"""Evaluation metrics: 3D geometry, 3D semantics and the mesh F-score.

The port's own copy of ``segfusion_tpu/utils/metrics.py``, trimmed to the
three functions the Database calls (host numpy at evaluation boundaries)
and the 2D segmentation score the segmentation CLIs keep. The arithmetic
is the JAX package's line for line, so both give the same numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["evaluation", "semantic_evaluation", "fscore", "RunningScore",
           "runningScore"]

_EPS = 1.0e-10


def _masked_nansum(x, mask):
    return np.nansum(np.where(mask, x, 0.0))


def evaluation(est: np.ndarray, target: np.ndarray,
               mask: Optional[np.ndarray] = None) -> Dict[str, float]:
    """3D TSDF geometry metrics, clipped to +/-0.04 over the observed
    mask."""
    est = np.nan_to_num(np.asarray(est, np.float32))
    target = np.nan_to_num(np.asarray(target, np.float32))
    est = np.clip(est, -0.04, 0.04)
    target = np.clip(target, -0.04, 0.04)

    if mask is not None:
        mask = np.asarray(mask) > 0
        msum = np.nansum(mask) + _EPS
        mse = _masked_nansum((est - target) ** 2, mask) / msum
        mad = _masked_nansum(np.abs(est - target), mask) / msum
        tp = np.nansum((est < 0) & (target < 0) & mask)
        fp = np.nansum((est < 0) & (target >= 0) & mask)
        fn = np.nansum((est >= 0) & (target < 0) & mask)
        tn = np.nansum((est >= 0) & (target >= 0) & mask)
        iou = tp / (tp + fp + fn + _EPS)
        acc = (tp + tn) / msum
    else:
        mse = float(np.nanmean((est - target) ** 2))
        mad = float(np.nanmean(np.abs(est - target)))
        tp = np.nansum((est < 0) & (target < 0))
        fp = np.nansum((est < 0) & (target >= 0))
        fn = np.nansum((est >= 0) & (target < 0))
        tn = np.nansum((est >= 0) & (target >= 0))
        iou = tp / (tp + fp + fn + _EPS)
        acc = (tp + tn) / (tp + tn + fp + fn + _EPS)

    return {"mse": float(mse), "mad": float(mad),
            "iou": float(iou), "acc": float(acc)}


def semantic_evaluation(est: np.ndarray, target: np.ndarray,
                        mask: np.ndarray, n_class: int
                        ) -> Tuple[Dict[str, float], Dict[int, float]]:
    """3D semantic metrics over observed voxels: per-class IoU/Acc averaged
    over the classes actually present (class 0, free space, is left out of
    the means)."""
    eps = np.finfo(np.float32).eps
    est = (np.asarray(est).astype(np.int64) * (np.asarray(mask) > 0)).ravel()
    target = (np.asarray(target).astype(np.int64)
              * (np.asarray(mask) > 0)).ravel()

    gt_present = np.bincount(np.unique(target), minlength=n_class)
    est_present = np.bincount(np.unique(est), minlength=n_class)

    valid = (target >= 0) & (target < n_class)
    hist = np.bincount(n_class * target[valid] + est[valid],
                       minlength=n_class * n_class).reshape(n_class, n_class)

    tp = np.diag(hist).astype(np.float64)
    fp = hist.sum(axis=0) - tp
    fn = hist.sum(axis=1) - tp

    n_valid_classes = max(int(gt_present.sum()) - 1, 1)  # exclude class 0
    acc = tp / (tp + fn + eps)
    iou = tp / (tp + fn + fp + eps)
    mean_acc = float(np.sum(acc[1:]) / n_valid_classes)
    mean_iou = float(np.sum(iou[1:]) / n_valid_classes)

    present = np.where(est_present | gt_present)[0]
    cls_iou = {int(c): float(iou[c]) for c in present}
    return {"Mean Acc": mean_acc, "Mean IoU": mean_iou}, cls_iou


class RunningScore:
    """2D segmentation confusion-matrix metrics: Acc, Mean Acc, FreqW Acc
    and Mean IoU, and the per-class IoU. With ``ignore_index`` 0 the
    class-0 row and column leave the scores, and class 0's IoU reads 0."""

    def __init__(self, n_classes: int, ignore_index: int = -100):
        self.n_classes = n_classes
        self.ignore_index = ignore_index
        self.confusion_matrix = np.zeros((n_classes, n_classes), np.float64)

    def _hist(self, label_true, label_pred):
        n = self.n_classes
        mask = (label_true >= 0) & (label_true < n)
        return np.bincount(
            n * label_true[mask].astype(np.int64)
            + label_pred[mask].astype(np.int64),
            minlength=n * n).reshape(n, n)

    def update(self, label_trues, label_preds):
        """Add a batch of (label, prediction) images."""
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += self._hist(np.asarray(lt).ravel(),
                                                np.asarray(lp).ravel())

    def get_scores(self):
        """(metrics dict, class -> IoU); classes absent from both the
        labels and the predictions score NaN and leave the means."""
        hist = self.confusion_matrix
        if self.ignore_index == 0:
            hist = hist[1:, 1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
            iou = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                                   - np.diag(hist))
            mean_iou = np.nanmean(iou)
            freq = hist.sum(axis=1) / hist.sum()
            fwavacc = (freq[freq > 0] * iou[freq > 0]).sum()
        if self.ignore_index == 0:
            iou = np.insert(iou, 0, 0.0)
        cls_iou = dict(zip(range(self.n_classes), iou))
        return ({"Acc": float(acc), "Mean Acc": float(acc_cls),
                 "FreqW Acc": float(fwavacc), "Mean IoU": float(mean_iou)},
                cls_iou)

    def reset(self):
        self.confusion_matrix[:] = 0


runningScore = RunningScore   # the reference's name


def fscore(est_points: np.ndarray, gt_points: np.ndarray,
           threshold: float = 0.05,
           max_points: int = 200_000,
           seed: int = 0) -> Dict[str, float]:
    """Mesh reconstruction F-score at a distance threshold (in meters):
    precision is the share of estimated points within ``threshold`` of the
    gt points, recall the converse; at most ``max_points`` of each, drawn
    with ``seed``. Nearest neighbours by scipy's cKDTree."""
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(seed)
    est = np.asarray(est_points, np.float32)
    gt = np.asarray(gt_points, np.float32)
    if len(est) == 0 or len(gt) == 0:
        return {"fscore": 0.0, "precision": 0.0, "recall": 0.0}
    if len(est) > max_points:
        est = est[rng.choice(len(est), max_points, replace=False)]
    if len(gt) > max_points:
        gt = gt[rng.choice(len(gt), max_points, replace=False)]

    d_e2g = cKDTree(gt).query(est, k=1)[0]
    d_g2e = cKDTree(est).query(gt, k=1)[0]

    precision = float(np.mean(d_e2g < threshold))
    recall = float(np.mean(d_g2e < threshold))
    f = 2 * precision * recall / max(precision + recall, _EPS)
    return {"fscore": f, "precision": precision, "recall": recall}
