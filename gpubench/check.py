"""What decides ``correct``: the port's volume after the window against
the plain reference's replay of the same frames, and the numbers
compared.

The port's state after the window is a recurrence over every frame the
window fused, so the reference replays that whole stream from an empty
volume, frame by frame, in float32 with TF32 off (``reference/``), with
the same weights and the same frames, once the window has closed and the
port's stream is freed. The numbers (``compare``):

* ``weight_gap``: the widest gap between the two weight volumes, as a
  share of the reference's largest weight. The weights depend on the
  geometry alone, so a frame dropped, doubled or half integrated shows.
* ``tsdf_gap``: the mean gap between the two TSDF volumes over the voxels
  the reference observed, as a share of the truncation (init_value):
  extraction, FusionNet's estimates, integration and K1's shadow; and
  ``tsdf_gap_rel``, that gap over ``bf16_probe`` + 1e-4. ``bf16_probe``
  is measured by the reference itself on every 8th frame of its replay:
  the mean gap between its clipped estimates and those of the same frame
  with every product's operands rounded to bfloat16 (convolutions, linear
  layers and attention's two products; the segmenter's labels too, where
  the cell labels). Random weights leave FusionNet's
  sensitivity to rounding to the seed (the probe spans 1e-5 to 1e-2), so
  the gap is compared in units of what bfloat16, the precision the
  configurations state, does to these nets on these frames.
* ``label_mismatch`` and ``score_gap``: the share of labelled voxels whose
  class differs, and the mean gap of their scores (AdapNet++'s labels and
  softmax scores through the key scatter-max), where the cell labels.

The precision control (``control``) is the reference with every product's
operands rounded to float8 (e4m3, one scale per tensor): the step below
the bfloat16 the configurations state.

The nets are found by name (``architectures``): each cell's fusion net
and segmenter come from their own files, called the same way whatever
the architecture.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from . import architectures
from .reference import fusion as rf
from .reference.layers import plain_precision, set_quantiser

__all__ = ["compare", "compare_run", "replay", "fp8", "flops_per_frame",
           "reference_nets"]

_SEM_BATCH = 8
_PROBE = 8        # every 8th frame of the replay probes bf16 rounding
# the TSDF gap (in init_value) the port shows where bf16 rounding cannot
# move the nets' estimates (a seed whose FusionNet saturates: probe
# 1.2e-5, gap 8.2e-5 to 1.0e-4), from the atomic scatter-adds' order and
# the bf16 words they round to; it keeps tsdf_gap_rel steady on such seeds
_GAP_FLOOR = 1e-4


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return ((t.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(t.dtype)


def reference_nets(conf: dict, fusion_state, seg_state, device,
                   quantiser=None):
    """The reference's nets with the run's weights (float32 copies)."""
    c = conf["config"]
    fusion_file = architectures.fusion(c)
    seg_file = None if seg_state is None else architectures.segmenter(c)
    with torch.device("meta"):
        fnet = fusion_file.reference(c["FUSION_MODEL"])
    fnet.load_state_dict({k: v.float() if v.is_floating_point() else v
                          for k, v in fusion_state.items()}, assign=True)
    fnet = set_quantiser(fnet.to(device).eval(), quantiser)
    seg = None
    if seg_file is not None:
        with torch.device("meta"):
            seg = seg_file.reference(c["SEMANTIC_2D_MODEL"])
        seg.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in seg_state.items()}, assign=True)
        seg = set_quantiser(seg.to(device).eval(), quantiser)
    return fnet, seg


@torch.no_grad()
def replay(conf: dict, traffic: dict, fusion_state, seg_state, orbit,
           order, device, quantiser=None) -> rf.Volume:
    """The reference's volume after the frames ``order`` (orbit indices)."""
    c, a = conf["config"], conf["assumed"]
    with plain_precision():
        fnet, seg = reference_nets(conf, fusion_state, seg_state, device,
                                   quantiser)
        sem = {}
        if seg is not None:
            used = sorted(set(order))
            for i in range(0, len(used), _SEM_BATCH):
                idx = torch.tensor(used[i:i + _SEM_BATCH], device=device)
                probs = torch.softmax(seg(orbit["image"][idx],
                                          orbit["depth_input"][idx]), -1)
                score, ids = probs.max(-1)
                for j, k in enumerate(used[i:i + _SEM_BATCH]):
                    sem[k] = (ids[j].reshape(-1).to(torch.uint8),
                              score[j].reshape(-1))
        probes = {k for i, k in enumerate(order) if i % _PROBE == 0} \
            if quantiser is None else set()
        probe_ids = {}
        if seg is not None and probes:     # the segmenter in bf16 too
            set_quantiser(seg, rf.bf16_round)
            used = sorted(probes)
            for i in range(0, len(used), _SEM_BATCH):
                idx = torch.tensor(used[i:i + _SEM_BATCH], device=device)
                ids = seg(orbit["image"][idx],
                          orbit["depth_input"][idx]).argmax(-1)
                for j, k in enumerate(used[i:i + _SEM_BATCH]):
                    probe_ids[k] = ids[j].reshape(-1)
            set_quantiser(seg, None)
        fm = c["FUSION_MODEL"]
        vol = rf.Volume(tuple(a["volume_shape"]), a["volume_origin"],
                        a["voxel_size"], c["DATA"]["init_value"], device)
        for i, k in enumerate(order):
            frame = {key: orbit[key][k] for key in
                     ("depth", "mask", "extrinsics", "intrinsics")}
            rf.step(vol, fnet, frame, int(fm["n_points"]),
                    int(fm["n_tail_points"]),
                    int(c["SEMANTIC_2D_MODEL"]["n_classes"]),
                    sem.get(k), probe=quantiser is None and i % _PROBE == 0,
                    probe_ids=probe_ids.get(k))
    return vol


def compare(num, w, key, ref: rf.Volume,
            semantics: bool) -> Dict[str, float]:
    """The numbers of the module docstring, port (num, w, key) against
    the reference volume."""
    init = ref.init_value
    wr = ref.w
    obs = wr > 0
    out = {"weight_gap": float((w - wr).abs().amax()
                               / torch.clamp_min(wr.amax(), 1e-12))}
    tp = torch.where(w > 0, num / torch.clamp_min(w, 1e-12), init)
    gap = (tp - ref.tsdf()).abs() / init
    out["tsdf_gap"] = float(gap[obs].mean()) if bool(obs.any()) \
        else float("inf")
    if ref.probe_n:
        probe = ref.probe_sum / ref.probe_n / init
        out["bf16_probe"] = probe
        out["tsdf_gap_rel"] = out["tsdf_gap"] / (probe + _GAP_FLOOR)
    if semantics:
        lab = obs & (ref.key > 0)
        if bool(lab.any()):
            kp, kr = key[lab], ref.key[lab]
            out["label_mismatch"] = float(((kp % 256) != (kr % 256))
                                          .float().mean())
            out["score_gap"] = float(((kp // 256) - (kr // 256)).abs()
                                     .double().mean() / ((1 << 23) - 1))
        else:
            out["label_mismatch"] = out["score_gap"] = float("inf")
    return out


def compare_run(run, final) -> Dict[str, float]:
    """Free the port's stream, replay the run's frames in the reference,
    compare."""
    num, w, key = final.num, final.weights, final.semkey
    run.stream = None
    run.pipe = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run.ref = replay(run.cell.config, run.cell.traffic, run.fusion_state,
                     run.seg_state, run.orbit, run.order, run.device)
    run.replay_s = time.perf_counter() - t0
    return compare(num, w, key, run.ref, run.seg_state is not None)


def flops_per_frame(run) -> float:
    """FLOPs of one frame's nets at the cell's shapes, counted on the
    reference's nets on the meta device (the same count whatever
    implements them): the fusion net, and the segmenter where the cell
    labels."""
    from torch.utils.flop_counter import FlopCounterMode
    c = run.cell.config["config"]
    h, w = int(c["DATA"]["resy"]), int(c["DATA"]["resx"])
    p = int(c["FUSION_MODEL"]["n_points"])
    with torch.device("meta"):
        fnet = architectures.fusion(c).reference(c["FUSION_MODEL"])
        inputs = {"tsdf_values": torch.zeros(1, h, w, p),
                  "tsdf_weights": torch.zeros(1, h, w, p),
                  "tsdf_frame": torch.zeros(1, h, w, 1),
                  "semantic_frame": torch.zeros(1, h, w, 1)}
        seg = (architectures.segmenter(c).reference(c["SEMANTIC_2D_MODEL"])
               if run.seg_state is not None else None)
        with FlopCounterMode(display=False) as fc:
            fnet(inputs)
            if seg is not None:
                seg(torch.zeros(1, h, w, 3), torch.zeros(1, h, w))
    return float(fc.get_total_flops())


def control(run, quantiser=fp8) -> Optional[Dict[str, float]]:
    """The control's numbers: the reference in the lower precision against
    the reference, over the same frames."""
    ref = getattr(run, "ref", None) or replay(
        run.cell.config, run.cell.traffic, run.fusion_state, run.seg_state,
        run.orbit, run.order, run.device)
    low = replay(run.cell.config, run.cell.traffic, run.fusion_state,
                 run.seg_state, run.orbit, run.order, run.device, quantiser)
    return compare(low.num, low.w, low.key, ref, run.seg_state is not None)
