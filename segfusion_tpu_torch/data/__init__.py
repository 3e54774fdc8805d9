"""Datasets and host-side streaming.

Port of ``segfusion_tpu/data/__init__.py``. Only the Synthetic dataset is
ported; Replica and ScanNet wait for ROADMAP Queue 1 #9.
"""

from .prefetch import PrefetchLoader
from .synthetic import Synthetic

__all__ = ["PrefetchLoader", "Synthetic", "get_data"]

_DATASETS = {"Synthetic": Synthetic}
_NOT_PORTED = ("Replica", "ScanNet")


def get_data(name: str, config_data, device="cuda"):
    """The dataset ``name`` over ``config_data`` (a DATA section); frames
    that a dataset renders are rendered on ``device``."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name} is not ported to segfusion_tpu_torch yet "
            "(ROADMAP Queue 1 #9)")
    if name not in _DATASETS:
        raise NotImplementedError(f"Dataset {name} not implemented "
                                  f"(available: {sorted(_DATASETS)})")
    return _DATASETS[name](config_data, device=device)
