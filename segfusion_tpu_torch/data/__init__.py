"""Datasets and host-side streaming.

Port of ``segfusion_tpu/data/__init__.py``: the Replica and ScanNet
loaders (host-decoded frames from the datasets' own directory layouts)
and the Synthetic rooms (depth rendered on ``device``).
"""

from .prefetch import PrefetchLoader
from .replica import Replica
from .scannet import ScanNet
from .synthetic import Synthetic

__all__ = ["PrefetchLoader", "Replica", "ScanNet", "Synthetic", "get_data"]

_DATASETS = {"Replica": Replica, "ScanNet": ScanNet, "Synthetic": Synthetic}


def get_data(name: str, config_data, device="cuda"):
    """The dataset ``name`` over ``config_data`` (a DATA section); frames
    that a dataset renders are rendered on ``device``."""
    if name not in _DATASETS:
        raise NotImplementedError(f"Dataset {name} not implemented "
                                  f"(available: {sorted(_DATASETS)})")
    return _DATASETS[name](config_data, device=device)
