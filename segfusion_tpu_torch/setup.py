"""Factory facade: the reference's ``utils.setup`` namespace over the
port's modules (the JAX package's ``segfusion_tpu/setup.py``). The data
augmentations wait for the real-data loaders (ROADMAP Queue 1 #9)."""

from .config import get_data_config  # noqa: F401
from .core.database import Database
from .data import get_data  # noqa: F401
from .utils.losses import get_loss_function  # noqa: F401
from .utils.optim import get_optimizer  # noqa: F401
from .utils.schedulers import get_schedule as get_scheduler  # noqa: F401
from .utils.workspace import Workspace, get_workspace  # noqa: F401


def get_database(dataset, data_config, device="cuda") -> Database:
    """The per-scene volume store over ``dataset`` (on ``device``)."""
    return Database(dataset, data_config, device=device)
