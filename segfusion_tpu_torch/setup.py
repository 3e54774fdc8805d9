"""Factory facade: the reference's ``utils.setup`` namespace over the
port's modules (the JAX package's ``segfusion_tpu/setup.py``), with the
model factories the CLIs build from: ``build_adapnet`` (AdapNet++ stage
1 or 2), ``build_fusion_net`` and ``get_segmenter`` (the pipelines'
segmenter from a checkpoint). The data augmentations wait for the
real-data loaders (ROADMAP Queue 1 #9)."""

from .config import get_data_config  # noqa: F401
from .core.database import Database
from .data import get_data  # noqa: F401
from .models.adapnet import build_adapnet  # noqa: F401
from .models.fusionnet import build_fusion_net  # noqa: F401
from .utils.convert import (  # noqa: F401
    segmenter_from_checkpoint as get_segmenter)
from .utils.losses import get_loss_function  # noqa: F401
from .utils.optim import get_optimizer  # noqa: F401
from .utils.schedulers import get_schedule as get_scheduler  # noqa: F401
from .utils.workspace import Workspace, get_workspace  # noqa: F401


def get_database(dataset, data_config, device="cuda") -> Database:
    """The per-scene volume store over ``dataset`` (on ``device``)."""
    return Database(dataset, data_config, device=device)
