"""The nets of a cell, found by name: one file per architecture.

A configuration's ``FUSION_MODEL.name`` names ``nets/fusion/<name>.py``
and its ``SEMANTIC_2D_MODEL.name`` (``adapnet`` where the section has
none, as in the reference yamls) names ``nets/segmenter/<name>.py``. Each
file supplies

* ``port(section)``: the port's module, built through the port's own
  factory from the port's config section (the caller picks the device,
  the meta device at set-up);
* ``reference(section)``: the plain reference, plain ``torch`` made of
  ``reference/layers.py``'s pieces and importing nothing of the port,
  from the cell file's section. A fusion net is called as
  ``ref(inputs) -> (B, H*W, n_points)``, a segmenter as
  ``ref(image, depth_input) -> (B, H, W, C)`` logits; a net ignores an
  input it does not use;
* a segmenter also ``pipeline_segmenter(module)``: the object
  ``Pipeline`` takes (``apply_fn_batched(images, depths)``).

Both sides take one state dict (``weights.random_state``), so the
reference keeps the port's submodule names.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType

__all__ = ["NETS", "fusion", "segmenter"]

NETS = Path(__file__).resolve().parent / "nets"
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _load(kind: str, section: str, name) -> ModuleType:
    name = str(name)
    path = NETS / kind / f"{name}.py"
    if not _NAME.fullmatch(name) or not path.is_file():
        try:
            shown = path.relative_to(Path(__file__).resolve().parents[1])
        except ValueError:
            shown = path
        raise SystemExit(f"gpubench: {section}.name {name!r} has no net "
                         f"file; add {shown}")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_net_{kind}_{re.sub(r'[.-]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fusion(config: dict) -> ModuleType:
    """The file of the fusion net that ``config`` (a cell file's
    ``config``) names."""
    return _load("fusion", "FUSION_MODEL", config["FUSION_MODEL"]["name"])


def segmenter(config: dict) -> ModuleType:
    """The file of the 2D segmenter that ``config`` names."""
    return _load("segmenter", "SEMANTIC_2D_MODEL",
                 config["SEMANTIC_2D_MODEL"].get("name", "adapnet"))
