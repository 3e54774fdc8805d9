"""Stage timing, profiler traces and a NaN/Inf guard.

Port of ``segfusion_tpu/utils/tracing.py``:

- :class:`StageTimer` accumulates wall time per named stage; ``sync``
  waits for the device before the clock stops (``torch.cuda.synchronize``
  on the device of each CUDA tensor given; PyTorch returns before a card
  finishes);
- :func:`trace` runs ``torch.profiler`` (CPU and, where torch sees a card,
  CUDA activity) and writes a Chrome trace into ``log_dir``; a no-op when
  ``log_dir`` is falsy;
- :func:`nan_guard` raises ``FloatingPointError`` on the host when an
  operation makes a NaN or an infinity from finite inputs. The JAX
  package's ``checkify.float_checks`` trips on any intermediate primitive,
  so the port checks every operation too: a ``TorchDispatchMode`` sees each
  aten op's floating outputs (checking only the function's outputs would
  miss a NaN that a later op hides, such as a ``where``). Each check reads
  a flag back from the device, so a guarded call runs op by op.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["StageTimer", "trace", "nan_guard"]


class StageTimer:
    """Per-stage wall time; ``report()`` gives each stage's mean in ms.

    Usage::

        timer = StageTimer()
        with timer.stage("extract"):
            out = extract(...)
            timer.sync(out)        # wait for the device first
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        yield self
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    @staticmethod
    def sync(tree):
        """Wait for every card holding a tensor of ``tree`` (nested lists,
        tuples and dicts) to finish its queued work."""
        devices = {t.device for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor) and t.is_cuda}
        for dev in devices:
            torch.cuda.synchronize(dev)

    def report(self) -> Dict[str, float]:
        return {k: 1e3 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def log(self, logger=None):
        rep = self.report()
        msg = " | ".join(f"{k}: {v:.2f} ms" for k, v in
                         sorted(rep.items(), key=lambda kv: -kv[1]))
        (logger.info if logger else print)(f"stage timing: {msg}")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, its Chrome trace written to
    ``log_dir/trace.json`` (open in Perfetto or chrome://tracing). No-op
    when ``log_dir`` is falsy. Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _nonfinite(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and not bool(torch.isfinite(t).all()))


class _FiniteCheck(TorchDispatchMode):
    """Raises when an op's floating output holds a NaN or an infinity
    and none of its floating inputs did."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(_nonfinite(t) for t in tree_leaves(out)) and not any(
                _nonfinite(t) for t in tree_leaves((args, kwargs))):
            raise FloatingPointError(
                f"non-finite values produced by {func}")
        return out


def nan_guard(fn: Callable, enabled: bool = True) -> Callable:
    """``fn`` with every operation checked for NaN / Inf made from finite
    inputs (raises ``FloatingPointError``); ``fn`` itself when not
    ``enabled``."""
    if not enabled:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _FiniteCheck():
            return fn(*args, **kwargs)

    return wrapped
