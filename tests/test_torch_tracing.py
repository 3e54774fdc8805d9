"""The port's tracing utilities (``segfusion_tpu_torch/utils/tracing.py``)
beside the JAX package's (tests/test_tracing.py): ``StageTimer``,
``nan_guard`` (checked per operation, as ``checkify.float_checks``) and
``trace``."""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.utils.tracing import nan_guard as j_nan_guard
from segfusion_tpu_torch.utils.tracing import StageTimer, nan_guard, trace
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)


def test_stage_timer_accumulates():
    t = StageTimer()
    with t.stage("a"):
        x = torch.ones(64) * 2
        t.sync({"x": [x, 3]})
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    rep = t.report()
    assert set(rep) == {"a", "b"} and rep["a"] >= 0.0
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    off = StageTimer(enabled=False)
    with off.stage("a"):
        pass
    assert off.report() == {}


@pytest.mark.parametrize("name,fn,jfn,ok,bad", [
    ("log", torch.log, jnp.log, [1.0, 2.0], [-1.0]),
    ("sqrt", torch.sqrt, jnp.sqrt, [4.0], [-4.0]),
])
def test_nan_guard_trips_like_checkify(name, fn, jfn, ok, bad):
    """Both packages' guards pass finite results through and raise on a
    NaN made from finite inputs."""
    guarded = nan_guard(fn)
    jguarded = j_nan_guard(jax.jit(jfn))
    out = guarded(torch.tensor(ok))
    assert torch.equal(out, fn(torch.tensor(ok)))
    jguarded(jnp.asarray(ok))
    with pytest.raises(FloatingPointError, match="non-finite"):
        guarded(torch.tensor(bad))
    with pytest.raises(Exception):
        jguarded(jnp.asarray(bad))


def test_nan_guard_checks_intermediates():
    """A NaN that a later op hides (``nan_to_num``) still trips: every
    operation is checked, not only the outputs; an infinity too. Inputs
    that are already non-finite do not trip the op that reads them."""
    def hidden(x):
        return torch.nan_to_num(torch.log(x))

    assert torch.isfinite(hidden(torch.tensor([-1.0]))).all()
    with pytest.raises(FloatingPointError):
        nan_guard(hidden)(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError):
        nan_guard(lambda x: 1.0 / x)(torch.tensor([0.0]))
    passed = nan_guard(lambda x: x * 2)(torch.tensor([float("inf")]))
    assert torch.isinf(passed).all()


def test_nan_guard_disabled_passthrough():
    f = lambda x: x * 2  # noqa: E731
    assert nan_guard(f, enabled=False) is f


def test_trace_writes_and_is_a_no_op_when_falsy(tmp_path):
    for off in (None, ""):
        with trace(off) as prof:
            torch.ones(4).sum()
        assert prof is None
    with trace(str(tmp_path / "tr")):
        torch.ones(8).cumsum(0)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "")
               for e in data["traceEvents"])
