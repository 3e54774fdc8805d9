"""Port parity for ``train_fusion`` under ``SETTINGS.integration: scalar``:
its chunks of ``accumulation_steps`` frames go through the flat
``Pipeline.train_sequence`` into the training Database's volume (the
gradients summed over a chunk, one update a chunk), against the JAX
package's ``train_fusion.py`` on synthetic_small, on the CPU
(``tests/test_torch_train_fusion_flat.py``'s setting and bounds).
"""

import os

from segfusion_tpu_torch.utils.checkpoints import load_checkpoint
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_train_fusion_flat import (assert_trained_alike,
                                                trainer_pair)


def test_train_fusion_scalar_chunks_match_jax(tmp_path, monkeypatch):
    """10 frames in chunks of 4 (the last padded): 3 updates in optax's
    plain chain layout; the parameters and losses as in
    ``assert_trained_alike``."""
    params, jparams, net, ws, logged = trainer_pair(
        tmp_path, monkeypatch, {"integration": "scalar"},
        {"accumulation_steps": 4})
    last = load_checkpoint(os.path.join(ws.model_path, "last.ckpt"))
    assert int(last["opt_state"]["1"]["1"]["1"]["count"]) == 3
    assert "mini_step" not in last["opt_state"]
    assert_trained_alike(params, jparams, net, logged)
