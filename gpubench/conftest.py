"""pytest settings of the benchmark's own tests (``gpubench/tests``).

The marker ``gpubench_card`` marks tests that need a CUDA card; they skip
here, deciding inside the ``card`` fixture. Run them on the card with
``python3 -m pytest gpubench/tests -m gpubench_card``.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpubench_card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    """Tiny tensors on a shared machine: many threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
