"""One short run of each stream cell on the card through the command the
driver runs; ``correct`` has to come out true."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.gpubench_card
@pytest.mark.parametrize("name", ["accuracy.stream", "speed.stream"])
def test_cell_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", name, "--seed",
         "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
