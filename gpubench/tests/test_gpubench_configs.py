"""BENCHMARK.json keeps to the benchmark's contract, and each
configuration file holds its yaml under configs/fusion/ as written."""

import json
import re
from pathlib import Path

import pytest
import yaml

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_matches_yaml(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    src = data["source"].split("(")[-1].rstrip(")")
    assert data["config"] == yaml.safe_load((ROOT / src).read_text())
    assert conf["reduced"] == []
    assert data["assumed"]["volume_shape"] == [448, 448, 448]


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"]
    items = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    for it in items:
        assert NAME.match(it["name"]), it["name"]
    for group in ("configs", "workloads"):
        names = [it["name"] for it in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for text in [it.get("why", "") for it in items] + [
            m.get("layer", "") for m in SPEC["per_layer"]]:
        assert len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_cells_and_metrics():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in cells.values():
        assert w["config"] in configs and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
        reported = [m for m in e2e.values()
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
    for m in e2e.values():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        assert any(w in m["workloads"] for m in SPEC["per_layer"])
