#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in BENCHMARK.json, makes its weights and frames from
the seed on the card, warms up, drives the cell's traffic for ``--seconds``
and prints one JSON line: the cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``), whether the port's result matched
the plain reference (``correct``), and the numbers compared beside their
limits (``checks``, also the last lines on standard error). Exits non-zero
without a result where torch sees fewer CUDA devices than the cell needs,
where ``SEGFUSION_FRAME_BLOCK`` or ``SEGFUSION_GEO_DTYPE`` is set, or where
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    sys.path.insert(0, ROOT)
    from gpubench import harness

    bad = harness.refuse_overrides()
    if bad:
        print(f"gpubench: {bad} set in the environment; the port would run "
              "other settings than the cell's file states", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    import torch
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gpubench: the cell needs {need} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import segfusion_tpu_torch  # noqa: F401  (fails where the port is absent)

    res = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T_START)
    correct, checks = harness.judge(res["numbers"], cell.limits)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gpubench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in
             cell.bench["end_to_end"] + cell.bench["per_layer"]}
    for name, value in res["numbers"].items():
        if name not in checks:
            print(f"reading {name} {value!r} (no limit)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(harness.result_line(correct, res["attempted"], 0, res["metrics"],
                              units, res["device"], checks,
                              res.get("breakdown")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
