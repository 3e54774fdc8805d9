"""Readings that the limits of ``limits/<cell>.json`` are set from: for
each seed one run of the cell at its own size and load (the window of
``--seconds``), the port's numbers against the reference, and on the
first ``--control`` seeds the precision control's numbers (the reference
with float8 convolutions in the port's place) over the same frames.

    python3 gpubench/readings.py --workload <cell> --seeds 1 2 3 \\
        --seconds 15 --control 3 [--out chiprun_out/readings.jsonl]

All seeds run in one process. Prints one JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from gpubench import check, harness

    if harness.refuse_overrides():
        return 2
    cell = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run = harness.build(cell, seed, dev)
        harness.warm_up(run)
        window = harness.run_window(run, args.seconds)
        final = run.pipe._exit_rows(run.layout, run.stream.rv)
        line = {"cell": cell.name, "seed": seed, "frames": len(run.order),
                "fps": window["fps"]}
        if "latency_s" in window:
            line["frame_p95_ms"] = 1e3 * harness.p95(window["latency_s"])
        line["port"] = check.compare_run(run, final)
        line["replay_s"] = run.replay_s
        if i < args.control:
            t1 = time.perf_counter()
            line["control"] = check.control(run)
            line["control_s"] = time.perf_counter() - t1
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del run, final
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
