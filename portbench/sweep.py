"""The open-loop knee of a serving cell, on the card, in one process: the
cell's mix at each camera count for a short window, with the rate offered,
the rate served, the latency percentiles and the backlog's growth (the
median latency of the window's last fifth over its first fifth).

    python3 portbench/sweep.py --workload <cell> --seconds <s> --seed <n> \\
        --cameras <n> ...

The cell's traffic file then fixes N at about four fifths of the highest
rate served without a growing backlog.
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cameras", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    for n in args.cameras:
        cell = harness.load_cell(ROOT, args.workload)
        cell.mix["cameras"] = n
        cell.config["check"]["every"] = 10 ** 9
        seen = {}

        def observe(reqs, t0, t1):
            seen["reqs"], seen["t"] = reqs, (t0, t1)

        result, _ = harness.run(ROOT, args.workload, args.seed, args.seconds,
                                False, "cuda", time.perf_counter(),
                                log=lambda s: None, cell=cell,
                                observe=observe)
        reqs = [r for r in seen["reqs"] if r is not None]
        lat = [r.done - r.due for r in reqs if r.error is None]
        k = max(1, len(lat) // 5)
        ranked = sorted(lat)
        end = max(r.done for r in reqs)
        print(json.dumps({
            "cameras": n, "offered_fps": n * cell.mix["fps"],
            "served_fps": len(lat) / (end - seen["t"][0]),
            "p50_ms": result["metrics"]["request_p50_ms"]["value"],
            "p95_ms": ranked[max(0, -(-95 * len(ranked) // 100) - 1)] * 1e3,
            "growth": statistics.median(lat[-k:]) / statistics.median(
                lat[:k]),
            "failed": result["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
