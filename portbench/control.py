"""Readings that the check's limits are set from, on the card, in one
process: the program's compared numbers over many seeds (each a full run
of the cell, window and all), and the control's, the plain reference
computed in TF32 and put in the program's place, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ...

Prints one JSON line per reading, then the largest program reading and
the smallest control reading of each number.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(ROOT, args.workload)
    program, control = {}, {}
    for seed in args.seeds:
        result, compared = harness.run(
            ROOT, args.workload, seed, args.seconds, False, "cuda",
            time.perf_counter(), log=lambda s: print(s, flush=True),
            cell=cell)
        rec = {n: v for n, v, _ in compared}
        print(json.dumps({"side": "program", "seed": seed, "numbers": rec,
                          "metrics": result["metrics"]}), flush=True)
        for n, v in rec.items():
            program[n] = max(program.get(n, v), v)
    for seed in args.control_seeds:
        frames = harness.make_frames(cell, seed, "cuda")
        kept = [((i,), [harness.reference_rgb(cell.config, f, "tf32")])
                for i, f in enumerate(frames)]
        compared = harness.check(cell.config, frames, kept, 0, 0,
                                 log=lambda s: print(s, flush=True))
        rec = {n: v for n, v, _ in compared}
        print(json.dumps({"side": "control_tf32", "seed": seed,
                          "numbers": rec}), flush=True)
        for n, v in rec.items():
            control[n] = min(control.get(n, v), v)
        del frames, kept
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": program, "control_min": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
