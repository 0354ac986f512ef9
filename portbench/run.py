"""The benchmark of jpeg_decoder_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout, on a machine with the cards the cell asks
for.  It makes the cell's frames from the seed, warms up, offers the
cell's traffic for ``--seconds`` (with ``--trace 1`` under the profiler),
checks the sampled outputs against the plain reference, and prints as its
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), ``breakdown`` (traced runs) and ``check``,
the compared numbers with their limits, which also end standard error.
It exits with 2, printing no result, without enough CUDA cards, and with 3
if JAX or the JAX package got loaded.
"""

import os
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age() -> float:
    """Seconds since this process started (interpreter start-up included),
    from /proc where it can; else since this module ran."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"),
                   time.perf_counter() - T_START)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = time.perf_counter() - process_age()

    # Build and kernel caches at fixed paths inside the checkout.
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)

    import torch

    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA card(s), this "
              f"machine has {n}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, compared = harness.run(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda", t_start, log=lambda s: print(s, flush=True), cell=cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    result["check"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in compared}
    for n, v, lim in compared:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
