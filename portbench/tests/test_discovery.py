"""A later cell's traffic file and metric file are found by name, with no
edit to any file the harness already has."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from portbench.tests.tiny import ROOT

NEW_METRIC = '''"""Calls completed per second of the window (a test's metric)."""


def read(ctx):
    return len(ctx.requests) / ctx.window_s
'''


def test_new_traffic_and_metric_files_are_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "rtp1080_x5",
                              "config": "rtp1080_service",
                              "traffic": "open_phased_x5", "chips": 1,
                              "why": "five cameras"})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("rtp1080_x5")
    spec["per_layer"].append({"name": "serve.calls_per_s", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "single-image entry, models.decoder",
                              "moves": "request_p50_ms",
                              "workloads": ["rtp1080_x5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "portbench" / "traffic" / "open_phased_x5.json").write_text(
        json.dumps({"kind": "open", "cameras": 5, "fps": 30,
                    "jitter_ms": 1.0, "phase": "even"}))
    (root / "portbench" / "metrics" / "serve.calls_per_s.py").write_text(
        NEW_METRIC)
    code = textwrap.dedent("""
        import json
        from portbench import harness
        from portbench.tests import tiny
        tiny.CUTS["rtp1080_x5"] = (tiny.CUTS["rtp1080_open"][0], {"fps": 2})
        c = tiny.cell("rtp1080_x5")
        out = {}
        for traced in (False, True):
            result, _ = tiny.run("rtp1080_x5", seconds=0.5, traced=traced,
                                 c=c)
            out[str(traced)] = sorted(result["metrics"])
        print(json.dumps([c.mix, out, harness.__file__]))
    """)
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mix, metrics, where = json.loads(proc.stdout.strip().splitlines()[-1])
    assert where.startswith(str(root))
    assert mix["cameras"] == 5
    assert metrics["False"] == ["request_p50_ms", "setup_s"]
    assert metrics["True"] == ["serve.calls_per_s"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
