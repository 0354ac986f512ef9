"""BENCHMARK.json keeps to its contract's shape, and every name in it
leads to its file."""

import json
import os
import re

from portbench import harness
from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.join(ROOT, "portbench")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_names():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names), names
    assert len({x["name"] for x in spec["end_to_end"] + spec["per_layer"]}) \
        == len(spec["end_to_end"]) + len(spec["per_layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_file_is_there_and_agrees():
    spec = _spec()
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(HERE, "entries",
                                           f"{cfg['entry']}.py"))
    for w in spec["workloads"]:
        assert w["config"] in configs
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           f"{w['traffic']}.json"))
        cell = harness.load_cell(ROOT, w["name"])
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
        assert m["moves"] in e2e
