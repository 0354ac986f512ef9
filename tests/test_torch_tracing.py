"""The port's stage spans and cache counters (``utils/profiling.py``) and
the benchmark's readers of them (``portbench/stages.py``), on the CPU."""

import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import profile

from jpeg_decoder_tpu_torch import decode
from jpeg_decoder_tpu_torch.ops import entropy_cuda
from jpeg_decoder_tpu_torch.testing.encoder import encode
from jpeg_decoder_tpu_torch.utils import profiling
from jpeg_decoder_tpu_torch.utils.profiling import SpanRecord

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness, stages, trace  # noqa: E402

STAGES = ("decode.parse", "entropy.prepare_scan", "entropy.enqueue",
          "entropy.flags", "pixel.enqueue")
#: The stage spans of one call: the quantisation tables' uploads and the
#: pixel pipeline's launches are two ``pixel.enqueue`` spans.
CALL_SPANS = sorted(STAGES + ("pixel.enqueue",))


@pytest.fixture(scope="module")
def blob():
    """A small 4:2:0 frame with restart markers: the restart route."""
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    return encode(img, restart_interval=1, quality=85)[0]


def _decode(blob):
    return decode(blob, entropy="hybrid", device="cpu")


def test_off_records_nothing(blob):
    before = profiling.spans()
    _decode(blob)
    assert profiling.spans() == before
    assert profiling.span("a") is profiling.span("b")


def test_one_call_nests_its_stages(blob):
    _decode(blob)
    with profile():
        _decode(blob)
    got = profiling.spans()
    roots = [s for s in got if s.name == "decode"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent_id is None and root.call_id is not None
    kids = [s for s in got if s is not root]
    assert sorted(s.name for s in kids) == CALL_SPANS
    for s in kids:
        assert s.parent_id == root.span_id and s.call_id == root.call_id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert s.tid == root.tid == threading.get_native_id()
    for s in got:
        assert 0 <= s.cpu_ns <= s.end_ns - s.start_ns


def test_threads_get_their_own_calls(blob):
    _decode(blob)
    go = threading.Barrier(2)
    errors = []

    def work():
        try:
            go.wait(timeout=60)
            _decode(blob)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    with profile():
        ts = [threading.Thread(target=work) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in ts) and not errors
    got = profiling.spans()
    roots = [s for s in got if s.name == "decode"]
    assert len(roots) == 2
    assert len({r.call_id for r in roots}) == 2
    assert len({r.tid for r in roots}) == 2
    for r in roots:
        mine = [s for s in got if s.call_id == r.call_id]
        assert len(mine) == 1 + len(CALL_SPANS)
        assert {s.tid for s in mine} == {r.tid}


def test_table_cache_miss_is_counted(blob):
    _decode(blob)
    entropy_cuda.clear_table_cache()
    with profile():
        _decode(blob)
        first = profiling.counters().get("tables.build", 0)
        _decode(blob)
        second = profiling.counters().get("tables.build", 0)
    assert (first, second) == (1, 1)


def test_device_trace_holds_the_spans(blob, tmp_path):
    # A host entropy backend: few torch operations for the trace to hold.
    with profiling.device_trace(str(tmp_path)):
        decode(blob, entropy="python", device="cpu")
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mark = next(e for e in events if e.get("name") == profiling.TRACE_ANCHOR)
    mine = [e for e in events if e.get("cat") == "jd_span"]
    assert sorted(e["name"] for e in mine) == [
        "decode", "decode.parse", "pixel.enqueue", "pixel.enqueue"]
    for e in mine:
        assert e["tid"] == threading.get_native_id()
        assert e["pid"] == mark["pid"]
        assert mark["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= mark["ts"] + mark["dur"]


# --- the benchmark's readers, on hand-built spans and a hand-built trace.

W0, W1 = 1_000, 100_000


def _call(call: int, t: int, tid: int, parts: list) -> list:
    """A decode root at ``t`` with its stages back to back: ``parts`` is
    (wall ns, cpu ns) per stage of STAGES."""
    root_id = call * 10
    out, at = [], t
    for k, (name, (wall, cpu)) in enumerate(zip(STAGES, parts)):
        out.append(SpanRecord(name, at, at + wall, cpu, tid, root_id + k + 1,
                              root_id, call))
        at += wall
    out.append(SpanRecord("decode", t, at + 100, at + 100 - t, tid, root_id,
                          None, call))
    return out


def _hand_built():
    spans = (
        _call(1, 2_000, 7, [(100, 90), (300, 300), (200, 150), (1_000, 10),
                            (400, 300)])
        + _call(2, 10_000, 8, [(200, 200), (500, 400), (100, 100),
                               (2_000, 20), (300, 300)])
        + _call(3, 20_000, 7, [(150, 99), (400, 400), (300, 200),
                               (1_500, 30), (600, 600)])
        # A calibration call after the window is left out.
        + _call(4, W1 + 10, 7, [(9_000, 0)] * 5))
    counts = [profiling.CountRecord("tables.build", 1, 500, 7, None),
              profiling.CountRecord("layout.comp_src_upload", 1, 3_000, 7, 1),
              profiling.CountRecord("kernels.load", 2, 20_100, 7, 3),
              profiling.CountRecord("kernels.build", 1, W1 + 20, 7, 4)]
    # Per call: K2's launch and write kernel inside enqueue .. flags, and
    # one pixel kernel inside pixel.enqueue.
    ops = [("offsets_kernel", 2_450, 2_500), ("sync_kernel", 2_500, 3_000),
           ("write_kernel", 3_000, 3_500), ("k5", 3_700, 3_800),
           ("offsets_kernel", 10_750, 10_800), ("write_kernel", 10_800,
                                                11_500),
           ("k5", 12_000, 12_050),
           ("offsets_kernel", 20_600, 20_700), ("write_kernel", 20_700,
                                                22_000),
           ("k5", 22_500, 22_600)]
    red = trace.Reduced(window_s=(W1 - W0) * 1e-9, busy_s=0.0,
                        device_ops=ops, idle_gaps=[], top_ops=[],
                        spans=[(trace.WINDOW, W0, W1, 1)], all_ops=ops)
    return spans, counts, red


@pytest.fixture
def hand_ctx(monkeypatch):
    spans, counts, red = _hand_built()
    monkeypatch.setattr(stages, "recorded", lambda: (spans, counts))
    lines = []
    monkeypatch.setattr(stages, "_print", lines.append)
    ctx = types.SimpleNamespace(trace=red)
    return ctx, lines


@pytest.mark.parametrize("name, want", [
    ("serve.parse_ms", 150e-6),
    ("serve.scan_prep_ms", 400e-6),
    ("serve.k2_enqueue_ms", 200e-6),
    ("serve.flag_wait_ms", 1_500e-6),
    ("serve.pixel_enqueue_ms", 400e-6),
    # the mean of wall - cpu over the four host stages: 160, 100, 151 ns.
    ("serve.host_offcpu_ms", 137e-6),
    # idle inside each root: 2_100 - 1_150, 3_200 - 800, 3_050 - 1_500 ns.
    ("serve.call_idle_ms", 1_550e-6),
    # the three increments inside the window.
    ("serve.cache_misses", 3),
])
def test_readers_on_hand_built_spans(hand_ctx, name, want):
    ctx, _ = hand_ctx
    assert harness.reader(name).read(ctx) == pytest.approx(want, rel=1e-12)


def test_stage_log_on_hand_built_spans(hand_ctx):
    ctx, lines = hand_ctx
    st = stages.of(ctx)
    assert [c.root.call_id for c in st.calls] == [1, 2, 3]
    assert stages.of(ctx) is st and len(lines) == 3 + 3
    assert "100.00% of 3 K2 launches" in lines[0]
    assert "100.00% of 3 write_kernel" in lines[0]
    # flags end - write end, sorted: 100, 1_300, 350 ns.
    assert "by 0.1/0.1/0.4 us)" in lines[0]
    assert "thread 8" in lines[3]
    # 100 ns of each root after its last stage: 100 / 3_050 the median.
    assert "leave 3.28% of the median call uncovered" in lines[0]
    idle = stages.idle_by_span(st)
    busy = 1_150 + 800 + 1_500
    assert sum(idle.values()) == pytest.approx((W1 - W0 - busy) * 1e-9)
    assert idle["decode"] == pytest.approx(300e-9)
    # flags minus K2's kernels over them: 1_000 - 900, 2_000 - 750,
    # 1_500 - 1_150.
    assert idle["entropy.flags"] == pytest.approx(1_700e-9)
    assert stages.clock_check([3, 1, 2], [2, 4, 3]) == (
        1.0, [(1, 1), (2, 1), (3, 1)])
    assert stages.clock_check([5, 1], [4, 2]) == (0.5, [(1, 1), (5, -1)])
    # Enqueue starts at 1.4%, 9.8% and 19.7% of the window, 50 ns before
    # their launches; write ends at 2.5%, 10.6% and 21.2%, 100, 1_300 and
    # 350 ns before the flags end.
    assert lines[1].endswith("launch 0 0 - - - - - - - -; flags 0 1 0 - - "
                             "- - - - -")


def test_readers_without_a_recorder(monkeypatch):
    _, _, red = _hand_built()
    monkeypatch.setattr(stages, "recorded", lambda: None)
    ctx = types.SimpleNamespace(trace=red)
    for name in ("serve.parse_ms", "serve.call_idle_ms",
                 "serve.cache_misses", "serve.pixel_fused_share",
                 "serve.k2_in_place_share"):
        assert harness.reader(name).read(ctx) is None


def test_fused_share_on_hand_built_spans(monkeypatch):
    """The share of the window's calls with a ``pixel.k6b`` increment; a
    program without the route (no ``k6b_route``) reads None."""
    from jpeg_decoder_tpu_torch.models import decoder

    spans, counts, red = _hand_built()
    counts = counts + [
        profiling.CountRecord("pixel.k6b", 1, 3_800, 7, 1),
        profiling.CountRecord("pixel.k6b", 1, 22_600, 7, 3),
        profiling.CountRecord("pixel.k6b", 1, W1 + 30, 7, 4),
        profiling.CountRecord("pixel.consts_upload", 1, 12_000, 8, 2)]
    monkeypatch.setattr(stages, "recorded", lambda: (spans, counts))
    monkeypatch.setattr(stages, "_print", lambda line: None)
    reader = harness.reader("serve.pixel_fused_share")
    ctx = types.SimpleNamespace(trace=red)
    assert reader.read(ctx) == pytest.approx(200 / 3, rel=1e-12)
    monkeypatch.delattr(decoder, "k6b_route")
    assert reader.read(types.SimpleNamespace(trace=red)) is None


def test_in_place_share_on_hand_built_spans(monkeypatch):
    """The share of the window's calls with an ``entropy.scan_in_place``
    increment; a program whose K2 has no in-place form (no
    ``entropy_cuda.decode_scan_bytes``) reads None."""
    from jpeg_decoder_tpu_torch.ops import entropy_cuda

    spans, counts, red = _hand_built()
    counts = counts + [
        profiling.CountRecord("entropy.scan_in_place", 1, 3_700, 7, 1),
        profiling.CountRecord("entropy.scan_in_place", 1, 12_100, 8, 2),
        profiling.CountRecord("entropy.scan_in_place", 1, W1 + 30, 7, 4),
        profiling.CountRecord("pixel.k6b", 1, 22_600, 7, 3)]
    monkeypatch.setattr(stages, "recorded", lambda: (spans, counts))
    monkeypatch.setattr(stages, "_print", lambda line: None)
    reader = harness.reader("serve.k2_in_place_share")
    ctx = types.SimpleNamespace(trace=red)
    assert reader.read(ctx) == pytest.approx(200 / 3, rel=1e-12)
    monkeypatch.delattr(entropy_cuda, "decode_scan_bytes")
    assert reader.read(types.SimpleNamespace(trace=red)) is None
