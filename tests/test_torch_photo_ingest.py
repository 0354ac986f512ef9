"""The ``photo12_ingest`` configuration on the CPU: 12 MP phone photos with
no restart markers through ``decode(entropy="pallas", idct="exact",
upsample="fancy")``, at a small size.  The port's entropy and pixel stages
against the benchmark's corpus planes and plain reference
(``portbench/reference.py``), K2's chunked model on the frame's one long
segment, the cell's metrics and their readers, and K2's statistics as the
recorder's counters.  No card and no JAX."""

import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import profile

from jpeg_decoder_tpu_torch import decode
from jpeg_decoder_tpu_torch.entropy import python_ref
from jpeg_decoder_tpu_torch.io import parser
from jpeg_decoder_tpu_torch.models import decoder
from jpeg_decoder_tpu_torch.ops import entropy_cuda, scan_prep
from jpeg_decoder_tpu_torch.utils import profiling
from jpeg_decoder_tpu_torch.utils.profiling import CountRecord, SpanRecord

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import corpus, harness, reference, stages, trace  # noqa: E402

CONFIG = harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                        "photo12_ingest.json"))
SEED = 2**31 + 5
#: The configuration's per-layer metrics that read K2 on the long stream.
NEW_METRICS = ("k2_roofline.photo", "device.idle_share.photo",
               "photo.k2_sync_per_chunk", "photo.k2_seal_redecodes")
SHARED_METRICS = ("serve.service_ms", "serve.parse_ms", "serve.scan_prep_ms",
                  "serve.k2_enqueue_ms", "serve.flag_wait_ms",
                  "serve.pixel_device_ms", "serve.request_p95_ms",
                  "serve.pixel_enqueue_ms", "serve.host_offcpu_ms",
                  "serve.call_idle_ms", "serve.cache_misses",
                  "serve.pixel_fused_share", "serve.k2_in_place_share")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain models step thousands of lanes of a few thousand elements:
    one intra-op thread is several times faster than many here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    """A seeded 256 x 192 frame of the configuration's recipe (4:2:0, q95,
    no restart markers), from the benchmark's corpus maker."""
    recipe = dict(CONFIG["frame"], width=256, height=192)
    return corpus.make_frames(recipe, SEED, 1, "cpu")[0]


def test_recipe_is_the_deployment():
    f = CONFIG["frame"]
    assert (f["width"], f["height"], f["quality"]) == (4032, 3024, 95)
    assert f["samplings"] == [[2, 2], [1, 1], [1, 1]]
    assert f["restart_interval"] == 0 and CONFIG["reduced"] == []
    assert CONFIG["kwargs"] == {"entropy": "pallas", "idct": "exact",
                                "upsample": "fancy"}
    assert CONFIG["pixels"] == {"idct": "trunc", "upsample": "fancy"}
    assert CONFIG["workers"] == 2 and CONFIG["entry"] == "decode"


def test_frame_is_one_segment(frame):
    hdr = parser.parse(frame.blob)
    assert frame.segments == 1 and hdr.restart_interval == 0
    assert len(hdr.scans[0].seg_offsets) == 2


def test_decode_planes_and_rgb_against_reference(frame):
    """(a): the planes are the corpus's exactly (the entropy layer is
    lossless), and the RGB is the reference's ``trunc`` + ``fancy`` within
    the configuration's ``share_off``.  That limit is 1e-3: the port's
    ``exact`` is float32 arithmetic, the reference float64, so a sample may
    land on the other side of a truncation now and then (none does on this
    frame); the TF32 control misses by about 1% of samples (below)."""
    res = decode(frame.blob, entropy="pallas", idct="exact",
                 upsample="fancy", device="cpu", keep_planes=True)
    for got, want in zip(res.quantized_planes, frame.planes):
        assert np.array_equal(got, want.numpy())
    ref = harness.reference_rgb(CONFIG, frame)
    off, worst, tot = reference.compare(res.rgb, ref)
    assert off / tot <= CONFIG["check"]["limits"]["share_off"], (off, worst)


def test_tf32_control_fails_share_off(frame):
    """The reference in TF32 (``control.py``'s control) is not correct by
    the configuration's ``share_off``; in float64 it is."""
    kept = [((0,), [harness.reference_rgb(CONFIG, frame, "tf32")])]
    (name, share, lim), *_ = harness.check(CONFIG, [frame], kept, 0, 0,
                                           log=lambda s: None)
    assert name == "share_off" and share > lim
    kept = [((0,), [harness.reference_rgb(CONFIG, frame)])]
    compared = harness.check(CONFIG, [frame], kept, 0, 0, log=lambda s: None)
    assert all(v <= lim for _, v, lim in compared)


def _rows_by_segment(data: np.ndarray, off: np.ndarray,
                     row_bytes: int) -> np.ndarray:
    """Plain version of ``scan_prep._segment_rows``: one row a segment."""
    rows = np.zeros((len(off) - 1, row_bytes), np.uint8)
    for s in range(len(off) - 1):
        rows[s, :off[s + 1] - off[s]] = data[off[s]:off[s + 1]]
    return rows


@pytest.mark.parametrize("n_seg", [1, 2, 7])
@pytest.mark.parametrize("padded", [False, True])
def test_segment_rows_equal_a_row_a_segment(n_seg, padded):
    """The rows ``prepare_scan`` packs, from a zero-tailed buffer (the
    parser's ``data_padded``) or from the bytes alone, with empty and
    uneven segments, a first offset above 0 and bytes past the last one:
    each row the segment's bytes, zero past them."""
    rng = np.random.default_rng(n_seg)
    for _ in range(20):
        n = int(rng.integers(1, 400))
        data = rng.integers(1, 256, n + 256, dtype=np.uint8)
        data[n:] = 0
        cut = np.sort(rng.integers(0, n + 1, n_seg + 1))
        if rng.random() < 0.5:
            cut[-1] = n
        row_bytes = 4 * (-(-int(np.diff(cut).max()) // 4) + 2)
        want = _rows_by_segment(data[:n], cut, row_bytes)
        got = scan_prep._segment_rows(data[:n], cut, row_bytes,
                                      data if padded else None)
        assert np.array_equal(got, want), (n, cut)


def test_one_segment_packs_from_the_parsers_buffer(frame):
    """The frame's one segment is packed straight from a zero-tailed
    buffer that begins at the scan's bytes (the parser's ``data_padded``):
    a view, no copy before the byte swap, into the words the plain packing
    gives.  A ``data_padded`` that no longer begins there is not used."""
    hdr = parser.parse(frame.blob)
    scan = hdr.scans[0]
    n, off = len(scan.data), np.asarray(scan.seg_offsets, np.int64)
    base = np.zeros(n + 256, np.uint8)
    base[:n] = scan.data
    scan.data, scan.data_padded = base[:n], base
    assert scan_prep._zero_tail(scan, scan.data) is base
    words = scan_prep.prepare_scan(hdr, scan)[0]
    row = scan_prep._segment_rows(scan.data, off, 4 * words.shape[1], base)
    assert np.shares_memory(row, base)
    assert np.array_equal(words[0],
                          scan_prep.pack_words(scan.data)[:words.shape[1]])
    scan.data = base[:n].copy()
    assert scan_prep._zero_tail(scan, scan.data) is None
    assert np.array_equal(scan_prep.prepare_scan(hdr, scan)[0], words)


def _k2_inputs(blob):
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    words, nm, block_comp, max_mcus, _ = scan_prep.prepare_scan(hdr, scan)
    dc, ac = scan_prep.luts_for_scan(hdr, scan)
    luts = np.empty((2 * len(hdr.components), 1 << 16), np.int32)
    luts[0::2], luts[1::2] = dc, ac
    return hdr, scan, words, nm, luts, block_comp, max_mcus


def test_chunked_model_splits_the_long_stream(frame):
    """(b): K2's chunked model on the frame's one segment at 32-bit chunks
    and 16 chunks a CTA (about 200 CTAs) equals the sequential decode, and
    the cross-CTA rounds and the serial seal both had work."""
    hdr, scan, words, nm, luts, block_comp, max_mcus = _k2_inputs(
        frame.blob)
    stats = {}
    out, err = entropy_cuda.decode_segments_chunked_torch(
        torch.from_numpy(words), torch.from_numpy(nm), torch.from_numpy(luts),
        block_comp=block_comp, n_comps=3, max_mcus=max_mcus, chunk_bits=32,
        lanes_per_cta=16, stats=stats)
    want = python_ref.decode_scan_baseline(hdr, scan)
    assert err.tolist() == [0]
    assert np.array_equal(out.view(-1, 64).numpy(), want)
    assert stats["chunks"] == int(entropy_cuda.seg_chunks(
        torch.from_numpy(words), 32).sum())
    assert stats["chunks"] // 16 >= 100
    assert stats["global_round_ctas"] > 0 and stats["seal_redecodes"] > 0


def test_cell_reports_its_metrics():
    """(c): the cell, its traffic and its metrics as BENCHMARK.json gives
    them."""
    cell = harness.load_cell(ROOT, "photo12_open")
    assert cell.config == CONFIG and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"request_p50_ms",
                                                    "setup_s"}
    per = {m["name"]: m for m in cell.per_layer}
    assert set(per) == set(NEW_METRICS + SHARED_METRICS)
    for name in NEW_METRICS:
        assert per[name]["workloads"] == ["photo12_open"]
        assert per[name]["moves"] == "request_p50_ms"
        assert callable(harness.reader(name).read)
    mix = cell.mix
    assert (mix["kind"], mix["fps"], mix["phase"]) == ("open", 10, "even")
    assert mix["cameras"] >= 1 and harness.n_distinct(cell) == mix["cameras"]


def test_full_size_takes_k6b():
    """At 4032 x 3024 4:2:0 under ``exact`` + ``fancy`` K6b's plan fits its
    shared memory, so ``decode()`` takes the K6b route on the card."""
    head, tail = corpus.headers(3024, 4032, CONFIG["frame"]["samplings"],
                                [corpus.qtable(CONFIG["frame"]["quality"]),
                                 corpus.qtable(CONFIG["frame"]["quality"],
                                               True)],
                                0)
    hdr = parser.parse(head + b"\x00" + tail)
    plan = decoder._k6b_plan(hdr, "fancy")
    assert plan is not None
    assert decoder.k6b_route("exact", False, "cuda", plan)


def test_cpu_decode_counts_no_k2_stats():
    """On the CPU K2's plain twin runs: no launch, so no statistics and no
    ``entropy.stats`` span.  (Two MCUs of the recipe: the profiler records
    every torch operation of the twin.)"""
    recipe = dict(CONFIG["frame"], width=32, height=16)
    blob = corpus.make_frames(recipe, SEED, 1, "cpu")[0].blob
    with profile():
        decode(blob, entropy="pallas", idct="exact", upsample="fancy",
               device="cpu")
        names = {s.name for s in profiling.spans()}
        counted = profiling.counters()
    assert "entropy.stats" not in names and "entropy.flags" in names
    assert not any(k in counted for k in entropy_cuda.COUNTERS)


def _tail(chunks: list, stats: dict) -> torch.Tensor:
    """A launch's ``tail``: chunks, statistics, then clear error flags."""
    return torch.tensor(chunks + [stats[k] for k in entropy_cuda.STATS]
                        + [0] * len(chunks), dtype=torch.int32)


def test_count_stats_records_four_counters():
    stats = {"round0_iterations": 5, "global_round_ctas": 3,
             "global_round_iterations": 2, "seal_redecodes": 7,
             "sync_decodes": 900}
    with profile():
        entropy_cuda.count_stats(_tail([400, 300, 1], stats))
        got = {k: v for k, v in profiling.counters().items()
               if k.startswith("k2.")}
    assert got == {"k2.chunks": 701, "k2.sync_decodes": 900,
                   "k2.seal_redecodes": 7, "k2.global_round_ctas": 3}
    assert not profiling.recording()


W0, W1 = 1_000, 100_000


def _ctx(monkeypatch, counts):
    """A traced run's context with two decode() calls in the window and
    one after it, and the given counter increments."""
    spans = [SpanRecord("decode", t, t + 1_000, 1_000, 7, 10 * c, None, c)
             for c, t in ((1, 2_000), (2, 10_000), (3, W1 + 10))]
    red = trace.Reduced(window_s=(W1 - W0) * 1e-9, busy_s=0.0,
                        device_ops=[], idle_gaps=[], top_ops=[],
                        spans=[(trace.WINDOW, W0, W1, 1)], all_ops=[])
    monkeypatch.setattr(stages, "recorded", lambda: (spans, counts))
    monkeypatch.setattr(stages, "_print", lambda line: None)
    return types.SimpleNamespace(trace=red)


def _launch(call: int, t: int, chunks: int, sync: int, seal: int) -> list:
    return [CountRecord("k2.chunks", chunks, t, 7, call),
            CountRecord("k2.sync_decodes", sync, t, 7, call),
            CountRecord("k2.seal_redecodes", seal, t, 7, call),
            CountRecord("k2.global_round_ctas", 2, t, 7, call)]


def test_k2_readers_on_hand_built_counts(monkeypatch):
    """Sync decodes per chunk over the window's calls, and the seal's mean
    re-decodes a call; the call after the window is left out."""
    counts = (_launch(1, 2_500, 16_000, 17_000, 4)
              + _launch(2, 10_500, 16_400, 16_900, 0)
              + _launch(3, W1 + 20, 99, 9_999, 999))
    ctx = _ctx(monkeypatch, counts)
    assert harness.reader("photo.k2_sync_per_chunk").read(ctx) == \
        pytest.approx(33_900 / 32_400, rel=1e-12)
    assert harness.reader("photo.k2_seal_redecodes").read(ctx) == 2.0


@pytest.mark.parametrize("name", ["photo.k2_sync_per_chunk",
                                  "photo.k2_seal_redecodes"])
def test_k2_readers_without_counters(monkeypatch, name):
    """A program that counts nothing of K2 (the parent of these counters,
    or the CPU) reads None, and so does one without a recorder."""
    reader = harness.reader(name)
    ctx = _ctx(monkeypatch, [CountRecord("pixel.k6b", 1, 2_500, 7, 1)])
    assert reader.read(ctx) is None
    monkeypatch.setattr(stages, "recorded", lambda: None)
    assert reader.read(types.SimpleNamespace(trace=ctx.trace)) is None
