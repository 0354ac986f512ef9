"""K2 reading each restart segment in place from the parser's scan bytes
(``entropy_cuda.decode_scan_bytes``) on the card.

Its blocks, error flags, chunk counts and statistics equal those of the
same launch on the rows ``scan_prep.prepare_scan`` packs
(``decode_segments``), and its blocks the native host decoder's, on the
benchmark's two frames (a 1080p DRI-120 RTP/JPEG frame and a 4032 x 3024
DRI-0 q95 photo), with the scan at every byte alignment of a buffer that
ends exactly where it does.  Bytes past a segment's end read as zero where
the next segment's would decode otherwise, and ``decode()`` on the card
never packs rows.  Every test needs an NVIDIA card (``cuda`` marker) and
skips without one; the file imports neither jax nor PIL:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_scan_in_place.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu_torch import decode
from jpeg_decoder_tpu_torch.entropy import native
from jpeg_decoder_tpu_torch.io import parser
from jpeg_decoder_tpu_torch.ops import entropy_cuda, scan_prep
from jpeg_decoder_tpu_torch.testing.encoder import encode
from jpeg_decoder_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import corpus, harness  # noqa: E402

pytestmark = pytest.mark.cuda

SEED = 2**31 + 24
CONFIGS = ("rtp1080_service", "photo12_ingest")
_BLOBS: dict = {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _config(name: str) -> dict:
    return harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                          f"{name}.json"))


def _blob(name: str, dev) -> bytes:
    """The configuration's frame, made once on the card from ``SEED``."""
    if name not in _BLOBS:
        _BLOBS[name] = corpus.make_frames(_config(name)["frame"], SEED, 1,
                                          dev)[0].blob
    return _BLOBS[name]


def _both(hdr, scan, data, seg, n_words, dev):
    """K2 on the packed rows and on ``data`` read in place: each form's
    (blocks, flags) and its tail (chunks, statistics, flags)."""
    words, nm, block_comp, max_mcus, _ = scan_prep.prepare_scan(hdr, scan)
    luts, l1 = entropy_cuda.device_tables(hdr, scan, dev)
    kw = dict(block_comp=block_comp, n_comps=len(hdr.components),
              max_mcus=max_mcus, l1=l1, precision=hdr.precision)
    rows_tail, bytes_tail = [], []
    rows = entropy_cuda.decode_segments(
        torch.from_numpy(words).to(dev), torch.from_numpy(nm).to(dev), luts,
        **kw, tail=rows_tail)
    in_place = entropy_cuda.decode_scan_bytes(
        data, torch.from_numpy(seg).to(dev), luts, n_words=n_words, **kw,
        tail=bytes_tail)
    torch.cuda.synchronize()
    return rows, in_place, rows_tail[0].cpu(), bytes_tail[0].cpu()


@pytest.mark.parametrize("name", CONFIGS)
def test_in_place_equals_rows_and_native(cuda_device, name):
    """The frame's scan at byte 0..3 of a buffer that ends exactly at the
    scan (no padding; the offsets unaligned): the same blocks, flags, chunks
    and statistics as the packed rows, and the native decoder's blocks."""
    hdr = parser.parse(_blob(name, cuda_device))
    scan = hdr.scans[0]
    seg, n_words, block_comp, _, lay = scan_prep.segment_table(hdr, scan)
    n_seg = len(scan.seg_offsets) - 1
    assert n_seg == (68 if name == "rtp1080_service" else 1)
    want = native.decode_scan_baseline(hdr, scan)
    n = lay.n_mcus * len(block_comp)
    for shift in range(4):
        buf = torch.full((shift + len(scan.data),), 0xFF, dtype=torch.uint8)
        buf[shift:] = torch.from_numpy(scan.data)
        moved = seg.copy()
        moved[:n_seg + 1] += shift
        (r_out, r_err), (b_out, b_err), r_tail, b_tail = _both(
            hdr, scan, buf.to(cuda_device), moved, n_words, cuda_device)
        assert torch.equal(b_err, r_err) and not b_err.any(), shift
        assert torch.equal(b_tail, r_tail), shift
        assert torch.equal(b_out, r_out), shift
        np.testing.assert_array_equal(
            b_out.view(-1, 64)[:n].cpu().numpy(), want)


def _segments_cut_short(blob: bytes):
    """A DRI-1 frame's scan with 1..3 bytes taken off the end of every
    segment and the bytes closed up over them: (hdr, scan, bytes, offsets)."""
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    off = np.asarray(scan.seg_offsets, np.int64)
    parts = [scan.data[off[s]:off[s + 1] - 1 - s % 3]
             for s in range(len(off) - 1)]
    cut = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    return hdr, scan, np.concatenate(parts), cut.astype(np.int64)


def test_in_place_reads_zero_past_each_segment(cuda_device):
    """Segments cut short, so that each one's decode reads past its end:
    in place those bytes are zero, as in the packed rows (flags and the
    blocks of every segment), and rows that read on into the next
    segment's first bytes instead decode otherwise."""
    rng = np.random.default_rng(24)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    hdr, scan, data, cut = _segments_cut_short(
        encode(rgb, quality=95, restart_interval=1)[0])
    n_seg = len(cut) - 1
    words, nm, block_comp, max_mcus, _ = scan_prep.prepare_scan(hdr, scan)
    n_words = scan_prep.row_words(cut)
    rows = np.zeros((n_seg, 4 * n_words), np.uint8)
    on = np.zeros_like(rows)
    padded = np.concatenate([data, np.zeros(4 * n_words, np.uint8)])
    for s in range(n_seg):
        rows[s, :cut[s + 1] - cut[s]] = data[cut[s]:cut[s + 1]]
        on[s] = padded[cut[s]:cut[s] + 4 * n_words]
    luts, l1 = entropy_cuda.device_tables(hdr, scan, cuda_device)
    kw = dict(block_comp=block_comp, n_comps=len(hdr.components),
              max_mcus=max_mcus, l1=l1)
    seg = np.concatenate([cut, nm]).astype(np.int64)
    got = entropy_cuda.decode_scan_bytes(
        torch.from_numpy(data).to(cuda_device),
        torch.from_numpy(seg).to(cuda_device), luts, n_words=n_words, **kw)
    nm_dev = torch.from_numpy(nm).to(cuda_device)

    def packed(b):
        w = torch.from_numpy(b.view(">u4").astype(np.uint32))
        return entropy_cuda.decode_segments(w.to(cuda_device), nm_dev, luts,
                                            **kw)

    zero, read_on = packed(rows), packed(on)
    assert torch.equal(got[1], zero[1]) and torch.equal(got[0], zero[0])
    assert not (torch.equal(read_on[1], zero[1])
                and torch.equal(read_on[0], zero[0]))


def test_in_place_refuses_an_unaligned_buffer(cuda_device):
    blob = encode(np.zeros((16, 16, 3), np.uint8), quality=75)[0]
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    seg, n_words, block_comp, max_mcus, _ = scan_prep.segment_table(hdr,
                                                                    scan)
    luts = entropy_cuda.device_tables(hdr, scan, cuda_device)[0]
    data = torch.zeros(len(scan.data) + 1, dtype=torch.uint8,
                       device=cuda_device)
    with pytest.raises(ValueError):
        entropy_cuda.decode_scan_bytes(
            data[1:], torch.from_numpy(seg).to(cuda_device), luts,
            n_words=n_words, block_comp=block_comp, n_comps=3,
            max_mcus=max_mcus)


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_on_card_packs_no_rows(cuda_device, name, monkeypatch):
    """The cell's ``decode()`` call on the card with ``_segment_rows``
    made to raise: one K2 launch that read the scan in place (the counter
    ``entropy.scan_in_place``), RGB equal to the native host decode's."""
    blob = _blob(name, cuda_device)
    kw = dict(_config(name)["kwargs"], device=cuda_device)
    want = decode(blob, **dict(kw, entropy="native")).rgb

    def refuse(*args, **kwargs):
        raise AssertionError("decode() packed rows on the card")

    monkeypatch.setattr(scan_prep, "_segment_rows", refuse)
    # The recorder on without a torch profiler: a profiler session here
    # would keep later ones in the process from tracing the card.
    monkeypatch.setattr(profiling, "recording", lambda: True)
    before = entropy_cuda.decode_segments.launches
    got = decode(blob, **kw).rgb
    torch.cuda.synchronize()
    counted = profiling.counters()
    assert entropy_cuda.decode_segments.launches == before + 1
    assert counted.get("entropy.scan_in_place") == 1
    assert torch.equal(got, want)
