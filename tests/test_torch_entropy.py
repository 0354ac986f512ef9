"""Entropy decode of the PyTorch port against the JAX package, exactly.

The same blobs, made from a numpy seed by tools/encoder.py and PIL, go
through both packages:

* the K2 twin ``entropy_cuda.decode_segments_torch`` against the Pallas
  kernel ``entropy_pallas.decode_segments_pallas`` run in interpret mode, on
  the same words, MCU counts and LUTs: equal blocks on every valid row and
  equal error flags (JAX leaves rows past ``nm[s]*bpm`` unspecified);
* the model of the chunked K2 kernel,
  ``entropy_cuda.decode_segments_chunked_torch``, against both, at chunk
  sizes that start lanes mid-code, under every schedule of its
  synchronisation (inside CTAs, across them, the serial seal), and its
  phase-0 first-level tables against the JAX native decoder's;
* the port's device backend ``entropy_cuda.decode_scan_baseline`` on the
  CPU against JAX's ``decode_scan_baseline``;
* the host copies (``scan_prep``, ``python_ref``) against their originals,
  and the port's native bindings against JAX's python_ref;
* the LUT-probe twins (K3/K4) against tools/pallas_mosaic_repro.py's
  expected values.

Interpret mode compiles once per shape (seconds) and then runs fast, so the
images stay as small as tests/test_entropy_pallas.py's.  The CUDA kernels
are held to these twins on the card in tests/test_torch_cuda.py.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu.entropy import python_ref as jref  # noqa: E402
from jpeg_decoder_tpu.io import parser as jparser  # noqa: E402
from jpeg_decoder_tpu.ops import entropy_pallas  # noqa: E402
from jpeg_decoder_tpu.ops import scan_prep as jprep  # noqa: E402

from jpeg_decoder_tpu_torch import JPEGError  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import native as tnative  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import python_ref as tref  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser as tparser  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_cuda  # noqa: E402
from jpeg_decoder_tpu_torch.ops import scan_prep as tprep  # noqa: E402
from jpeg_decoder_tpu_torch.probes import lut_probe  # noqa: E402


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 6.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


# (samplings or "gray", quality, restart_interval, (h, w))
CASES = [
    (((2, 2), (1, 1), (1, 1)), 90, 2, (32, 48)),
    (((2, 2), (1, 1), (1, 1)), 80, 0, (16, 32)),
    (((1, 1), (1, 1), (1, 1)), 95, 5, (40, 48)),
    (((2, 2), (1, 1), (1, 1)), 75, 1, (37, 53)),
    ("gray", 85, 2, (24, 40)),
    (((2, 1), (1, 1), (1, 1)), 60, 1, (17, 30)),
]


def _blob(k):
    samp, q, ri, (h, w) = CASES[k]
    if samp == "gray":
        return encode(_rgb(k, h, w)[..., 0], grayscale=True, quality=q,
                      samplings=((1, 1),), restart_interval=ri)[0]
    return encode(_rgb(k, h, w), samplings=samp, quality=q,
                  restart_interval=ri)[0]


def _pil_restart_blob():
    buf = io.BytesIO()
    Image.fromarray(_rgb(9, 32, 48)).save(buf, "JPEG", quality=90,
                                          restart_marker_blocks=2)
    return buf.getvalue()


BLOBS = [_blob(k) for k in range(len(CASES))] + [_pil_restart_blob()]


def _drop_second_rst(blob: bytes) -> bytes:
    """Remove the RST1 marker: one restart segment fewer than DRI says."""
    i = blob.index(b"\xff\xd1")
    return blob[:i] + blob[i + 2:]


def _kernel_inputs(blob):
    """JAX scan prep of ``blob``: words, nm, block_comp, max_mcus and the
    interleaved (2n, 65536) LUTs the kernels read."""
    hdr = jparser.parse(blob)
    scan = hdr.scans[0]
    words, nm, block_comp, max_mcus, _ = jprep.prepare_scan(hdr, scan)
    dc, ac = jprep.luts_for_scan(hdr, scan)
    luts = np.empty((2 * len(hdr.components), 1 << 16), np.int32)
    luts[0::2], luts[1::2] = dc, ac
    kw = dict(block_comp=block_comp, n_comps=len(hdr.components),
              max_mcus=max_mcus)
    return words, nm, luts, kw


def _both_kernels(words, nm, luts, kw):
    jout, jerr = entropy_pallas.decode_segments_pallas(
        jnp.asarray(words), jnp.asarray(nm), jnp.asarray(luts),
        interpret=True, **kw)
    tout, terr = entropy_cuda.decode_segments_torch(
        torch.from_numpy(words), torch.from_numpy(nm), torch.from_numpy(luts),
        **kw)
    return (np.asarray(jout), np.asarray(jerr)), (tout.numpy(), terr.numpy())


def _assert_valid_rows_equal(got, ref, nm, bpm, segments):
    for s in segments:
        n = int(nm[s]) * bpm
        np.testing.assert_array_equal(got[s, :n], ref[s, :n])
        assert not got[s, n:].any()


@pytest.mark.parametrize("k", range(len(BLOBS)))
def test_twin_matches_pallas_kernel(k):
    words, nm, luts, kw = _kernel_inputs(BLOBS[k])
    (jout, jerr), (tout, terr) = _both_kernels(words, nm, luts, kw)
    assert tout.dtype == np.int32 and terr.dtype == np.int32
    assert tout.shape == jout.shape
    np.testing.assert_array_equal(terr, jerr)
    assert not terr.any()
    _assert_valid_rows_equal(tout, jout, nm, len(kw["block_comp"]),
                             range(len(nm)))


def test_twin_flags_corrupt_segments_as_pallas_kernel():
    """Random words after the first in every third segment and one all-ones
    segment (the all-ones code is never assigned): equal flags, and equal
    blocks in every segment neither flags (garbage decodes included)."""
    words, nm, luts, kw = _kernel_inputs(BLOBS[0])
    rng = np.random.default_rng(3)
    for s in range(0, len(words), 3):
        words[s, 1:] = rng.integers(0, 2**32, words.shape[1] - 1,
                                    dtype=np.uint64)
    words[1, :] = 0xFFFFFFFF
    (jout, jerr), (tout, terr) = _both_kernels(words, nm, luts, kw)
    np.testing.assert_array_equal(terr, jerr)
    assert terr[1] == 1
    _assert_valid_rows_equal(tout, jout, nm, len(kw["block_comp"]),
                             np.flatnonzero(terr == 0))


def test_twin_decodes_at_most_max_mcus_as_pallas_kernel():
    """MCU counts above max_mcus decode max_mcus MCUs in both (the last
    segment then decodes its zero padding past the end of its data)."""
    words, nm, luts, kw = _kernel_inputs(BLOBS[3])
    nm = nm + 3
    (jout, jerr), (tout, terr) = _both_kernels(words, nm, luts, kw)
    np.testing.assert_array_equal(terr, jerr)
    _assert_valid_rows_equal(tout, jout, np.minimum(nm, kw["max_mcus"]),
                             len(kw["block_comp"]), range(len(nm)))


CHUNKS = [32, 96, 1024]


def _chunked(words, nm, luts, kw, chunk_bits, **extra):
    got, err = entropy_cuda.decode_segments_chunked_torch(
        torch.from_numpy(words), torch.from_numpy(nm), torch.from_numpy(luts),
        chunk_bits=chunk_bits, **kw, **extra)
    return got.numpy(), err.numpy()


@pytest.mark.parametrize("chunk_bits", CHUNKS)
@pytest.mark.parametrize("k", range(len(BLOBS)))
def test_chunked_model_matches_pallas_kernel_and_twin(k, chunk_bits):
    """The chunked kernel's model (speculative chunks that synchronise)
    equals the sequential twin everywhere and the Pallas kernel on every
    valid row, error flags included; 32-bit chunks start mid-code."""
    words, nm, luts, kw = _kernel_inputs(BLOBS[k])
    (jout, jerr), (tout, terr) = _both_kernels(words, nm, luts, kw)
    got, err = _chunked(words, nm, luts, kw, chunk_bits)
    assert got.dtype == np.int32 and err.dtype == np.int32
    np.testing.assert_array_equal(got, tout)
    np.testing.assert_array_equal(err, terr)
    np.testing.assert_array_equal(err, jerr)
    _assert_valid_rows_equal(got, jout, nm, len(kw["block_comp"]),
                             range(len(nm)))


def _dri0_inputs():
    blob = encode(_rgb(21, 64, 96), samplings=((2, 2), (1, 1), (1, 1)),
                  quality=90, restart_interval=0)[0]
    return blob, _kernel_inputs(blob)


@pytest.mark.parametrize("lanes,rounds", [(64, 1), (4, 0), (2, 3)])
@pytest.mark.parametrize("chunk_bits", CHUNKS)
def test_chunked_model_dri0_every_schedule(chunk_bits, lanes, rounds):
    """A DRI=0 scan (one segment) split into chunks: exact against the
    twin and python_ref whether the chunks settle inside CTAs, across them,
    or only in the serial seal (no cross-CTA round, 4-chunk CTAs)."""
    blob, (words, nm, luts, kw) = _dri0_inputs()
    assert words.shape[0] == 1
    st = {}
    got, err = _chunked(words, nm, luts, kw, chunk_bits, lanes_per_cta=lanes,
                        global_rounds=rounds, stats=st)
    ref, ref_err = entropy_cuda.decode_segments_torch(
        torch.from_numpy(words), torch.from_numpy(nm), torch.from_numpy(luts),
        **kw)
    np.testing.assert_array_equal(got, ref.numpy())
    assert not err.any() and not ref_err.any()
    hdr = jparser.parse(blob)
    n = int(nm[0]) * len(kw["block_comp"])
    np.testing.assert_array_equal(
        got[0, :n], jref.decode_scan_baseline(hdr, hdr.scans[0]))
    assert st["chunks"] == int(entropy_cuda.seg_chunks(
        torch.from_numpy(words), chunk_bits)[0])
    if chunk_bits == 32:
        # Mid-code starts: chunks need more than one re-decode to settle,
        # and without a cross-CTA round the seal must repair CTA heads.
        assert st["chunks"] > 100
        assert st["sync_decodes"] > st["chunks"]
        if lanes == 4 and rounds == 0:
            assert st["seal_redecodes"] > 0
        if lanes == 64:
            assert st["round0_iterations"] > 2


@pytest.mark.parametrize("chunk_bits", CHUNKS)
def test_chunked_model_flags_corrupt_segments_as_twin(chunk_bits):
    """The corrupt stream of test_twin_flags_corrupt_segments_as_pallas_kernel:
    the same flags as the sequential twin and the Pallas kernel, and the
    same blocks in every unflagged segment (garbage decodes included)."""
    words, nm, luts, kw = _kernel_inputs(BLOBS[0])
    rng = np.random.default_rng(3)
    for s in range(0, len(words), 3):
        words[s, 1:] = rng.integers(0, 2**32, words.shape[1] - 1,
                                    dtype=np.uint64)
    words[1, :] = 0xFFFFFFFF
    (jout, jerr), (tout, terr) = _both_kernels(words, nm, luts, kw)
    got, err = _chunked(words, nm, luts, kw, chunk_bits)
    np.testing.assert_array_equal(err, terr)
    np.testing.assert_array_equal(err, jerr)
    assert err[1] == 1
    ok = np.flatnonzero(err == 0)
    np.testing.assert_array_equal(got[ok], tout[ok])


@pytest.mark.parametrize("chunk_bits", CHUNKS)
def test_chunked_model_decodes_at_most_max_mcus(chunk_bits):
    """MCU counts above max_mcus: max_mcus MCUs, the last segment's taken
    from its zero padding past its data, as the twin and Pallas do."""
    words, nm, luts, kw = _kernel_inputs(BLOBS[3])
    nm = nm + 3
    (jout, jerr), (tout, terr) = _both_kernels(words, nm, luts, kw)
    got, err = _chunked(words, nm, luts, kw, chunk_bits)
    np.testing.assert_array_equal(got, tout)
    np.testing.assert_array_equal(err, terr)
    _assert_valid_rows_equal(got, jout, np.minimum(nm, kw["max_mcus"]),
                             len(kw["block_comp"]), range(len(nm)))


def test_chunked_model_empty_and_short_segments():
    """A segment with no MCUs writes nothing and flags nothing; one whose
    bits end early is decoded on by its last chunk from zero words."""
    words, nm, luts, kw = _kernel_inputs(BLOBS[2])
    nm = nm.copy()
    nm[0] = 0
    words[1, 2:] = 0
    got, err = _chunked(words, nm, luts, kw, 32)
    ref, ref_err = entropy_cuda.decode_segments_torch(
        torch.from_numpy(words), torch.from_numpy(nm), torch.from_numpy(luts),
        **kw)
    np.testing.assert_array_equal(got, ref.numpy())
    np.testing.assert_array_equal(err, ref_err.numpy())
    assert not got[0].any() and err[0] == 0


def test_chunked_model_rejects_bad_chunk_size():
    words, nm, luts, kw = _kernel_inputs(BLOBS[0])
    with pytest.raises(ValueError):
        _chunked(words, nm, luts, kw, 48)


def test_seg_chunks_counts_bits_to_last_nonzero_word():
    words = torch.zeros((3, 10), dtype=torch.uint32)
    words[0, 9] = 1
    words[1, 3] = 7
    got = entropy_cuda.seg_chunks(words, 64)
    assert got.tolist() == [5, 2, 1]


@pytest.mark.parametrize("k", [0, 2, 4])
def test_first_level_tables_match_jax_native(k):
    """Phase 0's plain version equals the first-level table the JAX
    package's native decoder appends to its int16 LUTs."""
    from jpeg_decoder_tpu.entropy import native as jnative

    hdr = jparser.parse(BLOBS[k])
    scan = hdr.scans[0]
    _, _, luts, _ = _kernel_inputs(BLOBS[k])
    got = entropy_cuda.first_level(torch.from_numpy(luts))
    assert got.dtype == torch.int16 and got.shape == (len(luts), 4096)
    for c, comp in enumerate(hdr.components):
        for t, spec in ((2 * c, scan.dc_specs[comp.td]),
                        (2 * c + 1, scan.ac_specs[comp.ta])):
            np.testing.assert_array_equal(got[t].numpy(),
                                          jnative._lut16(spec)[65536:])


def test_device_tables_cached_per_table_set():
    """One upload per table set and device: a scan with the same tables
    reuses the entry; the oldest set is dropped past the limit (the
    encoder's quality does not change its tables, so PIL makes new ones)."""
    entropy_cuda.clear_table_cache()
    hdr0, hdr2 = tparser.parse(BLOBS[0]), tparser.parse(BLOBS[2])
    luts, l1 = entropy_cuda.device_tables(hdr0, hdr0.scans[0], "cpu")
    assert l1 is None and luts.dtype == torch.int32
    again = entropy_cuda.device_tables(hdr0, hdr0.scans[0], "cpu")
    assert again[0] is luts
    _, _, ref, _ = _kernel_inputs(BLOBS[0])
    np.testing.assert_array_equal(luts.numpy(), ref)
    # Another image with the same (standard) tables shares the entry.
    assert entropy_cuda.device_tables(hdr2, hdr2.scans[0], "cpu")[0] is luts
    keys = set()
    for q in range(entropy_cuda.TABLE_CACHE_SIZE + 1):
        buf = io.BytesIO()
        Image.fromarray(_rgb(q, 16, 16)).save(buf, "JPEG", quality=50 + q,
                                              optimize=True)
        h = tparser.parse(buf.getvalue())
        got = entropy_cuda.device_tables(h, h.scans[0], "cpu")[0]
        keys.add(got.numpy().tobytes())
    assert len(keys) == entropy_cuda.TABLE_CACHE_SIZE + 1
    assert entropy_cuda.device_tables(hdr0, hdr0.scans[0], "cpu")[0] \
        is not luts
    entropy_cuda.clear_table_cache()


def test_kernel_constants_match_model():
    """The model's CTA size and table width are the kernel's."""
    import re

    src = open(entropy_cuda.LIB.src).read()
    assert int(re.search(r"kSyncLanes = (\d+);", src).group(1)) == \
        entropy_cuda.SYNC_LANES
    assert int(re.search(r"kL1Bits = (\d+);", src).group(1)) == \
        entropy_cuda.L1_BITS
    assert int(re.search(r"kStats = (\d+);", src).group(1)) == \
        len(entropy_cuda.STATS)


@pytest.mark.parametrize("k", [0, 1, 3, 4])
def test_device_backend_on_cpu_matches_jax(k):
    """entropy_cuda.decode_scan_baseline(hdr, scan, "cpu") equals JAX's
    pallas backend (case 1 is DRI=0: one lane) and python_ref."""
    jhdr, thdr = jparser.parse(BLOBS[k]), tparser.parse(BLOBS[k])
    ref = entropy_pallas.decode_scan_baseline(jhdr, jhdr.scans[0],
                                              interpret=True)
    got = entropy_cuda.decode_scan_baseline(thdr, thdr.scans[0], "cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        ref, jref.decode_scan_baseline(jhdr, jhdr.scans[0]))


def test_device_backend_raises_on_corrupt_stream():
    hdr = tparser.parse(BLOBS[0])
    scan = hdr.scans[0]
    data = scan.data.copy()
    data[scan.seg_offsets[1]:scan.seg_offsets[1] + 6] = 0xFF
    scan.data = data
    with pytest.raises(JPEGError, match="segments \\[1\\]"):
        entropy_cuda.decode_scan_baseline(hdr, scan, "cpu")


@pytest.mark.parametrize("k", range(len(BLOBS)))
def test_scan_prep_matches_jax(k):
    jhdr, thdr = jparser.parse(BLOBS[k]), tparser.parse(BLOBS[k])
    ref = jprep.prepare_scan(jhdr, jhdr.scans[0])
    got = tprep.prepare_scan(thdr, thdr.scans[0])
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2:4] == ref[2:4]
    for a, b in zip(tprep.luts_for_scan(thdr, thdr.scans[0]),
                    jprep.luts_for_scan(jhdr, jhdr.scans[0])):
        np.testing.assert_array_equal(a, b)
    data = np.frombuffer(BLOBS[k], np.uint8)[:37]
    np.testing.assert_array_equal(tprep.pack_words(data),
                                  jprep.pack_words(data))


def _mismatch_blobs():
    return [_drop_second_rst(BLOBS[k]) for k in (0, 2, 6)]


@pytest.mark.parametrize("k", range(len(BLOBS)))
def test_python_ref_baseline_matches_jax(k):
    jhdr, thdr = jparser.parse(BLOBS[k]), tparser.parse(BLOBS[k])
    np.testing.assert_array_equal(
        tref.decode_scan_baseline(thdr, thdr.scans[0]),
        jref.decode_scan_baseline(jhdr, jhdr.scans[0]))


@pytest.mark.parametrize("blob", _mismatch_blobs())
def test_python_ref_resilient_matches_jax(blob):
    jhdr, thdr = jparser.parse(blob), tparser.parse(blob)
    ref = jref.decode_scan_resilient(jhdr, jhdr.scans[0])
    np.testing.assert_array_equal(
        tref.decode_scan_resilient(thdr, thdr.scans[0]), ref)
    np.testing.assert_array_equal(
        tnative.decode_scan_resilient(thdr, thdr.scans[0]), ref)


def test_python_ref_sequential_matches_jax():
    """A two-scan sequential frame, decoded scan by scan into planes."""
    blob = encode(_rgb(12, 40, 48), scans=[(0,), (1, 2)],
                  restart_interval=3)[0]
    jhdr, thdr = jparser.parse(blob), tparser.parse(blob)
    from jpeg_decoder_tpu import layout as jlayout

    lay = jlayout.scan_layout(jhdr)
    ref = [np.zeros((*s, 64), np.int32) for s in lay.comp_shapes]
    got = [np.zeros((*s, 64), np.int32) for s in lay.comp_shapes]
    for js, ts in zip(jhdr.scans, thdr.scans):
        jref.decode_scan_sequential_into(jhdr, js, ref)
        tref.decode_scan_sequential_into(thdr, ts, got)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_threads", [1, 2])
@pytest.mark.parametrize("k", range(len(BLOBS)))
def test_native_baseline_matches_jax_python_ref(k, n_threads):
    jhdr, thdr = jparser.parse(BLOBS[k]), tparser.parse(BLOBS[k])
    got = tnative.decode_scan_baseline(thdr, thdr.scans[0],
                                       n_threads=n_threads)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, jref.decode_scan_baseline(jhdr, jhdr.scans[0]))


def test_native_baseline_12bit_matches_jax_python_ref():
    blob = encode(_rgb(13, 24, 32), precision=12, restart_interval=2)[0]
    jhdr, thdr = jparser.parse(blob), tparser.parse(blob)
    assert thdr.precision == 12
    np.testing.assert_array_equal(
        tnative.decode_scan_baseline(thdr, thdr.scans[0]),
        jref.decode_scan_baseline(jhdr, jhdr.scans[0]))


def test_native_available():
    assert tnative.available()


def test_lut_chain_twin_equals_expected():
    """tools/pallas_mosaic_repro.py:37-41: the chain over its 8 indices."""
    idx = np.array([[17], [4093], [65535], [2], [9], [100], [7], [31]],
                   np.int32)
    expected = 0
    for i in range(8):
        expected += (int(idx[i, 0]) + expected) & 0xFFFF
    assert tuple(idx[:, 0]) == lut_probe.CHAIN_IDX
    assert lut_probe.chain_expected(lut_probe.CHAIN_IDX) == expected
    lut = torch.arange(65536, dtype=torch.int32)
    got = lut_probe.lut_chain_probe(lut, torch.from_numpy(idx))
    assert got.dtype == torch.int32 and int(got) == expected


def test_lut_gather_twin_equals_take():
    """tools/pallas_mosaic_repro.py:99-126: lut[idx] for (8, 128) indices
    drawn from seed 0, the JAX file's check."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 65536, (8, 128), np.int32)
    lut = np.arange(65536, dtype=np.int32)
    got = lut_probe.lut_gather(torch.from_numpy(lut), torch.from_numpy(idx))
    assert got.shape == (8, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), lut[idx])


# 12-bit frames (T.81 size categories up to 15 for DC and 14 for AC):
# (samplings or "gray", restart_interval, (h, w)).
CASES_12 = [(((2, 2), (1, 1), (1, 1)), 2, (24, 32)),
            (((2, 2), (1, 1), (1, 1)), 0, (16, 32)),
            ("gray", 3, (24, 40))]


def _blob12(k):
    samp, ri, (h, w) = CASES_12[k]
    if samp == "gray":
        return encode(_rgb(40 + k, h, w)[..., 1], grayscale=True,
                      samplings=((1, 1),), precision=12,
                      restart_interval=ri)[0]
    return encode(_rgb(40 + k, h, w), samplings=samp, precision=12,
                  restart_interval=ri)[0]


def _inputs12(k):
    thdr = tparser.parse(_blob12(k))
    words, nm, luts, kw = _kernel_inputs(_blob12(k))
    ref = tnative.decode_scan_baseline(thdr, thdr.scans[0])
    return thdr, words, nm, luts, kw, ref


def _scan_rows(out, nm, kw, n_blocks):
    """Segment rows of an (S, rows, 64) output back to scan order."""
    bpm = len(kw["block_comp"])
    return np.concatenate([out[s, :int(nm[s]) * bpm]
                           for s in range(len(nm))])[:n_blocks]


@pytest.mark.parametrize("k", range(len(CASES_12)))
def test_twin_12bit_matches_native(k):
    """The K2 twin at precision 12 equals the native decoder on 12-bit
    frames; where an AC term needs size 11 the 8-bit categories flag the
    frame (so the wider ones are in use)."""
    thdr, words, nm, luts, kw, ref = _inputs12(k)
    assert thdr.precision == 12
    args = (torch.from_numpy(words), torch.from_numpy(nm),
            torch.from_numpy(luts))
    out, err = entropy_cuda.decode_segments_torch(*args, **kw, precision=12)
    assert not err.any()
    np.testing.assert_array_equal(_scan_rows(out.numpy(), nm, kw, len(ref)),
                                  ref)
    _, err8 = entropy_cuda.decode_segments_torch(*args, **kw)
    assert bool(err8.any()) or np.abs(ref[:, 1:]).max() < 1024
    assert k != 0 or err8.any()


@pytest.mark.parametrize("chunk_bits", [32, 1024])
@pytest.mark.parametrize("k", range(len(CASES_12)))
def test_chunked_model_12bit_matches_native(k, chunk_bits):
    _, words, nm, luts, kw, ref = _inputs12(k)
    got, err = _chunked(words, nm, luts, kw, chunk_bits, precision=12)
    assert not err.any()
    np.testing.assert_array_equal(_scan_rows(got, nm, kw, len(ref)), ref)


@pytest.mark.parametrize("k", range(len(CASES_12)))
def test_device_backend_12bit_on_cpu_matches_jax_lanes(k):
    """entropy_cuda.decode_scan_baseline takes 12-bit frames and equals the
    JAX package's lockstep lanes (entropy_flat.decode_scan_baseline, its
    `jax` backend on restart streams)."""
    from jpeg_decoder_tpu.ops import entropy_flat

    jhdr, thdr = jparser.parse(_blob12(k)), tparser.parse(_blob12(k))
    got = entropy_cuda.decode_scan_baseline(thdr, thdr.scans[0], "cpu")
    np.testing.assert_array_equal(
        got.numpy(), entropy_flat.decode_scan_baseline(jhdr, jhdr.scans[0]))


def test_size_limits_refuse_other_precisions():
    assert entropy_cuda.size_limits(8) == (11, 10)
    assert entropy_cuda.size_limits(12) == (15, 14)
    words, nm, luts, kw = _kernel_inputs(BLOBS[0])
    with pytest.raises(ValueError):
        entropy_cuda.decode_segments(torch.from_numpy(words),
                                     torch.from_numpy(nm),
                                     torch.from_numpy(luts), **kw,
                                     precision=16)
