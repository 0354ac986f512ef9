"""Host-side JPEG syntax parser: markers, headers, and entropy-segment prep.

A numpy-only copy of ``jpeg_decoder_tpu/io/parser.py`` (see ../types.py for
why the port keeps copies); its native unstuffer is the port's own
``entropy/native`` build.

The equivalent of reference layers L1+L2 (file.hpp + jpeg.cpp:37-298,
826-907).  Two responsibilities:

1. Marker/header parsing — a straightforward offset walk over the byte buffer
   (segments are few and tiny; Python is fine here).
2. Entropy-coded data preparation — the hot host path.  The reference strips
   byte stuffing one byte at a time (file.hpp:59-104); we do it as a
   vectorized NumPy pass that simultaneously produces:

   * the unstuffed ("clean") byte buffer,
   * the restart-segment offset table (byte offsets into the clean buffer),

   which together form the device-friendly representation: each restart
   segment is byte-aligned and independently decodable (DC predictors reset at
   RSTn, jpeg.cpp:419-425), making segments the unit of sharding.
"""

from __future__ import annotations

import numpy as np

from ..types import (
    Component,
    FrameHeader,
    HuffmanSpec,
    JPEGError,
    QuantTable,
    ScanHeader,
    ZIGZAG,
    M_APP0,
    M_APP15,
    M_COM,
    M_DHT,
    M_DNL,
    M_DQT,
    M_DRI,
    M_EOI,
    M_RST0,
    M_RST7,
    M_DAC,
    M_SOF0,
    M_SOF1,
    M_SOF2,
    M_SOF9,
    M_SOF10,
    M_SOI,
    M_SOS,
    M_TEM,
)

# SOF markers we accept -> (progressive, arithmetic).  The reference
# accepts only 0xC0 and hard-exits on 0xC2 (jpeg.cpp:69-73); the parser
# accepts progressive and arithmetic-coded (SOF9/SOF10) frames too.
_SOF_SUPPORTED = {M_SOF0: (False, False), M_SOF1: (False, False),
                  M_SOF2: (True, False), M_SOF9: (False, True),
                  M_SOF10: (True, True)}
# SOF markers that exist but we do not support (lossless/hierarchical).
_SOF_ALL = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
            0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def _be16(buf: np.ndarray, off: int) -> int:
    return (int(buf[off]) << 8) | int(buf[off + 1])


def unstuff_entropy(data: np.ndarray, start: int):
    """Strip byte stuffing from the entropy-coded region starting at
    ``start``; dispatches to the native C++ single-pass scanner when the
    native library builds (~10x the NumPy path), with identical outputs
    (asserted in tests/test_torch_host.py).  Where it does not build, the
    NumPy scan is the host path; the entropy decoder itself then raises
    the build error."""
    global _native_unstuff
    if _native_unstuff is None:
        from ..entropy import native

        try:
            native._load()
            _native_unstuff = native.unstuff
        except native.BuildFailure:
            _native_unstuff = False
    if _native_unstuff:
        return _native_unstuff(data, start)
    return unstuff_entropy_numpy(data, start)


_native_unstuff = None


def unstuff_entropy_numpy(data: np.ndarray, start: int):
    """Strip byte stuffing from the entropy-coded region starting at ``start``.

    Vectorized equivalent of JPEGFile::readImageData (file.hpp:59-104):

    * ``FF 00``   -> keep the FF, drop the 00 (byte stuffing)
    * ``FF FF``   -> drop the first FF (fill byte before a marker)
    * ``FF D0-D7``-> drop both, record a restart-segment boundary
    * ``FF other``-> entropy data ends at this FF (next marker / EOI)

    Returns ``(clean, seg_offsets, end)`` where ``clean`` is the unstuffed
    uint8 array, ``seg_offsets`` is an int64 array of byte offsets into
    ``clean`` of each segment start (always beginning with 0; length
    n_segments + 1 with the total length appended), and ``end`` is the offset
    in ``data`` of the 0xFF that begins the terminating marker.
    """
    region = data[start:]
    ff_pos = np.flatnonzero(region == 0xFF)
    if ff_pos.size and ff_pos[-1] == len(region) - 1:
        # Trailing lone FF: treat as terminator (truncated stream).
        ff_pos = ff_pos[:-1]
        term = len(region) - 1
    else:
        term = None
    nxt = region[ff_pos + 1] if ff_pos.size else np.empty(0, np.uint8)

    is_stuff = nxt == 0x00
    is_fill = nxt == 0xFF
    is_rst = (nxt >= M_RST0) & (nxt <= M_RST7)
    is_term = ~(is_stuff | is_fill | is_rst)

    term_idx = np.flatnonzero(is_term)
    if term_idx.size:
        end_local = int(ff_pos[term_idx[0]])
    elif term is not None:
        end_local = term
    else:
        raise JPEGError("entropy data: no terminating marker found")

    in_range = ff_pos < end_local
    ff_pos, nxt = ff_pos[in_range], nxt[in_range]
    is_stuff, is_fill, is_rst = (m[in_range] for m in (is_stuff, is_fill, is_rst))

    # Build drop mask over region[:end_local].
    drop = np.zeros(end_local, dtype=bool)
    drop[ff_pos[is_fill]] = True                # fill FF dropped
    stuff_zero = ff_pos[is_stuff] + 1           # the 0x00 after a kept FF
    drop[stuff_zero[stuff_zero < end_local]] = True
    rst_ff = ff_pos[is_rst]
    drop[rst_ff] = True                         # FF of RSTn
    rst_byte = rst_ff + 1
    drop[rst_byte[rst_byte < end_local]] = True  # Dn of RSTn

    keep = ~drop
    clean = region[:end_local][keep]
    # Map each RST marker to its clean-stream offset: number of kept bytes
    # strictly before the RST's FF == new offset of the byte following it.
    kept_before = np.cumsum(keep)
    seg_starts = kept_before[rst_ff - 1] if rst_ff.size else np.empty(0, np.int64)
    seg_starts = np.asarray(seg_starts, dtype=np.int64)
    # Guard: an RST at position 0 (malformed) would index -1; clamp.
    if rst_ff.size and rst_ff[0] == 0:
        seg_starts[0] = 0
    seg_offsets = np.concatenate(
        [[0], seg_starts, [len(clean)]]).astype(np.int64)
    # Collapse duplicate boundaries (e.g. consecutive RSTs -> empty segment).
    seg_offsets = np.unique(seg_offsets)
    return np.ascontiguousarray(clean), seg_offsets, start + end_local


def parse(buf: bytes | np.ndarray) -> FrameHeader:
    """Parse a full JPEG byte stream into a :class:`FrameHeader`.

    Equivalent of Image::readJPEG's dispatch loop (jpeg.cpp:826-907) plus all
    read_* handlers, generalized to multi-scan (progressive) streams.
    """
    data = np.frombuffer(bytes(buf), dtype=np.uint8) if not isinstance(
        buf, np.ndarray) else buf.view(np.uint8)
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != M_SOI:
        # Parity: SOI check at jpeg.cpp:800-806.
        raise JPEGError("not a JPEG file (missing SOI)")

    pos = 2
    width = height = precision = None
    progressive = False
    components: list[Component] = []
    quant_tables: dict[int, QuantTable] = {}
    dc_tables: dict[int, HuffmanSpec] = {}
    ac_tables: dict[int, HuffmanSpec] = {}
    restart_interval = 0
    scans: list[ScanHeader] = []
    zero_based = False
    adobe_transform = None
    saw_jfif = False
    exif_orientation = None
    icc_chunks: list[tuple[int, bytes]] = []
    arithmetic = False
    dc_cond: dict[int, tuple[int, int]] = {}
    ac_cond: dict[int, int] = {}

    while pos < n:
        if data[pos] != 0xFF:
            raise JPEGError(f"expected marker at offset {pos}, got "
                            f"0x{int(data[pos]):02x}")
        # Skip fill bytes (series of FFs before the marker code).
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = int(data[pos])
        pos += 1

        if marker == M_EOI:
            break
        if marker in (0x00, M_TEM) or M_RST0 <= marker <= M_RST7:
            continue  # standalone markers, no payload

        if pos + 2 > n:
            raise JPEGError("truncated marker segment")
        length = _be16(data, pos)
        if length < 2 or pos + length > n:
            raise JPEGError(f"bad segment length {length} for marker "
                            f"0x{marker:02x}")
        seg = data[pos + 2: pos + length]
        pos += length

        if M_APP0 <= marker <= M_APP15 or marker == M_COM:
            # APP0/JFIF validation is lenient (warn-not-exit), unlike
            # jpeg.cpp:37-61.  APP14 "Adobe" carries the color-transform
            # flag (0 = as-is RGB/CMYK, 1 = YCbCr, 2 = YCCK) that decides
            # the color stage for 3- and 4-component frames.
            if (marker == M_APP0 + 14 and len(seg) >= 12
                    and bytes(seg[:5]) == b"Adobe"):
                adobe_transform = int(seg[11])
            elif (marker == M_APP0 and len(seg) >= 5
                    and bytes(seg[:5]) == b"JFIF\x00"):
                saw_jfif = True
            elif (marker == M_APP0 + 1 and len(seg) >= 6
                    and bytes(seg[:6]) == b"Exif\x00\x00"):
                exif_orientation = _parse_exif_orientation(seg[6:])
            elif (marker == M_APP0 + 2 and len(seg) >= 14
                    and bytes(seg[:12]) == b"ICC_PROFILE\x00"):
                # Multi-chunk profile: (seq_no 1-based, total) then data.
                icc_chunks.append((int(seg[12]), bytes(seg[14:])))
            continue
        elif marker == M_DQT:
            _parse_dqt(seg, quant_tables)
        elif marker == M_DHT:
            _parse_dht(seg, dc_tables, ac_tables)
        elif marker == M_DRI:
            # Parity: jpeg.cpp:289-298.
            if len(seg) != 2:
                raise JPEGError("DRI: invalid length")
            restart_interval = _be16(seg, 0)
        elif marker == M_DAC:
            _parse_dac(seg, dc_cond, ac_cond)
        elif marker in _SOF_ALL:
            if marker not in _SOF_SUPPORTED:
                raise JPEGError(f"unsupported SOF marker 0xff{marker:02x} "
                                "(lossless/hierarchical)")
            if width is not None:
                raise JPEGError("multiple SOF markers")
            progressive, arithmetic = _SOF_SUPPORTED[marker]
            (precision, height, width,
             components, zero_based) = _parse_sof(seg)
        elif marker == M_SOS:
            if width is None:
                raise JPEGError("SOS before SOF")
            scan = _parse_sos(seg, components)
            scan.dc_specs = dict(dc_tables)
            scan.ac_specs = dict(ac_tables)
            scan.dc_cond = dict(dc_cond)
            scan.ac_cond = dict(ac_cond)
            scan.restart_interval = restart_interval
            clean, seg_offsets, end = unstuff_entropy(data, pos)
            scan.data = clean
            # The native unstuffer returns a zero-offset view into a
            # buffer it already zero-padded by 256 bytes — expose it so
            # the native decoders skip a per-call copy-to-pad.
            base = clean.base
            if (base is not None and base.dtype == np.uint8
                    and base.nbytes >= clean.nbytes + 256
                    and base.__array_interface__["data"][0]
                    == clean.__array_interface__["data"][0]):
                scan.data_padded = base[:clean.nbytes + 256]
            scan.seg_offsets = seg_offsets
            scans.append(scan)
            pos = end  # points at the FF of the next marker
        elif marker == M_DNL:
            # DNL (B.2.5): defines the number of lines when SOF said 0.
            if len(seg) >= 2 and height == 0:
                height = _be16(seg, 0)
                if height == 0:
                    raise JPEGError("DNL: zero line count")
            continue
        else:
            # Unknown-but-well-formed segment: skip (reference warns and
            # continues for META, errors otherwise; we skip leniently).
            continue

    if width is None:
        raise JPEGError("no SOF marker found")
    if not scans:
        raise JPEGError("no SOS scan found")
    if height == 0:
        raise JPEGError(
            "SOF declared 0 lines and no DNL segment followed the scan")

    hdr = FrameHeader(
        width=width, height=height, precision=precision,
        progressive=progressive, components=components,
        quant_tables=quant_tables, dc_tables=dc_tables, ac_tables=ac_tables,
        restart_interval=restart_interval, scans=scans,
        zero_based_ids=zero_based, arithmetic=arithmetic,
        adobe_transform=adobe_transform,
        saw_jfif=saw_jfif, exif_orientation=exif_orientation,
        icc_profile=(b"".join(c for _, c in sorted(icc_chunks))
                     if icc_chunks else None),
    )
    _validate(hdr)
    return hdr


def parse_file(path) -> FrameHeader:
    with open(path, "rb") as f:
        return parse(f.read())


def _parse_dac(seg: np.ndarray, dc: dict, ac: dict):
    """DAC arithmetic-conditioning segment (T.81 B.2.4.3): pairs of
    (class/id byte, conditioning value).  DC value packs (U << 4) | L
    with 0 <= L <= U <= 15; AC value is Kx in 1..63."""
    if len(seg) % 2:
        raise JPEGError("DAC: invalid length")
    for off in range(0, len(seg), 2):
        info = int(seg[off])
        val = int(seg[off + 1])
        tid = info & 0x0F
        if tid > 3 or (info >> 4) > 1:
            raise JPEGError("DAC: invalid table id")
        if info >> 4:
            if not 1 <= val <= 63:
                raise JPEGError(f"DAC: invalid Kx {val}")
            ac[tid] = val
        else:
            l_param, u_param = val & 0x0F, val >> 4
            if l_param > u_param:
                raise JPEGError(f"DAC: L {l_param} > U {u_param}")
            dc[tid] = (l_param, u_param)


def _parse_exif_orientation(tiff: np.ndarray) -> int | None:
    """Minimal TIFF IFD0 walk for the orientation tag (0x0112).

    Lenient: any malformed structure returns None (metadata never fails a
    decode).  Handles both byte orders; only the first IFD is scanned —
    orientation lives in IFD0 per EXIF 2.3 §4.6.4."""
    try:
        if len(tiff) < 14:
            return None
        order = bytes(tiff[:2])
        if order == b"MM":
            def rd(off, n):
                v = 0
                for k in range(n):
                    v = (v << 8) | int(tiff[off + k])
                return v
        elif order == b"II":
            def rd(off, n):
                v = 0
                for k in reversed(range(n)):
                    v = (v << 8) | int(tiff[off + k])
                return v
        else:
            return None
        if rd(2, 2) != 42:
            return None
        ifd = rd(4, 4)
        if ifd + 2 > len(tiff):
            return None
        n_entries = rd(ifd, 2)
        for k in range(n_entries):
            e = ifd + 2 + 12 * k
            if e + 12 > len(tiff):
                return None
            if rd(e, 2) == 0x0112 and rd(e + 2, 2) == 3:  # SHORT
                val = rd(e + 8, 2)
                return val if 1 <= val <= 8 else None
        return None
    except Exception:  # noqa: BLE001
        return None


def _parse_sof(seg: np.ndarray):
    """Parity: read_sof (jpeg.cpp:67-146), minus the hard exits."""
    if len(seg) < 6:
        raise JPEGError("SOF: truncated")
    precision = int(seg[0])
    if precision not in (8, 12):
        # 8-bit baseline/extended plus 12-bit extended (T.81 B.2.2);
        # 16-bit is lossless-only.
        raise JPEGError(f"SOF: unsupported sample precision {precision}")
    height = _be16(seg, 1)
    width = _be16(seg, 3)
    if width == 0:
        raise JPEGError("SOF: zero image width")
    # height == 0 is legal (T.81 B.2.2): the true number of lines arrives
    # in a DNL segment after the first scan (B.2.5); patched by parse().
    ncomp = int(seg[5])
    if ncomp not in (1, 3, 4):
        # Reference supports exactly 3 (jpeg.cpp:83-87); we add grayscale
        # (1) and Adobe CMYK / YCCK (4).
        raise JPEGError(f"SOF: unsupported component count {ncomp}")
    if len(seg) != 6 + 3 * ncomp:
        raise JPEGError("SOF: bad length")
    comps = []
    ids = []
    for i in range(ncomp):
        cid = int(seg[6 + 3 * i])
        sampling = int(seg[7 + 3 * i])
        tq = int(seg[8 + 3 * i])
        h, v = sampling >> 4, sampling & 0x0F
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise JPEGError(f"SOF: invalid sampling factors {h}x{v}")
        if tq > 3:
            raise JPEGError("SOF: invalid quantization table id")
        comps.append(Component(comp_id=cid, h=h, v=v, tq=tq))
        ids.append(cid)
    # Zero-based component-ID quirk (jpeg.cpp:91-104): accept both 0-based
    # and 1-based numbering.
    zero_based = 0 in ids
    if len(set(ids)) != ncomp:
        raise JPEGError("SOF: duplicate component ids")
    # General T.81 sampling support — a superset of the reference's
    # "luma in {1,2}^2, chroma 1x1" constraint (jpeg.cpp:110-136): any
    # h, v in 1..4 with <= 10 blocks/MCU (T.81 B.2.2) and integer
    # upsampling ratios (h_max % h == 0), which covers every sampling
    # libjpeg handles (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...).
    if sum(c.h * c.v for c in comps) > 10:
        raise JPEGError("SOF: more than 10 blocks per MCU (T.81 B.2.2)")
    h_max = max(c.h for c in comps)
    v_max = max(c.v for c in comps)
    for c in comps:
        if h_max % c.h or v_max % c.v:
            raise JPEGError(
                f"SOF: non-integer sampling ratio {c.h}x{c.v} vs "
                f"{h_max}x{v_max} max is not supported")
    return precision, height, width, comps, zero_based


def _parse_dqt(seg: np.ndarray, out: dict[int, QuantTable]):
    """Parity: read_quantization_table (jpeg.cpp:197-231).  Stores values in
    natural order via de-zigzag at parse time (types.hpp:88-90).  Fixes the
    reference's 16-bit truncation bug (jpeg.cpp:213-219)."""
    off = 0
    while off < len(seg):
        info = int(seg[off]); off += 1
        tid = info & 0x0F
        prec16 = info >> 4
        if tid > 3:
            raise JPEGError("DQT: invalid table id")
        count = 128 if prec16 else 64
        if off + count > len(seg):
            raise JPEGError("DQT: truncated table")
        raw = seg[off:off + count]
        off += count
        if prec16:
            vals = (raw[0::2].astype(np.int32) << 8) | raw[1::2]
        else:
            vals = raw.astype(np.int32)
        natural = np.zeros(64, np.int32)
        natural[ZIGZAG] = vals
        out[tid] = QuantTable(table_id=tid, values=natural)


def _parse_dht(seg: np.ndarray, dc: dict, ac: dict):
    """Parity: read_huffman_table (jpeg.cpp:148-196)."""
    off = 0
    while off < len(seg):
        if off + 17 > len(seg):
            raise JPEGError("DHT: truncated")
        info = int(seg[off])
        tid = info & 0x0F
        is_ac = info >> 4
        if tid > 3 or is_ac > 1:
            raise JPEGError("DHT: invalid table id")
        counts = seg[off + 1: off + 17].astype(np.uint8)
        total = int(counts.sum())
        if total > 256 or off + 17 + total > len(seg):
            # T.81 allows up to 256 symbols; the reference's tighter 176
            # bound (jpeg.cpp:177-181) would reject legal 12-bit extended
            # tables (run 0-15 x size 1-14 alone is 224 symbols).
            raise JPEGError("DHT: invalid number of symbols")
        symbols = seg[off + 17: off + 17 + total].astype(np.uint8)
        off += 17 + total
        spec = HuffmanSpec(table_class=int(is_ac), table_id=tid,
                           counts=counts, symbols=symbols)
        (ac if is_ac else dc)[tid] = spec


def _parse_sos(seg: np.ndarray,
               components: list[Component]) -> ScanHeader:
    """Parity: read_sos (jpeg.cpp:233-287), generalized to arbitrary
    (Ss, Se, Ah, Al) and component subsets for progressive scans."""
    if len(seg) < 1:
        raise JPEGError("SOS: truncated")
    ncomp = int(seg[0])
    if ncomp < 1 or ncomp > 4 or len(seg) != 4 + 2 * ncomp:
        raise JPEGError("SOS: invalid length")
    id_to_index = {c.comp_id: i for i, c in enumerate(components)}
    comp_indices, dc_ids, ac_ids = [], [], []
    for i in range(ncomp):
        cid = int(seg[1 + 2 * i])
        tbl = int(seg[2 + 2 * i])
        if cid not in id_to_index:
            raise JPEGError(f"SOS: unknown component id {cid}")
        ci = id_to_index[cid]
        td, ta = tbl >> 4, tbl & 0x0F
        components[ci].td = td
        components[ci].ta = ta
        comp_indices.append(ci)
        dc_ids.append(td)
        ac_ids.append(ta)
    if len(set(comp_indices)) != ncomp:
        raise JPEGError("SOS: duplicate component selector (T.81 B.2.3)")
    ss = int(seg[1 + 2 * ncomp])
    se = int(seg[2 + 2 * ncomp])
    a = int(seg[3 + 2 * ncomp])
    ah, al = a >> 4, a & 0x0F
    if not (0 <= ss <= 63 and ss <= se <= 63):
        raise JPEGError("SOS: invalid spectral selection")
    return ScanHeader(comp_indices=comp_indices, dc_table_ids=dc_ids,
                      ac_table_ids=ac_ids, ss=ss, se=se, ah=ah, al=al)


def _validate(hdr: FrameHeader):
    """Pre-decode validation: every referenced table must exist.
    Parity: process_image_data guards (jpeg.cpp:757-774)."""
    for scan in hdr.scans:
        needs_dc = scan.ss == 0
        needs_ac = scan.se > 0
        for k, ci in enumerate(scan.comp_indices):
            c = hdr.components[ci]
            if c.tq not in hdr.quant_tables:
                raise JPEGError(f"missing quantization table {c.tq}")
            if hdr.arithmetic:
                continue  # conditioning tables have spec defaults
            if needs_dc and not (hdr.progressive and scan.ah > 0):
                if scan.dc_table_ids[k] not in scan.dc_specs:
                    raise JPEGError(
                        f"missing DC huffman table {scan.dc_table_ids[k]}")
            if needs_ac and not (hdr.progressive and scan.ss == 0):
                if scan.ac_table_ids[k] not in scan.ac_specs:
                    raise JPEGError(
                        f"missing AC huffman table {scan.ac_table_ids[k]}")
        if not hdr.progressive and (scan.ss, scan.se, scan.ah, scan.al) != (0, 63, 0, 0):
            # Baseline guard, parity with jpeg.cpp:255-264.
            raise JPEGError("baseline scan must cover spectral band 0..63")
