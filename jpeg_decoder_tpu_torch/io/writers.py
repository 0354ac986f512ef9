"""Output sinks: BMP / PPM / PNG / NPY writers.

Counterpart of ``jpeg_decoder_tpu/io/writers.py``, numpy only: the same
bytes for the same array.  PNG goes through Pillow, imported when a PNG is
written; without Pillow that raises an ImportError that names the format
and the ones that need nothing (.bmp, .ppm, .npy).

Replaces the reference's L5 output layer.  The reference's BMP writer
(jpeg.cpp:462-509) uses a 12-byte BITMAPCOREHEADER, writes channels in
R, B, G order and pads rows by ``width % 4`` — both wrong (SURVEY.md §2 #16).
This writer emits a standard 40-byte BITMAPINFOHEADER 24bpp BMP with correct
B, G, R order and ``(4 - (3*width) % 4) % 4`` padding.  The X11 display path
(display.hpp) is intentionally dropped: the framework returns device arrays
and writes image files instead.
"""

from __future__ import annotations

import struct

import numpy as np


def write_bmp(path, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a 24bpp bottom-up BMP."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    pad = (4 - (3 * w) % 4) % 4
    row_size = 3 * w + pad
    data_size = row_size * h
    header_size = 14 + 40
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", header_size + data_size, 0, 0, header_size))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                            data_size, 2835, 2835, 0, 0))
        bgr = rgb[::-1, :, ::-1]  # bottom-up rows, B,G,R channel order
        if pad:
            padded = np.zeros((h, row_size), dtype=np.uint8)
            padded[:, : 3 * w] = bgr.reshape(h, 3 * w)
            f.write(padded.tobytes())
        else:
            f.write(np.ascontiguousarray(bgr).tobytes())


def write_ppm(path, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as binary PPM (P6)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb).tobytes())


def write_png(path, rgb: np.ndarray) -> None:
    """Write PNG via PIL (format forced: PIL would otherwise infer a
    LOSSY format from extensions like .jpg, silently degrading the
    decoder's output)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"writing {path}: PNG output needs Pillow, which is not "
            "installed; write .bmp, .ppm or .npy instead") from e

    Image.fromarray(np.asarray(rgb, dtype=np.uint8), "RGB").save(
        path, format="PNG")


def write_image(path, rgb: np.ndarray) -> None:
    """Dispatch on file extension (.bmp / .ppm / .png / .jpg-as-png).

    12-bit decodes arrive as uint16 (0..4095); the 8-bit file formats get
    the high 8 bits (use ``.npy`` to keep full precision)."""
    p = str(path).lower()
    if p.endswith(".npy"):
        np.save(path, rgb)
        return
    if rgb.dtype == np.uint16:
        import logging

        logging.getLogger(__name__).info(
            "writing a 12-bit decode to an 8-bit format: keeping the high "
            "8 bits (save to .npy for full precision)")
        rgb = (rgb >> 4).astype(np.uint8)
    if p.endswith(".bmp"):
        write_bmp(path, rgb)
    elif p.endswith(".ppm"):
        write_ppm(path, rgb)
    else:
        write_png(path, rgb)


def read_bmp(path) -> np.ndarray:
    """Minimal BMP reader (24bpp BITMAPINFOHEADER or BITMAPCOREHEADER) used
    by tests to round-trip our writer and to ingest reference-style dumps."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"BM":
        raise ValueError("not a BMP file")
    data_off = struct.unpack_from("<I", buf, 10)[0]
    hdr_size = struct.unpack_from("<I", buf, 14)[0]
    if hdr_size == 12:  # BITMAPCOREHEADER
        w, h, _, bpp = struct.unpack_from("<HHHH", buf, 18)
    else:
        w, h = struct.unpack_from("<ii", buf, 18)
        bpp = struct.unpack_from("<H", buf, 28)[0]
    if bpp != 24:
        raise ValueError(f"unsupported BMP bpp {bpp}")
    pad = (4 - (3 * w) % 4) % 4
    rows = np.frombuffer(buf, np.uint8, (3 * w + pad) * abs(h), data_off)
    rows = rows.reshape(abs(h), 3 * w + pad)[:, : 3 * w].reshape(abs(h), w, 3)
    if h > 0:
        rows = rows[::-1]
    return rows[:, :, ::-1].copy()  # BGR -> RGB
