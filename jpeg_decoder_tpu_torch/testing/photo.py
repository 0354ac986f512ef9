"""Seeded synthetic photos and the committed progressive-Huffman fixtures.

:func:`synthetic_photo` is the test image of ``chip_smoke.py``: smooth
random colour fields plus Gaussian luma noise.  The port's encoder writes
no progressive Huffman stream (nor does ``tools/encoder.py``), and the card's
machine has no PIL, so the progressive fixtures the smoke run decodes are
made once with PIL by::

    python -m jpeg_decoder_tpu_torch.testing.photo

and committed under ``fixtures/`` (``--rewrite`` encodes the ones already
there again).  :func:`fixture` returns a fixture's
bytes with the synthetic photo it was encoded from, rebuilt from its seed.
"""

from __future__ import annotations

import io
import os

import numpy as np

FIXTURES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
#: name -> (seed, height, width, PIL quality, restart interval in MCU rows
#: of each scan, 0 for none, sampling); progressive Huffman.  Sampling
#: "4:2:0" and "4:2:2" are YCbCr (six and four blocks per MCU of the
#: interleaved DC scans), "gray" one component (one block per unit, the
#: source's luma).
PROGRESSIVE_FIXTURES = {
    "progressive_1080p_a.jpg": (101, 1080, 1920, 90, 0, "4:2:0"),
    "progressive_1080p_b.jpg": (102, 1080, 1920, 90, 0, "4:2:0"),
    "progressive_512.jpg": (103, 512, 512, 90, 0, "4:2:0"),
    "progressive_1080p_dri.jpg": (104, 1080, 1920, 90, 1, "4:2:0"),
    "progressive_4k.jpg": (105, 2160, 3840, 90, 0, "4:2:0"),
    "progressive_gray.jpg": (106, 251, 331, 90, 0, "gray"),
    "progressive_422.jpg": (107, 270, 360, 90, 0, "4:2:2"),
}
_PIL_SUBSAMPLING = {"4:2:0": 2, "4:2:2": 1}


def synthetic_photo(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random colour field (a few low-frequency cosines per
    channel) plus Gaussian luma noise of sigma 3: (h, w, 3) uint8."""
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    chans = []
    for _ in range(3):
        acc = np.full((h, w), rng.uniform(60, 190))
        for _ in range(4):
            fy, fx = rng.uniform(0.3, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(10, 35) * np.cos(2 * np.pi * (fy * y + fx * x)
                                                + ph)
        chans.append(acc)
    img = np.stack(chans, axis=-1) + rng.normal(0.0, 3.0, (h, w, 1))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _source(name: str) -> np.ndarray:
    """What a fixture encodes: the synthetic photo, or for a gray fixture
    its luma (ITU-R BT.601 weights, rounded) as (h, w) uint8."""
    seed, h, w, _, _, sampling = PROGRESSIVE_FIXTURES[name]
    img = synthetic_photo(np.random.default_rng(seed), h, w)
    if sampling == "gray":
        img = np.rint(img @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)
    return img


def fixture(name: str) -> tuple[bytes, np.ndarray]:
    """A committed fixture's bytes and its (h, w, 3) uint8 source (a gray
    one's luma in all three channels, as a gray frame decodes)."""
    with open(os.path.join(FIXTURES_DIR, name), "rb") as f:
        blob = f.read()
    src = _source(name)
    if src.ndim == 2:
        src = np.repeat(src[:, :, None], 3, axis=2)
    return blob, src


def write_fixtures(rewrite: bool = False) -> None:
    """Encode the fixtures with PIL (progressive; with a restart interval,
    ``restart_marker_rows``) into ``fixtures/``: those not there yet, or
    all with ``rewrite``."""
    from PIL import Image

    os.makedirs(FIXTURES_DIR, exist_ok=True)
    for name, (_, _, _, q, rows, sampling) in PROGRESSIVE_FIXTURES.items():
        path = os.path.join(FIXTURES_DIR, name)
        if os.path.exists(path) and not rewrite:
            continue
        buf = io.BytesIO()
        kw = {"restart_marker_rows": rows} if rows else {}
        if sampling != "gray":
            kw["subsampling"] = _PIL_SUBSAMPLING[sampling]
        Image.fromarray(_source(name)).save(buf, "JPEG", quality=q,
                                            progressive=True, **kw)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        print(f"{name}: {len(buf.getvalue())} bytes")


if __name__ == "__main__":
    import sys

    write_fixtures(rewrite="--rewrite" in sys.argv[1:])
