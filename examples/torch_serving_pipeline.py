"""Example: the PyTorch port's batched decode feeding a model on the card.

The counterpart of examples/serving_pipeline.py for jpeg_decoder_tpu_torch.
The input pipeline of a training or serving job gets JPEG bytes on the host
and consumes pixels on the device.  ``BatchDecoder`` keeps the decoded RGB
on the card, so the stand-in model below runs on ``rgb_batch`` where it
lies: the only host-to-device traffic is the coefficient wire, and only the
(B, 3) embeddings come back to the host.

Run:  python examples/torch_serving_pipeline.py [--glob 'dir/*.jpg']
                                                 [--device cuda|cpu]
                                                 [--n N] [--scale S]

Without ``--glob`` the inputs are made here from a seed
(``testing/photo.synthetic_photo``, ``testing/encoder.encode``): ``--n``
images cycling over 1920x1080 4:2:0 q90, 1920x1080 4:4:4 q95 DRI 8 and
1000x750 4:2:0 q90 (each side divided by ``--scale``), then one corrupt
blob.  The decode runs on the card by default and stops without one;
``--device cpu`` runs the kernels' plain versions.  ``--repeat R`` times R
passes and prints the lines of the last.
"""

import argparse
import glob
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from jpeg_decoder_tpu_torch import BatchDecoder  # noqa: E402
from jpeg_decoder_tpu_torch.models import routing  # noqa: E402

# The stand-in model's projection (examples/serving_pipeline.py).
W = ((0.9, -0.2, 0.1),
     (0.05, 1.1, -0.3),
     (-0.4, 0.2, 0.8))
# height, width, samplings, quality, restart interval of the made inputs
GEOMETRIES = ((1080, 1920, ((2, 2), (1, 1), (1, 1)), 90, 0),
              (1080, 1920, ((1, 1), (1, 1), (1, 1)), 95, 8),
              (750, 1000, ((2, 2), (1, 1), (1, 1)), 90, 0))
CORRUPT = b"\xff\xd8not-a-jpeg"


def model_step(rgb_batch: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stand-in model: normalise, pool over space, project; (B, 3)
    embeddings on the device the pixels are on."""
    x = rgb_batch.float() / 127.5 - 1.0
    feats = x.mean(dim=(1, 2))
    return feats @ w


def made_inputs(n: int, scale: int) -> tuple[list[str], list[bytes]]:
    """``n`` seeded frames over :data:`GEOMETRIES` and the corrupt blob."""
    from jpeg_decoder_tpu_torch.testing.encoder import encode
    from jpeg_decoder_tpu_torch.testing.photo import synthetic_photo

    names, blobs = [], []
    for k in range(n):
        h, w, samplings, quality, ri = GEOMETRIES[k % len(GEOMETRIES)]
        h, w = max(1, h // scale), max(1, w // scale)
        img = synthetic_photo(np.random.default_rng(k), h, w)
        blobs.append(encode(img, samplings=samplings, quality=quality,
                            restart_interval=ri)[0])
        names.append(f"made/{k:03d}_{w}x{h}_q{quality}_dri{ri}.jpg")
    return names + ["made/corrupt.jpg"], blobs + [CORRUPT]


def serve(bd: BatchDecoder, blobs: list[bytes], w: torch.Tensor):
    """One pass: decode, then the model once per group on the caller's
    stream (``decode`` made it wait for the decoder's stream).  Returns the
    items and each group's embeddings, the only tensors copied to the
    host."""
    items = bd.decode(blobs)
    on_host = {}
    for it in items:
        if not it.ok or id(it.rgb_batch) in on_host:
            continue
        if it.rgb_batch.device.type != bd.device.type:
            raise AssertionError(f"rgb_batch of item {it.index} lies on "
                                 f"{it.rgb_batch.device}, not {bd.device}")
        on_host[id(it.rgb_batch)] = model_step(it.rgb_batch, w).cpu()
    return items, on_host


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--glob", default=None,
                    help="JPEG files to decode (default: made here)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8,
                    help="frames made without --glob")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide the made frames' sides by this")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()

    dev = routing.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.glob is None:
        paths, blobs = made_inputs(args.n, args.scale)
    else:
        paths = sorted(glob.glob(args.glob))
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append(f.read())
    w = torch.tensor(W, dtype=torch.float32, device=dev)

    walls = []
    with BatchDecoder(device=dev, idct="fast", upsample="fancy") as bd:
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            items, on_host = serve(bd, blobs, w)
            walls.append(time.perf_counter() - t0)
    for it in items:
        if not it.ok:
            print(f"{paths[it.index]}: failed: {it.error}")
            continue
        emb = on_host[id(it.rgb_batch)][it.batch_index].numpy()
        print(f"{paths[it.index]}: embedding {emb}")
    mp = sum(it.header.height * it.header.width for it in items
             if it.ok) / 1e6
    emb_bytes = sum(e.numel() * e.element_size() for e in on_host.values())
    print(f"{len(blobs)} images decoded + embedded in "
          f"{min(walls) * 1e3:.1f} ms ({mp:.2f} MP, "
          f"{mp / min(walls):.1f} MP/s; passes "
          f"{', '.join(f'{t * 1e3:.1f}' for t in walls)} ms) on {dev}; "
          f"{len(on_host)} groups, {emb_bytes} bytes of embeddings to the "
          "host" + (" (pixels never left the device)" if dev.type == "cuda"
                    else ""))


if __name__ == "__main__":
    main()
