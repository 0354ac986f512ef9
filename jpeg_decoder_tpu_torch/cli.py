"""Command-line interface of the PyTorch/CUDA port.

Counterpart of ``jpeg_decoder_tpu/cli.py``, with its options, names and
defaults: multiple inputs, selectable entropy backend / IDCT mode / output
format, optional coefficient dumps, per-image error isolation, ``--resume``
and the batched path.  It decodes on the CUDA card by default and stops
with an error when there is none; ``--platform cpu`` decodes on the CPU
(the kernels' plain twins).

Usage:
    python -m jpeg_decoder_tpu_torch [options] IMAGE [IMAGE ...]

Under ``--idct exact`` (with or without ``--strict``: the port has no fused
variant) the written images equal the JAX CLI's ``--strict`` output byte for
byte.  PNG output and ``--show`` need Pillow; ``--format bmp``/``ppm`` (or an
``.npy`` output path, which keeps 12-bit samples) need nothing.
``--batch --device-entropy`` decodes through
``parallel.sharded.decode_batch_sharded`` (entropy decode on the device per
geometry group); without ``--batch`` the flag is ignored, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

#: --platform values and the torch device each names (None: the card).
PLATFORMS = {"cpu": "cpu", "cuda": None, "gpu": None}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jpeg_decoder_tpu_torch",
        description="JPEG decoder on an NVIDIA card (PyTorch + CUDA)",
    )
    p.add_argument("inputs", nargs="+", help="input JPEG file(s)")
    p.add_argument("-o", "--output", default=None,
                   help="output file (single input) or directory; "
                        "default: alongside input as .png")
    p.add_argument("--format", choices=["png", "bmp", "ppm"], default="png")
    p.add_argument("--entropy", default="auto",
                   choices=["auto", "python", "native", "speculative", "hybrid",
                            "jax", "pallas"],
                   help="entropy-decode backend ('pallas' and 'jax': the "
                        "CUDA Huffman kernel; 'hybrid': the host skeleton "
                        "walk and the CUDA emit-lane kernel on DRI=0 "
                        "streams)")
    p.add_argument("--idct", default="fast",
                   choices=["exact", "fast", "kron", "pallas"],
                   help="'exact' matches the reference C++ bit-for-bit; "
                        "'pallas' is the fused dequant+IDCT CUDA kernel")
    p.add_argument("--upsample", default="nn", choices=["nn", "fancy"],
                   help="chroma upsampling: 'nn' matches the reference; "
                        "'fancy' is libjpeg-style triangular (higher quality)")
    p.add_argument("--orientation", default="ignore",
                   choices=["ignore", "respect"],
                   help="EXIF orientation: 'respect' auto-rotates like "
                        "PIL.ImageOps.exif_transpose")
    p.add_argument("--strict", action="store_true",
                   help="byte-perfect reference parity (the port's 'exact' "
                        "IDCT always has it)")
    p.add_argument("--dump-coeffs", metavar="PREFIX", default=None,
                   help="also dump dequantized coefficient planes as "
                        "PREFIX.<image>.comp<i>.npy")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="'cpu' decodes on the CPU; 'cuda'/'gpu' (the "
                        "default) on the CUDA card")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: summary; -vv: full header narration "
                        "(tables, scans) like the reference's verbose dumps")
    p.add_argument("--time", action="store_true", help="print per-image decode ms")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="capture a torch.profiler trace of the decode(s) "
                        "(LOGDIR/trace.json)")
    p.add_argument("--resume", action="store_true",
                   help="skip inputs whose output file already exists "
                        "(restartable batch decode)")
    p.add_argument("--show", action="store_true",
                   help="open the decoded image in the system viewer "
                        "(needs Pillow)")
    p.add_argument("--batch", action="store_true",
                   help="decode all inputs through the batched device "
                        "pipeline (geometry-grouped single dispatches)")
    p.add_argument("--device-entropy", action="store_true",
                   help="with --batch: fully device-resident path (entropy "
                        "decode on the device per geometry group)")
    return p


def _show(rgb, title: str) -> None:
    try:
        from PIL import Image as _PILImage
    except ImportError as e:
        raise ImportError("--show needs Pillow, which is not installed") from e
    _PILImage.fromarray(rgb).show(title=title)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    logging.getLogger("jpeg_decoder_tpu_torch").setLevel(
        [logging.WARNING, logging.INFO, logging.DEBUG][min(args.verbose, 2)])
    from . import decode
    from .io import writers
    from .models.routing import resolve_device
    from .utils import logging as jd_logging
    from .utils.config import DecodeConfig
    from .utils.profiling import StageTimer

    # The card unless --platform cpu; no card raises here, before any work.
    device = resolve_device(PLATFORMS[args.platform or "cuda"])
    cfg = DecodeConfig(entropy=args.entropy, idct=args.idct,
                       upsample=args.upsample, strict=args.strict,
                       orientation=args.orientation).validate()

    timer = StageTimer()
    profile_cm = None
    if args.profile:
        from .utils.profiling import device_trace

        profile_cm = device_trace(args.profile)
        profile_cm.__enter__()

    multi = len(args.inputs) > 1
    outdir = None
    if args.output and (multi or os.path.isdir(args.output)):
        outdir = args.output
        os.makedirs(outdir, exist_ok=True)

    if args.batch:
        try:
            return _run_batch(args, timer, outdir, cfg, device)
        finally:
            if profile_cm is not None:
                profile_cm.__exit__(None, None, None)

    rc = 0
    total_mp = 0.0
    for path in args.inputs:
        try:
            base = os.path.splitext(os.path.basename(path))[0]
            if outdir:
                out = os.path.join(outdir, f"{base}.{args.format}")
            elif args.output:
                out = args.output
            else:
                out = os.path.join(os.path.dirname(path) or ".",
                                   f"{base}.{args.format}")
            if args.resume and os.path.exists(out):
                print(f"{path}: exists, skipped ({out})")
                continue
            t0 = time.perf_counter()
            with timer.stage("decode"):
                res = decode(path,
                             keep_planes=args.dump_coeffs is not None,
                             device=device, **cfg.decode_kwargs())
                rgb = res.rgb.cpu().numpy()
            if args.verbose:
                jd_logging.log_header(res.header)
            total_mp += rgb.shape[0] * rgb.shape[1] / 1e6
            dt = (time.perf_counter() - t0) * 1e3
            try:
                writers.write_image(out, rgb)
            except PermissionError:
                out = os.path.join(os.getcwd(), f"{base}.{args.format}")
                writers.write_image(out, rgb)
            h, w = rgb.shape[:2]
            msg = f"{path}: {w}x{h} -> {out}"
            if args.time:
                msg += f"  ({dt:.1f} ms, {w * h / dt / 1e3:.1f} MP/s)"
            print(msg)
            if args.show:
                _show(rgb, base)
            if args.dump_coeffs is not None:
                import numpy as np

                for ci, plane in enumerate(res.dequantized_planes):
                    np.save(f"{args.dump_coeffs}.{base}.comp{ci}.npy", plane)
        except Exception as e:  # noqa: BLE001 — per-image isolation
            print(f"{path}: ERROR: {e}", file=sys.stderr)
            rc = 1
    if profile_cm is not None:
        profile_cm.__exit__(None, None, None)
    if args.time and total_mp:
        print(timer.report(megapixels=total_mp), file=sys.stderr)
    return rc


def _run_batch(args, timer, outdir, cfg, device) -> int:
    """Batched decode path: all inputs through BatchDecoder, or with
    ``--device-entropy`` through ``decode_batch_sharded``.

    Output naming matches the single-image path: -o names a FILE for a
    single input and a directory otherwise; per-input failures (unreadable
    file, malformed stream) are isolated.  --resume skips inputs whose
    output exists.  Flags the batch pipeline cannot honor are rejected
    rather than silently ignored.
    """
    from .io import writers
    from .models.batch import BatchDecoder

    for flag, name in ((args.strict, "--strict"),
                       (args.dump_coeffs, "--dump-coeffs")):
        if flag:
            print(f"{name} is not supported with --batch (use the "
                  f"per-image path)", file=sys.stderr)
            return 2

    def out_path(path: str) -> str:
        name = os.path.splitext(os.path.basename(path))[0]
        if outdir:
            return os.path.join(outdir, f"{name}.{args.format}")
        if args.output and len(args.inputs) == 1:
            return args.output
        # Default: alongside the input, matching the single-image path.
        return os.path.join(os.path.dirname(path) or ".",
                            f"{name}.{args.format}")

    rc = 0
    blobs, names = [], []
    for path in args.inputs:
        if args.resume and os.path.exists(out_path(path)):
            print(f"{path}: exists, skipped ({out_path(path)})")
            continue
        try:
            with open(path, "rb") as f:
                blobs.append(f.read())
            names.append(path)
        except OSError as e:
            print(f"{path}: ERROR: {e}", file=sys.stderr)
            rc = 1

    if not blobs:
        return rc
    t0 = time.perf_counter()
    if args.device_entropy:
        # Entropy decode on the device per geometry group.
        from .parallel.sharded import decode_batch_sharded

        with timer.stage("batch decode (device entropy)"):
            items = decode_batch_sharded(blobs, device, idct=args.idct,
                                         upsample=args.upsample)
            rgbs = [it.rgb.cpu().numpy() if it.ok else None for it in items]
    else:
        with BatchDecoder(device=device, **cfg.batch_kwargs()) as bd:
            with timer.stage("batch decode"):
                items = bd.decode(blobs)
                rgbs = [it.rgb.cpu().numpy() if it.ok else None
                        for it in items]
    dt = time.perf_counter() - t0

    total_mp = 0.0
    for path, item, rgb in zip(names, items, rgbs):
        if not item.ok:
            print(f"{path}: ERROR: {item.error}", file=sys.stderr)
            rc = 1
            continue
        total_mp += rgb.shape[0] * rgb.shape[1] / 1e6
        out = out_path(path)
        writers.write_image(out, rgb)
        print(f"{path}: {rgb.shape[1]}x{rgb.shape[0]} -> {out}")
        if args.show:
            _show(rgb, os.path.basename(path))
    if args.time:
        print(f"batch: {len(blobs)} images, {total_mp:.2f} MP in "
              f"{dt*1e3:.0f} ms -> {total_mp/dt:.1f} MP/s", file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
