"""jpeg_decoder_tpu_torch — the PyTorch/CUDA port of jpeg_decoder_tpu.

Three entry points: the batched serving path :class:`BatchDecoder` (host
parse, entropy decode to one of four wire formats, geometry grouping, then
unpack, plane gather, dequant+IDCT, fancy upsample and YCbCr->RGB on the
device, in waves that overlap host and device work); the batch with entropy
decode on the device, :func:`decode_batch_sharded` (``parallel/sharded.py``:
per geometry group one launch of the emit-lane kernel
(``csrc/entropy_emit.cu``) or of the Huffman decoder over every restart
segment, then plane gather and pixels); and the single-image :func:`decode`
(host parse and scan prep, then Huffman decode, plane gather, dequant+IDCT,
upsample and colour on the device).  Progressive Huffman frames of 8 bits
decode on the card too, under ``decode(entropy="pallas"|"jax"|"hybrid")``
and in :func:`decode_batch_sharded`: each scan as lanes of the progressive
scan kernels (``ops/entropy_prog.py``).  Arithmetic, multi-scan and
restart-mismatched frames, progressive ones under the host backends (and,
in ``BatchDecoder``, 12-bit ones) decode to host planes first.
:func:`decode_to_file` writes the result (``io/writers.py``) and
``python -m jpeg_decoder_tpu_torch`` is the command-line tool (``cli.py``).
Their device kernels are hand-written CUDA for Hopper: the Kronecker
dequant+IDCT K1 (``csrc/idct.cu``), the strict AAN dequant+IDCT K5
(``csrc/idct_exact.cu``), the Huffman decoder over restart segments K2
(``csrc/entropy.cu``), the emit-lane Huffman decoder K7 of the ``hybrid``
backend and the device-entropy batch (``csrc/entropy_emit.cu``) and the
progressive scan kernels K8a-K8d (``csrc/entropy_prog.cu``: DC first, DC
refinement, AC first, AC refinement), and the batch routes' pixel stage
(``csrc/pixels.cu``: K6a, the nibble wire's unpack, and K6b, scan-order
blocks to RGB in one launch under every IDCT); ``csrc/lut_probe.cu`` holds the
LUT-probe kernels K3/K4 (``probes/lut_probe.py``).  Entry points run on the
card unless the caller passes ``device="cpu"``, which runs every kernel's
plain PyTorch version.  ``decode_batch_sharded`` and the other functions of
``parallel/sharded.py`` also take a ``torch.distributed`` ``DeviceMesh``
(``parallel/mesh.py``, ``parallel/multihost.py``: one process per GPU),
each rank decoding its share with the same kernels and K7c
(``csrc/emit_carry.cu``) carrying DC across ranks.  The package imports torch and numpy, never jax or
``jpeg_decoder_tpu``; importing it builds nothing (the native library and
the kernels are built at first use under ``.cache/torch/``).
"""

from .io.parser import parse, parse_file
from .models.batch import BatchDecoder, BatchItem, decode_batch
from .models.decoder import DecodeResult, decode, decode_to_file
from .parallel.sharded import decode_batch_sharded
from .types import FrameHeader, JPEGError

__all__ = ["BatchDecoder", "BatchItem", "DecodeResult", "FrameHeader",
           "JPEGError", "decode", "decode_batch", "decode_batch_sharded",
           "decode_to_file", "parse", "parse_file"]
