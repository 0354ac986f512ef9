"""jpeg_decoder_tpu_torch — the PyTorch/CUDA port of jpeg_decoder_tpu.

The batched serving path (host parse, native entropy decode to the nibble
wire, pow-2 geometry grouping, then unpack, plane gather, dequant+IDCT,
fancy upsample and YCbCr->RGB on the device), with the dequant+IDCT step as
a hand-written CUDA kernel for Hopper (``csrc/idct.cu``).  The package
imports torch and numpy, never jax or ``jpeg_decoder_tpu``; importing it
builds nothing (the native library and the kernel are built at first use
under ``.cache/torch/``).
"""

from .io.parser import parse
from .models.batch import BatchDecoder, BatchItem, decode_batch
from .types import JPEGError

__all__ = ["BatchDecoder", "BatchItem", "JPEGError", "decode_batch", "parse"]
