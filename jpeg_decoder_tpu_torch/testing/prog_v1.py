"""K8c and K8d's first forms, kept as the same-card baseline of the current
kernels.

``csrc/entropy_prog.cu`` keeps the AC kernels as they were first ported
(``ac_first_kernel_v1``, ``ac_refine_kernel_v1``: one thread per lane, 128
threads a CTA, every table probe, word, history value and correction bit
read from device memory) behind the C entry ``jd_prog_ac_v1``, in the same
build as the current ones.  ``chip_smoke.py`` and the card tests time and
check them in turns with ``ops/entropy_prog_cuda.ac_first``/``ac_refine`` on
the same inputs.  Nothing in ``decode()``, ``BatchDecoder`` or
``decode_batch_sharded`` reaches this module.
"""

from __future__ import annotations

import torch

from .._build import launch_check
from ..ops import entropy_prog_cuda as k8


def _ac_v1(refine: bool, words, lanes: k8.LaneTable, lut, plane,
           geom: k8.Geometry, ss: int, se: int, al: int) -> torch.Tensor:
    dev = k8._check(words, lanes, [lut], [plane], geom, al, band=(ss, se))
    if geom.bpm != 1 or lut.shape[0] != 1:
        raise ValueError("AC scans have one component and one table")
    if dev.type != "cuda":
        raise ValueError("the first-form kernels run on CUDA tensors only")
    err = torch.zeros(lanes.n, dtype=torch.int32, device=dev)
    geo = geom.pack()
    with torch.cuda.device(dev):
        rc = k8.build().jd_prog_ac_v1(
            int(refine), *k8._lane_ptrs(words, lanes),
            lanes.eob0.data_ptr(), lut.data_ptr(), plane.data_ptr(),
            geo.ctypes.data, ss, se, al, int(lanes.chained), lanes.n,
            err.data_ptr(), k8._stream(dev))
    launch_check(rc, "jd_prog_ac_v1")
    return err


def ac_first_v1(words, lanes, lut, plane, geom, *, ss: int, se: int,
                al: int, table=None) -> torch.Tensor:
    """K8c's first form: ``entropy_prog_cuda.ac_first``'s contract on CUDA
    tensors (it reads the LUT itself: ``table`` is ignored).  Returns the
    lane flags."""
    return _ac_v1(False, words, lanes, lut, plane, geom, ss, se, al)


def ac_refine_v1(words, lanes, lut, plane, geom, *, ss: int, se: int,
                 al: int, table=None) -> torch.Tensor:
    """K8d's first form: ``entropy_prog_cuda.ac_refine``'s contract on CUDA
    tensors (``table`` is ignored).  Returns the lane flags."""
    return _ac_v1(True, words, lanes, lut, plane, geom, ss, se, al)
