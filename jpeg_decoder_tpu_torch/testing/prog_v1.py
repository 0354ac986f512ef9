"""K8a-K8d's first forms, kept as the same-card baseline of the current
kernels.

``csrc/entropy_prog.cu`` keeps the four kernels as they were first ported
behind the C entries ``jd_prog_dc_v1`` (``dc_first_kernel_v1``: one thread
per lane; ``dc_refine_kernel_v1``: one thread per lane and slot up to the
longest lane) and ``jd_prog_ac_v1`` (``ac_first_kernel_v1``,
``ac_refine_kernel_v1``: one thread per lane), 128 threads a CTA, every
table probe, word, history value and correction bit read from device
memory, in the same build as the current ones.  ``chip_smoke.py`` and the
card tests time and check them in turns with
``ops/entropy_prog_cuda.dc_first``/``dc_refine``/``ac_first``/``ac_refine``
on the same inputs.  Nothing in ``decode()``, ``BatchDecoder`` or
``decode_batch_sharded`` reaches this module.
"""

from __future__ import annotations

import torch

from .._build import launch_check
from ..ops import entropy_prog_cuda as k8


def _dc_v1(refine: bool, words, lanes: k8.LaneTable, luts, planes: list,
           geom: k8.Geometry, al: int) -> torch.Tensor:
    dev = k8._check(words, lanes, [] if luts is None else [luts], planes,
                    geom, al)
    if dev.type != "cuda":
        raise ValueError("the first-form kernels run on CUDA tensors only")
    nsc = 0 if luts is None else luts.shape[0]
    if not refine and (lanes.pred0.shape[1] != nsc or any(
            not 0 <= s[5] < nsc for s in geom.slots)):
        raise ValueError("pred0, luts and the slots' components disagree")
    err = torch.zeros(lanes.n, dtype=torch.int32, device=dev)
    geo = geom.pack()
    with torch.cuda.device(dev):
        rc = k8.build().jd_prog_dc_v1(
            int(refine), *k8._lane_ptrs(words, lanes),
            lanes.pred0.data_ptr(), nsc,
            None if luts is None else luts.data_ptr(),
            *k8._plane_ptrs(planes), geo.ctypes.data, al,
            int(lanes.chained), lanes.n, lanes.max_units * geom.bpm,
            err.data_ptr(), k8._stream(dev))
    launch_check(rc, "jd_prog_dc_v1")
    return err


def dc_first_v1(words, lanes, luts, planes, geom, *, al: int,
                table=None) -> torch.Tensor:
    """K8a's first form: ``entropy_prog_cuda.dc_first``'s contract on CUDA
    tensors (it reads the LUTs itself: ``table`` is ignored).  Returns the
    lane flags."""
    return _dc_v1(False, words, lanes, luts, planes, geom, al)


def dc_refine_v1(words, lanes, planes, geom, *, al: int) -> torch.Tensor:
    """K8b's first form: ``entropy_prog_cuda.dc_refine``'s contract on CUDA
    tensors.  Returns the lane flags."""
    return _dc_v1(True, words, lanes, None, planes, geom, al)


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
