"""The port's build cache: one helper for the g++ and the nvcc build.

A library is named by a hash of its source bytes and compiler flags, so an
edited source or another flag set never loads a stale build, whatever the
files' modification times say.  Built here with g++ on a tiny C file.
"""

import ctypes
import os

import pytest

from jpeg_decoder_tpu_torch import _build
from jpeg_decoder_tpu_torch.entropy import native
from jpeg_decoder_tpu_torch.ops import (emit_carry_cuda, entropy_cuda,
                                        entropy_emit_cuda, entropy_prog_cuda,
                                        idct_cuda, idct_exact_cuda,
                                        pixels_cuda)
from jpeg_decoder_tpu_torch.probes import lut_probe
from jpeg_decoder_tpu_torch.testing import emit_v1

#: The CUDA builds of the port, one per csrc/*.cu (K7's first form, the
#: baseline chip_smoke.py times it against, included).
CUDA_LIBS = {"idct": idct_cuda.LIB, "entropy": entropy_cuda.LIB,
             "lut_probe": lut_probe.LIB, "idct_exact": idct_exact_cuda.LIB,
             "entropy_emit": entropy_emit_cuda.LIB,
             "entropy_emit_v1": emit_v1.LIB,
             "entropy_prog": entropy_prog_cuda.LIB,
             "emit_carry": emit_carry_cuda.LIB, "pixels": pixels_cuda.LIB}


def test_every_cuda_source_has_a_build():
    srcs = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    assert srcs == sorted(os.path.basename(lib.src)
                          for lib in CUDA_LIBS.values())
    assert len({lib.stem for lib in CUDA_LIBS.values()}) == len(CUDA_LIBS)

FLAGS = ("-O1", "-shared", "-fPIC")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CACHE", str(tmp_path / "cache"))
    return tmp_path


def _source(path, value):
    path.write_text(f'extern "C" int answer(void) {{ return {value}; }}\n')
    return str(path)


def _answer(lib_file):
    lib = ctypes.CDLL(lib_file)
    lib.answer.restype = ctypes.c_int
    return lib.answer()


@pytest.mark.parametrize("change,same", [
    ("nothing", True), ("flags", False), ("source", False), ("subdir", False),
])
def test_lib_path_keys_source_and_flags(cache, change, same):
    src = _source(cache / "a.cpp", 1)
    before = _build.lib_path(src, FLAGS, "native", "t")
    flags, subdir = FLAGS, "native"
    if change == "flags":
        flags = FLAGS + ("-DX",)
    elif change == "source":
        _source(cache / "a.cpp", 2)
    elif change == "subdir":
        subdir = "kernels"
    after = _build.lib_path(src, flags, subdir, "t")
    assert (before == after) is same
    assert after.startswith(
        os.path.join(str(cache), "cache", subdir, "libt_"))


def test_shared_lib_builds_once(cache):
    src = _source(cache / "a.cpp", 7)
    path, log = _build.shared_lib("g++", FLAGS, src, "native", "t",
                                  RuntimeError)
    assert log is not None and os.path.exists(path)
    again, log2 = _build.shared_lib("g++", FLAGS, src, "native", "t",
                                    RuntimeError)
    assert (again, log2) == (path, None)
    assert _answer(path) == 7


def test_edited_source_never_loads_stale_build(cache):
    """An edit whose file is older than the cached library (as after a copy
    that keeps old mtimes) still builds anew."""
    src = _source(cache / "a.cpp", 1)
    old, _ = _build.shared_lib("g++", FLAGS, src, "native", "t",
                               RuntimeError)
    _source(cache / "a.cpp", 2)
    past = os.path.getmtime(old) - 3600
    os.utime(src, (past, past))
    new, log = _build.shared_lib("g++", FLAGS, src, "native", "t",
                                 RuntimeError)
    assert new != old and log is not None
    assert _answer(new) == 2


def test_failed_build_raises_given_error(cache):
    src = cache / "bad.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(native.BuildFailure, match="g\\+\\+ failed"):
        _build.shared_lib("g++", FLAGS, str(src), "native", "t",
                          native.BuildFailure)
    assert not os.path.exists(_build.lib_path(str(src), FLAGS, "native", "t"))


def test_missing_compiler_raises_given_error(cache):
    src = _source(cache / "a.cpp", 1)
    with pytest.raises(idct_cuda.KernelBuildFailure, match="not found"):
        _build.shared_lib(str(cache / "no-such-compiler"), FLAGS, src,
                          "kernels", "t", idct_cuda.KernelBuildFailure)


def test_both_builds_share_the_cache():
    """The entropy library and the CUDA kernel are keyed the same way,
    under .cache/torch/ beside the package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _build.CACHE == os.path.join(repo, ".cache", "torch")
    lib = native._load()
    assert os.path.dirname(lib._name) == os.path.join(_build.CACHE, "native")
    assert lib._name == _build.lib_path(native._SRC, native.GXX_FLAGS,
                                        "native", "jpeg_entropy")


@pytest.mark.parametrize("name", list(CUDA_LIBS))
def test_cuda_lib_name_keys_source_and_flags(name, cache, monkeypatch):
    """Each kernel's library is named by its own source and nvcc's flags:
    an edited copy of the source or another flag set gets another name."""
    lib = CUDA_LIBS[name]
    src = cache / os.path.basename(lib.src)
    src.write_bytes(open(lib.src, "rb").read())
    copy = _build.CudaLib(os.path.basename(lib.src), lib.stem, {})
    copy.src = str(src)
    first = copy.path()
    assert first == lib.path()      # same bytes, same flags: same name
    assert os.path.basename(first).startswith(f"lib{lib.stem}_")
    src.write_bytes(src.read_bytes() + b"// edited\n")
    edited = copy.path()
    assert edited != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert lib.path() not in (first, edited)


@pytest.mark.parametrize("name", list(CUDA_LIBS))
def test_cuda_lib_without_nvcc_raises(name, cache, monkeypatch):
    """No nvcc anywhere: loading a kernel raises KernelBuildFailure (and
    builds nothing)."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else
                        os.path.lexists(p))
    lib = _build.CudaLib(os.path.basename(CUDA_LIBS[name].src),
                         CUDA_LIBS[name].stem, {})
    with pytest.raises(idct_cuda.KernelBuildFailure, match="nvcc not found"):
        lib.load()
    assert not os.path.exists(os.path.join(_build.CACHE, "kernels"))


def test_cuda_lib_name_keys_its_headers(cache, monkeypatch):
    """A source that includes a csrc/ header is named by the header's bytes
    too: an edited header gets another name; sources without the include
    keep theirs."""
    csrc = cache / "csrc"
    csrc.mkdir()
    for name in ("pixels.cu", "idct_common.cuh", "lut_probe.cu"):
        (csrc / name).write_bytes(open(os.path.join(_build.CSRC, name),
                                       "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert _build._local_headers((csrc / "pixels.cu").read_bytes()) == [
        str(csrc / "idct_common.cuh")]
    paths = {}
    for name in ("pixels.cu", "lut_probe.cu"):
        lib = _build.CudaLib(name, name.split(".")[0], {})
        paths[name] = lib.path()
    (csrc / "idct_common.cuh").write_bytes(
        (csrc / "idct_common.cuh").read_bytes() + b"// edited\n")
    assert _build.CudaLib("pixels.cu", "pixels", {}).path() != \
        paths["pixels.cu"]
    assert _build.CudaLib("lut_probe.cu", "lut_probe", {}).path() == \
        paths["lut_probe.cu"]
