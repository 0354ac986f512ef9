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
from jpeg_decoder_tpu_torch.ops import idct_cuda

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
