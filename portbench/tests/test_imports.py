"""The harness loads neither JAX nor the JAX package, and the plain
reference nothing of the program."""

import os
import subprocess
import sys
import textwrap

from portbench.tests.tiny import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg_decoder_tpu")


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_cpu_run_loads_no_jax():
    last = _run("""
        import sys
        from portbench.tests import tiny
        result, compared = tiny.run("cam4k_b8", seconds=0.5)
        assert result["correct"], compared
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    top = set(eval(last))
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "jpeg_decoder_tpu_torch" in top


def test_forbidden_modules_compares_whole_names():
    last = _run("""
        import sys, types
        from portbench import harness
        sys.modules["jpeg_decoder_tpu_torch_x"] = types.ModuleType("x")
        sys.modules["jaxtyping"] = types.ModuleType("y")
        first = harness.forbidden_modules()
        sys.modules["jpeg_decoder_tpu.models"] = types.ModuleType("z")
        print([first, harness.forbidden_modules()])
    """)
    first, second = eval(last)
    assert first == [] and second == ["jpeg_decoder_tpu.models"]


def test_reference_imports_nothing_of_the_program():
    last = _run("""
        import sys
        import portbench.reference, portbench.corpus
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    top = set(eval(last))
    assert "jpeg_decoder_tpu_torch" not in top
    assert not top & set(FORBIDDEN)
