"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points refuse to run without a GPU unless the caller asks for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import koboldcpp_tpu_torch

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(koboldcpp_tpu_torch.__file__)


def _submodules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="koboldcpp_tpu_torch."))


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import importlib, sys\n"
        f"for name in {['koboldcpp_tpu_torch', *_submodules()]!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'koboldcpp_tpu' "
        "or m.startswith('koboldcpp_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def test_sources_never_name_jax_or_the_jax_package():
    """No `import jax` and no `koboldcpp_tpu` short of `koboldcpp_tpu_torch`
    (word boundary); a source note may still point at a file of the JAX
    package by its path, `koboldcpp_tpu/...`."""
    jax_import = re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M)
    jax_pkg = re.compile(r"\bkoboldcpp_tpu\b(?!_torch|/)")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, subdirs, fs in os.walk(PKG_DIR):
        subdirs[:] = [s for s in subdirs if s != "_build"]  # build outputs
        paths += [os.path.join(d, f) for f in fs
                  if f.endswith((".py", ".cu", ".cuh"))]
    for path in paths:
        src = open(path, encoding="utf-8").read()
        assert not jax_import.search(src), path
        hit = jax_pkg.search(src)
        assert hit is None, (path, src[max(0, hit.start() - 60):hit.end() + 20])


def test_entry_points_need_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the path taken on a machine without a GPU")
    from koboldcpp_tpu_torch.device import resolve_device
    from koboldcpp_tpu_torch.engine import Engine
    from koboldcpp_tpu_torch.models.loader import load_model
    from koboldcpp_tpu_torch.models.synthetic import (TINYLLAMA_1_1B,
                                                      synthetic_params)

    fix = os.path.join(ROOT, "tests", "fixtures", "refgguf",
                       "tiny-q4_k_m.gguf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(fix)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_params(TINYLLAMA_1_1B)
    m = load_model(fix, device="cpu")
    assert m.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(m)
    Engine(m, max_context=32, device="cpu")


def test_every_jax_module_has_its_port():
    """Every module of the JAX package has its counterpart under the same
    relative path, but utils/compile_cache.py (the port's kernel builds
    are cached by ops/_build.py): the parallel forms, the GUI launcher,
    the United backend and the horde / tunnel host modules included."""
    jax_dir = os.path.join(ROOT, "koboldcpp_tpu")
    missing = []
    for d, subdirs, fs in os.walk(jax_dir):
        subdirs[:] = [s for s in subdirs if s != "__pycache__"]
        for f in fs:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), jax_dir)
                if not os.path.exists(os.path.join(PKG_DIR, rel)):
                    missing.append(rel)
    assert missing == [os.path.join("utils", "compile_cache.py")], missing
    for name in ("parallel.comm", "parallel.sharding", "parallel.pipeline",
                 "parallel.sequence", "parallel.ring_attention",
                 "parallel.multihost", "parallel.launch", "gui", "united",
                 "server.horde", "server.tunnel"):
        assert f"koboldcpp_tpu_torch.{name}" in _submodules()
