"""What the GPU bring-up guarantees, checked on the CPU: one compile-cache
rule, no backend-name routing, no Pallas-TPU import, and a chip smoke test
that refuses to run without a GPU. The ``gpu`` test runs the smoke test
itself where a GPU is present."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(args, cwd=ROOT, env=None, timeout=300):
    full = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=timeout)


def _program_files():
    files = [ROOT / "bench.py", ROOT / "__graft_entry__.py",
             ROOT / "chip_smoke.py"]
    for sub in ("stainlib_tpu", "scripts"):
        files += sorted((ROOT / sub).rglob("*.py"))
        files += sorted((ROOT / sub).rglob("*.sh"))
    return files


@pytest.mark.parametrize("pattern", [
    r"pallas", r"pltpu", r"default_backend\(\)\s*==",
    r"platform\s*!=\s*[\"']cpu[\"']", r"interpret\s*=", r"/tmp/jax_cache"])
def test_no_tpu_routing_left(pattern):
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in _program_files()
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits


def test_no_module_imports_pallas_tpu():
    import importlib
    import pkgutil

    import stainlib_tpu

    for mod in pkgutil.walk_packages(stainlib_tpu.__path__, "stainlib_tpu."):
        if mod.name.startswith("stainlib_tpu.models"):
            continue  # flax-based families; checked by the text guard
        importlib.import_module(mod.name)
    assert "jax.experimental.pallas.tpu" not in sys.modules
    assert not (ROOT / "stainlib_tpu" / "kernels").exists()


def test_compile_cache_uses_env_dir_and_sets_nothing(tmp_path):
    code = ("import jax; from stainlib_tpu.utils.compile_cache import "
            "enable_compile_cache as e; print(e()); "
            "print(jax.config.jax_compilation_cache_dir); "
            "import jax.numpy as jnp; jax.jit(lambda x: x * 2 + 1)"
            "(jnp.ones(8)).block_until_ready()")
    cache = tmp_path / "cache"
    out = _run(["-c", code], env={
        "JAX_COMPILATION_CACHE_DIR": str(cache), "JAX_PLATFORMS": "cpu",
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"})
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()[:2]
    assert returned == str(cache) and configured == str(cache)
    assert any(cache.iterdir())


def test_compile_cache_defaults_to_checkout_dir():
    code = ("import jax; from stainlib_tpu.utils.compile_cache import "
            "enable_compile_cache as e; print(e()); "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()[:2]
    assert returned == configured == str(ROOT / ".jax_cache")


def test_chip_smoke_refuses_cpu():
    out = _run(["chip_smoke.py"], env={"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs 1 GPU" in out.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def gpu_available():
    """Whether JAX sees a GPU outside this CPU-forced test process: asked
    of a child process, so the answer is decided here, at run time."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cuda"  # fails fast where there is no CUDA
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or out.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_available):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stdout + out.stderr
    assert '"ok": true' in out.stdout.splitlines()[-1]
