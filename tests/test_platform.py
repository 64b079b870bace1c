"""What the program runs on: compile cache, meshes, device reports, and
``chip_smoke.py`` refusing to pass without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from svdsolver_tpu.parallel.mesh import make_mesh
from svdsolver_tpu.utils import cache
from svdsolver_tpu.utils.device import describe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_honours_env(monkeypatch, tmp_path, restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", "/unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/unchanged"


def test_cache_env_read_by_jax(tmp_path):
    # JAX itself takes the directory from the environment
    code = "import jax; print(jax.config.jax_compilation_cache_dir)"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.stdout.strip() == str(tmp_path)


@pytest.mark.parametrize("platform", ["cpu", None])
def test_make_mesh_refuses_too_few_devices(platform):
    have = len(jax.devices(platform) if platform else jax.devices())
    with pytest.raises(ValueError, match="need"):
        make_mesh(have + 1, platform=platform)


def test_make_mesh_uses_requested_platform():
    mesh = make_mesh(4, dp=1, platform="cpu")
    assert dict(mesh.shape) == {"dp": 1, "tp": 4}
    assert {d.platform for d in mesh.devices.flat} == {"cpu"}


def test_describe_names_the_backend():
    dev = describe()
    assert dev == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "No module named 'svdsolver_tpu'" in proc.stderr
