"""Environment contracts: where the compile cache lives, which backends
the CLI accepts, that f64 configs solve in f64, and that chip_smoke.py
refuses to report without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest

import maxwell_tpu
from maxwell_tpu.cli import run as cli

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
ROOT = os.path.abspath(ROOT)


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert maxwell_tpu.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert maxwell_tpu.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set writes its
    compiled programs there."""
    code = (
        "import jax, maxwell_tpu, jax.numpy as jnp\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "print(jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(3)).sum())\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120, capture_output=True)
    assert any(tmp_path.iterdir()), "no cache entry written"


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_platform_choices(platform):
    args = cli._parser().parse_args(["c.json", "--platform", platform])
    assert args.platform == platform


def test_platform_rejects_others():
    with pytest.raises(SystemExit):
        cli._parser().parse_args(["c.json", "--platform", "rocm"])


@pytest.mark.parametrize("name", ["config1.json", "config2.json"])
def test_f64_config_solves_in_f64(monkeypatch, capsys, name):
    """f64 configs build f64 operators and reach tol without any
    refinement pass."""
    from maxwell_tpu.solvers.operator import Pencil

    seen = []
    orig = Pencil.from_problem

    def spy(problem, **kw):
        seen.append(jnp.dtype(kw["dtype"]))
        return orig(problem, **kw)

    monkeypatch.setattr(Pencil, "from_problem", staticmethod(spy))
    rc = cli.main([os.path.join(ROOT, "configs", name), "--nev", "2",
                   "--maxiter", "120"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and seen == [jnp.dtype(jnp.float64)]
    assert rep["converged"] and "t_refine_s" not in rep
    assert max(rep["residuals"]) <= 1e-8


def _smoke(cwd, env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_gpu():
    p = _smoke(ROOT, {})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding only the script, it fails and prints no
    result (JAX on the CPU here; on the card the package import fails)."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _smoke(str(tmp_path), {})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
