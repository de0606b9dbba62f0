"""CLI driver end-to-end: every BASELINE config runs by name and reports
converged eigenpairs (SURVEY.md §2 C17, §5.6)."""

import json
import os

import pytest

from maxwell_tpu.cli import run as cli

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "..", "configs")


def run_cli(capsys, name, *extra):
    rc = cli.main([os.path.join(CONFIGS, name), *extra])
    assert rc == 0
    lines = [
        json.loads(l)
        for l in capsys.readouterr().out.strip().splitlines()
        if l.startswith("{")
    ]
    return lines[-1]  # final report


def test_config1(capsys):
    rep = run_cli(capsys, "config1.json", "--nev", "3")
    assert rep["converged"]
    assert max(rep["analytic_rel_err"]) < 3e-2


def test_config2(capsys):
    rep = run_cli(capsys, "config2.json", "--nev", "3", "--maxiter", "60")
    assert rep["converged"]
    assert max(rep["analytic_rel_err"]) < 1e-2


def test_config3(capsys):
    rep = run_cli(capsys, "config3.json")
    assert rep["converged"]
    assert min(rep["eigenvalues"]) > 30  # interior modes near sigma=45


def test_config4(capsys):
    rep = run_cli(capsys, "config4.json", "--maxiter", "40")
    assert rep["converged"]
    assert max(rep["analytic_rel_err"]) < 5e-2


def test_config5(capsys):
    rep = run_cli(capsys, "config5.json", "--nev", "8", "--maxiter", "80")
    assert rep["converged"]
    assert len(rep["eigenvalues"]) == 8


def test_config4_stencil(capsys):
    rep = run_cli(capsys, "config4_stencil.json", "--maxiter", "40")
    assert rep["converged"]
    assert max(rep["analytic_rel_err"]) < 5e-2


def test_eigenvector_export(capsys, tmp_path):
    import numpy as np

    out = str(tmp_path / "pairs.npz")
    rep = run_cli(
        capsys, "config1.json", "--nev", "2", "--save-eigenvectors", out
    )
    with np.load(out) as z:
        assert z["eigenvectors"].shape[1] == 2
        assert np.all(np.isfinite(z["eigenvalues"]))


def test_refine_runs_when_batch_covers_nev(capsys, tmp_path):
    """refine: true with batch >= nev: lobpcg_dist takes the unstaged path
    and never calls the per-stage polish hook, so the final refinement
    must still run (it used to be switched off whenever the hook was
    built, returning the f32-floor block)."""
    cfg = {
        "problem": {"kind": "brick3d", "nx": 8, "ny": 8, "nz": 8},
        "solver": {"kind": "lobpcg_dist", "nev": 3, "batch": 4,
                   "tol": 1e-8, "maxiter": 60, "precond_alpha": 15.0,
                   "refine": True},
        "storage": {"dtype": "f32", "operator": "stencil"},
        "dist": {"n_shards": 2},
    }
    path = tmp_path / "staged.json"
    path.write_text(json.dumps(cfg))
    rep = run_cli(capsys, str(path))
    assert "t_refine_s" in rep
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8


def test_staged_refine_polishes_each_stage(capsys, tmp_path):
    """refine: true with batch < nev: each f32 stage is polished in f64 on
    the mesh (earlier stages deflated) before it joins the deflation
    basis, and the generic final pass is skipped."""
    cfg = {
        "problem": {"kind": "brick3d", "nx": 8, "ny": 8, "nz": 8},
        "solver": {"kind": "lobpcg_dist", "nev": 4, "batch": 2,
                   "tol": 1e-8, "maxiter": 60, "precond_alpha": 15.0,
                   "refine": True},
        "storage": {"dtype": "f32", "operator": "stencil"},
        "dist": {"n_shards": 2},
    }
    path = tmp_path / "staged.json"
    path.write_text(json.dumps(cfg))
    rep = run_cli(capsys, str(path))
    assert "t_refine_s" not in rep
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    # against the analytic modes with their multiplicities: a pair found
    # twice would push the next mode out of the list
    assert max(rep["analytic_rel_err"]) < 5e-2
