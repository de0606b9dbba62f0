"""Bring-up proof on the GPU: drive the eigensolver's main paths once at a
real size, compare every operator apply with its plain reference, and
print one JSON line.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: the distributed path only

Phases (one process; nothing is caught and carried on):
  1. device: JAX's first device must be a GPU, else exit 1;
  2. apply parity: assembled 48^3 K against scipy f64, m in {1, 8, 24},
     f32 and f64, for the XLA reference, the Triton kernel and the
     width-based "auto" choice;
  3. matrix-free 64^3: f32 LOBPCG + native-f64 polish on the card to
     1e-8, residuals recomputed in f64 on the card;
  4. assembled 32^3 through maxwell_tpu.solve in native f64;
  5. every committed config through the CLI, and config5 once more as an
     f32 staged solve with the per-stage distributed f64 polish.
The last line of standard output is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def _device_phase():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU (first device is {devs[0].platform!r})",
            file=sys.stderr,
        )
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[1] device_kind={devs[0].device_kind!r} count={len(devs)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    for line in smi.splitlines():
        log(f"[1] nvidia-smi: {line}")
    return devs


def _timed(fn, *args, reps: int = 20) -> float:
    """Seconds per call of an already-compiled fn, after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _memory(compiled) -> str:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{k[:-9]}={getattr(ma, k, None)}" for k in keys)


def apply_phase(grid: int, widths) -> None:
    """Each apply against scipy f64 K @ X at real widths: the XLA
    reference, the Triton kernel as compiled for the card, and the GPU
    apply that "auto" resolves to (it picks one of the two per width).
    Tolerances, relative to ||K||_inf ||X||_max: f32 1e-5
    (HIGHEST/elementwise f32, sums in another order than scipy's), f64
    1e-12."""
    import jax
    import jax.numpy as jnp

    from maxwell_tpu.kernels.spmm import (
        bsr_matmat_triton,
        choose_apply,
        matmat_fn,
        resolve_kernel,
    )
    from maxwell_tpu.problems import BrickCavity3D
    from maxwell_tpu.sparse.bsr import BSRMatrix, bsr_matmat_ref

    applies = {"ref": bsr_matmat_ref, "triton": bsr_matmat_triton,
               "auto": matmat_fn(resolve_kernel("auto"))}

    t0 = time.perf_counter()
    K = BrickCavity3D(nx=grid, ny=grid, nz=grid).K.tocsr()
    n = K.shape[0]
    knorm = abs(K).sum(axis=1).max()
    log(f"[2] assembled {grid}^3 K: n={n} nnz={K.nnz} "
        f"({time.perf_counter() - t0:.1f} s host)")
    rng = np.random.default_rng(0)
    for dtype, tol in ((jnp.float32, 1e-5), (jnp.float64, 1e-12)):
        A = BSRMatrix.from_csr(K, block=4, align_slots=4, dtype=dtype)
        for m in widths:
            X = np.zeros((A.n_padded, m))
            X[:n] = rng.standard_normal((n, m))
            ref = K @ X[:n]
            scale = knorm * np.abs(X).max()
            Xd = jnp.asarray(X, dtype)
            log(f"[2] m={m}: auto picks {choose_apply(A, Xd)}")
            for name, mm in applies.items():
                compiled = jax.jit(mm).lower(A, Xd).compile()
                Y = np.asarray(compiled(A, Xd), np.float64)[:n]
                err = np.abs(Y - ref).max() / scale
                t = _timed(compiled, A, Xd)
                log(f"[2] {name:6s} {jnp.dtype(dtype).name} m={m:2d}: "
                    f"rel err {err:.2e} (tol {tol:.0e}) "
                    f"{t * 1e3:.3f} ms/apply "
                    f"{K.nnz * m / t / 1e9:.2f} Gnnz*col/s; "
                    f"{_memory(compiled)}")
                if not err <= tol:
                    raise AssertionError(f"{name} m={m} error {err:.2e}")


def _h2_bound(grid: int) -> float:
    """Allowed relative eigenvalue error against the continuum modes:
    lowest-order Nedelec on a uniform brick is O(h^2); 5 h^2 is a few
    times the measured constant for the lowest five modes."""
    return 5.0 / grid**2


def _f64_check(grid: int, X, tag: str) -> np.ndarray:
    """Residuals and Rayleigh quotients of host eigenvectors X (stencil
    ordering) recomputed in native f64 on the card; raises unless every
    residual is <= 1e-8 and the eigenvalues are within O(h^2) of the
    analytic modes. Returns the sorted Rayleigh quotients."""
    import jax.numpy as jnp

    from maxwell_tpu.problems.analytic import cavity_eigenvalues_3d
    from maxwell_tpu.problems.stencil3d import StencilPencil3D

    nev = X.shape[1]
    pen64 = StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                  dtype=jnp.float64)
    Xd = jnp.zeros((pen64.n_padded, nev), jnp.float64).at[: pen64.n].set(
        jnp.asarray(X, jnp.float64))
    KX, MX = pen64.K_mm(Xd), pen64.M_mm(Xd)
    theta = jnp.sum(Xd * KX, axis=0) / jnp.sum(Xd * MX, axis=0)
    R = KX - MX * theta[None, :]
    res = np.asarray(
        jnp.linalg.norm(R, axis=0)
        / (jnp.linalg.norm(KX, axis=0)
           + jnp.abs(theta) * jnp.linalg.norm(MX, axis=0))
    )
    theta = np.sort(np.asarray(theta))
    err = np.abs(theta / cavity_eigenvalues_3d(1.0, 1.0, 1.0, nev) - 1.0)
    log(f"[{tag}] f64 recomputed residuals "
        f"{np.array2string(res, precision=2)}; analytic rel err max "
        f"{err.max():.2e} (bound {_h2_bound(grid):.1e})")
    if not res.max() <= 1e-8:
        raise AssertionError(f"{tag}: f64 residual {res.max():.2e}")
    if not err.max() <= _h2_bound(grid):
        raise AssertionError(f"{tag}: analytic error {err.max():.2e}")
    return theta


def stencil_phase(grid: int, nev: int = 5) -> None:
    import jax
    import jax.numpy as jnp

    from maxwell_tpu.problems.stencil3d import StencilPencil3D
    from maxwell_tpu.solvers import lobpcg
    from maxwell_tpu.solvers.refine import refine_f64_pencil
    from maxwell_tpu.solvers.spectral import spectral_preconditioner

    pen = StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                dtype=jnp.float32)
    pc = spectral_preconditioner(pen, alpha=15.0)
    # how many device kernels XLA makes of one tap apply (K @ X, m=8)
    X8 = jnp.zeros((pen.n_padded, 8), jnp.float32)
    hlo = jax.jit(lambda p, X: p.K_mm(X)).lower(pen, X8).compile().as_text()
    kernels = sum(" fusion(" in ln and "kind=" in ln for ln in hlo.splitlines())
    customs = sum(" custom-call(" in ln for ln in hlo.splitlines())
    log(f"[3] tap K_mm {grid}^3 m=8 compiles to {kernels} fusions and "
        f"{customs} custom calls")

    def run():
        t0 = time.perf_counter()
        r = lobpcg(pen, nev=nev, maxiter=60, tol=2e-6, precond=pc,
                   stall_window=10, return_device=True)
        jax.block_until_ready(r.eigenvectors)
        t1 = time.perf_counter()
        ref = refine_f64_pencil(
            lambda: StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                          dtype=jnp.float64),
            r.eigenvectors, tol=1e-8,
        )
        return r, ref, t1 - t0, time.perf_counter() - t1

    r, ref, s_cold, f_cold = run()
    r, ref, s_warm, f_warm = run()
    cold, warm = s_cold + f_cold, s_warm + f_warm
    log(f"[3] stencil {grid}^3 n={pen.n}: lobpcg {r.iterations} it "
        f"res {r.residuals.max():.1e} -> f64 polish {ref.iterations} it "
        f"res {ref.residuals.max():.1e}; cold {cold:.2f} s "
        f"(solve {s_cold:.2f} + refine {f_cold:.2f}), warm {warm:.2f} s "
        f"(solve {s_warm:.2f} + refine {f_warm:.2f}), compile "
        f"{cold - warm:.2f} s")

    if not ref.converged:
        raise AssertionError(f"stencil polish residual "
                             f"{ref.residuals.max():.2e}")
    _f64_check(grid, ref.eigenvectors, "3")


def assembled_phase(grid: int, nev: int = 5) -> None:
    import jax.numpy as jnp

    import maxwell_tpu
    from maxwell_tpu.kernels.spmm import resolve_kernel
    from maxwell_tpu.problems import BrickCavity3D

    cav = BrickCavity3D(nx=grid, ny=grid, nz=grid)
    t0 = time.perf_counter()
    res = maxwell_tpu.solve(cav, nev=nev, dtype=jnp.float64, tol=1e-8)
    t = time.perf_counter() - t0
    X = np.asarray(res.eigenvectors, np.float64)
    theta = np.asarray(res.eigenvalues, np.float64)
    KX, MX = cav.K @ X, cav.M @ X
    rel = np.linalg.norm(KX - MX * theta, axis=0) / (
        np.linalg.norm(KX, axis=0)
        + np.abs(theta) * np.linalg.norm(MX, axis=0)
    )
    err = np.abs(np.sort(theta) / cav.analytic_eigenvalues(nev) - 1.0)
    log(f"[4] assembled {grid}^3 f64 n={cav.n_edges} kernel="
        f"{resolve_kernel()}: {res.iterations} it in {t:.2f} s (cold); "
        f"host f64 residuals max {rel.max():.1e}; analytic rel err max "
        f"{err.max():.2e} (bound {_h2_bound(grid):.1e})")
    if not (res.converged and rel.max() <= 1e-8):
        raise AssertionError(f"assembled residual {rel.max():.2e}")
    if not err.max() <= _h2_bound(grid):
        raise AssertionError(f"assembled analytic error {err.max():.2e}")


def _run_config(path: str, name: str) -> None:
    from maxwell_tpu.cli import run as cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([path])
    t = time.perf_counter() - t0
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    ana = rep.get("analytic_rel_err")
    log(f"[5] {name}: rc={rc} converged={rep['converged']} "
        f"n={rep['n']} it={rep['iterations']} max res "
        f"{max(rep['residuals']):.1e} analytic rel err "
        f"{max(ana) if ana else 'n/a'} wall {t:.1f} s "
        f"(solve {rep['t_solve_s']:.1f} s"
        f"{', refine %.1f s' % rep['t_refine_s'] if 't_refine_s' in rep else ''})")
    if rc != 0 or not rep["converged"]:
        raise AssertionError(f"{name} did not converge")


def configs_phase(names) -> None:
    """Every committed config by name, then config5 as an f32 staged solve
    whose stages are polished in f64 on the mesh before they deflate the
    next stage (the CLI's `refine` road for distributed stencils)."""
    from maxwell_tpu import native

    log(f"[5] HAVE_NATIVE={native.HAVE_NATIVE}")
    for name in names:
        _run_config(os.path.join(ROOT, "configs", name), name)
    with open(os.path.join(ROOT, "configs", "config5.json")) as f:
        cfg = json.load(f)
    cfg["storage"]["dtype"] = "f32"
    cfg["solver"]["refine"] = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config5_f32_refine.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        _run_config(path, "config5.json as f32 + refine")


def four_phase(grid: int, asm_grid: int, D: int = 4) -> None:
    """The distributed path on D devices against the same path on one:
    slab-sharded stencil f32 LOBPCG + distributed native-f64 polish to
    1e-8, and the row-partitioned assembled apply with ppermute halos."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from maxwell_tpu.dist import make_mesh, partition_problem
    from maxwell_tpu.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu.problems import BrickCavity3D
    from maxwell_tpu.solvers.dist_solve import lobpcg_dist, spmm_dist
    from maxwell_tpu.solvers.operator import Pencil
    from maxwell_tpu.solvers.refine import refine_f64_dist

    eigs = {}
    for d in (1, D):
        mesh = make_mesh(d)

        def build(dtype, d=d):
            return DistStencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                             D=d, dtype=dtype)

        dp = build(jnp.float32)
        t0 = time.perf_counter()
        r = lobpcg_dist(dp, mesh, nev=5, maxiter=80, tol=2e-6,
                        precond="spectral", precond_alpha=15.0,
                        stall_window=10, return_device=True)
        jax.block_until_ready(r.eigenvectors)
        t1 = time.perf_counter()
        ref = refine_f64_dist(lambda: build(jnp.float64), mesh,
                              r.eigenvectors, tol=1e-8)
        t2 = time.perf_counter()
        shards = sorted(
            str(s.device) for s in r.eigenvectors.addressable_shards
        )
        log(f"[dist] stencil {grid}^3 mesh of {d}: f32 {r.iterations} it "
            f"-> res {r.residuals.max():.1e} in {t1 - t0:.2f} s, f64 polish "
            f"{ref.iterations} it -> res {ref.residuals.max():.1e} in "
            f"{t2 - t1:.2f} s (cold); shards on {shards}")
        if not ref.converged:
            raise AssertionError(f"mesh of {d}: polish did not converge")
        eigs[d] = _f64_check(grid, ref.eigenvectors, "dist")
    diff = np.abs(eigs[D] / eigs[1] - 1.0).max()
    log(f"[dist] eigenvalues mesh {D} vs mesh 1: max rel diff {diff:.1e}")
    if not diff <= 1e-8:
        raise AssertionError(f"mesh eigenvalues differ by {diff:.2e}")

    cav = BrickCavity3D(nx=asm_grid, ny=asm_grid, nz=asm_grid)
    dp = partition_problem(cav, D, dtype=jnp.float64)
    mesh = make_mesh(D)
    n = dp.n
    X = np.zeros((dp.global_rows, 8))
    X[:n] = np.random.default_rng(3).standard_normal((n, 8))
    Xd = jnp.asarray(X)
    Y = spmm_dist(dp, mesh, Xd, which="K")
    shards = sorted(str(s.device) for s in Y.addressable_shards)
    checksum = float(jax.jit(jax.shard_map(
        lambda p, Xl: p.halo_checksum(Xl), mesh=mesh,
        in_specs=(dp.partition_specs(), P(dp.axis, None)), out_specs=P(),
        check_vma=False,
    ))(dp, Xd))
    single = Pencil.from_problem(cav, dtype=jnp.float64)
    Xo = np.zeros((single.n_padded, 8))
    Xo[:n] = X[:n][np.argsort(dp.perm)]
    Ys = np.asarray(single.K_mm(jnp.asarray(Xo)))[:n][dp.perm]
    err = np.abs(np.asarray(Y)[:n] - Ys).max() / np.abs(Ys).max()
    log(f"[dist] assembled {asm_grid}^3 on {D} shards (kernel {dp.kernel}, "
        f"H={dp.H} L={dp.L}): spmm_dist vs single-card rel diff "
        f"{err:.1e}, halo checksum {checksum}; shards on {shards}")
    if not (err <= 1e-12 and checksum == 0.0):
        raise AssertionError("sharded apply disagrees with the single card")


CONFIGS = (
    "config1.json", "config2.json", "config3.json", "config4.json",
    "config4_stencil.json", "config5.json", "config6_tet.json",
    "config7_dielectric.json",
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the distributed path on four cards, against one",
    )
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    devs = _device_phase()

    import jax

    jax.config.update("jax_enable_x64", True)
    phases = (
        [("distributed", lambda: four_phase(64, 32))]
        if args.four
        else [
            ("2 apply parity", lambda: apply_phase(48, (1, 2, 4, 8, 24))),
            ("3 stencil 64^3", lambda: stencil_phase(64)),
            ("4 assembled 32^3", lambda: assembled_phase(32)),
            ("5 configs", lambda: configs_phase(CONFIGS)),
        ]
    )
    if args.four and len(devs) != 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    for name, phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"[phase {name}] {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
