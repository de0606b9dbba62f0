"""Benchmark harness (SURVEY.md §6). Needs the GPU: it exits 1 when JAX's
first device is not one, and never falls back to the CPU.

Sections, each recorded under its own keys in bench_details.json (a
section that raises is recorded as `<section>_error`, the remaining
sections still run, and the script exits 1 at the end):
  1. device memory copy and read bandwidth;
  2. operator applies against their own byte traffic: the XLA blocked-ELL
     reference and the Triton kernel at 24^3 (m=8) and 48^3 (m=24), and
     the assembly-free tap stencil at 24^3 and 64^3;
  3. physics parity gate + per-phase LOBPCG costs (12^3 assembled), then
     the eigensolves: 64^3 stencil f32 solve + native-f64 polish on the
     card (time-to-1e-8, residual re-verified in f64), the 48^3 assembled
     LOBPCG at 30 fixed iterations with each apply, 128^3 stencil,
     dielectric 32^3, 12^3 time-to-1e-8 with the host f64 polish,
     distributed 64^3 in f64 on a mesh of one, shift-invert rows and the
     staged-locking per-iteration cost.

Timing: host clock around work that ends in block_until_ready. Kernel
rows time a jitted chain of applies (one dispatch); solver rows record
cold (compile + run) and the median of warm runs.

Prints ONE JSON line:
  {"metric": "spmv_nnz_per_s_per_chip", "value": ..., "unit": "nnz/s",
   "vs_baseline": <the headline apply's share of its own copy-bandwidth
   roofline>}
with platform, device kind, device count, and the card's name and power
limit beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np


def _chain_time(fn, x0, iters=20, args=(), repeats=3):
    """Seconds per call of shape-preserving `fn`, timed as one jitted
    fori_loop of `iters` dependent calls (median of `repeats`). Large
    operands ride as jit arguments, not closure constants."""
    import jax

    f = jax.jit(
        lambda x, *a: jax.lax.fori_loop(0, iters, lambda i, y: fn(y, *a), x)
    )
    jax.block_until_ready(f(x0, *args))  # compile + warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x0, *args))
        ts.append((time.perf_counter() - t0) / iters)
    return float(np.median(ts))


def _wallstats(fn, runs=3):
    """Cold + `runs` warm wall timings of a whole solver call. The callee
    must block on its device results. Returns (last_result, stats)."""
    t0 = time.perf_counter()
    out = fn()
    cold = time.perf_counter() - t0
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[len(ts) // 2]
    return out, {
        "cold_s": cold,
        "median_s": med,
        "min_s": ts[0],
        "max_s": ts[-1],
        "compile_s": max(cold - med, 0.0),
    }


def _ready(res):
    import jax

    jax.block_until_ready(res.eigenvectors)
    return res


def _polish(build, res, **kw):
    """Native-f64 polish on the device of an f32 block to 1e-8."""
    from maxwell_tpu.solvers.refine import refine_f64_pencil

    return refine_f64_pencil(build, res.eigenvectors, tol=1e-8, **kw)


def _analytic_rel(eigs, nev):
    from maxwell_tpu.problems.analytic import cavity_eigenvalues_3d

    return np.abs(np.sort(eigs) / cavity_eigenvalues_3d(1, 1, 1, nev) - 1)


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, first device is {dev.platform!r}",
              file=sys.stderr)
        sys.exit(1)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    details = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }
    paths = {}
    state = {}
    key = jax.random.PRNGKey(0)

    def log(msg):
        print(f"bench: {msg}", file=sys.stderr, flush=True)

    def section(name):
        def run(fn):
            log(f"{name}...")
            t0 = time.perf_counter()
            try:
                fn()
            except Exception as e:  # recorded, fails the run at the end
                details[f"{name}_error"] = repr(e)[:400]
                traceback.print_exc()
            log(f"  {name}: {time.perf_counter() - t0:.1f} s")
        return run

    # ---- 1. device memory bandwidth ------------------------------------
    @section("hbm")
    def _():
        nbytes = 1 << 30
        big = jnp.ones((nbytes // 4,), jnp.float32)
        t = _chain_time(lambda x: jnp.abs(x) + 1.0, big, iters=20)
        bw = 2 * nbytes / t
        y0 = jnp.zeros((1,), jnp.float32)
        t = _chain_time(lambda y, B: jnp.sum(B + y)[None], y0, iters=20,
                        args=(big,))
        bw_r = max(nbytes / t, bw / 2 * 1.001)
        state["bw"] = bw
        details["hbm_copy_GBps"] = bw / 1e9
        details["hbm_read_GBps"] = bw_r / 1e9
        log(f"  copy {bw / 1e9:.0f} GB/s, read {bw_r / 1e9:.0f} GB/s")

    def record(name, t, nnz, bytes_moved):
        roof = bytes_moved / state["bw"]
        paths[name] = {
            "time_s": t,
            "bytes_own": int(bytes_moved),
            "roofline_s": roof,
            "pct_of_own_roofline": 100.0 * roof / t,
            "nnz_per_s": nnz / t,
        }
        log(f"  {name}: {t * 1e6:.1f} us, {100 * roof / t:.1f}% of own "
            f"copy roofline, {nnz / t / 1e9:.2f} Gnnz/s")

    # ---- 2. operator applies, each against ITS OWN traffic --------------
    @section("spmm")
    def _():
        from maxwell_tpu.kernels.spmm import bsr_matmat_triton
        from maxwell_tpu.problems import BrickCavity3D
        from maxwell_tpu.sparse.bsr import BSRMatrix, bsr_matmat_ref
        from maxwell_tpu.sparse.reorder import PermutedProblem

        applies = {"ref": bsr_matmat_ref, "triton": bsr_matmat_triton}
        for g, m in ((24, 8), (48, 1), (48, 24)):
            cav = PermutedProblem(BrickCavity3D(nx=g, ny=g, nz=g))
            K = cav.K.tocsr()
            A = BSRMatrix.from_csr(K, block=4, align_slots=4,
                                   dtype=jnp.float32)
            c = jnp.float32(1.0 / abs(K).sum(axis=1).max())
            X = jax.random.normal(key, (A.n_padded, m), jnp.float32)
            own = (A.blocks.size + A.cols.size + 2 * A.n_padded * m) * 4
            for name, mm in applies.items():
                t = _chain_time(lambda Y, A_: mm(A_, Y) * c, X, args=(A,))
                record(f"spmm_{name}_{g}_m{m}", t, K.nnz * m, own)

    @section("stencil")
    def _():
        from maxwell_tpu.problems.stencil3d import StencilPencil3D

        for g in (24, 64):
            st = StencilPencil3D.build(nx=g, ny=g, nz=g, dtype=jnp.float32)
            X = jax.random.normal(key, (st.n_padded, 8), jnp.float32)
            t = _chain_time(lambda Y, p: p.K_mm(Y) * 1e-3, X, args=(st,))
            # own traffic: fields in + out (coefficients are O(1) taps);
            # ~33 taps per row stand in for the assembled nnz
            record(f"stencil_taps_{g}", t, 33 * st.n * 8,
                   2 * st.n_padded * 8 * 4)

    details["paths"] = paths

    # ---- 3. eigensolves + parity gate ------------------------------------
    @section("lobpcg_12")
    def _():
        from maxwell_tpu.problems import BrickCavity3D
        from maxwell_tpu.solvers import lobpcg
        from maxwell_tpu.solvers.operator import Pencil
        from maxwell_tpu.solvers.precond import shifted_cg_preconditioner

        cav = BrickCavity3D(nx=12, ny=12, nz=12)
        pen = Pencil.from_problem(cav, dtype=jnp.float32)
        pc = shifted_cg_preconditioner(pen, alpha=15.0, iters=16)
        state["pen12"], state["pc12"], state["cav12"] = pen, pc, cav
        Xp = jax.random.normal(key, (pen.n_padded, 8), jnp.float32)
        details["phase_seconds_per_call"] = {
            "KM_mm": _chain_time(
                lambda Z, p: (lambda a, b: a + b)(*p.KM_mm(Z)), Xp,
                args=(pen,)),
            "project": _chain_time(lambda Z, p: p.project(Z), Xp,
                                   args=(pen,)),
            "precond": _chain_time(lambda Z: pc(Z), Xp),
        }
        res, st = _wallstats(lambda: lobpcg(
            pen, nev=5, maxiter=80, tol=2e-6, precond=pc, stall_window=10))
        rel = _analytic_rel(res.eigenvalues, 5)
        details.update(
            lobpcg_3d_n=pen.n, lobpcg_3d_kernel=pen.kernel,
            lobpcg_3d_solve_stats=st, lobpcg_3d_iters=int(res.iterations),
            lobpcg_3d_max_res=float(res.residuals.max()),
            lobpcg_3d_analytic_rel_err=[float(v) for v in rel],
        )
        # parity gate: discretization error at 12^3 is ~0.6%; 2% margin
        if rel.max() > 0.02:
            raise AssertionError(f"12^3 analytic error {rel.max():.2e}")

    @section("lobpcg_64")
    def _():
        from maxwell_tpu.problems.stencil3d import StencilPencil3D
        from maxwell_tpu.solvers import lobpcg
        from maxwell_tpu.solvers.spectral import spectral_preconditioner

        st = StencilPencil3D.build(nx=64, ny=64, nz=64, dtype=jnp.float32)
        pc = spectral_preconditioner(st, alpha=15.0)
        res, s1 = _wallstats(lambda: _ready(lobpcg(
            st, nev=5, maxiter=60, tol=2e-6, precond=pc, stall_window=10,
            return_device=True)))
        build64 = lambda: StencilPencil3D.build(  # noqa: E731
            nx=64, ny=64, nz=64, dtype=jnp.float64)
        ref, s2 = _wallstats(lambda: _polish(build64, res))
        # the claimed residual, recomputed in f64 on the card
        st64 = build64()
        X = jnp.zeros((st64.n_padded, 5), jnp.float64).at[: st64.n].set(
            jnp.asarray(ref.eigenvectors))
        KX, MX = st64.K_mm(X), st64.M_mm(X)
        th = jnp.asarray(ref.eigenvalues, jnp.float64)
        r = np.asarray(jnp.linalg.norm(KX - MX * th, axis=0) / (
            jnp.linalg.norm(KX, axis=0)
            + jnp.abs(th) * jnp.linalg.norm(MX, axis=0)))
        rel = _analytic_rel(ref.eigenvalues, 5)
        details.update(
            lobpcg_64_n=int(st.n), lobpcg_64_solve_stats=s1,
            lobpcg_64_iters=int(res.iterations),
            time_to_1e8_64_s=s1["median_s"] + s2["median_s"],
            time_to_1e8_64_polish_stats=s2,
            time_to_1e8_64_polish_iters=int(ref.iterations),
            time_to_1e8_64_max_res=float(ref.residuals.max()),
            time_to_1e8_64_f64_verified_res=float(r.max()),
            lobpcg_64_analytic_rel_err=[float(v) for v in rel],
        )
        if not (r.max() <= 1e-8 and rel.max() <= 0.005):
            raise AssertionError(f"64^3: res {r.max():.1e} err {rel.max():.1e}")

    @section("lobpcg_48")
    def _():
        """Assembled 48^3 f32 LOBPCG at a fixed 30 iterations with each
        apply, in turns (the keep-or-remove measurement of the kernel)."""
        from maxwell_tpu.kernels.spmm import KERNELS
        from maxwell_tpu.problems import BrickCavity3D
        from maxwell_tpu.solvers import lobpcg
        from maxwell_tpu.solvers.operator import Pencil
        from maxwell_tpu.solvers.precond import shifted_cg_preconditioner

        cav = BrickCavity3D(nx=48, ny=48, nz=48)
        runs = {}
        for k in KERNELS:
            pen = Pencil.from_problem(cav, kernel=k, dtype=jnp.float32)
            pc = shifted_cg_preconditioner(pen, alpha=15.0, iters=16)
            runs[k] = lambda pen=pen, pc=pc: _ready(lobpcg(
                pen, nev=5, maxiter=30, tol=1e-30, precond=pc,
                return_device=True))
        times = {k: [] for k in KERNELS}
        for k in KERNELS:  # cold
            t0 = time.perf_counter()
            r = runs[k]()
            details[f"lobpcg_48_{k}_cold_s"] = time.perf_counter() - t0
            details[f"lobpcg_48_{k}_eigs"] = [float(v) for v in r.eigenvalues]
        for k in list(KERNELS) + list(KERNELS)[::-1] + list(KERNELS):
            t0 = time.perf_counter()
            runs[k]()
            times[k].append(time.perf_counter() - t0)
        for k, v in times.items():
            details[f"lobpcg_48_{k}_30it_s"] = float(np.median(v))
            details[f"lobpcg_48_{k}_30it_runs_s"] = v
        log("  " + json.dumps({k: round(float(np.median(v)), 4)
                               for k, v in times.items()}))

    @section("lobpcg_128")
    def _():
        from maxwell_tpu.problems.stencil3d import StencilPencil3D
        from maxwell_tpu.solvers import lobpcg
        from maxwell_tpu.solvers.spectral import spectral_preconditioner

        st = StencilPencil3D.build(nx=128, ny=128, nz=128,
                                   dtype=jnp.float32)
        pc = spectral_preconditioner(st, alpha=15.0)
        res, s1 = _wallstats(lambda: _ready(lobpcg(
            st, nev=5, maxiter=60, tol=2e-6, precond=pc, stall_window=10,
            return_device=True)), runs=1)
        ref, s2 = _wallstats(lambda: _polish(
            lambda: StencilPencil3D.build(nx=128, ny=128, nz=128,
                                          dtype=jnp.float64), res), runs=1)
        rel = _analytic_rel(ref.eigenvalues, 5)
        details.update(
            lobpcg_128_n=int(st.n), lobpcg_128_solve_stats=s1,
            lobpcg_128_iters=int(res.iterations),
            time_to_1e8_128_s=s1["median_s"] + s2["median_s"],
            time_to_1e8_128_polish_stats=s2,
            time_to_1e8_128_max_res=float(ref.residuals.max()),
            time_to_1e8_128_analytic_rel_err=float(rel.max()),
        )
        if not (ref.converged and rel.max() <= 1e-3):
            raise AssertionError("128^3 did not reach 1e-8 / parity")

    @section("dielectric_32")
    def _():
        from maxwell_tpu.problems.stencil3d import StencilPencil3D
        from maxwell_tpu.solvers import lobpcg
        from maxwell_tpu.solvers.spectral import spectral_preconditioner

        epsr = np.ones((32, 32, 32))
        epsr[:16] = 2.5  # half-filled dielectric
        st = StencilPencil3D.build(nx=32, ny=32, nz=32, dtype=jnp.float32,
                                   eps_r=epsr)
        pc = spectral_preconditioner(st, alpha=12.0)
        res, s1 = _wallstats(lambda: _ready(lobpcg(
            st, nev=4, maxiter=120, tol=2e-6, precond=pc, stall_window=12,
            return_device=True)))
        ref, s2 = _wallstats(lambda: _polish(
            lambda: StencilPencil3D.build(nx=32, ny=32, nz=32,
                                          dtype=jnp.float64, eps_r=epsr),
            res, precond_alpha=12.0))
        details.update(
            dielectric_32_solve_stats=s1,
            dielectric_32_iters=int(res.iterations),
            dielectric_32_polish_stats=s2,
            dielectric_32_refined_res=float(ref.residuals.max()),
            dielectric_32_time_to_1e8_s=s1["median_s"] + s2["median_s"],
        )
        if not ref.converged:
            raise AssertionError("dielectric polish did not converge")

    @section("time_to_1e8_12")
    def _():
        from maxwell_tpu.solvers import lobpcg
        from maxwell_tpu.solvers.refine import refine_f64

        pen, pc, cav = state["pen12"], state["pc12"], state["cav12"]
        t0 = time.perf_counter()
        r32 = lobpcg(pen, nev=5, maxiter=120, tol=1e-5, precond=pc,
                     stall_window=12)
        ref = refine_f64(cav, r32.eigenvectors, theta=r32.eigenvalues,
                         tol=1e-8)
        details.update(
            time_to_1e8_s=time.perf_counter() - t0,
            time_to_1e8_converged=bool(ref.converged),
            time_to_1e8_max_res=float(ref.residuals.max()),
        )
        if not ref.converged:
            raise AssertionError("12^3 host polish did not converge")

    @section("dist_lobpcg_64")
    def _():
        from maxwell_tpu.dist import make_mesh
        from maxwell_tpu.dist.stencil_dist import DistStencilPencil3D
        from maxwell_tpu.solvers.dist_solve import lobpcg_dist

        mesh1 = make_mesh(1)
        dsp = DistStencilPencil3D.build(nx=64, ny=64, nz=64, D=1,
                                        dtype=jnp.float64)
        res, s1 = _wallstats(lambda: _ready(lobpcg_dist(
            dsp, mesh1, nev=5, maxiter=80, tol=1e-8, precond="spectral",
            precond_alpha=15.0, return_device=True)))
        details.update(
            dist_time_to_1e8_64_f64_stats=s1,
            dist_lobpcg_64_f64_iters=int(res.iterations),
            dist_lobpcg_64_f64_res=float(res.residuals.max()),
        )
        if not res.converged:
            raise AssertionError("distributed f64 solve did not converge")

    @section("shift_invert")
    def _():
        from maxwell_tpu.problems import RectCavity2D
        from maxwell_tpu.problems.stencil3d import StencilPencil3D
        from maxwell_tpu.solvers.operator import Pencil
        from maxwell_tpu.solvers.refine import refine_f64
        from maxwell_tpu.solvers.shift_invert import (
            build_shift_invert_op,
            shift_invert_lanczos,
        )

        cav = RectCavity2D(nx=128, ny=128)
        pen = Pencil.from_problem(cav, dtype=jnp.float32)
        t0 = time.perf_counter()
        si = build_shift_invert_op(pen, 45.0, backend="ldlt",
                                   KM=(cav.K, cav.M))
        details["si_ldlt_factor_2d128_s"] = time.perf_counter() - t0
        x = jax.random.normal(key, (pen.n_padded, 1), jnp.float32)
        details["si_apply_2d128_tri_solve_s"] = _chain_time(
            lambda z: si(z), x, iters=4)
        r2, s2 = _wallstats(lambda: shift_invert_lanczos(
            pen, sigma=45.0, nev=4, maxiter=40, tol=1e-6, backend="ldlt",
            KM=(cav.K, cav.M)), runs=1)
        pol = refine_f64(cav, r2.eigenvectors, tol=1e-8)
        details.update(
            si_solve_2d128_stats=s2,
            si_solve_2d128_res=float(r2.residuals.max()),
            si_2d128_polished_res=float(pol.residuals.max()),
        )
        st = StencilPencil3D.build(nx=64, ny=64, nz=64, dtype=jnp.float32)
        rs, ss = _wallstats(lambda: shift_invert_lanczos(
            st, sigma=60.0, nev=3, maxiter=30, tol=1e-5,
            backend="iterative"), runs=1)
        ref, sr = _wallstats(lambda: _polish(
            lambda: StencilPencil3D.build(nx=64, ny=64, nz=64,
                                          dtype=jnp.float64), rs), runs=1)
        details.update(
            si_solve_64_stencil_stats=ss,
            si_solve_64_res=float(rs.residuals.max()),
            si_64_polish_stats=sr,
            si_64_polished_res=float(ref.residuals.max()),
        )
        if not (pol.converged and ref.converged):
            raise AssertionError("shift-invert polish did not converge")

    @section("staged_locking")
    def _():
        from maxwell_tpu.dist import make_mesh
        from maxwell_tpu.dist.stencil_dist import DistStencilPencil3D
        from maxwell_tpu.solvers.dist_solve import lobpcg_dist

        mesh1 = make_mesh(1)
        d = DistStencilPencil3D.build(nx=32, ny=32, nz=32, D=1,
                                      dtype=jnp.float32)
        kw = dict(maxiter=10, tol=1e-30, precond="spectral",
                  precond_alpha=15.0)
        rf, sf = _wallstats(lambda: lobpcg_dist(d, mesh1, nev=20, **kw),
                            runs=2)
        rq = lobpcg_dist(d, mesh1, nev=10, maxiter=60, tol=1e-5,
                         precond="spectral", precond_alpha=15.0,
                         stall_window=10)
        rs, ss = _wallstats(lambda: lobpcg_dist(
            d, mesh1, nev=10, deflate_Q=rq.eigenvectors, **kw), runs=2)
        full = sf["median_s"] / max(rf.iterations, 1)
        s2 = ss["median_s"] / max(rs.iterations, 1)
        details.update(
            staged_ms_per_iter_full_m30=full * 1e3,
            staged_ms_per_iter_stage2_m15=s2 * 1e3,
            staged_iter_cost_drop_pct=100.0 * (1.0 - s2 / full),
        )

    errors = sorted(k for k in details if k.endswith("_error"))
    details["errors"] = errors
    with open("bench_details.json", "w") as f:
        json.dump(details, f, indent=2)

    head = "spmm_triton_24_m8"
    line = {"metric": "spmv_nnz_per_s_per_chip", "unit": "nnz/s",
            "platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}
    if head in paths:
        line.update(value=paths[head]["nnz_per_s"],
                    vs_baseline=paths[head]["pct_of_own_roofline"] / 100.0)
    if errors:
        log(f"FAILED sections: {errors}")
        line.update(metric="bench_failed", errors=errors)
        print(json.dumps(line))
        sys.exit(1)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
