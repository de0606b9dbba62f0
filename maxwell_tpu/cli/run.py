"""CLI driver: `python -m maxwell_tpu.cli.run configs/config2.json [overrides]`.

Config schema (JSON):
{
  "problem": {"kind": "rect2d"|"brick3d", "a":1, "b":1, ["c":1],
               "nx":16, "ny":16, ["nz":16]},
  "solver":  {"kind": "lanczos"|"tr_lanczos"|"lobpcg"|"shift_invert"|"lobpcg_dist",
               "nev":5, "tol":1e-8, "maxiter":200, ...},
  "storage": {"block": 4, "dtype": "f32"|"f64",
               "kernel": "auto"|"ref"|"triton"},
  "dist":    {"n_shards": 8}            # lobpcg_dist only
}

Emits per-iteration JSON lines (residual history) and a final report with
eigenvalues, residuals, timing, and analytic parity when available
(SURVEY.md §5.5/§5.6).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time


def material_grids(cfg):
    """Per-cell eps_r/mu_r from the JSON "materials" block (round 4):

      "materials": {"eps_fill": {"value": 2.5,
                                 "box": [x0, x1, y0, y1, z0, z1]},
                    "mu_fill":  {...}}

    box is in FRACTIONAL cell coordinates (0..1 per axis; default fills
    the whole cavity). Returns (eps_r, mu_r) numpy grids or (None, None).
    """
    import numpy as np

    mcfg = cfg.get("materials")
    if not mcfg:
        return None, None
    nx, ny, nz = cfg.get("nx", 8), cfg.get("ny", 8), cfg.get("nz", 8)

    def grid(spec):
        if spec is None:
            return None
        g = np.ones((nx, ny, nz))
        box = spec.get("box", [0, 1, 0, 1, 0, 1])
        i0, i1 = int(box[0] * nx), max(int(box[1] * nx), int(box[0] * nx) + 1)
        j0, j1 = int(box[2] * ny), max(int(box[3] * ny), int(box[2] * ny) + 1)
        k0, k1 = int(box[4] * nz), max(int(box[5] * nz), int(box[4] * nz) + 1)
        g[i0:i1, j0:j1, k0:k1] = spec.get("value", 1.0)
        return g

    return grid(mcfg.get("eps_fill")), grid(mcfg.get("mu_fill"))


def build_problem(cfg):
    kind = cfg.get("kind", "rect2d")
    if kind == "rect2d":
        from maxwell_tpu.problems import RectCavity2D

        return RectCavity2D(
            a=cfg.get("a", 1.0),
            b=cfg.get("b", 1.0),
            nx=cfg.get("nx", 16),
            ny=cfg.get("ny", 16),
            bc=cfg.get("bc", "pec"),
        )
    if kind == "brick3d":
        from maxwell_tpu.problems import BrickCavity3D

        eps_r, mu_r = material_grids(cfg)
        return BrickCavity3D(
            a=cfg.get("a", 1.0),
            b=cfg.get("b", 1.0),
            c=cfg.get("c", 1.0),
            nx=cfg.get("nx", 8),
            ny=cfg.get("ny", 8),
            nz=cfg.get("nz", 8),
            bc=cfg.get("bc", "pec"),
            eps_r=eps_r,
            mu_r=mu_r,
        )
    if kind == "tet3d":
        # unstructured tetrahedral Nedelec on a Kuhn-triangulated brick
        # (problems/tetmesh.py); "jiggle" perturbs interior vertices so the
        # mesh is genuinely non-tensor-product
        import numpy as np

        from maxwell_tpu.problems.tetmesh import TetCavity, brick_tet_mesh

        a, b, c = cfg.get("a", 1.0), cfg.get("b", 1.0), cfg.get("c", 1.0)
        n = cfg.get("n", cfg.get("nx", 6))
        jig = cfg.get("jiggle", 0.0)
        if jig:
            verts, tets = brick_tet_mesh(a, b, c, n, n, n)
            rng = np.random.default_rng(cfg.get("seed", 0))
            eps = 1e-9
            interior = np.all(
                (verts > eps) & (verts < np.array([a, b, c]) - eps), axis=1
            )
            verts = verts.copy()
            verts[interior] += (
                jig * (a / n) * rng.standard_normal((int(interior.sum()), 3))
            )
            return TetCavity(a=a, b=b, c=c, verts=verts, tets=tets)
        return TetCavity(a=a, b=b, c=c, n=n)
    raise ValueError(f"unknown problem kind {kind!r}")


def _parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="path to JSON config")
    ap.add_argument("--nev", type=int, default=None)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--checkpoint", default=None, help="state file for save/resume")
    ap.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="also save the Ritz block every K iterations from inside the "
        "compiled loop (kill-mid-solve recovery; SURVEY.md §5.4)",
    )
    ap.add_argument(
        "--save-eigenvectors", default=None,
        help="write eigenpairs (values + vectors) to this .npz",
    )
    ap.add_argument(
        "--platform", default=None, choices=("cpu", "gpu"),
        help="force the JAX backend (default: JAX's own choice)",
    )
    ap.add_argument(
        "--refine", action="store_true",
        help="mixed-precision polish to tol after an f32 device solve: "
        "f64 host RQI sweeps for assembled operators, warm-started native-"
        "f64 LOBPCG on the device for matrix-free (stencil) pencils, "
        "sharded or not (solvers/refine.py); f64 solves need no polish",
    )
    return ap


def main(argv=None):
    import jax
    import jax.numpy as jnp

    args = _parser().parse_args(argv)
    if args.platform:
        jax.config.update(
            "jax_platforms", {"cpu": "cpu", "gpu": "cuda"}[args.platform]
        )

    with open(args.config) as f:
        cfg = json.load(f)
    scfg = cfg.get("solver", {})
    if args.nev is not None:
        scfg["nev"] = args.nev
    if args.tol is not None:
        scfg["tol"] = args.tol
    if args.maxiter is not None:
        scfg["maxiter"] = args.maxiter

    stg = cfg.get("storage", {})
    dtype = {"f32": jnp.float32, "f64": jnp.float64}[stg.get("dtype", "f64")]
    use_stencil = stg.get("operator") == "stencil"
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    block = stg.get("block")  # None -> default layout
    kernel = stg.get("kernel", "auto")  # kernels.spmm.resolve_kernel
    t0 = time.perf_counter()
    # the assembly-free (stencil) path must not pay host CSR assembly —
    # build the assembled problem lazily only where matrices are consumed
    problem = None if use_stencil else build_problem(cfg.get("problem", {}))
    t_setup = time.perf_counter() - t0

    kind = scfg.get("kind", "lobpcg")
    nev = scfg.get("nev", 5)
    tol = scfg.get("tol", 1e-8)
    maxiter = scfg.get("maxiter", 200)
    # refinement polishes an f32 solve; an f64 solve reaches tol itself
    # (staged f64 runs keep the full tolerance in every stage: deflation
    # quality equals the basis block's residual — round 5)
    want_refine = bool(args.refine or scfg.get("refine", False)) and (
        dtype == jnp.float32
    )
    # with refinement the device solve only needs the fp32-comfortable part
    full_tol = tol
    if want_refine:
        tol = max(tol, 1e-5)

    t0 = time.perf_counter()
    if kind == "lobpcg_dist":
        from maxwell_tpu.dist import make_mesh, partition_problem
        from maxwell_tpu.solvers.dist_solve import lobpcg_dist

        D = cfg.get("dist", {}).get("n_shards", len(jax.devices()))
        if D > len(jax.devices()):
            # degenerate-mesh rule (SURVEY.md §4): the same SPMD program
            # runs at any device count — clamp so configs written for the
            # simulated 8-device mesh run on fewer real devices
            print(
                f"dist.n_shards={D} > {len(jax.devices())} visible "
                f"device(s): clamping (mesh-of-{len(jax.devices())})",
                file=sys.stderr, flush=True,
            )
            D = len(jax.devices())
        pcfg = cfg.get("problem", {})
        if stg.get("operator") == "stencil":
            if pcfg.get("kind") != "brick3d":
                raise ValueError("distributed stencil operator is 3D-only")
            from maxwell_tpu.dist.stencil_dist import DistStencilPencil3D

            def build_dist(dt):
                return DistStencilPencil3D.build(
                    a=pcfg.get("a", 1.0), b=pcfg.get("b", 1.0),
                    c_len=pcfg.get("c", 1.0), nx=pcfg.get("nx", 8),
                    ny=pcfg.get("ny", 8), nz=pcfg.get("nz", 8),
                    D=D, dtype=dt, block=block or 8,
                )

            dp = build_dist(dtype)
            # the f64 twin for the polish, built once on first use
            build_dist64 = functools.cache(
                functools.partial(build_dist, jnp.float64)
            )
        else:
            dp = partition_problem(
                problem, D, block=block, kernel=kernel, dtype=dtype
            )
        mesh = make_mesh(D)
        # staged stencil runs with refinement: polish EACH stage's block
        # in native f64 on the mesh before it joins the deflation basis —
        # an f32-floor stage (~1e-5) would otherwise seed duplicate
        # eigenpairs in the next stage (deflation quality equals the
        # basis residual)
        stage_polish = None
        polished = []  # lobpcg_dist runs the hook only when batch < nev
        if want_refine and use_stencil and scfg.get("batch"):
            from maxwell_tpu.solvers.refine import refine_f64_dist

            def stage_polish(r, Q):
                polished.append(True)
                return refine_f64_dist(
                    build_dist64, mesh, r.eigenvectors, tol=full_tol,
                    precond_alpha=scfg.get("precond_alpha", 15.0),
                    deflate_Q=Q,
                )

        res = lobpcg_dist(
            dp,
            mesh,
            nev=nev,
            m=scfg.get("block_size"),
            maxiter=maxiter,
            tol=tol,
            precond_alpha=scfg.get("precond_alpha"),
            precond_iters=scfg.get("precond_iters", 20),
            checkpoint=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            batch=scfg.get("batch"),
            # when a refinement pass follows ON AN F32 DEVICE, cut at the
            # f32 floor and return the best iterate instead of bouncing
            # to maxiter (round 4: an unstalled f32 dist solve at tol
            # below its floor returned a degraded final block). f64 runs
            # have no such floor — a stall cut there fires MID-convergence
            # on slowly-separating degenerate clusters and hands the
            # refine a half-converged block (round 5: config5's 8pi^2
            # triple collapsed in the RR for exactly this reason).
            stall_window=scfg.get(
                "stall_window",
                15 if (want_refine and dtype == jnp.float32) else 0,
            ),
            stage_polish=stage_polish,
        )
        if polished:
            # stages are already refined to full_tol — the generic
            # refine pass below would be redundant work
            want_refine = False
    else:
        pcfg = cfg.get("problem", {})
        if stg.get("operator") == "stencil":
            # assembly-free matrix-free operator (tensor grids only);
            # block only sets padding granularity here
            if pcfg.get("kind", "rect2d") == "rect2d":
                from maxwell_tpu.problems.stencil2d import StencilPencil2D

                pencil = StencilPencil2D.build(
                    a=pcfg.get("a", 1.0), b=pcfg.get("b", 1.0),
                    nx=pcfg.get("nx", 16), ny=pcfg.get("ny", 16),
                    dtype=dtype, block=block or 8,
                    bc=pcfg.get("bc", "pec"),
                )
            else:
                from maxwell_tpu.problems.stencil3d import StencilPencil3D

                eps_r3, mu_r3 = material_grids(pcfg)
                pencil = StencilPencil3D.build(
                    a=pcfg.get("a", 1.0), b=pcfg.get("b", 1.0),
                    c=pcfg.get("c", 1.0), nx=pcfg.get("nx", 8),
                    ny=pcfg.get("ny", 8), nz=pcfg.get("nz", 8),
                    dtype=dtype, block=block or 8,
                    bc=pcfg.get("bc", "pec"),
                    eps_r=eps_r3, mu_r=mu_r3,
                )
        else:
            from maxwell_tpu.solvers.operator import Pencil

            pencil = Pencil.from_problem(
                problem, block=block, kernel=kernel, dtype=dtype
            )
        if kind == "lanczos":
            from maxwell_tpu.solvers import lanczos

            res = lanczos(pencil, nev=nev, maxiter=maxiter, tol=tol)
        elif kind == "tr_lanczos":
            from maxwell_tpu.solvers.trlanczos import thick_restart_lanczos

            res = thick_restart_lanczos(
                pencil, nev=nev, ncv=scfg.get("ncv"),
                max_restarts=scfg.get("max_restarts", 40), tol=tol,
            )
        elif kind == "shift_invert" and stg.get("operator") == "stencil":
            raise ValueError(
                "shift_invert needs assembled matrices (factorization); "
                "drop storage.operator=stencil"
            )
        elif kind == "shift_invert":
            from maxwell_tpu.solvers.shift_invert import shift_invert_lanczos

            res = shift_invert_lanczos(
                pencil,
                sigma=scfg.get("sigma", 1.0),
                nev=nev,
                maxiter=maxiter,
                tol=tol,
                KM=(problem.K, problem.M),  # factor the assembled matrices
            )
        elif kind == "lobpcg":
            from maxwell_tpu.solvers import lobpcg
            from maxwell_tpu.solvers.precond import shifted_cg_preconditioner

            pc = None
            if scfg.get("precond_alpha") is not None:
                kind = scfg.get("precond", "auto")
                if kind in ("auto", "spectral"):
                    # exact spectral (K + alpha M)^-1 for vacuum-PEC
                    # stencil pencils: grid-independent iteration count
                    # (solvers/spectral.py)
                    try:
                        from maxwell_tpu.solvers.spectral import (
                            spectral_preconditioner,
                        )

                        pc = spectral_preconditioner(
                            pencil, alpha=scfg["precond_alpha"]
                        )
                    except (ValueError, AttributeError):
                        if kind == "spectral":
                            raise
                if pc is None:
                    pc = shifted_cg_preconditioner(
                        pencil,
                        alpha=scfg["precond_alpha"],
                        iters=scfg.get("precond_iters", 20),
                    )
            res = lobpcg(
                pencil,
                nev=nev,
                m=scfg.get("block_size"),
                maxiter=maxiter,
                tol=tol,
                precond=pc,
                checkpoint=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                log_every=scfg.get("log_every", 0),
            )
        else:
            raise ValueError(f"unknown solver {kind!r}")
    t_solve = time.perf_counter() - t0

    t_refine = None
    if want_refine and res.eigenvectors is not None:
        t0 = time.perf_counter()
        if kind == "lobpcg_dist" and use_stencil:
            # the sharded twin of the matrix-free polish below, under the
            # run's own mesh
            from maxwell_tpu.solvers.refine import refine_f64_dist

            ref = refine_f64_dist(
                build_dist64, mesh, res.eigenvectors, tol=full_tol,
                precond_alpha=scfg.get("precond_alpha", 15.0),
            )
        elif use_stencil:
            # matrix-free polish: rebuild the SAME stencil pencil in native
            # f64 on the device and continue LOBPCG from the f32 block —
            # never assembles K (VERDICT.md round-1 item 3)
            from maxwell_tpu.solvers.refine import refine_f64_pencil

            pcfg = cfg.get("problem", {})
            if pcfg.get("kind", "rect2d") == "rect2d":
                from maxwell_tpu.problems.stencil2d import StencilPencil2D

                def build_f64():
                    return StencilPencil2D.build(
                        a=pcfg.get("a", 1.0), b=pcfg.get("b", 1.0),
                        nx=pcfg.get("nx", 16), ny=pcfg.get("ny", 16),
                        dtype=jnp.float64, block=block or 8,
                        bc=pcfg.get("bc", "pec"),
                    )
            else:
                from maxwell_tpu.problems.stencil3d import StencilPencil3D

                def build_f64():
                    return StencilPencil3D.build(
                        a=pcfg.get("a", 1.0), b=pcfg.get("b", 1.0),
                        c=pcfg.get("c", 1.0), nx=pcfg.get("nx", 8),
                        ny=pcfg.get("ny", 8), nz=pcfg.get("nz", 8),
                        dtype=jnp.float64, block=block or 8,
                        bc=pcfg.get("bc", "pec"),
                        eps_r=eps_r3, mu_r=mu_r3,
                    )

            ref = refine_f64_pencil(
                build_f64, res.eigenvectors, tol=full_tol,
                precond_alpha=scfg.get("precond_alpha", 15.0),
                precond_iters=scfg.get("precond_iters", 16),
            )
        else:
            from maxwell_tpu.solvers.refine import refine_f64

            ref = refine_f64(
                problem, res.eigenvectors, theta=res.eigenvalues,
                tol=full_tol,
            )
        t_refine = time.perf_counter() - t0
        ref.history = list(res.history) + [
            dict(h, phase="refine") for h in ref.history
        ]
        ref.iterations += res.iterations
        res = ref

    for h in res.history:
        print(json.dumps(h))

    if use_stencil:
        if kind == "lobpcg_dist":
            # GLOBAL problem size (dp.n is the per-shard local size)
            n_report = getattr(dp, "n_full", None) or dp.n
        else:
            n_report = pencil.n
    else:
        n_report = problem.n_edges
    report = {
        "eigenvalues": [float(v) for v in res.eigenvalues],
        "residuals": [float(r) for r in res.residuals],
        "iterations": res.iterations,
        "converged": res.converged,
        "t_setup_s": t_setup,
        "t_solve_s": t_solve,
        "n": int(n_report),
    }
    if t_refine is not None:
        report["t_refine_s"] = t_refine
    if (
        kind != "shift_invert"
        and cfg.get("problem", {}).get("bc", "pec") == "pec"
        and not cfg.get("problem", {}).get("materials")
    ):
        # (loaded cavities have no closed-form modes — no analytic row)
        # analytic oracle lists the SMALLEST PEC modes
        try:
            pcfg = cfg.get("problem", {})
            if pcfg.get("kind", "rect2d") == "rect2d":
                from maxwell_tpu.problems.analytic import te_eigenvalues_2d

                exact = te_eigenvalues_2d(
                    pcfg.get("a", 1.0), pcfg.get("b", 1.0), nev
                )
            else:
                from maxwell_tpu.problems.analytic import (
                    cavity_eigenvalues_3d,
                )

                exact = cavity_eigenvalues_3d(
                    pcfg.get("a", 1.0), pcfg.get("b", 1.0),
                    pcfg.get("c", 1.0), nev,
                )
            report["analytic"] = [float(v) for v in exact]
            report["analytic_rel_err"] = [
                float(abs(v - e) / e)
                for v, e in zip(res.eigenvalues, exact)
            ]
        except Exception:
            pass
    if args.save_eigenvectors:
        import numpy as np

        np.savez(
            args.save_eigenvectors,
            eigenvalues=res.eigenvalues,
            eigenvectors=res.eigenvectors,
            residuals=res.residuals,
        )
        report["eigenvectors_file"] = args.save_eigenvectors
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
