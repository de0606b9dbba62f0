"""Pin the analytic comm model's volumes to what the COMPILED PROGRAM
actually moves (round-4 VERDICT item 6: the model was an untested
formula). Each CommModel volume method must reproduce the per-collective
result bytes extracted from the compiled shard_map HLO of the
corresponding piece of one distributed LOBPCG iteration, within 10%."""

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from maxwell_tpu.bench.comm_model import (
    CommModel,
    collective_bytes_from_hlo,
)
from maxwell_tpu.dist import make_mesh
from maxwell_tpu.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu.solvers.spectral import DistSpectralShift

D = 8
N = 32
M = 9


@pytest.fixture(scope="module")
def pieces():
    assert jax.device_count() >= D
    mesh = make_mesh(D)
    dsp = DistStencilPencil3D.build(nx=N, ny=N, nz=N, D=D,
                                    dtype=jnp.float32)
    sol = DistSpectralShift.build(dsp, 15.0)
    row = P(dsp.axis, None)
    X = jnp.zeros((dsp.global_rows, M), jnp.float32)

    def vols(fn, in_specs, out_specs, *args):
        f = jax.jit(
            jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)
        )
        return collective_bytes_from_hlo(
            f.lower(*args).compile().as_text()
        )

    km = vols(lambda p, Y: p.KM_mm(Y),
              (dsp.partition_specs(), row), (row, row), dsp, X)
    sp = vols(lambda p, s, Y: s.solve(p, Y),
              (dsp.partition_specs(), sol.partition_specs(), row), row,
              dsp, sol, X)
    pj = vols(lambda p, Y: p.project(Y),
              (dsp.partition_specs(), row), row, dsp, X)
    model = CommModel(ny=N, nz=N, cells=N // D, m=M,
                      t_compute_iter_s=1.0, bw_link=1.0, bw_host=1.0)
    return km, sp, pj, model


def _within(got, want, tol=0.10):
    assert want > 0 and abs(got - want) / want <= tol, (
        f"model {want} vs HLO {got} ({abs(got - want) / want:.1%} off)"
    )


def test_halo_volume_matches_hlo(pieces):
    km, _, _, model = pieces
    # the KM apply's only collective is the packed ghost-plane ppermute
    assert set(km) == {"collective-permute"}
    _within(km["collective-permute"], model.halo_bytes(), tol=0.01)


def test_spectral_allreduce_matches_hlo(pieces):
    _, sp, _, model = pieces
    assert set(sp) == {"all-reduce"}
    _within(sp["all-reduce"], model.spectral_psum_bytes(D), tol=0.01)


def test_projector_volumes_match_hlo(pieces):
    _, _, pj, model = pieces
    _within(pj["all-reduce"], model.projector_psum_bytes(D), tol=0.01)
    _within(pj["collective-permute"], model.projector_permute_bytes(),
            tol=0.10)


def test_iteration_volume_totals(pieces):
    """One LOBPCG iteration = KM(W) + precond(R) + project(W): the
    model's t_iter decomposition must account for >= 95% of the summed
    HLO collective bytes of those pieces (Gram/RR psums are the
    excluded remainder — latency-bound small ops)."""
    km, sp, pj, model = pieces
    hlo_permute = km.get("collective-permute", 0) + pj.get(
        "collective-permute", 0
    )
    hlo_ar = sp.get("all-reduce", 0) + pj.get("all-reduce", 0)
    _within(hlo_permute,
            model.halo_bytes() + model.projector_permute_bytes(),
            tol=0.05)
    _within(hlo_ar,
            model.spectral_psum_bytes(D) + model.projector_psum_bytes(D),
            tol=0.01)
