"""ppermute halo exchange vs the all_gather window oracle (SURVEY.md §5.2
checksum mode; §2 C8 halo transport) on the simulated mesh: the halo
checksum is exactly 0, and the sharded apply over the exchanged halo
matches the single-device apply."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from maxwell_tpu.dist import make_mesh, partition_problem
from maxwell_tpu.problems import RectCavity2D
from maxwell_tpu.solvers.dist_solve import spmm_dist

D = 8


def test_rdma_halo_spmm_parity():
    cav = RectCavity2D(nx=16, ny=16)
    dp = partition_problem(cav, D, block=8, dtype=jnp.float64)
    assert dp.H <= dp.L, "ppermute fast path needs the shallow-halo regime"
    mesh = make_mesh(D)
    key = jax.random.PRNGKey(0)
    n_pad_g = dp.D * dp.L * dp.b
    X = jax.random.normal(key, (n_pad_g, 3), jnp.float64).at[dp.n :].set(0)
    mapped = jax.shard_map(
        lambda p, Xl: p.halo_checksum(Xl),
        mesh=mesh,
        in_specs=(dp.partition_specs(), P(dp.axis, None)),
        out_specs=P(),
        check_vma=False,
    )
    assert float(jax.jit(mapped)(dp, X)) == 0.0
    Y = np.asarray(spmm_dist(dp, mesh, X, which="K"))[: dp.n]
    Xo = np.asarray(X)[: dp.n][np.argsort(dp.perm)]
    ref = (cav.K @ Xo)[dp.perm]
    np.testing.assert_allclose(Y, ref, rtol=1e-12, atol=1e-12)
