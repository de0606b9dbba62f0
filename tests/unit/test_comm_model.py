"""Sanity of the analytic weak-scaling model (bench/comm_model.py):
monotonicities and limiting behavior. Link rates are inputs; the values
below are placeholders for the structure, not measurements."""

from maxwell_tpu.bench.comm_model import CommModel


def _model(**kw):
    base = dict(
        ny=64, nz=64, cells=8, m=8, t_compute_iter_s=5e-3,
        bw_link=4e10, bw_host=2e10,
    )
    base.update(kw)
    return CommModel(**base)


def test_single_shard_is_pure_compute():
    m = _model()
    t = m.t_iter(1)
    assert t["halo"] == 0.0 and t["allreduce"] == 0.0
    assert m.weak_efficiency(1) == 1.0


def test_efficiency_decreases_with_devices_and_dcn():
    m = _model()
    effs = [m.weak_efficiency(D, hosts=1) for D in (2, 4, 8)]
    assert all(0.0 < e <= 1.0 for e in effs)
    assert effs[0] >= effs[1] >= effs[2]
    # crossing hosts (the slower link) can only hurt
    assert m.weak_efficiency(8, hosts=2) <= m.weak_efficiency(8, hosts=1)


def test_bandwidth_monotone():
    lo = _model(bw_link=1e10)
    hi = _model(bw_link=9e10)
    assert hi.weak_efficiency(8) > lo.weak_efficiency(8)


def test_dominant_term_is_spectral_allreduce():
    """At 64^2 cross-sections the mode-volume psum dwarfs the halo —
    the model must point a multi-device tuning effort at the right term."""
    m = _model()
    rows = m.report(sizes=(2, 8))
    assert all(r["dominant_comm"] == "allreduce" for r in rows)
    # and the halo volume is orders of magnitude smaller
    assert m.halo_bytes() * 20 < m.spectral_psum_bytes(8)


def test_gate_prediction_fields():
    rows = _model().report(sizes=(1, 2, 4, 8))
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    for r in rows:
        assert 0.0 < r["predicted_efficiency"] <= 1.0
        assert 0.0 <= r["comm_fraction"] < 1.0
