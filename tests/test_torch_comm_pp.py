"""The port's FedNL-PP star against repro.comm.star_pp and the port's local
backend, on the CPU: fault-free runs, dropouts under both on_dropout
policies (the participants and the drops exact every round), stragglers,
sessions restored by replay, and (net marked) a PP run over TCP.

Tolerances: participants, drops, bits and frame sizes are exact; each
round's model agrees norm-wise to rtol 1e-8 (the two sides add FP64 sums in
other orders: a one-client batch against the tau-client batch, or the other
package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

jax.config.update("jax_enable_x64", True)

from repro.comm import star_pp as jstar_pp
from repro.comm.transport import FaultSpec as JFaultSpec
from repro.core.fednl import FedNLConfig as JConfig
from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, FaultSpec, open_session, solve
from repro_torch.comm import star_pp
from repro_torch.comm.transport import FaultInjector, loopback_pair
from repro_torch.core.fednl import FedNLConfig

CPU = "cpu"
X_RTOL = 1e-8
TAU, ROUNDS = 4, 8


def _close_models(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert float(rel.max()) <= X_RTOL, rel


@pytest.fixture(scope="module")
def tiny_z():
    return DataSpec(dataset="tiny").build()


def _spec(compressor="topk", **kw):
    kw.setdefault("rounds", ROUNDS)
    return ExperimentSpec(data=DataSpec(dataset="tiny"), algorithm="fednl-pp", tau=TAU,
                          compressor=CompressorSpec(compressor), **kw)


@pytest.mark.parametrize("compressor", ["topk", "randk", "toplek", "natural"])
def test_pp_loopback_matches_local(compressor):
    spec = _spec(compressor)
    got = solve(spec.replace(backend="star-loopback"), device=CPU)
    want = solve(spec, device=CPU)
    assert got.participants == want.participants
    assert all(len(d) == 0 for d in got.dropped)
    _close_models(got.x_hist, want.x_hist)
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)
    np.testing.assert_array_equal(got.extras["measured_payload_bits"], got.sent_bits_payload)
    assert got.extras["tau"] == TAU


def test_pp_wire_accounting_is_the_measured_frames():
    spec = _spec("randseqk", accounting="wire")
    got = solve(spec.replace(backend="star-loopback"), device=CPU)
    np.testing.assert_array_equal(got.sent_bits, 8 * got.extras["measured_frame_bytes"])
    np.testing.assert_array_equal(got.sent_bits, solve(spec, device=CPU).sent_bits)


@pytest.mark.parametrize("on_dropout", ["partial", "resample"])
@pytest.mark.parametrize("compressor", ["topk", "randk"])
def test_pp_dropout_matches_the_reference(tiny_z, on_dropout, compressor):
    """drop_prob 0.25: the port's and the reference's runs drop the same
    clients, sample the same replacements and produce the same models."""
    got = star_pp.run_pp_loopback(tiny_z, FedNLConfig(compressor=compressor), TAU,
                                  rounds=ROUNDS, seed=0, on_dropout=on_dropout,
                                  fault=FaultSpec(drop_prob=0.25), device=CPU)
    want = jstar_pp.run_pp_loopback(jnp.asarray(tiny_z), JConfig(compressor=compressor), TAU,
                                    rounds=ROUNDS, seed=0, on_dropout=on_dropout,
                                    fault=JFaultSpec(drop_prob=0.25))
    assert got.participants == want.participants
    assert got.dropped == want.dropped
    assert sum(map(len, got.dropped)) > 0
    if on_dropout == "resample":
        assert any(len(p) == TAU and d for p, d in zip(got.participants, got.dropped))
    else:
        assert all(len(p) + len(d) == TAU for p, d in zip(got.participants, got.dropped))
    _close_models(got.x_hist, want.x_hist)
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)
    np.testing.assert_array_equal(got.measured_payload_bits, want.measured_payload_bits)
    np.testing.assert_array_equal(got.measured_frame_bytes, want.measured_frame_bytes)


def test_fault_draws_are_the_reference():
    from repro.comm.transport import FaultInjector as JInjector

    spec = FaultSpec(drop_prob=0.3, straggler_prob=0.4, seed=5)
    jspec = JFaultSpec(drop_prob=0.3, straggler_prob=0.4, seed=5)
    for cid in range(3):
        got, want = FaultInjector(spec, cid), JInjector(jspec, cid)
        assert [got.should_drop() for _ in range(20)] == [want.should_drop() for _ in range(20)]
        assert [got.maybe_stall() for _ in range(5)] == [want.maybe_stall() for _ in range(5)]


def test_pp_stragglers_only_delay(tiny_z):
    cfg = FedNLConfig()
    fast = star_pp.run_pp_loopback(tiny_z, cfg, TAU, rounds=3, seed=0, device=CPU)
    slow = star_pp.run_pp_loopback(
        tiny_z, cfg, TAU, rounds=3, seed=0, device=CPU,
        fault=FaultSpec(straggler_prob=0.5, straggler_delay_s=0.002))
    assert slow.participants == fast.participants
    np.testing.assert_array_equal(slow.x_hist, fast.x_hist)


def test_pp_master_rejects_bad_arguments(tiny_z):
    conns = {i: loopback_pair()[0] for i in range(3)}
    with pytest.raises(ValueError, match="on_dropout"):
        star_pp.StarPPMaster(conns, 24, FedNLConfig(), 2, on_dropout="retry", device=CPU)
    with pytest.raises(ValueError, match="tau"):
        star_pp.StarPPMaster(conns, 24, FedNLConfig(), 4, device=CPU)


@pytest.mark.parametrize("on_dropout", ["partial", "resample"])
def test_pp_session_restored_by_replay_is_bit_identical(tmp_path, on_dropout):
    spec = _spec("randk", backend="star-loopback", rounds=6,
                 fault=FaultSpec(drop_prob=0.25), on_dropout=on_dropout)
    want = solve(spec, device=CPU)
    with open_session(spec, device=CPU) as s:
        s.step(3)
        path = s.save(tmp_path / "pp.fnlsess")
    with open_session(spec, restore=path, device=CPU) as s2:
        got = s2.run()
    assert got.participants == want.participants and got.dropped == want.dropped
    np.testing.assert_array_equal(np.asarray(got.x_hist).view(np.int64),
                                  np.asarray(want.x_hist).view(np.int64))
    np.testing.assert_array_equal(got.x.view(np.int64), want.x.view(np.int64))
    np.testing.assert_array_equal(got.sent_bits, want.sent_bits)
    assert got.final_grad_norm == want.final_grad_norm


@pytest.mark.net
def test_pp_tcp_with_dropout_matches_loopback():
    """Three client processes, five rounds, drop_prob 0.25 resampled: the
    participants and drops of the loopback run, and every child exits within
    the test's own deadline."""
    from repro_torch.comm.star_pp import StarPPMaster
    from repro_torch.launch.multiproc import ClientCluster

    fault = FaultSpec(drop_prob=0.25)
    spec = ExperimentSpec(data=DataSpec(shape=(24, 3, 40)), algorithm="fednl-pp", tau=2,
                          fault=fault, on_dropout="resample", rounds=5)
    cfg = spec.fednl_config()
    cluster = ClientCluster(None, spec.data.shape, spec.seed, pp=True,
                            fault_dict=dict(drop_prob=0.25, straggler_prob=0.0,
                                            straggler_delay_s=0.0, seed=0),
                            cfg=cfg, device=CPU, accept_timeout=60.0)
    try:
        got = StarPPMaster(cluster.conns, cluster.d, cfg, 2, seed=0, on_dropout="resample",
                           device=CPU).run(5)
    finally:
        cluster.close(join_timeout=30.0)
    assert cluster.exit_codes() == [0, 0, 0]
    want = solve(spec.replace(backend="star-loopback"), device=CPU)
    assert got.participants == [list(p) for p in want.participants]
    assert got.dropped == [list(d) for d in want.dropped]
    _close_models(got.x_hist, want.x_hist)
    np.testing.assert_array_equal(got.measured_frame_bytes, want.extras["measured_frame_bytes"])
