"""The port's buffered-async engine on its own terms, mirroring
tests/test_async_engine.py against the port's ``ScanRunner`` (no jax:
these run on the card's machine too).

* The sync-degenerate contract: ``AsyncRunner(deadline=inf,
  buffer_size=U, churn=None)`` is ``ScanRunner`` bitwise under both rng
  modes (every history field, the weights), and with STC's residual.
* Buffered admission and staleness against a host replay of the logged
  masks; a filled buffer closes the round early; a deadline below every
  completion time admits nobody; construction checks.
* Churn: an all-departed fleet never admits, drops mid-upload, zero
  probabilities are the no-churn run, the stationary alive fraction.
* The staleness term of gamma: exactly +0.0 at tau = 0, monotone and
  HT-scaled, and the engine's reported gamma includes it; the HT
  plug-in's unbiasedness.
* LTFL's deadline budget, and async sweep lanes against solo runs.
* The port's own: ties at the K-th rank go to the lower index (the
  stable argsort), and under ``control="device"`` the program's feedback
  sees the buffered delay. A ``gpu`` test holds the degenerate contract
  on the card, with every segment under the sync check.
* Async on the registry in blocks (``population_sharding=8``, N = 40):
  the degenerate case bitwise the sharded ``ScanRunner``, buffered
  admission with churn and K < U against the host replay of the logged
  admissions, and the reference's ``rng="host"`` guard.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import LTFLConfig
from repro_torch.core.channel import ChannelArrays
from repro_torch.core.convergence import gamma, gamma_dev, gap_terms
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import (
    AsyncRunner,
    ChannelAwareSampler,
    ChurnSpec,
    EnergyAwareSampler,
    FedMPScheme,
    FedSGDScheme,
    LTFLScheme,
    ScanRunner,
    STCScheme,
)
from repro_torch.fed.scan_engine import _laned_ltfl
from repro_torch.models import MLP, MLPConfig

LTFL = LTFLConfig(num_devices=4, samples_min=40, samples_max=60,
                  bo_iters=3, alt_max_iters=2)
# the four devices finish at ~144, 149, 176 and 357 s (the round, with
# the server delay, at ~358 s); this deadline admits three of them
DEADLINE = 350.0


@pytest.fixture(scope="module")
def world():
    imgs, labels = synthetic_cifar(600, seed=0)
    timgs, tlabels = synthetic_cifar(128, seed=1)
    model = MLP(MLPConfig(hidden=(16,), downsample=4))
    gen = torch.Generator()
    gen.manual_seed(0)
    return (model, model.init(gen),
            ArrayDataset({"images": imgs, "labels": labels}),
            ArrayDataset({"images": timgs, "labels": tlabels}))


def make(cls, world, scheme, device="cpu", **kw):
    model, params, train, test = world
    kw = {"batch_size": 8, "seed": 0, "eval_every": 0, **kw}
    return cls(model, params, LTFL, train, test, scheme, device=device,
               **kw)


def assert_history_bitwise(h_sync, h_async):
    assert len(h_sync) == len(h_async)
    for a, b in zip(h_sync, h_async):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, float) and np.isnan(va):
                assert np.isnan(vb), (f.name, a.round)
            else:
                assert va == vb, (f.name, a.round, va, vb)


def assert_same_weights(a, b):
    assert a.params.keys() == b.params.keys()
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k


# --------------------------------------------------------------------------- #
# the sync-degenerate contract
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rng_mode", ["host", "device"])
def test_degenerate_async_is_scanrunner_bitwise(world, rng_mode):
    sync = make(ScanRunner, world, FedSGDScheme(), eval_every=2,
                rng=rng_mode)
    asyn = make(AsyncRunner, world, FedSGDScheme(), eval_every=2,
                rng=rng_mode)
    assert_history_bitwise(sync.run(6), asyn.run(6))
    assert_same_weights(sync, asyn)
    assert all(r["n_admitted"] == LTFL.num_devices
               for r in asyn.async_history)
    assert np.all(asyn.staleness == 0.0)
    if rng_mode == "device":            # the stream did not shift
        assert torch.equal(sync._generator.get_state(),
                           asyn._generator.get_state())


def test_degenerate_stateful_compressor_bitwise(world):
    sync = make(ScanRunner, world, STCScheme())
    asyn = make(AsyncRunner, world, STCScheme())
    assert_history_bitwise(sync.run(5), asyn.run(5))
    for k, v in sync.comp_state.items():
        assert torch.equal(v, asyn.comp_state[k]), k


# --------------------------------------------------------------------------- #
# buffered admission and staleness
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rng_mode", ["host", "device"])
def test_staleness_dynamics_replay(world, rng_mode):
    """Admitted devices reset to 0, scheduled ones that missed age by 1,
    unscheduled ones keep their counter: replayed on the host from the
    logged masks, against the logged pre-reset tau and the final state."""
    r = make(AsyncRunner, world, FedSGDScheme(), rng=rng_mode,
             deadline=DEADLINE, buffer_size=2)
    h = r.run(8)
    tau = np.zeros(LTFL.num_devices)
    for rec, arec in zip(h, r.async_history):
        cohort = (np.asarray(rec.cohort, int) if rec.cohort
                  else np.arange(LTFL.num_devices))
        np.testing.assert_array_equal(arec["tau"], tau[cohort])
        assert rec.staleness == pytest.approx(float(np.mean(tau[cohort])))
        adm = arec["admitted"]
        assert arec["n_admitted"] == int(adm.sum()) <= 2
        assert rec.received <= arec["n_admitted"]
        tau[cohort] = np.where(adm, 0.0, tau[cohort] + 1.0)
    np.testing.assert_array_equal(r.staleness, tau)
    assert tau.max() > 0.0


def test_buffer_closes_round_early(world):
    sync = make(ScanRunner, world, FedSGDScheme())
    asyn = make(AsyncRunner, world, FedSGDScheme(), buffer_size=1)
    h_sync, h_async = sync.run(4), asyn.run(4)
    for a, b in zip(h_sync, h_async):
        assert b.delay < a.delay
        # stragglers still spend their energy (Eq. 37 unchanged)
        assert b.energy == pytest.approx(a.energy, rel=1e-6)
    assert all(r["n_admitted"] == 1 for r in asyn.async_history)


def test_deadline_excludes_stragglers(world):
    r = make(AsyncRunner, world, FedSGDScheme(), deadline=10.0)
    h = r.run(3)
    assert all(rec["n_admitted"] == 0 for rec in r.async_history)
    assert all(rec.received == 0 for rec in h)
    for rec in h:
        assert rec.delay == pytest.approx(10.0 + LTFL.server_delay)
    np.testing.assert_array_equal(r.staleness,
                                  np.full(LTFL.num_devices, 3.0))


def test_async_validation(world):
    with pytest.raises(ValueError, match="deadline"):
        make(AsyncRunner, world, FedSGDScheme(), deadline=0.0)
    with pytest.raises(ValueError, match="buffer_size"):
        make(AsyncRunner, world, FedSGDScheme(), buffer_size=5)
    with pytest.raises(ValueError, match="buffer_size"):
        make(AsyncRunner, world, FedSGDScheme(), buffer_size=0)
    with pytest.raises(TypeError, match="ChurnSpec"):
        make(AsyncRunner, world, FedSGDScheme(), churn=0.5)
    with pytest.raises(ValueError, match="p_depart"):
        ChurnSpec(p_depart=1.5)
    if not torch.cuda.is_available():
        # built like ScanRunner: on cuda unless asked, no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(AsyncRunner, world, FedSGDScheme(), device=None)


# --------------------------------------------------------------------------- #
# async on the registry in blocks
# --------------------------------------------------------------------------- #
SHARDED = dict(population_size=40, cohort_size=4, rng="device",
               population_sharding=8, block_fading=True,
               cohort_sampler=ChannelAwareSampler())


def test_sharded_degenerate_async_is_scanrunner_bitwise(world):
    sync = make(ScanRunner, world, FedSGDScheme(), **SHARDED)
    asyn = make(AsyncRunner, world, FedSGDScheme(), **SHARDED)
    assert_history_bitwise(sync.run(5), asyn.run(5))
    assert_same_weights(sync, asyn)
    assert torch.equal(sync._generator.get_state(),
                       asyn._generator.get_state())
    np.testing.assert_array_equal(sync.population.fading_epoch,
                                  asyn.population.fading_epoch)


@pytest.mark.parametrize("sampler", [ChannelAwareSampler(explore=0.25),
                                     EnergyAwareSampler()],
                         ids=["channel_explore", "energy"])
def test_sharded_async_churn_and_buffer(world, sampler):
    """K = 2 of U = 4, a deadline and churn over the sharded registry:
    the (N,) tau on the runner's device follows the host replay of the
    logged admissions; cohorts reach beyond the first one."""
    r = make(AsyncRunner, world, FedSGDScheme(), deadline=DEADLINE,
             buffer_size=2, churn=ChurnSpec(0.2, 0.5, 0.1),
             **{**SHARDED, "cohort_sampler": sampler})
    h = r.run(8)
    tau = np.zeros(40)
    for rec, arec in zip(h, r.async_history):
        cohort = np.asarray(rec.cohort, int)
        assert len(np.unique(cohort)) == 4 and np.all(cohort < 40)
        assert np.isfinite(rec.train_loss)
        np.testing.assert_array_equal(arec["tau"], tau[cohort])
        assert rec.received <= arec["n_admitted"] <= 2
        tau[cohort] = np.where(arec["admitted"], 0.0, tau[cohort] + 1.0)
    np.testing.assert_array_equal(r.staleness, tau)
    assert len({tuple(rec.cohort) for rec in h}) > 1
    assert r._tau_dev.shape == (40,)


def test_sharded_async_needs_device_rng(world):
    with pytest.raises(ValueError, match="rng='device'"):
        make(AsyncRunner, world, FedSGDScheme(),
             **{**SHARDED, "rng": "host"})


# --------------------------------------------------------------------------- #
# churn
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rng_mode", ["host", "device"])
def test_churn_all_departed_never_admits(world, rng_mode):
    r = make(AsyncRunner, world, FedSGDScheme(), rng=rng_mode,
             churn=ChurnSpec(p_depart=1.0, p_return=0.0))
    h = r.run(4)
    assert all(rec["n_admitted"] == 0 for rec in r.async_history)
    assert all(rec.received == 0 for rec in h)
    assert all(len(rec.cohort) in (0, LTFL.num_devices) for rec in h)


@pytest.mark.parametrize("rng_mode", ["host", "device"])
def test_churn_drop_mid_upload(world, rng_mode):
    r = make(AsyncRunner, world, FedSGDScheme(), rng=rng_mode,
             deadline=DEADLINE, churn=ChurnSpec(p_drop=1.0))
    h = r.run(3)
    assert all(rec["n_admitted"] == 0 for rec in r.async_history)
    for rec in h:
        assert rec.delay == pytest.approx(DEADLINE + LTFL.server_delay)
        assert rec.energy > 0.0


def test_churn_zero_probabilities_degenerate(world):
    """ChurnSpec(0, 0, 0) is the no-churn trajectory under host rng (the
    churn stream is separate from the replay stream)."""
    base = make(AsyncRunner, world, FedSGDScheme(), deadline=DEADLINE,
                buffer_size=2)
    churned = make(AsyncRunner, world, FedSGDScheme(), deadline=DEADLINE,
                   buffer_size=2, churn=ChurnSpec(0.0, 0.0, 0.0))
    assert_history_bitwise(base.run(5), churned.run(5))


def test_churn_stationary_fraction(world):
    """Under no deadline, n_admitted counts the alive cohort; its time
    average sits near the chain's stationary point 0.5."""
    r = make(AsyncRunner, world, FedSGDScheme(), rng="device",
             buffer_size=4, churn=ChurnSpec(p_depart=0.3, p_return=0.3))
    r.run(40)
    frac = np.mean([rec["n_admitted"] for rec in r.async_history]) / 4
    assert 0.25 <= frac <= 0.75


# --------------------------------------------------------------------------- #
# the staleness term of gamma
# --------------------------------------------------------------------------- #
def _gap_args(ns):
    return (LTFL, np.full(3, 4.0), np.full(3, 0.05), np.full(3, 0.3),
            np.full(3, 0.01), ns)


def test_gamma_staleness_zero_is_exact_noop():
    args = _gap_args(np.array([40.0, 50.0, 60.0]))
    base = gap_terms(*args)
    stale0 = gap_terms(*args, staleness=np.zeros(3))
    assert stale0.staleness == 0.0
    assert stale0.total == base.total
    dev = [torch.as_tensor(np.asarray(a, np.float32)) for a in args[1:]]
    assert float(gamma_dev(LTFL, *dev)) == float(
        gamma_dev(LTFL, *dev, staleness=torch.zeros(3)))


def test_gamma_staleness_monotone_and_ht_scaled():
    ns = np.array([50.0, 50.0, 50.0])
    args = _gap_args(ns)
    prev = 0.0
    for tau in (0.0, 1.0, 4.0, 16.0):
        g = gap_terms(*args, staleness=np.full(3, tau))
        assert g.staleness >= prev
        prev = g.staleness
    kw = dict(population_samples=float(np.sum(ns)))
    pi_full = gap_terms(*args, staleness=np.ones(3), inclusion=np.ones(3),
                        **kw)
    pi_half = gap_terms(*args, staleness=np.ones(3),
                        inclusion=np.full(3, 0.5), **kw)
    assert pi_half.staleness == pytest.approx(2.0 * pi_full.staleness)


def test_ht_plugin_unbiased_under_exchangeable_admission():
    """The plug-in effective inclusion pi * (n_admitted / U): with
    exchangeable completion times, sum over the admitted of x_i / pi_eff
    is unbiased for the population total (Monte Carlo)."""
    rng = np.random.default_rng(7)
    n_pop, u, k, draws = 10, 4, 2, 20000
    x = rng.uniform(1.0, 2.0, n_pop)
    pi_eff = (u / n_pop) * (k / u)
    # each draw's cohort: the first u of a random permutation; its
    # buffer: the k earliest of iid exponential completion times
    cohorts = np.argsort(rng.random((draws, n_pop)), axis=1)[:, :u]
    t = rng.exponential(size=(draws, u))
    admitted = np.take_along_axis(cohorts, np.argsort(t, axis=1)[:, :k],
                                  axis=1)
    est = np.sum(x[admitted] / pi_eff, axis=1)
    assert float(np.mean(est)) == pytest.approx(float(np.sum(x)), rel=0.03)


def test_engine_gamma_uses_staleness(world, monkeypatch):
    """The reported gamma is Eq. 29 with the staleness term of each
    round's logged (pre-reset) tau, and so above the same round's gamma
    without it once a cohort member is stale."""
    from repro_torch.fed import scan_engine
    calls = []

    def recording(*args, **kw):
        out = gamma(*args, **kw)
        calls.append((out, gamma(*args, **{k: v for k, v in kw.items()
                                           if k != "staleness"}),
                      kw.get("staleness")))
        return out
    monkeypatch.setattr(scan_engine, "gamma", recording)
    r = make(AsyncRunner, world, FedSGDScheme(), deadline=DEADLINE,
             buffer_size=1)
    h = r.run(6)
    assert len(calls) == len(h) == 6
    for rec, arec, (with_tau, without, tau) in zip(h, r.async_history,
                                                    calls):
        np.testing.assert_array_equal(tau, arec["tau"])
        assert rec.gamma == with_tau and np.isfinite(rec.gamma)
        if rec.staleness > 0.0:
            assert with_tau > without
        else:
            assert with_tau == without
    assert any(rec.staleness > 0.0 for rec in h)


# --------------------------------------------------------------------------- #
# scheme integration and lanes
# --------------------------------------------------------------------------- #
def test_ltfl_scheme_deadline_budget(world):
    r = make(AsyncRunner, world, LTFLScheme(), deadline=100.0,
             buffer_size=3)
    assert r.scheme._async_t_max == pytest.approx(100.0 + LTFL.server_delay)
    h = r.run(2)
    assert all(np.isfinite(rec.train_loss) for rec in h)
    loose = make(AsyncRunner, world, LTFLScheme(),
                 deadline=float(LTFL.t_max) * 2)
    assert loose.scheme._async_t_max is None
    assert make(AsyncRunner, world, LTFLScheme()).scheme._async_t_max is None


@pytest.mark.parametrize("rng_mode", ["host", "device"])
def test_async_run_sweep_lanes(world, rng_mode):
    """Lanes inherit the deadline, buffer and churn and bucket apart from
    sync lanes; each lane is its solo run: admissions, tau and the
    numpy-side fields bitwise, losses within rel 1e-5 and the accounting
    within rel 1e-6 (tests/test_torch_sweep_lanes.py: one vmap over the
    bucket's 2 x U clients, an (L, U) accounting view)."""
    kw = dict(rng=rng_mode, deadline=DEADLINE, buffer_size=2,
              churn=ChurnSpec(0.2, 0.5, 0.1))
    proto = make(AsyncRunner, world, FedSGDScheme(), **kw)
    swept = proto.run_sweep([1, 2], 4)
    buckets = proto._last_sweep_buckets
    assert [b["lane_indices"] for b in buckets] == [[0, 1]]
    assert buckets[0]["signature"][-1] == (
        "async", DEADLINE, 2, (0.2, 0.5, 0.1))
    sync_sig = ScanRunner._lane_signature(proto, make(
        ScanRunner, world, FedSGDScheme(), rng=rng_mode))
    assert sync_sig != buckets[0]["signature"]
    for seed, hist, lane in zip((1, 2), swept, buckets[0]["lanes"]):
        assert isinstance(lane, AsyncRunner)
        solo = make(AsyncRunner, world, FedSGDScheme(), seed=seed, **kw)
        h_solo = solo.run(4)
        for a, b in zip(hist, h_solo):
            assert (a.cohort, a.received, a.staleness) == \
                (b.cohort, b.received, b.staleness)
            assert a.train_loss == pytest.approx(b.train_loss, rel=1e-5)
            for f in ("delay", "energy", "gamma"):
                assert getattr(a, f) == pytest.approx(getattr(b, f),
                                                      rel=1e-6)
        for p, q in zip(lane.async_history, solo.async_history):
            np.testing.assert_array_equal(p["admitted"], q["admitted"])
            np.testing.assert_array_equal(p["tau"], q["tau"])
        np.testing.assert_array_equal(lane.staleness, solo.staleness)
    assert not proto.history and proto.staleness.max() == 0.0


# --------------------------------------------------------------------------- #
# the port's own
# --------------------------------------------------------------------------- #
def test_admission_ranks_ties_to_the_lower_index(world):
    """Three devices with the same channel finish at the same instant;
    with K = 2 the buffer takes the fastest device and the lowest index
    of the tied three (jnp.argsort is stable; torch.argsort is asked to
    be), wherever the tie sits."""
    r = make(AsyncRunner, world, FedSGDScheme(), buffer_size=2)
    r._ensure_device_world()
    view = _laned_ltfl(r.ltfl, {k: torch.tensor([[float(v)]])
                                for k, v in r._laned_cfg().items()})
    u = LTFL.num_devices
    ones = torch.ones(1, u)
    cohort = torch.arange(u).reshape(1, u)
    for fast, want in ((3, [True, False, False, True]),
                       (0, [True, True, False, False]),
                       (1, [True, True, False, False])):
        cpu = torch.full((1, u), 1e9)
        cpu[0, fast] = 2e9                       # finishes first
        ch = ChannelArrays(distance=torch.full((1, u), 100.0),
                           fading_mean=ones.clone(),
                           interference=torch.full((1, u), 1e-10),
                           cpu_hz=cpu, num_samples=torch.full((1, u), 50.0))
        r._tau_dev.zero_()
        alpha, weights, _, tau, admitted, _ = r._admission(
            [r], view, ch, cohort, ones, ones, None, torch.zeros(1, u),
            torch.full((1, u), 0.1), torch.full((1, u), 1e6), None)
        assert admitted[0].tolist() == want, (fast, admitted)
        assert alpha[0].tolist() == [float(a) for a in want]
        np.testing.assert_array_equal(tau[0].numpy(), np.zeros(u))
        np.testing.assert_array_equal(weights[0].numpy(), np.ones(u))
        np.testing.assert_array_equal(
            r.staleness, [0.0 if a else 1.0 for a in want])


def test_device_control_feedback_sees_the_buffered_delay(world):
    """Under control='device' FedMP's bandit feedback gets each round's
    buffered delay (K = 1 closes the round at the first arrival), the
    same value the history reports, below the synchronous round's."""
    r = make(AsyncRunner, world, FedMPScheme(), rng="device",
             control="device", buffer_size=1)
    seen = []
    inner = r._ctl_program.feedback

    def feedback(state, cohort, loss, delay):
        seen.append(delay.clone())
        return inner(state, cohort, loss, delay)
    r._ctl_program = r._ctl_program._replace(feedback=feedback)
    h = r.run(4)
    assert r._segment_spans(0, 4) == [(0, 4)]
    assert [float(d) for d in seen] == [rec.delay for rec in h]
    assert all(a["n_admitted"] == 1 for a in r.async_history)
    sync = make(ScanRunner, world, FedMPScheme(), rng="device",
                control="device")
    for rec, srec in zip(h, sync.run(4)):
        assert rec.delay < srec.delay


@pytest.mark.gpu
@pytest.mark.parametrize("rng_mode", ["host", "device"])
def test_degenerate_on_the_card(world, rng_mode):
    """The degenerate contract on the card, every segment under the sync
    check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runs = []
    for cls in (ScanRunner, AsyncRunner):
        runner = make(cls, world, FedSGDScheme(), device="cuda",
                      eval_every=2, rng=rng_mode)
        runner.segment_sync_debug = "error"
        runs.append((runner, runner.run(6)))
    assert_history_bitwise(runs[0][1], runs[1][1])
    assert_same_weights(runs[0][0], runs[1][0])
    asyn = runs[1][0]
    assert all(r["n_admitted"] == LTFL.num_devices
               for r in asyn.async_history)
    buffered = make(AsyncRunner, world, FedSGDScheme(), device="cuda",
                    rng=rng_mode, deadline=DEADLINE, buffer_size=2,
                    churn=ChurnSpec(0.2, 0.5, 0.1))
    buffered.segment_sync_debug = "error"
    h = buffered.run(6)
    assert all(np.isfinite(rec.train_loss) for rec in h)
    assert all(a["n_admitted"] <= 2 for a in buffered.async_history)
