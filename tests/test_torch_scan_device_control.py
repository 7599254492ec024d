"""``ScanRunner(control="device")``: Algorithm 1, FedMP's bandit and the
eval head inside the segment, held to tests/test_scan_engine.py's and
tests/test_sweep_lanes.py's device-control assertions (solve counts in
place of the reference's trace counts), on the CPU at small size (MLP
hidden 16, U = 4, ``bo_iters`` 3, ``alt_max_iters`` 2).

* The planner: one span where host control would cut per round
  (``recontrol_every=1``, ``eval_every=1``), ``max_segment`` caps it, a
  cadence-4 program keeps boundaries at its multiples and decides only
  at a segment's first round (``_decide_first``); the solve runs once
  per decide round (``_n_decide_solves``).
* LTFL per round under block fading: control means in bounds, power
  moving with the channel, gamma finite, the control state and the
  range estimates on the runner's device.
* FedSGD under host and device control with ``rng="device"``: the same
  stream, so the losses are bitwise equal, and the eval head's accuracy
  within abs 1e-6 of ``evaluate()`` (NaN off its cadence).
* LTFL with partial participation and ``participation="unbiased"``
  (refused under host control): one segment, unique cohorts, finite
  gamma.
* FedMP's bandit on the device equals a host replay of its transition
  rule over the measured history.
* Sweep lanes (Table 2 and a 0.05 W "tight" regime) in one bucket,
  each bitwise its solo run, the cap binding in the tight lane.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import LTFLConfig
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import (
    FedMPScheme,
    FedSGDScheme,
    LTFLScheme,
    ScanRunner,
    SweepSpec,
)
from repro_torch.models import MLP, MLPConfig

LTFL = LTFLConfig(num_devices=4, samples_min=40, samples_max=60,
                  bo_iters=3, alt_max_iters=2)
# a second regime differing only in laned floats: the same bucket
TIGHT = dataclasses.replace(
    LTFL, t_max=1000.0, e_max=5.0,
    wireless=dataclasses.replace(LTFL.wireless, p_max=0.05, n0=8e-21))


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


def _runner(world, scheme, ltfl=LTFL, **kw):
    model, params, train, test = world
    kw = {"batch_size": 8, "seed": 0, "eval_every": 0, "rng": "device",
          "control": "device", **kw}
    return ScanRunner(model, params, ltfl, train, test, scheme,
                      device="cpu", **kw)


def assert_bit_equal(h_lane, h_solo):
    assert len(h_lane) == len(h_solo)
    for a, b in zip(h_lane, h_solo):
        for f in ("round", "received", "cohort", "train_loss", "delay",
                  "energy", "cum_delay", "cum_energy", "gamma", "rho_mean",
                  "delta_mean", "power_mean", "test_acc"):
            va, vb = getattr(a, f), getattr(b, f)
            if isinstance(va, float) and math.isnan(va):
                assert math.isnan(vb), f
            else:
                assert va == vb, f


# --------------------------------------------------------------------------- #
# the planner and the solve count
# --------------------------------------------------------------------------- #
def test_device_control_coalesces_planner_spans(world):
    host_ctl = _runner(world, LTFLScheme(recontrol_every=1), eval_every=1,
                       rng="host", control="host")
    assert host_ctl._segment_spans(0, 4) == [(0, 1), (1, 2), (2, 3),
                                             (3, 4)]
    dev_ctl = _runner(world, LTFLScheme(recontrol_every=1), eval_every=1)
    assert dev_ctl._segment_spans(0, 4) == [(0, 4)]
    capped = _runner(world, LTFLScheme(recontrol_every=1), eval_every=1,
                     max_segment=2)
    assert capped._segment_spans(0, 5) == [(0, 2), (2, 4), (4, 5)]


def test_device_cadence_splits_segments_and_solves_on_decide_rounds(world):
    scheme = LTFLScheme(recontrol_every=4)
    runner = _runner(world, scheme)
    assert runner._segment_spans(0, 8) == [(0, 4), (4, 8)]
    assert [runner._decide_first(a) for a in (0, 4)] == [True, True]
    hist = runner.run(8)
    assert len(hist) == 8
    assert scheme._n_decide_solves == 2
    # the decision holds between decide rounds
    assert len({r.power_mean for r in hist[:4]}) == 1

    scheme2 = LTFLScheme(recontrol_every=4)
    capped = _runner(world, scheme2, max_segment=2)
    spans = capped._segment_spans(0, 8)
    assert spans == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert [capped._decide_first(a) for a, _ in spans] == \
        [True, False, True, False]
    capped.run(8)
    assert scheme2._n_decide_solves == 2


# --------------------------------------------------------------------------- #
# LTFL per round, one segment
# --------------------------------------------------------------------------- #
def test_device_control_single_segment(world):
    scheme = LTFLScheme(recontrol_every=1)
    runner = _runner(world, scheme, eval_every=2, block_fading=True)
    assert runner._segment_spans(0, 6) == [(0, 6)]
    hist = runner.run(6)
    assert scheme._n_decide_solves == 6
    runner.run(6)
    assert scheme._n_decide_solves == 12
    assert len(runner.history) == 12
    for rec in hist:
        assert np.isfinite(rec.train_loss) and np.isfinite(rec.gamma)
        assert 1.0 <= rec.delta_mean <= LTFL.delta_max
        assert 0.0 <= rec.rho_mean <= LTFL.rho_max
        assert LTFL.wireless.p_min <= rec.power_mean <= LTFL.wireless.p_max
    # the eval head lands where the host's would
    assert np.isfinite(hist[0].test_acc) and np.isfinite(hist[2].test_acc)
    assert np.isnan(hist[1].test_acc) and np.isnan(hist[3].test_acc)
    # per-round recontrol under block fading follows the channel
    assert len({round(r.power_mean, 6) for r in hist}) > 1
    # the control state and the range estimates stay on the device
    assert runner._ctl_state.power.device == runner.device
    assert runner._range_sq_dev.device == runner.device
    assert runner.channel_epoch == 12


def test_in_segment_eval_matches_host_evaluate(world):
    """The same seed and rng='device' stream under host control (eval
    between segments) and device control (the eval head): a scheme with
    no program draws the same, so the losses are bitwise equal."""
    host_eval = _runner(world, FedSGDScheme(), eval_every=2,
                        control="host")
    in_segment = _runner(world, FedSGDScheme(), eval_every=2)
    assert in_segment._segment_spans(0, 6) == [(0, 6)]
    h_a, h_b = host_eval.run(6), in_segment.run(6)
    for a, b in zip(h_a, h_b):
        assert a.train_loss == b.train_loss
        assert a.received == b.received
        if np.isnan(a.test_acc):
            assert np.isnan(b.test_acc)
        else:
            assert b.test_acc == pytest.approx(a.test_acc, abs=1e-6)
    assert np.isnan(h_b[1].test_acc) and np.isfinite(h_b[4].test_acc)
    for k, v in host_eval.params.items():
        assert torch.equal(v, in_segment.params[k]), k


def test_device_control_partial_participation_runs(world):
    runner = _runner(world, LTFLScheme(), population_size=12,
                     cohort_size=4, block_fading=True,
                     participation="unbiased")
    assert runner._segment_spans(0, 5) == [(0, 5)]
    hist = runner.run(5)
    assert runner.scheme._n_decide_solves == 5
    for rec in hist:
        cohort = np.asarray(rec.cohort)
        assert cohort.shape == (4,) and len(np.unique(cohort)) == 4
        assert np.isfinite(rec.gamma) and np.isfinite(rec.train_loss)
        assert 1.0 <= rec.delta_mean <= LTFL.delta_max
    # the host estimates are the device's, synced at the end of run
    assert np.all(np.isfinite(runner._range_sq_pop))
    np.testing.assert_array_equal(runner._range_sq_pop,
                                  runner._range_sq_dev.numpy())


def test_guards(world):
    with pytest.raises(ValueError, match="rng='device'"):
        _runner(world, LTFLScheme(recontrol_every=1), rng="host")

    class Recontrols(FedSGDScheme):
        def scan_recontrol_every(self, runner):
            return 1

    with pytest.raises(ValueError, match="scan_control_program"):
        _runner(world, Recontrols())
    with pytest.raises(ValueError, match="host-recontrol"):
        _runner(world, LTFLScheme(), control="host", population_size=8,
                cohort_size=4)


# --------------------------------------------------------------------------- #
# FedMP's bandit on the device
# --------------------------------------------------------------------------- #
def test_fedmp_device_bandit_matches_host_replay(world):
    scheme = FedMPScheme()
    runner = _runner(world, scheme)
    assert runner._segment_spans(0, 6) == [(0, 6)]
    hist = runner.run(6)
    arms = np.asarray(scheme.arms)
    n, a = 4, len(arms)
    counts = np.zeros((n, a))
    rewards = np.zeros((n, a))
    prev_loss = None
    for rnd, rec in enumerate(hist):
        choice = np.zeros(n, np.int64)
        for u in range(n):
            if np.any(counts[u] == 0):
                choice[u] = int(np.argmin(counts[u]))
            else:
                ucb = rewards[u] / counts[u] + np.sqrt(
                    2.0 * np.log(rnd + 1) / counts[u])
                choice[u] = int(np.argmax(ucb))
        assert rec.rho_mean == pytest.approx(float(np.mean(arms[choice])),
                                             abs=1e-6)
        reward = 0.0
        if prev_loss is not None:
            reward = max(prev_loss - rec.train_loss, 0.0) \
                / max(rec.delay, 1e-9)
        counts[np.arange(n), choice] += 1.0
        rewards[np.arange(n), choice] += reward
        prev_loss = rec.train_loss
    np.testing.assert_array_equal(scheme._counts, counts)
    np.testing.assert_allclose(scheme._rewards, rewards, rtol=1e-4,
                               atol=1e-9)
    assert scheme._prev_loss == pytest.approx(hist[-1].train_loss)


# --------------------------------------------------------------------------- #
# sweep lanes under device control
# --------------------------------------------------------------------------- #
def test_device_control_lanes_bit_match_solo_runs(world):
    def scheme():
        return LTFLScheme(recontrol_every=2)

    parent = _runner(world, scheme())
    spec = SweepSpec.grid(schemes={"ltfl": scheme},
                          ltfls={"table2": LTFL, "tight": TIGHT},
                          seeds=(0,))
    hists = parent.run_sweep(spec, 6)
    assert [b["lane_indices"] for b in parent._last_sweep_buckets] == \
        [[0, 1]]
    assert not parent.history
    lanes = parent._last_sweep_buckets[0]["lanes"]
    for lane_spec, hist, lane in zip(spec.lanes, hists, lanes):
        solo = _runner(world, scheme(), ltfl=lane_spec.ltfl)
        assert_bit_equal(hist, solo.run(6))
        for k, v in solo.params.items():
            assert torch.equal(v, lane.params[k]), k
        assert lane.scheme._n_decide_solves == 3
    table2, tight = hists
    assert table2[-1].power_mean != tight[-1].power_mean
    assert all(r.power_mean <= 0.05 + 1e-6 for r in tight)
