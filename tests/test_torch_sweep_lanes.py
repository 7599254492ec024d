"""Sweep lanes: ``SweepSpec`` grids, buckets, and each lane against its
solo run.

* ``SweepSpec.grid`` labels equal the reference's.
* The bucket partition of a mixed spec (two schemes x two cohort widths
  x two seeds) equals the reference's ``_last_sweep_buckets``.
* Each lane of a bucket against a solo ``ScanRunner`` of the same
  config, both rng modes: the numpy-side fields (cohorts, received
  counts, control means) bitwise, the loss within rel 1e-5 (the
  reference's test_run_sweep_matches_single_runs tolerance: the bucket
  computes every client's gradient in one vmap over L * U clients, the
  solo run over U), delay, energy and gamma within rel 1e-6 (the same
  float32 accounting over an (L, U) view instead of (1, U)); for LTFL
  the final weights too, rel 1e-5. LTFL lanes
  take the quantizer (one launch per leaf for the bucket), STC lanes
  carry their residual stacked over the bucket's clients.
* A learning-rate grid shares one bucket and its lanes diverge.
* Unbiased lanes divide by their own population's sample total.
"""
import dataclasses

import pytest
import torch

pytest.importorskip("jax")

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.data import ArrayDataset as RefArrayDataset
from repro.data import synthetic_cifar as ref_synthetic_cifar
from repro.fed import FedSGDScheme as RefFedSGDScheme
from repro.fed import LaneSpec as RefLaneSpec
from repro.fed import ScanRunner as RefScanRunner
from repro.fed import STCScheme as RefSTCScheme
from repro.fed import SweepSpec as RefSweepSpec
from repro.models.mlp import MLP as RefMLP
from repro.models.mlp import MLPConfig as RefMLPConfig
from repro_torch.configs import LTFLConfig
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import (
    FedSGDScheme,
    LaneSpec,
    LTFLScheme,
    ScanRunner,
    STCScheme,
    SweepSpec,
    UniformSampler,
)
from repro_torch.models import MLP, MLPConfig, params_to_numpy

MLP_KW = dict(hidden=(16,), downsample=4)
LTFL_KW = dict(num_devices=4, samples_min=40, samples_max=60, bo_iters=3,
               alt_max_iters=2)
LTFL = LTFLConfig(**LTFL_KW)
# a second regime differing only in laned floats: same bucket
TIGHT = dataclasses.replace(
    LTFL, t_max=1000.0, e_max=5.0,
    wireless=dataclasses.replace(LTFL.wireless, p_max=0.05, n0=8e-21))


@pytest.fixture(scope="module")
def world():
    imgs, labels = synthetic_cifar(600, seed=0)
    timgs, tlabels = synthetic_cifar(128, seed=1)
    model = MLP(MLPConfig(**MLP_KW))
    gen = torch.Generator()
    gen.manual_seed(0)
    return (model, model.init(gen),
            ArrayDataset({"images": imgs, "labels": labels}),
            ArrayDataset({"images": timgs, "labels": tlabels}))


def assert_lane_matches_solo(h_lane, h_solo):
    assert len(h_lane) == len(h_solo)
    for a, b in zip(h_lane, h_solo):
        for f in ("round", "received", "cohort", "rho_mean", "delta_mean",
                  "power_mean", "participation"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.train_loss == pytest.approx(b.train_loss, rel=1e-5)
        for f in ("delay", "energy", "cum_delay", "cum_energy", "gamma"):
            assert getattr(a, f) == pytest.approx(getattr(b, f),
                                                  rel=1e-6), f


def _solo_runner(world, ltfl, scheme, seed, **kw):
    model, params, train, test = world
    return ScanRunner(model, params, ltfl, train, test, scheme,
                      batch_size=8, seed=seed, eval_every=0, device="cpu",
                      **kw)


def _solo(world, ltfl, scheme, seed, rounds, **kw):
    return _solo_runner(world, ltfl, scheme, seed, **kw).run(rounds)


def test_grid_labels_equal_the_reference():
    spec = SweepSpec.grid(
        schemes={"fedsgd": FedSGDScheme, "stc": STCScheme},
        ltfls={"narrow": LTFL, "tight": TIGHT},
        kwargs={"u3": {"cohort_size": 3}}, seeds=(0, 1))
    ref = RefSweepSpec.grid(
        schemes={"fedsgd": RefFedSGDScheme, "stc": RefSTCScheme},
        ltfls={"narrow": None, "tight": None},
        kwargs={"u3": {"cohort_size": 3}}, seeds=(0, 1))
    assert [lane.label for lane in spec.lanes] == \
        [lane.label for lane in ref.lanes]
    assert [lane.seed for lane in spec.lanes] == \
        [lane.seed for lane in ref.lanes]
    assert SweepSpec.grid(seeds=(3,)).lanes[0] == LaneSpec(seed=3,
                                                           label="s3")
    assert RefSweepSpec.grid(seeds=(3,)).lanes[0] == RefLaneSpec(
        seed=3, label="s3")
    with pytest.raises(ValueError, match="at least one lane"):
        SweepSpec(lanes=())


def test_buckets_equal_the_reference(world):
    """Two schemes x two cohort widths x two seeds: four buckets, the
    same lanes in each as the reference forms."""
    model, params, train, test = world
    kw = dict(batch_size=8, seed=0, eval_every=0, population_size=6)
    axes = dict(kwargs={"u4": {"cohort_size": 4}, "u3": {"cohort_size": 3}},
                seeds=(0, 1))
    spec = SweepSpec.grid(schemes={"fedsgd": FedSGDScheme,
                                   "stc": STCScheme}, **axes)
    parent = ScanRunner(model, params, LTFL, train, test, FedSGDScheme(),
                        device="cpu", **kw)
    hists = parent.run_sweep(spec, 1)
    imgs, labels = ref_synthetic_cifar(600, seed=0)
    timgs, tlabels = ref_synthetic_cifar(128, seed=1)
    ref = RefScanRunner(RefMLP(RefMLPConfig(**MLP_KW)),
                        params_to_numpy(params), RefLTFLConfig(**LTFL_KW),
                        RefArrayDataset({"images": imgs, "labels": labels}),
                        RefArrayDataset({"images": timgs,
                                         "labels": tlabels}),
                        RefFedSGDScheme(), **kw)
    ref_hists = ref.run_sweep(RefSweepSpec.grid(
        schemes={"fedsgd": RefFedSGDScheme, "stc": RefSTCScheme}, **axes),
        1)
    got = [b["lane_indices"] for b in parent._last_sweep_buckets]
    assert len(got) == 4
    assert got == [b["lane_indices"] for b in ref._last_sweep_buckets]
    for h, rh in zip(hists, ref_hists):
        assert [r.cohort for r in h] == [r.cohort for r in rh]
        assert [r.received for r in h] == [r.received for r in rh]
    assert not parent.history            # the sweep leaves the parent be


@pytest.mark.parametrize("mode", ["host", "device"])
def test_lanes_match_solo_runs(world, mode):
    """LTFL x two channel regimes x two seeds: one bucket; each lane is
    its solo run, history and final weights (block fading redrawn on the
    device in device mode)."""
    model, params, train, test = world
    spec = SweepSpec.grid(schemes={"ltfl": LTFLScheme},
                          ltfls={"narrow": LTFL, "tight": TIGHT},
                          seeds=(0, 1))
    kw = dict(block_fading=mode == "device")
    parent = ScanRunner(model, params, LTFL, train, test, LTFLScheme(),
                        batch_size=8, seed=0, eval_every=0, device="cpu",
                        rng=mode, **kw)
    hists = parent.run_sweep(spec, 3)
    assert [b["lane_indices"] for b in parent._last_sweep_buckets] == \
        [[0, 1, 2, 3]]
    lanes = parent._last_sweep_buckets[0]["lanes"]
    for lane_spec, lane, hist in zip(spec.lanes, lanes, hists):
        solo = _solo_runner(world, lane_spec.ltfl, LTFLScheme(),
                            lane_spec.seed, rng=mode, **kw)
        assert_lane_matches_solo(hist, solo.run(3))
        assert lane.params.keys() == solo.params.keys()
        for k, w in solo.params.items():
            torch.testing.assert_close(lane.params[k], w, rtol=1e-5,
                                       atol=1e-7)
    # the laned regime reaches the accounting
    assert hists[0][-1].energy != hists[2][-1].energy


def test_stc_lanes_carry_their_residual(world):
    model, params, train, test = world
    parent = ScanRunner(model, params, LTFL, train, test, STCScheme(),
                        batch_size=8, seed=0, eval_every=0, device="cpu")
    hists = parent.run_sweep([0, 1], 3)
    for seed, hist in zip([0, 1], hists):
        assert_lane_matches_solo(hist, _solo(world, LTFL, STCScheme(),
                                             seed, 3))


def test_learning_rate_grid_shares_one_bucket(world):
    model, params, train, test = world
    fast = dataclasses.replace(LTFL, learning_rate=0.1)
    parent = ScanRunner(model, params, LTFL, train, test, FedSGDScheme(),
                        batch_size=8, seed=0, eval_every=0, device="cpu")
    spec = SweepSpec.grid(ltfls={"base": LTFL, "fast": fast}, seeds=(0,))
    hists = parent.run_sweep(spec, 3)
    assert len(parent._last_sweep_buckets) == 1
    for lane, hist in zip(spec.lanes, hists):
        assert_lane_matches_solo(hist, _solo(world, lane.ltfl,
                                             FedSGDScheme(), 0, 3))
    assert hists[0][-1].train_loss != hists[1][-1].train_loss


@pytest.mark.parametrize("mode", ["host", "device"])
def test_unbiased_lanes_use_their_own_population(world, mode):
    """Every lane's population draws its own sample total; the HT
    denominator and gamma come from the lane's, not the parent's."""
    model, params, train, test = world
    kw = dict(population_size=7, cohort_size=4,
              cohort_sampler=UniformSampler(), participation="unbiased",
              rng=mode)
    parent = ScanRunner(model, params, LTFL, train, test, FedSGDScheme(),
                        batch_size=8, seed=0, eval_every=0, device="cpu",
                        **kw)
    hists = parent.run_sweep([1, 2], 3)
    for seed, hist in zip([1, 2], hists):
        assert_lane_matches_solo(hist, _solo(world, LTFL, FedSGDScheme(),
                                             seed, 3, **kw))
