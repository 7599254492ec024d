"""The cohort samplers' device twins and ``ScanRunner(rng="device")``.

* ``_gumbel_topk_inclusion_dev`` against the reference's twin and the
  port's host ``gumbel_topk_inclusion`` (a deterministic quadrature:
  rel 2e-4 / abs 1e-6, float32 against float32 and float64).
* The uniform twin: ascending cohorts without replacement, pi = U/N, the
  identity cohort at U == N, and each device's inclusion frequency over
  4000 draws within 5 standard errors of U/N (5 * sqrt(0.25 / 4000) =
  0.04, the largest standard error of a frequency).
* The channel-aware twin: exactly the host sampler's top U, ties to the
  lower index (a population with tied rates), and explore slots that
  reach devices outside the top set.
* The energy-aware twin: the empirical inclusion frequency over 4000
  draws within the same 0.04 of the exact ``gumbel_topk_inclusion``, and
  the reported pi equal to it (rel 2e-4).
* Device mode end to end: partial participation (cohort and unbiased),
  a zero-sample device, block fading mixed into the host population.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

from repro.control.device_samplers import \
    _gumbel_topk_inclusion_dev as ref_inclusion_dev
from repro_torch.configs import LTFLConfig
from repro_torch.control.device_samplers import (
    _gumbel_topk_inclusion_dev,
    channel_aware_twin,
    energy_aware_twin,
    uniform_twin,
)
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import (
    ChannelAwareSampler,
    EnergyAwareSampler,
    FedSGDScheme,
    Population,
    ScanRunner,
    STCScheme,
    gumbel_topk_inclusion,
)
from repro_torch.models import MLP, MLPConfig

LTFL = LTFLConfig(num_devices=6, samples_min=40, samples_max=60,
                  bo_iters=3, alt_max_iters=2)
DRAWS = 4000
MC_ATOL = 5 * np.sqrt(0.25 / DRAWS)


def _population(seed, n):
    return Population.sample(LTFL.wireless, n, 40, 60,
                             np.random.default_rng(seed))


def _generator(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


@pytest.mark.parametrize("k", [1, 3, 7])
def test_gumbel_topk_inclusion_dev_matches_reference(k):
    w = np.random.default_rng(k).uniform(0.05, 1.0, 12)
    w /= w.sum()
    port = _gumbel_topk_inclusion_dev(torch.tensor(w, dtype=torch.float32),
                                      k).numpy()
    ref = np.asarray(ref_inclusion_dev(jnp.asarray(w, jnp.float32), k))
    np.testing.assert_allclose(port, ref, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(port, gumbel_topk_inclusion(w, k),
                               rtol=2e-4, atol=1e-6)
    assert float(port.sum()) == pytest.approx(k, rel=1e-4)


def test_uniform_twin():
    ch = _population(0, 12).channel.to_arrays()
    twin = uniform_twin(12, 4)
    assert twin.provides_inclusion
    gen = _generator(0)
    counts = np.zeros(12)
    for _ in range(DRAWS):
        cohort, pi = twin.select(ch, gen)
        c = cohort.numpy()
        counts[c] += 1
    assert c.shape == (4,) and np.all(np.diff(c) > 0)
    np.testing.assert_allclose(pi.numpy(), 4 / 12)
    np.testing.assert_allclose(counts / DRAWS, 4 / 12, atol=MC_ATOL)
    cohort, pi = uniform_twin(12, 12).select(ch, gen)
    np.testing.assert_array_equal(cohort.numpy(), np.arange(12))
    np.testing.assert_allclose(pi.numpy(), 1.0)


def test_channel_aware_twin_is_the_host_top_u_with_lower_index_ties():
    pop = _population(1, 10)
    ch = pop.channel
    # devices 2, 5, 7 and 8 share one channel: their rates tie exactly
    for i in (5, 7, 8):
        ch.distance[i], ch.interference[i] = ch.distance[2], \
            ch.interference[2]
        ch.cpu_hz[i] = ch.cpu_hz[2]
    ch.distance[2] = ch.distance.min()
    for i in (5, 7, 8):
        ch.distance[i] = ch.distance[2]
    twin = channel_aware_twin(10, 4, LTFL)
    assert not twin.provides_inclusion
    for u in (2, 3, 4):
        host, probs = ChannelAwareSampler().select(
            pop, u, 0, np.random.default_rng(0), LTFL)
        assert probs is None
        cohort, pi = channel_aware_twin(10, u, LTFL).select(
            ch.to_arrays(), _generator(0))
        assert pi is None
        np.testing.assert_array_equal(cohort.numpy(), host)
    seen = set()
    gen = _generator(1)
    for _ in range(64):
        c, _ = channel_aware_twin(10, 4, LTFL, explore=0.25).select(
            ch.to_arrays(), gen)
        assert len(np.unique(c.numpy())) == 4
        seen.update(c.tolist())
    top3, _ = ChannelAwareSampler().select(pop, 3, 0,
                                           np.random.default_rng(0), LTFL)
    assert len(seen - set(top3.tolist())) > 1


def test_energy_aware_twin_inclusion():
    pop = _population(2, 10)
    w = EnergyAwareSampler()._norm_weights(pop, LTFL)
    pi_exact = np.clip(gumbel_topk_inclusion(w, 3), 1e-9, 1.0)
    twin = energy_aware_twin(LTFL, 3)
    assert twin.provides_inclusion
    ch = pop.channel.to_arrays()
    gen = _generator(3)
    counts = np.zeros(10)
    for _ in range(DRAWS):
        cohort, pi = twin.select(ch, gen)
        c = cohort.numpy()
        assert len(np.unique(c)) == 3
        counts[c] += 1
    np.testing.assert_allclose(counts / DRAWS, pi_exact, atol=MC_ATOL)
    np.testing.assert_allclose(pi.numpy(), pi_exact[c], rtol=2e-4)


@pytest.fixture(scope="module")
def world():
    imgs, labels = synthetic_cifar(600, seed=0)
    timgs, tlabels = synthetic_cifar(128, seed=1)
    model = MLP(MLPConfig(hidden=(16,), downsample=4))
    return (model, model.init(_generator(0)),
            ArrayDataset({"images": imgs, "labels": labels}),
            ArrayDataset({"images": timgs, "labels": tlabels}))


@pytest.mark.parametrize("participation", ["cohort", "unbiased"])
def test_device_mode_partial_participation(world, participation):
    model, params, train, test = world
    scan = ScanRunner(model, params, LTFL, train, test, STCScheme(),
                      batch_size=8, seed=0, eval_every=3, device="cpu",
                      population_size=12, cohort_size=4, rng="device",
                      block_fading=True, participation=participation,
                      cohort_sampler=EnergyAwareSampler())
    fading0 = scan.population.channel.fading_mean.copy()
    hist = scan.run(6)
    for rec in hist:
        cohort = np.asarray(rec.cohort)
        assert cohort.shape == (4,) and np.all(np.diff(cohort) > 0)
        assert np.all((cohort >= 0) & (cohort < 12))
        assert np.isfinite(rec.train_loss) and np.isfinite(rec.gamma)
        assert rec.delay > 0 and rec.energy > 0
        assert rec.participation == pytest.approx(4 / 12)
    assert np.isfinite(hist[3].test_acc) and np.isnan(hist[1].test_acc)
    assert [(a, b) for a, b in scan._segment_spans(0, 6)] == [(0, 1),
                                                              (1, 4),
                                                              (4, 6)]
    # the device's redraws reached the host population
    assert not np.array_equal(scan.population.channel.fading_mean, fading0)
    assert scan.channel_epoch == 6
    np.testing.assert_array_equal(scan.channel.fading_mean,
                                  scan.population.channel.fading_mean[
                                      scan.cohort])


def test_device_mode_tolerates_zero_sample_device(world):
    """A zero-sample device's draws are clamped to its all-zero row and
    its aggregation weight is 0; a host batch from it stays an error."""
    model, params, train, test = world
    cfg = LTFLConfig(num_devices=4, samples_min=0, samples_max=3,
                     bo_iters=3, alt_max_iters=2)
    scan = ScanRunner(model, params, cfg, train, test, FedSGDScheme(),
                      batch_size=4, seed=0, eval_every=0, device="cpu",
                      population_size=16, cohort_size=4, rng="device")
    sizes = scan.batcher.client_sizes()
    assert (sizes == 0).any()
    for rec in scan.run(3):
        assert np.isfinite(rec.train_loss)
    zero = int(np.flatnonzero(sizes == 0)[0])
    with pytest.raises(ValueError, match="zero-sample"):
        scan.batcher.batch_indices(2, np.random.default_rng(0),
                                   clients=[zero])
