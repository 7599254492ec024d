"""The port's numpy host side against the reference, bitwise.

The control plane (rates, packet error rates, transmission draws, delay,
energy, the Gamma gap, Theorems 2/3, Bayesian optimization and the whole
Algorithm-1 ``solve``), the data partitions and batch draws, and the
population sampler are float64/integer numpy on both sides; from the same
seeded numpy stream they must give identical bits and leave the stream
in the same state.
"""
import dataclasses

import numpy as np
import pytest

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.core import bayesopt as ref_bayesopt
from repro.core import channel as ref_channel
from repro.core import controller as ref_controller
from repro.core import convergence as ref_convergence
from repro.core import delay_energy as ref_de
from repro.data import ArrayDataset as RefArrayDataset
from repro.data import ClientBatcher as RefClientBatcher
from repro.data import partition as ref_partition
from repro.fed.population import Population as RefPopulation
from repro.fed.population import UniformSampler as RefUniformSampler
from repro_torch.configs import LTFLConfig
from repro_torch.core import bayesopt, channel, controller, convergence
from repro_torch.core import delay_energy as de
from repro_torch.data import ArrayDataset, ClientBatcher
from repro_torch.data import partition
from repro_torch.fed.population import Population, UniformSampler

U = 30
V = 4_901_450          # the paper-width ResNet's parameter count


def _cfgs(**kw):
    return LTFLConfig(**kw), RefLTFLConfig(**kw)


def test_configs_are_the_reference_defaults():
    port, ref = _cfgs()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _states(seed=0, n=U):
    port, ref = _cfgs()
    a = channel.ChannelState.sample(port.wireless, n, 400, 600,
                                    np.random.default_rng(seed))
    b = ref_channel.ChannelState.sample(ref.wireless, n, 400, 600,
                                        np.random.default_rng(seed))
    return port, ref, a, b


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_channel_rates_per_and_draws_bitwise():
    port, ref, a, b = _states()
    for f in ("distance", "fading_mean", "interference", "cpu_hz",
              "num_samples"):
        _eq(getattr(a, f), getattr(b, f))
    rng = np.random.default_rng(1)
    powers = rng.uniform(0.01, 0.1, (5, U))        # (K, U) candidates
    _eq(channel.expected_rate(port.wireless, a, powers),
        ref_channel.expected_rate(ref.wireless, b, powers))
    _eq(channel.packet_error_rate(port.wireless, a, powers),
        ref_channel.packet_error_rate(ref.wireless, b, powers))
    r1, r2 = np.random.default_rng(2), np.random.default_rng(2)
    _eq(channel.sample_transmissions(port.wireless, a, powers[0], r1),
        ref_channel.sample_transmissions(ref.wireless, b, powers[0], r2))
    a2 = a.redraw_fading(port.wireless, r1)
    b2 = b.redraw_fading(ref.wireless, r2)
    _eq(a2.fading_mean, b2.fading_mean)
    _eq(a2.interference, b2.interference)
    assert r1.bit_generator.state == r2.bit_generator.state


def test_delay_energy_and_gap_bitwise():
    port, ref, a, b = _states(3)
    rng = np.random.default_rng(4)
    rho = rng.uniform(0.0, 0.5, U)
    power = rng.uniform(0.01, 0.1, U)
    payload = rng.uniform(1e6, 4e7, U)
    for fp, fr in ((de.device_round_delay, ref_de.device_round_delay),
                   (de.device_round_energy, ref_de.device_round_energy)):
        _eq(fp(port.wireless, a, payload, rho, power),
            fr(ref.wireless, b, payload, rho, power))
    assert de.round_delay(port, a, payload, rho, power) == \
        ref_de.round_delay(ref, b, payload, rho, power)
    assert de.round_energy(port, a, payload, rho, power) == \
        ref_de.round_energy(ref, b, payload, rho, power)
    rsq = rng.uniform(1.0, 100.0, U)
    deltas = rng.integers(1, 9, U).astype(np.float64)
    pers = rng.uniform(0.0, 0.2, (4, U))
    for kw in ({}, {"inclusion": rng.uniform(0.2, 1.0, U),
                    "population_samples": 90_000.0,
                    "staleness": rng.integers(0, 4, U)}):
        gp = convergence.gap_terms(port, rsq, deltas, rho, pers,
                                   a.num_samples, **kw)
        gr = ref_convergence.gap_terms(ref, rsq, deltas, rho, pers,
                                       b.num_samples, **kw)
        for f in ("quantization", "pruning", "transmission", "scale",
                  "participation", "staleness"):
            _eq(getattr(gp, f), getattr(gr, f))
        _eq(gp.total, gr.total)


def test_theorems_and_evaluate_bitwise():
    port, ref, a, b = _states(5)
    rng = np.random.default_rng(6)
    power = rng.uniform(0.01, 0.1, U)
    deltas = np.full(U, 8)
    payload = controller.payload_bits_host(V, deltas, port.xi_bits)
    _eq(payload, ref_controller.payload_bits_host(V, deltas, ref.xi_bits))
    rho_p = controller.optimal_rho(port, a, payload, power)
    _eq(rho_p, ref_controller.optimal_rho(ref, b, payload, power))
    _eq(controller.optimal_delta(port, a, rho_p, power, V),
        ref_controller.optimal_delta(ref, b, rho_p, power, V))
    cand = rng.uniform(0.01, 0.1, (6, U))
    rsq = np.full(U, 1e-2 * V)
    gp, fp = controller._evaluate(port, a, rsq, rho_p, deltas, cand, V)
    gr, fr = ref_controller._evaluate(ref, b, rsq, rho_p, deltas, cand, V)
    _eq(gp, gr)
    _eq(fp, fr)


def test_bayesopt_bitwise():
    def objective(x):
        return np.sum((x - 0.3) ** 2, axis=-1)

    bounds = np.tile([[0.0, 1.0]], (5, 1))
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    a = bayesopt.minimize(objective, bounds, 6, r1, vectorized=True)
    b = ref_bayesopt.minimize(objective, bounds, 6, r2, vectorized=True)
    _eq(a.x_best, b.x_best)
    assert a.y_best == b.y_best
    _eq(a.history, b.history)
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("kw", [dict(bo_iters=6, alt_max_iters=3),
                                dict(bo_iters=4, alt_max_iters=2,
                                     t_max=400.0, e_max=2.0)])
def test_controller_solve_bitwise(kw):
    port, ref = _cfgs(**kw)
    a = channel.ChannelState.sample(port.wireless, U, 400, 600,
                                    np.random.default_rng(8))
    b = ref_channel.ChannelState.sample(ref.wireless, U, 400, 600,
                                        np.random.default_rng(8))
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    rsq = np.random.default_rng(10).uniform(1e3, 1e5, U)
    dp = controller.solve(port, a, V, range_sq_sums=rsq, rng=r1)
    dr = ref_controller.solve(ref, b, V, range_sq_sums=rsq, rng=r2)
    for f in ("rho", "delta", "power", "per", "gamma_trace"):
        _eq(getattr(dp, f), getattr(dr, f))
    assert dp.gamma == dr.gamma and dp.alternations == dr.alternations
    assert r1.bit_generator.state == r2.bit_generator.state


def test_partitions_batches_and_cohorts_bitwise():
    sizes = np.random.default_rng(11).integers(400, 601, 12)
    for fp, fr, n in ((partition.iid_partition, ref_partition.iid_partition,
                       8000),
                      (partition.population_partition,
                       ref_partition.population_partition, 5000)):
        r1, r2 = np.random.default_rng(12), np.random.default_rng(12)
        pa, pb = fp(n, sizes, r1), fr(n, sizes, r2)
        for x, y in zip(pa, pb):
            _eq(x, y)
        assert r1.bit_generator.state == r2.bit_generator.state
    labels = np.random.default_rng(13).integers(0, 10, 8000)
    r1, r2 = np.random.default_rng(14), np.random.default_rng(14)
    for x, y in zip(partition.dirichlet_partition(labels, sizes, 0.5, r1),
                    ref_partition.dirichlet_partition(labels, sizes, 0.5,
                                                      r2)):
        _eq(x, y)

    parts = partition.iid_partition(8000, sizes, np.random.default_rng(15))
    data = {"x": np.arange(8000)}
    bp = ClientBatcher(ArrayDataset(data), parts)
    br = RefClientBatcher(RefArrayDataset(data), parts)
    r1, r2 = np.random.default_rng(16), np.random.default_rng(16)
    _eq(bp.batch_indices(50, r1, clients=[1, 5, 7]),
        br.batch_indices(50, r2, clients=[1, 5, 7]))
    _eq(bp.batch(3, r1)["x"], br.batch(3, r2)["x"])

    port, ref = _cfgs()
    r1, r2 = np.random.default_rng(17), np.random.default_rng(17)
    pp = Population.sample(port.wireless, 40, 400, 600, r1)
    pr = RefPopulation.sample(ref.wireless, 40, 400, 600, r2)
    for k in range(3):
        ca, pa = UniformSampler().select(pp, 10, k, r1, port)
        cb, pb = RefUniformSampler().select(pr, 10, k, r2, ref)
        _eq(ca, cb)
        _eq(pa, pb)
        pp.advance_epoch()
        pr.advance_epoch()
        _eq(pp.refresh_fading(port.wireless, ca, r1),
            pr.refresh_fading(ref.wireless, cb, r2))
        _eq(pp.view(ca).fading_mean, pr.view(cb).fading_mean)
    assert r1.bit_generator.state == r2.bit_generator.state
