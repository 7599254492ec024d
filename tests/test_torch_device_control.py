"""The device control plane (``repro_torch.control``) against the port's
host control plane and against the reference's device twins, at the
sizes of tests/test_device_control.py (U = 6, ``bo_iters`` 3,
``alt_max_iters`` 2, 512 candidates).

* ``minimize_dev`` against the port's host ``bayesopt.minimize`` on the
  host's numpy stream injected as ``BODraws``: the first proposal to
  atol 1e-5 (the masked prefix GP is exact), longer runs on outcome
  quality.
* Theorems 2/3, the infeasible-budget clamps and the batched
  ``evaluate_dev`` against the host (atol 1e-5; rtol 1e-4).
* ``solve_dev`` against the port's host ``controller.solve`` and
  against the reference's ``solve_dev``, on the same injected draws and
  channel: rho atol 1e-5, delta equal, power rtol 1e-4, per atol 1e-6,
  gamma rel 1e-4 (the reference test's tolerances; the host side is
  float64, both device sides float32).
* The generator mode: deterministic and feasible-shaped; exactly one of
  ``generator=`` / ``draws=``.
* The frozen carry: a solve that Eq. 57 stops after one alternation
  equals a one-alternation solve bitwise, with the host's count.

The reference runs as its own tests run it (jit on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.control import BODraws as RefBODraws
from repro.control import solve_dev as ref_solve_dev
from repro.core.channel import ChannelState as RefChannelState
from repro_torch.configs import LTFLConfig
from repro_torch.control import (
    BODraws,
    evaluate_dev,
    make_draws,
    minimize_dev,
    optimal_delta_dev,
    optimal_rho_dev,
    solve_dev,
)
from repro_torch.core import bayesopt, controller
from repro_torch.core.channel import ChannelState
from repro_torch.core.quantization import payload_bits_host

from torch_parity import host_bo_draws

LTFL_KW = dict(num_devices=6, samples_min=40, samples_max=60, bo_iters=3,
               alt_max_iters=2)
LTFL = LTFLConfig(**LTFL_KW)
V = 3000
TARGET = np.array([0.6, 0.3, 0.45])


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _quadratic(d=3):
    bounds = np.tile([[0.0, 1.0]], (d, 1))

    def hobj(pm):
        return np.sum((np.atleast_2d(pm) - TARGET) ** 2, -1)

    def dobj(pm):
        return torch.sum((pm - _t(TARGET)) ** 2, -1)

    return bounds, hobj, dobj


def _first(draws: BODraws) -> BODraws:
    return BODraws(*(x[0] for x in draws))


# --------------------------------------------------------------------------- #
# device BO against the host BO
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minimize_dev_first_proposal_matches_host(seed):
    bounds, hobj, dobj = _quadratic()
    res = bayesopt.minimize(hobj, bounds, iters=1,
                            rng=np.random.default_rng(seed), vectorized=True)
    xb, yb = minimize_dev(dobj, _t(bounds), _first(host_bo_draws(seed, 1, 1,
                                                                 3)))
    np.testing.assert_allclose(xb.numpy(), res.x_best, atol=1e-5)
    assert float(yb) == pytest.approx(res.y_best, abs=1e-6)


def test_minimize_dev_outcome_quality_matches_host():
    """Longer runs may part ways at float32 near-ties of the
    acquisition, so the pin is on the outcome: both land near the
    quadratic's optimum."""
    bounds, hobj, dobj = _quadratic()
    for seed in (0, 1, 2, 3):
        res = bayesopt.minimize(hobj, bounds, iters=8,
                                rng=np.random.default_rng(seed),
                                vectorized=True)
        _, yb = minimize_dev(dobj, _t(bounds),
                             _first(host_bo_draws(seed, 1, 8, 3)))
        assert res.y_best <= 0.05 and float(yb) <= 0.05
        assert abs(float(yb) - res.y_best) <= 0.05


def test_make_draws_shapes_and_determinism():
    def draw(**kw):
        gen = torch.Generator()
        gen.manual_seed(3)
        return make_draws(gen, iters=5, init_points=4, n_candidates=64, d=7,
                          **kw)

    d1, d2 = draw(), draw()
    assert d1.u_init.shape == (4, 7)
    assert d1.u_cand.shape == (5, 64, 7)
    assert d1.eps_local.shape == (5, 16, 7)
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert float(d1.u_init.min()) >= 0.0 and float(d1.u_init.max()) <= 1.0
    # the local normals carry the host's 0.1 scale
    assert 0.05 < float(d1.eps_local.std()) < 0.15
    stacked = draw(alternations=2)
    assert stacked.u_cand.shape == (2, 5, 64, 7)


# --------------------------------------------------------------------------- #
# Theorems 2/3 and the batched evaluation
# --------------------------------------------------------------------------- #
def test_theorem_twins_match_host(rng):
    state = ChannelState.sample(LTFL.wireless, 8, 40, 60, rng)
    arrs = state.to_arrays()
    power = rng.uniform(LTFL.wireless.p_min, LTFL.wireless.p_max, 8)
    deltas = rng.integers(1, 9, 8).astype(np.float64)
    payload = payload_bits_host(V, deltas, LTFL.xi_bits)

    rho_host = controller.optimal_rho(LTFL, state, payload, power)
    rho_dev = optimal_rho_dev(LTFL, arrs, _t(payload), _t(power))
    np.testing.assert_allclose(rho_dev.numpy(), rho_host, atol=1e-5)
    delta_host = controller.optimal_delta(LTFL, state, rho_host, power, V)
    delta_dev = optimal_delta_dev(LTFL, arrs, rho_dev, _t(power), V).numpy()
    # floor() near an integer may round the other way in float32
    assert np.max(np.abs(delta_dev - delta_host)) <= 1
    assert np.mean(delta_dev == delta_host) >= 0.75


def test_theorem_twins_infeasible_budget_clamps(rng):
    tight = LTFLConfig(num_devices=4, samples_min=40, samples_max=60,
                       t_max=1e-3, e_max=1e-6, server_delay=0.0)
    state = ChannelState.sample(tight.wireless, 4, 40, 60, rng)
    arrs = state.to_arrays()
    power = _t(np.full(4, tight.wireless.p_max))
    payload = payload_bits_host(V, np.full(4, 8.0), tight.xi_bits)
    rho_dev = optimal_rho_dev(tight, arrs, _t(payload), power)
    np.testing.assert_allclose(rho_dev.numpy(), np.full(4, tight.rho_max),
                               atol=1e-6)
    delta_dev = optimal_delta_dev(tight, arrs, rho_dev, power, V)
    np.testing.assert_array_equal(delta_dev.numpy(), np.ones(4))
    assert not torch.isnan(rho_dev).any() and not torch.isnan(
        delta_dev).any()


def test_evaluate_dev_matches_host_batched(rng):
    state = ChannelState.sample(LTFL.wireless, 6, 40, 60, rng)
    rsq = rng.uniform(1.0, 50.0, 6)
    rhos = rng.uniform(0.0, 0.4, 6)
    deltas = rng.integers(1, 9, 6).astype(np.float64)
    powers = rng.uniform(LTFL.wireless.p_min, LTFL.wireless.p_max, (5, 6))
    g_host, f_host = controller._evaluate(LTFL, state, rsq, rhos, deltas,
                                          powers, V)
    g_dev, f_dev = evaluate_dev(LTFL, state.to_arrays(), _t(rsq), _t(rhos),
                                _t(deltas), _t(powers), V)
    assert g_dev.shape == (5,) and f_dev.shape == (5,)
    np.testing.assert_allclose(g_dev.numpy(), g_host, rtol=1e-4)
    np.testing.assert_array_equal(f_dev.numpy(), f_host)


# --------------------------------------------------------------------------- #
# Algorithm 1
# --------------------------------------------------------------------------- #
def assert_decisions_close(dev, rho, delta, power, per, gamma):
    """tests/test_device_control.py's tolerances."""
    np.testing.assert_allclose(dev.rho.numpy(), rho, atol=1e-5)
    np.testing.assert_array_equal(dev.delta.numpy(),
                                  np.asarray(delta, np.float64))
    np.testing.assert_allclose(dev.power.numpy(), power, rtol=1e-4)
    np.testing.assert_allclose(dev.per.numpy(), per, atol=1e-6)
    assert float(dev.gamma) == pytest.approx(float(gamma), rel=1e-4)


def _problem(seed):
    state = ChannelState.sample(LTFL.wireless, 6, 40, 60,
                                np.random.default_rng(seed))
    return state, np.full(6, 1e-2 * V)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_dev_pinned_to_host_solve(seed):
    state, rsq = _problem(seed)
    host = controller.solve(LTFL, state, V, range_sq_sums=rsq,
                            rng=np.random.default_rng(seed + 100))
    draws = host_bo_draws(seed + 100, LTFL.alt_max_iters, LTFL.bo_iters, 6)
    dev = solve_dev(LTFL, state.to_arrays(), V, _t(rsq), draws=draws)
    assert_decisions_close(dev, host.rho, host.delta, host.power, host.per,
                           host.gamma)
    assert int(dev.alternations) == host.alternations


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_dev_matches_the_reference_solve_dev(seed):
    state, rsq = _problem(seed)
    ref_state = RefChannelState.sample(RefLTFLConfig(**LTFL_KW).wireless, 6,
                                       40, 60, np.random.default_rng(seed))
    draws = host_bo_draws(seed + 100, LTFL.alt_max_iters, LTFL.bo_iters, 6)
    ref_draws = RefBODraws(*(jnp.asarray(x.numpy()) for x in draws))
    ref = jax.jit(lambda dr: ref_solve_dev(
        RefLTFLConfig(**LTFL_KW), ref_state.to_arrays(), V,
        jnp.asarray(rsq, jnp.float32), draws=dr))(ref_draws)
    dev = solve_dev(LTFL, state.to_arrays(), V, _t(rsq), draws=draws)
    assert_decisions_close(dev, *(np.asarray(x, np.float64) for x in (
        ref.rho, ref.delta, ref.power, ref.per, ref.gamma)))


def test_solve_dev_generator_mode_is_deterministic_and_feasible_shaped():
    state, _ = _problem(5)

    def solve(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return solve_dev(LTFL, state.to_arrays(), V, generator=gen)

    d1, d2 = solve(9), solve(9)
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    rho, delta = d1.rho.numpy(), d1.delta.numpy()
    assert np.all((rho >= 0.0) & (rho <= LTFL.rho_max))
    assert np.all((delta >= 1.0) & (delta <= LTFL.delta_max))
    np.testing.assert_array_equal(delta, np.round(delta))
    p = d1.power.numpy()
    assert np.all((p >= LTFL.wireless.p_min) & (p <= LTFL.wireless.p_max))
    with pytest.raises(ValueError, match="exactly one"):
        solve_dev(LTFL, state.to_arrays(), V)
    with pytest.raises(ValueError, match="exactly one"):
        solve_dev(LTFL, state.to_arrays(), V, generator=torch.Generator(),
                  draws=host_bo_draws(0, 2, 3, 6))


def test_frozen_carry_equals_the_stopped_solve():
    """alt_tol = inf stops the host loop after one alternation (|inf -
    gamma| <= inf); the device solve runs all four and freezes the
    carry, which must give the one-alternation solve's bits."""
    state, rsq = _problem(1)
    stop = dataclasses.replace(LTFL, alt_max_iters=4, alt_tol=float("inf"))
    one = dataclasses.replace(LTFL, alt_max_iters=1)
    draws = host_bo_draws(7, 4, LTFL.bo_iters, 6)
    frozen = solve_dev(stop, state.to_arrays(), V, _t(rsq), draws=draws)
    single = solve_dev(one, state.to_arrays(), V, _t(rsq),
                       draws=BODraws(*(x[:1] for x in draws)))
    for f in ("rho", "delta", "power", "per", "gamma"):
        assert torch.equal(getattr(frozen, f), getattr(single, f)), f
    assert int(frozen.alternations) == int(single.alternations) == 1
    host = controller.solve(stop, state, V, range_sq_sums=rsq,
                            rng=np.random.default_rng(7))
    assert host.alternations == 1
    assert_decisions_close(frozen, host.rho, host.delta, host.power,
                           host.per, host.gamma)
