"""The port's buffered-async engine against the reference's
(``repro.fed.async_engine``).

* ``ChurnSpec``'s validation: the same values pass and fail, with the
  same messages.
* ``buffered_round_accounting_dev`` against the reference's on seeded
  (U,) inputs at rtol 1e-6 (both float32 on the CPU, as the other device
  twins in tests/test_torch_scan_engine.py): a filled buffer, a round
  the deadline closes, and an infinite deadline; and its degenerate case
  (all admitted, K = U, no deadline) bitwise the port's
  ``round_accounting_dev``, for a (U,) view and a lane bucket's (L, U).
* ``AsyncRunner(rng="host")`` against the reference's ``AsyncRunner``
  with a finite deadline, K < U and churn: the same seed, data and MLP
  weights (carried across as numpy), the reference's quantizer uniforms
  injected. The cohorts, the churn masks, the admissions, tau,
  ``n_admitted`` and ``received`` are bitwise the reference's (numpy
  streams on both sides, and admission decided on float32 completion
  times that both compute alike); the losses within rel 1e-5 (two
  frameworks) and delay, energy and gamma within rel 1e-6. The test
  fails, rather than passing by luck, if a completion time lies within
  1e-5 relative of the deadline or two arrivals nearly tie at the K-th
  rank, where float32 rounding could decide admission.
"""
import dataclasses

import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.core import channel as ref_channel
from repro.core import delay_energy as ref_de
from repro.data import ArrayDataset as RefArrayDataset
from repro.data import synthetic_cifar as ref_synthetic_cifar
from repro.fed import ALL_SCHEMES as REF_SCHEMES
from repro.fed import AsyncRunner as RefAsyncRunner
from repro.fed import ChurnSpec as RefChurnSpec
from repro.fed import UniformSampler as RefUniformSampler
from repro.models.mlp import MLP as RefMLP
from repro.models.mlp import MLPConfig as RefMLPConfig
from repro_torch.configs import LTFLConfig
from repro_torch.core import channel, delay_energy
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import (
    ALL_SCHEMES,
    AsyncRunner,
    ChurnSpec,
    UniformSampler,
)
from repro_torch.models import MLP, MLPConfig, params_to_numpy

from torch_parity import jax_uniforms

MLP_KW = dict(hidden=(16,), downsample=4)
LTFL = dict(num_devices=4, samples_min=40, samples_max=60, bo_iters=3,
            alt_max_iters=2)
ROUNDS = 6
NEAR = 1e-5          # relative margin for the deadline and the K-th rank


# --------------------------------------------------------------------------- #
# ChurnSpec
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    {}, dict(p_depart=0.1, p_return=0.5, p_drop=0.05),
    dict(p_depart=1.0, p_return=0.0), dict(p_depart=1.5),
    dict(p_return=-0.1), dict(p_drop=2.0)])
def test_churn_spec_validation_matches_reference(kw):
    errors = []
    for cls in (ChurnSpec, RefChurnSpec):
        try:
            spec = cls(**kw)
        except ValueError as err:
            errors.append(str(err))
        else:
            errors.append(None)
            assert dataclasses.asdict(spec) == {
                "p_depart": 0.0, "p_return": 0.0, "p_drop": 0.0, **kw}
            with pytest.raises(dataclasses.FrozenInstanceError):
                spec.p_drop = 0.5
    assert errors[0] == errors[1]


# --------------------------------------------------------------------------- #
# buffered_round_accounting_dev
# --------------------------------------------------------------------------- #
def _accounting_inputs(u=8):
    rng = np.random.default_rng(3)
    cfg = LTFLConfig(**LTFL)
    state = channel.ChannelState.sample(cfg.wireless, u, 40, 60, rng)
    return dict(
        cfg=cfg, state=state,
        power=rng.uniform(cfg.wireless.p_min, cfg.wireless.p_max, u),
        payload=rng.uniform(1e5, 1e7, u), rho=rng.uniform(0.0, 0.5, u))


def _completion(x):
    return delay_energy.device_round_delay(
        x["cfg"].wireless, x["state"], x["payload"], x["rho"], x["power"])


# admitted mask, deadline, buffer size, as functions of the inputs'
# sorted completion times t
ACCOUNTING_CASES = {
    # the 3 fastest admitted, K = 3: the buffer fills at the 3rd
    "filled": lambda t: (t <= np.sort(t)[2], np.inf, 3),
    # 4 arrive before the deadline, K = 6: the deadline closes the round
    "deadline": lambda t: (t <= np.sort(t)[3],
                           0.5 * (np.sort(t)[3] + np.sort(t)[4]), 6),
    # no deadline and K = U with one dropped: the last completion
    "inf": lambda t: (t != np.sort(t)[1], np.inf, len(t)),
}


@pytest.mark.parametrize("case", list(ACCOUNTING_CASES))
def test_buffered_accounting_matches_reference(case):
    x = _accounting_inputs()
    admitted, deadline, k = ACCOUNTING_CASES[case](_completion(x))
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    port = delay_energy.buffered_round_accounting_dev(
        x["cfg"], x["state"].to_arrays(), torch.from_numpy(f32(x["payload"])),
        torch.from_numpy(f32(x["rho"])), torch.from_numpy(f32(x["power"])),
        torch.from_numpy(admitted), deadline, k)
    ref = ref_de.buffered_round_accounting_dev(
        RefLTFLConfig(**LTFL),
        ref_channel.ChannelState(**dataclasses.asdict(x["state"])).to_arrays(),
        jnp.asarray(f32(x["payload"])), jnp.asarray(f32(x["rho"])),
        jnp.asarray(f32(x["power"])), jnp.asarray(admitted),
        jnp.float32(deadline), k)
    for p, r in zip(port, ref):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6)
    if case == "deadline":
        assert float(port[0]) == pytest.approx(
            deadline + x["cfg"].server_delay, rel=1e-6)


@pytest.mark.parametrize("lanes", [None, 3])
def test_buffered_accounting_degenerate_is_sync_bitwise(lanes):
    """All admitted, K = U, no deadline: ``round_accounting_dev``'s
    (delay, energy) bitwise, for a (U,) view and a bucket's (L, U) under
    a laned server delay."""
    x = _accounting_inputs()
    ch = x["state"].to_arrays()
    cfg = x["cfg"]
    args = [torch.from_numpy(np.asarray(x[k], np.float32))
            for k in ("payload", "rho", "power")]
    if lanes is not None:
        ch = channel.ChannelArrays.stack([ch] * lanes)
        args = [torch.stack([a * (1.0 + 0.1 * j) for j in range(lanes)])
                for a in args]
        cfg = dataclasses.replace(cfg)
        object.__setattr__(cfg, "server_delay", torch.tensor(
            [[1.0], [2.0], [0.5]]))
    u = ch.num_samples.shape[-1]
    admitted = torch.ones(ch.num_samples.shape, dtype=torch.bool)
    sync = delay_energy.round_accounting_dev(cfg, ch, *args)
    buffered = delay_energy.buffered_round_accounting_dev(
        cfg, ch, *args, admitted, float("inf"), u)
    for s, b in zip(sync, buffered[:2]):
        assert s.shape == b.shape == (() if lanes is None else (lanes,))
        assert torch.equal(s, b)


# --------------------------------------------------------------------------- #
# AsyncRunner(rng="host") against the reference
# --------------------------------------------------------------------------- #
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


# scheme, scheme kwargs, runner kwargs, buffer size, churn, and where the
# deadline goes: between the d-th and (d+1)-th fastest of the population
# (None: no deadline)
PARITY_CASES = {
    # partial participation with HT weights: the deadline, the buffer
    # and churn all mask, and the inclusion is scaled by n_admitted / U
    "fedsgd-unbiased": ("fedsgd", {}, dict(
        population_size=7, cohort_size=4, participation="unbiased"),
        2, (0.2, 0.5, 0.1), 4),
    # LTFL's quantizer (the reference's uniforms injected) under the
    # buffer and churn
    "ltfl": ("ltfl", {}, {}, 3, (0.15, 0.5, 0.1), None),
}


def _record_masks(runner, out):
    """Wrap ``_prepare_host_segment`` to keep each segment's churn masks
    (the replayed rows' ``alive_c`` and ``drop``) as numpy."""
    inner = runner._prepare_host_segment

    def wrapped(a, b):
        res = inner(a, b)
        xs = res[0]
        out.append((np.asarray(xs["alive_c"]), np.asarray(xs["drop"])))
        return res
    runner._prepare_host_segment = wrapped


def _population_completion(runner):
    """Each registered device's completion time under the run's (fixed)
    controls, float64 on the host: the channel is static (no block
    fading) and the controls are those of every round."""
    ctl = runner.scheme.controls(0)
    payload = np.asarray(runner.scheme.payload_bits(ctl), np.float64)
    view = runner.population.view(runner.cohort)
    t_cohort = delay_energy.device_round_delay(
        runner.ltfl.wireless, view, payload, ctl.rho, ctl.power)
    if runner.cohort_size == runner.population_size:
        return t_cohort
    # uniform controls (FedSGD): one value each for the whole population
    assert np.all(ctl.rho == ctl.rho[0]) and np.all(ctl.power == ctl.power[0])
    return delay_energy.device_round_delay(
        runner.ltfl.wireless, runner.population.channel, payload[0],
        ctl.rho[0], ctl.power[0])


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_async_host_rng_matches_reference(world, case):
    scheme, skw, kw, k, churn, slot = PARITY_CASES[case]
    model, params, train, test = world
    ref_kw, port_kw = dict(kw), dict(kw)
    if "population_size" in kw:
        ref_kw["cohort_sampler"] = RefUniformSampler()
        port_kw["cohort_sampler"] = UniformSampler()
    common = dict(batch_size=8, seed=0, eval_every=0, buffer_size=k)
    # the deadline between two devices' completion times, read from a
    # probe runner (the controls do not depend on it for FedSGD; LTFL's
    # case has none)
    deadline = float("inf")
    if slot is not None:
        probe = AsyncRunner(model, params, LTFLConfig(**LTFL), train, test,
                            ALL_SCHEMES[scheme](**skw), device="cpu",
                            **common, **port_kw)
        t = np.sort(_population_completion(probe))
        deadline = float(0.5 * (t[slot - 1] + t[slot]))
    port = AsyncRunner(model, params, LTFLConfig(**LTFL), train, test,
                       ALL_SCHEMES[scheme](**skw), device="cpu",
                       uniforms=jax_uniforms, deadline=deadline,
                       churn=ChurnSpec(*churn), **common, **port_kw)
    imgs, labels = ref_synthetic_cifar(600, seed=0)
    timgs, tlabels = ref_synthetic_cifar(128, seed=1)
    ref = RefAsyncRunner(RefMLP(RefMLPConfig(**MLP_KW)),
                         params_to_numpy(params), RefLTFLConfig(**LTFL),
                         RefArrayDataset({"images": imgs, "labels": labels}),
                         RefArrayDataset({"images": timgs,
                                          "labels": tlabels}),
                         REF_SCHEMES[scheme](**skw), deadline=deadline,
                         churn=RefChurnSpec(*churn), **common, **ref_kw)
    masks_port, masks_ref = [], []
    _record_masks(port, masks_port)
    _record_masks(ref, masks_ref)
    h_port, h_ref = port.run(ROUNDS), ref.run(ROUNDS)

    # admission must not hinge on float32 rounding: no completion time
    # near the deadline, no near-tie at the K-th arrival
    t_pop = _population_completion(port)
    full = port.cohort_size == port.population_size
    alive = np.concatenate([m[0] for m in masks_port])
    drop = np.concatenate([m[1] for m in masks_port])
    for i, rec in enumerate(h_port):
        cohort = np.arange(port.cohort_size) if full else \
            np.asarray(rec.cohort)
        t = t_pop[cohort] if not full else t_pop
        if np.isfinite(deadline):
            assert np.all(np.abs(t - deadline) > NEAR * deadline), \
                (i, t, deadline)
        arrived = np.sort(t[alive[i] & ~drop[i] & (t <= deadline)])
        if arrived.size > k:
            assert arrived[k] - arrived[k - 1] > NEAR * arrived[k], \
                (i, arrived)

    # numpy-side and admission fields: bitwise
    assert len(masks_port) == len(masks_ref)
    for (ap, dp), (ar, dr) in zip(masks_port, masks_ref):
        np.testing.assert_array_equal(ap, ar)
        np.testing.assert_array_equal(dp, dr)
    assert len(port.async_history) == len(ref.async_history) == ROUNDS
    for p, r in zip(port.async_history, ref.async_history):
        assert p["round"] == r["round"]
        np.testing.assert_array_equal(p["admitted"], r["admitted"])
        np.testing.assert_array_equal(p["tau"], r["tau"])
        assert p["n_admitted"] == r["n_admitted"]
    np.testing.assert_array_equal(port.staleness, ref.staleness)
    for p, r in zip(h_port, h_ref):
        assert (p.round, p.cohort, p.received, p.rho_mean, p.delta_mean,
                p.power_mean, p.staleness) == \
            (r.round, r.cohort, r.received, r.rho_mean, r.delta_mean,
             r.power_mean, r.staleness)
        assert p.train_loss == pytest.approx(r.train_loss, rel=1e-5)
        for f in ("delay", "energy", "gamma", "cum_delay", "cum_energy"):
            assert getattr(p, f) == pytest.approx(getattr(r, f), rel=1e-6), f
    # the case masks something: some round admits fewer than U, some
    # device goes stale, churn departs or drops someone
    assert min(a["n_admitted"] for a in port.async_history) < \
        port.cohort_size
    assert max(rec.staleness for rec in h_port) > 0.0
    assert not (alive.all() and not drop.any())
    if np.isfinite(deadline):
        assert np.any(t_pop > deadline)
    assert port.np_rng.bit_generator.state == ref.np_rng.bit_generator.state
