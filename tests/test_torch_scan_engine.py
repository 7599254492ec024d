"""The scanned engine against the reference and against the port's own
per-round loop.

* The device twins (channel, delay/energy, gamma, payload) against the
  reference's ``_dev`` functions at rtol 1e-6 (both float32 on the CPU;
  the formulas agree op for op, up to how each library rounds a power),
  and against the port's float64 host path at the reference's own
  tolerances (tests/test_scan_engine.py::test_dev_twins_match_host).
* The segment planner equal to the reference's over a grid of recontrol
  cadence, eval cadence, ``max_segment`` and round count.
* ``ScanRunner(rng="host")`` against the reference's ``ScanRunner``: the
  same seed, data and initial MLP weights, the reference's quantizer
  uniforms injected; held to tests/test_scan_engine.py's
  ``assert_history_parity`` tolerances with ``loss_exact=False`` (loss
  rel 1e-5: two frameworks), and the numpy-side fields (cohorts,
  received counts, control means) bitwise.
* ``ScanRunner`` against the port's ``FedRunner``: the same tensor ops on
  the same inputs, so the losses are bitwise equal for stateless schemes
  and for STC (its residual carried through the segment); accounting and
  gamma at the same tolerances. ``max_segment=1`` is the per-round loop,
  and a second ``run`` restarts the round numbering.
* The guards (``control="device"`` with ``rng="host"`` raises, as the
  reference's does), and ``make_scanned_step`` against a loop of its
  step.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.core import channel as ref_channel
from repro.core import convergence as ref_conv
from repro.core import delay_energy as ref_de
from repro.core import quantization as ref_quant
from repro.data import ArrayDataset as RefArrayDataset
from repro.data import synthetic_cifar as ref_synthetic_cifar
from repro.fed import ALL_SCHEMES as REF_SCHEMES
from repro.fed import ScanRunner as RefScanRunner
from repro.fed import UniformSampler as RefUniformSampler
from repro.models.mlp import MLP as RefMLP
from repro.models.mlp import MLPConfig as RefMLPConfig
from repro_torch.configs import LTFLConfig
from repro_torch.core import channel, convergence, delay_energy
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.core.quantization import payload_bits, payload_bits_host
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import (
    ALL_SCHEMES,
    ChannelAwareSampler,
    FedMPScheme,
    FedRunner,
    LTFLScheme,
    ScanRunner,
    UniformSampler,
    make_scanned_step,
)
from repro_torch.models import MLP, MLPConfig, params_to_numpy
from repro_torch.optim import sgd

from torch_parity import jax_uniforms

MLP_KW = dict(hidden=(16,), downsample=4)
LTFL = dict(num_devices=4, samples_min=40, samples_max=60, bo_iters=3,
            alt_max_iters=2)


def assert_history_parity(h_loop, h_scan, *, loss_exact=True):
    """tests/test_scan_engine.py's tolerances, with the numpy-side
    fields bitwise."""
    assert len(h_loop) == len(h_scan)
    for a, b in zip(h_loop, h_scan):
        assert a.round == b.round
        if loss_exact:
            assert a.train_loss == b.train_loss
        else:
            assert a.train_loss == pytest.approx(b.train_loss, rel=1e-5)
        assert a.received == b.received
        assert a.cohort == b.cohort
        assert a.rho_mean == b.rho_mean
        assert a.delta_mean == b.delta_mean
        assert a.power_mean == b.power_mean
        assert a.delay == pytest.approx(b.delay, rel=1e-4)
        assert a.energy == pytest.approx(b.energy, rel=1e-4)
        assert a.cum_delay == pytest.approx(b.cum_delay, rel=1e-4)
        assert a.cum_energy == pytest.approx(b.cum_energy, rel=1e-4)
        assert a.gamma == pytest.approx(b.gamma, rel=1e-3)
        if np.isnan(a.test_acc):
            assert np.isnan(b.test_acc)
        else:
            assert a.test_acc == pytest.approx(b.test_acc, abs=1e-6)


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


def _run(cls, world, scheme, rounds, **kw):
    model, params, train, test = world
    r = cls(model, params, LTFLConfig(**LTFL), train, test, scheme,
            batch_size=8, seed=0, device="cpu", **kw)
    r.run(rounds)
    return r


# --------------------------------------------------------------------------- #
# device twins
# --------------------------------------------------------------------------- #
def _twin_inputs():
    rng = np.random.default_rng(0)
    cfg = LTFLConfig(**LTFL)
    state = channel.ChannelState.sample(cfg.wireless, 8, 40, 60, rng)
    return dict(
        cfg=cfg, state=state,
        power=rng.uniform(cfg.wireless.p_min, cfg.wireless.p_max, 8),
        payload=rng.uniform(1e5, 1e7, 8), rho=rng.uniform(0.0, 0.5, 8),
        rsq=rng.uniform(1.0, 100.0, 8),
        deltas=rng.integers(1, 9, 8).astype(float),
        pi=rng.uniform(0.2, 1.0, 8))


def _twin(name, lib, x):
    """Twin ``name`` evaluated by ``lib`` ("port" or "ref") in float32."""
    cfg, state = x["cfg"], x["state"]
    if lib == "port":
        mod = {"channel": channel, "de": delay_energy, "conv": convergence}
        ch, rcfg = state.to_arrays(), cfg

        def arr(v):
            return torch.as_tensor(np.asarray(v, np.float32))
    else:
        mod = {"channel": ref_channel, "de": ref_de, "conv": ref_conv}
        rcfg = RefLTFLConfig(**LTFL)
        ch = ref_channel.ChannelState(
            **dataclasses.asdict(state)).to_arrays()

        def arr(v):
            return jnp.asarray(np.asarray(v, np.float32))
    w = rcfg.wireless
    p, pay, rho = arr(x["power"]), arr(x["payload"]), arr(x["rho"])
    if name == "expected_rate":
        return mod["channel"].expected_rate_dev(w, ch, p)
    if name == "packet_error_rate":
        return mod["channel"].packet_error_rate_dev(w, ch, p)
    if name == "device_round_delay":
        return mod["de"].device_round_delay_dev(w, ch, pay, rho, p)
    if name == "device_round_energy":
        return mod["de"].device_round_energy_dev(w, ch, pay, rho, p)
    if name == "round_accounting":
        return np.asarray(mod["de"].round_accounting_dev(
            rcfg, ch, pay, rho, p))
    pers = mod["channel"].packet_error_rate_dev(w, ch, p)
    g = (arr(x["rsq"]), arr(x["deltas"]), rho, pers, ch.num_samples)
    if name == "gamma":
        return mod["conv"].gamma_dev(rcfg, *g)
    if name == "gamma_unbiased":
        return mod["conv"].gamma_dev(
            rcfg, *g, inclusion=arr(x["pi"]),
            population_samples=float(np.sum(state.num_samples) * 2))
    raise KeyError(name)


def _host(name, x):
    """The port's float64 host path for twin ``name``."""
    cfg, state = x["cfg"], x["state"]
    w = cfg.wireless
    args = (x["payload"], x["rho"], x["power"])
    if name == "expected_rate":
        return channel.expected_rate(w, state, x["power"])
    if name == "packet_error_rate":
        return channel.packet_error_rate(w, state, x["power"])
    if name == "device_round_delay":
        return delay_energy.device_round_delay(w, state, *args)
    if name == "device_round_energy":
        return delay_energy.device_round_energy(w, state, *args)
    if name == "round_accounting":
        return np.asarray([delay_energy.round_delay(cfg, state, *args),
                           delay_energy.round_energy(cfg, state, *args)])
    pers = channel.packet_error_rate(w, state, x["power"])
    g = (x["rsq"], x["deltas"], x["rho"], pers, state.num_samples)
    if name == "gamma":
        return convergence.gamma(cfg, *g)
    return convergence.gamma(
        cfg, *g, inclusion=x["pi"],
        population_samples=float(np.sum(state.num_samples) * 2))


TWINS = ["expected_rate", "packet_error_rate", "device_round_delay",
         "device_round_energy", "round_accounting", "gamma",
         "gamma_unbiased"]
# the reference's own tolerances against the host path
HOST_TOL = {"packet_error_rate": dict(rtol=1e-4, atol=1e-7)}


@pytest.mark.parametrize("name", TWINS)
def test_dev_twin_matches_reference_and_host(name):
    x = _twin_inputs()
    port = np.asarray(_twin(name, "port", x), np.float64)
    ref = np.asarray(_twin(name, "ref", x), np.float64)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(port, _host(name, x),
                               **HOST_TOL.get(name, dict(rtol=1e-4)))


def test_payload_bits_one_float32_formula():
    """The tensor and numpy halves give the same float32 numbers, and
    the reference's."""
    bits = np.array([1.0, 3.0, 8.0, 0.0])
    dev = payload_bits(4_901_450, torch.tensor(bits), 64)
    host = payload_bits_host(4_901_450, bits, 64)
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy().astype(np.float64), host)
    np.testing.assert_array_equal(
        host, ref_quant.payload_bits_host(4_901_450, bits, 64))


def test_sample_transmissions_and_fading_draws():
    """The device draws follow the host distributions: alpha is
    Bernoulli(1 - q) (8000 draws per device: 5 standard errors), fading
    is fading_scale * Exp(1) and interference uniform on its range."""
    x = _twin_inputs()
    w, state = x["cfg"].wireless, x["state"]
    ch = state.to_arrays()
    gen = torch.Generator()
    gen.manual_seed(0)
    power = torch.as_tensor(x["power"], dtype=torch.float32)
    draws = torch.stack([channel.sample_transmissions_dev(w, ch, power, gen)
                         for _ in range(8000)]).numpy()
    q = channel.packet_error_rate(w, state, x["power"])
    assert set(np.unique(draws)) <= {0.0, 1.0}
    np.testing.assert_array_less(
        np.abs(draws.mean(0) - (1.0 - q)),
        5 * np.sqrt(np.maximum(q * (1 - q), 1e-4) / 8000))
    fading, interference = channel.draw_fading_dev(w, gen, 20000)
    assert fading.dtype == torch.float32
    assert float(fading.mean()) == pytest.approx(w.fading_scale, rel=0.03)
    assert float(interference.min()) >= w.interference_min
    assert float(interference.max()) <= w.interference_max


# --------------------------------------------------------------------------- #
# the segment planner
# --------------------------------------------------------------------------- #
def _planner(rc, ev, max_segment):
    scheme = types.SimpleNamespace(scan_recontrol_every=lambda runner: rc)
    return types.SimpleNamespace(control="host", _ctl_program=None,
                                 scheme=scheme, eval_every=ev,
                                 max_segment=max_segment)


@pytest.mark.parametrize("rc", [0, 1, 3])
def test_segment_spans_match_reference(rc):
    for ev in (0, 1, 2, 5):
        for max_segment in (None, 1, 4):
            for rounds in (1, 7, 12):
                fake = _planner(rc, ev, max_segment)
                assert ScanRunner._segment_spans(fake, 0, rounds) == \
                    RefScanRunner._segment_spans(fake, 0, rounds), \
                    (rc, ev, max_segment, rounds)


# --------------------------------------------------------------------------- #
# against the reference's ScanRunner
# --------------------------------------------------------------------------- #
REF_CASES = {
    "ltfl": ("ltfl", dict(recontrol_every=2), dict(eval_every=0)),
    "fedsgd-unbiased": ("fedsgd", {}, dict(
        eval_every=2, population_size=7, cohort_size=4,
        participation="unbiased")),
}


@pytest.mark.parametrize("case", list(REF_CASES))
def test_scan_host_rng_matches_reference(world, case):
    scheme, skw, kw = REF_CASES[case]
    model, params, train, test = world
    ref_kw = dict(kw)
    port_kw = dict(kw)
    if "population_size" in kw:
        ref_kw["cohort_sampler"] = RefUniformSampler()
        port_kw["cohort_sampler"] = UniformSampler()
    imgs, labels = ref_synthetic_cifar(600, seed=0)
    timgs, tlabels = ref_synthetic_cifar(128, seed=1)
    ref = RefScanRunner(RefMLP(RefMLPConfig(**MLP_KW)),
                        params_to_numpy(params), RefLTFLConfig(**LTFL),
                        RefArrayDataset({"images": imgs, "labels": labels}),
                        RefArrayDataset({"images": timgs,
                                         "labels": tlabels}),
                        REF_SCHEMES[scheme](**skw), batch_size=8, seed=0,
                        **ref_kw)
    ref.run(4)
    port = ScanRunner(model, params, LTFLConfig(**LTFL), train, test,
                      ALL_SCHEMES[scheme](**skw), batch_size=8, seed=0,
                      device="cpu", uniforms=jax_uniforms, **port_kw)
    port.run(4)
    assert_history_parity(ref.history, port.history, loss_exact=False)
    assert port.np_rng.bit_generator.state == ref.np_rng.bit_generator.state
    np.testing.assert_allclose(port._range_sq_pop, ref._range_sq_pop,
                               rtol=1e-4)


# --------------------------------------------------------------------------- #
# against the port's own FedRunner
# --------------------------------------------------------------------------- #
LOOP_CASES = {
    "fedsgd-eval2": (lambda: ALL_SCHEMES["fedsgd"](), dict(eval_every=2)),
    "signsgd": (lambda: ALL_SCHEMES["signsgd"](), dict(eval_every=0)),
    "ltfl-recontrol2-fading": (lambda: LTFLScheme(recontrol_every=2),
                               dict(eval_every=0, block_fading=True)),
    "stc": (lambda: ALL_SCHEMES["stc"](), dict(eval_every=0)),
    "fedsgd-max-segment-1": (lambda: ALL_SCHEMES["fedsgd"](),
                             dict(eval_every=0, max_segment=1)),
    "fedmp": (lambda: FedMPScheme(), dict(eval_every=0)),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_scan_matches_fedrunner(world, case):
    factory, kw = LOOP_CASES[case]
    loop_kw = {k: v for k, v in kw.items() if k != "max_segment"}
    loop = _run(FedRunner, world, factory(), 5, **loop_kw)
    scan = _run(ScanRunner, world, factory(), 5, **kw)
    assert_history_parity(loop.history, scan.history)
    np.testing.assert_array_equal(loop._range_sq_pop, scan._range_sq_pop)
    for k, v in loop.params.items():
        assert torch.equal(v, scan.params[k]), k
    if case == "stc":                    # the residual through the segment
        for k, v in loop.comp_state.items():
            assert torch.equal(v, scan.comp_state[k]), k
    if kw.get("max_segment") == 1 or case == "fedmp":
        # FedMP re-decides every round: length-1 segments under host
        # control, as the reference plans them
        assert all(b - a == 1 for a, b in scan._segment_spans(0, 5))
    if case == "ltfl-recontrol2-fading":
        assert scan._segment_spans(0, 5) == [(0, 2), (2, 4), (4, 5)]
        assert scan.channel_epoch == loop.channel_epoch == 5
        np.testing.assert_array_equal(scan.channel.fading_mean,
                                      loop.channel.fading_mean)


def test_repeated_run_restarts_rounds_like_fedrunner(world):
    loop = _run(FedRunner, world, ALL_SCHEMES["fedsgd"](), 2, eval_every=0)
    scan = _run(ScanRunner, world, ALL_SCHEMES["fedsgd"](), 2,
                eval_every=0)
    loop.run(2)
    scan.run(2)
    assert_history_parity(loop.history, scan.history)
    assert [r.round for r in scan.history] == [0, 1, 0, 1]


def test_scan_guards(world):
    model, params, train, test = world
    cfg = LTFLConfig(**LTFL)

    def make(scheme=None, **kw):
        return ScanRunner(model, params, cfg, train, test,
                          scheme or ALL_SCHEMES["fedsgd"](), batch_size=8,
                          device="cpu", **kw)

    # the reference's guard: device control needs the device rng stream
    with pytest.raises(ValueError, match="rng='device'"):
        make(control="device", rng="host")
    with pytest.raises(ValueError, match="rng='device'"):
        RefScanRunner(RefMLP(RefMLPConfig(**MLP_KW)),
                      params_to_numpy(params), RefLTFLConfig(**LTFL), train,
                      test, REF_SCHEMES["fedsgd"](), batch_size=8,
                      control="device", rng="host")
    with pytest.raises(ValueError, match="A7"):
        make(population_sharding=2, rng="device")
    with pytest.raises(ValueError, match="rng="):
        make(rng="numpy")
    with pytest.raises(ValueError, match="max_segment"):
        make(max_segment=0)

    class HostOnly(UniformSampler):
        def device_twin(self, runner):
            return None

    with pytest.raises(ValueError, match="device_twin"):
        make(rng="device", population_size=8, cohort_size=4,
             cohort_sampler=HostOnly())
    with pytest.raises(ValueError, match="inclusion"):
        make(rng="device", population_size=8, cohort_size=4,
             cohort_sampler=ChannelAwareSampler(),
             participation="unbiased")
    with pytest.raises(ValueError, match="host-recontrol"):
        make(LTFLScheme(), rng="device", population_size=8, cohort_size=4)
    with pytest.warns(UserWarning, match="eval_every=1"):
        make().run(2)


# --------------------------------------------------------------------------- #
# make_scanned_step
# --------------------------------------------------------------------------- #
def test_make_scanned_step_matches_loop(world):
    model, params, train, _ = world
    C, B, R = 3, 4, 5
    opt = sgd(0.1)
    step = make_fl_train_step(model, opt, C, prune_kind="magnitude")
    n = R * C * B
    imgs = torch.from_numpy(train.arrays["images"][:n]).reshape(
        R, C, B, 32, 32, 3)
    labels = torch.from_numpy(train.arrays["labels"][:n]).reshape(R, C, B)
    controls = {"rho": torch.tensor([0.0, 0.2, 0.4]),
                "delta": torch.tensor([8.0, 4.0, 2.0]),
                "weights": torch.ones(C), "drop_prob": torch.full((C,), 0.3)}
    p_l, o_l, c_l = params, opt.init(params), step.init_comp_state(params)
    losses = []
    for r in range(R):
        p_l, o_l, c_l, m = step(p_l, o_l, c_l, {"images": imgs[r],
                                                "labels": labels[r]},
                                controls, r)
        losses.append(m["loss"])
    p_s, _, _, ms = make_scanned_step(step)(
        params, opt.init(params), step.init_comp_state(params),
        {"images": imgs, "labels": labels}, controls, list(range(R)))
    assert ms["loss"].shape == (R,)
    assert torch.equal(ms["loss"], torch.stack(losses))
    for k, v in p_l.items():
        assert torch.equal(v, p_s[k]), k
