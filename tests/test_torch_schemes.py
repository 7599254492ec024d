"""The paper's four baselines, the sign and STC compressors, the
channel- and energy-aware samplers and the MLP against the reference.

``FedRunner`` histories of FedSGD, SignSGD, FedMP and STC on the MLP
(hidden 16, 8x8x3 inputs), 4 devices, 7 rounds (FedMP's bandit pulls
each of its 5 arms once, then runs its UCB branch), plus FedMP under
partial participation (7 registered devices, cohorts of 4 from the
energy-aware sampler, Horvitz-Thompson weights). Same seed, data and
initial weights on both sides. Everything the host numpy stream decides
and charges must be bitwise equal: cohort, rho / delta / power, received,
delay, energy, FedMP's arm choices and counts, and the stream's final
state. Tensor results within float32 tolerance: loss and gamma rel 1e-4,
accuracy within 0.01, final weights rel 1e-4 / abs 1e-5, FedMP's
rewards (loss decreases over delays) rel 1e-3 with abs 1e-12 (a decrease
of two near-equal losses keeps only their float32 difference).

Compressors on one stacked batch: sign exactly; STC's kept entries and
signs exactly (ties included), its values and residual after two steps
rel 1e-6 (the per-row mean of the kept magnitudes is summed in another
order). Samplers: cohorts, inclusion probabilities and rng states
bitwise (host numpy on both sides).
"""
import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.core import compressors as ref_comp
from repro.data import ArrayDataset as RefArrayDataset
from repro.data import synthetic_cifar as ref_synthetic_cifar
from repro.fed import ALL_SCHEMES as REF_SCHEMES
from repro.fed import FedRunner as RefFedRunner
from repro.fed import population as ref_pop
from repro.models.mlp import MLP as RefMLP
from repro.models.mlp import MLPConfig as RefMLPConfig
from repro_torch.configs import LTFLConfig
from repro_torch.core import compressors as comp
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import ALL_SCHEMES, FedRunner
from repro_torch.fed import population as pop
from repro_torch.models import MLP, MLPConfig, params_from_numpy, \
    params_to_numpy

from torch_parity import tree_numpy

ROUNDS = 7
MLP_KW = dict(hidden=(16,), downsample=4)
LTFL = dict(num_devices=4, bo_iters=4, alt_max_iters=2)
CASES = {
    "fedsgd": ("fedsgd", {}),
    "signsgd": ("signsgd", {}),
    "fedmp": ("fedmp", {}),
    "stc": ("stc", {}),
    "fedmp-energy-aware": ("fedmp", dict(population_size=7, cohort_size=4,
                                         participation="unbiased")),
}


def _data(lib_cifar, lib_ds):
    imgs, labels = lib_cifar(3000, seed=0)
    timgs, tlabels = lib_cifar(200, seed=1)
    return (lib_ds({"images": imgs, "labels": labels}),
            lib_ds({"images": timgs, "labels": tlabels}))


def _initial_weights():
    gen = torch.Generator()
    gen.manual_seed(0)
    return params_to_numpy(MLP(MLPConfig(**MLP_KW)).init(gen))


@pytest.fixture(scope="module", params=list(CASES))
def histories(request):
    scheme, kw = CASES[request.param]
    if "population_size" in kw:
        ref_kw = dict(kw, cohort_sampler=ref_pop.EnergyAwareSampler())
        port_kw = dict(kw, cohort_sampler=pop.EnergyAwareSampler())
    else:
        ref_kw = port_kw = kw
    params = _initial_weights()
    ref_train, ref_test = _data(ref_synthetic_cifar, RefArrayDataset)
    ref = RefFedRunner(RefMLP(RefMLPConfig(**MLP_KW)), params,
                       RefLTFLConfig(**LTFL), ref_train, ref_test,
                       REF_SCHEMES[scheme](), batch_size=4, seed=0,
                       **ref_kw)
    ref.run(ROUNDS)
    train, test = _data(synthetic_cifar, ArrayDataset)
    port = FedRunner(MLP(MLPConfig(**MLP_KW)), params_from_numpy(params),
                     LTFLConfig(**LTFL), train, test, ALL_SCHEMES[scheme](),
                     batch_size=4, seed=0, device="cpu", **port_kw)
    port.run(ROUNDS)
    return ref, port


def test_scheme_host_decisions_bitwise(histories):
    ref, port = histories
    assert port.scheme.name == ref.scheme.name
    assert len(port.history) == len(ref.history) == ROUNDS
    for rp, rr in zip(port.history, ref.history):
        for field in ("round", "delay", "energy", "cum_delay",
                      "cum_energy", "received", "rho_mean", "delta_mean",
                      "power_mean", "cohort", "participation"):
            assert getattr(rp, field) == getattr(rr, field), field
    np.testing.assert_array_equal(port.cohort, ref.cohort)
    assert port.np_rng.bit_generator.state == ref.np_rng.bit_generator.state
    if port.scheme.name == "fedmp":
        np.testing.assert_array_equal(port.scheme._choice,
                                      ref.scheme._choice)
        np.testing.assert_array_equal(port.scheme._counts,
                                      ref.scheme._counts)
        assert port.scheme._counts.sum() == ROUNDS * port.num_devices
        np.testing.assert_allclose(port.scheme._rewards,
                                   ref.scheme._rewards, rtol=1e-3,
                                   atol=1e-12)


def test_scheme_tensor_results_close(histories):
    ref, port = histories
    for rp, rr in zip(port.history, ref.history):
        assert np.isfinite(rp.train_loss)
        np.testing.assert_allclose(rp.train_loss, rr.train_loss, rtol=1e-4)
        np.testing.assert_allclose(rp.gamma, rr.gamma, rtol=1e-4)
        assert abs(rp.test_acc - rr.test_acc) <= 0.01
    ref_w = params_from_numpy(tree_numpy(ref.params))
    assert list(port.params) == list(ref_w)
    for k, v in ref_w.items():
        np.testing.assert_allclose(port.params[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    if port.scheme.name == "stc":
        for k, v in tree_numpy(ref.comp_state).items():
            np.testing.assert_allclose(port.comp_state[k].numpy(), v,
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def _stacked_grads(seed=0, n_clients=3):
    """A stacked (C, ...) gradient dict with exact ties: values on a
    1/64 grid, so many entries share a magnitude."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 40), "b": (7,), "c": (2, 3, 3, 4)}
    return {k: (np.round(rng.standard_normal((n_clients,) + s) * 8) / 64)
            .astype(np.float32) for k, s in shapes.items()}


def test_sign_compressor_matches_reference():
    g = _stacked_grads()
    c, rc = comp.sign_compressor(0.03), ref_comp.sign_compressor(0.03)
    wire, _ = c.compress({k: torch.from_numpy(v) for k, v in g.items()},
                         torch.zeros(3), 0, ())
    ref_wire, _ = jax.vmap(lambda gi: rc.compress(gi, 0.0, None, ()))(
        {k: jnp.asarray(v) for k, v in g.items()})
    agg = {k: torch.from_numpy(v[0] - v[1]) for k, v in g.items()}
    out = c.server_transform(agg)
    ref_out = rc.server_transform({k: jnp.asarray(v.numpy())
                                   for k, v in agg.items()})
    for k in g:
        np.testing.assert_array_equal(wire[k].numpy(),
                                      np.asarray(ref_wire[k]))
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref_out[k]))
    assert comp.get_compressor("sign", lr_scale=0.03).name == "sign"


@pytest.mark.parametrize("sparsity", [0.01, 0.1, 0.5])
def test_stc_compressor_matches_reference_two_steps(sparsity):
    c, rc = comp.stc_compressor(sparsity), ref_comp.stc_compressor(sparsity)
    g0 = _stacked_grads(0)
    params = {k: torch.zeros(v.shape[1:]) for k, v in g0.items()}
    state = c.init_state(params, 3)
    ref_state = rc.init_state({k: jnp.zeros(v.shape[1:])
                               for k, v in g0.items()}, 3)
    ref_step = jax.vmap(lambda gi, r: rc.compress(gi, 0.0, None, r))
    for seed in (0, 1):
        g = _stacked_grads(seed)
        wire, state = c.compress({k: torch.from_numpy(v)
                                  for k, v in g.items()},
                                 torch.zeros(3), seed, state)
        ref_wire, ref_state = ref_step({k: jnp.asarray(v)
                                        for k, v in g.items()}, ref_state)
        for k in g:
            w, rw = wire[k].numpy(), np.asarray(ref_wire[k])
            np.testing.assert_array_equal(np.sign(w), np.sign(rw),
                                          err_msg=k)
            np.testing.assert_allclose(w, rw, rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(state[k].numpy(),
                                       np.asarray(ref_state[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            # per client row: k = max(int(sparsity * leaf size), 1) kept
            # at least, every tie of the threshold kept too
            size = int(np.prod(w.shape[1:]))
            kept = (w.reshape(3, -1) != 0).sum(axis=1)
            assert (kept >= max(int(sparsity * size), 1)).all()


def test_compressor_registry():
    assert comp.get_compressor("none").name == "none"
    assert comp.get_compressor("stc", sparsity=0.1).name == "stc"
    ltfl = comp.ltfl_quantizer()
    assert comp.get_compressor(ltfl) is ltfl
    with pytest.raises(KeyError, match="unknown compressor"):
        comp.get_compressor("topk")


def _populations(n, seed):
    ref_ltfl, ltfl = RefLTFLConfig(**LTFL), LTFLConfig(**LTFL)
    w_ref, w = ref_ltfl.wireless, ltfl.wireless
    p_ref = ref_pop.Population.sample(w_ref, n, ref_ltfl.samples_min,
                                      ref_ltfl.samples_max,
                                      np.random.default_rng(seed))
    p = pop.Population.sample(w, n, ltfl.samples_min, ltfl.samples_max,
                              np.random.default_rng(seed))
    return (p_ref, ref_ltfl), (p, ltfl)


@pytest.mark.parametrize("sampler", [
    "channel", "channel-explore", "energy"])
def test_samplers_bitwise(sampler):
    (p_ref, ref_ltfl), (p, ltfl) = _populations(40, seed=5)
    make = {
        "channel": lambda m: m.ChannelAwareSampler(),
        "channel-explore": lambda m: m.ChannelAwareSampler(power=0.05,
                                                           explore=0.25),
        "energy": lambda m: m.EnergyAwareSampler(),
    }[sampler]
    s_ref, s = make(ref_pop), make(pop)
    rng_ref, rng = np.random.default_rng(9), np.random.default_rng(9)
    for rnd, u in enumerate((8, 8, 12, 40)):
        i_ref, pi_ref = s_ref.select(p_ref, u, rnd, rng_ref, ref_ltfl)
        i, pi = s.select(p, u, rnd, rng, ltfl)
        np.testing.assert_array_equal(i, i_ref)
        assert i.dtype == np.int64 and (np.diff(i) > 0).all()
        if pi_ref is None:
            assert pi is None
        else:
            np.testing.assert_array_equal(pi, pi_ref)
    assert rng.bit_generator.state == rng_ref.bit_generator.state


@pytest.mark.parametrize("n,k", [(12, 1), (12, 5), (30, 29), (9, 9)])
def test_gumbel_topk_inclusion_bitwise(n, k):
    """Bitwise the reference's, and its analytic pins at the reference
    test's weights and tolerances (tests/test_population.py)."""
    w = np.random.default_rng(n * 100 + k).uniform(0.2, 3.0, n)
    pi = pop.gumbel_topk_inclusion(w, k)
    np.testing.assert_array_equal(pi, ref_pop.gumbel_topk_inclusion(w, k))
    assert pi.sum() == pytest.approx(min(k, n), rel=1e-4)
    if k == 1:
        np.testing.assert_allclose(pi, w / w.sum(), rtol=1e-10)


@pytest.mark.parametrize("kw", [dict(), dict(hidden=(16, 8), downsample=4)])
def test_mlp_forward_and_loss_match_reference(kw):
    model, ref_model = MLP(MLPConfig(**kw)), RefMLP(RefMLPConfig(**kw))
    gen = torch.Generator()
    gen.manual_seed(1)
    params = model.init(gen)
    ref_params = jax.tree_util.tree_map(jnp.asarray,
                                        params_to_numpy(params))
    assert {k: v.shape for k, v in ref_model.init(
        jax.random.PRNGKey(0)).items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    imgs, labels = synthetic_cifar(16, seed=2)
    batch = {"images": torch.from_numpy(imgs),
             "labels": torch.from_numpy(labels)}
    ref_batch = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    np.testing.assert_allclose(
        model.apply(params, batch["images"]).numpy(),
        np.asarray(ref_model.logits(ref_params, ref_batch)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(model.loss(params, batch)),
                               float(ref_model.loss(ref_params, ref_batch)),
                               rtol=1e-5)
    assert float(model.accuracy(params, batch)) == \
        float(ref_model.accuracy(ref_params, ref_batch))
