"""The port's FedRunner + LTFLScheme against the reference's, 3 rounds.

Same seed, same data and initial weights (numpy, handed to both), and
the reference's quantizer uniforms injected into the port. Everything the
host numpy stream decides (cohort, Algorithm-1 controls, packet outcomes)
and everything charged from it (delay, energy) must be bitwise equal;
the tensor results within float32 tolerance: loss and gamma rel 1e-3
(gamma reads the measured gradient ranges), accuracy within 0.01.
"""
import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax

from repro.data import ArrayDataset as RefArrayDataset
from repro.data import synthetic_cifar as ref_synthetic_cifar
from repro.fed import FedRunner as RefFedRunner
from repro.fed import LTFLScheme as RefLTFLScheme
from repro.models.resnet import ResNet as RefResNet
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import FedRunner, LTFLScheme
from repro_torch.models import ResNet, params_from_numpy

from torch_parity import (
    BATCH,
    initial_weights,
    jax_uniforms,
    port_ltfl,
    port_resnet_config,
    ref_ltfl,
    ref_resnet_config,
    tree_numpy,
)

ROUNDS = 3


def _data(lib_cifar, lib_ds):
    imgs, labels = lib_cifar(3000, seed=0)
    timgs, tlabels = lib_cifar(200, seed=1)
    return (lib_ds({"images": imgs, "labels": labels}),
            lib_ds({"images": timgs, "labels": tlabels}))


def test_synthetic_cifar_bitwise():
    a = synthetic_cifar(64, seed=3)
    b = ref_synthetic_cifar(64, seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def histories():
    ref_model = RefResNet(ref_resnet_config())
    ref_params = initial_weights()
    ref_train, ref_test = _data(ref_synthetic_cifar, RefArrayDataset)
    ref = RefFedRunner(ref_model, ref_params, ref_ltfl(), ref_train,
                       ref_test, RefLTFLScheme(), batch_size=BATCH, seed=0)
    ref.run(ROUNDS)

    train, test = _data(synthetic_cifar, ArrayDataset)
    port = FedRunner(ResNet(port_resnet_config()),
                     params_from_numpy(ref_params), port_ltfl(),
                     train, test, LTFLScheme(), batch_size=BATCH, seed=0,
                     device="cpu", uniforms=jax_uniforms)
    port.run(ROUNDS)
    return ref, port


def test_host_decisions_bitwise(histories):
    ref, port = histories
    np.testing.assert_array_equal(port.cohort, ref.cohort)
    d_ref, d_port = ref.scheme._decision, port.scheme._decision
    for field in ("rho", "delta", "power", "per"):
        np.testing.assert_array_equal(getattr(d_port, field),
                                      getattr(d_ref, field), err_msg=field)
    assert d_port.gamma == d_ref.gamma
    assert port.num_params == ref.num_params
    # the numpy stream ends in the same state
    assert port.np_rng.bit_generator.state == ref.np_rng.bit_generator.state


def test_history_accounting_bitwise(histories):
    ref, port = histories
    assert len(port.history) == len(ref.history) == ROUNDS
    for rp, rr in zip(port.history, ref.history):
        for field in ("round", "delay", "energy", "cum_delay",
                      "cum_energy", "received", "rho_mean", "delta_mean",
                      "power_mean", "cohort", "participation"):
            assert getattr(rp, field) == getattr(rr, field), field


def test_history_tensor_results_close(histories):
    ref, port = histories
    for rp, rr in zip(port.history, ref.history):
        assert np.isfinite(rp.train_loss)
        np.testing.assert_allclose(rp.train_loss, rr.train_loss, rtol=1e-3)
        np.testing.assert_allclose(rp.gamma, rr.gamma, rtol=1e-3)
        assert abs(rp.test_acc - rr.test_acc) <= 0.01


def test_final_weights_close(histories):
    ref, port = histories
    ref_w = params_from_numpy(tree_numpy(ref.params))
    assert list(port.params) == list(ref_w)
    for k, v in ref_w.items():
        np.testing.assert_allclose(port.params[k].numpy(), v.numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


def test_runner_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    train, test = _data(synthetic_cifar, ArrayDataset)
    model = ResNet(port_resnet_config())
    gen = torch.Generator()
    gen.manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedRunner(model, model.init(gen), port_ltfl(), train, test,
                  LTFLScheme(), batch_size=BATCH)


@pytest.mark.parametrize("kw", [
    dict(block_fading=True),
    dict(population_size=7, cohort_size=4, participation="unbiased"),
])
def test_host_round_inputs_bitwise(kw):
    """Everything the host decides per round under block fading (with
    per-round recontrol) and under partial participation (cohort draws,
    Horvitz-Thompson weights): cohort, controls, weights, batch indices,
    the round seed (the reference's PRNGKey seed) and the packet outcomes
    — without running a step."""
    ref_train, ref_test = _data(ref_synthetic_cifar, RefArrayDataset)
    train, test = _data(synthetic_cifar, ArrayDataset)
    params = initial_weights()
    ref = RefFedRunner(RefResNet(ref_resnet_config()), params, ref_ltfl(),
                       ref_train, ref_test, RefLTFLScheme(recontrol_every=1),
                       batch_size=BATCH, seed=3, **kw)
    port = FedRunner(ResNet(port_resnet_config()), params_from_numpy(params),
                     port_ltfl(), train, test, LTFLScheme(recontrol_every=1),
                     batch_size=BATCH, seed=3, device="cpu", **kw)
    for rnd in range(3):
        hr, hp = ref._host_round_inputs(rnd), port._host_round_inputs(rnd)
        np.testing.assert_array_equal(hp.cohort, hr.cohort)
        for f in ("rho", "delta", "power"):
            np.testing.assert_array_equal(getattr(hp.ctl, f),
                                          getattr(hr.ctl, f))
        np.testing.assert_array_equal(hp.weights, hr.weights)
        assert hp.agg_denom == hr.agg_denom
        np.testing.assert_array_equal(hp.batch_idx, hr.batch_idx)
        np.testing.assert_array_equal(
            np.asarray(jax.random.PRNGKey(hp.seed)), np.asarray(hr.key))
        np.testing.assert_array_equal(hp.alpha, hr.alpha)
        np.testing.assert_array_equal(port.channel.fading_mean,
                                      ref.channel.fading_mean)
    assert port.np_rng.bit_generator.state == ref.np_rng.bit_generator.state
