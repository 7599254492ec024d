"""The port's ResNet and round step against the reference's.

* ResNet loss, accuracy and gradients on the same (numpy-made) weights:
  rtol 1e-4, atol 1e-6 — the convolutions sum in another order.
* One ``make_fl_train_step`` (magnitude pruning, host alpha) against the
  reference step with ``use_kernels=True`` (as tests/test_round_engine.py
  runs it), the reference's uniforms injected. Gradients differ in the
  last bits, so per-client ranges do too, and an element whose
  continuous level sits at a rounding boundary may flip by one
  quantization step: as tests/test_kernels.py allows, a < 1e-3 fraction
  of update entries may differ by up to one step; the rest agree to
  rtol 1e-3 of the update's scale.
"""
import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.core.ltfl_step import make_fl_train_step as ref_make_step
from repro.data import synthetic_cifar
from repro.models.resnet import ResNet as RefResNet
from repro.optim import sgd as ref_sgd
from repro_torch.core.compressors import ltfl_quantizer
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.models import ResNet, params_from_numpy
from repro_torch.optim import sgd

from torch_parity import (
    BATCH,
    initial_weights,
    jax_uniforms,
    port_resnet_config,
    ref_resnet_config,
)

C = 4
LR = 0.05


@pytest.fixture(scope="module")
def world():
    tree = initial_weights()
    imgs, labels = synthetic_cifar(C * BATCH, seed=5)
    return tree, imgs, labels


def test_resnet_loss_grads_accuracy(world):
    tree, imgs, labels = world
    ref_model, model = RefResNet(ref_resnet_config()), \
        ResNet(port_resnet_config())
    rb = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    tb = {"images": torch.from_numpy(imgs), "labels": torch.from_numpy(labels)}
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    rl, rg = jax.jit(jax.value_and_grad(ref_model.loss))(ref_params, rb)
    params = params_from_numpy(tree)
    tg, tl = torch.func.grad_and_value(model.loss)(params, tb)
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-4)
    rg = params_from_numpy(jax.tree_util.tree_map(np.asarray, rg))
    assert list(tg) == list(rg) and len(tg) == 31
    for k in rg:
        np.testing.assert_allclose(tg[k].numpy(), rg[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(model.accuracy(params, tb)) == float(
        jax.jit(ref_model.accuracy)(ref_params, rb))


def test_paper_width_structure():
    """The default config is the paper's model: 32 leaves, 4,901,450
    parameters, in the reference's leaf order."""
    specs = ResNet().param_specs()
    assert len(specs) == 32
    assert sum(int(np.prod(s.shape)) for s in specs.values()) == 4_901_450
    names = list(specs)
    assert names[0] == "groups.0.0.conv1" and names[-1] == "stem"
    assert names.index("head_b") < names.index("head_gn.beta") \
        < names.index("head_w")


def test_round_step_matches_reference(world):
    """One step with every optional control in play: a fixed aggregation
    denominator, a learning rate tensor, a dropped client and a delta = 0
    passthrough (the default path is held by tests/test_torch_slice.py)."""
    tree, imgs, labels = world
    batch_np = {"images": imgs.reshape(C, BATCH, *imgs.shape[1:]),
                "labels": labels.reshape(C, BATCH)}
    controls_np = {
        "rho": np.array([0.0, 0.2, 0.35, 0.5], np.float32),
        "delta": np.array([8.0, 4.0, 0.0, 2.0], np.float32),
        "weights": np.array([410.0, 520.0, 600.0, 455.0], np.float32),
        "alpha": np.array([1.0, 0.0, 1.0, 1.0], np.float32),
        "agg_denom": np.float32(4000.0),
        "lr": np.float32(0.03),
    }
    seed = 424242

    ref_step = jax.jit(ref_make_step(
        RefResNet(ref_resnet_config()), ref_sgd(LR), C,
        prune_kind="magnitude", compressor="ltfl", use_kernels=True,
        simulate_drops=False))
    rp, _, _, rm = ref_step(jax.tree_util.tree_map(jnp.asarray, tree), (),
                            (), jax.tree_util.tree_map(jnp.asarray,
                                                       batch_np),
                            {k: jnp.asarray(v) for k, v in
                             controls_np.items()},
                            jax.random.PRNGKey(seed))

    step = make_fl_train_step(ResNet(port_resnet_config()), sgd(LR), C,
                              prune_kind="magnitude",
                              compressor=ltfl_quantizer(
                                  uniforms=jax_uniforms))
    params = params_from_numpy(tree)
    tp, _, _, tm = step(params, (), (),
                        {k: torch.from_numpy(v) for k, v in
                         batch_np.items()},
                        {k: torch.as_tensor(v) for k, v in
                         controls_np.items()}, seed)

    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tm["range_sq"].numpy(),
                               np.asarray(rm["range_sq"]), rtol=1e-4)
    assert float(tm["clients_received"]) == float(rm["clients_received"])
    rp = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp))
    lr = float(controls_np["lr"])
    for k, v0 in params.items():
        upd_ref = (rp[k].numpy() - v0.numpy()) / lr
        upd = (tp[k].numpy() - v0.numpy()) / lr
        diff = np.abs(upd - upd_ref)
        scale = float(np.abs(upd_ref).max()) + 1e-12
        off = diff > 1e-3 * scale
        assert off.mean() < 1e-3, (k, off.mean())
        # a flip moves one client's entry by one of its steps, weighted
        # by that client's share of the aggregate: never more than scale
        assert diff.max() <= scale, k
