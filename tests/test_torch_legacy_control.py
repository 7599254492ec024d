"""The scalar Algorithm 1 and the leftover host names against the
reference.

* ``sample_devices``: bitwise the reference's devices on the same seeds
  (one device at a time, its draw order);
* ``solve_reference`` at U = 7, ``LTFLConfig(bo_iters=5,
  alt_max_iters=3)`` (tests/test_control_vectorized.py's setting):
  every ``ControlDecision`` field bitwise the reference's on the same
  seeds, and the port's vectorized ``solve`` within the tolerances that
  file holds the reference's two to;
* ``_evaluate_reference`` against ``_evaluate`` on a (K, U) batch of
  power vectors (its tolerances too);
* ``theorem1_bound``, ``importance``, ``pruning_error_bound``,
  ``ArrayDataset.subset`` and ``FedRunner.devices`` against the
  reference's, bitwise; ``actual_pruning_error`` within rel 1e-6 (a
  float32 sum of each leaf, reduced in another order by each side).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.configs.base import WirelessConfig as RefWirelessConfig
from repro.core import channel as rch
from repro.core import controller as rctl
from repro.core import convergence as rconv
from repro.core import pruning as rpr
from repro.data import ArrayDataset as RefArrayDataset
from repro_torch.configs.base import LTFLConfig, WirelessConfig
from repro_torch.core import channel, controller, convergence, pruning
from repro_torch.data import ArrayDataset

V = 300_000
U = 7
SETTINGS = dict(bo_iters=5, alt_max_iters=3)


def _devices(seed, u=U, lo=400, hi=600):
    return (rch.sample_devices(RefWirelessConfig(), u, lo, hi,
                               np.random.default_rng(seed)),
            channel.sample_devices(WirelessConfig(), u, lo, hi,
                                   np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_sample_devices_bitwise(seed):
    ref, got = _devices(seed, u=12, lo=40, hi=60)
    assert isinstance(got, tuple) and len(got) == 12
    for r, d in zip(ref, got):
        assert isinstance(d, channel.DeviceChannel)
        for f in ("distance", "fading_mean", "interference", "cpu_hz",
                  "num_samples"):
            assert getattr(d, f) == getattr(r, f), f
            assert type(getattr(d, f)) is type(getattr(r, f)), f


def _assert_decisions_equal(a, b):
    np.testing.assert_array_equal(a.rho, b.rho)
    np.testing.assert_array_equal(a.delta, b.delta)
    assert a.delta.dtype == b.delta.dtype
    np.testing.assert_array_equal(a.power, b.power)
    np.testing.assert_array_equal(a.per, b.per)
    np.testing.assert_array_equal(a.gamma_trace, b.gamma_trace)
    assert a.gamma == b.gamma
    assert a.alternations == b.alternations


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_solve_reference_bitwise_and_matches_solve(seed):
    ref_devs, devs = _devices(seed)
    ref = rctl.solve_reference(RefLTFLConfig(**SETTINGS), ref_devs, V,
                               rng=np.random.default_rng(seed + 100))
    got = controller.solve_reference(LTFLConfig(**SETTINGS), devs, V,
                                     rng=np.random.default_rng(seed + 100))
    _assert_decisions_equal(got, ref)
    # a ChannelState is split into devices, as in the reference
    via_state = controller.solve_reference(
        LTFLConfig(**SETTINGS), channel.ChannelState.from_devices(devs), V,
        rng=np.random.default_rng(seed + 100))
    _assert_decisions_equal(via_state, ref)
    # the vectorized solve, within tests/test_control_vectorized.py's
    # tolerances
    vec = controller.solve(LTFLConfig(**SETTINGS),
                           channel.ChannelState.from_devices(devs), V,
                           rng=np.random.default_rng(seed + 100))
    np.testing.assert_array_equal(got.delta, vec.delta)
    np.testing.assert_allclose(got.rho, vec.rho, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.power, vec.power, rtol=1e-12)
    np.testing.assert_allclose(got.per, vec.per, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.gamma_trace, vec.gamma_trace,
                               rtol=1e-10)
    assert vec.gamma == pytest.approx(got.gamma, rel=1e-10)
    assert vec.alternations == got.alternations


def test_solve_reference_default_prior_and_rng():
    """No range masses and no rng: the 1e-2 V prior and the config's
    seed, as the reference."""
    ref_devs, devs = _devices(5)
    ref = rctl.solve_reference(RefLTFLConfig(**SETTINGS), ref_devs, V)
    got = controller.solve_reference(LTFLConfig(**SETTINGS), devs, V)
    _assert_decisions_equal(got, ref)


def test_evaluate_reference_matches_batched_evaluate():
    ref_devs, devs = _devices(2)
    rng = np.random.default_rng(4)
    cfg = LTFLConfig(**SETTINGS)
    w = cfg.wireless
    k = 6
    rsqs = np.full(U, 1e-2 * V)
    rhos = rng.uniform(0.0, 0.5, U)
    deltas = rng.integers(1, 9, U)
    p_mat = rng.uniform(w.p_min, w.p_max, (k, U))
    state = channel.ChannelState.from_devices(devs)
    g_b, f_b = controller._evaluate(cfg, state, rsqs, rhos, deltas, p_mat,
                                    V)
    for j in range(k):
        g_r, f_r = controller._evaluate_reference(cfg, devs, rsqs, rhos,
                                                  deltas, p_mat[j], V)
        assert g_b[j] == pytest.approx(g_r, rel=1e-12)
        assert bool(f_b[j]) == f_r
        # and bitwise the reference's scalar evaluation
        assert (g_r, f_r) == rctl._evaluate_reference(
            RefLTFLConfig(**SETTINGS), ref_devs, rsqs, rhos, deltas,
            p_mat[j], V)
    # a budget no device meets: infeasible on both
    tight = LTFLConfig(t_max=1e-3, **SETTINGS)
    assert not controller._evaluate_reference(tight, devs, rsqs, rhos,
                                              deltas, p_mat[0], V)[1]


def test_theorem1_bound_matches_reference():
    cfg, ref_cfg = LTFLConfig(), RefLTFLConfig()
    for gammas in ([], [0.5], [0.3, 0.2, 0.9, 1.7]):
        assert convergence.theorem1_bound(cfg, 2.5, gammas) \
            == rconv.theorem1_bound(ref_cfg, 2.5, gammas)


def test_pruning_leftovers_match_reference():
    rng = np.random.default_rng(0)
    w = {"a": rng.standard_normal((16, 24)).astype(np.float32),
         "b": rng.standard_normal((24,)).astype(np.float32)}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    for k in w:
        np.testing.assert_array_equal(pruning.importance(tw[k]).numpy(),
                                      np.asarray(rpr.importance(jw[k])))
    for rho in (0.0, 0.3, 0.9):
        assert pruning.pruning_error_bound(rho, 7.5) \
            == float(rpr.pruning_error_bound(rho, 7.5))
        pruned, _ = pruning.magnitude_prune_pytree(tw, rho)
        jpruned, _ = rpr.magnitude_prune_pytree(jw, rho)
        err = pruning.actual_pruning_error(tw, pruned)
        assert err.dtype == torch.float32
        # the masks are bitwise; each leaf's float32 sum runs in another
        # order on each side (seen rel 2.3e-7)
        assert float(err) == pytest.approx(
            float(rpr.actual_pruning_error(jw, jpruned)), rel=1e-6)
        # Lemma 2 with D^2 = ||w||^2
        d_sq = sum(float((v * v).sum()) for v in tw.values())
        assert float(err) <= pruning.pruning_error_bound(rho, d_sq) + 1e-5


def test_array_dataset_subset_matches_reference():
    arrays = {"x": np.arange(10), "y": np.arange(10) * 2}
    idx = np.array([1, 3, 3, 8])
    sub, ref = (ArrayDataset(arrays).subset(idx),
                RefArrayDataset(arrays).subset(idx))
    assert isinstance(sub, ArrayDataset) and sub.size == ref.size == 4
    for k in arrays:
        np.testing.assert_array_equal(sub.arrays[k], ref.arrays[k])


def test_fed_runner_devices_matches_reference():
    """The legacy ``devices`` view of the cohort, on both runners built
    from the same seed: bitwise the reference's tuple, and what
    ``solve_reference`` takes."""
    from repro.fed.rounds import FedRunner as RefFedRunner
    from repro.fed.schemes import FedSGDScheme as RefFedSGD
    from repro.models.mlp import MLP as RefMLP
    from repro.models.mlp import MLPConfig as RefMLPConfig
    from repro_torch.fed import FedRunner
    from repro_torch.fed.schemes import FedSGDScheme
    from torch_parity import mlp_world

    model, params, train, test = mlp_world()
    kw = dict(num_devices=4, samples_min=40, samples_max=60, **SETTINGS)
    runner = FedRunner(model, params, LTFLConfig(**kw), train, test,
                       FedSGDScheme(), batch_size=4, seed=0, device="cpu")
    ref_model = RefMLP(RefMLPConfig(hidden=(16,), downsample=4))
    ref_params = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    ref_runner = RefFedRunner(
        ref_model, ref_params, RefLTFLConfig(**kw),
        RefArrayDataset(train.arrays), RefArrayDataset(test.arrays),
        RefFedSGD(), batch_size=4, seed=0)
    devs, ref_devs = runner.devices, ref_runner.devices
    assert isinstance(devs, tuple) and len(devs) == 4
    assert [vars(d) for d in devs] == [vars(d) for d in ref_devs]
    dec = controller.solve_reference(LTFLConfig(**kw), devs,
                                     runner.num_params)
    ref = rctl.solve_reference(RefLTFLConfig(**kw), ref_devs,
                               ref_runner.num_params)
    _assert_decisions_equal(dec, ref)
