"""The port's ``momentum`` and ``adamw`` against the reference's.

The same weights and 5 steps of seeded gradients (numpy, float32 values)
go through both sides as float32 trees and as bfloat16 trees (the state
leaves are float32 on both sides either way). Checked each step:

* the updates and the float32 state leaves within rel 1e-6 / atol 1e-7
  (float32 arithmetic; ``b ** t`` and the square root are library calls
  that may round differently by an ulp); a bfloat16 update may then sit
  one bf16 ulp apart where the float32 value lies at a rounding tie;
* AdamW's step count ``t``: equal, int32, on the parameters' device;
* ``update_with_lr`` at the constructor's rate as a float32 tensor:
  bitwise ``update`` (what lets a sweep lane its learning rate), and
  ``step.lanes`` with laned rates bitwise each lane's solo step.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.optim import adamw as ref_adamw
from repro.optim import apply_updates as ref_apply
from repro.optim import momentum as ref_momentum
from repro_torch.optim import (
    adamw,
    apply_updates,
    global_norm,
    momentum,
    sgd,
)

SHAPES = {"w": (16, 24), "b": (24,), "emb": (3, 8, 8)}
STEPS = 5
OPTS = {                        # name: (kind, lr, keyword arguments)
    "momentum": ("momentum", 0.05, {}),
    "momentum_beta": ("momentum", 0.02, {"beta": 0.5}),
    "adamw": ("adamw", 0.05, {}),
    "adamw_decay": ("adamw", 0.01, {"b2": 0.99, "weight_decay": 0.1}),
}
MAKERS = {"momentum": (ref_momentum, momentum), "adamw": (ref_adamw, adamw)}


def _tree(rng, scale):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got, want, where, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=where)
        return
    # bf16: the float32 values agree to 1e-6, so at most one bf16 ulp
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp), where


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(0)
    p0 = _tree(rng, 0.5)
    kind, lr, kw = OPTS[name]
    ref_opt, opt = (f(lr, **kw) for f in MAKERS[kind])
    rp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(dtype) for k, v in p0.items()}
    rs, ts = ref_opt.init(rp), opt.init(tp)
    for i in range(STEPS):
        g = _tree(rng, 0.1)
        rg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(dtype) for k, v in g.items()}
        rupd, rs = ref_opt.update(rg, rs, rp)
        upd, ts_new = opt.update(tg, ts, tp)
        lanes_upd, lanes_state = opt.update_with_lr(
            tg, ts, tp, torch.tensor(lr, dtype=torch.float32))
        for k in SHAPES:
            assert upd[k].dtype == dtype, k
            _close(upd[k], rupd[k], f"{name} step {i} update {k}", dtype)
            assert torch.equal(upd[k], lanes_upd[k]), (name, i, k)
            for s in ("m", "v"):
                if s in rs:
                    assert ts_new[s][k].dtype == torch.float32
                    _close(ts_new[s][k], rs[s][k],
                           f"{name} step {i} {s} {k}", torch.float32)
                    assert torch.equal(ts_new[s][k], lanes_state[s][k])
        if "t" in rs:
            assert ts_new["t"].dtype == torch.int32
            assert ts_new["t"].shape == ()
            assert int(ts_new["t"]) == int(rs["t"]) == i + 1
        ts = ts_new
        rp = ref_apply(rp, rupd)
        # carry the reference's weights across, so each step is compared
        # from the same point
        tp = {k: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32)))
              .to(dtype) for k, v in rp.items()}


@pytest.mark.parametrize("opt_fn", [lambda: sgd(0.1),
                                    lambda: momentum(0.02),
                                    lambda: adamw(0.05)],
                         ids=["sgd", "momentum", "adamw"])
def test_optimizers_minimize_quadratic(opt_fn):
    """The twin of tests/test_data_optim_ckpt.py's test."""
    opt = opt_fn()
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    losses = []
    for _ in range(200):
        g = {"w": 2.0 * params["w"]}
        upd, state = opt.update(g, state, params)
        params = apply_updates(params, upd)
        losses.append(float(torch.sum(params["w"] ** 2)))
    assert min(losses) < 5e-2, min(losses)
    assert float(global_norm(params)) ** 2 == pytest.approx(losses[-1])


@pytest.mark.parametrize("make", [lambda: momentum(0.05),
                                  lambda: adamw(0.05, weight_decay=0.01)],
                         ids=["momentum", "adamw"])
def test_laned_learning_rates_match_solo_steps(make):
    """Two sweep lanes with their own learning rates through
    ``step.lanes`` (the step's ``controls["lr"]``): each lane's weights
    and optimizer state bitwise its solo step's at its rate."""
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.models import MLP, MLPConfig

    model = MLP(MLPConfig(hidden=(8,), downsample=4))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    c = 2
    batch = {"images": torch.randn(c, 4, 32, 32, 3, generator=gen),
             "labels": torch.randint(0, 10, (c, 4), generator=gen)}
    opt = make()
    step = make_fl_train_step(model, opt, c, prune_kind="magnitude")
    lrs = (0.05, 0.02)
    ctl = [{"rho": torch.tensor([0.2, 0.3]), "delta": torch.tensor([4., 8.]),
            "weights": torch.tensor([10., 12.]),
            "alpha": torch.tensor([1., 1.]),
            "lr": torch.tensor(lr)} for lr in lrs]
    state = opt.init(params)
    p_l, o_l, _, _ = step.lanes(
        [params, params], [state, state], (),
        {k: torch.cat([v, v]) for k, v in batch.items()}, ctl, [3, 4])
    for i in range(2):
        p1, o1, _, _ = step(params, state, (), batch, ctl[i], 3 + i)
        for k in params:
            assert torch.equal(p_l[i][k], p1[k]), (i, k)
            assert torch.equal(o_l[i]["m"][k], o1["m"][k]), (i, k)
    # and the baked rate of lane 0 is the laned one, bitwise
    baked = {k: v for k, v in ctl[0].items() if k != "lr"}
    p2, o2, _, _ = step(params, state, (), batch, baked, 3)
    for k in params:
        assert torch.equal(p2[k], p_l[0][k]), k
