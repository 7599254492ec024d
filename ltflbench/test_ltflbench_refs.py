"""The plain references agree with the port at small sizes on the CPU: the
language model's loss and gradients (granite-8b cut by the port's
``reduce_for_smoke``), a narrow ResNet's, and one whole LTFL step of
the language model; Algorithm 1 and the host's draws of an edge run
against the port's controller at the paper's 30 devices; and the
reference's ranking and quantizer on hand-worked values."""
import sys

import pytest
import torch

from ltflbench import harness
from ltflbench import manifest as mf
from ltflbench.refs import lm, ltfl, resnet

sys.path.insert(0, str(mf.REPO / "src"))
torch.set_num_threads(1)

SMOKE_LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=256, rope_theta=1e7)
SMOKE_RESNET = dict(image_size=32, in_channels=3, num_classes=10,
                    stem_channels=8, group_channels=[8, 16, 32, 32],
                    blocks_per_group=[1, 1, 1, 1])


def _port_lm(dtype):
    from repro_torch import configs
    from repro_torch.models import build_model
    arch = configs.reduce_for_smoke(configs.get_arch("granite-8b"))
    arch = arch.replace(**SMOKE_LM)
    return build_model(arch), arch


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_lm_loss_and_grads_match_the_port(dtype, tol):
    model, _ = _port_lm(dtype)
    params = harness.make_weights(lm.spec(SMOKE_LM), 5, dtype,
                                  torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, 256, (2, 24), generator=gen)
    batch = {"tokens": tok, "labels": tok}
    want = torch.func.grad_and_value(model.loss)(params, batch)
    got = torch.func.grad_and_value(
        lambda p, b: lm.loss(p, b, SMOKE_LM))(params, batch)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=tol)
    for k in params:
        a, b = got[0][k].float(), want[0][k].float()
        assert float((a - b).norm()) <= tol * float(b.norm()) + 1e-12, k


def test_resnet_loss_and_grads_match_the_port():
    from repro_torch.configs import ResNetConfig
    from repro_torch.models import ResNet
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in SMOKE_RESNET.items()}
    model = ResNet(ResNetConfig(**cfg))
    params = harness.make_weights(resnet.spec(SMOKE_RESNET), 3,
                                  torch.float32, torch.device("cpu"))
    gen = torch.Generator().manual_seed(2)
    batch = {"images": torch.rand((6, 32, 32, 3), generator=gen) * 2 - 1,
             "labels": torch.randint(0, 10, (6,), generator=gen,
                                     dtype=torch.int32)}
    want = torch.func.grad_and_value(model.loss)(params, batch)
    got = torch.func.grad_and_value(
        lambda p, b: resnet.loss(p, b, SMOKE_RESNET))(params, batch)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-5)
    for k in params:
        a, b = got[0][k], want[0][k]
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-9, k


def test_ltfl_step_matches_the_port_step():
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.optim import sgd
    model, _ = _port_lm(torch.float32)
    params = harness.make_weights(lm.spec(SMOKE_LM), 9, torch.float32,
                                  torch.device("cpu"))
    c = 3
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, 256, (c, 2, 16), generator=gen)
    batch = {"tokens": tok, "labels": tok}
    controls = {"rho": torch.tensor([0.25, 0.1, 0.5]),
                "delta": torch.tensor([8.0, 4.0, 0.0]),
                "drop_prob": torch.full((c,), 0.3),
                "weights": torch.tensor([500.0, 400.0, 600.0])}
    step = make_fl_train_step(model, sgd(0.05), c, prune_block=16,
                              prune_kind="block")
    p, _, _, m = step(params, (), step.init_comp_state(params), batch,
                      controls, 77)
    got, loss, _ = ltfl.step(
        params, [{"tokens": tok[i], "labels": tok[i]} for i in range(c)],
        controls, 77, 0.05, lambda w, x: lm.loss(w, x, SMOKE_LM), "block",
        16)
    assert float(loss) == pytest.approx(float(m["loss"]), rel=1e-5)
    for k in params:
        d = (got[k] - params[k]).norm()
        assert float((got[k] - p[k]).norm()) <= 1e-3 * float(d) + 1e-7, k


def test_ranked_keep_breaks_ties_by_position():
    scores = torch.tensor([[3.0, 1.0], [1.0, 2.0]])
    keep = ltfl.ranked_keep(scores, torch.tensor([0.0, 0.5, 0.75, 1.0]))
    assert keep[0].all()
    assert keep[1].tolist() == [[True, False], [False, True]]
    assert keep[2].tolist() == [[True, False], [False, False]]
    assert not keep[3].any()


def test_quantize_by_hand():
    g = torch.tensor([[0.0, -1.0, 0.5, 0.25]])
    rand = torch.tensor([[0.9, 0.9, 0.9, 0.4]])
    # 2 bits: 3 levels over [0, 1], spacing 1/3; 0.25 = 0.75 of a step,
    # up where rand < 0.75; 0.5 = 1.5 steps, up where rand < 0.5
    q = ltfl.quantize(g, torch.tensor([2.0]), rand)
    assert q[0].tolist() == pytest.approx([0.0, -1.0, 1 / 3, 1 / 3])
    assert ltfl.quantize(g, torch.tensor([0.0]), rand).equal(g)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_algorithm1_matches_the_port_controller(seed):
    import json
    import numpy as np
    from repro_torch.configs import LTFLConfig
    from repro_torch.configs.base import WirelessConfig
    from repro_torch.core import controller
    from repro_torch.core.channel import ChannelState
    from ltflbench.refs import algorithm1
    cf = json.loads((mf.HERE / "configs" / "ltfl-resnet-table2.json")
                    .read_text())
    v = 4_901_450
    stream = algorithm1.HostStream(cf, seed, v)
    state = stream.rng.bit_generator.state
    want = stream.alg.solve(stream.dev, stream.range_sq, stream.rng)
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    d = stream.dev
    got = controller.solve(
        LTFLConfig(**{**cf["ltfl"], "wireless": WirelessConfig(
            **cf["wireless"])}),
        ChannelState(d.distance, d.fading, d.interference, d.cpu,
                     d.samples), v, range_sq_sums=stream.range_sq, rng=rng)
    gaps = algorithm1.decision_gaps(got, want, cf["ltfl"], cf["wireless"])
    assert max(gaps.values()) <= 1e-12, gaps
    assert 0 < float(np.mean(want.rho)) < cf["ltfl"]["rho_max"]
