"""The sharded LTFL step (``param_shardings`` / ``gather_shardings``) on
a real (2, 4) mesh of 8 gloo ranks, against the unsharded step, on its
whole-weight path: the path of every family but the dense one, asked for
here with ``tensor_parallel=False`` (the dense family's tensor-parallel
path is held in ``test_torch_tensor_parallel.py``).

Reduced granite-8b (float32, 2 layers, width 256) with its clients on
'data' and its weights on 'model' by the rule table; each client's 4
rows are split over the 4 'model' ranks, so the gradients meet in a
reduce-scatter, the quantizer's ranges in all-reduces, the aggregate in
an all-reduce over 'data', and the int8 levels in an all-gather over
'data'. The weights are pruned on their shards (tile norms all-gathered
for the ranking, the pruned shards all-gathered), or whole where a shard
would cut a tile (``CASES``). The plain versions of the three kernels run on the CPU. Both
steps get the same weights, batch and injected uniforms.

Tolerance: the sharded gradient of a client is a mean of four row
gradients where the unsharded one sums all rows at once, so the two
differ by float32 rounding (a stochastic level could flip where that
rounding crosses a level boundary; none does in the "sgd" case, one
would at block 128, see ``CASES``). Losses
and range sums agree to 1e-5 relative, every updated weight to 1e-7
absolute (measured: at most 1.5e-8 with the quantizer, bitwise with the
int8 wire format, whose aggregate every rank sums itself).
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.registry import build_model, make_train_batch
from repro_torch.optim import sgd

C, ROWS, SEQ, BLOCK, LR, SEED = 2, 4, 16, 64, 0.05, 11
# (uplink, prune block): at 64 every tileable leaf is pruned on its
# 'model' shards; at 128 the 256-wide leaves' 64-wide shards would cut
# tiles, so those leaves are gathered and pruned whole beside the
# 512-wide ones pruned on their shards. That case sends its gradients
# unquantized: with the quantizer one level of embed.head flips there
# (6.4e-5 on one coordinate), where the float32 rounding of the row
# split crosses a level boundary; the other two cases hold the quantizer
CASES = {"sgd": ("ltfl", BLOCK), "int8": ("int8", BLOCK),
         "sgd-block128": ("none", 128)}


def _setup():
    cfg = reduce_for_smoke(get_arch("granite-8b"))
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.float() for k, v in model.init(gen).items()}
    batch = make_train_batch(cfg, C * ROWS, SEQ, gen)
    batch = {k: v.reshape((C, ROWS) + v.shape[1:]) for k, v in batch.items()}
    controls = {"rho": torch.tensor([0.25, 0.5]),
                "delta": torch.tensor([3.0, 5.0]),
                "weights": torch.tensor([40.0, 60.0]),
                "drop_prob": torch.tensor([0.0, 0.0])}
    return model, params, batch, controls


def _uniforms(seed, n_clients, shapes):
    rng = np.random.default_rng(seed)
    for s in shapes:
        yield torch.from_numpy(rng.random((n_clients,) + tuple(s),
                                          dtype=np.float32))


def _step(model, uplink, block=BLOCK, **kw):
    from repro_torch.core.compressors import ltfl_quantizer
    int8 = uplink == "int8"
    return make_fl_train_step(
        model, sgd(LR), C, prune_block=block, int8_collective=int8,
        compressor=None if int8 else "none" if uplink == "none"
        else ltfl_quantizer(uniforms=_uniforms),
        int8_uniforms=_uniforms if int8 else None, **kw)


def _rank(rank, port, out_dir):
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=8)
    try:
        mesh = make_test_mesh(device_type="cpu")
        model, params, batch, controls = _setup()
        rules = sh.base_rules(mesh, client_axes=("data",))
        psh = sh.param_shardings(mesh, model, rules)
        stacked = sh.stacked_shardings(mesh, model, rules, C, "client")
        gather = sh.stacked_shardings(mesh, model, rules, C, None)
        bsh = sh.batch_shardings(mesh, rules, batch, leading="client")
        dparams = {k: sh.distribute(v, psh[k]) for k, v in params.items()}
        dbatch = {k: sh.distribute(v, bsh[k]) for k, v in batch.items()}
        results = {}
        for case, (uplink, block) in CASES.items():
            step = _step(model, uplink, block, param_shardings=stacked,
                         gather_shardings=gather, tensor_parallel=False)
            new, _, _, m = step(dparams, (), (), dbatch, controls, SEED)
            results[case] = (
                {k: v.full_tensor() for k, v in new.items()}, m,
                step.layout.c_local)
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "sharded.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    mp.spawn(_rank, args=(_free_port(), str(out)), nprocs=8, join=True)
    return torch.load(out / "sharded.pt")


def test_layout_of_the_mesh(sharded):
    assert sharded["sgd"][2] == 1          # one client a 'data' rank


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_unsharded(sharded, case):
    uplink, block = CASES[case]
    model, params, batch, controls = _setup()
    new, _, _, m = _step(model, uplink, block)(params, (), (), batch,
                                               controls, SEED)
    s_new, s_m, _ = sharded[case]
    torch.testing.assert_close(s_m["loss"], m["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(s_m["range_sq"], m["range_sq"], rtol=1e-5,
                               atol=0)
    assert torch.equal(s_m["clients_received"], m["clients_received"])
    for k in params:
        torch.testing.assert_close(s_new[k], new[k], rtol=0, atol=1e-7,
                                   msg=k)
