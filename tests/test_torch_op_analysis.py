"""Per-device op analysis (``repro_torch.launch.op_analysis``), the
counterpart of the reference's HLO analysis (tests/test_hlo_and_dryrun.py):
the ring wire factors, exact FLOPs of a 16-step loop, the one all-reduce
of a contraction sharded 8 ways, and a sharded matmul counted per device
(1/16 of the global FLOPs, where ``FlopCounterMode`` counts the global
op). The collectives run on a fake process group of 16 ranks over meta
tensors: nothing is computed or sent.
"""
import datetime

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import fake_process_group
from repro_torch.launch.op_analysis import _wire_factor, analyze_ops
from repro_torch.launch.sharding import NamedSharding, from_local


@pytest.fixture
def group():
    fake_process_group(16)
    yield
    dist.destroy_process_group()


def _mesh(n):
    return DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("model",))


def test_wire_factors():
    assert _wire_factor("all-reduce", 4) == pytest.approx(1.5)
    assert _wire_factor("all-gather", 4) == 3.0
    assert _wire_factor("reduce-scatter", 4) == pytest.approx(0.75)
    assert _wire_factor("all-reduce", 1) == 0.0
    assert _wire_factor("all-to-all", 8) == pytest.approx(7 / 8)
    assert _wire_factor("collective-permute", 8) == 1.0


def test_wire_factors_are_the_reference_s():
    pytest.importorskip("jax")
    from repro.launch.hlo_analysis import _wire_factor as ref
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "all-to-all", "collective-permute", "other"):
        for g in (1, 2, 3, 8, 16, 256):
            assert _wire_factor(kind, g) == ref(kind, g)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_flops_exact(device):
    def loop(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x.sum()
    x = torch.ones((128, 256), device=device)
    ws = torch.ones((16, 256, 256), device=device) * 0.01
    counts, _ = analyze_ops(loop, x, ws)
    assert counts["flops"] == 16 * 2 * 128 * 256 * 256
    assert counts["coll_count"] == 0


def test_flops_equal_flop_counter_mode_under_grad():
    def f(w, x):
        return torch.tanh(torch.softmax(x @ w, -1) @ w.t()).sum()
    w, x = torch.randn(4, 64, 32), torch.randn(48, 64)
    fn = torch.func.vmap(torch.func.grad(f), in_dims=(0, None))
    with FlopCounterMode(display=False) as fc:
        fn(w, x)
    counts, _ = analyze_ops(fn, w, x)
    assert counts["flops"] == fc.get_total_flops() > 0


def test_collective_bytes_on_sharded_matmul(group):
    mesh = _mesh(8)
    sh = NamedSharding(mesh, ("model", None))
    a = from_local(torch.empty((128, 128), device="meta"), sh, (1024, 128))
    b = from_local(torch.empty((128, 128), device="meta"), sh, (1024, 128))

    def f(a, b):
        return (a.T @ b).redistribute(mesh, [Replicate()])

    counts, _ = analyze_ops(f, a, b)
    ar = counts["coll_all-reduce"]
    assert counts["coll_count"] == 1
    assert ar == 128 * 128 * 4            # one all-reduce of the f32 output
    assert counts["coll_wire_total"] == pytest.approx(ar * 2 * 7 / 8)
    assert counts["flops"] == 2 * 128 * 128 * 128     # the local product


def test_sharded_matmul_counts_one_sixteenth(group):
    mesh = _mesh(16)
    x = from_local(torch.empty((1024, 4096), device="meta"),
                   NamedSharding(mesh, (None, None)), (1024, 4096))
    w = from_local(torch.empty((4096, 896), device="meta"),
                   NamedSharding(mesh, (None, "model")), (4096, 14336))
    counts, out = analyze_ops(lambda x, w: x @ w, x, w)
    assert tuple(out.shape) == (1024, 14336)
    assert out.placements == (Shard(1),)
    assert counts["flops"] == 2 * 1024 * 4096 * 14336 // 16
    assert counts["coll_count"] == 0


def test_all_gather_and_peak_bytes(group):
    mesh = _mesh(16)
    w = from_local(torch.empty((4096, 896), device="meta"),
                   NamedSharding(mesh, (None, "model")), (4096, 14336))
    base = 4096 * 896 * 4
    counts, full = analyze_ops(lambda w: w.full_tensor(), w, base=base)
    assert tuple(full.shape) == (4096, 14336)
    assert counts["coll_all-gather"] == base
    assert counts["coll_wire_total"] == 15 * base
    assert counts["peak_bytes"] >= base + 4096 * 14336 * 4


def test_real_tensors_on_a_one_rank_group():
    # a gloo world of one: DTensor moves nothing over a mesh dim of one;
    # an explicit all-reduce runs for real and is counted, with no wire
    import os
    import socket
    from repro_torch.core.sharded_step import all_reduce
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = _mesh(1)
        t = distribute_tensor(torch.arange(6.0).reshape(2, 3), mesh,
                              [Shard(0)])
        counts, full = analyze_ops(lambda t: t.full_tensor(), t)
        assert torch.equal(full, torch.arange(6.0).reshape(2, 3))
        assert counts["coll_count"] == 0
        x = torch.arange(4.0)
        counts, out = analyze_ops(lambda x: all_reduce(x, "max", mesh, [0]),
                                  x)
        assert torch.equal(out, x)
        assert counts["coll_count"] == 1
        assert counts["coll_all-reduce"] == 16
        assert counts["coll_wire_total"] == 0.0       # a group of one
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kernel", ["stochastic_quant", "block_norms",
                                    "apply_block_mask"])
def test_kernel_reads_counted_on_meta(kernel):
    # a hand-written kernel's reads show in no dispatched op: its wrapper
    # reports them, on meta as on the card, and the counter adds them
    from repro_torch.kernels.block_prune import apply_block_mask, block_norms
    from repro_torch.kernels.stochastic_quant import stochastic_quant
    g = torch.empty((3, 256, 512), device="meta", dtype=torch.bfloat16)
    rand = torch.empty((3, 256 * 512), device="meta")
    rng = torch.empty((3, 3), device="meta")
    mask = torch.empty((3, 2, 4), device="meta", dtype=torch.bool)
    calls = {
        "stochastic_quant": (lambda: stochastic_quant(
            g.reshape(3, -1), rand, rng), g.numel() * 2 + rand.numel() * 4
            + 36, g.numel() * 2),
        "block_norms": (lambda: block_norms(g[0], (128, 128)),
                        256 * 512 * 2, 8 * 4),
        "apply_block_mask": (lambda: apply_block_mask(g, mask, (128, 128)),
                             g.numel() * 2 + 24, g.numel() * 2),
    }
    fn, reads, writes = calls[kernel]
    counts, _ = analyze_ops(fn)
    assert counts["kernel_read_bytes"] == reads
    # the output's allocation is the kernel's write; the wrapper's views
    # move nothing
    assert counts["hbm_bytes"] == reads + writes


def test_plain_versions_report_no_kernel_reads():
    # on the CPU the plain version's own ops are what is counted
    from repro_torch.kernels.block_prune import block_norms
    counts, _ = analyze_ops(lambda w: block_norms(w, (128, 128)),
                            torch.ones((256, 512)))
    assert counts["kernel_read_bytes"] == 0
    assert counts["hbm_bytes"] > 256 * 512 * 4
