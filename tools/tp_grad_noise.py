"""The tensor-parallel gradients of one reduced config's ``model.loss``
on a ("data", "model") = (1, 4) mesh of four gloo ranks on the CPU,
against the unsharded gradients, per leaf (relative norm error and
largest element error over the largest element): the float32 noise of
the ranks' partial sums, which the stochastic quantizer can turn into
level flips.

  PYTHONPATH=src:tests python3 tools/tp_grad_noise.py zamba2
  PYTHONPATH=src:tests python3 tools/tp_grad_noise.py rwkv --float64

The config names are ``tests/torch_tp_worker.py``'s; the weights and
tokens are the TP test's (``tests/test_torch_tensor_parallel.py``,
which needs jax for its uniforms: this script does not). With
``--float64`` the leaves and inputs are float64 (the models still cast
to float32 where the reference does).
"""
import argparse
import os
import socket
import sys
import tempfile

import torch
import torch.multiprocessing as mp


def _cast(params, batch, f64):
    if not f64:
        return params, batch
    return ({k: v.double() for k, v in params.items()},
            {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()})


def _rank(rank, port, name, f64, out):
    import torch.distributed as dist

    import torch_tp_worker as w
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.common import logical_rule_scope
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=4)
    try:
        tree, tokens = torch.load(os.path.join(out, "in.pt"),
                                  weights_only=False)
        _, model, params, batch = w.port(name, tree, tokens)
        params, batch = _cast(params, batch, f64)
        mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
        rules = sh.base_rules(mesh)
        psh = sh.param_shardings(mesh, model, rules)
        local = {k: sh.local_slice(v, psh[k]).contiguous()
                 for k, v in params.items()}
        with logical_rule_scope(rules, mesh):
            grads, loss = torch.func.grad_and_value(model.loss)(
                local, {k: v[0] for k, v in batch.items()})
        ctx = tp.context_for(mesh, rules)
        whole = {}
        for k, g in grads.items():
            spec = psh[k].spec
            whole[k] = (g if "model" not in spec else tp.all_gather(
                g, ctx, spec.index("model") - len(spec)))
        if rank == 0:
            torch.save((whole, loss), os.path.join(out, "tp.pt"))
    finally:
        dist.destroy_process_group()


def main() -> None:
    import numpy as np

    import torch_tp_worker as w
    ap = argparse.ArgumentParser()
    ap.add_argument("name", choices=sorted(w.CONFIGS))
    ap.add_argument("--float64", action="store_true")
    args = ap.parse_args()
    cfg = w.port_config(args.name)
    from repro_torch.models import build_model, params_to_numpy
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = params_to_numpy(build_model(cfg).init(gen))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (w.C, w.ROWS, w.SEQ))
    out = tempfile.mkdtemp()
    torch.save((tree, tokens), os.path.join(out, "in.pt"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(port, args.name, args.float64, out), nprocs=4,
             join=True)
    got, loss = torch.load(os.path.join(out, "tp.pt"))
    _, model, params, batch = w.port(args.name, tree, tokens)
    params, batch = _cast(params, batch, args.float64)
    want, want_loss = torch.func.grad_and_value(model.loss)(
        params, {k: v[0] for k, v in batch.items()})
    print(f"{args.name}: loss {float(loss)!r} (unsharded "
          f"{float(want_loss)!r})")
    for k, v in want.items():
        d = got[k] - v
        print(f"  {k:40s} rel {float(d.norm() / v.norm()):.2e} max "
              f"{float(d.abs().max() / v.abs().max()):.2e}")


if __name__ == "__main__":
    sys.exit(main())
