"""The all-gathers of one dry-run pair's program on rank 0, grouped by
output shape and dtype: how many, and the bytes of each gathered output
(a rank's whole copy). It shows what the tensor-parallel step gathers as
activations, and how large they are, beside the record that
``python -m repro_torch.launch.dryrun`` writes for the same pair.

  PYTHONPATH=src python3 tools/tp_gathers.py zamba2-2.7b train_4k
  PYTHONPATH=src python3 tools/tp_gathers.py whisper-medium prefill_32k \\
      --test-mesh --variant '{"act": "seq"}'

Meta tensors under a fake process group (256 ranks, or 8 with
``--test-mesh``): nothing is computed or allocated and no card is
needed.
"""
import argparse
import json
from collections import defaultdict


def main() -> None:
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import (
        fake_process_group,
        make_production_mesh,
        make_test_mesh,
    )
    from repro_torch.launch.op_analysis import OpCounter

    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape", choices=sorted(configs.SHAPES))
    ap.add_argument("--test-mesh", action="store_true")
    ap.add_argument("--variant", default="{}")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    shape = configs.get_shape(args.shape)
    arch = configs.arch_for_shape(configs.get_arch(args.arch), shape)
    fake_process_group(8 if args.test_mesh else 256)
    try:
        mesh = (make_test_mesh(device_type="cpu") if args.test_mesh
                else make_production_mesh(device_type="cpu"))
        build = {"train": dryrun_lib.build_train,
                 "prefill": dryrun_lib.build_prefill,
                 "decode": dryrun_lib.build_decode}[shape.mode]
        built = build(arch, shape, mesh, json.loads(args.variant))
        counter = OpCounter(base=built.args_bytes)
        with counter:
            built.fn()
    finally:
        dist.destroy_process_group()
    groups = defaultdict(int)
    for e in counter.coll_log:
        if e["kind"] == "all-gather":
            groups[(e["shape"], e["dtype"])] += 1
    rows = sorted(((n * _bytes(s, d), n, s, d)
                   for (s, d), n in groups.items()), reverse=True)
    print(f"{arch.name} x {shape.name} on {mesh.mesh_dim_names} "
          f"{tuple(mesh.shape)} {args.variant}: {sum(groups.values())} "
          f"all-gathers, {sum(r[0] for r in rows)} output bytes")
    for total, n, s, d in rows[:args.top]:
        print(f"  {n:6d} x {s} {d}: {_bytes(s, d)} bytes each, {total} "
              "in all")


def _bytes(shape, dtype) -> int:
    import math

    import torch
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


if __name__ == "__main__":
    main()
