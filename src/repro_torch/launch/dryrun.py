"""Dry run of every (arch x shape x mesh) on the meta device.

Held against ``repro.launch.dryrun`` (its arguments and output). Each
pair runs under a fake process group of the mesh's size (256 ranks for
the (16, 16) production mesh, 512 for (2, 16, 16), 8 for the test
meshes), made before the mesh and destroyed after; nothing is computed
or allocated and no card is needed.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --test-mesh --variant '{"scan": 2}'

Writes one JSON record per pair into ``artifacts/dryrun_torch/``.
"""
import argparse
import json
import sys
import traceback


def main() -> int:
    from repro_torch import configs
    from repro_torch.launch import dryrun_lib

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see configs.list_archs)")
    ap.add_argument("--shape", help="input shape name",
                    choices=sorted(configs.SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) pair")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (pod,data,model) instead of 16x16")
    ap.add_argument("--test-mesh", action="store_true",
                    help="the 8-rank CI mesh, (2, 4) or (2, 2, 2)")
    ap.add_argument("--variant", default="{}",
                    help="JSON dict of overrides, e.g. '{\"prune\": false}'")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args()

    variant = json.loads(args.variant)
    if args.all:
        pairs = [(a, s) for a in configs.list_archs()
                 for s in sorted(configs.SHAPES)]
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]

    failures = []
    for a, s in pairs:
        try:
            dryrun_lib.run_pair(a, s, multi_pod=args.multi_pod,
                                variant=variant, test_mesh=args.test_mesh,
                                out_dir=args.out)
        except Exception:
            failures.append((a, s))
            print(f"FAIL {a} x {s}:", file=sys.stderr)
            traceback.print_exc()
    if failures:
        print(f"{len(failures)} failures: {failures}", file=sys.stderr)
        return 1
    print("dry-run complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
