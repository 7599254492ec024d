"""The stochastic level flips of the quantized tensor-parallel steps that
``tests/test_torch_tensor_parallel.py`` holds (8 gloo ranks on the CPU):
for each config's quantized case, against the port's unsharded step and
against the reference's, the coordinates past the test's 1e-6 that its
explained-flip rule (``flip_distance``) explains, by leaf, each with
its distance from a level boundary; and any it does not explain.

  PYTHONPATH=src:tests python3 tools/tp_flip_report.py [DIR]

DIR is a directory where the test saved its ranks' and reference's
results (``Background``: inputs.pt, tp.pt, ref.pt; pytest keeps it as
``tp0`` under its base temporary directory); without it, this script
spawns the ranks and the reference itself (~2 min on 8 cores).
"""
import sys
import tempfile
from pathlib import Path

import torch


def main() -> None:
    import test_torch_tensor_parallel as t
    if len(sys.argv) > 1:
        out = Path(sys.argv[1])
        inputs, ranks, refs = (torch.load(out / f, weights_only=False)
                               for f in ("inputs.pt", "tp.pt", "ref.pt"))
    else:
        work = t.Background(Path(tempfile.mkdtemp()))
        try:
            inputs = {n: t._inputs(n) for n in t.CONFIGS}
            work.hand_over(inputs)
            ranks, refs = work.ranks(), work.references()
        finally:
            work.close()
    worst = 0.0
    for name in t.CONFIGS:
        for layout, uplink in t.cases(name):
            if uplink != "ltfl":
                continue
            new, _, levels = t.unsharded_step(inputs[name], name, uplink)
            got = ranks[name, layout, uplink][0]
            sides = [("unsharded", new)]
            if (layout, uplink) == t.cases(name)[0]:
                sides.append(("reference", refs["step", name][0]))
            for side, want in sides:
                for k, v in want.items():
                    dist = t.flip_distance(got[k] - v, *levels[k])
                    flips = dist[(dist > 0) & torch.isfinite(dist)]
                    bad = int(torch.isinf(dist).sum())
                    if len(flips) or bad:
                        far = float(flips.max()) if len(flips) else 0.0
                        worst = max(worst, far)
                        print(f"{name} {layout} against the {side}: {k} "
                              f"{len(flips)} of {v.numel()} flipped "
                              f"(farthest {far:.3g} of a level from a "
                              f"boundary), {bad} unexplained")
    print(f"worst distance of a flip: {worst:.3g} (EPS {t.EPS:g})")


if __name__ == "__main__":
    sys.exit(main())
