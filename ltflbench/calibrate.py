"""The readings the output check's limits are set from, many seeds in one
process (set-up is paid once).

    python3 -m ltflbench.calibrate --workload <cell> --first <seed> \\
        --seeds <n> --variant program [--variant control ...]

Variants, each compared with the plain reference on the same seeds:

* ``program``: the port as the benchmark runs it (the lower reading);
* ``control``: the reference itself in the precision below the
  configuration's (float8 e4m3 products for bfloat16, TF32 for float32
  with TF32 off) put in the program's place (an upper reading);
* ``control_alg1`` (edge): Algorithm 1 of the plain reference in
  float32, its decision against the float64 reference's;
* ``half_batch``, ``unchanged``, ``altered`` (edge): the port with a
  fault planted (``plant``): each client's loss over the first half of
  its batch only; a step that hands its parameters back unchanged;
  Algorithm 1's answer replaced where it is made by one that lies in the
  configuration's ranges (rho 0, the most bits, the most power).

Prints one JSON line a variant and seed (with every step's and every
leaf's gap under ``detail``), then the largest and smallest reading of
each number a variant. Needs a card unless ``--device cpu``
(small configurations only: the tests use it).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from unittest import mock

from ltflbench import compare
from ltflbench import manifest as mf

VARIANTS = ("program", "control", "control_alg1", "half_batch",
            "unchanged", "altered")


@contextlib.contextmanager
def plant(fault: str):
    """The port with ``fault`` planted underneath the timed path."""
    if fault == "unchanged":
        from repro_torch.core import ltfl_step
        with mock.patch.object(ltfl_step, "apply_updates",
                               lambda params, updates: dict(params)):
            yield
    elif fault == "half_batch":
        from repro_torch.models import ResNet
        from repro_torch.models.transformer import DecoderLM
        patches = []
        for cls in (DecoderLM, ResNet):
            orig = cls.loss

            def half(self, params, batch, orig=orig):
                return orig(self, params,
                            {k: v[: v.shape[0] // 2]
                             for k, v in batch.items()})
            patches.append(mock.patch.object(cls, "loss", half))
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            yield
    elif fault == "altered":
        import numpy as np
        from repro_torch.core import controller
        from repro_torch.core.channel import packet_error_rate

        def constant(ltfl, devices, num_params, **kw):
            u, w = len(devices), ltfl.wireless
            power = np.full(u, w.p_max)
            return controller.ControlDecision(
                rho=np.zeros(u), delta=np.full(u, ltfl.delta_max, np.int64),
                power=power, per=packet_error_rate(w, devices, power),
                gamma=float("nan"), alternations=0,
                gamma_trace=np.zeros(0))
        with mock.patch.object(controller, "solve", constant):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}")


def datacenter_gaps(cell: dict, seed: int, variant: str, device,
                    prog=None):
    from ltflbench import harness
    from ltflbench.entries import datacenter as dcm
    dc = dcm.Datacenter(cell, seed, device)
    ref = dcm.reference_readings(dc)
    if variant == "control":
        return _found(dcm.reference_readings(dc, fp8=True), ref), prog
    faults = plant(variant) if variant != "program" \
        else contextlib.nullcontext()
    with faults:                # a fault is planted before the step is built
        if prog is None:
            prog = dcm.Program(dc)
        prog.dc = dc
        readings = harness.to_host(prog.start(dc.weights()))
    prog.state = None
    harness.free(device)
    return _found(readings, ref), prog


def _found(readings: dict, ref: dict) -> dict:
    return {**compare.gaps(readings, ref),
            "detail": compare.detail(readings, ref)}


def edge_gaps(cell: dict, seed: int, variant: str, device) -> dict:
    import numpy as np
    from ltflbench import harness
    from ltflbench.entries import edge as em
    from ltflbench.refs import algorithm1
    edge = em.Edge(cell, seed, device)
    rounds = cell["params"]["rounds_per_call"]
    lf, wf = edge.cf["ltfl"], edge.cf["wireless"]
    if variant == "control_alg1":
        ref = algorithm1.HostStream(edge.cf, seed, edge.num_params)
        low = algorithm1.HostStream(edge.cf, seed, edge.num_params,
                                    np.float32)
        try:
            d = algorithm1.decision_gaps(low.round(0)["decision"],
                                         ref.round(0)["decision"], lf, wf)
        except np.linalg.LinAlgError as e:    # failed, with no number
            return {"decision_gap": float("nan"), "detail": repr(e)}
        return {"decision_gap": max(d.values()), "detail": d}
    if variant == "control":
        readings = em.reference_readings(edge, rounds, tf32=True)
    else:
        params = edge.weights()
        faults = plant(variant) if variant != "program" \
            else contextlib.nullcontext()
        with faults:
            runner = edge.runner(params)
            got = em.program_readings(runner, params, lf["learning_rate"],
                                      rounds)
            readings = {**harness.to_host(got), "decision": got["decision"]}
        del runner, got
        harness.free(device)
    ref = em.reference_readings(edge, rounds)            # TF32 off again
    return {**em.gaps(edge, readings, ref),
            "detail": {**compare.detail(readings, ref),
                       "decision": algorithm1.decision_gaps(
                           readings["decision"], ref["decision"], lf, wf)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--variant", action="append", choices=VARIANTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(mf.REPO / "src"))
    import torch
    device = torch.device(args.device)
    cell = mf.cell(mf.load(), args.workload)
    edge = cell["params"]["entry"] == "edge"
    summary = {}
    for variant in args.variant or ["program"]:
        prog, rows = None, []
        for seed in range(args.first, args.first + args.seeds):
            if edge:
                found = edge_gaps(cell, seed, variant, device)
            else:
                found, prog = datacenter_gaps(cell, seed, variant, device,
                                              prog)
            rows.append(found)
            print(json.dumps({"variant": variant, "seed": seed, **found}),
                  flush=True)
        summary[variant] = {}
        for k in rows[0]:
            got = [r[k] for r in rows if k != "detail" and r[k] == r[k]]
            if got:             # a NaN is a run that gave no number
                summary[variant][k] = {"max": max(got), "min": min(got)}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
