"""Run one cell of the benchmark and print its result line.

    python3 -m ltflbench.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the repository root, on a machine with a CUDA card. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a profiled steady window. The last line on standard output
is one JSON object; each number the output check compared is printed
beside its limit as the last lines on standard error and under
``checks``, the line's last key. Without a card, with fewer cards than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, the run prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from ltflbench import manifest as mf  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole: ``repro_torch`` is the port."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(res, cell: dict, manifest: dict, trace: bool,
                device_info: dict) -> dict:
    units = mf.metric_units(manifest)
    metrics = {}
    if not trace:
        for m in mf.metrics_for(manifest, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": res.end_to_end[m["name"]],
                                  "unit": units[m["name"]]}
    else:
        for m in mf.metrics_for(manifest, cell["name"], "per_layer"):
            value = mf.reader(m["name"]).read(res.trace_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value,
                                      "unit": units[m["name"]]}
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": device_info}
    if trace:
        from ltflbench import trace as tracing
        tr = res.trace_ctx["trace"]
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tracing.top_device_ops(tr),
                             "idle_gaps": tracing.idle_gaps(tr)}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res.checks.items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(mf.REPO / "src"))
    import torch
    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    entry = importlib.import_module(
        f"ltflbench.entries.{cell['params']['entry']}")
    res = entry.run(cell, args.seed, args.seconds, bool(args.trace), device,
                    T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    from ltflbench import counts
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell["chips"], "memory_peak_bytes": res.memory_peak_bytes,
            "power_limit": counts.power_limit()}
    line = result_line(res, cell, manifest, bool(args.trace), info)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
