"""The port needs no jax and nothing of the reference package.

A subprocess blocks jax (``sys.modules["jax"] = None``) and imports every
module of ``repro_torch`` (the scanned and async engines, the device
samplers, the checkpoints, the meshes, the rule table and the dry run
among them); no source file of the port,
no ``examples/torch_*.py`` script, nor ``chip_smoke.py``, has an import
statement of ``jax`` or ``repro`` (docstrings that name a reference
module are fine); and the port's sweep, controller, async-service and batched-serving
examples run with both blocked. ``repro_torch.core`` and
``repro_torch.kernels`` export the reference packages' names without
building or loading a kernel, and the kernel submodules that those
exports shadow stay reachable (the package first, then ``ops``; the
launch counters as ``chip_smoke.py`` reads them).

The probes, examples and launchers run as jobs of three interpreters
started together (``run_jobs``), each job in turn through ``runpy`` or
``exec`` with its own ``sys.argv``, its output captured and its exit
code taken from ``SystemExit`` (an uncaught exception is exit code 1,
its traceback on stderr, as a fresh interpreter would print it); each
test reads its jobs' results. An interpreter costs seconds before it
does any work, and one a job was most of this file's time; each job's
output is the same as in an interpreter of its own, but for the
wall-clock figures it prints.
"""
import ast
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(from|import)\s+(jax|repro)\b", re.M)

# the jobs' interpreter, jax and the reference blocked; the results file
# is rewritten after every job, so a job that hangs leaves the earlier
# ones' results
_RUNNER = """
import contextlib, io, json, runpy, sys, traceback
sys.modules["jax"] = None
sys.modules["repro"] = None
jobs, results_file = json.loads(sys.argv[1]), sys.argv[2]
results = {}
for name, kind, target, argv in jobs:
    out, err, code = io.StringIO(), io.StringIO(), 0
    sys.argv = [target if kind != "exec" else "-c"] + argv
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            if kind == "module":
                runpy.run_module(target, run_name="__main__")
            elif kind == "path":
                runpy.run_path(target, run_name="__main__")
            else:
                exec(compile(target, name, "exec"), {"__name__": "__main__"})
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    except BaseException:
        code = 1
        err.write(traceback.format_exc())
    results[name] = [code, out.getvalue(), err.getvalue()]
    with open(results_file, "w") as f:
        json.dump(results, f)
"""


def run_jobs(groups, tmp, timeout=300):
    """Each group of jobs ({name: (kind, target, argv)}; kind "module"
    for ``runpy.run_module``, "path" for ``runpy.run_path``, "exec" for
    source) in one interpreter of its own, in order; the groups run
    together. {name: ``subprocess.CompletedProcess``}; a job that did not
    end within ``timeout`` seconds of the start, or that a job before it
    in its group hung, fails with that said on stderr. One CPU thread an
    interpreter: the jobs' ops are tiny, and beside the test suite's
    other workers more threads only wait on each other."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for i, jobs in enumerate(groups):
        results = Path(tmp) / f"jobs{i}.json"
        spec = json.dumps([[n, *job[:2], list(job[2])]
                           for n, job in jobs.items()])
        procs.append((jobs, results, subprocess.Popen(
            [sys.executable, "-c", _RUNNER, spec, str(results)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    start, done = time.time(), {}
    for jobs, results, p in procs:
        try:
            _, stderr = p.communicate(
                timeout=max(timeout - (time.time() - start), 0))
        except subprocess.TimeoutExpired:
            p.kill()
            _, stderr = p.communicate()
            stderr += f"\npast the jobs' {timeout} s"
        got = json.loads(results.read_text()) if results.exists() else {}
        for name in jobs:
            code, out, err = got.get(name, (None, "", stderr))
            done[name] = subprocess.CompletedProcess(name, code, out, err)
    return done


_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in {k for k, v in sys.modules.items() if v is not None}
for name in ("repro_torch.fed.scan_engine", "repro_torch.fed.async_engine",
             "repro_torch.checkpoint",
             "repro_torch.control.device_samplers",
             "repro_torch.control.device_controller",
             "repro_torch.control.device_bayesopt",
             "repro_torch.control.program",
             "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_lib",
             "repro_torch.launch.mesh", "repro_torch.launch.sharding",
             "repro_torch.launch.op_analysis",
             "repro_torch.core.sharded_step"):
    assert name in names, name
print(len(names))
"""


def test_port_imports_without_jax(runs):
    out = runs["probe"]
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_no_jax_or_reference_import_statements():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("torch_*.py")))
    assert len(list((ROOT / "examples").glob("torch_*.py"))) == 6
    assert len(files) > 20
    for f in files:
        hits = IMPORT_RE.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_sweep_example_runs_without_jax_on_the_cpu(runs):
    out = runs["sweep"]
    assert out.returncode == 0, out.stderr
    assert "12 lanes ran in 3 buckets" in out.stdout
    assert len([l for l in out.stdout.splitlines()
                if l.startswith(("ltfl/", "fedsgd/", "stc/"))]) == 6


def test_controller_demo_runs_without_jax_on_the_cpu(runs):
    out = runs["controller"]
    assert out.returncode == 0, out.stderr
    assert "solve_dev on cpu" in out.stdout
    assert out.stdout.count("within T_max") == 2
    assert "Gamma^n: host" in out.stdout


def test_async_service_example_runs_without_jax_on_the_cpu(runs):
    out = runs["async"]
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("service up on cpu: U=6")
    clients = [l for l in out.stdout.splitlines()
               if l.startswith("client ")]
    assert len(clients) == 2 and "admitted/round [" in clients[0]
    assert "engine has aggregated 7 rounds total" in out.stdout


def _launcher(*args):
    return ("module", "repro_torch.launch.train",
            ["--edge", "--rounds", "2", "--devices", "4", "--train-samples",
             "3000", "--test-samples", "200", "--batch-size", "4",
             "--width", "8", *args])


def test_launcher_defaults_to_cuda_and_runs_on_the_cpu_when_asked(runs):
    import torch
    if not torch.cuda.is_available():
        out = runs["edge_default"]
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
    out = runs["edge"]
    assert out.returncode == 0, out.stderr
    rounds = [l for l in out.stdout.splitlines() if l.startswith("[ltfl]")]
    assert len(rounds) == 2 and "recv=" in rounds[-1]


@pytest.mark.parametrize("scheme", ["fedsgd", "signsgd", "fedmp", "stc"])
def test_launcher_runs_the_baseline_schemes_on_the_cpu(runs, scheme):
    out = runs["edge_" + scheme]
    assert out.returncode == 0, out.stderr
    rounds = [l for l in out.stdout.splitlines()
              if l.startswith(f"[{scheme}]")]
    assert len(rounds) == 2 and "recv=" in rounds[-1]


def _datacenter(*args):
    return ("module", "repro_torch.launch.train",
            ["--arch", "granite-8b", "--smoke", "--steps", "2", *args])


def test_datacenter_launcher_defaults_to_cuda_and_runs_on_the_cpu_when_asked(
        runs):
    import torch
    if not torch.cuda.is_available():
        out = runs["datacenter_default"]
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
    out = runs["datacenter"]
    assert out.returncode == 0, out.stderr
    steps = [l for l in out.stdout.splitlines() if l.startswith("step=")]
    assert len(steps) == 2
    assert "loss=" in steps[-1] and "clients_received=" in steps[-1]
    assert "2 layers, d_model 256, 1574144 parameters" in out.stdout


def _serve(*args):
    return ("module", "repro_torch.launch.serve", ["--smoke", *args])


def test_serve_launcher_defaults_to_cuda_and_runs_on_the_cpu_when_asked(runs):
    """The serve launcher with jax and the reference blocked: its three
    lines at the reference's defaults (batch 4, prompt 32, 16 tokens)."""
    import torch
    if not torch.cuda.is_available():
        out = runs["serve_default"]
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
    out = runs["serve"]
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("prefill 4x32: ")
    assert lines[1].startswith("decoded 15 steps in ") and "tok/s" in lines[1]
    assert lines[2].startswith("generated ids[0]: [")
    assert len(lines[2].split(": [")[1].split(",")) == 16


def _reference_all(package):
    """``__all__`` of a reference package's ``__init__``, read with ast
    (no jax needed)."""
    tree = ast.parse((ROOT / "src" / "repro" / package / "__init__.py")
                     .read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in repro.{package}")


_EXPORTS = """
import sys, types
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.core as core
import repro_torch.kernels as kernels
from repro_torch.kernels import build
assert build._loaded == {}, build._loaded
assert not build.BUILD_DIR.exists() or sys.argv[1] == "built"
for pkg in (core, kernels):
    for name in pkg.__all__:
        assert getattr(pkg, name) is not None, name
assert isinstance(core.quantization, types.ModuleType)
assert isinstance(kernels.ops, types.ModuleType)
assert callable(kernels.stochastic_quant) and callable(core.make_plain_train_step)
print(" ".join(core.__all__))
print(" ".join(kernels.__all__))
"""


def test_core_and_kernels_export_the_reference_names_without_jax(runs):
    out = runs["exports"]
    assert out.returncode == 0, out.stderr
    core_names, kernel_names = (l.split() for l in
                                out.stdout.strip().splitlines())
    assert core_names == _reference_all("core")
    assert kernel_names == _reference_all("kernels")


_SHADOW = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.kernels
import repro_torch.kernels.ops as ops
import torch
from repro_torch.kernels.block_sparse_matmul import DEFAULT_BLOCKS
from repro_torch.kernels.ref import block_sparse_matmul_ref
# the exports shadow their submodules, as the reference's do
assert not hasattr(repro_torch.kernels.stochastic_quant, "LAUNCHES")
assert not hasattr(repro_torch.kernels.block_sparse_matmul, "LAUNCHES")
gen = torch.Generator().manual_seed(0)
x = torch.randn(64, 96, generator=gen)
w = torch.randn(96, 128, generator=gen)
out = ops.pruned_matmul(x, w, 0.25, blocks=(32, 32, 32))
_, mask = ops.block_prune_2d(w, 0.25, block=(32, 32))
assert torch.equal(out, block_sparse_matmul_ref(x, w, mask, 32, 32))
assert DEFAULT_BLOCKS == (128, 128, 128)
sys.path.insert(0, sys.argv[1])
import chip_smoke
mods = chip_smoke.kernel_modules("stochastic_quant", "block_prune",
                                 "block_sparse_matmul")
for name, m in zip(("stochastic_quant", "block_prune",
                    "block_sparse_matmul"), mods):
    assert m is importlib.import_module("repro_torch.kernels." + name)
print(sorted(chip_smoke.all_launches().items()))
"""


def test_kernel_submodules_stay_reachable_behind_the_exports(runs):
    out = runs["shadow"]
    assert out.returncode == 0, out.stderr
    launches = dict(eval(out.stdout.strip()))
    assert set(launches) == {"stochastic_quant", "block_norms",
                             "apply_block_mask", "block_sparse_matmul",
                             "block_sparse_matmul_wgmma",
                             "block_sparse_matmul_simt"}
    assert set(launches.values()) == {0}      # the CPU launches nothing


def test_serve_batched_example_runs_without_jax_on_the_cpu(runs):
    out = runs["batched"]
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == ("serving reduced granite-8b (2L d=256 "
                        "family=dense) on cpu")
    assert lines[1].startswith("prefill 2x8: ")
    assert lines[2].startswith("generated 5 tokens/seq in ")
    assert lines[2].endswith(" tok/s)")
    assert [l.split(":")[0] for l in lines[3:]] == ["request 0",
                                                    "request 1"]
    assert len(lines[3].split(": [")[1].split(",")) == 5


def job_groups():
    """Every job of this file, in three groups: the import probes and the
    examples, and the launchers in two halves; each launcher's run
    without ``--device`` only where there is no card (it fails with "no
    CUDA device")."""
    import torch
    examples = ROOT / "examples"
    built = (PORT / "kernels" / "_build").exists()
    probes = {
        "probe": ("exec", _PROBE, []),
        "exports": ("exec", _EXPORTS, ["built" if built else "clean"]),
        "shadow": ("exec", _SHADOW, [str(ROOT)]),
        "sweep": ("path", str(examples / "torch_paper_table_sweep.py"),
                  ["--device", "cpu", "--rounds", "2"]),
        "controller": ("path", str(examples / "torch_controller_demo.py"),
                       ["--device", "cpu"]),
        "async": ("path", str(examples / "torch_serve_async.py"),
                  ["--device", "cpu", "--clients", "2"]),
        "batched": ("path", str(examples / "torch_serve_batched.py"),
                    ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                     "--gen", "5"])}
    edge = {"edge_default": _launcher(),
            "edge": _launcher("--device", "cpu")}
    edge.update({"edge_" + s: _launcher("--device", "cpu", "--scheme", s)
                 for s in ("fedsgd", "signsgd")})
    rest = {"edge_" + s: _launcher("--device", "cpu", "--scheme", s)
            for s in ("fedmp", "stc")}
    rest.update({"datacenter_default": _datacenter(),
                 "datacenter": _datacenter("--device", "cpu"),
                 "serve_default": _serve(),
                 "serve": _serve("--device", "cpu")})
    groups = [probes, edge, rest]
    if torch.cuda.is_available():
        groups = [{k: v for k, v in g.items() if not k.endswith("_default")}
                  for g in groups]
    return groups


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(job_groups(), tmp_path_factory.mktemp("jobs"))
