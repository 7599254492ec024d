"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the port. Each check runs in an interpreter
of its own, since the test process has loaded both packages."""
import ast
import os
import subprocess
import sys

import pytest

from ltflbench import manifest as mf

ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": os.pathsep.join([str(mf.REPO / "src"), str(mf.REPO)])}

HARNESS_PATH = """
import sys, time, torch
torch.set_num_threads(1)
from ltflbench import manifest as mf, run, calibrate, counts, trace
from ltflbench.entries import datacenter, edge
m = mf.load()
cell = mf.cell(m, "granite-8b.fl_128")
cell["config_file"].update(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
                           head_dim=16, d_ff=64, vocab_size=64)
cell["params"].update(seq_len=8, pool=3, clients=2)
res = datacenter.run(cell, 3, 0.2, False, torch.device("cpu"),
                     time.perf_counter())
assert res.correct, res.checks
for metric in [x["name"] for x in m["per_layer"]]:
    mf.reader(metric)
print(sorted({k.split(".")[0] for k in sys.modules}))
print("forbidden", run.forbidden_modules())
"""

REFS_ONLY = """
import sys
import ltflbench.refs.lm, ltflbench.refs.ltfl, ltflbench.refs.resnet
import ltflbench.refs.algorithm1
print(sorted(k for k in sys.modules if k.split(".")[0] == "repro_torch"))
"""


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=mf.REPO,
                         env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_harness_path_loads_no_jax():
    last = _python(HARNESS_PATH).strip().splitlines()
    assert last[-1] == "forbidden []"
    loaded = set(eval(last[-2]))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_port():
    assert _python(REFS_ONLY).strip() == "[]"


@pytest.mark.parametrize("name,plain", [
    ("lm.py", "torch"), ("ltfl.py", "torch"), ("resnet.py", "torch"),
    ("__init__.py", "torch"), ("algorithm1.py", "numpy")])
def test_reference_sources_import_only_torch(name, plain):
    """Each reference imports only the one plain library it is written
    in (PyTorch, or NumPy for the host's Algorithm 1)."""
    tree = ast.parse((mf.HERE / "refs" / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "math", "typing", plain}, roots


def test_forbidden_names_compared_whole():
    from ltflbench import run
    names = ["repro_torch.core", "jaxtyping", "reproducible", "repro.core",
             "jax.numpy", "flax"]
    assert run.forbidden_modules(names) == ["flax", "jax", "repro"]
