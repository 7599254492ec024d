"""The launchers run the SSM, hybrid and encoder-decoder families on the
CPU with jax and the reference blocked (``sys.modules["jax"] = None``,
as tests/test_torch_import.py runs the others): two datacenter steps of
``launch.train --smoke --device cpu`` (sequence 32, one sample a
client) and the serve launcher's three lines at its defaults, for
rwkv6-7b, zamba2-2.7b and whisper-medium. The subprocesses run on one
CPU thread: their ops are tiny, and beside the test suite's other
workers more threads only wait on each other.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_RUN = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
runpy.run_module(module, run_name="__main__")
"""


def _run(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", _RUN, module, *args],
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("arch,n_params", [
    ("rwkv6-7b", 1644288), ("zamba2-2.7b", 1736352),
    ("whisper-medium", 3938304)])
def test_launchers_run_the_new_families_on_the_cpu_without_jax(arch,
                                                                n_params):
    out = _run("repro_torch.launch.train", "--arch", arch, "--smoke",
               "--device", "cpu", "--steps", "2", "--seq-len", "32",
               "--per-client-batch", "1")
    assert out.returncode == 0, out.stderr
    steps = [l for l in out.stdout.splitlines() if l.startswith("step=")]
    assert len(steps) == 2 and "clients_received=" in steps[-1]
    assert f"2 layers, d_model 256, {n_params} parameters, 4 clients x " \
        "batch 1 x seq 32" in out.stdout
    out = _run("repro_torch.launch.serve", "--smoke", "--arch", arch,
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("prefill 4x32: ")
    assert lines[1].startswith("decoded 15 steps in ")
    assert len(lines[2].split(": [")[1].split(",")) == 16
