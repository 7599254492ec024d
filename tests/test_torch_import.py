"""The port needs no jax and nothing of the reference package.

A subprocess blocks jax (``sys.modules["jax"] = None``) and imports every
module of ``repro_torch``; and no source file of the port, nor
``chip_smoke.py``, has an import statement of ``jax`` or ``repro``
(docstrings that name a reference module are fine).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(from|import)\s+(jax|repro)\b", re.M)

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
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_no_jax_or_reference_import_statements():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        hits = IMPORT_RE.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def _launcher(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--edge",
         "--rounds", "2", "--devices", "4", "--train-samples", "3000",
         "--test-samples", "200", "--batch-size", "4", "--width", "8",
         *args], env=env, capture_output=True, text=True, timeout=300)


def test_launcher_defaults_to_cuda_and_runs_on_the_cpu_when_asked():
    import torch
    if not torch.cuda.is_available():
        out = _launcher()
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
    out = _launcher("--device", "cpu")
    assert out.returncode == 0, out.stderr
    rounds = [l for l in out.stdout.splitlines() if l.startswith("[ltfl]")]
    assert len(rounds) == 2 and "recv=" in rounds[-1]


@pytest.mark.parametrize("scheme", ["fedsgd", "signsgd", "fedmp", "stc"])
def test_launcher_runs_the_baseline_schemes_on_the_cpu(scheme):
    out = _launcher("--device", "cpu", "--scheme", scheme)
    assert out.returncode == 0, out.stderr
    rounds = [l for l in out.stdout.splitlines()
              if l.startswith(f"[{scheme}]")]
    assert len(rounds) == 2 and "recv=" in rounds[-1]


def _datacenter(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-8b", "--smoke", "--steps", "2", *args], env=env,
        capture_output=True, text=True, timeout=300)


def test_datacenter_launcher_defaults_to_cuda_and_runs_on_the_cpu_when_asked():
    import torch
    if not torch.cuda.is_available():
        out = _datacenter()
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
    out = _datacenter("--device", "cpu")
    assert out.returncode == 0, out.stderr
    steps = [l for l in out.stdout.splitlines() if l.startswith("step=")]
    assert len(steps) == 2
    assert "loss=" in steps[-1] and "clients_received=" in steps[-1]
    assert "2 layers, d_model 256, 1574144 parameters" in out.stdout
