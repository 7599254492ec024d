"""The launchers run the SSM, hybrid and encoder-decoder families on the
CPU with jax and the reference blocked (``sys.modules["jax"] = None``,
as tests/test_torch_import.py runs the others): two datacenter steps of
``launch.train --smoke --device cpu`` (sequence 32, one sample a
client) and the serve launcher's three lines at its defaults, for
rwkv6-7b, zamba2-2.7b and whisper-medium. The six runs are jobs of
``test_torch_import.run_jobs``, one interpreter a family, the three run
together, each on one CPU thread: their ops are tiny, and beside the
test suite's other workers more threads only wait on each other.
"""
import pytest

from test_torch_import import run_jobs

ARCHS = {"rwkv6-7b": 1644288, "zamba2-2.7b": 1736352,
         "whisper-medium": 3938304}


def job_groups():
    """One group a family: its datacenter steps and its serve run."""
    return [{arch + " train": ("module", "repro_torch.launch.train",
                               ["--arch", arch, "--smoke", "--device", "cpu",
                                "--steps", "2", "--seq-len", "32",
                                "--per-client-batch", "1"]),
             arch + " serve": ("module", "repro_torch.launch.serve",
                               ["--smoke", "--arch", arch, "--device",
                                "cpu"])}
            for arch in ARCHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(job_groups(), tmp_path_factory.mktemp("jobs"))


@pytest.mark.parametrize("arch,n_params", list(ARCHS.items()))
def test_launchers_run_the_new_families_on_the_cpu_without_jax(runs, arch,
                                                                n_params):
    out = runs[arch + " train"]
    assert out.returncode == 0, out.stderr
    steps = [l for l in out.stdout.splitlines() if l.startswith("step=")]
    assert len(steps) == 2 and "clients_received=" in steps[-1]
    assert f"2 layers, d_model 256, {n_params} parameters, 4 clients x " \
        "batch 1 x seq 32" in out.stdout
    out = runs[arch + " serve"]
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("prefill 4x32: ")
    assert lines[1].startswith("decoded 15 steps in ")
    assert len(lines[2].split(": [")[1].split(",")) == 16
