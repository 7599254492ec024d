"""The output check decides ``correct`` as it should: a run of each entry
at a small size on the CPU (the look for a card skipped, the rest of the
run driven) comes out correct as the port stands, and not correct with
a fault planted underneath the timed path (a step that hands its
parameters back unchanged; each client's loss over half of its batch;
on the edge, Algorithm 1's answer replaced by one inside the
configuration's ranges), or with the control (the plain reference in the
precision below the configuration's) in the program's place. The limits
are the cells' own."""
import sys
import time

import numpy as np
import pytest
import torch

from ltflbench import calibrate, compare
from ltflbench import manifest as mf
from ltflbench.entries import datacenter, edge
from ltflbench.refs import algorithm1

sys.path.insert(0, str(mf.REPO / "src"))
torch.set_num_threads(1)
CPU = torch.device("cpu")
M = mf.load()


def small(name: str, dtype: str = "float32") -> dict:
    """The cell at a size a test holds; the language model in float32,
    where a tiny model's bfloat16 rounding would swamp the limits set at
    the published widths (``dtype`` keeps bfloat16 for the control)."""
    cell = mf.cell(M, name)
    cf, p = cell["config_file"], cell["params"]
    if p["entry"] == "datacenter":
        cf.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256, dtype=dtype)
        p.update(seq_len=16, pool=4)
    else:
        cf.update(stem_channels=8, group_channels=[8, 16, 32, 32],
                  train_samples=3000, test_samples=200, batch_size=4)
        cf["ltfl"].update(num_devices=4)
    return cell


ENTRIES = {"granite-8b.fl_128": datacenter, "ltfl-resnet.table2": edge}


def _run(name, seed):
    return ENTRIES[name].run(small(name), seed, 0.3, False, CPU,
                             time.perf_counter())


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_sound_run_is_correct(name):
    res = _run(name, 2 ** 31 + 11)
    assert res.correct, res.checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_planted_fault_is_not_correct(name, fault):
    with calibrate.plant(fault):
        res = _run(name, 2 ** 31 + 12)
    assert not res.correct, res.checks


def test_fp8_control_is_not_correct():
    cell = small("granite-8b.fl_128", "bfloat16")
    dc = datacenter.Datacenter(cell, 2 ** 31 + 13, CPU)
    found = compare.gaps(datacenter.reference_readings(dc, fp8=True),
                         datacenter.reference_readings(dc))
    assert not compare.judge(found, cell["params"]["limits"]), found


def test_altered_decision_is_not_correct():
    with calibrate.plant("altered"):
        res = _run("ltfl-resnet.table2", 2 ** 31 + 15)
    assert not res.correct, res.checks
    assert res.checks["decision_gap"][0] > res.checks["decision_gap"][1]


@pytest.mark.parametrize("seed", [2 ** 31 + 16, 2 ** 33 + 17])
def test_float32_algorithm1_control_is_not_correct(seed):
    """At the cell's own size: Algorithm 1 in float32 decides otherwise
    than in float64, or fails outright (a Cholesky factor that float32
    cannot hold)."""
    cell = mf.cell(M, "ltfl-resnet.table2")
    cf, limit = cell["config_file"], cell["params"]["limits"]
    v = 4_901_450
    ref = algorithm1.HostStream(cf, seed, v).round(0)["decision"]
    try:
        low = algorithm1.HostStream(cf, seed, v, np.float32).round(0)
    except np.linalg.LinAlgError:
        return
    gap = max(algorithm1.decision_gaps(low["decision"], ref, cf["ltfl"],
                                       cf["wireless"]).values())
    assert gap > limit["decision_gap"], gap


@pytest.mark.gpu
def test_tf32_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on a CUDA card only")
    cell = small("ltfl-resnet.table2")
    e = edge.Edge(cell, 2 ** 31 + 14, torch.device("cuda"))
    rounds = cell["params"]["rounds_per_call"]
    found = edge.gaps(e, edge.reference_readings(e, rounds, tf32=True),
                      edge.reference_readings(e, rounds))
    assert not compare.judge(found, cell["params"]["limits"]), found
