"""The dry run's count of a recurrence over time (``models.common.
time_scan`` under ``launch.op_analysis.OpCounter``): on meta tensors the
counter runs four steps of a scan and counts one of them n - 3 times
(``OpCounter.scan``), as the reference's HLO analysis counts a ``while``
body once times its trip count. Held here against the step-by-step run
(``time_scan`` replaced by its plain loop, ``common._loop``) of the same
step, at sequences of 12 to 32 steps (6 chunks of 2 in the chunked
forms), on reduced rwkv6-7b and zamba2-2.7b (``reduce_for_smoke``) on
the (2, 4) test mesh's fake process group: the train step (forward and
backward, with remat as by default and without it, the chunked
recurrences, and for rwkv6 the tensor-parallel step under each of the
residual stream's layouts) and prefill. FLOPs, bytes, the kernels'
reads, the collectives (count, kinds, operand and wire bytes, the log)
and the peak live bytes are all equal: the peak is exact, not bounded.
No jax is imported.
"""
import pytest
import torch

CASES = [
    ("rwkv6-7b", "train", 16, {}),
    ("rwkv6-7b", "train", 12, {"remat": False}),
    ("rwkv6-7b", "train", 12, {"rwkv_chunk": 2}),
    ("rwkv6-7b", "train", 16, {"act": "seq"}),
    ("rwkv6-7b", "train", 12, {"rules_override": {"act_embed": None}}),
    ("rwkv6-7b", "prefill", 32, {}),
    ("zamba2-2.7b", "train", 16, {}),
    ("zamba2-2.7b", "train", 12, {"remat": False}),
    ("zamba2-2.7b", "train", 12, {"mamba_chunk": 2, "remat": False}),
    ("zamba2-2.7b", "prefill", 32, {}),
]


def _records(arch, mode, seq, variant):
    """(scaled, step-by-step) counts of one step and their collective
    logs; the lengths of the scans the scaled run met, and of those its
    counter ran (``OpCounter.scan``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import fake_process_group, make_test_mesh
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models import common
    from repro_torch.models import mamba2, rwkv6
    saved = rwkv6.CHUNK, mamba2.CHUNK
    rwkv6.CHUNK = variant.get("rwkv_chunk", 0)
    mamba2.CHUNK = variant.get("mamba_chunk", 0)
    met, ran = [], []
    real = common.time_scan

    def seen(step, carry, n):
        met.append(n)
        return real(step, carry, n)

    class Counter(OpCounter):
        def scan(self, step, carry, n):
            ran.append(n)
            return super().scan(step, carry, n)
    fake_process_group(8)
    try:
        mesh = make_test_mesh(device_type="cpu")
        cfg = reduce_for_smoke(get_arch(arch))
        build = {"train": dryrun_lib.build_train,
                 "prefill": dryrun_lib.build_prefill}[mode]
        built = build(cfg, ShapeConfig("t", seq, 8, mode), mesh, variant)
        out = []
        for counter, scan in ((Counter, seen), (OpCounter, common._loop)):
            counter = counter(base=built.args_bytes)
            for mod in (rwkv6, mamba2):
                mod.time_scan = scan
            with counter:
                result = built.fn()
            del result
            out.append((counter.summary(), counter.coll_log))
        return out, met, ran
    finally:
        for mod in (rwkv6, mamba2):
            mod.time_scan = real
        rwkv6.CHUNK, mamba2.CHUNK = saved
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,mode,seq,variant", CASES)
def test_scaled_scan_counts_as_the_step_by_step_run(arch, mode, seq,
                                                    variant):
    ((scaled, log), (steps, step_log)), met, ran = _records(
        arch, mode, seq, variant)
    # the counter ran every scan long enough to be scaled, and only those
    assert ran and ran == [n for n in met if n > 4]
    assert scaled == steps
    assert log == step_log
    assert scaled["flops"] > 0 and scaled["peak_bytes"] > 0
    if mode == "train":
        assert scaled["kernel_read_bytes"] > 0


def test_real_tensors_run_every_step():
    # on CPU tensors the counter leaves the recurrence to run step by
    # step: the logits are bitwise those of the forward without it
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models import build_model
    cfg = reduce_for_smoke(get_arch("rwkv6-7b"))
    model = build_model(cfg, remat=False)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = {k: v.float() for k, v in model.init(gen).items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": tokens})
        counter = OpCounter()
        with counter:
            got, _ = model.forward(params, {"tokens": tokens})
    assert torch.equal(got, want)
    assert counter.flops > 0
