"""The yardstick's arithmetic against hand-worked numbers: the union of
device intervals, the idle share and gaps, rooflines, MFU, the model
FLOPs and the kernels' bytes."""
import math

import pytest

from ltflbench import counts, trace


def test_union_counts_overlaps_once_and_clips():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert trace.union_ns(spans, 0, 100) == 15 + 10 + 10
    assert trace.union_ns(spans, 8, 45) == 7 + 10 + 5
    assert trace.union_ns([], 0, 10) == 0


def _trace():
    t = trace.Trace(window_ns=(0, 1_000_000_000))
    t.device = [("void stochastic_quant_kernel<Bf16>(...)", 0, 100_000_000),
                ("sm90_xmma_gemm_bf16", 50_000_000, 400_000_000),
                ("void apply_block_mask_kernel<Bf16>", 600_000_000,
                 700_000_000)]
    t.host = [("ltflbench.step", 0, 1_000_000_000),
              ("aten::argsort", 420_000_000, 590_000_000),
              ("cudaStreamSynchronize", 750_000_000, 990_000_000)]
    return t


def test_busy_idle_and_shares():
    t = _trace()
    assert t.window_s == 1.0
    assert t.busy_s == pytest.approx(0.5)
    assert trace.idle_share(t) == pytest.approx(50.0)
    assert t.kernel_s((r"stochastic_quant_kernel",)) == pytest.approx(0.1)
    assert trace.share(t, (r"(?i:gemm)",)) == pytest.approx(70.0)
    assert trace.share(t, (r"nothing_like_this",)) is None


def test_idle_gaps_named_by_innermost_host_event():
    gaps = trace.idle_gaps(_trace())
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(0.3)]
    assert gaps[1] == ["aten::argsort", pytest.approx(0.2)]
    assert len(gaps) == 2


def test_top_device_ops_sum_by_name():
    ops = trace.top_device_ops(_trace())
    assert ops[0] == ["sm90_xmma_gemm_bf16", pytest.approx(0.35)]
    assert [n for n, _ in ops][1:] == [
        "void stochastic_quant_kernel<Bf16>(...)",
        "void apply_block_mask_kernel<Bf16>"]


def test_roofline_and_mfu():
    # 3.35 GB in 2 ms: the bandwidth bound is 1 ms, half the time
    assert counts.roofline_share(3.35e9, 0.0, 2e-3, 989e12) \
        == pytest.approx(50.0)
    # 989 GFLOP in 1 ms at 989 TFLOP/s: the operation bound, all of it
    assert counts.roofline_share(0.0, 989e9, 1e-3, 989e12) \
        == pytest.approx(100.0)
    assert counts.mfu(98.9e12, 1.0, 989e12) == pytest.approx(10.0)


def test_granite_counts():
    per_layer = counts.lm_matmul_params(4096, 32, 8, 128, 14336, 1, 0)
    assert per_layer == 218_103_808
    head = counts.lm_matmul_params(4096, 32, 8, 128, 14336, 0, 49152)
    assert head == 201_326_592
    flops = counts.lm_train_flops(4096, 32, 8, 128, 14336, 4, 49152, 8,
                                  2048)
    matmuls = 6 * (4 * per_layer + head) * 16384
    attn = 6 * 2048 ** 2 * 4096 * 4 * 8
    assert flops == pytest.approx(matmuls + attn)
    assert flops == pytest.approx(108.8e12, rel=2e-3)


def test_resnet_forward_flops_by_hand():
    f = counts.resnet_forward_flops(32, 3, 64, (64, 128, 256, 512),
                                    (1, 1, 1, 1), 10)
    conv = lambda k, ci, co, hw: 2 * k * k * ci * co * hw * hw  # noqa: E731
    hand = (conv(3, 3, 64, 32) + 2 * conv(3, 64, 64, 32)
            + conv(1, 64, 128, 16) + conv(3, 64, 128, 16)
            + conv(3, 128, 128, 16)
            + conv(1, 128, 256, 8) + conv(3, 128, 256, 8)
            + conv(3, 256, 256, 8)
            + conv(1, 256, 512, 4) + conv(3, 256, 512, 4)
            + conv(3, 512, 512, 4) + 2 * 512 * 10)
    assert f == hand
    assert math.isclose(f, 0.5068e9, rel_tol=1e-3)


def test_kernel_bytes_by_hand():
    # two leaves of 1,000 and 24 elements, 4 clients, bf16
    assert counts.quant_bytes([1000, 24], 4, 2) == 2 * 2 * 4 * 1024 \
        + 12 * 4 * 2
    # one 64 x 64 leaf in 32 x 32 tiles (4 tiles), 4 clients, bf16
    n, tiles = 4096, 4
    assert counts.prune_bytes([n], 4, 2, 32) == (
        2 * n + 4 * tiles + 2 * 4 * n + 2 * 2 * 4 * n + 2 * 4 * tiles)


@pytest.mark.parametrize("key", sorted(counts.PEAK_FLOPS))
def test_peaks_are_the_data_sheets(key):
    assert counts.PEAK_FLOPS[key] in (989e12, 495e12, 67e12, 1979e12)
