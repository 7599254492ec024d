"""The port's recurrent blocks against the reference's: the Mamba2 block
(``repro_torch.models.mamba2``: ``mamba_seq``, ``mamba_step``) and the
RWKV6 time and channel mixes (``repro_torch.models.rwkv6``:
``time_mix_seq``, ``time_mix_step``, ``channel_mix_seq``,
``channel_mix_step``), and cross- and non-causal attention
(``layers.attention_train`` with ``kv_x``, ``causal``, ``rope``,
``q_offset``), all in float32.

zamba2-2.7b and rwkv6-7b at ``reduce_for_smoke`` widths (d_model 256;
Mamba2: 16 heads of 32 channels, state 16, conv width 4; RWKV6: 8 heads
of 32). The weights are numpy normals (matrices scaled by 1/sqrt(fan
in); the decay and mixing vectors drawn away from their inits of zeros
and ones, so every term of the recurrences counts), carried to both
sides; the carried states are nonzero. The sequence blocks run with the
reference's default ``CHUNK = 0`` (the sequential recurrence) and with
``CHUNK = 16`` on both sides (the chunk-parallel forms), monkeypatched
as tests/test_perf_variants.py does. Tolerance: rel 1e-5 of every
output and state (||port - ref|| / ||ref||; the float32 bound of
tests/test_torch_transformer.py; seen: up to 1.6e-6).
"""
import numpy as np
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax.numpy as jnp

from repro.models import layers as ref_layers
from repro.models import mamba2 as ref_mamba2
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.models import layers, mamba2, rwkv6

from torch_parity import arch_pair

B, S, TOL = 2, 32, 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _weights(specs, seed):
    """numpy float32 weights for a flat spec dict: matrices normal /
    sqrt(fan in), vectors and the (k, d) mixing ratios as below."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in specs.items():
        if k == "mu":
            w = rng.uniform(0.1, 0.9, s.shape)
        elif k in ("a_log", "dt_bias", "w0"):
            w = 0.5 * rng.standard_normal(s.shape)
        elif len(s.shape) == 1 or k == "u":
            w = 1.0 + 0.3 * rng.standard_normal(s.shape)
        else:
            w = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        out[k] = w.astype(np.float32)
    return out


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _arr(rng, shape, scale=1.0):
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _check(got, want, where):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g = g.detach().to(torch.float32).numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape, (where, i)
        assert _rel(g, w) <= TOL, (where, i, _rel(g, w))


@pytest.fixture
def chunk(monkeypatch):
    """CHUNK on both sides of the given module pair."""
    def set_chunk(ref_mod, mod, n):
        monkeypatch.setattr(ref_mod, "CHUNK", n)
        monkeypatch.setattr(mod, "CHUNK", n)
    return set_chunk


@pytest.mark.parametrize("n_chunk", [0, 16])
def test_mamba_seq_matches_reference(chunk, n_chunk):
    chunk(ref_mamba2, mamba2, n_chunk)
    ref_cfg, cfg = arch_pair("zamba2-2.7b")
    s, d_in, H, conv_dim = mamba2.mamba_dims(cfg)
    assert mamba2.mamba_dims(cfg)[1:] == ref_mamba2.mamba_dims(ref_cfg)[1:]
    rp, tp = _both(_weights(mamba2.mamba_specs(cfg), 0))
    rng = np.random.default_rng(1)
    ru, tu = _arr(rng, (B, S, cfg.d_model))
    rh, th = _arr(rng, (B, H, s.head_dim, s.state_dim), 0.1)
    rc, tc = _arr(rng, (B, s.conv_width - 1, conv_dim), 0.5)
    want = ref_mamba2.mamba_seq(ref_cfg, rp, ru, rh, rc)
    got = mamba2.mamba_seq(cfg, tp, tu, th, tc)
    _check(got, want, f"mamba_seq CHUNK={n_chunk}")
    # a sequence that is not a multiple of CHUNK runs the recurrence
    want = ref_mamba2.mamba_seq(ref_cfg, rp, ru[:, :S - 3], rh, rc)
    got = mamba2.mamba_seq(cfg, tp, tu[:, :S - 3], th, tc)
    _check(got, want, f"mamba_seq S={S - 3} CHUNK={n_chunk}")


def test_mamba_step_matches_reference_and_mamba_seq():
    """Four steps against the reference's, and against the sequence block
    over the same four tokens from the same states."""
    ref_cfg, cfg = arch_pair("zamba2-2.7b")
    s, d_in, H, conv_dim = mamba2.mamba_dims(cfg)
    rp, tp = _both(_weights(mamba2.mamba_specs(cfg), 2))
    rng = np.random.default_rng(3)
    ru, tu = _arr(rng, (B, 4, cfg.d_model))
    rh, th = _arr(rng, (B, H, s.head_dim, s.state_dim), 0.1)
    rc, tc = _arr(rng, (B, s.conv_width - 1, conv_dim), 0.5)
    h0, c0 = th, tc
    outs = []
    for t in range(4):
        want = ref_mamba2.mamba_step(ref_cfg, rp, ru[:, t], rh, rc)
        got = mamba2.mamba_step(cfg, tp, tu[:, t], th, tc)
        _check(got, want, f"mamba_step {t}")
        outs.append(got[0])
        rh, rc = want[1], want[2]
        th, tc = got[1], got[2]
    y, h, c = mamba2.mamba_seq(cfg, tp, tu, h0, c0)
    assert _rel(torch.stack(outs, 1).numpy(), y.numpy()) <= TOL
    assert _rel(th.numpy(), h.numpy()) <= TOL
    assert torch.equal(tc, c)


@pytest.mark.parametrize("n_chunk", [0, 16])
def test_time_mix_seq_matches_reference(chunk, n_chunk):
    chunk(ref_rwkv6, rwkv6, n_chunk)
    ref_cfg, cfg = arch_pair("rwkv6-7b")
    H, hd = cfg.n_heads, cfg.head_dim
    rp, tp = _both(_weights(rwkv6.time_mix_specs(cfg), 4))
    rng = np.random.default_rng(5)
    rx, tx = _arr(rng, (B, S, cfg.d_model))
    rprev, tprev = _arr(rng, (B, cfg.d_model))
    rs, ts = _arr(rng, (B, H, hd, hd), 0.1)
    want = ref_rwkv6.time_mix_seq(ref_cfg, rp, rx, rprev, rs)
    got = rwkv6.time_mix_seq(cfg, tp, tx, tprev, ts)
    _check(got, want, f"time_mix_seq CHUNK={n_chunk}")


@pytest.mark.parametrize("n_chunk", [0, 16])
def test_channel_mix_seq_matches_reference(chunk, n_chunk):
    chunk(ref_rwkv6, rwkv6, n_chunk)
    ref_cfg, cfg = arch_pair("rwkv6-7b")
    rp, tp = _both(_weights(rwkv6.channel_mix_specs(cfg), 6))
    rng = np.random.default_rng(7)
    rx, tx = _arr(rng, (B, S, cfg.d_model))
    rprev, tprev = _arr(rng, (B, cfg.d_model))
    want = ref_rwkv6.channel_mix_seq(ref_cfg, rp, rx, rprev)
    got = rwkv6.channel_mix_seq(cfg, tp, tx, tprev)
    _check(got, want, f"channel_mix_seq CHUNK={n_chunk}")


def test_rwkv_steps_match_reference_and_the_sequence_blocks():
    """Four time-mix and channel-mix steps against the reference's, and
    against the sequence blocks over the same four tokens."""
    ref_cfg, cfg = arch_pair("rwkv6-7b")
    H, hd = cfg.n_heads, cfg.head_dim
    rtm, ttm = _both(_weights(rwkv6.time_mix_specs(cfg), 8))
    rcm, tcm = _both(_weights(rwkv6.channel_mix_specs(cfg), 9))
    rng = np.random.default_rng(10)
    rx, tx = _arr(rng, (B, 4, cfg.d_model))
    rprev, tprev = _arr(rng, (B, cfg.d_model))
    rs, ts = _arr(rng, (B, H, hd, hd), 0.1)
    s0, p0 = ts, tprev
    tm_out, cm_out = [], []
    for t in range(4):
        want = ref_rwkv6.time_mix_step(ref_cfg, rtm, rx[:, t], rprev, rs)
        got = rwkv6.time_mix_step(cfg, ttm, tx[:, t], tprev, ts)
        _check(got, want, f"time_mix_step {t}")
        want_c = ref_rwkv6.channel_mix_step(ref_cfg, rcm, rx[:, t], rprev)
        got_c = rwkv6.channel_mix_step(cfg, tcm, tx[:, t], tprev)
        _check(got_c, want_c, f"channel_mix_step {t}")
        tm_out.append(got[0])
        cm_out.append(got_c[0])
        rprev, rs = want[1], want[2]
        tprev, ts = got[1], got[2]
    seq, last, state = rwkv6.time_mix_seq(cfg, ttm, tx, p0, s0)
    assert _rel(torch.stack(tm_out, 1).numpy(), seq.numpy()) <= TOL
    assert _rel(state.numpy(), ts.numpy()) <= TOL
    assert torch.equal(last, tx[:, -1])
    cseq, _ = rwkv6.channel_mix_seq(cfg, tcm, tx, p0)
    assert _rel(torch.stack(cm_out, 1).numpy(), cseq.numpy()) <= TOL


@pytest.mark.parametrize("kw", [
    dict(causal=False, rope=False),                 # the encoder
    dict(causal=False, rope=False, cross=True),     # cross-attention
    dict(causal=True, rope=True, q_offset=5),       # self, offset queries
])
def test_attention_train_options_match_reference(kw):
    kw = dict(kw)
    cross = kw.pop("cross", False)
    ref_cfg, cfg = arch_pair("granite-8b")
    rp, tp = _both(_weights(layers.attention_specs(cfg), 11))
    rng = np.random.default_rng(12)
    rx, tx = _arr(rng, (B, 16, cfg.d_model))
    rk, tk = _arr(rng, (B, 24, cfg.d_model)) if cross else (None, None)
    want = ref_layers.attention_train(ref_cfg, rp, rx, kv_x=rk, **kw)
    got = layers.attention_train(cfg, tp, tx, kv_x=tk, **kw)
    _check((got,), (want,), f"attention_train {kw} cross={cross}")
