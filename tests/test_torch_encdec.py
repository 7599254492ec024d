"""The port's encoder-decoder family (``EncDecLM``, whisper-medium)
against the reference's at ``reduce_for_smoke`` widths (2 encoder and 2
decoder layers over 16 frames).

The reference's encoder takes its frames in bfloat16 and its
``lax.scan`` cannot carry them up to float32, so the encoder's leaves
are bfloat16 on both sides and the rest float32. The decoder (the tree's
structure, forward, loss, the decoder's gradients, prefill and its
caches, a chain of decode steps, prefill-then-decode against forward,
greedy generation) is held in float32 on the reference's encoder output
with ``torch_parity``'s family checks and tolerances. The encoder is
held to the bf16 noise: the port's bfloat16 encoder output, and the
encoder leaves' gradients, no farther from the port's float32 encoder on
the same (bf16-valued) weights than 1.25 times the reference's bf16 ones
are (tests/test_torch_moe.py's rule for bf16).
"""
import pytest
import torch

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")
import jax

from repro_torch.models import build_model, params_from_numpy

from torch_parity import (
    FS,
    FamilyPair,
    as_np,
    check_forward_loss_and_gradients,
    check_greedy_generation,
    check_prefill_and_decode_chain,
    check_prefill_then_decode,
    check_structure,
    rel,
)


@pytest.fixture(scope="module")
def pair():
    return FamilyPair("whisper-medium")


def test_structure_matches_reference(pair):
    check_structure(pair)


def test_forward_loss_and_gradients_match_reference(pair):
    check_forward_loss_and_gradients(pair)


def test_prefill_and_decode_chain_match_reference(pair):
    check_prefill_and_decode_chain(pair)


def test_prefill_then_decode_is_forward(pair):
    check_prefill_then_decode(pair)


def test_greedy_generation_matches_reference_serve_loop(pair):
    check_greedy_generation(pair)


def test_encoder_matches_reference_to_the_bf16_noise(pair):
    """whisper's encoder with bfloat16 leaves, both sides, against the
    port's float32 encoder on the same (bf16-valued) weights; and the
    encoder leaves' gradients of the whole model the same way."""
    model = build_model(pair.cfg)               # its own encode
    p32 = {k: v.to(torch.float32) for k, v in pair.params.items()}
    t16 = as_np(model.encode(pair.params, pair.frames))
    t32 = as_np(model.encode(p32, pair.frames))
    assert rel(t16, t32) <= 1.25 * rel(as_np(pair.ref_enc), t32)

    rb, tb = pair.batches(FS)
    rg = jax.jit(jax.grad(pair.ref_model.loss))(pair.ref_params, rb)
    ref_grads = params_from_numpy(jax.tree_util.tree_map(as_np, rg))
    g16 = torch.func.grad(model.loss)(pair.params, tb)
    g32 = torch.func.grad(model.loss)(p32, tb)
    for k in g16:
        if k.startswith("encoder."):
            noise = rel(ref_grads[k].numpy(), as_np(g32[k]))
            assert rel(as_np(g16[k]), as_np(g32[k])) <= 1.25 * noise, k
