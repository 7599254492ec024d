"""The port's SSM family (``RWKVLM``, rwkv6-7b) and hybrid family
(``HybridLM``, zamba2-2.7b: Mamba2 layers and one shared attention +
MLP block) against the reference's, in float32 at ``reduce_for_smoke``
widths (2 layers, d_model 256; zamba2 one segment of 2 Mamba layers):
the tree's structure, forward, loss and every gradient, prefill and its
cache, a chain of decode steps, prefill-then-decode against forward, and
greedy generation through ``launch.serve.generate``. The checks, their
inputs and tolerances are ``torch_parity``'s family checks.
"""
import pytest

# the JAX reference; the machine with the card has no jax, so there
# this module skips (its tests compare against the reference)
pytest.importorskip("jax")

from torch_parity import (
    FamilyPair,
    check_decode_from_the_prefill_cache,
    check_forward_loss_and_gradients,
    check_greedy_generation,
    check_prefill_and_decode_chain,
    check_prefill_then_decode,
    check_structure,
)


@pytest.fixture(scope="module", params=["rwkv6-7b", "zamba2-2.7b"])
def pair(request):
    return FamilyPair(request.param)


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


def test_decode_reads_the_float32_prefill_cache_as_given(pair):
    check_decode_from_the_prefill_cache(pair)
