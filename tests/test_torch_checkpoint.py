"""Checkpoints cross-loaded with the reference, and the host data pieces
that came with them, bitwise.

* A reference-saved checkpoint (nested tree, a bfloat16 leaf, ints)
  restored by the port, and a port-saved one (flat dotted parameter
  names, a bfloat16 tensor) restored by the reference: every leaf
  bitwise, dtypes kept, ``latest_step`` equal on both sides.
* ``synthetic_lm``, ``ArrayDataset.epochs`` and
  ``ClientBatcher.client_sizes`` / ``padded_parts`` (both partition
  forms, an empty shard included) against the reference's.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint import latest_step as ref_latest_step
from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro.data import ArrayDataset as RefArrayDataset
from repro.data import ClientBatcher as RefClientBatcher
from repro.data import population_partition as ref_population_partition
from repro.data import synthetic_lm as ref_synthetic_lm
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.data import (
    ArrayDataset,
    ClientBatcher,
    population_partition,
    synthetic_lm,
)
from repro_torch.models import params_from_numpy


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"layers": [{"w": rng.normal(size=(3, 4))
                                   .astype(np.float32)},
                                  {"w": rng.normal(size=(2,))
                                   .astype(np.float32)}],
                       "emb": jnp.asarray(rng.normal(size=(5, 3)),
                                          jnp.bfloat16)},
            "step": np.int32(7)}
    ref_save(str(tmp_path), 3, tree)
    ref_save(str(tmp_path), 12, tree, metadata={"note": "x"})
    assert latest_step(str(tmp_path)) == ref_latest_step(str(tmp_path)) \
        == 12
    target = {"params": {"layers": [{"w": torch.zeros(3, 4)},
                                    {"w": torch.zeros(2)}],
                         "emb": torch.zeros(5, 3, dtype=torch.bfloat16)},
              "step": np.int32(0)}
    got = restore(str(tmp_path), target)
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["emb"].view(torch.int16),
                       torch.from_numpy(np.array(
                           tree["params"]["emb"]).view(np.int16)))
    for i in range(2):
        np.testing.assert_array_equal(
            got["params"]["layers"][i]["w"].numpy(),
            tree["params"]["layers"][i]["w"])
    assert got["step"] == 7 and got["step"].dtype == np.int32
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), target)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rng = np.random.default_rng(1)
    ref_tree = {"groups": [[{"conv1": rng.normal(size=(3, 3, 2, 4))
                             .astype(np.float32)}]],
                "head": {"w": rng.normal(size=(4, 10)).astype(np.float32),
                         "b": jnp.asarray(rng.normal(size=(10,)),
                                          jnp.bfloat16)}}
    params = params_from_numpy(ref_tree)       # flat dotted names
    assert "groups.0.0.conv1" in params
    assert params["head.b"].dtype == torch.bfloat16
    path = save(str(tmp_path), 5, {"params": params})
    assert path.endswith("step_00000005.npz")
    assert ref_latest_step(str(tmp_path)) == 5
    got = ref_restore(str(tmp_path), {"params": ref_tree})
    assert got["params"]["head"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got["params"]["head"]["b"]),
                                  _bits(ref_tree["head"]["b"]))
    np.testing.assert_array_equal(
        np.asarray(got["params"]["groups"][0][0]["conv1"]),
        ref_tree["groups"][0][0]["conv1"])
    np.testing.assert_array_equal(np.asarray(got["params"]["head"]["w"]),
                                  ref_tree["head"]["w"])
    # and back into the port's flat dict
    again = restore(str(tmp_path), {"params": params})["params"]
    for k, v in params.items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k


def test_synthetic_lm_and_epochs_match_the_reference():
    for kw in (dict(seed=0), dict(seed=3, period=8, noise=0.0)):
        np.testing.assert_array_equal(synthetic_lm(6, 37, 100, **kw),
                                      ref_synthetic_lm(6, 37, 100, **kw))
    arrays = {"x": np.arange(23), "y": np.arange(23) * 2}
    port = ArrayDataset(arrays).epochs(5, np.random.default_rng(0))
    ref = RefArrayDataset(arrays).epochs(5, np.random.default_rng(0))
    for _ in range(10):                      # past the first epoch's end
        a, b = next(port), next(ref)
        for k in arrays:
            np.testing.assert_array_equal(a[k], b[k])


def test_client_sizes_and_padded_parts_match_the_reference():
    data = {"x": np.arange(100)}
    sizes = np.array([5, 0, 12, 3, 7])
    packed = population_partition(100, sizes, np.random.default_rng(0))
    ref_packed = ref_population_partition(100, sizes,
                                          np.random.default_rng(0))
    listed = [np.arange(4), np.arange(10, 19), np.arange(30, 31)]
    for parts, ref_parts in ((packed, ref_packed), (listed, listed)):
        port = ClientBatcher(ArrayDataset(data), parts)
        ref = RefClientBatcher(RefArrayDataset(data), ref_parts)
        np.testing.assert_array_equal(port.client_sizes(),
                                      ref.client_sizes())
        for width in (None, 20):
            np.testing.assert_array_equal(port.padded_parts(width),
                                          ref.padded_parts(width))
