"""The port's rule table (``repro_torch.launch.sharding``) and the
logical axes of every model against the reference's.

The seven assertions of tests/test_sharding_rules.py, restated on the
port's ``AbstractMesh``; then, for every architecture and variant of
the configuration registry at its published widths: each parameter
leaf's shape and logical axes (flattened by ``models.convert``'s dotted
paths), the cache axes, and each leaf's ``make_pspec`` on the (16, 16)
and (2, 16, 16) meshes with fsdp on and off and every client-axis choice,
entry by entry against the reference's ``make_pspec`` called on a
duck-typed mesh (the reference's rule functions read only
``axis_names`` and ``shape``; no jax devices are made). The placements
of a spec are checked on a fake process group of 256 ranks.
"""
import pytest

from repro_torch import configs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (
    AbstractMesh,
    client_axes,
    fake_process_group,
    make_production_mesh,
    num_clients,
)
from repro_torch.models import build_model
from repro_torch.models.common import logical_axes
from repro_torch.models.convert import _walk

MESH = AbstractMesh((("data", 16), ("model", 16)))
MESH3 = AbstractMesh((("pod", 2), ("data", 16), ("model", 16)))
NAMES = configs.list_archs() + sorted(configs.VARIANTS)


def test_divisible_dims_shard():
    rules = sh.base_rules(MESH)
    assert sh.make_pspec((4096, 14336), ("embed", "d_ff"), rules,
                         MESH) == (None, "model")


def test_indivisible_head_falls_back_to_head_dim():
    rules = sh.base_rules(MESH)
    spec = sh.make_pspec((96, 128, 32768, 8, 192),
                         ("layers", "batch", "seq", "kv_heads", "head_dim"),
                         rules, MESH)
    assert spec == (None, "data", None, None, "model")


def test_divisible_kv_keeps_heads_and_dedupes_head_dim():
    rules = sh.base_rules(MESH)
    spec = sh.make_pspec((36, 128, 32768, 16, 128),
                         ("layers", "batch", "seq", "kv_heads", "head_dim"),
                         rules, MESH)
    assert spec == (None, "data", None, "model", None)


def test_client_axis_consumes_data():
    rules = sh.base_rules(MESH, client_axes=("data",))
    spec = sh.make_pspec((16, 16, 4096), ("client", "batch", "seq"),
                         rules, MESH)
    assert spec == ("data", None, None)


def test_multi_pod_batch():
    rules = sh.base_rules(MESH3)
    assert sh.make_pspec((256, 4096), ("batch", "seq"), rules,
                         MESH3) == (("pod", "data"), None)


def test_fsdp_shards_embed_over_data():
    rules = sh.base_rules(MESH, fsdp=True)
    assert sh.make_pspec((18432, 73728), ("embed", "d_ff"), rules,
                         MESH) == ("data", "model")


def test_batch_of_one_replicates():
    rules = sh.base_rules(MESH)
    assert sh.make_pspec((1,), ("batch",), rules, MESH) == (None,)


def test_placements_nest_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    spec = (("pod", "data"), None, "model")
    assert sh.placements(spec, MESH3) == (Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, None), MESH3) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements((("data", "pod"),), MESH3)
    assert sh.NamedSharding(MESH3, spec).local_shape((64, 3, 32)) == \
        (2, 3, 2)


def test_client_axes_and_counts():
    assert num_clients(MESH, False) == 16 and num_clients(MESH, True) == 1
    assert num_clients(MESH3, False) == 32 and num_clients(MESH3, True) == 2
    assert client_axes(True, False) == ("pod", "data")
    assert client_axes(False, True) == ()


@pytest.mark.parametrize("builder", ["production", "test"])
def test_mesh_builders_need_a_device_type(builder):
    # a caller who does not name the card gets an error, not a CPU mesh
    from repro_torch.launch.mesh import make_test_mesh
    build = make_production_mesh if builder == "production" \
        else make_test_mesh
    with pytest.raises(TypeError):
        build()


def test_device_mesh_placements_on_a_fake_group():
    import torch
    import torch.distributed as dist
    fake_process_group(256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (16, 16)
        rules = sh.base_rules(mesh)
        model = build_model(configs.get_arch("granite-8b"))
        psh = sh.param_shardings(mesh, model, rules)
        ab = sh.param_shardings(MESH, model, sh.base_rules(MESH))
        assert {k: v.spec for k, v in psh.items()} == \
            {k: v.spec for k, v in ab.items()}
        from torch.distributed.tensor import Replicate, Shard
        w = psh["layers.ffn.wi_gate"]
        assert w.spec == (None, None, "model")
        assert w.local_shape((36, 4096, 14336)) == (36, 4096, 896)
        d = sh.from_local(torch.empty((4096, 896), device="meta"),
                          sh.NamedSharding(mesh, (None, "model")),
                          (4096, 14336))
        assert d.placements == (Replicate(), Shard(1))
        assert tuple(d.shape) == (4096, 14336)
    finally:
        dist.destroy_process_group()


def test_shard_hint_redistributes_in_a_scope():
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import logical_rule_scope, shard_hint
    fake_process_group(8)
    try:
        mesh = make_test_mesh(device_type="cpu")
        rules = sh.base_rules(mesh)
        x = distribute_tensor(torch.empty((8, 16, 32), device="meta"), mesh,
                              [Replicate(), Replicate()])
        axes = ("batch", "act_seq", "act_embed")
        assert shard_hint(x, axes) is x                  # no scope
        plain = torch.ones(8, 16, 32)
        with logical_rule_scope(rules, mesh):
            y = shard_hint(x, axes)
            assert shard_hint(plain, axes) is plain      # not a DTensor
        assert y.placements == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (4, 16, 8)
        model = build_model(configs.get_arch("granite-8b"))
        cache = model.abstract_cache(128, 4096)
        csh = sh.cache_shardings(mesh, rules, model, cache)
        assert csh["k"].spec == (None, "data", None, "model", None)
        assert csh["k"].placements == (Shard(1), Shard(3))
        assert sh.replicated(mesh).placements == (Replicate(), Replicate())
        bsh = sh.batch_shardings(mesh, rules, {"tokens": cache["k"][0]})
        assert bsh["tokens"].spec == ("data", None, None, None)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# against the reference
# --------------------------------------------------------------------------- #
jax = pytest.importorskip("jax")
from repro import configs as ref_configs                       # noqa: E402
from repro.launch import sharding as ref_sh                     # noqa: E402
from repro.models import build_model as ref_build_model         # noqa: E402


class _DuckMesh:
    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)


def _ref_flat(tree):
    return dict(_walk(tree, ""))


def _pair(name):
    ref = ref_build_model(ref_configs.get_arch(name))
    port = build_model(configs.get_arch(name))
    return ref, port


@pytest.mark.parametrize("name", NAMES)
def test_shapes_and_logical_axes(name):
    ref, port = _pair(name)
    ref_specs = _ref_flat(ref.param_specs())
    specs = port.param_specs()
    assert list(specs) == list(ref_specs)
    axes = logical_axes(specs)
    for k, s in specs.items():
        assert s.shape == tuple(ref_specs[k].shape), k
        assert axes[k] == tuple(ref_specs[k].axes), k
    abstract = port.abstract_params()
    assert all(v.device.type == "meta" and tuple(v.shape) == specs[k].shape
               for k, v in abstract.items())


@pytest.mark.parametrize("name", NAMES)
def test_cache_axes(name):
    ref, port = _pair(name)
    assert port.cache_axes() == ref.cache_axes()
    ref_cache = ref.abstract_cache(8, 64)
    cache = port.abstract_cache(8, 64)
    assert list(cache) == list(ref_cache)
    for k, v in cache.items():
        assert tuple(v.shape) == tuple(ref_cache[k].shape), k
        assert len(port.cache_axes()[k]) == v.dim(), k


def _client_choices(mesh):
    if "pod" in mesh.axis_names:
        return [(), ("pod",), ("pod", "data")]
    return [(), ("data",)]


@pytest.mark.parametrize("fsdp", [False, True], ids=["baseline", "fsdp"])
@pytest.mark.parametrize("mesh", [MESH, MESH3], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", NAMES)
def test_make_pspec_matches_reference(name, mesh, fsdp):
    ref, port = _pair(name)
    duck = _DuckMesh(mesh)
    specs = port.param_specs()
    cache = port.abstract_cache(128, 4096)
    checked = 0
    for ca in _client_choices(mesh):
        rules = sh.base_rules(mesh, fsdp=fsdp, client_axes=ca)
        ref_rules = ref_sh.base_rules(duck, fsdp=fsdp, client_axes=ca)
        assert {k: rules[k] for k in ref_rules} == ref_rules
        for k, s in specs.items():
            for shape, axes in ((s.shape, s.axes),
                                ((16,) + s.shape, ("client",) + s.axes)):
                got = sh.make_pspec(shape, axes, rules, mesh)
                want = tuple(ref_sh.make_pspec(shape, axes, ref_rules, duck))
                want += (None,) * (len(got) - len(want))
                assert got == want, (k, axes, ca)
                sh.placements(got, mesh)        # mesh order holds
                checked += 1
        for k, v in cache.items():
            ax = port.cache_axes()[k]
            got = sh.make_pspec(tuple(v.shape), ax, rules, mesh)
            want = tuple(ref_sh.make_pspec(tuple(v.shape), ax, ref_rules,
                                           duck))
            assert got == want + (None,) * (len(got) - len(want)), k
    assert checked >= 2 * len(specs)


def test_policy_matches_reference():
    for name in NAMES:
        assert sh.policy_for(configs.get_arch(name)) == \
            ref_sh.policy_for(ref_configs.get_arch(name))
