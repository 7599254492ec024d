"""The registry in blocks (``population_sharding``) against the host
``Population`` path, the unsplit device registry and the reference.

The reference (tests/test_sharded_population.py) runs S = 1 in process
and S = 8 in subprocesses with 8 virtual XLA devices. The port keeps one
controller, so S = 1 and S = 8 both run here in one process, every block
on the CPU:

* layout: ``device_population`` pads N = 23 and N = 1003 (to 1008 over 8
  blocks) with copies of device 0; the mesh helpers and their guards;
* samplers: the sharded channel-aware cohort equals the host
  ``ChannelAwareSampler.select`` bitwise (ties to the lower index across
  blocks too); uniform cohorts are valid with pi = U/N and never draw the
  pad; the energy-aware pi follows the host's first-order convention
  (rel 5e-3: float32 blocks against float64 host weights) and its
  empirical inclusion over 400 draws is within abs 0.08 of it (the
  reference's bounds); explore slots reach outside the top set; the
  per-block cohort guard;
* gathers: ``gather_cohort_dev`` and ``gather_parts_dev`` equal
  ``take`` / ``index_select`` on the unsplit registry bitwise, with
  zero-sample devices and the partition's wrap regime;
* the lazy refresh touches only scheduled, stale devices;
* the engine: cohorts equal ``FedRunner``'s on a static channel, one
  registry upload across runs, only ever-scheduled devices advance their
  fading epoch, uniform sampling with ``participation="unbiased"``, the
  guards, sweep lanes (seed and U grids) bitwise their solo runs, and
  S = 8 against S = 1 (cohorts and fading bitwise, loss rel 1e-6);
* against the reference at its in-process S = 1 mesh, on the same numpy
  inputs with the reference's fresh fading draws injected:
  ``gather_cohort_dev``, ``gather_parts_dev``, ``refresh_cohort_dev`` and
  ``host_sync`` bitwise; the channel-aware cohort bitwise, its float32
  SNR scores at rel 1e-6.
"""
import copy

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.configs.base import LTFLConfig as RefLTFLConfig
from repro.control.device_samplers import \
    sharded_channel_aware_twin as ref_sharded_channel_aware_twin
from repro.core.channel import _mean_gain_dev as ref_mean_gain_dev
from repro.core.channel import _noise_dev as ref_noise_dev
from repro.core.channel import draw_fading_dev as ref_draw_fading_dev
from repro.fed import Population as RefPopulation
from repro.fed import device_population as ref_device_population
from repro.fed.population import gather_cohort_dev as ref_gather_cohort_dev
from repro.fed.population import gather_parts_dev as ref_gather_parts_dev
from repro.fed.population import host_sync as ref_host_sync
from repro.fed.population import refresh_cohort_dev as ref_refresh_cohort_dev
from repro.launch.sharding import population_mesh as ref_population_mesh
from repro_torch.configs import LTFLConfig
from repro_torch.control.device_samplers import (
    sharded_channel_aware_twin,
    sharded_energy_aware_twin,
    sharded_uniform_twin,
)
from repro_torch.core.channel import ChannelArrays, _mean_gain_dev, \
    _noise_dev, expected_rate
from repro_torch.data import population_partition
from repro_torch.fed import (
    ChannelAwareSampler,
    EnergyAwareSampler,
    FedRunner,
    FedSGDScheme,
    LaneSpec,
    Population,
    ScanRunner,
    SweepSpec,
    UniformSampler,
    device_population,
)
from repro_torch.fed.population import (
    gather_cohort_dev,
    gather_parts_dev,
    host_sync,
    refresh_cohort_dev,
)
from repro_torch.launch.sharding import (
    PopMesh,
    population_blocks,
    population_mesh,
    population_pad,
)

from torch_parity import mlp_world

LTFL = LTFLConfig(num_devices=4, samples_min=40, samples_max=60,
                  bo_iters=3, alt_max_iters=2)
REF_LTFL = RefLTFLConfig(num_devices=4, samples_min=40, samples_max=60,
                         bo_iters=3, alt_max_iters=2)
SHARDS = [1, 8]


def cpu_mesh(s):
    return population_mesh(s, devices=["cpu"] * s)


def population(seed, n, dtype=np.float64):
    return Population.sample(LTFL.wireless, n, 40, 60,
                             np.random.default_rng(seed), dtype=dtype)


def unsplit(blocks):
    return torch.cat(list(blocks))


def generator(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


@pytest.fixture(scope="module")
def world():
    return mlp_world()


# --------------------------------------------------------------------------- #
# layout
# --------------------------------------------------------------------------- #
def test_population_dtype_policy():
    """The storage dtype never changes which devices a seed registers."""
    p64, p32 = population(3, 50), population(3, 50, np.float32)
    assert p64.channel.fading_mean.dtype == np.float64
    for name in ("distance", "fading_mean", "interference", "cpu_hz"):
        a64, a32 = getattr(p64.channel, name), getattr(p32.channel, name)
        assert a32.dtype == np.float32
        np.testing.assert_array_equal(a32, a64.astype(np.float32))
    np.testing.assert_array_equal(p32.channel.num_samples,
                                  p64.channel.num_samples)


@pytest.mark.parametrize("n,s", [(23, 1), (23, 8), (1003, 8)])
def test_device_population_layout(n, s):
    pop = population(7, n)
    mesh = cpu_mesh(s)
    dev = device_population(pop, mesh)
    n_pad = population_pad(n, mesh)
    assert n_pad == -(-n // s) * s
    assert (n, s) != (1003, 8) or n_pad == 1008
    assert len(dev.channel) == len(dev.fading_epoch) == s
    for f in ChannelArrays._fields:
        got = unsplit(getattr(c, f) for c in dev.channel)
        assert got.shape == (n_pad,) and got.dtype == torch.float32
        want = getattr(pop.channel, f).astype(np.float32)
        np.testing.assert_array_equal(got[:n].numpy(), want)
        # the pad repeats device 0
        np.testing.assert_array_equal(got[n:].numpy(),
                                      np.full(n_pad - n, want[0]))
    epochs = unsplit(dev.fading_epoch)
    assert epochs.dtype == torch.int32 and epochs.shape == (n_pad,)
    assert dev.epoch == pop.epoch


def test_population_mesh_helpers():
    mesh = cpu_mesh(8)
    assert mesh.axis_names == ("pop",) and mesh.shape == {"pop": 8}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    blocks = population_blocks(np.arange(16), mesh)
    assert [b.tolist() for b in blocks[:2]] == [[0, 1], [2, 3]]
    src = np.arange(8, dtype=np.float32)
    population_blocks(src, population_mesh(1, devices=["cpu"]))[0][0] = 9
    assert src[0] == 0                   # a block never aliases its source
    with pytest.raises(ValueError, match="equal"):
        population_blocks(np.arange(15), mesh)
    with pytest.raises(ValueError, match="mixed"):
        population_mesh(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="num_shards"):
        population_mesh(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        # no cards: a mesh of cards raises, it does not fall back
        with pytest.raises(ValueError, match="num_shards"):
            population_mesh(1)


# --------------------------------------------------------------------------- #
# sharded twins
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n,u", [(23, 3), (1003, 16)])
def test_sharded_channel_aware_matches_host(n, u, s):
    pop = population(5, n)
    host_idx, _ = ChannelAwareSampler().select(
        pop, u, 0, np.random.default_rng(0), LTFL)
    mesh = cpu_mesh(s)
    twin = sharded_channel_aware_twin(n, u, LTFL, mesh)
    idx, pi = twin.select(device_population(pop, mesh).channel,
                          generator(0))
    assert pi is None and not twin.provides_inclusion
    np.testing.assert_array_equal(idx.numpy(), host_idx)


def test_sharded_channel_aware_ties_go_to_the_lower_index():
    """Devices with one channel tie exactly; across blocks as within one,
    the lower global index wins, as the host's stable sort."""
    pop = population(1, 40)
    ch = pop.channel
    w = LTFL.wireless
    best = int(np.argmax(expected_rate(w, ch, np.full(40, w.p_max))))
    for i in (3, 9, 17, 30, 38):
        for f in ("distance", "fading_mean", "interference"):
            getattr(ch, f)[i] = getattr(ch, f)[best]
    host_idx, _ = ChannelAwareSampler().select(
        pop, 4, 0, np.random.default_rng(0), LTFL)
    mesh = cpu_mesh(8)
    idx, _ = sharded_channel_aware_twin(40, 4, LTFL, mesh).select(
        device_population(pop, mesh).channel, generator(0))
    np.testing.assert_array_equal(idx.numpy(), host_idx)
    assert list(host_idx) == sorted({3, 9, 17, 30, 38, best})[:4]


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_uniform_draws_valid_cohorts(s):
    n, u = 1003, 16
    mesh = cpu_mesh(s)
    twin = sharded_uniform_twin(n, u, mesh, seed=3)
    ch = device_population(population(5, n), mesh).channel
    seen = set()
    for _ in range(6):
        idx, pi = twin.select(ch, generator(0))
        idx = idx.numpy()
        assert idx.shape == (u,) and np.all(np.diff(idx) > 0)
        assert np.all((idx >= 0) & (idx < n))       # the pad never drawn
        np.testing.assert_allclose(pi.numpy(), u / n, rtol=1e-6)
        seen.add(tuple(idx))
    assert len(seen) == 6                # the block generators advance


def test_sharded_uniform_full_cohort_is_the_identity():
    mesh = cpu_mesh(1)
    twin = sharded_uniform_twin(12, 12, mesh)
    gen = generator(0)
    state = gen.get_state()
    idx, pi = twin.select(device_population(population(0, 12),
                                            mesh).channel, gen)
    assert idx.tolist() == list(range(12)) and torch.all(pi == 1.0)
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_energy_pi_matches_host_convention(s):
    n, u = 1003, 16
    pop = population(5, n)
    w = EnergyAwareSampler().headroom(pop, LTFL)
    w = w / np.sum(w)
    mesh = cpu_mesh(s)
    twin = sharded_energy_aware_twin(LTFL, n, u, mesh, seed=1)
    idx, pi = twin.select(device_population(pop, mesh).channel,
                          generator(0))
    idx, pi = idx.numpy(), pi.numpy()
    assert len(np.unique(idx)) == u and np.all(idx < n)
    assert np.all(np.diff(idx) > 0)
    np.testing.assert_allclose(pi, np.clip(u * w[idx], 1e-9, 1.0),
                               rtol=5e-3)


def test_sharded_energy_empirical_inclusion():
    """The empirical inclusion of the two-stage Gumbel-top-k draw over 4
    blocks matches the reported first-order pi."""
    pop = population(11, 32)
    mesh = cpu_mesh(4)
    twin = sharded_energy_aware_twin(LTFL, 32, 8, mesh, seed=7)
    ch = device_population(pop, mesh).channel
    counts = np.zeros(32)
    trials = 400
    for _ in range(trials):
        idx, _ = twin.select(ch, generator(0))
        counts[idx.numpy()] += 1
    w = EnergyAwareSampler().headroom(pop, LTFL)
    np.testing.assert_allclose(counts / trials,
                               np.clip(8 * w / np.sum(w), 1e-9, 1.0),
                               atol=0.08)


def test_sharded_explore_reaches_outside_the_top_set():
    n, u = 200, 8
    pop = population(2, n)
    host_top, _ = ChannelAwareSampler().select(
        pop, u - 2, 0, np.random.default_rng(0), LTFL)
    mesh = cpu_mesh(8)
    twin = sharded_channel_aware_twin(n, u, LTFL, mesh, explore=0.25)
    ch = device_population(pop, mesh).channel
    outside = set()
    for _ in range(5):
        idx, _ = twin.select(ch, generator(0))
        idx = set(idx.tolist())
        assert len(idx) == u and set(host_top) <= idx
        outside |= idx - set(host_top)
    assert len(outside) > 2


def test_cohort_guard_rejects_cohort_larger_than_block():
    with pytest.raises(ValueError, match="block"):
        sharded_uniform_twin(12, 16, cpu_mesh(1))
    with pytest.raises(ValueError, match="per-shard block"):
        sharded_channel_aware_twin(40, 6, LTFL, cpu_mesh(8))


# --------------------------------------------------------------------------- #
# gathers and the lazy refresh
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s", SHARDS)
def test_gather_cohort_matches_take(s):
    n = 1003
    pop = population(5, n)
    mesh = cpu_mesh(s)
    dev = device_population(pop, mesh)
    whole = ChannelArrays(*(unsplit(getattr(c, f) for c in dev.channel)
                            for f in ChannelArrays._fields))
    rng = np.random.default_rng(0)
    for cohort in (np.array([0, 125, 126, 1002]),
                   np.sort(rng.choice(n, 16, replace=False)),
                   rng.choice(n, 16, replace=False)):   # unsorted too
        c = torch.from_numpy(cohort.astype(np.int64))
        got, want = gather_cohort_dev(mesh, dev.channel, c), whole.take(c)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("s", SHARDS)
def test_gather_parts_matches_index_select(s):
    """Zero-sample devices and the wrap regime (sum of sizes > pool): the
    gathered rows and sizes, and the batch indices drawn from them, equal
    the unsplit table's."""
    n, u, b = 1003, 16, 8
    rng = np.random.default_rng(5)
    sizes = rng.integers(0, 12, n)
    assert (sizes == 0).any() and sizes.sum() > 2048
    parts = population_partition(2048, sizes, rng)
    mesh = cpu_mesh(s)
    n_pad = population_pad(n, mesh)
    table = np.concatenate([parts.padded(),
                            np.zeros((n_pad - n, parts.table.shape[1]),
                                     np.int32)])
    sz = np.concatenate([sizes, np.zeros(n_pad - n, np.int64)]).astype(
        np.int32)
    tbl_b, sz_b = population_blocks(table, mesh), population_blocks(sz, mesh)
    for seed in range(3):
        cohort = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
            n, u, replace=False)))
        rows, got_sz = gather_parts_dev(mesh, tbl_b, sz_b, cohort)
        assert torch.equal(rows, torch.from_numpy(table)[cohort])
        assert torch.equal(got_sz, torch.from_numpy(sz)[cohort])
        gen = generator(seed)
        draws = torch.floor(torch.rand((u, b), generator=gen)
                            * torch.clamp(got_sz, min=1)[:, None])
        idx = torch.gather(rows.long(), 1, draws.long())
        ref = torch.from_numpy(table.astype(np.int64))[cohort]
        gen = generator(seed)
        draws = torch.floor(torch.rand((u, b), generator=gen)
                            * torch.clamp(torch.from_numpy(sz)[cohort],
                                          min=1)[:, None])
        assert torch.equal(idx, torch.gather(ref, 1, draws.long()))


@pytest.mark.parametrize("s", SHARDS)
def test_refresh_cohort_is_lazy_and_scheduled_only(s):
    pop = population(7, 23)
    mesh = cpu_mesh(s)
    dev = device_population(pop, mesh)
    dev = dev._replace(epoch=dev.epoch + 1)          # a new fading epoch
    blk = dev.fading_epoch[0].shape[0]
    # member 5 already carries a realization from the current epoch
    dev.fading_epoch[5 // blk][5 % blk] = 1
    f0 = unsplit(c.fading_mean for c in dev.channel).clone()
    out = refresh_cohort_dev(LTFL.wireless, mesh, dev,
                             torch.tensor([1, 5, 17]), generator(2))
    f1 = unsplit(c.fading_mean for c in out.channel)
    np.testing.assert_array_equal(np.flatnonzero((f0 != f1).numpy()),
                                  [1, 17])        # stale members only
    epochs = unsplit(out.fading_epoch).numpy()
    assert epochs[1] == epochs[17] == epochs[5] == out.epoch == 1
    # unscheduled devices keep their stale realization and stale epoch
    assert np.count_nonzero(epochs) == 3


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
def scan(world, **kw):
    model, params, train, test = world
    kw = {"batch_size": 8, "seed": 0, "eval_every": 0, "device": "cpu",
          "population_size": 40, "cohort_size": 4, "rng": "device",
          "cohort_sampler": ChannelAwareSampler(), **kw}
    return ScanRunner(model, params, LTFL, train, test, FedSGDScheme(), **kw)


@pytest.mark.parametrize("s", SHARDS)
def test_scanrunner_sharded_matches_host_cohorts(world, s):
    """On a static channel the channel-aware schedule is the host path's
    round for round; the registry uploads once across runs."""
    model, params, train, test = world
    loop = FedRunner(model, params, LTFL, train, test, FedSGDScheme(),
                     batch_size=8, seed=0, eval_every=0, device="cpu",
                     population_size=40, cohort_size=4,
                     cohort_sampler=ChannelAwareSampler())
    runner = scan(world, population_sharding=s)
    for a, b in zip(loop.run(3), runner.run(3)):
        assert a.cohort == b.cohort
    assert runner._n_pop_uploads == 1
    runner.run(2)
    assert runner._n_pop_uploads == 1                   # no re-upload


def test_scanrunner_sharded_block_fading_lazy_refresh(world):
    runner = scan(world, population_sharding=8, block_fading=True)
    f0 = runner.population.channel.fading_mean.copy()
    e0 = runner.population.fading_epoch.copy()
    hist = runner.run(4)
    for rec in hist:
        assert np.isfinite(rec.train_loss)
        c = np.asarray(rec.cohort)
        assert c.shape == (4,) and np.all(np.diff(c) > 0)
    assert runner.channel_epoch == 4 and runner.population.epoch == 4
    # the refreshes reached the host population after run()...
    assert not np.array_equal(runner.population.channel.fading_mean, f0)
    # ...and only ever-scheduled devices advanced their own epoch
    touched = set(np.flatnonzero(runner.population.fading_epoch != e0))
    sched = set(np.concatenate([np.asarray(r.cohort) for r in hist]))
    assert touched and touched <= sched
    assert set(runner.population.fading_epoch[sorted(touched)]) <= \
        {1, 2, 3, 4}
    np.testing.assert_array_equal(
        runner.channel.fading_mean,
        runner.population.channel.fading_mean[runner.cohort])


def test_scanrunner_sharded_uniform_unbiased(world):
    runner = scan(world, population_sharding=8,
                  cohort_sampler=UniformSampler(), participation="unbiased")
    for rec in runner.run(3):
        c = np.asarray(rec.cohort)
        assert len(np.unique(c)) == 4 and np.all((c >= 0) & (c < 40))
        assert rec.participation == pytest.approx(4 / 40)
        assert np.isfinite(rec.gamma)


def test_sharded_guards(world):
    model, params, train, test = world
    # the registry in blocks is drawn on the device: device rng only
    with pytest.raises(ValueError, match="rng='device'"):
        scan(world, population_sharding=2, rng="host")

    class HostOnly(UniformSampler):
        def sharded_twin(self, runner, mesh):
            return None

    with pytest.raises(ValueError, match="sharded_twin"):
        scan(world, population_sharding=2, cohort_sampler=HostOnly())
    with pytest.raises(ValueError, match="per-shard block"):
        scan(world, population_sharding=20, cohort_size=4)
    with pytest.raises(ValueError, match="do not match"):
        scan(world, population_sharding=PopMesh(
            (torch.device("cuda", 0),) * 2))
    with pytest.raises(ValueError, match="'pop' axis"):
        scan(world, population_sharding=(torch.device("cpu"),))
    parent = scan(world, population_sharding=2)
    bad = SweepSpec(lanes=(LaneSpec(seed=0, label="n-grid/n80",
                                    kwargs={"population_size": 80}),))
    with pytest.raises(ValueError, match="n-grid/n80"):
        parent.run_sweep(bad, 2)


def assert_bitwise(hist, solo):
    assert len(hist) == len(solo)
    for a, b in zip(hist, solo):
        assert a.cohort == b.cohort
        assert a.train_loss == b.train_loss
        assert a.delay == b.delay and a.energy == b.energy
        assert a.gamma == b.gamma


def test_sharded_sweep_seed_lanes_match_solo_runs(world):
    parent = scan(world, population_sharding=8, block_fading=True)
    hists = parent.run_sweep([0, 1], 3)
    assert len(parent._last_sweep_buckets) == 1
    for seed, hist in zip((0, 1), hists):
        solo = scan(world, population_sharding=8, block_fading=True,
                    seed=seed)
        assert_bitwise(hist, solo.run(3))


def test_sharded_sweep_ugrid_matches_solo_runs(world):
    """A U grid over one sharded parent: one bucket a cohort width, each
    lane bitwise its solo sharded run."""
    parent = scan(world, population_sharding=8, block_fading=True)
    spec = SweepSpec(lanes=(
        LaneSpec(seed=0, label="u4/s0", kwargs={"cohort_size": 4}),
        LaneSpec(seed=1, label="u4/s1", kwargs={"cohort_size": 4}),
        LaneSpec(seed=0, label="u5/s0", kwargs={"cohort_size": 5}),
    ))
    hists = parent.run_sweep(spec, 3)
    assert [b["lane_indices"] for b in parent._last_sweep_buckets] == \
        [[0, 1], [2]]
    for hist, (u, seed) in zip(hists, [(4, 0), (4, 1), (5, 0)]):
        solo = scan(world, population_sharding=8, block_fading=True,
                    seed=seed, cohort_size=u)
        assert_bitwise(hist, solo.run(3))


def test_shard_count_invariant(world):
    """Channel-aware under block fading draws nothing per block, so S = 8
    and S = 1 run the same schedule, fading and losses."""
    runs = {}
    for s in (8, 1):
        runner = scan(world, population_sharding=s, block_fading=True)
        runs[s] = (runner.run(5), runner)
    (h8, r8), (h1, r1) = runs[8], runs[1]
    for a, b in zip(h8, h1):
        assert a.cohort == b.cohort
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-6)
    np.testing.assert_array_equal(r8.population.channel.fading_mean,
                                  r1.population.channel.fading_mean)
    np.testing.assert_array_equal(r8.population.fading_epoch,
                                  r1.population.fading_epoch)


# --------------------------------------------------------------------------- #
# against the reference at its in-process S = 1 mesh
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pair():
    """The same 23 devices on both sides (one numpy stream), on the
    reference's S = 1 mesh and the port's S = 1 and S = 8 meshes."""
    ref_pop = RefPopulation.sample(REF_LTFL.wireless, 23, 40, 60,
                                   np.random.default_rng(7))
    pop = population(7, 23)
    np.testing.assert_array_equal(ref_pop.channel.fading_mean,
                                  pop.channel.fading_mean)
    return ref_population_mesh(1), ref_pop, pop


@pytest.mark.parametrize("s", SHARDS)
def test_gather_cohort_dev_matches_reference(pair, s):
    mesh1, ref_pop, pop = pair
    cohort = np.array([0, 4, 9, 22], np.int64)
    ref = ref_gather_cohort_dev(
        mesh1, ref_device_population(ref_pop, mesh1).channel,
        jnp.asarray(cohort, jnp.int32))
    mesh = cpu_mesh(s)
    got = gather_cohort_dev(mesh, device_population(pop, mesh).channel,
                            torch.from_numpy(cohort))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("s", SHARDS)
def test_gather_parts_dev_matches_reference(pair, s):
    mesh1 = pair[0]
    n = 23
    rng = np.random.default_rng(3)
    sizes = rng.integers(0, 9, n)
    table = population_partition(64, sizes, rng).padded()
    sz = sizes.astype(np.int32)
    cohort = np.array([1, 2, 11, 20], np.int64)
    ref_rows, ref_sz = ref_gather_parts_dev(
        mesh1, jnp.asarray(table), jnp.asarray(sz),
        jnp.asarray(cohort, jnp.int32))
    mesh = cpu_mesh(s)
    n_pad = population_pad(n, mesh)
    table = np.concatenate([table, np.zeros((n_pad - n, table.shape[1]),
                                            np.int32)])
    sz = np.concatenate([sz, np.zeros(n_pad - n, np.int32)])
    rows, got_sz = gather_parts_dev(mesh, population_blocks(table, mesh),
                                    population_blocks(sz, mesh),
                                    torch.from_numpy(cohort))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
    np.testing.assert_array_equal(got_sz.numpy(), np.asarray(ref_sz))


@pytest.mark.parametrize("s", SHARDS)
def test_refresh_and_host_sync_match_reference(pair, s):
    """The reference's fresh draws injected: the refreshed registry and
    the host populations after ``host_sync`` are bitwise equal."""
    mesh1, ref_pop, pop = pair
    ref_pop, pop = copy.deepcopy(ref_pop), copy.deepcopy(pop)
    cohort = np.array([1, 5, 17, 22], np.int64)
    key = jax.random.PRNGKey(4)
    ref_dev = ref_device_population(ref_pop, mesh1)
    ref_dev = ref_dev._replace(
        epoch=ref_dev.epoch + 1,
        fading_epoch=ref_dev.fading_epoch.at[5].set(1))
    ref_out = ref_refresh_cohort_dev(REF_LTFL.wireless, mesh1, ref_dev,
                                     jnp.asarray(cohort, jnp.int32), key)
    fresh = ref_draw_fading_dev(REF_LTFL.wireless, key, len(cohort))
    mesh = cpu_mesh(s)
    dev = device_population(pop, mesh)
    dev = dev._replace(epoch=dev.epoch + 1)
    blk = dev.fading_epoch[0].shape[0]
    dev.fading_epoch[5 // blk][5 % blk] = 1
    out = refresh_cohort_dev(
        LTFL.wireless, mesh, dev, torch.from_numpy(cohort),
        fresh=tuple(torch.from_numpy(np.array(x)) for x in fresh))
    for f in ("fading_mean", "interference"):
        np.testing.assert_array_equal(
            unsplit(getattr(c, f) for c in out.channel).numpy()[:23],
            np.asarray(getattr(ref_out.channel, f)))
    np.testing.assert_array_equal(unsplit(out.fading_epoch).numpy()[:23],
                                  np.asarray(ref_out.fading_epoch))
    ref_host_sync(ref_pop, ref_out)
    host_sync(pop, out)
    for f in ("fading_mean", "interference"):
        np.testing.assert_array_equal(getattr(pop.channel, f),
                                      getattr(ref_pop.channel, f))
    np.testing.assert_array_equal(pop.fading_epoch, ref_pop.fading_epoch)
    assert pop.epoch == ref_pop.epoch == 1


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_channel_aware_matches_reference(pair, s):
    """The cohorts bitwise; the float32 mean-SNR scores at rel 1e-6 (the
    reference's ``_mean_gain_dev`` / ``_noise_dev`` against the port's)."""
    mesh1, ref_pop, pop = pair
    ref_ch = ref_device_population(ref_pop, mesh1).channel
    ref_idx, _ = ref_sharded_channel_aware_twin(
        23, 3, REF_LTFL, mesh1).select(ref_ch, jax.random.PRNGKey(0))
    mesh = cpu_mesh(s)
    ch = device_population(pop, mesh).channel
    idx, _ = sharded_channel_aware_twin(23, 3, LTFL, mesh).select(
        ch, generator(0))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    w, p_ref = LTFL.wireless, np.float32(0.5 * (LTFL.wireless.p_min
                                                + LTFL.wireless.p_max))
    snr = torch.cat([p_ref * _mean_gain_dev(c) / _noise_dev(w, c)
                     for c in ch])[:23]
    ref_snr = jnp.float32(p_ref) * ref_mean_gain_dev(ref_ch) / \
        ref_noise_dev(REF_LTFL.wireless, ref_ch)
    np.testing.assert_allclose(snr.numpy(), np.asarray(ref_snr), rtol=1e-6)
