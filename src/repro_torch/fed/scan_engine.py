"""The scanned experiment engine: whole segments of rounds per host
visit, and sweep lanes folded into one client axis.

Held against ``repro.fed.scan_engine`` (``RoundLog``,
``make_scanned_step``, ``ScanRunner`` with its segment planner, both rng
modes and ``run``; ``LaneSpec``, ``SweepSpec``, ``run_sweep`` and its
buckets). ``FedRunner`` visits the host every round: it gathers the
batch on the host and uploads it, and reads the round's loss and
gradient ranges back. The reference folds a segment of rounds into one
compiled ``lax.scan``; here a segment is a Python loop over its rounds
that never waits for the device:

* ``_ensure_device_world`` puts the training pool on the device once
  (and, for ``rng="device"``, each device's padded index table and its
  channel state);
* ``rng="host"`` replays ``FedRunner._host_round_inputs`` for the whole
  segment on the identical numpy stream (cohorts, controls, batch
  indices, round seeds, packet outcomes), stacks the rows and uploads
  each stacked array once; batches are gathered on the device by index.
  The quantizer's uniforms come from each round's seed exactly as in
  ``FedRunner``, so the same tensor ops run on the same inputs and the
  losses are bitwise ``FedRunner``'s for stateless schemes;
* ``rng="device"`` draws everything on the device from one
  ``torch.Generator`` per runner, seeded with ``seed``: the cohort
  (through the sampler's ``device_twin``), the block-fading redraw, the
  batch indices (with replacement, the reference's documented
  simplification), the packet outcomes and the quantizer's uniforms.
  Philox is not threefry: this mode matches the reference in
  distribution only;
* the per-round outputs stay on the device (``RoundLog``) until the
  segment ends; ``_absorb_segment`` pulls them to the host once and
  reduces gamma (Eq. 29) there in float64, so a sweep lane and its solo
  run share one code path for it.

Nothing inside a segment's loop reads a tensor's value on the host
(``segment_sync_debug`` runs the loop under
``torch.cuda.set_sync_debug_mode`` to prove it).

Segments split at host boundaries under ``control="host"``: a segment
starts at every host recontrol round (``scheme.scan_recontrol_every``),
ends after every eval round, and is at most ``max_segment`` rounds long,
so ``max_segment=1`` is the per-round loop. The inherited
``eval_every=1`` evaluates after every round and so makes every segment
one round long; ``run`` warns.

``control="device"`` (needs ``rng="device"``) removes both boundaries:
the scheme's ``scan_control_program`` (``repro_torch.control``: LTFL's
Algorithm 1 through ``solve_dev``, FedMP's bandit) decides inside the
loop against each round's own fading and cohort, and an eval head
scores the same fixed batches ``evaluate()`` does on the eval rounds,
so ``LTFLScheme(recontrol_every=1)`` over R rounds is one segment. Per
round and lane the generator draws the fading, the cohort and the batch
indices, then the program's BO draws, then the packet outcomes at the
decided power; a scheme with no program consumes the stream as under
host control. A program runs once per lane with that lane's 0-d slice
of the laned config, so a lane's solve has a solo run's shapes and is
bitwise its solo run's. The (N,) gradient-range estimates stay on the
device across rounds and segments (each round writes the cohort's
measured values); the program reads the cohort's. A program with
cadence ``every`` = k > 1 keeps segment boundaries at multiples of k,
and only a segment's first round may decide (``_decide_first``).

Sweep lanes
-----------
``run_sweep`` runs a ``SweepSpec`` of lanes (seeds, schemes, channel
regimes, budgets, cohort grids). Lanes whose ``_lane_signature`` match
(shapes, cadences, scheme constants: everything a segment bakes in) form
a bucket, and a bucket runs as ONE step over L * U clients
(``make_fl_train_step``'s ``step.lanes``): each lane prunes its own
weights, one vmap computes every client's gradient, the gate and the
quantizer run on the (L * U, ...) stack, so the quantizer launches once
per leaf per round for the whole bucket, and aggregation and the update
run per lane with the lane's own learning rate. The lane-varying config
floats (``_LANED_WIRELESS`` / ``_LANED_LTFL``) become (L, 1) float32
tensors that broadcast through the accounting twins; a solo run is the
one-lane bucket, so it runs the same arithmetic. ``torch.func.vmap``
over the step is not an option: the quantizer is a ctypes call on a
data pointer, which has no vmap rule.

Buffered-async rounds
---------------------
``AsyncRunner`` (``repro_torch.fed.async_engine``) sets ``_async`` and
provides ``_admission``, which the segment calls every round once the
round's inputs are known (the replayed rows, or ``_device_round``'s
draws) and before ``step.lanes``: it masks the cohort into the buffer's
admissions over the bucket's (L, U) clients, so the masked packet
outcomes and the staleness-attenuated weights feed the step, and its
buffered (delay, energy) replace the synchronous accounting, the
program's feedback included. The round's pre-reset staleness ``tau``
and the ``admitted`` mask ride ``RoundLog``; ``_absorb_segment`` adds
the staleness term to gamma (host float64) and reports the cohort's mean
tau as ``RoundRecord.staleness``. ``_lane_extra_kwargs`` hands a lane
its parent's deadline, buffer and churn, and ``_engine_signature`` keeps
lanes of different async settings in different buckets. Without
``_async`` none of this runs.

The registry in blocks
----------------------
``population_sharding=S`` (an int, or a ``PopMesh`` whose devices may
repeat a card; needs ``rng="device"``) keeps the (N,) registry on the
device in S equal blocks (``repro_torch.fed.population.
PopulationArrays``), the reference's ``body_dev_sharded``. One runner
drives every block; the (U,) step, the control plane, the range
estimates and the async state stay on the runner's device. The registry
and the (N_pad, W) int32 data-index table (widened to int64 only after
the (U, W) gather) upload once (``_n_pop_uploads``). Per round and lane,
``_sharded_draws`` takes, in order: the epoch bump and the U fresh
block-fading values from the lane's generator (where the unsharded path
draws all N), the two-stage cohort on last-known CSI (the twin's
per-block generators), the lazy refresh of the cohort's stale members,
the cohort's channel view and index rows gathered from the blocks; then
the batch indices from the lane's generator, the program's draws and
the packet outcomes as above. Under block fading this is the host
``Population``'s semantics (schedule on stale CSI, then refresh U), not
the unsharded device path's (redraw all N, then schedule), so the two
are different runs; S does not change a channel-aware run's cohorts or
fading. ``host_sync`` folds the blocks back into the host population
once per ``run``, each device with its own fading epoch. A sweep over a
sharded parent gives every lane its own blocks and needs every lane's N
to be the parent's.
"""
from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch.core.channel import (
    ChannelArrays,
    gl_nodes,
    packet_error_rate_dev,
    sample_transmissions_dev,
    draw_fading_dev,
)
from repro_torch.core.convergence import gamma
from repro_torch.core.delay_energy import round_accounting_dev
from repro_torch.fed.population import (
    UniformSampler,
    device_population,
    gather_cohort_dev,
    gather_parts_dev,
    host_sync,
    refresh_cohort_dev,
)
from repro_torch.fed.rounds import FedRunner, RoundRecord
from repro_torch.launch.sharding import (
    population_blocks,
    population_mesh,
    population_pad,
)

Tree = Dict[str, torch.Tensor]

# The lane-varying ("laned") config fields: per lane float32 values that
# the segment reads as (L, 1) tensors, so lanes that differ only in them
# share a bucket. Everything else on the configs is static (shapes,
# Algorithm 1's loop bounds) or consumed on the host (population draws,
# partitions) and so belongs to the bucket signature.
_LANED_WIRELESS = (
    "p_max", "p_min", "bandwidth_ul", "n0", "waterfall", "fading_scale",
    "interference_min", "interference_max", "cycles_per_sample", "k_eff",
    "sigma_exp")
_LANED_LTFL = (
    "rho_max", "delta_max", "xi_bits", "t_max", "e_max", "server_delay",
    "bo_xi", "alt_tol", "lipschitz", "d_sq", "v1", "v2", "learning_rate")


def _rebuild_config(cfg, overrides):
    """Dataclass copy with field overrides that bypasses
    ``__post_init__`` (its range checks call ``bool()`` on the values,
    which are tensors here; each lane's own config passed them when it
    was built)."""
    out = object.__new__(type(cfg))
    for f in dataclasses.fields(cfg):
        object.__setattr__(out, f.name,
                           overrides.get(f.name, getattr(cfg, f.name)))
    return out


def _laned_ltfl(ltfl, cfg: Dict[str, torch.Tensor]):
    """``ltfl`` with every laned field replaced by its (L, 1) tensor
    from ``cfg`` (keys ``w_<field>`` for the wireless config)."""
    wireless = _rebuild_config(
        ltfl.wireless, {k: cfg["w_" + k] for k in _LANED_WIRELESS})
    over: Dict[str, Any] = {k: cfg[k] for k in _LANED_LTFL}
    over["wireless"] = wireless
    return _rebuild_config(ltfl, over)


class RoundLog(NamedTuple):
    """One segment's per-round outputs of one lane (leading axis =
    round), the mirror of ``RoundRecord``'s measured fields. Kept on the
    device during the segment; ``_absorb_segment`` gets it as numpy.
    Gamma is not reduced on the device: its per-device inputs
    (``range_sq``, ``gap_delta``, ``rho_u``, ``pers``, ``ns_u``,
    ``inclusion``) ride the log and the host reduces them in float64.
    ``test_acc`` and the control means are logged under
    ``control="device"`` only (the eval head, the per-round decisions);
    under host control they are None and the host fills them."""

    train_loss: Any          # (R,)
    delay: Any               # (R,)  Eq. 34 incl. server delay
    energy: Any              # (R,)  Eq. 37 summed
    received: Any            # (R,)  sum alpha
    range_sq: Any            # (R, U) measured per-device range^2 sums
    gap_delta: Any           # (R, U) applied delta (32 where delta == 0)
    rho_u: Any               # (R, U) applied pruning ratios
    pers: Any                # (R, U) packet error rates at applied power
    ns_u: Any                # (R, U) cohort sample counts
    cohort: Any              # (R, U) scheduled population indices
    inclusion: Any = None    # (R, U) HT pi_i; None unless unbiased
    test_acc: Any = None     # (R,) the eval head (NaN when not due)
    rho_mean: Any = None     # (R,) means of the round's controls
    delta_mean: Any = None   # (R,)
    power_mean: Any = None   # (R,)
    tau: Any = None          # (R, U) pre-reset staleness (async only)
    admitted: Any = None     # (R, U) buffer admissions (async only)


def make_scanned_step(step_fn: Callable) -> Callable:
    """Wrap a round step into one multi-round segment.

    ``scanned(params, opt_state, comp_state, batches, controls, seeds)``
    runs ``len(seeds)`` rounds: ``batches`` leaves carry a leading round
    axis (R, C, B, ...), ``seeds`` holds one integer round seed per round
    and ``controls`` is held constant. Returns the final (params,
    opt_state, comp_state) and the per-round metrics stacked on the
    device (no host sync inside). The minimal scanned API, for the
    datacenter step (``examples/torch_train_federated_lm.py``);
    ``ScanRunner`` is the full edge engine."""

    def scanned(params, opt_state, comp_state, batches, controls, seeds):
        rows = []
        for r, seed in enumerate(seeds):
            batch = {k: v[r] for k, v in batches.items()}
            params, opt_state, comp_state, m = step_fn(
                params, opt_state, comp_state, batch, controls, seed)
            rows.append(m)
        metrics = {k: torch.stack([m[k] for m in rows]) for k in rows[0]}
        return params, opt_state, comp_state, metrics

    return scanned


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """One lane of a ``run_sweep``: its ``seed``; ``scheme_factory``
    (None deep-copies the parent's scheme as constructed); ``ltfl`` (None
    inherits the parent's; its laned floats vary freely within a bucket,
    its static fields open a new one); ``kwargs`` overriding the parent's
    construction kwargs (the U/N axis); a free-form ``label``."""

    seed: int = 0
    scheme_factory: Optional[Callable[[], Any]] = None
    ltfl: Optional[Any] = None
    kwargs: Optional[Dict[str, Any]] = None
    label: str = ""


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A heterogeneous grid of lanes for ``ScanRunner.run_sweep``."""

    lanes: Tuple[LaneSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "lanes", tuple(self.lanes))
        if not self.lanes:
            raise ValueError("SweepSpec needs at least one lane")

    @classmethod
    def grid(cls, *, schemes: Optional[Dict[str, Any]] = None,
             ltfls: Optional[Dict[str, Any]] = None,
             kwargs: Optional[Dict[str, Dict[str, Any]]] = None,
             seeds: Sequence[int] = (0,)) -> "SweepSpec":
        """Cross product of named scheme factories x named configs x
        named kwargs overrides x seeds; labels join the axis names
        (``"ltfl/highband/s0"``). An omitted axis contributes one
        inherit-from-parent point."""
        s_ax = dict(schemes) if schemes else {"": None}
        c_ax = dict(ltfls) if ltfls else {"": None}
        k_ax = dict(kwargs) if kwargs else {"": None}
        lanes = []
        for sname, factory in s_ax.items():
            for cname, cfg in c_ax.items():
                for kname, kw in k_ax.items():
                    for seed in seeds:
                        label = "/".join(
                            x for x in (sname, cname, kname, f"s{seed}")
                            if x)
                        lanes.append(LaneSpec(
                            seed=int(seed), scheme_factory=factory,
                            ltfl=cfg, kwargs=kw, label=label))
        return cls(lanes=tuple(lanes))


def _cat_states(states: List[Any]) -> Any:
    """Lanes' compressor states as one state over their stacked
    clients (a dict of (U, ...) tensors, e.g. STC's residual; a
    stateless compressor's ``()``)."""
    if len(states) == 1 or not isinstance(states[0], dict):
        return states[0]
    return {k: torch.cat([s[k] for s in states]) for k in states[0]}


def _split_state(state: Any, n_lanes: int, n_clients: int) -> List[Any]:
    if n_lanes == 1 or not isinstance(state, dict):
        return [state] * n_lanes
    return [{k: v[i * n_clients:(i + 1) * n_clients]
             for k, v in state.items()} for i in range(n_lanes)]


class ScanRunner(FedRunner):
    """``FedRunner`` with the per-round loop replaced by segments.

    Construction arguments, ``history`` and the ``RoundRecord``s are
    ``FedRunner``'s; only ``run`` differs. Additional arguments:

    * ``rng``: ``"host"`` (the numpy stream replayed; default) or
      ``"device"`` (drawn on the device; see the module docstring);
    * ``control``: ``"host"`` (Algorithm 1 and eval run between
      segments; default) or ``"device"`` (both inside the segment,
      through the scheme's ``scan_control_program``; needs
      ``rng="device"``);
    * ``max_segment``: optional cap on a segment's length;
    * ``population_sharding``: S, or a ``PopMesh``: the registry in S
      blocks (module docstring; needs ``rng="device"``). An int builds
      ``population_mesh(S)`` over S cards for a CUDA runner, S blocks on
      the CPU for a CPU runner.

    ``segment_sync_debug`` (None, ``"warn"`` or ``"error"``) runs each
    segment's loop under ``torch.cuda.set_sync_debug_mode`` on a card.
    """

    segment_sync_debug: Optional[str] = None
    # the buffered-async spec, set by AsyncRunner (which also provides
    # ``_admission``); None runs synchronous rounds
    _async: Optional[Any] = None

    def __init__(self, model, params, ltfl, train, test, scheme, *,
                 rng: str = "host", control: str = "host",
                 max_segment: Optional[int] = None,
                 population_sharding=None, **kwargs):
        if rng not in ("host", "device"):
            raise ValueError(f"rng={rng!r} (want 'host' or 'device')")
        if population_sharding is not None and rng != "device":
            raise ValueError(
                "population_sharding keeps the device registry in blocks "
                "and draws cohorts on the device through the sharded "
                "sampler twins; pass rng='device'")
        if control not in ("host", "device"):
            raise ValueError(
                f"control={control!r} (want 'host' or 'device')")
        if control == "device" and rng != "device":
            raise ValueError(
                "control='device' decides inside the segment, which needs "
                "the segment's own rng stream; pass rng='device'")
        if not scheme.scan_supported:
            raise ValueError(
                f"{type(scheme).__name__} needs per-round host feedback "
                "and cannot run scanned; use FedRunner")
        if max_segment is not None and max_segment < 1:
            raise ValueError(f"max_segment={max_segment} must be >= 1")
        # construction inputs, for run_sweep's lanes
        self._ctor = dict(model=model, params=params, ltfl=ltfl,
                          train=train, test=test, kwargs=dict(kwargs))
        self._scheme_proto = copy.deepcopy(scheme)   # before setup
        super().__init__(model, params, ltfl, train, test, scheme, **kwargs)
        self.rng = rng
        self.control = control
        self.max_segment = max_segment
        self.seed = int(kwargs.get("seed", 0))
        self._ctl_program = None
        self._ctl_state = None
        rc = scheme.scan_recontrol_every(self)
        if control == "device" and rc:
            self._ctl_program = scheme.scan_control_program(self)
            if self._ctl_program is None:
                raise ValueError(
                    f"{type(scheme).__name__} recontrols every {rc} "
                    "round(s) but provides no scan_control_program (no "
                    "device twin of its control loop); use "
                    "control='host'")
            self._ctl_state = self._ctl_program.init
        self._sampler_twin = None
        self._generator: Optional[torch.Generator] = None
        self._pop_mesh = None
        if population_sharding is not None:
            mesh = population_sharding
            if isinstance(mesh, int):
                mesh = population_mesh(
                    mesh, devices=(None if self.device.type == "cuda"
                                   else [self.device] * mesh))
            if "pop" not in getattr(mesh, "axis_names", ()):
                raise ValueError(
                    f"population_sharding mesh {mesh!r} has no 'pop' axis "
                    "(use repro_torch.launch.sharding.population_mesh)")
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(
                    f"population_sharding mesh devices {mesh.devices} do "
                    f"not match the runner's device {self.device}")
            self._pop_mesh = mesh
            self._sampler_twin = self.sampler.sharded_twin(self, mesh)
            if self._sampler_twin is None:
                raise ValueError(
                    "population_sharding needs a sharded sampler twin, but "
                    f"{type(self.sampler).__name__}.sharded_twin() "
                    "returned None; use an unsharded runner or a sampler "
                    "with a sharded twin (repro_torch.control."
                    "device_samplers)")
        elif rng == "device":
            self._sampler_twin = self.sampler.device_twin(self)
        if rng == "device":
            if self._sampler_twin is None:
                raise ValueError(
                    f"rng='device' draws cohorts on the device, but "
                    f"{type(self.sampler).__name__}.device_twin() "
                    "returned None (a host-only scheduler); use "
                    "rng='host' or a sampler with a device twin "
                    "(repro_torch.control.device_samplers)")
            if self.participation == "unbiased" and \
                    not self._sampler_twin.provides_inclusion:
                raise ValueError(
                    "participation='unbiased' needs inclusion "
                    f"probabilities; the {type(self.sampler).__name__} "
                    "device twin does not provide them")
            if control == "host" and rc and \
                    self.cohort_size < self.population_size:
                raise ValueError(
                    "rng='device' cannot host-recontrol against a cohort "
                    "drawn on the device; use control='device' (recontrol "
                    "inside the segment) or rng='host' (per-round "
                    "segments)")
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(int(kwargs.get("seed", 0)))
        self._data_dev: Optional[Tree] = None
        # device rng: each device's index table and the (N,) population
        # view, resident across segments and synced to the host
        # population lazily (at the end of run, or when host recontrol
        # needs the cohort's view)
        self._parts_padded: Optional[torch.Tensor] = None
        self._part_sizes: Optional[torch.Tensor] = None
        # ChannelArrays (N,), or PopulationArrays under population_sharding
        # (then the two above are lists of blocks)
        self._pop_dev: Optional[Any] = None
        self._n_pop_uploads = 0      # registry uploads (one per runner)
        self._range_sq_dev: Optional[torch.Tensor] = None
        self._eval_dev: Optional[List[Tree]] = None
        self._host_pop_stale = False
        # set by run_sweep: one {"signature", "lane_indices"} per bucket
        self._last_sweep_buckets: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------ #
    # device-resident world
    # ------------------------------------------------------------------ #
    def _ensure_device_world(self) -> None:
        """Upload the training pool (both modes); under device control
        the eval head's fixed batches (those ``evaluate`` scores); for
        device rng the (N, W) padded index table, the shard sizes, the
        (N,) channel state and the (N,) gradient-range estimates, once.
        Under ``population_sharding`` the registry, the table and the
        sizes go over the mesh in N_pad / S row blocks, the table and
        sizes as int32 (zero rows pad the table)."""
        if self._data_dev is None:
            self._data_dev = self._to_device(self.batcher.base.arrays)
        # the quadrature's constants, on the device the segment uses
        gl_nodes(next(iter(self._data_dev.values())).device)
        if self.control == "device" and self.eval_every and \
                self._eval_dev is None:
            self._eval_dev = [self._to_device(b)
                              for b in self._eval_batches()]
        if self.rng != "device" or self._parts_padded is not None:
            return
        self._range_sq_dev = torch.from_numpy(
            self._range_sq_pop.astype(np.float32)).to(self.device)
        mesh = self._pop_mesh
        dtype = np.int64 if mesh is None else np.int32
        table = self.batcher.padded_parts(dtype=dtype)
        if table.shape[1] == 0:                  # every shard empty
            table = np.zeros((table.shape[0], 1), dtype)
        sizes = self.batcher.client_sizes().astype(dtype)
        if mesh is None:
            self._pop_dev = self.population.channel.to_arrays(self.device)
            self._parts_padded = torch.from_numpy(table).to(self.device)
            self._part_sizes = torch.from_numpy(sizes).to(self.device)
        else:
            self._pop_dev = device_population(self.population, mesh)
            n, n_pad = table.shape[0], population_pad(table.shape[0], mesh)
            if n_pad > n:
                table = np.concatenate(
                    [table, np.zeros((n_pad - n, table.shape[1]), dtype)])
                sizes = np.concatenate([sizes, np.zeros(n_pad - n, dtype)])
            self._parts_padded = population_blocks(table, mesh)
            self._part_sizes = population_blocks(sizes, mesh)
        self._n_pop_uploads += 1
        if self._sampler_twin.prepare is not None:
            self._sampler_twin.prepare(self._pop_dev)

    # ------------------------------------------------------------------ #
    # segmentation
    # ------------------------------------------------------------------ #
    def _segment_spans(self, start: int, end: int):
        """Split [start, end) at host boundaries: a new segment starts at
        every recontrol round, ends after every eval round, and never
        exceeds ``max_segment`` rounds. Under ``control="device"`` both
        run inside the segment, so only a program's cadence ``every`` >
        1 keeps boundaries (at its multiples, so that at most a
        segment's first round decides)."""
        if self.control == "device":
            p = self._ctl_program
            rc = p.every if p is not None and p.every > 1 else 0
            ev = 0
        else:
            rc = self.scheme.scan_recontrol_every(self)
            ev = self.eval_every
        spans = []
        a = start
        while a < end:
            b = a + 1
            while b < end:
                if rc and b % rc == 0:
                    break                 # host recontrol due at b
                if ev and (b - 1) % ev == 0:
                    break                 # eval due after round b-1
                if self.max_segment and b - a >= self.max_segment:
                    break
                b += 1
            spans.append((a, b))
            a = b
        return spans

    def _decide_first(self, a: int) -> bool:
        """Whether the segment starting at round ``a`` opens with a
        decide round: every segment for a cadence-1 program, an
        on-cadence start for a cadence-k one (``_segment_spans`` keeps
        every later round of the segment off-cadence)."""
        if self._ctl_program is None:
            return False
        if self._ctl_program.every <= 1:
            return True
        return a % self._ctl_program.every == 0

    # ------------------------------------------------------------------ #
    # per-segment host preparation
    # ------------------------------------------------------------------ #
    def _laned_cfg(self) -> Dict[str, np.float32]:
        """This runner's laned config values, float32."""
        w, l = self.ltfl.wireless, self.ltfl
        cfg = {"w_" + k: np.float32(getattr(w, k)) for k in _LANED_WIRELESS}
        cfg.update({k: np.float32(getattr(l, k)) for k in _LANED_LTFL})
        return cfg

    def _segment_consts(self, ctl, agg_denom) -> Dict[str, np.ndarray]:
        consts = {
            "rho": np.asarray(ctl.rho, np.float32),
            "delta": np.asarray(ctl.delta, np.float32),
            "power": np.asarray(ctl.power, np.float32),
            "payload": np.asarray(self.scheme.payload_bits(ctl),
                                  np.float32),
        }
        if agg_denom is not None:
            consts["agg_denom"] = np.float32(agg_denom)
        return consts

    def _prepare_host_segment(self, a: int, b: int):
        """Replay the host half of rounds [a, b) on the numpy stream (in
        ``FedRunner.run_round``'s order) and stack the per-round inputs:
        (xs of (R, ...) numpy arrays, segment constants, controls, the
        round seeds)."""
        rows, seeds = [], []
        ctl0 = None
        agg_denom = None
        for r in range(a, b):
            h = self._host_round_inputs(r)
            agg_denom = h.agg_denom
            if ctl0 is None:
                ctl0 = h.ctl
            elif not (np.array_equal(ctl0.rho, h.ctl.rho)
                      and np.array_equal(ctl0.delta, h.ctl.delta)
                      and np.array_equal(ctl0.power, h.ctl.power)):
                raise ValueError(
                    f"{type(self.scheme).__name__} changed controls inside "
                    f"a scan segment (round {r}); its scan_recontrol_every "
                    "declaration is wrong")
            view = self.channel          # the cohort view the replay set
            row = {
                "cohort": h.cohort.astype(np.int64),
                "distance": view.distance,
                "fading": view.fading_mean,
                "interference": view.interference,
                "cpu": view.cpu_hz,
                "ns": view.num_samples,
                "weights": h.weights,
                "batch_idx": h.batch_idx.astype(np.int64),
                "alpha": h.alpha,
            }
            if self.participation == "unbiased":
                row["inclusion"] = self._cohort_probs
            rows.append(row)
            seeds.append(h.seed)
        xs = {k: np.stack([row[k] for row in rows]) for k in rows[0]}
        for k in xs:
            # indices stay int64 and masks bool; the rest is float32
            if k not in ("cohort", "batch_idx") and xs[k].dtype != bool:
                xs[k] = xs[k].astype(np.float32)
        return xs, self._segment_consts(ctl0, agg_denom), ctl0, seeds

    def _prepare_device_segment(self, a: int):
        """The segment-start controls (none when a control program
        decides inside the segment); every per-round draw happens on the
        device. Unbiased aggregation divides by this runner's own
        population sample total."""
        agg_denom = (self._pop_samples_total
                     if self.participation == "unbiased" else None)
        if self._ctl_program is not None:
            consts = ({} if agg_denom is None
                      else {"agg_denom": np.float32(agg_denom)})
            return consts, None
        ctl = self.scheme.controls(a)
        return self._segment_consts(ctl, agg_denom), ctl

    # ------------------------------------------------------------------ #
    # post-segment host absorption
    # ------------------------------------------------------------------ #
    def _absorb_segment(self, a: int, b: int, ctl, log: RoundLog) -> None:
        """Fold one lane's segment (``log`` as numpy) into the host
        state and append its ``RoundRecord``s (cumulative sums and gamma
        in float64). Under host control eval runs here, at the segment's
        last round when due (the planner ends segments at eval rounds);
        under device control the eval head measured it in the segment
        and the accuracy and the control means come from the log (``ctl``
        is then None when a program decided)."""
        cohorts = np.asarray(log.cohort, np.int64)
        rsqs = np.asarray(log.range_sq, np.float64)
        if self.rng == "device":
            # the (N,) state stays on the device; the host population and
            # range estimates sync lazily (end of run, host recontrol)
            self._host_pop_stale = True
            if self.block_fading:
                # the segment advanced b - a fading epochs on the device
                self._channel_epoch += b - a
                self.population.epoch += b - a
            self.cohort = cohorts[-1]
            if self.control == "host" and \
                    self.scheme.scan_recontrol_every(self):
                # host recontrol reads the cohort's view between segments
                self._sync_host_population()
            program = self._ctl_program
            if program is not None and program.absorb is not None:
                program.absorb(self.scheme, {
                    k: v.cpu().numpy() for k, v in self._ctl_state.items()})
        else:
            for i in range(b - a):
                self._range_sq_pop[cohorts[i]] = rsqs[i]

        losses = np.asarray(log.train_loss, np.float64)
        delays = np.asarray(log.delay, np.float64)
        energies = np.asarray(log.energy, np.float64)
        received = np.asarray(log.received, np.float64)
        # the applied controls as the device applied them (float32)
        gds = np.asarray(log.gap_delta, np.float64)
        rhos_u = np.asarray(log.rho_u, np.float64)
        perss = np.asarray(log.pers, np.float64)
        nss = np.asarray(log.ns_u, np.float64)
        incl = (np.asarray(log.inclusion, np.float64)
                if log.inclusion is not None else None)
        denom = float(np.float32(self._pop_samples_total))
        # async: the staleness term of Eq. 29 (exactly +0.0 at tau = 0)
        taus = (np.asarray(log.tau, np.float64)
                if log.tau is not None else None)
        gammas = [gamma(self.ltfl, rsqs[i], gds[i], rhos_u[i], perss[i],
                        nss[i], **({"inclusion": incl[i],
                                    "population_samples": denom}
                                   if incl is not None else {}),
                        **({"staleness": taus[i]}
                           if taus is not None else {}))
                  for i in range(b - a)]
        device_ctl = self.control == "device"
        if device_ctl:
            accs, rho_m, delta_m, power_m = (
                np.asarray(f, np.float64) for f in (
                    log.test_acc, log.rho_mean, log.delta_mean,
                    log.power_mean))
        # a program's feedback is the scheme's post_round on the device:
        # both would apply it twice
        in_segment_feedback = (self._ctl_program is not None
                               and self._ctl_program.feedback is not None)
        partial = self.cohort_size < self.population_size
        for i, r in enumerate(range(a, b)):
            self._cum_delay += float(delays[i])
            self._cum_energy += float(energies[i])
            eval_due = bool(self.eval_every and r % self.eval_every == 0)
            if device_ctl:
                test_acc = float(accs[i])
            else:
                if eval_due and i != b - a - 1:
                    raise RuntimeError(
                        "segmentation must end segments at eval rounds")
                test_acc = self.evaluate() if eval_due else float("nan")
            rec = RoundRecord(
                round=r,
                train_loss=float(losses[i]),
                test_acc=test_acc,
                delay=float(delays[i]),
                energy=float(energies[i]),
                cum_delay=self._cum_delay,
                cum_energy=self._cum_energy,
                received=int(received[i]),
                gamma=float(gammas[i]),
                rho_mean=(float(rho_m[i]) if ctl is None
                          else float(np.mean(ctl.rho))),
                delta_mean=(float(delta_m[i]) if ctl is None
                            else float(np.mean(ctl.delta))),
                power_mean=(float(power_m[i]) if ctl is None
                            else float(np.mean(ctl.power))),
                cohort=cohorts[i].tolist() if partial else [],
                participation=self.cohort_size / self.population_size,
                staleness=(float(np.mean(taus[i]))
                           if taus is not None else 0.0),
            )
            self.history.append(rec)
            if not in_segment_feedback:
                self.scheme.post_round(r, {"train_loss": rec.train_loss,
                                           "delay": rec.delay,
                                           "test_acc": rec.test_acc})

    def _sync_host_population(self) -> None:
        """Fold the device-resident (N,) channel state back into the
        host ``Population`` and refresh the cohort's view."""
        if not self._host_pop_stale:
            return
        if self._pop_mesh is not None:
            # each device's own epoch: the blocks refresh lazily
            host_sync(self.population, self._pop_dev)
        else:
            ch = self.population.channel
            ch.fading_mean[:] = self._pop_dev.fading_mean.cpu().numpy()
            ch.interference[:] = self._pop_dev.interference.cpu().numpy()
            if self.block_fading:
                # the device redraws the whole population every epoch
                self.population.fading_epoch[:] = self.population.epoch
        self._range_sq_pop[:] = self._range_sq_dev.cpu().numpy()
        self.channel = self.population.view(self.cohort)
        self._host_pop_stale = False

    def _sharded_draws(self, gen: torch.Generator):
        """One round's population work on the registry in blocks, in
        ``body_dev_sharded``'s order: under block fading the epoch bump
        and U fresh (fading, interference) values from the lane's
        generator ``gen``; the cohort from the two-stage twin on
        last-known CSI; the lazy refresh of its stale members; its (U,)
        channel view and (U, W) index rows from the blocks. Returns (the
        view, the cohort, pi or None, the rows and sizes as int64), all
        on the runner's device; no host sync."""
        mesh, pop = self._pop_mesh, self._pop_dev
        w = self.ltfl.wireless
        fresh = None
        if self.block_fading:
            pop = self._pop_dev = pop._replace(epoch=pop.epoch + 1)
            fresh = draw_fading_dev(w, gen, self.cohort_size)
        cohort, pi = self._sampler_twin.select(pop.channel, gen)
        if fresh is not None:
            refresh_cohort_dev(w, mesh, pop, cohort, fresh=fresh)
        ch = gather_cohort_dev(mesh, pop.channel, cohort, self.device)
        rows, sizes = gather_parts_dev(mesh, self._parts_padded,
                                       self._part_sizes, cohort, self.device)
        return ch, cohort, pi, rows.to(torch.int64), sizes.to(torch.int64)

    # ------------------------------------------------------------------ #
    # the public loop
    # ------------------------------------------------------------------ #
    def run(self, num_rounds: int, log_every: int = 0) -> List[RoundRecord]:
        if self.eval_every == 1 and self.max_segment != 1 \
                and num_rounds > 1 and self.control == "host":
            warnings.warn(
                "ScanRunner with eval_every=1 (the FedRunner default) "
                "evaluates after every round, so every segment has "
                "length 1 and nothing is amortized; pass eval_every=0 or "
                "an eval cadence of k rounds, or control='device' to "
                "evaluate inside the segment", stacklevel=2)
        n0 = len(self.history)
        # round numbering restarts at 0 on every run() call, as in
        # FedRunner.run (history keeps appending)
        _run_bucket([self], num_rounds)
        if log_every:
            for rec in self.history[n0:]:
                if rec.round % log_every == 0:
                    print(f"[{self.scheme.name}] round={rec.round:4d} "
                          f"loss={rec.train_loss:.4f} "
                          f"acc={rec.test_acc:.3f} "
                          f"delay={rec.delay:9.1f}s "
                          f"energy={rec.energy:8.2f}J "
                          f"recv={rec.received}/{self.num_devices}")
        return self.history

    # ------------------------------------------------------------------ #
    # sweep lanes
    # ------------------------------------------------------------------ #
    def _lane_extra_kwargs(self) -> Dict[str, Any]:
        """Engine construction kwargs a lane inherits from its parent
        (none here; ``AsyncRunner`` hands on its deadline, buffer and
        churn)."""
        return {}

    def _engine_signature(self) -> tuple:
        """What the engine bakes into a segment beyond the base
        signature (nothing here; ``AsyncRunner`` adds its deadline,
        buffer size and churn)."""
        return ()

    def _build_lane(self, spec: LaneSpec) -> "ScanRunner":
        """A lane: the parent's construction inputs with the spec's
        seed, scheme, config and kwargs applied; ``type(self)`` keeps an
        ``AsyncRunner``'s lanes async."""
        c = self._ctor
        kw = dict(c["kwargs"])
        kw.update(self._lane_extra_kwargs())
        if spec.kwargs:
            kw.update(spec.kwargs)
        kw["seed"] = int(spec.seed)
        scheme = (spec.scheme_factory() if spec.scheme_factory is not None
                  else copy.deepcopy(self._scheme_proto))
        return type(self)(c["model"], c["params"],
                          spec.ltfl if spec.ltfl is not None else c["ltfl"],
                          c["train"], c["test"], scheme, rng=self.rng,
                          control=self.control,
                          max_segment=self.max_segment,
                          population_sharding=self._pop_mesh, **kw)

    def _lane_signature(self, lane: "ScanRunner") -> tuple:
        """The bucket key: everything a segment bakes in. Lanes share a
        bucket iff their signatures match."""
        sig = (lane._scan_shape_signature(), lane.rng, lane.control,
               lane.max_segment, lane._pop_mesh, type(lane.sampler).__name__,
               lane.scheme.scan_lane_signature(lane),
               lane._engine_signature())
        if lane.rng == "device" and \
                not isinstance(lane.sampler, UniformSampler):
            # the channel- and energy-aware twins close over config
            # floats (reference power, energy budget, CPU energy model)
            w, l = lane.ltfl.wireless, lane.ltfl
            sig += ((float(w.p_min), float(w.p_max), float(l.e_max),
                     float(w.k_eff), float(w.sigma_exp),
                     float(w.cycles_per_sample)),)
        return sig

    def run_sweep(self, sweep: Union[SweepSpec, Sequence[int]],
                  num_rounds: int,
                  scheme_factory: Optional[Callable[[], Any]] = None
                  ) -> List[List[RoundRecord]]:
        """Run a batch of lanes: a ``SweepSpec``, or a sequence of seeds
        (replicas of this runner's config; ``scheme_factory`` applies to
        that form only). Lanes are grouped into buckets by
        ``_lane_signature`` and each bucket runs as one step over its
        lanes' clients per round; host work between segments runs per
        lane. Returns one history per lane, in lane order; the buckets
        land on ``self._last_sweep_buckets``. This runner's own state is
        not touched. Each bucket's entry holds its ``signature``, its
        ``lane_indices`` and its ``lanes``, the runners as they finished
        (their ``params`` are the lanes' final weights). Over a sharded
        parent every lane gets its own blocks on the parent's mesh; a
        lane with another ``population_size`` raises, naming its
        label."""
        if isinstance(sweep, SweepSpec):
            if scheme_factory is not None:
                raise ValueError(
                    "scheme_factory is the seed-list argument; SweepSpec "
                    "lanes carry their own scheme factories")
            specs = list(sweep.lanes)
        else:
            specs = [LaneSpec(seed=int(s), scheme_factory=scheme_factory)
                     for s in sweep]
        if self._pop_mesh is not None:
            for spec in specs:
                n_lane = (spec.kwargs or {}).get("population_size",
                                                 self.population_size)
                if n_lane is not None and \
                        int(n_lane) != self.population_size:
                    raise ValueError(
                        f"run_sweep lane {spec.label!r} sets "
                        f"population_size={int(n_lane)} but the sharded "
                        f"parent registers {self.population_size} devices; "
                        "lanes over one population_sharding mesh share N "
                        "(cohort-size, regime and seed grids are fine): run "
                        "other N as separate sweeps")
        lanes = [self._build_lane(spec) for spec in specs]
        self._ensure_device_world()
        buckets: Dict[tuple, List[int]] = {}
        for i, lane in enumerate(lanes):
            buckets.setdefault(self._lane_signature(lane), []).append(i)
        self._last_sweep_buckets = [
            {"signature": sig, "lane_indices": list(idxs),
             "lanes": [lanes[i] for i in idxs]}
            for sig, idxs in buckets.items()]
        for bucket in self._last_sweep_buckets:
            for lane in bucket["lanes"]:
                lane._data_dev = self._data_dev   # one shared backing pool
            _run_bucket(bucket["lanes"], num_rounds)
        return [lane.history for lane in lanes]


# --------------------------------------------------------------------------- #
# one bucket of lanes (a solo run is the one-lane bucket)
# --------------------------------------------------------------------------- #
def _run_bucket(lanes: List[ScanRunner], num_rounds: int) -> None:
    """Run ``num_rounds`` rounds of every lane, segment by segment: per
    segment the host prepares each lane, the segment's rounds run as one
    step over all the lanes' clients each, and each lane absorbs its
    share of the log."""
    rep = lanes[0]
    for lane in lanes:
        lane._ensure_device_world()
    # the laned config: (L, 1) float32 tensors, one upload per run
    cfgs = [lane._laned_cfg() for lane in lanes]
    cfg = rep._to_device({k: np.asarray([[c[k]] for c in cfgs], np.float32)
                          for k in cfgs[0]})
    view = _laned_ltfl(rep.ltfl, cfg)
    # each lane's control program reads its own 0-d slice of it
    lane_views = [_laned_ltfl(lane.ltfl, {k: v[j, 0] for k, v in cfg.items()})
                  for j, lane in enumerate(lanes)]
    for a, b in rep._segment_spans(0, num_rounds):
        if rep.rng == "host":
            preps = [lane._prepare_host_segment(a, b) for lane in lanes]
            xs = rep._to_device({k: np.stack([p[0][k] for p in preps],
                                             axis=1)
                                 for k in preps[0][0]})    # (R, L, ...)
            consts = [p[1] for p in preps]
            ctls = [p[2] for p in preps]
            seeds = [p[3] for p in preps]
        else:
            preps = [lane._prepare_device_segment(a) for lane in lanes]
            xs, seeds = None, None
            consts = [p[0] for p in preps]
            ctls = [p[1] for p in preps]
        consts = rep._to_device({k: np.stack([c[k] for c in consts])
                                 for k in consts[0]})      # (L, ...)
        logs = _segment(lanes, view, cfg, consts, xs, seeds, a, b - a,
                        lane_views, rep._decide_first(a))
        host = RoundLog(*(None if f is None else f.cpu().numpy()
                          for f in logs))
        for i, lane in enumerate(lanes):
            lane._absorb_segment(a, b, ctls[i], RoundLog(
                *(None if f is None else f[:, i] for f in host)))
    for lane in lanes:
        if lane.rng == "device":
            lane._sync_host_population()


def _segment(lanes: List[ScanRunner], view, cfg: Tree, consts: Tree,
             xs: Optional[Tree], seeds: Optional[List[List[int]]],
             start: int, length: int, lane_views, decide_first: bool
             ) -> RoundLog:
    """One segment's rounds [start, start + length) for a bucket of
    lanes; no host sync inside. Returns the bucket's log, each field
    (R, L, ...) on the device."""
    rep = lanes[0]
    mode = rep.segment_sync_debug if rep.device.type == "cuda" else None
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    try:
        return _segment_rounds(lanes, view, cfg, consts, xs, seeds, start,
                               length, lane_views, decide_first)
    finally:
        if mode is not None:
            torch.cuda.set_sync_debug_mode("default")


def _segment_rounds(lanes, view, cfg, consts, xs, seeds, start, length,
                    lane_views, decide_first):
    rep = lanes[0]
    n_lanes, u, bsz = len(lanes), rep.num_devices, rep.batch_size
    data = rep._data_dev
    step = rep._step
    unbiased = rep.participation == "unbiased"
    program = rep._ctl_program       # a bucket's lanes all have one or none
    device_ctl = rep.control == "device"
    params = [lane.params for lane in lanes]
    opt_states = [lane.opt_state for lane in lanes]
    comp_state = _cat_states([lane.comp_state for lane in lanes])
    fixed = None                     # the segment's constant controls
    if program is None:
        fixed = (consts["rho"], consts["delta"], consts["power"],
                 consts["payload"])
        fixed_gap_delta = torch.where(fixed[1] > 0, fixed[1], 32.0)
        fixed_means = [torch.mean(f, dim=-1) for f in fixed[:3]]
    if device_ctl:
        no_acc = torch.full((n_lanes,), float("nan"), device=rep.device)
    lr = cfg["learning_rate"]
    cols = {k: [] for k in RoundLog._fields}
    for i in range(length):
        r = start + i
        if xs is not None:               # host rng: the replayed inputs
            ch = ChannelArrays(xs["distance"][i], xs["fading"][i],
                               xs["interference"][i], xs["cpu"][i],
                               xs["ns"][i])
            cohort, weights, alpha = (xs["cohort"][i], xs["weights"][i],
                                      xs["alpha"][i])
            inclusion = xs["inclusion"][i] if unbiased else None
            batch = _gather(data, xs["batch_idx"][i].reshape(n_lanes * u,
                                                             bsz))
            round_seeds = [s[i] for s in seeds]
            rho, delta, power, payload = fixed
        else:                            # device rng: drawn here
            decide = decide_first if i == 0 else (
                program is not None and program.every <= 1)
            (ch, cohort, weights, alpha, inclusion, batch,
             (rho, delta, power, payload)) = _device_round(
                lanes, lane_views, fixed, r, decide)
            round_seeds = [lane._generator for lane in lanes]
        accounting = None
        if rep._async is not None:
            # buffered admission masks the step's inputs; its accounting
            # replaces the synchronous one below
            masks = ((xs["alive_c"][i], xs["drop"][i])
                     if xs is not None and "alive_c" in xs else None)
            (alpha, weights, inclusion, tau, admitted,
             accounting) = rep._admission(lanes, view, ch, cohort, alpha,
                                          weights, inclusion, rho, power,
                                          payload, masks)
            cols["tau"].append(tau)
            cols["admitted"].append(admitted)
        controls = []
        for j in range(n_lanes):
            c = {"rho": rho[j], "delta": delta[j], "weights": weights[j],
                 "alpha": alpha[j], "lr": lr[j, 0]}
            if unbiased:
                c["agg_denom"] = consts["agg_denom"][j]
            controls.append(c)
        params, opt_states, comp_state, metrics = step.lanes(
            params, opt_states, comp_state, batch, controls, round_seeds)
        if accounting is None:
            delay, energy = round_accounting_dev(view, ch, payload, rho,
                                                 power)
        else:
            delay, energy = accounting
        if xs is None:
            # the carried (N,) range estimates; the program's feedback
            for j, lane in enumerate(lanes):
                lane._range_sq_dev.index_copy_(0, cohort[j],
                                               metrics[j]["range_sq"])
                if program is not None and program.feedback is not None:
                    lane._ctl_state = lane._ctl_program.feedback(
                        lane._ctl_state, cohort[j], metrics[j]["loss"],
                        delay[j])
        cols["train_loss"].append(torch.stack([m["loss"] for m in metrics]))
        cols["delay"].append(delay)
        cols["energy"].append(energy)
        cols["received"].append(torch.sum(alpha, dim=-1))
        cols["range_sq"].append(torch.stack(
            [m["range_sq"] for m in metrics]))
        cols["gap_delta"].append(fixed_gap_delta if program is None
                                 else torch.where(delta > 0, delta, 32.0))
        cols["rho_u"].append(rho)
        cols["pers"].append(packet_error_rate_dev(view.wireless, ch, power))
        cols["ns_u"].append(ch.num_samples)
        cols["cohort"].append(cohort)
        if unbiased:
            cols["inclusion"].append(inclusion)
        if device_ctl:
            due = rep.eval_every and r % rep.eval_every == 0
            cols["test_acc"].append(_eval_head(lanes, params) if due
                                    else no_acc)
            means = (fixed_means if program is None else
                     [torch.mean(f, dim=-1) for f in (rho, delta, power)])
            for k, m in zip(("rho_mean", "delta_mean", "power_mean"), means):
                cols[k].append(m)
    for lane, p, o, c in zip(lanes, params, opt_states,
                             _split_state(comp_state, n_lanes, u)):
        lane.params, lane.opt_state, lane.comp_state = p, o, c
    return RoundLog(**{k: torch.stack(v) if v else None
                       for k, v in cols.items()})


def _eval_head(lanes: List[ScanRunner], params: List[Tree]) -> torch.Tensor:
    """(L,) accuracies: each lane's mean ``model.accuracy`` over the fixed
    batches ``evaluate`` scores, float32 on the device."""
    with torch.no_grad():
        return torch.stack([
            torch.mean(torch.stack([lane.model.accuracy(p, b)
                                    for b in lane._eval_dev]))
            for lane, p in zip(lanes, params)])


def _device_round(lanes: List[ScanRunner], lane_views, fixed, r: int,
                  decide: bool):
    """One round's draws and controls for every lane, each from its own
    generator in a fixed order: the fading, the cohort and the batch
    indices (a sharded lane: ``ScanRunner._sharded_draws``, then the
    batch indices); then the control program's decision (its BO draws), when
    the lanes have one; then the packet outcomes at the decided power
    (the step then draws the quantizer's uniforms). Each lane consumes
    its stream exactly as it would alone, and without a program as under
    host control. ``fixed`` holds the segment's constant (rho, delta,
    power, payload) when there is no program. Returns the (L, U) channel
    view, cohorts, weights, packet outcomes and inclusion (or None), the
    (L * U, B, ...) batch and the (L, U) controls."""
    rep = lanes[0]
    u, bsz = rep.num_devices, rep.batch_size
    views, cohorts, weights, incls, idx = [], [], [], [], []
    for lane in lanes:
        gen = lane._generator
        if lane._pop_mesh is not None:
            ch, cohort, pi, rows, sizes = lane._sharded_draws(gen)
        else:
            if lane.block_fading:
                # the whole population redrawn each epoch, on the device
                fading, interference = draw_fading_dev(
                    lane.ltfl.wireless, gen, lane.population_size)
                lane._pop_dev = lane._pop_dev._replace(
                    fading_mean=fading, interference=interference)
            ch_pop = lane._pop_dev
            cohort, pi = lane._sampler_twin.select(ch_pop, gen)
            ch = ch_pop.take(cohort)
            sizes = torch.index_select(lane._part_sizes, 0, cohort)
            rows = torch.index_select(lane._parts_padded, 0, cohort)
        # a zero-sample device draws index 0 of its all-zero row: its
        # aggregation weight (num_samples = 0) discards it
        sizes = torch.clamp(sizes, min=1)
        draws = torch.floor(torch.rand((u, bsz), generator=gen,
                                       device=sizes.device)
                            * sizes[:, None].to(torch.float32))
        draws = torch.minimum(draws.to(torch.int64), sizes[:, None] - 1)
        idx.append(torch.gather(rows, 1, draws))
        if lane.participation == "unbiased":
            weights.append(ch.num_samples / pi)
            incls.append(pi)
        else:
            weights.append(ch.num_samples)
        views.append(ch)
        cohorts.append(cohort)
    if fixed is None:
        ctls = []
        for lane, ch, cohort, lview in zip(lanes, views, cohorts,
                                           lane_views):
            ctl, lane._ctl_state = lane._ctl_program.controls(
                lane._ctl_state, r, cohort, ch,
                torch.index_select(lane._range_sq_dev, 0, cohort),
                lane._generator, lview, decide=decide)
            ctls.append(ctl)
        fixed = tuple(torch.stack(f) for f in zip(*ctls))
    power = fixed[2]
    alphas = [sample_transmissions_dev(lane.ltfl.wireless, ch, power[j],
                                       lane._generator)
              for j, (lane, ch) in enumerate(zip(lanes, views))]
    return (ChannelArrays.stack(views), torch.stack(cohorts),
            torch.stack(weights), torch.stack(alphas),
            torch.stack(incls) if incls else None,
            _gather(rep._data_dev, torch.cat(idx)), fixed)


def _gather(data: Tree, idx: torch.Tensor) -> Tree:
    """The (L * U, B, ...) batch at global sample indices (L * U, B),
    gathered on the device (index_select keeps each leaf contiguous)."""
    flat = idx.reshape(-1)
    return {k: torch.index_select(v, 0, flat).reshape(
        idx.shape + v.shape[1:]) for k, v in data.items()}
