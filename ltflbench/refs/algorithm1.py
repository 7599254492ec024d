"""Algorithm 1 (paper Section 5) and the host's draws of an edge round, in
plain NumPy.

Algorithm 1 alternates two stages until the convergence gap Gamma (Eq.
29) changes by no more than ``alt_tol`` (Eq. 57), at most
``alt_max_iters`` times:

1. the closed forms at the current powers: the pruning ratio of Theorem
   2 (Eq. 40-42) from the payload at the current bits, then the bits of
   Theorem 3 (Eq. 44-46) at that ratio;
2. Bayesian optimisation of the power vector (Section 5.3, problem P4):
   a Gaussian process with the RBF kernel of Eq. 52 on powers scaled to
   [0, 1], observations standardised, four random starting points, then
   ``bo_iters`` proposals, each the candidate of least z = (mu - y* -
   xi) / sd (Eq. 53-56, probability of improvement) among 512 uniform
   candidates and 128 Gaussian steps (sd 0.1) from the incumbent, z held
   at -6 or above so that candidates whose improvement is certain tie and
   the first wins. The objective is Gamma, plus 1e9 where a device breaks
   its delay (Eq. 34) or energy (Eq. 37) budget.

A last pass of stage 1 at the chosen powers gives the decision.
Expectations over Rayleigh fading (the rate of Eq. 1 and the packet
error rate of Eq. 3) are 64-point Gauss-Laguerre sums; the payload of Eq.
18 is a float32 product and sum, as the paper's system counts it.
Everything else is float64, or ``dtype`` throughout for the control.

``HostStream`` re-makes the host's draws from the run's seed, in the
system's documented order, on one ``numpy.random.Generator``: the
devices of Table 2 (distances, interference, CPU frequencies, sample
counts: one vectorised draw each; the mean fading is the configuration's
scale), one permutation of the training pool cut in device order into
sorted parts, then for each round Algorithm 1 on a recontrol round (its
draws), each device's batch (a choice without replacement from its
part), the round's seed (an integer in [0, 2^31 - 1)) and the packet
outcomes (one uniform a device, received where it is at or above the
device's packet error rate at its power).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

PENALTY = 1e9
Z_FLOOR = -6.0
CANDIDATES = 512
INIT_POINTS = 4
_NODES, _WEIGHTS = np.polynomial.laguerre.laggauss(64)


class Decision(NamedTuple):
    rho: np.ndarray
    delta: np.ndarray
    power: np.ndarray


class Devices(NamedTuple):
    distance: np.ndarray
    fading: np.ndarray
    interference: np.ndarray
    cpu: np.ndarray
    samples: np.ndarray


class Algorithm1:
    """Algorithm 1 for one cell's configuration (``ltfl`` and
    ``wireless`` as in the configuration file), in ``dtype``."""

    def __init__(self, ltfl: dict, wireless: dict, num_params: int,
                 dtype=np.float64):
        self.dt = np.dtype(dtype).type
        self.l = {k: self.dt(v) for k, v in ltfl.items()
                  if isinstance(v, (int, float))}
        self.w = {k: self.dt(v) for k, v in wireless.items()}
        self.iters, self.alts = int(ltfl["bo_iters"]), int(
            ltfl["alt_max_iters"])
        self.delta_max = int(ltfl["delta_max"])
        self.v = num_params
        self.nodes = _NODES.astype(self.dt)
        self.weights = _WEIGHTS.astype(self.dt)

    def arr(self, x) -> np.ndarray:
        return np.asarray(x, self.dt)

    # -- the channel (Eq. 1-3) ------------------------------------------
    def gain(self, dev: Devices) -> np.ndarray:
        """E[h] = E[varpi] d^-2 (Eq. 2)."""
        return self.arr(dev.fading) * self.arr(dev.distance) ** self.dt(-2)

    def noise(self, dev: Devices) -> np.ndarray:
        return self.arr(dev.interference) + self.w["bandwidth_ul"] \
            * self.w["n0"]

    def rate(self, dev: Devices, power) -> np.ndarray:
        """Eq. 1: B E_X[log2(1 + c X)], X ~ Exp(1), c = p E[h] / (I +
        B N0)."""
        c = self.arr(power) * self.gain(dev) / self.noise(dev)
        return self.w["bandwidth_ul"] * np.sum(
            self.weights * np.log2(self.dt(1) + c[..., None] * self.nodes),
            axis=-1)

    def per(self, dev: Devices, power) -> np.ndarray:
        """Eq. 3: E_X[1 - exp(-c / X)], c = waterfall (I + B N0) / (p
        E[h]), clipped to [0, 1]."""
        c = self.w["waterfall"] * self.noise(dev) / (self.arr(power)
                                                     * self.gain(dev))
        x = np.maximum(self.nodes, self.dt(1e-12))
        return np.clip(np.sum(self.weights * (self.dt(1) - np.exp(
            -c[..., None] / x)), axis=-1), 0, 1).astype(self.dt)

    def payload(self, delta) -> np.ndarray:
        """Eq. 18: V delta + xi bits, a float32 product and sum."""
        f = np.float32
        return (f(self.v) * np.asarray(delta, f) + f(self.l["xi_bits"])
                ).astype(self.dt)

    # -- budgets and the gap (Eq. 29-37) ----------------------------------
    def cycles(self, dev: Devices) -> np.ndarray:
        return self.arr(dev.samples) * self.w["cycles_per_sample"]

    def compute_energy(self, dev: Devices) -> np.ndarray:
        """k f^(sigma - 1) N c0: Eq. 35 without the kept share."""
        return self.w["k_eff"] * self.arr(dev.cpu) ** (
            self.w["sigma_exp"] - self.dt(1)) * self.arr(dev.samples) \
            * self.w["cycles_per_sample"]

    def feasible(self, dev: Devices, rho, delta, power) -> np.ndarray:
        """Every device within T^max (Eq. 31-34) and E^max (Eq. 35-37),
        to a relative 1e-9."""
        keep = self.dt(1) - self.arr(rho)
        up = self.payload(delta) * keep / np.maximum(
            self.rate(dev, power), self.dt(1e-9))
        t = self.cycles(dev) * keep / self.arr(dev.cpu) + up \
            + self.l["server_delay"]
        e = self.compute_energy(dev) * keep + self.arr(power) * up
        tol = self.dt(1) + self.dt(1e-9)
        return (np.all(t <= self.l["t_max"] * tol, axis=-1)
                & np.all(e <= self.l["e_max"] * tol, axis=-1))

    def gamma(self, dev: Devices, range_sq, rho, delta, power):
        """Eq. 29: (3 sum R_u / (4 (2^delta - 1)^2) + 3 L^2 D^2 sum rho
        + 12 v1 / N sum N_u q_u) / (1 - 12 v2), with R_u each device's
        gradient-range mass."""
        steps = np.maximum(self.dt(2) ** self.arr(delta) - self.dt(1),
                           self.dt(1e-12))
        n = self.arr(dev.samples)
        quant = self.dt(3) * np.sum(self.arr(range_sq) / (
            self.dt(4) * steps * steps), axis=-1)
        prune = self.dt(3) * self.l["lipschitz"] ** 2 * self.l["d_sq"] \
            * np.sum(self.arr(rho), axis=-1)
        trans = self.dt(12) * self.l["v1"] / np.sum(n) * np.sum(
            n * self.per(dev, power), axis=-1)
        scale = self.dt(1) / (self.dt(1) - self.dt(12) * self.l["v2"])
        return scale * (quant + prune + trans)

    # -- stage 1: Theorems 2 and 3 ----------------------------------------
    def stage1(self, dev: Devices, delta, power):
        one = self.dt(1)
        power = self.arr(power)
        rate = np.maximum(self.rate(dev, power), self.dt(1e-30))
        cpu, e_comp = self.arr(dev.cpu), self.compute_energy(dev)
        bits = self.payload(delta)
        phi1 = (self.l["t_max"] - self.l["server_delay"]) / (
            self.cycles(dev) / cpu + bits / rate)
        phi2 = self.l["e_max"] / (e_comp + power * bits / rate)
        rho = np.clip(one - np.minimum(phi1, phi2), 0,
                      self.l["rho_max"]).astype(self.dt)
        keep = np.maximum(one - rho, self.dt(1e-9))
        phi3 = (self.l["t_max"] - self.l["server_delay"]
                - self.cycles(dev) * keep / cpu) * rate / keep
        phi4 = (self.l["e_max"] - e_comp * keep) * rate / (power * keep)
        v_kept = self.dt(self.v) * keep
        raw = np.minimum(np.minimum((phi3 - self.l["xi_bits"]) / v_kept,
                                    (phi4 - self.l["xi_bits"]) / v_kept),
                         self.dt(self.delta_max))
        raw = np.where(np.isnan(raw), one, raw)
        delta = np.clip(np.floor(raw), 1, self.delta_max).astype(np.int64)
        return rho, delta

    # -- stage 2: Bayesian optimisation over the powers -------------------
    def kernel(self, a, b) -> np.ndarray:
        d2 = np.sum(a * a, -1)[:, None] + np.sum(b * b, -1)[None, :] \
            - self.dt(2) * a @ b.T
        return np.exp(-np.maximum(d2, 0) / self.dt(2))

    def powers_by_bo(self, objective, u: int, rng: np.random.Generator):
        lo, hi = self.w["p_min"], self.w["p_max"]
        span = max(hi - lo, self.dt(1e-12))
        xs = [self.arr(rng.uniform(0.0, 1.0, size=u))
              for _ in range(INIT_POINTS)]
        ys = [self.dt(y) for y in objective(lo + np.stack(xs) * span)]
        for _ in range(self.iters):
            x, y = np.stack(xs), self.arr(ys)
            mu_y, sd_y = np.mean(y), np.std(y)
            sd_y = sd_y if sd_y != 0 else self.dt(1)
            target = (y - mu_y) / sd_y
            k = self.kernel(x, x) + self.dt(1e-8) * np.eye(len(xs),
                                                          dtype=self.dt)
            chol = np.linalg.cholesky(k)
            alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, target))
            best = int(np.argmin(y))
            cand = np.concatenate([
                self.arr(rng.uniform(0.0, 1.0, size=(CANDIDATES, u))),
                np.clip(x[best] + self.arr(rng.normal(
                    0.0, 0.1, size=(CANDIDATES // 4, u))), 0, 1)])
            kq = self.kernel(x, cand)
            mu = kq.T @ alpha
            v = np.linalg.solve(chol, kq)
            sd = np.sqrt(np.maximum(self.dt(1) - np.sum(v * v, axis=0),
                                    self.dt(1e-12)))
            z = np.maximum((mu - target[best] - self.l["bo_xi"]) / sd,
                           self.dt(Z_FLOOR))
            pick = cand[int(np.argmin(z))]
            xs.append(pick)
            ys.append(self.dt(objective(lo + pick[None, :] * span)[0]))
        return lo + xs[int(np.argmin(ys))] * span

    def solve(self, dev: Devices, range_sq, rng: np.random.Generator
              ) -> Decision:
        u = len(dev.distance)
        power = np.full(u, (self.w["p_min"] + self.w["p_max"])
                        / self.dt(2), self.dt)
        delta = np.full(u, self.delta_max, np.int64)
        prev = np.inf
        for _ in range(self.alts):
            rho, delta = self.stage1(dev, delta, power)

            def objective(p, rho=rho, delta=delta):
                g = self.gamma(dev, range_sq, rho, delta, p)
                return g + np.where(self.feasible(dev, rho, delta, p),
                                    self.dt(0), self.dt(PENALTY))

            power = self.powers_by_bo(objective, u, rng)
            g = float(self.gamma(dev, range_sq, rho, delta, power))
            done = abs(prev - g) <= float(self.l["alt_tol"])
            prev = g
            if done:
                break
        rho, delta = self.stage1(dev, delta, power)
        return Decision(rho=rho, delta=delta, power=power)


class HostStream:
    """The host's draws of an edge run (module docstring), from ``seed``;
    ``cf`` is the configuration file. ``round(r)`` gives round r's
    decision, weights, batch indices, seed and packet outcomes, with
    Algorithm 1 run in ``dtype`` on recontrol rounds."""

    def __init__(self, cf: dict, seed: int, num_params: int,
                 dtype=np.float64):
        l, w = cf["ltfl"], cf["wireless"]
        u = int(l["num_devices"])
        self.rng = rng = np.random.default_rng(int(seed))
        distance = rng.uniform(w["dist_min"], w["dist_max"], u)
        interference = rng.uniform(w["interference_min"],
                                   w["interference_max"], u)
        cpu = rng.uniform(w["cpu_min"], w["cpu_max"], u)
        samples = rng.integers(l["samples_min"], l["samples_max"] + 1, u)
        self.dev = Devices(distance, np.full(u, w["fading_scale"]),
                           interference, cpu, samples)
        perm = rng.permutation(int(cf["train_samples"]))
        ends = np.cumsum(samples)
        self.parts = [np.sort(perm[e - n:e]) for n, e in zip(samples, ends)]
        self.alg = Algorithm1(l, w, num_params, dtype)
        self.check = Algorithm1(l, w, num_params)   # outcomes in float64
        self.range_sq = np.full(u, 1e-2 * num_params)
        self.every, self.batch = int(cf["recontrol_every"]), int(
            cf["batch_size"])
        self.decision = None

    def round(self, r: int) -> Dict[str, object]:
        if self.decision is None or (self.every and r % self.every == 0):
            self.decision = self.alg.solve(self.dev, self.range_sq, self.rng)
        d = self.decision
        idx = np.stack([p[self.rng.choice(p.size, size=self.batch,
                                          replace=self.batch > p.size)]
                        for p in self.parts])
        seed = int(self.rng.integers(0, 2 ** 31 - 1))
        q = self.check.per(self.dev, np.asarray(d.power, np.float64))
        alpha = (self.rng.random(len(q)) >= q).astype(np.int64)
        return {"decision": d, "weights": self.dev.samples.astype(
            np.float64), "batch_idx": idx, "seed": seed, "alpha": alpha}


def decision_gaps(prog: Decision, ref: Decision, ltfl: dict,
                  wireless: dict) -> Dict[str, float]:
    """The worst device's gap in each decision, over the decision's
    range: rho over rho_max, bits over delta_max, power over p_max."""
    return {
        "rho": float(np.max(np.abs(np.asarray(prog.rho, np.float64)
                                   - ref.rho))) / ltfl["rho_max"],
        "delta": float(np.max(np.abs(np.asarray(prog.delta, np.float64)
                                     - ref.delta))) / ltfl["delta_max"],
        "power": float(np.max(np.abs(np.asarray(prog.power, np.float64)
                                     - ref.power))) / wireless["p_max"]}
