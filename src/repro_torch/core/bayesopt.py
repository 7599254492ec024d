"""Bayesian optimization for transmission power control (paper Section 5.3).

Gaussian-process surrogate with the paper's RBF kernel (Eq. 52,
kappa = exp(-||p - p'||^2 / 2) on normalized inputs) and the
probability-of-improvement acquisition (Eq. 53-56). Pure numpy: the
controller runs on the edge server, outside the jitted training path.

``minimize`` supports two objective shapes:

* scalar (default): ``objective((D,)) -> float``, called point-by-point;
* ``vectorized=True``: ``objective((K, D)) -> (K,)`` — init points are
  scored in ONE call and each per-iteration proposal as a (1, D) batch,
  so a device-broadcasting objective (e.g. the controller's batched
  Gamma/feasibility evaluation over K candidate power vectors) never
  falls back to per-point Python loops. Both paths consume the rng
  stream identically, so seeded runs agree between them.

Held against ``repro.core.bayesopt``: a numpy copy of the whole module,
so a seeded ``minimize`` consumes the rng stream identically and returns
bitwise the same result. The device twin
(``repro_torch.control.device_bayesopt``) shares the saturation-clamped
argmin-z proposal rule below.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
from scipy.special import erf


def _rbf(a: np.ndarray, b: np.ndarray, lengthscale: float) -> np.ndarray:
    """kappa(x, x') = exp(-||x - x'||^2 / (2 l^2)); paper uses l = 1."""
    d2 = np.sum(a * a, -1)[:, None] + np.sum(b * b, -1)[None, :] \
        - 2.0 * a @ b.T
    return np.exp(-np.maximum(d2, 0.0) / (2.0 * lengthscale ** 2))


class GaussianProcess:
    """Zero-mean GP posterior (Eq. 48-51); predictions are batched over
    query points. Pure numpy — mixing in scipy.linalg here measurably
    thrashes numpy's BLAS thread pool on small hosts."""

    def __init__(self, lengthscale: float = 1.0, jitter: float = 1e-8):
        self.lengthscale = lengthscale
        self.jitter = jitter
        self._x: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.asarray(x, np.float64)
        self._y = np.asarray(y, np.float64)
        k = _rbf(self._x, self._x, self.lengthscale)
        k[np.diag_indices_from(k)] += self.jitter
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, self._y))

    def predict(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean (Eq. 50) and variance (Eq. 51) at query points."""
        kq = _rbf(self._x, np.asarray(xq, np.float64), self.lengthscale)
        mu = kq.T @ self._alpha
        v = np.linalg.solve(self._chol, kq)
        var = np.maximum(1.0 - np.sum(v * v, axis=0), 1e-12)
        return mu, var


def _norm_cdf(x: np.ndarray) -> np.ndarray:
    """Phi(x) (Eq. 55) via the true vectorized erf (one array op over all
    acquisition candidates, not an element-by-element Python loop)."""
    return 0.5 * (1.0 + erf(np.asarray(x, np.float64) / np.sqrt(2.0)))


# Acquisition-equivalence floor for the proposal argmax (see the
# selection comment in ``minimize``): 1 - Phi(-6) differs from 1.0 by
# ~1e-9, so below this z every candidate is treated as tied and the
# FIRST one wins — a deliberate shared rule (it slightly changes f64
# selection in the z range (-8.3, -6), where argmax over f64 PI used to
# resolve sub-1e-9 differences) so the f32 twin in
# repro_torch.control.device_bayesopt ties exactly the same way.
_Z_SATURATION = -6.0


@dataclass
class BOResult:
    x_best: np.ndarray
    y_best: float
    history: np.ndarray     # (M,) best-so-far trace


def minimize(objective: Callable[[np.ndarray], float],
             bounds: np.ndarray,
             iters: int,
             rng: np.random.Generator,
             xi: float = 0.01,
             n_candidates: int = 512,
             lengthscale: float = 1.0,
             init_points: int = 4,
             vectorized: bool = False) -> BOResult:
    """Minimize ``objective`` over a box via GP + PI (Algorithm 1's inner loop).

    bounds: (D, 2) array of [low, high]. Inputs are normalized to [0, 1]^D
    before entering the kernel; observations are standardized.
    ``vectorized=True`` declares a batched objective (K, D) -> (K,).
    """
    bounds = np.asarray(bounds, np.float64)
    lo, hi = bounds[:, 0], bounds[:, 1]
    span = np.maximum(hi - lo, 1e-12)
    d = len(lo)

    def denorm(u):
        return lo + u * span

    def evaluate(u: np.ndarray) -> float:
        """Score one normalized point through either objective shape."""
        if vectorized:
            return float(np.asarray(objective(denorm(u[None, :])))[0])
        return float(objective(denorm(u)))

    xs = [rng.uniform(0.0, 1.0, size=d) for _ in range(max(init_points, 1))]
    if vectorized:   # score every init point in ONE batched call
        ys = [float(y) for y in np.asarray(objective(denorm(np.stack(xs))))]
    else:
        ys = [float(objective(denorm(u))) for u in xs]
    gp = GaussianProcess(lengthscale=lengthscale)
    trace = [min(ys)]

    for _ in range(iters):
        x_arr = np.stack(xs)
        y_arr = np.asarray(ys)
        mu_y, sd_y = float(np.mean(y_arr)), float(np.std(y_arr)) or 1.0
        gp.fit(x_arr, (y_arr - mu_y) / sd_y)

        best_idx = int(np.argmin(y_arr))
        y_star = (y_arr[best_idx] - mu_y) / sd_y

        # candidates: global uniform + local perturbations of the incumbent
        cand = rng.uniform(0.0, 1.0, size=(n_candidates, d))
        local = np.clip(x_arr[best_idx]
                        + rng.normal(0.0, 0.1, size=(n_candidates // 4, d)),
                        0.0, 1.0)
        cand = np.concatenate([cand, local], axis=0)

        mu, var = gp.predict(cand)
        sd = np.sqrt(var)
        # Eq. 53/56: maximizing PI = 1 - Phi(z) with z = (mu - y* - xi)/sd
        # is minimizing z (Phi is strictly monotone) — except below the
        # _Z_SATURATION floor, where ALL candidates are deliberately
        # treated as acquisition-equivalent (their PI values differ by
        # < 1e-9) and the FIRST one wins. That floor is a small, explicit
        # change from strict argmax over floating-point PI: it replaces
        # BOTH precision-dependent saturation regimes (f64 argmax used to
        # resolve sub-1e-9 PI differences down to z ~ -8.3 and tie-break
        # by first index only below; f32 saturates far earlier) with one
        # shared rule, preserving the old behavior's exploration property
        # (raw argmin(z) would always chase sd -> 0 candidates glued to
        # the incumbent) while making the f32 twin
        # (repro_torch.control.device_bayesopt.minimize_dev) pick the same
        # candidate on injected draws instead of diverging wherever the
        # two precisions saturate differently.
        z = np.maximum((mu - y_star - xi) / sd, _Z_SATURATION)
        x_next = cand[int(np.argmin(z))]                # Eq. 56
        xs.append(x_next)
        ys.append(evaluate(x_next))
        trace.append(min(ys))

    best = int(np.argmin(ys))
    return BOResult(x_best=denorm(xs[best]), y_best=float(ys[best]),
                    history=np.asarray(trace))
