"""Bayesian optimization on the device: Algorithm 1's inner power-control
loop inside a scanned segment.

Held against ``repro.control.device_bayesopt`` (``BODraws``,
``make_draws``, ``minimize_dev``): the device twin of
``repro_torch.core.bayesopt.minimize``, the same zero-mean GP surrogate
(the RBF kernel, Eq. 48-52) and probability-of-improvement acquisition
(Eq. 53-56), in float32 tensor ops that never read a value back to the
host, so the optimizer runs inside ``ScanRunner``'s segment loop.

The fixed-shape contract, as the reference's:

* the observations live in a preallocated (P + M, D) buffer filled in
  order; the GP fit at iteration m masks the unfilled rows with an
  identity block, so the kernel matrix is block-diagonal and its
  Cholesky factor, posterior mean and variance over the filled rows are
  the host GP's, not an approximation;
* every iteration works on the same shapes, whatever m is;
* float32 throughout (the host GP is float64), with a larger jitter
  (1e-5) than the host's 1e-8: the two agree to tolerance;
* every random number is an input, a ``BODraws`` drawn up front from a
  ``torch.Generator`` (``make_draws``) or injected by the caller. The
  parity tests inject the host optimizer's numpy stream (init uniforms,
  then per iteration the candidate uniforms and the 0.1-scaled local
  normals), so both optimizers run on the same sample paths.

No host sync: the Cholesky factor comes from ``cholesky_ex`` (``cholesky``
reads its ``info`` back), the GP weights from two triangular solves
(``cho_solve``'s two), and the incumbent and the proposal are picked
with ``index_select`` on an ``argmin``, never by indexing with a tensor.
``torch.argmin`` returns the first minimum, which is the host rule's
tie-break under the shared ``_Z_SATURATION`` clamp.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bayesopt import _Z_SATURATION


class BODraws(NamedTuple):
    """Every random number one ``minimize_dev`` call consumes. A leading
    axis (``make_draws(..., alternations=K)``) stacks K calls' draws.
    ``eps_local`` holds the actual local perturbations, the 0.1 scale
    included, so a host stream (``rng.normal(0.0, 0.1, ...)``) transfers
    as it is."""

    u_init: torch.Tensor     # (P, D) init points in [0, 1]^D
    u_cand: torch.Tensor     # (M, K, D) global uniform candidates
    eps_local: torch.Tensor  # (M, K // 4, D) local perturbations


def make_draws(generator: torch.Generator, iters: int, init_points: int,
               n_candidates: int, d: int, device=None, *,
               alternations: Optional[int] = None) -> BODraws:
    """One BO call's draws from ``generator``, float32 on ``device``
    (default: the generator's). With ``alternations`` every field gains
    a leading (alternations,) axis: one draw per field for all of them,
    so a solve consumes a fixed amount of the stream."""
    device = generator.device if device is None else device
    lead = () if alternations is None else (alternations,)

    def rand(*shape):
        return torch.rand(lead + shape, generator=generator, device=device,
                          dtype=torch.float32)

    u_init = rand(init_points, d)
    u_cand = rand(iters, n_candidates, d)
    eps = torch.randn(lead + (iters, n_candidates // 4, d),
                      generator=generator, device=device,
                      dtype=torch.float32)
    return BODraws(u_init=u_init, u_cand=u_cand, eps_local=0.1 * eps)


def _rbf(a: torch.Tensor, b: torch.Tensor, lengthscale: float
         ) -> torch.Tensor:
    """kappa(x, x') = exp(-||x - x'||^2 / (2 l^2)) (Eq. 52), float32."""
    d2 = (torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
          - 2.0 * a @ b.T)
    return torch.exp(-torch.clamp(d2, min=0.0) / (2.0 * lengthscale ** 2))


def minimize_dev(objective: Callable[[torch.Tensor], torch.Tensor],
                 bounds: torch.Tensor,
                 draws: BODraws,
                 *,
                 xi=0.01,
                 lengthscale: float = 1.0,
                 jitter: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """GP + PI minimization over a box on the device; returns (x_best,
    y_best), a (D,) tensor and a 0-d tensor.

    ``objective``: batched (K, D) -> (K,). ``bounds``: (D, 2) [low,
    high]; inputs are normalized to [0, 1]^D before the kernel and the
    observations standardized, the host pipeline. ``xi`` may be a
    Python float or a 0-d tensor (a sweep lane's laned value)."""
    bounds = bounds.to(torch.float32)
    lo, hi = bounds[:, 0], bounds[:, 1]
    span = torch.clamp(hi - lo, min=1e-12)
    p, d = draws.u_init.shape
    m_iters = draws.u_cand.shape[0]
    t = p + m_iters
    device = bounds.device

    def denorm(u):
        return lo + u * span

    xs = torch.zeros((t, d), dtype=torch.float32, device=device)
    ys = torch.zeros((t,), dtype=torch.float32, device=device)
    xs[:p] = draws.u_init
    ys[:p] = objective(denorm(draws.u_init)).to(torch.float32)
    # the live prefix of every iteration, and its padded diagonal
    valid_all = (torch.arange(t, device=device)[None, :]
                 < (p + torch.arange(m_iters, device=device))[:, None])
    diag_all = torch.where(valid_all, jitter, 1.0).to(torch.float32)
    n_live_all = (p + torch.arange(m_iters, device=device)).to(torch.float32)

    for m in range(m_iters):
        valid = valid_all[m]
        n_live = n_live_all[m]
        # standardize the live observations (host: mean / std, or 1)
        mu_y = torch.sum(torch.where(valid, ys, 0.0)) / n_live
        sd_y = torch.sqrt(torch.sum(torch.where(valid, (ys - mu_y) ** 2,
                                                0.0)) / n_live)
        sd_y = torch.where(sd_y > 0.0, sd_y, 1.0)
        ys_std = torch.where(valid, (ys - mu_y) / sd_y, 0.0)

        # masked GP fit: the live block plus an identity padding
        k_full = _rbf(xs, xs, lengthscale)
        mask2 = valid[:, None] & valid[None, :]
        k_masked = torch.where(mask2, k_full, 0.0) + torch.diag(diag_all[m])
        chol, _ = torch.linalg.cholesky_ex(k_masked)
        half = torch.linalg.solve_triangular(chol, ys_std[:, None],
                                             upper=False)
        alpha = torch.linalg.solve_triangular(chol.T, half,
                                              upper=True)[:, 0]

        best_idx = torch.argmin(torch.where(valid, ys_std, float("inf")))
        best = best_idx.reshape(1)
        y_star = torch.index_select(ys_std, 0, best)
        x_inc = torch.index_select(xs, 0, best)                   # (1, D)

        # candidates: global uniforms + local perturbations of the
        # incumbent (host draw order; eps carries the 0.1 scale)
        cand = torch.cat([draws.u_cand[m],
                          torch.clamp(x_inc + draws.eps_local[m], 0.0, 1.0)])

        kq = _rbf(xs, cand, lengthscale) * valid[:, None].to(torch.float32)
        mu = kq.T @ alpha
        v = torch.linalg.solve_triangular(chol, kq, upper=False)
        var = torch.clamp(1.0 - torch.sum(v * v, dim=0), min=1e-12)
        # Eq. 53/56: maximize PI = 1 - Phi(z) <=> minimize z, clamped at
        # the shared saturation level so that candidates with PI ~ 1 tie
        # and the first wins (the host optimizer's rule)
        z = torch.clamp((mu - y_star - xi) / torch.sqrt(var),
                        min=_Z_SATURATION)
        x_next = torch.index_select(cand, 0, torch.argmin(z).reshape(1))
        y_next = objective(denorm(x_next)).to(torch.float32)
        xs[p + m:p + m + 1] = x_next
        ys[p + m:p + m + 1] = y_next

    best = torch.argmin(ys).reshape(1)
    return (denorm(torch.index_select(xs, 0, best)[0]),
            torch.index_select(ys, 0, best)[0])
