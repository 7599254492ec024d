"""LTFL paper system parameters (Table 2).

Held against ``repro.configs.base`` (``WirelessConfig``, ``LTFLConfig``):
the same fields, defaults and checks, so a configuration built on either
side describes the same system.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class WirelessConfig:
    """Wireless/PHY + device parameters, exactly the paper's Table 2.

    Notes:
      * N0 = -174 dBm/Hz = 3.98e-21 W/Hz.
      * The waterfall threshold is listed as "0.023dB" in Table 2; the
        PER formula (Eq. 3) uses it as a linear factor, and 0.023 linear
        reproduces sensible packet error rates (~1-10%), so it is linear.
      * f_u ~ U[30, 110] MHz and c0 = 2.7e8 cycles/sample are the paper's
        values verbatim.
    """

    p_max: float = 0.1               # W
    p_min: float = 0.01              # W
    bandwidth_ul: float = 10e6       # Hz (B_u^UL)
    n0: float = 3.98e-21             # W/Hz (-174 dBm/Hz)
    waterfall: float = 0.023         # Upsilon (linear, see note)
    fading_scale: float = 0.015      # E[varpi_u] Rayleigh scale
    dist_min: float = 100.0          # m, d_u ~ U[100, 300]
    dist_max: float = 300.0
    interference_min: float = 1e-8   # W, I_u ~ U[1e-8, 2e-8]
    interference_max: float = 2e-8
    cpu_min: float = 30e6            # Hz, f_u ~ U[30, 110] MHz
    cpu_max: float = 110e6
    cycles_per_sample: float = 2.7e8 # c0
    k_eff: float = 1.25e-26          # k (effective switched capacitance)
    sigma_exp: float = 3.0           # sigma in E = k f^sigma T


@dataclass(frozen=True)
class LTFLConfig:
    """Controller + FL-round configuration (problem P1, Algorithm 1)."""

    num_devices: int = 30            # U
    samples_min: int = 400           # N_u ~ U[400, 600]
    samples_max: int = 600
    rho_max: float = 0.5             # rho^max
    delta_max: int = 8               # delta^max (bits)
    xi_bits: int = 64                # xi: bits for (min, max, sign block)
    t_max: float = 3000.0            # T^max per round
    e_max: float = 10.0              # E^max per device per round
    server_delay: float = 1.0        # s (Eq. 33)
    learning_rate: float = 0.05      # eta
    # Algorithm 1 / Bayesian optimization
    bo_iters: int = 24               # M^max
    bo_xi: float = 0.01              # PI acquisition offset (Eq. 53)
    alt_max_iters: int = 8           # outer alternation cap
    alt_tol: float = 1e-3            # convergence criterion (Eq. 57)
    # Theorem-1 constants (Assumptions 1-4)
    lipschitz: float = 1.0           # L
    d_sq: float = 1.0                # D^2 (second-moment bound)
    v1: float = 1.0                  # v1 (Assumption 4)
    v2: float = 1.0 / 24.0           # v2 < 1/12 so (1 - 12 v2) > 0
    seed: int = 0
    wireless: WirelessConfig = field(default_factory=WirelessConfig)

    def __post_init__(self):
        if not 0.0 <= self.rho_max <= 1.0:
            raise ValueError("rho_max must be in [0, 1]")
        if self.v2 >= 1.0 / 12.0:
            raise ValueError("Theorem 1 requires v2 < 1/12")
