"""Algorithm 1 twice: the host controller (numpy float64) and its device
twin ``solve_dev`` (float32, the solve ``ScanRunner(control="device")``
runs every round), on the same ten Table-2 devices.

The two draw their Bayesian-optimization candidates from different
streams (numpy; a ``torch.Generator``), so their powers differ in
detail; the closed forms (rho*, delta*) and Gamma^n come out close. A
device whose budget no control meets gets rho_max and delta 1 from
both.

Run:  PYTHONPATH=src python examples/torch_controller_demo.py
      (on a CUDA card; add --device cpu to run on the CPU)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import LTFLConfig
from repro_torch.control import solve_dev
from repro_torch.core import controller
from repro_torch.core.channel import ChannelState
from repro_torch.core.delay_energy import (
    device_round_delay,
    device_round_energy,
)
from repro_torch.core.quantization import payload_bits_host
from repro_torch.fed import resolve_device

V = 4_901_450            # the paper-width ResNet's parameter count


def table(name, ltfl, state, rho, delta, power, per):
    """Per-device controls with the delay and energy they cost."""
    payload = payload_bits_host(V, delta, ltfl.xi_bits)
    t = device_round_delay(ltfl.wireless, state, payload, rho, power) \
        + ltfl.server_delay
    e = device_round_energy(ltfl.wireless, state, payload, rho, power)
    print(f"\n=== {name} ===")
    print(f"{'u':>2} {'rho*':>6} {'delta*':>6} {'p* (W)':>8} {'PER':>7} "
          f"{'T (s)':>9} {'E (J)':>7}")
    for i in range(state.num_devices):
        print(f"{i:>2} {rho[i]:6.3f} {int(delta[i]):6d} {power[i]:8.4f} "
              f"{per[i]:7.4f} {t[i]:9.1f} {e[i]:7.2f}")
    ok = (t <= ltfl.t_max * (1 + 1e-6)) & (e <= ltfl.e_max * (1 + 1e-6))
    print(f"within T_max={ltfl.t_max}s and E_max={ltfl.e_max}J: "
          f"{int(ok.sum())} of {state.num_devices} devices")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device for solve_dev (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ltfl = LTFLConfig(num_devices=10, bo_iters=16, alt_max_iters=4)
    rng = np.random.default_rng(args.seed)
    state = ChannelState.sample(ltfl.wireless, ltfl.num_devices,
                                ltfl.samples_min, ltfl.samples_max, rng)
    print("=== devices (Table 2 draws) ===")
    for i in range(state.num_devices):
        print(f"  u={i}: d={state.distance[i]:5.0f}m "
              f"f={state.cpu_hz[i] / 1e6:5.1f}MHz "
              f"I={state.interference[i] * 1e8:.2f}e-8W "
              f"N={state.num_samples[i]}")

    t0 = time.time()
    host = controller.solve(ltfl, state, V, rng=rng)
    host_s = time.time() - t0
    table(f"host controller.solve (numpy float64, {host_s:.3f} s, "
          f"{host.alternations} alternations)", ltfl, state,
          host.rho, host.delta, host.power, host.per)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t0 = time.time()
    dev = solve_dev(ltfl, state.to_arrays(device), V, generator=gen)
    d = {k: v.cpu().numpy().astype(np.float64)
         for k, v in dev._asdict().items()}
    dev_s = time.time() - t0
    table(f"solve_dev on {device} (float32, {dev_s:.3f} s, "
          f"{int(d['alternations'])} alternations)", ltfl, state,
          d["rho"], d["delta"], d["power"], d["per"])
    print(f"\nGamma^n: host {host.gamma:.6g}, device "
          f"{float(d['gamma']):.6g}")


if __name__ == "__main__":
    main()
