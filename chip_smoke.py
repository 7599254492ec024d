#!/usr/bin/env python3
"""Card check for the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py                # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile DIR  # also writes torch.profiler
                                         # tables (see the end of this list)

Phases; any failure exits non-zero before the result lines:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every hand-written kernel from the sources in this checkout (one
   nvcc per source, started together), with ptxas' register report;
3. kernel vs plain version: the quantizer at all 32 leaf shapes of the
   paper-width ResNet x 30 clients, float32 and bfloat16, mixed per-client
   bits (1, 2, 4, 8), the same uniforms; float32 must agree exactly,
   bfloat16 to within one quantization step on < 1e-3 of the elements;
4. small reference: one round step at width 8, 4 clients, on the card and
   on the CPU (plain version) with the same injected uniforms — loss and
   the updated weights must agree (float32 tolerance, rare one-step flips);
5. main path: ``FedRunner`` + ``LTFLScheme`` on the card at the paper's
   full width (ResNetConfig() defaults, 4,901,450 parameters), U = 30
   devices, per-device batch 50, synthetic CIFAR of 20,000 images, eval
   on, 3 rounds; every loss finite and the quantizer launched exactly
   once per leaf per round (32), counted from 0 just before the run;
6. timing: the kernel and its plain version with CUDA events, at the
   largest leaf (30 x 2,359,296) and over all 32 leaves of a round, the
   latter both launched from Python (eager) and replayed from a CUDA
   graph (the device time, reported as ``ms``);
7. block kernels vs plain versions: ``block_norms`` and
   ``apply_block_mask`` at all 9 tileable leaf shapes of granite-8b's
   full widths (2 layers), float32 and bfloat16, blocks 32/64/128, C = 4
   per-client masks (rho 0.25/0.1/0.5/0.9): the norms, the tile masks
   ranked from them, the masked weights (one shared w) and the gated
   stacked gradients must all be bitwise equal (compared as integers,
   so the sign of zero counts);
8. small datacenter reference: one block-pruned step of granite-8b at
   ``reduce_for_smoke`` widths on the card (kernels) and on the CPU
   (plain versions) with the same weights, batch and injected draws:
   tile masks equal; in float32 the loss and the updated weights agree
   within phase 4's tolerances, in bfloat16 within the parity tests'
   (tests/test_torch_datacenter.py);
9. datacenter main path: ``repro_torch.launch.train.run_datacenter`` on
   granite-8b at its published widths with the depth cut to 2 layers
   (838,881,280 parameters, bf16), the launcher's defaults (4 clients x
   batch 2 x seq 128, rho 0.25, delta 8, drop 0.05, block 32, lr 0.05),
   3 steps: every loss finite and, counted from 0 just before the run,
   per step 9 ``block_norms``, 18 ``apply_block_mask`` (9 for the
   weights, 9 for the gradient gate) and 12 ``stochastic_quant``
   launches; step times and the peak device memory are printed;
10. timing: each block kernel, its plain version and the one-call
   PyTorch equivalent (``library_ms``) with CUDA events, at the largest
   leaf (embed.tok, 49152 x 4096) and over a step's 9 leaves, eager and
   graph-replayed, beside the bound (bytes over 3.35 TB/s);
11. ``block_sparse_matmul`` vs its plain version, float32 and bfloat16:
   tests/test_kernels.py's shapes and densities (float32 within its
   1e-4), and x (1024, K) against each of granite-8b's 8 projection
   shapes at its published widths with tile masks from
   ``ops.block_prune_2d(w, 0.25, block=(128, 128))`` (float32 within
   2 K 2^-24 (|x| |w|), the bound on two float32 sums of K products in
   different orders; bfloat16 within one bf16 ulp on all but 1e-3 of
   the elements, and within one ulp plus that float32 bound on all); a
   fully masked product is exact zeros. Every product must take the path
   ``kernel_path`` names, read from the per-path launch counts: bfloat16
   at 128-multiples (the reference shapes and the 8 full-width ones)
   ``wgmma``, float32 and the test file's odd-block shapes ((8, 3, 5);
   (96, 60, 48) at blocks (32, 20, 16); (200, 300, 64) at (40, 30, 8))
   ``simt``. Then this slice's main path, ``ops.pruned_matmul`` at
   (1024, 4096) x (4096, 14336) bf16, with every launch count set to 0
   just before: ``block_norms``, ``apply_block_mask`` and
   ``block_sparse_matmul`` launch once each, the last on the ``wgmma``
   path, and the result equals the plain path's;
12. the paper's four baselines (``fedsgd``, ``signsgd``, ``fedmp``,
   ``stc``) through ``FedRunner`` at phase 5's full width and settings,
   3 rounds each: every loss finite, 0 quantizer launches, STC's
   residual finite; round times and peak device memory are printed;
13. timing: ``block_sparse_matmul``, its plain version and the library
   call (bf16 cuBLAS ``x @ w`` on the pre-masked weight) at each of the
   8 full-width shapes and summed over them, eager and graph-replayed,
   beside the bound: the live tiles' 2 M bk bn operations over the bf16
   tensor-core peak (989 TFLOP/s), or x, the live tiles of w, the
   output and the mask over 3.35 TB/s, whichever is more; then a sweep
   of the pruning ratio at wi_gate (1024 x 4096 x 14336; rho 0, 0.25,
   0.5, 0.75, 0.9): B4 and dense bf16 cuBLAS graph-replayed beside B4's
   bound, which gives the rho at which skipping beats the dense call.

14. serving at small size, card against CPU: granite-8b, olmoe-1b-7b,
   deepseek-v2-lite-16b (MLA) and phi-3-vision-4.2b (VLM) at
   ``reduce_for_smoke`` widths in float32, the same weights and prompt
   (2 x 48) on both: the prefill's logits (rel 1e-5) and cache (bf16, one
   ulp on <= 1e-3 of its elements), and 9 greedy tokens through
   ``repro_torch.launch.serve.generate`` (each side's decode logits rel
   3e-4, the ids equal): tests/test_torch_serve.py's tolerances;
15. serving granite-8b at its full published config (36 layers,
   8,254,390,272 parameters by ``param_count()``, bf16, seed 0) through
   ``generate``: batch 8 x prompt 2048 x 64 tokens, and batch 1 x prompt
   32768 x 8 tokens, which must take the query-chunked attention path
   (one call a layer; the first run none). Per run: prefill seconds and
   TFLOP/s (the reference formulation's matmul work) against 989, the
   median decode step by CUDA events against its bytes bound (the
   weights it reads, the whole cache, over 3.35 TB/s), tok/s and the
   peak memory. Then decode against forward: the decode step at position
   2048 (batch 2) against ``forward`` over the same 2049 tokens, in bf16
   and again with the same weights in float32: float32 within rel 1e-2
   (the bf16 cache's rounding, tests/test_torch_mla.py's bound) on the
   rows whose MoE routing agrees at every layer (a near-tie the cache's
   rounding flips is counted), and the bf16 decode no farther from the
   float32 forward than twice the bf16 forward is (its own bf16 noise);
16. serving olmoe-1b-7b, deepseek-v2-lite-16b and phi-3-vision-4.2b at
   their full published configs: batch 8 x prompt 2048 x 32 tokens, the
   same numbers (the MoE bound counts the distinct experts the step's
   tokens chose), and decode against forward as in phase 15 at batch 8,
   position 63 (phi: 576 + 63), with capacity factor 16 for MoE
   (prefill drops tokens, decode does not). No hand-written kernel lies on the serving path
   (as in the reference): phases 14-16 must leave every ``LAUNCHES``
   count as it was;
17. small datacenter reference of the other families: phase 8's step, in
   float32, for olmoe-1b-7b (MoE), rwkv6-7b (SSM), zamba2-2.7b (hybrid)
   and whisper-medium (encoder-decoder, with frames) at
   ``reduce_for_smoke`` widths, card against CPU: tile masks equal, the
   loss and the updated weights within phase 4's tolerances;
18. the datacenter main path of those four at their published widths
   through ``run_datacenter`` with the launcher's defaults, 3 steps, the
   depth cut (``DC_FAMILIES``): olmoe and rwkv6 to 2 layers, zamba2 to
   one segment of 6, whisper to 2 encoder + 2 decoder layers over its
   1500 frames. Every loss finite and, counted from 0 just before each
   run, per step one ``stochastic_quant`` per leaf, one ``block_norms``
   per tileable leaf and two ``apply_block_mask`` per tileable leaf, as
   the reference's leaf tree implies (olmoe 13/10/20, rwkv6 20/13/26,
   zamba2 21/10/20, whisper 33/17/34); step times and peak memory;
19. phase 14 for rwkv6-7b, zamba2-2.7b and whisper-medium (a float32
   recurrent state rel 1e-5);
20. serving those three at their full published configs through
   ``generate``: rwkv6 and zamba2 batch 8 x prompt 2048 x 32 tokens (the
   sequential recurrences: 65,536 and 110,592 steps of prefill), whisper
   batch 8 x 1500 frames x prompt 416 x 32 tokens (its 448-token text
   context); phase 15's numbers (the decode bound counts a recurrent
   state read and written whole, a cross cache read) and decode against
   forward at batch 8, position 63, as phase 16, but the float32 decode
   held to the bf16 forward's own distance from the float32 forward
   (the bf16 cache's rounding is part of the bf16 forward's; zamba2's
   bf16 conv state, rounded at 54 layers, takes it past phase 16's
   fixed 1e-2: 1.19e-2). Phases 19-20 must leave every
   ``LAUNCHES`` count as it was.

21. the scanned engine at small size: ``control="device"`` and
   ``population_sharding`` with ``rng="host"`` raise ValueErrors;
   ``ScanRunner(rng="host")`` with the MLP (hidden 16) and U = 4, LTFL,
   6 rounds in segments of 3, on the card against the CPU with the same
   injected uniforms (cohorts,
   received counts and control means equal; losses within phase 4's rel
   1e-4); on the card ``ScanRunner`` against ``FedRunner`` for LTFL and
   FedSGD, 6 rounds: losses and weights bitwise equal;
   ``make_scanned_step`` over granite-8b's datacenter step at
   ``reduce_for_smoke`` widths, 3 rounds, against a loop of the same
   step: losses and weights bitwise equal;
22. the scanned engine's main path at the paper's width (phase 5's
   model, U = 30, batch 50, 20,000 images), ``LTFLScheme(
   recontrol_every=10)``, ``eval_every=0``: 20 rounds (two segments)
   with ``rng="host"``, then 20 with ``rng="device"``, every segment's
   loop under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
   inside a segment fails the phase; the check is first shown to catch a
   device-to-host read); every loss finite and, counted
   from 0 just before each run, 32 quantizer launches a round. Then the
   steady time a round of ``FedRunner`` and of ``ScanRunner`` (both rng
   modes) at this width, and in the MLP regime of
   benchmarks/scan_engine.py (MLP, U = 16, batch 4, FedSGD, 64 rounds),
   and the peak memory;
23. ``run_sweep`` of ``SweepSpec.grid`` with LTFL over 2 channel regimes
   (Table 2; a 5 MHz band and a 0.05 W power cap) x 2 seeds at phase
   22's width, 10 rounds, under deterministic cuDNN: exactly one bucket
   of 4 lanes and, counted from 0, 32 quantizer launches a round for the
   whole bucket (its loop under the same sync check); the quantizer's
   inputs and outputs of the bucket's first round (120 rows a leaf, each
   with its own [lo, hi, levels]) against the plain version by phase 3's
   rules, float32 as the path got them and cast to bfloat16; each lane
   against its solo ``ScanRunner`` on the card: numpy-side fields equal,
   losses and final weights bitwise equal, each round's delay and
   energy within rel 1e-6 (``SWEEP_ACCOUNTING_REL``: the same float32
   accounting over a (4, 30) view instead of (1, 30)); then two planted
   faults (lanes 0 and 1 swap their quantized gradients; or only the two
   rows at the lanes' seam) must move lane 0's weights. With cuDNN as it
   was (nondeterministic algorithms allowed, as users run): the bucket's
   steady time a round with its lanes built beforehand against the 4
   lanes run one after another alone, the peak memory, and how far each
   lane's weights and losses then lie from its solo run's (what the
   bitwise check would face without deterministic cuDNN); the bucket
   against its lanes alone in the MLP regime too (U = 16, batch 4, 64
   rounds, 4 seed lanes, FedSGD and LTFL).

24. the device control plane at phase 22's width:
   ``LTFLScheme(recontrol_every=1)`` with ``rng="device"``,
   ``control="device"``, block fading and ``eval_every=5``, 10 rounds
   as one segment under the sync check: every loss and gamma finite, 32
   quantizer launches a round counted from 0, one solve a round, the
   control means in bounds, the power moving between rounds, the eval
   head's accuracy on rounds 0 and 5 only; then its steady time a round
   against host control (``rng="host"``, one-round segments with the
   numpy solve between them), both with eval every 5. FedSGD under host
   and device control (``rng="device"``, 4 rounds, eval every 2, under
   deterministic cuDNN): losses bitwise equal, the eval head within abs
   1e-6 of ``evaluate()``. ``solve_dev`` on the card against the host
   ``controller.solve`` with the host's draws injected: at
   tests/test_device_control.py's sizes (U = 6, ``bo_iters`` 3,
   ``alt_max_iters`` 2, seeds 0-2) its tolerances are the gate (rho atol
   1e-5, delta equal, power rtol 1e-4, per atol 1e-6, gamma rel 1e-4);
   at U = 30 and ``LTFLConfig()`` the power and gamma gaps, both
   decisions' feasibility and both alternation counts are reported; one
   solve there from a generator is timed by CUDA events and its device
   events counted by torch.profiler. A device-control sweep at MLP
   width (U = 16, ``bo_iters`` 8, ``alt_max_iters`` 3): Table 2 and a
   0.05 W cap in one bucket under deterministic cuDNN, each lane bitwise
   its solo run (losses, gamma, weights, host fields; delay and energy
   within ``SWEEP_ACCOUNTING_REL``), the capped lane's power at or under
   0.05 W. Last, host against device control in the regime of
   benchmarks/device_control.py (MLP, batch 4, ``bo_iters`` 8,
   ``alt_max_iters`` 3, block fading; U = 8, 16, 32), s a round.

25. the buffered-async engine at phase 22's width (U = 30, batch 50,
   ``LTFLConfig()``): ``AsyncRunner`` with K = 15 and a deadline midway
   between the fastest and the slowest completion time (read from
   ``device_round_delay_dev``) of the first cohort under the synchronous
   round-0 controls; 10 rounds, one segment under the sync check, each
   of (a) ``rng="host"``, (b) ``rng="device"`` with
   ``ChurnSpec(0.1, 0.5, 0.05)``, (c) ``rng="device",
   control="device"``, ``LTFLScheme(recontrol_every=1)``, block fading.
   Each: 32 quantizer launches a round counted from 0, 0 < n_admitted
   <= 15 every round and < 30 on some, received <= n_admitted, the
   logged tau finite and non-negative and the final tau equal to a host
   replay of the logged admissions; its steady s a round, peak memory
   and device events in 2 rounds (torch.profiler) beside
   ``ScanRunner``'s in the same mode. Under deterministic cuDNN:
   ``AsyncRunner(deadline=inf, buffer_size=U, churn=None)`` against
   ``ScanRunner`` over 3 rounds under both rng modes (losses, delay,
   energy, gamma, received, weights bitwise); an async ``run_sweep``
   bucket of 2 seed lanes (device rng, churn, the deadline, K = 15): 32
   quantizer launches a round for the bucket, each lane its solo
   ``AsyncRunner`` (losses, admissions, tau, weights bitwise; delay and
   energy within ``SWEEP_ACCOUNTING_REL``);
26. the straggler regime of benchmarks/async_engine.py (MLP hidden 16,
   downsample 4, batch 4, CPU 5e6-110e6 Hz, FedSGD, eval every round;
   U = 16 and 32; 30 sync rounds, then 90 async with the deadline at 0.35
   x the sync round's mean delay and K = U/2): the simulated seconds of
   the paper's wireless model to the target accuracy (the best the sync
   run reaches in its first 20 rounds), sync and async, and their ratio,
   reported, not gated.

27. the registry in blocks (``population_sharding``) at N = 10^6
   registered devices: (a) phase 22's width and model, U = 30,
   ``ChannelAwareSampler``, block fading, ``rng="device"``, LTFL (its
   cadence is 1 under partial participation, so ``control="device"``
   solves in the segment), on meshes of 1 and 8 blocks all on the card,
   under deterministic cuDNN: per S a cold start (construction and the
   one upload) timed, 10 rounds as one segment under the sync check
   with 32 quantizer launches a round counted from 0, then 5 more
   timed; one registry upload across the two runs; S = 8 against S = 1
   bitwise (cohorts, losses, host ``fading_mean``, ``fading_epoch``);
   the gathered (U,) view and (U, W) rows equal ``index_select`` on the
   concatenated blocks for the last cohort, a random one and the block
   edges, and a planted fault (blocks past the first read the next
   slot) fails that check; registry and index-table bytes a block, peak
   memory; the unsharded device registry at the same N timed (another
   semantics: all N redrawn each epoch). (c) ``AsyncRunner`` of phase
   25 (b) (K = 15, phase 25's deadline, ``ChurnSpec(0.1, 0.5, 0.05)``)
   on the S = 8 registry: a warm-up round, then 5 rounds sync-free and
   timed, 32 launches a round,
   phase 25's admission checks, its s a round against the sharded
   ``ScanRunner``'s. (b) benchmarks/population_scale.py ``--sharded``'s
   regime (ResNet width 8, pool 2048, batch 16, FedSGD, channel-aware,
   block fading, U = 16) at N = 10^4, 10^5, 10^6 over 8 blocks: s a
   round (min of 3 10-round runs) and the 10^6 / 10^4 ratio, reported,
   not gated.

28. the host leftovers on the datacenter path, granite-8b at its
   published widths cut to 2 layers and the launcher's defaults (phase
   9's ``DatacenterRun``), 3 steps each with the launch counts set to 0
   just before: (a) the int8 wire format (``make_fl_train_step(...,
   int8_collective=True)``, SGD): 9 ``block_norms``, 18
   ``apply_block_mask`` and 0 ``stochastic_quant`` launches a step, the
   first step's int8 levels of all 12 leaves within [-127, 127]; (b)
   ``momentum(0.05)`` and ``adamw(0.05)`` on phase 9's LTFL step: 12 / 9
   / 18 a step and the optimizer state's bytes; every loss finite, step
   times beside phase 9's and the peak memory; (c) phase 8's card-vs-CPU
   check in float32 for the int8 step (the update held to the bfloat16
   aggregate's noise) and for AdamW (a sign flip of Adam's first step
   allowed); (d) ``ops.quantize_dequantize_2d`` and the static
   ``stochastic_quant_static`` at the 9 tileable leaf shapes, float32 and
   bfloat16, bits 1, 2, 4, 8: one B1 launch a call, held to the plain
   version by phase 3's rules; (e) ``make_plain_train_step`` with SGD on
   one batch of 8 x 128, 2 steps: losses finite, no kernel launch; (f)
   ``examples/torch_serve_batched.py`` at its defaults as a subprocess:
   exit 0 and its tok/s.

29. the launch tooling (ROADMAP A8): (a) the dry run
   (``python -m repro_torch.launch.dryrun``, each pair in its own
   process under a fake process group, all started together at the
   phase's start): granite-8b x train_4k on the production (16, 16) and
   (2, 16, 16) meshes and the reference's three CI pairs on the (2, 4)
   test mesh (granite-8b x decode_32k, whisper-medium x prefill_32k,
   granite-8b x train_4k as a scanned segment of 2 rounds); each record
   printed with ``fits_hbm`` against 80 GB; (b) the sharded step
   (``make_fl_train_step(param_shardings=, gather_shardings=)``) on an
   NCCL world of one and a ("data", "model") = (1, 1) ``DeviceMesh``,
   params DTensors placed by the rule table, phase 9's run (granite-8b at
   its published widths, 2 layers, the launcher's defaults), 3 steps
   with SGD and 3 with the int8 wire format against the plain-tensor step
   on the same weights, batch and draws: losses and updated weights
   bitwise equal, launches counted from 0 each step 12 / 9 / 18
   (``stochastic_quant`` / ``block_norms`` / ``apply_block_mask``) and
   0 / 9 / 18 under int8; (c) the dry run of exactly (b)'s step on meta
   tensors at (1, 1): its per-device FLOPs equal ``FlopCounterMode``'s
   count of the real step on the card and its parameter bytes the real
   ones; predicted and measured peak bytes with their ratio, the
   roofline's ``t_compute`` and ``t_memory`` beside the measured step
   time (its ``hbm_bytes`` hold the kernels' reads, which their
   wrappers report); (d) phase 9's step with ``remat`` on and off, each
   from a fresh run with nothing of (b) and (c) alive: the first loss
   (the forward alone) bitwise, the later losses, the first step's
   aggregate norm and the weights after the last step within
   ``REMAT_*_REL`` of each other, both peaks and both step times.

``--profile DIR`` also writes torch.profiler tables of one edge round
(``DIR/profile_round.txt``), one datacenter step
(``DIR/profile_step.txt``; phase 18's ``profile_step_<arch>.txt``), one
decode step of each serving run
(``DIR/profile_decode_<arch>_<B>x<P>.txt``), one scanned segment of
phase 22 (``DIR/profile_segment.txt``) and a 2-round device-control
segment of phase 24 (``DIR/profile_control_segment.txt``), with their
idle shares.

The last three lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. The ``stochastic_quant``
row also carries the scanned engine's launches a round by rng mode and
under device control (``control_launches_per_round``), the async
engine's by mode (``async_launches_per_round``) and for its sweep bucket
(``async_sweep_launches_per_round``), on the registry in blocks
(``sharded_launches_per_round``, ``sharded_async_launches_per_round``),
the
sweep bucket's launches a round for its lanes and its check against the
plain version at the bucket's rows (``max_abs_err`` is the larger of
phase 3's and that check's float32 error), and phase 28's static-bits
calls (``static_bits_*``). The B1-B3 rows carry phase 28's launches a
step under the int8 wire format, momentum and AdamW
(``host_leftover_launches_per_step``). The
``block_sparse_matmul`` row also carries its main-path launches by path
(``path``), the paths of phase 11's products (``check_paths``), its rate
on live work (``kernel_tflops``) and the rho sweep.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
KERNELS = ["stochastic_quant", "block_prune",   # csrc/<name>.cu, built
           "block_sparse_matmul"]
C = 30                                  # clients (U) on the edge main path
DC_CLIENTS = 4                          # clients on the datacenter path
DC_LAYERS = 2                           # granite-8b's 36 layers cut to 2
DC_STEPS = 3
DC_RHO = (0.25, 0.1, 0.5, 0.9)          # per-client cuts in phases 7, 10
HBM_BYTES_PER_S = 3.35e12               # H100 SXM, published, 700 W
F32_FLOPS = 67e12                       # H100 SXM non-tensor-core float32
BF16_FLOPS = 989e12                     # H100 SXM dense bf16 tensor cores
BSMM_TOKENS = 1024                      # datacenter step: 4 x 2 x 128
BSMM_RHO = 0.25                         # the launcher's default
BSMM_SWEEP_RHO = (0.0, 0.25, 0.5, 0.75, 0.9)   # phase 13's sweep
BASELINES = ("fedsgd", "signsgd", "fedmp", "stc")
SERVE_DEVICE = "cuda"
SERVE_FAMILIES = ("granite-8b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
                  "phi-3-vision-4.2b")
# phase 15: granite-8b (batch, prompt, tokens); the second prompt is past
# CHUNKED_ATTN_THRESHOLD; decode vs forward at batch 2, position 2048
SERVE_B = ((8, 2048, 64), (1, 32768, 8))
SERVE_B_CHECK = (2, 2048)
# phase 16: the other families at full width; decode vs forward at a
# size whose tokens fit one MoE group of at most 512 on both calls (8 x
# 63 tokens prefilled, 8 x 64 forward)
SERVE_C = ((8, 2048, 32),)
SERVE_C_CHECK = (8, 63)
GRANITE_PARAMS = 8_254_689_280          # param_count() 8,254,390,272 + norms
# phases 17-18: the datacenter step of the MoE, SSM, hybrid and
# encoder-decoder families; per config the depth cut and, per step, the
# launches the reference's leaf tree implies at block 32 (one
# stochastic_quant per leaf, one block_norms per tileable leaf, two
# apply_block_mask: the weights and the gradient gate), worked out from
# repro.core.pruning.tileable on the reference's specs at these cuts
# (tests/test_torch_datacenter_moe.py holds these numbers against it)
DC_FAMILIES = {
    "olmoe-1b-7b": ({"n_layers": 2}, 1_045_178_368,
                    {"stochastic_quant": 13, "block_norms": 10,
                     "apply_block_mask": 20}),
    "rwkv6-7b": ({"n_layers": 2}, 974_221_312,
                 {"stochastic_quant": 20, "block_norms": 13,
                  "apply_block_mask": 26}),
    # one segment: the least that attn_every = 6 allows
    "zamba2-2.7b": ({"n_layers": 6}, 508_034_720,
                    {"stochastic_quant": 21, "block_norms": 10,
                     "apply_block_mask": 20}),
    # 2 encoder + 2 decoder layers, 1500 frames: the encoder's float32
    # scores (4 clients x 2 x 16 heads x 1500^2) kept for backward
    "whisper-medium": ({"n_layers": 2, "encoder_layers": 2}, 169_158_656,
                       {"stochastic_quant": 33, "block_norms": 17,
                        "apply_block_mask": 34}),
}
# phase 20: the SSM, hybrid and encoder-decoder families at full width;
# whisper's prompt of 416 ends its self-attention cache at its published
# 448-token text context (encoder_seq 1500 frames from the config)
SERVE_D = {"rwkv6-7b": ((8, 2048, 32),), "zamba2-2.7b": ((8, 2048, 32),),
           "whisper-medium": ((8, 416, 32),)}
SERVE_D_CHECK = (8, 63)
# caches whose axis 2 is the sequence: a decode step reads them whole and
# writes one entry; cross caches are only read; any other leaf is a
# recurrent state, read and written whole
SEQ_CACHES = ("k", "v", "ckv", "attn_k", "attn_v", "self_k", "self_v")
QUANT_FLOPS_PER_ELEM = 10               # abs, sub, div, floor, sub, cmp,
                                        # add, clip (2), mul-add (2)


def kernel_modules(*names):
    """The kernel wrapper modules ``repro_torch.kernels.<name>``.
    ``repro_torch.kernels`` exports the functions ``stochastic_quant``
    and ``block_sparse_matmul`` under their modules' names (as the
    reference's package does), so its attributes are not the modules."""
    import importlib
    return tuple(importlib.import_module(f"repro_torch.kernels.{n}")
                 for n in names)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean ms per replay of ``fn`` captured in a CUDA graph: the
    device time of its launches without the host's per-launch cost."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def leaf_shapes():
    from repro_torch.models import ResNet
    return {k: s.shape for k, s in ResNet().param_specs().items()}


def make_batch(shapes, dtype, seed):
    """Per leaf: g (C, L), rand (C, L), rng (C, 3) on the card, with the
    per-client bits cycling 1, 2, 4, 8."""
    import torch
    from repro_torch.kernels.ops import level_counts
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    bits = torch.tensor([1.0, 2.0, 4.0, 8.0], device="cuda").repeat(
        C // 4 + 1)[:C]
    out = []
    for shape in shapes.values():
        n = math.prod(shape)
        g = (torch.randn(C, n, generator=gen, device="cuda") * 0.01).to(dtype)
        rand = torch.rand(C, n, generator=gen, device="cuda")
        a = g.to(torch.float32).abs()
        rng = torch.stack([a.amin(1), a.amax(1), level_counts(bits)], 1)
        out.append((g, rand, rng.contiguous()))
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        results = list(pool.map(build.build, KERNELS))
    for name, (lib, text) in zip(KERNELS, results):
        log(f"[build] {name}: {lib.name}")
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line
                                    or "spill" in line):
                log(f"[build]   {line.strip()}")
        build.load(name)
    log(f"[build] {len(KERNELS)} kernel(s) in {time.time() - t0:.1f} s")


def quant_vs_plain(batch, where: str, outs=None):
    """The quantizer against ``stochastic_quant_ref`` on (g, rand, rng)
    triples, by phase 3's rules: float32 exactly, bfloat16 within one
    quantization step on < 1e-3 of the elements. ``outs``, when given,
    are the kernel's outputs already made on these inputs (else the
    wrapper launches here). Returns the max abs error, the mismatch
    fraction and the number of elements."""
    import torch
    from repro_torch.kernels.ref import stochastic_quant_ref
    from repro_torch.kernels.stochastic_quant import stochastic_quant
    worst, mism, total = 0.0, 0, 0
    for i, (g, rand, rng) in enumerate(batch):
        out = stochastic_quant(g, rand, rng) if outs is None else outs[i]
        ref = stochastic_quant_ref(g, rand, rng)
        torch.cuda.synchronize()
        diff = (out.to(torch.float32) - ref.to(torch.float32)).abs()
        step = ((rng[:, 1] - rng[:, 0]) / rng[:, 2])[:, None]
        worst = max(worst, float(diff.max()))
        mism += int((diff > 0).sum())
        total += diff.numel()
        if g.dtype == torch.float32 and float(diff.max()) != 0.0:
            fail(f"{where}: f32 kernel != plain at leaf {i}: max "
                 f"{float(diff.max())}")
        if g.dtype == torch.bfloat16 and bool(
                (diff > step * 1.01 + 1e-30).any()):
            fail(f"{where}: bf16 kernel off by more than one step at leaf "
                 f"{i}")
    frac = mism / total
    if frac >= 1e-3:
        fail(f"{where}: mismatch fraction {frac} >= 1e-3")
    return worst, frac, total


def phase_kernel_vs_plain(shapes) -> float:
    import torch
    max_err_f32 = None
    for dtype in (torch.float32, torch.bfloat16):
        worst, frac, total = quant_vs_plain(
            make_batch(shapes, dtype, seed=1), f"{str(dtype)[6:]}")
        log(f"[check] {str(dtype)[6:]}: 32 leaves x {C} clients, "
            f"{total} elements: max_abs_err={worst!r} "
            f"mismatch_fraction={frac!r}")
        if dtype == torch.float32:
            max_err_f32 = worst
    return max_err_f32


def phase_small_reference() -> None:
    """One step at width 8, U = 4 on the card and on the CPU, same
    weights, data, controls and uniforms."""
    import numpy as np
    import torch
    from repro_torch.configs import ResNetConfig
    from repro_torch.core.compressors import ltfl_quantizer
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.data import synthetic_cifar
    from repro_torch.models import ResNet
    from repro_torch.optim import sgd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n_clients, batch = 4, 8
    model = ResNet(ResNetConfig(stem_channels=8,
                                group_channels=(8, 16, 32, 64)))
    gen = torch.Generator()
    gen.manual_seed(3)
    params = model.init(gen)
    imgs, labels = synthetic_cifar(n_clients * batch, seed=3)
    batch_np = {"images": imgs.reshape(n_clients, batch, 32, 32, 3),
                "labels": labels.reshape(n_clients, batch)}
    controls_np = {"rho": np.array([0.0, 0.2, 0.4, 0.5], np.float32),
                   "delta": np.array([8.0, 4.0, 2.0, 1.0], np.float32),
                   "weights": np.array([400, 450, 500, 550], np.float32),
                   "alpha": np.array([1, 1, 0, 1], np.float32)}

    def cpu_uniforms(seed, nc, shapes):
        g = torch.Generator()
        g.manual_seed(seed)
        return [torch.rand((nc,) + tuple(s), generator=g) for s in shapes]

    results = {}
    for dev in ("cpu", "cuda"):
        step = make_fl_train_step(model, sgd(0.05), n_clients,
                                  prune_kind="magnitude",
                                  compressor=ltfl_quantizer(
                                      uniforms=cpu_uniforms))
        p, _, _, m = step(
            {k: v.to(dev) for k, v in params.items()}, (), (),
            {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()},
            {k: torch.from_numpy(v).to(dev) for k, v in controls_np.items()},
            7)
        results[dev] = ({k: v.cpu() for k, v in p.items()}, float(m["loss"]))
    (pc, lc), (pg, lg) = results["cpu"], results["cuda"]
    if not math.isclose(lc, lg, rel_tol=1e-4):
        fail(f"small reference: loss cpu {lc} vs cuda {lg}")
    worst = 0.0
    for k, v0 in params.items():
        uc, ug = (pc[k] - v0) / 0.05, (pg[k] - v0) / 0.05
        scale = float(uc.abs().max()) + 1e-12
        off = float(((ug - uc).abs() > 1e-3 * scale).float().mean())
        worst = max(worst, off)
        if off >= 1e-3 or float((ug - uc).abs().max()) > scale:
            fail(f"small reference: update of {k} differs "
                 f"(fraction {off})")
    log(f"[reference] width-8 step, cpu vs cuda: loss {lc!r} vs {lg!r}, "
        f"worst off-fraction {worst!r}")


def phase_main_path(profile_dir):
    import numpy as np
    import torch
    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.data import ArrayDataset, synthetic_cifar
    from repro_torch.fed import FedRunner, LTFLScheme
    from repro_torch.kernels.stochastic_quant import LAUNCHES
    from repro_torch.models import ResNet

    t0 = time.time()
    imgs, labels = synthetic_cifar(20000, seed=0)
    timgs, tlabels = synthetic_cifar(2000, seed=1)
    train = ArrayDataset({"images": imgs, "labels": labels})
    test = ArrayDataset({"images": timgs, "labels": tlabels})
    model = ResNet(ResNetConfig())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    n_leaves = len(params)
    log(f"[main] data + init {time.time() - t0:.1f} s: {n_leaves} leaves, "
        f"{sum(p.numel() for p in params.values())} parameters")

    LAUNCHES["stochastic_quant"] = 0
    torch.cuda.reset_peak_memory_stats()
    runner = FedRunner(model, params, LTFLConfig(), train, test,
                       LTFLScheme(), batch_size=50, seed=0, eval_every=1,
                       device="cuda")
    # where a round's wall time goes: the step call and the eval, each
    # timed to a synchronize (the rest is host work: Algorithm 1, the
    # batch gather and upload, accounting)
    spent = {"step": 0.0, "eval": 0.0}

    def timed(key, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.time() - t
            return out
        return call

    runner._step = timed("step", runner._step)
    runner.evaluate = timed("eval", runner.evaluate)
    rounds = []
    for rnd in range(3):
        before = LAUNCHES["stochastic_quant"]
        spent.update(step=0.0, eval=0.0)
        torch.cuda.synchronize()
        t = time.time()
        rec = runner.run_round(rnd)
        torch.cuda.synchronize()
        wall = time.time() - t
        launched = LAUNCHES["stochastic_quant"] - before
        log(f"[main] round {rnd}: loss={rec.train_loss!r} "
            f"acc={rec.test_acc!r} delay={rec.delay!r}s "
            f"energy={rec.energy!r}J received={rec.received}/{C} "
            f"gamma={rec.gamma!r} rho_mean={rec.rho_mean!r} "
            f"delta_mean={rec.delta_mean!r} wall={wall!r}s "
            f"step={spent['step']!r}s eval={spent['eval']!r}s "
            f"host={wall - spent['step'] - spent['eval']!r}s "
            f"quant_launches={launched}")
        if not math.isfinite(rec.train_loss):
            fail(f"round {rnd}: loss {rec.train_loss}")
        if launched != n_leaves:
            fail(f"round {rnd}: {launched} quantizer launches, want "
                 f"{n_leaves}")
        rounds.append(wall)
    launches = LAUNCHES["stochastic_quant"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] 3 rounds: launches={launches} round_wall_s={rounds} "
        f"max_memory_allocated={peak} bytes")
    if launches != 3 * n_leaves:
        fail(f"main path launched the quantizer {launches} times")
    if not all(np.isfinite(v.detach().cpu().numpy()).all()
               for v in runner.params.values()):
        fail("non-finite weights after 3 rounds")
    if profile_dir is not None:
        profile_round(runner, profile_dir)
    return launches


def profile_round(runner, out_dir: Path) -> None:
    """A torch.profiler table of one more edge round, by device time."""
    profile_call(lambda: runner.run_round(3), out_dir / "profile_round.txt",
                 "round")


def profile_call(fn, out_file: Path, label: str) -> None:
    """Run ``fn`` once under torch.profiler; write the device-time table
    to ``out_file`` and print the wall time, the device busy time and the
    idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_file.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    # device busy time: the union of the device-side events' intervals
    # (microseconds on the host's clock), so nothing is counted twice
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    out_file.write_text(table)
    if spans:
        log(f"[profile] {label} wall {wall!r} s (profiler on), "
            f"{len(spans)} device events, device busy {busy_us / 1e6!r} s,"
            f" idle share {1.0 - busy_us / 1e6 / wall!r}")
    else:
        log(f"[profile] {label}: no device events recorded: idle share "
            "not measured")
    log(f"[profile] top of the {label}'s device-time table:")
    for line in table.splitlines()[:16]:
        log(f"[profile] {line}")


def phase_timing(shapes):
    import torch
    from repro_torch.kernels.ref import stochastic_quant_ref
    from repro_torch.kernels.stochastic_quant import stochastic_quant
    leaves = make_batch(shapes, torch.float32, seed=2)
    big = max(range(len(leaves)), key=lambda i: leaves[i][0].numel())
    g, rand, rng = leaves[big]

    def all_kernel():
        for g_, r_, q_ in leaves:
            stochastic_quant(g_, r_, q_)

    def all_plain():
        for g_, r_, q_ in leaves:
            stochastic_quant_ref(g_, r_, q_)

    res = {
        "largest_kernel_ms": cuda_ms(lambda: stochastic_quant(g, rand, rng),
                                     20),
        "largest_plain_ms": cuda_ms(
            lambda: stochastic_quant_ref(g, rand, rng), 10),
        # eager: 32 launches from Python, host launch cost included
        "round_kernel_eager_ms": cuda_ms(all_kernel, 10),
        "round_plain_eager_ms": cuda_ms(all_plain, 5),
        # the same launches replayed from a CUDA graph: device time
        "round_kernel_ms": graph_ms(all_kernel, 20),
        "round_plain_ms": graph_ms(all_plain, 10),
    }
    # the least time for the same work: each input read once, each output
    # written once (g 4 B, rand 4 B, out 4 B per element + 12 B per client
    # range row), or ~10 float32 operations per element, whichever is more
    elems_big = g.numel()
    elems_all = sum(x[0].numel() for x in leaves)

    def bound(elems, rows):
        t_bytes = (elems * 12 + rows * 12) / HBM_BYTES_PER_S * 1e3
        t_ops = elems * QUANT_FLOPS_PER_ELEM / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    res["largest_bound_ms"], _ = bound(elems_big, C)
    res["round_bound_ms"], res["bound_by"] = bound(elems_all,
                                                   C * len(leaves))
    res["round_elements"] = elems_all
    res["largest_elements"] = elems_big
    for k in ("largest", "round"):
        res[f"{k}_achieved_GBps"] = (res[f"{k}_elements"] * 12
                                     / (res[f"{k}_kernel_ms"] * 1e-3) / 1e9)
    log(f"[timing] {json.dumps(res)}")
    return res


def bits(x):
    """A float tensor as its integer bit pattern (the sign of zero counts)."""
    import torch
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def dc_arch():
    """granite-8b at its published widths, depth cut to DC_LAYERS."""
    from repro_torch.configs import get_arch
    return get_arch("granite-8b").replace(n_layers=DC_LAYERS)


def dc_matrices(block: int = 32):
    """The tileable leaves of the full-width config as the (rows, N)
    matrices the block kernels see (leading dims collapsed), by name."""
    import torch
    from repro_torch.core.pruning import tileable
    from repro_torch.models import DecoderLM
    out = {}
    for name, spec in DecoderLM(dc_arch()).param_specs().items():
        if tileable(torch.empty(spec.shape, device="meta"), block):
            out[name] = (math.prod(spec.shape[:-1]), spec.shape[-1])
    return out


def phase_block_vs_plain(mats):
    """Both block kernels against their plain versions, bitwise, at every
    tileable leaf shape, f32 and bf16, blocks 32/64/128, C per-client
    masks. Returns the largest |difference| of the norms and of the
    masked outputs (0.0 when bitwise)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_prune import apply_block_mask, block_norms
    from repro_torch.kernels.ref import apply_block_mask_ref, block_norms_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rho = torch.tensor(DC_RHO, device="cuda")
    worst, worst_mask, tiles = 0.0, 0.0, 0

    def max_diff(a, b):
        return float((_f32(a) - _f32(b)).abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        for name, (m, n) in mats.items():
            w = (torch.randn(m, n, generator=gen, device="cuda")
                 * 0.02).to(dtype)
            w.view(-1)[::9973] = -0.0
            g = (torch.randn(DC_CLIENTS, m, n, generator=gen, device="cuda")
                 * 1e-3).to(dtype)
            for b in (32, 64, 128):
                where = f"{name} {(m, n)} {str(dtype)[6:]} block {b}"
                norms = block_norms(w, (b, b))
                ref = block_norms_ref(w, b, b)
                torch.cuda.synchronize()
                worst = max(worst, float((norms - ref).abs().max()))
                if not torch.equal(bits(norms), bits(ref)):
                    fail(f"block_norms != plain at {where}")
                tiles += norms.numel()
                pruned, mask = ops.block_prune_2d(w, rho, (b, b))
                ref_mask = ops.rank_mask(ref, rho)
                torch.cuda.synchronize()
                if not torch.equal(mask, ref_mask):
                    fail(f"tile masks differ at {where}")
                ref_pruned = apply_block_mask_ref(w, ref_mask, b, b)
                worst_mask = max(worst_mask, max_diff(pruned, ref_pruned))
                if not torch.equal(bits(pruned), bits(ref_pruned)):
                    fail(f"apply_block_mask (weights) != plain at {where}")
                del pruned, ref_pruned
                gated = apply_block_mask(g, mask, (b, b))
                ref_gated = apply_block_mask_ref(g, mask, b, b)
                worst_mask = max(worst_mask, max_diff(gated, ref_gated))
                if not torch.equal(bits(gated), bits(ref_gated)):
                    fail(f"apply_block_mask (gradients) != plain at {where}")
                del gated, ref_gated
            del w, g
    torch.cuda.empty_cache()
    log(f"[check] block kernels: {len(mats)} leaf shapes x f32/bf16 x "
        f"blocks 32/64/128, {tiles} tiles, C = {DC_CLIENTS}: norms, masks, "
        f"masked weights and gated gradients bitwise equal "
        f"(max norm difference {worst!r}, max masked-output difference "
        f"{worst_mask!r})")
    return worst, worst_mask


def _f32(t):
    import torch
    return t.to(torch.float32)


def _bf16_ulp(x):
    """One bf16 ulp at |x|, as float32."""
    import torch
    a = x.abs().to(torch.bfloat16)
    return _f32(torch.nextafter(a, torch.full_like(a, float("inf")))) \
        - _f32(a)


def phase_small_datacenter(name: str = "granite-8b",
                           dtypes=None, variant: str = "sgd") -> None:
    """One block-pruned step of ``name`` at reduce_for_smoke widths on the
    card and on the CPU: same weights, batch (with image embeddings or
    frames where the family takes them), controls, uniforms and drop
    draw; in each of ``dtypes`` (default float32 and bfloat16).
    ``variant`` "int8" runs the int8 wire format (SGD; the aggregate is
    bfloat16, so the update is held to its bf16 noise: phase 8's bf16
    rule on the update), "adamw" the LTFL quantizer under
    ``adamw(0.05)`` (phase 4's rule, but a gradient at the noise level
    may flip the sign of Adam's first step, lr * sign(g): no element
    farther than twice the largest update)."""
    import torch
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.core.compressors import ltfl_quantizer
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.core.pruning import prune_pytree
    from repro_torch.models import build_model, make_train_batch
    from repro_torch.optim import adamw, sgd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    arch = reduce_for_smoke(get_arch(name))
    model = build_model(arch)
    specs = model.param_specs()
    gen = torch.Generator()
    gen.manual_seed(3)
    init = {k: _f32(v) for k, v in model.init(gen).items()}
    batch = {k: v.reshape(DC_CLIENTS, 2, *v.shape[1:]) for k, v in
             make_train_batch(arch, DC_CLIENTS * 2, 64, gen).items()}
    controls = {"rho": [0.25, 0.1, 0.5, 0.25], "delta": [8.0, 8.0, 4.0, 2.0],
                "drop_prob": [0.05, 0.05, 0.6, 0.3],
                "weights": [500.0, 450.0, 520.0, 610.0]}
    controls = {k: torch.tensor(v) for k, v in controls.items()}

    def cpu_uniforms(seed, nc, shapes):
        g = torch.Generator()
        g.manual_seed(seed)
        return [torch.rand((nc,) + tuple(s), generator=g) for s in shapes]

    def cpu_drops(seed, nc):
        g = torch.Generator()
        g.manual_seed(seed + 1)
        return torch.rand((nc,), generator=g)

    lr = 0.05
    opt = adamw(lr) if variant == "adamw" else sgd(lr)
    wire = (dict(int8_collective=True, int8_uniforms=cpu_uniforms)
            if variant == "int8" else
            dict(compressor=ltfl_quantizer(uniforms=cpu_uniforms)))
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        out = {}
        for dev in ("cpu", "cuda"):
            step = make_fl_train_step(
                model, opt, DC_CLIENTS, prune_block=32,
                prune_kind="block", drop_uniforms=cpu_drops, **wire)
            # the MoE router stays float32, as the spec has it
            p = {k: v.to(dev, torch.float32 if specs[k].dtype
                         == torch.float32 else dtype)
                 for k, v in init.items()}
            _, masks = prune_pytree(p, controls["rho"].to(dev), block=32)
            p1, _, _, m = step(p, opt.init(p), (),
                               {k: v.to(dev) for k, v in batch.items()},
                               {k: v.to(dev) for k, v in controls.items()},
                               7)
            out[dev] = ({k: v.cpu() for k, v in p1.items()},
                        {k: v.cpu() for k, v in masks.items()},
                        float(m["loss"]), float(m["clients_received"]))
        (pc, mc, lc, rc), (pg, mg, lg, rg) = out["cpu"], out["cuda"]
        where = f"{name} {str(dtype)[6:]}" + (
            "" if variant == "sgd" else f" {variant}")
        for k in mc:
            if not torch.equal(mc[k], mg[k]):
                fail(f"small datacenter {where}: masks of {k} differ")
        if rc != rg:
            fail(f"small datacenter {where}: received {rc} vs {rg}")
        loss_tol = 1e-4 if dtype == torch.float32 else 1e-3
        if not math.isclose(lc, lg, rel_tol=loss_tol):
            fail(f"small datacenter {where}: loss cpu {lc} vs cuda {lg}")
        worst = 0.0
        for k, v0 in init.items():
            v0 = _f32(v0.to(dtype))
            new_c, new_g = _f32(pc[k]), _f32(pg[k])
            if variant == "int8":           # the bf16 aggregate's noise
                upd_c, upd_g = new_c - v0, new_g - v0
                diff = (upd_g - upd_c).abs()
                off = float((diff > _bf16_ulp(upd_c)).float().mean())
                bad = off > 0.05 or bool(
                    (diff > upd_c.abs().max() + _bf16_ulp(upd_c)).any())
            elif dtype == torch.float32:    # phase 4's tolerances
                uc, ug = (new_c - v0) / lr, (new_g - v0) / lr
                scale = float(uc.abs().max()) + 1e-12
                flip = 2.0 if variant == "adamw" else 1.0
                off = float(((ug - uc).abs() > 1e-3 * scale).float().mean())
                bad = off >= 1e-3 or float((ug - uc).abs().max()) \
                    > flip * scale
            else:                           # tests/test_torch_datacenter.py
                diff = (new_g - new_c).abs()
                ulp = _bf16_ulp(new_c)
                off = float((diff > ulp).float().mean())
                bad = off > 0.05 or bool(
                    (diff > (new_c - v0).abs().max() + ulp).any())
            worst = max(worst, off)
            if bad:
                fail(f"small datacenter {where}: update of {k} differs "
                     f"(fraction {off})")
        log(f"[reference] datacenter step at smoke widths, {where}, cpu vs "
            f"cuda: masks equal, received {rc!r}, loss {lc!r} vs {lg!r}, "
            f"worst off-fraction {worst!r}")


def phase_datacenter(profile_dir, name: str = "granite-8b", cut=None,
                     want=None, n_want: int = 838_881_280):
    """The datacenter main path at full widths through the launcher's
    function (``name`` with the depth ``cut``; granite-8b at DC_LAYERS by
    default): launch counts per step (``want``), step times, peak
    memory, the parameter count ``n_want``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    block_prune, stochastic_quant = kernel_modules("block_prune",
                                                   "stochastic_quant")

    full = get_arch(name)
    arch = dc_arch() if cut is None else full.replace(**cut)
    args = train.build_parser().parse_args(["--steps", str(DC_STEPS)])
    counters = (block_prune.LAUNCHES, stochastic_quant.LAUNCHES)
    want = want or {"block_norms": 9, "apply_block_mask": 18,
                    "stochastic_quant": 12}

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    enc = (f", encoder {full.encoder_layers} -> {arch.encoder_layers} "
           f"layers over {arch.encoder_seq} frames"
           if arch.encoder_layers else "")
    log(f"[datacenter] {name} at its published widths (d_model "
        f"{arch.d_model}, {arch.n_heads} heads, {arch.n_kv_heads} KV heads, "
        f"d_ff {arch.d_ff}, vocab {arch.vocab_size}), depth cut "
        f"{full.n_layers} -> {arch.n_layers} layers{enc}")
    per_step = []
    last = {}

    def on_step(i, m):
        now = counts()
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last.update(now)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.time()
    run, records = train.run_datacenter(arch, args, "cuda", on_step=on_step)
    wall = time.time() - t0
    total = counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(v.numel() for v in run.params.values())
    for i, (m, got) in enumerate(zip(records, per_step)):
        log(f"[datacenter] {name} step {i}: loss={m['loss']!r} "
            f"grad_norm={m['grad_norm']!r} "
            f"received={m['clients_received']!r} "
            f"step_s={m['seconds']!r} launches={got}")
        if not math.isfinite(m["loss"]):
            fail(f"datacenter {name} step {i}: loss {m['loss']}")
        if {k: got[k] for k in want} != want:
            fail(f"datacenter {name} step {i}: launches {got}, want {want}")
    log(f"[datacenter] {name}: {n_params} parameters, {len(records)} steps "
        f"in {wall!r} s (set-up included), step_s="
        f"{[m['seconds'] for m in records]}, max_memory_allocated={peak} "
        f"bytes, launches={total}")
    if n_params != n_want:
        fail(f"full-width cut {name} has {n_params} parameters, want "
             f"{n_want}")
    if not all(bool(torch.isfinite(v).all()) for v in run.params.values()):
        fail(f"non-finite weights after the datacenter steps of {name}")
    if profile_dir is not None:
        fname = ("profile_step.txt" if cut is None
                 else f"profile_step_{name}.txt")
        profile_call(lambda: run.step(DC_STEPS), profile_dir / fname,
                     f"datacenter step {name}")
    del run
    torch.cuda.empty_cache()
    return total, peak, records


def _bound(n_bytes: float, n_ops: float, peak_flops: float = F32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_block_timing(mats, block: int = 32):
    """CUDA-event times of both block kernels, their plain versions and
    one-call PyTorch equivalents on bf16 leaves at the main path's shapes
    and block, C per-client masks: the largest leaf and a whole step's
    leaves (eager and graph-replayed)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_prune import apply_block_mask, block_norms
    from repro_torch.kernels.ref import apply_block_mask_ref, block_norms_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rho = torch.tensor(DC_RHO, device="cuda")
    c, b = DC_CLIENTS, block
    ws = {k: (torch.randn(m, n, generator=gen, device="cuda")
              * 0.02).to(torch.bfloat16) for k, (m, n) in mats.items()}
    masks = {k: ops.rank_mask(block_norms_ref(w, b, b), rho)
             for k, w in ws.items()}
    big = "embed.tok"

    def views(w):
        m, n = w.shape[-2:]
        return m // b, n // b

    def lib_norms(w):
        tr, tc = views(w)
        return torch.linalg.vector_norm(w.view(tr, b, tc, b), dim=(1, 3),
                                        dtype=torch.float32)

    def lib_mask(w, mask):
        tr, tc = views(w)
        lead = w.shape[:-2] if w.dim() == 3 else (1,)
        return torch.mul(w.view(*lead, tr, b, tc, b),
                         mask.view(c, tr, 1, tc, 1))

    fns = {
        "norms": (lambda w, m: block_norms(w, (b, b)),
                  lambda w, m: block_norms_ref(w, b, b),
                  lambda w, m: lib_norms(w)),
        "mask": (lambda w, m: apply_block_mask(w, m, (b, b)),
                 lambda w, m: apply_block_mask_ref(w, m, b, b),
                 lib_mask),
    }
    res = {}

    def time_all(tag, kind, inputs, big_inputs):
        kern, plain, lib = fns[kind]
        for label, fn in (("kernel", kern), ("plain", plain),
                          ("library", lib)):
            res[f"{tag}_largest_{label}_ms"] = cuda_ms(
                lambda: fn(*big_inputs), 10)

            def step_all():
                for x, m in inputs:
                    fn(x, m)

            res[f"{tag}_step_{label}_eager_ms"] = cuda_ms(step_all, 5)
            res[f"{tag}_step_{label}_ms"] = graph_ms(step_all, 10)
            torch.cuda.empty_cache()

    # the library calls compute the same functions (norms summed in
    # float32 in another order: rel 1e-5, as tests/test_kernels.py)
    w, m = ws[big], masks[big]
    if not torch.allclose(lib_norms(w), block_norms_ref(w, b, b),
                          rtol=1e-5, atol=0.0):
        fail("library norms differ from the plain version")
    if not torch.equal(bits(lib_mask(w, m).reshape(c, *w.shape)),
                       bits(apply_block_mask_ref(w, m, b, b))):
        fail("library masking differs from the plain version")
    pairs = [(ws[k], masks[k]) for k in ws]
    time_all("norms", "norms", pairs, (ws[big], masks[big]))
    time_all("mask", "mask", pairs, (ws[big], masks[big]))
    elems = {k: w.numel() for k, w in ws.items()}
    tiles = {k: m[0].numel() for k, m in masks.items()}
    n_all, t_all = sum(elems.values()), sum(tiles.values())
    # block_norms: read w once (2 B/elem), write 4 B a tile; 2 ops an
    # element (square, add), counted at the float32 rate
    res["norms_step_bound_ms"], res["norms_bound_by"] = _bound(
        2 * n_all + 4 * t_all, 2 * n_all)
    res["norms_largest_bound_ms"], _ = _bound(
        2 * elems[big] + 4 * tiles[big], 2 * elems[big])
    # masking the shared weights: read w once, write C copies, read C
    # masks (1 B a tile); one multiply per output element
    res["mask_step_bound_ms"], res["mask_bound_by"] = _bound(
        2 * (1 + c) * n_all + c * t_all, c * n_all)
    res["mask_largest_bound_ms"], _ = _bound(
        2 * (1 + c) * elems[big] + c * tiles[big], c * elems[big])
    del ws
    torch.cuda.empty_cache()
    # gating the stacked gradients: read and write C copies
    gs = {k: (torch.randn(c, m, n, generator=gen, device="cuda")
              * 1e-3).to(torch.bfloat16) for k, (m, n) in mats.items()}
    time_all("gate", "mask", [(gs[k], masks[k]) for k in gs],
             (gs[big], masks[big]))
    res["gate_step_bound_ms"], res["gate_bound_by"] = _bound(
        4 * c * n_all + c * t_all, c * n_all)
    res["gate_largest_bound_ms"], _ = _bound(
        4 * c * elems[big] + c * tiles[big], c * elems[big])
    res["step_elements"], res["largest_elements"] = n_all, elems[big]
    del gs
    torch.cuda.empty_cache()
    log(f"[timing] block kernels (bf16, block {b}, C = {c}): "
        f"{json.dumps(res)}")
    return res

def bsmm_shapes():
    """granite-8b's 8 projection matrices at its published widths, (K, N)
    by leaf name, read from the model's parameter specs."""
    from repro_torch.models import DecoderLM
    names = ("layers.attn.wq", "layers.attn.wk", "layers.attn.wv",
             "layers.attn.wo", "layers.ffn.wi_gate", "layers.ffn.wi_up",
             "layers.ffn.wo", "embed.head")
    specs = DecoderLM(dc_arch()).param_specs()
    return {n.split(".", 1)[-1] if n.startswith("layers.") else n:
            tuple(specs[n].shape[-2:]) for n in names}


def _bsmm_full_inputs(shapes, dtype, seed):
    """Per shape: x (1024, K) ~ N(0, 1), w (K, N) ~ N(0, 0.02^2) in
    ``dtype`` on the card, and the tile mask of block_prune_2d at rho
    0.25, 128 x 128 blocks."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for name, (k, n) in shapes.items():
        x = torch.randn(BSMM_TOKENS, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(k, n, generator=gen, device="cuda") * 0.02).to(dtype)
        _, mask = ops.block_prune_2d(w, BSMM_RHO, block=(128, 128))
        out[name] = (x, w, mask)
    return out


def _bsmm_compare(out, ref, x, w, mask, bk, bn, where):
    """Kernel output against the plain version's; returns (max |diff|,
    share of elements off by more than one bf16 ulp, or 0.0 in f32).

    f32: within 2 K 2^-24 (|x| @ |w masked|) elementwise, the bound on
    two float32 sums of the same K products in different orders.
    bf16: both round such a sum once, so within one ulp on all but 1e-3
    of the elements, and within one ulp plus that bound on all."""
    import torch
    from repro_torch.kernels.ref import block_sparse_matmul_ref
    diff = (_f32(out) - _f32(ref)).abs()
    k = x.shape[1]
    bound = 2.0 * k * 2.0 ** -24 * _f32(block_sparse_matmul_ref(
        x.abs().to(torch.float32), w.abs().to(torch.float32), mask, bk, bn))
    if out.dtype == torch.float32:
        if bool((diff > bound).any()):
            fail(f"block_sparse_matmul f32 != plain beyond 2 K u |x||w| at "
                 f"{where}: max {float(diff.max())}")
        return float(diff.max()), 0.0
    ulp = _bf16_ulp(_f32(ref))
    share = float((diff > ulp).float().mean())
    if share > 1e-3 or bool((diff > ulp + bound).any()):
        fail(f"block_sparse_matmul bf16 != plain at {where}: {share} of "
             f"elements beyond one ulp, max {float(diff.max())}")
    return float(diff.max()), share


def phase_bsmm_vs_plain():
    """B4 against its plain version at the reference test's and the
    full-width shapes, f32 and bf16; then the slice's main path,
    ops.pruned_matmul, with the launch counts set to 0 just before.
    Returns (largest |diff| in f32 at the reference shapes, largest
    |diff| over all comparisons, the main path's launch counts, B4's
    launches before this phase)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_sparse_matmul import block_shape
    block_prune, block_sparse_matmul = kernel_modules(
        "block_prune", "block_sparse_matmul")
    from repro_torch.kernels.ref import block_norms_ref, \
        block_sparse_matmul_ref

    # the plain version's float32 matmul in full float32, as the kernel's
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = block_sparse_matmul.LAUNCHES
    by_path = {"wgmma": 0, "simt": 0}

    def kernel(x, w, mask, want, blocks=(128, 128, 128)):
        """B4 on the card; fails unless it took path ``want``."""
        before = dict(counts)
        out = block_sparse_matmul.block_sparse_matmul(x, w, mask, blocks)
        took = [p for p in by_path if counts[f"block_sparse_matmul_{p}"]
                == before[f"block_sparse_matmul_{p}"] + 1]
        if took != [want] or counts["block_sparse_matmul"] != \
                before["block_sparse_matmul"] + 1:
            fail(f"block_sparse_matmul at x {tuple(x.shape)} w "
                 f"{tuple(w.shape)} {x.dtype} blocks {blocks} took {took}, "
                 f"want [{want!r}]")
        by_path[want] += 1
        return out

    # launches so far: the edge and datacenter paths (phases 1-10)
    other_paths = counts["block_sparse_matmul"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    worst_small, worst, n_checks = 0.0, 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        want = "wgmma" if dtype == torch.bfloat16 else "simt"
        for m, n, k in ((128, 128, 128), (256, 256, 512), (128, 384, 256)):
            x = (torch.randn(m, k, generator=gen, device="cuda") / 8).to(dtype)
            w = (torch.randn(k, n, generator=gen, device="cuda") / 8).to(dtype)
            for density in (0.0, 0.5, 1.0):
                mask = torch.rand(k // 128, n // 128, generator=gen,
                                  device="cuda") < density
                out = kernel(x, w, mask, want)
                ref = block_sparse_matmul_ref(x, w, mask, 128, 128)
                torch.cuda.synchronize()
                where = f"{(m, n, k)} {str(dtype)[6:]} density {density}"
                diff = float((_f32(out) - _f32(ref)).abs().max())
                if density == 0.0 and not bool((out == 0).all()):
                    fail(f"fully masked product not zero at {where}")
                if dtype == torch.float32:
                    if not torch.allclose(out, ref, rtol=1e-4, atol=1e-4):
                        fail(f"block_sparse_matmul f32 != plain at {where}")
                    worst_small = max(worst_small, diff)
                else:
                    _bsmm_compare(out, ref, x, w, mask, 128, 128, where)
                worst = max(worst, diff)
                n_checks += 1
        # the test file's odd shapes: blocks that clamp, straddle or do
        # not fit the wgmma tile take simt in both dtypes
        for (m, n, k), blocks in (((8, 3, 5), (128, 128, 128)),
                                  ((96, 60, 48), (32, 20, 16)),
                                  ((200, 300, 64), (40, 30, 8))):
            x = (torch.randn(m, k, generator=gen, device="cuda") / 8).to(dtype)
            w = (torch.randn(k, n, generator=gen, device="cuda") / 8).to(dtype)
            _, bn, bk = block_shape(m, n, k, blocks)
            mask = torch.rand(k // bk, n // bn, generator=gen,
                              device="cuda") < 0.5
            out = kernel(x, w, mask, "simt", blocks)
            ref = block_sparse_matmul_ref(x, w, mask, bk, bn)
            torch.cuda.synchronize()
            where = f"{(m, n, k)} blocks {blocks} {str(dtype)[6:]}"
            if dtype == torch.float32:
                if not torch.allclose(out, ref, rtol=1e-4, atol=1e-4):
                    fail(f"block_sparse_matmul f32 != plain at {where}")
            else:
                _bsmm_compare(out, ref, x, w, mask, bk, bn, where)
            worst = max(worst, float((_f32(out) - _f32(ref)).abs().max()))
            n_checks += 1
    shares = {}
    for dtype in (torch.float32, torch.bfloat16):
        name_dt = str(dtype)[6:]
        want = "wgmma" if dtype == torch.bfloat16 else "simt"
        for name, (x, w, mask) in _bsmm_full_inputs(
                bsmm_shapes(), dtype, seed=17).items():
            where = f"{name} (1024, {x.shape[1]}) x {tuple(w.shape)} {name_dt}"
            out = kernel(x, w, mask, want)
            ref = block_sparse_matmul_ref(x, w, mask, 128, 128)
            torch.cuda.synchronize()
            d, share = _bsmm_compare(out, ref, x, w, mask, 128, 128, where)
            worst = max(worst, d)
            shares[f"{name}_{name_dt}"] = share
            n_checks += 1
            del out, ref
        torch.cuda.empty_cache()
    # a fully masked product at full width: exact zeros
    x = torch.randn(BSMM_TOKENS, 4096, generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = torch.randn(4096, 4096, generator=gen,
                    device="cuda").to(torch.bfloat16)
    dead = torch.zeros(32, 32, dtype=torch.bool, device="cuda")
    if not bool((kernel(x, w, dead, "wgmma") == 0).all()):
        fail("fully masked full-width product is not zero")
    log(f"[check] block_sparse_matmul: {n_checks} products (reference "
        f"shapes x densities 0/0.5/1, the odd-block shapes and 8 "
        f"full-width shapes, f32 and bf16) within tolerance: max |kernel "
        f"- plain| f32 at the reference shapes {worst_small!r}, over all "
        f"{worst!r}; bf16 share beyond one ulp by shape "
        f"{json.dumps(shares)}; fully masked products exact zeros; "
        f"paths {json.dumps(by_path)} (bf16 at 128-multiples wgmma, f32 "
        f"and the odd shapes simt, as kernel_path says)")

    # the slice's main path: ops.pruned_matmul at the wi_gate shape
    gen.manual_seed(19)
    x = torch.randn(BSMM_TOKENS, 4096, generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = (torch.randn(4096, 14336, generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    counters = (block_prune.LAUNCHES, block_sparse_matmul.LAUNCHES)
    torch.cuda.synchronize()
    for c in counters:
        for key in c:
            c[key] = 0
    out = ops.pruned_matmul(x, w, BSMM_RHO)
    torch.cuda.synchronize()
    launches = {key: v for c in counters for key, v in c.items()}
    want = {"block_norms": 1, "apply_block_mask": 1,
            "block_sparse_matmul": 1, "block_sparse_matmul_wgmma": 1,
            "block_sparse_matmul_simt": 0}
    if launches != want:
        fail(f"pruned_matmul launches {launches}, want {want}")
    _, bn, bk = block_shape(BSMM_TOKENS, 14336, 4096)
    mask_ref = ops.rank_mask(block_norms_ref(w, bk, bn), BSMM_RHO)
    _, mask = ops.block_prune_2d(w, BSMM_RHO, block=(bk, bn))
    if not torch.equal(mask, mask_ref):
        fail("pruned_matmul: tile mask differs from the plain ranking")
    ref = block_sparse_matmul_ref(x, w, mask_ref, bk, bn)
    d, share = _bsmm_compare(out, ref, x, w, mask_ref, bk, bn,
                             "pruned_matmul")
    worst = max(worst, d)
    log(f"[bsmm] pruned_matmul (1024, 4096) x (4096, 14336) bf16, rho "
        f"{BSMM_RHO}: launches={launches} (block_sparse_matmul launched "
        f"{other_paths} times on the edge and datacenter paths), "
        f"{int(mask.sum())}/{mask.numel()} live tiles, max |diff| {d!r}, "
        f"share beyond one ulp {share!r}, finite "
        f"{bool(torch.isfinite(out).all())}")
    if not bool(torch.isfinite(out).all()):
        fail("pruned_matmul output not finite")
    del x, w, out, ref
    torch.cuda.empty_cache()
    return worst_small, worst, launches, other_paths, by_path


def phase_baselines():
    """FedSGD, SignSGD, FedMP and STC through FedRunner at phase 5's
    full width and settings, 3 rounds each."""
    import torch
    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.data import ArrayDataset, synthetic_cifar
    from repro_torch.fed import ALL_SCHEMES, FedRunner
    from repro_torch.models import ResNet
    stochastic_quant, block_prune, block_sparse_matmul = kernel_modules(
        "stochastic_quant", "block_prune", "block_sparse_matmul")

    imgs, labels = synthetic_cifar(20000, seed=0)
    timgs, tlabels = synthetic_cifar(2000, seed=1)
    train = ArrayDataset({"images": imgs, "labels": labels})
    test = ArrayDataset({"images": timgs, "labels": tlabels})
    model = ResNet(ResNetConfig())
    counters = (stochastic_quant.LAUNCHES, block_prune.LAUNCHES,
                block_sparse_matmul.LAUNCHES)
    out = {}
    for name in BASELINES:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = model.init(gen)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            for key in c:
                c[key] = 0
        runner = FedRunner(model, params, LTFLConfig(), train, test,
                           ALL_SCHEMES[name](), batch_size=50, seed=0,
                           eval_every=1, device="cuda")
        walls, losses = [], []
        for rnd in range(3):
            torch.cuda.synchronize()
            t = time.time()
            rec = runner.run_round(rnd)
            torch.cuda.synchronize()
            walls.append(time.time() - t)
            losses.append(rec.train_loss)
            log(f"[baseline] {name} round {rnd}: loss={rec.train_loss!r} "
                f"acc={rec.test_acc!r} delay={rec.delay!r}s "
                f"energy={rec.energy!r}J received={rec.received}/{C} "
                f"rho_mean={rec.rho_mean!r} wall={walls[-1]!r}s")
            if not math.isfinite(rec.train_loss):
                fail(f"{name} round {rnd}: loss {rec.train_loss}")
        peak = torch.cuda.max_memory_allocated()
        launches = {key: v for c in counters for key, v in c.items()}
        if any(launches.values()):
            fail(f"{name}: kernel launches {launches}, want none")
        if not all(bool(torch.isfinite(v).all())
                   for v in runner.params.values()):
            fail(f"{name}: non-finite weights after 3 rounds")
        if name == "stc" and not all(bool(torch.isfinite(v).all())
                                     for v in runner.comp_state.values()):
            fail("stc: non-finite residual")
        log(f"[baseline] {name}: round_wall_s={walls} "
            f"max_memory_allocated={peak} bytes launches={launches}")
        out[name] = {"round_wall_s": walls, "losses": losses,
                     "max_memory_allocated": peak}
        del runner, params
    torch.cuda.empty_cache()
    return out


def phase_bsmm_timing():
    """CUDA-event times of B4, its plain version and the library call at
    the 8 full-width bf16 shapes, each alone and summed (eager and
    graph-replayed), beside the bound for this run's live tiles."""
    import torch
    from repro_torch.kernels.block_sparse_matmul import block_sparse_matmul
    from repro_torch.kernels.ref import apply_block_mask_ref, \
        block_sparse_matmul_ref
    shapes = bsmm_shapes()
    inputs = _bsmm_full_inputs(shapes, torch.bfloat16, seed=23)
    masked = {k: apply_block_mask_ref(w, m, 128, 128)
              for k, (x, w, m) in inputs.items()}
    # the library call computes the same function: check it once
    x, w, m = inputs["attn.wq"]
    lib = torch.matmul(x, masked["attn.wq"])
    ref = block_sparse_matmul_ref(x, w, m, 128, 128)
    _bsmm_compare(lib, ref, x, w, m, 128, 128, "library call")
    fns = {
        "kernel": lambda k: block_sparse_matmul(*inputs[k]),
        "plain": lambda k: block_sparse_matmul_ref(*inputs[k], 128, 128),
        "library": lambda k: torch.matmul(inputs[k][0], masked[k]),
    }
    res, per_shape = {}, {}
    for label, fn in fns.items():
        for k in shapes:
            per_shape.setdefault(k, {})[f"{label}_ms"] = cuda_ms(
                lambda: fn(k), 3)

        def all_shapes():
            for k in shapes:
                fn(k)

        res[f"{label}_eager_ms"] = cuda_ms(all_shapes, 3)
        res[f"{label}_ms"] = graph_ms(all_shapes, 3)
        torch.cuda.empty_cache()
    tot_bytes = tot_ops = 0.0
    for k, (x, w, m) in inputs.items():
        live = int(m.sum())
        n_bytes = (x.numel() * 2 + live * 128 * 128 * 2
                   + BSMM_TOKENS * w.shape[1] * 2 + m.numel())
        n_ops = 2.0 * BSMM_TOKENS * 128 * 128 * live
        per_shape[k]["bound_ms"], per_shape[k]["bound_by"] = _bound(
            n_bytes, n_ops, BF16_FLOPS)
        per_shape[k]["live_tiles"] = live
        per_shape[k]["tiles"] = m.numel()
        per_shape[k]["live_tflop"] = n_ops / 1e12
        tot_bytes += n_bytes
        tot_ops += n_ops
    res["bound_ms"], res["bound_by"] = _bound(tot_bytes, tot_ops, BF16_FLOPS)
    res["live_tflop"] = tot_ops / 1e12
    res["bytes"] = tot_bytes
    res["kernel_tflops"] = tot_ops / (res["kernel_ms"] * 1e-3) / 1e12
    for k, row in per_shape.items():
        row["kernel_tflops"] = row["live_tflop"] / (row["kernel_ms"] * 1e-3)
    res["per_shape"] = per_shape
    del inputs, masked
    torch.cuda.empty_cache()
    log(f"[timing] block_sparse_matmul (bf16, x 1024 rows, rho "
        f"{BSMM_RHO}, 128 x 128 blocks, 8 shapes): {json.dumps(res)}")
    res["rho_sweep"] = _bsmm_rho_sweep()
    return res


def _bsmm_rho_sweep():
    """B4 against dense bf16 cuBLAS at wi_gate (1024 x 4096 x 14336) as
    the pruning ratio rises: graph-replayed ms of each beside B4's bound
    for that rho's live tiles, and the kernel's result held to the plain
    version's. Returns one row per rho."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_sparse_matmul import block_sparse_matmul
    from repro_torch.kernels.ref import apply_block_mask_ref, \
        block_sparse_matmul_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    k, n = 4096, 14336
    x = torch.randn(BSMM_TOKENS, k, generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    rows = []
    for rho in BSMM_SWEEP_RHO:
        _, mask = ops.block_prune_2d(w, rho, block=(128, 128))
        masked = apply_block_mask_ref(w, mask, 128, 128)
        _bsmm_compare(block_sparse_matmul(x, w, mask),
                      block_sparse_matmul_ref(x, w, mask, 128, 128), x, w,
                      mask, 128, 128, f"rho sweep {rho}")
        live = int(mask.sum())
        n_bytes = (x.numel() * 2 + live * 128 * 128 * 2
                   + BSMM_TOKENS * n * 2 + mask.numel())
        bound, by = _bound(n_bytes, 2.0 * BSMM_TOKENS * 128 * 128 * live,
                           BF16_FLOPS)
        row = {"rho": rho, "live_tiles": live, "tiles": mask.numel(),
               "kernel_ms": graph_ms(
                   lambda: block_sparse_matmul(x, w, mask), 20),
               "bound_ms": bound, "bound_by": by,
               "dense_cublas_ms": graph_ms(lambda: torch.matmul(x, masked),
                                           20)}
        row["kernel_over_dense"] = row["kernel_ms"] / row["dense_cublas_ms"]
        rows.append(row)
        log(f"[sweep] block_sparse_matmul wi_gate rho {rho}: "
            f"{json.dumps(row)}")
        del masked
    del x, w
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------- #
# Serving (phases 14-16): no hand-written kernel lies on this path
# --------------------------------------------------------------------------- #
def all_launches():
    return {k: v for m in kernel_modules("stochastic_quant", "block_prune",
                                         "block_sparse_matmul")
            for k, v in m.LAUNCHES.items()}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _cache_off(got, ref, noise: float) -> float:
    """Share of bf16 cache elements that differ; fails past one bf16 ulp
    plus ``noise`` times the largest |ref| (tests/torch_parity.py's
    rule). A float32 leaf (a recurrent state) fails past rel 1e-5."""
    import torch
    worst = 0.0
    for k in ref:
        g, r = _f32(got[k]), _f32(ref[k])
        if ref[k].dtype == torch.float32:
            if got[k].dtype != torch.float32 or _rel(g, r) > 1e-5:
                fail(f"serve cache {k}: float32 state rel {_rel(g, r)}")
            continue
        tol = _bf16_ulp(r).maximum(_bf16_ulp(g)) + noise * float(r.abs().max())
        if bool(((g - r).abs() > tol).any()):
            fail(f"serve cache {k}: beyond one bf16 ulp")
        worst = max(worst, float((g != r).float().mean()))
    return worst


def phase_serve_small(names=SERVE_FAMILIES) -> None:
    """Each served family of ``names`` at reduce_for_smoke widths in
    float32 on the card and on the CPU, same weights and prompt (whisper:
    and frames): prefill logits, its cache (bf16 leaves to one ulp, a
    float32 recurrent state rel 1e-5) and 9 greedy tokens (8 decode
    steps) through ``launch.serve.generate``.
    Tolerances of tests/test_torch_serve.py: prefill logits rel 1e-5, the
    bf16 cache to one ulp (+1e-5 of its largest |value|) on <= 1e-3 of its
    elements, each side's decode chain rel 3e-4, equal ids."""
    import torch
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model, make_train_batch

    for name in names:
        arch = reduce_for_smoke(get_arch(name))
        model = build_model(arch)
        gen = torch.Generator()
        gen.manual_seed(5)
        init = {k: v.to(torch.float32) for k, v in model.init(gen).items()}
        batch = make_train_batch(arch, 2, 48, gen)
        batch.pop("labels")
        out = {}
        for dev in ("cpu", SERVE_DEVICE):
            p = {k: v.to(dev) for k, v in init.items()}
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.inference_mode():
                logits, cache = model.prefill(p, b)
            res = generate(model, p, b, 9)
            out[dev] = (logits.cpu(), {k: v.cpu() for k, v in cache.items()},
                        res.tokens.cpu(), res.logits.cpu())
        (lc, cc, tc, gc), (lg, cg, tg, gg) = out["cpu"], out[SERVE_DEVICE]
        err = _rel(lg, lc)
        if err > 1e-5:
            fail(f"serve small {name}: prefill logits rel {err}")
        off = _cache_off(cg, cc, 1e-5)
        if off > 1e-3:
            fail(f"serve small {name}: {off} of the cache differs")
        steps = [_rel(gg[:, i], gc[:, i]) for i in range(1, gg.shape[1])]
        if max(steps) > 3e-4:
            fail(f"serve small {name}: decode logits rel {max(steps)}")
        if not torch.equal(tg, tc):
            fail(f"serve small {name}: ids {tg.tolist()} vs {tc.tolist()}")
        log(f"[serve] small {name} float32, card vs cpu: prefill logits rel "
            f"{err!r}, cache off-share {off!r}, decode logits rel max "
            f"{max(steps)!r}, ids equal {tg[0].tolist()}")


def _prefill_flops(cfg, B: int, S: int) -> float:
    """Matmul operations of the reference formulation's prefill over B x S
    tokens (S with the image tokens): projections (the cache entry's k/v
    projected again), attention over the full S x S square (masked, not
    skipped), the FFN (MoE: router, one-hot dispatch and combine, experts
    over their capacity slots, shared experts) and the head."""
    from repro_torch.models import moe as moe_mod
    T, d, L = B * S, cfg.d_model, cfg.n_layers
    h = cfg.n_heads
    n_pre = cfg.moe.first_k_dense if cfg.moe else 0
    if cfg.mla is not None:
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = d * h * qd + 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim) \
            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) \
            + h * m.v_head_dim * d
        core = B * h * S * S * (qd + m.v_head_dim)
    else:
        kvw = cfg.n_kv_heads * cfg.head_dim
        proj = 2 * d * h * cfg.head_dim + 4 * d * kvw
        core = B * h * S * S * 2 * cfg.head_dim
    glu = 3 if cfg.glu else 2
    dense_ffn = glu * d * (cfg.moe.dense_d_ff if n_pre else cfg.d_ff) * T
    flops = L * (2 * T * proj + 2 * core)
    if cfg.moe is None:
        flops += 2 * L * dense_ffn
    else:
        mo = cfg.moe
        g = min(moe_mod.GROUP_SIZE, T)
        G = T // g
        C = moe_mod._capacity(g, mo.top_k, mo.num_experts,
                              mo.capacity_factor)
        # router; one-hot dispatch and combine; the experts over their
        # capacity slots; the shared experts
        moe_ffn = (T * d * mo.num_experts
                   + 2 * G * g * mo.num_experts * C * d
                   + G * mo.num_experts * C * glu * d * mo.d_expert
                   + T * glu * d * mo.d_shared_expert
                   * mo.num_shared_experts)
        flops += 2 * (n_pre * dense_ffn + (L - n_pre) * moe_ffn)
    return float(flops + 2 * T * d * cfg.vocab_size)


def _decode_bytes(model, params, B: int, cache_len: int, experts) -> float:
    """Bytes one decode step must move: every parameter but the token and
    position tables (B rows of each), the routed experts this step's
    tokens chose (``experts``: per MoE layer, the distinct experts), the
    whole cache read (the reference formulation reads every slot) and B
    new entries written; a recurrent state (no sequence axis) is read and
    written whole, a cross cache only read."""
    n = 0.0
    moe_leaves = ("ffn.w_gate", "ffn.w_up", "ffn.w_in", "ffn.w_down")
    for k, v in params.items():
        if k in ("embed.tok", "embed.pos"):
            n += B * v.shape[1] * v.element_size()
        elif k.startswith("layers.") and k.endswith(moe_leaves):
            per_expert = v[0, 0].numel() * v.element_size()
            n += sum(experts) * per_expert
        else:
            n += v.numel() * v.element_size()
    import torch
    for key, (shape, dt) in model.cache_struct(B, cache_len).items():
        size = math.prod(shape) * torch.empty((), dtype=dt).element_size()
        if key in SEQ_CACHES:
            n += size + size // shape[2]
        elif key.startswith("cross_"):
            n += size
        else:
            n += 2 * size
    return n


def _routed(fn):
    """Run ``fn``, recording the experts every MoE routing chose (the
    top-k indices, one tensor a layer)."""
    from repro_torch.models import moe as moe_mod
    seen = []
    inner = moe_mod._route

    def recorded(p, x, k):
        out = inner(p, x, k)
        seen.append(out[2])
        return out

    moe_mod._route = recorded
    try:
        return fn(), seen
    finally:
        moe_mod._route = inner


def _decode_and_forward(model, params, batch, p: int):
    """Prefill the first p text tokens, splice the cache into one of
    n_img + p + 1 slots, decode token p at position n_img + p; and
    ``forward`` over the same p + 1 tokens. Returns both logits at that
    position as float32 (B, V) and, per row, whether every MoE layer
    routed the token to the same experts in both."""
    import torch
    from repro_torch.launch.serve import splice
    cfg = model.cfg
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    tokens = batch["tokens"][:, :p + 1]
    B = tokens.shape[0]
    with torch.inference_mode():
        _, pc = model.prefill(params, dict(batch, tokens=tokens[:, :p]))
        cache = model.init_cache(B, n_img + p + 1, tokens.device)
        # the image tokens' entries too; recurrent states and cross caches
        # as they are (the serve loop's rule at a prompt of n_img + p)
        cache = {k: splice(v, pc[k], n_img + p) for k, v in cache.items()}
        del pc
        pos = torch.full((B,), n_img + p, dtype=torch.int64,
                         device=tokens.device)
        (dec, _), dec_routes = _routed(
            lambda: model.decode_step(params, tokens[:, p], pos, cache))
        del cache
        (full, _), fwd_routes = _routed(
            lambda: model.forward(params, dict(batch, tokens=tokens)))
        fwd = full[:, n_img + p].float()
        del full
    same = torch.ones(B, dtype=torch.bool, device=tokens.device)
    for d, f in zip(dec_routes, fwd_routes):
        f = f.reshape(B, n_img + p + 1, -1)[:, n_img + p]
        same &= (d.sort(-1).values == f.sort(-1).values).all(-1)
    return dec.float(), fwd, same


def _to_f32_in_place(params) -> None:
    """Every leaf as float32, one at a time (the bf16 one freed before the
    next), so a 16 B-parameter model fits the card in float32."""
    import torch
    for k in list(params):
        params[k] = params[k].to(torch.float32)
        torch.cuda.empty_cache()


def phase_serve_full(name: str, runs, check_p, profile_dir,
                     f32_to_noise: bool = False):
    """``name`` at its full published config (bf16, seed 0) through
    ``launch.serve.generate``: per run (batch, prompt, tokens) the
    prefill time and rate, the decode steps by CUDA events against their
    bytes bound, tok/s and the peak memory; prompts above
    CHUNKED_ATTN_THRESHOLD must take the query-chunked path (one call a
    layer) and the others not. Then decode against forward (at
    ``check_p``; capacity factor 16 for MoE, where prefill drops tokens
    and decode does not) and, with --profile, one profiled decode step.
    With ``f32_to_noise`` (phase 20) the float32 decode is held to the
    bf16 forward's distance from the float32 forward, not to phases
    15-16's fixed 1e-2: the bf16 cache rounds a recurrent state at every
    layer (zamba2's conv state at 54) besides the k/v entries, and its
    rounding is a part of the bf16 forward's."""
    import dataclasses
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model, layers, make_train_batch

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    arch = serve_arch(name)
    model = build_model(arch)
    gen = torch.Generator(device=SERVE_DEVICE)
    gen.manual_seed(0)
    t0 = time.time()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    p_bytes = sum(v.numel() * v.element_size() for v in params.values())
    log(f"[serve] {name}: {arch.n_layers} layers, d_model {arch.d_model}, "
        f"{n_params} parameters ({p_bytes} bytes, param_count() "
        f"{arch.param_count()}), init {time.time() - t0!r} s")
    chunked = []
    inner_chunked = layers._attend_chunked

    def counted(qg, *a, **kw):
        chunked.append(qg.shape[1])
        return inner_chunked(qg, *a, **kw)

    rows = []
    n_img = arch.num_image_tokens if arch.family == "vlm" else 0
    for B, P, n_gen in runs:
        batch = make_train_batch(arch, B, P, gen)
        batch.pop("labels")
        chunked.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        layers._attend_chunked = counted
        try:
            res = generate(model, params, batch, n_gen)
        finally:
            layers._attend_chunked = inner_chunked
        peak = torch.cuda.max_memory_allocated()
        want = arch.n_layers if n_img + P > layers.CHUNKED_ATTN_THRESHOLD \
            else 0
        if len(chunked) != want:
            fail(f"serve {name} {B}x{P}: {len(chunked)} chunked attention "
                 f"calls, want {want}")
        if not bool(torch.isfinite(res.logits.float()).all()):
            fail(f"serve {name} {B}x{P}: non-finite logits")
        if res.tokens.shape != (B, n_gen):
            fail(f"serve {name}: tokens {tuple(res.tokens.shape)}")
        cache_len = P + n_gen
        # the next step (its token, the last free position): the routing
        # count (MoE) and, with --profile, the trace
        tok = res.tokens[:, -1]
        pos = torch.full((B,), cache_len - 1, dtype=torch.int64,
                         device=SERVE_DEVICE)
        cache = res.cache

        def one_step():
            with torch.inference_mode():
                model.decode_step(params, tok, pos, cache)

        _, routes = _routed(one_step)
        experts = [int(t.unique().numel()) for t in routes]
        n_bytes = _decode_bytes(model, params, B, cache_len, experts)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        # the matmul work of the decoder families' formulation; the
        # recurrent and encoder-decoder prefills are not counted
        flops = (_prefill_flops(arch, B, n_img + P)
                 if arch.family in ("dense", "moe", "vlm") else None)
        step_ms = sorted(res.step_ms)
        med = step_ms[len(step_ms) // 2] if step_ms else float("nan")
        row = {
            "arch": name, "parameters": n_params, "batch": B, "prompt": P, "image_tokens": n_img,
            "gen": n_gen, "prefill_s": res.prefill_s,
            "prefill_tflop": flops and flops / 1e12,
            "prefill_tflops": flops and flops / res.prefill_s / 1e12,
            "prefill_share_of_989": flops and flops / res.prefill_s
            / BF16_FLOPS,
            "encoder_frames": arch.encoder_seq or None,
            "decode_s": res.decode_s,
            "tok_per_s": (n_gen - 1) * B / res.decode_s,
            "decode_step_ms_median": med,
            "decode_step_ms_min": step_ms[0] if step_ms else None,
            "decode_step_ms_max": step_ms[-1] if step_ms else None,
            "decode_bytes": n_bytes, "decode_bound_ms": bound_ms,
            "decode_bound_share": bound_ms / med,
            "experts_read": sum(experts) if experts else None,
            "max_memory_allocated": peak,
            "chunked_attention_calls": len(chunked),
        }
        if profile_dir is not None:
            profile_call(one_step, profile_dir / f"profile_decode_{name}_"
                         f"{B}x{P}.txt", f"decode step {name} {B}x{P}")
        del cache, res
        torch.cuda.empty_cache()
        log(f"[serve] {json.dumps(row)}")
        rows.append(row)

    # decode against forward, in bf16 and then (the same weights) float32
    check_model = model
    if arch.moe is not None:
        check_model = build_model(arch.replace(moe=dataclasses.replace(
            arch.moe, capacity_factor=16.0)))
    B, p = check_p
    batch = make_train_batch(arch, B, p + 1, gen)
    batch.pop("labels")
    dec16, fwd16, same16 = _decode_and_forward(check_model, params, batch,
                                               p)
    _to_f32_in_place(params)
    dec32, fwd32, same32 = _decode_and_forward(check_model, params, batch,
                                               p)
    if not bool(same32.any()):
        fail(f"serve {name}: float32 decode and forward route every row "
             "differently")
    check = {"position": n_img + p, "batch": B,
             "f32_rows_routed_alike": int(same32.sum()),
             "bf16_rows_routed_alike": int(same16.sum()),
             "f32_rel": _rel(dec32[same32], fwd32[same32]),
             "f32_rel_all_rows": _rel(dec32, fwd32),
             "bf16_rel_to_f32_forward": _rel(dec16, fwd32),
             "bf16_forward_rel_to_f32_forward": _rel(fwd16, fwd32),
             "bf16_rel": _rel(dec16, fwd16),
             "bf16_max_abs_diff": float((dec16 - fwd16).abs().max()),
             "argmax_agree_bf16": int((dec16.argmax(-1)
                                      == fwd16.argmax(-1)).sum()),
             "argmax_agree_f32": int((dec32.argmax(-1)
                                     == fwd32.argmax(-1)).sum())}
    cf16 = ", capacity factor 16" if arch.moe else ""
    log(f"[serve] {name} decode vs forward at position {n_img + p} (batch "
        f"{B}, {n_img + p + 1} tokens{cf16}): {json.dumps(check)}")
    # float32, over the rows every MoE layer routed alike in decode and
    # forward: the bf16 cache's rounding only (tests/test_torch_mla.py's
    # 1e-2); a near-tie that the cache's rounding flips moves a row's
    # experts, and is counted, not held to it. bf16: the decode no
    # farther from the float32 forward than twice the bf16 forward is
    # (two bf16 computations of one function)
    f32_bound = (check["bf16_forward_rel_to_f32_forward"]
                 if f32_to_noise else 1e-2)
    if check["f32_rel"] > f32_bound:
        fail(f"serve {name}: float32 decode vs forward rel "
             f"{check['f32_rel']} (bound {f32_bound})")
    if check["bf16_rel_to_f32_forward"] > \
            2 * check["bf16_forward_rel_to_f32_forward"]:
        fail(f"serve {name}: bf16 decode lies farther from the float32 "
             f"forward than twice the bf16 forward: {check}")
    rows[0]["decode_vs_forward"] = check
    del params, check_model, model
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------- #
# The scanned engine and sweep lanes (phases 21-23)
# --------------------------------------------------------------------------- #
SCAN_ROUNDS = 10                        # LTFLScheme(recontrol_every=10)
SWEEP_SEEDS = (0, 1)
# phase 23's tolerance for a lane's per-round delay and energy against
# its solo run's (see the module docstring); losses and weights: bitwise
SWEEP_ACCOUNTING_REL = 1e-6


def edge_world(n_train: int, n_test: int, seed: int = 0):
    from repro_torch.data import ArrayDataset, synthetic_cifar
    imgs, labels = synthetic_cifar(n_train, seed=seed)
    timgs, tlabels = synthetic_cifar(n_test, seed=seed + 1)
    return (ArrayDataset({"images": imgs, "labels": labels}),
            ArrayDataset({"images": timgs, "labels": tlabels}))


def same_host_fields(a, b, where: str) -> None:
    """The numpy-side fields of two histories: bitwise."""
    if len(a) != len(b):
        fail(f"{where}: {len(a)} rounds against {len(b)}")
    for x, y in zip(a, b):
        for f in ("round", "cohort", "received", "rho_mean", "delta_mean",
                  "power_mean"):
            if getattr(x, f) != getattr(y, f):
                fail(f"{where}: round {x.round} {f} {getattr(x, f)!r} vs "
                     f"{getattr(y, f)!r}")


def max_loss_rel(a, b) -> float:
    return max(abs(x.train_loss - y.train_loss) / abs(y.train_loss)
               for x, y in zip(a, b))


def phase_scan_small() -> None:
    """Phase 21: the scanned engine at small size, card against CPU and
    against the per-round loop, and make_scanned_step against a loop."""
    import torch
    from repro_torch.configs import LTFLConfig, get_arch, reduce_for_smoke
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.fed import ALL_SCHEMES, FedRunner, ScanRunner, \
        make_scanned_step
    from repro_torch.models import MLP, MLPConfig, build_model, \
        make_train_batch
    from repro_torch.optim import sgd

    train, test = edge_world(600, 128)
    model = MLP(MLPConfig(hidden=(16,), downsample=4))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    ltfl = LTFLConfig(num_devices=4, samples_min=40, samples_max=60,
                      bo_iters=3, alt_max_iters=2)

    def cpu_uniforms(seed, nc, shapes):
        g = torch.Generator()
        g.manual_seed(seed)
        return [torch.rand((nc,) + tuple(s), generator=g) for s in shapes]

    kw = dict(batch_size=8, seed=0, eval_every=0)
    # device control and the registry in blocks without the device rng
    # stream refuse, as the reference's do
    for bad, item in ((dict(control="device", rng="host"), "rng='device'"),
                      (dict(population_sharding=2, rng="host"),
                       "rng='device'")):
        try:
            ScanRunner(model, params, ltfl, train, test,
                       ALL_SCHEMES["ltfl"](), device="cuda", **bad, **kw)
        except ValueError as err:
            if item not in str(err):
                fail(f"ScanRunner({bad}) raised without naming {item}: "
                     f"{err}")
        else:
            fail(f"ScanRunner({bad}) did not raise")
    log("[scan] control='device' and population_sharding with "
        "rng='host' raise ValueErrors on the card")
    hists = {}
    for dev in ("cpu", "cuda"):
        runner = ScanRunner(model, params, ltfl, train, test,
                            ALL_SCHEMES["ltfl"](), device=dev,
                            uniforms=cpu_uniforms, max_segment=3, **kw)
        hists[dev] = runner.run(6)
    same_host_fields(hists["cuda"], hists["cpu"], "scan card vs cpu")
    rel = max_loss_rel(hists["cuda"], hists["cpu"])
    if rel > 1e-4:                           # phase 4's tolerance
        fail(f"scan card vs cpu: loss rel {rel}")
    log(f"[scan] MLP U=4, 6 rounds in segments of 3, card vs cpu: host "
        f"fields equal, loss max rel {rel!r}")
    for name in ("ltfl", "fedsgd"):
        loop = FedRunner(model, params, ltfl, train, test,
                         ALL_SCHEMES[name](), device="cuda", **kw)
        scan = ScanRunner(model, params, ltfl, train, test,
                          ALL_SCHEMES[name](), device="cuda", **kw)
        h_loop, h_scan = loop.run(6), scan.run(6)
        same_host_fields(h_scan, h_loop, f"scan vs FedRunner {name}")
        if [r.train_loss for r in h_scan] != [r.train_loss for r in h_loop]:
            fail(f"scan vs FedRunner {name}: losses "
                 f"{[r.train_loss for r in h_scan]} vs "
                 f"{[r.train_loss for r in h_loop]}")
        if not all(torch.equal(v, scan.params[k])
                   for k, v in loop.params.items()):
            fail(f"scan vs FedRunner {name}: weights differ")
        log(f"[scan] MLP U=4 {name}, 6 rounds on the card: ScanRunner "
            f"equals FedRunner bitwise (losses, weights)")

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    arch = reduce_for_smoke(get_arch("granite-8b"))
    model = build_model(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    clients, per_client, seq, rounds = DC_CLIENTS, 2, 128, 3
    opt = sgd(0.05)
    step = make_fl_train_step(model, opt, clients, prune_block=32,
                              prune_kind="block")
    batch = make_train_batch(arch, rounds * clients * per_client, seq,
                             generator=gen)
    batches = {k: v.reshape(rounds, clients, per_client, *v.shape[1:])
               for k, v in batch.items()}
    full = lambda v: torch.full((clients,), v, device="cuda")  # noqa: E731
    controls = {"rho": full(0.25), "delta": full(8.0),
                "drop_prob": full(0.05), "weights": full(500.0)}
    p, o, c = params, opt.init(params), step.init_comp_state(params)
    losses = []
    for r in range(rounds):
        p, o, c, m = step(p, o, c, {k: v[r] for k, v in batches.items()},
                          controls, r)
        losses.append(m["loss"])
    ps, _, _, ms = make_scanned_step(step)(
        params, opt.init(params), step.init_comp_state(params), batches,
        controls, list(range(rounds)))
    if not torch.equal(ms["loss"], torch.stack(losses)) or not all(
            torch.equal(v, ps[k]) for k, v in p.items()):
        fail(f"make_scanned_step vs loop: losses {ms['loss'].tolist()} vs "
             f"{torch.stack(losses).tolist()}")
    log(f"[scan] make_scanned_step over granite-8b's datacenter step at "
        f"smoke widths, {rounds} rounds: equals the loop bitwise (losses "
        f"{ms['loss'].tolist()}, weights)")


def _sync_free_run(runner, rounds: int, where: str):
    """``runner.run(rounds)`` with every segment's loop under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside a
    segment raises, and fails the phase."""
    runner.segment_sync_debug = "error"
    try:
        return runner.run(rounds)
    except RuntimeError as err:
        fail(f"{where}: a host sync inside a segment: {err}")
    finally:
        runner.segment_sync_debug = None


def _timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t


def phase_scan_main(profile_dir):
    """Phase 22: ScanRunner at the paper's width, both rng modes, then
    FedRunner against ScanRunner per round at paper width and in the
    MLP regime of benchmarks/scan_engine.py."""
    import torch
    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.fed import FedRunner, FedSGDScheme, LTFLScheme, \
        ScanRunner
    from repro_torch.kernels.stochastic_quant import LAUNCHES
    from repro_torch.models import MLP, MLPConfig, ResNet

    # the sync check's positive control: it must catch a device-to-host
    # read (PyTorch calls the mode a prototype that does not see every
    # sync); whether it sees a pageable host-to-device copy is logged
    probe = torch.ones(1, device="cuda")
    caught = {}
    for name, fn in (("item", lambda: float(probe)),
                     ("upload", lambda: torch.tensor([1.0], device="cuda"))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            caught[name] = False
        except RuntimeError:
            caught[name] = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if not caught["item"]:
        fail("set_sync_debug_mode('error') let a device-to-host read pass")
    log(f"[scan] sync check catches: {caught}")

    train, test = edge_world(20000, 2000)
    model = ResNet(ResNetConfig())
    n_leaves = len(model.param_specs())
    out = {"launches_per_round": {}, "round_s": {}, "sync_check": caught}

    def runner(cls, **kw):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        return cls(model, model.init(gen), LTFLConfig(), train, test,
                   LTFLScheme(recontrol_every=SCAN_ROUNDS), batch_size=50,
                   seed=0, eval_every=0, device="cuda", **kw)

    for mode in ("host", "device"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        scan = runner(ScanRunner, rng=mode)
        LAUNCHES["stochastic_quant"] = 0
        first = _timed(lambda: _sync_free_run(
            scan, SCAN_ROUNDS, f"scan rng={mode}"))
        steady = _timed(lambda: _sync_free_run(
            scan, SCAN_ROUNDS, f"scan rng={mode}"))
        launched = LAUNCHES["stochastic_quant"]
        peak = torch.cuda.max_memory_allocated()
        hist = scan.history
        if len(hist) != 2 * SCAN_ROUNDS or not all(
                math.isfinite(r.train_loss) for r in hist):
            fail(f"scan rng={mode}: losses {[r.train_loss for r in hist]}")
        if launched != 2 * SCAN_ROUNDS * n_leaves:
            fail(f"scan rng={mode}: {launched} quantizer launches in "
                 f"{2 * SCAN_ROUNDS} rounds, want {n_leaves} a round")
        out["launches_per_round"][mode] = launched // (2 * SCAN_ROUNDS)
        out["round_s"][f"scan_{mode}"] = steady / SCAN_ROUNDS
        log(f"[scan] paper width rng={mode}: 2 segments of {SCAN_ROUNDS} "
            f"rounds, no host sync inside a segment, quantizer launches "
            f"{launched} ({launched // (2 * SCAN_ROUNDS)} a round), losses "
            f"{[r.train_loss for r in hist]}, received "
            f"{[r.received for r in hist]}, segment_s first {first!r} "
            f"steady {steady!r}, max_memory_allocated={peak} bytes")
        if profile_dir is not None and mode == "host":
            profile_call(lambda: scan.run(SCAN_ROUNDS),
                         profile_dir / "profile_segment.txt",
                         f"scanned segment ({SCAN_ROUNDS} rounds)")
        del scan
    loop = runner(FedRunner)
    loop.run(SCAN_ROUNDS)
    out["round_s"]["fedrunner"] = _timed(
        lambda: loop.run(SCAN_ROUNDS)) / SCAN_ROUNDS
    del loop
    torch.cuda.empty_cache()
    log(f"[scan] paper width, steady s a round ({SCAN_ROUNDS}-round runs, "
        f"recontrol at each run's round 0): {out['round_s']}")

    # the MLP regime of benchmarks/scan_engine.py: U = 16, batch 4,
    # FedSGD, 64 rounds; min of 3 timed runs after a warm-up run
    mlp_train, mlp_test = edge_world(2048, 256)
    mlp = MLP(MLPConfig(hidden=(16,), downsample=4))
    ltfl = LTFLConfig(num_devices=16, samples_min=40, samples_max=60,
                      learning_rate=0.1)
    mlp_s = {}
    for name, cls, kw in (("fedrunner", FedRunner, {}),
                          ("scan_host", ScanRunner, {"rng": "host"}),
                          ("scan_device", ScanRunner, {"rng": "device"})):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        r = cls(mlp, mlp.init(gen), ltfl, mlp_train, mlp_test,
                FedSGDScheme(), batch_size=4, seed=0, eval_every=0,
                device="cuda", **kw)
        r.run(64)
        mlp_s[name] = min(_timed(lambda: r.run(64)) for _ in range(3)) / 64
    out["mlp_round_s"] = mlp_s
    log(f"[scan] MLP regime (U=16, batch 4, FedSGD, 64 rounds), min of 3, "
        f"s a round: {mlp_s}")
    return out


def param_gap(a, b, start) -> float:
    """||a - b|| / ||b - start|| over all leaves, in float64: how far two
    runs' final weights lie apart, as a share of how far ``b`` trained."""
    import torch
    num = sum(float(torch.sum((a[k].double() - b[k].double()) ** 2))
              for k in b)
    den = sum(float(torch.sum((b[k].double() - start[k].double()) ** 2))
              for k in b)
    return math.sqrt(num / den)


def _quant_hook(fn):
    """Route the quantizer wrapper the round step calls through ``fn(real,
    g, rand, rng)`` until the returned undo is called."""
    from repro_torch.kernels import ops
    real = ops.stochastic_quant
    ops.stochastic_quant = lambda g, rand, rng: fn(real, g, rand, rng)

    def undo():
        ops.stochastic_quant = real
    return undo


def _sweep_run(parent, spec, where: str):
    """``parent.run_sweep(spec, SCAN_ROUNDS)`` under the sync check;
    returns the histories and the lanes of its one bucket."""
    parent.segment_sync_debug = "error"
    try:
        hists = parent.run_sweep(spec, SCAN_ROUNDS)
    except RuntimeError as err:
        fail(f"{where}: a host sync inside a segment: {err}")
    finally:
        parent.segment_sync_debug = None
    return hists, parent._last_sweep_buckets[0]["lanes"]


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms, then as it was."""
    import torch
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def phase_sweep():
    """Phase 23: run_sweep of LTFL over 2 channel regimes x 2 seeds at
    the paper's width: one bucket, one quantizer launch per leaf per
    round for all 4 lanes, the kernel against its plain version on the
    bucket's own inputs, each lane bitwise against its solo run under
    deterministic cuDNN, two planted faults, then (cuDNN as it was) the
    bucket's time against its lanes run one after another, here and in
    the MLP regime."""
    import dataclasses
    import torch
    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.fed import LTFLScheme, ScanRunner, SweepSpec, \
        scan_engine
    from repro_torch.kernels.stochastic_quant import LAUNCHES
    from repro_torch.models import ResNet

    train, test = edge_world(20000, 2000)
    model = ResNet(ResNetConfig())
    n_leaves = len(model.param_specs())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    base = LTFLConfig()
    # a narrower band and a lower power cap: laned floats only
    narrow = dataclasses.replace(base, wireless=dataclasses.replace(
        base.wireless, bandwidth_ul=5e6, p_max=0.05))
    regimes = {"table2": base, "narrow": narrow}

    def scheme():
        return LTFLScheme(recontrol_every=SCAN_ROUNDS)

    spec = SweepSpec.grid(schemes={"ltfl": scheme}, ltfls=regimes,
                          seeds=SWEEP_SEEDS)
    n_lanes, u = len(spec.lanes), base.num_devices
    kw = dict(batch_size=50, seed=0, eval_every=0, device="cuda")
    parent = ScanRunner(model, params, base, train, test, scheme(), **kw)

    def solo_runner(lane_spec):
        return ScanRunner(model, params, lane_spec.ltfl, train, test,
                          scheme(), **dict(kw, seed=lane_spec.seed))

    # the main path; the first round's quantizer inputs and outputs are
    # kept (device copies: no sync) to hold the kernel against its plain
    # version at the bucket's own (L * U, n) rows
    recorded = []

    def record(real, g, rand, rng):
        out = real(g, rand, rng)
        if len(recorded) < n_leaves:
            recorded.append([t.clone() for t in (g, rand, rng, out)])
        return out

    with deterministic_cudnn():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        undo = _quant_hook(record)
        LAUNCHES["stochastic_quant"] = 0
        try:
            hists, lanes = _sweep_run(parent, spec, "sweep")
        finally:
            undo()
        launched = LAUNCHES["stochastic_quant"]
        buckets = [b["lane_indices"] for b in parent._last_sweep_buckets]
        if buckets != [list(range(n_lanes))]:
            fail(f"sweep: buckets {buckets}, want one of {n_lanes}")
        if launched != SCAN_ROUNDS * n_leaves:
            fail(f"sweep: {launched} quantizer launches in {SCAN_ROUNDS} "
                 f"rounds, want {n_leaves} a round for the whole bucket")
        quant = _bucket_quant_check(recorded, n_leaves, n_lanes * u)
        del recorded
        torch.cuda.empty_cache()

        # each lane against its solo run: bitwise
        solo_params, lanes_out = [], []
        for lane_spec, hist, lane in zip(spec.lanes, hists, lanes):
            solo = solo_runner(lane_spec)
            h_solo = list(solo.run(SCAN_ROUNDS))
            solo_params.append(solo.params)
            where = f"sweep lane {lane_spec.label}"
            same_host_fields(hist, h_solo, where)
            for x, y in zip(hist, h_solo):
                if not math.isfinite(x.train_loss) or \
                        x.train_loss != y.train_loss:
                    fail(f"{where}: round {x.round} loss {x.train_loss!r} "
                         f"vs its solo run's {y.train_loss!r}")
                for f in ("delay", "energy"):
                    a, b = getattr(x, f), getattr(y, f)
                    if abs(a - b) > SWEEP_ACCOUNTING_REL * abs(b):
                        fail(f"{where}: round {x.round} {f} {a!r} vs its "
                             f"solo run's {b!r}")
            gap = param_gap(lane.params, solo.params, params)
            if gap != 0.0:
                fail(f"{where}: final weights {gap} apart from its solo "
                     f"run's")
            lanes_out.append({"label": lane_spec.label,
                              "final_loss": hist[-1].train_loss,
                              "cum_delay": hist[-1].cum_delay,
                              "cum_energy": hist[-1].cum_energy})
            del solo
        del lanes
        parent._last_sweep_buckets = []
        # the weights' gap between lanes that differ by a seed or a regime
        gaps = {"other_seed": param_gap(solo_params[1], solo_params[0],
                                        params),
                "other_regime": param_gap(solo_params[2], solo_params[0],
                                          params)}
        faults = _planted_faults(parent, spec, hists[0], solo_params[0],
                                 params, u)
        del solo_params
    log(f"[sweep] under deterministic cuDNN every lane equals its solo run "
        f"bitwise (losses, final weights; host fields); weight gaps "
        f"||a - b|| / ||solo - init|| between lanes {json.dumps(gaps)}, "
        f"lane 0 under planted faults {json.dumps(faults)}")

    # the bucket's steady time without building its lanes, against the
    # lanes run one after another through the one-lane path; both run
    # 2 x SCAN_ROUNDS rounds, and how far a lane then lies from its solo
    # run is what the bitwise check above would face without
    # deterministic cuDNN
    solo_s, solos = [], []
    for lane_spec in spec.lanes:
        solo = solo_runner(lane_spec)
        solo.run(SCAN_ROUNDS)
        solo_s.append(_timed(lambda: solo.run(SCAN_ROUNDS)) / SCAN_ROUNDS)
        solos.append((solo.history, solo.params))
        del solo
    parent.run_sweep(spec, SCAN_ROUNDS)
    lanes = parent._last_sweep_buckets[0]["lanes"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bucket_s = _timed(lambda: scan_engine._run_bucket(lanes, SCAN_ROUNDS))
    peak = torch.cuda.max_memory_allocated()
    nondet = {"param_gap": [param_gap(lane.params, sp, params)
                            for lane, (_, sp) in zip(lanes, solos)],
              "loss_max_rel": [max_loss_rel(lane.history, sh)
                               for lane, (sh, _) in zip(lanes, solos)]}
    del lanes, solos
    parent._last_sweep_buckets = []
    sweep_s = _timed(lambda: parent.run_sweep(spec, SCAN_ROUNDS))
    parent._last_sweep_buckets = []
    torch.cuda.empty_cache()

    out = {"lanes": n_lanes, "buckets": len(buckets),
           "launches_per_round": launched // SCAN_ROUNDS,
           "quant_vs_plain": quant, "lanes_bitwise_solo": True,
           "param_gaps": gaps, "planted_faults": faults,
           "nondeterministic_cudnn_lane_vs_solo": nondet,
           "bucket_round_s": bucket_s / SCAN_ROUNDS,
           "sweep_round_s_with_setup": sweep_s / SCAN_ROUNDS,
           "solo_round_s": solo_s,
           "lanes_one_after_another_round_s": sum(solo_s),
           "bucket_speedup": sum(solo_s) / (bucket_s / SCAN_ROUNDS),
           "max_memory_allocated": peak, "lane_results": lanes_out,
           "mlp": _mlp_sweep_timing()}
    log(f"[sweep] {json.dumps(out)}")
    return out


def _bucket_quant_check(recorded, n_leaves: int, rows: int):
    """The quantizer's inputs and outputs of the bucket's first round
    against its plain version, by phase 3's rules: the float32 outputs
    the main path got, and the same inputs cast to bfloat16."""
    import torch
    if len(recorded) != n_leaves or any(r[0].shape[0] != rows
                                        for r in recorded):
        fail(f"sweep: recorded quantizer calls "
             f"{[tuple(r[0].shape) for r in recorded]}, want {n_leaves} "
             f"of {rows} rows")
    f32 = quant_vs_plain([r[:3] for r in recorded], "sweep bucket f32",
                         outs=[r[3] for r in recorded])
    bf16_batch = []
    for g, rand, rng, _ in recorded:
        gb = g.to(torch.bfloat16)
        a = gb.to(torch.float32).abs()
        bf16_batch.append((gb, rand, torch.stack(
            [a.amin(1), a.amax(1), rng[:, 2]], 1).contiguous()))
    bf16 = quant_vs_plain(bf16_batch, "sweep bucket bf16")
    quant = {"rows": rows, "leaves": n_leaves, "elements": f32[2],
             "f32_max_abs_err": f32[0], "f32_mismatch_fraction": f32[1],
             "bf16_max_abs_err": bf16[0], "bf16_mismatch_fraction": bf16[1]}
    log(f"[sweep] the quantizer on the bucket's first round ({rows} rows "
        f"a leaf, per-row [lo, hi, levels]) against its plain version: "
        f"{json.dumps(quant)}")
    return quant


def _planted_faults(parent, spec, hist0, solo0, start, u: int):
    """Two planted faults, each of which the bitwise lane check must
    see: lanes 0 and 1 (two seeds) swap their quantized gradients
    ("lanes": lane 0 aggregates lane 1's clients), or only the two rows
    either side of the lanes' seam ("seam": lane 0's last client and
    lane 1's first, the fold off by one row). Returns lane 0's weight
    gap to its solo run and its loss's max rel to the clean lane's."""
    import torch
    n = len(spec.lanes) * u
    perms = {"lanes": list(range(u, 2 * u)) + list(range(u)),
             "seam": list(range(u - 1)) + [u, u - 1]
             + list(range(u + 1, 2 * u))}
    faults = {}
    for name, perm in perms.items():
        idx = torch.tensor(perm + list(range(2 * u, n)), device="cuda")

        def permute(real, g, rand, rng, idx=idx):
            return torch.index_select(real(g, rand, rng), 0, idx)

        undo = _quant_hook(permute)
        try:
            hists, lanes = _sweep_run(parent, spec,
                                      f"sweep planted fault {name}")
        finally:
            undo()
        faults[name] = {"param_gap": param_gap(lanes[0].params, solo0,
                                               start),
                        "loss_max_rel": max_loss_rel(hists[0], hist0)}
        del lanes
        parent._last_sweep_buckets = []
        if not faults[name]["param_gap"] > 0.0:
            fail(f"sweep: the planted fault {name!r} left lane 0's "
                 f"weights equal to its solo run's")
    return faults


def _mlp_sweep_timing():
    """The MLP regime of benchmarks/scan_engine.py (U = 16, batch 4, 64
    rounds): a bucket of 4 seed lanes against the same lanes run one
    after another, each alone; min of 3 timed runs after a warm-up run,
    for FedSGD and for LTFL (recontrol once a run)."""
    import torch
    from repro_torch.configs import LTFLConfig
    from repro_torch.fed import FedSGDScheme, LTFLScheme, ScanRunner, \
        scan_engine
    from repro_torch.models import MLP, MLPConfig
    rounds, seeds = 64, (0, 1, 2, 3)
    train, test = edge_world(2048, 256)
    mlp = MLP(MLPConfig(hidden=(16,), downsample=4))
    ltfl = LTFLConfig(num_devices=16, samples_min=40, samples_max=60,
                      learning_rate=0.1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = mlp.init(gen)
    out = {}
    for name, factory in (("fedsgd", FedSGDScheme),
                          ("ltfl", lambda: LTFLScheme(
                              recontrol_every=rounds))):
        def make(seed):
            return ScanRunner(mlp, params, ltfl, train, test, factory(),
                              batch_size=4, seed=seed, eval_every=0,
                              device="cuda")
        parent = make(0)
        hists = parent.run_sweep(list(seeds), rounds,
                                 scheme_factory=factory)
        if not all(math.isfinite(r.train_loss) for h in hists for r in h):
            fail(f"MLP sweep {name}: a loss is not finite")
        lanes = parent._last_sweep_buckets[0]["lanes"]
        bucket = min(_timed(lambda: scan_engine._run_bucket(lanes, rounds))
                     for _ in range(3)) / rounds
        solo = []
        for seed in seeds:
            r = make(seed)
            r.run(rounds)
            solo.append(min(_timed(lambda: r.run(rounds))
                            for _ in range(3)) / rounds)
        out[name] = {"bucket_round_s": bucket,
                     "lanes_one_after_another_round_s": sum(solo),
                     "solo_round_s": solo,
                     "bucket_speedup": sum(solo) / bucket}
    return out


# --------------------------------------------------------------------------- #
# Device control (phase 24)
# --------------------------------------------------------------------------- #
CONTROL_ROUNDS = 10                     # one segment of per-round solves
CONTROL_EVAL_EVERY = 5
CONTROL_FEDSGD_ROUNDS = 4               # host vs device control, eval 2
CONTROL_MLP_CLIENTS = (8, 16, 32)       # benchmarks/device_control.py
CONTROL_MLP_ROUNDS = 8
# the reference test's sizes (tests/test_device_control.py), the gate
PIN_LTFL = dict(num_devices=6, samples_min=40, samples_max=60, bo_iters=3,
                alt_max_iters=2)
PIN_PARAMS = 3000


def host_bo_draws(seed: int, alternations: int, iters: int, d: int,
                  init_points: int = 4, n_candidates: int = 512):
    """The host optimizer's numpy draw order, stacked per alternation
    (init uniforms; per iteration the candidate uniforms, then the
    0.1-scaled local normals), as float32 ``BODraws`` on the card."""
    import numpy as np
    import torch
    from repro_torch.control import BODraws
    rng = np.random.default_rng(seed)
    ui = np.empty((alternations, init_points, d))
    uc = np.empty((alternations, iters, n_candidates, d))
    ep = np.empty((alternations, iters, n_candidates // 4, d))
    for a in range(alternations):
        ui[a] = rng.uniform(size=(init_points, d))
        for m in range(iters):
            uc[a, m] = rng.uniform(size=(n_candidates, d))
            ep[a, m] = rng.normal(0.0, 0.1, size=(n_candidates // 4, d))
    return BODraws(*(torch.as_tensor(x, dtype=torch.float32, device="cuda")
                     for x in (ui, uc, ep)))


def device_events(fn) -> int:
    """How many device-side events (kernels, copies, fills) one call of
    ``fn`` makes, counted by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_control(profile_dir):
    """Phase 24: the device control plane at the paper's width (the
    main path, FedSGD under both control modes, solve_dev against the
    host solve, a device-control sweep bucket at MLP width) and its
    times against host control."""
    import torch
    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.fed import FedSGDScheme, LTFLScheme, ScanRunner
    from repro_torch.kernels.stochastic_quant import LAUNCHES
    from repro_torch.models import ResNet

    train, test = edge_world(20000, 2000)
    model = ResNet(ResNetConfig())
    n_leaves = len(model.param_specs())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    base = LTFLConfig()
    w = base.wireless
    out = {}

    def make(scheme, **kw):
        kw = {"batch_size": 50, "seed": 0, "device": "cuda", **kw}
        return ScanRunner(model, params, base, train, test, scheme, **kw)

    # the main path: per-round Algorithm 1, one segment, eval head
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scheme = LTFLScheme(recontrol_every=1)
    runner = make(scheme, rng="device", control="device", block_fading=True,
                  eval_every=CONTROL_EVAL_EVERY)
    spans = runner._segment_spans(0, CONTROL_ROUNDS)
    if spans != [(0, CONTROL_ROUNDS)]:
        fail(f"device control: segments {spans}, want one")
    LAUNCHES["stochastic_quant"] = 0
    first = _timed(lambda: _sync_free_run(runner, CONTROL_ROUNDS,
                                          "device control"))
    launched = LAUNCHES["stochastic_quant"]
    hist = list(runner.history)
    if launched != CONTROL_ROUNDS * n_leaves:
        fail(f"device control: {launched} quantizer launches in "
             f"{CONTROL_ROUNDS} rounds, want {n_leaves} a round")
    if scheme._n_decide_solves != CONTROL_ROUNDS:
        fail(f"device control: {scheme._n_decide_solves} solves in "
             f"{CONTROL_ROUNDS} rounds")
    for r in hist:
        if not (math.isfinite(r.train_loss) and math.isfinite(r.gamma)):
            fail(f"device control: round {r.round} loss {r.train_loss} "
                 f"gamma {r.gamma}")
        if not (0.0 <= r.rho_mean <= base.rho_max
                and 1.0 <= r.delta_mean <= base.delta_max
                and w.p_min <= r.power_mean <= w.p_max):
            fail(f"device control: round {r.round} means out of bounds: "
                 f"{r.rho_mean}, {r.delta_mean}, {r.power_mean}")
        due = r.round % CONTROL_EVAL_EVERY == 0
        if due != math.isfinite(r.test_acc):
            fail(f"device control: round {r.round} test_acc {r.test_acc}")
    powers = [r.power_mean for r in hist]
    if len(set(powers)) < 2:
        fail(f"device control: power did not move: {powers}")
    steady = _timed(lambda: runner.run(CONTROL_ROUNDS))
    peak = torch.cuda.max_memory_allocated()
    out.update({
        "launches_per_round": launched // CONTROL_ROUNDS,
        "solves_per_round": 1,
        "segment_s_first": first, "round_s": steady / CONTROL_ROUNDS,
        "max_memory_allocated": peak,
        "losses": [r.train_loss for r in hist],
        "power_mean": powers, "rho_mean": [r.rho_mean for r in hist],
        "delta_mean": [r.delta_mean for r in hist],
        "test_acc": [r.test_acc for r in hist]})
    log(f"[control] paper width, LTFLScheme(recontrol_every=1), "
        f"rng/control='device', block fading, eval every "
        f"{CONTROL_EVAL_EVERY}: {CONTROL_ROUNDS} rounds in one segment, no "
        f"host sync inside, quantizer launches {launched} "
        f"({launched // CONTROL_ROUNDS} a round), {CONTROL_ROUNDS} solves, "
        f"losses {out['losses']}, power_mean {powers}, test_acc "
        f"{out['test_acc']}, segment_s first {first!r} steady {steady!r}, "
        f"max_memory_allocated={peak} bytes")
    if profile_dir is not None:
        profile_call(lambda: runner.run(2),
                     profile_dir / "profile_control_segment.txt",
                     "device-control segment (2 rounds)")
    del runner

    # host control: the numpy solve between one-round segments
    host = make(LTFLScheme(recontrol_every=1), rng="host",
                block_fading=True, eval_every=CONTROL_EVAL_EVERY)
    host.run(CONTROL_ROUNDS)
    out["host_control_round_s"] = _timed(
        lambda: host.run(CONTROL_ROUNDS)) / CONTROL_ROUNDS
    del host
    torch.cuda.empty_cache()
    out["device_vs_host_control"] = (out["host_control_round_s"]
                                     / out["round_s"])
    log(f"[control] paper width, steady s a round: device control "
        f"{out['round_s']!r}, host control (rng='host', one-round "
        f"segments) {out['host_control_round_s']!r}")

    # FedSGD (no program): the same stream under both control modes
    with deterministic_cudnn():
        fed = {}
        for ctl in ("host", "device"):
            r = make(FedSGDScheme(), rng="device", control=ctl,
                     eval_every=2)
            fed[ctl] = list(r.run(CONTROL_FEDSGD_ROUNDS))
            del r
    acc_gap = 0.0
    for a, b in zip(fed["host"], fed["device"]):
        if a.train_loss != b.train_loss or a.received != b.received:
            fail(f"FedSGD host vs device control: round {a.round} loss "
                 f"{a.train_loss!r} vs {b.train_loss!r}")
        if math.isnan(a.test_acc) != math.isnan(b.test_acc):
            fail(f"FedSGD host vs device control: round {a.round} acc "
                 f"{a.test_acc} vs {b.test_acc}")
        if not math.isnan(a.test_acc):
            acc_gap = max(acc_gap, abs(a.test_acc - b.test_acc))
    if acc_gap > 1e-6:
        fail(f"FedSGD eval head vs evaluate(): {acc_gap}")
    out["fedsgd_eval_head_max_abs_err"] = acc_gap
    log(f"[control] FedSGD at paper width, {CONTROL_FEDSGD_ROUNDS} rounds, "
        f"rng='device': control 'host' and 'device' losses bitwise equal, "
        f"eval head vs evaluate() max abs {acc_gap!r}")

    out["solve"] = _solve_checks(model)
    out["sweep"] = _control_sweep()
    out["mlp"] = _control_mlp_timing()
    log(f"[control] {json.dumps(out)}")
    return out


def _solve_checks(model):
    """solve_dev on the card against the host controller.solve with the
    host's draws injected: the reference test's sizes and tolerances
    (the gate), then the paper's U = 30 and Table-2 budget (reported);
    then the solve's time and device events at that size."""
    import numpy as np
    import torch
    from repro_torch.configs import LTFLConfig
    from repro_torch.control import solve_dev
    from repro_torch.core import controller
    from repro_torch.core.channel import ChannelState

    pin = LTFLConfig(**PIN_LTFL)
    for seed in (0, 1, 2):
        state = ChannelState.sample(pin.wireless, 6, 40, 60,
                                    np.random.default_rng(seed))
        rsq = np.full(6, 1e-2 * PIN_PARAMS)
        host = controller.solve(pin, state, PIN_PARAMS, range_sq_sums=rsq,
                                rng=np.random.default_rng(seed + 100))
        dev = solve_dev(pin, state.to_arrays("cuda"), PIN_PARAMS,
                        torch.as_tensor(rsq, dtype=torch.float32,
                                        device="cuda"),
                        draws=host_bo_draws(seed + 100, pin.alt_max_iters,
                                            pin.bo_iters, 6))
        d = {k: v.cpu().numpy().astype(np.float64)
             for k, v in dev._asdict().items()}
        gaps = {"rho": float(np.max(np.abs(d["rho"] - host.rho))),
                "power_rel": float(np.max(np.abs(d["power"] / host.power
                                                 - 1.0))),
                "per": float(np.max(np.abs(d["per"] - host.per))),
                "gamma_rel": abs(float(d["gamma"]) / host.gamma - 1.0)}
        if not (gaps["rho"] <= 1e-5 and gaps["power_rel"] <= 1e-4
                and gaps["per"] <= 1e-6 and gaps["gamma_rel"] <= 1e-4
                and np.array_equal(d["delta"], host.delta)):
            fail(f"solve_dev on the card vs controller.solve, seed {seed}: "
                 f"{gaps}, delta {d['delta']} vs {host.delta}")
    log("[control] solve_dev on the card against controller.solve at the "
        "reference test's sizes (U=6, bo_iters 3, alt_max_iters 2, seeds "
        "0-2): rho atol 1e-5, delta equal, power rtol 1e-4, per atol "
        "1e-6, gamma rel 1e-4 hold")

    full = LTFLConfig()
    v = sum(int(np.prod(s.shape)) for s in model.param_specs().values())
    u = full.num_devices
    state = ChannelState.sample(full.wireless, u, full.samples_min,
                                full.samples_max, np.random.default_rng(0))
    t = time.time()
    host = controller.solve(full, state, v, rng=np.random.default_rng(100))
    host_s = time.time() - t
    draws = host_bo_draws(100, full.alt_max_iters, full.bo_iters, u)
    ch = state.to_arrays("cuda")
    dev = solve_dev(full, ch, v, draws=draws)
    d = {k: v_.cpu().numpy().astype(np.float64)
         for k, v_ in dev._asdict().items()}
    rsq = np.full(u, 1e-2 * v)
    feas = [bool(controller._evaluate(full, state, rsq, rho, delta, power,
                                      v)[1])
            for rho, delta, power in ((host.rho, host.delta, host.power),
                                      (d["rho"], d["delta"], d["power"]))]
    full_gaps = {
        "power_max_rel": float(np.max(np.abs(d["power"] / host.power
                                             - 1.0))),
        "rho_max_abs": float(np.max(np.abs(d["rho"] - host.rho))),
        "delta_equal_share": float(np.mean(d["delta"] == host.delta)),
        "gamma_rel": abs(float(d["gamma"]) / host.gamma - 1.0),
        "feasible_host": feas[0], "feasible_device": feas[1],
        "alternations_host": host.alternations,
        "alternations_device": int(d["alternations"]),
        "host_solve_s": host_s}
    log(f"[control] solve_dev on the card vs controller.solve at U={u}, "
        f"LTFLConfig() (bo_iters {full.bo_iters}, alt_max_iters "
        f"{full.alt_max_iters}), injected draws (reported, no gate): "
        f"{json.dumps(full_gaps)}")

    # the production path: draws from a generator on the card
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def solve():
        return solve_dev(full, ch, v, generator=g)

    solve_ms = cuda_ms(solve, 5)
    torch.cuda.synchronize()
    t = time.time()
    solve()
    torch.cuda.synchronize()
    wall = time.time() - t
    events = device_events(solve)
    timing = {"solve_ms": solve_ms, "solve_wall_s": wall,
              "device_events": events}
    log(f"[control] one solve_dev at U={u}, LTFLConfig(), generator draws: "
        f"{solve_ms!r} ms by CUDA events (5 calls), {wall!r} s wall, "
        f"{events} device events")
    return {"pin": "held", "full": full_gaps, **timing}


def _control_sweep():
    """Two device-control lanes (Table 2 and a 0.05 W power cap) at MLP
    width in one bucket under deterministic cuDNN: each lane bitwise its
    solo run, the cap binding in its lane."""
    import dataclasses
    import torch
    from repro_torch.configs import LTFLConfig
    from repro_torch.fed import LTFLScheme, ScanRunner, SweepSpec
    from repro_torch.models import MLP, MLPConfig
    rounds = 6
    train, test = edge_world(2048, 256)
    mlp = MLP(MLPConfig(hidden=(16,), downsample=4))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = mlp.init(gen)
    base = LTFLConfig(num_devices=16, samples_min=40, samples_max=60,
                      learning_rate=0.1, bo_iters=8, alt_max_iters=3)
    capped = dataclasses.replace(base, wireless=dataclasses.replace(
        base.wireless, p_max=0.05))

    def scheme():
        return LTFLScheme(recontrol_every=1)

    def make(ltfl):
        return ScanRunner(mlp, params, ltfl, train, test, scheme(),
                          batch_size=4, seed=0, eval_every=0, rng="device",
                          control="device", block_fading=True,
                          device="cuda")

    spec = SweepSpec.grid(schemes={"ltfl": scheme},
                          ltfls={"table2": base, "cap005": capped},
                          seeds=(0,))
    with deterministic_cudnn():
        parent = make(base)
        parent.segment_sync_debug = "error"
        try:
            hists = parent.run_sweep(spec, rounds)
        except RuntimeError as err:
            fail(f"control sweep: a host sync inside a segment: {err}")
        buckets = [b["lane_indices"] for b in parent._last_sweep_buckets]
        if buckets != [[0, 1]]:
            fail(f"control sweep: buckets {buckets}, want one of 2")
        lanes = parent._last_sweep_buckets[0]["lanes"]
        acct = 0.0
        for lane_spec, hist, lane in zip(spec.lanes, hists, lanes):
            solo = make(lane_spec.ltfl)
            h_solo = list(solo.run(rounds))
            where = f"control sweep lane {lane_spec.label}"
            same_host_fields(hist, h_solo, where)
            for x, y in zip(hist, h_solo):
                if x.train_loss != y.train_loss or x.gamma != y.gamma:
                    fail(f"{where}: round {x.round} loss {x.train_loss!r} "
                         f"gamma {x.gamma!r} vs its solo run's "
                         f"{y.train_loss!r} {y.gamma!r}")
                for f in ("delay", "energy"):
                    a, b = getattr(x, f), getattr(y, f)
                    acct = max(acct, abs(a - b) / abs(b))
                    if abs(a - b) > SWEEP_ACCOUNTING_REL * abs(b):
                        fail(f"{where}: round {x.round} {f} {a!r} vs "
                             f"{b!r}")
            if not all(torch.equal(t, solo.params[k])
                       for k, t in lane.params.items()):
                fail(f"{where}: final weights differ from its solo run's")
    cap = [r.power_mean for r in hists[1]]
    if max(cap) > 0.05 + 1e-6:
        fail(f"control sweep: the 0.05 W lane's power_mean {cap}")
    out = {"lanes": 2, "rounds": rounds,
           "accounting_max_rel_vs_solo": acct,
           "power_mean": {"table2": [r.power_mean for r in hists[0]],
                          "cap005": cap}}
    log(f"[control] sweep at MLP width (U=16, bo_iters 8, alt_max_iters 3),"
        f" 2 device-control lanes in one bucket under deterministic cuDNN: "
        f"each lane bitwise its solo run (losses, gamma, weights, host "
        f"fields), {json.dumps(out)}")
    return out


def _control_mlp_timing():
    """benchmarks/device_control.py's regime (MLP, batch 4, bo_iters 8,
    alt_max_iters 3, block fading, LTFLScheme(recontrol_every=1)): s a
    round of host control (rng='host', one-round segments, the numpy
    solve between them) and device control (one segment), min of 3 timed
    runs after a warm-up run, per cohort width."""
    import torch
    from repro_torch.configs import LTFLConfig
    from repro_torch.fed import LTFLScheme, ScanRunner
    from repro_torch.models import MLP, MLPConfig
    train, test = edge_world(2048, 256)
    mlp = MLP(MLPConfig(hidden=(16,), downsample=4))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = mlp.init(gen)
    rows = {}
    for u in CONTROL_MLP_CLIENTS:
        ltfl = LTFLConfig(num_devices=u, samples_min=40, samples_max=60,
                          learning_rate=0.1, bo_iters=8, alt_max_iters=3)
        row = {}
        for name, kw in (("host", {"rng": "host"}),
                         ("device", {"rng": "device",
                                     "control": "device"})):
            r = ScanRunner(mlp, params, ltfl, train, test,
                           LTFLScheme(recontrol_every=1), batch_size=4,
                           seed=0, eval_every=0, block_fading=True,
                           device="cuda", **kw)
            r.run(CONTROL_MLP_ROUNDS)
            row[name] = min(_timed(lambda: r.run(CONTROL_MLP_ROUNDS))
                            for _ in range(3)) / CONTROL_MLP_ROUNDS
        row["speedup"] = row["host"] / row["device"]
        rows[u] = row
    log(f"[control] MLP regime of benchmarks/device_control.py, s a round "
        f"(min of 3 x {CONTROL_MLP_ROUNDS} rounds): {json.dumps(rows)}")
    return rows


# --------------------------------------------------------------------------- #
# The buffered-async engine (phases 25-26)
# --------------------------------------------------------------------------- #
ASYNC_ROUNDS = 10                       # one segment a run
ASYNC_BUFFER = 15                       # K, half the paper's U = 30
ASYNC_CHURN = dict(p_depart=0.1, p_return=0.5, p_drop=0.05)
ASYNC_EQ_ROUNDS = 3                     # degenerate case and sweep lanes
ASYNC_SWEEP_SEEDS = (0, 1)
# benchmarks/async_engine.py's straggler regime
STRAGGLER_CLIENTS = (16, 32)
STRAGGLER_CPU = (5e6, 110e6)            # a 20x CPU-frequency spread
STRAGGLER_DEADLINE_FRAC = 0.35          # of the sync round's mean delay
STRAGGLER_ROUNDS = (30, 90)             # sync, async


def _async_checks(runner, hist, k: int, where: str) -> dict:
    """Per round: 0 < n_admitted <= K, received <= n_admitted, the
    logged (pre-reset) tau finite and non-negative; the final tau equal
    to a host replay of the logged admissions (0 exactly where the last
    admission was); some round admitting fewer than U."""
    import numpy as np
    u = runner.cohort_size
    if len(hist) != len(runner.async_history):
        fail(f"{where}: {len(hist)} records, {len(runner.async_history)} "
             f"async rows")
    tau = np.zeros(runner.population_size)
    for rec, arec in zip(hist, runner.async_history):
        n = arec["n_admitted"]
        if not (0 < n <= k) or rec.received > n:
            fail(f"{where}: round {rec.round} admitted {n} (K = {k}), "
                 f"received {rec.received}")
        t = arec["tau"]
        if not (np.all(np.isfinite(t)) and np.all(t >= 0.0)):
            fail(f"{where}: round {rec.round} tau {t.tolist()}")
        if not math.isfinite(rec.train_loss):
            fail(f"{where}: round {rec.round} loss {rec.train_loss}")
        cohort = (np.asarray(rec.cohort, np.int64) if rec.cohort
                  else np.arange(u))
        if not np.array_equal(t, tau[cohort]):
            fail(f"{where}: round {rec.round} logged tau {t.tolist()} vs "
                 f"the replay's {tau[cohort].tolist()}")
        tau[cohort] = np.where(arec["admitted"], 0.0, tau[cohort] + 1.0)
    final = runner.staleness
    if not np.array_equal(final, tau):
        fail(f"{where}: final tau {final.tolist()} vs the replay's "
             f"{tau.tolist()}")
    admitted = [a["n_admitted"] for a in runner.async_history]
    if not min(admitted) < u:
        fail(f"{where}: every round admitted all {u}")
    return {"n_admitted": admitted,
            "received": [r.received for r in hist],
            "staleness": [r.staleness for r in hist],
            "losses": [r.train_loss for r in hist],
            "delay": [r.delay for r in hist]}


def phase_async():
    """Phase 25: AsyncRunner at the paper's width under host rng, device
    rng with churn and device control, each a sync-free segment with 32
    quantizer launches a round; the degenerate case bitwise ScanRunner
    under both rng modes; an async sweep bucket of 2 seed lanes, each
    lane bitwise its solo run."""
    import numpy as np
    import torch
    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.core.delay_energy import device_round_delay_dev
    from repro_torch.fed import AsyncRunner, ChurnSpec, LTFLScheme, \
        ScanRunner
    from repro_torch.kernels.stochastic_quant import LAUNCHES
    from repro_torch.models import ResNet

    train, test = edge_world(20000, 2000)
    model = ResNet(ResNetConfig())
    n_leaves = len(model.param_specs())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    base = LTFLConfig()
    u = base.num_devices

    def make(cls, scheme, **kw):
        kw = {"batch_size": 50, "seed": 0, "eval_every": 0,
              "device": "cuda", **kw}
        return cls(model, params, base, train, test, scheme, **kw)

    # the deadline: midway between the fastest and the slowest device of
    # the first cohort under the synchronous engine's round-0 controls
    probe = make(ScanRunner, LTFLScheme(recontrol_every=ASYNC_ROUNDS))
    ctl = probe.scheme.controls(0)

    def dev(v):
        return torch.as_tensor(np.asarray(v, np.float32), device="cuda")
    t_u = device_round_delay_dev(
        base.wireless, probe.channel.to_arrays("cuda"),
        dev(probe.scheme.payload_bits(ctl)), dev(ctl.rho),
        dev(ctl.power)).cpu().numpy().astype(np.float64)
    deadline = float(0.5 * (t_u.min() + t_u.max()))
    del probe
    log(f"[async] first cohort's completion times {t_u.min()!r} .. "
        f"{t_u.max()!r} s under the synchronous controls: deadline "
        f"{deadline!r} s, buffer K = {ASYNC_BUFFER} of U = {u}")
    out = {"deadline_s": deadline, "buffer_size": ASYNC_BUFFER,
           "launches_per_round": {}, "modes": {}}

    modes = {
        "host": (dict(rng="host"),
                 lambda: LTFLScheme(recontrol_every=ASYNC_ROUNDS)),
        "device_churn": (dict(rng="device"),
                         lambda: LTFLScheme(recontrol_every=ASYNC_ROUNDS)),
        "device_control": (dict(rng="device", control="device",
                                block_fading=True),
                           lambda: LTFLScheme(recontrol_every=1)),
    }
    for name, (kw, scheme) in modes.items():
        churn = (ChurnSpec(**ASYNC_CHURN) if name == "device_churn"
                 else None)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runner = make(AsyncRunner, scheme(), deadline=deadline,
                      buffer_size=ASYNC_BUFFER, churn=churn, **kw)
        spans = runner._segment_spans(0, ASYNC_ROUNDS)
        if spans != [(0, ASYNC_ROUNDS)]:
            fail(f"async {name}: segments {spans}, want one")
        LAUNCHES["stochastic_quant"] = 0
        first = _timed(lambda: _sync_free_run(runner, ASYNC_ROUNDS,
                                              f"async {name}"))
        launched = LAUNCHES["stochastic_quant"]
        if launched != ASYNC_ROUNDS * n_leaves:
            fail(f"async {name}: {launched} quantizer launches in "
                 f"{ASYNC_ROUNDS} rounds, want {n_leaves} a round")
        row = _async_checks(runner, list(runner.history), ASYNC_BUFFER,
                            f"async {name}")
        steady = _timed(lambda: _sync_free_run(runner, ASYNC_ROUNDS,
                                               f"async {name}"))
        peak = torch.cuda.max_memory_allocated()
        events = device_events(lambda: runner.run(2))
        del runner
        # the synchronous engine in the same mode, for the time and the
        # memory beside it (a 2-round warm-up, then timed)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sync = make(ScanRunner, scheme(), **kw)
        sync.run(2)
        sync_s = _timed(lambda: sync.run(ASYNC_ROUNDS))
        sync_peak = torch.cuda.max_memory_allocated()
        sync_events = device_events(lambda: sync.run(2))
        del sync
        out["launches_per_round"][name] = launched // ASYNC_ROUNDS
        row.update({"segment_s_first": first,
                    "round_s": steady / ASYNC_ROUNDS,
                    "scan_round_s": sync_s / ASYNC_ROUNDS,
                    "async_vs_scan": steady / sync_s,
                    "max_memory_allocated": peak,
                    "scan_max_memory_allocated": sync_peak,
                    "device_events_2_rounds": events,
                    "scan_device_events_2_rounds": sync_events})
        out["modes"][name] = row
        log(f"[async] paper width {name} ({kw}, churn {churn}): "
            f"{ASYNC_ROUNDS} rounds in one segment, no host sync inside, "
            f"quantizer launches {launched} ({launched // ASYNC_ROUNDS} a "
            f"round), n_admitted {row['n_admitted']}, received "
            f"{row['received']}, staleness {row['staleness']}, losses "
            f"{row['losses']}, steady s a round {steady / ASYNC_ROUNDS!r} "
            f"(ScanRunner {sync_s / ASYNC_ROUNDS!r}), "
            f"max_memory_allocated={peak} bytes (ScanRunner {sync_peak}), "
            f"device events in 2 rounds {events} (ScanRunner "
            f"{sync_events})")

    with deterministic_cudnn():
        # deadline = inf, K = U, no churn: ScanRunner bitwise
        for mode in ("host", "device"):
            runs = []
            for cls in (ScanRunner, AsyncRunner):
                r = make(cls, LTFLScheme(recontrol_every=ASYNC_EQ_ROUNDS),
                         rng=mode)
                runs.append((r, list(_sync_free_run(
                    r, ASYNC_EQ_ROUNDS, f"async degenerate {mode}"))))
            (s, hs), (a, ha) = runs
            for x, y in zip(hs, ha):
                for f in ("train_loss", "delay", "energy", "gamma",
                          "received", "staleness"):
                    if getattr(x, f) != getattr(y, f):
                        fail(f"async degenerate rng={mode}: round "
                             f"{x.round} {f} {getattr(y, f)!r} vs "
                             f"ScanRunner's {getattr(x, f)!r}")
            if not all(torch.equal(v, a.params[k])
                       for k, v in s.params.items()):
                fail(f"async degenerate rng={mode}: weights differ from "
                     f"ScanRunner's")
            if any(d["n_admitted"] != u for d in a.async_history):
                fail(f"async degenerate rng={mode}: a round admitted "
                     f"fewer than U")
            del runs, s, a
        log(f"[async] AsyncRunner(deadline=inf, buffer_size=U, churn=None) "
            f"equals ScanRunner bitwise under both rng modes over "
            f"{ASYNC_EQ_ROUNDS} rounds (losses, delay, energy, gamma, "
            f"received, weights)")

        # an async bucket of 2 seed lanes (device rng, churn, deadline,
        # K): one launch per leaf per round, each lane its solo run
        kw = dict(rng="device", deadline=deadline, buffer_size=ASYNC_BUFFER,
                  churn=ChurnSpec(**ASYNC_CHURN))

        def scheme():
            return LTFLScheme(recontrol_every=ASYNC_EQ_ROUNDS)
        parent = make(AsyncRunner, scheme(), **kw)
        parent.segment_sync_debug = "error"
        LAUNCHES["stochastic_quant"] = 0
        try:
            hists = parent.run_sweep(list(ASYNC_SWEEP_SEEDS),
                                     ASYNC_EQ_ROUNDS, scheme_factory=scheme)
        except RuntimeError as err:
            fail(f"async sweep: a host sync inside a segment: {err}")
        finally:
            parent.segment_sync_debug = None
        sweep_launched = LAUNCHES["stochastic_quant"]
        buckets = parent._last_sweep_buckets
        if [b["lane_indices"] for b in buckets] != [[0, 1]]:
            fail(f"async sweep: buckets "
                 f"{[b['lane_indices'] for b in buckets]}, want one of 2")
        if sweep_launched != ASYNC_EQ_ROUNDS * n_leaves:
            fail(f"async sweep: {sweep_launched} quantizer launches in "
                 f"{ASYNC_EQ_ROUNDS} rounds, want {n_leaves} a round for "
                 f"the bucket")
        for seed, hist, lane in zip(ASYNC_SWEEP_SEEDS, hists,
                                    buckets[0]["lanes"]):
            solo = make(AsyncRunner, scheme(), seed=seed, **kw)
            h_solo = list(solo.run(ASYNC_EQ_ROUNDS))
            where = f"async sweep lane seed {seed}"
            same_host_fields(hist, h_solo, where)
            for x, y in zip(hist, h_solo):
                if x.train_loss != y.train_loss or \
                        x.staleness != y.staleness:
                    fail(f"{where}: round {x.round} loss/staleness "
                         f"{x.train_loss!r}/{x.staleness!r} vs its solo "
                         f"run's {y.train_loss!r}/{y.staleness!r}")
                for f in ("delay", "energy"):
                    a, b = getattr(x, f), getattr(y, f)
                    if abs(a - b) > SWEEP_ACCOUNTING_REL * abs(b):
                        fail(f"{where}: round {x.round} {f} {a!r} vs its "
                             f"solo run's {b!r}")
            for p, q in zip(lane.async_history, solo.async_history):
                if not (np.array_equal(p["admitted"], q["admitted"])
                        and np.array_equal(p["tau"], q["tau"])):
                    fail(f"{where}: round {p['round']} admissions or tau "
                         f"differ from its solo run's")
            if not all(torch.equal(v, solo.params[k])
                       for k, v in lane.params.items()):
                fail(f"{where}: final weights differ from its solo run's")
            del solo
        del buckets, hists, parent
    out["sweep_launches_per_round"] = sweep_launched // ASYNC_EQ_ROUNDS
    out["degenerate_bitwise"] = True
    out["sweep_lanes_bitwise_solo"] = True
    torch.cuda.empty_cache()
    log(f"[async] sweep bucket of {len(ASYNC_SWEEP_SEEDS)} seed lanes "
        f"(device rng, churn, deadline, K = {ASYNC_BUFFER}): quantizer "
        f"launches {sweep_launched} "
        f"({sweep_launched // ASYNC_EQ_ROUNDS} a round), each lane equals "
        f"its solo AsyncRunner (losses, admissions, tau, weights bitwise; "
        f"delay and energy within {SWEEP_ACCOUNTING_REL})")
    log(f"[async] {json.dumps(out)}")
    return out


def _time_to_acc(history, target: float):
    """(simulated s, round) at the first round reaching ``target``
    accuracy; (inf, -1) if none does."""
    for rec in history:
        if rec.test_acc >= target:
            return rec.cum_delay, rec.round
    return float("inf"), -1


def phase_straggler():
    """Phase 26: benchmarks/async_engine.py's straggler regime on the
    card: simulated time to a target accuracy, sync against async."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.configs import LTFLConfig, WirelessConfig
    from repro_torch.fed import AsyncRunner, FedSGDScheme, ScanRunner
    from repro_torch.models import MLP, MLPConfig
    warnings.filterwarnings("ignore", message="ScanRunner with eval_every=1")
    train, test = edge_world(2048, 256)
    mlp = MLP(MLPConfig(hidden=(16,), downsample=4))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = mlp.init(gen)
    wireless = WirelessConfig(cpu_min=STRAGGLER_CPU[0],
                              cpu_max=STRAGGLER_CPU[1])
    rounds_sync, rounds_async = STRAGGLER_ROUNDS
    rows = []
    for clients in STRAGGLER_CLIENTS:
        ltfl = LTFLConfig(num_devices=clients, samples_min=40,
                          samples_max=60, learning_rate=0.1,
                          wireless=wireless)

        def make(cls, **kw):
            return cls(mlp, params, ltfl, train, test, FedSGDScheme(),
                       batch_size=4, seed=0, eval_every=1, device="cuda",
                       **kw)
        t0 = time.time()
        h_sync = make(ScanRunner).run(rounds_sync)
        sync_round = float(np.mean([r.delay for r in h_sync]))
        deadline = STRAGGLER_DEADLINE_FRAC * sync_round
        asyn = make(AsyncRunner, deadline=deadline,
                    buffer_size=clients // 2)
        h_async = asyn.run(rounds_async)
        wall = time.time() - t0
        if not all(math.isfinite(r.train_loss) for r in h_sync + h_async):
            fail(f"straggler U={clients}: a loss is not finite")
        target = max(r.test_acc for r in
                     h_sync[:max(1, 2 * rounds_sync // 3)])
        t_sync, r_sync = _time_to_acc(h_sync, target)
        t_async, r_async = _time_to_acc(h_async, target)
        rows.append({
            "clients": clients, "deadline_s": deadline,
            "buffer_size": clients // 2, "target_acc": target,
            "sync_time_s": t_sync, "async_time_s": t_async,
            "sync_round": r_sync, "async_round": r_async,
            "mean_admitted": float(np.mean(
                [d["n_admitted"] for d in asyn.async_history])),
            "ratio": (t_sync / t_async if math.isfinite(t_async)
                      else 0.0),
            "wall_s": wall})
    log(f"[straggler] benchmarks/async_engine.py's regime (MLP, batch 4, "
        f"CPU {STRAGGLER_CPU}, deadline {STRAGGLER_DEADLINE_FRAC} x the sync "
        f"round, K = U/2, {rounds_sync} sync vs {rounds_async} async "
        f"rounds, FedSGD), simulated seconds of the wireless model to the "
        f"target accuracy: {json.dumps(rows)}")
    return rows


REGISTRY_N = 1_000_000                  # population_scale.py --sharded's top N
REGISTRY_SHARDS = 8
REGISTRY_ROUNDS = 10                    # the checked first run, S = 1 and 8
REGISTRY_STEADY = 5                     # the timed second run
REGISTRY_ASYNC_ROUNDS = 5
REGISTRY_MLP_N = (10_000, 100_000, 1_000_000)
REGISTRY_MLP_U = 16
REGISTRY_MLP_ROUNDS = 10


def _gather_fault(runner, cohorts):
    """The first place where the cohort's gathered (U,) view or (U, W)
    rows differ from ``index_select`` on the concatenated blocks, or
    None."""
    import torch
    from repro_torch.core.channel import ChannelArrays
    from repro_torch.fed.population import gather_cohort_dev, \
        gather_parts_dev
    mesh, pop = runner._pop_mesh, runner._pop_dev
    table = torch.cat(runner._parts_padded)
    sizes = torch.cat(runner._part_sizes)
    try:
        for cohort in cohorts:
            view = gather_cohort_dev(mesh, pop.channel, cohort, runner.device)
            for f, got in zip(ChannelArrays._fields, view):
                whole = torch.cat([getattr(c, f) for c in pop.channel])
                if not torch.equal(got, torch.index_select(whole, 0,
                                                           cohort)):
                    return f"{f} at cohort {cohort.tolist()}"
            rows, sz = gather_parts_dev(mesh, runner._parts_padded,
                                        runner._part_sizes, cohort,
                                        runner.device)
            if not torch.equal(rows, torch.index_select(table, 0, cohort)):
                return f"index rows at cohort {cohort.tolist()}"
            if not torch.equal(sz, torch.index_select(sizes, 0, cohort)):
                return f"sizes at cohort {cohort.tolist()}"
    finally:
        del table, sizes
    return None


def phase_registry(deadline: float):
    """Phase 27: the registry in blocks (population_sharding) at N = 10^6:
    (a) the paper's width at S = 1 and S = 8 on one card against each
    other and the unsharded device registry; (b) the reference's sharded
    MLP regime over N; (c) AsyncRunner on the S = 8 registry."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import LTFLConfig, ResNetConfig
    from repro_torch.fed import AsyncRunner, ChannelAwareSampler, ChurnSpec, \
        FedSGDScheme, LTFLScheme, ScanRunner
    from repro_torch.fed import population as pop_mod
    from repro_torch.kernels.stochastic_quant import LAUNCHES
    from repro_torch.launch.sharding import population_mesh
    from repro_torch.models import ResNet

    train, test = edge_world(20000, 2000)
    model = ResNet(ResNetConfig())
    n_leaves = len(model.param_specs())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    base = LTFLConfig()
    u = base.num_devices
    meshes = {s: population_mesh(devices=["cuda:0"] * s)
              for s in (1, REGISTRY_SHARDS)}
    out = {"population": REGISTRY_N, "cohort": u, "shards": REGISTRY_SHARDS,
           "round_s": {}, "cold_start_s": {}, "max_memory_allocated": {}}

    def make(cls, sharding, **kw):
        # a cohort drawn anew every round makes LTFL re-solve every round
        # (its scan_recontrol_every is 1 under partial participation), so
        # the solve runs in the segment: control="device"
        t = time.time()
        runner = cls(model, params, base, train, test,
                     LTFLScheme(recontrol_every=SCAN_ROUNDS), batch_size=50,
                     seed=0, eval_every=0, device="cuda", rng="device",
                     control="device", block_fading=True,
                     population_size=REGISTRY_N, cohort_size=u,
                     cohort_sampler=ChannelAwareSampler(),
                     population_sharding=sharding, **kw)
        ctor = time.time() - t
        upload = _timed(runner._ensure_device_world)
        return runner, ctor + upload

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # (a) S = 1 and S = 8: a checked 10-round run, then a timed one
    runs = {}
    with deterministic_cudnn():
        for s in (1, REGISTRY_SHARDS):
            release()
            runner, cold = make(ScanRunner, meshes[s])
            uploads = runner._n_pop_uploads
            LAUNCHES["stochastic_quant"] = 0
            hist = list(_sync_free_run(runner, REGISTRY_ROUNDS,
                                       f"registry S={s}"))
            launched = LAUNCHES["stochastic_quant"]
            if launched != REGISTRY_ROUNDS * n_leaves:
                fail(f"registry S={s}: {launched} quantizer launches in "
                     f"{REGISTRY_ROUNDS} rounds, want {n_leaves} a round")
            if not all(math.isfinite(r.train_loss) for r in hist):
                fail(f"registry S={s}: losses {[r.train_loss for r in hist]}")
            steady = _timed(lambda: _sync_free_run(
                runner, REGISTRY_STEADY, f"registry S={s}"))
            if runner._n_pop_uploads != uploads or uploads != 1:
                fail(f"registry S={s}: {runner._n_pop_uploads} registry "
                     f"uploads after two runs (1 after set-up: {uploads})")
            pop = runner.population
            key = f"sharded_{s}"
            out["round_s"][key] = steady / REGISTRY_STEADY
            out["cold_start_s"][key] = cold
            out["max_memory_allocated"][key] = \
                torch.cuda.max_memory_allocated()
            if s == REGISTRY_SHARDS:
                out["launches_per_round"] = launched // REGISTRY_ROUNDS
                out["registry_bytes_per_block"] = [
                    sum(t.nbytes for t in ch) + fe.nbytes
                    for ch, fe in zip(runner._pop_dev.channel,
                                      runner._pop_dev.fading_epoch)]
                out["parts_bytes_per_block"] = [
                    t.nbytes + z.nbytes for t, z in zip(
                        runner._parts_padded, runner._part_sizes)]
                # the gathers against index_select on the whole registry:
                # the last cohort, one across every block, the edges
                cpu = torch.Generator()
                cpu.manual_seed(1)
                blk = REGISTRY_N // REGISTRY_SHARDS
                cohorts = [torch.tensor(hist[-1].cohort),
                           torch.sort(torch.randperm(
                               REGISTRY_N, generator=cpu)[:u]).values,
                           torch.tensor([0, blk - 1, blk, REGISTRY_N - 1])]
                cohorts = [c.to("cuda") for c in cohorts]
                bad = _gather_fault(runner, cohorts)
                if bad is not None:
                    fail(f"registry S={s}: gathered {bad} differs from "
                         "index_select on the concatenated blocks")
                # a planted fault (every block past the first reads the
                # next slot) must fail that check
                real = pop_mod._block_slots

                def shifted(cohort, mesh, blk, device):
                    return [sl._replace(slot=torch.clamp(
                        sl.slot + int(i > 0), max=blk - 1))
                        for i, sl in enumerate(real(cohort, mesh, blk,
                                                    device))]
                pop_mod._block_slots = shifted
                try:
                    planted = _gather_fault(runner, cohorts)
                finally:
                    pop_mod._block_slots = real
                if planted is None:
                    fail("registry: a planted fault in the block slots "
                         "passed the gather check")
                out["planted_fault_caught"] = planted
                del cohorts
            runs[s] = ([r.cohort for r in hist],
                       [r.train_loss for r in hist],
                       pop.channel.fading_mean.copy(),
                       pop.fading_epoch.copy(), pop.epoch)
            log(f"[registry] paper width S={s} at N={REGISTRY_N}: "
                f"{REGISTRY_ROUNDS} rounds in one sync-free segment, "
                f"quantizer launches {launched} "
                f"({launched // REGISTRY_ROUNDS} a round), registry "
                f"uploads {runner._n_pop_uploads} after 2 runs, losses "
                f"{[r.train_loss for r in hist]}, steady s a round "
                f"{steady / REGISTRY_STEADY!r}, cold start {cold!r} s, "
                f"max_memory_allocated="
                f"{out['max_memory_allocated'][key]} bytes")
            del runner, hist, pop
        (c1, l1, f1, e1, ep1), (c8, l8, f8, e8, ep8) = \
            runs[1], runs[REGISTRY_SHARDS]
        if c8 != c1:
            fail(f"registry: S=8 cohorts differ from S=1's: {c8} vs {c1}")
        if l8 != l1:
            fail(f"registry: S=8 losses {l8} vs S=1's {l1}")
        if not (np.array_equal(f8, f1) and np.array_equal(e8, e1)
                and ep8 == ep1):
            fail("registry: S=8 host fading or fading epochs differ "
                 "from S=1's")
        touched = int(np.count_nonzero(e8))
        out["devices_refreshed"] = touched
        out["s8_equals_s1"] = True
        log(f"[registry] S=8 equals S=1 bitwise over {REGISTRY_ROUNDS} rounds "
            f"(cohorts, losses, host fading_mean, fading_epoch: {touched} "
            f"devices refreshed, epoch {ep8}); gathered view and rows equal "
            f"index_select on the concatenated blocks; the planted fault "
            f"fails the check ({out['planted_fault_caught']}); bytes a block: "
            f"registry {out['registry_bytes_per_block'][0]}, index table "
            f"{out['parts_bytes_per_block'][0]}")
        # the unsharded device registry at the same N (another semantics:
        # all N redrawn each epoch; a time only)
        release()
        runner, cold = make(ScanRunner, None)
        _sync_free_run(runner, 2, "registry unsharded")
        out["round_s"]["unsharded"] = _timed(lambda: _sync_free_run(
            runner, REGISTRY_STEADY, "registry unsharded")) / REGISTRY_STEADY
        out["cold_start_s"]["unsharded"] = cold
        out["max_memory_allocated"]["unsharded"] = \
            torch.cuda.max_memory_allocated()
        del runner
        log(f"[registry] paper width at N={REGISTRY_N}, steady s a round: "
            f"{out['round_s']}; cold start s: {out['cold_start_s']}")

        # (c) AsyncRunner on the S = 8 registry
        release()
        asy, cold = make(AsyncRunner, meshes[REGISTRY_SHARDS],
                         deadline=deadline, buffer_size=ASYNC_BUFFER,
                         churn=ChurnSpec(**ASYNC_CHURN))
        # a round to warm up, as the ScanRunners' timed runs were second
        _sync_free_run(asy, 1, "registry async")
        LAUNCHES["stochastic_quant"] = 0
        t = _timed(lambda: _sync_free_run(asy, REGISTRY_ASYNC_ROUNDS,
                                          "registry async"))
        launched = LAUNCHES["stochastic_quant"]
        if launched != REGISTRY_ASYNC_ROUNDS * n_leaves:
            fail(f"registry async: {launched} quantizer launches in "
                 f"{REGISTRY_ASYNC_ROUNDS} rounds, want {n_leaves} a round")
        row = _async_checks(asy, list(asy.history), ASYNC_BUFFER,
                            "registry async")
        out["async"] = {"round_s": t / REGISTRY_ASYNC_ROUNDS,
                        "vs_sharded_scan": (t / REGISTRY_ASYNC_ROUNDS)
                        / out["round_s"][f"sharded_{REGISTRY_SHARDS}"],
                        "cold_start_s": cold, "n_admitted": row["n_admitted"],
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated()}
        out["async_launches_per_round"] = launched // REGISTRY_ASYNC_ROUNDS
        del asy
        log(f"[registry] AsyncRunner (K = {ASYNC_BUFFER}, deadline "
            f"{deadline!r} "
            f"s, churn {ASYNC_CHURN}) on the S={REGISTRY_SHARDS} registry: "
            f"{REGISTRY_ASYNC_ROUNDS} rounds sync-free, quantizer launches "
            f"{launched}, n_admitted {row['n_admitted']}, received "
            f"{row['received']}, s a round {t / REGISTRY_ASYNC_ROUNDS!r} "
            f"({out['async']['vs_sharded_scan']!r} x the sharded "
            f"ScanRunner's)")

    # (b) benchmarks/population_scale.py --sharded's regime
    release()
    mlp_train, mlp_test = edge_world(2048, 256)
    width = 8
    small = ResNet(ResNetConfig(stem_channels=width, group_channels=(
        width, width * 2, width * 2, width * 4)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    small_params = small.init(gen)
    ltfl = LTFLConfig(num_devices=REGISTRY_MLP_U, samples_min=40,
                      samples_max=60, learning_rate=0.15)
    rows = []
    for n in REGISTRY_MLP_N:
        t0 = time.time()
        r = ScanRunner(small, small_params, ltfl, mlp_train, mlp_test,
                       FedSGDScheme(), batch_size=16, seed=0, eval_every=0,
                       device="cuda", population_size=n,
                       cohort_size=REGISTRY_MLP_U,
                       cohort_sampler=ChannelAwareSampler(), rng="device",
                       population_sharding=meshes[REGISTRY_SHARDS],
                       block_fading=True)
        r._ensure_device_world()
        cold = time.time() - t0
        _sync_free_run(r, 2, f"registry mlp N={n}")
        per = min(_timed(lambda: r.run(REGISTRY_MLP_ROUNDS))
                  for _ in range(3)) / REGISTRY_MLP_ROUNDS
        rows.append({"population": n, "s_per_round": per,
                     "cold_start_s": cold})
        del r
    out["mlp"] = {"rows": rows, "ratio_maxN_over_minN":
                  rows[-1]["s_per_round"] / rows[0]["s_per_round"]}
    log(f"[registry] population_scale.py --sharded regime (ResNet width 8, "
        f"pool 2048, batch 16, FedSGD, U = {REGISTRY_MLP_U}, S = "
        f"{REGISTRY_SHARDS}, {REGISTRY_MLP_ROUNDS}-round runs, min of 3): "
        f"{json.dumps(rows)}, N=10^6 / 10^4 "
        f"{out['mlp']['ratio_maxN_over_minN']!r}")
    release()
    log(f"[registry] {json.dumps(out)}")
    return out


HOST_STEPS = 3                          # phase 28: steps a variant
PLAIN_STEPS = 2                         # phase 28 (e)


def _tensors(tree):
    """The tensors of a nested dict / tuple (an optimizer state)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in _tensors(x)]


def _dc_variant(label: str, opt_name: str = "sgd", int8: bool = False):
    """Phase 9's run (``DatacenterRun``: granite-8b at its published
    widths, 2 layers, the launcher's defaults) with its step rebuilt by
    ``make_fl_train_step``: ``opt_name`` (sgd / momentum / adamw at the
    launcher's lr) and the int8 wire format. HOST_STEPS steps with the
    launch counts set to 0 just before them; on the int8 step the first
    step's levels are read back per leaf (dtype, min, max)."""
    import torch
    from repro_torch.core import ltfl_step
    from repro_torch.launch import train
    from repro_torch.optim import adamw, momentum, sgd
    args = train.build_parser().parse_args([])
    modules = kernel_modules("stochastic_quant", "block_prune")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = train.DatacenterRun(dc_arch(), args, "cuda")
    run.opt = {"sgd": sgd, "momentum": momentum, "adamw": adamw}[opt_name](
        args.lr)
    run.step_fn = ltfl_step.make_fl_train_step(
        run.model, run.opt, args.clients, prune_block=args.prune_block,
        prune_kind="block", int8_collective=int8)
    run.opt_state = run.opt.init(run.params)
    run.comp_state = run.step_fn.init_comp_state(run.params)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _tensors(run.opt_state))
    levels = []
    quantize_int8_clients = ltfl_step.quantize_int8_clients

    def record(g, rand):
        lv, sc = quantize_int8_clients(g, rand)
        levels.append((lv.dtype, lv.amin(), lv.amax()))
        return lv, sc

    for m in modules:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0
    records, per_step, last = [], [], {}
    for i in range(HOST_STEPS):
        if int8 and i == 0:
            ltfl_step.quantize_int8_clients = record
        try:
            records.append(run.step(i))
        finally:
            ltfl_step.quantize_int8_clients = quantize_int8_clients
        now = {k: v for m in modules for k, v in m.LAUNCHES.items()}
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last = now
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(v).all()) for v in run.params.values())
    for i, (m, got) in enumerate(zip(records, per_step)):
        log(f"[host] {label} step {i}: loss={m['loss']!r} "
            f"grad_norm={m['grad_norm']!r} "
            f"received={m['clients_received']!r} step_s={m['seconds']!r} "
            f"launches={got}")
        if not math.isfinite(m["loss"]):
            fail(f"{label} step {i}: loss {m['loss']}")
    if not finite:
        fail(f"{label}: non-finite weights after {HOST_STEPS} steps")
    del run
    torch.cuda.empty_cache()
    return {"records": records, "per_step": per_step, "peak": peak,
            "state_bytes": state_bytes,
            "levels": [(dt, int(lo), int(hi)) for dt, lo, hi in levels]}


def _static_quant_check(mats):
    """The static-bits entry points (``ops.quantize_dequantize_2d`` and
    ``stochastic_quant_static``) at each tileable leaf shape, float32 and
    bfloat16, bits 1, 2, 4, 8: one B1 launch a call, held to the plain
    version by phase 3's rules. Returns (calls, max f32 error, max bf16
    error)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.stochastic_quant import (
        LAUNCHES,
        stochastic_quant_static,
    )
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    calls, worst = 0, {}

    def row(lo, hi, n_levels):
        return torch.stack([lo, hi, torch.full((), float(n_levels),
                                               device="cuda")]).reshape(1, 3)

    for dtype in (torch.float32, torch.bfloat16):
        for name, (m, n) in mats.items():
            g = (torch.randn(m, n, generator=gen, device="cuda")
                 * 0.01).to(dtype)
            u = torch.rand(m, n, generator=gen, device="cuda")
            a = g.to(torch.float32).abs()
            lo, hi = a.min(), a.max()
            del a
            for b in (1, 2, 4, 8):
                where = f"static bits {b} {name} {(m, n)} {str(dtype)[6:]}"
                n0 = LAUNCHES["stochastic_quant"]
                q1 = ops.quantize_dequantize_2d(g, b, rand=u)
                n1 = LAUNCHES["stochastic_quant"]
                q2 = stochastic_quant_static(g, u, lo, hi, b)
                n2 = LAUNCHES["stochastic_quant"]
                if (n1 - n0, n2 - n1) != (1, 1):
                    fail(f"{where}: launches {(n1 - n0, n2 - n1)}, want "
                         f"one a call")
                calls += 2
                # ops' levels max(round(2^b) - 1, 1), the static 2^b - 1
                triples = [(g.reshape(1, -1), u.reshape(1, -1),
                            row(lo, hi, max(round(2.0 ** b) - 1, 1))),
                           (g.reshape(1, -1), u.reshape(1, -1),
                            row(lo, hi, 2 ** b - 1))]
                err, _, _ = quant_vs_plain(
                    triples, where, outs=[q1.reshape(1, -1),
                                          q2.reshape(1, -1)])
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                del q1, q2
            del g, u
    torch.cuda.empty_cache()
    return calls, worst[torch.float32], worst[torch.bfloat16]


def phase_host_leftovers(mats, dc_records, dc_peak):
    """Phase 28: the int8 wire format, momentum and AdamW on the
    datacenter path at granite-8b's published widths, card against CPU at
    small size, the static-bits quantizer, the plain step and the
    batched-serving example."""
    import os
    import torch
    from repro_torch.core import make_plain_train_step
    from repro_torch.launch import train
    from repro_torch.optim import sgd
    t0 = time.time()
    want = {"block_norms": 9, "apply_block_mask": 18}
    out = {}
    # (a) the int8 wire format, (b) momentum and AdamW
    for key, label, opt_name, int8, n_quant in (
            ("int8", "int8 wire format (sgd)", "sgd", True, 0),
            ("momentum", "momentum(0.05)", "momentum", False, 12),
            ("adamw", "adamw(0.05)", "adamw", False, 12)):
        r = _dc_variant(label, opt_name, int8)
        for i, got in enumerate(r["per_step"]):
            if got != {**want, "stochastic_quant": n_quant}:
                fail(f"{label} step {i}: launches {got}, want "
                     f"{ {**want, 'stochastic_quant': n_quant} }")
        out[key] = r
        log(f"[host] {label}: step_s={[m['seconds'] for m in r['records']]}"
            f" (phase 9's sgd step: "
            f"{[m['seconds'] for m in dc_records]}), "
            f"max_memory_allocated={r['peak']} bytes (phase 9: {dc_peak}), "
            f"optimizer state {r['state_bytes']} bytes")
    lv = out["int8"]["levels"]
    if len(lv) != 12 or any(dt != torch.int8 or lo < -127 or hi > 127
                            for dt, lo, hi in lv):
        fail(f"int8 levels off: {lv}")
    log(f"[host] int8 levels of the first step, 12 leaves: dtype int8, "
        f"min {min(l[1] for l in lv)}, max {max(l[2] for l in lv)}")
    # (c) card against CPU at small size
    phase_small_datacenter("granite-8b", (torch.float32,), "int8")
    phase_small_datacenter("granite-8b", (torch.float32,), "adamw")
    # (d) the static-bits quantizer
    calls, f32_err, bf16_err = _static_quant_check(mats)
    log(f"[host] static-bits quantizer: {calls} calls ({len(mats)} leaf "
        f"shapes x f32/bf16 x bits 1/2/4/8 x 2 entry points), one launch "
        f"each; f32 max_abs_err {f32_err!r} (bitwise), bf16 {bf16_err!r}")
    # (e) the plain step on one global batch of 8 x 128
    args = train.build_parser().parse_args([])
    run = train.DatacenterRun(dc_arch(), args, "cuda")
    batch = {k: v.reshape(-1, *v.shape[2:]) for k, v in run.batch.items()}
    step = make_plain_train_step(run.model, sgd(args.lr))
    before = all_launches()
    params, opt_state, plain = run.params, (), []
    for i in range(PLAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch, i)
        loss = float(m["loss"])
        plain.append((loss, time.perf_counter() - t1))
        if not math.isfinite(loss):
            fail(f"plain step {i}: loss {loss}")
    if all_launches() != before:
        fail(f"the plain step launched kernels: {before} -> "
             f"{all_launches()}")
    log(f"[host] plain step, batch {tuple(batch['tokens'].shape)}: "
        f"(loss, s) {plain}, no kernel launch")
    del run, params, step
    torch.cuda.empty_cache()
    # (f) the batched-serving example at its defaults
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    proc = subprocess.run(
        [sys.executable, str(HERE / "examples" / "torch_serve_batched.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=HERE)
    lines = proc.stdout.strip().splitlines()
    rate = [l for l in lines if l.startswith("generated ")]
    if proc.returncode != 0 or len(rate) != 1 or "tok/s" not in rate[0]:
        fail(f"examples/torch_serve_batched.py: exit {proc.returncode}\n"
             f"{proc.stdout}{proc.stderr}")
    for line in lines:
        log(f"[host] example: {line}")
    tok_s = float(rate[0].split("(")[1].split()[0])
    log(f"[host] phase 28 in {time.time() - t0:.1f} s")
    return {"int8": out["int8"], "momentum": out["momentum"],
            "adamw": out["adamw"], "static_calls": calls,
            "static_f32_err": f32_err, "static_bf16_err": bf16_err,
            "plain": plain, "example_tok_s": tok_s}


DRYRUN_PAIRS = (
    ("granite-8b", "train_4k", [], "{}"),
    ("granite-8b", "train_4k", ["--multi-pod"], "{}"),
    ("granite-8b", "decode_32k", ["--test-mesh"], "{}"),
    ("whisper-medium", "prefill_32k", ["--test-mesh"], "{}"),
    ("granite-8b", "train_4k", ["--test-mesh"], '{"scan": 2}'),
)
LAUNCH_STEPS = 3                        # phase 29 (b): steps a variant
# phase 29 (d), remat on against off (relative), about ten times what
# the H100 80GB HBM3 (700 W) reads: the losses of steps 1-2 (1.2e-4 at
# most; stochastic levels flip where the bf16 gradients round apart), the
# first step's aggregate norm (2.8e-5), and the L2 of every weight after
# the last step (1.8e-4). A wrong recompute or VJP moves the norm by far
# more. The first loss, the forward's alone, is held bitwise.
REMAT_LOSS_REL = 1e-3
REMAT_NORM_REL = 3e-4
REMAT_WEIGHT_REL = 2e-3


def _start_dryruns(out_dir: Path):
    """Phase 29 (a)'s dry runs, each in its own process, started now."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = []
    for i, (arch, shape, flags, variant) in enumerate(DRYRUN_PAIRS):
        d = out_dir / f"pair{i}"
        procs.append((d, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, *flags, "--variant", variant,
             "--out", str(d)], env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _finish_dryruns(procs):
    records = []
    for (d, p), (arch, shape, flags, variant) in zip(procs, DRYRUN_PAIRS):
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"dry run {arch} x {shape} {flags} timed out")
        files = sorted(d.glob("*.json"))
        if p.returncode != 0 or "dry-run complete" not in out \
                or len(files) != 1:
            fail(f"dry run {arch} x {shape} {flags} {variant}: exit "
                 f"{p.returncode}\n{out}{err[-3000:]}")
        rec = json.loads(files[0].read_text())
        records.append(rec)
        log(f"[launch] dry run {rec['arch']} x {rec['shape']} on "
            f"{rec['mesh']} {rec['variant']}: fits_hbm={rec['fits_hbm']} "
            f"(80 GB) bytes_per_device={rec['bytes_per_device']!r} "
            f"flops_per_device={rec['flops_per_device']!r} "
            f"collectives={rec['collective_count']} "
            f"wire={rec['collective_wire_bytes']!r} "
            f"t_compute={rec['t_compute']!r} t_memory={rec['t_memory']!r} "
            f"t_collective={rec['t_collective']!r} "
            f"bottleneck={rec['bottleneck']} "
            f"useful={rec['useful_ratio']!r} run_s="
            f"{rec['compile_seconds']!r}")
    return records


def _step_launches(fn):
    """(result, {kernel: launches}) of ``fn()``, counted from 0."""
    modules = kernel_modules("stochastic_quant", "block_prune",
                             "block_sparse_matmul")
    for m in modules:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0
    out = fn()
    return out, {k: v for m in modules for k, v in m.LAUNCHES.items()}


def phase_launch_tooling(dc_records, dc_peak):
    """Phase 29: the dry run, the sharded step on a (1, 1) mesh against
    the plain step, the dry run against the card, and remat."""
    import gc
    import os
    import socket
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.ltfl_step import make_fl_train_step
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    t0 = time.time()
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_torch_"))
    procs = _start_dryruns(tmp)
    # (b) the sharded step on an NCCL world of one
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    except Exception as e:                                    # noqa: BLE001
        fail(f"NCCL world of one: {type(e).__name__}: {e}")
    args = train.build_parser().parse_args([])
    c = args.clients
    run = train.DatacenterRun(dc_arch(), args, "cuda")
    model = run.model
    rules = sh.base_rules(mesh, client_axes=("data",))
    psh = sh.param_shardings(mesh, model, rules)
    stacked = sh.stacked_shardings(mesh, model, rules, c, "client")
    gather = sh.stacked_shardings(mesh, model, rules, c, None)
    bsh = sh.batch_shardings(mesh, rules, run.batch, leading="client")
    dbatch = {k: sh.distribute(v, bsh[k]) for k, v in run.batch.items()}
    want = {"stochastic_quant": 12, "block_norms": 9, "apply_block_mask": 18,
            "block_sparse_matmul": 0, "block_sparse_matmul_wgmma": 0,
            "block_sparse_matmul_simt": 0}
    result = {}
    for int8 in (False, True):
        label = "int8" if int8 else "sgd"
        kw = dict(prune_block=args.prune_block, prune_kind="block",
                  int8_collective=int8)
        plain = make_fl_train_step(model, sgd(args.lr), c, **kw)
        sharded = make_fl_train_step(model, sgd(args.lr), c,
                                     param_shardings=stacked,
                                     gather_shardings=gather, **kw)
        p_plain = {k: v.clone() for k, v in run.params.items()}
        p_sh = {k: sh.distribute(v.clone(), psh[k])
                for k, v in run.params.items()}
        rows = []
        for i in range(LAUNCH_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p_plain, _, _, m_plain = plain(p_plain, (), (), run.batch,
                                           run.controls, i)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            (p_sh, _, _, m_sh), got = _step_launches(
                lambda: sharded(p_sh, (), (), dbatch, run.controls, i))
            torch.cuda.synchronize()
            sh_s = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated() - base
            w = {**want, "stochastic_quant": 0 if int8 else 12}
            if got != w:
                fail(f"sharded {label} step {i}: launches {got}, want {w}")
            loss, loss_plain = float(m_sh["loss"]), float(m_plain["loss"])
            if not math.isfinite(loss) or loss != loss_plain:
                fail(f"sharded {label} step {i}: loss {loss!r} vs plain "
                     f"{loss_plain!r}")
            diff = [k for k in p_plain
                    if not torch.equal(p_sh[k].to_local(), p_plain[k])]
            if diff:
                fail(f"sharded {label} step {i}: weights differ from the "
                     f"plain step's at {diff}")
            rows.append({"loss": loss, "step_s": sh_s, "plain_step_s":
                         plain_s, "launches": got, "peak_above_base": peak})
            log(f"[launch] sharded {label} step {i} on (1, 1): "
                f"loss={loss!r} (plain {loss_plain!r}, bitwise) weights "
                f"bitwise; step_s={sh_s!r} plain_step_s={plain_s!r} "
                f"launches={got}")
        result[label] = rows
    # (c) the dry run of (b)'s step against the card
    shape = ShapeConfig("phase9", args.seq_len, c * args.per_client_batch,
                        "train")
    built = dryrun_lib.build_train(
        dc_arch(), shape, mesh, {"prune_block": args.prune_block},
        n_clients=c)
    counts, _, meta_s = dryrun_lib.measure(built)
    sharded = make_fl_train_step(model, sgd(args.lr), c,
                                 prune_block=args.prune_block,
                                 prune_kind="block", param_shardings=stacked,
                                 gather_shardings=gather)
    p_sh = {k: sh.distribute(v.clone(), psh[k])
            for k, v in run.params.items()}
    real_param_bytes = sum(v.to_local().numel() * v.to_local().element_size()
                           for v in p_sh.values())
    real_args = real_param_bytes + sum(
        v.to_local().numel() * v.to_local().element_size()
        for v in dbatch.values()) + 4 * 4 * c + dryrun_lib.SEED_BYTES
    sharded(p_sh, (), (), dbatch, run.controls, 0)            # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        sharded(p_sh, (), (), dbatch, run.controls, 1)
    torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated() - base + real_args
    card_flops = fc.get_total_flops()
    if int(counts["flops"]) != card_flops:
        fail(f"dry-run FLOPs {counts['flops']!r} != FlopCounterMode's "
             f"{card_flops} on the card")
    if built.alias_bytes != real_param_bytes:
        fail(f"dry-run parameter bytes {built.alias_bytes} != the card's "
             f"{real_param_bytes}")
    step_s = min(r["step_s"] for r in result["sgd"][1:])
    t_compute = counts["flops"] / dryrun_lib.HW["peak_flops"]
    t_memory = counts["hbm_bytes"] / dryrun_lib.HW["hbm_bw"]
    log(f"[launch] dry run of (b)'s step at (1, 1) on meta ({meta_s:.2f} "
        f"s): flops {int(counts['flops'])} == FlopCounterMode on the card "
        f"{card_flops}; parameter bytes {built.alias_bytes} == "
        f"{real_param_bytes}; peak predicted {counts['peak_bytes']!r} "
        f"measured {measured_peak!r} (inputs + max_memory_allocated above "
        f"them), ratio {counts['peak_bytes'] / measured_peak!r}; "
        f"t_compute={t_compute!r} s t_memory={t_memory!r} s beside the "
        f"measured step {step_s!r} s")
    del p_sh, sharded
    dist.destroy_process_group()
    # (d) remat on and off, each from a fresh run with nothing of (b) and
    # (c) alive (its peak reads as phase 9's): the same weights, batch
    # and draws. The first loss is the forward's alone (bitwise); the
    # later losses, the first step's aggregate norm and the weights after
    # the last step hold the backward, where remat differs
    del p_plain, dbatch, m_plain, m_sh, plain, run, model
    gc.collect()
    torch.cuda.empty_cache()
    remat_rows, weights = {}, {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = train.DatacenterRun(dc_arch(), args, "cuda")
        if not remat:
            run.model = build_model(dc_arch(), remat=False)
            run.step_fn = make_fl_train_step(run.model, run.opt, c,
                                             prune_block=args.prune_block,
                                             prune_kind="block")
        recs = [run.step(i) for i in range(LAUNCH_STEPS)]
        remat_rows[remat] = {"loss": [r["loss"] for r in recs],
                             "grad_norm": [r["grad_norm"] for r in recs],
                             "step_s": [r["seconds"] for r in recs],
                             "peak": torch.cuda.max_memory_allocated()}
        weights[remat] = {k: v.to("cpu") for k, v in run.params.items()}
        del run, recs
        gc.collect()
    on, off = remat_rows[True], remat_rows[False]
    num = den = 0.0
    for k, w_off in weights[False].items():
        a = weights[True][k].to("cuda", torch.float32)
        b = w_off.to("cuda", torch.float32)
        num += float(torch.sum(torch.square(a - b)))
        den += float(torch.sum(torch.square(b)))
        del a, b
    del weights
    w_rel = math.sqrt(num / den)
    loss_rel = [abs(x - y) / abs(y) for x, y in zip(on["loss"], off["loss"])]
    norm_rel = abs(on["grad_norm"][0] - off["grad_norm"][0]) \
        / abs(off["grad_norm"][0])
    if on["loss"][0] != off["loss"][0]:
        fail(f"remat: first loss {on['loss'][0]!r} vs {off['loss'][0]!r} "
             "(the forward alone: bitwise)")
    if not (max(loss_rel) <= REMAT_LOSS_REL and norm_rel <= REMAT_NORM_REL
            and w_rel <= REMAT_WEIGHT_REL):
        fail(f"remat on vs off: losses {on['loss']} vs {off['loss']} (rel "
             f"{loss_rel}, limit {REMAT_LOSS_REL}), first aggregate norm "
             f"rel {norm_rel!r} (limit {REMAT_NORM_REL}), weights after "
             f"step {LAUNCH_STEPS - 1} rel {w_rel!r} (limit "
             f"{REMAT_WEIGHT_REL})")
    log(f"[launch] remat on: loss={on['loss']} grad_norm={on['grad_norm']} "
        f"step_s={on['step_s']} max_memory_allocated={on['peak']}; off: "
        f"loss={off['loss']} grad_norm={off['grad_norm']} "
        f"step_s={off['step_s']} max_memory_allocated={off['peak']} "
        f"(phase 9, remat on: {[r['seconds'] for r in dc_records]} s, "
        f"{dc_peak} bytes); loss rel {loss_rel} (first bitwise), first "
        f"aggregate norm rel {norm_rel!r}, weights after step "
        f"{LAUNCH_STEPS - 1} rel L2 {w_rel!r}")
    torch.cuda.empty_cache()
    records = _finish_dryruns(procs)
    log(f"[launch] phase 29 in {time.time() - t0:.1f} s")
    return {"steps": result, "dryrun": records,
            "flops": int(counts["flops"]),
            "peak_predicted": counts["peak_bytes"],
            "peak_measured": measured_peak, "remat": remat_rows}


def serve_arch(name: str):
    from repro_torch.configs import get_arch
    return get_arch(name)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    args = sys.argv[1:]
    profile_dir = None
    if "--profile" in args:
        i = args.index("--profile")
        if i + 1 >= len(args):
            fail("--profile needs a directory")
        profile_dir = Path(args[i + 1]).resolve()

    t_start = time.time()
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    def stamp(phases):
        log(f"[time] phase(s) {phases} done at "
            f"{time.time() - t_start:.1f} s")

    phase_build()
    shapes = leaf_shapes()
    if len(shapes) != 32:
        fail(f"paper-width ResNet has {len(shapes)} leaves, want 32")
    max_err = phase_kernel_vs_plain(shapes)
    phase_small_reference()
    launches = phase_main_path(profile_dir)
    t = phase_timing(shapes)
    stamp("1-6")
    mats = dc_matrices()
    if len(mats) != 9:
        fail(f"full-width granite-8b has {len(mats)} tileable leaves, "
             "want 9")
    norm_err, mask_err = phase_block_vs_plain(mats)
    phase_small_datacenter()
    dc_launches, dc_peak, dc_records = phase_datacenter(profile_dir)
    bt = phase_block_timing(mats)
    stamp("7-10")
    bsmm_err_small, bsmm_err, bsmm_launches, bsmm_other, bsmm_checks = \
        phase_bsmm_vs_plain()
    phase_baselines()
    st = phase_bsmm_timing()
    stamp("11-13")
    before = all_launches()
    phase_serve_small()
    serve_rows = phase_serve_full("granite-8b", SERVE_B, SERVE_B_CHECK,
                                  profile_dir)
    if serve_rows[0]["parameters"] != GRANITE_PARAMS:
        fail(f"granite-8b served with {serve_rows[0]['parameters']} "
             f"parameters, want {GRANITE_PARAMS}")
    for name in SERVE_FAMILIES[1:]:
        serve_rows += phase_serve_full(name, SERVE_C, SERVE_C_CHECK,
                                       profile_dir)
    if all_launches() != before:
        fail(f"the serving phases launched hand-written kernels: "
             f"{before} -> {all_launches()}")
    log(f"[serve] kernel launches unchanged by phases 14-16: {before}")
    stamp("14-16")
    # the datacenter step of the MoE, SSM, hybrid and encoder-decoder
    # families: small on the card against the CPU, then at published widths
    for name in DC_FAMILIES:
        phase_small_datacenter(name, (torch.float32,))
    family_launches = {}
    for name, (cut, n_want, want) in DC_FAMILIES.items():
        total, _, _ = phase_datacenter(profile_dir, name, cut, want, n_want)
        family_launches[name] = total
    stamp("17-18")
    before = all_launches()
    phase_serve_small(tuple(SERVE_D))
    for name, runs in SERVE_D.items():
        serve_rows += phase_serve_full(name, runs, SERVE_D_CHECK,
                                       profile_dir, f32_to_noise=True)
    if all_launches() != before:
        fail(f"the serving phases launched hand-written kernels: "
             f"{before} -> {all_launches()}")
    log(f"[serve] kernel launches unchanged by phases 19-20: {before}")
    log(f"[serve] summary {json.dumps(serve_rows)}")
    stamp("19-20")
    # the scanned engine and sweep lanes
    phase_scan_small()
    scan = phase_scan_main(profile_dir)
    sweep = phase_sweep()
    stamp("21-23")
    # the device control plane
    control = phase_control(profile_dir)
    stamp("24")
    # the buffered-async engine
    asy = phase_async()
    phase_straggler()
    stamp("25-26")
    # the registry in blocks at N = 10^6
    registry = phase_registry(asy["deadline_s"])
    stamp("27")
    # the host leftovers: int8 wire format, momentum / AdamW, static bits
    host = phase_host_leftovers(mats, dc_records, dc_peak)
    stamp("28")
    # the launch tooling: dry run, the sharded step, remat
    tooling = phase_launch_tooling(dc_records, dc_peak)
    stamp("29")
    log(f"[done] {time.time() - t_start:.1f} s")

    def per_family(key):
        return {name: t[key] for name, t in family_launches.items()}

    def host_launches(key):
        """Phase 28's launches a step (the first step's; all equal)."""
        return {v: host[v]["per_step"][0][key]
                for v in ("int8", "momentum", "adamw")}

    def tooling_launches(key):
        """Phase 29 (b)'s launches a step (the first step's; all equal)."""
        return {v: tooling["steps"][v][0]["launches"][key]
                for v in ("sgd", "int8")}

    def block_row(name, key, launches, err, extra):
        return {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_prune.cu",
            "replaces": {"block_norms": "src/repro/kernels/block_prune.py:31",
                         "apply_block_mask":
                         "src/repro/kernels/block_prune.py:52"}[name],
            "launches": launches,
            "max_abs_err": err,
            "ms": bt[f"{key}_step_kernel_ms"],
            "plain_ms": bt[f"{key}_step_plain_ms"],
            "bound_ms": bt[f"{key}_step_bound_ms"],
            "bound_by": bt[f"{key}_bound_by"],
            "library_ms": bt[f"{key}_step_library_ms"],
            "eager_ms": bt[f"{key}_step_kernel_eager_ms"],
            "plain_eager_ms": bt[f"{key}_step_plain_eager_ms"],
            "library_eager_ms": bt[f"{key}_step_library_eager_ms"],
            "largest_leaf_ms": bt[f"{key}_largest_kernel_ms"],
            "largest_leaf_plain_ms": bt[f"{key}_largest_plain_ms"],
            "largest_leaf_library_ms": bt[f"{key}_largest_library_ms"],
            "largest_leaf_bound_ms": bt[f"{key}_largest_bound_ms"],
            "family_datacenter_launches": per_family(name),
            "host_leftover_launches_per_step": host_launches(name),
            "sharded_step_launches_per_step": tooling_launches(name),
            **extra,
        }

    kernels = [{
        "name": "stochastic_quant",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stochastic_quant.cu",
        "replaces": "src/repro/kernels/stochastic_quant.py:59",
        "launches": launches,
        "datacenter_launches": dc_launches["stochastic_quant"],
        "family_datacenter_launches": per_family("stochastic_quant"),
        "max_abs_err": max(max_err,
                           sweep["quant_vs_plain"]["f32_max_abs_err"]),
        "max_abs_err_vs_plain": max_err,
        "ms": t["round_kernel_ms"],
        "kernel_ms": t["round_kernel_ms"],
        "plain_ms": t["round_plain_ms"],
        "bound_ms": t["round_bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "largest_leaf_ms": t["largest_kernel_ms"],
        "largest_leaf_plain_ms": t["largest_plain_ms"],
        "largest_leaf_bound_ms": t["largest_bound_ms"],
        "eager_ms": t["round_kernel_eager_ms"],
        "plain_eager_ms": t["round_plain_eager_ms"],
        "scan_launches_per_round": scan["launches_per_round"],
        "control_launches_per_round": control["launches_per_round"],
        "sweep_bucket_launches_per_round": sweep["launches_per_round"],
        "sweep_bucket_lanes": sweep["lanes"],
        "sweep_bucket_vs_plain": sweep["quant_vs_plain"],
        "async_launches_per_round": asy["launches_per_round"],
        "async_sweep_launches_per_round": asy["sweep_launches_per_round"],
        "sharded_launches_per_round": registry["launches_per_round"],
        "sharded_async_launches_per_round":
            registry["async_launches_per_round"],
        "static_bits_launches_per_call": 1,
        "static_bits_calls_checked": host["static_calls"],
        "static_bits_max_abs_err_f32": host["static_f32_err"],
        "static_bits_max_abs_err_bf16": host["static_bf16_err"],
        "host_leftover_launches_per_step": host_launches("stochastic_quant"),
        "sharded_step_launches_per_step":
            tooling_launches("stochastic_quant"),
    }, block_row("block_norms", "norms", dc_launches["block_norms"],
                 norm_err, {}),
        block_row("apply_block_mask", "mask",
                  dc_launches["apply_block_mask"], mask_err, {
                      "gate_ms": bt["gate_step_kernel_ms"],
                      "gate_plain_ms": bt["gate_step_plain_ms"],
                      "gate_library_ms": bt["gate_step_library_ms"],
                      "gate_bound_ms": bt["gate_step_bound_ms"],
                      "gate_eager_ms": bt["gate_step_kernel_eager_ms"],
                      "gate_largest_leaf_ms":
                          bt["gate_largest_kernel_ms"],
                  }), {
        "name": "block_sparse_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_sparse_matmul.cu",
        "replaces": "src/repro/kernels/block_sparse_matmul.py:45",
        "launches": bsmm_launches["block_sparse_matmul"],
        "edge_and_datacenter_launches": bsmm_other,
        "max_abs_err": bsmm_err,
        "max_abs_err_f32_reference_shapes": bsmm_err_small,
        "ms": st["kernel_ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
        "library_ms": st["library_ms"],
        "eager_ms": st["kernel_eager_ms"],
        "plain_eager_ms": st["plain_eager_ms"],
        "library_eager_ms": st["library_eager_ms"],
        "largest_leaf_ms": st["per_shape"]["embed.head"]["kernel_ms"],
        "largest_leaf_plain_ms": st["per_shape"]["embed.head"]["plain_ms"],
        "largest_leaf_library_ms":
            st["per_shape"]["embed.head"]["library_ms"],
        "largest_leaf_bound_ms": st["per_shape"]["embed.head"]["bound_ms"],
        "sharded_step_launches_per_step":
            tooling_launches("block_sparse_matmul"),
        "path": {"wgmma": bsmm_launches["block_sparse_matmul_wgmma"],
                 "simt": bsmm_launches["block_sparse_matmul_simt"]},
        "check_paths": bsmm_checks,
        "kernel_tflops": st["kernel_tflops"],
        "rho_sweep": [{key: r[key] for key in (
            "rho", "kernel_ms", "bound_ms", "dense_cublas_ms")}
            for r in st["rho_sweep"]],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
