#!/usr/bin/env python3
"""Time variants of the block-sparse product's wgmma path on one card.

Each variant is ``csrc/block_sparse_matmul.cu`` with text replaced,
built by nvcc beside the kernel's own build
(``src/repro_torch/kernels/_build/variants/``) and called through the same
C entry point at granite-8b's 8 projection shapes (x of 1024 rows,
``chip_smoke.py``'s inputs and masks: rho 0.25, 128 x 128 blocks). Per
variant it prints the share of elements more than one bf16 ulp from the
plain version (the largest over the shapes), each shape's ms (CUDA events,
eager) and the 8 shapes' ms replayed from a CUDA graph; then dense bf16
cuBLAS on the pre-masked weights, and the card's name and power limit.

    python3 tools/bsmm_variants.py                 # every named variant
    python3 tools/bsmm_variants.py base stages_3   # some of them
    python3 tools/bsmm_variants.py 'mine=OLD=>NEW||OLD2=>NEW2'

Variants marked "timing only" compute a wrong product on purpose (they
drop copies or misread an operand) to show what bounds the kernel; their
shares are meaningless.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_COPY_X = ("          mbar_expect_tx(bar, C::kStageBytes);\n"
           "          tma_load_2d(a, &x_map, k, m0, bar);")
_COPY_XW = (_COPY_X + "\n"
            "          tma_load_2d(b, &w_map, n0, k, bar);\n"
            "          tma_load_2d(b + kBBoxBytes, &w_map, n0 + 64, k, bar);")

VARIANTS = {
    "base": [],
    # how often the tensor cores' partial sum goes to the float32 sum
    "promote_4": [("constexpr int kPromote = 2;",
                   "constexpr int kPromote = 4;")],
    "promote_never": [("constexpr int kPromote = 2;",
                       "constexpr int kPromote = 1 << 20;")],
    # the depth of the shared-memory ring (128-row tiles)
    "stages_3": [("NWG == 2 ? 5 : 4;", "NWG == 2 ? 3 : 4;")],
    "stages_4": [("NWG == 2 ? 5 : 4;", "NWG == 2 ? 4 : 4;")],
    "stages_6": [("NWG == 2 ? 5 : 4;", "NWG == 2 ? 6 : 4;")],
    # timing only: copy x (or x and w) for a tile's first 5 steps only
    "skip_x": [(_COPY_X,
                "          if (i < C::kStages) {\n" + _COPY_X +
                "\n          } else mbar_expect_tx(bar, kBBytes);")],
    "skip_w": [(_COPY_XW,
                "          if (i < C::kStages) {\n" + _COPY_XW +
                "\n          } else { mbar_expect_tx(bar, C::kABytes);\n"
                "          tma_load_2d(a, &x_map, k, m0, bar); }")],
    # timing only: read the w stage as K-major (transpose bit clear)
    "k_major_b": [("%64, %65, p, 1, 1, 0, 1;", "%64, %65, p, 1, 1, 0, 0;"),
                  ("smem_desc(b + kk * 2048, kBBoxBytes, 1024)",
                   "smem_desc(b + kk * 32, 16, 1024)")],
}


def parse(spec: str):
    """NAME (a named variant) or NAME=OLD=>NEW||OLD=>NEW..."""
    if "=" not in spec:
        return spec, VARIANTS[spec]
    name, reps = spec.split("=", 1)
    return name, [tuple(r.split("=>", 1)) for r in reps.split("||") if r]


def build_variant(name, reps, out_dir: Path):
    from repro_torch.kernels import build
    text = (build.CSRC / "block_sparse_matmul.cu").read_text()
    for old, new in reps:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    src = out_dir / f"bsmm_{name}.cu"
    src.write_text(text)
    lib = out_dir / f"libbsmm_{name}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import apply_block_mask_ref, \
        block_sparse_matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    specs = [parse(s) for s in (sys.argv[1:] or list(VARIANTS))]
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: build_variant(name, reps, out_dir) for name, reps in specs}
    fns = {}
    for name, (proc, lib) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{text}")
        regs = [ln.split("Used")[-1].strip() for ln in text.splitlines()
                if "registers" in ln]
        print(f"[build] {name}: {regs}", flush=True)
        fn = ctypes.CDLL(str(lib)).block_sparse_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        fns[name] = fn

    inputs = cs._bsmm_full_inputs(cs.bsmm_shapes(), torch.bfloat16, seed=17)
    live = {k: m.to(torch.uint8).contiguous() for k, (_, _, m) in inputs.items()}
    outs = {k: torch.empty(x.shape[0], w.shape[1], dtype=torch.bfloat16,
                           device="cuda") for k, (x, w, _) in inputs.items()}

    def launch(fn, k):
        x, w, _ = inputs[k]
        path = ctypes.c_int(-1)
        err = fn(x.data_ptr(), w.data_ptr(), live[k].data_ptr(),
                 outs[k].data_ptr(), x.shape[0], w.shape[1], x.shape[1],
                 128, 128, 1, torch.cuda.current_stream().cuda_stream,
                 ctypes.byref(path))
        if err != 0 or path.value != 1:
            raise SystemExit(f"launch failed: error {err}, path {path.value}")

    for name, fn in fns.items():
        row = {"ms": {}, "share": 0.0}
        for k, (x, w, m) in inputs.items():
            launch(fn, k)
            ref = block_sparse_matmul_ref(x, w, m, 128, 128)
            diff = (outs[k].float() - ref.float()).abs()
            share = float((diff > cs._bf16_ulp(ref.float())).float().mean())
            row["share"] = max(row["share"], share)
            row["ms"][k] = cs.cuda_ms(lambda: launch(fn, k), 10)
            del ref, diff

        def all_shapes():
            for k in inputs:
                launch(fn, k)

        row["graph_ms_8"] = cs.graph_ms(all_shapes, 10)
        print(f"[variant] {name}: {json.dumps(row)}", flush=True)
    masked = {k: apply_block_mask_ref(w, m, 128, 128)
              for k, (_, w, m) in inputs.items()}

    def dense():
        for k, (x, _, _) in inputs.items():
            torch.matmul(x, masked[k])

    print(f"[variant] dense bf16 cuBLAS: graph_ms_8 "
          f"{cs.graph_ms(dense, 10)!r}", flush=True)
    print(cs.card_line())


if __name__ == "__main__":
    main()
