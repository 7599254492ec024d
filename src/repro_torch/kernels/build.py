"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

in ``_build/`` beside this file (listed in ``.gitignore``). The file name
carries a hash of the source and of every header in ``csrc/``
(``*.cuh``), so an edited source or header never loads a stale library;
the compile writes to a temporary name and renames it into place, so a
concurrent build never loads a half-written file. No driver library is
linked: a kernel that needs a driver call (``cuTensorMapEncodeTiled``)
reaches it through ``cudaGetDriverEntryPoint``. No
``--use_fast_math``: the kernels' exactness against their plain versions
depends on IEEE division and on no contraction into FMA. A missing
``nvcc``, a failed compile or a failed load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}

# Observers of what the kernels read: a wrapper calls ``note_reads``
# with the tensors its kernel reads, where it launches it and in its
# meta branch. No dispatched op shows those reads; the dry run's op
# counter (``launch.op_analysis.OpCounter``) listens here and adds their
# bytes (the kernel's output is counted where the wrapper allocates it).
READ_HOOKS: List[Callable] = []


def note_reads(name: str, *tensors) -> None:
    for hook in READ_HOOKS:
        hook(name, tensors)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the "
                       "card")


def source_digest(src: Path) -> str:
    """Hash of ``src`` and of every ``*.cuh`` beside it (name and bytes),
    the part of the library's file name that changes with the source."""
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:12]


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source
    exists. Returns (library path, compiler output; empty when cached)."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(src)
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)[0]))
    return _loaded[name]

