"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. At first use
it is compiled with ``nvcc`` into a shared library under ``build/kernels/``
at the repository root (never at import), and loaded with ``ctypes``. The
library's file name carries a hash of the source and the flags, so an edit
rebuilds. Each kernel passes its own flags (``fleet_tick`` keeps
``-fmad=false`` to stay bitwise with its plain version).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: the target every kernel is built for: Hopper, with its ``a`` features
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: the flags of every kernel but ``fleet_tick`` (which adds -fmad=false):
#: a shared library with a plain C interface, and ptxas's report
FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")
#: dynamic shared memory one block may take on an H100 (227 KB)
MAX_SMEM = 232_448
#: the element-type codes the kernels' C interfaces take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: nvcc builds in this process, over all kernels
BUILDS = 0
#: nvcc's output of the last build of each source (ptxas's registers,
#: shared memory and spills), by source file name
BUILD_LOGS: dict[str, str] = {}


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are built from csrc/*.cu at first use")
    return found


def build(source: str, flags: tuple, force: bool = False) -> Path:
    """Compile ``csrc/<source>`` with ``flags`` into a shared library in
    ``build/kernels/`` and return its path. ``force`` rebuilds even when
    the library exists; nvcc's output is kept in ``BUILD_LOGS[source]``."""
    global BUILDS
    src = CSRC / source
    text = src.read_bytes()
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}-{tag}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source}:\n"
                           f"{BUILD_LOGS[source]}")
    os.replace(tmp, out)
    BUILDS += 1
    return out


def load(source: str, flags: tuple) -> ctypes.CDLL:
    """The built library of ``csrc/<source>``, built first if needed."""
    return ctypes.CDLL(str(build(source, flags)))
