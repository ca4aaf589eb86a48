"""Build and load the hand-written CUDA kernels.

Each source in tac_torch/csrc/ compiles with nvcc into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries go to tac_torch/_build/, named by a
hash of the source and the flags: a changed source builds anew at first
use, an unchanged one loads as is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# kernel name -> (source, extra flags). water_fill's decisions compare
# smr - DEC[m] bit for bit with the reference: no multiply-add contraction.
KERNELS = {
    "water_fill": ("water_fill.cu", ["-fmad=false"]),
    "scatter_words": ("scatter_words.cu", []),
}

_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, else the PATH, else the toolkit's
    default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _command(name: str, out: str) -> list:
    src, extra = KERNELS[name]
    return [*ARCH, *BASE_FLAGS, *extra, "-o", out, os.path.join(CSRC, src)]


def library_path(name: str) -> str:
    src, extra = KERNELS[name]
    h = hashlib.sha256()
    with open(os.path.join(CSRC, src), "rb") as f:
        h.update(f.read())
    h.update(" ".join(ARCH + BASE_FLAGS + extra).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def start_build(name: str):
    """Start compiling one kernel. Returns (process, temporary output,
    library path); process is None when the library already exists.
    nvcc writes to the temporary file, which ``finish_build`` renames into
    place, so a reader never sees a partial library."""
    path = library_path(name)
    if os.path.exists(path):
        return None, None, path
    exe = nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([exe, *_command(name, tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def finish_build(proc, tmp: str, path: str, timeout: float = 600) -> str:
    """Wait for a build started by ``start_build``; returns nvcc's output
    (the -Xptxas -v register / shared-memory / spill lines)."""
    if proc is None:
        return ""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        os.unlink(tmp)
        raise
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {os.path.basename(path)}:\n{out}")
    os.replace(tmp, path)
    return out


def build_all() -> dict:
    """Compile every kernel in parallel (one nvcc per source, all started
    together). Returns {name: (seconds, nvcc output)}."""
    t0 = time.perf_counter()
    started = {name: start_build(name) for name in KERNELS}
    report = {}
    for name, build in started.items():
        out = finish_build(*build)
        report[name] = (time.perf_counter() - t0, out)
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build = start_build(name)
        finish_build(*build)
        lib = _loaded[name] = ctypes.CDLL(build[2])
    return lib
