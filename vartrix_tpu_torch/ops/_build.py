"""Builds the port's native libraries from the checkout's sources at first use.

Two shared libraries, both with a plain C interface loaded through ctypes:

  * the Smith-Waterman pair kernel, ``csrc/sw_pair.cu``, compiled by nvcc for
    Hopper (``sm_90a``);
  * the host BAM/matrix library, ``native/genomio.cpp`` at the repository
    root, compiled by g++ with the flags of ``native/build.sh``.

Outputs go to ``build/vartrix_tpu_torch/`` in the checkout, named by a hash
of the source and the flags so a changed source never loads a stale build.
Concurrent builders (test workers, a CLI run beside a test) serialise on a
file lock and publish with an atomic rename; the compiler's messages
(``-Xptxas -v`` for the kernel) are kept beside the library as ``.log``.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "vartrix_tpu_torch")

KERNEL_SRC = os.path.join(PKG_DIR, "csrc", "sw_pair.cu")
GENOMIO_SRC = os.path.join(REPO_ROOT, "native", "genomio.cpp")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel is built on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def _build(src: str, subdir: str, stem: str, flags: List[str],
           command) -> str:
    """Compile `src` once into BUILD_DIR/subdir; return the library path."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()
    out_dir = os.path.join(BUILD_DIR, subdir)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{stem}-{digest[:12]}.so")
    if os.path.exists(out):
        return out
    with open(os.path.join(out_dir, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        with open(out[:-3] + ".log", "w") as log:
            log.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"building {os.path.basename(src)} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def kernel_library() -> str:
    """Path of the compiled CUDA pair kernel (built on first call)."""
    return _build(KERNEL_SRC, "", "libsw_pair", NVCC_FLAGS,
                  lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, KERNEL_SRC])


def genomio_library() -> str:
    """Path of the compiled host BAM/matrix library (built on first call)."""
    return _build(GENOMIO_SRC, "native", "libgenomio", GXX_FLAGS,
                  lambda tmp: ["g++", *GXX_FLAGS, GENOMIO_SRC, "-o", tmp, "-lz"])


def build_log(library: str) -> str:
    """The compiler's messages for a library built by this module."""
    path = library[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
