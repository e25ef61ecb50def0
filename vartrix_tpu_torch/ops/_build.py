"""Builds the port's native libraries from the checkout's sources at first use.

Six shared libraries, each with a plain C interface loaded through ctypes:

  * the CUDA kernels, ``csrc/sw_pair.cu`` (full Smith-Waterman),
    ``csrc/sw_banded.cu`` (banded Smith-Waterman) and ``csrc/band_build.cu``
    (the band bounds of ``--sw-mode banded``), each compiled by nvcc for
    Hopper (``sm_90a``);
  * the host BAM/matrix library, ``native/genomio.cpp`` at the repository
    root, compiled by g++ with the flags of ``native/build.sh``;
  * the host CRAM decoder, ``native/cramio.cpp``, compiled and linked as
    ``native/build.sh`` does (zlib, liblzma, libbz2's runtime soname); on a
    machine without liblzma's development files, against the declaration
    in ``csrc/compat/lzma.h`` and liblzma's runtime soname;
  * the host reference of the band bounds, ``csrc/band_bounds.cpp``,
    compiled by g++ with the same flags (tests and chip_smoke.py only).

Outputs go to ``build/vartrix_tpu_torch/`` in the checkout, named by a hash
of the source and the flags so a changed source never loads a stale build.
Concurrent builders (test workers, a CLI run beside a test) serialise on a
file lock and publish with an atomic rename; the command line and the
compiler's messages (``-Xptxas -v`` for the kernels) are kept beside the
library as ``.log``.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import List, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "vartrix_tpu_torch")

KERNEL_SRC = os.path.join(PKG_DIR, "csrc", "sw_pair.cu")
BANDED_KERNEL_SRC = os.path.join(PKG_DIR, "csrc", "sw_banded.cu")
BAND_BUILD_SRC = os.path.join(PKG_DIR, "csrc", "band_build.cu")
GENOMIO_SRC = os.path.join(REPO_ROOT, "native", "genomio.cpp")
CRAMIO_SRC = os.path.join(REPO_ROOT, "native", "cramio.cpp")
COMPAT_INCLUDE = os.path.join(PKG_DIR, "csrc", "compat")
BAND_BOUNDS_SRC = os.path.join(PKG_DIR, "csrc", "band_bounds.cpp")

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
           command, deps: Tuple[str, ...] = ()) -> str:
    """Compile `src` (which includes `deps`) once into BUILD_DIR/subdir;
    return the library path."""
    h = hashlib.sha1()
    for path in (src, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    digest = h.hexdigest()
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
        argv = command(tmp)
        proc = subprocess.run(argv, capture_output=True, text=True)
        with open(out[:-3] + ".log", "w") as log:
            log.write(" ".join(argv) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"building {os.path.basename(src)} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _cuda_library(src: str, stem: str) -> str:
    return _build(src, "", stem, NVCC_FLAGS,
                  lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, src])


def kernel_library() -> str:
    """Path of the compiled CUDA pair kernel (built on first call)."""
    return _cuda_library(KERNEL_SRC, "libsw_pair")


def banded_kernel_library() -> str:
    """Path of the compiled CUDA banded kernel (built on first call)."""
    return _cuda_library(BANDED_KERNEL_SRC, "libsw_banded")


def band_build_library() -> str:
    """Path of the compiled CUDA band builder (built on first call)."""
    return _cuda_library(BAND_BUILD_SRC, "libband_build")


def genomio_library() -> str:
    """Path of the compiled host BAM/matrix library (built on first call)."""
    return _build(GENOMIO_SRC, "native", "libgenomio", GXX_FLAGS,
                  lambda tmp: ["g++", *GXX_FLAGS, GENOMIO_SRC, "-o", tmp, "-lz"])


def _lzma_flags() -> List[str]:
    """How libcramio finds liblzma: its header where the compiler finds
    <lzma.h>, else csrc/compat/lzma.h; -llzma where the linker finds
    liblzma.so, else the runtime soname (as native/build.sh links
    libbz2)."""
    header = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                            input="#include <lzma.h>\n", capture_output=True,
                            text=True).returncode == 0
    found = subprocess.run(["g++", "-print-file-name=liblzma.so"],
                           capture_output=True, text=True).stdout.strip()
    return (([] if header else ["-I", COMPAT_INCLUDE])
            + ["-llzma" if os.path.isabs(found) else "-l:liblzma.so.5"])


def cramio_library() -> str:
    """Path of the compiled host CRAM decoder (built on first call); its
    log's first line is the command, include and link flags included."""
    lzma = _lzma_flags()
    libs = ["-lz", lzma[-1], "-l:libbz2.so.1"]
    return _build(CRAMIO_SRC, "native", "libcramio", GXX_FLAGS + lzma + libs,
                  lambda tmp: ["g++", *GXX_FLAGS, *lzma[:-1], CRAMIO_SRC,
                               "-o", tmp, *libs],
                  deps=(os.path.join(COMPAT_INCLUDE, "lzma.h"),))


def band_bounds_library() -> str:
    """Path of the compiled host band reference (built on first call)."""
    return _build(BAND_BOUNDS_SRC, "native", "libband_bounds", GXX_FLAGS,
                  lambda tmp: ["g++", *GXX_FLAGS, BAND_BOUNDS_SRC, "-o", tmp])


def build_log(library: str) -> str:
    """The compiler's messages for a library built by this module."""
    path = library[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
