"""Build native sources of the port into ``build/`` beside the package.

Every shared library the port compiles (the host kernel-map code with
g++, the CUDA kernels with nvcc) lands in ``<checkout>/build/<kind>/``,
keyed by a hash of its source and flags, so a checkout builds what it
needs at first use and reuses it afterwards.  ``build/`` is gitignored.
Each build writes a temporary file and renames it into place, so
concurrent processes (pytest workers) never load a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import List

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build")

# flags of every CUDA kernel library (plain C interface, loaded by ctypes)
NVCC_FLAGS = ["-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    """Path of the CUDA compiler (PATH, then the toolkit's default)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def build_shared(src: str, kind: str, cmd_prefix: List[str],
                 flags: List[str]) -> str:
    """Compile ``src`` (a path under ``csrc/``) into a shared library.

    ``cmd_prefix`` is the compiler invocation (e.g. ``["g++"]``), ``flags``
    its options.  Returns the library path; the compiler's output of a
    successful build is kept beside it, in the library's path plus
    ``.log``.  Raises ``subprocess.CalledProcessError`` (with the
    compiler's output) on a failed build."""
    with open(src, "rb") as f:
        text = f.read()
    tag = hashlib.sha1(text + " ".join(cmd_prefix + flags).encode()
                       ).hexdigest()[:12]
    out_dir = os.path.join(BUILD_ROOT, kind)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(out_dir, f"{stem}_{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.run(cmd_prefix + flags + [src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(
                proc.returncode, proc.args, proc.stdout, proc.stderr)
        with open(f"{tmp}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(f"{tmp}.log", f"{so}.log")
        os.replace(tmp, so)
    return so
