"""Build a CUDA source of ``ops/csrc/`` into a shared library with ``nvcc``.

Every kernel of the port takes one route: a ``.cu`` file with a plain
``extern "C"`` interface, compiled for ``sm_90a`` into
``windflow_tpu_torch/_build/`` and loaded with ``ctypes`` by the module
that wraps it.  The build runs the first time a kernel is launched (never
at import), and the library's file name carries a hash of the source and
the flags, so an edited source is never served stale.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) — the port's CUDA kernels cannot be built")
    return found


def build(source: str) -> str:
    """Compile ``ops/csrc/<source>`` unless this exact source has been
    built already; returns the path of the shared library."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}-{tag.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so
