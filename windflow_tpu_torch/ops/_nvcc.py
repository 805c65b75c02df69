"""Build a CUDA source of ``ops/csrc/`` into a shared library with ``nvcc``.

Every kernel of the port takes one route: a ``.cu`` file with a plain
``extern "C"`` interface (or several translation units linked into one
library, :func:`build_units`), compiled for ``sm_90a`` into
``windflow_tpu_torch/_build/`` and loaded with ``ctypes`` by the module
that wraps it.  The build runs the first time a kernel is launched (never
at import), and the library's file name carries a hash of the source and
the flags, so an edited source is never served stale.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: per library built by build_units in this process: each unit's compile
#: seconds and the link's (chip_smoke.py prints them)
UNIT_SECONDS = {}


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
    """Compile ``ops/csrc/<source>`` unless this exact source (and the
    local headers it includes) has been built already; returns the path of
    the shared library."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        text = f.read()
    tag = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode())
    for header in re.findall(rb'^#include "([^"]+)"', text, re.M):
        with open(os.path.join(CSRC, header.decode()), "rb") as f:
            tag.update(header + f.read())
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


def build_units(stem: str, units, headers=(), csrc: str = CSRC,
                out_dir: str = BUILD_DIR) -> str:
    """Compile the translation units `units` (``(source, flags)`` pairs of
    files in `csrc` and nvcc flags of their own; a source may come several
    times with other defines) into objects of relocatable device code (a
    unit may call device functions of another), one ``nvcc -c`` each, all
    started together, and link them into one shared library; `headers`
    are the files they include.  Returns the library's path; one of these
    exact sources and flags is not built again."""
    rdc = ["-rdc=true"]
    tag = hashlib.sha1(" ".join((*NVCC_FLAGS, *rdc)).encode())
    for name in sorted({u[0] for u in units} | set(headers)):
        with open(os.path.join(csrc, name), "rb") as f:
            tag.update(name.encode() + f.read())
    for source, flags in units:
        tag.update(f"{source} {' '.join(flags)};".encode())
    so = os.path.join(out_dir, f"lib{stem}-{tag.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + rdc
    objs = [f"{tmp}.{i}.o" for i in range(len(units))]

    def compile_unit(i):
        source, flags = units[i]
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *compile_flags, *flags, "-c", "-o",
                               objs[i], os.path.join(csrc, source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        return " ".join((source, *flags)), seconds, proc

    try:
        with ThreadPoolExecutor(len(units)) as pool:
            done = list(pool.map(compile_unit, range(len(units))))
        failed = [f"{unit}:\n{proc.stderr}" for unit, _s, proc in done
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed building " + "\n".join(failed))
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, *rdc, "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {so}:\n{proc.stderr}")
        UNIT_SECONDS[stem] = {**{unit: s for unit, s, _p in done},
                              "link": time.perf_counter() - t0}
        os.replace(tmp, so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return so
