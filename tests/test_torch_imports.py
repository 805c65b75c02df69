"""The port stands alone: importing windflow_tpu_torch loads neither JAX nor
the JAX package, and no module of the port names either in an import.
Note the port's own name starts with the string "windflow_tpu": the checks
match the module ``windflow_tpu`` and the prefix ``windflow_tpu.`` only."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "windflow_tpu_torch"


def forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".")
               for m in ("jax", "jaxlib", "windflow_tpu"))


def test_forbidden_matches_names_not_prefixes():
    assert forbidden("windflow_tpu") and forbidden("windflow_tpu.ops.device")
    assert forbidden("jax.numpy")
    assert not forbidden("windflow_tpu_torch")
    assert not forbidden("windflow_tpu_torch.ops.device")


def run_isolated(code: str, **env):
    """Run `code` in a fresh interpreter from the repo root."""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, **env})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_import_loads_no_jax_and_no_reference_package():
    out = run_isolated(
        "import json, sys\n"
        "import windflow_tpu_torch\n"
        "from windflow_tpu_torch.interop import carry_core_state\n"
        "from windflow_tpu_torch.interop import carry_resident_state\n"
        "from windflow_tpu_torch.ops import resident, ring, windowed_reduce\n"
        "from windflow_tpu_torch.ops import gather, skyline\n"
        "from windflow_tpu_torch.patterns import native_core\n"
        "from windflow_tpu_torch.utils import latency, profile\n"
        "from windflow_tpu_torch.apps import spatial\n"
        "from windflow_tpu_torch.api import MultiPipe\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    mods = json.loads(out.strip().splitlines()[-1])
    for m in ("patterns.win_seq_gpu", "patterns.native_core", "ops.resident",
              "ops.ring", "ops.gather", "ops.skyline", "utils.profile",
              "utils.latency", "apps.spatial", "api.multipipe"):
        assert f"windflow_tpu_torch.{m}" in mods
    assert [m for m in mods if forbidden(m)] == []


def test_import_and_plain_versions_run_no_nvcc(tmp_path):
    """Importing the kernel modules, and running their plain versions on
    CPU tensors, starts no nvcc: the build happens at a kernel's first
    launch on a card.  A stand-in nvcc that records its calls proves it."""
    marker = tmp_path / "nvcc_called"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    nvcc.chmod(0o755)
    run_isolated(
        "import torch\n"
        "from windflow_tpu_torch.ops import ring, resident, windowed_reduce\n"
        "r = torch.zeros((2, 8), dtype=torch.int32)\n"
        "z = torch.zeros(2, dtype=torch.int32)\n"
        "ring.ring_append(r, torch.ones((2, 4), dtype=torch.int8), z)\n"
        "ring.ring_append_regular_sum(r, torch.zeros((2, 0), dtype=torch.int8),"
        " z, z, z + 3, 2, 1)\n"
        "windowed_reduce.windowed_reduce(r.view(-1), z, z + 2, 8, 'max')\n"
        "from windflow_tpu_torch.ops import gather, skyline\n"
        "t, m = gather.window_gather(r, z, z, z + 3, 8)\n"
        "skyline.skyline_windows(t.float(), t.float(), m)\n"
        "assert ring._lib is None and windowed_reduce._lib is None\n"
        "assert gather._lib is None and skyline._lib is None\n",
        CUDA_HOME=str(tmp_path), PATH=f"{nvcc.parent}:{os.environ['PATH']}")
    assert not marker.exists()


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("*.py")))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if forbidden(n)] == []


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert "windflow_tpu_torch" in " ".join(names)
    assert [n for n in names if forbidden(n)] == []


def test_default_device_raises_without_cuda():
    """Entry points run on the card: with no CUDA device visible,
    device=None raises instead of falling back to the CPU."""
    out = run_isolated(
        "import windflow_tpu_torch as wt\n"
        "try:\n"
        "    wt.WinSeqGPU(wt.Reducer('sum'), 4, 2,\n"
        "                 use_reduce_kernel=True).make_core()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n",
        CUDA_VISIBLE_DEVICES="")
    assert "raised: no CUDA device" in out
