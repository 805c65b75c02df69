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


#: the check, control, span-tracing and federation layers: imported only
#: when their knobs are set
LAYER_MODULES = (
    "check", "check.diagnostics", "check.directives", "check.closures",
    "check.effects", "check.config", "check.graph", "check.plane",
    "control", "control.policy", "control.rescale", "control.controller",
    "obs.trace", "obs.expo", "obs.federation", "obs.slo")

#: the row plane, portable checkpoints, the multi-process layout and the
#: dry run: imported by their users only
PLANE_MODULES = (
    "parallel.channel", "parallel.faults", "parallel.multihost",
    "parallel.plane", "recovery.portable", "dryrun")


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
        "from windflow_tpu_torch.apps import micro, pipe, spatial, ysb\n"
        "from windflow_tpu_torch.api import MultiPipe, builders\n"
        "from windflow_tpu_torch import PaneFarmGPU, WinMapReduceGPU\n"
        "from windflow_tpu_torch import check, control\n"
        "from windflow_tpu_torch.check import closures, config, effects\n"
        "from windflow_tpu_torch.check import directives, graph, plane\n"
        "from windflow_tpu_torch.control import controller, rescale\n"
        "from windflow_tpu_torch.obs import expo, trace\n"
        "from windflow_tpu_torch import parallel\n"
        "from windflow_tpu_torch.ops import mesh_reduce\n"
        "from windflow_tpu_torch.obs import federation, slo\n"
        "from windflow_tpu_torch.parallel import channel, faults\n"
        "from windflow_tpu_torch.parallel import multihost, plane\n"
        "from windflow_tpu_torch.recovery import portable\n"
        "from windflow_tpu_torch import dryrun\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    mods = json.loads(out.strip().splitlines()[-1])
    for m in ("patterns.win_seq_gpu", "patterns.native_core", "ops.resident",
              "ops.ring", "ops.gather", "ops.skyline", "utils.profile",
              "utils.latency", "apps.spatial", "api.multipipe",
              "api.builders", "apps.ysb", "apps.pipe", "apps.micro",
              "patterns.pane_farm", "patterns.win_mapreduce",
              "patterns.nesting", "obs.registry", "recovery.store",
              "runtime.overload", "parallel", "parallel.mesh",
              "ops.mesh_reduce", *LAYER_MODULES, *PLANE_MODULES):
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
        "assert gather._lib is None and skyline._lib is None\n"
        "from windflow_tpu_torch.ops import mesh_reduce\n"
        "p, c = mesh_reduce.sp_window_partial(r.view(-1), None, z, z + 3, 0,"
        " 'mean')\n"
        "mesh_reduce.sp_merge([p, p], [c, c], 'mean', ring=True)\n"
        "assert mesh_reduce._lib is None\n",
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


def forbidden_in_script(name: str) -> bool:
    """The port's scripts also keep off bench.py, which imports the JAX
    package."""
    return forbidden(name) or name == "bench" or name.startswith("bench.")


def _imported_names(tree):
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "scripts").glob("torch_*.py")))
def test_port_scripts_import_nothing_of_jax(path):
    """scripts/torch_*.py, the port's operator scripts: no import of JAX,
    the JAX package or bench.py, nor an exec'd child source naming one."""
    tree = ast.parse((REPO / path).read_text())
    names = _imported_names(tree)
    for node in ast.walk(tree):     # the children's sources, as strings
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and "import " in node.value and "\n" in node.value):
            try:
                names += _imported_names(ast.parse(node.value))
            except SyntaxError:
                pass
    assert "windflow_tpu_torch" in " ".join(names)
    assert [n for n in names if forbidden_in_script(n)] == []


def test_forbidden_in_script_matches_bench():
    assert forbidden_in_script("bench") and forbidden_in_script("jax")
    assert not forbidden_in_script("benchmarks")
    assert not forbidden_in_script("windflow_tpu_torch.apps.ysb")


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


def test_unset_knobs_import_no_layer():
    """check=, control=, trace= and federate= unset: a port pipeline's run
    imports none of the layer modules (the engine imports each lazily),
    nor the plane's."""
    out = run_isolated(
        "import json, sys\n"
        "import numpy as np\n"
        "from windflow_tpu_torch.api import MultiPipe\n"
        "from windflow_tpu_torch.core.tuples import Schema\n"
        "from windflow_tpu_torch.patterns.basic import Sink, Source\n"
        "def gen(sh):\n"
        "    sh.push(key=0, id=0, ts=0, value=1)\n"
        "got = []\n"
        "(MultiPipe('seed').add_source(Source(gen, Schema(value=np.int64)))\n"
        " .chain_sink(Sink(lambda b: got.append(b), vectorized=True))\n"
        " .run_and_wait_end())\n"
        "assert any(b is not None and len(b) for b in got)\n"
        "print(json.dumps(sorted(sys.modules)))\n", WF_LOG_DIR="")
    mods = set(json.loads(out.strip().splitlines()[-1]))
    assert "windflow_tpu_torch.runtime.engine" in mods
    assert [m for m in (*LAYER_MODULES, *PLANE_MODULES)
            if f"windflow_tpu_torch.{m}" in mods] == []
