"""The harness finds a cell's configuration, traffic, system and metric
readers by name; the open-loop schedule; the import check; the refusal
without a card."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness, pacing

ROOT = os.path.dirname(harness.HERE)
BENCH = harness.load_json(ROOT, "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    cell = harness.Cell(name, BENCH)
    assert cell.config["name"] == cell.spec["config"]
    pacing.check_mix(cell.mix)
    mod = harness.load_module(
        os.path.join(harness.HERE, "systems",
                     f"{cell.config['system']}.py"), "t_system")
    assert callable(mod.System)
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names and len(cell.per_layer) >= 1
    assert len(cell.end_to_end) >= 2
    for m in names:
        assert callable(cell.reader(m))
    moves = {m["moves"] for m in cell.per_layer}
    assert moves <= {m["name"] for m in cell.end_to_end}


def test_benchmark_json_names_files_that_exist():
    for c in BENCH["configs"]:
        cfg = harness.load_json(ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))


def test_unknown_cell_refused():
    with pytest.raises(SystemExit):
        harness.Cell("no_such.cell", BENCH)


def test_open_loop_times_each_chunk_from_when_it_was_due():
    now = [0.0]
    slept = []

    def clock():
        return now[0]

    def sleep(s):
        slept.append(s)
        now[0] += s

    def make(c, t):
        now[0] += 0.001            # making a chunk takes 1 ms
        return np.zeros(10)

    mix = {"loop": "open", "chunk": 10, "rate": 1000.0}   # 10 ms apart
    p = pacing.Paced(mix, make, 0.1, clock=clock, sleep=sleep)
    out = []
    for i, b in enumerate(p):
        out.append(b)
        if i == 3:
            now[0] += 0.035        # the pipeline holds chunk 3 for 35 ms
    assert len(out) == pacing.n_open_chunks(mix, 0.1) == 10
    assert p.due == pytest.approx([c * 0.01 for c in range(10)])
    lag = np.asarray(p.sent) - np.asarray(p.due)
    # on time (the chunk made in advance of its due time) until the stall,
    # then late by what the stall left over, whatever the pipeline does
    assert lag[:4] == pytest.approx([0.001, 0, 0, 0], abs=1e-12)
    assert lag[4] == pytest.approx(0.035 - 0.01 + 0.001)
    assert lag[5] == pytest.approx(lag[4] - 0.01 + 0.001)
    assert p.records == 100


def test_closed_loop_stops_at_the_window():
    now = [0.0]

    def make(c, t):
        now[0] += 0.01
        return np.zeros(4)
    p = pacing.Paced({"loop": "closed", "chunk": 4}, make, 0.05,
                     clock=lambda: now[0])
    assert len(list(p)) == 5 and p.records == 20


def test_ysb_chunk_from_the_pool_equals_the_events_made_anew():
    from windflow_tpu_torch import batch_from_columns
    from windflow_tpu_torch.apps import ysb
    from benchmark.systems.ysb import PERIOD, System
    cell = harness.Cell(BENCH["workloads"][0]["name"], BENCH)
    s = System(cell.config, {"chunk": 3 * PERIOD // 2}, 2 ** 33 + 9, "cpu")
    for c, t in [(0, 0.0), (1, 0.25), (7, 12.5), (2 ** 20, 3600.0)]:
        v = s.v0 + c * s.C + np.arange(s.C, dtype=np.int64)
        vm = v % 100000
        want = batch_from_columns(
            ysb.EVENT_SCHEMA, key=np.zeros(s.C, dtype=np.int64), id=v,
            ts=np.full(s.C, int(t * 1e6), dtype=np.int64),
            ad_id=vm % 1000, event_type=(vm % 3).astype(np.int8),
            revenue=vm % 97 + 1)
        got = s.make_chunk(c, t)
        assert got.dtype == want.dtype and (got == want).all()
        assert not np.shares_memory(got, s.pool)


def test_forbidden_modules_by_whole_top_level_name():
    assert harness.forbidden_modules(
        {"windflow_tpu_torch": 0, "windflow_tpu_torch.ops": 0,
         "jaxtyping": 0, "numpy": 0}) == []
    assert harness.forbidden_modules(
        {"windflow_tpu.ops.resident": 0, "jax.numpy": 0, "flax": 0,
         "jaxlib.xla": 0}) == ["flax", "jax", "jaxlib", "windflow_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(harness.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "windflow_tpu_torch" not in set(_imports(path)), path


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_refuses_in_a_directory_without_the_port(tmp_path):
    import shutil
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", str(2 ** 31 + 11), "--seconds", "3",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
