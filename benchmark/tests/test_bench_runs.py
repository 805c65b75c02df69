"""Whole runs of each cell on the CPU (the kernels' plain versions, small
chunks, a short window), past the harness's look for a card: a sound run
is correct, and a run with the timed path broken underneath is not, once
for each fault a cell can have (a one-card cell has no exchange between
cards to leave out)."""

import os
import tempfile
import time

import pytest

from benchmark import control, harness
from benchmark.reference import compare

BENCH = harness.load_json(os.path.dirname(harness.HERE), "BENCHMARK.json")
#: per configuration: the sizes a CPU test run can hold, its window, and
#: the key farm's flush (rows a replica ships at once), scaled with the
#: stream so that a window spans several launches as it does on the card
SMALL = {"ysb_kf": ({"chunk": 65536}, {"warm_chunks": 6, "win_sec": 1.0},
                    2.5, 1 << 12)}
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_run(name, monkeypatch, seed=2 ** 31 + 5):
    cell = harness.Cell(name, BENCH)
    mix, cfg, seconds, flush = SMALL[cell.spec["config"]]
    cell.mix.update({k: v for k, v in mix.items() if k in cell.mix})
    cell.config.update(cfg)
    if flush is not None:
        from windflow_tpu_torch.patterns import win_seq_gpu
        init = win_seq_gpu.KeyFarmGPU.__init__
        monkeypatch.setattr(
            win_seq_gpu.KeyFarmGPU, "__init__",
            lambda self, *a, **k: init(self, *a, **{"flush_rows": flush,
                                                    **k}))
    with tempfile.TemporaryDirectory() as scratch:
        run, readings, _ = harness.run_cell(cell, seed, seconds, True,
                                            "cpu", time.perf_counter(),
                                            scratch)
    return cell, run, readings


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, monkeypatch):
    cell, run, readings = small_run(name, monkeypatch)
    assert compare.passed(readings), readings
    assert readings["results"] == readings["expected"] > 0
    line = harness.result_line(cell, run, readings, 0, True, "cpu")
    assert line["correct"] and list(line)[-1] == "checks"
    # the host's layers read on the CPU; the device's need the card
    host = {m["name"] for m in cell.per_layer
            if m["source"] != "device_trace"}
    assert host and set(line["metrics"]) == host


def _state_unchanged(monkeypatch):
    from windflow_tpu_torch.ops import resident
    orig = resident.ring_append_eval
    monkeypatch.setattr(resident, "ring_append_eval",
                        lambda ring, *a, **k: orig(ring.clone(), *a, **k))


def _half_batch(monkeypatch):
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    orig = NativeResidentCore._process_rows
    monkeypatch.setattr(NativeResidentCore, "_process_rows",
                        lambda self, b: orig(self, b[: len(b) // 2]))


def _answer_altered(monkeypatch):
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    orig = NativeResidentCore._harvest

    def altered(self, harvested):
        out = orig(self, harvested)
        if len(out):
            out[out.dtype.names[-1]][0] += 1
        return out
    monkeypatch.setattr(NativeResidentCore, "_harvest", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    _, _, readings = small_run(name, monkeypatch)
    assert not compare.passed(readings), readings


@pytest.mark.parametrize("name,acc,correct", [
    ("ysb_kf.full", "int16", False), ("ysb_kf.full", "int32", True)])
def test_control_at_a_lower_precision(name, acc, correct):
    import numpy as np
    cell = harness.Cell(name, BENCH)
    mix, cfg, _, _ = SMALL[cell.spec["config"]]
    cell.mix.update({k: v for k, v in mix.items() if k in cell.mix})
    cell.config.update(cfg)
    r = control.readings(cell, 7, 4_000_000, 3.0, getattr(np, acc))
    assert compare.passed(r) is correct, r
