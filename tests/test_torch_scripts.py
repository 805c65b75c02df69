"""The port's operator scripts (scripts/torch_*.py), twins of the scripts
that drive the JAX package: the reference script tests run over the twins
(tests/test_check.py's self-lint and wf_lint CLI tests over the port's
corpus helpers tests/torch_*corpus*.py, the soak slices of
tests/test_recovery.py, test_control.py and test_overload.py, the rolling
restart of test_multihost_2proc.py), slow-marked exactly where the
reference's are; then what the twins add: soak_crash's cases drawn and
run as the reference's (the same params; the port's uncrashed rows equal
the same graph's through windflow_tpu, exactly), the native roll and the
sweeps on ``--device cpu``, wf_top's frame and exposition equal to the
reference's, and every device twin refusing to run without CUDA unless
asked for the CPU."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port's four bundled apps (tests/test_check.py's APP_MODULES)
APP_MODULES = tuple(f"windflow_tpu_torch.apps.{m}"
                    for m in ("ysb", "pipe", "spatial", "micro"))


@pytest.fixture(autouse=True)
def _no_ambient_obs_env(monkeypatch):
    """The lint runs pin exact diagnostic sets: an ambient WF_LOG_DIR
    would silence WF207, an ambient WF_SAMPLE_PERIOD plant it."""
    monkeypatch.delenv("WF_LOG_DIR", raising=False)
    monkeypatch.delenv("WF_SAMPLE_PERIOD", raising=False)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script(name):
    """scripts/<name>.py as a module."""
    return _load(os.path.join(REPO, "scripts", f"{name}.py"), name)


# ------------------------------------------------------------ self-lint

SOAK_TWINS = ("torch_soak_overload", "torch_soak_crash",
              "torch_soak_rescale", "torch_soak_wire",
              "torch_soak_handoff", "torch_wf_roll")


@pytest.mark.parametrize("name", SOAK_TWINS)
def test_soak_scripts_self_lint(name):
    """The soak/roll twins validate diagnostic-free through their
    wf_check_pipelines() hooks under the port's checker."""
    from windflow_tpu_torch.check import validate
    targets = _script(name).wf_check_pipelines()
    assert targets
    for target in targets:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            report = validate(target)
        assert len(report) == 0, f"{name}: {report.render()}"


# ------------------------------------------------------- wf-lint CLI twin

def _run(script, args, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    full.pop("WF_LOG_DIR", None)
    full.pop("WF_SAMPLE_PERIOD", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), *args],
        cwd=REPO, env=full, capture_output=True, text=True, timeout=300)


def _run_lint(args):
    return _run("torch_wf_lint.py", args)


def _corpus(name):
    return _load(os.path.join(REPO, "tests", f"{name}.py"), name)


def test_wf_lint_cli_corpus():
    """The CLI reports every planted diagnostic of the port's misconfig
    corpus and (under --error) exits nonzero."""
    r = _run_lint(["tests/torch_check_corpus.py", "--error"])
    assert r.returncode == 1, r.stdout + r.stderr
    corpus = _corpus("torch_check_corpus")
    assert corpus.PLANTED == _corpus("check_corpus").PLANTED
    for code in corpus.PLANTED:
        assert code in r.stdout, (
            f"{code} missing from CLI output:\n{r.stdout}\n{r.stderr}")


def test_wf_lint_cli_codes_equal_reference():
    """--json over each package's corpus: the twin reports the same WF
    codes, as often, as scripts/wf_lint.py over the JAX counterparts,
    and the --plane corpus likewise."""
    def codes(script, args):
        r = _run(script, [*args, "--json"])
        assert r.returncode == 0, r.stdout + r.stderr
        doc = json.loads(r.stdout)
        return doc["targets"], sorted(d["id"] for d in doc["diagnostics"])

    for port, ref in ((["tests/torch_check_corpus.py"],
                       ["tests/check_corpus.py"]),
                      (["--plane", "tests/torch_plane_corpus.py"],
                       ["--plane", "tests/plane_corpus.py"])):
        assert codes("torch_wf_lint.py", port) == codes("wf_lint.py", ref)


@pytest.mark.slow
def test_wf_lint_cli_apps_clean(tmp_path):
    """All four port apps lint clean through the CLI (exit 0 even with
    --error).  pipe's hook builds its farm on the card unless asked for
    the CPU, so here a module that asks for it stands in for
    windflow_tpu_torch.apps.pipe (chip_smoke.py's lint phase lints the
    app itself on the card).  Slow-marked as the reference's: the
    in-process self-lint (tests/test_torch_check.py) is the tier-1
    gate."""
    shim = tmp_path / "pipe_on_cpu.py"
    shim.write_text("from windflow_tpu_torch.apps import pipe\n\n\n"
                    "def wf_check_pipelines():\n"
                    "    return pipe.wf_check_pipelines(device='cpu')\n")
    mods = [m for m in APP_MODULES if not m.endswith(".pipe")]
    r = _run_lint(["--error", *mods, str(shim)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "5 graph(s), 0 diagnostic(s)" in r.stdout


def test_wf_lint_cli_pipe_as_it_is():
    """windflow_tpu_torch.apps.pipe lints as it is on a host without
    CUDA: its hook asks for no device, the check build resolves none, and
    the CLI exits 0 (also with --error) with the codes scripts/wf_lint.py
    reports over windflow_tpu.apps.pipe."""
    def codes(script, module, *extra):
        r = _run(script, [module, "--json", *extra],
                 CUDA_VISIBLE_DEVICES="")
        assert r.returncode == 0, r.stdout + r.stderr
        doc = json.loads(r.stdout)
        return doc["targets"], sorted(d["id"] for d in doc["diagnostics"])

    port = codes("torch_wf_lint.py", "windflow_tpu_torch.apps.pipe",
                 "--error")
    assert port == codes("wf_lint.py", "windflow_tpu.apps.pipe")
    assert port[0] == 1


def test_checked_pipe_still_needs_a_card_to_run(monkeypatch):
    """The check build's deferred placement does not reach a run: after
    validate() the pipe holds no built graph, and building it for a run
    on a host without CUDA raises as before."""
    import torch

    from windflow_tpu_torch.apps import pipe
    from windflow_tpu_torch.check import validate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    target = pipe.wf_check_pipelines()[0]
    assert len(validate(target)) == 0
    assert target._df is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        target._build()
    # on the CPU when asked, as before: the check keeps that build
    target = pipe.wf_check_pipelines(device="cpu")[0]
    assert len(validate(target)) == 0
    assert target._df is not None


def test_wf_lint_cli_plane_corpus():
    """--plane over the port's misconfigured 2-host spec reports the full
    planted WF22x + cross-host set; the minimally-fixed twin reports
    zero."""
    r = _run_lint(["--plane", "tests/torch_plane_corpus.py", "--error"])
    assert r.returncode == 1, r.stdout + r.stderr
    mod = _corpus("torch_plane_corpus")
    assert mod.PLANTED == _corpus("plane_corpus").PLANTED
    for code in mod.PLANTED:
        assert code in r.stdout, (
            f"{code} missing from --plane output:\n{r.stdout}\n{r.stderr}")

    r2 = _run_lint(["--plane", "tests/torch_plane_corpus_fixed.py",
                    "--error"])
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "0 diagnostic(s)" in r2.stdout


def test_wf_lint_cli_json():
    """--json emits one machine-readable document: every planted id of
    the port's corpus as {id, severity, module, target, message} records
    plus the target count."""
    r = _run_lint(["tests/torch_check_corpus.py", "--json"])
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["targets"] > 0
    recs = doc["diagnostics"]
    assert set(_corpus("torch_check_corpus").PLANTED) <= {
        d["id"] for d in recs}
    for d in recs:
        assert {"id", "severity", "module", "target", "message"} <= set(d)
    anchored = [d for d in recs if "file" in d]
    assert anchored and all(isinstance(d["line"], int) for d in anchored)


def test_wf_lint_cli_module_scan_fallback(tmp_path):
    """A manual-graph script over the port's Dataflow with NO
    wf_check_pipelines() hook is lintable: the fallback scan picks up the
    module-level Dataflow (a round-robin emitter over keyed state ->
    WF101)."""
    mod = tmp_path / "manual_graph.py"
    mod.write_text(textwrap.dedent("""
        import numpy as np
        from windflow_tpu_torch.core.tuples import Schema
        from windflow_tpu_torch.patterns.basic import _AccumulatorNode
        from windflow_tpu_torch.runtime.emitters import StandardEmitter
        from windflow_tpu_torch.runtime.engine import Dataflow

        S = Schema(value=np.int64)
        DF = Dataflow("manual")
        _em = DF.add(StandardEmitter(2, None, name="em"))
        _a = DF.add(_AccumulatorNode(lambda row, acc: None, None, S,
                                     "acc.0", rich=False))
        _b = DF.add(_AccumulatorNode(lambda row, acc: None, None, S,
                                     "acc.1", rich=False))
        DF.connect(_em, _a)
        DF.connect(_em, _b)
    """))
    r = _run_lint([str(mod), "--error"])
    assert r.returncode == 1, r.stdout + r.stderr
    assert "WF101" in r.stdout


def test_wf_lint_cli_exit2_contract():
    """Usage/import failures exit 2, distinct from 'findings' (1) and
    'clean' (0)."""
    assert _run_lint([]).returncode == 2
    assert _run_lint(["tests/no_such_module_xyz.py"]).returncode == 2
    # a module with no lintable targets is a usage error too
    assert _run_lint(["tests/oracle.py"]).returncode == 2


# ------------------------------------------------------------ soak slices

@pytest.mark.slow
def test_soak_crash_slice():
    """Small in-suite slice of scripts/torch_soak_crash.py."""
    mod = _script("torch_soak_crash")
    for case in range(8):
        mod.run_case(seed=11, case=case)


@pytest.mark.slow
def test_soak_crash_native_slice():
    """Small in-suite slice of `scripts/torch_soak_crash.py --native
    --device cpu`: crash differentials over the native core's state ABI
    and the ring kernels' plain versions.  A case that cannot reach the
    native core fails (the reference skips)."""
    mod = _script("torch_soak_crash")
    for case in range(4):
        mod.run_case_native(seed=11, case=case, device="cpu")


@pytest.mark.slow
def test_soak_rescale_slice():
    """Small in-suite slice of scripts/torch_soak_rescale.py."""
    mod = _script("torch_soak_rescale")
    total = 0
    for case in range(6):
        total += mod.run_case(seed=23, case=case)["rescales"]
    assert total > 0, "no rescale completed across the slice"


@pytest.mark.slow
def test_overload_soak_small():
    """A small slice of scripts/torch_soak_overload.py: randomized
    policies / capacities / poison patterns, all invariants conserved."""
    stats = _script("torch_soak_overload").run_soak(n=60, seed=123)
    assert stats["cases"] == 60
    assert stats["shed_cases"] > 0 and stats["poison_cases"] > 0


@pytest.mark.slow
def test_overload_soak_with_metrics(tmp_path):
    """The overload soak with the observability layer on: every
    conservation invariant holds with the sampler running, and the files
    it leaves are schema-valid with live samples showing occupancy."""
    from obs_schema import validate_event, validate_file, validate_sample
    d = str(tmp_path / "soakobs")
    stats = _script("torch_soak_overload").run_soak(
        n=25, seed=321, trace_dir=d, sample_period=0.01)
    assert stats["cases"] == 25 and stats["shed_cases"] > 0
    assert validate_file(os.path.join(d, "metrics.jsonl"),
                         validate_sample) >= 25
    assert validate_file(os.path.join(d, "events.jsonl"),
                         validate_event) > 0
    samples = [json.loads(line)
               for line in open(os.path.join(d, "metrics.jsonl"))]
    assert max(n["depth"] for s in samples for n in s["nodes"]) > 0
    assert max(n["shed"] for s in samples for n in s["nodes"]) > 0


# ------------------------------------------------------- rolling restarts

def test_rolling_restart_zero_loss(tmp_path):
    """scripts/torch_wf_roll.py's built-in differential: both worker
    processes rolled (drain -> seal -> hand-off -> restart with
    resume_epoch=) while the feeder emits; the merged outputs equal the
    uncrashed oracle."""
    out = _script("torch_wf_roll").run_roll(str(tmp_path), n_epochs=8)
    assert out["rolled"] == [1, 2]
    assert out["drains"] == 2
    assert out["epochs_sealed"] == 10


def test_rolling_restart_native_cores(tmp_path):
    """--native on the CPU at a small size: each worker holds a
    NativeResidentCore (the ring kernels' plain versions), rolled at
    epochs 5 and 11; the restarted process restores the sealed native
    blob and the merged rows equal the uncrashed run per key, in order,
    and the oracle's total."""
    out = _script("torch_wf_roll").run_native_roll(
        str(tmp_path), device="cpu", n_tuples=64 * 512)
    assert [r["sealed_epoch"] for r in out["rolls"]] == [5, 11]
    assert out["epochs_sealed"] == 18 and out["drains"] == 2
    assert out["total"] == out["oracle"] and out["per_key_identical"]
    assert all(r["restart_gap_s"] > 0 for r in out["rolls"])


# ------------------------------------- soak_crash against the reference

def _reference_rows(params, seed, case, native):
    """The case's uncrashed graph built through windflow_tpu (CPU JAX; the
    native case routes to the JAX package's NativeResidentCore), run to
    its end: (key, id, value) rows, sorted for a farm."""
    from windflow_tpu import (RecoveryPolicy, Reducer, Sink, Source,
                              WinFarm, WinSeq)
    from windflow_tpu.core.tuples import Schema
    from windflow_tpu.core.windows import WinType
    from windflow_tpu.patterns.win_seq_tpu import WinSeqTPU
    from windflow_tpu.runtime.engine import Dataflow
    from windflow_tpu.runtime.farm import build_pipeline

    p = params
    schema = Schema(value=np.int64)
    wt = WinType[p["win_type"]]
    batches = _script("soak_crash")._batches
    recovery = None
    if native:
        pattern = WinSeqTPU(Reducer("sum", "value"), p["win"], p["slide"],
                            wt, batch_len=p["batch_len"],
                            shards=p["shards"], name="w")
        if p["shards"] > 1:     # the script's pinned compare
            recovery = RecoveryPolicy(
                epoch_batches=p["epoch_batches"],
                max_restarts=len(p["kill_at"]) + 1, restart_backoff=0.005)
    elif p["farm"]:
        pattern = WinFarm(Reducer("sum", "value"), p["win"], p["slide"], wt,
                          pardegree=p["pardegree"], name="w")
    elif p["use_nic"]:
        pattern = WinSeq(lambda key, gwid, rows_: (int(rows_["value"].sum()),),
                         p["win"], p["slide"], wt, name="w",
                         result_fields={"value": np.int64})
    else:
        pattern = WinSeq(Reducer("sum", "value"), p["win"], p["slide"], wt,
                         name="w")
    out = []
    df = Dataflow(f"ref{case}", capacity=8, recovery=recovery)
    build_pipeline(df, [
        Source(batches=lambda i: batches(schema, p["n_batches"], p["rows"],
                                         p["n_keys"], seed + case),
               name="src"),
        pattern,
        Sink(lambda r: out.append((int(r["key"]), int(r["id"]),
                                   int(r["value"])))
             if r is not None else None, name="sink")])
    df.run_and_wait_end(timeout=300)
    return sorted(out) if not native and p["farm"] else out


@pytest.mark.parametrize("native", [False, True], ids=["host", "native"])
@pytest.mark.parametrize("case", range(4))
def test_soak_crash_matches_reference(case, native):
    """Seed 11: the twin draws the reference script's case (equal params),
    its crashed run equals its uncrashed run, and those uncrashed rows
    equal the same graph's through windflow_tpu, row for row."""
    ref, twin = _script("soak_crash"), _script("torch_soak_crash")
    report = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if native:
            want = ref.run_case_native(11, case)
            got = twin.run_case_native(11, case, device="cpu",
                                       report=report)
        else:
            want = ref.run_case(11, case)
            got = twin.run_case(11, case, report=report)
        assert got == want
        rows = _reference_rows(want, 11, case, native)
    assert report["oracle"] and report["oracle"] == rows


# ------------------------------------------------------ sweeps and YSB A/B

def _json_lines(out, prefix):
    rows = []
    for line in out.splitlines():
        if line.startswith(prefix):
            rows.append(json.loads(line[line.index(": {") + 2:]))
    return rows


@pytest.mark.parametrize("configs", ["sweep", "window", "proactive"])
def test_torch_sweep_cpu(configs, capsys):
    """A tiny --device cpu run of each config list: every per-run JSON
    line parses, its total equals the oracle, and the summary line holds
    every config's runs."""
    mod = _script("torch_sweep")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert mod.main(["--configs", configs, "0.032768", "1",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    runs = _json_lines(out, "round 0 ")
    assert len(runs) == len(mod.CONFIGS[configs])
    for row in runs + _json_lines(out, "warm-up"):
        assert row["total"] == row["oracle"] and row["windows"] > 0
    summary = json.loads(out.strip().splitlines()[-1])
    assert [r["cfg"] for r in summary["results"]] == mod.CONFIGS[configs]
    assert summary["tuples"] == 32768
    assert not any(k in os.environ for k in mod._ENV)


def test_torch_ab_ysb_cpu(capsys):
    """A tiny --device cpu A/B: both arms' deterministic checks equal the
    bincount oracle, and every round's JSON line parses with events and
    results."""
    mod = _script("torch_ab_ysb")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert mod.main(["1", "0.3", "2", "--device", "cpu",
                         "--check-events", "65536"]) == 0
    out = capsys.readouterr().out
    checks = {v: _json_lines(out, f"check {v}:") for v in ("kf", "kf-gpu")}
    assert all(len(c) == 1 and c[0]["oracle_match"]
               for c in checks.values())
    assert checks["kf"] == checks["kf-gpu"]
    for v in ("kf", "kf-gpu"):
        (row,) = _json_lines(out, f"round 0 {v}:")
        assert row["generated"] > 0 and row["results"] > 0


# ------------------------------------------------------------- wf_top twin

def test_wf_top_twin_frame_and_expo_equal_reference(tmp_path):
    """wf_top's twin renders the reference's frame (--once) and the
    port's exposition equals the reference's (--expo) for the same
    metrics files, written by a port dataflow's sampler."""
    import windflow_tpu_torch as wt
    d = str(tmp_path / "obs")
    df = wt.Dataflow("top", trace_dir=d, sample_period=0.01)
    schema = wt.Schema(value=np.int64)
    batches = [wt.batch_from_columns(schema, key=np.arange(64) % 4,
                                     id=np.arange(64), ts=np.arange(64),
                                     value=np.arange(64))] * 20
    wt.build_pipeline(df, [wt.Source(batches=batches, schema=schema),
                           wt.WinSeq(wt.Reducer("sum"), 8, 4),
                           wt.Sink(lambda r: None, vectorized=True)])
    df.run_and_wait_end(timeout=60)
    for args in (["--once"], ["--expo"]):
        ref = _run("wf_top.py", [d, *args], TZ="UTC")
        twin = _run("torch_wf_top.py", [d, *args], TZ="UTC")
        assert ref.returncode == twin.returncode == 0, ref.stderr + \
            twin.stderr
        assert twin.stdout == ref.stdout and twin.stdout.strip()


# ---------------------------------------------------- device twins' gates

@pytest.mark.parametrize("args", [
    ["torch_soak_crash.py", "--native", "--n", "1"],
    ["torch_wf_roll.py", "--native", "--tuples", "4096"],
    ["torch_sweep.py", "--configs", "sweep", "0.01", "1"],
    ["torch_ab_ysb.py", "1", "0.1"],
], ids=["soak_crash", "wf_roll", "sweep", "ab_ysb"])
def test_device_twins_refuse_without_cuda(args):
    """With no CUDA device visible and no --device cpu, a device twin
    exits 2 and runs nothing."""
    r = _run(args[0], args[1:], CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no CUDA device visible" in r.stderr
    assert "OK" not in r.stdout and "round" not in r.stdout
