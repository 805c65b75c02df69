"""Twin of scripts/soak_overload.py over the PyTorch/CUDA port
(windflow_tpu_torch): the same CLI, seeds, cases and output lines, with
every import taken from the port.

Seeded overload/poison soak: randomized fast-source -> map -> slow-sink
graphs under every backpressure policy (block / shed_oldest / shed_newest,
with and without put deadlines), with poison batches thrown at a
configurable error budget — asserting, per case, that the graph *degrades*
instead of dying or hanging and that the shed/quarantine accounting is
conserved (docs/ROBUSTNESS.md).

Mirrors the sweep-script pattern: standalone, seeded, and any failure is
reproducible in isolation:

    python scripts/torch_soak_overload.py --n 500 --seed 7        # the soak
    python scripts/torch_soak_overload.py --seed 7 --case 173     # one repro

The test suite runs a small slow-marked slice of this via
tests/test_torch_scripts.py (tier-1 excludes it with -m 'not slow').
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def run_case(seed: int, case: int, verbose: bool = False,
             trace_dir: str = None, sample_period: float = None) -> dict:
    """One randomized soak case; raises AssertionError (with the repro
    command in the message) on any invariant violation.

    ``trace_dir``/``sample_period`` opt the case's Dataflow into the
    observability layer (docs/OBSERVABILITY.md): the live sampler
    appends to ``<trace_dir>/metrics.jsonl`` while the case runs, which
    is how a soak under ``wf_top`` demonstrates in-flight occupancy and
    shedding.  Both also default from WF_LOG_DIR / WF_SAMPLE_PERIOD."""
    from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
    from windflow_tpu_torch.patterns.basic import Map, Sink, Source
    from windflow_tpu_torch.runtime.engine import Dataflow
    from windflow_tpu_torch.runtime.farm import build_pipeline
    from windflow_tpu_torch.runtime.overload import OverloadPolicy

    rng = np.random.default_rng((seed, case))
    shed = str(rng.choice(["block", "block", "shed_oldest", "shed_newest"]))
    put_deadline = (float(rng.uniform(2.0, 5.0))
                    if shed == "block" and rng.random() < 0.3 else None)
    capacity = int(rng.integers(2, 8))
    n_batches = int(rng.integers(5, 40))
    rows = int(rng.integers(8, 64))
    sink_delay = float(rng.choice([0.0, 0.0005, 0.002]))
    n_poison = int(rng.integers(0, 4))
    budget = int(rng.integers(0, 5))
    poison_at = set(rng.choice(n_batches, size=min(n_poison, n_batches),
                               replace=False).tolist())
    params = dict(shed=shed, put_deadline=put_deadline, capacity=capacity,
                  n_batches=n_batches, rows=rows, sink_delay=sink_delay,
                  poison_at=sorted(poison_at), budget=budget)
    repro = (f"python scripts/torch_soak_overload.py --seed {seed} "
             f"--case {case}")

    schema = Schema(value=np.int64)
    batches = []
    for i in range(n_batches):
        vals = np.full(rows, i, dtype=np.int64)
        if i in poison_at:
            vals = vals.copy()
            vals[0] = -1    # the poison marker the map trips on
        batches.append(batch_from_columns(
            schema, key=np.zeros(rows), id=np.arange(rows),
            ts=np.arange(rows), value=vals))

    map_seen = [0]
    sink_seen = [0]

    def poison_map(b):
        map_seen[0] += 1
        if (b["value"] < 0).any():
            raise ValueError(f"poison batch (case {case})")

    def consume(rowsb):
        if rowsb is not None and len(rowsb):
            sink_seen[0] += 1
            if sink_delay:
                time.sleep(sink_delay)

    df = Dataflow(f"soak{case}", capacity=capacity,
                  overload=OverloadPolicy(shed=shed,
                                          put_deadline=put_deadline,
                                          error_budget=budget),
                  trace_dir=trace_dir, sample_period=sample_period)
    build_pipeline(df, [
        Source(batches=batches, schema=schema),
        Map(poison_map, name="poison_map", vectorized=True),
        Sink(consume, vectorized=True)])

    t0 = time.monotonic()
    err = None
    try:
        df.run_and_wait_end()
    except Exception as e:  # noqa: BLE001 — classified below
        err = e
    wall = time.monotonic() - t0

    # ---- invariants -------------------------------------------------------
    ctx = f"{params} [{repro}]"
    assert wall < 60, f"case hung ({wall:.1f}s): {ctx}"
    shed_counts = df.shed_counts()
    quarantined = len(df.dead_letters)
    map_name = "poison_map.0"
    map_emitted = map_seen[0] - quarantined
    if shed == "block":
        # blocking policy never sheds; errors only from budget exhaustion
        # (or a genuinely expired deadline, which these sizes never hit)
        assert not shed_counts, f"block policy shed: {shed_counts} {ctx}"
        if len(poison_at) <= budget:
            assert err is None, f"in-budget poison raised {err!r}: {ctx}"
            assert quarantined == len(poison_at), \
                f"dead letters {quarantined} != poison {len(poison_at)}: {ctx}"
            assert sink_seen[0] == n_batches - quarantined, \
                f"sink saw {sink_seen[0]}: {ctx}"
        else:
            assert isinstance(err, ValueError), \
                f"budget exhausted but raised {err!r}: {ctx}"
    else:
        # shedding: conservation per inbox — every batch is delivered or
        # counted shed; poison that reaches the map is quarantined within
        # budget (an over-budget arrival fails the graph, also valid —
        # then the source stops early and conservation no longer applies)
        if err is None:
            assert map_seen[0] + shed_counts.get(map_name, 0) \
                == n_batches, \
                f"map conservation broke: {map_seen[0]} + " \
                f"{shed_counts.get(map_name, 0)} != {n_batches}: {ctx}"
            assert sink_seen[0] + shed_counts.get("sink.0", 0) \
                == map_emitted, \
                f"sink conservation broke: {sink_seen[0]} + " \
                f"{shed_counts.get('sink.0', 0)} != {map_emitted}: {ctx}"
        else:
            assert isinstance(err, ValueError) and quarantined >= budget, \
                f"unexpected failure {err!r}: {ctx}"
    assert quarantined <= max(budget, 0) + 1, \
        f"quarantined {quarantined} over budget {budget}: {ctx}"
    if verbose:
        print(f"case {case}: ok  sink={sink_seen[0]} shed={shed_counts} "
              f"dead={quarantined} err={type(err).__name__ if err else None}"
              f" {params}")
    return dict(params=params, sink=sink_seen[0], shed=shed_counts,
                dead=quarantined, error=repr(err) if err else None)


def run_soak(n: int, seed: int, verbose: bool = False,
             trace_dir: str = None, sample_period: float = None) -> dict:
    stats = {"cases": 0, "shed_cases": 0, "poison_cases": 0, "errors": 0}
    for case in range(n):
        r = run_case(seed, case, verbose=verbose, trace_dir=trace_dir,
                     sample_period=sample_period)
        stats["cases"] += 1
        stats["shed_cases"] += bool(r["shed"])
        stats["poison_cases"] += bool(r["dead"])
        stats["errors"] += bool(r["error"])
    return stats


def wf_check_pipelines():
    """Static-analysis entry (scripts/torch_wf_lint.py, docs/CHECKS.md): a
    tiny never-run instance of the soak topology — fast source ->
    poison map -> slow sink under a shedding OverloadPolicy."""
    from windflow_tpu_torch.core.tuples import Schema
    from windflow_tpu_torch.patterns.basic import Map, Sink, Source
    from windflow_tpu_torch.runtime.engine import Dataflow
    from windflow_tpu_torch.runtime.farm import build_pipeline
    from windflow_tpu_torch.runtime.overload import OverloadPolicy

    schema = Schema(value=np.int64)
    df = Dataflow("soak_overload_lint", capacity=4,
                  overload=OverloadPolicy(shed="shed_oldest",
                                          error_budget=2))
    build_pipeline(df, [
        Source(batches=[], schema=schema),
        Map(lambda b: None, name="poison_map", vectorized=True),
        Sink(lambda rows: None, vectorized=True)])
    return [df]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200, help="number of cases")
    ap.add_argument("--seed", type=int, default=0, help="soak seed")
    ap.add_argument("--case", type=int, default=None,
                    help="run ONE case standalone (failure repro)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--trace-dir", default=None,
                    help="observability output dir (metrics.jsonl / "
                         "events.jsonl / per-node logs; also WF_LOG_DIR)")
    ap.add_argument("--sample-period", type=float, default=None,
                    help="live sampler period in seconds (also "
                         "WF_SAMPLE_PERIOD); watch with "
                         "scripts/torch_wf_top.py")
    args = ap.parse_args()
    if args.case is not None:
        r = run_case(args.seed, args.case, verbose=True,
                     trace_dir=args.trace_dir,
                     sample_period=args.sample_period)
        print(r)
        return
    t0 = time.monotonic()
    stats = run_soak(args.n, args.seed, verbose=args.verbose,
                     trace_dir=args.trace_dir,
                     sample_period=args.sample_period)
    print(f"soak clean: {stats} in {time.monotonic() - t0:.1f}s")


if __name__ == "__main__":
    main()
