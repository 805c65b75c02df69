"""Twin of scripts/soak_rescale.py over the PyTorch/CUDA port
(windflow_tpu_torch): the same CLI, seeds, cases and output lines, with
every import taken from the port.

Seeded live-rescale soak: a Zipf-keyed source whose rate ramps up and
down (the diurnal-swing shape) feeds a Key_Farm under a ControlPolicy —
scripted rescale requests at randomized times plus admission control —
and the output is checked *differentially* against the same graph's
fixed-width oracle run: a farm rescaled N→N±k (and back) mid-stream must
produce byte-identical results, per-key order preserved, no drops or
duplicates (docs/CONTROL.md).

Mirrors the soak_overload.py / soak_crash.py pattern: standalone,
seeded, and any failure is reproducible in isolation:

    python scripts/torch_soak_rescale.py --n 100 --seed 23      # the soak
    python scripts/torch_soak_rescale.py --seed 23 --case 42    # one repro

The test suite runs a small slow-marked slice of this via
tests/test_torch_scripts.py (tier-1 excludes it with -m 'not slow').
"""

import argparse
import contextlib
import os
import sys
import threading
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _zipf_batches(schema, n_batches, rows, n_keys, a, seed):
    """Zipf-keyed batches with per-key dense ids and a rate ramp: batch
    sizes swell and shrink over the stream (the content, not the
    timing, is what the differential pins)."""
    rng = np.random.default_rng((seed, 0xcafe))
    ctr = {}
    for b in range(n_batches):
        # diurnal-ish ramp: 0.4x .. 1.6x of the nominal batch size
        scale = 1.0 + 0.6 * np.sin(2 * np.pi * b / max(n_batches - 1, 1))
        n = max(4, int(rows * scale))
        batch = np.zeros(n, dtype=schema.dtype())
        keys = (rng.zipf(a, size=n) - 1) % n_keys
        batch["key"] = keys
        batch["value"] = rng.integers(0, 1000, n)
        for i, k in enumerate(keys.tolist()):
            batch["id"][i] = ctr.get(k, 0)
            ctr[k] = ctr.get(k, 0) + 1
        batch["ts"] = batch["id"]
        yield batch


def run_case(seed: int, case: int, verbose: bool = False) -> dict:
    """One randomized rescale case; raises AssertionError (with the
    repro command in the message) on any divergence from the fixed-width
    oracle.  Returns the params dict incl. how many rescales landed."""
    from windflow_tpu_torch import (KeyFarm, MultiPipe, RecoveryPolicy,
                                    Reducer, Sink, Source)
    from windflow_tpu_torch.control import Admission, ControlPolicy, Rescale
    from windflow_tpu_torch.core.tuples import Schema
    from windflow_tpu_torch.core.windows import WinType

    rng = np.random.default_rng((seed, case))
    schema = Schema(value=np.int64)
    n_batches = int(rng.integers(40, 120))
    rows = int(rng.integers(32, 96))
    n_keys = int(rng.integers(6, 48))
    zipf_a = float(rng.uniform(1.3, 2.5))
    win = int(rng.integers(2, 16))
    slide = int(rng.integers(1, win + 1))
    win_type = WinType.CB if rng.random() < 0.7 else WinType.TB
    max_w = int(rng.integers(3, 7))
    init_w = int(rng.integers(1, max_w))
    epoch_batches = int(rng.integers(2, 10))
    admission = bool(rng.random() < 0.5)
    # scripted width schedule: (delay_s, target) pairs — a requester
    # sends them while the pipe runs; any timing is a correct timing
    n_req = int(rng.integers(2, 5))
    schedule = [(float(rng.uniform(0.02, 0.25)),
                 int(rng.integers(1, max_w + 1)))
                for _ in range(n_req)]
    params = dict(n_batches=n_batches, rows=rows, n_keys=n_keys,
                  zipf_a=round(zipf_a, 2), win=win, slide=slide,
                  win_type=win_type.name, init_w=init_w, max_w=max_w,
                  epoch_batches=epoch_batches, admission=admission,
                  schedule=schedule)
    repro = (f"python scripts/torch_soak_rescale.py --seed {seed} "
             f"--case {case}")
    if verbose:
        print(f"case {case}: {params}")

    def build(control=None, recovery=None, metrics=None):
        pipe = MultiPipe(f"soak{case}", capacity=8, recovery=recovery,
                         metrics=metrics, control=control)
        pipe.add_source(Source(
            batches=lambda i: _zipf_batches(schema, n_batches, rows,
                                            n_keys, zipf_a, seed + case),
            name="src"))
        pipe.add(KeyFarm(Reducer("sum", "value"), win, slide, win_type,
                         pardegree=init_w, name="kf"))
        out = []
        pipe.add_sink(Sink(
            lambda r: out.append((int(r["key"]), int(r["id"]),
                                  int(r["value"])))
            if r is not None else None, name="sink"))
        return pipe, out

    @contextlib.contextmanager
    def _quiet():
        # the soak runs metrics with no trace_dir on purpose (no file
        # I/O per case): the WF207 guidance warning is expected noise
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=r"\[WF207\]")
            yield

    # fixed-width oracle: the same logical stream, never rescaled
    oracle_pipe, oracle = build()
    oracle_pipe.run_and_wait_end(timeout=300)

    rules = [Rescale("kf", max_workers=max_w, min_workers=1,
                     up_depth=10 ** 9, down_depth=-1, cooldown=10 ** 9)]
    if admission:
        # throttling delays emission but never changes content, so it
        # runs INSIDE the differential
        rules.append(Admission(max_rate=5e5, min_rate=5e4, high_depth=6,
                               low_depth=1, hysteresis=1, cooldown=0.05))
    pipe, got = build(
        control=ControlPolicy(rules, period=0.02),
        recovery=RecoveryPolicy(epoch_batches=epoch_batches,
                                restart_backoff=0.01),
        metrics=True)
    with _quiet():
        pipe.run()
    ctl = pipe.controller
    done = threading.Event()

    def requester():
        for delay, width in schedule:
            if done.wait(delay):
                return
            try:
                ctl.request_rescale("kf", width)
            except Exception:
                pass  # e.g. a request while one is in flight

    t = threading.Thread(target=requester, daemon=True)
    t.start()
    try:
        pipe.wait(timeout=300)
    finally:
        done.set()
    t.join(timeout=5)
    n_rescales = sum(len(fc.history) for fc in ctl.farms)
    params["rescales"] = n_rescales

    def per_key(rows):
        # each key's result sequence in arrival order: checks per-key
        # ORDER as well as drops/dups (cross-key interleave is
        # scheduling-dependent in both runs)
        d = {}
        for k, i, v in rows:
            d.setdefault(k, []).append((i, v))
        return d

    assert per_key(got) == per_key(oracle), (
        f"{repro}: rescaled output diverged from the fixed-width oracle "
        f"({len(got)} vs {len(oracle)} rows; params {params})")
    return params


def wf_check_pipelines():
    """Static-analysis entry (scripts/torch_wf_lint.py, docs/CHECKS.md): a
    tiny never-run instance of the rescale topology — keyed farm under
    a ControlPolicy + RecoveryPolicy with metrics on.  Unlike the soak
    cases (which run metrics trace-less on purpose and filter WF207),
    the lint twin supplies a trace_dir so it validates clean."""
    import tempfile

    from windflow_tpu_torch import (KeyFarm, MultiPipe, RecoveryPolicy,
                                    Reducer, Sink, Source)
    from windflow_tpu_torch.control import ControlPolicy, Rescale
    from windflow_tpu_torch.core.tuples import Schema
    from windflow_tpu_torch.core.windows import WinType

    schema = Schema(value=np.int64)
    pipe = MultiPipe("soak_rescale_lint", capacity=8,
                     recovery=RecoveryPolicy(epoch_batches=4),
                     metrics=True, trace_dir=tempfile.gettempdir(),
                     control=ControlPolicy(
                         [Rescale("kf", max_workers=4, min_workers=1)]))
    pipe.add_source(Source(batches=lambda i: iter(()), schema=schema,
                           name="src"))
    pipe.add(KeyFarm(Reducer("sum", "value"), 8, 4, WinType.CB,
                     pardegree=2, name="kf"))
    sink = Sink(lambda r: None, name="sink")
    sink.recoverable = True
    pipe.add_sink(sink)
    return [pipe]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=100, help="number of cases")
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--case", type=int, default=None,
                    help="run exactly one case (repro mode)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if args.case is not None:
        p = run_case(args.seed, args.case, verbose=True)
        print(f"OK ({p['rescales']} rescales)")
        return
    total = 0
    for case in range(args.n):
        p = run_case(args.seed, case, verbose=args.verbose)
        total += p["rescales"]
        if (case + 1) % 10 == 0:
            print(f"{case + 1}/{args.n} cases OK ({total} rescales so far)")
    # the schedule timings are random: single cases may legitimately see
    # no barrier in time, but a soak whose rescales NEVER land is
    # vacuous — fail loudly
    assert total > 0, "no rescale completed across the whole soak"
    print(f"all {args.n} cases OK ({total} rescales)")


if __name__ == "__main__":
    main()
