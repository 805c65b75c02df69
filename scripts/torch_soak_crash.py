"""Seeded crash-recovery soak of the PyTorch/CUDA port (windflow_tpu_torch),
the twin of scripts/torch_soak_crash.py: randomized windowed graphs with
kill-point injection into a stateful worker, recovered under a
RecoveryPolicy and checked *differentially* against the same graph's
uncrashed run — the recovered output must be byte-identical
(docs/ROBUSTNESS.md "Recovery").  The same seed and case draw the same
graph as scripts/torch_soak_crash.py.

Standalone, seeded, and any failure is reproducible in isolation:

    python scripts/torch_soak_crash.py --n 200 --seed 11       # the soak
    python scripts/torch_soak_crash.py --seed 11 --case 42     # one repro

tests/test_torch_scripts.py runs a small slow-marked slice of this
(tier-1 excludes it with -m 'not slow').

--native runs the same differential over the C++ resident core's state
ABI (docs/ROBUSTNESS.md "Native state ABI"): randomized WinSeqGPU graphs
that route to NativeResidentCore over the ring kernels on --device
(default cuda:0; --device cpu runs the kernels' plain versions), killed
mid-stream and restored from the exported blob:

    python scripts/torch_soak_crash.py --native --n 50 --seed 11
    python scripts/torch_soak_crash.py --native --seed 11 --case 7
    python scripts/torch_soak_crash.py --native --device cpu --n 4

Without CUDA and without --device cpu, --native exits 2 and runs nothing.
A native case that cannot reach NativeResidentCore fails the run.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _batches(schema, n_batches, rows, n_keys, seed):
    rng = np.random.default_rng((seed, 0xbeef))
    ctr = {}
    for _ in range(n_batches):
        b = np.zeros(rows, dtype=schema.dtype())
        keys = rng.integers(0, n_keys, rows)
        b["key"] = keys
        b["value"] = rng.integers(0, 1000, rows)
        for i, k in enumerate(keys.tolist()):
            b["id"][i] = ctr.get(k, 0)
            ctr[k] = ctr.get(k, 0) + 1
        b["ts"] = b["id"]
        yield b


def run_case(seed: int, case: int, verbose: bool = False,
             report: dict = None) -> dict:
    """One randomized crash-recovery case; raises AssertionError (with
    the repro command in the message) on any divergence from the
    uncrashed differential oracle.  ``report``, when given, receives the
    uncrashed and recovered rows (``oracle``, ``got``: (key, id, value),
    sorted for a farm)."""
    from windflow_tpu_torch import (RecoveryPolicy, Reducer, Sink, Source,
                                    WinFarm, WinSeq)
    from windflow_tpu_torch.core.tuples import Schema
    from windflow_tpu_torch.core.windows import WinType
    from windflow_tpu_torch.runtime.engine import Dataflow
    from windflow_tpu_torch.runtime.farm import build_pipeline

    rng = np.random.default_rng((seed, case))
    schema = Schema(value=np.int64)
    n_batches = int(rng.integers(10, 40))
    rows = int(rng.integers(16, 80))
    n_keys = int(rng.integers(1, 8))
    win = int(rng.integers(2, 16))
    slide = int(rng.integers(1, win + 1))
    win_type = WinType.CB if rng.random() < 0.7 else WinType.TB
    farm = bool(rng.random() < 0.4)
    pardegree = int(rng.integers(2, 4)) if farm else 1
    epoch_batches = int(rng.integers(2, 12))
    n_kills = int(rng.integers(1, 3))
    # farm workers share one svc-call counter across pardegree replicas
    # (the window-range multicast roughly multiplies calls), so late
    # kill points need the wider range
    kill_at = sorted(set(
        rng.integers(1, max(n_batches * (pardegree if farm else 1), 2),
                     size=n_kills).tolist()))
    use_nic = bool(rng.random() < 0.3) and not farm
    params = dict(n_batches=n_batches, rows=rows, n_keys=n_keys, win=win,
                  slide=slide, win_type=win_type.name, farm=farm,
                  pardegree=pardegree, epoch_batches=epoch_batches,
                  kill_at=kill_at, use_nic=use_nic)
    repro = (f"python scripts/torch_soak_crash.py --seed {seed} "
             f"--case {case}")
    if verbose:
        print(f"case {case}: {params}")

    def pattern():
        if farm:
            return WinFarm(Reducer("sum", "value"), win, slide, win_type,
                           pardegree=pardegree, name="w")
        if use_nic:
            return WinSeq(
                lambda key, gwid, rows_: (int(rows_["value"].sum()),),
                win, slide, win_type, name="w",
                result_fields={"value": np.int64})
        return WinSeq(Reducer("sum", "value"), win, slide, win_type,
                      name="w")

    def run(recovery=None, kills=()):
        out = []
        df = Dataflow(f"soak{case}", capacity=8, recovery=recovery)
        build_pipeline(df, [
            Source(batches=lambda i: _batches(schema, n_batches, rows,
                                              n_keys, seed + case),
                   name="src"),
            pattern(),
            Sink(lambda r: out.append((int(r["key"]), int(r["id"]),
                                       int(r["value"])))
                 if r is not None else None, name="sink"),
        ])
        workers = [n for n in df.nodes
                   if n.name == "w" or n.name.startswith("w.")
                   or n.name.startswith("w_")]
        workers = [n for n in workers
                   if "emitter" not in n.name and "collector" not in n.name]
        state = {"n": 0, "todo": sorted(kills, reverse=True)}
        for node in workers:
            orig = node.svc

            def svc(batch, channel=0, _orig=orig):
                state["n"] += 1
                if state["todo"] and state["n"] >= state["todo"][-1]:
                    state["todo"].pop()
                    raise RuntimeError(f"{repro}: injected crash "
                                       f"@svc {state['n']}")
                return _orig(batch, channel)

            node.svc = svc
        df.run_and_wait_end(timeout=120)
        return out

    oracle = run()
    pol = RecoveryPolicy(epoch_batches=epoch_batches,
                         max_restarts=n_kills + 1,
                         restart_backoff=0.005)
    got = run(recovery=pol, kills=kill_at)
    if farm:
        oracle, got = sorted(oracle), sorted(got)
    assert got == oracle, (
        f"{repro}: recovered output diverged from the uncrashed oracle "
        f"({len(got)} vs {len(oracle)} rows; params {params})")
    if report is not None:
        report.update(oracle=oracle, got=got)
    return params


class NativeUnavailable(RuntimeError):
    """--native requested but no state-ABI native core on this host."""


def run_case_native(seed: int, case: int, verbose: bool = False,
                    device: str = "cuda:0", report: dict = None) -> dict:
    """One randomized crash-recovery case over the C++ resident core:
    a WinSeqGPU graph on ``device`` routed to NativeResidentCore is
    killed mid-stream and its state restored through the blob ABI;
    output must match the uncrashed differential oracle byte-for-byte.
    ``report``, when given, receives the case's ``batches``, the
    uncrashed and recovered rows (``oracle``, ``got``: (key, id, value)
    in arrival order) and the injected crashes (``restarts``)."""
    from windflow_tpu_torch import RecoveryPolicy, Reducer, Sink, Source
    from windflow_tpu_torch.core.tuples import Schema
    from windflow_tpu_torch.core.windows import WinType
    from windflow_tpu_torch.native import enabled
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    from windflow_tpu_torch.patterns.win_seq_gpu import WinSeqGPU
    from windflow_tpu_torch.runtime.engine import Dataflow
    from windflow_tpu_torch.runtime.farm import build_pipeline

    lib = enabled()
    if lib is None or not getattr(lib, "wf_has_state_abi", False):
        raise NativeUnavailable(
            "native library with the state ABI unavailable (build with "
            "`make -C native`, unset WF_NO_NATIVE)")

    rng = np.random.default_rng((seed, case, 0x4e41))
    schema = Schema(value=np.int64)
    n_batches = int(rng.integers(10, 32))
    rows = int(rng.integers(16, 80))
    n_keys = int(rng.integers(1, 8))
    win = int(rng.integers(2, 16))
    slide = int(rng.integers(1, win + 1))
    win_type = WinType.CB if rng.random() < 0.7 else WinType.TB
    batch_len = int(rng.choice([16, 32, 64]))
    shards = int(rng.integers(1, 3))
    epoch_batches = int(rng.integers(2, 10))
    n_kills = int(rng.integers(1, 3))
    kill_at = sorted(set(
        rng.integers(1, max(n_batches, 2), size=n_kills).tolist()))
    params = dict(n_batches=n_batches, rows=rows, n_keys=n_keys, win=win,
                  slide=slide, win_type=win_type.name, batch_len=batch_len,
                  shards=shards, epoch_batches=epoch_batches,
                  kill_at=kill_at)
    repro = (f"python scripts/torch_soak_crash.py --native --seed {seed} "
             f"--case {case} --device {device}")
    if verbose:
        print(f"native case {case}: {params}")

    crashes = [0]

    def run(recovery=None, kills=()):
        out = []
        df = Dataflow(f"nsoak{case}", capacity=8, recovery=recovery)
        build_pipeline(df, [
            Source(batches=lambda i: _batches(schema, n_batches, rows,
                                              n_keys, seed + case),
                   name="src"),
            WinSeqGPU(Reducer("sum", "value"), win, slide, win_type,
                      batch_len=batch_len, shards=shards, device=device,
                      name="w"),
            Sink(lambda r: out.append((int(r["key"]), int(r["id"]),
                                       int(r["value"])))
                 if r is not None else None, name="sink"),
        ])
        node = next(n for n in df.nodes
                    if n.name == "w" or n.name.startswith("w."))
        if not isinstance(node.core, NativeResidentCore):
            raise NativeUnavailable(
                f"routing picked {type(node.core).__name__}, not the "
                f"native core, on this host")
        state = {"n": 0, "todo": sorted(kills, reverse=True)}
        orig = node.svc

        def svc(batch, channel=0):
            state["n"] += 1
            if state["todo"] and state["n"] >= state["todo"][-1]:
                state["todo"].pop()
                crashes[0] += 1
                raise RuntimeError(f"{repro}: injected crash "
                                   f"@svc {state['n']}")
            return orig(batch, channel)

        node.svc = svc
        df.run_and_wait_end(timeout=300)
        return out

    pol = RecoveryPolicy(epoch_batches=epoch_batches,
                         max_restarts=n_kills + 1,
                         restart_backoff=0.005)
    # shards > 1 overlap ships completed launches in completion order,
    # so the plain run's cross-key interleave is wall-clock; recovery
    # mode pins overlap off (patterns/native_core.py) — judge the crash
    # against an uncrashed run under the SAME policy so both sides are
    # deterministic and the compare stays byte-exact
    oracle = run(recovery=pol if shards > 1 else None)
    got = run(recovery=pol, kills=kill_at)
    assert got == oracle, (
        f"{repro}: recovered native-core output diverged from the "
        f"uncrashed oracle ({len(got)} vs {len(oracle)} rows; "
        f"params {params})")
    if report is not None:
        report.update(
            batches=list(_batches(schema, n_batches, rows, n_keys,
                                  seed + case)),
            oracle=oracle, got=got, restarts=crashes[0])
    return params


def wf_check_pipelines():
    """Static-analysis entry (scripts/torch_wf_lint.py, docs/CHECKS.md): a
    tiny never-run instance of the crash-recovery topology — source ->
    window farm -> sink under a RecoveryPolicy.  The sink opts into
    restart (its real body is an idempotent list append)."""
    from windflow_tpu_torch import (RecoveryPolicy, Reducer, Sink, Source,
                                    WinFarm)
    from windflow_tpu_torch.core.windows import WinType
    from windflow_tpu_torch.runtime.engine import Dataflow
    from windflow_tpu_torch.runtime.farm import build_pipeline

    sink = Sink(lambda r: None, name="sink")
    sink.recoverable = True
    df = Dataflow("soak_crash_lint", capacity=8,
                  recovery=RecoveryPolicy(epoch_batches=4))
    build_pipeline(df, [
        Source(batches=lambda i: iter(()), name="src"),
        WinFarm(Reducer("sum", "value"), 8, 4, WinType.CB, pardegree=2,
                name="w"),
        sink])
    return [df]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=100, help="number of cases")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--case", type=int, default=None,
                    help="run exactly one case (repro mode)")
    ap.add_argument("--native", action="store_true",
                    help="soak the C++ resident core's state ABI")
    ap.add_argument("--device", default="cuda:0",
                    help="the native cases' device (default cuda:0; cpu "
                         "runs the ring kernels' plain versions)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if args.native:
        import functools

        import torch
        if (torch.device(args.device).type == "cuda"
                and not torch.cuda.is_available()):
            print("torch_soak_crash: no CUDA device visible; pass "
                  "--device cpu to run the native cases on the host",
                  file=sys.stderr)
            return 2
        case_fn = functools.partial(run_case_native, device=args.device)
    else:
        case_fn = run_case
    if args.case is not None:
        case_fn(args.seed, args.case, verbose=True)
        print("OK")
        return 0
    for case in range(args.n):
        case_fn(args.seed, case, verbose=args.verbose)
        if (case + 1) % 10 == 0:
            print(f"{case + 1}/{args.n} cases OK")
    print(f"all {args.n} cases OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
