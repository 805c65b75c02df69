"""Interleaved sweeps of sum_test on the port's resident route: the twin of
scripts/sweep.py, scripts/sweep_window.py and scripts/ab_proactive.py over
the PyTorch/CUDA port (windflow_tpu_torch), one config list each, run
round-robin in ONE process so the card's state averages out across
configs.

The workload is chip_smoke.py's sum_test (make_stream: 64 keys, values
0..99, CB 256/64, batch_len 32768) through WinSeqGPU on --device (default
cuda:0; cpu runs the ring kernels' plain versions), and every run's total
is held against chip_smoke.py's expected_total:

* ``--configs sweep`` (scripts/sweep.py): shards 1/2/4 x flush_rows
  2^19/2^20 at depth 24, Reducer("sum");
* ``--configs window`` (scripts/sweep_window.py): the in-flight dispatch
  window (WF_DISPATCH_WINDOW, patterns/native_core.py) and depth, a
  flush_rows 2^18 arm and an overlap-off arm (WF_NO_OVERLAP), over
  Reducer("sum", value_range=(0, 100)) at shards 1;
* ``--configs proactive`` (scripts/ab_proactive.py): proactive flush
  sizing on (WF_PROACTIVE=1) and off, at the chip_smoke.py resident
  stage (flush_rows 2^19, depth 48, shards 1).

A warm-up run (the resident stage, outside every timing) comes first.
Each run prints ``round R <config>: {json}`` with tuples/s, seconds, the
total and oracle and the launch diagnostics (ops/resident.py
stats_snapshot); then per config the best-of (sweep) or best and median
(window, proactive), as the reference scripts print them.

Usage: python scripts/torch_sweep.py --configs {sweep,window,proactive}
       [n_million] [rounds] [--device DEV]

Without CUDA and without --device cpu it exits 2 and runs nothing.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

#: each reference script's config list, and its (n_million, rounds)
CONFIGS = {
    "sweep": [dict(shards=shards, flush=flush, depth=24)
              for shards in (1, 2, 4) for flush in (1 << 19, 1 << 20)],
    "window": [
        {"dw": 8, "depth": 48},                        # the default
        {"dw": 8, "depth": 48, "flush": 1 << 18},
        {"dw": 16, "depth": 96},
        {"dw": 8, "depth": 48, "no_overlap": True},
    ],
    "proactive": [{"arm": "on"}, {"arm": "off"}],
}
DEFAULTS = {"sweep": (8, 3), "window": (16, 3), "proactive": (16, 4)}
_ENV = ("WF_DISPATCH_WINDOW", "WF_NO_OVERLAP", "WF_PROACTIVE")


def label(which, i, cfg):
    if which == "sweep":
        return (f"cfg{i} shards={cfg['shards']} "
                f"flush=2^{cfg['flush'].bit_length() - 1} "
                f"depth={cfg['depth']}")
    if which == "proactive":
        return f"{cfg['arm']:3s}"
    return str(cfg)


def stage_of(which, cfg, device):
    """The config's WinSeqGPU, with its environment knobs set."""
    import chip_smoke as cs
    import windflow_tpu_torch as wt
    for k in _ENV:
        os.environ.pop(k, None)
    if which == "sweep":
        return wt.WinSeqGPU(wt.Reducer("sum"), cs.WIN, cs.SLIDE,
                            batch_len=cs.BATCH_LEN, flush_rows=cfg["flush"],
                            depth=cfg["depth"], shards=cfg["shards"],
                            device=device)
    if which == "window":
        os.environ["WF_DISPATCH_WINDOW"] = str(cfg["dw"])
        if cfg.get("no_overlap"):
            os.environ["WF_NO_OVERLAP"] = "1"
        return wt.WinSeqGPU(wt.Reducer("sum", value_range=(0, 100)), cs.WIN,
                            cs.SLIDE, wt.WinType.CB, batch_len=cs.BATCH_LEN,
                            flush_rows=cfg.get("flush", cs.FLUSH_ROWS),
                            depth=cfg["depth"], shards=1, device=device)
    if cfg["arm"] == "on":
        os.environ["WF_PROACTIVE"] = "1"
    return cs.resident_stage(wt, device=device)


def run_one(stage, batches, schema, want, n_tuples):
    """One timed run: its JSON row (tuples/s, seconds, total, oracle and
    the launch diagnostics); fails unless the total equals the oracle."""
    import chip_smoke as cs
    from windflow_tpu_torch.ops import resident
    resident.stats_snapshot(reset=True)
    dt, n_windows, total, _ = cs.run_pipeline(stage, batches, schema)
    diag = resident.stats_snapshot(reset=True)
    if total != want:
        raise AssertionError(f"total {total} != oracle {want}")
    return {"tps": round(n_tuples / dt, 1), "seconds": dt,
            "windows": n_windows, "total": total, "oracle": want, **diag}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", choices=sorted(CONFIGS), required=True)
    ap.add_argument("n_million", type=float, nargs="?", default=None)
    ap.add_argument("rounds", type=int, nargs="?", default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import torch
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("torch_sweep: no CUDA device visible; pass --device cpu to "
              "run on the host", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import windflow_tpu_torch as wt
    which = args.configs
    n_m, rounds = DEFAULTS[which]
    n_m = args.n_million if args.n_million is not None else n_m
    rounds = args.rounds if args.rounds is not None else rounds
    n_tuples = int(n_m * 1e6)
    schema = wt.Schema(value=np.int64)
    batches = cs.make_stream(schema, n_tuples)
    n_tuples = sum(len(b) for b in batches)
    want = cs.expected_total(batches)
    configs = CONFIGS[which]

    t0 = time.perf_counter()
    warm = run_one(stage_of("proactive", {"arm": "off"}, args.device),
                   batches, schema, want, n_tuples)
    print(f"warm-up: {json.dumps(warm)}", flush=True)
    results = {i: [] for i in range(len(configs))}
    try:
        for r in range(rounds):
            for i, cfg in enumerate(configs):
                row = run_one(stage_of(which, cfg, args.device), batches,
                              schema, want, n_tuples)
                results[i].append(row)
                print(f"round {r} {label(which, i, cfg)}: {json.dumps(row)}",
                      flush=True)
    finally:
        for k in _ENV:
            os.environ.pop(k, None)
    if which == "sweep":
        print("\nbest-of per config:")
        for i, cfg in enumerate(configs):
            best = max(x["tps"] for x in results[i])
            print(f"  {label(which, i, cfg).split(' ', 1)[1]}: "
                  f"{best / 1e6:.2f}M tps")
    else:
        for i, cfg in enumerate(configs):
            tps = [x["tps"] for x in results[i]]
            print(f"{label(which, i, cfg)}: best {max(tps):,.0f} "
                  f"median {statistics.median(tps):,.0f} "
                  f"dispatches {[x['dispatches'] for x in results[i]]}")
    print(json.dumps({"configs": which, "tuples": n_tuples,
                      "rounds": rounds, "device": args.device,
                      "seconds": time.perf_counter() - t0,
                      "results": [{"cfg": cfg, "runs": results[i]}
                                  for i, cfg in enumerate(configs)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
