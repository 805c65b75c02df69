"""Interleaved YSB A/B over the PyTorch/CUDA port (windflow_tpu_torch), the
twin of scripts/ab_ysb.py: host kf vs device kf-gpu (and optionally wmr vs
wmr-gpu) alternating in ONE process so the card's and the host's state
average out across arms — judged on MEDIAN as well as best.

Before the timed rounds both arms run chip_smoke.py's deterministic YSB
stream (ysb_batches: --check-events events, ts 2 us apart) through
apps.ysb.build_pipeline, and every campaign's windows (count, lastUpdate,
revenue) must equal chip_smoke.py's bincount oracle (ysb_oracle): one
``check <variant>: {json}`` line each.  Then, as the reference: a warm-up
of the device arm, and ``rounds`` rounds of apps.ysb.run per arm, each
printing ``round R <variant>: {json}``; a timed run must have generated
events and received results.  The device arm runs on --device (default
cuda:0; cpu runs the kernels' plain versions).

Usage: python scripts/torch_ab_ysb.py [rounds] [duration_sec] [pardegree2]
       [variant_pair: kf|wmr] [--device DEV] [--check-events N]

Without CUDA and without --device cpu it exits 2 and runs nothing.
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def check(variant, n_events, par, device):
    """The variant over the deterministic stream against the oracle."""
    import chip_smoke as cs
    from windflow_tpu_torch.apps import ysb
    got, fields = {}, ("count", "lastUpdate", "revenue")

    def collect(live):
        for r in live:
            got.setdefault(int(r["key"]), []).append(
                tuple(int(r[f]) for f in fields))

    batches = cs.ysb_batches(n_events)
    pipe, _sink, sent = ysb.build_pipeline(
        variant, 0, 1, par, cs.YSB_WIN_SEC, cs.YSB_CHUNK, batches=batches,
        on_result=collect, device=device if variant.endswith("-gpu")
        else None)
    pipe.run_and_wait_end()
    want = cs.ysb_oracle(n_events)
    if sent[0] != n_events or got != want:
        bad = [c for c in want if got.get(c) != want[c]]
        raise AssertionError(f"ysb {variant}: sent {sent[0]} of {n_events}; "
                             f"campaigns {bad[:5]} differ from the oracle")
    return {"events": n_events, "windows": sum(map(len, got.values())),
            "kept_events": sum(r[0] for v in got.values() for r in v),
            "oracle_match": True}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rounds", type=int, nargs="?", default=3)
    ap.add_argument("duration_sec", type=float, nargs="?", default=4.0)
    ap.add_argument("pardegree2", type=int, nargs="?", default=4)
    ap.add_argument("pair", nargs="?", default="kf", choices=("kf", "wmr"))
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--check-events", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    import torch
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("torch_ab_ysb: no CUDA device visible; pass --device cpu to "
              "run on the host", file=sys.stderr)
        return 2
    from windflow_tpu_torch.apps.ysb import run, warmup
    rounds, dur, par = args.rounds, args.duration_sec, args.pardegree2
    host_v, dev_v = (args.pair, args.pair + "-gpu")

    for v in (host_v, dev_v):
        out = check(v, args.check_events, par, args.device)
        print(f"check {v}: {json.dumps(out)}", flush=True)
    warmup(dev_v, 1, par, 10.0, 262144, device=args.device)
    arms = {host_v: [], dev_v: []}
    for r in range(rounds):
        for v in (dev_v, host_v):
            out = run(v, duration_sec=dur, pardegree1=1, pardegree2=par,
                      warm=False, device=args.device)
            if not (out["generated"] > 0 and out["results"] > 0):
                raise AssertionError(f"round {r} {v}: {out}")
            arms[v].append(out)
            print(f"round {r} {v}: {json.dumps(out)}", flush=True)
    for v, rows in arms.items():
        eps = [x["events_per_sec"] for x in rows]
        gen = [x.get("gen_events_per_sec", 0) for x in rows]
        lat = [x["avg_latency_us"] / 1e3 for x in rows]
        print(f"{v:8s}: best {max(eps):,.0f}  median "
              f"{statistics.median(eps):,.0f} ev/s   "
              f"median ingest {statistics.median(gen):,.0f} ev/s   "
              f"median avg-latency {statistics.median(lat):,.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
