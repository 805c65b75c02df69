"""Micro-pipeline benchmark — a copy of ``windflow_tpu/apps/micro.py`` for
the PyTorch/CUDA port, itself the port of the reference's
``src/microbenchmarks/test_micro_1.cpp``: Source → Map → Filter → FlatMap →
Sink measuring end-to-end throughput and per-tuple latency via the same
counters (sentCounter / rcvResults / latency_sum, test_micro_1.cpp:31-37).

Latency here is measured per *batch* at the sink against the generation
timestamp carried in ``ts`` (wall-clock microseconds), then averaged per
tuple — the batch idiom's analog of the reference's per-tuple
``current_time_usecs() - t.ts``.  It has no device stage: it is carried
so that the port's apps are complete.
"""

from __future__ import annotations

import time

import numpy as np

from ..api import MultiPipe
from ..core.tuples import Schema, batch_from_columns
from ..patterns.basic import Filter, FlatMap, Map, Sink, Source

SCHEMA = Schema(value=np.int64)


def build_micro(duration_sec=5.0, chunk=4096, pardegree=1, capacity=2):
    """Assemble the micro pipeline without running it; returns
    ``(pipe, counters)`` with the shared counter cells the closures
    update (``sent``/``rcv``/``lat_sum``)."""
    import threading
    sent = [0]
    sent_lock = threading.Lock()

    def gen(shipper):
        t0 = time.monotonic()
        v0 = 0
        n = 0
        while time.monotonic() - t0 < duration_sec:
            now_us = int(time.time() * 1e6)
            v = np.arange(v0, v0 + chunk, dtype=np.int64)
            shipper.push_batch(batch_from_columns(
                SCHEMA, key=v % 16, id=v,
                ts=np.full(chunk, now_us, dtype=np.int64), value=v))
            n += chunk
            v0 += chunk
        with sent_lock:  # replicas race on the shared counter
            sent[0] += n

    def fm(batch, shipper):
        # 1-to-1 flatmap (the reference's shipper exercise)
        shipper.push_batch(batch)

    rcv = [0]
    lat_sum = [0.0]

    def sink(batch):
        if batch is None:
            return
        now_us = time.time() * 1e6
        rcv[0] += len(batch)
        lat_sum[0] += float((now_us - batch["ts"]).sum())

    # end-to-end latency ~= stages x capacity x chunk / throughput: the
    # two knobs below trade latency against batching efficiency
    pipe = (MultiPipe("micro", capacity=capacity)
            .add_source(Source(gen, SCHEMA, parallelism=pardegree,
                               name="micro_src"))
            .add(Map(lambda b: b.__setitem__("value", b["value"] * 3),
                     vectorized=True, parallelism=pardegree))
            .add(Filter(lambda b: b["value"] % 2 == 0, vectorized=True,
                        parallelism=pardegree))
            .add(FlatMap(fm, SCHEMA, vectorized=True, parallelism=pardegree))
            .chain_sink(Sink(sink, vectorized=True)))
    return pipe, {"sent": sent, "rcv": rcv, "lat_sum": lat_sum}


def wf_check_pipelines():
    """Static-analysis entry (docs/CHECKS.md): a tiny never-run instance
    of the benchmark topology.  pardegree 2 so the closure race analyzer
    sees the replica-shared generator (whose counter updates are
    lock-guarded — the pattern it must NOT flag)."""
    pipe, _counters = build_micro(0.0, chunk=1024, pardegree=2)
    return [pipe]


def run(duration_sec=5.0, chunk=4096, pardegree=1, capacity=2):
    pipe, counters = build_micro(duration_sec, chunk, pardegree, capacity)
    sent, rcv, lat_sum = (counters["sent"], counters["rcv"],
                          counters["lat_sum"])
    from ..ops import resident
    resident.stats_snapshot(reset=True)
    t0 = time.perf_counter()
    pipe.run_and_wait_end()
    elapsed = time.perf_counter() - t0
    return {
        "sent": sent[0],
        "received": rcv[0],
        "tuples_per_sec": round(sent[0] / elapsed, 1),
        "avg_latency_us": round(lat_sum[0] / max(rcv[0], 1), 1),
        "elapsed_sec": round(elapsed, 3),
        # launch diagnostics (zeros: no device stage)
        **resident.stats_snapshot(reset=True),
    }


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="micro pipeline benchmark")
    ap.add_argument("-l", "--length", type=float, default=5.0)
    ap.add_argument("-p", "--pardegree", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--capacity", type=int, default=2,
                    help="per-queue chunk capacity (latency knob)")
    a = ap.parse_args(argv)
    m = run(a.length, a.chunk, a.pardegree, a.capacity)
    for k, v in m.items():
        print(f"[micro] {k}: {v}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
