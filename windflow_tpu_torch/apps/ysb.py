"""Yahoo! Streaming Benchmark — a copy of ``windflow_tpu/apps/ysb.py`` for
the PyTorch/CUDA port, itself the port of the reference's
``src/yahoo_test_cpu`` suite (test_ysb_kf.cpp / test_ysb_wmr.cpp,
ysb_nodes.hpp, campaign_generator.hpp, yahoo_app.hpp; StreamBench variant).

Pipeline (test_ysb_kf.cpp:90-110):
    Source -> chain(Filter event_type==0) -> chain(Join ad->campaign)
           -> Key_Farm(TB tumbling 10s, per-campaign COUNT + MAX(ts))
           -> chain(Sink latency/throughput accounting)

Differences, per the framework's batch idiom:

* the Source generates whole event *batches* (SoA) with the reference's
  exact per-event recurrences (ysb_nodes.hpp:104-115: ``ad_id =
  (v % 100000) % (N_CAMPAIGNS * adsPerCampaign)``, ``event_type =
  (v % 100000) % 3``), vectorised;
* the Join's hashmap probe (ysb_nodes.hpp:188-210) becomes an O(1) numpy
  table gather ``cmp = ad_to_cmp[ad_id]`` — every ad is in the table, so
  the FlatMap's "drop on miss" arm never fires (same as the reference's
  generated workload);
* the aggregate (yahoo_app.hpp:150-156: ``count++``, ``lastUpdate =
  max(ts)``) exists in three flavours: the incremental fold
  ``YSBAggregateINC`` (the KF stage, matching the reference's INC flavour),
  the NIC ``YSBAggregate`` (the WMR MAP stage), and the device
  ``device_aggregate`` (the kf-gpu stage — count/max are monoids).

The device variants are ``kf-gpu`` (``KeyFarmGPU`` over the native core's
revenue ring on the card, appended and summed over the TB windows by one
``ring_append_eval`` launch a dispatch) and
``wmr-gpu``
(``WinMapReduceGPU``: the MAP stage on the card, REDUCE on the host) —
the JAX package's ``kf-tpu`` and ``wmr-tpu``.  They run on the card unless
``device="cpu"`` is passed.  Run on the card with ``python3 -m
windflow_tpu_torch.apps.ysb --variant kf-gpu``.
"""

from __future__ import annotations

import time

import numpy as np

from ..api import MultiPipe
from ..core.tuples import Schema, batch_from_columns
from ..core.windows import WinType
from ..ops.functions import WindowFunction, WindowUpdate
from ..patterns.basic import Filter, Map, Sink, Source
from ..patterns.key_farm import KeyFarm
from ..patterns.win_mapreduce import WinMapReduce

N_CAMPAIGNS = 100          # -DN_CAMPAIGNS=100 (yahoo Makefile:26)
ADS_PER_CAMPAIGN = 10      # CampaignGenerator default

EVENT_SCHEMA = Schema(ad_id=np.int64, event_type=np.int8,
                      revenue=np.int64)
#: key=cmp_id, ts carries the event time; revenue rides to the aggregate
JOINED_SCHEMA = Schema(revenue=np.int64)


class CampaignGenerator:
    """Synthetic campaign table (campaign_generator.hpp): sequential ad ids
    0..N*ads-1, campaign k owning ads [k*ads, (k+1)*ads)."""

    def __init__(self, n_campaigns: int = N_CAMPAIGNS,
                 ads_per_campaign: int = ADS_PER_CAMPAIGN):
        self.n_campaigns = n_campaigns
        self.ads_per_campaign = ads_per_campaign
        self.n_ads = n_campaigns * ads_per_campaign
        #: ad_id -> campaign id (the relational table + hashmap in one)
        self.ad_to_cmp = np.arange(self.n_ads) // ads_per_campaign


class YSBAggregate(WindowFunction):
    """Per-campaign tumbling-window COUNT(*) + MAX(ts) + SUM(revenue)
    (aggregateFunctionINC, yahoo_app.hpp:150-168; the revenue sum is the
    extension making the aggregate device-worthy — counts and max-ts
    are answerable from host bookkeeping alone, a per-event revenue fold
    is not)."""

    result_fields = {"count": np.int64, "lastUpdate": np.int64,
                     "revenue": np.int64}
    required_fields = ("ts", "revenue")  # staged to apply_batch / device

    def apply(self, key, gwid, rows):
        return (len(rows),
                int(rows["ts"].max()) if len(rows) else 0,
                int(rows["revenue"].sum()) if len(rows) else 0)

    def apply_batch(self, keys, gwids, cols, lens):
        # ts is a header column; reconstructing MAX(ts) from the window
        # extents is not possible in general, so this path receives ts via
        # cols
        ts = cols["ts"]
        pad = ts.shape[1]
        mask = np.arange(pad)[None, :] < lens[:, None]
        return {"count": lens.astype(np.int64),
                "lastUpdate": np.where(mask, ts, 0).max(axis=1),
                "revenue": np.where(mask, cols["revenue"], 0).sum(axis=1)}


class YSBAggregateINC(WindowUpdate):
    """The same aggregate as an *incremental* per-chunk fold — the
    reference's actual flavour (aggregateFunctionINC, yahoo_app.hpp:150-156):
    O(1) state per open window, no archive.  This is what the kf variant
    runs; the NIC twin above serves the WMR MAP stage and the device path."""

    result_fields = {"count": np.int64, "lastUpdate": np.int64,
                     "revenue": np.int64}

    def update(self, key, gwid, row, acc):
        acc["count"] += 1
        acc["lastUpdate"] = max(acc["lastUpdate"], row["ts"])
        acc["revenue"] += row["revenue"]

    def update_many(self, key, gwid, rows, acc):
        if len(rows):
            acc["count"] += len(rows)
            acc["lastUpdate"] = max(int(acc["lastUpdate"]),
                                    int(rows["ts"].max()))
            acc["revenue"] += int(rows["revenue"].sum())


class YSBReduce(WindowFunction):
    """Combine per-partition partials (reduceFunctionINC,
    yahoo_app.hpp:159-165)."""

    result_fields = {"count": np.int64, "lastUpdate": np.int64,
                     "revenue": np.int64}

    def apply(self, key, gwid, rows):
        return (int(rows["count"].sum()) if len(rows) else 0,
                int(rows["lastUpdate"].max()) if len(rows) else 0,
                int(rows["revenue"].sum()) if len(rows) else 0)


def device_aggregate(rich: bool = False):
    """The YSB aggregate as a multi-stat resident reduction: COUNT(*) +
    MAX(ts) + SUM(revenue) (yahoo_app.hpp:150-168).  SUM(revenue) is NOT
    host-free (counts come from window lengths and max-ts from the
    position-ordered archive, but a per-event revenue fold is real device
    work), so this routes to the resident device path: the C++ core
    answers COUNT and MAX(ts) from its archive (the pos-extrema split,
    win_seq_gpu.split_pos_max) and ships only the revenue column, once,
    into a ring on the card (ops/resident.py: ResidentWindowExecutor, the
    one device stat left after the split), which one ``ring_append_eval``
    launch a dispatch (kernel ``append_eval_kernel``) appends and sums
    over the dispatch's windows.  Event timestamps are relative microseconds
    (event_batches), so the declared value_range proves an int32 MAX exact
    for runs under ~35 minutes.  Revenue keeps the host variants' int64
    result dtype (one shared result schema across kf/kf-gpu/wmr/wmr-gpu)
    over the default int32 device accumulate; a TB window's row count is
    unbounded, so the accumulate-wrap warning stays armed for this stat by
    design — the declared per-event range documents the input but cannot
    prove a TB sum fits."""
    from ..ops.functions import MultiReducer, Reducer

    stats = [
        Reducer("count", out_field="count"),
        Reducer("max", "ts", "lastUpdate",
                value_range=(0, 2_100_000_000)),
        Reducer("sum", "revenue", "revenue", value_range=(0, 98))]
    if rich:
        # --rich-stats: MIN(ts) = the window's earliest event.  MIN over
        # the position field is as free as MAX (the pos-extrema split) —
        # the position-ordered archive's first window row holds it — so
        # firstUpdate costs nothing and the device half stays the single
        # revenue ring.
        stats.append(Reducer("min", "ts", "firstUpdate",
                             value_range=(0, 2_100_000_000)))
    return MultiReducer(*stats)


def event_batches(duration_sec: float, chunk: int, campaigns,
                  time_fn=time.monotonic):
    """Generator of event batches at full speed for `duration_sec`
    (ysb_nodes.hpp:103-125): ts is microseconds since start."""
    n_ads = campaigns.n_ads
    v0 = 0
    t0 = time_fn()
    while True:
        now = time_fn() - t0
        if now >= duration_sec:
            return
        v = np.arange(v0, v0 + chunk, dtype=np.int64)
        vm = v % 100000
        ts = np.full(chunk, int(now * 1e6), dtype=np.int64)
        yield batch_from_columns(
            EVENT_SCHEMA, key=np.zeros(chunk, dtype=np.int64),
            id=v, ts=ts, ad_id=vm % n_ads,
            event_type=(vm % 3).astype(np.int8),
            revenue=(vm % 97) + 1)
        v0 += chunk


class YSBSink:
    """Latency / count accounting (YSBSink, ysb_nodes.hpp:215-246)."""

    def __init__(self, start_wall_us: int, now_us=None, on_result=None):
        self.start_wall_us = start_wall_us
        self.now_us = now_us or (lambda: int(time.time() * 1e6))
        self.on_result = on_result
        self.received = 0
        self._lat_us = []   # per-result latencies -> avg/p95/p99 (the
        #                     reference's headline metric pair is
        #                     throughput AND per-result latency,
        #                     ysb_nodes.hpp:231-246); avg derives from
        #                     the same arrays as the percentiles so the
        #                     two can never disagree

    def __call__(self, batch):
        if batch is None:
            return
        live = batch[batch["count"] > 0]
        if not len(live):
            return
        now = self.now_us()
        lat = now - (live["lastUpdate"] + self.start_wall_us)
        self.received += len(live)
        self._lat_us.append(np.asarray(lat, dtype=np.float64))
        if self.on_result is not None:
            self.on_result(live)

    def latency_summary_us(self):
        """One summarize() pass over the full latency history: avg and
        percentiles derive from the same arrays, computed once."""
        from ..utils.latency import summarize
        s = summarize(self._lat_us, ndigits=1)
        if not s:
            return {"avg_latency_us": 0.0}
        return {"avg_latency_us": s["avg"], "p50_latency_us": s["p50"],
                "p95_latency_us": s["p95"], "p99_latency_us": s["p99"],
                "n_latency_samples": s["n"]}

    @property
    def avg_latency_us(self):
        return self.latency_summary_us()["avg_latency_us"]


def build_pipeline(variant: str, duration_sec: float, pardegree1: int,
                   pardegree2: int, win_sec: float = 10.0,
                   chunk: int = 262144, batches=None, on_result=None,
                   opt_level: int = 0, force_device: bool = False,
                   max_delay_ms=None, rich_stats: bool = False, device=None):
    """Assemble the YSB MultiPipe.  `variant`: 'kf' (test_ysb_kf), 'wmr'
    (test_ysb_wmr), or their device forms 'kf-gpu' / 'wmr-gpu', whose
    device stage runs on `device` (the card by default, "cpu" for the
    kernels' plain versions).  Pass `batches` to override the timed
    generator with a deterministic list (tests)."""
    campaigns = CampaignGenerator()
    ad_to_cmp = campaigns.ad_to_cmp
    win_us = int(win_sec * 1e6)

    sent = [0]

    def gen(shipper):
        src = batches if batches is not None else event_batches(
            duration_sec, chunk, campaigns)
        for b in src:
            sent[0] += len(b)
            shipper.push_batch(b)

    def join(b, out):
        # re-key each surviving event by its campaign id (id/ts flow
        # through via the non-in-place Map header copy; payload columns
        # must be forwarded explicitly)
        out["key"] = ad_to_cmp[b["ad_id"]]
        out["revenue"] = b["revenue"]

    start_wall_us = int(time.time() * 1e6)
    sink = YSBSink(start_wall_us, on_result=on_result)

    if variant == "kf":
        agg = KeyFarm(YSBAggregateINC(), win_us, win_us, WinType.TB,
                      pardegree=pardegree2, name="ysb_kf")
    elif variant == "kf-gpu":
        # COUNT + MAX(ts) + SUM(revenue) over device-resident rings.  The
        # revenue sum gives the window stage real device compute (a
        # count + MAX(ts) aggregate is host-free and make_core_for routes
        # it to the host); --force-device is retained as an explicit pin
        # (the default already selects the resident path)
        from ..patterns.win_seq_gpu import KeyFarmGPU
        agg = KeyFarmGPU(device_aggregate(rich=rich_stats), win_us, win_us,
                         WinType.TB,
                         pardegree=pardegree2, batch_len=256,
                         name="ysb_kf_gpu", max_delay_ms=max_delay_ms,
                         use_resident=True if force_device else None,
                         device=device)
    elif variant == "wmr":
        agg = WinMapReduce(YSBAggregate(), YSBReduce(), win_us, win_us,
                           WinType.TB, map_degree=max(pardegree2, 2),
                           name="ysb_wmr", opt_level=opt_level)
    elif variant == "wmr-gpu":
        # Win_MapReduce with the MAP stage device-batched (the reference's
        # Win_MapReduce_GPU per-stage placement, win_mapreduce_gpu.hpp):
        # each MAP partition computes COUNT + MAX(ts) + SUM(revenue) on the
        # resident ring (only revenue ships — pos-max split), REDUCE
        # combines the partials host-side as a multi-field MultiReducer
        from ..ops.functions import MultiReducer, Reducer
        from ..patterns.win_seq_gpu import WinMapReduceGPU
        # NOTE: no value_range on the reduce-stage max — its inputs are
        # MAP partials whose empty-partition identity is iinfo(int64).min,
        # far outside the raw-timestamp range (a declared range would
        # falsely suppress the int32-wrap warning if this stage were ever
        # flipped to reduce_on_device=True)
        reduce_agg = MultiReducer(
            Reducer("sum", "count", "count"),
            Reducer("max", "lastUpdate", "lastUpdate"),
            Reducer("sum", "revenue", "revenue"))
        agg = WinMapReduceGPU(device_aggregate(), reduce_agg, win_us,
                              win_us, WinType.TB,
                              map_degree=max(pardegree2, 2),
                              name="ysb_wmr_gpu", map_on_device=True,
                              reduce_on_device=False, opt_level=opt_level,
                              max_delay_ms=max_delay_ms, device=device)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    if max_delay_ms is not None and not variant.endswith("-gpu"):
        # the host variants' windows close at watermark cadence with no
        # device queueing — there is no flush timer to budget, and
        # accepting the flag silently would let an operator read their
        # latency numbers as budget-bounded when nothing bounded them
        raise ValueError(
            f"--max-delay-ms applies to device variants only (got "
            f"{variant!r}: host windows have no device queue to bound)")

    pipe = (MultiPipe(f"ysb_{variant}")
            .add_source(Source(gen, EVENT_SCHEMA, parallelism=pardegree1,
                               name="ysb_source"))
            .chain(Filter(lambda b: b["event_type"] == 0, vectorized=True,
                          parallelism=pardegree1, name="ysb_filter"))
            .chain(Map(join, vectorized=True, output_schema=JOINED_SCHEMA,
                       parallelism=pardegree1, name="ysb_join"))
            .add(agg)
            .chain_sink(Sink(sink, vectorized=True, name="ysb_sink")))
    return pipe, sink, sent


def wf_check_pipelines():
    """Static-analysis entry (docs/CHECKS.md): a tiny never-run instance
    of the benchmark topology (host KeyFarm variant — the device variants
    share the same shell wiring)."""
    pipe, _sink, _sent = build_pipeline("kf", 0.0, 1, 2, batches=[])
    return [pipe]


def warmup(variant, pardegree1, pardegree2, win_sec, chunk,
           force_device=False, rich_stats=False, device=None):
    """Warm the device path before the timed run: pushes a few synthetic
    chunks through an identical pipeline so the kernels' nvcc builds, the
    native library's build and the first launches (CUDA context, ring
    allocation) fall outside the timed run."""
    campaigns = CampaignGenerator()
    n = [0]

    def fake_clock():
        # advances ~0.4 s per chunk so windows open/fire like a real run
        n[0] += 1
        return n[0] * 0.4

    batches = list(event_batches(4.0, chunk, campaigns, time_fn=fake_clock))
    pipe, _, _ = build_pipeline(variant, 0, pardegree1, pardegree2,
                                win_sec, chunk, batches=batches,
                                force_device=force_device,
                                rich_stats=rich_stats, device=device)
    pipe.run_and_wait_end()


def run(variant="kf", duration_sec=10.0, pardegree1=1, pardegree2=4,
        win_sec=10.0, chunk=262144, warm=None, opt_level=0,
        force_device=False, max_delay_ms=None, rich_stats=False,
        device=None):
    """Run the benchmark; returns the reference's four stdout metrics
    (test_ysb_kf.cpp:113-116).  The device variants run on `device` (the
    card by default)."""
    if warm is None:
        # device variants warm by default: kf-gpu's aggregate carries
        # real device compute (SUM(revenue)) whether or not it is pinned
        warm = variant.endswith("-gpu")
    if warm:
        warmup(variant, pardegree1, pardegree2, win_sec, chunk,
               force_device=force_device, rich_stats=rich_stats,
               device=device)
    pipe, sink, sent = build_pipeline(variant, duration_sec, pardegree1,
                                      pardegree2, win_sec, chunk,
                                      opt_level=opt_level,
                                      force_device=force_device,
                                      max_delay_ms=max_delay_ms,
                                      rich_stats=rich_stats, device=device)
    from ..ops import resident
    resident.stats_snapshot(reset=True)
    t0 = time.perf_counter()
    pipe.run_and_wait_end()
    elapsed = time.perf_counter() - t0
    return {
        "generated": sent[0],
        "results": sink.received,
        **sink.latency_summary_us(),
        "elapsed_sec": round(elapsed, 3),
        "events_per_sec": round(sent[0] / elapsed, 1),
        # sustained source-side rate DURING the generation window: the
        # end-to-end events/sec above divides by elapsed incl. the EOS
        # drain (device variants pay their in-flight launches' service
        # there), while this measures what the pipeline ingests
        # under backpressure while streaming — the steady-state capacity
        # an infinite stream would see.  Both are reported; neither is
        # the other's substitute.
        "gen_events_per_sec": round(sent[0] / max(duration_sec, 1e-9), 1),
        # launch diagnostics: zeros on host-only variants; on device
        # variants they separate launch service from host bookkeeping
        **resident.stats_snapshot(reset=True),
    }


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Yahoo Streaming Benchmark")
    ap.add_argument("-l", "--length", type=float, default=10.0,
                    help="generation time seconds (reference -l)")
    ap.add_argument("-p", "--pardegree1", type=int, default=1)
    ap.add_argument("-w", "--pardegree2", type=int, default=4)
    ap.add_argument("--variant",
                    choices=["kf", "kf-gpu", "wmr", "wmr-gpu"],
                    default="kf")
    ap.add_argument("--win-sec", type=float, default=10.0)
    ap.add_argument("--chunk", type=int, default=262144)
    ap.add_argument("--max-delay-ms", type=float, default=None,
                    help="latency-budget mode: bound the device cores' "
                         "queueing delay via their force-flush timers")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up (device variants warm by "
                         "default: the kernels' nvcc builds and first "
                         "launches fall outside the timed run)")
    ap.add_argument("--opt", type=int, default=0, choices=[0, 1, 2],
                    help="graph optimisation level for the wmr variant "
                         "(optimize_WinMapReduce; LEVEL2 removes the "
                         "MAP-collector/REDUCE-emitter boundary)")
    ap.add_argument("--rich-stats", action="store_true",
                    help="kf-gpu: add MIN(ts) (firstUpdate) to the "
                         "aggregate — free from the position-ordered "
                         "archive, so only revenue still ships")
    ap.add_argument("--force-device", action="store_true",
                    help="kf-gpu: pin the window stage to the device-"
                         "resident ring (the default already routes "
                         "there)")
    a = ap.parse_args(argv)
    if a.rich_stats and a.variant != "kf-gpu":
        raise SystemExit("--rich-stats applies to the kf-gpu variant only")
    m = run(a.variant, a.length, a.pardegree1, a.pardegree2, a.win_sec,
            a.chunk, warm=False if a.no_warmup else None, opt_level=a.opt,
            force_device=a.force_device, max_delay_ms=a.max_delay_ms,
            rich_stats=a.rich_stats)
    print(f"[Main] Total generated messages are {m['generated']}")
    print(f"[Main] Total received results are {m['results']}")
    print(f"[Main] Latency (usec) {m['avg_latency_us']}")
    if "p95_latency_us" in m:
        print(f"[Main] Latency p95/p99 (usec) {m['p95_latency_us']} / "
              f"{m['p99_latency_us']}")
    print(f"[Main] Total elapsed time (seconds) {m['elapsed_sec']}")
    print(f"[Main] Events/sec {m['events_per_sec']} "
          f"(ingest {m['gen_events_per_sec']})")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
