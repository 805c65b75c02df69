"""Where the time goes in the port's sum_test run on one GPU.

Runs the chip_smoke.py workload (16M tuples, 64 keys, CB 256/64, batch_len
32768) through both device paths and the host core, printing one JSON line
per run:

* ``restaging`` (5 runs): WinSeqGPU(..., use_reduce_kernel=True) on
  cuda:0, end to end;
* ``restaging_profiled``: the same under torch.profiler, with the device's
  busy time per activity (kernels, copies) against the run's wall time;
* ``resident`` (5 runs) and ``resident_profiled``: the same for the
  default route, WinSeqGPU(Reducer("sum", value_range=(0, 100)), ...,
  flush_rows=2**19, depth=48, shards=1) — NativeResidentCore and the ring
  kernels;
* ``resident_phases``: one more resident run with the ship path's phase
  timers on (utils/profile.py: C++ bookkeeping, staging, dispatch, harvest
  wait, backpressure), host seconds per phase;
* ``host_core``: the port's host WinSeq core on the same stream — the floor
  the Python window bookkeeping sets without any device work.

With ``--spatial`` it profiles the spatial skyline instead (chip_smoke.py's
deterministic 640,000-point spatial_test stream, TB 4,000/1,000 points,
WinFarmGPU(device_skyline(), pardegree=2, batch_len=256)):

* ``spatial_resident`` / ``spatial_restaging`` (3 runs each): the
  resident route (per-field float32 rings) and the restaging route, end
  to end;
* ``*_profiled``: the same under torch.profiler: device busy share and
  the device time split into skyline_windows, window_gather, ring_append,
  other kernels (the rings' zero fill, casts), host-to-device and
  device-to-host copies;
* ``spatial_resident_phases``: host seconds per phase of the executor's
  launches (staging, dispatch, harvest wait);
* ``spatial_host_core``: the port's host WinSeq(SkylineWindow()) over the
  stream's first 16 windows — the host skyline's cost per window.

With ``--apps`` it runs chip_smoke.py's app phases with their timed runs
under torch.profiler (each after its warm-up, outside the profiler and the
launch counts), adding to each phase line the device busy ms, split into
copies and kernels, and its share of the profiled block's wall time:

* ``ysb_timed`` (kf-gpu, wmr-gpu): apps.ysb.run for APPS_YSB_SEC = 40 s
  of full-speed generation (100 campaigns, TB 10 s, pardegree2 4), so
  each campaign has 4 windows and 3 of them close under the watermark
  before the end of the stream (chip_smoke.py's own 10 s run closes its
  one window a campaign at the end of the stream): the app's metrics
  (events/s, p95/p99 latency, launch diagnostics) and the kernels'
  launches;
* ``pipe_test``: one timed apps.pipe run of 8M tuples (its total and
  window count held against expected());
* ``layers``: the layered sum_test run (16M tuples through KeyFarmGPU
  rescaled 2 -> 4 -> 2 under check=, trace=, recovery= and control=,
  beside the fixed-width run) with all of chip_smoke.py's checks.

With ``--ab DIR`` it compares this checkout (B) with another checkout of
the repository at DIR (A, e.g. the parent commit unpacked with ``git
archive``) on one card, in turns A, B, B, A: each turn is a fresh process
in its checkout (its own kernels, built from its own sources) and prints
one ``ab`` line with the rows of chip_smoke.py's windowed-reduce phase
(the restaging shape, and where that checkout's chip_smoke.py measures
them its cold times and the empty-launch floor), of
its ring-kernel phase (the fused ring_append_regular_sum, ring_append at
that shape), of its gather and skyline phases, ring_append at the inputs
of the spatial resident run's launches (where that checkout's
chip_smoke.py records them; since the per-field fusion the rectangles of
its ring_append_multi_eval calls, and that kernel at the largest call),
sum_test's resident tuples/s with the ring
kernels' launch counts of those runs, the spatial stream's points/s on the
resident and restaging routes (3 runs each after a warm-up), the
irregular evaluation of sum, min, max and prod over 32768 windows of a
64 x 262144 int32 ring, and the 4M native _multi run's windowed_reduce
launches and device time, and its ring_append_multi_eval launches and
device time where the checkout has the kernel (under torch.profiler).

Usage, from the repository root on a machine with a CUDA card:

    python3 scripts/torch_sum_test_profile.py [--spatial | --apps | --ab DIR]
"""

import contextlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402  (the workload's one definition)
import windflow_tpu_torch as wt  # noqa: E402
from windflow_tpu_torch.ops import resident  # noqa: E402
from windflow_tpu_torch.utils import profile as phases  # noqa: E402

# YSB's timed runs under --apps: 4 windows a campaign, 3 of them closed by
# the watermark before the end of the stream
APPS_YSB_SEC = 40.0


def restaging_stage():
    return wt.WinSeqGPU(wt.Reducer("sum"), cs.WIN, cs.SLIDE, wt.WinType.CB,
                        batch_len=cs.BATCH_LEN, use_reduce_kernel=True,
                        device="cuda:0")


def resident_stage():
    return cs.resident_stage(wt)


def device_busy(prof):
    """Device time (ms) by activity name, from the profiler's events."""
    busy = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            busy[ev.key] = busy.get(ev.key, 0.0) + t / 1e3
    return busy


def split(busy):
    """Device ms as host-to-device copies, kernels and device-to-host
    copies (other device work, e.g. memsets, separately)."""
    out = {"h2d_ms": 0.0, "kernel_ms": 0.0, "d2h_ms": 0.0, "other_ms": 0.0}
    for name, ms in busy.items():
        low = name.lower()
        if "htod" in low:
            out["h2d_ms"] += ms
        elif "dtoh" in low:
            out["d2h_ms"] += ms
        elif "memcpy" in low or "memset" in low:
            out["other_ms"] += ms
        else:
            out["kernel_ms"] += ms
    return out


def split_spatial(busy):
    """Device ms of the spatial path by kernel and copy direction."""
    out = {"skyline_ms": 0.0, "gather_ms": 0.0, "append_ms": 0.0,
           "other_kernel_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0,
           "other_copy_ms": 0.0}
    for name, ms in busy.items():
        low = name.lower()
        key = ("h2d_ms" if "htod" in low else
               "d2h_ms" if "dtoh" in low else
               "other_copy_ms" if "memcpy" in low or "memset" in low else
               "skyline_ms" if "skyline" in low else
               "gather_ms" if "gather" in low else
               "append_ms" if "ring_append" in low else "other_kernel_ms")
        out[key] += ms
    return out


def spatial_main(device, smi):
    from windflow_tpu_torch.apps.spatial import (POINT_SCHEMA,
                                                 SkylineWindow,
                                                 device_skyline)
    batches = cs.spatial_stream()

    def farm(**kw):
        return wt.WinFarmGPU(device_skyline(), cs.SP_WIN, cs.SP_SLIDE,
                             wt.WinType.TB, pardegree=cs.SP_PARDEGREE,
                             batch_len=cs.SP_BATCH, device="cuda:0", **kw)

    routes = (("spatial_resident", dict(use_resident=True)),
              ("spatial_restaging", {}))
    for label, kw in routes:
        cs.run_rows(farm(**kw), batches[:64], POINT_SCHEMA)   # warm-up
    for label, kw in routes:
        for _ in range(3):
            dt, rows = cs.run_rows(farm(**kw), batches, POINT_SCHEMA)
            print(json.dumps({"run": label, "seconds": dt,
                              "points_per_s": cs.SP_POINTS / dt,
                              "windows": len(rows),
                              "windows_per_s": len(rows) / dt,
                              "device": device, "nvidia_smi": smi}),
                  flush=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dt, rows = cs.run_rows(farm(**kw), batches, POINT_SCHEMA)
        busy = device_busy(prof)
        print(json.dumps({"run": f"{label}_profiled", "seconds": dt,
                          "device_busy_ms": sum(busy.values()),
                          "device_busy_share": sum(busy.values())
                          / (dt * 1e3),
                          **split_spatial(busy), "by_activity_ms": busy,
                          "device": device, "nvidia_smi": smi}), flush=True)
    phases.reset()
    phases.enable()
    dt, rows = cs.run_rows(farm(use_resident=True), batches, POINT_SCHEMA)
    phases.auto()
    print(json.dumps({"run": "spatial_resident_phases", "seconds": dt,
                      "phases_s_calls": phases.report(),
                      "counters": phases.counters(), "device": device,
                      "nvidia_smi": smi}), flush=True)
    n_prefix = (cs.SP_PREFIX_WINDOWS - 1) * cs.SP_SLIDE + cs.SP_WIN
    prefix = [b[b["ts"] < n_prefix]
              for b in batches[:n_prefix // cs.SP_CHUNK + 1]]
    dt, rows = cs.run_rows(wt.WinSeq(SkylineWindow(), cs.SP_WIN, cs.SP_SLIDE,
                                     wt.WinType.TB), prefix, POINT_SCHEMA)
    print(json.dumps({"run": "spatial_host_core", "seconds": dt,
                      "windows": len(rows), "points": n_prefix,
                      "ms_per_window": 1e3 * dt / len(rows),
                      "nvidia_smi": smi}), flush=True)
    return 0


# one turn of --ab, run inside a checkout (chip_smoke.py of that checkout)
AB_TURN = """
import json, torch
import chip_smoke as cs
import windflow_tpu_torch as wt
from windflow_tpu_torch.apps.spatial import POINT_SCHEMA, device_skyline
from windflow_tpu_torch.ops import ring as rk
from windflow_tpu_torch.ops import windowed_reduce as wr
cs.build_all()
dev = torch.device(cs.DEVICE)
out = {"windowed_reduce": cs.kernel_phase(wr, dev),
       "ring": cs.ring_kernel_phase(dev), "gather": cs.gather_phase(dev),
       "skyline": cs.skyline_phase(dev)}
schema = wt.Schema(value=cs.np.int64)
cs.run_pipeline(cs.resident_stage(wt), cs.make_stream(schema,
                                                      cs.PREFIX_TUPLES),
                schema)
stream = cs.make_stream(schema, cs.N_TUPLES)
counters = [getattr(rk, n) for n in ("ring_append_regular_sum",
            "ring_append") if hasattr(rk, n)] + [wr.windowed_reduce]
for c in counters:
    c.launches = 0
out["sum_test_resident_tuples_per_s"] = [
    cs.N_TUPLES / cs.run_pipeline(cs.resident_stage(wt), stream, schema)[0]
    for _ in range(3)]
out["sum_test_resident_launches"] = {c.__name__: c.launches
                                     for c in counters}
batches = cs.spatial_stream()
def farm(**kw):
    return wt.WinFarmGPU(device_skyline(), cs.SP_WIN, cs.SP_SLIDE,
                         wt.WinType.TB, pardegree=cs.SP_PARDEGREE,
                         batch_len=cs.SP_BATCH, device=cs.DEVICE, **kw)
for name, kw in (("resident", {"use_resident": True}), ("restaging", {})):
    cs.run_rows(farm(**kw), batches[:64], POINT_SCHEMA)
    out[name + "_points_per_s"] = [
        cs.SP_POINTS / cs.run_rows(farm(**kw), batches, POINT_SCHEMA)[0]
        for _ in range(3)]
if hasattr(cs, "recorded_multi_evals"):
    # the per-field step in one launch: its calls, and ring_append at
    # their rectangles
    with cs.recorded_multi_evals() as calls:
        cs.run_rows(farm(use_resident=True), batches, POINT_SCHEMA)
    out["ring_append_spatial"] = cs.ring_append_phase(
        dev, cs.rectangles_of(calls))
    out["multi_eval_spatial"] = cs.multi_eval_row(calls, "spatial_resident")
    del calls
elif hasattr(cs, "recorded_appends"):
    with cs.recorded_appends() as calls:
        cs.run_rows(farm(use_resident=True), batches, POINT_SCHEMA)
    out["ring_append_spatial"] = cs.ring_append_phase(dev, calls)
# the irregular evaluation: sum, min, max and prod of 32768 windows on a
# 64 x 262144 int32 ring, in one launch (or, in a checkout without
# windowed_reduce_many, one launch an op on the ring's flat view)
g = cs.np.random.default_rng(1)
ring = torch.from_numpy(g.integers(0, 100, size=(cs.KP, cs.CAP))).to(
    dev, torch.int32)
as32 = lambda a: torch.from_numpy(a).to(dev, torch.int32)
rows_ = as32(g.integers(0, cs.KP, size=cs.BATCH_LEN))
starts = as32(g.integers(0, cs.CAP - cs.WIN, size=cs.BATCH_LEN))
lens = as32(g.integers(0, cs.WIN + 1, size=cs.BATCH_LEN))
ops = ("sum", "min", "max", "prod")
if hasattr(wr, "windowed_reduce_many"):
    ring_ops = lambda: wr.windowed_reduce_many([(ring, op) for op in ops],
                                               rows_, starts, lens, cs.WIN)
else:
    flat_starts = (rows_.long() * cs.CAP + starts).to(torch.int32)
    ring_ops = lambda: [wr.windowed_reduce(ring.view(-1), flat_starts, lens,
                                           cs.WIN, op) for op in ops]
out["irregular_4ops_ms"] = cs.kernel_ms(ring_ops)
del ring
from torch.profiler import ProfilerActivity, profile
before = wr.windowed_reduce.launches
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    cs.multi_field_native(wr, rk)
out["multi_windowed_reduce_launches"] = wr.windowed_reduce.launches - before
out["multi_windowed_reduce_device_ms"] = sum(
    (getattr(ev, "device_time_total", 0) or 0) / 1e3
    for ev in prof.key_averages() if "windowed_reduce" in ev.key)
# the fused per-field kernel where the checkout has it
fused = getattr(rk, "ring_append_multi_eval", None)
out["multi_fused_launches"] = fused.launches if fused else None
out["multi_fused_device_ms"] = sum(
    (getattr(ev, "device_time_total", 0) or 0) / 1e3
    for ev in prof.key_averages() if "multi_eval_kernel" in ev.key)
print("AB " + json.dumps(out))
"""


def ab_main(other, device, smi):
    import subprocess
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"A": os.path.abspath(other), "B": here}
    for label in ("A", "B", "B", "A"):
        proc = subprocess.run([sys.executable, "-c", AB_TURN],
                              cwd=trees[label], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("AB ")][-1]
        print(json.dumps({"run": "ab", "tree": label, "dir": trees[label],
                          **json.loads(line[3:]), "device": device,
                          "nvidia_smi": smi}), flush=True)
    return 0


@contextlib.contextmanager
def device_busy_share():
    """Runs the block under torch.profiler; on exit the yielded dict holds
    the device busy ms (split into copies and kernels) and their share of
    the block's wall time."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the block alone: not the profiler's start (seconds, the first
        # time in a process) nor its teardown
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    busy = device_busy(prof)
    out.update(profiled_seconds=seconds,
               device_busy_ms=sum(busy.values()),
               device_busy_share=sum(busy.values()) / (seconds * 1e3),
               **split(busy), by_activity_ms=busy)


def apps_main(device, smi):
    """chip_smoke.py's ysb_timed (at APPS_YSB_SEC), pipe_test and layers
    phases, their timed runs under the profiler."""
    print(json.dumps({"run": "apps", "device": device, "nvidia_smi": smi}),
          flush=True)
    cs.ysb_timed(APPS_YSB_SEC, around=device_busy_share)
    cs.pipe_test(around=device_busy_share)
    cs.layers(around=device_busy_share)
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spatial", action="store_true",
                    help="profile the spatial skyline path instead")
    ap.add_argument("--apps", action="store_true",
                    help="profile the YSB device variants, pipe_test and "
                         "the layered sum_test instead")
    ap.add_argument("--ab", metavar="DIR",
                    help="compare the windowed-reduce, ring, gather and "
                         "skyline kernels, sum_test's resident route, the "
                         "spatial run and the _multi run with the checkout "
                         "at DIR, in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    device = torch.cuda.get_device_name(0)
    smi = cs.nvidia_smi_line()
    if args.ab:
        return ab_main(args.ab, device, smi)
    if args.spatial:
        return spatial_main(device, smi)
    if args.apps:
        return apps_main(device, smi)
    schema = wt.Schema(value=cs.np.int64)
    batches = cs.make_stream(schema, cs.N_TUPLES)
    want = cs.expected_total(batches)
    prefix = cs.make_stream(schema, cs.PREFIX_TUPLES)
    for make in (restaging_stage, resident_stage):
        # warm-up: kernel build, CUDA context, pinned pool, native library
        cs.run_pipeline(make(), prefix, schema)

    for label, make in (("restaging", restaging_stage),
                        ("resident", resident_stage)):
        for _ in range(5):
            resident.stats_snapshot(reset=True)
            dt, n, total, _ = cs.run_pipeline(make(), batches, schema)
            assert total == want, (total, want)
            print(json.dumps({"run": label, "tuples_per_s": cs.N_TUPLES / dt,
                              "seconds": dt, "windows": n,
                              "stats": resident.stats_snapshot(reset=True),
                              "device": device, "nvidia_smi": smi}),
                  flush=True)

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dt, n, total, _ = cs.run_pipeline(make(), batches, schema)
        assert total == want, (total, want)
        busy = device_busy(prof)
        print(json.dumps({"run": f"{label}_profiled", "seconds": dt,
                          "device_busy_ms": sum(busy.values()),
                          "device_busy_share": sum(busy.values())
                          / (dt * 1e3),
                          **split(busy), "by_activity_ms": busy,
                          "device": device, "nvidia_smi": smi}), flush=True)

    phases.reset()
    phases.enable()
    dt, n, total, _ = cs.run_pipeline(resident_stage(), batches, schema)
    phases.auto()
    assert total == want, (total, want)
    print(json.dumps({"run": "resident_phases", "seconds": dt,
                      "phases_s_calls": phases.report(),
                      "counters": phases.counters(), "device": device,
                      "nvidia_smi": smi}), flush=True)

    host = wt.WinSeq(wt.Reducer("sum"), cs.WIN, cs.SLIDE, wt.WinType.CB)
    dt, n, total, _ = cs.run_pipeline(host, batches, schema)
    assert total == want, (total, want)
    print(json.dumps({"run": "host_core", "tuples_per_s": cs.N_TUPLES / dt,
                      "seconds": dt, "windows": n, "nvidia_smi": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
