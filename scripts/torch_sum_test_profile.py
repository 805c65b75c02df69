"""Where the time goes in the port's sum_test run on one GPU.

Runs the chip_smoke.py workload (16M tuples, 64 keys, CB 256/64, batch_len
32768) three ways and prints one JSON line each:

* ``gpu``: WinSeqGPU(..., use_reduce_kernel=True) on cuda:0, end to end;
* ``gpu_profiled``: the same under torch.profiler, with the device's busy
  time per activity (kernels, copies) against the run's wall time;
* ``host_core``: the port's host WinSeq core on the same stream — the
  floor the Python window bookkeeping sets without any device work.

Usage, from the repository root on a machine with a CUDA card:

    python3 scripts/torch_sum_test_profile.py
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402  (the workload's one definition)
import windflow_tpu_torch as wt  # noqa: E402
from windflow_tpu_torch.ops import windowed_reduce as wr  # noqa: E402


def gpu_stage():
    return wt.WinSeqGPU(wt.Reducer("sum"), cs.WIN, cs.SLIDE, wt.WinType.CB,
                        batch_len=cs.BATCH_LEN, use_reduce_kernel=True,
                        device="cuda:0")


def device_busy(prof):
    """Device time (ms) by activity name, from the profiler's events."""
    busy = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            busy[ev.key] = busy.get(ev.key, 0.0) + t / 1e3
    return busy


def main():
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    schema = wt.Schema(value=cs.np.int64)
    batches = cs.make_stream(schema, cs.N_TUPLES)
    want = cs.expected_total(batches)
    device = torch.cuda.get_device_name(0)
    smi = cs.nvidia_smi_line()
    cs.run_pipeline(gpu_stage(), cs.make_stream(schema, cs.PREFIX_TUPLES),
                    schema)   # warm-up: kernel build, CUDA context, pinned pool

    for label in ("gpu", "gpu"):
        wr.windowed_reduce.launches = 0
        dt, n, total, _ = cs.run_pipeline(gpu_stage(), batches, schema)
        assert total == want, (total, want)
        print(json.dumps({"run": label, "tuples_per_s": cs.N_TUPLES / dt,
                          "seconds": dt, "windows": n,
                          "launches": wr.windowed_reduce.launches,
                          "device": device, "nvidia_smi": smi}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dt, n, total, _ = cs.run_pipeline(gpu_stage(), batches, schema)
    assert total == want, (total, want)
    busy = device_busy(prof)
    print(json.dumps({"run": "gpu_profiled", "seconds": dt,
                      "device_busy_ms": sum(busy.values()),
                      "device_busy_share": sum(busy.values()) / (dt * 1e3),
                      "by_activity_ms": busy, "device": device,
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
