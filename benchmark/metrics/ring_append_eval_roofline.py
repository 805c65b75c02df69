"""The ring kernel's share of its roofline: the mean least time of a
recorded launch (its bytes at 3.35 TB/s or its operations at 67 TF/s,
``bounds.py``) over the mean device time of a launch of that kernel in
the profiled sub-window, in percent."""

#: the device kernel of each recorded entry
KERNELS = {"ring_append_eval": "append_eval_kernel"}


def read(run):
    from benchmark import bounds
    if not run.launch_costs or not run.device_ops:
        return None
    least = [bounds.least_s(b, o) for _, b, o in run.launch_costs]
    names = {KERNELS[n] for n, _, _ in run.launch_costs}
    times = [d / 1e6 for name, _, d in run.device_ops
             if any(k in name for k in names)]
    if not times:
        return None
    return 100.0 * (sum(least) / len(least)) / (sum(times) / len(times))
