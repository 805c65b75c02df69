"""One minus the union of the device's busy intervals (kernels, copies,
memsets; torch.profiler) over the profiled sub-window, in percent."""


def read(run):
    from benchmark import devtrace
    return devtrace.idle_pct(run)
