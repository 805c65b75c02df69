"""The host's merge a window: the service of the MAP stage's reorder
collector (``<farm>.collector``) and of the REDUCE stage (the node whose
log counts ``reduce_windows``) over the windows the REDUCE stage fired, in
microseconds.  None where the program keeps no such counter."""


def read(run):
    if not run.nodes:
        return None
    reduce = [n for n in run.nodes.values() if "reduce_windows" in n]
    coll = [n for name, n in run.nodes.items()
            if name.endswith(f"_{run.farm}.collector")]
    windows = sum(n["reduce_windows"] for n in reduce)
    if not windows or not coll:
        return None
    ms = sum(n["svc_time_ms_total"] for n in reduce + coll)
    return 1e3 * ms / windows
