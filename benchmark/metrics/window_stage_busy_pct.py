"""The key farm's replicas' service time (the engine's per-node
``NodeStats.svc_time_ns_total``) over replicas x window, in percent."""

import re


def read(run):
    if not run.nodes:
        return None
    pat = re.compile(r"_\d+_" + re.escape(run.farm) + r"\.\d+$")
    svc = [n["svc_time_ms_total"] for name, n in run.nodes.items()
           if pat.search(name)]
    if not svc:
        return None
    return 100.0 * sum(svc) / 1e3 / (len(svc) * run.window_s)
