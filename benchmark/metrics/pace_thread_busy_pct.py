"""The busiest thread before the window stage, in percent of the window,
from the engine's own counters (NodeStats, node logs): a source counts its
``generate`` time, every other node its service time, each less the time
it spent blocked in puts into the next stage's full inbox.  The key farm's
replicas, its collector and the sink are left out, as in
``pre_window_busy_pct``.  None where the program keeps no such counters."""

import re


def read(run):
    if not run.nodes or not run.window_s:
        return None
    if not all("put_wait_ms_total" in n for n in run.nodes.values()):
        return None
    skip = re.compile(r"_\d+_(" + re.escape(run.farm)
                      + r"\.(\d+|collector)|sink\.\d+)$")
    busy = []
    for name, n in run.nodes.items():
        if skip.search(name):
            continue
        if "generate_ms_total" in n:
            busy.append(n["generate_ms_total"] - n["put_wait_ms_total"])
        elif n["rcv_batches"]:
            busy.append(n["svc_time_ms_total"] - n["put_wait_ms_total"])
    if not busy:
        return None
    return 100.0 * max(busy) / 1e3 / run.window_s
