"""The busiest thread before the window stage, in percent of the window,
each without the time it spent inside an inbox put (blocked by the next
stage): the source's thread (making chunks, and the stages fused into it:
YSB's Filter and Join), and each node between it and the key farm's
replicas (the farm's emitter; the engine's NodeStats service time)."""

import re


def read(run):
    if not run.nodes or run.put_s is None:
        return None
    skip = re.compile(r"_\d+_(" + re.escape(run.farm)
                      + r"\.(\d+|collector)|sink\.\d+)$")
    busy = [run.source_busy_s]
    for name, n in run.nodes.items():
        if skip.search(name) or not n["rcv_batches"]:
            continue
        put = sum(s for t, s in run.put_s.items()
                  if name.endswith("_" + t.split("/", 1)[-1]))
        busy.append(n["svc_time_ms_total"] / 1e3 - put)
    return 100.0 * max(busy) / run.window_s
