"""The source's fused chain a record: the Source shell, and the stages
fused after it (YSB's Filter and Join), without the generator's time and
without blocked puts.  The source node's ``push_ms_total`` less its
``put_wait_ms_total`` (the engine's NodeStats, node logs) over the records
consumed.  None where the program keeps no such counters."""


def read(run):
    if not run.nodes or not run.records:
        return None
    srcs = [n for n in run.nodes.values() if "push_ms_total" in n]
    if not srcs:
        return None
    ms = sum(n["push_ms_total"] - n["put_wait_ms_total"] for n in srcs)
    return 1e6 * ms / run.records
