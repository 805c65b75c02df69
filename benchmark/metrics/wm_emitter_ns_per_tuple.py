"""The WinMap emitter's time a tuple: the node ``<farm>.emitter``'s
service less its time blocked in puts into the MAP replicas' inboxes, over
the tuples it received (the engine's NodeStats, node logs).  None where
the program keeps no WinMap emitter counters (``wm_assign_ms_total``)."""


def read(run):
    if not run.nodes:
        return None
    for name, n in run.nodes.items():
        if (name.endswith(f"_{run.farm}.emitter")
                and "wm_assign_ms_total" in n and n["rcv_tuples"]):
            return (1e6 * (n["svc_time_ms_total"] - n["put_wait_ms_total"])
                    / n["rcv_tuples"])
    return None
