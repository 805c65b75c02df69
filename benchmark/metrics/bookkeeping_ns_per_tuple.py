"""The C++ window bookkeeping's time (the program's ``native_bookkeeping``
span, summed over the replicas' threads) over the records consumed."""


def read(run):
    span = (run.spans or {}).get("native_bookkeeping")
    if not span or not run.records:
        return None
    return 1e9 * span[0] / run.records
