"""Host time to stage and launch one dispatch: the program's
``device_put`` and ``dispatch`` spans over its dispatch count."""


def read(run):
    spans = run.spans or {}
    n = (run.stats or {}).get("dispatches", 0)
    if not n or "dispatch" not in spans:
        return None
    s = spans["dispatch"][0] + spans.get("device_put", (0.0, 0))[0]
    return 1e6 * s / n
