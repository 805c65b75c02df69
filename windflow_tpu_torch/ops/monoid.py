"""One source of truth for the built-in monoid reductions: identities and
reducer tables shared by the host path (numpy, ops/functions.py) and the
device path (ops/device.py, ops/windowed_reduce.py).

Semantics of the identity (what an *empty* window produces, matching the
reference's behaviour of leaving the result default-initialised): sum and
count give 0, prod gives 1, min/max give the dtype extremes — ``±inf`` for
floats, ``iinfo`` bounds for integers.
"""

from __future__ import annotations

import numpy as np

OPS = ("sum", "count", "mean", "min", "max", "prod")


def identity(op: str, dtype):
    """Monoid identity of `op` in `dtype` (accepts numpy or torch dtypes)."""
    dt = np.dtype(_numpy_dtype(dtype))
    if op in ("sum", "count", "mean"):
        return dt.type(0)
    if op == "prod":
        return dt.type(1)
    if op not in ("min", "max"):
        raise ValueError(f"unknown op {op!r}")
    if dt.kind == "f":
        return dt.type(np.inf if op == "min" else -np.inf)
    info = np.iinfo(dt)
    return dt.type(info.max if op == "min" else info.min)


def _numpy_dtype(dtype):
    """numpy dtype of a numpy or torch dtype (torch.int32 -> np.int32)."""
    if type(dtype).__module__ == "torch":
        import torch
        return torch.empty(0, dtype=dtype).numpy().dtype
    return dtype


#: numpy ufuncs for the host fold (count has no ufunc: it counts rows)
NP_UFUNCS = {
    "sum": np.add,
    "min": np.minimum,
    "max": np.maximum,
    "prod": np.multiply,
}


def torch_ufunc(op: str):
    """The torch pairwise combiner for `op` (count combines like sum —
    partial counts add)."""
    import torch
    return {"sum": torch.add, "count": torch.add, "mean": torch.add,
            "min": torch.minimum, "max": torch.maximum,
            "prod": torch.mul}[op]


def torch_reducer(op: str):
    """The torch reducer for `op`, called as ``fn(x, dim=...)`` (mean/count
    handled by the callers from masks).  ``mean`` maps to ``torch.sum``
    like the reference's table, so callers divide by the count."""
    import torch
    return {"sum": torch.sum, "mean": torch.sum, "min": torch.amin,
            "max": torch.amax, "prod": torch.prod}[op]
