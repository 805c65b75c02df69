#!/usr/bin/env python3
"""The port's ring_append_eval kernel (ops/csrc/resident.cuh) timed on one
GPU at chip_smoke.py's append_eval shapes, its long-window split and chunk
swept.

The shapes are chip_smoke.py's ``ae_shapes`` (seed 23): "ysb_10s" (25
windows of ~325k cells on a 32 x 2^19 int32 ring, an int8 rectangle of
8,192 columns), "ysb_deterministic" (50 windows of ~16.6k cells),
"max_prefix" (8,192 windows of 256 cells) and "mid_windows" (1,024
windows of 1k-8k cells).  Every case is first held against the plain
version and, bit for bit, against ``append_eval_order_twin`` with the
same split and chunk (chip_smoke.check_append_eval); every time is a
CUDA-graph replay with the rings cycled through three times the L2
(cold).  Lines, one JSON object each:

* ``env``: torch, CUDA and the card's name and power limit;
* ``chunk``: each chunk size of CHUNKS (cells, split LONG_SPLIT) at the
  three shapes with long windows;
* ``split``: each split of SPLITS (chunk LONG_CHUNK) at "mid_windows",
  whose windows of 1k-8k cells straddle it;
* ``pair``: the old ring_append + windowed_reduce_many pair and the empty
  launch at every shape, in the same process.

With ``--variants`` it times variants of the kernel instead (``variant``
lines): copies of the csrc/resident* sources with another minimum of
resident blocks an SM in the kernel's launch bounds (kEvalMinBlocks),
other groups in flight a lane (kGroupUnroll) and the rectangle's whole
groups read cell by cell (kBlkGroups = 0; VARIANTS), each built with nvcc
into windflow_tpu_torch/_build/variants/, held against the twin at every
shape and timed cold there, in turns A, B, B, A with the first.

With ``--one-field`` it times ring_append_eval (A) against
ring_append_multi_eval over one field (B) with the same inputs, at every
shape in turns A, B, B, A (``one_field`` lines), after holding the two
equal bit for bit: the same function, with the types fixed at compile
time (A) or switched at run time (B).

Usage, from the repository root on a machine with a CUDA card:

    python3 scripts/torch_append_eval_sweep.py [--variants | --one-field]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHUNKS = (128, 256, 512, 1024, 2048, 4096)
SPLITS = (256, 512, 1024, 2048, 4096, 8192)
#: (kEvalMinBlocks, kGroupUnroll, kBlkGroups) of the kernel's variants,
#: each timed twice in turns A, B, B, A against the first
VARIANTS = ((1, 4, 1), (1, 4, 0), (4, 4, 1), (4, 4, 0), (2, 8, 1))


def build_variant(rk, blocks, unroll, blk_groups):
    """Make rk launch a copy of the csrc/resident* library with other
    constants in resident.cuh (built with nvcc on first use); returns the
    library's path."""
    import re
    import shutil

    from windflow_tpu_torch.ops import _nvcc
    out = os.path.join(_nvcc.BUILD_DIR, "variants",
                       f"resident_b{blocks}_u{unroll}_g{blk_groups}")
    os.makedirs(out, exist_ok=True)
    for name in {u[0] for u in rk.UNITS} | {"resident.cuh"}:
        shutil.copy(os.path.join(_nvcc.CSRC, name), out)
    header = os.path.join(out, "resident.cuh")
    src = open(header).read()
    for name, value in (("kEvalMinBlocks", blocks),
                        ("kGroupUnroll", unroll),
                        ("kBlkGroups", blk_groups)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found in resident.cuh")
    with open(header, "w") as f:
        f.write(src)
    so = _nvcc.build_units("resident", rk.UNITS, headers=("resident.cuh",),
                           csrc=out, out_dir=out)
    rk._lib = None
    rk.build = lambda: so
    return so


def variants(cs, rk, shapes, emit):
    """Each variant after the first in turns A, B, B, A with the first (A),
    every time at every shape."""
    first = VARIANTS[0]
    for v in VARIANTS[1:]:
        for turn, (blocks, unroll, blk_groups) in enumerate(
                (first, v, v, first)):
            build_variant(rk, blocks, unroll, blk_groups)
            row = {}
            for label, case in shapes.items():
                cs.check_append_eval(
                    case, f"{label} variant {blocks}/{unroll}/{blk_groups}")
                row[label] = cold_ms(cs, rk, case)
            emit("variant", turn="ABBA"[turn], kEvalMinBlocks=blocks,
                 kGroupUnroll=unroll, kBlkGroups=blk_groups, **row)


def one_field(cs, rk, shapes, emit):
    """ring_append_eval (A) and a one-field ring_append_multi_eval (B) at
    every shape: first both on copies of the ring, the rings and every
    output equal bit for bit; then timed cold in turns A, B, B, A."""
    import torch
    for label, case in shapes.items():
        c = case
        args = (c["offs"], c["ops"], c["rows"], c["starts"], c["lens"],
                c["pad"])
        rings = [c["ring"].clone() for _ in range(2)]
        a = rk.ring_append_eval(rings[0], c["blk"], *args, long=c["long"])
        b, _t, _m = rk.ring_append_multi_eval(
            [rings[1]], [c["blk"]], c["offs"], [(0, op) for op in c["ops"]],
            *args[2:], long=c["long"])
        torch.cuda.synchronize()
        if not torch.equal(rings[0], rings[1]) or not all(
                torch.equal(x.view(torch.int32), y.view(torch.int32))
                for x, y in zip(a, b)):
            raise AssertionError(f"one_field {label}: ring_append_eval and "
                                 "the one-field multi kernel differ")
        del rings
        ms = {"A": [], "B": []}
        for turn in "ABBA":
            ms[turn].append(cold_ms(cs, rk, case, multi=turn == "B"))
        emit("one_field", case=label, eval_ms=ms["A"], multi_ms=ms["B"])


def cold_ms(cs, rk, case, multi=False):
    """The kernel's time at `case`, cold (chip_smoke.kernel_ms over rings
    cycled through three times the L2); with `multi`, that of
    ring_append_multi_eval over the one field."""
    import torch
    dev = case["ring"].device
    long = case["long"].on(torch.from_numpy(case["long"].vec).to(dev))
    counters = torch.zeros(long.n + 1, dtype=torch.int32, device=dev)
    args = (case["offs"], case["ops"], case["rows"], case["starts"],
            case["lens"], case["pad"])
    evals = [(0, op) for op in case["ops"]]

    def kernel(r):
        if multi:
            rk.ring_append_multi_eval([r], [case["blk"]], case["offs"], evals,
                                      *args[2:], long=long,
                                      counters=counters)
        else:
            rk.ring_append_eval(r, case["blk"], *args, long=long,
                                counters=counters)
    copies = cs.cold_copies(dev, (case["ring"].clone(),))
    ms = cs.kernel_ms(cs.cycled(copies, kernel), reps=10 * len(copies))
    if bool(counters.any()):
        raise AssertionError("a timed launch left a counter set")
    return ms


def replan(rk, case, split, chunk):
    """The case with its long-window list for another split and chunk."""
    long = rk.long_windows(case["rows"].cpu().numpy(),
                           case["starts"].cpu().numpy(),
                           case["lens"].cpu().numpy(), case["pad"],
                           case["ring"].shape[1], split, chunk)
    return dict(case, long=long)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_append_eval_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from windflow_tpu_torch.ops import ring as rk
    from windflow_tpu_torch.ops import windowed_reduce as wr
    rk.build()
    wr.build()
    dev = torch.device(cs.DEVICE)
    emit = lambda kind, **kw: print(json.dumps({"line": kind, **kw}),   # noqa
                                    flush=True)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvidia_smi=cs.nvidia_smi_line())
    shapes = cs.ae_shapes(np.random.default_rng(23), dev)
    if "--one-field" in sys.argv[1:]:
        one_field(cs, rk, shapes, emit)
        emit("env", nvidia_smi=cs.nvidia_smi_line())
        return 0
    if "--variants" in sys.argv[1:]:
        variants(cs, rk, shapes, emit)
        emit("env", nvidia_smi=cs.nvidia_smi_line())
        return 0
    for label in ("ysb_10s", "ysb_deterministic", "mid_windows"):
        for chunk in CHUNKS:
            case = replan(rk, shapes[label], rk.LONG_SPLIT, chunk)
            cs.check_append_eval(case, f"{label} chunk {chunk}")
            emit("chunk", case=label, chunk=chunk, split=rk.LONG_SPLIT,
                 long_windows=case["long"].n, chunks=case["long"].chunks,
                 ms=cold_ms(cs, rk, case))
    for split in SPLITS:
        case = replan(rk, shapes["mid_windows"], split, rk.LONG_CHUNK)
        cs.check_append_eval(case, f"mid_windows split {split}")
        emit("split", case="mid_windows", split=split, chunk=rk.LONG_CHUNK,
             long_windows=case["long"].n, chunks=case["long"].chunks,
             ms=cold_ms(cs, rk, case))
    for label, case in shapes.items():
        row = cs.time_append_eval(case)
        emit("pair", case=label, **row)
    emit("env", nvidia_smi=cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
