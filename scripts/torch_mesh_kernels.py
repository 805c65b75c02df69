"""The two mesh kernels of the port (ops/csrc/mesh_reduce.cu) timed on one
GPU at chip_smoke.py's mesh-step calls, sp_window_partial's split and
chunk swept, and the kernels of another checkout beside them.

The inputs are those of chip_smoke.py's stream step (``mesh_step_inputs``:
a (2, 2^24) int32 buffer, map 3v+1, filter v % 5 != 0): sp shard 0's
slice of group 0 (2^23 rows, base 0) and its keep mask, under wf shard
0's 262,144 CB 256/64 windows ("cb") and wf shard 1's 1,032 long ones
("long"), the int32 sum; the merge folds two int32 partials of 262,144
windows.  Every time is a CUDA-graph replay (chip_smoke.kernel_ms); a
partial is timed cold (its slice and mask cycled through three times the
L2) and hot.  Lines, one JSON object each:

* ``turn`` (with ``--ab DIR``: this checkout B and the one at DIR, A, in
  turns A, B, B, A, each a fresh process in its checkout, its kernels
  built from its own sources): the partial at "cb" and "long", the merge
  of a list of partials on the card and of the stacked (2, B) tensor,
  ``torch.sum(parts, dim=0)`` and the empty launch;
* ``chunk``: the partial at "long" and at 1,032 windows of 8,192 cells for
  each chunk size of CHUNKS (this checkout);
* ``split``: windows of L cells (L in LENGTHS) forced to the team path
  (split above L) and to the block path (split 0), at 1,032 windows and at
  2^24 window cells, hot; the split should sit where the block path
  starts to win.

With ``--variants`` it times variants of this checkout's partial instead
(``variant`` lines): copies of csrc/mesh_reduce.cu with other loads in
flight a lane (kUnroll), windows a team takes in a short block (kPasses)
and a minimum of resident blocks an SM for the partial's launch bounds
(kMinBlocks; VARIANTS), each built with nvcc into
windflow_tpu_torch/_build/variants/, held against the plain version and
timed cold at "cb" and "long".

Usage, from the repository root on a machine with a CUDA card:

    python3 scripts/torch_mesh_kernels.py [--ab DIR | --variants]
"""

import json
import os
import subprocess
import sys

CHUNKS = (128, 256, 512, 1024, 2048)
#: (kUnroll, kMinBlocks, kPasses) of the partial's variants
VARIANTS = ((4, 1, 1), (4, 6, 1), (4, 1, 2), (4, 6, 2), (4, 1, 4),
            (4, 6, 4), (4, 1, 8), (4, 6, 8), (8, 4, 4), (4, 8, 4),
            (8, 1, 1), (8, 6, 1))
LENGTHS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)

# one turn, run inside a checkout (chip_smoke.py and the kernels of that
# checkout; a checkout without the long-window list takes no keyword)
TURN = """
import inspect, json, sys
import numpy as np, torch
import chip_smoke as cs
from windflow_tpu_torch.ops import mesh_reduce as mr
from windflow_tpu_torch.ops import windowed_reduce as wr
mr.build(); wr.build()
dev = torch.device(cs.DEVICE)
flat, starts, lens = cs.mesh_step_inputs()
Ns = flat.shape[1] // cs.MESH_STEP_SHAPE[2]
v = 3 * torch.from_numpy(flat[0, :Ns]).to(dev) + 1
keep = (v % 5 != 0).contiguous()
vals = v.to(torch.int32).contiguous()
CB = len(starts[0]) - cs.MESH_LONG_WINDOWS - cs.MESH_PAST_N
takes_list = "long_windows" in inspect.signature(
    mr.sp_window_partial).parameters
out = {}
for case, sl in (("cb", slice(0, CB)), ("long", slice(CB, None))):
    st = torch.from_numpy(np.ascontiguousarray(starts[0, sl])).to(dev)
    ln = torch.from_numpy(np.ascontiguousarray(lens[0, sl])).to(dev)
    kw = {}
    if takes_list:
        kw["long_windows"] = torch.from_numpy(mr.find_long_windows(
            starts[0, sl], lens[0, sl], 0, Ns)).to(dev)
    copies = cs.cold_copies(dev, (vals, keep))
    out[case + "_cold_ms"] = cs.kernel_ms(cs.cycled(
        copies, lambda a, k: mr.sp_window_partial(a, k, st, ln, 0, "sum",
                                                  **kw)),
        reps=2 * len(copies))
    out[case + "_hot_ms"] = cs.kernel_ms(
        lambda: mr.sp_window_partial(vals, keep, st, ln, 0, "sum", **kw),
        reps=10)
    got = mr.sp_window_partial(vals, keep, st, ln, 0, "sum", **kw)[0]
    want = mr.sp_window_partial_reference(vals, keep, st, ln, 0, "sum")[0]
    assert torch.equal(got, want), case
    del copies
g = np.random.default_rng(5)
parts = torch.from_numpy(g.integers(-1000, 1000, (2, CB)).astype(
    np.int32)).to(dev)
plist = [parts[0].clone(), parts[1].clone()]
out["merge_list_ms"] = cs.kernel_ms(lambda: mr.sp_merge(plist, None, "sum"))
out["merge_stacked_ms"] = cs.kernel_ms(lambda: mr.sp_merge(parts, None,
                                                           "sum"))
assert torch.equal(mr.sp_merge(plist, None, "sum"), parts.sum(0).int())
out["torch_sum_ms"] = cs.kernel_ms(lambda: torch.sum(parts, dim=0))
out["empty_ms"] = cs.kernel_ms(wr.empty_launch, reps=100)
print("TURN " + json.dumps(out))
"""


def run_turn(tree):
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(proc.returncode)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    return json.loads(line[-1][5:])


def sweeps(emit):
    """The chunk and split sweeps of this checkout's partial."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from windflow_tpu_torch.ops import mesh_reduce as mr
    dev = torch.device(cs.DEVICE)
    flat, starts, lens = cs.mesh_step_inputs()
    Ns = flat.shape[1] // cs.MESH_STEP_SHAPE[2]
    v = 3 * torch.from_numpy(flat[0, :Ns]).to(dev) + 1
    keep = (v % 5 != 0).contiguous()
    vals = v.to(torch.int32).contiguous()
    CB = len(starts[0]) - cs.MESH_LONG_WINDOWS - cs.MESH_PAST_N
    g = np.random.default_rng(9)

    def as_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def timed(st, ln, split, cold=False):
        """The partial's time at `split` and mr.CHUNK, held against its
        plain version first."""
        mr.SPLIT = split
        longw = as_dev(mr.find_long_windows(st.cpu().numpy(),
                                            ln.cpu().numpy(), 0, Ns, split))
        got = mr.sp_window_partial(vals, keep, st, ln, 0, "sum",
                                   long_windows=longw)[0]
        want = mr.sp_window_partial_reference(vals, keep, st, ln, 0,
                                              "sum")[0]
        assert torch.equal(got, want), (split, mr.CHUNK)
        if cold:
            copies = cs.cold_copies(dev, (vals, keep))
            return cs.kernel_ms(cs.cycled(
                copies, lambda a, k: mr.sp_window_partial(
                    a, k, st, ln, 0, "sum", long_windows=longw)),
                reps=2 * len(copies))
        return cs.kernel_ms(lambda: mr.sp_window_partial(
            vals, keep, st, ln, 0, "sum", long_windows=longw), reps=10)

    split0, chunk0 = mr.SPLIT, mr.CHUNK
    long_st, long_ln = as_dev(starts[0, CB:]), as_dev(lens[0, CB:])
    mid_ln = np.full(1032, 8192)
    mid_st = as_dev(g.integers(0, Ns - 8192, 1032))
    for chunk in CHUNKS:
        mr.CHUNK = chunk
        emit({"run": "chunk", "chunk": chunk, "split": split0,
              "long_cold_ms": timed(long_st, long_ln, split0, cold=True),
              "long_hot_ms": timed(long_st, long_ln, split0),
              "w1032_l8192_hot_ms": timed(mid_st, as_dev(mid_ln), 0)})
    mr.CHUNK = chunk0
    for L in LENGTHS:
        for B in (1032, (1 << 24) // L):
            st = as_dev(g.integers(0, Ns - L, B))
            ln = as_dev(np.full(B, L))
            emit({"run": "split", "cells": L, "windows": B,
                  "chunk": chunk0, "team_ms": timed(st, ln, 1 << 30),
                  "block_ms": timed(st, ln, 0)})
    mr.SPLIT = split0


def variant_source(unroll, min_blocks, passes):
    """csrc/mesh_reduce.cu with kUnroll = `unroll`, kMinBlocks =
    `min_blocks` (1: no register cap beyond the block's) and kPasses =
    `passes`."""
    from windflow_tpu_torch.ops import _nvcc
    with open(os.path.join(_nvcc.CSRC, "mesh_reduce.cu")) as f:
        src = f.read()
    for name, value in (("kUnroll", unroll), ("kMinBlocks", min_blocks),
                        ("kPasses", passes)):
        head = f"constexpr int {name} = "
        at = src.index(head) + len(head)
        src = src[:at] + str(value) + src[src.index(";", at):]
    return src


def build_variants():
    """Every variant's shared library, built in parallel; {key: path}."""
    from concurrent.futures import ThreadPoolExecutor

    from windflow_tpu_torch.ops import _nvcc
    out_dir = os.path.join(_nvcc.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)

    def one(v):
        name = f"mesh_reduce_u{v[0]}_b{v[1]}_p{v[2]}"
        src = os.path.join(out_dir, name + ".cu")
        with open(src, "w") as f:
            f.write(variant_source(*v))
        so = os.path.join(out_dir, f"lib{name}.so")
        proc = subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-o", so,
                               src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        return so
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(one, VARIANTS)))


def variants(emit):
    """Each variant of the partial held against the plain version and
    timed cold at the mesh step's "cb" and "long" calls."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from windflow_tpu_torch.ops import mesh_reduce as mr
    dev = torch.device(cs.DEVICE)
    base_lib = mr._load()
    libs = build_variants()
    flat, starts, lens = cs.mesh_step_inputs()
    Ns = flat.shape[1] // cs.MESH_STEP_SHAPE[2]
    v = 3 * torch.from_numpy(flat[0, :Ns]).to(dev) + 1
    keep = (v % 5 != 0).contiguous()
    vals = v.to(torch.int32).contiguous()
    CB = len(starts[0]) - cs.MESH_LONG_WINDOWS - cs.MESH_PAST_N
    copies = cs.cold_copies(dev, (vals, keep))
    cases = {}
    for case, sl in (("cb", slice(0, CB)), ("long", slice(CB, None))):
        st, ln = starts[0, sl], lens[0, sl]
        cases[case] = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (st, ln, mr.find_long_windows(st, ln, 0,
                                                              Ns))]
    for key, so in libs.items():
        lib = ctypes.CDLL(so)
        for fn in ("wf_sp_window_partial", "wf_sp_merge"):
            getattr(lib, fn).argtypes = getattr(base_lib, fn).argtypes
            getattr(lib, fn).restype = getattr(base_lib, fn).restype
        mr._lib = lib
        row = {"run": "variant", "unroll": key[0], "min_blocks": key[1],
               "passes": key[2]}
        for case, (st, ln, longw) in cases.items():
            got = mr.sp_window_partial(vals, keep, st, ln, 0, "sum",
                                       long_windows=longw)[0]
            want = mr.sp_window_partial_reference(vals, keep, st, ln, 0,
                                                  "sum")[0]
            assert torch.equal(got, want), (key, case)
            row[case + "_cold_ms"] = cs.kernel_ms(cs.cycled(
                copies, lambda a, k: mr.sp_window_partial(
                    a, k, st, ln, 0, "sum", long_windows=longw)),
                reps=2 * len(copies))
        emit(row)
    mr._lib = base_lib


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="DIR",
                    help="time the other checkout's mesh kernels in turns "
                         "with this one's")
    ap.add_argument("--variants", action="store_true",
                    help="time variants of the partial kernel instead")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    info = {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": cs.nvidia_smi_line()}

    def emit(row):
        print(json.dumps({**row, **info}), flush=True)

    if args.variants:
        variants(emit)
        return 0
    trees = {"B": here}
    if args.ab:
        trees["A"] = os.path.abspath(args.ab)
    for label in (("A", "B", "B", "A") if args.ab else ("B",)):
        emit({"run": "turn", "tree": label, "dir": trees[label],
              **run_turn(trees[label])})
    sweeps(emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
