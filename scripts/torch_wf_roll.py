"""Twin of scripts/wf_roll.py over the PyTorch/CUDA port (windflow_tpu_torch):
the same CLI and output lines, with every import taken from the port, and
a --native mode whose workers hold device cores.

Zero-downtime rolling restart sequencer for a supervised row plane
(docs/ROBUSTNESS.md "Cross-host recovery"): cycle every stateful worker
process through drain -> seal -> hand-off -> restart while the source
keeps emitting, then verify the merged outputs are byte-identical to the
uncrashed oracle (zero record loss, zero duplication).

The four phases, per rolled worker:

  drain     the feeding MultiPipe's control-plane ``Drain`` actuator
            gates the sources and settles every inbox (quiesce), so no
            new rows are in flight anywhere in the graph
  seal      an epoch barrier is shipped on every plane edge; the worker
            checkpoints its state (CheckpointStore) and acks the sealed
            epoch, trimming the feeder's resume journal to the barrier
  hand-off  the worker exits at the seal WITHOUT an EOS — the feeder's
            journaling senders mark the link down and hold the unsealed
            tail for replay (parallel/channel.py wire resume)
  restart   a fresh process restores the sealed checkpoint and rebinds
            the same plane address with ``resume_epoch=``; the senders
            reconnect and replay exactly the records past the barrier;
            ``release_drain()`` resumes emission

Run the built-in differential (a feeder MultiPipe + 2 worker processes,
each rolled once mid-stream):

    python scripts/torch_wf_roll.py --epochs 8 -v

With --native each worker holds a NativeResidentCore over the ring
kernels on --device (default cuda:0; cpu runs the kernels' plain
versions) at sum_test's width (chip_smoke.py's resident stage: CB
256/64, 64 keys, values 0..99) instead of running sums: the seal drains
the core, writes the epoch's rows, saves the native state blob into the
worker's CheckpointStore and only then acks; the restarted process
restores that blob into a fresh core.  The feeder holds its source at
each roll's epoch, so each roll seals exactly its epoch (ROLL_AT);
the merged rows must equal the uncrashed single-process run per key, in
order, and the total chip_smoke.py's oracle (rolls at epochs 5 and 11):

    python scripts/torch_wf_roll.py --native --tuples 4000000 -v
    python scripts/torch_wf_roll.py --native --device cpu --tuples 65536

Without CUDA and without --device cpu, --native exits 2 and runs nothing.

tests/test_torch_scripts.py runs both (the native one on the CPU);
chip_smoke.py's roll phase runs both on the card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

#: the rolled worker: seal per-epoch running sums, exit at a seal when
#: the roll flag is present (phase A) or resume from a sealed epoch
#: (phase B) — the wf_roll sequencer drives both phases
_WORKER = r"""
import json, os, sys
from windflow_tpu_torch.parallel.channel import RowReceiver, WireResume
from windflow_tpu_torch.recovery.epoch import EpochMarker
from windflow_tpu_torch.recovery.store import CheckpointStore

w = int(sys.argv[1])
port, root, flag = int(sys.argv[2]), sys.argv[3], sys.argv[4]
resume_from = int(sys.argv[5])

store = CheckpointStore(os.path.join(root, f"store{w}"), retain=8)
sums = {}
if resume_from:
    latest = store.latest_complete()
    assert latest is not None and latest[0] == resume_from, latest
    sums = store.load(resume_from, "sums")

recv = RowReceiver(1, port=port, resume=WireResume(deadline=120.0),
                   resume_epoch=(resume_from or None), ack_epochs=False,
                   accept_timeout=60.0)
pending = []
out_f = open(os.path.join(root, f"out{w}.jsonl"), "a")
for item in recv.batches(epoch_markers=True):
    if isinstance(item, EpochMarker):
        e = int(item.epoch)
        n = store.save_blob(e, "sums", dict(sums))
        store.commit(e, {"sums": {"bytes": n}})
        for row in pending:
            out_f.write(json.dumps(row) + "\n")
        out_f.flush()
        os.fsync(out_f.fileno())
        pending = []
        recv.ack_epoch(e)
        if os.path.exists(flag):
            os._exit(0)   # hand-off: exit at the seal, no EOS — the
            #               feeder's journal bridges the restart gap
        continue
    for r in item:
        k, v = int(r["key"]), int(r["value"])
        sums[k] = sums.get(k, 0) + v
        pending.append([k, int(r["id"]), sums[k]])
recv.close()
"""


def _spawn_worker(w, port, root, flag, resume_from, script, env, *extra):
    return subprocess.Popen(
        [sys.executable, script, str(w), str(port), root, flag,
         str(resume_from), *map(str, extra)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def roll_worker(pipe, w, port, workers, senders, state, root, flag,
                script, env, verbose=False, extra=()):
    """One drain -> seal -> hand-off -> restart cycle for worker ``w``;
    returns the epoch the restarted process resumed from.  ``extra``:
    more arguments for the worker script, after the reference's five."""
    from windflow_tpu_torch.recovery.store import CheckpointStore

    if not pipe.request_drain(timeout=60.0):
        raise RuntimeError(f"drain for worker {w} never quiesced")
    # the flag goes down only AFTER quiesce: from here the one marker
    # the worker will see is the sequencer's own seal below, so it
    # exits exactly at the drained barrier
    with open(flag, "w"):
        pass
    # seal: every plane edge gets a barrier at the drained point (the
    # current epoch may be mid-stream — an extra marker is just a finer
    # seal, the per-key stream content is unchanged)
    state["epoch"] += 1
    for snd in senders.values():
        snd.send_epoch(state["epoch"])
    _out, err = workers[w].communicate(timeout=120)
    if workers[w].returncode != 0:
        raise RuntimeError(f"worker {w} failed at hand-off: "
                           f"{err.decode()[-4000:]}")
    sealed = CheckpointStore(os.path.join(root, f"store{w}"),
                             retain=8).latest_complete()
    if sealed is None:
        raise RuntimeError(f"worker {w} left no complete checkpoint")
    os.unlink(flag)
    workers[w] = _spawn_worker(w, port, root, flag, sealed[0], script, env,
                               *extra)
    pipe.release_drain()
    if verbose:
        print(f"rolled worker {w}: sealed epoch {sealed[0]}, "
              f"restarted with resume_epoch={sealed[0]}")
    return sealed[0]


def run_roll(root, n_epochs=8, verbose=False):
    """The built-in differential: a Drain-controlled feeder MultiPipe
    ships a deterministic keyed stream to 2 worker processes; each is
    rolled once mid-stream; merged outputs must equal the uncrashed
    oracle."""
    from windflow_tpu_torch.api import MultiPipe
    from windflow_tpu_torch.control import ControlPolicy, Drain
    from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
    from windflow_tpu_torch.parallel.channel import RowSender, WireResume
    from windflow_tpu_torch.patterns.basic import Sink, Source

    script = os.path.join(root, "roll_worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    env = _child_env()
    ports = _free_ports()
    flags = {w: os.path.join(root, f"roll{w}.flag") for w in (1, 2)}
    workers = {w: _spawn_worker(w, ports[w], root, flags[w], 0, script,
                                env)
               for w in (1, 2)}
    senders = {w: RowSender("127.0.0.1", ports[w],
                            resume=WireResume(deadline=120.0),
                            connect_deadline=60.0)
               for w in (1, 2)}

    schema = Schema(value=np.int64)
    state = {"bi": 0, "epoch": 0}

    def gen():
        for bi in range(2 * n_epochs):
            keys = np.arange(8, dtype=np.int64)
            ids = np.full(8, bi, dtype=np.int64)
            yield batch_from_columns(schema, key=keys, id=ids, ts=ids,
                                     value=7 * ids + keys + 1)
            time.sleep(0.02)   # the source keeps emitting through rolls

    def ship(rows):
        if rows is None:
            return
        keys = np.asarray(rows["key"])
        for w, snd in senders.items():
            m = (1 + keys % 2) == w
            if m.any():
                snd.send(rows[m])
        state["bi"] += 1
        if state["bi"] % 2 == 0:
            state["epoch"] += 1
            for snd in senders.values():
                snd.send_epoch(state["epoch"])

    pipe = (MultiPipe("wf_roll_feeder", capacity=8, metrics=True,
                      control=ControlPolicy([Drain(deadline=60.0,
                                                   poll=0.01)],
                                            period=0.05)))
    pipe.add_source(Source(batches=gen(), schema=schema, name="src"))
    pipe.add_sink(Sink(ship, vectorized=True, name="ship"))
    pipe.run()
    time.sleep(0.3)   # rows flowing before the first roll
    for w in sorted(workers):
        roll_worker(pipe, w, ports[w], workers, senders, state, root,
                    flags[w], script, env, verbose=verbose)
        time.sleep(0.2)
    pipe.wait(timeout=120)
    for snd in senders.values():
        snd.close()
    for w, p in workers.items():
        _out, err = p.communicate(timeout=120)
        if p.returncode != 0:
            raise RuntimeError(f"worker {w} failed after roll: "
                               f"{err.decode()[-2000:]}")

    # uncrashed oracle: per-key running sums over the generated stream
    want, sums = {}, {}
    for bi in range(2 * n_epochs):
        for k in range(8):
            v = 7 * bi + k + 1
            sums[k] = sums.get(k, 0) + v
            want.setdefault(k, []).append([bi, sums[k]])
    got = {}
    for w in (1, 2):
        with open(os.path.join(root, f"out{w}.jsonl")) as f:
            for line in f:
                k, rid, cum = json.loads(line)
                got.setdefault(int(k), []).append([int(rid), int(cum)])
    for rows in got.values():
        rows.sort()
    assert got == want, "rolled outputs diverged from the oracle"
    snap = pipe.metrics.snapshot()
    return {"rolled": sorted(workers),
            "drains": snap["counters"].get("ctl_drains", 0),
            "epochs_sealed": state["epoch"]}


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _free_ports():
    import socket
    ports = {}
    for w in (1, 2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports[w] = s.getsockname()[1]
        s.close()
    return ports


#: the rolled worker of --native: a NativeResidentCore on the device fed
#: from its RowReceiver; at each seal it drains the core, writes the
#: epoch's rows, saves the native state blob and only then acks; exits at
#: a seal when the roll flag is present, or restores a sealed blob into a
#: fresh core and resumes from that epoch
_NATIVE_WORKER = r"""
import json, os, sys, time
import chip_smoke as cs
from windflow_tpu_torch.parallel.channel import RowReceiver, WireResume
from windflow_tpu_torch.recovery.epoch import EpochMarker
from windflow_tpu_torch.recovery.store import CheckpointStore

w = int(sys.argv[1])
port, root, flag = int(sys.argv[2]), sys.argv[3], sys.argv[4]
resume_from, device = int(sys.argv[5]), sys.argv[6]

for wrapper in cs.kernel_wrappers().values():
    wrapper.launches = 0
store = CheckpointStore(os.path.join(root, f"store{w}"), retain=8)
core = cs._worker_core(device)
if resume_from:
    latest = store.latest_complete()
    assert latest is not None and latest[0] == resume_from, latest
    core.state_restore(store.load(resume_from, "core"))
recv = RowReceiver(1, port=port, resume=WireResume(deadline=300.0),
                   resume_epoch=(resume_from or None), ack_epochs=False,
                   accept_timeout=120.0)
bound = time.time()


def finish(**kw):
    cs._sync(device)
    with open(os.path.join(root, f"summary{w}_{resume_from}.json"),
              "w") as f:
        json.dump({"worker": w, "resumed_from": resume_from,
                   "bound": bound, "tuples": tuples,
                   "launches": {n: k.launches for n, k
                                in cs.kernel_wrappers().items()}, **kw}, f)


pending, dtype, tuples = [], None, 0
for item in recv.batches(epoch_markers=True):
    if isinstance(item, EpochMarker):
        e = int(item.epoch)
        pending += core.checkpoint_drain_batches()
        cs._fsync_save(os.path.join(root, f"out{w}_{e:07d}.npy"),
                       cs._concat(pending, dtype))
        pending = []
        n = store.save_blob(e, "core", core.state_snapshot())
        store.commit(e, {"core": {"bytes": n}})
        recv.ack_epoch(e)
        if os.path.exists(flag):
            finish(handoff_epoch=e)
            os._exit(0)   # hand-off at the seal, no EOS
        continue
    dtype = item.dtype
    tuples += len(item)
    pending += core.process_batches(item)
pending += core.flush_batches()
cs._fsync_save(os.path.join(root, f"out{w}_eos.npy"),
               cs._concat(pending, dtype))
recv.close()
finish()
"""


#: the epochs --native rolls worker 1 and worker 2 at
ROLL_AT = (5, 11)


def run_native_roll(root, device="cuda:0", n_tuples=4_000_000,
                    n_epochs=16, verbose=False):
    """--native: a Drain-controlled feeder MultiPipe ships chip_smoke.py's
    adopt_stream (two batches an epoch, key parity picks the worker) to 2
    worker processes that each hold a NativeResidentCore on ``device``;
    worker i is rolled at the seal of epoch ``ROLL_AT[i]`` (the feeder's
    source holds there until the roll is done).  The merged rows must
    equal the uncrashed single-process run per key, in order, and their
    total the oracle; on a card every restarted process must have
    launched the fused ring kernel.  Returns the run's record: wall
    seconds, the sealed epochs, each roll's restart gap (drain request ->
    restarted receiver bound) and every worker process's launches."""
    import threading

    import chip_smoke as cs
    import torch

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.api import MultiPipe
    from windflow_tpu_torch.control import ControlPolicy, Drain
    from windflow_tpu_torch.parallel.channel import RowSender, WireResume
    from windflow_tpu_torch.patterns.basic import Sink, Source
    from windflow_tpu_torch.recovery.store import CheckpointStore

    script = os.path.join(root, "roll_native_worker.py")
    with open(script, "w") as f:
        f.write(_NATIVE_WORKER)
    env = _child_env()
    ports = _free_ports()
    flags = {w: os.path.join(root, f"roll{w}.flag") for w in (1, 2)}
    schema = wt.Schema(value=np.int64)
    batches = cs.adopt_stream(schema, n_tuples, n_epochs)
    # roll i seals epoch ROLL_AT[i] after i earlier roll seals: the source
    # holds before the batch that would open the next data epoch
    holds = {2 * (e - 1 - i): threading.Event()
             for i, e in enumerate(ROLL_AT)}
    held = {b: threading.Event() for b in holds}
    state = {"bi": 0, "epoch": 0}

    def gen():
        for bi, b in enumerate(batches):
            if bi in holds:
                held[bi].set()
                holds[bi].wait()
            yield b

    def ship(rows):
        if rows is None:
            return
        keys = np.asarray(rows["key"])
        for w, snd in senders.items():
            m = (1 + keys % 2) == w
            if m.any():
                snd.send(rows[m])
        state["bi"] += 1
        if state["bi"] % 2 == 0:
            state["epoch"] += 1
            for snd in senders.values():
                snd.send_epoch(state["epoch"])

    t0 = time.perf_counter()
    workers = {w: _spawn_worker(w, ports[w], root, flags[w], 0, script,
                                env, device)
               for w in (1, 2)}
    senders = {w: RowSender("127.0.0.1", ports[w],
                            resume=WireResume(deadline=300.0),
                            connect_deadline=120.0)
               for w in (1, 2)}
    pipe = MultiPipe("wf_roll_native_feeder", capacity=8, metrics=True,
                     control=ControlPolicy([Drain(deadline=120.0,
                                                  poll=0.01)],
                                           period=0.05))
    pipe.add_source(Source(batches=gen(), schema=schema, name="src"))
    pipe.add_sink(Sink(ship, vectorized=True, name="ship"))
    pipe.run()
    rolls = []
    try:
        for w, bi, e in zip((1, 2), holds, ROLL_AT):
            # the source holds with epoch e - 1 shipped; the worker has
            # sealed it, so the only marker it sees after the flag is the
            # roll's own seal
            held[bi].wait(timeout=600)
            store = CheckpointStore(os.path.join(root, f"store{w}"),
                                    retain=8)
            t_end = time.monotonic() + 600
            while (state["epoch"] < e - 1
                   or (store.latest_complete() or (0,))[0] < e - 1):
                if time.monotonic() > t_end:
                    raise RuntimeError(f"worker {w} never sealed epoch "
                                       f"{e - 1}")
                time.sleep(0.005)
            t_drain = time.time()
            sealed = roll_worker(pipe, w, ports[w], workers, senders,
                                 state, root, flags[w], script, env,
                                 verbose=verbose, extra=(device,))
            holds[bi].set()
            if sealed != e:
                raise RuntimeError(f"worker {w} sealed epoch {sealed}, "
                                   f"not {e}")
            rolls.append({"worker": w, "sealed_epoch": sealed,
                          "t_drain": t_drain})
        pipe.wait(timeout=600)
        for snd in senders.values():
            snd.close()
        for w, p in workers.items():
            _out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise RuntimeError(f"worker {w} failed after roll: "
                                   f"{err.decode()[-4000:]}")
    finally:
        for ev in holds.values():
            ev.set()
        for p in workers.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0

    summaries = {}
    for f in sorted(os.listdir(root)):
        if f.startswith("summary"):
            with open(os.path.join(root, f)) as fh:
                s = json.load(fh)
            summaries[(s["worker"], s["resumed_from"])] = s
    merged = [np.load(os.path.join(root, f))
              for f in sorted(os.listdir(root)) if f.startswith("out")]
    merged = [m for m in merged if len(m)]
    _, _, _, single = cs.run_pipeline(cs.resident_stage(wt, device=device),
                                      batches, schema, keep=True)
    total = int(sum(int(m["value"].sum()) for m in merged))
    want = cs.expected_total(batches)
    if total != want or cs.by_key(merged) != cs.by_key(single):
        raise AssertionError(f"rolled native outputs diverged: total "
                             f"{total} (oracle {want}) or the per-key "
                             "rows differ from the uncrashed run")
    on_card = torch.device(device).type == "cuda"
    for r in rolls:
        before = summaries[(r["worker"], 0)]
        after = summaries[(r["worker"], r["sealed_epoch"])]
        r["restart_gap_s"] = after["bound"] - r.pop("t_drain")
        r["fused_before"] = before["launches"]["ring_append_regular_sum"]
        r["fused_after"] = after["launches"]["ring_append_regular_sum"]
        if on_card and not r["fused_after"]:
            raise AssertionError(f"worker {r['worker']}'s restarted "
                                 "process launched no fused kernel")
    launches = {}
    for s in summaries.values():
        for name, n in s["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return {"tuples": n_tuples, "epochs": n_epochs,
            "wall_seconds": wall, "epochs_sealed": state["epoch"],
            "rolls": rolls, "windows": sum(len(m) for m in merged),
            "total": total, "oracle": want, "per_key_identical": True,
            "drains": pipe.metrics.snapshot()["counters"].get(
                "ctl_drains", 0),
            "launches": launches}


def wf_check_pipelines():
    """Static-analysis entry (scripts/torch_wf_lint.py, docs/CHECKS.md): a
    tiny never-run instance of the feeder MultiPipe the roll sequencer
    drives (Drain-controlled source -> shipping sink), with a trace_dir
    so the metrics knob validates clean."""
    import tempfile

    from windflow_tpu_torch.api import MultiPipe
    from windflow_tpu_torch.control import ControlPolicy, Drain
    from windflow_tpu_torch.core.tuples import Schema
    from windflow_tpu_torch.patterns.basic import Sink, Source

    schema = Schema(value=np.int64)
    pipe = MultiPipe("wf_roll_feeder", capacity=8, metrics=True,
                     trace_dir=tempfile.gettempdir(),
                     control=ControlPolicy([Drain(deadline=60.0,
                                                  poll=0.01)],
                                           period=0.05))
    pipe.add_source(Source(batches=[], schema=schema, name="src"))
    pipe.add_sink(Sink(lambda rows: None, vectorized=True, name="ship"))
    return [pipe]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=None,
                    help="stream epochs (default 8; 16 with --native)")
    ap.add_argument("--native", action="store_true",
                    help="workers hold native resident cores on --device")
    ap.add_argument("--device", default="cuda:0",
                    help="--native's device (default cuda:0; cpu runs "
                         "the ring kernels' plain versions)")
    ap.add_argument("--tuples", type=int, default=4_000_000,
                    help="--native's stream length (64 keys)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    import tempfile
    if args.native:
        import torch
        if (torch.device(args.device).type == "cuda"
                and not torch.cuda.is_available()):
            print("torch_wf_roll: no CUDA device visible; pass --device "
                  "cpu to run the native workers on the host",
                  file=sys.stderr)
            return 2
        with tempfile.TemporaryDirectory(prefix="wf_roll_") as root:
            out = run_native_roll(root, device=args.device,
                                  n_tuples=args.tuples,
                                  n_epochs=args.epochs or 16,
                                  verbose=args.verbose)
        print(json.dumps(out))
        print(f"rolling restart OK: native workers [1, 2] cycled at "
              f"epochs {[r['sealed_epoch'] for r in out['rolls']]} over "
              f"{out['epochs_sealed']} sealed epochs, outputs identical "
              f"to the uncrashed run")
        return 0
    with tempfile.TemporaryDirectory(prefix="wf_roll_") as root:
        out = run_roll(root, n_epochs=args.epochs or 8,
                       verbose=args.verbose)
    print(f"rolling restart OK: workers {out['rolled']} cycled with "
          f"{out['drains']} drains over {out['epochs_sealed']} sealed "
          f"epochs, outputs byte-identical to the uncrashed oracle")
    return 0


if __name__ == "__main__":
    sys.exit(main())
