"""Twin of scripts/soak_wire.py over the PyTorch/CUDA port
(windflow_tpu_torch): the same CLI, seeds, cases and output lines, with
every import taken from the port.

Seeded wire-chaos soak: a resumable two-sender row plane driven
through randomized :class:`~windflow_tpu_torch.parallel.faults.FaultPlan`
schedules (kill / torn frame / duplicated delivery / stalled socket),
checked *differentially* — the receiver's per-key arrival order must be
byte-identical to the unfaulted oracle (docs/ROBUSTNESS.md "Wire
resume").

Mirrors the soak_crash.py pattern: standalone, seeded, and any failure
is reproducible in isolation:

    python scripts/torch_soak_wire.py --n 50 --seed 7        # the soak
    python scripts/torch_soak_wire.py --seed 7 --case 12     # one repro

The test suite runs a small slow-marked slice of this via
tests/test_torch_channel_faults.py (tier-1 excludes it with -m 'not slow').
"""

import argparse
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def run_case(seed: int, case: int, verbose: bool = False) -> dict:
    """One randomized wire-chaos case: two resumable senders partition a
    keyed stream to one receiver (the partition_and_ship shape), each
    sender under its own seeded FaultPlan; per-key arrival order must
    equal the generation-order oracle.  Raises AssertionError with the
    repro command on any divergence."""
    from windflow_tpu_torch.core.tuples import Schema, batch_from_columns
    from windflow_tpu_torch.parallel.channel import (RowReceiver, RowSender,
                                                     WireResume,
                                                     partition_and_ship)
    from windflow_tpu_torch.parallel.faults import FaultPlan

    rng = np.random.default_rng((seed, case))
    schema = Schema(value=np.int64)
    n_batches = int(rng.integers(8, 24))
    rows = int(rng.integers(4, 16))
    n_keys = int(rng.integers(2, 8))
    epoch_batches = int(rng.integers(2, 8))
    kinds = ["kill", "torn", "dup"]
    if rng.random() < 0.25:
        kinds.append("stall")
    n_faults = int(rng.integers(1, 4))
    # ~records per sender: its share of the batches + epoch frames
    horizon = max(4, n_batches + n_batches // epoch_batches + 2)
    plans = [FaultPlan.seeded(int(rng.integers(0, 2**31)),
                              horizon=horizon, n_faults=n_faults,
                              kinds=tuple(kinds), stall_for=0.3)
             for _ in range(2)]
    params = dict(n_batches=n_batches, rows=rows, n_keys=n_keys,
                  epoch_batches=epoch_batches,
                  plans=[repr(p) for p in plans])
    repro = f"python scripts/torch_soak_wire.py --seed {seed} --case {case}"
    if verbose:
        print(f"case {case}: {params}")

    # the keyed stream (generation order IS the per-key oracle order)
    batches, oracle = [], {}
    ctr = 0
    for _ in range(n_batches):
        ks = rng.integers(0, n_keys, rows)
        vals = np.arange(ctr, ctr + rows)
        ctr += rows
        batches.append(batch_from_columns(
            schema, key=ks, id=vals, ts=vals, value=vals))
        for k, v in zip(ks.tolist(), vals.tolist()):
            oracle.setdefault(k, []).append(v)

    rs = WireResume(deadline=15.0)
    recv = RowReceiver(n_senders=2, resume=rs, ack_epochs=True)
    got, errs = {}, []

    def consume():
        try:
            for b in recv.batches(epoch_markers=True):
                if not isinstance(b, np.ndarray):
                    continue   # EpochMarker (completed barrier => ack)
                for r in b:
                    got.setdefault(int(r["key"]), []).append(
                        int(r["value"]))
        except Exception as e:   # surfaced in the assert below
            errs.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    senders = {s: RowSender("127.0.0.1", recv.port, resume=rs,
                            faults=plans[s], connect_deadline=10.0)
               for s in range(2)}
    # key % 2 owns the sender; my_pid=2 owns nothing, so every row ships
    epoch = 0
    for i, b in enumerate(batches):
        partition_and_ship(b, np.asarray(b["key"]) % 2, 2, senders)
        if (i + 1) % epoch_batches == 0:
            epoch += 1
            for snd in senders.values():
                snd.send_epoch(epoch)
    for snd in senders.values():
        snd.close()
    t.join(timeout=60)
    assert not t.is_alive(), f"{repro}: receiver hung (params {params})"
    assert not errs, f"{repro}: receiver raised {errs[0]!r} ({params})"
    recv.close()
    assert got == {k: v for k, v in oracle.items() if v}, (
        f"{repro}: per-key arrival order diverged from the oracle "
        f"(params {params})")
    return params


def wf_check_pipelines():
    """Static-analysis entry (scripts/torch_wf_lint.py, docs/CHECKS.md): the
    wire bundle the chaos cases run — heartbeat paired with a stall
    timeout, resume journaling paired with receiver epoch tracking."""
    from windflow_tpu_torch.parallel.channel import WireConfig
    return [WireConfig(connect_deadline=10.0, heartbeat=2.0,
                       stall_timeout=10.0, resume=True, recovery=True)]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=50, help="number of cases")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--case", type=int, default=None,
                    help="run exactly one case (repro mode)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if args.case is not None:
        run_case(args.seed, args.case, verbose=True)
        print("OK")
        return
    for case in range(args.n):
        run_case(args.seed, case, verbose=args.verbose)
        if (case + 1) % 10 == 0:
            print(f"{case + 1}/{args.n} cases OK")
    print(f"all {args.n} cases OK")


if __name__ == "__main__":
    main()
