"""The Yahoo Streaming Benchmark through the port's YSB app
(``windflow_tpu_torch.apps.ysb.build_pipeline``: Source -> Filter(views)
-> Join(ad -> campaign) -> key farm of device window cores (COUNT, MAX(ts),
SUM(revenue) over tumbling event-time windows) -> Sink), fed by the
benchmark's own event generator: WindFlow's YSB recurrences from a
seeded first event number, event time the generator's clock.

An event's fields other than its number and time depend only on its
number modulo ``PERIOD``, so set-up builds them once, as a pool of
``PERIOD + chunk`` rows, and a chunk in the window is a copy of the
pool's slice with the numbers and the time stamp written in."""

from __future__ import annotations

import numpy as np

from benchmark.reference import ysb_windows

#: the period of the events' fields in the event number (ysb_nodes.hpp's
#: ``v % 100000``)
PERIOD = ysb_windows.PERIOD


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        from windflow_tpu_torch.apps import ysb
        from windflow_tpu_torch import batch_from_columns
        self.ysb, self.batch = ysb, batch_from_columns
        self.cfg, self.device, self.C = config, device, mix["chunk"]
        rng = np.random.default_rng(np.random.SeedSequence(seed % 2 ** 64))
        self.v0 = int(rng.integers(0, 2 ** 40))
        self.n_ads = config["n_campaigns"] * config["ads_per_campaign"]
        self.win_us = int(config["win_sec"] * 1e6)
        self.farm = "ysb_kf_gpu"
        v = np.arange(PERIOD + self.C, dtype=np.int64)
        ad, typ, rev = ysb_windows.fields(v, self.n_ads)
        self.pool = self.batch(
            self.ysb.EVENT_SCHEMA, key=np.zeros(len(v), dtype=np.int64),
            id=v, ts=np.zeros(len(v), dtype=np.int64), ad_id=ad,
            event_type=typ.astype(np.int8), revenue=rev)
        # copied as whole rows of bytes: numpy copies a structured array
        # field by field, several times slower
        self.rows = self.pool.view(np.dtype((np.void,
                                             self.pool.dtype.itemsize)))
        self.step = np.arange(self.C, dtype=np.int64)

    def warm_chunks(self):
        # event time advancing warm_event_s a chunk, so that windows close
        # inside the warm-up as they do in the window
        step = self.cfg["warm_event_s"]
        return [self.make_chunk(c, c * step)
                for c in range(self.cfg["warm_chunks"])]

    def make_chunk(self, c: int, t: float) -> np.ndarray:
        first = self.v0 + c * self.C
        off = first % PERIOD
        b = self.rows[off:off + self.C].copy().view(self.pool.dtype)
        b["id"] = self.step + first
        b["ts"] = int(t * 1e6)
        return b

    def pipeline(self, chunks, on_rows):
        cfg = self.cfg
        pipe, _sink, _sent = self.ysb.build_pipeline(
            cfg["variant"], 0, cfg["pardegree1"], cfg["pardegree2"],
            cfg["win_sec"], self.C, batches=chunks, on_result=on_rows,
            device=self.device)
        return pipe

    @staticmethod
    def columns(rows):
        return rows["key"], rows["id"], np.stack(
            [rows["count"], rows["lastUpdate"], rows["revenue"]], axis=1)

    def expected(self, paced, acc=None):
        cfg = self.cfg
        ts = (np.asarray(paced.due) * 1e6).astype(np.int64)
        want = ysb_windows.campaign_windows(
            self.v0, self.C, ts, cfg["n_campaigns"], cfg["ads_per_campaign"],
            self.win_us, rev_acc=np.int64 if acc is None else acc)
        n_w = max((w for _, w in want), default=-1) + 1
        index = np.full((cfg["n_campaigns"], n_w), -1, dtype=np.int64)
        vals = np.zeros((len(want), 3), dtype=np.int64)
        for i, ((k, w), v) in enumerate(sorted(want.items())):
            index[k, w] = i
            vals[i] = v
        return index, vals
