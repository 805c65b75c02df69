"""The Yahoo Streaming Benchmark's campaign windows in plain NumPy: per
campaign and tumbling event-time window, COUNT(*), MAX(ts) and
SUM(revenue) of the view events (yahoo_app.hpp's aggregate, with the
revenue sum the port's device aggregate adds).

The events: event number v (v0, v0 + 1, ...) has ``vm = v % 100000``, ad
``vm % n_ads``, type ``vm % 3`` (0 = view) and revenue ``vm % 97 + 1``
(the recurrences of WindFlow's YSB source, ysb_nodes.hpp); every event of
chunk c carries the time stamp ``ts[c]`` (microseconds).

A chunk's views and revenue of each campaign are told by prefix sums over
one period of ``vm``: what events 0 .. x - 1 hold is ``x // PERIOD``
whole periods and the first ``x % PERIOD`` events of one more.
"""

from __future__ import annotations

import numpy as np

#: the period of an event's fields in its number
PERIOD = 100000


def fields(v, n_ads: int):
    """(ad, type, revenue) of the events numbered `v`."""
    vm = np.asarray(v, dtype=np.int64) % PERIOD
    return vm % n_ads, vm % 3, vm % 97 + 1


def _period_prefix(n_campaigns: int, ads_per_campaign: int):
    """(PERIOD + 1, n_campaigns) views and view revenue of each campaign
    among the first x events of a period, for x = 0 .. PERIOD."""
    ad, typ, rev = fields(np.arange(PERIOD), n_campaigns * ads_per_campaign)
    at = np.nonzero(typ == 0)[0]
    camp = ad[at] // ads_per_campaign
    views = np.zeros((PERIOD + 1, n_campaigns), dtype=np.int64)
    revenue = np.zeros((PERIOD + 1, n_campaigns), dtype=np.int64)
    views[at + 1, camp] = 1
    revenue[at + 1, camp] = rev[at]
    return np.cumsum(views, axis=0), np.cumsum(revenue, axis=0)


def chunk_totals(v0: int, chunk: int, n_chunks: int, n_campaigns: int,
                 ads_per_campaign: int):
    """(n_chunks, n_campaigns) views and view revenue of each chunk."""
    views, revenue = _period_prefix(n_campaigns, ads_per_campaign)
    x = v0 + chunk * np.arange(n_chunks + 1, dtype=np.int64)
    q, r = x // PERIOD, x % PERIOD

    def upto(pre):                    # of events v < x, for each x
        return q[:, None] * pre[PERIOD][None, :] + pre[r]
    return np.diff(upto(views), axis=0), np.diff(upto(revenue), axis=0)


def campaign_windows(v0: int, chunk: int, ts: np.ndarray, n_campaigns: int,
                     ads_per_campaign: int, win_us: int, rev_acc=np.int64):
    """{(campaign, window): (count, max_ts, revenue)} of every non-empty
    window; the revenue accumulated in `rev_acc` (a narrower integer
    wraps as an accumulator of that width would)."""
    ts = np.asarray(ts, dtype=np.int64)
    wins = ts // win_us
    n_w = int(wins.max()) + 1 if len(ts) else 0
    n, rev = chunk_totals(v0, chunk, len(ts), n_campaigns, ads_per_campaign)
    count = np.zeros((n_w, n_campaigns), dtype=np.int64)
    revenue = np.zeros((n_w, n_campaigns), dtype=np.int64)
    last = np.full((n_w, n_campaigns), -1, dtype=np.int64)
    np.add.at(count, wins, n)
    np.add.at(revenue, wins, rev)
    np.maximum.at(last, wins, np.where(n > 0, ts[:, None], -1))
    if rev_acc != np.int64:
        revenue = revenue.astype(rev_acc).astype(np.int64)
    out = {}
    for w, k in zip(*np.nonzero(count)):
        out[(int(k), int(w))] = (int(count[w, k]), int(last[w, k]),
                                 int(revenue[w, k]))
    return out
