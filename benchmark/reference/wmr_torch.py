"""YSB through Win_MapReduce in plain PyTorch (CPU tensors, int64): the
MAP replicas' partials and the REDUCE merge of each window's partials.

The events are those of ``ysb_windows``: event number v (v0, v0 + 1,
...) has ``vm = v % 100000``, ad ``vm % n_ads``, type ``vm % 3`` (0 =
view) and revenue ``vm % 97 + 1``; a view's key is its ad's campaign,
``ad // ads_per_campaign``; every event of chunk c carries the stamp
``ts[c]`` (microseconds, non-decreasing).

The MAP assignment is WindFlow's (wm_nodes.hpp:101-110): a key's views go
round robin over the ``map_degree`` replicas, starting at ``key %
map_degree``, in arrival order, the count carried across chunks and
windows.  Replica i gives each key a partial for every tumbling window
from 0 to the window of the key's last view (that view is broadcast to
every replica at the end of the stream), COUNT, MAX(ts) and SUM(revenue)
of its views there: over no view COUNT 0, MAX ``EMPTY_MAX``, SUM 0.  Its
k-th partial of a key has the dense id ``i + k * map_degree``.  The
REDUCE stage merges the ``map_degree`` partials of each window (ids
``w * map_degree`` .. ``w * map_degree + map_degree - 1``); the sink keeps
the windows that hold a view.
"""

from __future__ import annotations

import torch

#: the period of an event's fields in its number
PERIOD = 100000
#: MAX(ts) of a partition with no view: the port's identity of max
EMPTY_MAX = torch.iinfo(torch.int64).min
I64 = torch.int64


def chunk_views(v0: int, chunk: int, c: int, n_campaigns: int,
                ads_per_campaign: int):
    """(key, revenue) of chunk c's views, in arrival order."""
    v = v0 + c * chunk + torch.arange(chunk, dtype=I64)
    vm = v % PERIOD
    vm = vm[vm % 3 == 0]
    return (vm % (n_campaigns * ads_per_campaign)) // ads_per_campaign, \
        vm % 97 + 1


def map_partials(v0: int, chunk: int, ts, n_campaigns: int,
                 ads_per_campaign: int, win_us: int, map_degree: int):
    """Every MAP partial, as a dict of (m,) int64 tensors ``key``, ``id``
    (dense), ``count``, ``lastUpdate`` and ``revenue``, ordered by key and
    id."""
    n, K = map_degree, n_campaigns
    ts = torch.as_tensor(ts, dtype=I64)
    if len(ts) > 1 and bool((ts[1:] < ts[:-1]).any()):
        raise ValueError("chunk stamps must not decrease")
    wins = ts // win_us
    W = int(wins.max()) + 1 if len(ts) else 0
    count = torch.zeros((W, K * n), dtype=I64)
    revenue = torch.zeros((W, K * n), dtype=I64)
    last = torch.full((W, K * n), EMPTY_MAX, dtype=I64)
    seen = torch.zeros(K, dtype=I64)              # each key's views so far
    last_w = torch.full((K,), -1, dtype=I64)      # its last view's window
    for c in range(len(ts)):
        key, rev = chunk_views(v0, chunk, c, n_campaigns, ads_per_campaign)
        per_key = torch.bincount(key, minlength=K)
        order = torch.argsort(key, stable=True)
        first = torch.cumsum(per_key, 0) - per_key
        rank = torch.empty_like(key)
        rank[order] = torch.arange(len(key), dtype=I64) - first[key[order]]
        slot = key * n + (key % n + seen[key] + rank) % n
        seen += per_key
        w = int(wins[c])
        count[w].index_add_(0, slot, torch.ones_like(slot))
        revenue[w].index_add_(0, slot, rev)
        hit = torch.bincount(slot, minlength=K * n) > 0
        last[w] = torch.where(hit, torch.clamp(last[w], min=int(ts[c])),
                              last[w])
        last_w = torch.where(per_key > 0, torch.clamp(last_w, min=w), last_w)
    # (K, W, n): key-major, then dense id w * n + i
    shape = (W, K, n)
    cube = [x.view(shape).permute(1, 0, 2) for x in (count, last, revenue)]
    due = (torch.arange(W, dtype=I64)[None, :, None]
           <= last_w[:, None, None]).expand(K, W, n)
    key = torch.arange(K, dtype=I64)[:, None, None].expand(K, W, n)
    dense = (torch.arange(W, dtype=I64)[None, :, None] * n
             + torch.arange(n, dtype=I64)[None, None, :]).expand(K, W, n)
    return {"key": key[due], "id": dense[due], "count": cube[0][due],
            "lastUpdate": cube[1][due], "revenue": cube[2][due]}


def reduce_windows(partials: dict, map_degree: int) -> dict:
    """The REDUCE merge: {(key, window): (count, max_ts, revenue)} of every
    window whose partials hold a view, window = dense id // map_degree."""
    key = torch.as_tensor(partials["key"], dtype=I64)
    wid = torch.as_tensor(partials["id"], dtype=I64) // map_degree
    if not len(key):
        return {}
    n_w = int(wid.max()) + 1
    cell = key * n_w + wid
    cells, at = torch.unique(cell, return_inverse=True)
    m = len(cells)
    count = torch.zeros(m, dtype=I64).index_add_(
        0, at, torch.as_tensor(partials["count"], dtype=I64))
    revenue = torch.zeros(m, dtype=I64).index_add_(
        0, at, torch.as_tensor(partials["revenue"], dtype=I64))
    last = torch.full((m,), EMPTY_MAX, dtype=I64).scatter_reduce_(
        0, at, torch.as_tensor(partials["lastUpdate"], dtype=I64), "amax")
    out = {}
    for j in torch.nonzero(count > 0).flatten().tolist():
        k, w = divmod(int(cells[j]), n_w)
        out[(k, w)] = (int(count[j]), int(last[j]), int(revenue[j]))
    return out


def campaign_windows(v0: int, chunk: int, ts, n_campaigns: int,
                     ads_per_campaign: int, win_us: int,
                     map_degree: int) -> dict:
    """The merged windows of the MAP partials: what the sink receives."""
    return reduce_windows(
        map_partials(v0, chunk, ts, n_campaigns, ads_per_campaign, win_us,
                     map_degree), map_degree)
