"""The plain references against brute force, and the frozen copies
against the originals in chip_smoke.py, at tiny sizes."""

import numpy as np
import pytest
import torch

from benchmark import bounds
from benchmark.reference import compare, ysb_windows


def test_ysb_windows_brute_force():
    v0, chunk = 123457, 1000
    ts = np.array([0, 400_000, 999_999, 1_000_000, 2_500_000, 2_600_000])
    got = ysb_windows.campaign_windows(v0, chunk, ts, 100, 10, 1_000_000)
    want = {}
    for c, t in enumerate(ts):
        for g in range(c * chunk, (c + 1) * chunk):
            vm = (v0 + g) % 100000
            if vm % 3:
                continue
            key = ((vm % 1000) // 10, int(t) // 1_000_000)
            n, last, rev = want.get(key, (0, -1, 0))
            want[key] = (n + 1, max(last, int(t)), rev + vm % 97 + 1)
    assert got == want
    narrow = ysb_windows.campaign_windows(v0, chunk, ts, 100, 10, 1_000_000,
                                          rev_acc=np.int8)
    assert any(narrow[k][2] != want[k][2] for k in want)


@pytest.mark.parametrize("v0,chunk,n", [(0, 1000, 7), (2 ** 40 - 3, 150_001, 5),
                                        (99_999, 262_144, 3)])
def test_ysb_chunk_totals_equal_each_chunks_events(v0, chunk, n):
    views, revenue = ysb_windows.chunk_totals(v0, chunk, n, 100, 10)
    for c in range(n):
        ad, typ, rev = ysb_windows.fields(
            v0 + np.arange(c * chunk, (c + 1) * chunk), 1000)
        camp = ad[typ == 0] // 10
        assert (views[c] == np.bincount(camp, minlength=100)).all()
        assert (revenue[c] == np.bincount(camp, weights=rev[typ == 0],
                                          minlength=100)).all()


def test_ysb_windows_against_chip_smoke_oracle():
    import chip_smoke as cs
    n = 3 * 262_144
    chunk = 1024
    ts = np.arange(n // chunk) * chunk * cs.YSB_TS_STEP_US
    # one stamp a chunk: the chunk's first event's, as cs.ysb_batches has
    # per event; compare on windows no chunk straddles
    got = ysb_windows.campaign_windows(0, chunk, ts, 100, 10,
                                       int(cs.YSB_WIN_SEC * 1e6))
    want = cs.ysb_oracle(n)
    counts = {k: v[0][0] for k, v in want.items()}
    assert {k: got[(k, 0)][0] for k in range(100)} == counts


def test_compare_counts_each_fault():
    index = np.arange(12).reshape(3, 4)
    want = np.arange(12) * 10
    key, wid = np.nonzero(index >= 0)
    ok = compare.compare(key, wid, want[index[key, wid]], index, want)
    assert compare.passed(ok) and ok["expected"] == 12
    vals = want[index[key, wid]].copy()
    vals[5] += 1
    assert compare.compare(key, wid, vals, index, want)["wrong"] == 1
    r = compare.compare(key[1:], wid[1:], want[index[key, wid]][1:], index,
                        want)
    assert r["missing"] == 1 and not compare.passed(r)
    k2, w2 = np.r_[key, 2], np.r_[wid, 3]
    r = compare.compare(k2, w2, want[index[k2, w2]], index, want)
    assert r["extra"] == 1 and r["out_of_order"] == 1
    sw = np.r_[1, 0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    r = compare.compare(key[sw], wid[sw], want[index[key, wid]][sw], index,
                        want)
    assert r["out_of_order"] == 1 and r["wrong"] == 0
    r = compare.compare(np.r_[key, 7], np.r_[wid, 0],
                        np.r_[want[index[key, wid]], 0], index, want)
    assert r["extra"] == 1


@pytest.mark.parametrize("seed", range(6))
def test_append_eval_bytes_equal_chip_smoke(seed):
    import chip_smoke as cs
    gen = np.random.default_rng(seed)
    KP, cap, Rb, B = 6, 4096, 128, 40
    case = {"ring": torch.zeros((KP, cap), dtype=torch.int32),
            "blk": torch.zeros((KP, Rb), dtype=torch.int16),
            "offs": torch.from_numpy(gen.integers(0, cap - Rb, KP)),
            "rows": torch.from_numpy(gen.integers(0, KP, B)),
            "starts": torch.from_numpy(gen.integers(0, cap, B)),
            "lens": torch.from_numpy(gen.integers(0, 900, B)), "pad": 1024,
            "ops": ["sum", "count", "max"][:1 + seed % 3]}
    want = cs.append_eval_bound(case)
    got = bounds.append_eval(KP, cap, 4, Rb, 2, case["offs"].numpy(),
                             case["ops"], case["rows"].numpy(),
                             case["starts"].numpy(), case["lens"].numpy(),
                             1024)
    assert got[0] == want[2]
    assert bounds.least_s(*got) * 1e3 == pytest.approx(want[0])
