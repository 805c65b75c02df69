"""The Filter and the out-schema Map move rows as whole rows of bytes
(``patterns/basic.py``: ``_row_type``, ``_header_types``) where the dtypes
show that a row's bytes are exactly its fields, and field by field
otherwise.  Both paths must give byte-identical batches of the same dtype,
leave their input as it was, and say in the node log's counter which path
each batch took."""

import numpy as np
import pytest

from windflow_tpu_torch.core.tuples import Schema
from windflow_tpu_torch.patterns import basic
from windflow_tpu_torch.patterns.basic import Filter, Map
from windflow_tpu_torch.utils.tracing import NodeStats

IN = Schema(ad_id=np.int64, event_type=np.int8, revenue=np.int64,
            tag=np.float32)
OUT = Schema(revenue=np.int64, cmp=np.int32, spare=np.float64)
N = 257


def events(n=N, markers=False, dtype=None):
    """`n` rows of `IN` with distinct bytes in every field; `dtype` lays
    the same fields out another way."""
    b = np.zeros(n, dtype=dtype or IN.dtype())
    i = np.arange(n)
    b["key"] = i % 5
    b["id"] = i + 1000
    b["ts"] = i * 37 - 3
    b["ad_id"] = (i * 7919) % 1000
    b["event_type"] = i % 3
    b["revenue"] = i % 97 + 1
    b["tag"] = i / 3.0
    if markers:
        b["marker"][::4] = True
    return b


def node(pattern, states=True):
    """A replica of `pattern`, keeping its node log's counter."""
    (rep,) = pattern.replicas()
    rep.stats = NodeStats(rep.name, states=states)
    rep.svc_init()
    return rep


def run(rep, batch):
    got = []
    rep.emit = got.append
    rep.svc(batch)
    return got


@pytest.fixture
def field_path(monkeypatch):
    """Take the field path for every dtype."""
    def force():
        monkeypatch.setattr(basic, "_row_type", lambda dt: None)
        monkeypatch.setattr(basic, "_header_types", lambda a, b: None)
    return force


SURVIVORS = {
    "none": lambda i: np.zeros(len(i), dtype=bool),
    "all": lambda i: np.ones(len(i), dtype=bool),
    "alternate": lambda i: i % 2 == 0,
    "one": lambda i: i == 3,
}


def make_filter(keep, vectorized):
    if vectorized:
        return Filter(lambda b: keep(b["id"] - 1000), vectorized=True)
    return Filter(lambda r: bool(keep(np.asarray([r["id"] - 1000]))[0]))


@pytest.mark.parametrize("markers", [False, True])
@pytest.mark.parametrize("survivors", sorted(SURVIVORS))
@pytest.mark.parametrize("vectorized", [True, False])
def test_filter_bytes_equal_fields(vectorized, survivors, markers,
                                   field_path):
    keep = SURVIVORS[survivors]
    batch = events(markers=markers)
    before = batch.tobytes()
    fast = node(make_filter(keep, vectorized))
    got = run(fast, batch)
    field_path()
    slow = node(make_filter(keep, vectorized))
    want = run(slow, batch)
    assert batch.tobytes() == before
    assert len(got) == len(want) == (survivors != "none")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == batch.dtype
        assert g.tobytes() == w.tobytes()
        assert g.tobytes() == batch[keep(np.arange(N))].tobytes()
        assert not np.shares_memory(g, batch)
    assert fast._moves == [1, 0]
    assert slow._moves == [0, 1]


def join(b, out):
    out["cmp"] = b["ad_id"] // 10
    out["revenue"] = b["revenue"]          # `spare` is left unset


def join_row(r, o):
    o["cmp"] = r["ad_id"] // 10
    o["revenue"] = r["revenue"]


@pytest.mark.parametrize("rows", ["fresh", "strided", "empty"])
@pytest.mark.parametrize("markers", [False, True])
@pytest.mark.parametrize("vectorized", [True, False])
def test_out_schema_map_bytes_equal_fields(vectorized, markers, rows,
                                           field_path):
    fn = join if vectorized else join_row
    batch = events(markers=markers)
    batch = {"fresh": batch, "strided": batch[1::3],
             "empty": batch[:0]}[rows]
    before = batch.tobytes()

    def make():
        return Map(fn, vectorized=vectorized, output_schema=OUT)

    fast = node(make())
    (got,) = run(fast, batch)
    field_path()
    slow = node(make())
    (want,) = run(slow, batch)
    assert batch.tobytes() == before
    assert got.dtype == want.dtype == OUT.dtype()
    assert got.tobytes() == want.tobytes()
    for f in ("key", "id", "ts", "marker", "revenue"):
        np.testing.assert_array_equal(got[f], batch[f])
    assert not got["spare"].any()
    assert fast._moves == [1, 0]
    assert slow._moves == [0, 1]


def test_chained_filter_and_map_leave_a_shared_input_unmodified():
    """The Filter's input is not fresh (its producer may hold it): the
    byte path reads it and writes only new arrays."""
    batch = events(markers=True)
    before = batch.tobytes()
    flt = node(Filter(lambda b: b["event_type"] == 0, vectorized=True))
    mp = node(Map(join, vectorized=True, output_schema=OUT))
    assert not flt.input_fresh and not mp.input_fresh
    got = []
    flt.emit = mp.svc
    mp.emit = got.append
    for _ in range(3):
        flt.svc(batch)
    assert batch.tobytes() == before
    keep = batch[batch["event_type"] == 0]
    assert [g.tobytes() for g in got] == [got[0].tobytes()] * 3
    np.testing.assert_array_equal(got[0]["id"], keep["id"])
    np.testing.assert_array_equal(got[0]["cmp"], keep["ad_id"] // 10)
    assert flt._moves == mp._moves == [3, 0]


def aligned():
    return np.dtype(IN.dtype().descr, align=True)


def reordered():
    """The Schema's fields, the header not first: no Schema makes it."""
    d = IN.dtype()
    names = ["ad_id", "key", "id", "ts", "marker", "event_type", "revenue",
             "tag"]
    return np.dtype([(n, d[n]) for n in names])


def with_object():
    return np.dtype(IN.dtype().descr + [("note", object)])


@pytest.mark.parametrize("make_dtype", [aligned, reordered, with_object])
def test_dtypes_off_the_byte_path_take_fields(make_dtype, field_path):
    """A Filter takes bytes for a structured dtype with no padding and no
    object; the Map where the Schema header's fields sit at the same
    offsets with the same types in both dtypes (an aligned input keeps
    them at 0..25).  Padding, a header elsewhere or an object field take
    the field path, and the counter says so; the results are today's."""
    dt = make_dtype()
    batch = events(dtype=dt)
    before = batch.tobytes() if not dt.hasobject else None
    keep = batch["event_type"] == 0
    flt = node(Filter(lambda b: b["event_type"] == 0, vectorized=True))
    (got,) = run(flt, batch)
    assert got.dtype == dt
    for f in dt.names:
        np.testing.assert_array_equal(got[f], batch[f][keep])
    assert flt._moves == ([1, 0] if make_dtype is reordered else [0, 1])
    mp = node(Map(join, vectorized=True, output_schema=OUT))
    (out,) = run(mp, batch)
    for f in ("key", "id", "ts", "marker", "revenue"):
        np.testing.assert_array_equal(out[f], batch[f])
    assert mp._moves == ([1, 0] if make_dtype is aligned else [0, 1])
    if before is not None:
        assert batch.tobytes() == before
    field_path()
    (want,) = run(node(Map(join, vectorized=True, output_schema=OUT)), batch)
    assert out.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", ["unstructured", "recarray"])
def test_other_filter_inputs_take_the_field_path(kind):
    """No fields, or an ndarray subclass (which the field path keeps)."""
    if kind == "unstructured":
        batch = np.arange(50, dtype=np.int64)
        fn = lambda b: b % 3 == 1          # noqa: E731
    else:
        batch = events().view(np.recarray)
        fn = lambda b: b.event_type == 0   # noqa: E731
    flt = node(Filter(fn, vectorized=True))
    (got,) = run(flt, batch)
    want = batch[fn(batch)]
    assert type(got) is type(want)
    assert got.tobytes() == want.tobytes()
    assert flt._moves == [0, 1]


def test_a_mask_of_the_wrong_length_raises_as_before():
    batch = events()
    flt = node(Filter(lambda b: np.ones(len(b) - 1, dtype=bool),
                      vectorized=True))
    with pytest.raises(IndexError):
        run(flt, batch)


@pytest.mark.parametrize("states", [True, False])
def test_counter_only_with_node_logs(states):
    flt = node(Filter(lambda b: b["event_type"] == 0, vectorized=True),
               states=states)
    mp = node(Map(join, vectorized=True, output_schema=OUT), states=states)
    inplace = node(Map(lambda b: None, vectorized=True), states=states)
    for rep in (flt, mp, inplace):
        run(rep, events())
    assert inplace._moves is None
    if states:
        assert flt.stats.snapshot()["batches_by_bytes"] == {flt.name: 1}
        assert mp.stats.snapshot()["batches_by_fields"] == {mp.name: 0}
        assert inplace.stats.moves is None
    else:
        for rep in (flt, mp, inplace):
            assert rep._moves is None and rep.stats.moves is None
            assert "batches_by_bytes" not in rep.stats.snapshot()


def test_plans_are_worked_out_once_a_dtype(monkeypatch):
    seen = []
    row_type = basic._row_type.__wrapped__
    monkeypatch.setattr(basic, "_row_type",
                        lambda dt: seen.append(dt) or row_type(dt))
    flt = node(Filter(lambda b: b["event_type"] == 0, vectorized=True))
    batch = events()
    for _ in range(4):
        run(flt, batch)
    run(flt, events(dtype=aligned()))
    assert seen == [batch.dtype, aligned()]
    assert flt._moves == [4, 1]
