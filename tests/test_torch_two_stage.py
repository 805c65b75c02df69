"""The two-stage device patterns through both packages on the same seeded
streams: the port's PaneFarmGPU / WinMapReduceGPU (and the farms and
nestings around them, device="cpu": the ring kernels' plain versions)
against the JAX package's PaneFarmTPU / WinMapReduceTPU (its resident and
restaging device paths on the CPU backend, as its own tests run them),
and both against the host WinSeq.  Results are compared per key in order:
the port must equal JAX row for row (id, ts, value), and the (id, value)
pairs must equal the host WinSeq's (a two-stage pattern's result ts is its
last stage's, not WinSeq's)."""

import numpy as np
import pytest

from windflow_tpu.api.builders import LEVEL1, LEVEL2
from windflow_tpu.core.windows import WinType as JWinType
from windflow_tpu.ops.functions import Reducer as JReducer
from windflow_tpu.patterns import nesting as jnest
from windflow_tpu.patterns import win_seq_tpu as jw
from windflow_tpu.patterns.win_seq import WinSeq as JWinSeq
import windflow_tpu_torch as wt
from windflow_tpu_torch.runtime.engine import Dataflow
from windflow_tpu_torch.runtime.farm import build_pipeline

from test_farms import cb_stream_batches, run_windowed, tb_stream_batches
from test_pane_wmr import iv

pytestmark = pytest.mark.filterwarnings(
    "ignore:resident device path accumulates:UserWarning")

KEYS, N = 3, 140
WIN, SLIDE = 12, 4          # sliding, pane-decomposable (slide < win)


def stream(kind):
    return (cb_stream_batches(KEYS, N) if kind == "CB"
            else tb_stream_batches(KEYS, N))


def run_port(pattern, batches):
    """Source -> pattern -> Sink through the port; per-key ordered
    (id, ts, value) results, the shape test_farms.run_windowed returns."""
    per_key = {}

    def snk(row):
        if row is not None:
            per_key.setdefault(int(row["key"]), []).append(
                (int(row["id"]), int(row["ts"]), int(row["value"])))

    df = Dataflow()
    build_pipeline(df, [wt.Source(batches=iter(batches),
                                  schema=wt.Schema(value=np.int64)),
                        pattern, wt.Sink(snk)])
    df.run_and_wait_end()
    return per_key


def host_ref(kind, win=WIN, slide=SLIDE, batches=None):
    return run_windowed(JWinSeq(JReducer("sum"), win, slide,
                                getattr(JWinType, kind)),
                        batches if batches is not None else stream(kind))


class Pkg:
    """One package's names, so a composition is written once for both."""

    def __init__(self, port):
        self.port = port
        if port:
            self.WinType, self.Reducer = wt.WinType, wt.Reducer
            self.WinSeqD, self.WinFarmD = wt.WinSeqGPU, wt.WinFarmGPU
            self.KeyFarmD, self.PaneFarmD = wt.KeyFarmGPU, wt.PaneFarmGPU
            self.WinMapReduceD = wt.WinMapReduceGPU
            self.WinFarmOf, self.KeyFarmOf = wt.WinFarmOf, wt.KeyFarmOf
            self.dev = {"device": "cpu"}
        else:
            self.WinType, self.Reducer = JWinType, JReducer
            self.WinSeqD, self.WinFarmD = jw.WinSeqTPU, jw.WinFarmTPU
            self.KeyFarmD, self.PaneFarmD = jw.KeyFarmTPU, jw.PaneFarmTPU
            self.WinMapReduceD = jw.WinMapReduceTPU
            self.WinFarmOf, self.KeyFarmOf = jnest.WinFarmOf, jnest.KeyFarmOf
            self.dev = {}

    def run(self, pattern, batches):
        return (run_port if self.port else run_windowed)(pattern, batches)


PORT, JAX = Pkg(True), Pkg(False)


def composition(p, name, kind):
    """The 9 device compositions of test_all_differential.py::
    test_all_device_compositions, with its degrees fixed (the JAX test
    draws them at random; both packages must see the same ones here)."""
    w = p.WinType.CB if kind == "CB" else p.WinType.TB
    s = lambda: p.Reducer("sum")
    d = p.dev
    make = {
        "seq": lambda: p.WinSeqD(s(), WIN, SLIDE, w, batch_len=32, **d),
        "wf": lambda: p.WinFarmD(s(), WIN, SLIDE, w, pardegree=3,
                                 batch_len=32, **d),
        "kf": lambda: p.KeyFarmD(s(), WIN, SLIDE, w, pardegree=2,
                                 batch_len=32, **d),
        "pf_plq": lambda: p.PaneFarmD(s(), s(), WIN, SLIDE, w, plq_degree=3,
                                      wlq_degree=2, wlq_on_device=False,
                                      batch_len=32, **d),
        "pf_wlq": lambda: p.PaneFarmD(s(), s(), WIN, SLIDE, w, plq_degree=2,
                                      wlq_degree=4, plq_on_device=False,
                                      batch_len=32, **d),
        "wmr_map": lambda: p.WinMapReduceD(s(), s(), WIN, SLIDE, w,
                                           map_degree=3, batch_len=32, **d),
        "wmr_red": lambda: p.WinMapReduceD(s(), s(), WIN, SLIDE, w,
                                           map_degree=2, map_on_device=False,
                                           reduce_on_device=True,
                                           batch_len=32, **d),
        # nesting with device inner patterns (the reference's GPU nesting
        # ctors III/IV, win_farm_gpu.hpp:227+, key_farm_gpu.hpp:167-334)
        "kf+pf": lambda: p.KeyFarmOf(p.PaneFarmD(
            s(), s(), WIN, SLIDE, w, plq_degree=2, wlq_degree=2,
            wlq_on_device=False, batch_len=16, **d), pardegree=2),
        "wf+wmr": lambda: p.WinFarmOf(p.WinMapReduceD(
            s(), s(), WIN, SLIDE, w, map_degree=2, reduce_on_device=False,
            batch_len=16, **d), pardegree=2),
    }
    return make[name]()


COMPOSITIONS = ["seq", "wf", "kf", "pf_plq", "pf_wlq", "wmr_map", "wmr_red",
                "kf+pf", "wf+wmr"]


@pytest.mark.parametrize("kind", ["CB", "TB"])
@pytest.mark.parametrize("name", COMPOSITIONS)
def test_device_composition_matches_jax_and_host(name, kind):
    """Every device composition of the sum_test_gpu test_all mirror: the
    port equals the JAX package per key in order, and the host WinSeq."""
    port = PORT.run(composition(PORT, name, kind), stream(kind))
    jax = JAX.run(composition(JAX, name, kind), stream(kind))
    assert port == jax
    assert iv(port) == iv(host_ref(kind))
    assert sum(len(v) for v in port.values()) > 0


@pytest.mark.parametrize("plq_dev,wlq_dev", [(True, False), (False, True),
                                             (True, True)])
def test_pane_farm_stage_placement(plq_dev, wlq_dev):
    """test_device.py's PaneFarm placements: each stage on the card or on
    the host, per key in order against JAX and the host WinSeq."""
    def make(p):
        return p.PaneFarmD(p.Reducer("sum"), p.Reducer("sum"), 12, 4,
                           p.WinType.CB, plq_degree=2, wlq_degree=2,
                           plq_on_device=plq_dev, wlq_on_device=wlq_dev,
                           batch_len=16, **p.dev)
    batches = cb_stream_batches(3, 120)
    port = PORT.run(make(PORT), batches)
    assert port == JAX.run(make(JAX), batches)
    assert iv(port) == iv(host_ref("CB", 12, 4, batches))


@pytest.mark.parametrize("map_dev,red_dev", [(True, False), (False, True),
                                             (True, True)])
def test_win_mapreduce_stage_placement(map_dev, red_dev):
    def make(p):
        return p.WinMapReduceD(p.Reducer("sum"), p.Reducer("sum"), 12, 4,
                               p.WinType.CB, map_degree=3, reduce_degree=2,
                               map_on_device=map_dev,
                               reduce_on_device=red_dev, batch_len=16,
                               **p.dev)
    batches = cb_stream_batches(3, 120)
    port = PORT.run(make(PORT), batches)
    assert port == JAX.run(make(JAX), batches)
    assert iv(port) == iv(host_ref("CB", 12, 4, batches))


def test_nested_device_inner():
    """WF(PF_GPU) with a single-worker device WLQ (PaneFarmGPU's
    WinSeqGPU stage, PatternConfig(..., 0, 1, slide))."""
    def make(p):
        return p.WinFarmOf(p.PaneFarmD(
            p.Reducer("sum"), p.Reducer("sum"), 16, 4, p.WinType.CB,
            plq_degree=2, wlq_degree=1, batch_len=16, **p.dev), pardegree=2)
    batches = cb_stream_batches(3, 140)
    port = PORT.run(make(PORT), batches)
    assert port == JAX.run(make(JAX), batches)
    assert iv(port) == iv(host_ref("CB", 16, 4, batches))


def test_incremental_stage_stays_on_host():
    """An incremental stage never reaches the device, as in JAX: the
    PaneFarmGPU's INC PLQ is a host WinFarm, its NIC WLQ a device farm."""
    pf = wt.PaneFarmGPU(wt.Reducer("sum"), wt.Reducer("sum"), 12, 4,
                        plq_degree=2, wlq_degree=2, plq_incremental=True,
                        device="cpu")
    assert type(pf.plq) is wt.WinFarm
    assert type(pf.wlq) is wt.WinFarmGPU
    wmr = wt.WinMapReduceGPU(wt.Reducer("sum"), wt.Reducer("sum"), 12, 4,
                             map_degree=2, map_incremental=True,
                             reduce_on_device=True, device="cpu")
    assert wmr.map_stage._device_opts is None
    assert type(wmr.reduce_stage) is wt.WinSeqGPU


def test_device_kwargs_match_jax():
    """The stages carry JAX's _dev_kw sets under the port's names:
    PaneFarmGPU passes no max_delay_ms, WinMapReduceGPU does."""
    jpf = jw.PaneFarmTPU(JReducer("sum"), JReducer("sum"), 12, 4)
    pf = wt.PaneFarmGPU(wt.Reducer("sum"), wt.Reducer("sum"), 12, 4)
    jm = jw.WinMapReduceTPU(JReducer("sum"), JReducer("sum"), 12, 4,
                            max_delay_ms=5.0)
    m = wt.WinMapReduceGPU(wt.Reducer("sum"), wt.Reducer("sum"), 12, 4,
                           max_delay_ms=5.0)
    rename = {"use_pallas": "use_reduce_kernel"}
    for j, p in ((jpf, pf), (jm, m)):
        assert {rename.get(k, k): v for k, v in j._dev_kw.items()} \
            == p._dev_kw
    assert "max_delay_ms" not in pf._dev_kw
    assert m._dev_kw["max_delay_ms"] == 5.0


@pytest.mark.parametrize("cls", ["PaneFarmGPU", "WinMapReduceGPU"])
def test_clone_with_keeps_placement_and_device_options(cls):
    """clone_with (called by the LEVEL1/LEVEL2 optimiser and by nesting)
    keeps the stage placement and the device options."""
    kw = ({"plq_on_device": False} if cls == "PaneFarmGPU"
          else {"reduce_on_device": True})
    orig = getattr(wt, cls)(wt.Reducer("sum"), wt.Reducer("sum"), 12, 4,
                            batch_len=24, depth=3, device="cpu", **kw)
    clone = orig.clone_with("c", slide_len=8)
    assert type(clone) is type(orig) and clone.name == "c"
    assert clone._on_device == orig._on_device
    assert clone._dev_kw == orig._dev_kw
    assert clone.spec.slide_len == 8 and clone.spec.win_len == 12


# ------------------------------------------- LEVEL1/LEVEL2 (test_opt_fusion)

def totals(per_key):
    return sum(v for rs in per_key.values() for _, _, v in rs)


@pytest.mark.parametrize("kind", ["CB", "TB"])
@pytest.mark.parametrize("level", [LEVEL1, LEVEL2])
def test_pane_farm_opt_matches_jax_and_seq(kind, level):
    """LEVEL1/LEVEL2 fusion over device-core PaneFarm stages
    (optimize_PaneFarmGPU, pane_farm_gpu.hpp:488-529)."""
    for degs in ((1, 1), (3, 1), (2, 3)):
        def make(p):
            w = getattr(p.WinType, kind)
            return p.PaneFarmD(p.Reducer("sum"), p.Reducer("sum"), WIN,
                               SLIDE, w, plq_degree=degs[0],
                               wlq_degree=degs[1], batch_len=16,
                               flush_rows=128, opt_level=level, **p.dev)
        port = PORT.run(make(PORT), stream(kind))
        assert port == JAX.run(make(JAX), stream(kind)), f"degs={degs}"
        assert totals(port) == totals(host_ref(kind)), f"degs={degs}"


@pytest.mark.parametrize("kind", ["CB", "TB"])
@pytest.mark.parametrize("level", [LEVEL1, LEVEL2])
@pytest.mark.parametrize("reduce_dev", [False, True],
                         ids=["red-host", "red-dev"])
def test_wmr_opt_matches_jax_and_seq(kind, level, reduce_dev):
    """LEVEL1/LEVEL2 over WinMapReduceGPU with the MAP stage (and
    optionally REDUCE) on the card (optimize_WinMapReduceGPU,
    win_mapreduce_gpu.hpp:529-558)."""
    for map_deg, red_deg in ((2, 1), (3, 2)):
        def make(p):
            w = getattr(p.WinType, kind)
            return p.WinMapReduceD(p.Reducer("sum"), p.Reducer("sum"), WIN,
                                   SLIDE, w, map_degree=map_deg,
                                   reduce_degree=red_deg,
                                   reduce_on_device=reduce_dev,
                                   batch_len=16, flush_rows=128,
                                   opt_level=level, **p.dev)
        port = PORT.run(make(PORT), stream(kind))
        assert port == JAX.run(make(JAX), stream(kind)), (map_deg, red_deg)
        assert totals(port) == totals(host_ref(kind)), (map_deg, red_deg)


def graph_node_count(pattern, batches):
    df = Dataflow()
    build_pipeline(df, [wt.Source(batches=iter(batches),
                                  schema=wt.Schema(value=np.int64)),
                        pattern, wt.Sink(lambda r: None)])
    return len(df.nodes)


def test_pane_farm_opt_shrinks_graph():
    def pf(level):
        return wt.PaneFarmGPU(wt.Reducer("sum"), wt.Reducer("sum"), WIN,
                              SLIDE, wt.WinType.CB, plq_degree=3,
                              wlq_degree=2, batch_len=16, flush_rows=128,
                              opt_level=level, device="cpu")
    n0 = graph_node_count(pf(0), stream("CB"))
    n1 = graph_node_count(pf(LEVEL1), stream("CB"))
    n2 = graph_node_count(pf(LEVEL2), stream("CB"))
    assert n1 == n0 - 1
    assert n2 <= n0 - 2


def test_pane_farm_opt_results_in_order():
    pf = wt.PaneFarmGPU(wt.Reducer("sum"), wt.Reducer("sum"), WIN, SLIDE,
                        wt.WinType.CB, plq_degree=3, wlq_degree=2,
                        batch_len=16, flush_rows=128, opt_level=LEVEL2,
                        device="cpu")
    got = run_port(pf, stream("CB"))
    for key, rs in got.items():
        ids = [i for i, _, _ in rs]
        assert ids == sorted(ids), f"key {key} out of order"
