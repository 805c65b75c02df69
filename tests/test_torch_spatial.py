"""The port's spatial app (windflow_tpu_torch/apps/spatial.py) against the
JAX package's — twins of tests/test_spatial_micro.py.  The host variants
(Win_Farm, Pane_Farm, WF(PF), k-means) run through the port's copy, and the
device skyline through WinSeqGPU/WinFarmGPU on device="cpu" (the kernels'
plain versions) on both routes; every result is compared with the JAX
package's WinSeq/WinSeqTPU/WinFarmTPU run on the same stream.  Device
coordinates are float32, so the device cases quantise to a 1/256 grid,
where results are exact."""

import numpy as np
import pytest

from windflow_tpu.apps import spatial as jsp
from windflow_tpu.core.windows import WinType as JWinType
from windflow_tpu.patterns.basic import Sink as JSink
from windflow_tpu.patterns.basic import Source as JSource
from windflow_tpu.patterns.key_farm import KeyFarm as JKeyFarm
from windflow_tpu.patterns.pane_farm import PaneFarm as JPaneFarm
from windflow_tpu.patterns.win_seq import WinSeq as JWinSeq
from windflow_tpu.patterns.win_seq_tpu import WinFarmTPU, WinSeqTPU
from windflow_tpu.runtime.engine import Dataflow as JDataflow
from windflow_tpu.runtime.farm import build_pipeline as jbuild_pipeline
import windflow_tpu_torch as wt
from windflow_tpu_torch.apps import spatial as sp
from windflow_tpu_torch.core.windows import PatternConfig, Role
from windflow_tpu_torch.patterns.key_farm import KeyFarm
from windflow_tpu_torch.patterns.nesting import WinFarmOf
from windflow_tpu_torch.patterns.pane_farm import PaneFarm
from windflow_tpu_torch.patterns.win_farm import WinFarm

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

WIN, SLIDE = 200, 50   # ts units; sliding TB windows


def collect(row_fn, fields):
    got = {}

    def snk(row):
        if row is not None:
            got.setdefault(int(row["key"]), []).append(row_fn(row, fields))
    return got, snk


def sky_row(row, _fields):
    return (int(row["id"]), int(row["size"]), round(float(row["checksum"]), 6))


def km_row(row, fields):
    return (int(row["id"]),) + tuple(round(float(row[f]), 9) for f in fields
                                     if f != "iters")


def run_port(pattern, batches, row_fn=sky_row):
    got, snk = collect(row_fn, sp.KMEANS_FIELDS)
    df = wt.Dataflow()
    wt.build_pipeline(df, [wt.Source(batches=batches, schema=sp.POINT_SCHEMA),
                           pattern, wt.Sink(snk)])
    df.run_and_wait_end()
    return got


def run_jax(pattern, batches, row_fn=sky_row):
    got, snk = collect(row_fn, jsp.KMEANS_FIELDS)
    df = JDataflow()
    jbuild_pipeline(df, [JSource(batches=batches, schema=jsp.POINT_SCHEMA),
                         pattern, JSink(snk)])
    df.run_and_wait_end()
    return got


def quantize(b):
    b = b.copy()
    b["x"] = np.round(b["x"] * 256) / 256
    b["y"] = np.round(b["y"] * 256) / 256
    return b


@pytest.fixture(scope="module")
def ref_results():
    batches = sp.point_batches(300, keys=2)
    return run_jax(JWinSeq(jsp.SkylineWindow(), WIN, SLIDE, JWinType.TB),
                   batches), batches


@pytest.fixture(scope="module")
def grid_ref():
    batches = [quantize(b) for b in sp.point_batches(300, keys=2)]
    return run_jax(JWinSeq(jsp.SkylineWindow(), WIN, SLIDE, JWinType.TB),
                   batches), batches


def test_generators_and_host_skyline_match_jax():
    for a, b in zip(sp.point_batches(700, keys=3, chunk=128, seed=4),
                    jsp.point_batches(700, keys=3, chunk=128, seed=4)):
        assert a.tobytes() == b.tobytes()
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 10, (500, 2))
    np.testing.assert_array_equal(sp.skyline_mask(pts),
                                  jsp.skyline_mask(pts))
    pts = np.array([[1.0, 1.0], [2.0, 2.0], [0.5, 3.0], [3.0, 0.5]])
    assert sp.skyline_mask(pts).tolist() == [True, False, True, True]
    direct = sp.skyline(pts)
    merged = sp.skyline(np.concatenate([sp.skyline(pts[:2]),
                                        sp.skyline(pts[2:])]))
    assert sorted(map(tuple, direct)) == sorted(map(tuple, merged))


def paced(duration, chunk, rate):
    """spatial_event_batches of both packages under one fake clock."""
    def make(mod):
        t = [0.0]
        return list(mod.spatial_event_batches(
            duration, chunk, rate, time_fn=lambda: t[0],
            sleep_fn=lambda s: t.__setitem__(0, t[0] + s)))
    return make(sp), make(jsp)


def test_paced_generator_matches_jax():
    mine, theirs = paced(0.05, 64, 10_000.0)
    assert len(mine) == len(theirs) > 0
    assert all(a.tobytes() == b.tobytes() for a, b in zip(mine, theirs))


@pytest.mark.parametrize("variant", ["seq", "win_farm", "pane_farm",
                                     "nested"])
def test_host_variants_match_jax(ref_results, variant):
    ref, batches = ref_results
    pattern = {
        "seq": lambda: wt.WinSeq(sp.SkylineWindow(), WIN, SLIDE,
                                 wt.WinType.TB),
        "win_farm": lambda: WinFarm(sp.SkylineWindow(), WIN, SLIDE,
                                    wt.WinType.TB, pardegree=3),
        "pane_farm": lambda: PaneFarm(sp.SkylinePLQ(), sp.SkylineWLQ(), WIN,
                                      SLIDE, wt.WinType.TB, plq_degree=2,
                                      wlq_degree=2),
        "nested": lambda: WinFarmOf(PaneFarm(
            sp.SkylinePLQ(), sp.SkylineWLQ(), WIN, SLIDE, wt.WinType.TB,
            plq_degree=2, wlq_degree=1), pardegree=2),
    }[variant]()
    assert run_port(pattern, batches) == ref


@pytest.mark.parametrize("use_resident", [None, True])
@pytest.mark.parametrize("farm", [False, True])
def test_device_skyline_matches_jax_and_host(grid_ref, farm, use_resident):
    """The skyline as a TorchWindowFunction on the device path, restaging
    (the default route) and resident (per-field float32 rings), through
    WinSeqGPU and WinFarmGPU: the same windows as the JAX package's device
    variants and the host skyline."""
    ref, batches = grid_ref
    if farm:
        got = run_port(wt.WinFarmGPU(sp.device_skyline(), WIN, SLIDE,
                                     wt.WinType.TB, pardegree=2, batch_len=8,
                                     use_resident=use_resident,
                                     device="cpu"), batches)
        want = run_jax(WinFarmTPU(jsp.device_skyline(), WIN, SLIDE,
                                  JWinType.TB, pardegree=2, batch_len=8,
                                  use_resident=use_resident), batches)
    else:
        got = run_port(wt.WinSeqGPU(sp.device_skyline(), WIN, SLIDE,
                                    wt.WinType.TB, batch_len=16,
                                    use_resident=use_resident, device="cpu"),
                       batches)
        want = run_jax(WinSeqTPU(jsp.device_skyline(), WIN, SLIDE,
                                 JWinType.TB, batch_len=16,
                                 use_resident=use_resident), batches)
    assert got == want == ref


def test_build_spatial_wf_gpu_on_cpu(grid_ref):
    """The app's device variant, fed fixed batches: the same windows as
    the host variant, every window delivered to its latency sink."""
    _ref, batches = grid_ref
    outs = {}
    for variant in ("wf", "wf-gpu"):
        kw = {"device": "cpu"} if variant == "wf-gpu" else {}
        pipe, sink, n_gen = sp.build_spatial(
            variant, 0.0, 2, WIN / 1e3, SLIDE / 1e3, 64, batches=batches,
            batch_len=8, **kw)
        pipe.run_and_wait_end()
        outs[variant] = (sink.received, sink.skyline_points, n_gen[0])
    assert outs["wf"] == outs["wf-gpu"]
    assert outs["wf"][0] > 0 and outs["wf"][2] == 600
    with pytest.raises(ValueError, match="wf-gpu"):
        sp.build_spatial("wf", 0.0, 2, 1, 1, 64, batches=[],
                         max_delay_ms=5)
    with pytest.raises(ValueError, match="unknown"):
        sp.build_spatial("wf-tpu", 0.0, 2, 1, 1, 64, batches=[])


def test_kmeans_lloyd_matches_jax():
    rng = np.random.default_rng(5)
    centers = np.array([[0.0, 0.0], [50.0, 0.0], [0.0, 50.0]])
    pts = np.concatenate([c + rng.normal(0, 0.5, size=(40, 2))
                          for c in centers])
    for data in (pts, np.zeros((0, 2)), np.array([[1.0, 2.0], [3.0, 4.0]])):
        m, c, i = sp.kmeans_lloyd(data)
        jm, jc, ji = jsp.kmeans_lloyd(data)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(c, jc)
        assert i == ji


def test_kmeans_window_farms_match_jax():
    batches = sp.point_batches(900, keys=2, chunk=128)
    ref = run_jax(JWinSeq(jsp.KMeansWindow(), WIN, SLIDE, JWinType.TB),
                  iter(batches), km_row)
    assert ref and all(len(v) > 3 for v in ref.values())
    assert run_jax(JKeyFarm(jsp.KMeansWindow(), WIN, SLIDE, JWinType.TB,
                            pardegree=2), iter(batches), km_row) == ref
    for comp in (wt.WinSeq(sp.KMeansWindow(), WIN, SLIDE, wt.WinType.TB),
                 WinFarm(sp.KMeansWindow(), WIN, SLIDE, wt.WinType.TB,
                         pardegree=3),
                 KeyFarm(sp.KMeansWindow(), WIN, SLIDE, wt.WinType.TB,
                         pardegree=2)):
        assert run_port(comp, iter(batches), km_row) == ref, \
            type(comp).__name__


def test_kmeans_over_skylines_two_stage_matches_jax():
    from windflow_tpu.core.windows import PatternConfig as JPatternConfig
    from windflow_tpu.core.windows import Role as JRole
    batches = sp.point_batches(600, keys=1, chunk=128)

    def stages(mod, WinSeq, cfg, role, wtype):
        return [WinSeq(mod.SkylinePLQ(), SLIDE, SLIDE, wtype.TB, name="sky",
                       role=role.PLQ, config=cfg.plain(SLIDE)),
                WinSeq(mod.KMeansOverSkylines(), 4, 1, wtype.CB, name="km")]

    got, snk = collect(km_row, sp.KMEANS_FIELDS)
    df = wt.Dataflow()
    wt.build_pipeline(df, [wt.Source(batches=iter(batches),
                                     schema=sp.POINT_SCHEMA),
                           *stages(sp, wt.WinSeq, PatternConfig, Role,
                                   wt.WinType), wt.Sink(snk)])
    df.run_and_wait_end()
    want, jsnk = collect(km_row, jsp.KMEANS_FIELDS)
    jdf = JDataflow()
    jbuild_pipeline(jdf, [JSource(batches=iter(batches),
                                  schema=jsp.POINT_SCHEMA),
                          *stages(jsp, JWinSeq, JPatternConfig, JRole,
                                  JWinType), JSink(jsnk)])
    jdf.run_and_wait_end()
    assert got and got == want


def test_spatial_pf_opt_levels_match_jax():
    batches = sp.point_batches(700, keys=2, chunk=128)
    want = run_jax(JPaneFarm(jsp.SkylinePLQ(), jsp.SkylineWLQ(), WIN, SLIDE,
                             JWinType.TB, plq_degree=2, wlq_degree=2),
                   iter(batches))
    assert want
    for lvl in (0, 1, 2):
        pf = PaneFarm(sp.SkylinePLQ(), sp.SkylineWLQ(), WIN, SLIDE,
                      wt.WinType.TB, plq_degree=2, wlq_degree=2,
                      opt_level=lvl)
        assert run_port(pf, iter(batches)) == want

