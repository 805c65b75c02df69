"""The port's builders and export surface against the JAX package's: every
``*GPU_Builder`` builds, from the same fluent calls, the pattern the JAX
``*TPU_Builder`` builds (the same constructor kwargs under the port's
names), the builder cases of test_multipipe.py run through the port's
MultiPipe, and the port exports every name of the JAX package's
``__all__`` under the TPU -> GPU / Jax -> Torch map, plus its own."""

import enum
import threading
import warnings

import numpy as np
import pytest

import windflow_tpu as jpkg
import windflow_tpu_torch as wt
from windflow_tpu.api import builders as jb
from windflow_tpu_torch.api import builders as pb

from test_multipipe import stream_batches, winseq_oracle

#: JAX name -> port name of the exported surface
NAME_MAP = {"JaxWindowFunction": "TorchWindowFunction"}
#: the port's exports that the JAX package has not
PORT_EXTRAS = {"NativeResidentCore", "ResidentWinSeqCore", "Dataflow",
               "build_pipeline"}
#: JAX builder kwargs -> the port's
KW_MAP = {"use_pallas": "use_reduce_kernel"}


def plain(v):
    """A kwarg comparable across the packages (their enums differ)."""
    return v.name if isinstance(v, enum.Enum) else v


def port_name(name):
    return NAME_MAP.get(name, name.replace("TPU", "GPU"))


def test_all_matches_jax_under_the_name_map():
    assert len(wt.__all__) == len(set(wt.__all__))
    assert set(wt.__all__) == {port_name(n) for n in jpkg.__all__} \
        | PORT_EXTRAS
    for name in wt.__all__:
        assert getattr(wt, name) is not None, name


def test_api_all_matches_jax():
    import windflow_tpu.api as japi
    import windflow_tpu_torch.api as papi
    assert sorted(papi.__all__) == sorted(port_name(n) for n in japi.__all__)
    assert papi.union_multipipes is wt.union_multipipes
    assert (papi.LEVEL0, papi.LEVEL1, papi.LEVEL2) == (0, 1, 2)


def test_host_builders_are_the_carried_patterns():
    """The 11 host builders build the port's own host patterns."""
    for name in ("Source", "Filter", "Map", "FlatMap", "Accumulator",
                 "Sink", "WinSeq", "WinFarm", "KeyFarm", "PaneFarm",
                 "WinMapReduce"):
        assert getattr(pb, f"{name}_Builder")._pattern_cls is \
            getattr(wt, name)


red = {"jax": lambda op="sum": jpkg.Reducer(op),
       "port": lambda op="sum": wt.Reducer(op)}


def fluent(pkg, name):
    """The same fluent calls on a package's device builder; the device
    options are the JAX names, mapped for the port."""
    mod = jb if pkg == "jax" else pb
    suffix = "TPU" if pkg == "jax" else "GPU"
    reduce_kernel = (lambda b: b.withPallas()) if pkg == "jax" \
        else (lambda b: b.withReduceKernel())
    r = red[pkg]
    B = getattr(mod, f"{name}{suffix}_Builder")
    if name in ("PaneFarm", "WinMapReduce"):
        b = B(r(), r()).withParallelism(3, 2).withOpt(1)
        b = (b.plqOnDevice(False).wlqOnDevice(True) if name == "PaneFarm"
             else b.mapOnDevice(True).reduceOnDevice(True))
    else:
        b = B(r()).withParallelism(3) if name != "WinSeq" else B(r())
    b = (b.withName(f"{name.lower()}_dev").withTBWindow(1000, 250)
         .withBatch(64).withDevice("cpu").withDepth(3)
         .withComputeDtype(np.int32))
    if name == "WinSeq":
        b = reduce_kernel(b)
    if name == "WinFarm":
        b = b.withOrdered(False)
    return b


DEVICE_BUILDERS = ["WinSeq", "WinFarm", "KeyFarm", "PaneFarm",
                   "WinMapReduce"]


@pytest.mark.parametrize("name", DEVICE_BUILDERS)
def test_device_builder_builds_what_jax_builds(name):
    jbld, pbld = fluent("jax", name), fluent("port", name)
    jkw, pkw = jbld._build_kw(), pbld._build_kw()
    mapped = {KW_MAP.get(k, k): v for k, v in jkw.items()}
    assert mapped.keys() == pkw.keys()
    for k, v in mapped.items():
        if k in ("winfunc", "plq_func", "wlq_func", "map_func",
                 "reduce_func"):
            assert (type(v).__name__, v.op) == \
                (type(pkw[k]).__name__, pkw[k].op), k
        else:
            assert plain(pkw[k]) == plain(v), k
    jp, pp = jbld.build(), pbld.build()
    assert type(pp) is getattr(wt, f"{name}GPU")
    assert type(jp).__name__ == f"{name}TPU"
    spec = lambda x: (x.spec if hasattr(x, "spec")
                      else x._seq_template.spec)     # a KeyFarm's workers'
    assert (spec(pp).win_len, spec(pp).slide_len, spec(pp).win_type.name) \
        == (spec(jp).win_len, spec(jp).slide_len, spec(jp).win_type.name)
    assert pp.name == jp.name
    assert getattr(pp, "parallelism", None) == getattr(jp, "parallelism",
                                                       None)
    if hasattr(jp, "_dev_kw"):
        assert {KW_MAP.get(k, k): v for k, v in jp._dev_kw.items()} == \
            pp._dev_kw
    else:
        assert {KW_MAP.get(k, k): v for k, v in jp._kw.items()
                if k not in ("config", "role")} == \
            {k: v for k, v in pp._kw.items() if k not in ("config", "role")}
    if name in ("PaneFarm", "WinMapReduce"):
        assert pp._on_device == jp._on_device
        assert pp.opt_level == jp.opt_level == 1


# ------------------------------------------- test_multipipe.py's builder cases

class Gather:
    def __init__(self):
        self.rows = []
        self._lock = threading.Lock()

    def __call__(self, row):
        if row is None:
            return
        with self._lock:
            self.rows.append((int(row["key"]), int(row["id"]),
                              int(row["value"])))


def port_source(batches):
    return (pb.Source_Builder().withBatches(batches)
            .withSchema(wt.Schema(value=np.int64)).build())


@pytest.mark.parametrize("builder_fn", [
    lambda: pb.WinSeq_Builder(wt.Reducer("sum")).withCBWindow(16, 5).build(),
    lambda: pb.WinFarm_Builder(wt.Reducer("sum")).withCBWindow(16, 5)
        .withParallelism(3).withOrdered().build(),
    lambda: pb.KeyFarm_Builder(wt.Reducer("sum")).withCBWindow(16, 5)
        .withParallelism(2).build(),
    lambda: pb.PaneFarm_Builder(wt.Reducer("sum"), wt.Reducer("sum"))
        .withCBWindow(16, 5).withParallelism(2, 2).build(),
    lambda: pb.WinMapReduce_Builder(wt.Reducer("sum"), wt.Reducer("sum"))
        .withCBWindow(16, 5).withParallelism(2, 1).build(),
    lambda: pb.WinSeqGPU_Builder(wt.Reducer("sum")).withCBWindow(16, 5)
        .withBatch(32).withDevice("cpu").build(),
    lambda: pb.WinFarmGPU_Builder(wt.Reducer("sum")).withCBWindow(16, 5)
        .withParallelism(2).withBatch(32).withDevice("cpu").build(),
    lambda: pb.KeyFarmGPU_Builder(wt.Reducer("sum")).withCBWindow(16, 5)
        .withParallelism(2).withBatch(32).withDevice("cpu").build(),
    lambda: pb.PaneFarmGPU_Builder(wt.Reducer("sum"), wt.Reducer("sum"))
        .withCBWindow(16, 5).withParallelism(2, 2).withBatch(32)
        .withDevice("cpu").build(),
    lambda: pb.WinMapReduceGPU_Builder(wt.Reducer("sum"), wt.Reducer("sum"))
        .withCBWindow(16, 5).withParallelism(2, 1).withBatch(32)
        .withDevice("cpu").build(),
], ids=["seq", "wf", "kf", "pf", "wmr", "seq_gpu", "wf_gpu", "kf_gpu",
        "pf_gpu", "wmr_gpu"])
@pytest.mark.filterwarnings("ignore:resident device path accumulates")
def test_windowed_stage_differential(builder_fn):
    """Every windowed pattern built fluently inside the port's MultiPipe
    matches the Win_Seq oracle (test_multipipe.py:168, with the five
    device builders beside the host ones)."""
    batches = stream_batches(3, 120)
    got = Gather()
    (wt.MultiPipe("wp")
     .add_source(port_source(batches))
     .add(builder_fn())
     .add_sink(pb.Sink_Builder(got).build())).run_and_wait_end()
    assert sorted(got.rows) == winseq_oracle(batches, 16, 5)


def test_builder_option_passthrough():
    wf = (pb.WinFarm_Builder(wt.Reducer("max")).withName("w")
          .withCBWindow(9, 4).withParallelism(5).withOrdered(False).build())
    assert wf.name == "w" and wf.parallelism == 5 and not wf.ordered
    assert wf.spec.win_len == 9 and wf.spec.slide_len == 4
    gpu = (pb.WinSeqGPU_Builder(wt.Reducer("sum")).withTBWindow(1000, 500)
           .withBatch(64).build())
    assert gpu.spec.win_type is wt.WinType.TB


def test_builder_cuda_args_warn_and_ignore():
    for call in (lambda b: b.withBatch(32, n_thread_block=128),
                 lambda b: b.withScratchpad(64)):
        with pytest.warns(UserWarning) as rec:
            gpu = call(pb.WinSeqGPU_Builder(wt.Reducer("sum"))
                       .withCBWindow(4, 2)).build()
        text = " ".join(str(w.message) for w in rec)
        assert "ignored" in text
        assert "XLA" not in text and "JAX" not in text
        assert "n_thread_block" not in gpu._kw


def test_with_reduce_kernel_pins_the_restaging_core():
    from windflow_tpu_torch.patterns.win_seq_gpu import DeviceWinSeqCore
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        core = (pb.WinSeqGPU_Builder(wt.Reducer("sum")).withCBWindow(8, 4)
                .withReduceKernel().withDevice("cpu").build().make_core())
    assert type(core) is DeviceWinSeqCore


def test_union_multipipes_exported_and_runs():
    """union_multipipes (api/multipipe.py) from the top level: two pipes'
    streams merged into one windowed consumer."""
    a, b = stream_batches(2, 40), stream_batches(2, 40, id0=40)
    got = Gather()
    p1 = wt.MultiPipe("a").add_source(port_source(a))
    p2 = wt.MultiPipe("b").add_source(port_source(b))
    u = wt.union_multipipes(p1, p2, name="u")
    u.add(pb.WinSeq_Builder(wt.Reducer("sum")).withCBWindow(10, 10).build())
    u.add_sink(pb.Sink_Builder(got).build())
    u.run_and_wait_end()
    assert sum(r[2] for r in got.rows) == \
        sum(int(x["value"].sum()) for x in a + b)
