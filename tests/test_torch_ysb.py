"""The Yahoo Streaming Benchmark through the port (apps/ysb.py) on the
tests/test_ysb.py stream: the device variants kf-gpu (KeyFarmGPU, 4
workers, TB tumbling windows, the revenue ring on the native core) and
wmr-gpu (WinMapReduceGPU, the MAP stage on the device), with
device="cpu" (the ring kernels' plain versions), against the JAX
package's kf-tpu / wmr-tpu, the port's host kf, and a numpy oracle of
every window's (count, lastUpdate, revenue), per campaign in window
order."""

import threading
import warnings

import numpy as np
import pytest

from windflow_tpu.apps import ysb as jysb
from windflow_tpu.core.windows import WindowSpec as JWindowSpec
from windflow_tpu.core.windows import WinType as JWinType
from windflow_tpu.patterns import win_seq_tpu as jw
from windflow_tpu_torch.apps import ysb
from windflow_tpu_torch.core.windows import WindowSpec, WinType
from windflow_tpu_torch.patterns import basic
from windflow_tpu_torch.patterns import win_seq_gpu as pw

from test_ysb import WIN_SEC, WIN_US, fixed_batches

pytestmark = pytest.mark.filterwarnings(
    "ignore:resident device path accumulates:UserWarning")

N_EVENTS = 30000
FIELDS = ("count", "lastUpdate", "revenue")


class Collect:
    """Per-campaign rows in arrival order."""

    def __init__(self, fields=FIELDS):
        self.fields = fields
        self.by_key = {}
        self._lock = threading.Lock()

    def __call__(self, live):
        with self._lock:
            for r in live:
                self.by_key.setdefault(int(r["key"]), []).append(
                    tuple(int(r[f]) for f in self.fields))


def run(mod, variant, n_events=N_EVENTS, fields=FIELDS, **kw):
    got = Collect(fields)
    pipe, sink, sent = mod.build_pipeline(
        variant, duration_sec=0, pardegree1=1, pardegree2=4,
        win_sec=WIN_SEC, batches=fixed_batches(n_events), on_result=got,
        **kw)
    pipe.run_and_wait_end()
    assert sent[0] == n_events
    assert sink.received == sum(len(v) for v in got.by_key.values())
    return got.by_key


def oracle_rows(n_events, ts_step_us=50, win_us=WIN_US):
    """{campaign: [(count, lastUpdate, revenue), ...]} in window order,
    non-empty windows only (the sink drops count-0 results)."""
    campaigns = ysb.CampaignGenerator()
    v = np.arange(n_events, dtype=np.int64)
    vm = v % 100000
    keep = vm % 3 == 0
    cmp_ids = campaigns.ad_to_cmp[(vm % campaigns.n_ads)[keep]]
    ts = v[keep] * ts_step_us
    rev = ((vm % 97) + 1)[keep]
    wins = ts // win_us
    out = {}
    for c in np.unique(cmp_ids):
        m = cmp_ids == c
        w, t, r = wins[m], ts[m], rev[m]
        out[int(c)] = [
            (int(np.sum(w == x)), int(t[w == x].max()), int(r[w == x].sum()))
            for x in np.unique(w)]
    return out


@pytest.mark.parametrize("port_variant,jax_variant",
                         [("kf-gpu", "kf-tpu"), ("wmr-gpu", "wmr-tpu")])
def test_device_variant_matches_jax_and_oracle(port_variant, jax_variant):
    got = run(ysb, port_variant, device="cpu")
    assert got == run(jysb, jax_variant)
    assert got == oracle_rows(N_EVENTS)
    assert len(got) == ysb.N_CAMPAIGNS


@pytest.mark.parametrize("variant", ["kf-gpu", "wmr-gpu"])
def test_device_variant_matches_port_host_kf(variant):
    assert run(ysb, variant, device="cpu") == run(ysb, "kf")


@pytest.mark.parametrize("path", ["bytes", "fields"])
@pytest.mark.parametrize("port_variant,jax_variant",
                         [("kf", "kf"), ("kf-gpu", "kf-tpu")])
def test_row_moves_match_jax_and_oracle(port_variant, jax_variant, path,
                                        monkeypatch):
    """The source thread's Filter and Join move rows as whole rows of
    bytes (patterns/basic.py), or field by field where forced: both give
    JAX's windows and the oracle's."""
    if path == "fields":
        monkeypatch.setattr(basic, "_row_type", lambda dt: None)
        monkeypatch.setattr(basic, "_header_types", lambda a, b: None)
    got = run(ysb, port_variant, device="cpu")
    assert got == run(jysb, jax_variant)
    assert got == oracle_rows(N_EVENTS)


def test_host_variants_match_jax():
    for variant in ("kf", "wmr"):
        assert run(ysb, variant) == run(jysb, variant), variant


def test_rich_stats_match_jax_and_ship_only_revenue():
    """--rich-stats adds MIN(ts) (firstUpdate), free from the position-
    ordered archive: the device half stays the single revenue ring, and
    the rows equal JAX's (tests/test_ysb.py::
    test_rich_stats_min_ts_is_host_free)."""
    spec = WindowSpec(10_000_000, 10_000_000, WinType.TB)
    agg = ysb.device_aggregate(rich=True)
    dev, pos = pw.split_pos_max(spec, agg)
    assert [p.field for p in dev] == ["revenue"]
    assert sorted((p.op, p.out_field) for p in pos) == [
        ("max", "lastUpdate"), ("min", "firstUpdate")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        core = pw.make_core_for(spec, agg, batch_len=256, device="cpu")
    assert getattr(core, "_ship_fields", None) == ("revenue",)
    fields = FIELDS + ("firstUpdate",)
    got = run(ysb, "kf-gpu", fields=fields, device="cpu", rich_stats=True)
    assert got == run(jysb, "kf-tpu", fields=fields, rich_stats=True)


def test_kf_gpu_core_is_the_native_revenue_ring():
    """kf-gpu's workers are native cores whose only device stat is the
    revenue sum (the pos-max split leaves COUNT and MAX(ts) on the host),
    as in JAX."""
    from windflow_tpu_torch.patterns.native_core import NativeResidentCore
    spec = WindowSpec(WIN_US, WIN_US, WinType.TB)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        core = pw.make_core_for(spec, ysb.device_aggregate(), batch_len=256,
                                device="cpu")
        jcore = jw.make_core_for(JWindowSpec(WIN_US, WIN_US, JWinType.TB),
                                 jysb.device_aggregate(), batch_len=256)
    assert type(core) is NativeResidentCore
    assert type(jcore).__name__ == "NativeResidentCore"
    assert core._ship_fields == jcore._ship_fields == ("revenue",)
    assert core._multi is jcore._multi is False


def test_revenue_warns_like_jax_and_stays_int64(monkeypatch):
    """SUM(revenue) over a TB window accumulates in int32 on the card: the
    accumulate-wrap warning stays armed as in JAX (a TB window's row
    count is unbounded), and the harvest is cast back to int64."""
    monkeypatch.setattr(pw, "_ACC_WARNED", set())
    monkeypatch.setattr(jw, "_ACC_WARNED", set())
    spec = WindowSpec(WIN_US, WIN_US, WinType.TB)
    with pytest.warns(UserWarning, match="accumulates in int32"):
        pw.make_core_for(spec, ysb.device_aggregate(), batch_len=256,
                         device="cpu")
    with pytest.warns(UserWarning, match="accumulates in int32"):
        jw.make_core_for(JWindowSpec(WIN_US, WIN_US, JWinType.TB),
                         jysb.device_aggregate(), batch_len=256)
    dtypes = []
    pipe, _, _ = ysb.build_pipeline(
        "kf-gpu", 0, 1, 4, win_sec=WIN_SEC, batches=fixed_batches(6000),
        on_result=lambda live: dtypes.append(live.dtype["revenue"]),
        device="cpu")
    pipe.run_and_wait_end()
    assert dtypes and all(d == np.int64 for d in dtypes)


def test_max_delay_refused_on_host_variants():
    with pytest.raises(ValueError, match="device variants only"):
        ysb.build_pipeline("kf", 0, 1, 2, batches=[], max_delay_ms=5.0)
    pipe, _, _ = ysb.build_pipeline("kf-gpu", 0, 1, 2, batches=[],
                                    max_delay_ms=5.0, device="cpu")
    pipe.run_and_wait_end()


def test_cli_names_the_gpu_variants():
    with pytest.raises(SystemExit):
        ysb.main(["--variant", "kf-tpu"])
    with pytest.raises(SystemExit, match="kf-gpu"):
        ysb.main(["--variant", "kf", "--rich-stats"])
