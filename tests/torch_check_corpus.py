"""Seeded misconfiguration corpus for ``scripts/torch_wf_lint.py``, built
through the port (tests/check_corpus.py's cases, the same ``PLANTED``):
every graph/config here plants at least one specific WF### diagnostic,
and ``tests/test_torch_scripts.py::test_wf_lint_cli_corpus`` asserts the
CLI reports each of ``PLANTED``.

Not a test module itself — imported by wf_lint via the
``wf_check_pipelines()`` convention (and as a module-level ``WireConfig``
scan target).
"""

import numpy as np

from windflow_tpu_torch.api import MultiPipe
from windflow_tpu_torch.core.tuples import Schema
from windflow_tpu_torch.core.windows import WinType
from windflow_tpu_torch.parallel.channel import WireConfig
from windflow_tpu_torch.parallel.plane import PlanePolicy
from windflow_tpu_torch.patterns.basic import Sink, Source, Map
from windflow_tpu_torch.patterns.pane_farm import PaneFarm
from windflow_tpu_torch.patterns.win_seq import WinSeq
from windflow_tpu_torch.runtime.overload import OverloadPolicy

SCHEMA = Schema(value=np.int64)

#: WF### ids the CLI run over this module must report
PLANTED = ("WF102", "WF103", "WF204", "WF205", "WF207", "WF208",
           "WF213", "WF214", "WF216", "WF217", "WF301")

#: module-level scan target: heartbeat at/above the stall timeout
BAD_WIRE = WireConfig(heartbeat=5.0, stall_timeout=2.0)   # -> WF205

#: module-level scan target: journal that can never trim (no acks)
BAD_RESUME_WIRE = WireConfig(resume=True)                 # -> WF214

#: module-level scan target: supervised plane whose handoff promise
#: has no journals to replay from
BAD_PLANE = PlanePolicy(wire=WireConfig.hardened())       # -> WF216


def _red(key, gwid, rows):
    return {"value": rows["value"].sum()}


def _src(shipper):
    return None


def _window_pipe() -> MultiPipe:
    """WF102 (hopping gap) + WF103 (non-divisible pane factor) +
    WF207 (metrics with no trace_dir)."""
    return (MultiPipe("corpus_windows", metrics=True)
            .add_source(Source(_src, SCHEMA))
            .add(WinSeq(_red, 4, 8, WinType.CB,
                        result_fields={"value": np.int64}))
            .add(PaneFarm(_red, _red, 10, 3, WinType.CB,
                          plq_result_fields={"value": np.int64},
                          wlq_result_fields={"value": np.int64}))
            .chain_sink(Sink(lambda b: None, vectorized=True)))


def _overload_pipe() -> MultiPipe:
    """WF208: shedding policy on unbounded inboxes (never builds)."""
    return (MultiPipe("corpus_overload", capacity=0,
                      overload=OverloadPolicy(shed="shed_newest"))
            .add_source(Source(_src, SCHEMA))
            .chain_sink(Sink(lambda b: None, vectorized=True)))


def _recovery_pipe() -> MultiPipe:
    """WF204: recovery over a sink that never opted into restart."""
    from windflow_tpu_torch.recovery.policy import RecoveryPolicy
    return (MultiPipe("corpus_recovery", recovery=RecoveryPolicy())
            .add_source(Source(_src, SCHEMA))
            .chain_sink(Sink(lambda b: None, vectorized=True)))


def _trace_pipe() -> MultiPipe:
    """WF213: span tracing with no trace_dir (spans stay ring-only)."""
    from windflow_tpu_torch.obs.trace import TracePolicy
    return (MultiPipe("corpus_trace", trace=TracePolicy(sample_rate=0.5))
            .add_source(Source(_src, SCHEMA))
            .chain_sink(Sink(lambda b: None, vectorized=True)))


def _federate_pipe() -> MultiPipe:
    """WF217: federation with no sampler to feed the shipper."""
    from windflow_tpu_torch.obs.federation import FederationPolicy
    return (MultiPipe("corpus_federate",
                      federate=FederationPolicy(host="corpus"))
            .add_source(Source(_src, SCHEMA))
            .chain_sink(Sink(lambda b: None, vectorized=True)))


def _race_pipe() -> MultiPipe:
    """WF301: parallel replicas mutating closed-over shared state."""
    counts = [0]

    def bump(batch):
        counts[0] += len(batch)

    return (MultiPipe("corpus_race")
            .add_source(Source(_src, SCHEMA))
            .add(Map(bump, parallelism=2, vectorized=True))
            .chain_sink(Sink(lambda b: None, vectorized=True)))


def wf_check_pipelines():
    return [_window_pipe(), _overload_pipe(), _recovery_pipe(),
            _trace_pipe(), _federate_pipe(), _race_pipe(), BAD_WIRE,
            BAD_RESUME_WIRE, BAD_PLANE]
