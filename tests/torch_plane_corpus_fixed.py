"""Minimally-fixed twin of ``tests/torch_plane_corpus.py``: the same 2-host
deployment with every planted defect repaired — one shared hardened-
style wire on both ends, resume on both ends, matching row dtypes, a
supervised host with a ckpt_sink replica target, and exactly one
telemetry aggregator.  ``scripts/torch_wf_lint.py --plane`` over this
module must report ZERO diagnostics.
"""

from windflow_tpu_torch.check.plane import HostSpec, PlaneSpec
from windflow_tpu_torch.parallel.channel import WireConfig
from windflow_tpu_torch.parallel.plane import PlanePolicy

#: one wire bundle for the whole plane: heartbeat under the stall
#: timeout, journaling paired with receiver epoch tracking
_WIRE = WireConfig(connect_deadline=30.0, heartbeat=2.0,
                   stall_timeout=10.0, resume=True, recovery=True)

_HOSTS = [
    HostSpec(0, sends="<i8", resume=True, plane=PlanePolicy(wire=_WIRE),
             federate=True),
    HostSpec(1, sends="<i8", resume=True, ckpt_sink=True, federate=True,
             aggregator=True),
]

SPEC = PlaneSpec({0: ("10.0.0.1", 9000), 1: ("10.0.0.2", 9000)},
                 _HOSTS, name="plane_corpus_fixed", wire=_WIRE)


def wf_plane_spec():
    return [SPEC]
