"""Seeded misconfigured 2-host plane topology for
``scripts/torch_wf_lint.py --plane``, built through the port
(tests/plane_corpus.py's deployment, the same ``PLANTED``): one declared
deployment planting the whole WF22x family plus the cross-host pairings
the per-process checks cannot see (WF205/WF214/WF216 across an edge).

Not a test module itself — ``tests/test_torch_scripts.py`` drives the CLI
over it and asserts every id in ``PLANTED`` is reported;
``tests/torch_plane_corpus_fixed.py`` is the minimally-fixed twin that
must lint clean.
"""

from windflow_tpu_torch.check.plane import HostSpec, PlaneSpec
from windflow_tpu_torch.parallel.channel import WireConfig
from windflow_tpu_torch.parallel.plane import PlanePolicy

#: WF### ids a ``--plane`` run over this module must report
PLANTED = ("WF205", "WF214", "WF216", "WF220", "WF221", "WF222",
           "WF223", "WF224")

#: host 0's wire: heartbeats at 5s into host 1, journals outbound
_WIRE0 = WireConfig(connect_deadline=30.0, heartbeat=5.0, resume=True,
                    recovery=True)
#: host 1's wire: 2s stall timeout (< host 0's heartbeat -> WF205) and
#: no recovery= (host 0 journals into the void -> WF214)
_WIRE1 = WireConfig(connect_deadline=30.0, stall_timeout=2.0)

_HOSTS = [
    # resume= set here but not on host 1 -> WF222 (both edges); the
    # federated shipper with no aggregator anywhere -> WF224
    HostSpec(0, wire=_WIRE0, sends="<i8", resume=True, federate=True),
    # expects a different row dtype than host 0 ships -> WF221; a
    # PlanePolicy over a wire that never journals -> WF216, and no host
    # offers a ckpt_sink for its takeovers -> WF223
    HostSpec(1, wire=_WIRE1, sends="<i8", expects="<f8",
             plane=PlanePolicy(wire=_WIRE1)),
]

#: pid 2 is in the address book but no HostSpec describes it -> WF220
SPEC = PlaneSpec({0: ("10.0.0.1", 9000), 1: ("10.0.0.2", 9000),
                  2: ("10.0.0.3", 9000)}, _HOSTS, name="plane_corpus")


def wf_plane_spec():
    return [SPEC]
