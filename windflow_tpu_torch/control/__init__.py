"""Closed-loop control plane (docs/CONTROL.md): the layer that *reads*
the observability sensors (sampler snapshots) and *drives* the
overload and recovery actuators (shed disciplines, admission,
epoch-barrier snapshots) — elastic rescale of key-partitioned farms, adaptive
shedding, and source admission control.

Contract with the engine (same as check/): ``control=`` unset means this
package is **never imported**; the engine's lazy imports are the only
coupling, so the seed hot paths stay byte-identical.

    from windflow_tpu_torch.control import (ControlPolicy, Rescale,
                                      AdaptiveShed, Admission)

    pipe = MultiPipe("job", metrics=True, recovery=RecoveryPolicy(
                         epoch_batches=64),
                     control=ControlPolicy([
                         Rescale("kf", max_workers=8, up_depth=12,
                                 down_depth=2),
                         Admission(max_rate=2e6, min_rate=1e5,
                                   high_depth=14, low_depth=4),
                     ]))
"""

from __future__ import annotations

from .controller import Controller, TokenBucket
from .policy import Admission, AdaptiveShed, ControlPolicy, Drain, Rescale
from .rescale import FarmController, RescaleError

__all__ = ["ControlPolicy", "Rescale", "AdaptiveShed", "Admission",
           "Drain", "Controller", "TokenBucket", "FarmController",
           "RescaleError"]
