"""Overload & robustness policy — the knobs that make a dataflow *degrade*
instead of dying or hanging when a stage is slow or an item is malformed.

The FastFlow reference gets graceful-under-load behavior from bounded
lock-free queues alone: producers block, end of story.  That is still the
default here (``block``), but a production stream job usually prefers one
of the classic shedding disciplines once a consumer cannot keep up:

* ``shed_oldest`` — drop the item at the head of the full inbox and admit
  the new one (bounded staleness: the consumer always sees the most
  recent data; the standard choice for monitoring/analytics feeds);
* ``shed_newest`` — drop the incoming item (bounded history: what is
  queued wins; the choice when older context must finish first);
* ``put_deadline`` — keep blocking semantics but bound the wait: a ``put``
  that cannot complete within the deadline raises :class:`OverloadError`,
  which tears the graph down with a *clear* error instead of a silent
  stall (fail fast over hang).

EOS frames are exempt from every policy: shedding or timing out an EOS
would corrupt the per-channel EOS counting the engine's termination
protocol relies on.

The same policy object carries the *poison-tuple* budget: when a node's
``svc`` raises and ``error_budget`` allows, the offending batch goes to
the dataflow's dead-letter queue (``Dataflow.dead_letters``, inspectable
after ``wait()``) instead of tearing the graph down; once the budget is
exhausted the next error fails fast exactly like today.

With no policy set (the default everywhere) every code path is identical
to the pre-robustness engine — the "knobs unset => seed-identical
behavior" contract (docs/ROBUSTNESS.md).
"""

from __future__ import annotations

#: valid shedding disciplines for OverloadPolicy.shed
SHED_POLICIES = ("block", "shed_oldest", "shed_newest")


class OverloadError(RuntimeError):
    """A blocking inbox ``put`` exceeded its configured deadline: the
    downstream stage is not keeping up and the policy says fail fast."""


class OverloadPolicy:
    """Per-dataflow robustness knobs (see module docstring).

    Parameters
    ----------
    shed:
        ``"block"`` (default — today's behavior), ``"shed_oldest"`` or
        ``"shed_newest"``.
    put_deadline:
        Seconds a blocking ``put`` may wait before raising
        :class:`OverloadError`.  Only meaningful with ``shed="block"``
        (the shedding policies never block).  ``None`` = wait forever.
    soft_limit:
        Occupancy at which the shedding disciplines start dropping,
        *below* the hard inbox capacity.  ``None`` (default) = shed only
        when full, exactly the pre-control behavior.  Only meaningful
        with a shedding policy; read per ``put``, so the control plane's
        :class:`~windflow_tpu_torch.control.policy.AdaptiveShed` rule moves it
        at runtime (a single attribute store — atomic under the GIL).
    error_budget:
        Default per-node poison-tuple allowance: how many ``svc``
        exceptions a node may quarantine to the dead-letter queue before
        failing fast.  0 (default) = every error fails fast, exactly like
        the seed engine.  A node-level ``error_budget`` (set via
        ``withErrorBudget`` on a builder or directly on a pattern)
        overrides this default.
    """

    __slots__ = ("shed", "put_deadline", "error_budget", "soft_limit")

    def __init__(self, shed: str = "block", put_deadline: float = None,
                 error_budget: int = 0, soft_limit: int = None):
        if shed not in SHED_POLICIES:
            raise ValueError(
                f"shed={shed!r}: must be one of {SHED_POLICIES}")
        if put_deadline is not None:
            put_deadline = float(put_deadline)
            if put_deadline <= 0:
                raise ValueError("put_deadline must be positive (None to "
                                 "wait forever)")
            if shed != "block":
                raise ValueError(
                    f"put_deadline only applies to shed='block' "
                    f"(shed={shed!r} never blocks)")
        if error_budget < 0:
            raise ValueError("error_budget must be >= 0")
        if soft_limit is not None:
            if int(soft_limit) < 1:
                raise ValueError("soft_limit must be >= 1 item (None to "
                                 "shed only when full)")
            if shed == "block":
                raise ValueError(
                    "soft_limit only applies to the shedding policies "
                    "(shed='block' has no drop point to move)")
        self.shed = shed
        self.put_deadline = put_deadline
        self.error_budget = int(error_budget)
        self.soft_limit = None if soft_limit is None else int(soft_limit)

    @property
    def reshapes_put(self) -> bool:
        """True when the inbox ``put`` path differs from the seed engine
        (a shedding discipline or a deadline is active)."""
        return self.shed != "block" or self.put_deadline is not None

    def __repr__(self):
        return (f"OverloadPolicy(shed={self.shed!r}, "
                f"put_deadline={self.put_deadline}, "
                f"error_budget={self.error_budget}, "
                f"soft_limit={self.soft_limit})")


class DeadLetter:
    """One quarantined poison batch: which node choked, on what, and why.
    Collected in ``Dataflow.dead_letters`` (thread-safe append), in
    arrival order, inspectable after ``wait()``."""

    __slots__ = ("node", "batch", "channel", "error")

    def __init__(self, node: str, batch, channel: int,
                 error: BaseException):
        self.node = node
        self.batch = batch
        self.channel = channel
        self.error = error

    def __repr__(self):
        rows = len(self.batch) if hasattr(self.batch, "__len__") else "?"
        return (f"<DeadLetter node={self.node!r} rows={rows} "
                f"error={type(self.error).__name__}: {self.error}>")

    def to_event(self) -> dict:
        """JSON-safe summary for the runtime event log
        (obs/events.py ``quarantine`` events): everything but the batch
        payload itself, which stays only in ``Dataflow.dead_letters``."""
        return {
            "node": self.node,
            "channel": self.channel,
            "rows": (len(self.batch)
                     if hasattr(self.batch, "__len__") else None),
            "error": type(self.error).__name__,
            "message": str(self.error),
        }
