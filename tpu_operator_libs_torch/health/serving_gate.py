"""Admission control and in-flight accounting for one decode server.

A copy of ``ServingEndpoint`` from ``tpu_operator_libs/health/serving_gate.py``
(the port imports nothing of the JAX package), without that module's
``k8s.objects`` import. ``ServingDrainGate``, the operator's side of the
drain, stays in the control plane: it is not part of the serving pod.

During a rolling upgrade the operator flips the endpoint to draining:
new requests are parked (``try_begin`` returns False; the router
re-routes them), in-flight generations run to completion, and only then
does eviction proceed. The unit of loss the gate drives to zero is a
dropped generation.
"""

from __future__ import annotations

import logging
import re
import threading

logger = logging.getLogger(__name__)

#: DNS-label shape a traffic-class name must take.
_CLASS_NAME_RE = re.compile(r"^[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?$")


class ServingEndpoint:
    """Admission control + in-flight accounting for one decode server.

    Thread-safe: the upgrade controller drains from its reconcile
    thread while request handlers begin/finish generations concurrently.

    ``traffic_class`` and ``model`` are the disruption-cost signals the
    control plane's ``DisruptionCostRanker``
    (``tpu_operator_libs/upgrade/handover.py``) ranks drain candidates by: endpoints of a batch class (or of a
    well-replicated model) are cheap to disrupt, the sole admitting
    replica of an interactive model is held behind the prewarm arc.
    Both are validated at construction — a malformed class name or a
    non-positive capacity must fail HERE, not misbehave passes later
    inside the budget math.
    """

    def __init__(self, name: str,
                 capacity: "int | None" = None,
                 traffic_class: str = "batch",
                 model: str = "") -> None:
        if not isinstance(name, str) or not name:
            raise ValueError("ServingEndpoint name must be a non-empty "
                             "string")
        if capacity is not None:
            if isinstance(capacity, bool) \
                    or not isinstance(capacity, int) or capacity < 1:
                raise ValueError(
                    f"ServingEndpoint {name}: capacity must be a "
                    f"positive integer or None, got {capacity!r}")
        if not isinstance(traffic_class, str) \
                or not _CLASS_NAME_RE.match(traffic_class):
            raise ValueError(
                f"ServingEndpoint {name}: traffic_class "
                f"{traffic_class!r} is malformed (must be a lowercase "
                f"DNS label)")
        self.name = name
        #: Concurrent generations this endpoint sustains — the per-node
        #: capacity signal the traffic-aware budget controller
        #: (upgrade/capacity.py) aggregates into fleet headroom. None =
        #: the controller's policy default (capacityBudget.
        #: perNodeCapacity) applies.
        self.capacity = capacity
        #: Traffic class this endpoint serves (matches a
        #: TrafficClassSpec name; "batch" = the cheap default).
        self.traffic_class = traffic_class
        #: Model identity for replication counting ("" = unscoped: the
        #: endpoint never counts as anyone's sole replica).
        self.model = model
        self._lock = threading.Lock()
        self._draining = False
        self._in_flight = 0
        self.completed = 0
        #: Generations aborted mid-flight (the metric the gate drives
        #: to zero; killed pods abort their in-flight handles).
        self.dropped = 0
        #: Generations the router migrated OFF this endpoint to a peer
        #: replica (session handover past the class drain deadline) —
        #: they completed elsewhere, not here, and were never dropped.
        self.handed_over = 0

    # -- request side ---------------------------------------------------
    def try_begin(self) -> bool:
        """Admit one generation; False while draining (the caller parks
        or re-routes the request — it is NOT dropped: it never started)."""
        with self._lock:
            if self._draining:
                return False
            self._in_flight += 1
            return True

    def finish(self) -> None:
        """A generation completed and its tokens were delivered."""
        with self._lock:
            if self._in_flight <= 0:
                raise RuntimeError(
                    f"endpoint {self.name}: finish() without begin()")
            self._in_flight -= 1
            self.completed += 1

    def kill(self) -> int:
        """The serving pod died (eviction, node failure): every
        in-flight generation is lost. Returns how many were dropped."""
        with self._lock:
            dropped = self._in_flight
            self.dropped += dropped
            self._in_flight = 0
            self._draining = True
            return dropped

    def handover(self) -> bool:
        """The router re-bound one in-flight generation to a peer
        replica: it leaves this endpoint's accounting WITHOUT counting
        as completed or dropped (the receiving endpoint's ``try_begin``
        picks it up). False when nothing was in flight to move."""
        with self._lock:
            if self._in_flight <= 0:
                return False
            self._in_flight -= 1
            self.handed_over += 1
            return True

    # -- upgrade side ---------------------------------------------------
    def begin_drain(self) -> None:
        """Stop admitting new generations (idempotent); in-flight ones
        run to completion."""
        with self._lock:
            if not self._draining:
                logger.info("serving endpoint %s: draining "
                            "(%d generation(s) in flight)",
                            self.name, self._in_flight)
            self._draining = True

    def resume(self) -> None:
        with self._lock:
            self._draining = False

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    @property
    def quiesced(self) -> bool:
        with self._lock:
            return self._in_flight == 0
