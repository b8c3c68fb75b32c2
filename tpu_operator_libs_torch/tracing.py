"""Spans of the port's hot paths, on the clock of the profiler's device
events.

A span is a named interval of the host's wall clock: start and end in
``time.time_ns()``, the clock that ``torch.profiler``'s CUDA events
carry, so a span lines up with a device trace of the same process. Each
span has an id, the id of its parent (the span open around it in the
same thread or task: ``contextvars``, so the spans of an endpoint's
threads do not mix) and a request id, the id of the root of its tree.
A span opened with ``request=True`` is a root wherever it is opened, so
its request id is fresh.

Finished spans go into one bounded ring, the newest :data:`RING` kept.
:func:`records` reads the spans that overlap a stretch of the clock and
:func:`clear` empties the ring. Recording is always on: a host span
costs two clock reads and an append, a device span two event records
more.

A device span (``device=True``, or a CUDA device) also records two
timing ``torch.cuda.Event`` on the current stream at its edges, unless
that stream is capturing a CUDA graph. Its :attr:`Span.device_ms` is the
card's time between them, once both have completed; it is None before
that, on the CPU and under capture.

The spans: name (parent; device span or not): what reads it.

- ``serve.request`` (none: a request's root, a fresh request id): the
  root of a served request's tree.
- ``serve.admit`` (serve.request): none, its operator's use.
- ``serve.queue`` (serve.request): ``DecodeServer.request_seconds``
  starts at its start.
- ``decode.generate`` (serve.request, or none): a generation's device
  work lies inside it.
- ``decode.cache_alloc``, ``decode.prefill``, ``decode.first_pick``
  (the first token's pick and the decode state's set-up, whose position
  is copied to the card behind the prefill), ``decode.eager_step``
  (decode.generate): ``dispatch_idle_ms.decode``.
- ``decode.capture`` (decode.generate): ``capture_idle_ms.decode``, and
  ``generate_on_device.last_call["capture_ms"]`` from its clock reads.
- ``decode.replay``, ``decode.wait``, ``decode.release``
  (decode.generate): none, its operator's use.
- ``decode.steps`` (decode.generate): none, its operator's use; the
  Python loop of steps where no graph is captured (the CPU, or a single
  step).
- ``serve.readback`` (serve.request): ``DecodeServer.request_seconds``
  ends at its end.
- ``train.step`` (none: a step's root): the root of a step's tree.
- ``train.forward`` (train.step; device): ``forward_ms.train``.
- ``train.backward`` (train.step; device): ``backward_ms.train``.
- ``train.update`` (train.step; device): none, its operator's use.

``decode.*`` spans are opened by ``examples/llama_decode.py``
(``generate_on_device``, and ``decode.cache_alloc`` in the host loop
``generate`` too); ``serve.*`` by ``examples/llama_serving_job.py``
(``DecodeServer.handle``); ``train.step`` and ``train.update`` by
``examples/llama.py``'s train step, ``train.forward`` and
``train.backward`` by ``optim.value_and_grad`` (the loss, then
``torch.autograd.grad``). No span is opened inside a decode step: it
runs once at capture, and its spans would not stand for the replays.
The metrics named are the benchmark's per-layer metrics.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import time

import torch

#: how many finished spans the ring keeps, the newest
RING = 65536

_ring: "collections.deque[Span]" = collections.deque(maxlen=RING)
_ids = itertools.count(1)
#: (span id, request id) of the span open in this thread or task
_open: "contextvars.ContextVar[tuple[int, int] | None]" = \
    contextvars.ContextVar("tpu_operator_libs_torch.tracing.open",
                           default=None)


def _on_card(device) -> bool:
    if device is True:
        return torch.cuda.is_available()
    return getattr(device, "type", None) == "cuda"


class Span:
    """One span: ``name``, ``span_id``, ``parent_id`` (None at a root),
    ``request_id``, and ``start`` / ``end`` in ``time.time_ns()``
    (``end`` once it has closed). A context manager that returns
    itself; the ring holds it from its end."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "start",
                 "end", "_device", "_request", "_events", "_device_ms",
                 "_token")

    def __init__(self, name: str, device=False, request: bool = False):
        self.name = name
        self._device = device
        self._request = request
        self._events = self._device_ms = self.end = None

    def __enter__(self) -> "Span":
        self.span_id = next(_ids)
        parent = _open.get()
        if parent is None or self._request:
            self.parent_id, self.request_id = None, self.span_id
        else:
            self.parent_id, self.request_id = parent
        self._token = _open.set((self.span_id, self.request_id))
        if self._device and _on_card(self._device) \
                and not torch.cuda.is_current_stream_capturing():
            self._events = [self._record(), None]
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        if self._events is not None \
                and not torch.cuda.is_current_stream_capturing():
            self._events[1] = self._record()
        _open.reset(self._token)
        _ring.append(self)
        return False

    def _record(self) -> "torch.cuda.Event":
        stream = torch.cuda.current_stream(
            None if self._device is True else self._device)
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        return event

    @property
    def device_ms(self) -> "float | None":
        """Milliseconds of the card between the span's edges, once both
        events have completed; None until then, and for a host span."""
        if self._device_ms is None and self._events is not None:
            first, last = self._events
            if last is not None and last.query():
                self._device_ms = first.elapsed_time(last)
                self._events = None
        return self._device_ms


def span(name: str, device=False, request: bool = False) -> Span:
    """A span named ``name`` for a ``with`` statement. ``device``: True
    (the current CUDA device, where there is one) or a device, whose
    current stream then takes the span's timing events where it is a
    CUDA device. ``request``: the span is a request's root, with a fresh
    request id and no parent."""
    return Span(name, device, request)


def records(t0: "int | None" = None, t1: "int | None" = None) \
        -> "list[Span]":
    """The finished spans in the ring that overlap ``[t0, t1]`` (either
    edge None: open on that side), in the order they ended."""
    return [s for s in list(_ring)
            if (t0 is None or s.end >= t0) and (t1 is None or s.start <= t1)]


def clear() -> None:
    """Empty the ring."""
    _ring.clear()
