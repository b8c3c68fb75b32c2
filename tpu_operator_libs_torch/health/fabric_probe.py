"""GPU fabric health probe: the compute path the operator runs before an
upgraded GPU node returns to service.

The port of ``tpu_operator_libs/health/ici_probe.py``. After a driver
rolling upgrade a node must not return to service on the strength of
"the pod is Ready" alone: the driver can load while NVLink or NVSwitch
links are degraded. The probe exercises what a training step uses and
checks the numbers against closed forms, so a link that answers wrongly
fails it, not only one that hangs:

- **tensor cores**: a bfloat16 128x128 product per card, summed in
  float32 (:func:`single_chip_probe`);
- **collectives**: an all-reduce, a ring pass (``batch_isend_irecv``)
  and a reduce-scatter over all ranks (:func:`fabric_probe`), the set a
  sharded training step rides on;
- **throughput**: a timed ring of 16 MiB hops (:func:`fabric_bandwidth_probe`).

The JAX probe is one ``shard_map`` program over a mesh; here each card
is one rank of a ``torch.distributed`` process group (NCCL on the card,
gloo on the CPU) and the functions run inside every rank, with the
rank's :class:`~tpu_operator_libs_torch.parallel.Mesh`. A TPU slice is a
torus, probed ring by ring along its axes (``fabric_probe_topology``); an
HGX node's GPUs all hang off one NVSwitch, so axis rings do not apply and
:func:`fabric_probe_rings` runs the battery over the shifted rings
i -> i + s, s = 1 .. n-1, which carry every ordered pair of cards once.
:class:`FabricValidator` plugs the probe into ``ValidationManager``'s
``extra_validator`` seam (``tpu_operator_libs/upgrade/validation_manager.py``),
as ``ICIFabricValidator`` does for TPU nodes; GPU nodes carry the
``UpgradeKeys(driver="gpu", domain="nvidia.com")`` key scheme
(``tpu_operator_libs/consts.py:447-453``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.parallel import run_ranks

logger = logging.getLogger(__name__)

#: the probe's tile: 128x128 bfloat16, as the JAX probe's
_TILE = 128
#: the GPU feature discovery label naming a node's card model
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"

#: the name torch 2.13 gives the reduce-scatter; earlier releases have
#: only the older one, which 2.13 deprecates
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class Clock:
    """Injectable time source (a copy of ``tpu_operator_libs/util.py``'s
    ``Clock``): timeouts read it, so tests advance a fake one."""

    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


@dataclass
class FabricProbeResult:
    healthy: bool
    max_abs_error: float
    latency_s: float
    n_devices: int
    #: the ring's shift: rank i sent to rank (i + shift) mod n
    shift: int = 1

    def __str__(self) -> str:
        status = "healthy" if self.healthy else "UNHEALTHY"
        return (f"GPU fabric {status}: {self.n_devices} devices, ring "
                f"shift {self.shift}, max|err|={self.max_abs_error:.3e}, "
                f"latency={self.latency_s * 1e3:.1f} ms")


@dataclass
class BandwidthProbeResult:
    """Achieved per-link throughput of a timed ring, in gigabytes/s."""

    gbytes_per_s: float
    bytes_per_hop: int
    rounds: int
    latency_s: float
    n_devices: int
    healthy: bool = True

    def __str__(self) -> str:
        status = "ok" if self.healthy else "DEGRADED"
        return (f"GPU fabric bandwidth {status}: "
                f"{self.gbytes_per_s:.1f} GByte/s/link "
                f"({self.n_devices} devices, "
                f"{self.bytes_per_hop >> 20} MiB x {self.rounds} hops, "
                f"{self.latency_s * 1e3:.1f} ms)")


def single_chip_probe(*, device=None) -> "tuple[Callable, tuple]":
    """(fn, example_args) for the one-card probe step: a bfloat16 matmul
    summed in float32 (the product of two bfloat16 values is exact in
    float32, so float32 operands give the JAX probe's
    ``preferred_element_type=float32`` sums) and an elementwise chain
    the host can check, ``tanh(y) + 0.5 y``."""
    device = resolve_device(device)

    def probe_step(x, w):
        y = x.float() @ w.float()
        return torch.tanh(y) + y * 0.5

    x = torch.full((_TILE, _TILE), 0.5, dtype=torch.bfloat16, device=device)
    w = torch.eye(_TILE, dtype=torch.bfloat16, device=device)
    return probe_step, (x, w)


def _ring_pass(x, shift: int):
    """Every rank sends ``x`` to rank + shift and receives rank - shift's
    (mod n); a shift of 0 mod n is the identity, as a one-device
    ``ppermute``."""
    n, rank = dist.get_world_size(), dist.get_rank()
    if shift % n == 0:
        return x
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + shift) % n),
           dist.P2POp(dist.irecv, got, (rank - shift) % n)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return got


def _battery(device, shift: int):
    """One pass of the battery on this rank: the largest error, over
    every rank, of the all-reduce, the ring and the reduce-scatter
    against their closed forms (``ici_probe.py::_probe_fn``)."""
    n, rank = dist.get_world_size(), dist.get_rank()
    # rank i holds i + 1; the product with 2 I makes it 2 (i + 1)
    x = torch.full((_TILE, _TILE), rank + 1, dtype=torch.bfloat16,
                   device=device)
    eye2 = 2.0 * torch.eye(_TILE, dtype=torch.bfloat16, device=device)
    mxu = x.float() @ eye2.float()

    reduced = mxu.clone()
    dist.all_reduce(reduced)  # sum of 2 (i + 1) = n (n + 1)
    err = torch.max(torch.abs(reduced - float(n * (n + 1))))
    ring = _ring_pass(mxu, shift)
    sender = (rank - shift) % n
    err = torch.maximum(err, torch.max(torch.abs(ring - 2.0 * (sender + 1))))
    if _TILE % n == 0:
        # the summed tile's rows, scattered; the psum and the ring cover
        # every link when n does not divide the tile
        rows = _TILE // n
        scattered = torch.empty((rows, _TILE), dtype=mxu.dtype,
                                device=device)
        _reduce_scatter(scattered, mxu)
        mine = reduced[rank * rows:(rank + 1) * rows]
        err = torch.maximum(err, torch.max(torch.abs(scattered - mine)))
    err = err.reshape(1)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return err


def _slowest(seconds: float, device) -> float:
    """The largest of every rank's ``seconds``: one figure for the whole
    program, as the JAX probe's single host times it."""
    value = torch.tensor([seconds], dtype=torch.float64, device=device)
    dist.all_reduce(value, op=dist.ReduceOp.MAX)
    return float(value)


def fabric_probe(mesh, tolerance: float = 1e-3,
                 shift: int = 1) -> FabricProbeResult:
    """Run the battery over every rank of the process group (call it on
    each, with the rank's mesh). ``healthy`` means every collective came
    within ``tolerance`` of its closed form on every rank. The second run
    is timed; reading the error back to the host is its fence."""
    _battery(mesh.device, shift).item()  # warm-up: connections, kernels
    dist.barrier()
    start = time.perf_counter()
    max_err = _battery(mesh.device, shift).item()
    latency = _slowest(time.perf_counter() - start, mesh.device)
    result = FabricProbeResult(healthy=max_err <= tolerance,
                               max_abs_error=max_err, latency_s=latency,
                               n_devices=dist.get_world_size(), shift=shift)
    logger.info("%s", result)
    return result


def ring_pairs(n: int, shift: int) -> "list[tuple[int, int]]":
    """The (sender, receiver) pairs of the ring i -> i + shift mod n."""
    return [(i, (i + shift) % n) for i in range(n)]


def shifted_rings(n: int, max_rings: Optional[int] = None) -> "list[int]":
    """The shifts 1 .. n-1, whose rings carry every ordered pair of n
    ranks once, capped at ``max_rings`` (the skipped count is logged:
    partial coverage is never silent)."""
    shifts = list(range(1, n))
    if max_rings is not None and len(shifts) > max_rings:
        logger.warning(
            "fabric probe: %d of %d shifted rings not probed "
            "(max_rings=%d) - coverage is partial",
            len(shifts) - max_rings, len(shifts), max_rings)
        shifts = shifts[:max_rings]
    return shifts


def fabric_probe_rings(mesh, tolerance: float = 1e-3,
                       max_rings: Optional[int] = None,
                       ) -> "list[FabricProbeResult]":
    """The battery over every shifted ring (:func:`shifted_rings`); one
    rank probes its one card with the identity ring."""
    shifts = shifted_rings(dist.get_world_size(), max_rings) or [1]
    return [fabric_probe(mesh, tolerance, shift) for shift in shifts]


def fabric_bandwidth_probe(mesh, payload_mib: int = 16, rounds: int = 8,
                           min_gbytes_per_s: Optional[float] = None,
                           shift: int = 1) -> BandwidthProbeResult:
    """Achieved throughput of a timed ring: ``payload_mib`` of bfloat16
    pass around the ring ``rounds`` times, each hop sending what the
    last one received, every link busy at once; bytes over the slowest
    rank's wall time, per link and direction, in gigabytes/s, rounded
    before it is held to ``min_gbytes_per_s`` so the verdict and the
    reported figure agree. On the CPU this times memory copies, so tests
    check structure, not rates."""
    n = dist.get_world_size()
    if n < 2:
        raise ValueError("bandwidth probe needs >= 2 devices")
    cols = max(((payload_mib << 20) // 2) // _TILE, 1)
    x = torch.ones((_TILE, cols), dtype=torch.bfloat16, device=mesh.device)

    def run():
        local = x
        for _ in range(rounds):
            local = _ring_pass(local, shift)
        # one scalar back to the host is the fence, not the payload
        return local.float().sum().item()

    run()  # warm-up outside the timed region
    dist.barrier()
    start = time.perf_counter()
    run()
    latency = _slowest(time.perf_counter() - start, mesh.device)
    bytes_per_hop = _TILE * cols * 2
    gbytes_per_s = round((bytes_per_hop * rounds / latency) / 1e9, 2)
    result = BandwidthProbeResult(
        gbytes_per_s=gbytes_per_s, bytes_per_hop=bytes_per_hop,
        rounds=rounds, latency_s=latency, n_devices=n,
        healthy=(min_gbytes_per_s is None
                 or gbytes_per_s >= min_gbytes_per_s))
    logger.info("%s", result)
    return result


def probe_node_rank(mesh, tolerance: float, max_rings: Optional[int],
                    min_gbytes_per_s: Optional[float]) -> dict:
    """One rank of a node's probe (:func:`run_ranks` runs it on every
    card): the ring battery, then, when it passed, a floor is set and
    there are two or more cards, the bandwidth ring."""
    results = fabric_probe_rings(mesh, tolerance, max_rings)
    healthy = all(r.healthy for r in results)
    gbytes = None
    if healthy and min_gbytes_per_s is not None and mesh.size >= 2:
        bw = fabric_bandwidth_probe(mesh, min_gbytes_per_s=min_gbytes_per_s)
        healthy, gbytes = bw.healthy, bw.gbytes_per_s
    return {"healthy": healthy, "gbytes_per_s": gbytes,
            "max_abs_error": max(r.max_abs_error for r in results)}


class FabricValidator:
    """NodeValidator adapter: the fabric probe behind
    ``ValidationManager``'s ``extra_validator`` seam (the port of
    ``ICIFabricValidator``).

    The default probe starts one rank per visible card
    (:func:`probe_node_rank`). ``probe_runner`` replaces it (tests, or a
    deployment that probes through a validation Job): it is called with
    no arguments and returns a result with ``healthy`` or a bool. Results
    are cached for ``cache_seconds`` per (node name, GPU product label),
    so one validator can serve the whole fleet and a result for one node
    is never served for another.
    """

    def __init__(self,
                 probe_runner: Optional[Callable[[], Any]] = None,
                 cache_seconds: float = 300.0,
                 clock: Optional[Clock] = None,
                 tolerance: float = 1e-3,
                 min_bandwidth_gbytes_per_s: Optional[float] = None,
                 max_rings: Optional[int] = None,
                 device=None, n_devices: Optional[int] = None) -> None:
        self._probe = probe_runner
        self._tolerance = tolerance
        self._min_bandwidth = min_bandwidth_gbytes_per_s
        self._max_rings = max_rings
        self._cache_seconds = cache_seconds
        self._clock = clock or Clock()
        self._device = device
        self._n_devices = n_devices
        self._cached: "dict[object, tuple[float, bool]]" = {}

    @staticmethod
    def _cache_key(node) -> object:
        if node is None:
            return None
        labels = getattr(node.metadata, "labels", {}) or {}
        return (node.metadata.name, labels.get(GPU_PRODUCT_LABEL, ""))

    def _default_probe(self) -> bool:
        device = resolve_device(self._device)
        n = self._n_devices
        if n is None:
            n = torch.cuda.device_count() if device.type == "cuda" else 1
        floor = self._min_bandwidth
        if floor is not None and n < 2:
            # one card has no fabric to time: the floor cannot be enforced
            # from here, which must be visible, not a silent pass
            logger.warning(
                "bandwidth floor configured but only %d device visible; "
                "skipping the throughput gate", n)
            floor = None
        result = run_ranks(probe_node_rank, n, self._tolerance,
                           self._max_rings, floor, device=device)[0]
        return bool(result["healthy"])

    def __call__(self, node) -> bool:
        now = self._clock.now()
        key = self._cache_key(node)
        cached = self._cached.get(key)
        if cached is not None:
            ts, healthy = cached
            if now - ts < self._cache_seconds:
                return healthy
        if self._probe is not None:
            result = self._probe()
            healthy = bool(getattr(result, "healthy", result))
        else:
            healthy = self._default_probe()
        self._cached[key] = (now, healthy)
        return healthy
