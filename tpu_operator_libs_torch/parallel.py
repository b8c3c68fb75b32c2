"""Data, tensor, sequence, pipeline and expert parallelism on
``torch.distributed``: the meshes, a launcher for their ranks, and the
collectives that XLA inserts from shardings in the JAX package, written
out.

Mirrors the JAX package's 2-D ``Mesh(devices.reshape(dp, tp), ("dp",
"tp"))`` with its split rule, the largest dp <= sqrt(n) that divides n
(``__graft_entry__.py::_dp_tp_split``,
``examples/jax_training_job.py::make_mesh``). Rank ``r`` sits at
``divmod(r, tp)``, as device ``r`` does in the reshaped JAX array.

The weights follow the Megatron split of
``tpu_operator_libs/examples/llama.py::init_llama_params``
(:data:`TP_SPLIT_DIM`): column-parallel weights hold a block of output
columns, row-parallel ones a block of input rows, and everything else is
replicated. XLA derives two conjugate collectives from those shardings;
here they are autograd functions:

- :func:`copy_to_tp` before each column-parallel product: identity
  forward, all-reduce over tp backward, so a replicated activation (and
  the replicated norm weights before it) gets the whole gradient;
- :func:`reduce_from_tp` after each row-parallel product: all-reduce over
  tp forward, identity backward.

:func:`gather_from_tp` all-gathers the column-parallel ``lm_head``'s
vocabulary shards, and :func:`mean_over_dp` averages gradients over the
data-parallel replicas. :data:`TP_COLLECTIVES` counts the collectives
that the tp reduce and gather points launch, and their bytes. On the
card the ranks talk over NCCL, on the CPU over gloo; :func:`run_ranks`
starts them.

The other meshes of the JAX package are a ``shape`` for
:func:`make_mesh`: ``{"dp": a, "sp": b}``, the dp x sp mesh of
sequence parallelism (``tests/test_llama.py:173-178``), and the 1-D
``{"sp": n}``, ``{"pp": n}`` and ``{"ep": n}`` of ring attention, the
pipeline and the experts (``__graft_entry__.py:228, 254, 270``). Ranks
are placed as ``devices.reshape(...)`` places devices, row-major. Their
neighbours on an axis trade tensors with :func:`ring_hop` (the
``ppermute`` of a ring) or, differentiably, :func:`ring_shift`.
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing as mp
import os
import pickle
import queue as queue_lib
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.kernels.global_norm import sum_of_squares

#: the dimension each tensor-parallel weight is split on, by its key:
#: column-parallel weights over their output dim (1), row-parallel ones
#: over their input dim (0); every other leaf is replicated. The Llama
#: weights are ``tpu_operator_libs/examples/llama.py:176-198``'s
#: PartitionSpecs, ``w1``/``w2`` the MLP's of
#: ``examples/jax_training_job.py:66-74``.
TP_SPLIT_DIM = {"wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1,
                "lm_head": 1, "w1": 1, "wo": 0, "w_down": 0, "w2": 0}

def dp_tp_split(n: int) -> "tuple[int, int]":
    """Largest dp <= sqrt(n) that divides n; tp = n // dp."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    dp = max(c for c in range(1, math.isqrt(n) + 1) if n % c == 0)
    return dp, n // dp


#: the axes a mesh may have, in the order their ranks are laid out
AXES = ("dp", "tp", "sp", "pp", "ep")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and its subgroups. ``dp`` and
    ``tp`` are 1 (with no group) on a mesh without those axes; the other
    axes are in ``other``."""

    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    #: the ranks that hold the same tp shard (this rank's column)
    dp_group: object
    #: the ranks that hold one replica's tp shards (this rank's row)
    tp_group: object
    device: torch.device
    #: the mesh's axes, in the JAX package's order
    axis_names: tuple = ("dp", "tp")
    #: the axes besides dp and tp, by name: (size, this rank's index on
    #: it, the group of the ranks along it)
    other: dict = dataclasses.field(default_factory=dict)

    def axis(self, name: str) -> "tuple[int, int, object]":
        """(size, this rank's index, group) of the axis ``name``; (1, 0,
        None) for an axis the mesh does not have."""
        if name == "dp":
            return self.dp, self.dp_rank, self.dp_group
        if name == "tp":
            return self.tp, self.tp_rank, self.tp_group
        return self.other.get(name, (1, 0, None))

    @property
    def sp(self) -> int:
        return self.axis("sp")[0]

    @property
    def sp_rank(self) -> int:
        return self.axis("sp")[1]

    @property
    def size(self) -> int:
        return math.prod(self.axis(name)[0] for name in self.axis_names)


def make_mesh(n=None, *, device=None, shape=None) -> Mesh:
    """The mesh of the initialised default process group (``n``, when
    given, must be its size). ``shape`` maps axis names (:data:`AXES`,
    in that order) to sizes whose product is the world; the default is
    the dp x tp split of :func:`dp_tp_split`. Every rank creates every
    subgroup, in one order, as ``torch.distributed.new_group``
    requires."""
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"mesh of {n} ranks asked for in a process group "
                         f"of {world}")
    if shape is None:
        dp, tp = dp_tp_split(world)
        shape = {"dp": dp, "tp": tp}
    names = tuple(shape)
    if not names or any(a not in AXES for a in names) \
            or list(names) != sorted(names, key=AXES.index):
        raise ValueError(f"mesh axes {names} must be some of {AXES}, in "
                         "that order")
    sizes = tuple(int(shape[a]) for a in names)
    if math.prod(sizes) != world:
        raise ValueError(f"mesh shape {dict(shape)} does not hold "
                         f"{world} ranks")
    grid = np.arange(world).reshape(sizes)
    coords = np.unravel_index(dist.get_rank(), sizes)
    axes = {}
    for i, name in enumerate(names):
        # the ranks along axis i: one group per place on the other axes
        mine = None
        for ranks in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            group = dist.new_group([int(r) for r in ranks])
            if dist.get_rank() in ranks:
                mine = group
        axes[name] = (sizes[i], int(coords[i]), mine)
    dp, dp_rank, dp_group = axes.pop("dp", (1, 0, None))
    tp, tp_rank, tp_group = axes.pop("tp", (1, 0, None))
    return Mesh(dp=dp, tp=tp, dp_rank=dp_rank, tp_rank=tp_rank,
                dp_group=dp_group, tp_group=tp_group,
                device=resolve_device(device), axis_names=names,
                other=axes)


def tp_of(mesh) -> int:
    return 1 if mesh is None else mesh.tp


@dataclasses.dataclass
class CollectiveCount:
    """Collectives launched and their bytes: each one's result on this
    rank, the whole tensor of an all-reduce and the gathered tensor of an
    all-gather (the sizes NCCL's own tests report)."""

    calls: int = 0
    bytes: int = 0

    def add(self, x) -> None:
        self.calls += 1
        self.bytes += x.numel() * x.element_size()


#: the forward collectives of :func:`reduce_from_tp` and
#: :func:`gather_from_tp` in this process, counted at each call (a CUDA
#: graph's capture counts its step once, as the kernel wrappers'
#: ``launches`` do; ``llama_decode._carry`` adds the replays)
TP_COLLECTIVES = CollectiveCount()


# --------------------------------------------------------------------------
# the conjugate collectives


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tp, tp_rank):
        ctx.tp, ctx.tp_rank = tp, tp_rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(tp)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        width = grad.shape[-1] // ctx.tp
        start = ctx.tp_rank * width
        return grad[..., start:start + width].contiguous(), None, None, None


def copy_to_tp(x, mesh):
    """Identity forward; all-reduce of the gradient over tp backward."""
    if tp_of(mesh) == 1:
        return x
    return _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x, mesh):
    """All-reduce (sum) over tp forward; identity backward."""
    if tp_of(mesh) == 1:
        return x
    out = _SumForward.apply(x, mesh.tp_group)
    TP_COLLECTIVES.add(out)
    return out


def gather_from_tp(x, mesh):
    """The tp shards of the last dim, concatenated in rank order;
    backward hands each rank its own slice of the gradient."""
    if tp_of(mesh) == 1:
        return x
    out = _GatherFromTP.apply(x, mesh.tp_group, mesh.tp, mesh.tp_rank)
    TP_COLLECTIVES.add(out)
    return out


def mean_over_dp(x, mesh):
    """``x`` averaged over the dp replicas (a mean of equal-sized local
    means is the global batch's mean)."""
    if mesh.dp == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=mesh.dp_group)
    return x / mesh.dp


def reduce_from_sp(x, mesh):
    """All-reduce (sum) over sp forward; identity backward: a loss whose
    sequence blocks sit on the sp ranks, each rank differentiating its
    own block's part."""
    if mesh.sp == 1:
        return x
    return _SumForward.apply(x, mesh.axis("sp")[2])


def sum_over(x, mesh, name: str):
    """``x`` summed over the ranks along the axis ``name``: a replicated
    weight's gradient whose sequence blocks each gave a part (sp), or
    disjoint outputs combined (pp, ep)."""
    size, _, group = mesh.axis(name)
    if size == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def local_seq(x, mesh, name: str = "sp"):
    """This rank's block of dim 1 (the sequence) along the axis
    ``name``."""
    size, index, _ = mesh.axis(name)
    if x.shape[1] % size:
        raise ValueError(f"sequence {x.shape[1]} does not split over "
                         f"{name}={size}")
    width = x.shape[1] // size
    return x[:, index * width:(index + 1) * width]


def gather_axis(x, mesh, name: str, dim: int = 0):
    """The blocks of ``x`` that the ranks along the axis ``name`` hold,
    concatenated on ``dim`` in rank order."""
    size, _, group = mesh.axis(name)
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def ring_hop(tensors, mesh, name: str = "sp", shift: int = 1):
    """Every rank sends ``tensors`` to the rank ``shift`` places on along
    the axis ``name`` and receives the same-shaped tensors of the rank
    ``shift`` places back (mod the axis size): ``lax.ppermute`` over
    the ring ``i -> i + shift``, as the fabric probe's ring pass
    (``health/fabric_probe.py::_ring_pass``). One ``batch_isend_irecv``
    for all of them; every rank of the axis must make the same calls in
    the same order. At size 1, or a shift of 0 mod the size, it is the
    identity (gloo cannot send a rank to itself)."""
    size, index, group = mesh.axis(name)
    tensors = [t.contiguous() for t in tensors]
    if shift % size == 0:
        return tensors
    ranks = dist.get_process_group_ranks(group)
    to, frm = ranks[(index + shift) % size], ranks[(index - shift) % size]
    got = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, to, group=group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, g, frm, group=group) for g in got]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return got


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, shift):
        ctx.mesh, ctx.name, ctx.shift = mesh, name, shift
        return ring_hop([x], mesh, name, shift)[0]

    @staticmethod
    def backward(ctx, grad):
        # the transpose of a permutation is its inverse: hop back
        return (ring_hop([grad], ctx.mesh, ctx.name, -ctx.shift)[0], None,
                None, None)


def ring_shift(x, mesh, name: str = "sp", shift: int = 1):
    """:func:`ring_hop` of one tensor, differentiable: its backward hops
    the gradient the other way round the ring."""
    return _RingShift.apply(x, mesh, name, shift)


def gather_rows(x, mesh):
    """The dp replicas' rows of ``x``, concatenated in rank order (every
    rank gets the global batch)."""
    if mesh is None or mesh.dp == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.dp_group)
    return torch.cat(parts, dim=0)


def local_rows(x, mesh):
    """This rank's block of the global batch's rows."""
    if mesh is None:
        return x
    if x.shape[0] % mesh.dp:
        raise ValueError(f"batch {x.shape[0]} does not split over "
                         f"dp={mesh.dp}")
    rows = x.shape[0] // mesh.dp
    return x[mesh.dp_rank * rows:(mesh.dp_rank + 1) * rows]


def any_rank(flag: bool, mesh) -> bool:
    """True when ``flag`` holds on any rank. Ranks that leave a loop
    must leave it together: one left waiting in a collective hangs."""
    if mesh is None or mesh.size == 1:
        return bool(flag)
    value = torch.tensor([1 if flag else 0], device=mesh.device)
    dist.all_reduce(value, op=dist.ReduceOp.MAX)
    return bool(value.item())


def named_leaves(tree, key=None):
    """(innermost dict key, leaf) pairs of nested dicts and lists, in
    ``optim.tree_leaves``' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from named_leaves(v, key)
    else:
        yield key, tree


def global_norm(grads, mesh=None):
    """optax's ``global_norm`` over a tree of tp shards: each sharded
    leaf's sum of squares is summed over tp, each replicated leaf counts
    once, and the leaves add in tree order. Float32 (optax's is in the
    leaves' dtype: bfloat16 for bfloat16 gradients; cast to it, as the
    clip casts it, the port's is within one ulp of optax's). The sums of
    squares are
    ``kernels/global_norm.py``'s kernel on the card, without a tp mesh
    with the norm in the same launch; the plain version on the CPU."""
    keys, leaves = zip(*named_leaves(grads))
    if tp_of(mesh) <= 1:
        return sum_of_squares(list(leaves), norm=True)[1]
    squares = list(sum_of_squares(list(leaves))[0])
    sharded = [i for i, k in enumerate(keys) if k in TP_SPLIT_DIM]
    summed = torch.stack([squares[i] for i in sharded])
    dist.all_reduce(summed, group=mesh.tp_group)
    for i, value in zip(sharded, summed):
        squares[i] = value
    return torch.sqrt(sum(squares))


# --------------------------------------------------------------------------
# the ranks


def to_numpy(tree):
    """Tensors of nested dicts, lists and tuples as numpy arrays (bfloat16
    widened to float32, which holds it exactly); other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree


def _rank_main(rank, n, init_method, device_type, fn, args, results,
               mesh_shape=None):
    """One rank: join the process group, build the mesh, run ``fn(mesh,
    *args)`` and send back ``(rank, ok, numpy result or traceback)``.
    ``args`` is a path when the launcher left them in a file."""
    try:
        if isinstance(args, str):
            with open(args, "rb") as f:
                args = pickle.load(f)
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            device = torch.device("cpu")
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=init_method, world_size=n, rank=rank)
        try:
            mesh = make_mesh(n, device=device, shape=mesh_shape)
            out = to_numpy(fn(mesh, *args))
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn_context():
    """The ranks' start method: spawn, since the parent may run threads
    (a JAX runtime, a profiler) that fork would copy half-way."""
    return mp.get_context("spawn")


def run_ranks(fn, n: int, *args, device=None, timeout: float = 900.0,
              mesh_shape=None):
    """Start ``n`` ranks, one process each, that each run ``fn(mesh,
    *args)`` in one process group (NCCL on the card, rank i on card i;
    gloo on the CPU), and return their results in rank order, tensors as
    numpy arrays. ``mesh`` is :func:`make_mesh`'s for ``mesh_shape``
    (default: the dp x tp split). ``fn`` and ``args`` must pickle (a module-level
    function). The ranks meet through a ``file://`` store in a fresh
    temporary directory, so concurrent launches never share a port. A
    rank that raises, dies or outlasts ``timeout`` fails the call, and
    every rank still running is stopped."""
    device = resolve_device(device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} cards, "
                         f"{torch.cuda.device_count()} visible")
    ctx = spawn_context()
    results = ctx.Queue()
    got: "dict[int, object]" = {}
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init_method = f"file://{tmp}/store"
        # A child reads its start-up arguments only after importing the
        # parent's main module, and start() blocks until the pipe holds
        # what the child has not read: arguments larger than the pipe's
        # buffer would start the ranks one after the other. So they go
        # through a file, unless they only pickle for a child (an Event).
        try:
            with open(f"{tmp}/args.pkl", "wb") as f:
                pickle.dump(args, f)
            rank_args = f"{tmp}/args.pkl"
        except (RuntimeError, TypeError, pickle.PicklingError):
            rank_args = args
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, n, init_method, device.type, fn,
                                   rank_args, results, mesh_shape))
                 for rank in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_lib.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"ranks {sorted(set(range(n)) - set(got))} gave "
                            f"no result within {timeout} s") from None
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        # a result may still be in the pipe: one more look
                        try:
                            rank, ok, payload = results.get(timeout=2.0)
                        except queue_lib.Empty:
                            raise RuntimeError(
                                f"ranks {dead} exited (codes "
                                f"{[procs[r].exitcode for r in dead]}) "
                                "without a result") from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n"
                                       f"{payload}")
                got[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    return [got[rank] for rank in range(n)]
