"""Carry JAX parameter pytrees, training states and KV caches across to
the port.

The port keeps the JAX package's parameter layout (weights ``(in, out)``,
applied as ``x @ W``), so conversion is a copy leaf by leaf. The
pipeline's and the experts' stacked weights split over their ``pp`` or
``ep`` axis by layer or expert (:func:`axis_block`). The tests
use it so that both packages compute from the same weights, and
:func:`state_from_jax` lets the port continue a JAX training run, as
:func:`kv_cache_from_jax` lets it continue a JAX decode. With a
``mesh`` each rank keeps its tp shards (:func:`shard_params`), the blocks
that the JAX package's ``NamedSharding``s give the device at its place in
the grid.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.parallel import TP_SPLIT_DIM, tp_of


def _leaf_to_tensor(value) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands out ml_dtypes');
        # the bits are the same, so reinterpret them
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _shard(x, dim: int, mesh):
    """This rank's tp block of ``x`` along ``dim``, in storage of its own:
    a block of rows is already contiguous, and as a view it would keep
    the whole weight (and any buffer it is cut from) alive."""
    if x.shape[dim] % mesh.tp:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over tp={mesh.tp}")
    return x.chunk(mesh.tp, dim=dim)[mesh.tp_rank].clone(
        memory_format=torch.contiguous_format)


def shard_params(params, mesh):
    """This rank's shards of a whole parameter tree: column-parallel
    weights (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``, ``lm_head``)
    split over their output dim, row-parallel ones (``wo``, ``w_down``)
    over their input dim, the rest replicated
    (``tpu_operator_libs/examples/llama.py:176-198``;
    ``parallel.TP_SPLIT_DIM``). The int8 ``{"q", "s"}`` leaves of
    ``quantize_params_int8`` split their codes so; the per-output-channel
    scale splits with a column-parallel weight's columns and stays whole
    for a row-parallel one. At tp = 1 (or ``mesh=None``) the tree comes
    back as it is."""
    if tp_of(mesh) == 1:
        return params

    def split(key, value):
        dim = TP_SPLIT_DIM.get(key)
        if dim is None:
            return walk(value)
        if isinstance(value, dict):
            return {"q": _shard(value["q"], dim, mesh),
                    "s": _shard(value["s"], 0, mesh) if dim == 1
                    else value["s"]}
        return _shard(value, dim, mesh)

    def walk(node):
        if isinstance(node, dict):
            return {k: split(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node

    return walk(params)


#: leaves of the pipeline's and the experts' parameters that every rank
#: of their axis holds whole (``tpu_operator_libs/examples/moe.py:208``);
#: every other leaf is stacked by layer or expert on dim 0
REPLICATED_ON_AXIS = ("router",)


def axis_block(params, mesh, name: str):
    """This rank's block of the layer- or expert-stacked leaves of a flat
    parameter dict (dim 0 over the mesh axis ``name``: the reference's
    ``P(name, None, None)``); the router stays whole."""
    size, index, _ = mesh.axis(name)

    def block(key, value):
        if key in REPLICATED_ON_AXIS:
            return value
        if value.shape[0] % size:
            raise ValueError(f"{key} {tuple(value.shape)} does not split "
                             f"over {name}={size}")
        return value.chunk(size)[index].contiguous()

    return {key: block(key, value) for key, value in params.items()}


def stacked_params_from_jax(tree, *, device=None):
    """The port's pipeline or MoE parameters for the JAX package's
    (``init_stage_params`` / ``init_moe_params``): a flat dict of arrays
    copied leaf by leaf; :func:`axis_block` gives a rank its block."""
    return {key: _leaf_to_tensor(value).to(resolve_device(device))
            for key, value in tree.items()}


def params_from_jax(tree, *, device=None, dtype=None, mesh=None):
    """The port's parameter dict for a JAX params pytree (dicts, lists
    and array leaves). ``dtype`` recasts the plain floating weights; the
    int8 ``{"q": int8, "s": f32}`` leaves of
    ``quantize_params_int8`` are copied as they are. With a ``mesh``, on
    its device, the rank's shards (:func:`shard_params`)."""
    device = mesh.device if mesh is not None else resolve_device(device)

    def convert(node, quantized=False):
        if isinstance(node, dict):
            inner = quantized or set(node) == {"q", "s"}
            return {key: convert(val, inner) for key, val in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(val, quantized) for val in node]
        tensor = _leaf_to_tensor(node)
        if dtype is not None and not quantized \
                and tensor.is_floating_point():
            tensor = tensor.to(dtype)
        return tensor.to(device)

    return shard_params(convert(tree), mesh)


def _adam_state(node):
    """The ``ScaleByAdamState`` (a namedtuple with count, mu and nu)
    inside an optax state, found through the tuples that ``optax.chain``
    nests it in."""
    fields = getattr(node, "_fields", ())
    if {"count", "mu", "nu"} <= set(fields):
        return node
    if isinstance(node, tuple):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def state_from_jax(state, *, device=None, mesh=None):
    """The port's training state ``{"params", "opt": {"count", "mu",
    "nu"}, "step"}`` for a JAX one whose ``"opt"`` is the state of
    ``optax.adamw`` or ``optax.adam``, alone or behind
    ``clip_by_global_norm`` in an ``optax.chain``. With a ``mesh`` the
    parameters and both moments are the rank's shards."""
    adam = _adam_state(state["opt"])
    if adam is None:
        raise ValueError(
            "no Adam state (count, mu, nu) in the optimizer state")
    device = mesh.device if mesh is not None else resolve_device(device)

    def tree(value):
        return params_from_jax(value, device=device, mesh=mesh)

    return {"params": tree(state["params"]),
            "opt": {"count": _leaf_to_tensor(adam.count).to(device),
                    "mu": tree(adam.mu), "nu": tree(adam.nu)},
            "step": _leaf_to_tensor(state["step"]).to(device)}


def kv_cache_from_jax(cache, *, device=None, mesh=None):
    """The port's KV cache (``llama_decode.init_kv_cache``'s list of
    per-layer ``{"k", "v"}`` or ``{"k", "k_s", "v", "v_s"}`` dicts) for
    the JAX package's, so that the port decodes on from a cache that JAX
    wrote: the state counterpart of :func:`params_from_jax`. With a
    ``mesh``, on its device, the rank's block: its dp block of the batch
    rows and its tp block of the KV heads (dims 0 and 2 of every leaf, as
    the JAX package shards its cache)."""
    device = mesh.device if mesh is not None else resolve_device(device)

    def block(x):
        if mesh is None:
            return x
        for dim, size, index in ((0, mesh.dp, mesh.dp_rank),
                                 (2, mesh.tp, mesh.tp_rank)):
            if x.shape[dim] % size:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {size}")
            x = x.chunk(size, dim=dim)[index]
        return x.contiguous()

    return [{name: block(_leaf_to_tensor(value)).to(device)
             for name, value in entry.items()} for entry in cache]
