"""Carry JAX parameter pytrees and training states across to the port.

The port keeps the JAX package's parameter layout (weights ``(in, out)``,
applied as ``x @ W``), so conversion is a copy leaf by leaf. The tests
use it so that both packages compute from the same weights, and
:func:`state_from_jax` lets the port continue a JAX training run.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_operator_libs_torch import resolve_device


def _leaf_to_tensor(value) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands out ml_dtypes');
        # the bits are the same, so reinterpret them
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree, *, device=None, dtype=None):
    """The port's parameter dict for a JAX params pytree (dicts, lists
    and array leaves). ``dtype`` recasts the plain floating weights; the
    int8 ``{"q": int8, "s": f32}`` leaves of
    ``quantize_params_int8`` are copied as they are."""
    device = resolve_device(device)

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

    return convert(tree)


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


def state_from_jax(state, *, device=None):
    """The port's training state ``{"params", "opt": {"count", "mu",
    "nu"}, "step"}`` for a JAX one whose ``"opt"`` is the state of
    ``optax.adamw`` or ``optax.adam``, alone or behind
    ``clip_by_global_norm`` in an ``optax.chain``."""
    adam = _adam_state(state["opt"])
    if adam is None:
        raise ValueError(
            "no Adam state (count, mu, nu) in the optimizer state")
    device = resolve_device(device)
    return {"params": params_from_jax(state["params"], device=device),
            "opt": {"count": _leaf_to_tensor(adam.count).to(device),
                    "mu": params_from_jax(adam.mu, device=device),
                    "nu": params_from_jax(adam.nu, device=device)},
            "step": _leaf_to_tensor(state["step"]).to(device)}
