"""AdamW with an optional warmup-cosine schedule and global-norm
clipping, on the port's parameter dicts.

Mirrors the optimizer ``tpu_operator_libs/examples/llama.py::make_train_step``
composes from optax (``:393-404``)::

    optax.chain(optax.clip_by_global_norm(clip_norm),      # when > 0
                optax.adamw(lr))   # lr: a float or warmup_cosine_decay_schedule

and ``optax.adam`` (``weight_decay=0``), which the MLP of
``examples/jax_training_job.py`` uses. It is functional like optax:
:meth:`AdamW.update` returns new parameters and a new state and leaves
its arguments as they are. The state is ``{"count", "mu", "nu"}``, the
fields of optax's ``ScaleByAdamState``, with no tuple nesting (the
schedule's count is the same as Adam's and clipping keeps none), so a
checkpoint is one flat dict. Everything stays on the parameters' device:
no step reads a value back to the host.

Where optax's numerics differ from ``torch.optim.AdamW``, this follows
optax: weight decay 1e-4 (torch's default is 1e-2), ``eps`` outside the
square root, bias correction at ``count + 1``, moments in the parameter
dtype, the learning rate of a schedule taken at the count before the
increment, and clipping by ``max_norm / norm`` only when
``norm >= max_norm``, with no epsilon (``clip_grad_norm_`` divides by
``norm + 1e-6``). The global norm is taken in float32; on tp shards
(a ``mesh``) it is the whole model's (``parallel.global_norm``), as optax
takes it over the global arrays.

The update itself is ``kernels/adamw.py``'s :func:`adamw_update`: one
hand-written kernel launch over every leaf on the card, its plain
version (this class's former body, op for op) on the CPU. With clipping
the norm before it is ``kernels/global_norm.py``'s kernel on the card
(one launch over every leaf without a tp mesh), its plain version on the
CPU.
"""

from __future__ import annotations

import math

import torch

from tpu_operator_libs_torch.kernels.adamw import (  # noqa: F401
    B1,  # optax.adamw's defaults, which make_train_step takes as they are
    B2,
    EPS,
    adamw_update,
)
from tpu_operator_libs_torch.parallel import global_norm


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts and lists, with the
    matching leaves of ``rest``; the result keeps ``tree``'s nesting."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val, *(r[key] for r in rest))
                for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, val, *(r[i] for r in rest))
                for i, val in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> "list[torch.Tensor]":
    leaves: "list[torch.Tensor]" = []
    tree_map(leaves.append, tree)
    return leaves


def value_and_grad(loss_fn, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)``, a scalar, with
    respect to every leaf of ``params``; grads have the params'
    nesting and dtypes, and both are detached."""
    with torch.enable_grad():
        leaves = tree_leaves(params)
        inputs = [leaf.detach().requires_grad_() for leaf in leaves]
        it = iter(inputs)
        loss = loss_fn(tree_map(lambda _: next(it), params), *args)
        grads = iter(torch.autograd.grad(loss, inputs))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def warmup_cosine_decay(count, *, peak_value: float, warmup_steps: int,
                        decay_steps: int):
    """``optax.warmup_cosine_decay_schedule(init_value=0, peak_value,
    warmup_steps, decay_steps)`` at ``count`` (a tensor), in float32: a
    linear ramp from 0 over ``warmup_steps``, then a cosine decay to 0
    at ``decay_steps``."""
    count = count.to(torch.float32)
    horizon = decay_steps - warmup_steps
    after = torch.clamp(count - warmup_steps, max=float(horizon))
    decayed = peak_value * (
        0.5 * (1 + torch.cos(math.pi * after / horizon)))
    if warmup_steps <= 0:
        return decayed
    frac = 1 - torch.clamp(count, 0, warmup_steps) / warmup_steps
    warm = -peak_value * frac + peak_value
    return torch.where(count < warmup_steps, warm, decayed)


class AdamW:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4),
    optionally behind ``optax.clip_by_global_norm(clip_norm)`` and with
    ``warmup_cosine_decay_schedule`` when ``total_steps > 0``."""

    def __init__(self, learning_rate: float, *, weight_decay: float = 1e-4,
                 clip_norm: float = 0.0, warmup_steps: int = 0,
                 total_steps: int = 0, mesh=None):
        self.peak_lr = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.mesh = mesh

    def init(self, params):
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def learning_rate(self, count):
        """The step size at ``count`` updates so far, a float32 tensor
        (a float when the rate is constant)."""
        if self.total_steps <= 0:
            return self.peak_lr
        return warmup_cosine_decay(count, peak_value=self.peak_lr,
                                   warmup_steps=self.warmup_steps,
                                   decay_steps=self.total_steps)

    @torch.no_grad()
    def update(self, grads, state, params):
        """(new params, new state) after one step on ``grads``: the
        leaves in ``params``' order through
        :func:`~tpu_operator_libs_torch.kernels.adamw.adamw_update` (the
        kernel on the card, one launch a step; on the CPU its plain
        version, ``adamw_update_reference``), with clipping behind
        ``parallel.global_norm`` (on one card one more launch)."""
        def leaves(tree):  # tree's leaves in params' order
            return tree_leaves(tree_map(lambda _, x: x, params, tree))

        norm = (global_norm(grads, self.mesh) if self.clip_norm > 0.0
                else None)
        new_params, new = adamw_update(
            leaves(grads), {"count": state["count"],
                            "mu": leaves(state["mu"]),
                            "nu": leaves(state["nu"])}, tree_leaves(params),
            lr=self.learning_rate(state["count"]),
            weight_decay=self.weight_decay, clip_norm=self.clip_norm,
            norm=norm)

        def like_params(flat):
            it = iter(flat)
            return tree_map(lambda _: next(it), params)

        return like_params(new_params), {"count": new["count"],
                                         "mu": like_params(new["mu"]),
                                         "nu": like_params(new["nu"])}
