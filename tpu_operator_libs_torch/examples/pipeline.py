"""Pipeline parallelism: layers sharded over the pp ranks, activations
handed stage to stage round the ring (the GPipe schedule).

Mirrors ``tpu_operator_libs/examples/pipeline.py``: ``init_stage_params``,
``_block``, ``_stage_forward``, ``pipeline_forward``, ``make_pipeline``
and ``sequential_reference``. Each rank holds one stage, a contiguous
block of layers (the reference's ``P("pp", None, None)``;
``convert.axis_block``). A batch is split into M microbatches; on
schedule step t, stage s runs microbatch ``t - s`` when it is in range
and hands its activation to stage s + 1 (``parallel.ring_shift``, the
reference's ``ppermute``): ``pp + M - 1`` steps. The last stage banks
the finished microbatches; the output is summed over pp, so every rank
returns it whole. The result equals all layers run in order on one
device: the hand-offs only move activations.
"""

from __future__ import annotations

import torch

from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.convert import axis_block
from tpu_operator_libs_torch.parallel import ring_shift, sum_over


def init_stage_params(n_layers_total: int, d_model: int, d_hidden: int,
                      pp: int, *, seed: int = 0, device=None):
    """Stacked residual-MLP block weights ``{"w1": (L, d, h), "w2": (L,
    h, d)}`` in float32 from a ``torch.Generator`` seeded with ``seed``
    (the layout of the reference's, not its ``jax.random`` numbers);
    layer i belongs to stage ``i // (L / pp)``."""
    if n_layers_total % pp:
        raise ValueError(f"pp={pp} must divide n_layers={n_layers_total}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {"w1": randn(n_layers_total, d_model, d_hidden) * d_model ** -0.5,
            "w2": randn(n_layers_total, d_hidden, d_model)
            * d_hidden ** -0.5}


def _block(x, w1, w2):
    """One residual MLP layer (B, d) -> (B, d)."""
    return x + torch.tanh(x @ w1) @ w2


def _stage_forward(x, w1_stack, w2_stack):
    """This stage's layer stack, in order."""
    for w1, w2 in zip(w1_stack, w2_stack):
        x = _block(x, w1, w2)
    return x


def pipeline_forward(params_local, microbatches, mesh,
                     axis_name: str = "pp"):
    """This stage's part of the GPipe schedule. ``params_local``: the
    stage's stacks ``{"w1": (L/pp, d, h), "w2": (L/pp, h, d)}``;
    ``microbatches``: the whole (M, Bm, d) input, the same on every
    stage (stage 0 reads it, later stages take what the stage before
    handed over). Returns (M, Bm, d): the finished activations on the
    last stage, zeros elsewhere. Every rank of the axis hands over at
    every step, in the same order."""
    size, stage, _ = mesh.axis(axis_name)
    n_micro = microbatches.shape[0]
    zero = torch.zeros_like(microbatches[0])
    banked = [zero] * n_micro
    recv = zero
    for t in range(size + n_micro - 1):
        micro = t - stage
        out = zero
        if 0 <= micro < n_micro:
            x_in = microbatches[micro] if stage == 0 else recv
            out = _stage_forward(x_in, params_local["w1"],
                                 params_local["w2"])
            if stage == size - 1:
                banked[micro] = out
        # stage pp-1's hand-off wraps to stage 0, which ignores it
        recv = ring_shift(out, mesh, axis_name)
    return torch.stack(banked)


def make_pipeline(mesh, axis_name: str = "pp"):
    """The run-ranks counterpart of the reference's jitted ``shard_map``:
    ``(stacked_params, microbatches) -> (M, Bm, d)`` on every rank of the
    axis, each passing the whole model; the rank keeps its stage's block
    of layers and the output is summed over pp, so every rank returns the
    whole of it."""
    def run(params, microbatches):
        local = axis_block(params, mesh, axis_name)
        out = pipeline_forward(local, microbatches.to(mesh.device), mesh,
                               axis_name)
        return sum_over(out, mesh, axis_name)

    return run


def sequential_reference(params, microbatches):
    """All layers on one device, for verification."""
    return torch.stack([_stage_forward(m, params["w1"], params["w2"])
                        for m in microbatches])
