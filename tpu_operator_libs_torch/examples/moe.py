"""Expert parallelism: a mixture-of-experts layer with its experts
sharded over the ep ranks.

Mirrors ``tpu_operator_libs/examples/moe.py``: ``init_moe_params``,
``_expert_mlp``, ``_route``, ``moe_forward``, ``moe_forward_a2a``,
``make_moe`` and ``dense_reference``. Top-1 token-choice routing: a
linear router scores every token against every expert, and each token
goes through its argmax expert, scaled by that expert's softmax
probability (Switch Transformer). Each rank holds an equal block of
experts (``convert.axis_block``; the router is replicated) and a block
of the tokens. Two dispatch modes:

- ``"gather"``: every rank all-gathers the tokens, runs its experts on
  the tokens routed to them, and an all-reduce sums the disjoint
  outputs. Exact: no capacity, no drops.
- ``"all_to_all"``: each token travels only to its expert's rank,
  through ``capacity`` slots per (source rank, expert)
  (``torch.distributed.all_to_all_single`` there and back); tokens over
  capacity are dropped (zero output; the residual carries them) and
  counted exactly. The slot arithmetic stays in float32 whatever the
  token dtype: a bfloat16 cumsum cannot count past 256 and would collide
  slots.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.convert import axis_block
from tpu_operator_libs_torch.parallel import gather_axis, sum_over

DISPATCH_MODES = ("gather", "all_to_all")


def init_moe_params(n_experts: int, d_model: int, d_hidden: int, *,
                    seed: int = 0, device=None):
    """Router and per-expert MLP weights (experts stacked on dim 0), in
    float32 from a ``torch.Generator`` seeded with ``seed`` (the layout of
    the reference's, not its ``jax.random`` numbers)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {"router": randn(d_model, n_experts) * d_model ** -0.5,
            "w1": randn(n_experts, d_model, d_hidden) * d_model ** -0.5,
            "w2": randn(n_experts, d_hidden, d_model) * d_hidden ** -0.5}


def _expert_mlp(x, w1, w2):
    """One expert's MLP, shared by both dispatch paths and the
    references."""
    return torch.tanh(x @ w1) @ w2


def _route(tokens, router):
    """(expert index per token, top-1 softmax gate per token in the
    tokens' dtype). The scores take the wider of the two dtypes, as
    JAX promotes bf16 tokens against an f32 router."""
    wide = torch.promote_types(tokens.dtype, router.dtype)
    logits = tokens.to(wide) @ router.to(wide)
    probs = torch.softmax(logits.float(), dim=-1)
    choice = torch.argmax(logits, dim=-1)
    gate = torch.gather(probs, -1, choice[:, None])[:, 0]
    return choice, gate.to(tokens.dtype)


def moe_forward(params_local, tokens_local, mesh, n_experts: int,
                axis_name: str = "ep"):
    """All-gather dispatch on this rank: ``params_local`` the router and
    this rank's experts ``{"w1": (E/ep, d, h), "w2": (E/ep, h, d)}``,
    ``tokens_local`` this rank's (B_local, d). Returns this rank's
    (B_local, d) output."""
    size, shard, _ = mesh.axis(axis_name)
    per_shard = n_experts // size
    b_local = tokens_local.shape[0]
    all_tokens = gather_axis(tokens_local, mesh, axis_name)
    choice, gate = _route(all_tokens, params_local["router"])
    out = torch.zeros_like(all_tokens)
    for local in range(per_shard):
        mine = (choice == shard * per_shard + local)[:, None]
        x = torch.where(mine, all_tokens, 0.0)
        y = _expert_mlp(x, params_local["w1"][local],
                        params_local["w2"][local])
        out = out + torch.where(mine, y, 0.0)
    combined = sum_over(out * gate[:, None], mesh, axis_name)
    return combined[shard * b_local:(shard + 1) * b_local]


def _all_to_all(x, mesh, axis_name):
    """Block i of dim 0 to rank i of the axis; block j of the result
    from rank j."""
    size, _, group = mesh.axis(axis_name)
    x = x.contiguous()
    if size == 1:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_forward_a2a(params_local, tokens_local, mesh, n_experts: int,
                    capacity: int, axis_name: str = "ep"):
    """Capacity-bounded all-to-all dispatch on this rank: (this rank's
    (B_local, d) output, the number of its tokens dropped, a float32
    scalar). Slots are assigned over the local tokens in order, per
    expert, as the reference's per-source capacity."""
    size = mesh.axis(axis_name)[0]
    per_shard = n_experts // size
    d_model = tokens_local.shape[-1]
    choice, gate = _route(tokens_local, params_local["router"])
    onehot = F.one_hot(choice, n_experts).float()              # (Bl, E)
    position = (torch.cumsum(onehot, dim=0) - 1.0) * onehot    # (Bl, E)
    keep = onehot * (position < capacity)
    dropped = onehot.sum() - keep.sum()
    # positions past capacity are not kept: any in-range class will do
    slot = keep[..., None] * F.one_hot(
        position.long().clamp(max=capacity - 1), capacity).float()
    send = torch.einsum("bd,bec->ecd", tokens_local.float(), slot)
    send = send.to(tokens_local.dtype).reshape(size, per_shard, capacity,
                                               d_model)
    recv = _all_to_all(send, mesh, axis_name)  # (source, E/ep, C, d)
    processed = torch.stack([
        _expert_mlp(recv[:, local].reshape(size * capacity, d_model),
                    params_local["w1"][local],
                    params_local["w2"][local]).reshape(size, capacity,
                                                       d_model)
        for local in range(per_shard)], dim=1)
    back = _all_to_all(processed, mesh, axis_name)
    back = back.reshape(n_experts, capacity, d_model)
    combined = torch.einsum("ecd,bec->bd", back.float(), slot)
    return combined.to(tokens_local.dtype) * gate[:, None], dropped


def slots_per_expert(tokens_local: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per (source rank, expert) for ``tokens_local`` tokens a
    rank."""
    return max(1, math.ceil(tokens_local * capacity_factor / n_experts))


def make_moe(mesh, n_experts: int, axis_name: str = "ep",
             dispatch: str = "gather", capacity_factor: float = 1.25):
    """The run-ranks counterpart of the reference's jitted ``shard_map``:
    ``(params, tokens) -> out`` on every rank of the axis, each passing
    the whole parameters and (B, d) tokens; the rank keeps its experts
    and its block of the tokens, and the output is gathered so every rank
    returns it whole. With ``"all_to_all"`` the result is ``(out,
    dropped)``, the drops summed over ep."""
    size = mesh.axis(axis_name)[0]
    if n_experts % size:
        raise ValueError(f"ep={size} must divide n_experts={n_experts}")
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch {dispatch!r}")

    def run(params, tokens):
        local = axis_block(params, mesh, axis_name)
        rows = tokens.to(mesh.device)
        if rows.shape[0] % size:
            raise ValueError(f"{rows.shape[0]} tokens do not split over "
                             f"{axis_name}={size}")
        b_local = rows.shape[0] // size
        index = mesh.axis(axis_name)[1]
        rows = rows[index * b_local:(index + 1) * b_local]
        if dispatch == "gather":
            out = moe_forward(local, rows, mesh, n_experts, axis_name)
            return gather_axis(out, mesh, axis_name)
        out, dropped = moe_forward_a2a(
            local, rows, mesh, n_experts,
            slots_per_expert(b_local, n_experts, capacity_factor),
            axis_name)
        return (gather_axis(out, mesh, axis_name),
                sum_over(dropped, mesh, axis_name))

    return run


def dense_reference(params, tokens):
    """All experts on one device, for verification."""
    choice, gate = _route(tokens, params["router"])
    out = torch.zeros_like(tokens)
    for e in range(params["w1"].shape[0]):
        mine = (choice == e)[:, None]
        y = _expert_mlp(tokens, params["w1"][e], params["w2"][e])
        out = out + torch.where(mine, y, 0.0)
    return out * gate[:, None]


def capacity_reference(params, tokens, ep: int, capacity_factor: float):
    """The all-to-all dispatch's result on one device, for verification:
    (the dense output with every dropped token's row zero, the number
    dropped). Of each source block of B/ep tokens, the first
    ``capacity`` routed to an expert, in order, are kept."""
    n_experts = params["w1"].shape[0]
    choice, _ = _route(tokens, params["router"])
    b_local = tokens.shape[0] // ep
    slots = slots_per_expert(b_local, n_experts, capacity_factor)
    kept = torch.zeros(tokens.shape[0], dtype=torch.bool,
                       device=tokens.device)
    for start in range(0, tokens.shape[0], b_local):
        block = choice[start:start + b_local]
        for e in range(n_experts):
            rows = torch.nonzero(block == e)[:slots, 0] + start
            kept[rows] = True
    out = torch.where(kept[:, None], dense_reference(params, tokens), 0.0)
    return out, int((~kept).sum())
