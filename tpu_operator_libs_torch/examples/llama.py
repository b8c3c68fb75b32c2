"""Llama-style decoder-only transformer on one device: forward and the
training step.

Mirrors ``tpu_operator_libs/examples/llama.py``: ``ATTENTION_IMPLS`` and
``LlamaConfig`` (copied), ``_rms_norm``, ``_rope``,
``init_llama_params``, ``forward`` (with ``remat``), ``next_token_loss``,
``config_for_mesh``, ``make_train_step`` and ``make_token_batch``
(``_rope``, the plain rotation, lives in ``kernels/rope.py``;
``_rms_norm``, the plain norm, in ``kernels/rms_norm.py``). RMSNorm ->
causal self-attention with rotary embeddings and grouped-query KV heads
-> SwiGLU MLP, the Llama-3 block structure. The norms (the attention's
residual add folded into the MLP's norm), the gate and the rotation of q
and k (one launch a layer, which on the flash path writes q, k and v in
the kernel's head-major layout) run the hand-written kernels of
``kernels/rms_norm.py``, ``kernels/swiglu.py`` and ``kernels/rope.py``,
forward and backward, the loss (the log-softmax at the targets and its
mean, forward and backward, over the whole logits) that of
``kernels/cross_entropy.py``, and the train step's global norm and AdamW
update those of ``kernels/global_norm.py`` and ``kernels/adamw.py``; the
layer's output add stays a plain add, the boundary that ``remat`` saves.

Parameters are a nested dict of tensors in the JAX package's layout:
weights are ``(in, out)`` and applied as ``x @ W``, so
:func:`tpu_operator_libs_torch.convert.params_from_jax` is a plain copy.

With a ``mesh`` (:class:`tpu_operator_libs_torch.parallel.Mesh`) each rank
holds its tp shards of the weights (the JAX package's PartitionSpecs,
``parallel.TP_SPLIT_DIM``) and its dp block of the batch: it runs
n_heads/tp query heads over n_kv_heads/tp KV heads (the GQA repeat stays
inside the shard), and the tp all-reduces XLA inserts from the shardings
are ``parallel.copy_to_tp`` / ``reduce_from_tp``. The column-parallel
``lm_head``'s vocabulary shards are all-gathered, so every tp rank holds
the whole logits and the loss is the JAX package's, unchanged.

With ``attention_impl="ring"`` the mesh is dp x sp (tp = 1): each rank
holds the whole weights, its dp rows and its sp block of the sequence,
and attention is ``examples/ring_attention.py``. What the JAX package
gets from global arrays is written out: RoPE at the block's global
positions, logits left sharded over the sequence, a loss whose target
shift crosses the block boundary (the last position of block r predicts
the first token of block r + 1) and whose mean is over the global
``B * (S - 1)``, and the gradients of the replicated weights summed over
sp before the mean over dp.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.convert import shard_params
from tpu_operator_libs_torch.examples.ring_attention import ring_attention
from tpu_operator_libs_torch.kernels.cross_entropy import cross_entropy
from tpu_operator_libs_torch.kernels.flash_attention import flash_attention
from tpu_operator_libs_torch.kernels.rms_norm import (  # noqa: F401
    add_rms_norm,
    rms_norm_reference as _rms_norm,  # the plain norm, the reference's name
)
from tpu_operator_libs_torch.kernels.rope import (  # noqa: F401
    rope_qk,
    rope_reference as _rope,  # the plain rotation, the reference's name
)
from tpu_operator_libs_torch.kernels.swiglu import swiglu
from tpu_operator_libs_torch.optim import AdamW, tree_map, value_and_grad
from tpu_operator_libs_torch.parallel import (
    copy_to_tp,
    gather_from_tp,
    local_rows,
    local_seq,
    mean_over_dp,
    reduce_from_sp,
    reduce_from_tp,
    ring_hop,
    sum_over,
    tp_of,
)

#: Attention implementations forward() accepts; validate_for and
#: forward both check against this single list so they cannot drift.
ATTENTION_IMPLS = ("xla", "flash", "ring")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Model shape. tp must divide n_heads, n_kv_heads and d_ff."""

    vocab: int = 64
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 4      # grouped-query attention (Llama-3 style)
    d_ff: int = 128          # SwiGLU hidden width (total, pre-shard)
    seq_len: int = 32
    rope_theta: float = 10000.0
    learning_rate: float = 3e-3
    # Optional LR schedule: with total_steps > 0 the step uses linear
    # warmup over warmup_steps then cosine decay to 0 at total_steps;
    # 0 keeps the constant LR.
    warmup_steps: int = 0
    total_steps: int = 0
    # Optional global-norm gradient clipping (0 = off).
    grad_clip_norm: float = 0.0
    # "xla" (einsum softmax over materialized scores), "flash" (the
    # hand-written CUDA kernel of kernels/flash_attention.py; never
    # materializes the S x S scores; tp=1 only) or "ring" (the sequence
    # sharded over a dp x sp mesh, examples/ring_attention.py).
    attention_impl: str = "xla"
    # Rematerialize each decoder layer on the backward pass (a training
    # option; forward-only callers are unaffected).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def validate_for(self, tp: int) -> None:
        if self.d_model % self.n_heads:
            raise ValueError("n_heads must divide d_model")
        if self.head_dim % 2:
            raise ValueError(
                f"head_dim={self.head_dim} must be even (RoPE rotates "
                "half-dimension pairs)")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_kv_heads must divide n_heads (GQA)")
        if self.n_kv_heads % tp or self.d_ff % tp or self.vocab % tp:
            raise ValueError(
                f"tp={tp} must divide n_kv_heads={self.n_kv_heads}, "
                f"d_ff={self.d_ff} and vocab={self.vocab} "
                "(lm_head is column-parallel)")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r} "
                f"(expected one of {ATTENTION_IMPLS})")
        if self.attention_impl == "flash" and tp > 1:
            raise ValueError(
                "attention_impl='flash' requires tp=1 (the kernel is not "
                "tensor-parallel partitioned)")
        if self.attention_impl == "ring" and tp > 1:
            raise ValueError(
                "attention_impl='ring' shards the sequence (sp), not "
                "heads; use tp=1 with a dp x sp mesh")


def init_llama_params(config: "LlamaConfig | None" = None,
                      param_dtype=None, seed: int = 0, *, device=None,
                      mesh=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device``. The layout is the JAX package's; the numbers differ
    from its ``jax.random`` draws (tests convert JAX's params instead).
    With a ``mesh``, on its device, every rank draws the whole tree and
    keeps its tp shards, so any tp splits the same weights."""
    config = config or LlamaConfig()
    config.validate_for(tp_of(mesh))
    device = mesh.device if mesh is not None else resolve_device(device)
    dtype = param_dtype or torch.float32
    d, hd = config.d_model, config.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def tensor(shape, scale=None):
        scale = scale if scale is not None else shape[0] ** -0.5
        value = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale
        return value.to(dtype)

    def ones():
        return torch.ones((d,), dtype=dtype, device=device)

    params = {
        "embed": tensor((config.vocab, d), scale=0.02),
        "final_norm": ones(),
        "lm_head": tensor((d, config.vocab)),
        "layers": [],
    }
    for _ in range(config.n_layers):
        params["layers"].append({
            "attn_norm": ones(),
            "wq": tensor((d, config.n_heads * hd)),
            "wk": tensor((d, config.n_kv_heads * hd)),
            "wv": tensor((d, config.n_kv_heads * hd)),
            "wo": tensor((config.n_heads * hd, d)),
            "mlp_norm": ones(),
            "w_gate": tensor((d, config.d_ff)),
            "w_up": tensor((d, config.d_ff)),
            "w_down": tensor((config.d_ff, d)),
        })
    return shard_params(params, mesh)


def forward(params, tokens, config: LlamaConfig, mesh=None):
    """Logits (B, S, vocab) for integer ``tokens`` (B, S), causal, on
    the device the parameters live on. With a ``mesh``, ``params`` are
    this rank's shards and the logits are whole on every tp rank."""
    seq = tokens.shape[1]
    if config.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention_impl {config.attention_impl!r} "
            f"(expected one of {ATTENTION_IMPLS})")
    h = params["embed"][tokens.long()]
    positions = None
    if config.attention_impl == "ring":
        if mesh is None or "sp" not in mesh.axis_names:
            raise ValueError(
                "attention_impl='ring' needs a mesh with an 'sp' axis")
        # the rank's block of the sequence rotates at its global positions
        positions = mesh.sp_rank * seq + torch.arange(seq, device=h.device)
    elif mesh is not None and mesh.sp > 1:
        raise ValueError(
            f"a mesh with sp={mesh.sp} shards the sequence: it runs "
            "attention_impl='ring' only")
    # only the einsum path materializes a mask; flash and ring mask in
    # their kernels
    causal = (torch.ones(seq, seq, dtype=torch.bool, device=h.device).tril()
              if config.attention_impl == "xla" else None)
    for layer in params["layers"]:
        if config.remat:
            # recompute the layer's activations on the backward pass; the
            # saved boundary is the layer's input residual stream
            h = checkpoint(_layer, h, layer, config, causal, mesh,
                           positions, use_reentrant=False)
        else:
            h = _layer(h, layer, config, causal, mesh, positions)

    h = copy_to_tp(add_rms_norm(h, None, params["final_norm"])[1], mesh)
    # ring: the logits stay sharded over the sequence
    return gather_from_tp(h @ params["lm_head"], mesh)


def _layer(h, layer, config: LlamaConfig, causal, mesh=None,
           positions=None):
    """One decoder layer on this rank's heads and d_ff columns;
    ``causal`` is the einsum path's (S, S) mask, or None for the flash
    and ring kernels, which mask inside; ``positions``: the ring block's
    global positions for RoPE."""
    batch, seq, _ = h.shape
    tp = tp_of(mesh)
    hd = config.head_dim
    nh, nkv = config.n_heads // tp, config.n_kv_heads // tp
    a = copy_to_tp(add_rms_norm(h, None, layer["attn_norm"])[1], mesh)
    q = (a @ layer["wq"]).reshape(batch, seq, nh, hd)
    k = (a @ layer["wk"]).reshape(batch, seq, nkv, hd)
    v = (a @ layer["wv"]).reshape(batch, seq, nkv, hd)
    if config.attention_impl == "ring":
        q, k = rope_qk(q, k, config.rope_theta, positions)
        # only the narrow KV heads travel the ring
        ctx = ring_attention(q, k, v, mesh, causal=True)
    elif causal is None:
        # q, k and v written (B, H, S, D) by the rotation's launch; the
        # kernel reads the nkv-head K/V natively (no repeat)
        q, k, v = rope_qk(q, k, config.rope_theta, positions, v=v,
                          head_major=True)
        ctx = flash_attention(q, k, v, causal=True, sm_scale=hd ** -0.5)
        ctx = ctx.transpose(1, 2)
    else:
        q, k = rope_qk(q, k, config.rope_theta, positions)
        group = nh // nkv
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        scores = scores.float().masked_fill(~causal, -1e30)
        attn = torch.softmax(scores, dim=-1).to(h.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    # the attention's residual add folded into the MLP's norm
    h, m = add_rms_norm(
        h, reduce_from_tp(ctx.reshape(batch, seq, nh * hd) @ layer["wo"],
                          mesh), layer["mlp_norm"])
    m = copy_to_tp(m, mesh)
    gated = swiglu(m @ layer["w_gate"], m @ layer["w_up"])
    # a plain add: the layer's output is the boundary remat saves
    return h + reduce_from_tp(gated @ layer["w_down"], mesh)


def next_token_loss(params, tokens, config: LlamaConfig, mesh=None):
    """Mean next-token cross-entropy over (B, S) integer tokens (this
    rank's rows, with a ``mesh``; with ``attention_impl="ring"`` this
    rank's block of them, and the mean is the dp replica's over its whole
    sequence, on every sp rank)."""
    if config.attention_impl == "ring":
        return _ring_loss(params, tokens, config, mesh)
    # the whole logits: the kernels skip the last position, which has no
    # target
    logits = forward(params, tokens, config, mesh)
    return cross_entropy(logits, tokens[:, 1:].long().contiguous())


def _ring_loss(params, tokens, config: LlamaConfig, mesh):
    """The sequence block's part of the loss, summed over sp: its last
    position's target is the next block's first token (one hop back
    round the ring), the last block drops its last position, and each
    block's mean is weighted by its share of the ``B * (S - 1)``
    targets."""
    logits = forward(params, tokens, config, mesh)
    sp, sp_rank, _ = mesh.axis("sp")
    after = ring_hop([tokens[:, :1]], mesh, "sp", shift=-1)[0]
    targets = torch.cat([tokens[:, 1:], after], dim=1).long()
    if sp_rank == sp - 1:
        targets = targets[:, :-1].contiguous()
    share = targets.numel() / (tokens.shape[0] * (tokens.shape[1] * sp - 1))
    return reduce_from_sp(cross_entropy(logits, targets) * share, mesh)


def config_for_mesh(tp: int) -> LlamaConfig:
    """The default config when it shards evenly over ``tp``, otherwise
    a tp-derived shape that always does."""
    base = LlamaConfig()
    try:
        base.validate_for(tp)
        return base
    except ValueError:
        return LlamaConfig(vocab=16 * tp, d_model=8 * tp,
                           n_heads=tp, n_kv_heads=tp, d_ff=16 * tp,
                           seq_len=base.seq_len)


def make_train_step(config: LlamaConfig, *, device=None, mesh=None):
    """(optimizer, step) where ``step(state, tokens) -> (state, loss)`` on
    the state ``{"params", "opt", "step"}`` the checkpoint/resume loop
    expects; ``optimizer.init(params)`` makes the ``"opt"`` entry. The
    step is functional: it returns new tensors and leaves ``state`` as it
    was, so a caller may keep an old state (the checkpoint check does).
    Tokens are moved to ``device``, where the state must live.

    With a ``mesh`` the state holds this rank's shards and ``tokens`` its
    rows (:func:`make_token_batch` with the mesh): the loss and the
    gradients are averaged over dp, so the step minimises the global
    batch's mean, the clip takes the norm of the whole model
    (``parallel.global_norm``), and AdamW runs on the shards. On a dp x
    sp mesh (``"ring"``) each rank's gradients are its sequence block's
    part, summed over sp before the dp mean."""
    if config.total_steps < 0 or config.warmup_steps < 0:
        raise ValueError(
            f"total_steps={config.total_steps} / warmup_steps="
            f"{config.warmup_steps} must be >= 0 (a negative horizon "
            "would silently fall back to constant LR)")
    if config.warmup_steps and config.total_steps <= 0:
        raise ValueError(
            f"warmup_steps={config.warmup_steps} requires "
            "total_steps > 0 (the schedule horizon); total_steps=0 "
            "means constant LR and would silently skip the warmup")
    if 0 < config.total_steps <= config.warmup_steps:
        raise ValueError(
            f"warmup_steps={config.warmup_steps} must be < "
            f"total_steps={config.total_steps} (cosine decay needs a "
            "positive post-warmup horizon)")
    if config.grad_clip_norm < 0.0:
        raise ValueError(
            f"grad_clip_norm must be >= 0, got {config.grad_clip_norm}")
    config.validate_for(tp_of(mesh))
    device = mesh.device if mesh is not None else resolve_device(device)
    optimizer = AdamW(config.learning_rate, clip_norm=config.grad_clip_norm,
                      warmup_steps=config.warmup_steps,
                      total_steps=config.total_steps, mesh=mesh)

    def train_step(state, tokens):
        loss, grads = value_and_grad(next_token_loss, state["params"],
                                     tokens.to(device), config, mesh)
        if mesh is not None:
            loss = mean_over_dp(loss, mesh)
            grads = tree_map(
                lambda g: mean_over_dp(sum_over(g, mesh, "sp"), mesh), grads)
        params, opt = optimizer.update(grads, state["opt"],
                                       state["params"])
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, loss

    return optimizer, train_step


def make_token_batch(step: int, config: LlamaConfig,
                     batch_per_shard: int = 2, *, device=None, start=None,
                     mesh=None):
    """Deterministic synthetic sequences with learnable structure: the
    affine orbit x_{t+1} = (7 x_t + 3) mod vocab from ``start`` (batch,)
    (default: a CPU ``torch.Generator`` seeded ``7000 + step``), int32
    (batch, seq_len) on ``device``. The global batch has
    ``batch_per_shard * dp`` rows; with a ``mesh``, on its device, the
    rank gets its dp block of them, and on a mesh with an sp axis its sp
    block of their columns."""
    device = mesh.device if mesh is not None else resolve_device(device)
    batch = batch_per_shard * (mesh.dp if mesh is not None else 1)
    if start is None:
        gen = torch.Generator().manual_seed(7000 + step)
        start = torch.randint(0, config.vocab, (batch,), generator=gen)
    x = torch.from_numpy(np.array(start, dtype=np.int64).reshape(-1))
    if x.shape[0] != batch:
        raise ValueError(
            f"start has {x.shape[0]} rows, the global batch has {batch} "
            f"(batch_per_shard {batch_per_shard})")
    x = local_rows(x, mesh)
    columns = []
    for _ in range(config.seq_len):
        columns.append(x)
        x = (x * 7 + 3) % config.vocab
    tokens = torch.stack(columns, dim=1)
    if mesh is not None:
        tokens = local_seq(tokens, mesh)
    return tokens.to(device=device, dtype=torch.int32)
