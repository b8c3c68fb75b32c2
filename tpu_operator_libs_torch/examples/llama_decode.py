"""Autoregressive decoding with a KV cache for the Llama example.

Mirrors ``tpu_operator_libs/examples/llama_decode.py``: ``init_kv_cache``,
``_sym_int8``, ``_quantize_kv_block``, ``quantize_params_int8``, ``_mm``,
``forward_with_cache``, ``_pick_next``, ``_prefill`` and the ``_check_*``
helpers, ``generate`` and ``generate_on_device``.

The test contract is the JAX package's: feeding a sequence one token at
a time through :func:`forward_with_cache` reproduces the batch
:func:`~tpu_operator_libs_torch.examples.llama.forward` logits at every
position to float tolerance (the cache is a rearrangement, not an
approximation).

Two differences of form. JAX updates the cache functionally
(``dynamic_update_slice`` on a donated buffer); here the cache is a list
of preallocated buffers written in place, and :func:`forward_with_cache`
returns the same list. Sampling draws Gumbel noise from an explicit
``torch.Generator`` instead of splitting a ``jax.random`` key; the host
and device loops consume it in the same order, so they draw the same
tokens. The int8-weight matmul is a hand-written kernel
(``kernels/int8_matmul.py``) that reads the codes as int8; the decode
attention stays plain PyTorch (XLA fuses both on the TPU; neither has a
Pallas source).

On the card, :func:`generate_on_device` replays one decode step from a
captured CUDA graph where JAX runs a ``lax.scan``: the step reads and
writes only preallocated device tensors, its position among them.

With a ``mesh`` (dp x tp, as the JAX package shards its cache on the
batch and KV-head axes) every entry point takes the global prompt and
returns the global tokens on every rank: a rank decodes its dp block of
the rows over its n_kv_heads/tp KV heads, the forward's tp reduce points
sum the row-parallel products, the vocabulary shards are gathered before
sampling, and the rows are gathered once at the end. Every tp rank then
picks from the same logits; a sampling caller gives each rank an equally
seeded generator.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.examples.llama import _rms_norm, _rope
from tpu_operator_libs_torch.kernels import WRAPPERS
from tpu_operator_libs_torch.kernels.int8_matmul import int8_matmul
from tpu_operator_libs_torch.parallel import (
    TP_SPLIT_DIM,
    any_rank,
    gather_from_tp,
    gather_rows,
    local_rows,
    reduce_from_tp,
    tp_of,
)


def init_kv_cache(config, batch: int, max_seq: int, param_dtype=None,
                  quantize_kv: bool = False, *, device=None, mesh=None):
    """Per-layer K/V buffers (B, max_seq, n_kv_heads, head_dim),
    zero-filled, one fresh buffer per leaf. With a ``mesh``, on its
    device, the rank holds its batch // dp rows and n_kv_heads // tp KV
    heads of them, codes and scales alike.

    With ``quantize_kv=True`` the buffers are int8 with a per-token
    per-kv-head float32 scale (``k_s``/``v_s``, (B, max_seq, n_kv)):
    symmetric per-(token, kv-head) scales make the K dequant a rank-1
    rescale of the score matrix after the int8 contraction and the V
    dequant a rescale of the attention weights before the value
    contraction (see the JAX module for the roofline argument)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    dtype = param_dtype or torch.float32
    if mesh is not None:
        if batch % mesh.dp:
            raise ValueError(f"batch {batch} does not split over "
                             f"dp={mesh.dp}")
        batch //= mesh.dp
    shape = (batch, max_seq, config.n_kv_heads // tp_of(mesh),
             config.head_dim)

    def buf(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    if quantize_kv:
        return [{"k": buf(shape, torch.int8),
                 "k_s": buf(shape[:3], torch.float32),
                 "v": buf(shape, torch.int8),
                 "v_s": buf(shape[:3], torch.float32)}
                for _ in range(config.n_layers)]
    return [{"k": buf(shape, dtype), "v": buf(shape, dtype)}
            for _ in range(config.n_layers)]


def _sym_int8(x, axis, group=None):
    """Symmetric int8 quantization along ``axis``: ``s = max|x| / 127``
    (floored at 1e-8 so all-zero slices don't divide by zero), ``q =
    clip(round(x / s))`` with round-half-to-even, as ``jnp.round``.
    With a ``group``, ``x`` is one shard of a tensor split along ``axis``
    and the max is taken over the whole of it (all-reduce max), so the
    scales are those of the unsplit tensor.
    Returns (int8 codes, float32 scales with ``axis`` removed)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axis)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s.unsqueeze(axis)), -127, 127) \
        .to(torch.int8)
    return q, s


def _quantize_kv_block(x):
    """(B, T, n_kv, head_dim) activations -> (int8 codes, (B, T, n_kv)
    float32 scales), symmetric per-(token, kv-head) over head_dim."""
    return _sym_int8(x, axis=-1)


def quantize_params_int8(params, mesh=None):
    """Weight-only int8 quantization of every matmul weight: each 2-D
    weight becomes ``{"q": int8 (in, out), "s": f32 (out,)}`` with a
    symmetric per-output-channel scale. Norm weights and the embedding
    table (a gather, not a matmul) stay in the original dtype.

    The JAX package quantizes the whole weight. On tp shards (a
    ``mesh``) a column-parallel weight holds whole columns, so its scales
    are the whole weight's for those columns; a row-parallel one (``wo``,
    ``w_down``) holds a block of each column, so its max is all-reduced
    over tp and every rank gets the whole weight's scales."""
    def quant(name, w):
        split_rows = tp_of(mesh) > 1 and TP_SPLIT_DIM[name] == 0
        q, s = _sym_int8(w, axis=0,
                         group=mesh.tp_group if split_rows else None)
        return {"q": q, "s": s}

    out = {"embed": params["embed"],
           "final_norm": params["final_norm"],
           "lm_head": quant("lm_head", params["lm_head"]),
           "layers": []}
    for layer in params["layers"]:
        out["layers"].append({
            "attn_norm": layer["attn_norm"],
            "mlp_norm": layer["mlp_norm"],
            **{k: quant(k, layer[k])
               for k in ("wq", "wk", "wv", "wo",
                         "w_gate", "w_up", "w_down")},
        })
    return out


def _promoted(a, b):
    """Both operands in their promoted dtype: JAX promotes mixed-dtype
    matmuls and einsums (a float32 cache under bfloat16 activations),
    where PyTorch's refuse them."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def _mm(x, w):
    """x @ w for a plain weight or an int8-quantized {"q", "s"} one:
    ``(x @ cast(q)) * s``, exact for a per-output-channel scale, by
    :func:`~tpu_operator_libs_torch.kernels.int8_matmul.int8_matmul` over
    x's leading axes (on the card the codes stay int8 in device memory)."""
    if isinstance(w, dict):
        out = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["q"],
                          w["s"])
        return out.reshape(*x.shape[:-1], out.shape[-1])
    x, w = _promoted(x, w)
    return x @ w


def forward_with_cache(params, tokens, cache, start_pos, config,
                       mesh=None):
    """Logits for ``tokens`` (B, T) occupying absolute positions
    ``start_pos .. start_pos+T-1``, attending to everything already in
    ``cache`` plus themselves. Writes the new keys and values into the
    cache buffers in place and returns (logits (B, T, vocab), cache).
    With a ``mesh``: this rank's rows, shards and cache; the logits are
    whole on every tp rank.

    ``start_pos`` is a Python int or a 0-d int64 tensor on the cache's
    device, as JAX's may be traced: both take the same ops (positions,
    RoPE angles, mask and cache writes from one positions tensor), and
    nothing reads it back to the host, so a captured step can advance it
    in place."""
    if config.attention_impl != "xla":
        raise ValueError(
            "forward_with_cache implements the einsum path; decode "
            "with attention_impl='xla'")

    batch, t_new = tokens.shape
    tp = tp_of(mesh)
    hd = config.head_dim
    nh, nkv = config.n_heads // tp, config.n_kv_heads // tp
    group = nh // nkv
    max_seq = cache[0]["k"].shape[1]
    device = cache[0]["k"].device
    positions = torch.arange(t_new, device=device) + start_pos

    h = params["embed"][tokens.long()]
    # key validity: cached positions < start_pos+T, and causality
    # within the new block
    kv_pos = torch.arange(max_seq, device=device)
    mask = kv_pos[None, :] <= positions[:, None]  # (T, max_seq)

    for layer, entry in zip(params["layers"], cache):
        quant_kv = "k_s" in entry
        a = _rms_norm(h, layer["attn_norm"])
        q = _mm(a, layer["wq"]).reshape(batch, t_new, nh, hd)
        k = _mm(a, layer["wk"]).reshape(batch, t_new, nkv, hd)
        v = _mm(a, layer["wv"]).reshape(batch, t_new, nkv, hd)
        q = _rope(q, config.rope_theta, positions)
        k = _rope(k, config.rope_theta, positions)
        if quant_kv:
            # quantize AFTER RoPE — the cache holds exactly what dense
            # attention would read, coded int8 + per-token scale
            k_q, k_s = _quantize_kv_block(k)
            v_q, v_s = _quantize_kv_block(v)
            new = {"k": k_q, "k_s": k_s, "v": v_q, "v_s": v_s}
        else:
            new = {"k": k.to(entry["k"].dtype), "v": v.to(entry["v"].dtype)}
        # written at the positions tensor along the sequence axis, the
        # counterpart of JAX's dynamic_update_slice at a traced start
        for name, block in new.items():
            entry[name].index_copy_(1, positions, block)

        # grouped einsum over (kv-head, group) — never materializes a
        # group-times-repeated copy of the cache
        q_g = q.reshape(batch, t_new, nkv, group, hd)
        # int8 codes are widened to the compute dtype; a float cache is
        # left as it is and the einsum promotes
        k_op = entry["k"].to(h.dtype) if quant_kv else entry["k"]
        scores = torch.einsum("bqkgd,bskd->bkgqs",
                              *_promoted(q_g, k_op)) * (hd ** -0.5)
        scores = scores.float()
        if quant_kv:
            # K dequant: one rank-1 rescale of the score matrix
            scores = scores \
                * entry["k_s"].permute(0, 2, 1)[:, :, None, None, :]
        scores = scores.masked_fill(~mask, -1e30)
        attn = torch.softmax(scores, dim=-1)
        if quant_kv:
            # V dequant: fold the per-(s, k) scale into the attention
            # weights BEFORE the value einsum (s is the contraction)
            attn = attn \
                * entry["v_s"].permute(0, 2, 1)[:, :, None, None, :]
        attn = attn.to(h.dtype)
        v_op = entry["v"].to(h.dtype) if quant_kv else entry["v"]
        ctx = torch.einsum("bkgqs,bskd->bqkgd", *_promoted(attn, v_op))
        h = h + reduce_from_tp(
            _mm(ctx.reshape(batch, t_new, nh * hd), layer["wo"]), mesh)

        m = _rms_norm(h, layer["mlp_norm"])
        gated = F.silu(_mm(m, layer["w_gate"])) * _mm(m, layer["w_up"])
        h = h + reduce_from_tp(_mm(gated, layer["w_down"]), mesh)

    h = _rms_norm(h, params["final_norm"])
    return gather_from_tp(_mm(h, params["lm_head"]), mesh), cache


def _categorical(logits, generator):
    """One draw per row from softmax(logits) by the Gumbel-max trick,
    with noise from ``generator`` (the same recipe as
    ``jax.random.categorical``, not the same bits)."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _pick_next(logits_last, temperature: float, top_k, generator,
               top_p=None, want_logprob: bool = False):
    """(B, vocab) logits -> ((B, 1) int64 next tokens, logprob or None).

    temperature 0 = greedy argmax (no generator needed). Otherwise
    sample from softmax(logits/temperature), optionally truncated to the
    ``top_k`` highest-logit tokens and then to the ``top_p`` nucleus
    (ties at the nucleus boundary are kept)."""
    if temperature <= 0.0:
        choice = torch.argmax(logits_last, dim=-1)
    else:
        logits_f = logits_last.float()
        if top_k is not None:
            kth = torch.sort(logits_f, dim=-1).values[:, -top_k][:, None]
            logits_f = logits_f.masked_fill(logits_f < kth, float("-inf"))
        if top_p is not None:
            # find the smallest kept probability p* (sorted cumulative
            # mass exclusive of self < top_p), then mask below it
            probs = torch.softmax(logits_f / temperature, dim=-1)
            sp = torch.flip(torch.sort(probs, dim=-1).values, dims=[-1])
            csum = torch.cumsum(sp, dim=-1)
            kept = (csum - sp) < top_p  # first token always kept
            pstar = torch.where(kept, sp, float("inf")) \
                .amin(dim=-1, keepdim=True)
            logits_f = logits_f.masked_fill(probs < pstar, float("-inf"))
        choice = _categorical(logits_f / temperature, generator)
    if not want_logprob:
        return choice[:, None], None
    # logprob of the chosen token under the MODEL's (untempered,
    # untruncated) distribution — what serving APIs report
    lp = torch.log_softmax(logits_last.float(), dim=-1)
    return choice[:, None], torch.gather(lp, -1, choice[:, None])[:, 0]


def _prefill(step, params, prompt, cache, prefill_chunk):
    """Prompt through the cache in one pass, or in ``prefill_chunk``-
    sized blocks. Returns (last block's logits, cache)."""
    prompt_len = prompt.shape[1]
    _check_prefill_chunk(prefill_chunk)
    if prefill_chunk is None or prompt_len <= prefill_chunk:
        return step(params, prompt, cache, 0)
    logits = None
    for off in range(0, prompt_len, prefill_chunk):
        block = prompt[:, off:off + prefill_chunk]
        logits, cache = step(params, block, cache, off)
    return logits, cache


def _check_prefill_chunk(prefill_chunk):
    """Both generate paths must agree on what a valid chunk is — an
    int >= 1."""
    if prefill_chunk is None:
        return
    if (not isinstance(prefill_chunk, int)
            or isinstance(prefill_chunk, bool) or prefill_chunk < 1):
        raise ValueError(
            f"prefill_chunk must be an int >= 1, got {prefill_chunk!r}")


def _check_sampling_args(temperature, generator, top_p):
    """Shared sampling-argument validation for both generate paths."""
    if temperature > 0.0 and generator is None:
        raise ValueError(
            "sampling (temperature > 0) requires a torch.Generator")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _start(params, prompt, config, max_new_tokens, param_dtype,
           temperature, generator, quantize_kv, top_p, mesh):
    """Shared set-up of both generate paths: checks, the prompt's rows
    of this rank on the parameters' device, and a fresh cache for
    prompt + new tokens."""
    _check_sampling_args(temperature, generator, top_p)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, device=device).long()
    batch, prompt_len = prompt.shape
    cache = init_kv_cache(config, batch, prompt_len + max_new_tokens,
                          param_dtype, quantize_kv=quantize_kv,
                          device=device, mesh=mesh)
    return local_rows(prompt, mesh), cache


def generate(params, prompt, config, max_new_tokens: int,
             param_dtype=None, temperature: float = 0.0, top_k=None,
             generator=None, quantize_kv: bool = False, top_p=None,
             eos_id=None, return_logprobs: bool = False,
             prefill_chunk=None, mesh=None):
    """Autoregressive decode driven from the host: prefill the prompt,
    then one cached step per token. ``temperature=0`` (default) is
    greedy; otherwise softmax sampling, optionally top-k and/or top-p
    truncated, with noise from ``generator``. ``eos_id``: once a row
    emits it, every later position in that row is ``eos_id``, and once
    every row has, the loop stops stepping. Returns (B,
    prompt+max_new_tokens) int64 on the parameters' device; with
    ``return_logprobs=True``, a (tokens, logprobs (B, max_new_tokens)
    float32) pair, eos-padded positions carrying 0.0. ``mesh``: see the
    module's docstring; the loop stops early only once every dp replica's
    rows are done."""
    prompt, cache = _start(params, prompt, config, max_new_tokens,
                           param_dtype, temperature, generator,
                           quantize_kv, top_p, mesh)
    batch, prompt_len = prompt.shape

    def step(p, t, c, pos):
        return forward_with_cache(p, t, c, pos, config, mesh)

    def pick(logits):
        return _pick_next(logits[:, -1, :], temperature, top_k, generator,
                          top_p, return_logprobs)

    logits, cache = _prefill(step, params, prompt, cache, prefill_chunk)
    tokens = [prompt]
    lps = []
    last, lp = pick(logits)
    done = torch.zeros((batch,), dtype=torch.bool, device=prompt.device)
    for i in range(max_new_tokens):
        if eos_id is not None:
            last = torch.where(done[:, None], eos_id, last)
            if return_logprobs:
                lp = torch.where(done, 0.0, lp)
            done = done | (last[:, 0] == eos_id)
        tokens.append(last)
        lps.append(lp)
        if i + 1 == max_new_tokens:
            break
        if eos_id is not None and not any_rank(not bool(done.all()), mesh):
            # every row has emitted eos: the remaining positions are
            # padding, so the host loop stops dispatching steps
            pad = max_new_tokens - (i + 1)
            tokens.append(torch.full((batch, pad), eos_id,
                                     dtype=last.dtype, device=last.device))
            if return_logprobs:
                lps.extend(torch.zeros((batch,), dtype=torch.float32,
                                       device=last.device)
                           for _ in range(pad))
            break
        logits, cache = step(params, last, cache, prompt_len + i)
        last, lp = pick(logits)
    out = gather_rows(torch.cat(tokens, dim=1), mesh)
    if return_logprobs:
        return out, gather_rows(torch.stack(lps, dim=1), mesh)
    return out


@dataclasses.dataclass
class _DecodeState:
    """The preallocated device tensors one decode step reads and writes:
    the token it feeds, that token's absolute position, the rows that
    have emitted eos, the output and logprob buffers, and the cache."""

    last: torch.Tensor  # (B, 1) int64
    pos: torch.Tensor  # 0-d int64
    done: "torch.Tensor | None"  # (B,) bool, with an eos_id
    out: torch.Tensor  # (B, prompt_len + max_new_tokens) int64
    logprobs: "torch.Tensor | None"  # (B, max_new_tokens) float32
    cache: list


def _decode_step(state, params, config, mesh, pick, eos_id, prompt_len):
    """One cached step, all on the device: the next token (eos-masked as
    in :func:`generate`) goes into ``out`` at ``pos + 1`` and into
    ``last``, its logprob into ``logprobs``, and ``pos`` advances in
    place as the last op. The same ops whether run eagerly or replayed
    from a graph."""
    logits, _ = forward_with_cache(params, state.last, state.cache,
                                   state.pos, config, mesh)
    nxt, lp = pick(logits)
    if eos_id is not None:
        # a finished row keeps emitting eos_id; its step still ran
        nxt = torch.where(state.done[:, None], eos_id, nxt)
        if lp is not None:
            lp = torch.where(state.done, 0.0, lp)
        state.done |= nxt[:, 0] == eos_id
    column = (state.pos + 1).reshape(1)
    state.out.index_copy_(1, column, nxt)
    if lp is not None:
        state.logprobs.index_copy_(1, column - prompt_len, lp[:, None])
    state.last.copy_(nxt)
    state.pos += 1


def _replay_steps(step, steps: int, generator, device) -> dict:
    """``steps`` calls of ``step`` on the card: the first runs eagerly on
    the capture's stream, as the warm-up that torch's capture recipe asks
    for (a real step: it writes the cache and draws from the generator
    like any other); then ``step`` is captured once into a CUDA graph,
    which only records and runs nothing, and the graph is replayed once
    for each step left. ``generator`` (sampling) is registered with the
    graph, so every replay draws at the next offsets of the caller's
    generator, as the eager steps would. Capture is thread-local: other
    threads' work on the card does not break it. Returns once the
    replays have run: the graph and its memory pool die with the call."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.stream(side):
        step()
        captured = {name: w.launches for name, w in WRAPPERS.items()}
        start = time.perf_counter()
        # not torch.cuda.graph: it would also synchronise the card and
        # empty the allocator's cache before every capture (0.5 s after
        # the allocations of a kernel benchmark, on the H100)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            step()
        finally:
            graph.capture_end()
        capture_ms = (time.perf_counter() - start) * 1e3
    main.wait_stream(side)
    with torch.cuda.stream(main):
        for _ in range(steps - 1):
            graph.replay()
    main.synchronize()
    # the wrappers ran once, at capture: their counts stand for the first
    # replay, and each further replay launches the same kernels again
    for name, wrapper in WRAPPERS.items():
        wrapper.launches += (wrapper.launches - captured[name]) * (steps - 2)
    return {"eager_steps": 1, "graph_launches": steps - 1,
            "capture_ms": capture_ms}


def generate_on_device(params, prompt, config, max_new_tokens: int,
                       param_dtype=None, temperature: float = 0.0,
                       top_k=None, generator=None,
                       quantize_kv: bool = False, top_p=None,
                       eos_id=None, return_logprobs: bool = False,
                       prefill_chunk=None, mesh=None):
    """:func:`generate` with the whole token loop left on the device.

    The counterpart of the JAX package's single dispatch with a donated
    cache: no step reads anything back to the host (no ``.item()`` or
    ``bool(...)``; eos is handled with ``torch.where`` and every step
    runs), each step writes preallocated device buffers (the position
    among them), and the caller reads the tokens back once. Same
    contract and return value as :func:`generate`; greedy output is
    token-equal to it, and so is sampled output drawn from an equally
    seeded generator.

    On the card without a ``mesh``, prefill, the first pick and one
    decode step run eagerly and the remaining steps replay one captured
    CUDA graph, one launch a token (:func:`_replay_steps`); on the CPU
    and with a ``mesh`` (capture over NCCL is not done) the same step
    runs in a Python loop, and with a ``mesh`` the rows are gathered once,
    after it. ``generate_on_device.last_call`` records the eager steps,
    graph launches and capture milliseconds of the latest call."""
    prompt, cache = _start(params, prompt, config, max_new_tokens,
                           param_dtype, temperature, generator,
                           quantize_kv, top_p, mesh)
    batch, prompt_len = prompt.shape
    device = prompt.device
    _check_prefill_chunk(prefill_chunk)
    if prefill_chunk is not None and prefill_chunk >= prompt_len:
        prefill_chunk = None

    def pick(logits):
        return _pick_next(logits[:, -1, :], temperature, top_k, generator,
                          top_p, return_logprobs)

    out = torch.empty((batch, prompt_len + max_new_tokens),
                      dtype=torch.long, device=device)
    out[:, :prompt_len] = prompt
    logprobs = (torch.empty((batch, max_new_tokens), dtype=torch.float32,
                            device=device)
                if return_logprobs else None)

    logits, cache = _prefill(
        lambda p, t, c, pos: forward_with_cache(p, t, c, pos, config, mesh),
        params, prompt, cache, prefill_chunk)
    last, lp = pick(logits)
    out[:, prompt_len] = last[:, 0]
    if return_logprobs:
        logprobs[:, 0] = lp
    done = last[:, 0] == eos_id if eos_id is not None else None
    state = _DecodeState(
        last=last, done=done, out=out, logprobs=logprobs,
        pos=torch.tensor(prompt_len, dtype=torch.long, device=device),
        cache=cache)

    def step():
        _decode_step(state, params, config, mesh, pick, eos_id, prompt_len)

    steps = max_new_tokens - 1
    if device.type == "cuda" and mesh is None and steps > 1:
        run = _replay_steps(step, steps,
                            generator if temperature > 0.0 else None, device)
    else:
        for _ in range(steps):
            step()
        run = {"eager_steps": steps, "graph_launches": 0, "capture_ms": 0.0}
    generate_on_device.last_call = run
    out = gather_rows(out, mesh)
    if return_logprobs:
        return out, gather_rows(logprobs, mesh)
    return out


#: what the latest call ran: eager steps, graph launches, capture ms
generate_on_device.last_call = {}
