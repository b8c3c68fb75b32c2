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
tokens. Six hand-written kernels do what XLA fuses on the TPU (none
has a Pallas source): the int8-weight matmul (``kernels/int8_matmul.py``)
reads the codes as int8; the cache write (``kernels/kv_append.py``'s
``rope_kv_append``) rotates the step's queries and keys and quantizes
and writes the new keys and values at the step's position; the cached
attention (``kernels/decode_attention.py``) reads the float or int8
cache in place and folds its scales; the norm (``kernels/rms_norm.py``)
takes every residual add with it, the gate (``kernels/swiglu.py``) is
one launch, and so is the token pick (``kernels/token_pick.py``: greedy,
or top-k, top-p and the draw, and the logprob). On the CPU each runs its
plain PyTorch version.

On the card, :func:`generate_on_device` replays one decode step from a
captured CUDA graph where JAX runs a ``lax.scan``: the step reads and
writes only preallocated device tensors, its position among them. With a
mesh the graph holds the step's tp collectives too, on every NCCL rank.
A server keeps its graphs (:class:`DecodeGraphs`): a request replays the
one its prompt shape captured first.

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

import torch
import torch.distributed as dist

from tpu_operator_libs_torch import resolve_device, tracing
from tpu_operator_libs_torch.kernels import WRAPPERS, save_launches
from tpu_operator_libs_torch.kernels.decode_attention import (
    _promoted,
    decode_attention,
)
from tpu_operator_libs_torch.kernels.int8_matmul import int8_matmul
from tpu_operator_libs_torch.kernels.kv_append import (  # noqa: F401
    _quantize_kv_block,  # the int8 recipe, under the reference's names
    _sym_int8,
    rope_kv_append,
)
from tpu_operator_libs_torch.kernels.rms_norm import add_rms_norm
from tpu_operator_libs_torch.kernels.swiglu import swiglu
from tpu_operator_libs_torch.kernels.token_pick import pick
from tpu_operator_libs_torch.parallel import (
    TP_COLLECTIVES,
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
    device, as JAX's may be traced: both take the same ops (RoPE, the
    cache write and the attention's mask from the position where it
    lies), and nothing reads it back to the host, so a captured step can
    advance it in place."""
    if config.attention_impl != "xla":
        raise ValueError(
            "forward_with_cache implements the einsum path; decode "
            "with attention_impl='xla'")

    batch, t_new = tokens.shape
    tp = tp_of(mesh)
    hd = config.head_dim
    nh, nkv = config.n_heads // tp, config.n_kv_heads // tp

    h = params["embed"][tokens.long()]
    # each residual add goes into the next norm: the layer's attention add
    # into its MLP norm, its MLP add into the next layer's attention norm
    # or the final norm; the first norm, on the embedding, has none
    delta = None
    for layer, entry in zip(params["layers"], cache):
        h, a = add_rms_norm(h, delta, layer["attn_norm"])
        q = _mm(a, layer["wq"]).reshape(batch, t_new, nh, hd)
        k = _mm(a, layer["wk"]).reshape(batch, t_new, nkv, hd)
        v = _mm(a, layer["wv"]).reshape(batch, t_new, nkv, hd)
        # RoPE of q and k and the new keys and values into the cache
        # (quantized after RoPE for an int8 one), one launch on the card;
        # then the queries against the whole cache
        q = rope_kv_append(entry, q, k, v, start_pos, config.rope_theta)
        ctx = decode_attention(q, entry, start_pos)
        h, m = add_rms_norm(h, reduce_from_tp(
            _mm(ctx.reshape(batch, t_new, nh * hd), layer["wo"]), mesh),
            layer["mlp_norm"])
        gated = swiglu(_mm(m, layer["w_gate"]), _mm(m, layer["w_up"]))
        delta = reduce_from_tp(_mm(gated, layer["w_down"]), mesh)

    _, h = add_rms_norm(h, delta, params["final_norm"])
    return gather_from_tp(_mm(h, params["lm_head"]), mesh), cache


def _pick_next(logits_last, temperature: float, top_k, generator,
               top_p=None, want_logprob: bool = False):
    """(B, vocab) logits -> ((B, 1) int64 next tokens, logprob or None).

    temperature 0 = greedy argmax (no generator needed). Otherwise
    sample from softmax(logits/temperature), optionally truncated to the
    ``top_k`` highest-logit tokens and then to the ``top_p`` nucleus
    (ties at the nucleus boundary are kept), by the Gumbel-max trick on
    (B, vocab) uniforms drawn from ``generator`` (the recipe of
    ``jax.random.categorical``, not its bits). One
    :func:`~tpu_operator_libs_torch.kernels.token_pick.pick`: a kernel
    launch on the card (behind the one ``torch.rand`` of a sampled pick),
    its plain version on the CPU."""
    u = None
    if temperature > 0.0:
        u = torch.rand(logits_last.shape, generator=generator,
                       dtype=torch.float32, device=logits_last.device)
    choice, lp = pick(logits_last, u, temperature, top_k, top_p,
                      want_logprob)
    return choice[:, None], lp


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


def _start(params, prompt, max_new_tokens, temperature, generator,
           top_p, mesh):
    """Shared set-up of both generate paths: checks, and the prompt's
    rows of this rank on the parameters' device."""
    _check_sampling_args(temperature, generator, top_p)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    prompt = torch.as_tensor(prompt, device=params["embed"].device).long()
    return local_rows(prompt, mesh)


def _new_cache(config, batch, max_seq, param_dtype, quantize_kv, device,
               mesh):
    """A fresh cache for this rank's ``batch`` rows (:func:`init_kv_cache`
    of the global batch)."""
    with tracing.span("decode.cache_alloc"):
        return init_kv_cache(config, batch * (mesh.dp if mesh else 1),
                             max_seq, param_dtype, quantize_kv=quantize_kv,
                             device=device, mesh=mesh)


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
    prompt = _start(params, prompt, max_new_tokens, temperature,
                    generator, top_p, mesh)
    batch, prompt_len = prompt.shape
    cache = _new_cache(config, batch, prompt_len + max_new_tokens,
                       param_dtype, quantize_kv, prompt.device, mesh)

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


def _captures(device, mesh) -> bool:
    """Whether :func:`generate_on_device` replays its step from a captured
    CUDA graph: on the card, with or without a ``mesh``. On the CPU the
    same step runs in a Python loop, the path its caller asked for. A
    mesh on the card must talk over NCCL, whose collectives a graph
    captures; any other backend raises rather than loop on the card."""
    if device.type != "cuda":
        return False
    if mesh is not None:
        backend = dist.get_backend(mesh.tp_group)
        if backend != "nccl":
            raise ValueError(f"a mesh on {device} decodes over NCCL, not "
                             f"{backend}: its collectives are captured in "
                             "the decode step's CUDA graph")
    return True


def _counts():
    """The kernel wrappers' launches (in all and by design) and the tp
    collectives' calls and bytes so far."""
    return (*save_launches(), (TP_COLLECTIVES.calls, TP_COLLECTIVES.bytes))


def _since(before):
    """What the wrappers and the tp reduce and gather points launched
    since ``before`` (:func:`_counts`), in its form."""
    launches, by_design, (calls, nbytes) = before
    now, now_by, (now_calls, now_bytes) = _counts()
    return ({name: now[name] - launches[name] for name in launches},
            {name: {design: count - by_design[name].get(design, 0)
                    for design, count in now_by[name].items()}
             for name in by_design},
            (now_calls - calls, now_bytes - nbytes))


def _carry(per_replay, replays: int) -> None:
    """Counts ``replays`` more replays of a graph one replay of which
    launches ``per_replay`` (:func:`_since` of its capture): its kernels
    and collectives pass no wrapper and no reduce point."""
    launches, by_design, (calls, nbytes) = per_replay
    for name, count in launches.items():
        WRAPPERS[name].launches += count * replays
    for name, by in by_design.items():
        counts = WRAPPERS[name].launches_by_design
        for design, count in by.items():
            counts[design] = counts.get(design, 0) + count * replays
    TP_COLLECTIVES.calls += calls * replays
    TP_COLLECTIVES.bytes += nbytes * replays


def _capture(step, generator, device, mesh):
    """The first steps of a replayed decode on the card: ``step`` runs
    eagerly on the capture's stream, as the warm-up that torch's capture
    recipe asks for (a real step: it writes the cache and draws from the
    generator like any other); then it is captured into a CUDA graph,
    which only records and runs nothing. ``generator`` (sampling) is
    registered with the graph, so every replay draws at its next offsets,
    as the eager steps would. Capture is thread-local: other threads'
    work on the card does not break it. Returns (graph, what one replay
    launches (:func:`_since`), the capture's milliseconds).

    With a ``mesh`` every rank makes the same calls. Its tp collectives
    are NCCL kernels on the process group's stream, joined to the
    capture's stream by events, so the graph holds them. Their
    communicators exist before the capture: NCCL creates one at its
    group's first collective, which prefill and the warm-up step make.
    The process group's watchdog thread queries its collectives' events;
    a thread-local capture leaves other threads' calls alone. The ranks
    agree that every capture succeeded before any replays, and then each
    replays the same count in the same order, so every replayed
    collective meets its peers; a rank whose capture failed raises, and
    so do the others."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.stream(side):
        with tracing.span("decode.eager_step"):
            step()
        before = _counts()
        with tracing.span("decode.capture") as capture:
            try:
                # not torch.cuda.graph: it would also synchronise the card
                # and empty the allocator's cache before every capture
                # (0.5 s after the allocations of a kernel benchmark, on
                # the H100)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    graph.capture_end()
            except Exception:
                any_rank(True, mesh)  # the peers must not replay alone
                raise
        per_replay = _since(before)
    if any_rank(False, mesh):
        raise RuntimeError("a peer rank failed to capture its decode step")
    main.wait_stream(side)
    return graph, per_replay, (capture.end - capture.start) / 1e6


def _replay(graph, replays: int, device) -> None:
    """``replays`` launches of ``graph`` on the current stream, and the
    wait for them."""
    with tracing.span("decode.replay"):
        for _ in range(replays):
            graph.replay()
    with tracing.span("decode.wait"):
        torch.cuda.current_stream(device).synchronize()


def _replay_steps(step, steps: int, generator, device, mesh=None) -> dict:
    """``steps`` calls of ``step`` on the card: the eager step and the
    capture of :func:`_capture`, then the graph replayed once for each
    step left; returns once the replays have run and the graph and its
    memory pool are freed."""
    graph, per_replay, capture_ms = _capture(step, generator, device, mesh)
    _replay(graph, steps - 1, device)
    with tracing.span("decode.release"):
        del graph
    # the wrappers ran once, at capture: their counts stand for the first
    # replay, and each further replay launches the same kernels again
    _carry(per_replay, steps - 2)
    return {"eager_steps": 1, "graph_launches": steps - 1,
            "capture_ms": capture_ms}


@dataclasses.dataclass
class _Kept:
    """A decode step that :class:`DecodeGraphs` keeps: its graph, the
    state the graph reads and writes, the generator it draws from (None
    for greedy picks), what one replay launches (:func:`_since`) and the
    parameters it reads."""

    graph: "torch.cuda.CUDAGraph"
    state: _DecodeState
    generator: "torch.Generator | None"
    per_replay: tuple
    params: dict


class DecodeGraphs:
    """The decode steps that :func:`generate_on_device` captured, kept for
    the later calls of the same shape: what a server that keeps its
    parameters passes as ``graphs``, so that a request after the first of
    its prompt length runs no eager step and no capture, only the prefill,
    the first pick and one replay a token.

    A kept step is one for each set of the call's shapes and sampling
    settings, with the buffers its graph reads and writes: the cache (a
    later prompt's prefill writes its own positions over it, and every
    query masks the positions past its own), the position, the tokens and
    the last token. Its generator takes the caller's state before the
    first pick and gives it back after the last replay, so a call draws
    what it would draw with a graph of its own. At most ``limit`` steps
    are kept, the least recently used dropped first; :meth:`clear` frees
    every graph and its memory pool. Every rank of a mesh keeps its own,
    and since the ranks make the same calls, their graphs agree."""

    def __init__(self, limit: int = 8):
        self.limit = limit
        self._kept: "dict[tuple, _Kept]" = {}

    def __len__(self) -> int:
        return len(self._kept)

    def clear(self) -> None:
        self._kept.clear()

    def _get(self, key, params) -> "_Kept | None":
        kept = self._kept.pop(key, None)
        if kept is None or kept.params is not params:
            return None
        self._kept[key] = kept  # the most recently used last
        return kept

    def _keep(self, key, kept: _Kept) -> None:
        self._kept[key] = kept
        while len(self._kept) > self.limit:
            del self._kept[next(iter(self._kept))]


def generate_on_device(params, prompt, config, max_new_tokens: int,
                       param_dtype=None, temperature: float = 0.0,
                       top_k=None, generator=None,
                       quantize_kv: bool = False, top_p=None,
                       eos_id=None, return_logprobs: bool = False,
                       prefill_chunk=None, mesh=None,
                       graphs: "DecodeGraphs | None" = None):
    """:func:`generate` with the whole token loop left on the device.

    The counterpart of the JAX package's single dispatch with a donated
    cache: no step reads anything back to the host (no ``.item()`` or
    ``bool(...)``; eos is handled with ``torch.where`` and every step
    runs), each step writes preallocated device buffers (the position
    among them), and the caller reads the tokens back once. Same
    contract and return value as :func:`generate`; greedy output is
    token-equal to it, and so is sampled output drawn from an equally
    seeded generator.

    On the card, with or without a ``mesh``, prefill, the first pick and
    one decode step run eagerly and the remaining steps replay one
    captured CUDA graph, one launch a token (:func:`_capture`); with a
    ``mesh`` the graph holds the step's NCCL collectives on every rank
    (a mesh over another backend raises, :func:`_captures`). With
    ``graphs`` (:class:`DecodeGraphs`) the graph is kept, and a later
    call of the same shape replays it for every step after the first
    pick. On the CPU the same step runs in a Python loop. With a
    ``mesh`` the rows are gathered once, after the loop.
    ``generate_on_device.last_call`` records this rank's eager steps,
    graph launches and capture milliseconds of the latest call, and the
    tp collectives its forward calls launched
    (``parallel.TP_COLLECTIVES``: prefill and every step, replays
    included) with their bytes."""
    with tracing.span("decode.generate"):
        collectives = (TP_COLLECTIVES.calls, TP_COLLECTIVES.bytes)
        capture = _captures(params["embed"].device, mesh)
        prompt = _start(params, prompt, max_new_tokens, temperature,
                        generator, top_p, mesh)
        batch, prompt_len = prompt.shape
        device = prompt.device
        _check_prefill_chunk(prefill_chunk)
        if prefill_chunk is not None and prefill_chunk >= prompt_len:
            prefill_chunk = None
        steps = max_new_tokens - 1
        keep = graphs is not None and capture and steps > 1
        key = (id(params), batch, prompt_len, max_new_tokens, param_dtype,
               temperature, top_k, top_p, quantize_kv, eos_id,
               return_logprobs)
        kept = graphs._get(key, params) if keep else None
        draws = generator if temperature > 0.0 else None
        if keep and draws is not None:
            # the kept graph draws from its own generator, at the
            # caller's offsets
            draws = (kept.generator if kept is not None
                     else torch.Generator(device=device))
            draws.set_state(generator.get_state())

        def pick(logits):
            return _pick_next(logits[:, -1, :], temperature, top_k, draws,
                              top_p, return_logprobs)

        if kept is None:
            cache = _new_cache(config, batch, prompt_len + max_new_tokens,
                               param_dtype, quantize_kv, device, mesh)
            out = torch.empty((batch, prompt_len + max_new_tokens),
                              dtype=torch.long, device=device)
            logprobs = (torch.empty((batch, max_new_tokens),
                                    dtype=torch.float32, device=device)
                        if return_logprobs else None)
        else:
            state = kept.state
            cache, out, logprobs = state.cache, state.out, state.logprobs
        out[:, :prompt_len] = prompt

        with tracing.span("decode.prefill"):
            logits, cache = _prefill(
                lambda p, t, c, pos: forward_with_cache(p, t, c, pos, config,
                                                        mesh),
                params, prompt, cache, prefill_chunk)
        with tracing.span("decode.first_pick"):
            last, lp = pick(logits)
            out[:, prompt_len] = last[:, 0]
            if return_logprobs:
                logprobs[:, 0] = lp
            done = last[:, 0] == eos_id if eos_id is not None else None
            if kept is None:
                state = _DecodeState(
                    last=last, done=done, out=out, logprobs=logprobs,
                    pos=torch.tensor(prompt_len, dtype=torch.long,
                                     device=device),
                    cache=cache)
            else:
                state.last.copy_(last)
                state.pos.fill_(prompt_len)
                if done is not None:
                    state.done.copy_(done)

        def step():
            _decode_step(state, params, config, mesh, pick, eos_id,
                         prompt_len)

        if kept is not None:
            _replay(kept.graph, steps, device)
            _carry(kept.per_replay, steps)
            run = {"eager_steps": 0, "graph_launches": steps,
                   "capture_ms": 0.0}
        elif keep:
            graph, per_replay, capture_ms = _capture(step, draws, device,
                                                     mesh)
            _replay(graph, steps - 1, device)
            # the wrappers ran once, at capture: their counts stand for
            # the first replay
            _carry(per_replay, steps - 2)
            graphs._keep(key, _Kept(graph, state, draws, per_replay, params))
            run = {"eager_steps": 1, "graph_launches": steps - 1,
                   "capture_ms": capture_ms}
        elif capture and steps > 1:
            run = _replay_steps(step, steps, draws, device, mesh)
        else:
            with tracing.span("decode.steps"):
                for _ in range(steps):
                    step()
            run = {"eager_steps": steps, "graph_launches": 0,
                   "capture_ms": 0.0}
        if keep and draws is not None:
            generator.set_state(draws.get_state())
        run["collectives"] = TP_COLLECTIVES.calls - collectives[0]
        run["collective_bytes"] = TP_COLLECTIVES.bytes - collectives[1]
        generate_on_device.last_call = run
        if keep:
            # the kept buffers are the next call's
            out = out.clone()
            logprobs = logprobs.clone() if return_logprobs else None
        out = gather_rows(out, mesh)
        if return_logprobs:
            return out, gather_rows(logprobs, mesh)
        return out


#: what this rank's latest call ran: eager steps, graph launches, capture
#: ms, tp collectives and their bytes
generate_on_device.last_call = {}
