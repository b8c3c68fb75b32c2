"""Operations and bytes of the port's work, computed from shapes alone,
and the least time the chip could take for them.

The bound helpers are copies of ``chip_smoke.py``'s (``PEAK_FLOPS``,
``PEAK_BYTES``, ``visible_pairs``, ``attention_bound_ms``,
``int8_bound_ms``, ``decode_attention_bound_ms``), kept here so that a
change to the program cannot move the yardstick. Each counts every input
byte read once and every output byte written once, whatever a kernel
reads again, and the FLOPs the mathematics needs, whatever a kernel
recomputes: the same count for any kernel that does the same work.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at 700 W.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16, F32, INT8 = 2, 4, 1


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS
            ) -> float:
    """The least seconds: the larger of the FLOPs over the peak and the
    bytes over the memory rate."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def visible_pairs(sq: int, sk: int, causal: bool = True, start: int = 0
                  ) -> int:
    """(query, key) pairs a causal mask leaves visible: query t (at
    absolute position start + t) sees keys 0 .. start + t."""
    if not causal:
        return sq * sk
    return sum(min(start + t + 1, sk) for t in range(sq))


def attention_pairs_causal(seq: int) -> int:
    return seq * (seq + 1) // 2


def matmul_params(c) -> int:
    """Weights that a token's forward multiplies (every layer's
    projections and the head; the embedding is a gather)."""
    d, hd = c.d_model, c.head_dim
    per_layer = (d * c.n_heads * hd + 2 * d * c.n_kv_heads * hd
                 + c.n_heads * hd * d + 3 * d * c.d_ff)
    return c.n_layers * per_layer + d * c.vocab


def layer_matmuls(c) -> "list[tuple[int, int]]":
    """(K, N) of each projection of one layer, in the order the forward
    runs them."""
    d, hd = c.d_model, c.head_dim
    return [(d, c.n_heads * hd), (d, c.n_kv_heads * hd),
            (d, c.n_kv_heads * hd), (c.n_heads * hd, d), (d, c.d_ff),
            (d, c.d_ff), (c.d_ff, d)]


# -- training ---------------------------------------------------------------

def train_step_flops(c, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x matmul parameters x tokens,
    and causal attention's two forward products (QK^T, PV) three times
    over (forward, and the backward's four products dV, dP, dQ, dK)."""
    tokens = batch * seq
    attn_fwd = (4 * batch * c.n_heads * c.head_dim
                * attention_pairs_causal(seq) * c.n_layers)
    return 6.0 * matmul_params(c) * tokens + 3.0 * attn_fwd


def flash_train_bound_s(c, batch: int, seq: int) -> float:
    """Least seconds of one step's flash attention, every layer: the
    forward (QK^T, PV over the visible pairs; Q, K, V read, O and the
    lse written) and the backward (five products: S again, dV, dP, dQ,
    dK; Q, K, V, dO, the lse and di read, dQ, dK, dV written), each
    against its own bytes, in bf16."""
    h, kv, dim = c.n_heads, c.n_kv_heads, c.head_dim
    pairs = attention_pairs_causal(seq)
    q_elems = batch * h * seq * dim
    kv_elems = batch * kv * seq * dim
    rows = batch * h * seq
    fwd = bound_s(4 * batch * h * dim * pairs,
                  BF16 * (2 * q_elems + 2 * kv_elems) + F32 * rows)
    bwd = bound_s(10 * batch * h * dim * pairs,
                  BF16 * (2 * q_elems + 2 * kv_elems)  # Q, dO; K, V
                  + BF16 * (q_elems + 2 * kv_elems)  # dQ; dK, dV
                  + 2 * F32 * rows)  # lse, di
    return c.n_layers * (fwd + bwd)


# -- serving ----------------------------------------------------------------

def int8_bound_s(m: int, k: int, n: int) -> float:
    """One int8-weight matmul with bf16 activations: the codes, x, the
    output and the scales moved once, against 2*M*K*N FLOPs."""
    return bound_s(2 * m * k * n,
                   k * n * INT8 + BF16 * (m * k + m * n) + F32 * n)


def decode_attention_bound_s(c, batch: int, t_new: int, start: int,
                             cache_len: int) -> float:
    """One cached attention call over an int8 cache: the keys and values
    (and their f32 scales) that the output depends on, positions 0 ..
    start + t_new - 1, read once, q read and the output written once,
    against 4*D FLOPs a visible (query, key) pair and head."""
    keys = min(cache_len, start + t_new)
    pairs = visible_pairs(t_new, cache_len, start=start)
    kvh, dim = c.n_kv_heads, c.head_dim
    nbytes = (2 * batch * keys * kvh * dim * INT8
              + 2 * batch * keys * kvh * F32
              + batch * t_new * c.n_heads * dim * (BF16 + BF16))
    return bound_s(4 * batch * c.n_heads * pairs * dim, nbytes)


def forward_calls(c, batch: int, prompt: int, new_tokens: int):
    """(t_new, start) of each ``forward_with_cache`` call of one
    generation: the prefill at 0, then one step at each position
    prompt .. prompt + new_tokens - 2 (the first token comes from the
    prefill's logits)."""
    return [(prompt, 0)] + [(1, prompt + i) for i in range(new_tokens - 1)]


def request_int8_bound_s(c, batch: int, prompt: int, new_tokens: int
                         ) -> float:
    """Summed bound of the int8 matmuls one generation needs: each
    layer's seven projections at M = batch x t_new, and the head at M =
    batch, the picked position of each call (as ``request_least_s``
    counts it: a head over every prompt position is work the program
    does and the mathematics does not need)."""
    total = 0.0
    for t_new, _ in forward_calls(c, batch, prompt, new_tokens):
        total += c.n_layers * sum(int8_bound_s(batch * t_new, k, n)
                                  for k, n in layer_matmuls(c))
        total += int8_bound_s(batch, c.d_model, c.vocab)
    return total


def request_attention_bound_s(c, batch: int, prompt: int, new_tokens: int
                              ) -> float:
    """Summed bound of every cached attention call of one generation."""
    cache_len = prompt + new_tokens
    return c.n_layers * sum(
        decode_attention_bound_s(c, batch, t_new, start, cache_len)
        for t_new, start in forward_calls(c, batch, prompt, new_tokens))


def weight_bytes_int8(c) -> int:
    """Codes and per-channel f32 scales of every projection and the
    head."""
    total = 0
    for k, n in layer_matmuls(c):
        total += c.n_layers * (k * n * INT8 + F32 * n)
    return total + c.d_model * c.vocab * INT8 + F32 * c.vocab


def request_least_s(c, batch: int, prompt: int, new_tokens: int) -> float:
    """The least seconds of the work one generation needs, call by call:
    each call's max(FLOPs / peak, bytes / rate), where the FLOPs are the
    projections over every new token (the head only where a token is
    picked: the prefill's last position) and the attention's visible
    pairs, and the bytes the int8 weights and scales, the cache read and
    the cache written, once a call."""
    d, kvh, dim = c.d_model, c.n_kv_heads, c.head_dim
    layer_params = sum(k * n for k, n in layer_matmuls(c))
    head = d * c.vocab
    weights = weight_bytes_int8(c)
    total = 0.0
    for t_new, start in forward_calls(c, batch, prompt, new_tokens):
        pairs = visible_pairs(t_new, prompt + new_tokens, start=start)
        flops = (2 * batch * t_new * c.n_layers * layer_params
                 + 2 * batch * head
                 + 4 * batch * c.n_heads * dim * pairs * c.n_layers)
        read = 2 * batch * start * kvh * (dim * INT8 + F32) * c.n_layers
        written = 2 * batch * t_new * kvh * (dim * INT8 + F32) * c.n_layers
        total += bound_s(flops, weights + read + written)
    return total
