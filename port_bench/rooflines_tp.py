"""Operations and bytes of one tensor-parallel rank's bf16 products,
computed from shapes alone, and the least time the card could take for
them.

A rank of a Megatron split at tp holds, of every layer, n_heads / tp
query heads and n_kv_heads / tp KV heads (its columns of ``wq``, ``wk``,
``wv`` and its rows of ``wo``), d_ff / tp columns of the gate and up
projections and rows of the down projection, and vocab / tp columns of
the head (``tpu_operator_libs_torch/parallel.py``'s ``TP_SPLIT_DIM``).
A product reads its weight block and its input once and writes its
output once, in bf16, against 2*M*K*N FLOPs; a forward call's bound is
the larger of its products' summed FLOPs over the bf16 peak and their
summed bytes over the memory rate (``rooflines.bound_s``). The head
counts the picked position of each row alone, as ``rooflines`` counts
it: a head over every prompt position is work the program does and the
mathematics does not need.
"""

from __future__ import annotations

from port_bench import rooflines

BF16 = rooflines.BF16


def shard_matmuls(c, tp: int) -> "list[tuple[int, int]]":
    """(K, N) of each product of one layer on one rank, in the order the
    forward runs them: q, k, v, o, gate, up, down."""
    d, hd = c.d_model, c.head_dim
    q, kv, ff = c.n_heads * hd // tp, c.n_kv_heads * hd // tp, c.d_ff // tp
    return [(d, q), (d, kv), (d, kv), (q, d), (d, ff), (d, ff), (ff, d)]


def shard_weight_bytes(c, tp: int) -> int:
    """The bf16 weight blocks one forward call's products read on one
    rank: every layer's and the head's."""
    per_layer = sum(k * n for k, n in shard_matmuls(c, tp))
    return BF16 * (c.n_layers * per_layer + c.d_model * c.vocab // tp)


def products(c, tp: int, rows: int, picked: int):
    """(M, K, N) of every product of one forward call on one rank:
    ``rows`` rows through each layer, ``picked`` through the head."""
    out = [(rows, k, n) for _ in range(c.n_layers)
           for k, n in shard_matmuls(c, tp)]
    return out + [(picked, c.d_model, c.vocab // tp)]


def forward_bf16_bound_s(c, tp: int, rows: int, picked: int) -> float:
    """The least seconds of one forward call's bf16 products on one
    rank: the larger of their FLOPs over the bf16 peak and their bytes
    (weight blocks, inputs and outputs, once each) over the memory
    rate."""
    flops = nbytes = 0
    for m, k, n in products(c, tp, rows, picked):
        flops += 2 * m * k * n
        nbytes += BF16 * (k * n + m * k + m * n)
    return rooflines.bound_s(flops, nbytes)


def request_bf16_bound_s(c, tp: int, batch: int, prompt: int,
                         new_tokens: int) -> float:
    """Summed bound of the bf16 products of one generation on one rank:
    the prefill at batch x prompt rows and each decode step at batch
    rows (``rooflines.forward_calls``), the head at batch rows each."""
    return sum(forward_bf16_bound_s(c, tp, batch * t_new, batch)
               for t_new, _ in rooflines.forward_calls(c, batch, prompt,
                                                       new_tokens))
