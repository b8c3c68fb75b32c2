"""Served logits with the weights' grid and the cache's grid set apart.

``llama_f32.served_logits`` puts the weights and the KV cache on one
``bits``-bit grid, as an int8 server holds both. A server of bf16
weights over an int8 cache holds them on two: the weights as drawn
(bf16, cast up to float32) and each (token, KV head) row of the cache on
the int8 grid. :func:`served_logits` takes the two apart, composed of
``llama_f32``'s own pieces (``dequantized_weight``, ``layer_forward``
with its ``kv_bits``), in plain ``torch`` on float32 tensors; the caller
turns TF32 off (``llama_f32.no_tf32``). It imports no kernel and nothing
of the program.

The controls are the same function on other grids: int8 or int4 weights
(per output channel) over the int8 cache, or the weights as drawn over
an int4 cache.
"""

from __future__ import annotations

from port_bench.reference import llama_f32


def served_logits(c, eps, tokens, first, layer_weights, ends, *,
                  weight_bits, kv_bits):
    """float32 logits at positions ``first`` .. S - 2 of ``tokens`` (B,
    S) (each predicts the token after it), through every layer, one at a
    time: the weights on the ``weight_bits``-bit grid (None: as given)
    and the cache on the ``kv_bits``-bit grid (None: float32).
    ``layer_weights(i)`` gives layer i's weights (any dtype; cast up
    here), ``ends`` the embedding, final norm and head."""
    h = ends["embed"][tokens].float()
    for i in range(c.n_layers):
        raw = layer_weights(i)
        layer = {name: (llama_f32.dequantized_weight(w, weight_bits)
                        if w.dim() == 2 else w.float())
                 for name, w in raw.items()}
        del raw
        h = llama_f32.layer_forward(h, layer, c, eps, kv_bits=kv_bits)
        del layer
    h = llama_f32.rms_norm(h[:, first:-1], ends["final_norm"].float(), eps)
    return h @ llama_f32.dequantized_weight(ends["lm_head"], weight_bits)
