"""The model's weights, made on the device from the run's seed.

Each layer is one ``torch.randn`` call of a generator seeded from (seed,
layer) in the served dtype, cut into the layer's matrices and scaled by
fan-in ** -0.5; the embedding and the head are one call each. Norm
weights are 1 + 0.1 x a normal draw, so a norm that drops its weight
shows. Because every layer has a stream of its own, the reference makes
any one layer again, alone, bit for bit: it never holds the whole model
in float32. The layout is the port's parameter dict (``(in, out)``
weights, ``x @ W``).
"""

from __future__ import annotations

import hashlib
import math

import torch

LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
NORM_SCALE = 0.1
EMBED_SCALE = 0.02


def stream_seed(seed: int, *names) -> int:
    """A 63-bit generator seed for one named stream of ``seed``."""
    text = ":".join(str(x) for x in (seed, *names)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *names))


def layer_shapes(c) -> "dict[str, tuple[int, int]]":
    d, hd = c.d_model, c.head_dim
    return {"wq": (d, c.n_heads * hd), "wk": (d, c.n_kv_heads * hd),
            "wv": (d, c.n_kv_heads * hd), "wo": (c.n_heads * hd, d),
            "w_gate": (d, c.d_ff), "w_up": (d, c.d_ff),
            "w_down": (c.d_ff, d)}


def make_layer(c, seed: int, index: int, device, dtype) -> dict:
    shapes = layer_shapes(c)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes) + 2 * c.d_model,
                       generator=generator(device, seed, "layer", index),
                       device=device, dtype=dtype)
    layer, offset = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        layer[name] = flat[offset:offset + size].view(shape).mul_(
            shape[0] ** -0.5)
        offset += size
    for name in ("attn_norm", "mlp_norm"):
        # cloned: a view would keep the whole flat buffer alive once the
        # matrices are quantized
        layer[name] = (flat[offset:offset + c.d_model] * NORM_SCALE
                       + 1).clone()
        offset += c.d_model
    return layer


def make_ends(c, seed: int, device, dtype) -> dict:
    """The embedding, the final norm and the head."""
    embed = torch.randn((c.vocab, c.d_model),
                        generator=generator(device, seed, "embed"),
                        device=device, dtype=dtype).mul_(EMBED_SCALE)
    flat = torch.randn(c.d_model * c.vocab + c.d_model,
                       generator=generator(device, seed, "head"),
                       device=device, dtype=dtype)
    head = flat[:c.d_model * c.vocab].view(c.d_model, c.vocab).mul_(
        c.d_model ** -0.5)
    norm = (flat[c.d_model * c.vocab:] * NORM_SCALE + 1).clone()
    return {"embed": embed, "final_norm": norm, "lm_head": head}


def make_params(c, seed: int, device, dtype) -> dict:
    params = make_ends(c, seed, device, dtype)
    params["layers"] = [make_layer(c, seed, i, device, dtype)
                        for i in range(c.n_layers)]
    return params
