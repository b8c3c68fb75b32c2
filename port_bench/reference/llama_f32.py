"""Plain float32 reference of the Llama-family model the benchmark runs.

Written from the published block (RMSNorm, rotary embeddings by halves,
grouped-query causal attention, a SwiGLU MLP, untied head), in plain
``torch`` operations on float32 tensors, with TF32 off. It imports no
kernel and nothing of the program, and it takes nothing the program
made: the weights come from ``port_bench.weights`` (the same bf16 draws,
made again and cast up), the batches and prompts from the run's seed.

What the configurations state beyond the block, the reference works out
itself: the per-output-channel int8 weights and the per-(token, KV head)
int8 cache of a served model (``bits``), the clipped AdamW step of a
trained one (optax's order: clip by the global norm, then Adam with
bias correction and decoupled weight decay) with its parameters and
moments stored in the configuration's dtype between steps, and a
sampled pick's Gumbel-max scores from the noise that PyTorch's
``torch.rand`` draws from the request's seed.

The controls are the same code one step lower in precision:
``bits=4`` for the int8 weights and cache, ``matmul=fp8_matmul`` for the
bf16 training step.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- quantization, as the configuration states it ---------------------------

def quantize_sym(x: torch.Tensor, dim: int, bits: int) -> torch.Tensor:
    """x rounded to a symmetric ``bits``-bit grid along ``dim``: scale
    max|x| / (2^(bits-1) - 1) for each slice over ``dim``, codes rounded
    half to even and clipped; returned dequantized, in float32."""
    top = 2 ** (bits - 1) - 1
    x = x.float()
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / top
    return torch.clamp(torch.round(x / scale), -top, top) * scale


def dequantized_weight(w: torch.Tensor, bits) -> torch.Tensor:
    """A (in, out) weight as the served model multiplies it: per output
    channel, the max over the input axis."""
    return w.float() if bits is None else quantize_sym(w, 0, bits)


def _e4m3_scaled(x: torch.Tensor, dtype) -> torch.Tensor:
    """x through an 8-bit float with a per-tensor scale (amax to the
    format's largest finite value), back in float32."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w with both operands in float8 e4m3 and the backward's
    incoming gradient in e5m2, as fp8 training runs its products;
    accumulation in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq = _e4m3_scaled(x, torch.float8_e4m3fn)
        wq = _e4m3_scaled(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dyq = _e4m3_scaled(dy, torch.float8_e5m2)
        dx = dyq @ wq.transpose(-1, -2)
        dw = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1)
              @ dyq.reshape(-1, dyq.shape[-1]))
        return dx, dw


def fp8_matmul(x, w):
    return _Fp8Matmul.apply(x, w)


def plain_matmul(x, w):
    return x @ w


# -- the block -------------------------------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float, positions):
    """(B, S, H, D) rotated by halves at ``positions`` (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    angles = positions.double()[:, None] * freqs[None, :]
    cos = torch.cos(angles).float()[None, :, None, :]
    sin = torch.sin(angles).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v):
    """Causal softmax attention, (B, S, H, D) queries over (B, S, Hkv,
    D) keys and values, query head h reading KV head h // (H / Hkv)."""
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    seq = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    mask = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def layer_forward(h, layer, c, eps, *, kv_bits=None, matmul=plain_matmul):
    """One decoder layer on float32 (B, S, d) ``h``; ``layer``'s weights
    float32 (already dequantized for a served model)."""
    batch, seq, _ = h.shape
    hd = c.head_dim
    positions = torch.arange(seq, device=h.device)
    a = rms_norm(h, layer["attn_norm"], eps)
    q = matmul(a, layer["wq"]).reshape(batch, seq, c.n_heads, hd)
    k = matmul(a, layer["wk"]).reshape(batch, seq, c.n_kv_heads, hd)
    v = matmul(a, layer["wv"]).reshape(batch, seq, c.n_kv_heads, hd)
    q, k = rope(q, c.rope_theta, positions), rope(k, c.rope_theta, positions)
    if kv_bits is not None:
        # the cache holds each (token, KV head) row on its own grid
        k, v = quantize_sym(k, -1, kv_bits), quantize_sym(v, -1, kv_bits)
    ctx = attention(q, k, v).reshape(batch, seq, c.n_heads * hd)
    h = h + matmul(ctx, layer["wo"])
    m = rms_norm(h, layer["mlp_norm"], eps)
    gate = matmul(m, layer["w_gate"])
    up = matmul(m, layer["w_up"])
    return h + matmul(torch.nn.functional.silu(gate) * up, layer["w_down"])


# -- serving: logits of the served positions -----------------------------

def served_logits(c, eps, tokens, first, layer_weights, ends, *, bits):
    """float32 logits at positions ``first`` .. S - 2 of ``tokens`` (B,
    S) (each predicts the token after it), through every layer with
    weights and cache on the ``bits``-bit grid. ``layer_weights(i)``
    gives layer i's weights (any dtype; cast up here), ``ends`` the
    embedding, final norm and head."""
    h = ends["embed"][tokens].float()
    for i in range(c.n_layers):
        raw = layer_weights(i)
        layer = {name: (dequantized_weight(w, bits) if w.dim() == 2
                        else w.float())
                 for name, w in raw.items()}
        del raw
        h = layer_forward(h, layer, c, eps, kv_bits=bits)
        del layer
    h = rms_norm(h[:, first:-1], ends["final_norm"].float(), eps)
    return h @ dequantized_weight(ends["lm_head"], bits)


def pick_noise(seed: int, rows: int, vocab: int, draws: int, device,
               temperature: float):
    """The uniforms that sampling at ``temperature`` > 0 draws for one
    request seeded with ``seed``: PyTorch's ``torch.rand`` on a fresh
    generator of ``device`` seeded with it, one (rows, vocab) float32
    draw a new token, in order. (rows, draws, vocab), or None at
    temperature 0 (greedy draws nothing)."""
    if temperature <= 0.0:
        return None
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.stack([torch.rand((rows, vocab), generator=g,
                                   dtype=torch.float32, device=device)
                        for _ in range(draws)], dim=1)


def pick_scores(logits, noise, temperature: float):
    """The Gumbel-max trick's scores, whose argmax is the sampled token:
    logits / temperature - log(-log(u)), with u clamped at float32's
    smallest normal; the logits themselves where ``noise`` is None."""
    if noise is None:
        return logits
    u = torch.clamp_min(noise, torch.finfo(torch.float32).tiny)
    return logits / temperature - torch.log(-torch.log(u))


def token_gaps(logits, chosen):
    """For each position, how far the chosen token's logit lies below
    the best: (..., V) logits and (...) token ids."""
    best = logits.max(dim=-1).values
    return best - torch.gather(logits, -1, chosen[..., None].long())[..., 0]


# -- training: losses, the first gradient, the change ----------------------

def named_leaves(params):
    out = [("embed", params["embed"]), ("final_norm", params["final_norm"]),
           ("lm_head", params["lm_head"])]
    for i, layer in enumerate(params["layers"]):
        out += [(f"layers.{i}.{k}", v) for k, v in sorted(layer.items())]
    return out


def next_token_loss(params, tokens, c, eps, total, matmul):
    """The sum of the rows' next-token losses over ``total`` targets:
    each block's share of the batch mean. Every layer is recomputed on
    the backward pass, so one layer's attention scores live at a time."""
    h = params["embed"][tokens]
    for layer in params["layers"]:
        h = checkpoint(layer_forward, h, layer, c, eps, use_reentrant=False,
                       matmul=matmul)
    h = rms_norm(h, params["final_norm"], eps)
    logits = matmul(h, params["lm_head"])[:, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    return -picked.sum() / total


def train_readings(c, eps, params, batches, *, lr, weight_decay, clip_norm,
                   matmul=plain_matmul, rows_per_block: int = 1,
                   storage=torch.float32) -> dict:
    """``len(batches)`` clipped AdamW steps from float32 ``params``
    (changed in place) over token batches (B, S). Returns each step's
    loss, each leaf's norm of the first step's clipped gradient and of
    its raw gradient, and each leaf's norm of the change after the last
    step, in ``named_leaves`` order. Each batch's gradient is summed over
    blocks of ``rows_per_block`` rows, so the activations of one block
    live at a time. The arithmetic is float32; the parameters and the
    moments are stored between steps in ``storage``, the dtype the
    configuration keeps them in (each rounded to it after its update)."""
    names, leaves = zip(*named_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    start = [p.detach().clone() for p in leaves]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    losses, first_grad, raw_grad = [], None, None
    for step, tokens in enumerate(batches, start=1):
        total = tokens.shape[0] * (tokens.shape[1] - 1)
        loss = 0.0
        for row in range(0, tokens.shape[0], rows_per_block):
            block = tokens[row:row + rows_per_block].long()
            part = next_token_loss(params, block, c, eps, total, matmul)
            part.backward()
            loss += part.item()
        losses.append(loss)
        with torch.no_grad():
            grads = [p.grad for p in leaves]
            norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads))
            if step == 1:
                raw_grad = [g.norm().item() for g in grads]
            if clip_norm > 0 and norm.item() >= clip_norm:
                grads = [g * (clip_norm / norm.item()) for g in grads]
            if step == 1:
                first_grad = [g.norm().item() for g in grads]
            b1, b2 = 1 - B1 ** step, 1 - B2 ** step
            for p, g, m, v in zip(leaves, grads, mu, nu):
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).addcmul_(g, g, value=1 - B2)
                m.copy_(m.to(storage))
                v.copy_(v.to(storage))
                update = (m / b1) / (torch.sqrt(v / b2) + ADAM_EPS)
                p.add_(update + weight_decay * p, alpha=-lr)
                p.copy_(p.to(storage))
                p.grad = None
    with torch.no_grad():
        change = [(p - s).norm().item() for p, s in zip(leaves, start)]
    return {"names": list(names), "losses": losses,
            "first_grad": first_grad, "raw_grad": raw_grad,
            "change": change}


def median(values):
    ordered = sorted(values)
    n = len(ordered)
    return 0.5 * (ordered[(n - 1) // 2] + ordered[n // 2])


def worst_leaf_gap(program, reference, keep=None):
    """The largest gap between the program's and the reference's norm of
    a leaf, over the larger of the reference's norm of that leaf and of
    the median leaf; with ``keep``, only the leaves it marks."""
    floor = median([r for i, r in enumerate(reference)
                    if keep is None or keep[i]])
    gaps = [abs(p - r) / max(r, floor)
            for i, (p, r) in enumerate(zip(program, reference))
            if keep is None or keep[i]]
    return max(gaps)


#: a leaf whose raw reference gradient is under this share of the median
#: leaf's moves by round-off alone under Adam: left out of the change
STILL_LEAF = 1e-3


def train_gaps(program: dict, reference: dict) -> dict:
    """The three numbers a training cell compares."""
    loss = max(abs(p - r) / abs(r) for p, r in
               zip(program["losses"], reference["losses"]))
    grad = worst_leaf_gap(program["first_grad"], reference["first_grad"])
    floor = STILL_LEAF * median(reference["raw_grad"])
    keep = [g >= floor for g in reference["raw_grad"]]
    change = worst_leaf_gap(program["change"], reference["change"], keep)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
