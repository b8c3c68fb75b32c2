"""Causal flash attention, forward and backward: the CUDA port of the
Pallas TPU kernels.

Mirrors ``jax.experimental.pallas.ops.tpu.flash_attention``, which
``tpu_operator_libs/examples/llama.py::forward`` calls as
``flash_attention(q, k, v, causal=True, sm_scale=head_dim ** -0.5)`` on
``(B, H, S, D)`` inputs, with its ``custom_vjp``
(``_flash_attention_fwd`` / ``_flash_attention_bwd``):

- the forward (``_flash_attention_impl``, kernel
  ``_flash_attention_kernel``) is ``csrc/flash_attention_fwd.cu``;
- the backward's two kernels (``_flash_attention_bwd_dkv`` and
  ``_flash_attention_bwd_dq``) are ``csrc/flash_attention_bwd.cu``.

Which design each launch runs is fixed by (dtype, head_dim) when the
library is compiled (``sm90::kTakesWgmma`` in
``csrc/flash_attention_sm90.cuh``; :func:`kernel_design` asks the built
library):

- bfloat16 at head_dim 64 and 128 (the model's): all three kernels are
  the Hopper design, products on the tensor cores (``wgmma``) over Q, K,
  V and dO tiles that TMA stages in a ring of shared-memory buffers;
- float32 at every head_dim, and bfloat16 at 16 and 32: all three run
  every product on the tensor cores (``mma.sync``) as three TF32
  products (``csrc/tf32_mma.cuh``), which keeps the f32 kernels within
  2e-5 of the plain version, over tiles staged by ``cp.async``
  (``csrc/tf32_block.cuh``); the forward's online softmax runs on the
  accumulator fragments of S, and the backward spreads a GQA group's
  query heads over blocks whose dK/dV partials the group's last block
  adds in head order (ticket counters kept per device
  and stream, as :func:`_build.zeroed_counters` keeps them: the first
  GQA backward on a stream, and the first to need more counters than
  the earlier ones, must not be captured in a CUDA graph). The partials
  are allocated on each GQA call, 2 * B * H * S_kv * D f32 (8 MB at
  (2, 8 / 2, 1000, 64), 4.3 GB at (16, 32 / 8, 8192, 128)).

The sources' design notes say what bounds each kernel and what it leaves
for later. :func:`flash_forward` and :func:`flash_backward` take the
plain versions (:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`) for tensors on the CPU and
launch the kernels for tensors on a CUDA device. K/V may carry fewer
heads than Q (grouped-query attention: kv head = h // (H // H_kv)); the
Pallas calls need them repeated to H heads first, the kernels read them
as they are and the dK/dV kernel sums each group's gradients itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_operator_libs_torch.kernels._build import (
    bind,
    build_all,
    raise_on,
    zeroed_counters,
)

#: head_dim values the kernel is compiled for: the model's 128 and the
#: narrow widths the tests use.
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the CUDA sources under ``csrc/``, forward and backward
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu")


def flash_attention_reference(q, k, v, *, causal: bool, sm_scale: float):
    """Plain PyTorch version: (out (B, H, Sq, D) in q's dtype, lse
    (B, H, Sq) float32). An einsum in float32, a -inf causal mask (query
    i sees keys <= i) and a float32 softmax."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        visible = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril()
        scores = scores.masked_fill(~visible, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype), lse


def _check_inputs(q, k, v) -> None:
    """Raise on anything the kernel does not take; the CPU path holds
    its inputs to the same contract so the tests exercise it."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D (B, H, S, D) tensor")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(
                f"{name} has dtype {t.dtype}; the kernel takes "
                f"{sorted(str(d) for d in _DTYPE_CODES)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    batch, heads, sq, dim = q.shape
    if k.shape[0] != batch or k.shape[3] != dim:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} in "
            "batch or head_dim")
    if heads % k.shape[1]:
        raise ValueError(
            f"kv heads {k.shape[1]} must divide q heads {heads}")
    if dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head_dim {dim} not in {SUPPORTED_HEAD_DIMS}")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError("sequence lengths must be >= 1")


_POINTER = ctypes.c_void_p
_INT = ctypes.c_int
_LAUNCH_TAIL = [_INT] * 8 + [ctypes.c_float, _POINTER]
#: (D, dtype, *design, *smem_bytes), see kernel_design
_DESIGN_QUERY = [_INT, _INT] + [ctypes.POINTER(_INT)] * 2
#: the C entries of each source: a launch takes its pointers, then B, H,
#: Hkv, Sq, Sk, D, dtype, causal, sm_scale and the stream; each launch
#: has a ``<entry>_design`` query beside it (:func:`kernel_design`)
_ENTRY_POINTS = {
    "flash_attention_fwd.cu": {
        "flash_attention_fwd": [_POINTER] * 5 + _LAUNCH_TAIL,
        "flash_attention_fwd_design": _DESIGN_QUERY,
    },
    "flash_attention_bwd.cu": {
        # q, k, v, do, lse, di, dk, dv, then the partials and counters
        # that flash_attention_bwd_dkv_scratch asks for
        "flash_attention_bwd_dkv": [_POINTER] * 10 + _LAUNCH_TAIL,
        "flash_attention_bwd_dq": [_POINTER] * 7 + _LAUNCH_TAIL,
        "flash_attention_bwd_dkv_design": _DESIGN_QUERY,
        "flash_attention_bwd_dq_design": _DESIGN_QUERY,
        # (B, H, Hkv, Sk, D, dtype, *partial_floats, *counters)
        "flash_attention_bwd_dkv_scratch":
            [_INT] * 6 + [ctypes.POINTER(ctypes.c_longlong)] * 2,
        # (B, H, Hkv, Sq, Sk, D, dtype, *blocks), see launch_blocks
        "flash_attention_bwd_dkv_blocks":
            [_INT] * 7 + [ctypes.POINTER(ctypes.c_longlong)],
        "flash_attention_bwd_dq_blocks":
            [_INT] * 7 + [ctypes.POINTER(ctypes.c_longlong)],
    },
}
_ERROR_STRING = "flash_attention_error_string"
_libs: "dict[str, ctypes.CDLL]" = {}
#: the dK/dV tickets by their count (a power of two), each kept per
#: (device, stream) by _build.zeroed_counters
_counters: "dict[int, dict]" = {}


def _library(source: str):
    if source not in _libs:
        # the first launch builds every kernel source, in parallel
        for name, built in zip(SOURCES, build_all(SOURCES)):
            _libs[name] = bind(built.lib, _ENTRY_POINTS[name], _ERROR_STRING)
    return _libs[source]


def _call(source: str, fn_name: str, pointers, q, k, causal: bool,
          sm_scale: float) -> None:
    """Launch ``fn_name`` on q's device and current stream with the data
    pointers of ``pointers`` (None: a null pointer); raise if the launch
    was refused."""
    lib = _library(source)
    batch, heads, sq, dim = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            *(None if t is None else t.data_ptr() for t in pointers), batch,
            heads, k.shape[1], sq, k.shape[2], dim, _DTYPE_CODES[q.dtype],
            int(causal), float(sm_scale), stream)
    raise_on(err, getattr(lib, _ERROR_STRING), fn_name)


#: what :func:`kernel_design` reports for each design code
DESIGNS = {1: "sm90 wgmma", 2: "3xTF32 mma.sync"}


@functools.cache
def kernel_design(name: str, dtype: torch.dtype, head_dim: int) -> dict:
    """The design the built library runs for the entry point ``name``
    (e.g. ``"flash_attention_bwd_dq"``) at (dtype, head_dim) and the
    dynamic shared memory a block takes; builds the libraries first if
    needed (so it needs ``nvcc``)."""
    source = next(src for src, fns in _ENTRY_POINTS.items() if name in fns)
    lib = _library(source)
    design, smem = _INT(), _INT()
    err = getattr(lib, f"{name}_design")(
        head_dim, _DTYPE_CODES[dtype], ctypes.byref(design),
        ctypes.byref(smem))
    if err != 0:
        message = getattr(lib, _ERROR_STRING)(err).decode()
        raise ValueError(f"{name} has no instance for {dtype}, head_dim "
                         f"{head_dim}: {message}")
    return {"design": DESIGNS[design.value],
            "dynamic_smem_bytes": smem.value}


def launch_blocks(name: str, q, k) -> int:
    """The blocks a launch of the backward kernel ``name`` (e.g.
    ``"flash_attention_bwd_dkv"``) runs on q (B, H, Sq, D) and k (B, H_kv,
    Sk, D), from the grid its launcher takes; builds the libraries first
    if needed (so it needs ``nvcc``)."""
    lib = _library(SOURCES[1])
    batch, heads, sq, dim = q.shape
    blocks = ctypes.c_longlong()
    err = getattr(lib, f"{name}_blocks")(
        batch, heads, k.shape[1], sq, k.shape[2], dim, _DTYPE_CODES[q.dtype],
        ctypes.byref(blocks))
    raise_on(err, getattr(lib, _ERROR_STRING), name)
    return blocks.value


def _count(name, dtype, head_dim) -> None:
    """One launch of the entry point ``name``'s kernel, counted on its
    wrapper (:data:`WRAPPERS`) in all and by the design its (dtype,
    head_dim) instance runs."""
    wrapper = WRAPPERS[name]
    wrapper.launches += 1
    design = kernel_design(name, dtype, head_dim)["design"]
    wrapper.launches_by_design[design] = \
        wrapper.launches_by_design.get(design, 0) + 1


def _launch(q, k, v, causal: bool, sm_scale: float):
    batch, heads, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, sq), dtype=torch.float32,
                      device=q.device)
    _call(SOURCES[0], "flash_attention_fwd", (q, k, v, out, lse), q, k,
          causal, sm_scale)
    _count("flash_attention_fwd", q.dtype, q.shape[3])
    return out, lse


def flash_forward(q, k, v, *, causal: bool, sm_scale: float):
    """(out, lse) from the kernel for CUDA tensors, from the plain
    version for CPU tensors."""
    _check_inputs(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    raise ValueError(f"unsupported device {q.device}")


def flash_attention_backward_reference(q, k, v, o, lse, do, *,
                                       causal: bool, sm_scale: float):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv) in
    the dtypes of q, k and v. The kernels' own algorithm, in float32:
    P = exp(Q K^T * sm_scale - lse) recomputed from the saved lse,
    dP = dO V^T, di = rowsum(O * dO), dS = P * (dP - di) * sm_scale, then
    dQ = dS K, dK = dS^T Q and dV = P^T dO, with dK and dV summed over
    each KV head's group of query heads."""
    batch, heads, sq, dim = q.shape
    kv_heads, sk = k.shape[1], k.shape[2]
    group = heads // kv_heads
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    if causal:
        visible = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril()
        scores = scores.masked_fill(~visible, float("-inf"))
    probs = torch.exp(scores - lse[..., None])
    del scores
    dv = torch.einsum("bhqk,bhqd->bhkd", probs, dof)
    dprobs = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    di = (o.float() * dof).sum(-1)
    dscores = probs * (dprobs - di[..., None]) * sm_scale
    del probs, dprobs
    dq = torch.einsum("bhqk,bhkd->bhqd", dscores, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", dscores, qf)

    def group_sum(x):
        return x.reshape(batch, kv_heads, group, sk, dim).sum(2)

    return dq.to(q.dtype), group_sum(dk).to(k.dtype), \
        group_sum(dv).to(v.dtype)


def _check_backward_inputs(q, k, v, o, lse, do) -> None:
    _check_inputs(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if not isinstance(t, torch.Tensor) or t.shape != q.shape \
                or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous tensor of q's shape, dtype "
                "and device")
    if not isinstance(lse, torch.Tensor) or lse.shape != q.shape[:3] \
            or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError(
            "lse must be a contiguous float32 (B, H, Sq) tensor on q's "
            "device")


def _require_cuda(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(
            f"the backward kernels take CUDA tensors, got {q.device}; "
            "flash_backward takes the plain version on the CPU")


def _dkv_scratch(q, k):
    """The dK/dV launch's f32 partials and zeroed ticket counters (None
    where its instance needs none)."""
    batch, heads, _, dim = q.shape
    floats, count = ctypes.c_longlong(), ctypes.c_longlong()
    lib = _library(SOURCES[1])
    err = lib.flash_attention_bwd_dkv_scratch(
        batch, heads, k.shape[1], k.shape[2], dim, _DTYPE_CODES[q.dtype],
        ctypes.byref(floats), ctypes.byref(count))
    raise_on(err, getattr(lib, _ERROR_STRING), "flash_attention_bwd_dkv")
    if floats.value == 0:
        return None, None
    # allocated here, so inside a captured graph from the graph's pool
    partials = torch.empty(floats.value, dtype=torch.float32,
                           device=q.device)
    size = 1 << max(10, (count.value - 1).bit_length())
    with torch.cuda.device(q.device):
        counters = zeroed_counters(
            _counters.setdefault(size, {}), q.device,
            torch.cuda.current_stream(q.device), size,
            "flash_attention_bwd_dkv")
    return partials, counters


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool,
                            sm_scale: float):
    """(dk, dv) from the dK/dV kernel, for CUDA tensors that
    :func:`flash_backward` has checked; ``di`` is rowsum(O * dO) in
    float32, (B, H, Sq)."""
    _require_cuda(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    partials, counters = _dkv_scratch(q, k)
    _call(SOURCES[1], "flash_attention_bwd_dkv",
          (q, k, v, do, lse, di, dk, dv, partials, counters), q, k, causal,
          sm_scale)
    _count("flash_attention_bwd_dkv", q.dtype, q.shape[3])
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, *, causal: bool,
                           sm_scale: float):
    """dq from the dQ kernel, on the terms of
    :func:`flash_attention_bwd_dkv`."""
    _require_cuda(q)
    dq = torch.empty_like(q)
    _call(SOURCES[1], "flash_attention_bwd_dq", (q, k, v, do, lse, di, dq),
          q, k, causal, sm_scale)
    _count("flash_attention_bwd_dq", q.dtype, q.shape[3])
    return dq


def flash_backward(q, k, v, o, lse, do, *, causal: bool, sm_scale: float):
    """(dq, dk, dv) for the forward's (out=o, lse) and the output
    gradient ``do``: the kernels for CUDA tensors, the plain version for
    CPU tensors."""
    _check_backward_inputs(q, k, v, o, lse, do)
    if q.device.type == "cuda":
        # di outside the kernels, as the Pallas backward computes it
        di = (o.float() * do.float()).sum(-1)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                         causal=causal, sm_scale=sm_scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, di, causal=causal,
                                    sm_scale=sm_scale)
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_forward(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse,
                                    grad_out.contiguous(),
                                    causal=ctx.causal,
                                    sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float):
    """Attention output (B, H, Sq, D) for q (B, H, Sq, D) and k, v
    (B, H_kv, Sk, D), float32 or bfloat16, contiguous; differentiable
    through the backward kernels."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale)


#: Kernel launches since the last reset (the plain CPU path adds none),
#: in all and by the design their instance runs (:func:`kernel_design`'s
#: names)
flash_attention.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention.launches_by_design = {}
flash_attention_bwd_dkv.launches_by_design = {}
flash_attention_bwd_dq.launches_by_design = {}
#: every kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"flash_attention_fwd": flash_attention,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq}
