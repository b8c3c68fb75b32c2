#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and multi-device slices on
the CUDA cards at full width.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

(``python3 chip_smoke.py --multichip-only`` runs phases 1, 2 and 9 alone,
for a machine with several cards.)

Each phase prints one JSON line; any failure raises and the script
exits non-zero without printing a result. Phases:

1. device: the card's name, count and power limit; TF32 off.
2. build: every CUDA source in ``tpu_operator_libs_torch/csrc``, one
   ``nvcc`` each, in parallel.
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version on the card at the train step's and the serving path's
   shapes and four more (bf16 and f32, GQA and a ragged last tile), each
   row naming the design it ran and timed beside
   ``scaled_dot_product_attention`` on a pinned backend.
3b. kernel_bwd: the dK/dV and dQ kernels against their plain version at
   the train step's shape and four more (an odd length among them), two
   launches bit-equal, each row naming the design it ran, timed beside
   SDPA's backward alone.
3c. ring_kernels, with the launch counts set to 0 just before its chain:
   the three flash kernels launched without the causal mask (a ring's
   past blocks) against plain and SDPA; the long-context shape (b) cut
   into 4 blocks, each query block's ring chain (``_block_attention``:
   a flash forward per visible block, folded by the fold kernel) against
   the whole-sequence flash forward and against the plain chain; the
   fold kernel against its plain version (rows that have seen nothing
   among them); the ring's backward schedule against the whole-sequence
   backward.
3d. int8_matmul: the int8-weight matmul kernel against its plain version
   at every shape the decode paths give it (decode M 8 and 2, prefill M
   512, phase 9's tp shards at M 4, a ragged shape, one f32 row), two
   launches bit-equal, timed in CUDA graphs beside
   ``torch._weight_int8pack_mm`` and cuBLAS on a bf16 copy.
4-6. the serving path, with the launch counts set to 0 just before it:
   ``forward`` of llama-277M with ``attention_impl="flash"`` against
   ``"xla"``; the decode contract (stepwise cache == batch forward, host
   loop == graph-replayed device loop in bf16, int8 weights + int8 KV
   and a sampled case with eos and logprobs; each call's graph launches
   and capture ms); a ``DecodeServer`` burst with a mid-burst drain, then
   decode at the bench's shape through the graph and the host loop.
7-8. the training path, with the launch counts set to 0 just before it:
   6 steps of ``make_train_step`` (flash, batch 16, seq 1024, bf16), its
   gradients against ``"xla"`` and against ``remat=True``; then save ->
   checkpoint gate -> restore into another seed's state -> the next
   loss equal bit for bit.
9. multichip, with the launch counts set to 0 just before it in its
   ranks: the one-card probe step; then one NCCL rank per visible card
   over the dp x tp mesh (``parallel.dp_tp_split``) running llama-277M
   (flash at tp=1, xla otherwise): 3 train steps at batch 16 x 1024
   (at one card, the losses held to phase 7's first three), host loop ==
   device loop decode in bf16 and int8, save -> gate -> restore -> the
   next loss bit-equal, the fabric battery over every shifted ring, and
   at two cards or more the bandwidth ring; then, at llama-277M's
   widths, ring (ring attention against dense; the ring Llama on a 1 x n
   dp x sp mesh, its forward at 1 x 8192 against the one-card flash
   forward and 3 train steps at 16 x 1024, held to phase 7's at one
   card), pipeline (GPipe, f32) and moe (both dispatch modes, f32).
10. kernels: one line with every kernel's launches, error and times.

The last line is ``{"ok": true, "device": {...}}``. The model is
llama-277M as ``bench.py`` builds it (vocab 2048, d_model 2048, 4
layers, 16 heads, head_dim 128, d_ff 8192, bf16), with random weights
from a seed. Without CUDA the script exits 1.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from tpu_operator_libs_torch.examples.llama import (  # noqa: E402
    LlamaConfig,
    forward,
    init_llama_params,
    make_token_batch,
    make_train_step,
    next_token_loss,
)
from tpu_operator_libs_torch.examples.llama_decode import (  # noqa: E402
    forward_with_cache,
    generate,
    generate_on_device,
    init_kv_cache,
    quantize_params_int8,
)
from tpu_operator_libs_torch.examples.llama_serving_job import (  # noqa: E402
    DecodeServer,
    run_demo,
)
from tpu_operator_libs_torch.examples.training_job import (  # noqa: E402
    make_checkpoint_manager,
    restore_state,
)
from tpu_operator_libs_torch.health.checkpoint_gate import (  # noqa: E402
    CheckpointDurabilityGate,
)
from tpu_operator_libs_torch.health.serving_gate import (  # noqa: E402
    ServingEndpoint,
)
from tpu_operator_libs_torch import multichip  # noqa: E402
from tpu_operator_libs_torch.examples.ring_attention import (  # noqa: E402
    _block_attention,
    _block_backward,
    _schedule,
)
from tpu_operator_libs_torch.kernels import (  # noqa: E402
    SOURCES,
    WRAPPERS,
    _build,
)
from tpu_operator_libs_torch.kernels.attention_fold import (  # noqa: E402
    attention_fold,
    attention_fold_reference,
)
from tpu_operator_libs_torch.kernels.int8_matmul import (  # noqa: E402
    int8_matmul,
    int8_matmul_reference,
    split_plan,
)
from tpu_operator_libs_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_reference,
    flash_backward,
    flash_forward,
    kernel_design,
)
from tpu_operator_libs_torch.optim import (  # noqa: E402
    tree_leaves,
    value_and_grad,
)
from tpu_operator_libs_torch.parallel import (  # noqa: E402
    dp_tp_split,
    run_ranks,
)

#: H100 SXM published dense peaks (NVIDIA data sheet, no sparsity)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

#: llama-277M at bench.py's defaults (bench.py:551-555 with D=2048)
CONFIG_277M = LlamaConfig(vocab=2048, d_model=2048, n_layers=4,
                          n_heads=16, n_kv_heads=16, d_ff=8192,
                          seq_len=1024, learning_rate=1e-4)

#: Kernel against plain version: (rtol, atol) on the output.
#: bf16: both sides accumulate in f32 and round once to bf16, so they may
#: differ by one bf16 ulp of the output, which is at most 2^-7 * |out|;
#: atol covers outputs near 0 where the f32 sums differ in order.
#: f32: sums in another order over <= 8192 keys; 2e-5 is the tolerance
#: the CPU test holds the plain version to against the Pallas kernel. The
#: backward's dK/dV sum up to S * H / H_kv pair terms (4,000 at shape
#: (c)), where their sound reading is 2.0e-5 and passes through the rtol
#: term; wrong variants of the algorithm there (dK unscaled, a group head
#: dropped, the ragged key tile dropped, inputs staged as bf16) are off
#: by 1.4e-2 and more (tests/test_torch_flash_attention.py). Each row
#: reports ``limit_use``, the largest share of its limit an element takes.
KERNEL_TOL = {torch.bfloat16: (2.0 ** -7, 1e-3), torch.float32: (1e-5, 2e-5)}
#: log-sum-exp, f32 on both sides
LSE_ATOL = 1e-4

SEED = 0

#: the yardstick's backend, pinned so that runs compare like with like:
#: flash for bf16, memory-efficient for f32 (flash takes no f32)
SDPA_BACKENDS = {torch.bfloat16: (SDPBackend.FLASH_ATTENTION, "flash"),
                 torch.float32: (SDPBackend.EFFICIENT_ATTENTION,
                                 "efficient")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(sq, sk, causal=True) -> int:
    if causal:
        return sum(min(i + 1, sk) for i in range(sq))
    return sq * sk


def attention_bound_ms(batch, heads, kv_heads, sq, sk, dim, dtype,
                       causal=True):
    """Least time for the work these inputs need: the larger of the
    FLOPs of the visible (query, key) pairs over the dtype's peak and
    Q, K, V, O and the lse moved once over the memory rate."""
    # QK^T and PV, 2 FLOPs/MAC
    flops = 4 * batch * heads * dim * visible_pairs(sq, sk, causal)
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (2 * batch * heads * sq * dim
                       + 2 * batch * kv_heads * sk * dim)
              + 4 * batch * heads * sq)
    t_flops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    card = {"name": torch.cuda.get_device_name(0),
            "power_limit": smi_line.split(",")[-1].strip()}
    emit({"phase": "device", "kind": card["name"],
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


#: each C++ kernel template's wrapper name and the dtype of its instances
#: when the template takes none (the wgmma kernels are bf16 only)
KERNEL_TEMPLATES = {
    "flash_fwd_kernel": ("flash_attention_fwd", None),
    "flash_fwd_wgmma_kernel": ("flash_attention_fwd", torch.bfloat16),
    "flash_bwd_dkv_kernel": ("flash_attention_bwd_dkv", None),
    "flash_bwd_dkv_wgmma_kernel": ("flash_attention_bwd_dkv",
                                   torch.bfloat16),
    "flash_bwd_dq_kernel": ("flash_attention_bwd_dq", None),
    "flash_bwd_dq_wgmma_kernel": ("flash_attention_bwd_dq", torch.bfloat16),
}


def ptxas_entry(block, kernel, dtype, head_dim, design):
    """One kernel instance's line of the build phase from its ptxas
    report."""
    regs = re.search(r"Used (\d+) registers", block)
    smem = re.search(r"(\d+) bytes smem", block)
    spill = re.search(r"(\d+) bytes spill stores", block)
    return {"kernel": kernel, "dtype": str(dtype).replace("torch.", ""),
            "head_dim": head_dim, "design": design["design"],
            "registers": int(regs.group(1)) if regs else None,
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
            "dynamic_smem_bytes": design["dynamic_smem_bytes"],
            "spill_store_bytes": int(spill.group(1)) if spill else 0,
            # ptxas serialises wgmma it cannot keep asynchronous
            "wgmma_serialized": "serialized" in block}


def phase_build():
    """Build every kernel source at once (one nvcc each, in parallel)
    and report, per kernel instance, ptxas' registers, static shared
    memory and spills, the dynamic shared memory a block takes and the
    design the library runs for its (dtype, head_dim)."""
    start = time.perf_counter()
    built = _build.build_all(SOURCES)
    wall = time.perf_counter() - start
    for source, lib in zip(SOURCES, built):
        entries = []
        for block in lib.ptxas_report.split("Compiling entry function")[1:]:
            mm = re.search(r"\d(int8_matmul(?:_reduce)?_kernel)I"
                           r"(13__nv_bfloat16|f)(?:Li(\d)ELb([01])E)?", block)
            if mm is not None:
                loads = "16-byte" if mm.group(4) == "1" else "bytewise"
                design = ("split-K sum in split order" if mm.group(3) is None
                          else f"CUDA-core FMA, {mm.group(3)} rows of x a "
                               f"block, {loads} code loads")
                entries.append(ptxas_entry(
                    block, mm.group(1),
                    torch.float32 if mm.group(2) == "f" else torch.bfloat16,
                    None, {"design": design, "dynamic_smem_bytes": 0}))
                continue
            fold = re.search(r"\dattention_fold_kernelI(13__nv_bfloat16|f)E",
                             block)
            if fold is not None:
                entries.append(ptxas_entry(
                    block, "attention_fold_kernel",
                    torch.float32 if fold.group(1) == "f" else torch.bfloat16,
                    None, {"design": "one warp a row",
                           "dynamic_smem_bytes": 0}))
                continue
            # the template's name follows its length in the mangled name
            name = re.search(r"\d(flash_[a-z]+(?:_[a-z]+)*?_kernel)I"
                             r"(13__nv_bfloat16|f)?Li(\d+)E", block)
            if name is None:
                raise RuntimeError(f"unrecognised ptxas entry: {block[:200]}")
            wrapper, fixed_dtype = KERNEL_TEMPLATES[name.group(1)]
            dtype = fixed_dtype or (torch.bfloat16 if name.group(2) != "f"
                                    else torch.float32)
            head_dim = int(name.group(3))
            entries.append(ptxas_entry(block, name.group(1), dtype, head_dim,
                                       kernel_design(wrapper, dtype,
                                                     head_dim)))
        emit({"phase": "build", "source": source,
              "build_seconds": lib.build_seconds, "wall_seconds_all": wall,
              "ptxas": entries})


def limit_use(err, ref, rtol, atol) -> float:
    """The largest share of its limit, atol + rtol * |ref|, that an
    element's error ``err`` takes: the check passes while it is <= 1."""
    return (err / (atol + rtol * ref.float().abs())).max().item()


def check_kernel_shape(label, batch, heads, kv_heads, seq, dim, dtype,
                       card, iters, causal=True):
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    q = randn(batch, heads, seq, dim)
    k = randn(batch, kv_heads, seq, dim)
    v = randn(batch, kv_heads, seq, dim)
    scale = dim ** -0.5
    out, lse = flash_forward(q, k, v, causal=causal, sm_scale=scale)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_reference(q, k, v, causal=causal,
                                             sm_scale=scale)
    rtol, atol = KERNEL_TOL[dtype]
    err = (out.float() - ref.float()).abs()
    max_err = err.max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    use = limit_use(err, ref, rtol, atol)
    if not (use <= 1 and lse_err <= LSE_ATOL
            and torch.isfinite(out.float()).all()):
        raise RuntimeError(
            f"flash_attention_fwd disagrees with its plain version at "
            f"{label}: max|err| {max_err} (rtol {rtol}, atol {atol}), "
            f"lse max|err| {lse_err} (atol {LSE_ATOL})")
    del ref, ref_lse, err
    kernel_ms = cuda_ms(
        lambda: flash_forward(q, k, v, causal=causal, sm_scale=scale), iters)
    plain_ms = cuda_ms(
        lambda: flash_attention_reference(q, k, v, causal=causal,
                                          sm_scale=scale),
        max(1, iters // 3), warmup=1)
    group = heads // kv_heads
    k_full = k.repeat_interleave(group, dim=1)
    v_full = v.repeat_interleave(group, dim=1)
    backend, backend_name = SDPA_BACKENDS[dtype]
    with sdpa_kernel(backend):
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_full, v_full, is_causal=causal, scale=scale), iters)
    bound_ms, bound_by = attention_bound_ms(batch, heads, kv_heads, seq,
                                            seq, dim, dtype, causal)
    row = {"phase": "kernel", "name": "flash_attention_fwd",
           "shape": label, "causal": causal, "B": batch, "H": heads,
           "H_kv": kv_heads,
           "S": seq, "D": dim, "dtype": str(dtype).replace("torch.", ""),
           **kernel_design("flash_attention_fwd", dtype, dim),
           "max_abs_err": max_err, "rtol": rtol, "atol": atol,
           "limit_use": use, "lse_max_abs_err": lse_err,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": f"sdpa[{backend_name}]",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "card": card}
    emit(row)
    del q, k, v, k_full, v_full, out, lse
    torch.cuda.empty_cache()
    return row


def phase_kernel(card):
    shapes = [
        # the main paths' calls: the train step of llama-277M (batch 16)
        # and its serving forward (batch 2), S 1024
        ("train", 16, 16, 16, 1024, 128, torch.bfloat16, 5),
        ("main", 2, 16, 16, 1024, 128, torch.bfloat16, 20),
        ("a", 8, 16, 16, 1024, 128, torch.bfloat16, 10),
        ("b", 1, 16, 16, 8192, 128, torch.bfloat16, 5),
        ("c", 2, 8, 2, 1000, 64, torch.float32, 20),
        # GQA and a ragged last tile through the bf16 (wgmma) design
        ("d", 2, 8, 2, 1000, 128, torch.bfloat16, 20),
    ]
    return [check_kernel_shape(*s[:7], card, s[7]) for s in shapes]


def backward_bound_ms(products, batch, heads, kv_heads, seq, dim, dtype,
                      outputs, causal=True):
    """Least time for one backward kernel on these inputs: ``products``
    matrix products of 2*D FLOPs per visible pair over the dtype's peak,
    against Q, K, V, dO, lse and di read once and ``outputs`` (the
    element counts it writes) written once, over the memory rate."""
    flops = products * 2 * dim * batch * heads * visible_pairs(seq, seq,
                                                                causal)
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (2 * batch * heads * seq * dim
                       + 2 * batch * kv_heads * seq * dim + sum(outputs))
              + 2 * 4 * batch * heads * seq)
    t_flops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def sdpa_backward_ms(q, k, v, do, scale, iters, causal=True):
    """F.scaled_dot_product_attention's backward alone, on its pinned
    backend, K/V repeated to q's heads: one forward keeps its graph, then
    each timed call is torch.autograd.grad of it (the library's dq, dk,
    dv)."""
    group = q.shape[1] // k.shape[1]
    qg = q.detach().clone().requires_grad_()
    kg = k.repeat_interleave(group, dim=1).requires_grad_()
    vg = v.repeat_interleave(group, dim=1).requires_grad_()
    with sdpa_kernel(SDPA_BACKENDS[q.dtype][0]):
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal, scale=scale)
        ms = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                 retain_graph=True), iters)
    del out
    return ms


def check_backward_shape(label, batch, heads, kv_heads, seq, dim, dtype,
                         card, iters, causal=True):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    q = randn(batch, heads, seq, dim)
    k = randn(batch, kv_heads, seq, dim)
    v = randn(batch, kv_heads, seq, dim)
    do = randn(batch, heads, seq, dim)
    scale = dim ** -0.5
    o, lse = flash_forward(q, k, v, causal=causal, sm_scale=scale)
    di = (o.float() * do.float()).sum(-1)
    kw = {"causal": causal, "sm_scale": scale}
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    torch.cuda.synchronize()
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    dq2 = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    torch.cuda.synchronize()
    bit_equal = {"dkv": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)),
                 "dq": bool(torch.equal(dq, dq2))}
    del dk2, dv2, dq2
    refs = flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    rtol, atol = KERNEL_TOL[dtype]
    errors, use = {}, {}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        err = (got.float() - ref.float()).abs()
        use[name] = limit_use(err, ref, rtol, atol)
        errors[name] = err.max().item()
        if not (use[name] <= 1 and torch.isfinite(got.float()).all()):
            raise RuntimeError(
                f"{name} of the backward kernels disagrees with the plain "
                f"version at {label}: max|err| {errors[name]} (rtol {rtol}, "
                f"atol {atol})")
    if not all(bit_equal.values()):
        raise RuntimeError(
            f"two launches of the backward kernels differ at {label}: "
            f"{bit_equal}")
    del refs
    dkv_ms = cuda_ms(
        lambda: flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw), iters)
    dq_ms = cuda_ms(
        lambda: flash_attention_bwd_dq(q, k, v, do, lse, di, **kw), iters)
    plain_ms = cuda_ms(
        lambda: flash_attention_backward_reference(q, k, v, o, lse, do,
                                                   **kw),
        max(1, iters // 3), warmup=1)
    library_ms = sdpa_backward_ms(q, k, v, do, scale, iters, causal)
    kv_elems = batch * kv_heads * seq * dim
    dkv_bound = backward_bound_ms(4, batch, heads, kv_heads, seq, dim,
                                  dtype, [kv_elems, kv_elems], causal)
    dq_bound = backward_bound_ms(3, batch, heads, kv_heads, seq, dim, dtype,
                                 [batch * heads * seq * dim], causal)
    common = {"shape": label, "causal": causal, "B": batch, "H": heads,
              "H_kv": kv_heads,
              "S": seq, "D": dim, "dtype": str(dtype).replace("torch.", ""),
              "rtol": rtol, "atol": atol, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library": f"sdpa[{SDPA_BACKENDS[dtype][1]}] backward alone",
              "plain_and_library_cover": "dq, dk and dv together",
              "card": card}
    rows = [
        {"phase": "kernel_bwd", "name": "flash_attention_bwd_dkv", **common,
         **kernel_design("flash_attention_bwd_dkv", dtype, dim),
         "max_abs_err": max(errors["dk"], errors["dv"]),
         "dk_max_abs_err": errors["dk"], "dv_max_abs_err": errors["dv"],
         "limit_use": max(use["dk"], use["dv"]),
         "bit_equal_launches": bit_equal["dkv"], "kernel_ms": dkv_ms,
         "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1]},
        {"phase": "kernel_bwd", "name": "flash_attention_bwd_dq", **common,
         **kernel_design("flash_attention_bwd_dq", dtype, dim),
         "max_abs_err": errors["dq"], "limit_use": use["dq"],
         "bit_equal_launches": bit_equal["dq"], "kernel_ms": dq_ms,
         "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
    ]
    for row in rows:
        emit(row)
    del q, k, v, do, o, lse, di, dq, dk, dv
    torch.cuda.empty_cache()
    return rows


def phase_kernel_bwd(card):
    shapes = [
        # the main path's call: the train step of llama-277M, batch 16
        ("main", 16, 16, 16, 1024, 128, torch.bfloat16, 5),
        ("b", 1, 16, 16, 8192, 128, torch.bfloat16, 3),
        ("c", 2, 8, 2, 1000, 64, torch.float32, 10),
        # GQA and a ragged last tile through the bf16 (wgmma) kernels
        ("d", 2, 8, 2, 1000, 128, torch.bfloat16, 10),
        # an odd length: lse and di rows that no 16-byte TMA row could
        # carry, a ragged 64-query and 128-key tile
        ("odd", 2, 8, 2, 997, 128, torch.bfloat16, 10),
    ]
    rows = []
    for s in shapes:
        rows += check_backward_shape(*s[:7], card, s[7])
    return rows


#: the ring phase's long-context shape (PERF.md section 4, (b)) and the
#: number of sequence blocks it is cut into
RING_SHAPE = (1, 16, 8192, 128)
RING_BLOCKS = 4


def ring_limit(ref, parts_abs, dtype):
    """The elementwise limit of a ring chain against an unsplit
    computation (or another chain): ``KERNEL_TOL``'s rtol on the
    reference, for the two sides' final roundings, plus the same rtol on
    ``parts_abs``, the sum over the chain's blocks of each block's
    magnitude (each block's output or gradient is rounded once to bf16
    before the float32 sum, and is at most one bf16 ulp off its plain
    counterpart, so the sum's error is at most 2^-7 of that), plus
    ``KERNEL_TOL``'s atol for elements near 0."""
    rtol, atol = KERNEL_TOL[dtype]
    return atol + rtol * (ref.float().abs() + parts_abs)


def fold_bound_ms(rows, dim, o_dtype):
    """Least time of one fold: acc (f32) read and written, o_blk read,
    lse_acc read and written and lse_blk read, over the memory rate (3
    FLOPs an element: far below the card's ratio)."""
    esize = torch.finfo(o_dtype).bits // 8
    return (rows * dim * (8 + esize) + rows * 12) / PEAK_BYTES * 1e3


def phase_ring_kernels(card):
    """The kernels as the ring runs them, on one card: rows without the
    causal mask, the 4-block chain of the long-context shape, the fold
    kernel against its plain version, and the ring's backward schedule.
    Returns (non-causal forward rows, non-causal backward rows, the fold
    row, the chain's launches)."""
    fwd_rows = [check_kernel_shape("ring_block", 1, 16, 16, 2048, 128,
                                   torch.bfloat16, card, 10, causal=False)]
    bwd_rows = check_backward_shape("ring_block", 1, 16, 16, 2048, 128,
                                    torch.bfloat16, card, 10, causal=False)

    batch, heads, seq, dim = RING_SHAPE
    dtype, n = torch.bfloat16, RING_BLOCKS
    width, scale = seq // n, dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def randn():
        return torch.randn(RING_SHAPE, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    q, k, v, do = randn(), randn(), randn(), randn()

    def block(x, j):
        return x[:, :, j * width:(j + 1) * width].contiguous()

    qb, kb, vb, dob = ([block(x, j) for j in range(n)] for x in (q, k, v, do))
    # the yardsticks first: their launches are not the chain's
    whole, whole_lse = flash_forward(q, k, v, causal=True, sm_scale=scale)
    whole_grads = flash_backward(q, k, v, whole, whole_lse, do, causal=True,
                                 sm_scale=scale)

    def chain(me, fold_block):
        """Query block ``me``'s ring steps; ``fold_block(k, v, acc, lse,
        causal)`` folds one visible block. Returns (out, lse, the sum of
        the blocks' |output|)."""
        acc = torch.zeros(qb[me].shape, dtype=torch.float32, device="cuda")
        lse = torch.full(qb[me].shape[:3], float("-inf"), device="cuda")
        parts = torch.zeros_like(acc)
        for _, src, causal in _schedule(me, n, True):
            if causal is not None:
                parts += fold_block(qb[me], kb[src], vb[src], acc, lse,
                                    causal).float().abs()
        return acc.to(dtype), lse, parts

    def kernel_block(qm, ks, vs, acc, lse, causal):
        out, lse_blk = flash_forward(qm, ks, vs, causal=causal,
                                     sm_scale=scale)
        attention_fold(acc, lse, out, lse_blk)
        return out

    def plain_block(qm, ks, vs, acc, lse, causal):
        out, lse_blk = flash_attention_reference(qm, ks, vs, causal=causal,
                                                 sm_scale=scale)
        attention_fold_reference(acc, lse, out, lse_blk)
        return out

    reset_launch_counts()
    kernel_chain = [chain(me, kernel_block) for me in range(n)]
    torch.cuda.synchronize()
    chain_launches = launch_counts()
    plain_chain = [chain(me, plain_block) for me in range(n)]
    use_whole, use_plain, err_whole, err_plain, lse_err = 0.0, 0.0, 0.0, 0.0, 0.0
    for me, ((out, lse, parts), (ref, ref_lse, ref_parts)) in enumerate(
            zip(kernel_chain, plain_chain)):
        want = block(whole, me)
        for got_ref, ref_parts_abs, name in ((want, parts, "whole"),
                                             (ref, ref_parts, "plain")):
            err = (out.float() - got_ref.float()).abs()
            use = (err / ring_limit(got_ref, torch.maximum(
                parts, ref_parts_abs), dtype)).max().item()
            if name == "whole":
                use_whole, err_whole = (max(use_whole, use),
                                        max(err_whole, err.max().item()))
            else:
                use_plain, err_plain = (max(use_plain, use),
                                        max(err_plain, err.max().item()))
        lse_err = max(lse_err, (lse - block(whole_lse, me)).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
        if not torch.isfinite(out.float()).all():
            raise RuntimeError(f"ring chain of block {me} not finite")
    if not (use_whole <= 1 and use_plain <= 1 and lse_err <= LSE_ATOL):
        raise RuntimeError(
            f"ring chain off: limit_use vs whole {use_whole}, vs plain "
            f"{use_plain}, lse max|err| {lse_err}")
    def port_chain():
        """The chains as the ring runs them: ``_block_attention`` on
        every visible block, no magnitudes kept."""
        for me in range(n):
            acc = torch.zeros(qb[me].shape, device="cuda")
            lse = torch.full(qb[me].shape[:3], float("-inf"), device="cuda")
            for _, src, causal in _schedule(me, n, True):
                if causal is not None:
                    _block_attention(qb[me], kb[src], vb[src], acc, lse,
                                     causal, scale)
            acc.to(dtype)

    chain_ms = cuda_ms(port_chain, 5)
    plain_chain_ms = cuda_ms(
        lambda: [chain(me, plain_block) for me in range(n)], 1, warmup=1)
    whole_ms = cuda_ms(lambda: flash_forward(q, k, v, causal=True,
                                             sm_scale=scale), 5)
    emit({"phase": "ring_chain", "shape": list(RING_SHAPE), "blocks": n,
          "dtype": "bfloat16", "launches": chain_launches,
          "max_abs_err_vs_whole": err_whole, "limit_use_vs_whole": use_whole,
          "max_abs_err_vs_plain": err_plain, "limit_use_vs_plain": use_plain,
          "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
          "limit": "atol + rtol * (|ref| + sum of |block outputs|), "
                   f"rtol {KERNEL_TOL[dtype][0]}, atol {KERNEL_TOL[dtype][1]}",
          "chain_ms": chain_ms, "plain_chain_ms": plain_chain_ms,
          "whole_sequence_flash_ms": whole_ms, "card": card})

    # the fold kernel against its plain version on identical inputs: a
    # past block folded into the diagonal's state, rows 0-63 of head 0
    # having seen nothing on either side (the guard's rows)
    diag, diag_lse = flash_forward(qb[1], kb[1], vb[1], causal=True,
                                   sm_scale=scale)
    past, past_lse = flash_forward(qb[1], kb[0], vb[0], causal=False,
                                   sm_scale=scale)
    acc0, lse0 = diag.float(), diag_lse.clone()
    acc0[:, 0, :64], lse0[:, 0, :64] = 0.0, float("-inf")
    past_lse[:, 0, :64] = float("-inf")
    got_acc, got_lse = attention_fold(acc0.clone(), lse0.clone(), past,
                                      past_lse)
    ref_acc, ref_lse = attention_fold_reference(acc0.clone(), lse0.clone(),
                                                past, past_lse)
    torch.cuda.synchronize()
    rtol, atol = KERNEL_TOL[torch.float32]
    fold_err = (got_acc - ref_acc).abs()
    fold_use = limit_use(fold_err, ref_acc, rtol, atol)
    seen = torch.isfinite(ref_lse)
    fold_lse_err = (got_lse[seen] - ref_lse[seen]).abs().max().item()
    guard_ok = bool((got_acc[:, 0, :64] == 0).all()
                    and torch.isneginf(got_lse[~seen]).all()
                    and int((~seen).sum()) == batch * 64)
    if not (fold_use <= 1 and guard_ok and fold_lse_err <= LSE_ATOL
            and torch.isfinite(got_acc).all()):
        raise RuntimeError(
            f"attention_fold off its plain version: limit_use {fold_use}, "
            f"guard rows zero {guard_ok}, lse err {fold_lse_err}")
    bit_equal = bool(torch.equal(got_acc, ref_acc))
    rows = batch * heads * width
    fold_ms = cuda_ms(lambda: attention_fold(acc0, lse0, past, past_lse), 50)
    fold_plain_ms = cuda_ms(
        lambda: attention_fold_reference(acc0, lse0, past, past_lse), 20)
    fold_row = {"phase": "ring_fold", "name": "attention_fold",
                "shape": "ring_block", "B": batch, "H": heads, "S": width,
                "D": dim, "o_dtype": "bfloat16", "max_abs_err":
                fold_err.max().item(), "rtol": rtol, "atol": atol,
                "limit_use": fold_use, "lse_max_abs_err": fold_lse_err,
                "bit_equal": bit_equal,
                "guard_rows_zero": guard_ok, "kernel_ms": fold_ms,
                "plain_ms": fold_plain_ms,
                "bound_ms": fold_bound_ms(rows, dim, dtype),
                "bound_by": "bytes", "library_ms": None,
                "library": "none: no single PyTorch call folds",
                "card": card}
    emit(fold_row)

    # the ring's backward schedule over the blocks, given the whole
    # sequence's output and lse, against the whole-sequence backward
    dq = [torch.zeros(x.shape, device="cuda") for x in qb]
    dk = [torch.zeros(x.shape, device="cuda") for x in kb]
    dv = [torch.zeros(x.shape, device="cuda") for x in vb]
    parts = {name: [torch.zeros_like(t) for t in ts]
             for name, ts in (("dq", dq), ("dk", dk), ("dv", dv))}

    def ring_backward(accumulate):
        for me in range(n):
            out_me, lse_me = block(whole, me), block(whole_lse, me)
            di = (out_me.float() * dob[me].float()).sum(-1)
            for _, src, causal in _schedule(me, n, True):
                if causal is None:
                    continue
                got = _block_backward(qb[me], kb[src], vb[src], out_me,
                                      lse_me, dob[me], di, causal, scale)
                if accumulate:
                    for name, acc, index, part in zip(
                            ("dq", "dk", "dv"), (dq, dk, dv),
                            (me, src, src), got):
                        acc[index] += part.float()
                        parts[name][index] += part.float().abs()

    ring_backward(True)
    torch.cuda.synchronize()
    bwd_use, bwd_err = 0.0, 0.0
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), whole_grads):
        for j in range(n):
            want = block(ref, j)
            err = (got[j].to(dtype).float() - want.float()).abs()
            bwd_err = max(bwd_err, err.max().item())
            bwd_use = max(bwd_use, (err / ring_limit(
                want, parts[name][j], dtype)).max().item())
            if not torch.isfinite(got[j]).all():
                raise RuntimeError(f"ring backward {name} not finite")
    if not bwd_use <= 1:
        raise RuntimeError(f"ring backward off the whole-sequence backward: "
                           f"limit_use {bwd_use}, max|err| {bwd_err}")
    emit({"phase": "ring_backward", "shape": list(RING_SHAPE), "blocks": n,
          "max_abs_err": bwd_err, "limit_use": bwd_use,
          "ring_ms": cuda_ms(lambda: ring_backward(False), 3),
          "whole_sequence_flash_backward_ms": cuda_ms(
              lambda: flash_backward(q, k, v, whole, whole_lse, do,
                                     causal=True, sm_scale=scale), 3),
          "card": card})
    del q, k, v, do, qb, kb, vb, dob, whole, whole_grads, dq, dk, dv, parts
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows, fold_row, chain_launches


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls captured
    in one CUDA graph and replayed ``replays`` times, CUDA events: the
    launches follow each other with no host work between them, as in
    the replayed decode step."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def int8_bound_ms(m, k, n, dtype):
    """Least time of one int8-weight matmul: the codes, x, the output
    and the scales moved once over the memory rate, against the product's
    2*M*K*N FLOPs over x's dtype's peak."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = (k * n + esize * (m * k + m * n) + 4 * n) / PEAK_BYTES
    t_flops = 2 * m * k * n / PEAK_FLOPS[dtype]
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def int8_limit(ref, pre_scale, dtype):
    """The elementwise limit of the kernel against its plain version.
    Both round twice: the f32 sum to x's dtype, then its product with the
    rounded scale. The sums differ in order, so the first rounding may
    land one ulp apart (at most rtol of the unscaled product, carried
    through the scale: rtol * |round(x @ q) * s|), and the second adds
    at most rtol * |ref|: ``KERNEL_TOL``'s rtol once for each rounding,
    plus its atol. A single rtol * |ref| is exceeded by outputs whose two
    roundings both fall apart (2 ulps), which the card shows."""
    rtol, atol = KERNEL_TOL[dtype]
    return atol + rtol * (ref.float().abs() + pre_scale)


#: (label, M, K, N, dtype, iters) of the int8 matmul phase: every (K, N)
#: of llama-277M at decode (M 8 at the bench shape, 2 in the decode
#: contract) and prefill (M 512 = 8 x 64), phase 9's tp = 2 shards at
#: its M of 4 rows a rank, a ragged shape and one f32 row
INT8_SHAPES = [
    ("decode_qkvo_lm_head", 8, 2048, 2048, torch.bfloat16, 200),
    ("decode_gate_up", 8, 2048, 8192, torch.bfloat16, 200),
    ("decode_down", 8, 8192, 2048, torch.bfloat16, 200),
    ("contract_qkvo_lm_head", 2, 2048, 2048, torch.bfloat16, 200),
    ("contract_gate_up", 2, 2048, 8192, torch.bfloat16, 200),
    ("contract_down", 2, 8192, 2048, torch.bfloat16, 200),
    ("prefill_qkvo_lm_head", 512, 2048, 2048, torch.bfloat16, 20),
    ("prefill_gate_up", 512, 2048, 8192, torch.bfloat16, 10),
    ("prefill_down", 512, 8192, 2048, torch.bfloat16, 10),
    ("tp2_qkv_lm_head", 4, 2048, 1024, torch.bfloat16, 200),
    ("tp2_o", 4, 1024, 2048, torch.bfloat16, 200),
    ("tp2_gate_up", 4, 2048, 4096, torch.bfloat16, 200),
    ("tp2_down", 4, 4096, 2048, torch.bfloat16, 200),
    ("ragged", 3, 2000, 1000, torch.bfloat16, 200),
    ("decode_qkvo_f32", 8, 2048, 2048, torch.float32, 200),
]


def check_int8_shape(label, m, k, n, dtype, iters, card):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    # a weight at the model's init scale, quantized as quantize_params_int8
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    s = torch.clamp_min(w.abs().amax(dim=0), 1e-8) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    del w
    got = int8_matmul(x, q, s)
    again = int8_matmul(x, q, s)
    torch.cuda.synchronize()
    ref = int8_matmul_reference(x, q, s)
    pre_scale = (x @ q.to(dtype)).float().abs() * s.to(dtype).float()
    err = (got.float() - ref.float()).abs()
    use = (err / int8_limit(ref, pre_scale, dtype)).max().item()
    bit_equal = bool(torch.equal(got, again))
    if not (use <= 1 and bit_equal and got.shape == (m, n)
            and torch.isfinite(got.float()).all()):
        raise RuntimeError(
            f"int8_matmul off its plain version at {label}: limit_use "
            f"{use}, max|err| {err.max().item()}, bit-equal launches "
            f"{bit_equal}")
    row = {"phase": "int8_matmul", "name": "int8_matmul", "shape": label,
           "M": m, "K": k, "N": n, "dtype": str(dtype).replace("torch.", ""),
           "split_plan": list(split_plan(
               m, n, k, torch.cuda.get_device_properties(0)
               .multi_processor_count)),
           "max_abs_err": err.max().item(),
           "limit": "atol + rtol * (|ref| + |round(x @ q) * s|)",
           "rtol": KERNEL_TOL[dtype][0], "atol": KERNEL_TOL[dtype][1],
           "limit_use": use,
           "bit_equal_to_plain_share": (got == ref).float().mean().item(),
           "bit_equal_launches": bit_equal}
    del got, again, ref, pre_scale, err
    row["kernel_ms"] = graph_ms(lambda: int8_matmul(x, q, s), iters)
    row["kernel_eager_ms"] = cuda_ms(lambda: int8_matmul(x, q, s), iters)
    row["plain_ms"] = graph_ms(lambda: int8_matmul_reference(x, q, s),
                               iters)
    if dtype == torch.bfloat16:
        # the library's int8-weight product takes the codes as (N, K) and
        # the scales in x's dtype: both made outside the timing
        q_nk, s_x = q.t().contiguous(), s.to(dtype)
        row["library"] = "torch._weight_int8pack_mm"
        row["library_ms"] = graph_ms(
            lambda: torch._weight_int8pack_mm(x, q_nk, s_x),
            max(2, iters // 10))
        del q_nk
    else:
        row["library"] = "none: torch._weight_int8pack_mm takes no f32"
        row["library_ms"] = None
    # cuBLAS on a bf16 copy of the codes made outside the timing: the
    # product alone, without the conversion the plain version pays
    w_x = q.to(dtype)
    row["cublas_on_converted_copy_ms"] = graph_ms(lambda: x @ w_x, iters)
    row["bound_ms"], row["bound_by"] = int8_bound_ms(m, k, n, dtype)
    row["card"] = card
    emit(row)
    del x, q, s, w_x
    torch.cuda.empty_cache()
    return row


def phase_int8_matmul(card):
    return [check_int8_shape(*shape, card) for shape in INT8_SHAPES]


def cast_params(params, dtype):
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype)


def rel_err(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


#: bf16 logits: the two attention paths (or the batch and the stepwise
#: cache path) round to bf16 at different points through 4 layers, and
#: bf16 keeps 8 significant bits; a wrong mask, position or cache slot
#: moves the logits by O(1) of their scale, far beyond 5e-2.
BF16_LOGITS_REL_TOL = 5e-2
#: f32 logits: the tolerance of tests/test_llama.py:192 and
#: tests/test_llama_decode.py:69 (rtol = atol = 1e-4, elementwise).
F32_TOL = 1e-4


def phase_forward(params, params32, card):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, CONFIG_277M.vocab, (2, 1024), generator=gen,
                           device="cuda")
    flash_cfg = dataclasses.replace(CONFIG_277M, attention_impl="flash")
    result = {"phase": "forward", "batch": 2, "seq": 1024, "card": card}
    for label, p, cfg_dtype in (("bf16", params, torch.bfloat16),
                                ("f32", params32, torch.float32)):
        before = flash_attention.launches
        with torch.no_grad():
            flash = forward(p, tokens, flash_cfg)
            grew = flash_attention.launches - before
            xla = forward(p, tokens, CONFIG_277M)
        if grew != CONFIG_277M.n_layers:
            raise RuntimeError(
                f"forward(flash) launched the kernel {grew} times, "
                f"expected n_layers={CONFIG_277M.n_layers}")
        if flash.shape != (2, 1024, CONFIG_277M.vocab) \
                or flash.dtype != cfg_dtype \
                or not torch.isfinite(flash.float()).all():
            raise RuntimeError(f"forward(flash) {label} output malformed")
        err = (flash.float() - xla.float()).abs().max().item()
        if cfg_dtype == torch.bfloat16:
            rel = rel_err(flash, xla)
            ok = rel <= BF16_LOGITS_REL_TOL
            result[label] = {"max_abs_err": err, "rel_err": rel,
                             "rel_tol": BF16_LOGITS_REL_TOL}
        else:
            ok = torch.allclose(flash, xla, rtol=F32_TOL, atol=F32_TOL)
            result[label] = {"max_abs_err": err, "rtol": F32_TOL,
                             "atol": F32_TOL}
        result[label]["launches"] = grew
        if not ok:
            raise RuntimeError(
                f"forward flash vs xla ({label}) out of tolerance: "
                f"{result[label]}")
    emit(result)


def stepwise_logits(params, tokens, dtype):
    batch, seq = tokens.shape
    cache = init_kv_cache(CONFIG_277M, batch, seq, dtype, device="cuda")
    outs = []
    for pos in range(seq):
        logits, cache = forward_with_cache(params, tokens[:, pos:pos + 1],
                                           cache, pos, CONFIG_277M)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


def phase_decode(params, params32, card):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, CONFIG_277M.vocab, (2, 64), generator=gen,
                           device="cuda")
    result = {"phase": "decode_contract", "batch": 2, "seq": 64,
              "card": card}
    with torch.no_grad():
        full = forward(params, tokens, CONFIG_277M)
        step = stepwise_logits(params, tokens, torch.bfloat16)
        rel = rel_err(step, full)
        full32 = forward(params32, tokens, CONFIG_277M)
        step32 = stepwise_logits(params32, tokens, torch.float32)
    ok32 = torch.allclose(step32, full32, rtol=F32_TOL, atol=F32_TOL)
    result["stepwise_vs_forward"] = {
        "bf16_rel_err": rel, "bf16_rel_tol": BF16_LOGITS_REL_TOL,
        "f32_max_abs_err": (step32 - full32).abs().max().item(),
        "f32_rtol_atol": F32_TOL}
    if rel > BF16_LOGITS_REL_TOL or not ok32:
        raise RuntimeError(f"decode contract broken: {result}")

    prompt = torch.randint(0, CONFIG_277M.vocab, (8, 64), generator=gen,
                           device="cuda")
    qparams = quantize_params_int8(params)
    for label, p, kw in (("bf16", params, {}),
                         ("int8_weights_int8_kv", qparams,
                          {"quantize_kv": True})):
        host = generate(p, prompt, CONFIG_277M, 32,
                        param_dtype=torch.bfloat16, **kw)
        dev = generate_on_device(p, prompt, CONFIG_277M, 32,
                                 param_dtype=torch.bfloat16, **kw)
        equal = bool(torch.equal(host, dev))
        valid = bool(((dev >= 0) & (dev < CONFIG_277M.vocab)).all())
        result[f"host_equals_device_{label}"] = equal
        result[f"device_loop_{label}"] = dict(generate_on_device.last_call)
        if not (equal and valid and dev.shape == (8, 96)):
            raise RuntimeError(
                f"host and device decode loops differ ({label})")
        expect_graph(generate_on_device.last_call, 32, label)
    result["sampled"] = sampled_contract(qparams, prompt)
    emit(result)
    return qparams


def expect_graph(run, new_tokens, what):
    """The device loop on the card replays its graph once a token after
    prefill, the first pick and the eager warm-up step."""
    if run["eager_steps"] != 1 or run["graph_launches"] != new_tokens - 2:
        raise RuntimeError(f"{what}: the device loop ran {run}, expected "
                           f"1 eager step and {new_tokens - 2} graph "
                           "launches")


#: the decode contract's sampling settings
SAMPLING = {"temperature": 1.0, "top_k": 50, "top_p": 0.9,
            "return_logprobs": True}


def sampled_contract(qparams, prompt):
    """Sampled decode, int8 weights + int8 KV, with eos and logprobs: the
    graph-replayed device loop against the host loop from equally seeded
    generators, tokens and logprobs bit for bit. The eos is a token that
    row 0 draws at its fifth step without one, so that row pads."""
    def run(fn, **kw):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        return fn(qparams, prompt, CONFIG_277M, 32,
                  param_dtype=torch.bfloat16, quantize_kv=True,
                  generator=gen, **SAMPLING, **kw)

    free, _ = run(generate)
    eos = int(free[0, 64 + 4])
    host, host_lp = run(generate, eos_id=eos)
    dev, dev_lp = run(generate_on_device, eos_id=eos)
    graph = dict(generate_on_device.last_call)
    out = {**SAMPLING, "eos_id": eos,
           "tokens_equal": bool(torch.equal(host, dev)),
           "logprobs_equal": bool(torch.equal(host_lp, dev_lp)),
           "row0_padded_from": 64 + 4,
           "rows_that_hit_eos": int((dev[:, 64:] == eos).any(dim=1).sum()),
           "device_loop": graph}
    if not (out["tokens_equal"] and out["logprobs_equal"]
            and bool((dev[0, 64 + 4:] == eos).all())
            and torch.isfinite(dev_lp).all()):
        raise RuntimeError(f"sampled decode: host and device loops differ "
                           f"or row 0 did not pad: {out}")
    expect_graph(graph, 32, "sampled decode")
    return out


def phase_serving(params, qparams, card):
    server = DecodeServer(CONFIG_277M, params,
                          ServingEndpoint("llama-277m-smoke"),
                          max_new_tokens=64)
    summary = run_demo(server, n_requests=8, drain_after=4, workers=3,
                       batch=8, prompt_len=64, seed=SEED + 3)
    if summary["dropped"] != 0 or summary["parked"] < 1:
        raise RuntimeError(f"drain contract broken: {summary}")
    served = len(summary["served_request_ids"])
    lat = summary["request_seconds"]
    emit({"phase": "serving", "requests": 8, "batch": 8, "prompt": 64,
          "new_tokens": 64, "drain_after": 4, "workers": 3,
          "completed": summary["completed"], "served": served,
          "parked": summary["parked"], "dropped": summary["dropped"],
          "decode_tok_per_s": served * 8 * 64 / summary["burst_seconds"],
          "latency_p50_s": statistics.median(lat),
          "latency_max_s": max(lat), "card": card})

    # the bench's decode cell: batch 8, prompt 64, 960 new, context 1024
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    prompt = torch.randint(0, CONFIG_277M.vocab, (8, 64), generator=gen,
                           device="cuda")
    cells = {}
    for label, p, kw in (("bf16", params, {}),
                         ("int8_weights_int8_kv", qparams,
                          {"quantize_kv": True})):
        cell = {}
        # the graph-replayed device loop, then the host loop as the eager
        # yardstick, each warmed by a short call
        for loop, fn in (("graph", generate_on_device), ("host", generate)):
            fn(p, prompt, CONFIG_277M, 8, param_dtype=torch.bfloat16, **kw)
            start = time.perf_counter()
            out = fn(p, prompt, CONFIG_277M, 960,
                     param_dtype=torch.bfloat16, **kw).cpu()
            seconds = time.perf_counter() - start
            if out.shape != (8, 1024) or not bool(
                    ((out >= 0) & (out < CONFIG_277M.vocab)).all()):
                raise RuntimeError(
                    f"bench-shape decode malformed ({label}, {loop})")
            cell[loop] = {"seconds": seconds, "tok_per_s": 8 * 960 / seconds}
            if loop == "graph":
                run = dict(generate_on_device.last_call)
                expect_graph(run, 960, f"bench-shape decode ({label})")
                cell[loop]["device_loop"] = run
                tokens = out
            elif not torch.equal(out, tokens):
                raise RuntimeError(f"bench-shape decode: host and graph "
                                   f"loops differ ({label})")
            cell[loop]["profile_64_steps"] = profile_decode(fn, p, prompt,
                                                            kw)
        cell["graph_over_host"] = (cell["graph"]["tok_per_s"]
                                   / cell["host"]["tok_per_s"])
        cells[label] = cell
    emit({"phase": "decode_bench_shape", "batch": 8, "prompt": 64,
          "new_tokens": 960, "cells": cells, "card": card})


def profile_device(fn, top: int = 6):
    """Device-busy share and the top kernels by device time over one
    call of ``fn`` (which ends by waiting for the device), from
    torch.profiler (the profiler's own cost is in the wall time, so the
    share is a lower bound). None where the profiler records no device
    time on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - start) * 1e6

    def device_us(event):
        return getattr(event, "device_time_total",
                       getattr(event, "cuda_time_total", 0.0))

    # kernel, memcpy and memset rows only: a CPU op's row repeats the
    # device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in events)
    if busy_us == 0:
        return None
    rows = sorted(events, key=device_us, reverse=True)[:top]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top": [{"name": e.key[:60], "calls": e.count,
                     "device_ms": device_us(e) / 1e3} for e in rows]}


def profile_decode(fn, params, prompt, kw):
    """profile_device over a 64-token decode by ``fn`` (the device loop
    or the host loop)."""
    return profile_device(lambda: fn(
        params, prompt, CONFIG_277M, 64, param_dtype=torch.bfloat16,
        **kw).cpu())


#: every kernel's wrapper, by the name its launch counter reports under
KERNELS = WRAPPERS
#: the kernels the training path runs, and the ring's
FLASH_KERNELS = ["flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"]
RING_KERNELS = FLASH_KERNELS + ["attention_fold"]


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> "dict[str, int]":
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


#: the train step's shape (bench.py:530-533): batch 16, seq 1024
TRAIN_BATCH = 16
TRAIN_STEPS = 6
#: f32 gradients against the xla path: rtol = atol = 1e-4, as the f32
#: logits; remat against no remat in f32: tests/test_llama.py:148's
#: rtol 1e-5, atol 1e-6 (the same kernels recompute the same values)
REMAT_RTOL, REMAT_ATOL = 1e-5, 1e-6


def expect_launches(delta, fwd, bwd, what, fold=0, int8=0):
    want = {"flash_attention_fwd": fwd, "flash_attention_bwd_dkv": bwd,
            "flash_attention_bwd_dq": bwd, "attention_fold": fold,
            "int8_matmul": int8}
    if delta != want:
        raise RuntimeError(f"{what} launched {delta}, expected {want}")


def grads_with_launches(params, tokens, config):
    """(loss, grads, launches per kernel) of the loss's gradients."""
    before = launch_counts()
    loss, grads = value_and_grad(next_token_loss, params, tokens, config)
    torch.cuda.synchronize()
    after = launch_counts()
    return loss, grads, {k: after[k] - before[k] for k in after}


def compare_grads(label, got, want, loss_got, loss_want, *, rel_tol=None,
                  rtol=None, atol=None):
    """Hold every gradient leaf (and the loss) to the reference: by the
    max-normalised error ``rel_tol`` in bf16, elementwise rtol/atol in
    f32. Returns the worst error seen."""
    worst = 0.0
    pairs = [(torch.stack([loss_got]), torch.stack([loss_want]))]
    pairs += list(zip(tree_leaves(got), tree_leaves(want)))
    for g, w in pairs:
        if not torch.isfinite(g.float()).all():
            raise RuntimeError(f"{label}: non-finite gradient")
        if rel_tol is not None:
            err = rel_err(g, w)
            ok = err <= rel_tol
        else:
            err = (g.float() - w.float()).abs().max().item()
            ok = torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol)
        worst = max(worst, err)
        if not ok:
            raise RuntimeError(
                f"{label} out of tolerance: {err} (shape "
                f"{tuple(g.shape)}, rel_tol {rel_tol}, rtol {rtol}, "
                f"atol {atol})")
    return worst


def phase_train(params, card):
    """make_train_step at llama-277M, flash, batch 16, seq 1024, bf16:
    TRAIN_STEPS steps on make_token_batch, then the step's gradients
    against the xla path and against remat, in bf16 and in f32."""
    config = dataclasses.replace(CONFIG_277M, attention_impl="flash")
    n_layers = config.n_layers
    optimizer, step = make_train_step(config)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    batches = [make_token_batch(i, config, TRAIN_BATCH)
               for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    start = time.perf_counter()
    state, first = step(state, batches[0])
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - start) * 1e3
    one = launch_counts()
    expect_launches({k: one[k] - before[k] for k in one}, n_layers,
                    n_layers, "one train step")
    losses = [first]
    start = time.perf_counter()
    for tokens in batches[1:]:
        state, loss = step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3 / (TRAIN_STEPS - 1)
    peak_bytes = torch.cuda.max_memory_allocated()
    after = launch_counts()
    expect_launches({k: after[k] - before[k] for k in after},
                    n_layers * TRAIN_STEPS, n_layers * TRAIN_STEPS,
                    f"{TRAIN_STEPS} train steps")
    losses = [float(x) for x in losses]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train losses not finite and falling: {losses}")
    if int(state["step"]) != TRAIN_STEPS:
        raise RuntimeError(f"state step {int(state['step'])}")
    profile = profile_device(lambda: step(state, batches[0])[1].item(),
                             top=10)

    # the step's gradients: flash against xla and against remat, bf16 at
    # the train shape, f32 at batch 2
    result = {"phase": "train", "batch": TRAIN_BATCH,
              "seq": config.seq_len, "steps": TRAIN_STEPS, "losses": losses,
              "first_step_ms": first_ms, "step_ms": step_ms,
              "steps_behind_one_sync": TRAIN_STEPS - 1,
              "tokens_per_s": TRAIN_BATCH * config.seq_len / step_ms * 1e3,
              "max_memory_allocated_bytes": peak_bytes,
              "profile_1_step": profile, "card": card}
    tokens = batches[0]
    for label, p, toks in (("bf16", params, tokens),
                           ("f32", cast_params(params, torch.float32),
                            tokens[:2])):
        flash_loss, flash_g, flash_n = grads_with_launches(p, toks, config)
        expect_launches(flash_n, n_layers, n_layers, f"{label} flash grads")
        xla_loss, xla_g, xla_n = grads_with_launches(p, toks, CONFIG_277M)
        expect_launches(xla_n, 0, 0, f"{label} xla grads")
        if label == "bf16":
            vs_xla = compare_grads("bf16 flash vs xla grads", flash_g, xla_g,
                                   flash_loss, xla_loss,
                                   rel_tol=BF16_LOGITS_REL_TOL)
            tol = {"rel_tol": BF16_LOGITS_REL_TOL}
        else:
            vs_xla = compare_grads("f32 flash vs xla grads", flash_g, xla_g,
                                   flash_loss, xla_loss, rtol=F32_TOL,
                                   atol=F32_TOL)
            tol = {"rtol": F32_TOL, "atol": F32_TOL}
        del xla_g
        remat = dataclasses.replace(config, remat=True)
        remat_loss, remat_g, remat_n = grads_with_launches(p, toks, remat)
        expect_launches(remat_n, 2 * n_layers, n_layers,
                        f"{label} remat grads")
        bit_equal = bool(torch.equal(remat_loss, flash_loss) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(remat_g),
                                              tree_leaves(flash_g))))
        if label == "bf16":
            vs_remat = compare_grads("bf16 remat grads", remat_g, flash_g,
                                     remat_loss, flash_loss,
                                     rel_tol=BF16_LOGITS_REL_TOL)
        else:
            vs_remat = compare_grads("f32 remat grads", remat_g, flash_g,
                                     remat_loss, flash_loss,
                                     rtol=REMAT_RTOL, atol=REMAT_ATOL)
        result[label] = {
            "batch": toks.shape[0], "flash_loss": float(flash_loss),
            "xla_loss": float(xla_loss), "flash_vs_xla_max_err": vs_xla,
            **tol, "remat_vs_plain_max_err": vs_remat,
            "remat_bit_equal": bit_equal,
            "launches_flash": flash_n, "launches_remat": remat_n}
        del flash_g, remat_g, p
    emit(result)
    torch.cuda.empty_cache()
    return state, optimizer, step, losses


def phase_checkpoint(state, optimizer, step, card):
    """__graft_entry__.py:159-217 with the port's manager and gate: the
    gate is closed on an empty root and opens on the committed save; a
    state from another seed restored from it gives the uninterrupted
    run's next loss bit for bit."""
    config = dataclasses.replace(CONFIG_277M, attention_impl="flash")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                            dir=os.path.join(ROOT, "build"))
    try:
        gate = CheckpointDurabilityGate(root)
        if gate.check():
            raise RuntimeError("checkpoint gate open on an empty root")
        manager = make_checkpoint_manager(root)
        done = int(state["step"])
        start = time.perf_counter()
        manager.save(done, state)
        save_s = time.perf_counter() - start
        if not gate.check():
            raise RuntimeError("checkpoint gate closed after a committed "
                               "save")
        if CheckpointDurabilityGate(root, min_step=done + 1).check():
            raise RuntimeError("checkpoint gate open below min_step")
        tokens = make_token_batch(done, config, TRAIN_BATCH)
        _, loss_uninterrupted = step(state, tokens)
        fresh_params = init_llama_params(config, param_dtype=torch.bfloat16,
                                         seed=SEED + 7)
        fresh = {"params": fresh_params,
                 "opt": optimizer.init(fresh_params),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        start = time.perf_counter()
        restored, start_step = restore_state(manager, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - start
        if start_step != done:
            raise RuntimeError(f"resume picked step {start_step}, "
                               f"wanted {done}")
        _, loss_resumed = step(restored, tokens)
        if not torch.equal(loss_uninterrupted, loss_resumed):
            raise RuntimeError(
                f"resumed step diverged: {float(loss_resumed)!r} != "
                f"{float(loss_uninterrupted)!r}")
        saved_bytes = sum(os.path.getsize(os.path.join(d, f))
                          for d, _, files in os.walk(root) for f in files)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "checkpoint", "step": done, "saved_bytes": saved_bytes,
          "save_s": save_s, "restore_s": restore_s,
          "gate_closed_before_save": True, "gate_open_after_save": True,
          "resumed_loss": float(loss_resumed),
          "resumed_loss_bit_equal": True, "card": card})


#: the multichip phase's train steps, and the tolerance of its losses
#: against phase 7's first steps on the same state and batches at one card
MULTI_STEPS = 3
MULTI_LOSS_TOL = 1e-3
#: the multichip decode stage's new tokens a loop
MULTI_NEW_TOKENS = 16
#: the one-card probe: tests/test_health.py's tolerance of the JAX probe
PROBE_ATOL = 1e-2


def multichip_shapes(n) -> "multichip.ParallelShapes":
    """Phase 9's pipeline and moe stages at llama-277M's widths (d_model
    2048, hidden 8192) on n cards: 8 microbatches of 2,048 tokens, and 16
    x 1024 tokens for the experts, both in f32 (TF32 off) so that the dry
    run's 1e-4 holds; and the ring Llama itself."""
    return multichip.ParallelShapes(
        d_model=2048, d_hidden=8192, microbatches=(8, 2048),
        tokens_per_rank=TRAIN_BATCH * 1024 // n,
        ring_llama=dataclasses.replace(CONFIG_277M, attention_impl="ring"))


def phase_multichip(card, train_losses=None):
    """The multi-device slice on every visible card, one NCCL rank each
    (``multichip.run_stages`` at llama-277M width): one line per stage.
    ``train_losses``: phase 7's, which a one-card run's losses (of the
    dp x tp and of the ring Llama) must match within MULTI_LOSS_TOL.
    Returns rank 0's kernel launches of stages 1-4 and of the ring
    stage."""
    fn, args = multichip.entry()
    out = fn(*args)
    probe_err = (out - (math.tanh(0.5) + 0.25)).abs().max().item()
    emit({"phase": "multichip_probe", "single_chip_max_abs_err": probe_err,
          "atol": PROBE_ATOL, "card": card})
    if not probe_err <= PROBE_ATOL:
        raise RuntimeError(f"single-chip probe off by {probe_err}")

    n = torch.cuda.device_count()
    dp, tp = dp_tp_split(n)
    config = dataclasses.replace(
        CONFIG_277M, attention_impl="flash" if tp == 1 else "xla")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_multichip_",
                                dir=os.path.join(ROOT, "build"))
    stages = functools.partial(
        multichip.run_stages, param_dtype=torch.bfloat16,
        batch_per_shard=TRAIN_BATCH // dp, train_steps=MULTI_STEPS,
        prompt_len=64, new_tokens=MULTI_NEW_TOKENS, decode_rows=8,
        payload_mib=16,
        rounds=8, shapes=multichip_shapes(n))
    start = time.perf_counter()
    try:
        ranks = run_ranks(stages, n, config, ckpt_dir, device="cuda",
                          timeout=600.0)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall_s = time.perf_counter() - start
    first = ranks[0]
    common = {"n": n, "dp": dp, "tp": tp, "card": card}

    rings = first["fabric"]
    emit({"phase": "multichip_fabric", **common,
          "rings": len(rings), "shifts": [r["shift"] for r in rings],
          "max_abs_err": max(r["max_abs_error"] for r in rings),
          "latency_ms": [r["latency_s"] * 1e3 for r in rings]})
    bw = first.get("bandwidth")
    emit({"phase": "multichip_bandwidth", **common,
          **({"gbytes_per_s": bw["gbytes_per_s"],
              "bytes_per_hop": bw["bytes_per_hop"], "rounds": bw["rounds"],
              "latency_ms": bw["latency_s"] * 1e3} if bw else
             {"gbytes_per_s": None,
              "not_run": "one card: no fabric to time"})})

    launches = first["launches"]
    # flash at tp=1: each kernel once a layer a step, the train stage's
    # steps and the checkpoint stage's two; xla otherwise. The int8
    # decode's two loops: a forward for each new token (prefill and the
    # steps), seven int8 products a layer and the lm_head's each
    per_kernel = (config.n_layers * (MULTI_STEPS + 2)
                  if config.attention_impl == "flash" else 0)
    int8 = 2 * MULTI_NEW_TOKENS * (7 * config.n_layers + 1)
    for rank in ranks:
        expect_launches(rank["launches"], per_kernel, per_kernel,
                        f"multichip rank path at tp={tp}", int8=int8)
        if rank["losses"] != first["losses"]:
            raise RuntimeError("ranks disagree on the losses")
    train = {"phase": "multichip_train", **common,
             "attention_impl": config.attention_impl,
             "batch": TRAIN_BATCH, "seq": config.seq_len,
             "steps": MULTI_STEPS, "step_ms": first["step_ms"],
             "losses": first["losses"], "launches": launches,
             "wall_s_all_stages": wall_s}
    if n == 1 and train_losses is not None:
        ref = train_losses[:MULTI_STEPS]
        diff = max(abs(a - b) for a, b in zip(first["losses"], ref))
        train.update({"phase7_losses": ref, "max_abs_diff_vs_phase7": diff,
                      "tol": MULTI_LOSS_TOL,
                      "bit_equal_to_phase7": first["losses"] == ref})
        if not diff <= MULTI_LOSS_TOL:
            raise RuntimeError(f"multichip losses {first['losses']} off "
                               f"phase 7's {ref} by {diff}")
    emit(train)
    emit({"phase": "multichip_decode", **common, "batch": 8, "prompt": 64,
          "new_tokens": MULTI_NEW_TOKENS,
          "int8_matmul_launches": launches["int8_matmul"],
          "bf16_host_equals_device": True,
          "int8_weights_int8_kv_host_equals_device": True,
          "tokens_equal_on_every_rank": all(
              (r["decode_plain"] == first["decode_plain"]).all()
              for r in ranks)})
    emit({"phase": "multichip_checkpoint", **common,
          "saved_bytes": first["saved_bytes"], "save_s": first["save_s"],
          "restore_s": first["restore_s"],
          "resumed_loss": first["resumed_loss"],
          "gate_closed_before_save": True, "gate_open_after_save": True,
          "resumed_loss_bit_equal": True})

    # ring, pipeline, moe: every rank checked its own against its
    # reference; rank 0's numbers, every rank's launches
    ring = first["ring"]
    llama = ring["llama"]
    for rank in ranks:
        idle = [k for k in RING_KERNELS if rank["launches_ring"][k] < 1]
        if idle:
            raise RuntimeError(f"the ring stage never launched {idle}")
        if rank["ring"]["llama"]["losses"] != llama["losses"]:
            raise RuntimeError("ranks disagree on the ring Llama's losses")
    if n == 1 and train_losses is not None:
        ref = train_losses[:MULTI_STEPS]
        diff = max(abs(a - b) for a, b in zip(llama["losses"], ref))
        llama.update({"phase7_losses": ref, "max_abs_diff_vs_phase7": diff,
                      "tol": MULTI_LOSS_TOL,
                      "bit_equal_to_phase7": llama["losses"] == ref})
        if not diff <= MULTI_LOSS_TOL:
            raise RuntimeError(f"ring Llama losses {llama['losses']} off "
                               f"phase 7's {ref} by {diff}")
    llama["logits_rel_err_max_over_ranks"] = max(
        r["ring"]["llama"]["logits_rel_err"] for r in ranks)
    llama["logits_bit_equal_on_every_rank"] = all(
        r["ring"]["llama"]["logits_bit_equal_to_flash"] for r in ranks)
    emit({"phase": "multichip_ring", **common, "sp": n,
          "attention": {k: ring[k] for k in ("shape", "max_abs_err", "tol",
                                              "ms")},
          "llama": llama, "launches": first["launches_ring"]})
    emit({"phase": "multichip_pipeline", **common, **first["pipeline"],
          "dtype": "float32"})
    emit({"phase": "multichip_moe", **common, **first["moe"],
          "dtype": "float32"})
    return launches, first["launches_ring"]


def kernel_entry(name, source, replaces, launches, rows, shape, card):
    """The kernels line's entry; its times and bound are those of the
    first row, the shape that the most launches of the main paths had."""
    main_row = rows[0]
    return {
        "name": name, "route": "cuda",
        "source": f"tpu_operator_libs_torch/csrc/{source}",
        "replaces": replaces, "launches": sum(launches.values()),
        "launches_by_path": launches, "ok": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": main_row["library"], "design": main_row["design"],
        "shape": shape,
        "shapes": [{k: r[k] for k in ("shape", "causal", "B", "H", "H_kv",
                                      "S", "D", "dtype", "design",
                                      "max_abs_err",
                                      "limit_use", "kernel_ms", "plain_ms",
                                      "library", "library_ms", "bound_ms",
                                      "bound_by")} for r in rows],
        "card": card}


def int8_entry(rows, serving, multi, card):
    """The kernels line's int8_matmul entry; its times and bound are the
    bench shape's decode of wq/wk/wv/wo and the lm_head, (8, 2048, 2048),
    the product most launched on the serving path."""
    main_row = rows[0]
    return {
        "name": "int8_matmul", "route": "cuda",
        "source": "tpu_operator_libs_torch/csrc/int8_matmul.cu",
        "replaces": "tpu_operator_libs/examples/llama_decode.py:135-143 "
                    "(_mm, fused by XLA; no pallas_call)",
        "launches": serving + multi,
        "launches_by_path": {"serving": serving, "multichip": multi},
        "launches_counted": "eager calls plus, for a replayed graph, the "
                            "launches recorded at capture times the replays",
        "ok": True, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "library": main_row["library"],
        "design": "CUDA-core FMA over 16-byte int8 loads, split-K with a "
                  "fixed-order second pass",
        "shape": "M=8 K=2048 N=2048 bf16 x int8 (decode at the bench "
                 "shape: wq, wk, wv, wo, lm_head)",
        "shapes": [{k: r[k] for k in (
            "shape", "M", "K", "N", "dtype", "split_plan", "max_abs_err",
            "limit_use", "bit_equal_launches", "kernel_ms", "plain_ms",
            "library", "library_ms", "cublas_on_converted_copy_ms",
            "bound_ms", "bound_by")} for r in rows],
        "card": card}


def main(argv) -> int:
    card = phase_device()
    phase_build()
    if argv == ["--multichip-only"]:
        phase_multichip(card)
        emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                     "count": torch.cuda.device_count()}})
        return 0
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}")
    fwd_rows = phase_kernel(card)
    bwd_rows = phase_kernel_bwd(card)
    # the ring's chain: counts at 0 just before it, read just after
    ring_fwd, ring_bwd, fold_row, chain = phase_ring_kernels(card)
    fwd_rows += ring_fwd
    bwd_rows += ring_bwd
    int8_rows = phase_int8_matmul(card)

    params = init_llama_params(CONFIG_277M, param_dtype=torch.bfloat16,
                               seed=SEED, device="cuda")
    params32 = cast_params(params, torch.float32)
    # the serving path: counts at 0 just before it, read just after
    reset_launch_counts()
    phase_forward(params, params32, card)
    qparams = phase_decode(params, params32, card)
    phase_serving(params, qparams, card)
    serving = launch_counts()
    del params32, qparams
    torch.cuda.empty_cache()
    # the training path, likewise
    reset_launch_counts()
    state, optimizer, step, train_losses = phase_train(params, card)
    phase_checkpoint(state, optimizer, step, card)
    training = launch_counts()
    del state, params
    torch.cuda.empty_cache()
    # the multi-device path: its ranks set their counts to 0 before it
    multi, ring = phase_multichip(card, train_losses)
    for path, counts, names in (
            ("serving", serving, ["flash_attention_fwd", "int8_matmul"]),
            ("training", training, FLASH_KERNELS),
            ("ring chain", chain, ["flash_attention_fwd", "attention_fold"]),
            ("multichip", multi, ["int8_matmul"]),
            ("multichip ring", ring, RING_KERNELS)):
        missing = [name for name in names if counts[name] < 1]
        if missing:
            raise RuntimeError(f"the {path} path never launched {missing}")

    pallas = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    emit({"kernels": [
        kernel_entry(
            "flash_attention_fwd", "flash_attention_fwd.cu",
            f"{pallas}:758 (_flash_attention_impl; reached from "
            "tpu_operator_libs/examples/llama.py:293)",
            {"serving": serving["flash_attention_fwd"],
             "training": training["flash_attention_fwd"],
             "multichip": multi["flash_attention_fwd"],
             "ring_kernels": chain["flash_attention_fwd"],
             "ring": ring["flash_attention_fwd"]}, fwd_rows,
            "B=16 H=16 S=1024 D=128 bf16 (the train step's forward of "
            "llama-277M; B=2 serves)", card),
        kernel_entry(
            "flash_attention_bwd_dkv", "flash_attention_bwd.cu",
            f"{pallas}:1121 (_flash_attention_bwd_dkv, kernel :796; "
            "reached from jax.grad through "
            "tpu_operator_libs/examples/llama.py:293)",
            {"training": training["flash_attention_bwd_dkv"],
             "multichip": multi["flash_attention_bwd_dkv"],
             "ring": ring["flash_attention_bwd_dkv"]},
            bwd_rows[0::2],
            "B=16 H=16 S=1024 D=128 bf16 (train step of llama-277M)", card),
        kernel_entry(
            "flash_attention_bwd_dq", "flash_attention_bwd.cu",
            f"{pallas}:1456 (_flash_attention_bwd_dq, kernel :1146; "
            "reached from jax.grad through "
            "tpu_operator_libs/examples/llama.py:293)",
            {"training": training["flash_attention_bwd_dq"],
             "multichip": multi["flash_attention_bwd_dq"],
             "ring": ring["flash_attention_bwd_dq"]},
            bwd_rows[1::2],
            "B=16 H=16 S=1024 D=128 bf16 (train step of llama-277M)", card),
        {"name": "attention_fold", "route": "cuda",
         "source": "tpu_operator_libs_torch/csrc/attention_fold.cu",
         "replaces": "tpu_operator_libs/examples/ring_attention.py:25-57 "
                     "(_block_attention's online-softmax update, fused by "
                     "XLA; no pallas_call)",
         "launches": chain["attention_fold"] + ring["attention_fold"],
         "launches_by_path": {"ring_kernels": chain["attention_fold"],
                              "ring": ring["attention_fold"]},
         "ok": True, "max_abs_err": fold_row["max_abs_err"],
         "ms": fold_row["kernel_ms"], "plain_ms": fold_row["plain_ms"],
         "bound_ms": fold_row["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "library": fold_row["library"],
         "design": "one warp a row", "shape": "B=1 H=16 S=2048 D=128, "
         "o_blk bf16 (a ring block of the long-context shape)",
         "card": card},
        int8_entry(int8_rows, serving["int8_matmul"],
                   multi["int8_matmul"], card),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
