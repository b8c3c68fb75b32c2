#!/usr/bin/env python3
"""Drive the PyTorch port's serving slice on one CUDA card at full width.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises and the script
exits non-zero without printing a result. Phases:

1. device: the card's name, count and power limit; TF32 off.
2. build: the CUDA kernel from ``tpu_operator_libs_torch/csrc``.
3. kernel: ``flash_attention`` against its plain PyTorch version on the
   card at the main path's shape and three more, with times.
4-6. the main path, with the launch counts set to 0 just before it:
   ``forward`` of llama-277M with ``attention_impl="flash"`` against
   ``"xla"``; the decode contract (stepwise cache == batch forward, host
   loop == device loop, bf16 and int8 weights + int8 KV); a
   ``DecodeServer`` burst with a mid-burst drain, then decode at the
   bench's shape.
7. kernels: one line with every kernel's launches, error and times.

The last line is ``{"ok": true, "device": {...}}``. The model is
llama-277M as ``bench.py`` builds it (vocab 2048, d_model 2048, 4
layers, 16 heads, head_dim 128, d_ff 8192, bf16), with random weights
from a seed. Without CUDA the script exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from tpu_operator_libs_torch.examples.llama import (  # noqa: E402
    LlamaConfig,
    forward,
    init_llama_params,
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
from tpu_operator_libs_torch.health.serving_gate import (  # noqa: E402
    ServingEndpoint,
)
from tpu_operator_libs_torch.kernels import _build  # noqa: E402
from tpu_operator_libs_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_reference,
    flash_forward,
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
#: the CPU test holds the plain version to against the Pallas kernel.
KERNEL_TOL = {torch.bfloat16: (2.0 ** -7, 1e-3), torch.float32: (1e-5, 2e-5)}
#: log-sum-exp, f32 on both sides
LSE_ATOL = 1e-4

SEED = 0


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


def attention_bound_ms(batch, heads, kv_heads, sq, sk, dim, dtype,
                       causal=True):
    """Least time for the work these inputs need: the larger of the
    FLOPs of the visible (query, key) pairs over the dtype's peak and
    Q, K, V, O and the lse moved once over the memory rate."""
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4 * batch * heads * dim * pairs  # QK^T and PV, 2 FLOPs/MAC
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


def phase_build():
    built = _build.build("flash_attention_fwd.cu")
    entries = []
    report = built.ptxas_report
    for block in report.split("Compiling entry function")[1:]:
        name = re.search(r"flash_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)E",
                         block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        entries.append({
            "dtype": ("bfloat16" if name and name.group(1) != "f"
                      else "float32"),
            "head_dim": int(name.group(2)) if name else None,
            "registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(spill.group(1)) if spill else 0})
    emit({"phase": "build", "source": "flash_attention_fwd.cu",
          "build_seconds": built.build_seconds,
          "dynamic_smem_bytes_per_head_dim": "2*64*D*4",
          "ptxas": entries})


def check_kernel_shape(label, batch, heads, kv_heads, seq, dim, dtype,
                       card, iters):
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    q = randn(batch, heads, seq, dim)
    k = randn(batch, kv_heads, seq, dim)
    v = randn(batch, kv_heads, seq, dim)
    scale = dim ** -0.5
    out, lse = flash_forward(q, k, v, causal=True, sm_scale=scale)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                             sm_scale=scale)
    rtol, atol = KERNEL_TOL[dtype]
    err = (out.float() - ref.float()).abs()
    max_err = err.max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    within = bool((err <= atol + rtol * ref.float().abs()).all())
    if not (within and lse_err <= LSE_ATOL
            and torch.isfinite(out.float()).all()):
        raise RuntimeError(
            f"flash_attention_fwd disagrees with its plain version at "
            f"{label}: max|err| {max_err} (rtol {rtol}, atol {atol}), "
            f"lse max|err| {lse_err} (atol {LSE_ATOL})")
    del ref, ref_lse, err
    kernel_ms = cuda_ms(
        lambda: flash_forward(q, k, v, causal=True, sm_scale=scale), iters)
    plain_ms = cuda_ms(
        lambda: flash_attention_reference(q, k, v, causal=True,
                                          sm_scale=scale),
        max(1, iters // 3), warmup=1)
    group = heads // kv_heads
    k_full = k.repeat_interleave(group, dim=1)
    v_full = v.repeat_interleave(group, dim=1)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_full, v_full, is_causal=True, scale=scale), iters)
    bound_ms, bound_by = attention_bound_ms(batch, heads, kv_heads, seq,
                                            seq, dim, dtype)
    row = {"phase": "kernel", "name": "flash_attention_fwd",
           "shape": label, "B": batch, "H": heads, "H_kv": kv_heads,
           "S": seq, "D": dim, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max_err, "rtol": rtol, "atol": atol,
           "lse_max_abs_err": lse_err, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "card": card}
    emit(row)
    del q, k, v, k_full, v_full, out, lse
    torch.cuda.empty_cache()
    return row


def phase_kernel(card):
    shapes = [
        # the main path's call: forward of llama-277M at batch 2, S 1024
        ("main", 2, 16, 16, 1024, 128, torch.bfloat16, 20),
        ("a", 8, 16, 16, 1024, 128, torch.bfloat16, 10),
        ("b", 1, 16, 16, 8192, 128, torch.bfloat16, 5),
        ("c", 2, 8, 2, 1000, 64, torch.float32, 20),
    ]
    return [check_kernel_shape(*s[:7], card, s[7]) for s in shapes]


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
        if not (equal and valid and dev.shape == (8, 96)):
            raise RuntimeError(
                f"host and device decode loops differ ({label})")
    emit(result)
    return qparams


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
        generate_on_device(p, prompt, CONFIG_277M, 8,
                           param_dtype=torch.bfloat16, **kw)  # warm
        start = time.perf_counter()
        out = generate_on_device(p, prompt, CONFIG_277M, 960,
                                 param_dtype=torch.bfloat16, **kw).cpu()
        seconds = time.perf_counter() - start
        if out.shape != (8, 1024) \
                or not bool(((out >= 0) & (out < CONFIG_277M.vocab)).all()):
            raise RuntimeError(f"bench-shape decode malformed ({label})")
        cells[label] = {"seconds": seconds,
                        "tok_per_s": 8 * 960 / seconds,
                        "profile_64_steps": profile_decode(p, prompt, kw)}
    emit({"phase": "decode_bench_shape", "batch": 8, "prompt": 64,
          "new_tokens": 960, "cells": cells, "card": card})


def profile_decode(params, prompt, kw):
    """Device-busy share and the top kernels by device time over a
    64-token decode, from torch.profiler (the profiler's own cost is in
    the wall time, so the share is a lower bound). None where the
    profiler records no device time on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        generate_on_device(params, prompt, CONFIG_277M, 64,
                           param_dtype=torch.bfloat16, **kw).cpu()
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
    top = sorted(events, key=device_us, reverse=True)[:6]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top": [{"name": e.key[:60], "calls": e.count,
                     "device_ms": device_us(e) / 1e3} for e in top]}


def main() -> int:
    card = phase_device()
    phase_build()
    rows = phase_kernel(card)

    params = init_llama_params(CONFIG_277M, param_dtype=torch.bfloat16,
                               seed=SEED, device="cuda")
    params32 = cast_params(params, torch.float32)
    # the main path: counts at 0 just before it, read just after
    flash_attention.launches = 0
    phase_forward(params, params32, card)
    qparams = phase_decode(params, params32, card)
    phase_serving(params, qparams, card)
    launches = flash_attention.launches
    if launches < 1:
        raise RuntimeError("the main path never launched flash_attention")

    main_row = rows[0]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "tpu_operator_libs_torch/csrc/flash_attention_fwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758"
                    " (_flash_attention_impl; reached from "
                    "tpu_operator_libs/examples/llama.py:293)",
        "launches": launches, "ok": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "B=2 H=16 S=1024 D=128 bf16 (forward of llama-277M)",
        "shapes": [{k: r[k] for k in ("shape", "B", "H", "H_kv", "S", "D",
                                      "dtype", "max_abs_err", "kernel_ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")} for r in rows],
        "card": card}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
