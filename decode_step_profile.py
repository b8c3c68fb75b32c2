#!/usr/bin/env python3
"""Profile the PyTorch port's cached decode step at the bench decode's
shape on one CUDA card: llama-277M (bf16, random weights from seed 0),
batch 8, a 1024-position cache read at position 1023, in bf16 and in
int8 weights + int8 KV.

For one eager ``forward_with_cache`` step it reports the device
kernels (and copies and sets) the step runs and their device time, from
``torch.profiler``: every kernel by name with its calls, and the port's
own kernels matched by their whole names; the copy kernels' share; and
the bytes that the step's copy ops (``clone``, ``_to_copy``, ``copy_``,
``index_copy_``) move, counted from their tensors' sizes by a dispatch
mode. It then times ``generate_on_device`` through its CUDA graph at the
bench cell (prompt 64, 960 new tokens): tok/s and the call's wall ms a
step, and prints a SHA-256 digest of its tokens, which two trees that
decode the same bits share.

Run from the root of a checkout on a machine with a card:

    python3 decode_step_profile.py [--tree DIR] [--label NAME]

``--tree`` imports ``tpu_operator_libs_torch`` from another checkout of
the port, so that two commits can be profiled in turns on one card.
Prints one JSON line; exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the ops that copy a tensor's bytes, by overload packet
COPY_OPS = ("aten.clone", "aten._to_copy", "aten.copy_", "aten.index_copy_")
BATCH, CONTEXT, PROMPT, NEW_TOKENS = 8, 1024, 64, 960
#: the port's kernels that a cached step may launch
PORT_KERNELS = ("int8_matmul", "decode_attention", "rope_kv_append",
                "kv_append", "rms_norm", "swiglu", "rope", "adamw",
                "cross_entropy", "global_norm")


def port_kernel(key: str):
    """The port's kernel (of PORT_KERNELS) whose instance a profiler row
    names, by the kernel's whole name, demangled or mangled: a
    ``rope_kv_append_kernel<2>`` row is rope_kv_append's and not
    kv_append's, an ``int8_matmul_mma_kernel<..>`` row int8_matmul's, a
    ``rms_norm_fwd_kernel<8>`` row rms_norm's; None for any other
    kernel."""
    found = re.search(r"(?:^|\W|\d)(" + "|".join(PORT_KERNELS)
                      + r")(?:_[a-z]+)?_kernel(?![a-z_])", key)
    return found.group(1) if found else None


class CopyBytes(TorchDispatchMode):
    """Counts the calls of COPY_OPS and the bytes each reads and writes
    (source and result once each; a copy inside another op is not seen
    again)."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()
        self.bytes = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if name in COPY_OPS:
            src = args[3] if name == "aten.index_copy_" else (
                args[1] if name == "aten.copy_" else args[0])
            self.calls[name] += 1
            self.bytes[name] += 2 * src.numel() * src.element_size() \
                if name == "aten.index_copy_" else (
                    src.numel() * src.element_size()
                    + out.numel() * out.element_size())
        return out


def step_profile(forward_with_cache, params, cache, config) -> dict:
    """One eager step at position CONTEXT - 1 (the position on the
    device, as the captured step has it), after two warm-up steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.zeros((BATCH, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor(CONTEXT - 1, device="cuda")

    def step():
        forward_with_cache(params, tokens, cache, pos, config)

    step()
    step()
    torch.cuda.synchronize()
    with CopyBytes() as copies:
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()

    def device_us(event):
        return getattr(event, "device_time_total",
                       getattr(event, "cuda_time_total", 0.0))

    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=device_us, reverse=True)
    copy_events = [e for e in events if "copy" in e.key.lower()]
    return {
        # the port's own kernels, by their instances' whole names
        "port_kernels": {
            name: {"calls": sum(e.count for e in events
                                if port_kernel(e.key) == name),
                   "device_ms": sum(device_us(e) for e in events
                                    if port_kernel(e.key) == name) / 1e3}
            for name in PORT_KERNELS},
        "device_events": sum(e.count for e in events),
        "device_ms": sum(device_us(e) for e in events) / 1e3,
        "copy_kernels": {"calls": sum(e.count for e in copy_events),
                         "device_ms": sum(device_us(e)
                                          for e in copy_events) / 1e3},
        "copy_ops": {"calls": dict(copies.calls),
                     "bytes": dict(copies.bytes),
                     "total_bytes": sum(copies.bytes.values())},
        # every kernel, copy and set the step ran, by device time
        "kernels": [{"name": e.key[:120], "calls": e.count,
                     "device_ms": device_us(e) / 1e3} for e in events]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_step_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from tpu_operator_libs_torch.examples.llama import (
        LlamaConfig,
        init_llama_params,
    )
    from tpu_operator_libs_torch.examples.llama_decode import (
        forward_with_cache,
        generate_on_device,
        init_kv_cache,
        quantize_params_int8,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    # llama-277M as bench.py builds it (bench.py:551-555 with D=2048)
    config = LlamaConfig(vocab=2048, d_model=2048, n_layers=4, n_heads=16,
                         n_kv_heads=16, d_ff=8192, seq_len=1024,
                         learning_rate=1e-4)
    params = init_llama_params(config, param_dtype=torch.bfloat16, seed=0,
                               device="cuda")
    prompt = torch.randint(0, config.vocab, (BATCH, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    cells = {}
    for label, p, quantize_kv in (
            ("bf16", params, False),
            ("int8_weights_int8_kv", quantize_params_int8(params), True)):
        cache = init_kv_cache(config, BATCH, CONTEXT, torch.bfloat16,
                              quantize_kv=quantize_kv, device="cuda")
        cell = {"step": step_profile(forward_with_cache, p, cache, config)}
        del cache
        kw = {"param_dtype": torch.bfloat16, "quantize_kv": quantize_kv}
        generate_on_device(p, prompt, config, 8, **kw)
        torch.cuda.synchronize()
        start = time.perf_counter()
        tokens = generate_on_device(p, prompt, config, NEW_TOKENS,
                                    **kw).cpu()
        seconds = time.perf_counter() - start
        cell["graph_tok_per_s"] = BATCH * NEW_TOKENS / seconds
        # the call's wall time a token step (prefill and readback in it)
        cell["graph_ms_per_step"] = seconds / NEW_TOKENS * 1e3
        cell["graph_tokens_sha256"] = hashlib.sha256(
            tokens.numpy().tobytes()).hexdigest()
        cells[label] = cell
    print(json.dumps({"label": args.label or args.tree,
                      "tree": os.path.abspath(args.tree),
                      "card": smi.stdout.strip().splitlines()[0],
                      "batch": BATCH, "context": CONTEXT,
                      "new_tokens": NEW_TOKENS, "cells": cells}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
