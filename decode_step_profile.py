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

With ``--sampled`` the step is the cached step with its token pick
(``llama_decode._pick_next``), the pick is also profiled alone, and the
graph decode samples from a seeded generator (its tokens and its
logprobs each get a digest), each under two settings (SAMPLED_CELLS):
the decode contract's (temperature 1.0, top-k 50, top-p 0.9, with the
logprob) and what ``DecodeServer(temperature=)`` sends (the temperature
alone).

Run from the root of a checkout on a machine with a card:

    python3 decode_step_profile.py [--tree DIR] [--label NAME] [--sampled]

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
                "cross_entropy", "global_norm", "token_pick")
#: the decode contract's sampling settings (``chip_smoke.py``'s phase 6
#: and ``--sampled`` read them from here)
SAMPLING = {"temperature": 1.0, "top_k": 50, "top_p": 0.9,
            "return_logprobs": True}
#: what ``DecodeServer(temperature=)`` sends: the temperature alone, no
#: top-k, no top-p, no logprob
SERVED_SAMPLING = {"temperature": 1.0, "top_k": None, "top_p": None,
                   "return_logprobs": False}
#: ``--sampled``'s settings, by the name its cells carry
SAMPLED_CELLS = {"contract": SAMPLING, "served": SERVED_SAMPLING}
SAMPLING_SEED = 6


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


def device_us(event):
    return getattr(event, "device_time_total",
                   getattr(event, "cuda_time_total", 0.0))


def device_events(fn):
    """The device kernels (and copies and sets) of one eager call of
    ``fn``, by device time, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=device_us, reverse=True)


def kernel_rows(events):
    return [{"name": e.key[:120], "calls": e.count,
             "device_ms": device_us(e) / 1e3} for e in events]


def step_profile(forward_with_cache, params, cache, config,
                 pick=None) -> dict:
    """One eager step at position CONTEXT - 1 (the position on the
    device, as the captured step has it), after two warm-up steps; with
    ``pick`` (a function of the step's (B, vocab) last logits) the step
    picks its token too, and the pick is profiled alone as well."""
    tokens = torch.zeros((BATCH, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor(CONTEXT - 1, device="cuda")

    def step():
        logits, _ = forward_with_cache(params, tokens, cache, pos, config)
        if pick is not None:
            pick(logits[:, -1, :])
        return logits

    step()
    logits = step()
    torch.cuda.synchronize()
    with CopyBytes() as copies:
        step()
    torch.cuda.synchronize()
    events = device_events(step)
    copy_events = [e for e in events if "copy" in e.key.lower()]
    extra = {}
    if pick is not None:
        alone = device_events(lambda: pick(logits[:, -1, :]))
        extra["pick_alone"] = {
            "device_events": sum(e.count for e in alone),
            "device_ms": sum(device_us(e) for e in alone) / 1e3,
            "kernels": kernel_rows(alone)}
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
        "kernels": kernel_rows(events), **extra}


def profile_cell(params, prompt, config, quantize_kv, sampling) -> dict:
    """One cell: the cached step (with its pick under ``sampling``, the
    keywords of ``generate``; greedy and no pick where empty) profiled,
    then the graph decode at the bench cell timed and digested."""
    from tpu_operator_libs_torch.examples.llama_decode import (
        _pick_next,
        forward_with_cache,
        generate_on_device,
        init_kv_cache,
    )

    cache = init_kv_cache(config, BATCH, CONTEXT, torch.bfloat16,
                          quantize_kv=quantize_kv, device="cuda")
    pick = None
    if sampling:
        pick_gen = torch.Generator(device="cuda").manual_seed(SAMPLING_SEED)

        def pick(logits_last):
            return _pick_next(logits_last, sampling["temperature"],
                              sampling["top_k"], pick_gen,
                              sampling["top_p"], sampling["return_logprobs"])
    cell = {"step": step_profile(forward_with_cache, params, cache, config,
                                 pick)}
    del cache

    def decode(new_tokens):
        gen = (torch.Generator(device="cuda").manual_seed(SAMPLING_SEED)
               if sampling else None)
        return generate_on_device(params, prompt, config, new_tokens,
                                  param_dtype=torch.bfloat16,
                                  quantize_kv=quantize_kv, generator=gen,
                                  **sampling)

    decode(8)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = decode(NEW_TOKENS)
    if sampling.get("return_logprobs"):
        tokens, logprobs = out[0].cpu(), out[1].cpu()
    else:
        tokens, logprobs = out.cpu(), None
    seconds = time.perf_counter() - start
    cell["graph_tok_per_s"] = BATCH * NEW_TOKENS / seconds
    # the call's wall time a token step (prefill and readback in it)
    cell["graph_ms_per_step"] = seconds / NEW_TOKENS * 1e3
    cell["graph_tokens_sha256"] = hashlib.sha256(
        tokens.numpy().tobytes()).hexdigest()
    if logprobs is not None:
        cell["graph_logprobs_sha256"] = hashlib.sha256(
            logprobs.numpy().tobytes()).hexdigest()
    return cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--label", default=None)
    parser.add_argument("--sampled", action="store_true",
                        help="profile the step with its sampled pick and "
                             "time the sampled graph decode, under each "
                             "of SAMPLED_CELLS")
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
        for name, sampling in (SAMPLED_CELLS.items() if args.sampled
                               else [(None, {})]):
            cells[label if name is None else f"{label}/{name}"] = \
                profile_cell(p, prompt, config, quantize_kv, sampling)
    print(json.dumps({"label": args.label or args.tree,
                      "tree": os.path.abspath(args.tree),
                      "sampled": SAMPLED_CELLS if args.sampled else None,
                      "card": smi.stdout.strip().splitlines()[0],
                      "batch": BATCH, "context": CONTEXT,
                      "new_tokens": NEW_TOKENS, "cells": cells}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
