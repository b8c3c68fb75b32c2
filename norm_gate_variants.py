#!/usr/bin/env python3
"""Time plan and launch variants of the port's norm and gate forward
kernels (``tpu_operator_libs_torch/csrc/rms_norm.cu``,
``csrc/swiglu.cu``) on one CUDA card, in turns, at ``chip_smoke.py``
phase 3f's shapes.

Parts (``--parts``):

- ``plans``: the norm's layouts (``NORM_LAYOUTS``: its vectors a
  thread, ``rms_norm.TARGET_LOADS``, 1 being 256 threads a row of
  2,048, 2 and 4 being 128 and 64; the rows a block; the grid; the
  two-pass loop; and source variants: one warp a row, bfloat16
  unpacked as loaded, registers capped, w prefetched before the wait,
  no programmatic dependent launch), at the bench
  decode also after the O projection, and the gate's vectors a thread
  (``swiglu.UNROLLS``) and, as a source variant, the gate without its
  silu (the loads, the product and the stores alone, to part the bytes'
  time from the arithmetic's); each timed as phase 3f times the kernels
  (CUDA graphs of repeated calls), the norm beside ``F.rms_norm``.
- ``launch``: the two kernels as they are (programmatic dependent
  launch) and built with the launch attribute off (a copy of the sources
  with one edit), swapped into the wrappers in turns (on, off, off, on):
  each alone and after the product before it on the decode step, in
  bf16 through ``torch.matmul`` (``chip_smoke.after_product_ms``) and
  through the int8-weight kernel (``int8_matmul``).
- ``decode``: the graph decode at the bench cell (batch 8, prompt 64,
  960 new tokens, llama-277M with random bf16 weights from seed 0, in
  bf16 and in int8 weights + int8 KV) with the attribute on and off in
  turns (``--rounds`` times on, off, off, on): tok/s, the call's ms a
  step and a SHA-256 of the tokens.

Source variants are built by ``nvcc`` (the package's flags) into
``build/norm_gate_variants/`` and loaded with ctypes. Run from the root
of a checkout on a machine with a card:

    python3 norm_gate_variants.py [--parts plans,launch,decode] [--rounds N]

Prints one JSON line a part; exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import itertools
import json
import shutil
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from tpu_operator_libs_torch.kernels import _build
from tpu_operator_libs_torch.kernels import rms_norm as rmod
from tpu_operator_libs_torch.kernels import swiglu as smod

OUT_DIR = _build.BUILD_DIR.parent / "norm_gate_variants"
#: the edits of each source variant, by file: (text, replacement) pairs
VARIANTS = {
    # one warp a row of 2,048: the register budget 8 vectors a thread
    "warp_a_row": {"rms_norm.cu": [
        ("constexpr int kMaxLoads = 4;", "constexpr int kMaxLoads = 8;")]},
    # bfloat16 converted to float32 registers as loaded
    "unpacked": {"rms_norm.cu": [
        ("  return vec == 8 && loads > 0 && h_dtype == 1",
         "  return false && vec == 8 && loads > 0 && h_dtype == 1")]},
    # at least 5 blocks of 256 threads an SM: the registers capped
    "min_blocks_5": {"rms_norm.cu": [(
        "__launch_bounds__(kFwdThreads)\n    rms_norm_fwd_kernel",
        "__launch_bounds__(kFwdThreads, 5)\n    rms_norm_fwd_kernel")]},
    # w's 128-byte lines prefetched into L2 before the wait
    "prefetch_w": {"rms_norm.cu": [(
        "  wait_for_prerequisites();\n  if constexpr (kLoads > 0) {",
        "  for (int line = t; line < (p.dim * (p.w_dtype == 0 ? 4 : 2) + 127)"
        " / 128; line += tpr) {\n"
        "    asm volatile(\"prefetch.global.L2 [%0];\" : : \"l\"("
        "static_cast<const char*>(p.w) + line * 128LL));\n  }\n"
        "  wait_for_prerequisites();\n  if constexpr (kLoads > 0) {")]},
    # the gate without its silu (the product of the loads alone): what
    # the bytes cost without the arithmetic; wrong results by design
    "gate_without_silu": {"swiglu.cu": [(
        "        out[e] = __fmul_rn(silu(a[j].at(e), kDtype), b[j].at(e));",
        "        out[e] = __fmul_rn(a[j].at(e), b[j].at(e));")]},
    # both forwards launched without programmatic dependent launch
    "no_dependent_launch": {"dependent_launch.cuh": [(
        "programmaticStreamSerializationAllowed = 1",
        "programmaticStreamSerializationAllowed = 0")]},
}
#: the norm's layouts that ``plans`` times: (name, source variant or
#: None, ``rms_norm.TARGET_LOADS`` (None: the plan's; 0: the two-pass
#: loop), rows a block (None: the plan's), grid (None: the plan's;
#: "full": a block for every group of rows; "strided": a grid of the
#: resident blocks))
NORM_LAYOUTS = [
    ("as_is", None, None, None, None),
    ("one_vector", None, (1, 1), None, None),
    ("two_vectors", None, (2, 2), None, None),
    ("four_vectors", None, (4, 4), None, None),
    ("warp_a_row", "warp_a_row", (8, 8), None, None),
    ("two_vectors_a_row_a_block", None, (2, 2), 1, None),
    ("as_is_strided", None, None, None, "strided"),
    ("as_is_full_grid", None, None, None, "full"),
    ("two_pass", None, 0, None, None),
    ("unpacked", "unpacked", None, None, None),
    ("min_blocks_5", "min_blocks_5", None, None, None),
    ("prefetch_w", "prefetch_w", None, None, None),
    ("no_dependent_launch", "no_dependent_launch", None, None, None),
]
#: the layouts that ``plans`` also times after the O projection at the
#: bench decode (``chip_smoke.after_product_ms``)
AFTER_PRODUCT_LAYOUTS = ("as_is", "two_vectors", "prefetch_w",
                         "no_dependent_launch")
#: the C entries of each library, whose argument types a variant takes
#: from the package's own library
ENTRIES = {"rms_norm.cu": ("rms_norm_fwd", "rms_norm_fwd_resident",
                           "rms_norm_bwd", "rms_norm_bwd_resident",
                           "rms_norm_error_string"),
           "swiglu.cu": ("swiglu_fwd", "swiglu_fwd_resident", "swiglu_bwd",
                         "swiglu_error_string")}
MODULES = {"rms_norm.cu": rmod, "swiglu.cu": smod}
#: (label, rows, iters) of the norm's rows at d_model 2048 and of the
#: gate's at d_ff (the tp = 2 shard at half of it)
NORM_CASES = [("bench_decode", 8, 400), ("prefill_block", 512, 200),
              ("train", cs.TRAIN_ROWS, 20)]
GATE_CASES = [("bench_decode", 8, 8192, 400), ("tp2_shard", 4, 4096, 400),
              ("prefill_block", 512, 8192, 100),
              ("train", cs.TRAIN_ROWS, 8192, 10)]


def build_variant(name) -> "dict[str, ctypes.CDLL]":
    """The package's libraries with the variant's edits, by source: a
    source is rebuilt from a copy of ``csrc`` where the variant edits it
    or a header; the others are the package's own."""
    root = OUT_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, root / "csrc")
    for file, edits in VARIANTS[name].items():
        path = root / "csrc" / file
        text = path.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {file} no longer holds "
                                 f"{old!r}; update VARIANTS")
            text = text.replace(old, new)
        path.write_text(text)
    libs = {}
    for source, names in ENTRIES.items():
        own = MODULES[source]._library()
        if not any(file == source or file.endswith(".cuh")
                   for file in VARIANTS[name]):
            libs[source] = own
            continue
        out = root / f"{source}.so"
        run = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
             str(root / "csrc" / source), *_build.NVCC_LIBS],
            capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"variant {name}: nvcc failed on {source}:\n"
                             f"{run.stderr[-4000:]}")
        lib = ctypes.CDLL(str(out))
        for entry in names:
            fn, ref = getattr(lib, entry), getattr(own, entry)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        libs[source] = lib
    return libs


def use(libs) -> None:
    """Swap ``libs`` (by source) into the wrappers; the resident-block
    counts are per library, so their cache is cleared."""
    for source, lib in libs.items():
        MODULES[source]._lib = lib
        MODULES[source]._resident.cache_clear()
        if source == "rms_norm.cu":
            rmod._bwd_resident.cache_clear()


def randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def part_plans(rounds) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 60)
    w = (1 + 0.1 * torch.randn(2048, generator=gen, device="cuda")).to(
        torch.bfloat16)
    own = {source: MODULES[source]._library() for source in ENTRIES}
    built = {name: build_variant(name) for name in
             {layout[1] for layout in NORM_LAYOUTS if layout[1] is not None}}
    saved = (rmod.TARGET_LOADS, rmod.MAX_LOADS, rmod.LOADS, rmod.plan)
    plan = rmod.plan

    def planner(per_block, grid):
        """``plan`` with the rows a block and the grid overridden."""
        def planned(rows, dim, vec, sms, backward=False, resident=None,
                    add=False, bf16=False):
            p = plan(rows, dim, vec, sms, backward, resident, add, bf16)
            if per_block is not None:
                p = dataclasses.replace(p, rows_per_block=per_block)
            groups = -(-rows // p.rows_per_block)
            if grid == "full" or (grid is None and per_block is not None
                                  and add):
                p = dataclasses.replace(p, blocks=groups)
            elif grid == "strided" or per_block is not None:
                p = dataclasses.replace(p, blocks=min(groups, sms * resident(
                    p.loads, p.threads_per_row * p.rows_per_block)))
            return p
        return planned

    norm = {}
    for label, rows, iters in NORM_CASES:
        h, d = randn(gen, rows, 2048), randn(gen, rows, 2048)
        for add in (True, False):
            key = f"{label}_{'add' if add else 'no_add'}"
            cell = norm[key] = {}
            for _ in range(rounds):
                for name, variant, target, per_block, grid in NORM_LAYOUTS:
                    use(built[variant] if variant else own)
                    rmod.TARGET_LOADS = (1, 1) if target == 0 \
                        else target or saved[0]
                    rmod.MAX_LOADS, rmod.LOADS = (
                        (8, (0, 1, 2, 8)) if variant == "warp_a_row"
                        else (0, saved[2]) if target == 0 else saved[1:3])
                    rmod.plan = planner(per_block, grid)
                    entry = cell.setdefault(name, {"plan": str(
                        rmod.forward_plan(rows, 2048, 8, 0, add)), "ms": []})
                    entry["ms"].append(cs.graph_ms(
                        lambda: rmod._launch_forward(
                            h, d if add else None, w, rmod.EPS,
                            label == "train"), iters))
                    if label == "bench_decode" \
                            and name in AFTER_PRODUCT_LAYOUTS:
                        entry.setdefault("after_product_ms", []).append(
                            cs.after_product_ms(
                                (lambda o: rmod.add_rms_norm(h, o, w)) if add
                                else (lambda o: rmod.add_rms_norm(o, None, w)),
                                randn(gen, rows, 2048), 2048, iters)[
                                "kernel_after_product_ms"])
                cell.setdefault("F.rms_norm_ms", []).append(cs.graph_ms(
                    lambda: torch.nn.functional.rms_norm(
                        h + d if add else h, (2048,), w, rmod.EPS), iters))
        del h, d
    use(own)
    rmod.TARGET_LOADS, rmod.MAX_LOADS, rmod.LOADS, rmod.plan = saved
    torch.cuda.empty_cache()
    gate = {}
    saved = smod.UNROLLS
    bare = build_variant("gate_without_silu")
    for label, rows, dim, iters in GATE_CASES:
        g, u = randn(gen, rows, dim), randn(gen, rows, dim)
        cell = gate[label] = {}
        for _ in range(rounds):
            for unrolls in ((1,), (2,), (4,), saved, "without_silu"):
                use(bare if unrolls == "without_silu" else own)
                smod.UNROLLS = saved if unrolls == "without_silu" \
                    else unrolls
                name = unrolls if unrolls == "without_silu" else (
                    "as_is" if unrolls == saved else f"u{unrolls[0]}")
                cell.setdefault(name, {"plan": str(smod.forward_plan(
                    g.numel(), 8, torch.bfloat16, 0)), "ms": []})[
                    "ms"].append(cs.graph_ms(lambda: smod.swiglu(g, u), iters))
        del g, u
        torch.cuda.empty_cache()
    use(own)
    smod.UNROLLS = saved
    return {"part": "plans", "norm": norm, "gate": gate}


def after_int8_ms(kernel, m, n, iters) -> float:
    """``chip_smoke.after_product_ms`` with the int8-weight product (the
    int8 decode path's ``int8_matmul``) before the kernel: graph(product
    + kernel) less graph(product), in turns, over weight copies that
    overflow L2."""
    from tpu_operator_libs_torch.kernels.int8_matmul import int8_matmul

    k = m.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 62)
    pool = [(torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8),
             0.01 * torch.rand(n, generator=gen, device="cuda"))
            for _ in range(max(2, cs.ROTATE_BYTES // (k * n)))]
    turn = itertools.cycle(pool)

    def product():
        return int8_matmul(m, *next(turn))

    def both():
        return kernel(product())

    times = {"product": [], "both": []}
    for name in ("product", "both", "both", "product"):
        times[name].append(cs.graph_ms(both if name == "both" else product,
                                       iters))
    del pool
    torch.cuda.empty_cache()
    return statistics.mean(times["both"]) - statistics.mean(times["product"])


def part_launch(rounds) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 61)
    w = (1 + 0.1 * torch.randn(2048, generator=gen, device="cuda")).to(
        torch.bfloat16)
    h, o, m = (randn(gen, 8, 2048) for _ in range(3))
    g, u = randn(gen, 8, 8192), randn(gen, 8, 8192)
    libs = {"on": {source: MODULES[source]._library() for source in ENTRIES},
            "off": build_variant("no_dependent_launch")}
    kernels = [("norm_add", lambda x: rmod.add_rms_norm(h, x, w), 2048, o),
               ("norm_no_add", lambda x: rmod.add_rms_norm(x, None, w), 2048,
                o),
               ("gate", lambda x: smod.swiglu(g, x), 8192, u)]
    cells = {}
    for turn in ("on", "off", "off", "on") * rounds:
        use(libs[turn])
        for name, fn, n, alone in kernels:
            after = cs.after_product_ms(fn, m, n, 200)
            cell = cells.setdefault(name, {}).setdefault(turn, {
                "alone_ms": [], "after_product_ms": [], "product_ms": [],
                "after_int8_product_ms": []})
            cell["alone_ms"].append(cs.graph_ms(lambda: fn(alone), 400))
            cell["after_product_ms"].append(after["kernel_after_product_ms"])
            cell["product_ms"].append(after["product_ms"])
            cell["after_int8_product_ms"].append(
                after_int8_ms(fn, m, n, 200))
    use(libs["on"])
    return {"part": "launch", "product": "torch.matmul (8, 2048) x (2048, "
            "2048) before the norm, (2048, 8192) before the gate; "
            "int8_matmul at the same shapes", "cells": cells}


def part_decode(rounds) -> dict:
    from tpu_operator_libs_torch.examples.llama import init_llama_params
    from tpu_operator_libs_torch.examples.llama_decode import (
        generate_on_device,
        quantize_params_int8,
    )

    config = cs.CONFIG_277M
    params = init_llama_params(config, param_dtype=torch.bfloat16,
                               seed=cs.SEED, device="cuda")
    weights = {"bf16": (params, False),
               "int8_weights_int8_kv": (quantize_params_int8(params), True)}
    prompt = torch.randint(0, config.vocab, (8, 64), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    libs = {"on": {source: MODULES[source]._library() for source in ENTRIES},
            "off": build_variant("no_dependent_launch")}
    cells = {}
    for turn in ("on", "off", "off", "on") * rounds:
        use(libs[turn])
        for label, (p, quantize_kv) in weights.items():
            kw = {"param_dtype": torch.bfloat16, "quantize_kv": quantize_kv}
            generate_on_device(p, prompt, config, 8, **kw)
            torch.cuda.synchronize()
            start = time.perf_counter()
            tokens = generate_on_device(p, prompt, config, 960, **kw).cpu()
            seconds = time.perf_counter() - start
            cell = cells.setdefault(label, {}).setdefault(turn, {
                "tok_per_s": [], "ms_per_step": [], "tokens_sha256": set()})
            cell["tok_per_s"].append(8 * 960 / seconds)
            cell["ms_per_step"].append(seconds / 960 * 1e3)
            cell["tokens_sha256"].add(hashlib.sha256(
                tokens.numpy().tobytes()).hexdigest())
    use(libs["on"])
    for by_turn in cells.values():
        for cell in by_turn.values():
            cell["tokens_sha256"] = sorted(cell["tokens_sha256"])
    return {"part": "decode", "batch": 8, "prompt": 64, "new_tokens": 960,
            "cells": cells}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default="plans,launch,decode")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("norm_gate_variants: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.phase_device()
    parts = {"plans": lambda: part_plans(args.rounds),
             "launch": lambda: part_launch(args.rounds),
             "decode": lambda: part_decode(args.rounds)}
    for name in args.parts.split(","):
        print(json.dumps({**parts[name](), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
