#!/usr/bin/env python3
"""Time source and plan variants of the port's decode-attention kernel
(``tpu_operator_libs_torch/csrc/decode_attention.cu``) on one CUDA card,
in turns with the kernel as it is, at ``chip_smoke.py`` phase 3e's shapes.

A source variant is the kernel's source with one edit (``VARIANTS``):

- ``loads_only``: every warp skips its tiles' products and softmax, so
  the loads (and an int8 cache's conversion) remain;
- ``compute_only``: every tile's rows are zero-filled instead of read
  (for head_dims whose 16-byte chunks divide the block's 128 threads),
  so the products remain and the device memory is not read;
- ``i2f``: int8 codes converted to bf16 by the conversion instruction
  instead of the float magic number;
- ``no_lo``: the value product without the weights' lo part (results
  off by a bf16 rounding of each weight).

Each is built by ``nvcc`` (the package's flags) into
``build/decode_attention_variants/``, swapped into the wrapper and timed
as phase 3e times it: CUDA graphs of 30 calls, each on another copy of
the cache, the copies overflowing L2. A plan variant (``--plans
splits:stages,...``) replaces the plan's splits and stages. Variants
that skip work give wrong results by design; each line reports the
error against the plain version in float32.

Run from the root of a checkout on a machine with a card:

    python3 decode_attention_variants.py [--shapes NAME:DTYPE,...]
        [--variants NAME,...] [--plans SPLITS:STAGES,...] [--rounds N]

Prints one JSON line for each (shape, plan); exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from tpu_operator_libs_torch.kernels import _build
from tpu_operator_libs_torch.kernels import decode_attention as dmod

SOURCE = _build.CSRC_DIR / dmod.SOURCE
OUT_DIR = _build.BUILD_DIR.parent / "decode_attention_variants"

#: the edits of each source variant: (text, replacement) pairs
VARIANTS = {
    "loads_only": [(
        "    if (s0 + w0 >= blk.k_end) continue;  // the warp's keys are all "
        "past\n",
        "    continue;\n")],
    "compute_only": [(
        "        const bool in = j < n;\n        cp_async16(dst,",
        "        const bool in = false;\n        cp_async16(dst,")],
    "i2f": [(
        "        uint32_t h[8];\n"
        "        codes_to_bf16(u.x, h[0], h[1]);\n"
        "        codes_to_bf16(u.y, h[2], h[3]);\n"
        "        codes_to_bf16(u.z, h[4], h[5]);\n"
        "        codes_to_bf16(u.w, h[6], h[7]);\n",
        "        const char4* b = reinterpret_cast<const char4*>(&u);\n"
        "        uint32_t h[8];\n"
        "        for (int x = 0; x < 4; ++x) {\n"
        "          h[2 * x] = pack_bf16(b[x].x, b[x].y);\n"
        "          h[2 * x + 1] = pack_bf16(b[x].z, b[x].w);\n"
        "        }\n")],
    "no_lo": [(
        "        mma_bf16(acc[j], a_lo, b[0], b[1]);\n", ""), (
        "        mma_bf16(acc[j + 1], a_lo, b[2], b[3]);\n", "")],
}
DEFAULT_SHAPES = ("bench_decode:bfloat16,bench_decode:int8,"
                  "bench_decode_mid:bfloat16,bench_decode_mid:int8")


def build(names) -> "dict[str, ctypes.CDLL]":
    """The kernel as it is and each named variant, one nvcc each, all
    started together."""
    text = SOURCE.read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ["as_is", *names]:
        edited = text
        for old, new in VARIANTS.get(name, []):
            if old not in edited:
                raise SystemExit(f"variant {name}: its edit no longer "
                                 "matches the source")
            edited = edited.replace(old, new, 1)
        src = OUT_DIR / f"{name}.cu"
        src.write_text(edited)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent),
             "-o", str(OUT_DIR / f"{name}.so"), str(src), *_build.NVCC_LIBS],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{err}")
        libs[name] = dmod.bind(ctypes.CDLL(str(OUT_DIR / f"{name}.so")))
    return libs


def with_plan(p: dmod.Plan, splits: int, stages: int, dim: int,
              cache: torch.dtype) -> dmod.Plan:
    return dataclasses.replace(
        p, splits=splits, stages=stages,
        smem_bytes=dmod.smem_bytes(p.route, dim, cache, p.key_tile,
                                   p.row_stride, stages),
        grid=(p.grid[0] // p.splits * splits,) + p.grid[1:])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shapes", default=DEFAULT_SHAPES)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--plans", default="",
                        help="splits:stages pairs besides the plan's own")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_attention_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    names = [n for n in args.variants.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    libs = build(names)
    real_plan = dmod.plan
    for item in args.shapes.split(","):
        label, cache_name = item.split(":")
        shape = next(s for s in cs.DECODE_SHAPES if s[0] == label
                     and cs.dtype_name(s[-1]) == cache_name)
        _, b, t, h, kv, seq, start, d, q_dtype, cache = shape
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 40)
        q = torch.randn((b, t, h, d), generator=gen,
                        device="cuda").to(q_dtype)
        entry = cs.random_cache(gen, b, seq, kv, d, cache)
        pos = torch.tensor(start, device="cuda")
        copies = min(cs.MAX_CACHE_COPIES,
                     -(-cs.ROTATE_BYTES // cs.cache_bytes(entry)))
        pool = [(entry,)] + [({n: x.clone() for n, x in entry.items()},)
                             for _ in range(copies - 1)]
        want = cs.decode_attention_reference(
            q.float(), {n: x if x.dtype == torch.int8 else x.float()
                        for n, x in entry.items()}, pos)
        base = real_plan(b, t, h, kv, seq, d, q_dtype, cache)
        plans = [base] + [with_plan(base, *map(int, pair.split(":")), d,
                                    cache)
                          for pair in args.plans.split(",") if pair]
        for p in plans:
            row = {"shape": label, "cache": cache_name, "splits": p.splits,
                   "stages": p.stages, "blocks_that_fit":
                   dmod.blocks_that_fit(p.smem_bytes), "ms": {},
                   "max_abs_err": {}, "card": card.strip()}
            dmod.plan = lambda *a, _p=p, **k: _p
            try:
                for r in range(args.rounds):
                    for name in libs if r % 2 == 0 else list(libs)[::-1]:
                        dmod._lib = libs[name]
                        got = dmod.decode_attention(q, entry, pos)
                        row["max_abs_err"][name] = (
                            got.float() - want).abs().max().item()
                        row["ms"].setdefault(name, []).append(cs.rotated_ms(
                            lambda e: dmod.decode_attention(q, e, pos),
                            pool, 30))
                        # a variant that skips the combine leaves its
                        # counters set
                        for counters in dmod._counters.values():
                            counters.zero_()
            finally:
                dmod.plan = real_plan
                dmod._lib = None
            print(json.dumps(row), flush=True)
        del pool, entry, q
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
