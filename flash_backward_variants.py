#!/usr/bin/env python3
"""Time source variants of the flash backward's 3xTF32 kernels
(``tpu_operator_libs_torch/csrc/flash_attention_bwd.cu`` over
``csrc/tf32_mma.cuh``) on one CUDA card, in turns, at ``chip_smoke.py``
phase 3b's float32 shapes, and beside them the scalar pair of another
checkout.

Variants (``VARIANTS``, string edits of a copy of ``csrc``):

- ``as_is``: the kernels as they are;
- ``cvt_rna``: hi and lo rounded by ``cvt.rna.tf32.f32`` in place of the
  integer add and mask (hi) and the unrounded lo;
- ``unrolled``: the first products' depth (head_dim) unrolled whole, not
  32 columns at a time;
- ``draft``: both, the first draft of the design;
- ``two_blocks``: a 128-register cap, two blocks an SM at head_dim <= 64.

With ``--scalar DIR`` the dK/dV and dQ pair of the checkout at DIR (an
earlier design with its own C signature, e.g. the parent's scalar
kernels: ``git archive <commit> | tar -x -C DIR``) is built from DIR's
own sources and timed in the same turns.

Each variant is built by ``nvcc`` (the package's flags) into
``build/flash_backward_variants/`` and swapped into the wrappers; each
turn (the variants in order, then reversed, ``--rounds`` times) checks
its dq, dk and dv against the plain backward (``limit_use`` under
``KERNEL_TOL``) and times dK/dV and dQ by CUDA events over 20 launches.
Run from the root of a checkout on a machine with a card:

    python3 flash_backward_variants.py [--variants as_is,cvt_rna,...]
        [--scalar DIR] [--rounds N]

Prints one JSON line a variant's build (registers and spills of its f32
instances), one a variant, shape and turn, and one a shape for SDPA's
backward; exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from tpu_operator_libs_torch.kernels import _build
from tpu_operator_libs_torch.kernels import flash_attention as fa

OUT_DIR = _build.BUILD_DIR.parent / "flash_backward_variants"
SOURCE = "flash_attention_bwd.cu"
_SPLIT = ("    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "    lo = __float_as_uint(x - __uint_as_float(hi));\n")
_CVT = ('    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
        '    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo)\n'
        '        : "f"(x - __uint_as_float(hi)));\n')
_CHUNK = ("  return D < 32 ? D : 32;\n", "  return D;\n")
_BOUNDS = ("__launch_bounds__(tf32::kThreads, 1)",
           "__launch_bounds__(tf32::kThreads, D <= 64 ? 2 : 1)")
#: the edits of each variant, by file: (text, replacement, count) triples
VARIANTS = {
    "as_is": {},
    "cvt_rna": {"tf32_mma.cuh": [(_SPLIT, _CVT, 1)]},
    "unrolled": {SOURCE: [(*_CHUNK, 1)]},
    "draft": {"tf32_mma.cuh": [(_SPLIT, _CVT, 1)], SOURCE: [(*_CHUNK, 1)]},
    "two_blocks": {SOURCE: [(*_BOUNDS, 2)]},
}
#: phase 3b's float32 rows: (label, B, H, H_kv, S, D)
SHAPES = [("c", 2, 8, 2, 1000, 64), ("f32_main", 2, 16, 16, 1024, 128),
          ("f32_d16", 2, 8, 2, 1000, 16)]


def _nvcc(csrc: Path, out: Path) -> str:
    run = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(out), str(csrc / SOURCE), *_build.NVCC_LIBS],
        capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"nvcc failed on {csrc / SOURCE}:\n"
                         f"{run.stderr[-4000:]}")
    return run.stderr


def build_variant(name) -> "tuple[ctypes.CDLL, dict]":
    """The backward library with the variant's edits, bound as the
    wrapper binds its own, and the registers and spill bytes of its f32
    tf32 instances by kernel and head_dim."""
    root = OUT_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, root / "csrc")
    for file, edits in VARIANTS[name].items():
        path = root / "csrc" / file
        text = path.read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"variant {name}: {file} holds {old!r} "
                                 f"{text.count(old)} times, not {count}; "
                                 "update VARIANTS")
            text = text.replace(old, new)
        path.write_text(text)
    report = _nvcc(root / "csrc", root / "bwd.so")
    regs = {}
    for block in report.split("Compiling entry function")[1:]:
        m = re.search(r"\d(flash_bwd_d[a-z]+_tf32_kernel)IfLi(\d+)E", block)
        if m:
            used = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            regs[f"{m.group(1)} D={m.group(2)}"] = {
                "registers": int(used.group(1)),
                "spill_store_bytes": int(spill.group(1)) if spill else 0}
    lib = _build.bind(ctypes.CDLL(str(root / "bwd.so")),
                      fa._ENTRY_POINTS[SOURCE], fa._ERROR_STRING)
    return lib, regs


def build_scalar(tree: Path) -> ctypes.CDLL:
    """The backward library of the checkout at ``tree``, with the C
    signature the scalar pair had: pointers, then B, H, Hkv, Sq, Sk, D,
    dtype, causal, sm_scale and the stream."""
    out = OUT_DIR / "scalar.so"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _nvcc(tree / "tpu_operator_libs_torch" / "csrc", out)
    lib = ctypes.CDLL(str(out))
    for fn, pointers in (("flash_attention_bwd_dkv", 8),
                         ("flash_attention_bwd_dq", 7)):
        getattr(lib, fn).argtypes = ([ctypes.c_void_p] * pointers
                                     + [ctypes.c_int] * 8
                                     + [ctypes.c_float, ctypes.c_void_p])
        getattr(lib, fn).restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def inputs(batch, heads, kv_heads, seq, dim):
    """phase 3b's inputs of the shape (float32, seed SEED + 10), the
    forward's lse, di and the plain backward's gradients."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    q, k, v, do = (torch.randn((batch, h, seq, dim), generator=gen,
                               device="cuda")
                   for h in (heads, kv_heads, kv_heads, heads))
    kw = {"causal": True, "sm_scale": dim ** -0.5}
    o, lse = fa.flash_forward(q, k, v, **kw)
    di = (o * do).sum(-1)
    refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    return {"q": q, "k": k, "v": v, "do": do, "lse": lse, "di": di,
            "refs": refs, "kw": kw}


def scalar_calls(lib, x):
    """(dkv, dq) callables of the scalar library on ``x`` and their
    outputs (dq, dk, dv)."""
    q, k = x["q"], x["k"]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, x["v"]))
    batch, heads, seq, dim = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    args = (batch, heads, k.shape[1], seq, k.shape[2], dim, 0, 1,
            x["kw"]["sm_scale"], stream)
    dkv_ptrs = [t.data_ptr() for t in (q, k, x["v"], x["do"], x["lse"],
                                       x["di"], dk, dv)]
    dq_ptrs = [t.data_ptr() for t in (q, k, x["v"], x["do"], x["lse"],
                                      x["di"], dq)]

    def dkv():
        _build.raise_on(lib.flash_attention_bwd_dkv(*dkv_ptrs, *args),
                        lib.flash_attention_error_string, "scalar dK/dV")

    def dq_fn():
        _build.raise_on(lib.flash_attention_bwd_dq(*dq_ptrs, *args),
                        lib.flash_attention_error_string, "scalar dQ")
    return dkv, dq_fn, (dq, dk, dv)


def turn(name, lib, x):
    """One variant at one shape: limit_use of dq, dk, dv and the two
    kernels' ms."""
    kw = x["kw"]
    args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["di"])
    if name == "scalar":
        dkv, dq_fn, got = scalar_calls(lib, x)
        dkv()
        dq_fn()
    else:
        fa._libs[SOURCE] = lib

        def dkv():
            return fa.flash_attention_bwd_dkv(*args, **kw)

        def dq_fn():
            return fa.flash_attention_bwd_dq(*args, **kw)
        got = (dq_fn(),) + dkv()
    torch.cuda.synchronize()
    rtol, atol = cs.KERNEL_TOL[torch.float32]
    uses = {grad: cs.limit_use((g - r).abs(), r, rtol, atol)
            for grad, g, r in zip(("dq", "dk", "dv"), got, x["refs"])}
    return {"limit_use": uses, "dkv_ms": cs.cuda_ms(dkv, 20),
            "dq_ms": cs.cuda_ms(dq_fn, 20)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--scalar", default=None)
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_backward_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    card = cs.phase_device()
    fa._library(SOURCE)  # the package's own build, for the forward
    libs = {}
    for name in args.variants.split(","):
        libs[name], regs = build_variant(name)
        print(json.dumps({"variant": name, "ptxas_f32": regs,
                          "card": card}), flush=True)
    if args.scalar:
        libs["scalar"] = build_scalar(Path(args.scalar).resolve())
    data = {shape[0]: inputs(*shape[1:]) for shape in SHAPES}
    names = list(libs)
    for round_ in range(args.rounds):
        for order in (names, names[::-1]):
            for name in order:
                for label, x in data.items():
                    print(json.dumps({"round": round_, "variant": name,
                                      "shape": label,
                                      **turn(name, libs[name], x),
                                      "card": card}), flush=True)
    for label, x in data.items():
        print(json.dumps({"shape": label, "library": "sdpa[efficient] "
                          "backward alone",
                          "library_ms": cs.sdpa_backward_ms(
                              x["q"], x["k"], x["v"], x["do"],
                              x["kw"]["sm_scale"], 20),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
