#!/usr/bin/env python3
"""Time source variants of the flash attention's 3xTF32 kernels, the
forward and the backward pair
(``tpu_operator_libs_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` over ``csrc/tf32_mma.cuh`` and
``csrc/tf32_block.cuh``) on one CUDA card, in turns, at ``chip_smoke.py``
phase 3b's float32 shapes, and beside them the kernels of other
checkouts.

Variants (``VARIANTS``, string edits of a copy of ``csrc``):

- ``as_is``: the kernels as they are;
- ``cvt_rna``: hi and lo rounded by ``cvt.rna.tf32.f32`` in place of the
  integer add and mask (hi) and the unrounded lo;
- ``unrolled``: the backward's first products' depth (head_dim) unrolled
  whole, not 32 columns at a time (the forward's is whole already);
- ``draft``: both, the first draft of the design;
- ``two_blocks``: a 128-register cap, two blocks an SM at head_dim <= 64;
- ``fwd_two_blocks``: the same cap on the forward alone;
- ``fwd_chunked``: the forward's S unrolled 32 columns of head_dim at a
  time, as the backward's first products, not whole.

With ``--scalar DIR`` the dK/dV and dQ pair of the checkout at DIR (an
earlier design with its own C signature, e.g. an earlier scalar pair:
``git archive <commit> | tar -x -C DIR``) is built from DIR's own
sources and timed in the same turns; with ``--forward DIR`` the forward
of the checkout at DIR (whose C interface is this one's, e.g. the
scalar forward the 3xTF32 one replaced), likewise.

Each variant is built by ``nvcc`` (the package's flags) into
``build/flash_backward_variants/``; its backward is swapped into the
wrappers and its forward called through its own library. Each turn (the
variants in order, then reversed, ``--rounds`` times) checks the
forward's out and lse against the plain forward and dq, dk and dv
against the plain backward (``limit_use`` under ``KERNEL_TOL``) and
times the forward, dK/dV and dQ by CUDA events over 20 launches. Run
from the root of a checkout on a machine with a card:

    python3 flash_backward_variants.py [--variants as_is,cvt_rna,...]
        [--scalar DIR] [--forward DIR] [--rounds N]

Prints one JSON line a variant's build (registers and spills of its
3xTF32 instances), one a variant, shape and turn, and one a shape for
SDPA's forward and backward; exits 1 without CUDA.
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
FORWARD, SOURCE = fa.SOURCES
_SPLIT = ("    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "    lo = __float_as_uint(x - __uint_as_float(hi));\n")
_CVT = ('    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
        '    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo)\n'
        '        : "f"(x - __uint_as_float(hi)));\n')
_CHUNK = ("  return D < 32 ? D : 32;\n", "  return D;\n")
_BOUNDS = ("__launch_bounds__(tf32::kThreads, 1)",
           "__launch_bounds__(tf32::kThreads, D <= 64 ? 2 : 1)")
_FWD_DEPTH = ("#pragma unroll\n      for (int c = 0; c < D; c += 8) {\n",
              "#pragma unroll 4\n      for (int c = 0; c < D; c += 8) {\n")
#: the edits of each variant, by file: (text, replacement, count) triples
VARIANTS = {
    "as_is": {},
    "cvt_rna": {"tf32_mma.cuh": [(_SPLIT, _CVT, 1)]},
    "unrolled": {"tf32_block.cuh": [(*_CHUNK, 1)]},
    "draft": {"tf32_mma.cuh": [(_SPLIT, _CVT, 1)],
              "tf32_block.cuh": [(*_CHUNK, 1)]},
    "two_blocks": {SOURCE: [(*_BOUNDS, 2)]},
    "fwd_two_blocks": {FORWARD: [(*_BOUNDS, 1)]},
    "fwd_chunked": {FORWARD: [(*_FWD_DEPTH, 1)]},
}
#: phase 3b's float32 rows: (label, B, H, H_kv, S, D)
SHAPES = [("c", 2, 8, 2, 1000, 64), ("f32_main", 2, 16, 16, 1024, 128),
          ("f32_d16", 2, 8, 2, 1000, 16)]


def _nvcc(csrc: Path, out: Path, source: str = SOURCE) -> str:
    run = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(out), str(csrc / source), *_build.NVCC_LIBS],
        capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"nvcc failed on {csrc / source}:\n"
                         f"{run.stderr[-4000:]}")
    return run.stderr


def _bind(path: Path, source: str) -> ctypes.CDLL:
    return _build.bind(ctypes.CDLL(str(path)), fa._ENTRY_POINTS[source],
                       fa._ERROR_STRING)


def build_variant(name) -> "tuple[dict, dict]":
    """The forward and backward libraries with the variant's edits, by
    source, bound as the wrappers bind their own, and the registers and
    spill bytes of their 3xTF32 instances by kernel, dtype and
    head_dim."""
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
    libs, regs = {}, {}
    for source in (FORWARD, SOURCE):
        out = root / f"{Path(source).stem}.so"
        report = _nvcc(root / "csrc", out, source)
        for block in report.split("Compiling entry function")[1:]:
            m = re.search(r"\d(flash_(?:fwd|bwd_d[a-z]+)_tf32_kernel)I"
                          r"(f|13__nv_bfloat16)Li(\d+)E", block)
            if m:
                used = re.search(r"Used (\d+) registers", block)
                spill = re.search(r"(\d+) bytes spill stores", block)
                dtype = "float32" if m.group(2) == "f" else "bfloat16"
                regs[f"{m.group(1)} {dtype} D={m.group(3)}"] = {
                    "registers": int(used.group(1)),
                    "spill_store_bytes": int(spill.group(1)) if spill
                    else 0}
        libs[source] = _bind(out, source)
    return libs, regs


def build_forward(tree: Path) -> ctypes.CDLL:
    """The forward library of the checkout at ``tree``, bound as this
    one's."""
    out = OUT_DIR / "forward.so"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _nvcc(tree / "tpu_operator_libs_torch" / "csrc", out, FORWARD)
    return _bind(out, FORWARD)


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
            "refs": refs, "kw": kw,
            "fwd_refs": fa.flash_attention_reference(q, k, v, **kw)}


def forward_call(lib, x):
    """A callable of the forward library ``lib`` on ``x`` and its
    outputs (out, lse)."""
    q, k = x["q"], x["k"]
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    batch, heads, seq, dim = q.shape
    args = (batch, heads, k.shape[1], seq, k.shape[2], dim, 0, 1,
            x["kw"]["sm_scale"], torch.cuda.current_stream().cuda_stream)
    ptrs = [t.data_ptr() for t in (q, k, x["v"], out, lse)]

    def fwd():
        _build.raise_on(lib.flash_attention_fwd(*ptrs, *args),
                        lib.flash_attention_error_string, "forward")
    return fwd, (out, lse)


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


def forward_turn(lib, x):
    """The forward's limit_use, lse max|err| and ms at one shape."""
    fwd, (out, lse) = forward_call(lib, x)
    fwd()
    torch.cuda.synchronize()
    ref, ref_lse = x["fwd_refs"]
    rtol, atol = cs.KERNEL_TOL[torch.float32]
    return {"fwd_limit_use": cs.limit_use((out - ref).abs(), ref, rtol,
                                          atol),
            "fwd_lse_max_abs_err": (lse - ref_lse).abs().max().item(),
            "fwd_ms": cs.cuda_ms(fwd, 20)}


def turn(name, libs, x):
    """One variant at one shape: the forward's row (:func:`forward_turn`)
    where ``libs`` holds a forward, and limit_use of dq, dk, dv and the
    two backward kernels' ms where it holds a backward."""
    row = forward_turn(libs[FORWARD], x) if FORWARD in libs else {}
    if SOURCE not in libs:
        return row
    kw = x["kw"]
    args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["di"])
    if name == "scalar":
        dkv, dq_fn, got = scalar_calls(libs[SOURCE], x)
        dkv()
        dq_fn()
    else:
        fa._libs[SOURCE] = libs[SOURCE]

        def dkv():
            return fa.flash_attention_bwd_dkv(*args, **kw)

        def dq_fn():
            return fa.flash_attention_bwd_dq(*args, **kw)
        got = (dq_fn(),) + dkv()
    torch.cuda.synchronize()
    rtol, atol = cs.KERNEL_TOL[torch.float32]
    uses = {grad: cs.limit_use((g - r).abs(), r, rtol, atol)
            for grad, g, r in zip(("dq", "dk", "dv"), got, x["refs"])}
    return {**row, "limit_use": uses, "dkv_ms": cs.cuda_ms(dkv, 20),
            "dq_ms": cs.cuda_ms(dq_fn, 20)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--scalar", default=None)
    parser.add_argument("--forward", default=None)
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_backward_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    card = cs.phase_device()
    fa._library(SOURCE)  # the package's own build, for the inputs' lse
    libs = {}
    for name in args.variants.split(","):
        libs[name], regs = build_variant(name)
        print(json.dumps({"variant": name, "ptxas_f32": regs,
                          "card": card}), flush=True)
    if args.scalar:
        libs["scalar"] = {SOURCE: build_scalar(Path(args.scalar).resolve())}
    if args.forward:
        libs["forward"] = {FORWARD: build_forward(
            Path(args.forward).resolve())}
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
        group = x["q"].shape[1] // x["k"].shape[1]
        k, v = (x[n].repeat_interleave(group, dim=1) for n in ("k", "v"))
        with cs.sdpa_kernel(cs.SDPA_BACKENDS[torch.float32][0]):
            fwd_ms = cs.cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    x["q"], k, v, is_causal=True,
                    scale=x["kw"]["sm_scale"]), 20)
        print(json.dumps({"shape": label, "library": "sdpa[efficient]",
                          "forward_ms": fwd_ms,
                          "backward_alone_ms": cs.sdpa_backward_ms(
                              x["q"], x["k"], x["v"], x["do"],
                              x["kw"]["sm_scale"], 20),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
