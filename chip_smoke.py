#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and multi-device slices on
the CUDA cards at full width.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

(``python3 chip_smoke.py --multichip-only`` runs phases 1, 2 and 9 alone,
for a machine with several cards; ``python3 chip_smoke.py --train-turns
DIR`` runs phase 7 of the checkout at DIR and of this one in turns, DIR,
this, this, DIR, one process a turn, to compare two commits on one
card.)

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
   the train step's shape and six more (an odd length among them; f32 at
   head_dim 64, 128 and 16 through the 3xTF32 design), two launches
   bit-equal, each row naming the design it ran, its grid as
   torch.profiler recorded the launch (checked against the grid its
   launcher reports) and its instance's registers and spills, timed
   beside SDPA's backward alone; the 3xTF32 rows hold the tensor-core
   bound of three TF32 products beside the f32 bound, and (c)'s and
   f32_main's limit_use over 8 seeds.
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
   512, phase 9's tp shards at M 4, a ragged shape, one f32 row) and at
   the edges of its plan (ragged prefill M, M around the wgmma design's
   threshold, an N that TMA cannot take, ragged wgmma tiles in K and N),
   each row naming the design it ran and its CUDA launches a call (1);
   two launches and a graph-replayed one bit-equal; timed in CUDA graphs
   over copies of the weight that overflow L2 (so read from device
   memory), beside ``torch._weight_int8pack_mm`` and cuBLAS on a bf16
   copy.
3e. decode_kernels: the cached step's attention kernel and the two
   entries of its cache-write kernel (``rope_kv_append``, which rotates q
   and k and writes the cache in one launch, and the rotation-free
   ``kv_append``) against their plain versions at the shapes the decode
   paths give them (the bench decode at the last and a middle position,
   its prefill block, phase 9's tp shard, each over a bf16 and an int8
   cache; GQA in f32, bf16 queries over an f32 cache, head_dims 64, 16
   and 8, a ragged S), each row naming its design and its CUDA launches
   a call (1); the attention within ``KERNEL_TOL`` of the plain version
   in float32, the cache writes (and the rotated q) bit-equal to their
   plain versions and touching no other row; two launches and a
   graph-replayed one bit-equal; the attention's output
   unchanged by NaN planted past the position and its split counters back
   at 0; timed in CUDA graphs over cache copies that overflow L2, the
   attention beside SDPA with the boolean mask where the cache is float
   and of q's dtype, its bound over the visible keys and over the whole
   cache.
3f. norm_gate_kernels: the norm kernel (the residual add folded in, with
   and without it) and its backward (with and without the residual
   output's gradient), and the gate kernel and its backward, against
   their plain versions at the shapes the paths give them (the bench
   decode, the prefill block, the train step's, f32 and an odd width;
   the gate at the tp = 2 shard too): one CUDA launch a call, two
   launches and a graph-replayed one bit-equal (the backward's dw summed
   over every row in order), timed in CUDA graphs beside the plain
   version, the autograd of the plain version (the backward rows) and
   ``torch.nn.functional.rms_norm`` (the norm rows); the two forwards
   (launched with programmatic dependent launch) report their plan's
   layout and their instance's registers and spills, and at the bench
   decode are timed also after the product before them on the step (the
   O projection, the up projection): graph(product + kernel) less
   graph(product).
3g. train_kernels: the batch forward's RoPE kernel (q and k rotated, v
   copied, in the flash path's head-major layout or the input's) and its
   backward against their plain versions at the train step's shape in
   both layouts, the ring's block at its global positions, f32, head_dims
   64, 16, 8 and 18 and an odd S: every output bit-equal (zeros and
   negative zeros planted in the gradients), the launch contract, timed
   in CUDA graphs beside the plain versions; the AdamW kernel over
   llama-277M's 39 leaves against its plain version in bf16 and f32, a
   constant rate and the warmup-cosine schedule at counts 0 and 5, the
   clip with a norm above and below its limit, weight decay 1e-4 and 0:
   new p, m and v bit-equal, the inputs unchanged, the launch contract of
   the kernel alone, timed beside the plain version and
   ``torch._fused_adamw_``; the loss's forward and backward kernels
   against their plain version and its autograd at the train step's
   logits (16, 1024, 2048) bf16, f32, an odd vocabulary (1001), a
   128,256-wide one at few rows and a ring block (S_used = S): the loss
   within 1e-5 relative, dlogits within one bf16 ulp (f32: 1e-5 relative
   plus 2^-20 of the gradient's scale) and 0 past S_used, the launch
   contract, timed beside the plain version
   and ``F.cross_entropy`` (forward, backward, and both); the clip's
   global norm over the 39 leaves in bf16 and f32 within 1e-5 relative,
   the launch contract, timed beside the plain version and
   ``torch._foreach_norm``.
3h. token_pick: the decode step's token-pick kernel against its plain
   version (``pick_reference``) at the bench decode's (8, 2048) in bf16
   and f32, greedy, sampled at the decode contract's settings
   (temperature 1.0, top-k 50, top-p 0.9) with and without the logprob,
   and at the served temperature alone, the prefill's strided
   ``logits[:, -1, :]``, vocabularies of 1001 (4 rows) and 128,256 (2
   rows, a cluster of 8 blocks a row), and edge settings over planted
   rows (top-k 1
   and V, top-p 1e-9 and 1.0, temperature 0.05; tied maxima, -inf):
   greedy tokens bit-equal, sampled tokens equal over several noise
   draws but where either token's nucleus decision rests on a mass
   within 1e-5 of top-p (the exempt rows counted), logprobs within 1e-5
   relative plus 1e-6, the launch contract, timed in CUDA graphs beside
   the plain version (its launches counted) and, greedy,
   ``torch.argmax``.
4-6. the serving path, with the launch counts set to 0 just before it:
   ``forward`` of llama-277M with ``attention_impl="flash"`` against
   ``"xla"``; the decode contract (stepwise cache == batch forward, host
   loop == graph-replayed device loop in bf16, int8 weights + int8 KV
   and a sampled case with eos and logprobs; each call's graph launches
   and capture ms; decode_attention and rope_kv_append launched once a
   layer a forward, the norm 2L + 1 times and the gate L times, the
   token pick once a forward of a decode, kv_append never);
   a ``DecodeServer`` burst with a mid-burst drain, then decode at the
   bench's shape through the graph and the host loop, greedy and
   sampled (the decode contract's settings, with logprobs, and what
   ``DecodeServer(temperature=)`` sends, the temperature alone: graph ==
   host loop bit for bit), each with its tok/s and device events a
   token.
7-8. the training path, with the launch counts set to 0 just before it:
   6 steps of ``make_train_step`` (flash, batch 16, seq 1024, bf16; RoPE
   and its backward once a layer, the loss and its backward and AdamW
   once a step), the update's own time, the loss's device time by its
   kernels and by the plain version, its gradients against ``"xla"`` and
   against ``remat=True``; then the clipped trainer configuration
   (``--grad-clip-norm`` 1.0 behind the warmup-cosine schedule: the
   global norm once a step, the first loss bit-equal to the unclipped
   run's, the first step's norm and whether the clip bound); then save ->
   checkpoint gate -> restore into another seed's state -> the next
   loss equal bit for bit.
9. multichip, with the launch counts set to 0 just before it in its
   ranks: the one-card probe step; then one NCCL rank per visible card
   over the dp x tp mesh (``parallel.dp_tp_split``) running llama-277M
   (flash at tp=1, xla otherwise): 3 train steps at batch 16 x 1024
   (at one card, the losses held to phase 7's first three), host loop ==
   device loop decode in bf16 and int8 (the device loop replayed from one
   CUDA graph a token on every rank, its launches checked on each), then
   decode at the bench's shape through the graph and the host loop on
   every rank (at one card, the graph's tokens held to phase 6's), save
   -> gate -> restore -> the next loss bit-equal, the fabric battery over
   every shifted ring, and at two cards or more the bandwidth ring; then,
   at llama-277M's widths, ring (ring attention against dense; the ring
   Llama on a 1 x n dp x sp mesh, its forward at 1 x 8192 against the
   one-card flash forward and 3 train steps at 16 x 1024, held to phase
   7's at one card), pipeline (GPipe, f32) and moe (both dispatch modes,
   f32); last, the serving pod over NCCL on phase 6's burst.
10. kernels: one line with every kernel's launches, error and times.

The last line is ``{"ok": true, "device": {...}}``. The model is
llama-277M as ``bench.py`` builds it (vocab 2048, d_model 2048, 4
layers, 16 heads, head_dim 128, d_ff 8192, bf16), with random weights
from a seed. Without CUDA the script exits 1.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from decode_step_profile import (  # noqa: E402
    SAMPLED_CELLS,
    SAMPLING,
    SERVED_SAMPLING,
)
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
    serve_rank,
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
    restore_launches,
    save_launches,
)
from tpu_operator_libs_torch.kernels.attention_fold import (  # noqa: E402
    attention_fold,
    attention_fold_reference,
)
from tpu_operator_libs_torch.kernels.decode_attention import (  # noqa: E402
    _counters as decode_counters,
    blocks_that_fit as decode_blocks_that_fit,
    decode_attention,
    decode_attention_reference,
    output_dtype as decode_output_dtype,
    plan as decode_plan,
)
from tpu_operator_libs_torch.kernels.kv_append import (  # noqa: E402
    _quantize_kv_block,
    _rope,
    kv_append,
    kv_append_reference,
    rope_kv_append,
    rope_kv_append_reference,
    vector_width,
)
from tpu_operator_libs_torch.kernels import rms_norm as norm_mod  # noqa: E402
from tpu_operator_libs_torch.kernels.rms_norm import (  # noqa: E402
    _rms_parts,
    add_rms_norm,
    add_rms_norm_reference,
    rms_norm_backward_reference,
    rms_norm_bwd,
    rms_norm_reference,
)
from tpu_operator_libs_torch.kernels import swiglu as gate_mod  # noqa: E402
from tpu_operator_libs_torch.kernels.swiglu import (  # noqa: E402
    swiglu,
    swiglu_backward_reference,
    swiglu_bwd,
    swiglu_reference,
    vector_width as gate_vector_width,
)
from tpu_operator_libs_torch.kernels import adamw as adamw_mod  # noqa: E402
from tpu_operator_libs_torch.kernels import (  # noqa: E402
    cross_entropy as loss_mod,
    global_norm as gnorm_mod,
)
from tpu_operator_libs_torch.kernels import rope as rope_mod  # noqa: E402
from tpu_operator_libs_torch.kernels import (  # noqa: E402
    token_pick as pick_mod,
)
from tpu_operator_libs_torch.kernels.rope import (  # noqa: E402
    rope_bwd,
    rope_qk,
)
from tpu_operator_libs_torch.kernels.int8_matmul import (  # noqa: E402
    int8_matmul,
    int8_matmul_reference,
    plan as int8_plan,
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
    launch_blocks,
)
from tpu_operator_libs_torch.optim import (  # noqa: E402
    AdamW,
    tree_leaves,
    value_and_grad,
)
from tpu_operator_libs_torch.parallel import (  # noqa: E402
    dp_tp_split,
    global_norm,
    run_ranks,
)
from decode_step_profile import PORT_KERNELS, port_kernel  # noqa: E402

#: H100 SXM published dense peaks (NVIDIA data sheet, no sparsity): bf16
#: and f32 (CUDA cores) by dtype, and TF32 on the tensor cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
#: the backward's design for f32 and narrow bf16 (kernel_design's name)
TF32_DESIGN = "3xTF32 mma.sync"
PEAK_BYTES = 3.35e12

#: llama-277M at bench.py's defaults (bench.py:551-555 with D=2048)
CONFIG_277M = LlamaConfig(vocab=2048, d_model=2048, n_layers=4,
                          n_heads=16, n_kv_heads=16, d_ff=8192,
                          seq_len=1024, learning_rate=1e-4)
#: the train step's shape (bench.py:530-533): batch 16, seq 1024
TRAIN_BATCH = 16
TRAIN_ROWS = TRAIN_BATCH * CONFIG_277M.seq_len

#: Kernel against plain version: (rtol, atol) on the output.
#: bf16: both sides accumulate in f32 and round once to bf16, so they may
#: differ by one bf16 ulp of the output, which is at most 2^-7 * |out|;
#: atol covers outputs near 0 where the f32 sums differ in order.
#: f32: sums in another order over <= 8192 keys; 2e-5 is the tolerance
#: the CPU test holds the plain version to against the Pallas kernel. The
#: backward's dK/dV sum up to S * H / H_kv pair terms (4,000 at shape
#: (c)), where their sound reading on an H100 80GB HBM3 at 700 W (2.0e-5
#: for the scalar design, up to 6.0e-5 and a limit_use of 0.75 for the
#: 3xTF32 one, PERF.md §6) passes through the rtol term; wrong variants of the algorithm there
#: (dK unscaled, a group head dropped, the ragged key tile dropped,
#: inputs staged as bf16, one TF32 product) are off by 1.4e-2 and more,
#: or 10x the limit and more (tests/test_torch_flash_attention.py). Each row
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
                       causal=True, peak=None, passes=1):
    """Least time for the work these inputs need: the larger of the
    FLOPs of the visible (query, key) pairs, each product run ``passes``
    times, over the dtype's peak (or ``peak``) and Q, K, V, O and the
    lse moved once over the memory rate."""
    # QK^T and PV, 2 FLOPs/MAC
    flops = passes * 4 * batch * heads * dim * visible_pairs(sq, sk, causal)
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (2 * batch * heads * sq * dim
                       + 2 * batch * kv_heads * sk * dim)
              + 4 * batch * heads * sq)
    t_flops = flops / (peak or PEAK_FLOPS[dtype])
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
    "flash_fwd_tf32_kernel": ("flash_attention_fwd", None),
    "flash_fwd_wgmma_kernel": ("flash_attention_fwd", torch.bfloat16),
    "flash_bwd_dkv_tf32_kernel": ("flash_attention_bwd_dkv", None),
    "flash_bwd_dkv_wgmma_kernel": ("flash_attention_bwd_dkv",
                                   torch.bfloat16),
    "flash_bwd_dq_tf32_kernel": ("flash_attention_bwd_dq", None),
    "flash_bwd_dq_wgmma_kernel": ("flash_attention_bwd_dq", torch.bfloat16),
}


def ptxas_entry(block, kernel, dtype, head_dim, design, serialized=()):
    """One kernel instance's line of the build phase from its ptxas
    report; ``serialized``: the mangled names that ptxas warned (C7515)
    run their wgmma serialised, a warning it may print apart from the
    function's own lines."""
    name = re.match(r"\s*'([^']+)'", block)
    regs = re.search(r"Used (\d+) registers", block)
    smem = re.search(r"(\d+) bytes smem", block)
    spill = re.search(r"(\d+) bytes spill stores", block)
    stack = re.search(r"(\d+) bytes cumulative stack size", block)
    return {"kernel": kernel, "dtype": str(dtype).replace("torch.", ""),
            "head_dim": head_dim, "design": design["design"],
            "registers": int(regs.group(1)) if regs else None,
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
            "dynamic_smem_bytes": design["dynamic_smem_bytes"],
            "spill_store_bytes": int(spill.group(1)) if spill else 0,
            # local memory, e.g. an array indexed at run time
            "stack_bytes": int(stack.group(1)) if stack else 0,
            # ptxas serialises wgmma it cannot keep asynchronous; a note
            # that names a function is that function's, wherever it falls
            "wgmma_serialized": (
                name is not None and name.group(1) in serialized) or (
                "serialized" in block
                and not re.search(r"serialized[^\n]*function '", block))}


#: the build phase's ptxas entries by source (empty for a reused build)
BUILT_INSTANCES: "dict[str, list]" = {}


def instance_ptxas(source, kernel, keys=("registers", "spill_store_bytes",
                                         "stack_bytes"), **template):
    """``keys`` (registers, spills and stack) of the built instance of
    ``kernel`` with these template arguments, from the build phase's
    ptxas report; "not reported" where the build was reused (ptxas did
    not run)."""
    for entry in BUILT_INSTANCES.get(source, []):
        if entry["kernel"] == kernel and all(
                entry.get(k) == v for k, v in template.items()):
            return {k: entry[k] for k in keys}
    return "not reported (a reused build: ptxas did not run)"


def wgmma_ring(block_m):
    """The int8 wgmma kernel's ring stages and dynamic shared memory at a
    tile of block_m rows by 128 columns (``wg::Tile`` in the source): a
    stage is the x box (block_m rows of 128 bytes) and an 8 KB code box;
    the epilogue's buffer holds the tile's bf16 output; as many stages as
    fit beside it, at most 8, and 1024 bytes of alignment."""
    stage = block_m * 128 + 8192
    epilogue = block_m * 128 * 2
    stages = min(8, (232448 - 256 - 1024 - epilogue) // stage)
    return stages, 1024 + stages * stage + epilogue


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
        serialized = set(re.findall(r"serialized[^\n]*function '([^']+)'",
                                    lib.ptxas_report))
        for block in lib.ptxas_report.split("Compiling entry function")[1:]:
            def loads(aligned):  # the template's kAligned, mangled
                return "16-byte cp.async" if aligned == "1" else "bytewise"
            mf = re.search(r"\d(int8_matmul_kernel)ILi(\d)ELb([01])E", block)
            if mf is not None:
                # kRing stages of 64 x 128 codes and 64 f32 columns of kM
                # rows of x
                entries.append(ptxas_entry(
                    block, mf.group(1), torch.float32, None,
                    {"design": f"cuda_cores: {mf.group(2)} rows of x a "
                               f"block, {loads(mf.group(3))} ring, "
                               "in-kernel split-K fixup",
                     "dynamic_smem_bytes": 6 * (64 * 128
                                                + int(mf.group(2)) * 64 * 4)},
                    serialized))
                continue
            ms = re.search(r"\d(int8_matmul_streamk_kernel)ILi(\d)ELi(\d)E",
                           block)
            if ms is not None:
                rows, boxes = 8 * int(ms.group(2)), int(ms.group(3))
                # 4 stages of 16 KB of codes and the x boxes of their
                # 16384 / (128 boxes) rows of K, from a 1024-byte boundary
                stage_k = 16384 // (128 * boxes)
                entries.append(ptxas_entry(
                    block, ms.group(1), torch.bfloat16, None,
                    {"design": f"stream_k: {rows} x {128 * boxes} tiles, "
                               "TMA ring, persistent grid, tickets by "
                               "tile and warp",
                     "dynamic_smem_bytes": 1024 + 4 * (
                         16384 + stage_k // 64 * rows * 128)},
                    serialized))
                continue
            mm = re.search(r"\d(int8_matmul_mma_kernel)ILb([01])ELi(\d)E",
                           block)
            if mm is not None:
                rows = 8 * int(mm.group(3))
                # kRing stages of 128 x 128 codes and `rows` rows of 144
                # bf16, or the 8 warps' f32 sums that reuse them
                entries.append(ptxas_entry(
                    block, mm.group(1), torch.bfloat16, None,
                    {"design": f"mma_sync: {rows} rows of x a block, "
                               f"{loads(mm.group(2))} ring, in-kernel "
                               "split-K fixup",
                     "dynamic_smem_bytes": max(
                         4 * (128 * 128 + rows * 144 * 2),
                         8 * rows * 128 * 4)},
                    serialized))
                continue
            mw = re.search(r"\d(int8_matmul_wgmma_kernel)ILi(\d+)E", block)
            if mw is not None:
                block_m = int(mw.group(2))
                stages, smem = wgmma_ring(block_m)
                entries.append(ptxas_entry(
                    block, mw.group(1), torch.bfloat16, None,
                    {"design": f"wgmma: {block_m} x 128 tiles, "
                               f"persistent, a {stages}-stage TMA ring, "
                               "codes converted in registers",
                     "dynamic_smem_bytes": smem}, serialized))
                continue
            da = re.search(r"\d(decode_attention_kernel)I(f|13__nv_bfloat16|a)"
                           r"Lb([01])E", block)
            if da is not None:
                cache = {"f": torch.float32, "a": torch.int8}.get(
                    da.group(2), torch.bfloat16)
                entries.append(ptxas_entry(
                    block, da.group(1), cache, None,
                    {"design": "cuda cores: a ring of key tiles by "
                               + ("16-byte cp.async" if da.group(3) == "1"
                                  else "element loads"),
                     # it depends on head_dim, the key tile and the stages
                     "dynamic_smem_bytes": None}, serialized))
                continue
            dm = re.search(r"\d(decode_attention_mma_kernel)I"
                           r"(13__nv_bfloat16|a)Li(\d+)E", block)
            if dm is not None:
                entries.append(ptxas_entry(
                    block, dm.group(1),
                    torch.int8 if dm.group(2) == "a" else torch.bfloat16,
                    int(dm.group(3)),
                    {"design": "tensor cores: mma.sync m16n8k16, head_dim "
                               f"up to {dm.group(3)}",
                     "dynamic_smem_bytes": None}, serialized))
                continue
            ka = re.search(r"\d((?:rope_)?kv_append_kernel)ILi([12])E", block)
            if ka is not None:
                entries.append(ptxas_entry(
                    block, ka.group(1), "any", None,
                    {"design": append_design(ka.group(1) != "kv_append_kernel",
                                             int(ka.group(2))),
                     "dynamic_smem_bytes": 0}))
                continue
            nf = re.search(r"\d(rms_norm_fwd_kernel)ILi(\d)ELi(\d)ELb([01])E",
                           block)
            if nf is not None:
                vec, loads = int(nf.group(2)), int(nf.group(3))
                packed = nf.group(4) == "1"
                entries.append({**ptxas_entry(
                    block, nf.group(1), "bfloat16" if packed else "any", None,
                    {"design": norm_instance_design(vec, loads, packed),
                     "dynamic_smem_bytes": 0}), "vec": vec, "loads": loads,
                    "packed": packed})
                continue
            sf = re.search(r"\d(swiglu_fwd_kernel)I(f|13__nv_bfloat16)Li(\d)E"
                           r"Li(\d)E", block)
            if sf is not None:
                vec, unroll = int(sf.group(3)), int(sf.group(4))
                entries.append({**ptxas_entry(
                    block, sf.group(1), torch.float32 if sf.group(2) == "f"
                    else torch.bfloat16, None,
                    {"design": f"{unroll} vectors of {vec} a thread",
                     "dynamic_smem_bytes": 0}), "vec": vec,
                    "unroll": unroll})
                continue
            nb = re.search(r"\d(rms_norm_bwd_kernel)ILi(\d)ELi(\d)ELb([01])E"
                           r"Lb([01])E", block)
            if nb is not None:
                vec, loads = int(nb.group(2)), int(nb.group(3))
                packed, ds = nb.group(4) == "1", nb.group(5) == "1"
                # dw's exchange or sums: dim floats, set by the launch
                entries.append({**ptxas_entry(
                    block, nb.group(1), "bfloat16" if packed else "any", None,
                    {"design": norm_instance_design(vec, loads, packed)
                     + (", with ds" if ds else ", without ds"),
                     "dynamic_smem_bytes": None}), "vec": vec,
                    "loads": loads, "packed": packed, "ds": ds})
                continue
            nk = re.search(r"\d(swiglu_bwd_kernel)ILi(\d)E", block)
            if nk is not None:
                entries.append(ptxas_entry(
                    block, nk.group(1), "any", None,
                    {"design": f"{nk.group(2)} elements a load",
                     "dynamic_smem_bytes": 0}))
                continue
            rk = re.search(r"\d(rope_kernel)ILb([01])ELi(\d)E", block)
            if rk is not None:
                entries.append({**ptxas_entry(
                    block, rk.group(1), "any", None,
                    {"design": ("backward" if rk.group(2) == "1"
                                else "forward") + f", {rk.group(3)} pairs "
                               "a thread",
                     "dynamic_smem_bytes": 0}),
                    "backward": rk.group(2) == "1", "vec": int(rk.group(3))})
                continue
            ce = re.search(r"\d(cross_entropy_(?:wide|fwd|bwd)_kernel)"
                           r"ILi(\d)E", block)
            if ce is not None:
                entries.append({**ptxas_entry(
                    block, ce.group(1), "any", None,
                    {"design": loss_design(ce.group(1), int(ce.group(2))),
                     "dynamic_smem_bytes": 0}), "vec": int(ce.group(2))})
                continue
            gn = re.search(r"\d(global_norm_kernel)ILi(\d)E", block)
            if gn is not None:
                entries.append({**ptxas_entry(
                    block, gn.group(1), "any", None,
                    {"design": global_norm_design(int(gn.group(2))),
                     "dynamic_smem_bytes": 0}), "vec": int(gn.group(2))})
                continue
            tk = re.search(r"\d(token_pick_(?:block|wide)_kernel)ILi(\d)E"
                           r"Lb([01])E", block)
            if tk is not None:
                vec = int(tk.group(2))
                entries.append({**ptxas_entry(
                    block, tk.group(1), "any", None,
                    {"design": pick_design(
                        2048 if "block" in tk.group(1) else 4096, vec)
                     + (", sampled" if tk.group(3) == "1" else ", greedy"),
                     "dynamic_smem_bytes": 0 if "block" in tk.group(1)
                     else None}), "vec": vec,
                    "sample": tk.group(3) == "1"})
                continue
            ak = re.search(r"\d(adamw_kernel)ILi(\d)E", block)
            if ak is not None:
                entries.append({**ptxas_entry(
                    block, ak.group(1), "any", None,
                    {"design": f"{ak.group(2)} elements a load",
                     "dynamic_smem_bytes": 0}), "vec": int(ak.group(2))})
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
            name = re.search(r"\d(flash_[a-z]+(?:_[a-z0-9]+)*?_kernel)I"
                             r"(13__nv_bfloat16|f)?Li(\d+)E", block)
            if name is None:
                raise RuntimeError(f"unrecognised ptxas entry: {block[:200]}")
            wrapper, fixed_dtype = KERNEL_TEMPLATES[name.group(1)]
            dtype = fixed_dtype or (torch.bfloat16 if name.group(2) != "f"
                                    else torch.float32)
            head_dim = int(name.group(3))
            entries.append(ptxas_entry(block, name.group(1), dtype, head_dim,
                                       kernel_design(wrapper, dtype,
                                                     head_dim), serialized))
        BUILT_INSTANCES[source] = entries
        emit({"phase": "build", "source": source,
              "build_seconds": lib.build_seconds, "wall_seconds_all": wall,
              "ptxas": entries})


def limit_use(err, ref, rtol, atol) -> float:
    """The largest share of its limit, atol + rtol * |ref|, that an
    element's error ``err`` takes: the check passes while it is <= 1."""
    return (err / (atol + rtol * ref.float().abs())).max().item()


def forward_inputs(seed, batch, heads, kv_heads, seq, dim, dtype):
    """q, k and v for a forward row, drawn on the card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    return (randn(batch, heads, seq, dim), randn(batch, kv_heads, seq, dim),
            randn(batch, kv_heads, seq, dim))


def forward_limit_use(seed, batch, heads, kv_heads, seq, dim, dtype,
                      causal=True) -> dict:
    """The forward kernel's limit_use under KERNEL_TOL and its lse's
    max|err| against the plain version, on inputs drawn from ``seed``."""
    q, k, v = forward_inputs(seed, batch, heads, kv_heads, seq, dim, dtype)
    kw = {"causal": causal, "sm_scale": dim ** -0.5}
    out, lse = flash_forward(q, k, v, **kw)
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    return {"o": limit_use((out.float() - ref.float()).abs(), ref,
                           *KERNEL_TOL[dtype]),
            "lse_max_abs_err": (lse - ref_lse).abs().max().item()}


def fwd_template(design) -> str:
    """The C++ template of the forward kernel in the design
    ``kernel_design`` named."""
    return ("flash_fwd_tf32_kernel" if design == TF32_DESIGN
            else "flash_fwd_wgmma_kernel")


def check_kernel_shape(label, batch, heads, kv_heads, seq, dim, dtype,
                       card, iters, causal=True, seeds=0):
    """A forward row at one shape: the kernel against the plain version
    on inputs from SEED, two launches bit-equal, times and bounds; with
    ``seeds`` > 0 also its limit_use on inputs from that many more
    seeds."""
    q, k, v = forward_inputs(SEED, batch, heads, kv_heads, seq, dim, dtype)
    scale = dim ** -0.5
    out, lse = flash_forward(q, k, v, causal=causal, sm_scale=scale)
    torch.cuda.synchronize()
    out2, lse2 = flash_forward(q, k, v, causal=causal, sm_scale=scale)
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
    del out2, lse2
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
    if not bit_equal:
        raise RuntimeError(f"two launches of flash_attention_fwd differ at "
                           f"{label}")
    del ref, ref_lse, err
    by_seed = {SEED: {"o": use, "lse_max_abs_err": lse_err}}
    for seed in range(SEED + 1, SEED + 1 + seeds):
        by_seed[seed] = forward_limit_use(seed, batch, heads, kv_heads, seq,
                                          dim, dtype, causal)
        if not (by_seed[seed]["o"] <= 1
                and by_seed[seed]["lse_max_abs_err"] <= LSE_ATOL):
            raise RuntimeError(f"flash_attention_fwd exceeds the limit at "
                               f"{label}, seed {seed}: {by_seed[seed]}")
    seeds_row = ({} if seeds == 0 else
                 {"limit_use_by_seed": {str(s): u for s, u in by_seed.items()},
                  "limit_use_max_over_seeds": max(
                      u["o"] for u in by_seed.values())})
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
    design = kernel_design("flash_attention_fwd", dtype, dim)
    row = {"phase": "kernel", "name": "flash_attention_fwd",
           "shape": label, "causal": causal, "B": batch, "H": heads,
           "H_kv": kv_heads,
           "S": seq, "D": dim, "dtype": str(dtype).replace("torch.", ""),
           **design, **seeds_row,
           "max_abs_err": max_err, "rtol": rtol, "atol": atol,
           "limit_use": use, "lse_max_abs_err": lse_err,
           "bit_equal_launches": bit_equal,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": f"sdpa[{backend_name}]",
           "ptxas": instance_ptxas(
               "flash_attention_fwd.cu", fwd_template(design["design"]),
               dtype=str(dtype).replace("torch.", ""), head_dim=dim),
           **forward_bounds(kernel_ms, design["design"], batch, heads,
                            kv_heads, seq, seq, dim, dtype, causal=causal),
           "card": card}
    emit(row)
    del q, k, v, k_full, v_full, out, lse
    torch.cuda.empty_cache()
    return row


#: phase 3's shapes: (label, B, H, H_kv, S, D, dtype, timed launches,
#: causal)
FWD_SHAPES = [
    # the main paths' calls: the train step of llama-277M (batch 16)
    # and its serving forward (batch 2), S 1024
    ("train", 16, 16, 16, 1024, 128, torch.bfloat16, 5, True),
    ("main", 2, 16, 16, 1024, 128, torch.bfloat16, 20, True),
    ("a", 8, 16, 16, 1024, 128, torch.bfloat16, 10, True),
    ("b", 1, 16, 16, 8192, 128, torch.bfloat16, 5, True),
    ("c", 2, 8, 2, 1000, 64, torch.float32, 20, True),
    # the per-layer call of phases 4 and 7's f32 forward, and GQA and a
    # ragged tile at the narrowest head_dim, f32 and bf16, through the
    # 3xTF32 design; (c) without the mask
    ("f32_main", 2, 16, 16, 1024, 128, torch.float32, 20, True),
    ("f32_d16", 2, 8, 2, 1000, 16, torch.float32, 20, True),
    ("bf16_d16", 2, 8, 2, 1000, 16, torch.bfloat16, 20, True),
    ("c_non_causal", 2, 8, 2, 1000, 64, torch.float32, 20, False),
    # GQA and a ragged last tile through the bf16 (wgmma) design
    ("d", 2, 8, 2, 1000, 128, torch.bfloat16, 20, True),
]


def phase_kernel(card):
    """Phase 3's rows; the f32 rows' limit_use over F32_SEEDS more seeds
    at (c) and f32_main: the 3xTF32 forward's margin under the limit."""
    return [check_kernel_shape(
        *s[:7], card, s[7], causal=s[8],
        seeds=F32_SEEDS if s[0] in ("c", "f32_main") else 0)
        for s in FWD_SHAPES]


def backward_bound_ms(products, batch, heads, kv_heads, seq, dim, dtype,
                      outputs, causal=True, peak=None):
    """Least time for one backward kernel on these inputs: ``products``
    matrix products of 2*D FLOPs per visible pair over the dtype's peak
    (or ``peak``), against Q, K, V, dO, lse and di read once and
    ``outputs`` (the element counts it writes) written once, over the
    memory rate."""
    flops = products * 2 * dim * batch * heads * visible_pairs(seq, seq,
                                                                causal)
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (2 * batch * heads * seq * dim
                       + 2 * batch * kv_heads * seq * dim + sum(outputs))
              + 2 * 4 * batch * heads * seq)
    t_flops = flops / (peak or PEAK_FLOPS[dtype])
    t_bytes = nbytes / PEAK_BYTES
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def design_bounds(kernel_ms, design, dtype, bound):
    """A flash row's bounds: ``bound_ms`` on the dtype's rate (for f32
    the CUDA cores' 67 TFLOP/s, which the f32 function needs), and for
    the 3xTF32 design on f32 inputs also the tensor cores' bound of what
    it runs, three TF32 products for each at 495 TFLOP/s; the row's
    ``bound_share`` (bound over kernel_ms) takes the latter where there
    is one. ``bound(passes, peak)``: (ms, by) of the work with each
    product run ``passes`` times at ``peak`` (None: the dtype's)."""
    bound_ms, by = bound(1, None)
    row = {"bound_ms": bound_ms, "bound_by": by}
    if design == TF32_DESIGN and dtype == torch.float32:
        tc, tc_by = bound(3, PEAK_TF32)
        row.update({"bound_3xtf32_ms": tc, "bound_3xtf32_by": tc_by,
                    "bound_share": tc / kernel_ms,
                    "bound_share_uses": "bound_3xtf32_ms"})
    else:
        row.update({"bound_share": bound_ms / kernel_ms,
                    "bound_share_uses": "bound_ms"})
    return row


def backward_bounds(products, kernel_ms, design, *shape, outputs, causal):
    """:func:`design_bounds` of a backward kernel of ``products`` products
    a pair (:func:`backward_bound_ms`)."""
    return design_bounds(
        kernel_ms, design, shape[-1],
        lambda passes, peak: backward_bound_ms(passes * products, *shape,
                                               outputs, causal, peak=peak))


def forward_bounds(kernel_ms, design, *shape, causal):
    """:func:`design_bounds` of the forward (:func:`attention_bound_ms`;
    ``shape``: B, H, H_kv, Sq, Sk, D, dtype)."""
    return design_bounds(
        kernel_ms, design, shape[-1],
        lambda passes, peak: attention_bound_ms(*shape, causal, peak=peak,
                                                passes=passes))


def bwd_template(which, design) -> str:
    """The C++ template of a backward kernel ("dkv" or "dq") in the
    design ``kernel_design`` named."""
    route = "tf32" if design == TF32_DESIGN else "wgmma"
    return f"flash_bwd_{which}_{route}_kernel"


def backward_grids(spec) -> dict:
    """{label: {"dkv": blocks, "dq": blocks}} of one launch of each
    backward kernel at each [label, B, H, H_kv, S, D, dtype, causal] of
    ``spec``, as :func:`launched_blocks` reads them (None where the
    profiler recorded none)."""
    grids = {}
    for label, batch, heads, kv_heads, seq, dim, dtype, causal in spec:
        dtype = getattr(torch, dtype)
        q, k, v, do = backward_inputs(SEED + 10, batch, heads, kv_heads,
                                      seq, dim, dtype)
        kw = {"causal": causal, "sm_scale": dim ** -0.5}
        o, lse = flash_forward(q, k, v, **kw)
        di = (o.float() * do.float()).sum(-1)
        templates = {which: bwd_template(which, kernel_design(
            f"flash_attention_bwd_{which}", dtype, dim)["design"])
            for which in ("dkv", "dq")}
        seen = launched_blocks(
            lambda: (flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw),
                     flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)),
            list(templates.values()))
        grids[label] = {which: (seen[template][0] if template in seen
                                else None)
                        for which, template in templates.items()}
        del q, k, v, do, o, lse, di
    return grids


def measure_backward_grids(shapes) -> dict:
    """:func:`backward_grids` of ``shapes`` ((label, B, H, H_kv, S, D,
    dtype, causal) tuples) from a process of its own
    (``chip_smoke.py --backward-grids SPEC``): in one process with the
    card tests, the profiler sessions after a :func:`launched_blocks`
    recorded no device event (NVIDIA H100 80GB HBM3, PERF.md §6)."""
    spec = [[label, *dims, str(dtype).replace("torch.", ""), causal]
            for label, *dims, dtype, causal in shapes]
    run = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--backward-grids",
         json.dumps(spec)], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    if run.returncode != 0:
        raise RuntimeError(f"chip_smoke.py --backward-grids failed "
                           f"({run.returncode}):\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def launched_blocks(fn, kernels) -> dict:
    """The blocks of each launch that one call of ``fn`` made of a kernel
    whose name holds one of ``kernels``, as torch.profiler's trace of the
    device records its grid: {kernel: [blocks, ...]}, {} where no session
    of up to MAX_PROFILE_SESSIONS recorded a grid for each (a session can
    lose a kernel's record, see :func:`cuda_launches`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(MAX_PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        found = {}
        for event in events:
            grid = event.get("args", {}).get("grid")
            if event.get("cat") != "kernel" or not grid:
                continue
            for kernel in kernels:
                if kernel in event.get("name", ""):
                    found.setdefault(kernel, []).append(math.prod(grid))
        if all(kernel in found for kernel in kernels):
            return found
    return {}


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


def backward_inputs(seed, batch, heads, kv_heads, seq, dim, dtype):
    """q, k, v and dO for a backward row, drawn on the card from
    ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    return (randn(batch, heads, seq, dim), randn(batch, kv_heads, seq, dim),
            randn(batch, kv_heads, seq, dim), randn(batch, heads, seq, dim))


def backward_limit_use(seed, batch, heads, kv_heads, seq, dim, dtype,
                       causal=True) -> dict:
    """dq, dk and dv's limit_use under KERNEL_TOL, the kernels against
    the plain backward, on inputs drawn from ``seed``."""
    q, k, v, do = backward_inputs(seed, batch, heads, kv_heads, seq, dim,
                                  dtype)
    kw = {"causal": causal, "sm_scale": dim ** -0.5}
    o, lse = flash_forward(q, k, v, **kw)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    refs = flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    return {name: limit_use((got.float() - ref.float()).abs(), ref,
                            *KERNEL_TOL[dtype])
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      refs)}


def check_backward_shape(label, batch, heads, kv_heads, seq, dim, dtype,
                         card, iters, causal=True, seeds=0, seen=None):
    """A backward row at one shape: both kernels against the plain
    backward on inputs from SEED + 10, two launches bit-equal, their
    grids (``seen``: {"dkv": blocks, "dq": blocks} as
    :func:`measure_backward_grids` saw them launched), times and bounds;
    with ``seeds`` > 0 also their limit_use on inputs from that many more
    seeds."""
    q, k, v, do = backward_inputs(SEED + 10, batch, heads, kv_heads, seq,
                                  dim, dtype)
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
    by_seed = {SEED + 10: use}
    for seed in range(SEED + 11, SEED + 11 + seeds):
        by_seed[seed] = backward_limit_use(seed, batch, heads, kv_heads,
                                           seq, dim, dtype, causal)
        if not max(by_seed[seed].values()) <= 1:
            raise RuntimeError(f"the backward kernels exceed the limit at "
                               f"{label}, seed {seed}: {by_seed[seed]}")
    seeds_row = ({} if seeds == 0 else
                 {"limit_use_by_seed": {str(seed): uses
                                        for seed, uses in by_seed.items()},
                  "limit_use_max_over_seeds": {
                      name: max(u[name] for u in by_seed.values())
                      for name in ("dq", "dk", "dv")}})
    dkv_design = kernel_design("flash_attention_bwd_dkv", dtype, dim)
    dq_design = kernel_design("flash_attention_bwd_dq", dtype, dim)
    templates = {"dkv": bwd_template("dkv", dkv_design["design"]),
                 "dq": bwd_template("dq", dq_design["design"])}
    # the grids as the profiler saw them launched (``seen``), beside the
    # grids the launchers report they take
    grids = {}
    for which in templates:
        name = f"flash_attention_bwd_{which}"
        reported = launch_blocks(name, q, k)
        blocks = (seen or {}).get(which)
        if blocks is not None and blocks != reported:
            raise RuntimeError(
                f"{name} at {label} launched {blocks} blocks where its "
                f"launcher reports {reported}")
        grids[which] = {"blocks": blocks,
                        "blocks_from": "not recorded" if blocks is None
                        else "torch.profiler's launch record",
                        "launcher_blocks": reported}
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
    shape = (batch, heads, kv_heads, seq, dim, dtype)
    dkv_bound = backward_bounds(4, dkv_ms, dkv_design["design"], *shape,
                                outputs=[kv_elems, kv_elems], causal=causal)
    dq_bound = backward_bounds(3, dq_ms, dq_design["design"], *shape,
                               outputs=[batch * heads * seq * dim],
                               causal=causal)
    common = {"shape": label, "causal": causal, "B": batch, "H": heads,
              **seeds_row,
              "H_kv": kv_heads,
              "S": seq, "D": dim, "dtype": str(dtype).replace("torch.", ""),
              "rtol": rtol, "atol": atol, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library": f"sdpa[{SDPA_BACKENDS[dtype][1]}] backward alone",
              "plain_and_library_cover": "dq, dk and dv together",
              "card": card}
    rows = [
        {"phase": "kernel_bwd", "name": "flash_attention_bwd_dkv", **common,
         **dkv_design, "max_abs_err": max(errors["dk"], errors["dv"]),
         "dk_max_abs_err": errors["dk"], "dv_max_abs_err": errors["dv"],
         "limit_use": max(use["dk"], use["dv"]),
         "dk_limit_use": use["dk"], "dv_limit_use": use["dv"],
         "bit_equal_launches": bit_equal["dkv"], "kernel_ms": dkv_ms,
         **grids["dkv"],
         "ptxas": instance_ptxas(
             "flash_attention_bwd.cu", templates["dkv"],
             dtype=str(dtype).replace("torch.", ""), head_dim=dim),
         **dkv_bound},
        {"phase": "kernel_bwd", "name": "flash_attention_bwd_dq", **common,
         **dq_design, "max_abs_err": errors["dq"], "limit_use": use["dq"],
         "bit_equal_launches": bit_equal["dq"], "kernel_ms": dq_ms,
         **grids["dq"],
         "ptxas": instance_ptxas(
             "flash_attention_bwd.cu", templates["dq"],
             dtype=str(dtype).replace("torch.", ""), head_dim=dim),
         **dq_bound},
    ]
    for row in rows:
        emit(row)
    del q, k, v, do, o, lse, di, dq, dk, dv
    torch.cuda.empty_cache()
    return rows


#: the seeds beyond the first of phase 3b's (c) and f32_main rows
F32_SEEDS = 7


#: phase 3b's shapes: (label, B, H, H_kv, S, D, dtype, timed launches)
BWD_SHAPES = [
    # the main path's call: the train step of llama-277M, batch 16
    ("main", 16, 16, 16, 1024, 128, torch.bfloat16, 5),
    ("b", 1, 16, 16, 8192, 128, torch.bfloat16, 3),
    ("c", 2, 8, 2, 1000, 64, torch.float32, 10),
    # the per-layer call of phase 7's f32 gradients, and GQA and a ragged
    # tile at the narrowest head_dim, through the 3xTF32 design
    ("f32_main", 2, 16, 16, 1024, 128, torch.float32, 10),
    ("f32_d16", 2, 8, 2, 1000, 16, torch.float32, 10),
    # GQA and a ragged last tile through the bf16 (wgmma) kernels
    ("d", 2, 8, 2, 1000, 128, torch.bfloat16, 10),
    # an odd length: lse and di rows that no 16-byte TMA row could carry,
    # a ragged 64-query and 128-key tile
    ("odd", 2, 8, 2, 997, 128, torch.bfloat16, 10),
]
#: phase 3c's backward row: a ring's past block, no mask
RING_BWD_SHAPE = ("ring_block", 1, 16, 16, 2048, 128, torch.bfloat16, 10)


def phase_kernel_bwd(card, grids):
    """Phase 3b's rows; ``grids``: :func:`measure_backward_grids` of
    BWD_SHAPES."""
    rows = []
    for s in BWD_SHAPES:
        # the f32 rows' limit_use over more seeds than one: the 3xTF32
        # kernels' margin under the limit (PERF.md §6)
        more = F32_SEEDS if s[0] in ("c", "f32_main") else 0
        rows += check_backward_shape(*s[:7], card, s[7], seeds=more,
                                     seen=grids.get(s[0]))
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


def phase_ring_kernels(card, grids):
    """The kernels as the ring runs them, on one card: rows without the
    causal mask, the 4-block chain of the long-context shape, the fold
    kernel against its plain version, and the ring's backward schedule.
    Returns (non-causal forward rows, non-causal backward rows, the fold
    row, the chain's launches)."""
    fwd_rows = [check_kernel_shape("ring_block", 1, 16, 16, 2048, 128,
                                   torch.bfloat16, card, 10, causal=False)]
    bwd_rows = check_backward_shape(*RING_BWD_SHAPE[:7], card,
                                    RING_BWD_SHAPE[7], causal=False,
                                    seen=grids.get(RING_BWD_SHAPE[0]))

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


#: bytes of weight copies that a timed int8 product turns through, four
#: times an H100's 50 MB L2, so that each call reads its weight from
#: device memory, as the decode step's products read theirs
ROTATE_BYTES = 200 << 20


def rotated_ms(fn, pool, iters: int) -> float:
    """``graph_ms`` of ``fn(*args)`` with args taken from ``pool`` in
    turn: each call reads another copy of its operands."""
    turn = itertools.cycle(pool)
    return graph_ms(lambda: fn(*next(turn)), iters)


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
#: its M of 4 rows a rank, a ragged shape, one f32 row, and the plan's
#: edges: M just below and at the wgmma design's threshold (63 / 64 rows
#: at N 8192, 128 / 129 at N 2048, where its tiles first fill a quarter
#: of an H100), ragged prefill M (64, 100, 500), an N that TMA cannot
#: take at M 512, and K and N that leave the wgmma design a ragged last
#: tile (TMA's zero fill past K, a partial code box and masked columns
#: past N); and the served DeepSeek-7B's products (the benchmark's chat
#: cell: q, k, v and o, gate and up, down, the head) at decode's 16 rows
#: and at its prefill's 1,024 to 4,096 (16 rows of 64 to 256 tokens)
INT8_SHAPES = [
    ("decode_qkvo_lm_head", 8, 2048, 2048, torch.bfloat16, 200),
    ("decode_gate_up", 8, 2048, 8192, torch.bfloat16, 200),
    ("decode_down", 8, 8192, 2048, torch.bfloat16, 200),
    ("contract_qkvo_lm_head", 2, 2048, 2048, torch.bfloat16, 200),
    ("contract_gate_up", 2, 2048, 8192, torch.bfloat16, 200),
    ("contract_down", 2, 8192, 2048, torch.bfloat16, 200),
    ("prefill_qkvo_lm_head", 512, 2048, 2048, torch.bfloat16, 50),
    ("prefill_gate_up", 512, 2048, 8192, torch.bfloat16, 20),
    ("prefill_down", 512, 8192, 2048, torch.bfloat16, 20),
    ("tp2_qkv_lm_head", 4, 2048, 1024, torch.bfloat16, 200),
    ("tp2_o", 4, 1024, 2048, torch.bfloat16, 200),
    ("tp2_gate_up", 4, 2048, 4096, torch.bfloat16, 200),
    ("tp2_down", 4, 4096, 2048, torch.bfloat16, 200),
    ("ragged", 3, 2000, 1000, torch.bfloat16, 200),
    ("decode_qkvo_f32", 8, 2048, 2048, torch.float32, 200),
    ("below_threshold_m63", 63, 2048, 8192, torch.bfloat16, 100),
    ("threshold_m64", 64, 2048, 8192, torch.bfloat16, 100),
    ("below_threshold_m128", 128, 2048, 2048, torch.bfloat16, 100),
    ("threshold_m129", 129, 2048, 2048, torch.bfloat16, 100),
    ("prefill_m64", 64, 2048, 2048, torch.bfloat16, 100),
    ("prefill_m100", 100, 2048, 2048, torch.bfloat16, 100),
    ("prefill_m500", 500, 2048, 2048, torch.bfloat16, 50),
    ("prefill_unaligned_n", 512, 2048, 1000, torch.bfloat16, 20),
    ("prefill_k_ragged_tile", 512, 2040, 2048, torch.bfloat16, 50),
    ("prefill_n_ragged_tile", 512, 2048, 1040, torch.bfloat16, 50),
    ("chat_qkvo", 16, 4096, 4096, torch.bfloat16, 200),
    ("chat_gate_up", 16, 4096, 11008, torch.bfloat16, 100),
    ("chat_down", 16, 11008, 4096, torch.bfloat16, 100),
    ("chat_head", 16, 4096, 102400, torch.bfloat16, 20),
] + [
    (f"chat_prefill_m{m}_{name}", m, k, n, torch.bfloat16, iters)
    for m in (1024, 2048, 3072, 4096)
    for name, k, n, iters in (("qkvo", 4096, 4096, 20),
                              ("gate_up", 4096, 11008, 10),
                              ("down", 11008, 4096, 10),
                              ("head", 4096, 102400, 2))]


#: the most profiler sessions ``cuda_launches`` takes of one call
MAX_PROFILE_SESSIONS = 5


def cuda_launches(fn) -> int:
    """Kernels (and memsets or copies) that one call of ``fn`` puts on
    the card, from torch.profiler's device events: the largest count of
    two sessions of one call each, or of up to MAX_PROFILE_SESSIONS while
    every session counted none. A session can lose a kernel's record (on
    an H100 with torch 2.11 the first profiled launch of a kernel from
    ``csrc/kv_append.cu`` came back with no device event once in each of
    three runs, beside an "Activity Buffer Request", while the next
    session of the same call showed it; both sessions of one int8_matmul
    call once came back empty); it never adds one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    while len(counts) < 2 or (max(counts) == 0
                              and len(counts) < MAX_PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA))
    return max(counts)


def graph_replay_equal(fn, eager) -> bool:
    """Whether one call of ``fn`` captured in a CUDA graph and replayed
    returns ``eager`` bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # the stream's first call runs eagerly, as a capture asks
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    equal = bool(torch.equal(out, eager))
    del graph, out
    return equal


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
    graph_equal = graph_replay_equal(lambda: int8_matmul(x, q, s), got)
    launches = cuda_launches(lambda: int8_matmul(x, q, s))
    if not (use <= 1 and bit_equal and graph_equal and launches == 1
            and got.shape == (m, n) and torch.isfinite(got.float()).all()):
        raise RuntimeError(
            f"int8_matmul off its plain version at {label}: limit_use "
            f"{use}, max|err| {err.max().item()}, bit-equal launches "
            f"{bit_equal}, graph replay bit-equal {graph_equal}, CUDA "
            f"launches a call {launches}")
    p = int8_plan(m, k, n, dtype,
                  torch.cuda.get_device_properties(0).multi_processor_count)
    row = {"phase": "int8_matmul", "name": "int8_matmul", "shape": label,
           "M": m, "K": k, "N": n, "dtype": str(dtype).replace("torch.", ""),
           "design": p.design,
           "plan": {"block_m": p.block_m, "block_n": p.block_n,
                    "splits": p.splits, "k_per_split": p.k_per_split,
                    "blocks": p.blocks},
           "cuda_launches_per_call": launches,
           "max_abs_err": err.max().item(),
           "limit": "atol + rtol * (|ref| + |round(x @ q) * s|)",
           "rtol": KERNEL_TOL[dtype][0], "atol": KERNEL_TOL[dtype][1],
           "limit_use": use,
           "bit_equal_to_plain_share": (got == ref).float().mean().item(),
           "bit_equal_launches": bit_equal,
           "graph_replay_bit_equal": graph_equal}
    del got, again, ref, pre_scale, err
    # timed inside a CUDA graph, each call on another copy of the weight
    # (ROTATE_BYTES of them): the weight comes from device memory, as in
    # the decode step, not from L2
    qs = [q] + [q.clone() for _ in range(-(-ROTATE_BYTES // (k * n)) - 1)]
    row["weight_copies"] = len(qs)
    row["kernel_ms"] = rotated_ms(lambda qi: int8_matmul(x, qi, s),
                                  [(qi,) for qi in qs], iters)
    # one weight, read again and again, so from L2 where it fits: how
    # PR 8 timed the kernel
    row["kernel_l2_ms"] = graph_ms(lambda: int8_matmul(x, q, s), iters)
    # one weight, eager: the wrapper's host cost shows
    row["kernel_eager_ms"] = cuda_ms(lambda: int8_matmul(x, q, s), iters)
    row["plain_ms"] = rotated_ms(lambda qi: int8_matmul_reference(x, qi, s),
                                 [(qi,) for qi in qs], iters)
    if label.startswith("chat_prefill"):
        # its time grows with the rows (0.61 ms at 16 rows of (4096,
        # 4096)): at thousands of rows a call takes seconds
        row["library"] = "torch._weight_int8pack_mm, not timed at prefill"
        row["library_ms"] = None
    elif dtype == torch.bfloat16:
        # the library's int8-weight product takes the codes as (N, K) and
        # the scales in x's dtype: both made outside the timing
        s_x = s.to(dtype)
        row["library"] = "torch._weight_int8pack_mm"
        row["library_ms"] = rotated_ms(
            lambda qi: torch._weight_int8pack_mm(x, qi, s_x),
            [(qi.t().contiguous(),) for qi in qs], max(2, iters // 10))
    else:
        row["library"] = "none: torch._weight_int8pack_mm takes no f32"
        row["library_ms"] = None
    # cuBLAS on bf16 copies of the codes made outside the timing: the
    # product alone, without the conversion the plain version pays
    row["cublas_on_converted_copy_ms"] = rotated_ms(
        lambda wi: x @ wi, [(qi.to(dtype),) for qi in qs], iters)
    row["bound_ms"], row["bound_by"] = int8_bound_ms(m, k, n, dtype)
    row["card"] = card
    emit(row)
    del x, q, s, qs
    torch.cuda.empty_cache()
    return row


def phase_int8_matmul(card):
    return [check_int8_shape(*shape, card) for shape in INT8_SHAPES]


#: (label, B, T, n_heads, n_kv_heads, S, start_pos, head_dim, q dtype,
#: cache dtype) of phase 3e, at llama-277M's widths: the bench decode (8
#: rows, context 1024) at its last position and mid-sequence, its prefill
#: block of 64, phase 9's tp = 2 shard (4 rows a rank over 8 heads), each
#: over a bf16 and an int8 cache; GQA with an f32 cache under f32 q;
#: bf16 q over an f32 cache (param_dtype None under bf16 params); the
#: card tests' head_dim 64, the serving job's 16 and the dry run's 8; a
#: ragged S. The first row is the serving path's most launched call.
DECODE_SHAPES = [
    (label, b, t, h, kv, s, pos, d, q, cache)
    for label, b, t, h, kv, s, pos, d, q, caches in [
        ("bench_decode", 8, 1, 16, 16, 1024, 1023, 128, torch.bfloat16,
         (torch.bfloat16, torch.int8)),
        ("bench_decode_mid", 8, 1, 16, 16, 1024, 544, 128, torch.bfloat16,
         (torch.bfloat16, torch.int8)),
        ("bench_prefill", 8, 64, 16, 16, 1024, 0, 128, torch.bfloat16,
         (torch.bfloat16, torch.int8)),
        ("tp2_shard", 4, 1, 8, 8, 1024, 1023, 128, torch.bfloat16,
         (torch.bfloat16, torch.int8)),
        ("gqa_f32", 2, 1, 16, 4, 1000, 999, 128, torch.float32,
         (torch.float32,)),
        ("mixed_bf16_q_f32_cache", 8, 1, 16, 16, 1024, 1023, 128,
         torch.bfloat16, (torch.float32,)),
        ("head_dim_64", 8, 1, 16, 16, 1024, 1023, 64, torch.bfloat16,
         (torch.bfloat16, torch.int8)),
        ("head_dim_16", 8, 1, 16, 16, 1024, 1023, 16, torch.bfloat16,
         (torch.bfloat16, torch.int8)),
        ("head_dim_8", 8, 1, 16, 16, 1024, 1023, 8, torch.bfloat16,
         (torch.bfloat16, torch.int8)),
        ("ragged_s", 8, 1, 16, 16, 997, 996, 128, torch.bfloat16,
         (torch.bfloat16, torch.int8)),
    ]
    for cache in caches
]
#: the most cache copies a timed call turns through (small caches)
MAX_CACHE_COPIES = 64


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def random_cache(gen, batch, seq, kv_heads, dim, cache):
    """One layer's cache, full of values: float (normal) or the int8
    codes and scales of normal values as the cache write makes them."""
    def randn():
        return torch.randn((batch, seq, kv_heads, dim), generator=gen,
                           device="cuda")

    if cache == torch.int8:
        (kq, ks), (vq, vs) = (_quantize_kv_block(randn()) for _ in range(2))
        return {"k": kq, "k_s": ks, "v": vq, "v_s": vs}
    return {"k": randn().to(cache), "v": randn().to(cache)}


def cache_bytes(entry) -> int:
    return sum(t.numel() * t.element_size() for t in entry.values())


def decode_attention_bound_ms(batch, t_new, heads, kv_heads, seq, dim,
                              q_dtype, cache, start=None):
    """Least time of one call: K, V (and their scales) read once, q read
    and the output written once, over the memory rate, against 4*B*nh*hd
    FLOPs a (query, key) pair over the peak of the compute dtype (q's for
    an int8 cache, else the promoted one). With ``start`` only the keys
    that the output depends on count, positions 0 .. start + T - 1, and
    each query's visible ones, start + t + 1; without it the whole cache
    and every pair, as the reference reads it."""
    out = decode_output_dtype(q_dtype, cache)
    keys, pairs = seq, t_new * seq
    if start is not None:
        keys = min(seq, start + t_new)
        pairs = sum(min(seq, start + t + 1) for t in range(t_new))
    nbytes = (2 * batch * keys * kv_heads * dim * cache.itemsize
              + (2 * batch * keys * kv_heads * 4 if cache == torch.int8
                 else 0)
              + batch * t_new * heads * dim
              * (q_dtype.itemsize + out.itemsize))
    t_bytes = nbytes / PEAK_BYTES
    t_flops = 4 * batch * heads * pairs * dim / PEAK_FLOPS[out]
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def kv_append_bound_ms(batch, t_new, kv_heads, dim, x_dtype, cache):
    """Least time of one cache write: K and V read and their rows (and
    scales) written once, over the memory rate."""
    rows = 2 * batch * t_new * kv_heads
    nbytes = rows * dim * (x_dtype.itemsize + cache.itemsize) \
        + (rows * 4 if cache == torch.int8 else 0)
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def rope_kv_append_bound_ms(batch, t_new, heads, kv_heads, dim, x_dtype,
                            cache):
    """Least time of one rotation and cache write: q, k, v and the
    (dim / 2,) float32 frequencies read once, the rotated q and the cache
    rows (and scales) written once, over the memory rate. Its operations
    (a rotation is a few FLOPs and two trig calls an element) are far
    below the float32 peak's share of these bytes."""
    kv_rows = 2 * batch * t_new * kv_heads
    nbytes = (2 * batch * t_new * heads * dim * x_dtype.itemsize
              + kv_rows * dim * (x_dtype.itemsize + cache.itemsize)
              + (kv_rows * 4 if cache == torch.int8 else 0) + dim // 2 * 4)
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def append_design(rotate: bool, vec: int) -> str:
    """The cache-write kernel's design at a vector width."""
    rows = "q, k or v" if rotate else "k or v"
    loads = ("two pairs a lane (8- or 4-byte loads)" if vec == 2
             else "one pair a lane (element loads)")
    return f"one warp a (b, t, head) row of {rows}, {loads}"


def max_ulp(got, want) -> int:
    """The largest distance in units in the last place between two
    float32 or bfloat16 tensors of one dtype (0: bit-equal)."""
    bits = torch.finfo(got.dtype).bits
    ints = {32: torch.int32, 16: torch.int16}[bits]

    def line(x):  # sign and magnitude onto one monotone integer line
        x = x.contiguous().view(ints).long()
        mag = x & ((1 << (bits - 1)) - 1)
        return torch.where(x < 0, -mag, mag)

    if got.numel() == 0:
        return 0
    return int((line(got) - line(want)).abs().max().item())


def check_decode_shape(label, batch, t_new, heads, kv_heads, seq, start,
                       dim, q_dtype, cache, card):
    """decode_attention against its plain version at one shape: the error
    against the plain version computed in float32 from the same inputs
    (the limit), and against the plain version at its own dtypes; two
    launches and a graph replay bit-equal; one CUDA launch a call; times
    in CUDA graphs over cache copies that overflow L2."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    q = torch.randn((batch, t_new, heads, dim), generator=gen,
                    device="cuda").to(q_dtype)
    entry = random_cache(gen, batch, seq, kv_heads, dim, cache)
    pos = torch.tensor(start, device="cuda")
    got = decode_attention(q, entry, pos)
    again = decode_attention(q, entry, pos)
    torch.cuda.synchronize()
    oracle = decode_attention_reference(
        q.float(), {n: t if t.dtype == torch.int8 else t.float()
                    for n, t in entry.items()}, pos)
    plain = decode_attention_reference(q, entry, pos)
    rtol, atol = KERNEL_TOL[got.dtype]
    err = (got.float() - oracle).abs()
    use = limit_use(err, oracle, rtol, atol)
    bit_equal = bool(torch.equal(got, again))
    graph_equal = graph_replay_equal(lambda: decode_attention(q, entry, pos),
                                     got)
    launches = cuda_launches(lambda: decode_attention(q, entry, pos))
    # NaN planted past the step's last key (in the scales of an int8
    # cache) must not reach the output: the kernel never reads there
    planted = {n: t.clone() for n, t in entry.items()}
    for name in ("k_s", "v_s") if cache == torch.int8 else ("k", "v"):
        planted[name][:, start + t_new:] = float("nan")
    tail_unread = bool(torch.equal(decode_attention(q, planted, pos), got))
    counters_zero = all(not c.any() for c in decode_counters.values())
    del planted
    if not (use <= 1 and bit_equal and graph_equal and launches == 1
            and tail_unread and counters_zero
            and got.shape == q.shape and got.dtype == plain.dtype
            and torch.isfinite(got.float()).all()):
        raise RuntimeError(
            f"decode_attention off its plain version at {label} "
            f"({dtype_name(cache)} cache): limit_use {use}, max|err| "
            f"{err.max().item()}, bit-equal launches {bit_equal}, graph "
            f"replay bit-equal {graph_equal}, CUDA launches a call "
            f"{launches}, NaN past the position unread {tail_unread}, "
            f"ticket counters back at 0 {counters_zero}, dtype "
            f"{got.dtype} (plain {plain.dtype})")
    p = decode_plan(batch, t_new, heads, kv_heads, seq, dim, q_dtype, cache)
    row = {"phase": "decode_kernels", "name": "decode_attention",
           "shape": label, "B": batch, "T": t_new, "H": heads,
           "H_kv": kv_heads, "S": seq, "D": dim, "start_pos": start,
           "dtype": dtype_name(q_dtype), "cache": dtype_name(cache),
           "out_dtype": dtype_name(got.dtype), "design": p.design,
           "plan": {"route": p.route, "blocks": p.blocks,
                    "splits": p.splits,
                    "stages": p.stages, "key_tile": p.key_tile,
                    "smem_bytes": p.smem_bytes,
                    "blocks_per_sm": decode_blocks_that_fit(p.smem_bytes)},
           "cuda_launches_per_call": launches,
           "max_abs_err": err.max().item(),
           "oracle": "the plain version in float32 on the same inputs",
           "rtol": rtol, "atol": atol, "limit_use": use,
           "max_abs_err_vs_plain_own_dtype":
               (got.float() - plain.float()).abs().max().item(),
           "bit_equal_launches": bit_equal,
           "graph_replay_bit_equal": graph_equal,
           "nan_past_the_position_unread": tail_unread,
           "ticket_counters_zero": counters_zero}
    del again, oracle, plain, err
    # timed inside CUDA graphs, each call on another copy of the cache
    # (ROTATE_BYTES of them): the cache comes from device memory, as in
    # the decode step, not from L2
    copies = min(MAX_CACHE_COPIES, -(-ROTATE_BYTES // cache_bytes(entry)))
    pool = [(entry,)] + [({n: t.clone() for n, t in entry.items()},)
                         for _ in range(copies - 1)]
    row["cache_copies"] = len(pool)
    row["kernel_ms"] = rotated_ms(lambda e: decode_attention(q, e, pos),
                                  pool, 30)
    row["plain_ms"] = rotated_ms(
        lambda e: decode_attention_reference(q, e, pos), pool, 10)
    if cache != torch.int8 and cache == q_dtype:
        # the library's attention with the reference's boolean mask on
        # transposed views of the cache, GQA by the library
        mask = torch.arange(seq, device="cuda")[None, :] \
            <= (start + torch.arange(t_new, device="cuda"))[:, None]
        qt = q.transpose(1, 2)
        row["library"] = "sdpa(attn_mask=(T, S) bool, enable_gqa=True)"
        try:
            row["library_ms"] = rotated_ms(
                lambda e: torch.nn.functional.scaled_dot_product_attention(
                    qt, e["k"].transpose(1, 2), e["v"].transpose(1, 2),
                    attn_mask=mask, enable_gqa=True), pool, 10)
        except RuntimeError as exc:  # a yardstick, not a check of the port
            row["library"] += f": failed ({str(exc)[:200]})"
            row["library_ms"] = None
    else:
        row["library"] = ("none: no PyTorch call reads an int8 cache with "
                          "scales" if cache == torch.int8 else
                          "none: sdpa takes no mixed dtypes")
        row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = decode_attention_bound_ms(
        batch, t_new, heads, kv_heads, seq, dim, q_dtype, cache, start)
    row["bound_ms_whole_cache"], row["bound_by_whole_cache"] = \
        decode_attention_bound_ms(batch, t_new, heads, kv_heads, seq, dim,
                                  q_dtype, cache)
    row["card"] = card
    emit(row)
    del pool, entry, q, got
    torch.cuda.empty_cache()
    return row


def check_append_shape(label, batch, t_new, heads, kv_heads, seq, start,
                       dim, q_dtype, cache, card):
    """kv_append against its plain version at one shape: every cache leaf
    bit-equal after the write, the rows outside [start, start + T)
    untouched; two launches and a graph replay bit-equal; one CUDA launch
    a call; timed in a CUDA graph."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    k, v = (torch.randn((batch, t_new, kv_heads, dim), generator=gen,
                        device="cuda").to(q_dtype) for _ in range(2))
    base = random_cache(gen, batch, seq, kv_heads, dim, cache)
    pos = torch.tensor(start, device="cuda")

    def fresh():
        return {n: t.clone() for n, t in base.items()}

    got, again, want = fresh(), fresh(), fresh()
    kv_append(got, k, v, pos)
    kv_append(again, k, v, pos)
    kv_append_reference(want, k, v, pos)
    torch.cuda.synchronize()
    bit_equal_plain = all(torch.equal(got[n], want[n]) for n in got)
    bit_equal = all(torch.equal(got[n], again[n]) for n in got)
    untouched = all(
        torch.equal(got[n][:, :start], base[n][:, :start])
        and torch.equal(got[n][:, start + t_new:], base[n][:, start + t_new:])
        for n in got)
    written = all(not torch.equal(got[n][:, start:start + t_new],
                                  base[n][:, start:start + t_new])
                  for n in got)

    def leaves_bytes(entry):
        return torch.cat([t.view(torch.uint8).flatten()
                          for t in entry.values()])

    target = fresh()
    graph_equal = graph_replay_equal(
        lambda: leaves_bytes(kv_append(target, k, v, pos)),
        leaves_bytes(got))
    launches = cuda_launches(lambda: kv_append(target, k, v, pos))
    if not (bit_equal_plain and bit_equal and untouched and written
            and graph_equal and launches == 1):
        raise RuntimeError(
            f"kv_append off its plain version at {label} "
            f"({dtype_name(cache)} cache): bit-equal to plain "
            f"{bit_equal_plain}, two launches {bit_equal}, other rows "
            f"untouched {untouched}, rows written {written}, graph replay "
            f"{graph_equal}, CUDA launches a call {launches}")
    row = {"phase": "decode_kernels", "name": "kv_append", "shape": label,
           "B": batch, "T": t_new, "H_kv": kv_heads, "S": seq, "D": dim,
           "start_pos": start, "dtype": dtype_name(q_dtype),
           "cache": dtype_name(cache),
           "design": append_design(False, vector_width(
               k, v, got["k"], got["v"])),
           "cuda_launches_per_call": launches, "max_abs_err": 0.0,
           "bit_equal_to_plain": bit_equal_plain,
           "other_rows_untouched": untouched, "bit_equal_launches": bit_equal,
           "graph_replay_bit_equal": graph_equal,
           "kernel_ms": graph_ms(lambda: kv_append(target, k, v, pos), 50),
           "plain_ms": graph_ms(
               lambda: kv_append_reference(target, k, v, pos), 20),
           "library": "none: no single PyTorch call quantizes and writes",
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = kv_append_bound_ms(
        batch, t_new, kv_heads, dim, q_dtype, cache)
    row["card"] = card
    emit(row)
    del got, again, want, target, base
    torch.cuda.empty_cache()
    return row


#: RoPE's theta at every phase 3e row: llama-277M's
ROPE_THETA = CONFIG_277M.rope_theta


def check_rope_append_shape(label, batch, t_new, heads, kv_heads, seq,
                            start, dim, q_dtype, cache, card):
    """rope_kv_append against its plain version at one shape: the rotated
    q and every cache leaf bit-equal after the write (else the largest
    ulp and code distances in the error), the rows outside [start, start
    + T) untouched; two launches and a graph replay bit-equal; one CUDA
    launch a call; timed in a CUDA graph beside the plain version and
    beside what the path ran before (``_rope`` of q and k, then the
    kv_append kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    q = torch.randn((batch, t_new, heads, dim), generator=gen,
                    device="cuda").to(q_dtype)
    k, v = (torch.randn((batch, t_new, kv_heads, dim), generator=gen,
                        device="cuda").to(q_dtype) for _ in range(2))
    base = random_cache(gen, batch, seq, kv_heads, dim, cache)
    pos = torch.tensor(start, device="cuda")

    def fresh():
        return {n: t.clone() for n, t in base.items()}

    def call(entry):
        return rope_kv_append(entry, q, k, v, pos, ROPE_THETA)

    got, again, want = fresh(), fresh(), fresh()
    q_got = call(got)
    q_again = call(again)
    q_want = rope_kv_append_reference(want, q, k, v, pos, ROPE_THETA)
    torch.cuda.synchronize()
    bit_equal_plain = torch.equal(q_got, q_want) and all(
        torch.equal(got[n], want[n]) for n in got)
    bit_equal = torch.equal(q_got, q_again) and all(
        torch.equal(got[n], again[n]) for n in got)
    untouched = all(
        torch.equal(got[n][:, :start], base[n][:, :start])
        and torch.equal(got[n][:, start + t_new:], base[n][:, start + t_new:])
        for n in got)
    written = all(not torch.equal(got[n][:, start:start + t_new],
                                  base[n][:, start:start + t_new])
                  for n in got)
    distances = {"q_max_ulp": max_ulp(q_got, q_want)}
    for n in got:
        if got[n].dtype == torch.int8:
            distances[f"{n}_max_code_diff"] = int(
                (got[n].int() - want[n].int()).abs().max().item())
        else:
            distances[f"{n}_max_ulp"] = max_ulp(got[n], want[n])
    err = max([(q_got.float() - q_want.float()).abs().max().item()]
              + [(got[n].float() - want[n].float()).abs().max().item()
                 for n in got])

    def result_bytes(q_rot, entry):
        return torch.cat([q_rot.view(torch.uint8).flatten()]
                         + [t.view(torch.uint8).flatten()
                            for t in entry.values()])

    target = fresh()
    graph_equal = graph_replay_equal(
        lambda: result_bytes(call(target), target),
        result_bytes(q_got, got))
    launches = cuda_launches(lambda: call(target))
    if not (bit_equal_plain and bit_equal and untouched and written
            and graph_equal and launches == 1):
        raise RuntimeError(
            f"rope_kv_append off its plain version at {label} "
            f"({dtype_name(cache)} cache): bit-equal to plain "
            f"{bit_equal_plain} {distances}, two launches {bit_equal}, "
            f"other rows untouched {untouched}, rows written {written}, "
            f"graph replay {graph_equal}, CUDA launches a call {launches}")

    def parent_path():  # RoPE and the rotation-free write, unfused
        positions = torch.arange(t_new, device="cuda") + pos
        kv_append(target, _rope(k, ROPE_THETA, positions), v, pos)
        return _rope(q, ROPE_THETA, positions)

    vec = vector_width(q, q_got, k, v, got["k"], got["v"])
    row = {"phase": "decode_kernels", "name": "rope_kv_append",
           "shape": label, "B": batch, "T": t_new, "H": heads,
           "H_kv": kv_heads, "S": seq, "D": dim, "start_pos": start,
           "dtype": dtype_name(q_dtype), "cache": dtype_name(cache),
           "design": append_design(True, vec),
           "cuda_launches_per_call": launches, "max_abs_err": err,
           **distances, "bit_equal_to_plain": bit_equal_plain,
           "other_rows_untouched": untouched, "bit_equal_launches": bit_equal,
           "graph_replay_bit_equal": graph_equal,
           "kernel_ms": graph_ms(lambda: call(target), 50),
           "plain_ms": graph_ms(lambda: rope_kv_append_reference(
               target, q, k, v, pos, ROPE_THETA), 20),
           "rope_then_kv_append_kernel_ms": graph_ms(parent_path, 20),
           "library": "none: no single PyTorch call rotates, quantizes and "
                      "writes",
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = rope_kv_append_bound_ms(
        batch, t_new, heads, kv_heads, dim, q_dtype, cache)
    row["card"] = card
    emit(row)
    del got, again, want, target, base
    torch.cuda.empty_cache()
    return row


def phase_decode_kernels(card):
    """Phase 3e: (attention rows, rotation-free cache-write rows, rotating
    cache-write rows), in DECODE_SHAPES' order."""
    return ([check_decode_shape(*shape, card) for shape in DECODE_SHAPES],
            [check_append_shape(*shape, card) for shape in DECODE_SHAPES],
            [check_rope_append_shape(*shape, card)
             for shape in DECODE_SHAPES])


#: (label, rows, dim, dtype, iters) of phase 3f's norm rows, at
#: llama-277M's d_model: the bench decode's step (8 rows), its prefill
#: block (8 x 64), the train step's 16 x 1024, an f32 step and an odd
#: width (element loads). The first row is the decode paths' most
#: launched call, the third the train step's.
NORM_SHAPES = [
    ("bench_decode", 8, 2048, torch.bfloat16, 200),
    ("prefill_block", 512, 2048, torch.bfloat16, 100),
    ("train", TRAIN_ROWS, 2048, torch.bfloat16, 10),
    ("decode_f32", 8, 2048, torch.float32, 200),
    ("odd_width", 64, 1001, torch.bfloat16, 100),
]
#: (label, rows, d_ff, dtype, iters) of phase 3f's gate rows: the bench
#: decode, phase 9's tp = 2 shard (4 rows a rank over half of d_ff), the
#: prefill block, the train step's and an f32 step
GATE_SHAPES = [
    ("bench_decode", 8, 8192, torch.bfloat16, 200),
    ("tp2_shard", 4, 4096, torch.bfloat16, 200),
    ("prefill_block", 512, 8192, torch.bfloat16, 100),
    ("train", TRAIN_ROWS, 8192, torch.bfloat16, 10),
    ("decode_f32", 8, 8192, torch.float32, 200),
]


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bytes_bound_ms(nbytes):
    """The least time to move ``nbytes`` once at the memory rate: the
    norm and the gate do a few FLOPs an element, far below the float32
    peak's share of their bytes."""
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def flat_bytes(*tensors):
    return torch.cat([t.reshape(-1).contiguous().view(torch.uint8)
                      for t in tensors if t is not None])


def check_launch_contract(name, label, fn, outputs, again):
    """Two launches bit-equal, one CUDA graph replay bit-equal to the
    eager call, one CUDA launch a call; raises otherwise."""
    bit_equal = all(torch.equal(a, b) for a, b in zip(outputs, again)
                    if a is not None)
    graph_equal = graph_replay_equal(lambda: flat_bytes(*fn()),
                                     flat_bytes(*outputs))
    launches = cuda_launches(fn)
    if not (bit_equal and graph_equal and launches == 1):
        raise RuntimeError(
            f"{name} at {label}: bit-equal launches {bit_equal}, graph "
            f"replay bit-equal {graph_equal}, CUDA launches a call "
            f"{launches}")
    return {"cuda_launches_per_call": launches, "bit_equal_launches": True,
            "graph_replay_bit_equal": True}


def norm_inputs(gen, dim, dtype):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # a weight near the model's init (ones)
    weight = (1 + 0.1 * torch.randn((dim,), generator=gen, device="cuda")) \
        .to(dtype)
    return randn, weight


def check_norm_shape(label, rows, dim, dtype, iters, add, card):
    """The norm kernel against its plain version at one shape, with the
    residual add or without: the sum bit-equal, the norm within
    ``KERNEL_TOL`` taken once for each of its two roundings (the variance
    sums in another order, so ``x * rstd`` may round one ulp apart before
    the weight multiply), rstd (the train shape writes it) within 1e-6;
    the launch contract; the plan's layout and the instance's registers
    and spills; times in CUDA graphs beside the plain version and
    ``F.rms_norm``, and at the bench decode after the O projection
    (``after_product_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    randn, w = norm_inputs(gen, dim, dtype)
    h = randn(rows, dim)
    d = randn(rows, dim) if add else None
    # the train step's forward writes rstd for its backward
    want_rstd = label == "train"

    def call():
        return norm_mod._launch_forward(h, d, w, norm_mod.EPS, want_rstd)

    s, y, rstd = call()
    again = call()
    torch.cuda.synchronize()
    ref_s, ref_y = add_rms_norm_reference(h, d, w)
    _, ref_rstd = _rms_parts(ref_s, w, norm_mod.EPS)
    pre = (ref_s * ref_rstd[:, None]).to(dtype).float().abs() * \
        w.float().abs()
    rtol, atol = KERNEL_TOL[dtype]
    err = (y.float() - ref_y.float()).abs()
    use = (err / (atol + rtol * (ref_y.float().abs() + pre))).max().item()
    sum_equal = d is None or torch.equal(s, ref_s)
    rstd_err = None if rstd is None else \
        ((rstd - ref_rstd).abs() / ref_rstd).max().item()
    if not (use <= 1 and sum_equal and (rstd_err is None or rstd_err <= 1e-6)
            and y.dtype == ref_y.dtype and torch.isfinite(y.float()).all()):
        raise RuntimeError(
            f"rms_norm off its plain version at {label} (add {add}): "
            f"limit_use {use}, max|err| {err.max().item()}, sum bit-equal "
            f"{sum_equal}, rstd relative error {rstd_err}")
    vec = norm_mod.vector_width(dim, h, d, w, s, y)
    p = norm_mod.forward_plan(rows, dim, vec, 0, add, (dtype,) * 3)
    row = {"phase": "norm_gate_kernels", "name": "rms_norm", "shape": label,
           "rows": rows, "dim": dim, "dtype": dtype_name(dtype), "add": add,
           "writes_rstd": want_rstd,
           **check_launch_contract("rms_norm", label, call,
                                   (s, y, rstd), again),
           "design": norm_design(rows, dim, vec, False, dtype, add),
           "plan": dataclasses.asdict(p),
           "ptxas": instance_ptxas(
               "rms_norm.cu", "rms_norm_fwd_kernel", vec=vec, loads=p.loads,
               packed=norm_mod.packed(vec, p.loads, (dtype,) * 3)),
           "max_abs_err": err.max().item(),
           "limit": "atol + rtol * (|ref| + |round(s * rstd) * w|)",
           "rtol": rtol, "atol": atol, "limit_use": use,
           "bit_equal_to_plain_share": (y == ref_y).float().mean().item(),
           "max_ulp_vs_plain": max_ulp(y, ref_y),
           "sum_bit_equal": sum_equal, "rstd_max_rel_err": rstd_err,
           "kernel_ms": graph_ms(call, iters),
           "plain_ms": graph_ms(
               lambda: add_rms_norm_reference(h, d, w), max(2, iters // 4))}
    dims = (dim,)
    if add:
        row["library"] = ("torch.add + torch.nn.functional.rms_norm (one "
                          "rounding, not the reference's two)")
        row["library_ms"] = graph_ms(lambda: torch.nn.functional.rms_norm(
            h + d, dims, w, norm_mod.EPS), iters)
    else:
        row["library"] = ("torch.nn.functional.rms_norm (one rounding, not "
                          "the reference's two)")
        row["library_ms"] = graph_ms(lambda: torch.nn.functional.rms_norm(
            h, dims, w, norm_mod.EPS), iters)
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(
        tensor_bytes(h, d, w, s, y, rstd))
    if label == "bench_decode":
        # after the O projection that gives it delta (or h), as in the
        # decode step: the time the launch adds to the product's
        out = randn(rows, dim)
        row["after_product"] = after_product_ms(
            (lambda o: add_rms_norm(h, o, w)) if add
            else (lambda o: add_rms_norm(o, None, w)), out, dim, iters)
        del out
    row["card"] = card
    emit(row)
    del h, d, s, y, rstd, again, ref_s, ref_y, pre, err
    torch.cuda.empty_cache()
    return row


def check_norm_bwd_shape(label, rows, dim, dtype, iters, fused, card):
    """The norm's backward kernel against its plain formula at one shape,
    with the residual output's gradient ``ds`` or without: dx and dw
    within ``KERNEL_TOL`` (the row sums and dw's sum over the rows in
    another order); the launch contract (dw's ordered combine: launches
    and a replay bit-equal); the plan, the design and the instance's
    registers, shared memory, spills and stack; times in CUDA graphs
    beside the plain formula and ``F.rms_norm``'s backward op (eagerly
    its autograd backward and that of the plain norm, what the train step
    ran before); where dw's combine has two levels, the kernel with
    one level (every block's partial added by the last block) beside it;
    at the train shape the kernel in other layouts of the row."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    randn, w = norm_inputs(gen, dim, dtype)
    x, dy = randn(rows, dim), randn(rows, dim)
    ds = randn(rows, dim) if fused else None
    _, rstd = _rms_parts(x, w, norm_mod.EPS)

    def call():
        return rms_norm_bwd(dy, x, w, rstd, ds)

    dx, dw = call()
    again = call()
    torch.cuda.synchronize()
    ref_dx, ref_dw = rms_norm_backward_reference(dy, x, w, rstd, ds)
    rtol, atol = KERNEL_TOL[dtype]
    use = max(limit_use((dx.float() - ref_dx.float()).abs(), ref_dx, rtol,
                        atol),
              limit_use((dw.float() - ref_dw.float()).abs(), ref_dw, rtol,
                        atol))
    err = max((dx.float() - ref_dx.float()).abs().max().item(),
              (dw.float() - ref_dw.float()).abs().max().item())
    if not (use <= 1 and torch.isfinite(dx.float()).all()
            and torch.isfinite(dw.float()).all()):
        raise RuntimeError(
            f"rms_norm_bwd off its plain formula at {label} (ds {fused}): "
            f"limit_use {use}, max|err| {err}")
    vec = norm_mod.vector_width(dim, dy, x, w, ds, dx)
    dtypes = (dtype, dtype, dtype, dtype if fused else None)
    p = norm_mod.backward_plan(rows, dim, vec, 0, dtypes)
    packed = norm_mod.packed(vec, p.loads, [d for d in dtypes if d])
    ptxas = instance_ptxas(
        "rms_norm.cu", "rms_norm_bwd_kernel",
        keys=("registers", "static_smem_bytes", "spill_store_bytes",
              "stack_bytes"), vec=vec, loads=p.loads, packed=packed,
        ds=fused)
    if isinstance(ptxas, dict):
        ptxas["dynamic_smem_bytes"] = 4 * dim
    row = {"phase": "norm_gate_kernels", "name": "rms_norm_bwd",
           "shape": label, "rows": rows, "dim": dim,
           "dtype": dtype_name(dtype), "add": fused,
           **check_launch_contract("rms_norm_bwd", label, call, (dx, dw),
                                   again),
           "design": norm_design(rows, dim, vec, backward=True, dtype=dtype,
                                 add=fused),
           "plan": dataclasses.asdict(p), "ptxas": ptxas,
           "max_abs_err": err, "rtol": rtol, "atol": atol, "limit_use": use,
           "dw_bit_equal_to_plain": bool(torch.equal(dw, ref_dw)),
           "kernel_ms": graph_ms(call, iters),
           "plain_ms": graph_ms(lambda: rms_norm_backward_reference(
               dy, x, w, rstd, ds), max(2, iters // 4))}
    groups = -(-p.blocks // p.blocks_per_group)
    row["combine"] = {
        "order": "a thread's rows in order; the block's groups in order; "
                 + (f"{groups} groups of {p.blocks_per_group} blocks, each "
                    "group's partials in block order by its last block, "
                    "then the groups' sums in group order by the last "
                    "group" if groups > 1 else
                    "the blocks' partials in block order by the last "
                    "block"),
        "blocks": p.blocks, "groups": groups,
        "partial_bytes": 4 * dim * (p.blocks + (groups if groups > 1
                                                else 0))}
    if groups > 1:
        # the same launch with one level: the last block adds every
        # block's partial
        row["combine"]["one_level_ms"] = with_attrs(
            norm_mod, lambda: graph_ms(call, iters), COMBINE_GROUPS=1)
    if label == "train":
        # the plan's other layouts of a row of 2,048 (threads a row x
        # vectors a thread), each with its resident blocks
        row["layouts_ms"] = {
            f"{2048 // vec // loads}x{loads}": with_attrs(
                norm_mod, lambda: graph_ms(call, iters),
                BACKWARD_TARGET_LOADS=loads)
            for loads in (1, 2, 4)}
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = rms_norm_reference(xr, wr)
    row["plain_autograd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        y, [xr, wr], dy, retain_graph=True), eager_iters(iters))
    y = torch.nn.functional.rms_norm(xr, (dim,), wr, norm_mod.EPS)
    row["library"] = (
        "torch.ops.aten._fused_rms_norm_backward (dx and dw; no ds added; "
        "one rounding), the backward of torch.nn.functional.rms_norm "
        f"(grad_fn {type(y.grad_fn).__name__}), in a CUDA graph as the "
        "kernel; library_eager_ms: the autograd backward, eagerly")
    _, library_rstd = torch.ops.aten._fused_rms_norm(x, [dim], w,
                                                     norm_mod.EPS)
    row["library_ms"] = graph_ms(
        lambda: torch.ops.aten._fused_rms_norm_backward(
            dy, x, [dim], library_rstd, w, [True, True]), iters)
    row["library_eager_ms"] = cuda_ms(lambda: torch.autograd.grad(
        y, [xr, wr], dy, retain_graph=True), eager_iters(iters))
    del y, xr, wr, library_rstd
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(
        tensor_bytes(dy, x, w, rstd, ds, dx, dw))
    row["card"] = card
    emit(row)
    del x, dy, ds, dx, dw, again, ref_dx, ref_dw
    torch.cuda.empty_cache()
    return row


def with_attrs(module, fn, **values):
    """``fn()`` with ``module``'s attributes set to ``values``, then
    restored."""
    own = {name: getattr(module, name) for name in values}
    for name, value in values.items():
        setattr(module, name, value)
    try:
        return fn()
    finally:
        for name, value in own.items():
            setattr(module, name, value)


def eager_iters(iters) -> int:
    """Calls of an eagerly timed backward (the plain autograd, the
    library's): at least 10, so that one slow host turn does not make the
    mean (the train shape's 2 calls read 0.18 to 2.36 ms between runs)."""
    return max(10, iters // 4)


def norm_instance_design(vec, loads, packed) -> str:
    return f"{vec} elements a load, " + (
        "two passes (the row read twice)" if loads == 0
        else f"{loads} vectors a thread held in registers"
        + (" as packed bfloat16" if packed else ""))


def norm_design(rows, dim, vec, backward, dtype=torch.bfloat16,
                add=True) -> str:
    loads = {8: "8-element vector loads", 4: "4-element vector loads",
             1: "element loads"}[vec]
    if backward:
        dtypes = (dtype, dtype, dtype, dtype if add else None)
        p = norm_mod.backward_plan(rows, dim, vec, 0, dtypes)
        groups = -(-p.blocks // p.blocks_per_group)
        held = ("the row read twice, dw's sums in shared memory"
                if p.loads == 0 else
                f"{p.loads} vectors a thread of dy, x"
                + (" and ds" if add else "") + " held in registers"
                + (" as packed bfloat16" if norm_mod.packed(
                    vec, p.loads, [d for d in dtypes if d]) else "")
                + ", the next row's loads before this row's sum, dw's "
                "sums in registers")
        barrier = ("no barrier" if p.threads_per_row == 32
                   else "the row's own named barrier")
        combine = (f"dw combined in {groups} groups of "
                   f"{p.blocks_per_group} blocks, then the groups"
                   if groups > 1 else "dw combined in block order by the "
                   "last block")
        return (f"{p.threads_per_row} threads a row, {loads}, {held}, "
                f"{barrier}; {p.rows_per_block} rows a block, {p.blocks} "
                f"blocks striding; {combine}")
    p = norm_mod.forward_plan(rows, dim, vec, 0, add, (dtype,) * 3)
    held = ("the row read twice" if p.loads == 0 else
            f"{p.loads} vectors a thread held in registers"
            + (" as packed bfloat16" if norm_mod.packed(
                vec, p.loads, (dtype,) * 3) else ""))
    barrier = "no barrier" if p.threads_per_row == 32 else "one barrier a row"
    groups = -(-rows // p.rows_per_block)
    grid = ("a block for each" if p.blocks == groups
            else f"{p.blocks} blocks striding")
    return (f"{p.threads_per_row} threads a row, {loads}, {held}, "
            f"{barrier}; {p.rows_per_block} rows a block, {grid}; "
            "programmatic dependent launch")


def after_product_ms(kernel, m, out_features, iters):
    """The time a forward kernel adds after the bf16 product that gives
    it its input, as on the decode step: ``graph_ms`` of ``kernel(m @
    W)`` less that of ``m @ W`` alone, in turns (product, both, both,
    product), each call on another of ``weight_copies`` copies of W that
    overflow L2, so that the product reads its weight from device memory
    as the step's does. With programmatic dependent launch the kernel may
    start before the product ends, which the repeated kernel alone
    (``kernel_ms``) does not show."""
    k = m.shape[-1]
    copies = max(2, ROTATE_BYTES // (k * out_features * m.element_size()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 54)
    weights = [(torch.randn((k, out_features), generator=gen, device="cuda")
                * k ** -0.5).to(m.dtype) for _ in range(copies)]
    turn = itertools.cycle(weights)

    def product():
        return torch.matmul(m, next(turn))

    def both():
        return kernel(product())

    times = {"product": [], "both": []}
    for name in ("product", "both", "both", "product"):
        times[name].append(graph_ms(both if name == "both" else product,
                                    iters))
    product_ms = statistics.mean(times["product"])
    both_ms = statistics.mean(times["both"])
    del weights
    torch.cuda.empty_cache()
    return {"product": f"({m.shape[0]}, {k}) x ({k}, {out_features}) "
                       f"{dtype_name(m.dtype)}, torch.matmul",
            "weight_copies": copies, "product_ms": product_ms,
            "product_and_kernel_ms": both_ms,
            "kernel_after_product_ms": both_ms - product_ms,
            "turns_ms": times}


def check_gate_shape(label, rows, dim, dtype, iters, card):
    """The gate kernel against ``F.silu(g) * u`` at one shape: bit-equal
    (else the largest ulp distance, held to ``KERNEL_TOL``); the launch
    contract; the plan's layout and the instance's registers and spills;
    times in CUDA graphs beside the plain version, and at the bench
    decode after the up projection (``after_product_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    g, u = ((2 * torch.randn((rows, dim), generator=gen, device="cuda"))
            .to(dtype) for _ in range(2))

    def call():
        return (swiglu(g, u),)

    (y,) = call()
    again = call()
    torch.cuda.synchronize()
    ref = swiglu_reference(g, u)
    rtol, atol = KERNEL_TOL[dtype]
    err = (y.float() - ref.float()).abs()
    use = limit_use(err, ref, rtol, atol)
    if not (use <= 1 and torch.isfinite(y.float()).all()):
        raise RuntimeError(f"swiglu off its plain version at {label}: "
                           f"limit_use {use}, max ulp {max_ulp(y, ref)}")
    vec = gate_vector_width(g, u, y)
    p = gate_mod.forward_plan(g.numel(), vec, dtype, 0)
    row = {"phase": "norm_gate_kernels", "name": "swiglu", "shape": label,
           "rows": rows, "dim": dim, "dtype": dtype_name(dtype),
           **check_launch_contract("swiglu", label, call, (y,), again),
           "design": gate_design(p, vec),
           "plan": dataclasses.asdict(p),
           "ptxas": instance_ptxas("swiglu.cu", "swiglu_fwd_kernel",
                                   dtype=dtype_name(dtype), vec=vec,
                                   unroll=p.unroll),
           "max_abs_err": err.max().item(), "rtol": rtol, "atol": atol,
           "limit_use": use, "bit_equal_to_plain": bool(torch.equal(y, ref)),
           "max_ulp_vs_plain": max_ulp(y, ref),
           "kernel_ms": graph_ms(lambda: swiglu(g, u), iters),
           "plain_ms": graph_ms(lambda: swiglu_reference(g, u),
                                max(2, iters // 4)),
           "library": "none: no single PyTorch call gates", "library_ms": None}
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(tensor_bytes(g, u, y))
    if label == "bench_decode":
        # after the up projection that gives it u, as in the decode step
        m = torch.randn((rows, CONFIG_277M.d_model), generator=gen,
                        device="cuda").to(dtype)
        row["after_product"] = after_product_ms(lambda o: swiglu(g, o), m,
                                                dim, iters)
        del m
    row["card"] = card
    emit(row)
    del g, u, y, again, ref, err
    torch.cuda.empty_cache()
    return row


def check_gate_bwd_shape(label, rows, dim, dtype, iters, card):
    """The gate's backward kernel against its plain formula at one shape:
    dg and du bit-equal (else the largest ulp distances, held to
    ``KERNEL_TOL``); the launch contract; times in CUDA graphs beside the
    plain formula and eagerly beside autograd through ``F.silu(g) * u``
    (what the train step ran before)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    dy, g, u = ((2 * torch.randn((rows, dim), generator=gen, device="cuda"))
                .to(dtype) for _ in range(3))

    def call():
        return swiglu_bwd(dy, g, u)

    dg, du = call()
    again = call()
    torch.cuda.synchronize()
    ref_dg, ref_du = swiglu_backward_reference(dy, g, u)
    rtol, atol = KERNEL_TOL[dtype]
    use = max(limit_use((dg.float() - ref_dg.float()).abs(), ref_dg, rtol,
                        atol),
              limit_use((du.float() - ref_du.float()).abs(), ref_du, rtol,
                        atol))
    ulps = {"dg_max_ulp_vs_plain": max_ulp(dg, ref_dg),
            "du_max_ulp_vs_plain": max_ulp(du, ref_du)}
    if not (use <= 1 and torch.isfinite(dg.float()).all()
            and torch.isfinite(du.float()).all()):
        raise RuntimeError(f"swiglu_bwd off its plain formula at {label}: "
                           f"limit_use {use}, {ulps}")
    gr, ur = g.clone().requires_grad_(), u.clone().requires_grad_()
    y = swiglu_reference(gr, ur)
    row = {"phase": "norm_gate_kernels", "name": "swiglu_bwd",
           "shape": label, "rows": rows, "dim": dim,
           "dtype": dtype_name(dtype),
           **check_launch_contract("swiglu_bwd", label, call, (dg, du),
                                   again),
           "design": gate_bwd_design(gate_vector_width(dy, g, u, dg, du)),
           "max_abs_err": max(
               (dg.float() - ref_dg.float()).abs().max().item(),
               (du.float() - ref_du.float()).abs().max().item()),
           "rtol": rtol, "atol": atol, "limit_use": use,
           "bit_equal_to_plain": bool(torch.equal(dg, ref_dg)
                                      and torch.equal(du, ref_du)),
           **ulps,
           "kernel_ms": graph_ms(call, iters),
           "plain_ms": graph_ms(lambda: swiglu_backward_reference(dy, g, u),
                                max(2, iters // 4)),
           "plain_autograd_ms": cuda_ms(lambda: torch.autograd.grad(
               y, [gr, ur], dy, retain_graph=True), eager_iters(iters)),
           "library": "none: no single PyTorch call gates", "library_ms": None}
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(
        tensor_bytes(dy, g, u, dg, du))
    row["card"] = card
    emit(row)
    del dy, g, u, dg, du, again, ref_dg, ref_du, y, gr, ur
    torch.cuda.empty_cache()
    return row


def gate_design(p, vec) -> str:
    loads = {8: "8-element vector loads", 4: "4-element vector loads",
             1: "element loads"}[vec]
    return (f"{p.unroll} vectors a thread ({loads}), every load first; "
            f"{p.blocks} blocks of 256 striding, a scalar tail; "
            "programmatic dependent launch")


def gate_bwd_design(vec) -> str:
    loads = {8: "8-element vector loads", 4: "4-element vector loads",
             1: "element loads"}[vec]
    return f"a thread a vector ({loads}), the grid striding, a scalar tail"


def phase_norm_gate_kernels(card):
    """Phase 3f: (norm rows, norm backward rows, gate rows, gate backward
    rows); the first of each is its kernel's line entry's: the bench
    decode with the add (the decode step's 2L of its 2L + 1 norms), the
    train shape with ds, the bench decode's gate and the train shape's
    gate backward."""
    norm = [check_norm_shape(*shape, add, card) for add in (True, False)
            for shape in NORM_SHAPES]
    norm_bwd = [check_norm_bwd_shape(*shape, fused, card)
                for fused in (True, False) for shape in NORM_SHAPES]
    norm_bwd.sort(key=lambda r: (r["shape"] != "train", not r["add"]))
    gate = [check_gate_shape(*shape, card) for shape in GATE_SHAPES]
    gate_bwd = [check_gate_bwd_shape(*shape, card) for shape in GATE_SHAPES]
    gate_bwd.sort(key=lambda r: r["shape"] != "train")
    return norm, norm_bwd, gate, gate_bwd


#: (label, B, S, H, H_kv, D, dtype, head_major, first position) of phase
#: 3g's RoPE rows: the train step's in the flash path's layout (q, k and
#: v written head-major: the row its launches run) and in the xla path's,
#: the ring's block at its global positions, f32 at batch 2 (phase 7's f32
#: gradients), head_dims 64 (GQA, an odd S) and 16, and the narrower
#: loads' instances (D 8: 4 pairs a thread; D 18: one)
ROPE_SHAPES = [
    ("train_flash", 16, 1024, 16, 16, 128, torch.bfloat16, True, None),
    ("train_xla", 16, 1024, 16, 16, 128, torch.bfloat16, False, None),
    ("ring_block", 1, 2048, 16, 16, 128, torch.bfloat16, False, 2048),
    ("f32_flash", 2, 1024, 16, 16, 128, torch.float32, True, None),
    ("d64_gqa_s997", 2, 997, 8, 2, 64, torch.bfloat16, True, None),
    ("d16_f32", 2, 256, 4, 2, 16, torch.float32, False, 5),
    ("d8_vec4", 2, 61, 3, 1, 8, torch.bfloat16, True, None),
    ("d18_vec1", 1, 33, 2, 2, 18, torch.float32, False, 7),
]


def bit_equal(got, want) -> bool:
    """The same bits (not only equal values: -0 and +0 differ)."""
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                               b.reshape(-1).contiguous().view(torch.uint8))
               for a, b in zip(got, want))


def rope_design(head_major, backward, vec, splits) -> str:
    layout = "head-major" if head_major else "(B, S, H, D)"
    where = (f"from {layout} to (B, S, H, D)" if backward
             else f"from (B, S, H, D) to {layout}")
    return (f"a thread a token's {vec} pairs, their cos/sin once, walking "
            f"the heads of q, k{' and v' if head_major else ''} in "
            f"{splits} head groups; {where}")


def check_rope_shape(label, batch, seq, heads, kv_heads, dim, dtype,
                     head_major, start, card):
    """rope_qk and rope_bwd against their plain versions at one shape:
    every output bit-equal (the plain version's roundings, signed zeros
    included: zeros planted in the gradients); the launch contract of
    each; times in CUDA graphs beside the plain versions (what the path
    ran before: ``_rope`` of q and k, the flash path's transposed copies,
    autograd's backward of the same operations)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)

    def randn(h):
        return torch.randn((batch, seq, h, dim), generator=gen,
                           device="cuda").to(dtype)

    q, k, v = randn(heads), randn(kv_heads), randn(kv_heads)
    v = v if head_major else None
    pos = None if start is None else \
        start + torch.arange(seq, device="cuda")
    extra = {"v": v, "head_major": True} if head_major else {}

    def fwd():
        return rope_qk(q, k, ROPE_THETA, pos, **extra)

    outs, again = fwd(), fwd()
    want = rope_mod._plain(q, k, v, ROPE_THETA, pos, head_major)
    douts = [torch.randn(t.shape, generator=gen, device="cuda").to(dtype)
             for t in outs]
    for t in douts:
        t.view(-1)[: dim * 3] = 0.0
        t.view(-1)[dim * 3: dim * 4] = -0.0
    dv = douts[2] if head_major else None

    def bwd():
        return rope_bwd(douts[0], douts[1], ROPE_THETA, pos, dv=dv,
                        head_major=head_major)

    grads, grads_again = bwd(), bwd()
    want_grads = rope_mod._plain_backward(douts[0], douts[1], dv,
                                          ROPE_THETA, pos, head_major)
    torch.cuda.synchronize()
    fwd_equal, bwd_equal = bit_equal(outs, want), bit_equal(grads,
                                                            want_grads)
    if not (fwd_equal and bwd_equal):
        raise RuntimeError(
            f"rope at {label}: forward bit-equal {fwd_equal} (max ulp "
            f"{[max_ulp(a, b) for a, b in zip(outs, want)]}), backward "
            f"{bwd_equal} (max ulp "
            f"{[max_ulp(a, b) for a, b in zip(grads, want_grads)]})")
    vec = rope_mod.vector_width(dim, q, k, v, *outs)
    groups = rope_mod.splits(batch * seq, dim, vec,
                             heads + kv_heads * (2 if head_major else 1),
                             _build.sm_count(0))
    common = {"phase": "train_kernels", "shape": label, "B": batch, "S": seq,
              "H": heads, "H_kv": kv_heads, "D": dim,
              "dtype": dtype_name(dtype), "head_major": head_major,
              "with_v": head_major, "first_position": start or 0,
              "vec": vec, "head_groups": groups, "max_abs_err": 0.0,
              "library": "none: no single PyTorch call rotates",
              "library_ms": None}
    # the function's bytes: each input read once, each output written once
    nbytes = tensor_bytes(q, k, v, pos, *outs)
    rows = []
    for name, call, got, twice, plain, backward in (
            ("rope", fwd, outs, again,
             lambda: rope_mod._plain(q, k, v, ROPE_THETA, pos, head_major),
             False),
            ("rope_bwd", bwd, grads, grads_again,
             lambda: rope_mod._plain_backward(douts[0], douts[1], dv,
                                              ROPE_THETA, pos, head_major),
             True)):
        iters = 50 if q.numel() < 1 << 24 else 20
        row = {**common, "name": name,
               **check_launch_contract(name, label, call, got, twice),
               "design": rope_design(head_major, backward, vec, groups),
               "ptxas": instance_ptxas("rope.cu", "rope_kernel",
                                       backward=backward, vec=vec),
               "bit_equal_to_plain": True,
               "kernel_ms": graph_ms(call, iters),
               "plain_ms": graph_ms(plain, max(2, iters // 5))}
        row["bound_ms"], row["bound_by"] = bytes_bound_ms(nbytes)
        row["card"] = card
        emit(row)
        rows.append(row)
    del q, k, v, outs, again, want, douts, grads, grads_again, want_grads
    torch.cuda.empty_cache()
    return rows


#: (label, dtype, AdamW options, count before the step) of phase 3g's
#: AdamW rows over llama-277M's 39 leaves: the train step's (bf16, a
#: constant rate; its first row), f32, the warmup-cosine schedule at
#: counts 0 and 5, the clip with a global norm above its limit (the
#: gradients scaled) and below it, and optax.adam's weight decay 0
ADAMW_CASES = [
    ("bf16_constant", torch.bfloat16, {}, 0),
    ("f32_constant", torch.float32, {}, 0),
    ("bf16_schedule_count0", torch.bfloat16,
     {"warmup_steps": 2, "total_steps": 100}, 0),
    ("bf16_schedule_count5", torch.bfloat16,
     {"warmup_steps": 2, "total_steps": 100}, 5),
    ("bf16_clip_above", torch.bfloat16, {"clip_norm": 0.5}, 0),
    ("bf16_clip_below", torch.bfloat16, {"clip_norm": 2.0}, 0),
    ("bf16_adam", torch.bfloat16, {"weight_decay": 0.0}, 0),
    ("f32_schedule_clip_count5", torch.float32,
     {"warmup_steps": 2, "total_steps": 100, "clip_norm": 0.5}, 5),
]


def adamw_leaves(dtype):
    """(grads, mu, nu, params) of llama-277M's shapes in ``dtype``:
    the model's init, gradients and first moments near 1e-3, second
    moments their squares."""
    params = tree_leaves(init_llama_params(CONFIG_277M, param_dtype=dtype,
                                           seed=SEED + 71, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)

    def like(p, scale):
        return (scale * torch.randn(p.shape, generator=gen,
                                    device="cuda")).to(dtype)

    grads = [like(p, 1e-3) for p in params]
    mu = [like(p, 1e-3) for p in params]
    nu = [like(p, 1e-3).square() for p in params]
    return grads, mu, nu, params


def fused_adamw_ms(grads, mu, nu, params, lr, weight_decay, iters):
    """``torch._fused_adamw_`` (PyTorch's multi-tensor AdamW: the same
    work, other numerics: torch's decay and eps) over copies of the
    leaves, CUDA events."""
    p, m, v = ([t.clone() for t in ts] for ts in (params, mu, nu))
    steps = [torch.zeros((), device="cuda") for _ in params]

    def call():
        torch._fused_adamw_(p, grads, m, v, [], steps, lr=lr,
                            beta1=adamw_mod.B1, beta2=adamw_mod.B2,
                            weight_decay=weight_decay, eps=adamw_mod.EPS,
                            amsgrad=False, maximize=False)

    return cuda_ms(call, iters)


def check_adamw_case(label, dtype, options, count, leaves, card):
    """adamw_update against its plain version on llama-277M's leaves: new
    p, m and v bit-equal and the inputs unchanged; the launch contract of
    the kernel alone (its 0-d arguments made first); times beside the
    plain version and ``torch._fused_adamw_``."""
    grads, mu, nu, params = leaves
    opt = AdamW(CONFIG_277M.learning_rate, **options)
    before = [t.clone() for t in grads + mu + nu + params]
    count_t = torch.tensor(count, dtype=torch.int32, device="cuda")
    norm, clip = None, opt.clip_norm
    if clip:
        norm = global_norm(grads)
        # the limit a share of the norm: above it the gradients scale
        clip = opt.clip_norm * float(norm)
    state = {"count": count_t, "mu": mu, "nu": nu}
    kw = {"lr": opt.learning_rate(count_t), "weight_decay": opt.weight_decay,
          "clip_norm": clip, "norm": norm}
    got_p, got_s = adamw_mod.adamw_update(grads, state, params, **kw)
    want_p, want_s = adamw_mod.adamw_update_reference(grads, state, params,
                                                      **kw)
    torch.cuda.synchronize()
    got = got_p + got_s["mu"] + got_s["nu"]
    want = want_p + want_s["mu"] + want_s["nu"]
    equal = bit_equal(got, want)
    unchanged = bit_equal(before, grads + mu + nu + params)
    if not (equal and unchanged):
        worst = max(max_ulp(a, b) for a, b in zip(got, want))
        raise RuntimeError(f"adamw at {label}: bit-equal to plain {equal} "
                           f"(max ulp {worst}), inputs unchanged "
                           f"{unchanged}")
    del got_p, got_s, want_p, want_s, got, want, before
    args = {**adamw_mod.scalars(count_t + 1, kw["lr"], dtype, clip, norm),
            "weight_decay": opt.weight_decay, "clip_norm": clip}

    def call():
        return [t for ts in adamw_mod.launch(grads, mu, nu, params, **args)
                for t in ts]

    outs = call()
    row = {"phase": "train_kernels", "name": "adamw", "shape": label,
           "leaves": len(params), "elements": sum(p.numel() for p in params),
           "dtype": dtype_name(dtype), "count": count,
           "schedule": opt.total_steps > 0, "clip_norm": clip,
           "clipped": bool(clip) and float(norm) >= clip,
           "weight_decay": opt.weight_decay,
           **check_launch_contract("adamw", label, call, outs, call()),
           "design": f"one launch over {len(params)} leaves (a table of "
                     f"{adamw_mod.MAX_LEAVES} at most in the parameters), "
                     f"{adamw_mod.vector_width(params[0])} elements a load",
           "ptxas": instance_ptxas("adamw.cu", "adamw_kernel",
                                   vec=adamw_mod.vector_width(params[0])),
           "bit_equal_to_plain": True, "inputs_unchanged": True,
           "max_abs_err": 0.0}
    del outs
    if label in ("bf16_constant", "f32_constant"):
        row.update({
            "kernel_ms": cuda_ms(call, 20),
            "update_ms": cuda_ms(lambda: adamw_mod.adamw_update(
                grads, state, params, **kw), 20),
            "plain_ms": cuda_ms(lambda: adamw_mod.adamw_update_reference(
                grads, state, params, **kw), 5),
            "library": "torch._fused_adamw_ (torch's AdamW numerics)",
            "library_ms": fused_adamw_ms(grads, mu, nu, params,
                                         CONFIG_277M.learning_rate,
                                         opt.weight_decay, 20)})
        row["bound_ms"], row["bound_by"] = bytes_bound_ms(
            tensor_bytes(*grads, *mu, *nu, *params) * 7 // 4)
    row["card"] = card
    emit(row)
    torch.cuda.empty_cache()
    return row


#: (label, B, S, V, dtype, S_used, gradient, iters) of phase 3g's loss
#: rows: the train step's logits (its first row), phase 7's f32
#: gradients at batch 2, an odd vocabulary (element loads), Llama 3's
#: 128,256-wide vocabulary at few rows (the wide rows' loop) and a ring
#: block of four at the train shape, whose S_used is S and whose loss
#: takes a share of 1/4 of the gradient
LOSS_SHAPES = [
    ("train", TRAIN_BATCH, 1024, 2048, torch.bfloat16, 1023, 1.0, 20),
    ("f32", 2, 1024, 2048, torch.float32, 1023, 1.0, 50),
    ("odd_vocab_1001", 4, 256, 1001, torch.bfloat16, 255, 1.0, 50),
    ("vocab_128256", 2, 16, 128256, torch.bfloat16, 15, 1.0, 50),
    ("ring_block", TRAIN_BATCH, 256, 2048, torch.bfloat16, 256, 0.25, 50),
]
#: the loss against its plain version: float32 on both sides, each row's
#: sum of exps in another order (the kept log-sum within a few float32
#: ulps), so 1e-5 relative, not bit for bit
LOSS_RTOL = 1e-5
#: float32 dlogits: exp(log p) carries the log-sum's few ulps (1e-5 of
#: the value), and the target's element, gp - p * gp, cancels as p nears
#: 1 and keeps an absolute error of a few ulps of gp = g / (B * S_used)
#: (2^-20 of it); bfloat16 dlogits: both round the same float32 work to
#: bfloat16 once, so one ulp
DLOGITS_F32_RTOL, DLOGITS_F32_GP_ATOL = 1e-5, 2.0 ** -20
DLOGITS_BF16_ULPS = 1
#: the clip's norm and each leaf's sum of squares: float32 sums in other
#: orders
GLOBAL_NORM_RTOL = 1e-5


def loss_design(kernel, vec) -> str:
    if kernel == "cross_entropy_fwd_kernel":
        return (f"a warp a row of up to 2,048 held in registers, {vec} "
                "elements a load; the mean's partials added in order by "
                "the last ticket")
    if kernel == "cross_entropy_wide_kernel":
        return (f"a block a row, an online (max, sum) a thread, {vec} "
                "elements a load; the mean's partials added in order by "
                "the last ticket")
    return (f"a warp a row and 2,048 columns, {vec} elements a load, "
            "log p recomputed from the kept (max, log-sum)")


def global_norm_design(vec) -> str:
    return (f"one launch over the AdamW table's leaves, {vec} elements a "
            "load, chunks of 8 vectors a thread; each leaf's partials, then "
            "the leaves, added in order by the last ticket")


def check_loss_shape(label, batch, seq, vocab, dtype, used, gradient, iters,
                     card):
    """The loss's forward and backward kernels against their plain
    versions (``next_token_loss_reference`` and its autograd, what the
    path ran before) at one shape: the loss within LOSS_RTOL, dlogits
    within DLOGITS_BF16_ULPS (bf16) or the f32 limit and exactly 0 past
    S_used; the launch contract of each; times in CUDA graphs beside the
    plain versions (the backward's by autograd, eagerly) and
    ``F.cross_entropy`` on the (N, V) rows, which rounds log p to the
    logits' dtype: a yardstick, not an oracle. Returns (forward row,
    backward row)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    logits = (3.0 * torch.randn((batch, seq, vocab), generator=gen,
                                device="cuda")).to(dtype)
    targets = torch.randint(0, vocab, (batch, used), generator=gen,
                            device="cuda")
    grad = torch.tensor(gradient, device="cuda")

    def fwd():
        return loss_mod.cross_entropy_fwd(logits, targets)

    def bwd(stats):
        return (loss_mod.cross_entropy_bwd(logits, targets, stats, grad),)

    got, again = fwd(), fwd()
    stats = got[1]
    dgot, dagain = bwd(stats), bwd(stats)
    x = logits.clone().requires_grad_()
    want = loss_mod.next_token_loss_reference(x, targets)
    (dwant,) = torch.autograd.grad(want, x, grad)
    want = want.detach()
    torch.cuda.synchronize()
    loss_err = abs(float(got[0]) - float(want)) / abs(float(want))
    gp = gradient / targets.numel()
    rest_zero = not dgot[0][:, used:].any()
    if dtype == torch.bfloat16:
        ulps = max_ulp(dgot[0], dwant)
        d_ok, d_use = ulps <= DLOGITS_BF16_ULPS, ulps / DLOGITS_BF16_ULPS
    else:
        ulps = max_ulp(dgot[0], dwant)
        d_use = float(((dgot[0] - dwant).abs() / (
            DLOGITS_F32_RTOL * dwant.abs() + DLOGITS_F32_GP_ATOL * gp))
            .max())
        d_ok = d_use <= 1
    d_err = float((dgot[0].float() - dwant.float()).abs().max())
    if not (loss_err <= LOSS_RTOL and d_ok and rest_zero
            and torch.isfinite(got[0])):
        raise RuntimeError(
            f"cross_entropy at {label}: loss {float(got[0])!r} against "
            f"{float(want)!r} (relative {loss_err}), dlogits max ulp {ulps} "
            f"(limit use {d_use}), rows past S_used zero {rest_zero}")
    common = {"phase": "train_kernels", "shape": label, "B": batch, "S": seq,
              "V": vocab, "S_used": used, "dtype": dtype_name(dtype),
              "vec": loss_mod.vector_width(logits), "card": card}
    # the library's yardstick on the used rows, copied out beforehand
    rows = logits[:, :used].reshape(-1, vocab).contiguous()
    flat = targets.reshape(-1)
    lib_x = rows.clone().requires_grad_()
    lib_loss = F.cross_entropy(lib_x, flat)
    plain_loss = loss_mod.next_token_loss_reference(x, targets)
    wide = vocab > 2048
    fwd_row = {
        **common, "name": "cross_entropy",
        **check_launch_contract("cross_entropy", label, fwd, got, again),
        "design": loss_design("cross_entropy_wide_kernel" if wide
                              else "cross_entropy_fwd_kernel",
                              common["vec"]),
        "ptxas": instance_ptxas(
            "cross_entropy.cu", "cross_entropy_wide_kernel" if wide
            else "cross_entropy_fwd_kernel", vec=common["vec"]),
        "loss": float(got[0]), "plain_loss": float(want),
        "max_abs_err": abs(float(got[0]) - float(want)),
        "rel_err": loss_err, "rel_tol": LOSS_RTOL,
        "kernel_ms": graph_ms(fwd, iters),
        "plain_ms": graph_ms(
            lambda: loss_mod.next_token_loss_reference(logits, targets),
            max(2, iters // 5)),
        "library": "F.cross_entropy on the (N, V) rows (log p rounded to "
                   "the logits' dtype)",
        "library_ms": graph_ms(lambda: F.cross_entropy(rows, flat), iters)}
    fwd_row["bound_ms"], fwd_row["bound_by"] = bytes_bound_ms(
        tensor_bytes(rows, flat, stats) + 4)
    emit(fwd_row)
    bwd_row = {
        **common, "name": "cross_entropy_bwd", "gradient": gradient,
        **check_launch_contract("cross_entropy_bwd", label,
                                lambda: bwd(stats), dgot, dagain),
        "design": loss_design("cross_entropy_bwd_kernel", common["vec"]),
        "ptxas": instance_ptxas("cross_entropy.cu",
                                "cross_entropy_bwd_kernel",
                                vec=common["vec"]),
        "max_abs_err": d_err, "max_ulp_vs_plain": ulps, "limit_use": d_use,
        "rows_past_s_used_zero": True,
        "kernel_ms": graph_ms(lambda: bwd(stats), iters),
        "plain_ms": cuda_ms(lambda: torch.autograd.grad(
            plain_loss, x, grad, retain_graph=True), max(2, iters // 5)),
        "library": "F.cross_entropy's backward on the (N, V) rows",
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            lib_loss, lib_x, retain_graph=True), iters),
        # the loss's whole work in the step: forward and backward
        "kernel_fwd_bwd_ms": graph_ms(lambda: bwd(fwd()[1]), iters),
        "plain_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
            loss_mod.next_token_loss_reference(x, targets), x, grad),
            max(2, iters // 5)),
        "library_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
            F.cross_entropy(lib_x, flat), lib_x), iters)}
    bwd_row["bound_ms"], bwd_row["bound_by"] = bytes_bound_ms(
        tensor_bytes(rows, flat, stats, grad, logits))
    emit(bwd_row)
    del logits, x, dwant, dgot, dagain, got, again, rows, lib_x, lib_loss
    del plain_loss, want
    torch.cuda.empty_cache()
    return fwd_row, bwd_row


def check_global_norm_case(label, dtype, grads, card):
    """The clip's global norm (``sum_of_squares`` with the norm: one
    launch over llama-277M's 39 leaves) against its plain version: each
    leaf's sum of squares and the norm within GLOBAL_NORM_RTOL, and
    ``parallel.global_norm`` the same launch's norm bit for bit; the
    launch contract; times in CUDA graphs beside the plain version and
    ``torch._foreach_norm`` (each leaf's norm in its dtype, not summed:
    a yardstick that reads every leaf once)."""

    def call():
        return gnorm_mod.sum_of_squares(grads, norm=True)

    got, again = call(), call()
    plain = gnorm_mod.sum_of_squares_reference(grads)
    want_sums, want = torch.stack(plain), torch.sqrt(sum(plain))
    via_parallel = global_norm(grads)
    torch.cuda.synchronize()
    rel = max(float(((got[0] - want_sums).abs() / want_sums).max()),
              abs(float(got[1]) - float(want)) / float(want))
    same = bool(torch.equal(via_parallel, got[1]))
    if not (rel <= GLOBAL_NORM_RTOL and same):
        raise RuntimeError(f"global_norm at {label}: relative error {rel}, "
                           f"parallel.global_norm the kernel's {same}")
    row = {"phase": "train_kernels", "name": "global_norm", "shape": label,
           "leaves": len(grads), "elements": sum(g.numel() for g in grads),
           "dtype": dtype_name(dtype),
           "vec": adamw_mod.vector_width(*grads),
           **check_launch_contract("global_norm", label, call, got, again),
           "design": global_norm_design(adamw_mod.vector_width(*grads)),
           "ptxas": instance_ptxas("adamw.cu", "global_norm_kernel",
                                   vec=adamw_mod.vector_width(*grads)),
           "norm": float(got[1]), "plain_norm": float(want),
           "max_abs_err": abs(float(got[1]) - float(want)), "rel_err": rel,
           "rel_tol": GLOBAL_NORM_RTOL, "parallel_global_norm_equal": True,
           "kernel_ms": graph_ms(call, 20),
           "plain_ms": graph_ms(lambda: torch.sqrt(sum(
               gnorm_mod.sum_of_squares_reference(grads))), 5),
           "library": "torch._foreach_norm (each leaf's norm in its dtype)",
           "library_ms": graph_ms(lambda: torch._foreach_norm(grads), 20),
           "card": card}
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(tensor_bytes(*grads))
    emit(row)
    torch.cuda.empty_cache()
    return row


def phase_train_kernels(card):
    """Phase 3g: (rope rows, rope_bwd rows, adamw rows, cross_entropy
    rows, cross_entropy_bwd rows, global_norm rows); the first of each is
    its kernel's line entry's: the flash train step's RoPE and its
    backward, the bf16 train step's update, loss and norm."""
    rope_rows = [row for shape in ROPE_SHAPES
                 for row in check_rope_shape(*shape, card)]
    loss_rows = [row for shape in LOSS_SHAPES
                 for row in check_loss_shape(*shape, card)]
    rows, norm_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        leaves = adamw_leaves(dtype)
        rows += [check_adamw_case(label, d, options, count, leaves, card)
                 for label, d, options, count in ADAMW_CASES if d == dtype]
        norm_rows.append(check_global_norm_case(
            f"{dtype_name(dtype)}_39_leaves", dtype, leaves[0], card))
        del leaves
        torch.cuda.empty_cache()
    rows.sort(key=lambda r: r["shape"] != "bf16_constant")
    return (rope_rows[0::2], rope_rows[1::2], rows, loss_rows[0::2],
            loss_rows[1::2], norm_rows)


#: phase 3h's pick settings: greedy; the decode contract's sampling
#: (SAMPLING); what ``DecodeServer(temperature=)`` sends (SERVED_SAMPLING:
#: the temperature alone)
GREEDY = {"temperature": 0.0, "top_k": None, "top_p": None,
          "want_logprob": False}


def pick_settings(sampling):
    """phase 3h's settings of a pick made under ``generate``'s sampling
    keywords, without the logprob (a case asks for it apart)."""
    return {"temperature": sampling["temperature"],
            "top_k": sampling["top_k"], "top_p": sampling["top_p"],
            "want_logprob": False}


PICK_SAMPLED = pick_settings(SAMPLING)
PICK_SERVED = pick_settings(SERVED_SAMPLING)
#: (label, B, V, dtype, settings, logits, draws, iters) of phase 3h: the
#: bench decode's step (8, 2048) greedy (what the bench cells and the
#: serving burst pick: the kernels line's row), sampled at the decode
#: contract's settings, with and without the logprob, bf16 and f32, and
#: at the served temperature alone; the prefill pick's strided
#: ``logits[:, -1, :]`` view; an odd vocabulary (1001: element loads) and
#: a Llama-3 one (128,256: a cluster of blocks a row); and
#: edge settings over planted rows (ties at the top, half a row -inf, a
#: row of three finite logits, equal pairs, a uniform row). ``logits``:
#: "randn" (3 x a standard normal), "strided" (the last position of (B,
#: 64, V)) or "planted"; ``draws``: noise draws whose tokens are compared
PICK_CASES = [
    ("bench_greedy", 8, 2048, torch.bfloat16, GREEDY, "randn", 1, 200),
    ("bench_greedy_logprob", 8, 2048, torch.bfloat16,
     {**GREEDY, "want_logprob": True}, "randn", 1, 200),
    ("bench_sampled", 8, 2048, torch.bfloat16, PICK_SAMPLED, "randn", 16,
     200),
    ("bench_sampled_logprob", 8, 2048, torch.bfloat16,
     {**PICK_SAMPLED, "want_logprob": True}, "randn", 16, 200),
    ("bench_served", 8, 2048, torch.bfloat16, PICK_SERVED, "randn", 16,
     200),
    ("f32_greedy_logprob", 8, 2048, torch.float32,
     {**GREEDY, "want_logprob": True}, "randn", 1, 200),
    ("f32_sampled_logprob", 8, 2048, torch.float32,
     {**PICK_SAMPLED, "want_logprob": True}, "randn", 16, 200),
    ("prefill_view_sampled_logprob", 8, 2048, torch.bfloat16,
     {**PICK_SAMPLED, "want_logprob": True}, "strided", 4, 200),
    ("prefill_view_greedy", 8, 2048, torch.bfloat16, GREEDY, "strided", 1,
     200),
    ("vocab_1001_greedy", 4, 1001, torch.bfloat16, GREEDY, "randn", 1, 200),
    ("vocab_1001_sampled_logprob", 4, 1001, torch.bfloat16,
     {**PICK_SAMPLED, "want_logprob": True}, "randn", 16, 200),
    ("vocab_128256_greedy", 2, 128256, torch.bfloat16,
     {**GREEDY, "want_logprob": True}, "randn", 1, 50),
    ("vocab_128256_sampled", 2, 128256, torch.bfloat16,
     {**PICK_SAMPLED, "want_logprob": True}, "randn", 4, 50),
    ("vocab_128256_served", 2, 128256, torch.bfloat16, PICK_SERVED,
     "randn", 4, 50),
    ("edge_greedy_ties_inf", 8, 2048, torch.bfloat16,
     {**GREEDY, "want_logprob": True}, "planted", 1, 50),
    ("edge_top_k_1", 8, 2048, torch.bfloat16,
     {**GREEDY, "temperature": 1.0, "top_k": 1}, "planted", 8, 50),
    ("edge_top_k_V", 8, 2048, torch.bfloat16,
     {**GREEDY, "temperature": 1.0, "top_k": 2048, "want_logprob": True},
     "planted", 8, 50),
    ("edge_top_p_1e-9", 8, 2048, torch.bfloat16,
     {**GREEDY, "temperature": 1.0, "top_p": 1e-9}, "planted", 8, 50),
    ("edge_top_p_1", 8, 2048, torch.bfloat16,
     {**GREEDY, "temperature": 1.0, "top_p": 1.0, "want_logprob": True},
     "planted", 8, 50),
    ("edge_t_0.05", 8, 2048, torch.bfloat16,
     {**PICK_SAMPLED, "temperature": 0.05, "want_logprob": True},
     "planted", 8, 50),
]
#: a sampled row is held to the plain version's token unless the kernel's
#: or the plain version's token is one whose nucleus decision rests on a
#: mass within this of top_p (:func:`nucleus_uncertain`: the plain
#: version's exclusive cumulative mass in descending order): the
#: kernel adds the probabilities in another order than torch.cumsum, so
#: such a token may be kept by one and masked by the other
NUCLEUS_EXEMPT = 1e-5
#: logprobs: the untempered log-softmax, the row's sum of exps in another
#: order (a few float32 ulps of the sum: its log moves by ~1e-7, which is
#: the whole value for a logprob near 0, hence the absolute term)
LOGPROB_RTOL, LOGPROB_ATOL = 1e-5, 1e-6


def pick_design(vocab, vec) -> str:
    if vocab <= pick_mod.ROW_ELEMS:
        return (f"a block a row of up to 2,048 in shared memory, {vec} "
                "elements a load; top-k and top-p by bisection over the "
                "bit patterns, a barrier a pass, no sort")
    return (f"a cluster of {pick_mod.CLUSTER_BLOCKS} blocks a row, each "
            f"holding an eighth of it in shared memory, {vec} elements a "
            "load; top-k and top-p by bisection over the bit patterns, "
            "each pass's partials across the cluster's shared memory, no "
            "sort")


def nucleus_uncertain(logits, temperature: float, top_k, top_p,
                      within: float):
    """(B, V) bool: the tokens whose nucleus decision in
    ``pick_reference`` rests on a mass within ``within`` of ``top_p``:
    the exclusive cumulative mass in descending order at the first of
    the token's value (the mass strictly above it, which the kernel sums
    in another order) lies that close. The row's maximum (mass above it
    exactly 0 on both sides) never does; none without top-p. A sampled
    token of the kernel and of the plain version can differ only where
    one of the two is such a token."""
    batch, vocab = logits.shape
    if temperature <= 0.0 or top_p is None:
        return torch.zeros((batch, vocab), dtype=torch.bool,
                           device=logits.device)
    logits_f = logits.float()
    if top_k is not None:
        logits_f = pick_mod.top_k_masked(logits_f, top_k)
    probs, sp, exclusive = pick_mod.descending_masses(logits_f, temperature)
    # the descending position of the first of each token's value: the
    # count of larger values
    above = vocab - torch.searchsorted(sp.flip(-1), probs, right=True)
    mass = torch.gather(exclusive, -1, above)
    return ((mass - top_p).abs() <= within) & (above > 0)


def pick_logits(gen, batch, vocab, dtype, kind):
    """Phase 3h's (B, V) logits of ``kind`` (see PICK_CASES) on the card."""
    if kind == "strided":
        full = 3.0 * torch.randn((batch, 64, vocab), generator=gen,
                                 device="cuda")
        return full.to(dtype)[:, -1, :]
    x = 3.0 * torch.randn((batch, vocab), generator=gen, device="cuda")
    if kind == "planted":
        x[0, :3] = x[0].max() + 1.0  # three tied maxima
        x[1, vocab // 2:] = float("-inf")
        x[2, 3:] = float("-inf")  # three finite logits
        x[3, 1::2] = x[3, 0::2]  # equal pairs
        x[4] = 0.0  # uniform
    return x.to(dtype)


def pick_agreement(label, batch, vocab, dtype, settings, kind, draws):
    """The token pick's kernel against its plain version
    (``pick_reference``, what the decode path ran before) at one case of
    PICK_CASES: greedy tokens bit-equal, sampled tokens equal over
    ``draws`` noise draws on every row but those where either token is
    one whose nucleus decision lies within NUCLEUS_EXEMPT of top_p,
    logprobs within LOGPROB_RTOL and LOGPROB_ATOL; raises otherwise.
    Returns (logits, the last draw's noise, the rows exempted over the
    draws, the largest logprob error, its largest share of the
    limit)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    x = pick_logits(gen, batch, vocab, dtype, kind)
    sample = settings["temperature"] > 0.0
    args = (settings["temperature"], settings["top_k"], settings["top_p"],
            settings["want_logprob"])
    uncertain = nucleus_uncertain(x, *args[:3], NUCLEUS_EXEMPT)
    exempt_rows, lp_err, lp_use = 0, 0.0, 0.0
    for draw in range(draws):
        u = (torch.rand((batch, vocab), generator=gen, device="cuda")
             if sample else None)
        got = pick_mod.pick(x, u, *args)
        want = pick_mod.pick_reference(x, u, *args)
        torch.cuda.synchronize()
        exempt = (uncertain.gather(-1, got[0][:, None])
                  | uncertain.gather(-1, want[0][:, None]))[:, 0]
        exempt_rows += int(exempt.sum())
        if not bool(((got[0] == want[0]) | exempt).all()):
            raise RuntimeError(
                f"token_pick at {label}, draw {draw}: tokens "
                f"{got[0].tolist()} against {want[0].tolist()} (exempt "
                f"{exempt.tolist()})")
        if settings["want_logprob"]:
            err = (got[1] - want[1]).abs()
            limit = LOGPROB_ATOL + LOGPROB_RTOL * want[1].abs()
            finite = torch.isfinite(want[1])
            if not bool(torch.equal(finite, torch.isfinite(got[1]))):
                raise RuntimeError(f"token_pick at {label}: logprobs "
                                   f"{got[1].tolist()} against "
                                   f"{want[1].tolist()}")
            if bool(finite.any()):
                lp_err = max(lp_err, float(err[finite].max()))
                lp_use = max(lp_use, float((err / limit)[finite].max()))
            if lp_use > 1.0:
                raise RuntimeError(f"token_pick at {label}: logprob error "
                                   f"{lp_err} (limit use {lp_use})")
    return x, u, exempt_rows, lp_err, lp_use


def check_pick_case(label, batch, vocab, dtype, settings, kind, draws, iters,
                    card):
    """:func:`pick_agreement` at one case of PICK_CASES, the launch
    contract, and times in CUDA graphs beside the plain version and,
    greedy, ``torch.argmax``: the case's row."""
    x, u, exempt_rows, lp_err, lp_use = pick_agreement(
        label, batch, vocab, dtype, settings, kind, draws)
    sample = settings["temperature"] > 0.0
    args = (settings["temperature"], settings["top_k"], settings["top_p"],
            settings["want_logprob"])

    def call():
        return pick_mod.pick(x, u, *args)

    def plain():
        return pick_mod.pick_reference(x, u, *args)

    out, again = call(), call()
    vec = pick_mod.vector_width(x, u)
    wide = vocab > pick_mod.ROW_ELEMS
    row = {"phase": "token_pick", "name": "token_pick", "shape": label,
           "B": batch, "V": vocab, "dtype": dtype_name(dtype),
           "logits": kind, "strided": kind == "strided", **settings,
           "vec": vec,
           **check_launch_contract("token_pick", label, call, out, again),
           "design": pick_design(vocab, vec),
           "dynamic_smem_bytes": 4 * vec * -(-vocab // (
               pick_mod.CLUSTER_BLOCKS * vec)) if wide else 0,
           "ptxas": instance_ptxas(
               "token_pick.cu", "token_pick_wide_kernel" if wide
               else "token_pick_block_kernel", vec=vec, sample=sample),
           "draws": draws, "rows_checked": draws * batch,
           "exempt_rows": exempt_rows,
           "nucleus_exempt_within": NUCLEUS_EXEMPT,
           "tokens_equal_outside_exempt": True,
           "max_abs_err": lp_err, "logprob_limit_use": lp_use,
           "logprob_rtol_atol": [LOGPROB_RTOL, LOGPROB_ATOL],
           "kernel_ms": graph_ms(call, iters),
           "plain_ms": graph_ms(plain, max(2, iters // 5)),
           "plain_cuda_launches": cuda_launches(plain),
           "library": "torch.argmax over the rows" if not sample else None,
           "library_ms": graph_ms(lambda: torch.argmax(x, dim=-1), iters)
           if not sample else None, "card": card}
    outputs = batch * (8 + (4 if settings["want_logprob"] else 0))
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(
        batch * vocab * x.element_size() + tensor_bytes(u) + outputs)
    emit(row)
    del x, u, out, again
    return row


def phase_token_pick(card):
    """Phase 3h: the token pick's rows; the first is the kernels line's
    (the bench decode's greedy pick)."""
    return [check_pick_case(*case, card) for case in PICK_CASES]


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
        before = launch_counts()
        step = stepwise_logits(params, tokens, torch.bfloat16)
        result["decode_kernel_launches_stepwise"] = expect_decode_launches(
            before, tokens.shape[1], "the stepwise bf16 decode", picks=0)
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
        before = launch_counts()
        host = generate(p, prompt, CONFIG_277M, 32,
                        param_dtype=torch.bfloat16, **kw)
        expect_decode_launches(before, 32, f"the host loop ({label})")
        before = launch_counts()
        dev = generate_on_device(p, prompt, CONFIG_277M, 32,
                                 param_dtype=torch.bfloat16, **kw)
        result[f"decode_kernel_launches_{label}"] = expect_decode_launches(
            before, 32, f"the graph loop ({label})")
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
    before = launch_counts()
    dev, dev_lp = run(generate_on_device, eos_id=eos)
    # every step runs on the device, eos or not
    expect_decode_launches(before, 32, "the sampled graph loop")
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


#: the serving burst (phase 6, and the pod of phase 9): 8 requests of 8
#: prompts of 64 tokens, 64 new, a drain after 4, 3 workers
BURST_NEW_TOKENS = 64
BURST = {"n_requests": 8, "drain_after": 4, "workers": 3, "batch": 8,
         "prompt_len": 64, "seed": SEED + 3}
#: the bench's decode cell: batch 8, prompt 64, 960 new, context 1024
BENCH_NEW_TOKENS = 960


def bench_prompt():
    """The bench decode cell's prompt, (8, 64), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    return torch.randint(0, CONFIG_277M.vocab, (8, 64), generator=gen,
                         device="cuda")


def burst_line(summary, card, **extra):
    """The serving line of a burst's summary; raises unless the drain
    dropped nothing and parked at least one request."""
    if summary["dropped"] != 0 or summary["parked"] < 1:
        raise RuntimeError(f"drain contract broken: {summary}")
    served = len(summary["served_request_ids"])
    lat = summary["request_seconds"]
    return {"requests": BURST["n_requests"], "batch": BURST["batch"],
            "prompt": BURST["prompt_len"], "new_tokens": BURST_NEW_TOKENS,
            "drain_after": BURST["drain_after"], "workers": BURST["workers"],
            "completed": summary["completed"], "served": served,
            "parked": summary["parked"], "dropped": summary["dropped"],
            "decode_tok_per_s": served * BURST["batch"] * BURST_NEW_TOKENS
            / summary["burst_seconds"],
            "latency_p50_s": statistics.median(lat),
            "latency_max_s": max(lat), **extra, "card": card}


def phase_serving(params, qparams, card):
    """The serving burst, then the bench decode cell; returns the graph
    loop's bench tokens by dtype, on the host."""
    server = DecodeServer(CONFIG_277M, params,
                          ServingEndpoint("llama-277m-smoke"),
                          max_new_tokens=BURST_NEW_TOKENS)
    summary = run_demo(server, **BURST)
    emit({"phase": "serving", **burst_line(summary, card)})

    # the bench's decode cell: batch 8, prompt 64, 960 new, context 1024
    prompt = bench_prompt()
    cells, graph_tokens, sampled = {}, {}, {}
    for label, p, kw in (("bf16", params, {}),
                         ("int8_weights_int8_kv", qparams,
                          {"quantize_kv": True})):
        cell = {}
        # the graph-replayed device loop, then the host loop as the eager
        # yardstick, each warmed by a short call
        for loop, fn in (("graph", generate_on_device), ("host", generate)):
            fn(p, prompt, CONFIG_277M, 8, param_dtype=torch.bfloat16, **kw)
            before = launch_counts()
            start = time.perf_counter()
            out = fn(p, prompt, CONFIG_277M, BENCH_NEW_TOKENS,
                     param_dtype=torch.bfloat16, **kw).cpu()
            seconds = time.perf_counter() - start
            check_bench_tokens(out, f"{label}, {loop}")
            cell[loop] = {"seconds": seconds,
                          "tok_per_s": 8 * BENCH_NEW_TOKENS / seconds,
                          "decode_kernel_launches": expect_decode_launches(
                              before, BENCH_NEW_TOKENS,
                              f"bench-shape decode ({label}, {loop})")}
            if loop == "graph":
                run = dict(generate_on_device.last_call)
                expect_graph(run, BENCH_NEW_TOKENS,
                             f"bench-shape decode ({label})")
                cell[loop]["device_loop"] = run
                tokens = graph_tokens[label] = out
            elif not torch.equal(out, tokens):
                raise RuntimeError(f"bench-shape decode: host and graph "
                                   f"loops differ ({label})")
            cell[loop]["profile_64_steps"] = profile_decode(fn, p, prompt,
                                                            kw)
        cell["graph_over_host"] = (cell["graph"]["tok_per_s"]
                                   / cell["host"]["tok_per_s"])
        cells[label] = cell
        sampled[label] = {
            name: sampled_bench_cell(f"{label}, {name}", p, prompt, kw,
                                     sampling)
            for name, sampling in SAMPLED_CELLS.items()}
    emit({"phase": "decode_bench_shape", "batch": 8, "prompt": 64,
          "new_tokens": BENCH_NEW_TOKENS, "cells": cells,
          "sampled": {"settings": SAMPLED_CELLS, "cells": sampled},
          "card": card})
    return graph_tokens


def sampled_bench_cell(label, params, prompt, kw, sampling):
    """The bench decode cell sampled under ``sampling`` (SAMPLED_CELLS:
    the decode contract's settings, or the served temperature alone):
    the graph-replayed device loop, then the host loop, from equally
    seeded generators, tokens (and logprobs, where asked for) bit for
    bit, each timed and profiled over 64 tokens (the device events a
    token, the pick's rand among them)."""
    want_logprobs = sampling["return_logprobs"]

    def run(fn, new_tokens):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
        out = fn(params, prompt, CONFIG_277M, new_tokens,
                 param_dtype=torch.bfloat16, generator=gen, **sampling,
                 **kw)
        return out if want_logprobs else (out, None)

    cell = {}
    for loop, fn in (("graph", generate_on_device), ("host", generate)):
        run(fn, 8)
        before = launch_counts()
        start = time.perf_counter()
        out, lps = run(fn, BENCH_NEW_TOKENS)
        out = out.cpu()
        lps = lps.cpu() if want_logprobs else None
        seconds = time.perf_counter() - start
        check_bench_tokens(out, f"sampled {label}, {loop}")
        cell[loop] = {"seconds": seconds,
                      "tok_per_s": 8 * BENCH_NEW_TOKENS / seconds,
                      "decode_kernel_launches": expect_decode_launches(
                          before, BENCH_NEW_TOKENS,
                          f"sampled bench-shape decode ({label}, {loop})")}
        if loop == "graph":
            run_info = dict(generate_on_device.last_call)
            expect_graph(run_info, BENCH_NEW_TOKENS,
                         f"sampled bench-shape decode ({label})")
            cell[loop]["device_loop"] = run_info
            tokens, logprobs = out, lps
        elif not (torch.equal(out, tokens)
                  and (not want_logprobs or torch.equal(lps, logprobs))):
            raise RuntimeError(f"sampled bench-shape decode: host and graph "
                               f"loops differ ({label})")
        if want_logprobs and not bool(torch.isfinite(lps).all()):
            raise RuntimeError(f"sampled bench-shape decode ({label}, "
                               f"{loop}): logprobs not finite")
        profile = profile_device(lambda: run(fn, 64)[0].cpu())
        if profile is not None:
            profile["device_events_per_token"] = \
                profile["device_events"] / 64
        cell[loop]["profile_64_steps"] = profile
    cell["graph_over_host"] = (cell["graph"]["tok_per_s"]
                               / cell["host"]["tok_per_s"])
    cell["host_equals_graph"] = True
    return cell


def check_bench_tokens(out, what):
    if tuple(out.shape) != (8, 64 + BENCH_NEW_TOKENS) or not bool(
            ((out >= 0) & (out < CONFIG_277M.vocab)).all()):
        raise RuntimeError(f"bench-shape decode malformed ({what})")


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
                     "device_ms": device_us(e) / 1e3} for e in rows],
            # kernels, copies and sets the device ran, and the copies'
            # share (clones, casts and memcpys: "copy" in the name)
            "device_events": sum(e.count for e in events),
            "copies": {
                "calls": sum(e.count for e in events
                             if "copy" in e.key.lower()),
                "device_ms": sum(device_us(e) for e in events
                                 if "copy" in e.key.lower()) / 1e3},
            # the port's decode kernels' instances, in or out of the top
            # rows, matched by whole kernel name
            **{name: [{"name": e.key[:100], "calls": e.count,
                       "device_ms": device_us(e) / 1e3}
                      for e in events if port_kernel(e.key) == name]
               for name in PORT_KERNELS}}



def profile_decode(fn, params, prompt, kw):
    """profile_device over a 64-token decode by ``fn`` (the device loop
    or the host loop), with the device events a token."""
    profile = profile_device(lambda: fn(
        params, prompt, CONFIG_277M, 64, param_dtype=torch.bfloat16,
        **kw).cpu())
    if profile is not None:
        profile["device_events_per_token"] = profile["device_events"] / 64
    return profile


#: every kernel's wrapper, by the name its launch counter reports under
KERNELS = WRAPPERS
#: the kernels the training path runs, and the ring's
FLASH_KERNELS = ["flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"]
RING_KERNELS = FLASH_KERNELS + ["attention_fold"]


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "launches_by_design"):
            wrapper.launches_by_design.clear()


def launch_counts() -> "dict[str, int]":
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


def design_launch_counts() -> "dict[str, dict[str, int]]":
    """The flash kernels' launches since the last reset by the design
    their instance ran (the wgmma one or the 3xTF32 one)."""
    return {name: dict(KERNELS[name].launches_by_design)
            for name in FLASH_KERNELS}


TRAIN_STEPS = 6
#: f32 gradients against the xla path: rtol = atol = 1e-4, as the f32
#: logits; remat against no remat in f32: tests/test_llama.py:148's
#: rtol 1e-5, atol 1e-6 (the same kernels recompute the same values)
REMAT_RTOL, REMAT_ATOL = 1e-5, 1e-6


def expect_launches(delta, fwd, bwd, what, fold=0, int8=0, decode=0,
                    blocks=None, train=None, picks=0):
    """``decode``: the launches of each decode kernel (decode_attention
    and rope_kv_append run once a layer a forward_with_cache call; the
    rotation-free kv_append never); ``blocks``: the norm's and the gate's
    (:func:`block_launches`; none by default); ``train``: RoPE's and
    AdamW's (:func:`train_launches`; none by default); ``picks``: the
    token pick's (once a pick of a decode)."""
    want = {"flash_attention_fwd": fwd, "flash_attention_bwd_dkv": bwd,
            "flash_attention_bwd_dq": bwd, "attention_fold": fold,
            "int8_matmul": int8, "decode_attention": decode,
            "rope_kv_append": decode, "kv_append": 0, "token_pick": picks,
            **(blocks or block_launches(0)),
            **(train or train_launches(0))}
    if delta != want:
        raise RuntimeError(f"{what} launched {delta}, expected {want}")


#: the norm's and the gate's kernels, forward and backward
BLOCK_KERNELS = ["rms_norm", "rms_norm_bwd", "swiglu", "swiglu_bwd"]


def block_launches(forwards, backwards=0, remat=False) -> dict:
    """The norm's and the gate's launches for ``forwards`` forwards of
    llama-277M (batch forward or cached step: 2L + 1 norms, L gates each)
    and ``backwards`` backwards (as many of each backward kernel); with
    ``remat`` each backward recomputes the layers' forwards (the final
    norm stays outside them)."""
    n = CONFIG_277M.n_layers
    again = backwards if remat else 0
    return {"rms_norm": forwards * (2 * n + 1) + again * 2 * n,
            "rms_norm_bwd": backwards * (2 * n + 1),
            "swiglu": (forwards + again) * n, "swiglu_bwd": backwards * n}


#: the batch forward's RoPE and the loss (forward and backward each) and
#: the update
TRAIN_KERNELS = ["rope", "rope_bwd", "cross_entropy", "cross_entropy_bwd",
                 "adamw"]
#: the clipped update's global norm (phase 7's clipped trainer
#: configuration; no other path clips)
CLIP_KERNELS = ["global_norm"]


def train_launches(forwards, backwards=0, updates=0, remat=False,
                   clipped=False) -> dict:
    """RoPE's launches for ``forwards`` batch forwards of llama-277M and
    ``backwards`` backwards (once a layer each; with ``remat`` each
    backward recomputes the layers' forwards), the loss's (one forward
    and one backward launch for each; remat does not recompute it), and
    AdamW's for ``updates`` updates (its 39 leaves take one launch), each
    behind one launch of the global norm when ``clipped``."""
    n = CONFIG_277M.n_layers
    again = backwards if remat else 0
    return {"rope": (forwards + again) * n, "rope_bwd": backwards * n,
            "cross_entropy": forwards, "cross_entropy_bwd": backwards,
            "adamw": updates, "global_norm": updates if clipped else 0}


#: the decode path's kernels that run once a layer a forward_with_cache
DECODE_KERNELS = ["decode_attention", "rope_kv_append"]


def expect_decode_launches(before, forwards, what, picks=None) -> int:
    """Each decode kernel launched once a layer for each of ``forwards``
    forward_with_cache calls since the counts ``before`` (a replayed
    graph's launches counted), the norm 2L + 1 times and the gate L times
    a call, the token pick ``picks`` times (by default once a call: a
    decode picks after its prefill and after every step), their backward
    kernels, the rotation-free kv_append, the batch forward's RoPE and
    AdamW never; returns the decode kernels' count."""
    after = launch_counts()
    want = forwards * CONFIG_277M.n_layers
    expected = {**dict.fromkeys(DECODE_KERNELS, want), "kv_append": 0,
                "token_pick": forwards if picks is None else picks,
                **block_launches(forwards), **train_launches(0)}
    got = {name: after[name] - before[name] for name in expected}
    if got != expected:
        raise RuntimeError(f"{what} launched {got}, expected {expected} "
                           f"({forwards} forwards of "
                           f"{CONFIG_277M.n_layers} layers)")
    return want


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


def time_update(optimizer, state, tokens, config) -> dict:
    """The train step's AdamW update alone (``AdamW.update``: its 0-d
    operations and the kernel's one launch) on one step's gradients, and
    its plain version on the same leaves, CUDA events; the update's
    launches checked, then every count set back (a measurement is not the
    path)."""
    saved = save_launches()
    _, grads = value_and_grad(next_token_loss, state["params"], tokens,
                              config)
    before = launch_counts()["adamw"]
    update_ms = cuda_ms(lambda: optimizer.update(grads, state["opt"],
                                                 state["params"]), 10)
    launches = launch_counts()["adamw"] - before
    if launches != 12:  # 10 timed calls and 2 of warm-up
        raise RuntimeError(f"AdamW.update launched {launches} kernels over "
                           "12 calls, expected 12")
    restore_launches(saved)
    opt = state["opt"]
    plain_ms = cuda_ms(lambda: adamw_mod.adamw_update_reference(
        tree_leaves(grads), {"count": opt["count"],
                             "mu": tree_leaves(opt["mu"]),
                             "nu": tree_leaves(opt["nu"])},
        tree_leaves(state["params"]),
        lr=optimizer.learning_rate(opt["count"]),
        weight_decay=optimizer.weight_decay), 5)
    del grads
    torch.cuda.empty_cache()
    return {"update_ms": update_ms, "update_plain_ms": plain_ms,
            "update_launches_a_call": 1}


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
                    n_layers, "one train step", blocks=block_launches(1, 1),
                    train=train_launches(1, 1, 1))
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
                    f"{TRAIN_STEPS} train steps",
                    blocks=block_launches(TRAIN_STEPS, TRAIN_STEPS),
                    train=train_launches(TRAIN_STEPS, TRAIN_STEPS,
                                         TRAIN_STEPS))
    losses = [float(x) for x in losses]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train losses not finite and falling: {losses}")
    if int(state["step"]) != TRAIN_STEPS:
        raise RuntimeError(f"state step {int(state['step'])}")
    profile = profile_device(lambda: step(state, batches[0])[1].item(),
                             top=10)
    update = time_update(optimizer, state, batches[0], config)
    loss_device = loss_device_time(batches[0], profile)

    # the step's gradients: flash against xla and against remat, bf16 at
    # the train shape, f32 at batch 2
    result = {"phase": "train", "batch": TRAIN_BATCH,
              "seq": config.seq_len, "steps": TRAIN_STEPS, "losses": losses,
              "first_step_ms": first_ms, "step_ms": step_ms,
              "steps_behind_one_sync": TRAIN_STEPS - 1,
              "tokens_per_s": TRAIN_BATCH * config.seq_len / step_ms * 1e3,
              "max_memory_allocated_bytes": peak_bytes, **update,
              "profile_1_step": profile, "loss_device": loss_device,
              "card": card}
    tokens = batches[0]
    for label, p, toks in (("bf16", params, tokens),
                           ("f32", cast_params(params, torch.float32),
                            tokens[:2])):
        flash_loss, flash_g, flash_n = grads_with_launches(p, toks, config)
        expect_launches(flash_n, n_layers, n_layers, f"{label} flash grads",
                        blocks=block_launches(1, 1),
                        train=train_launches(1, 1))
        xla_loss, xla_g, xla_n = grads_with_launches(p, toks, CONFIG_277M)
        expect_launches(xla_n, 0, 0, f"{label} xla grads",
                        blocks=block_launches(1, 1),
                        train=train_launches(1, 1))
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
                        f"{label} remat grads",
                        blocks=block_launches(1, 1, remat=True),
                        train=train_launches(1, 1, remat=True))
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


def loss_device_time(tokens, step_profile) -> dict:
    """The loss's device time in the train step, forward and backward,
    from the profiler: by its kernels, and by the plain version with
    autograd (what the step ran before), on logits of the step's shape
    and dtype (random) and its batch's targets; each beside its share of
    the step's device time (the profiled step's, with the plain version's
    time in place of the kernels' for the plain share). The launch counts
    are set back after (a measurement is not the path)."""
    saved = save_launches()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    x = (3.0 * torch.randn((*tokens.shape, CONFIG_277M.vocab),
                           generator=gen, device="cuda")) \
        .to(torch.bfloat16).requires_grad_()
    targets = tokens[:, 1:].long().contiguous()

    def run(loss_fn):
        def call():
            torch.autograd.grad(loss_fn(x, targets), x)
            torch.cuda.synchronize()
        call()
        found = profile_device(call) or {}
        return {k: found.get(k) for k in ("device_busy_ms",
                                          "device_events")}

    out = {"kernels": run(loss_mod.cross_entropy),
           "plain": run(loss_mod.next_token_loss_reference)}
    restore_launches(saved)
    busy = (step_profile or {}).get("device_busy_ms")
    kernels, plain = (out[k]["device_busy_ms"] for k in ("kernels", "plain"))
    if busy and kernels is not None and plain is not None:
        out["kernels"]["share_of_step"] = kernels / busy
        out["plain"]["share_of_step"] = plain / (busy - kernels + plain)
    del x
    torch.cuda.empty_cache()
    return out


#: phase 7's clipped trainer configuration: the training job's
#: --grad-clip-norm (tpu_operator_libs/examples/jax_training_job.py:
#: 284-293) at 1.0, with the warmup-cosine schedule
CLIPPED = {"grad_clip_norm": 1.0, "warmup_steps": 2, "total_steps": 1000}
CLIPPED_STEPS = 4


def phase_train_clipped(params, card, first_loss):
    """make_train_step in the clipped trainer configuration (CLIPPED) at
    phase 7's shape (llama-277M, flash, batch 16, seq 1024, bf16):
    CLIPPED_STEPS steps on phase 7's batches, each with one launch of the
    global norm before the update; the first loss bit-equal to the
    unclipped run's ``first_loss`` (the same parameters and batch: the
    loss comes before the update); the step's time (the steps after the
    first, behind one sync) and peak memory; the first step's global
    norm and whether the clip bound; the clipped update's time."""
    config = dataclasses.replace(CONFIG_277M, attention_impl="flash",
                                 **CLIPPED)
    n_layers = config.n_layers
    optimizer, step = make_train_step(config)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    batches = [make_token_batch(i, config, TRAIN_BATCH)
               for i in range(CLIPPED_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    start = time.perf_counter()
    state, first = step(state, batches[0])
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - start) * 1e3
    losses = [first]
    start = time.perf_counter()
    for tokens in batches[1:]:
        state, loss = step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3 / (CLIPPED_STEPS - 1)
    peak_bytes = torch.cuda.max_memory_allocated()
    after = launch_counts()
    expect_launches({k: after[k] - before[k] for k in after},
                    n_layers * CLIPPED_STEPS, n_layers * CLIPPED_STEPS,
                    f"{CLIPPED_STEPS} clipped train steps",
                    blocks=block_launches(CLIPPED_STEPS, CLIPPED_STEPS),
                    train=train_launches(CLIPPED_STEPS, CLIPPED_STEPS,
                                         CLIPPED_STEPS, clipped=True))
    losses = [float(x) for x in losses]
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"clipped train losses not finite: {losses}")
    if losses[0] != first_loss:
        raise RuntimeError(f"the clipped run's first loss {losses[0]!r} is "
                           f"not the unclipped run's {first_loss!r}")
    # the first step's norm and the clipped update's time: measurements,
    # so the counts are set back after
    saved = save_launches()
    _, grads = value_and_grad(next_token_loss, params, batches[0], config)
    norm = float(global_norm(grads))
    update_ms = cuda_ms(lambda: optimizer.update(grads, state["opt"],
                                                 state["params"]), 10)
    norm_ms = cuda_ms(lambda: global_norm(grads), 10)
    restore_launches(saved)
    del grads
    profile = profile_device(lambda: step(state, batches[0])[1].item(),
                             top=10)
    emit({"phase": "train_clipped", **CLIPPED, "batch": TRAIN_BATCH,
          "seq": config.seq_len, "steps": CLIPPED_STEPS, "losses": losses,
          "first_loss_bit_equal_to_unclipped": True,
          "first_step_global_norm": norm,
          "clip_bound_first_step": norm >= CLIPPED["grad_clip_norm"],
          "first_step_ms": first_ms, "step_ms": step_ms,
          "steps_behind_one_sync": CLIPPED_STEPS - 1,
          "tokens_per_s": TRAIN_BATCH * config.seq_len / step_ms * 1e3,
          "max_memory_allocated_bytes": peak_bytes,
          "update_ms": update_ms, "global_norm_ms": norm_ms,
          "launches": {k: after[k] - before[k] for k in
                       TRAIN_KERNELS + CLIP_KERNELS},
          "profile_1_step": profile, "card": card})
    del state
    torch.cuda.empty_cache()
    return step_ms


#: one turn of --train-turns, run in a checkout's root: its own phase 7
#: and, where the checkout has it, its clipped trainer configuration
TURN_CODE = (
    "import os, sys; sys.path.insert(0, os.getcwd()); import torch; "
    "import chip_smoke as cs; card = cs.phase_device(); "
    "params = cs.init_llama_params(cs.CONFIG_277M, "
    "param_dtype=torch.bfloat16, seed=cs.SEED, device='cuda'); "
    "cs.reset_launch_counts(); losses = cs.phase_train(params, card)[3]; "
    "clipped = getattr(cs, 'phase_train_clipped', None); "
    "clipped and clipped(params, card, losses[0])")


def train_turns(other, card) -> None:
    """Phase 7 of the checkout at ``other`` and of this one in turns
    (other, this, this, other), a process a turn, each tree running its
    own ``phase_train`` (and ``phase_train_clipped`` where it has one) and
    building its own kernels; one line a turn with the step's time,
    losses, peak memory, the profiled step's device events, copies, norm
    and loss kernels, the update's time and the loss's device time where
    the tree reports them, and the clipped step's."""
    for tree in (other, ROOT, ROOT, other):
        run = subprocess.run([sys.executable, "-c", TURN_CODE],
                             cwd=tree, capture_output=True, text=True,
                             timeout=900)
        lines = [line for line in run.stdout.splitlines()
                 if line.startswith('{"phase": "train"')]
        if run.returncode or not lines:
            raise RuntimeError(f"phase 7 of {tree} failed (exit "
                               f"{run.returncode}):\n{run.stderr[-3000:]}")
        train = json.loads(lines[0])
        profile = train["profile_1_step"] or {}
        clipped = [json.loads(line) for line in run.stdout.splitlines()
                   if line.startswith('{"phase": "train_clipped"')]
        emit({"phase": "train_turns", "tree": os.path.relpath(tree, ROOT),
              **{k: train.get(k) for k in (
                  "step_ms", "first_step_ms", "losses",
                  "max_memory_allocated_bytes", "update_ms",
                  "update_plain_ms", "loss_device")},
              **{k: profile.get(k) for k in (
                  "device_events", "device_busy_ms", "wall_ms", "copies",
                  "top", "rms_norm", "cross_entropy")},
              "clipped": {k: clipped[0].get(k) for k in (
                  "step_ms", "losses", "max_memory_allocated_bytes",
                  "update_ms", "global_norm_ms",
                  "first_step_global_norm")} if clipped else None,
              "card": card})


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


def phase_multichip(card, train_losses=None, bench_tokens=None):
    """The multi-device slice on every visible card, one NCCL rank each
    (``multichip.run_stages`` at llama-277M width): one line per stage,
    then the serving pod over the same cards. ``train_losses``: phase
    7's, which a one-card run's losses (of the dp x tp and of the ring
    Llama) must match within MULTI_LOSS_TOL; ``bench_tokens``: phase 6's
    bench decode tokens by dtype, which a one-card run's graph tokens
    must equal. Returns rank 0's kernel launches of stages 1-4 and of the
    ring stage."""
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
        payload_mib=16, rounds=8, shapes=multichip_shapes(n),
        decode_bench=(bench_prompt().cpu().numpy(), BENCH_NEW_TOKENS))
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
    # decodes' two loops, at the contract's and the bench's lengths: a
    # forward for each new token (prefill and the steps, replayed ones
    # counted from the graph), seven int8 products a layer and the
    # lm_head's each
    per_kernel = (config.n_layers * (MULTI_STEPS + 2)
                  if config.attention_impl == "flash" else 0)
    int8 = (2 * (MULTI_NEW_TOKENS + BENCH_NEW_TOKENS)
            * (7 * config.n_layers + 1))
    # both dtypes' loops: the decode kernels once a layer a forward, the
    # token pick once a forward
    forwards = 2 * 2 * (MULTI_NEW_TOKENS + BENCH_NEW_TOKENS)
    decode = forwards * config.n_layers
    # the norm and the gate in every train step (the train stage's and
    # the checkpoint stage's two) and every decode forward; RoPE and AdamW
    # in every train step, flash or xla
    steps = MULTI_STEPS + 2
    for rank in ranks:
        expect_launches(rank["launches"], per_kernel, per_kernel,
                        f"multichip rank path at tp={tp}", int8=int8,
                        decode=decode, picks=forwards,
                        blocks=block_launches(steps + forwards, steps),
                        train=train_launches(steps, steps, steps))
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
    emit(multichip_decode_line(ranks, common, launches))
    emit(multichip_bench_line(ranks, common, bench_tokens))
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
        idle = [k for k in RING_KERNELS + BLOCK_KERNELS + TRAIN_KERNELS
                if rank["launches_ring"][k] < 1]
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
    emit({"phase": "multichip_serving", **common,
          **multichip_serving(n, card)})
    check_rank_designs(ranks)
    by_design = {"multichip": first["launches_by_design"],
                 "ring": first["launches_by_design_ring"]}
    return launches, first["launches_ring"], by_design


def check_rank_designs(ranks) -> None:
    """The flash kernels' launches by design of the multi-rank phase: on
    every rank each launch has one. The counts may differ between ranks:
    a causal ring's rank r runs the r + 1 blocks at or before its own
    and skips the rest."""
    for r, rank in enumerate(ranks):
        for designs, counts in (
                (rank["launches_by_design"], rank["launches"]),
                (rank["launches_by_design_ring"], rank["launches_ring"])):
            for name, by in designs.items():
                if sum(by.values()) != counts[name]:
                    raise RuntimeError(
                        f"rank {r}'s {name} launches by design {by} do not "
                        f"add up to its {counts[name]}")


#: the decode stage's dtypes: the label the ranks return, the line's name
DECODE_LABELS = (("plain", "bf16"),
                 ("int8_weights_int8_kv", "int8_weights_int8_kv"))


def expect_graph_on_every_rank(runs, new_tokens, what) -> dict:
    """expect_graph on each rank's device loop; their graph launches and
    capture ms, in rank order."""
    for rank, run in enumerate(runs):
        expect_graph(run, new_tokens, f"{what} on rank {rank}")
    return {"graph_launches_by_rank": [r["graph_launches"] for r in runs],
            "capture_ms_by_rank": [r["capture_ms"] for r in runs]}


def multichip_decode_line(ranks, common, launches):
    """The decode stage's line from what every rank returned: each loop's
    tokens against the other's and against rank 0's, and each rank's
    device loop, which must be 1 eager step and the rest graph replays."""
    line = {"phase": "multichip_decode", **common, "batch": 8,
            "prompt": 64, "new_tokens": MULTI_NEW_TOKENS,
            "int8_matmul_launches": launches["int8_matmul"],
            **{f"{name}_launches": launches[name]
               for name in DECODE_KERNELS + BLOCK_KERNELS + TRAIN_KERNELS
               + ["token_pick"]}}
    equal_ranks = True
    for label, name in DECODE_LABELS:
        key = f"decode_{label}"
        line[f"{name}_host_equals_device"] = all(
            np.array_equal(r[key], r[f"{key}_host"]) for r in ranks)
        equal_ranks &= all(np.array_equal(r[key], ranks[0][key])
                           for r in ranks)
        runs = expect_graph_on_every_rank(
            [r[f"{key}_loop"] for r in ranks], MULTI_NEW_TOKENS,
            f"multichip decode ({name})")
        line.update({f"{name}_{k}": v for k, v in runs.items()})
    line["tokens_equal_on_every_rank"] = equal_ranks
    if not (equal_ranks and all(line[f"{name}_host_equals_device"]
                                for _, name in DECODE_LABELS)):
        raise RuntimeError(f"multichip decode: loops or ranks differ: "
                           f"{line}")
    return line


def multichip_bench_line(ranks, common, bench_tokens):
    """The bench-shape decode on every rank: rank 0's times of the graph
    and the host loop, every rank's graph launches, tokens equal on
    every rank and in both loops, and at one card equal to phase 6's
    graph tokens (``bench_tokens``; None when phase 6 did not run)."""
    line = {"phase": "multichip_decode_bench", **common, "batch": 8,
            "prompt": 64, "new_tokens": BENCH_NEW_TOKENS, "cells": {}}
    for label, name in DECODE_LABELS:
        cells = [r["decode_bench"][label] for r in ranks]
        tokens = cells[0]["graph"]["tokens"]
        check_bench_tokens(tokens, f"multichip, {name}")
        cell = {loop: {k: cells[0][loop][k] for k in ("seconds", "tok_per_s")}
                for loop in ("graph", "host")}
        cell["graph_over_host"] = (cell["graph"]["tok_per_s"]
                                   / cell["host"]["tok_per_s"])
        cell["graph"].update(expect_graph_on_every_rank(
            [c["graph"]["device_loop"] for c in cells], BENCH_NEW_TOKENS,
            f"multichip bench decode ({name})"))
        cell["tokens_equal_on_every_rank"] = all(
            np.array_equal(c[loop]["tokens"], tokens)
            for c in cells for loop in ("graph", "host"))
        if not cell["tokens_equal_on_every_rank"]:
            raise RuntimeError(f"multichip bench decode ({name}): ranks or "
                               "loops differ")
        if bench_tokens is not None and common["n"] == 1:
            cell["graph_tokens_equal_phase6"] = bool(
                np.array_equal(tokens, bench_tokens[name].numpy()))
            if not cell["graph_tokens_equal_phase6"]:
                raise RuntimeError(f"multichip bench decode ({name}) at one "
                                   "card differs from phase 6's")
        else:
            cell["graph_tokens_equal_phase6"] = None
        line["cells"][name] = cell
    return line


def multichip_serving(n, card):
    """The serving pod (``serve_rank``) over NCCL on every visible card:
    phase 6's burst at llama-277M, bf16, greedy; every rank replays its
    decode from a graph that the first generation captures
    (max_new_tokens - 2 launches) and every later one, of the same shape,
    replays for each step (max_new_tokens - 1)."""
    start = time.perf_counter()
    pod = run_ranks(serve_rank, n,
                    {"config": CONFIG_277M,
                     "max_new_tokens": BURST_NEW_TOKENS},
                    BURST, device="cuda", timeout=300.0)
    wall_s = time.perf_counter() - start
    summary = pod[0]
    generations = summary["completed"]
    want = (BURST_NEW_TOKENS - 2) + (BURST_NEW_TOKENS - 1) * (generations - 1)
    launches = [summary["graph_launches"]] + [
        r["graph_launches"] for r in pod[1:]]
    followers = [r["follower_generations"] for r in pod[1:]]
    if launches != [want] * n or followers != [generations] * (n - 1):
        raise RuntimeError(
            f"the pod's ranks replayed {launches} graph launches over "
            f"{generations} generations (followers took {followers}), "
            f"expected {want} on every rank")
    return burst_line(summary, card, graph_launches_by_rank=launches,
                      follower_generations=followers,
                      wall_s_with_start_up=wall_s)


def kernel_entry(name, source, replaces, launches, rows, shape, card,
                 **extra):
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
                                      "S", "D", "dtype", "design", "blocks",
                                      "blocks_from", "max_abs_err",
                                      "limit_use", "limit_use_max_over_seeds",
                                      "kernel_ms", "plain_ms",
                                      "library", "library_ms", "bound_ms",
                                      "bound_by", "bound_3xtf32_ms",
                                      "bound_share", "bound_share_uses")
                    if k in r} for r in rows],
        **extra, "card": card}


def int8_entry(rows, serving, multi, card):
    """The kernels line's int8_matmul entry; its times and bound are the
    bench shape's decode of wq/wk/wv/wo and the lm_head, (8, 2048, 2048),
    the product most launched on the serving path."""
    main_row = rows[0]
    ms = {r["shape"]: r["kernel_ms"] for r in rows}
    return {
        "name": "int8_matmul", "route": "cuda",
        "source": "tpu_operator_libs_torch/csrc/int8_matmul.cu",
        "replaces": "tpu_operator_libs/examples/llama_decode.py:135-143 "
                    "(_mm, fused by XLA; no pallas_call)",
        "launches": serving + multi,
        "launches_by_path": {"serving": serving, "multichip": multi},
        "launches_counted": "eager calls plus, for a replayed graph (on "
                            "one card and on every rank of a mesh), the "
                            "launches recorded at capture times the "
                            "replays; multichip: rank 0's",
        "ok": True, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "library": main_row["library"],
        "design": "a persistent warp-specialised wgmma GEMM, the codes "
                  "converted in registers (bf16 prefill); a "
                  "persistent stream-K grid fed by TMA, mma.sync with the "
                  "weight as A (the rest of bf16 with TMA's alignment); "
                  "mma.sync over a cp.async ring (unaligned bf16); f32 "
                  "FMAs on the CUDA cores (f32); cut tiles added in a "
                  "fixed order inside the launch",
        "shape": "M=8 K=2048 N=2048 bf16 x int8 (decode at the bench "
                 "shape: wq, wk, wv, wo, lm_head)",
        # one bench-shape decode step's 29 products (wq, wk, wv, wo of 4
        # layers and the lm_head, w_gate and w_up of 4, w_down of 4), each
        # weight read from device memory (phase 3d's kernel_ms)
        "decode_step_29_launches_ms": 17 * ms["decode_qkvo_lm_head"]
        + 8 * ms["decode_gate_up"] + 4 * ms["decode_down"],
        "shapes": [{k: r[k] for k in (
            "shape", "M", "K", "N", "dtype", "design", "plan",
            "cuda_launches_per_call", "max_abs_err", "limit_use",
            "bit_equal_launches", "graph_replay_bit_equal", "kernel_ms",
            "kernel_l2_ms", "plain_ms",
            "library", "library_ms", "cublas_on_converted_copy_ms",
            "bound_ms", "bound_by")} for r in rows],
        "card": card}


def decode_entry(name, source, rows, serving, multi, replaces, card,
                 **extra):
    """The kernels line's entry of a decode kernel; its times and bound
    are phase 3e's first row, the bench decode over a bf16 cache, the call
    most launched on the serving path."""
    main_row = rows[0]
    keys = ("shape", "B", "T", "H", "H_kv", "S", "D", "start_pos", "dtype",
            "cache", "design", "cuda_launches_per_call", "max_abs_err",
            "limit_use", "bit_equal_to_plain", "bit_equal_launches",
            "graph_replay_bit_equal", "kernel_ms", "plain_ms",
            "rope_then_kv_append_kernel_ms", "library", "library_ms",
            "bound_ms", "bound_by", "bound_ms_whole_cache", "plan")
    return {
        "name": name, "route": "cuda",
        "source": f"tpu_operator_libs_torch/csrc/{source}",
        "replaces": replaces, "launches": serving[name] + multi[name],
        "launches_by_path": {"serving": serving[name],
                             "multichip": multi[name]},
        "launches_counted": "eager calls plus, for a replayed graph, the "
                            "launches recorded at capture times the "
                            "replays; multichip: rank 0's",
        "ok": True, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": main_row["library"], "design": main_row["design"],
        "shape": "B=8 T=1 H=16 S=1024 D=128 bf16 q over a bf16 cache at "
                 "position 1023 (the bench decode's step)",
        "shapes": [{k: r[k] for k in keys if k in r} for r in rows],
        **extra, "card": card}


def block_entry(name, source, replaces, rows, launches, shape, card):
    """The kernels line's entry of a norm, gate, RoPE, AdamW, loss,
    global-norm or token-pick kernel; its times and bound are its first
    phase 3f, 3g or 3h row's (``phase_norm_gate_kernels``,
    ``phase_train_kernels``, ``phase_token_pick``)."""
    main_row = rows[0]
    keys = ("shape", "rows", "dim", "B", "S", "V", "S_used", "H", "H_kv",
            "D", "head_major", "leaves", "elements", "count", "schedule",
            "clip_norm", "clipped", "weight_decay", "dtype", "add",
            "strided", "temperature", "top_k", "top_p", "want_logprob",
            "design", "cuda_launches_per_call", "plain_cuda_launches",
            "rows_checked", "exempt_rows", "logprob_limit_use",
            "max_abs_err", "limit_use",
            "max_ulp_vs_plain", "dg_max_ulp_vs_plain", "du_max_ulp_vs_plain",
            "bit_equal_to_plain", "bit_equal_launches",
            "graph_replay_bit_equal", "inputs_unchanged", "rel_err",
            "kernel_ms", "update_ms", "plain_ms", "plain_autograd_ms",
            "library", "library_ms", "kernel_fwd_bwd_ms", "plain_fwd_bwd_ms",
            "library_fwd_bwd_ms", "bound_ms", "bound_by")
    return {
        "name": name, "route": "cuda",
        "source": f"tpu_operator_libs_torch/csrc/{source}",
        "replaces": replaces, "launches": sum(launches.values()),
        "launches_by_path": launches,
        "launches_counted": "eager calls plus, for a replayed graph, the "
                            "launches recorded at capture times the "
                            "replays; multichip: rank 0's",
        "ok": True, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": main_row["library"], "design": main_row["design"],
        "shape": shape,
        "shapes": [{k: r[k] for k in keys if k in r} for r in rows],
        "card": card}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--backward-grids":
        print(json.dumps(backward_grids(json.loads(argv[1]))))
        return 0
    card = phase_device()
    phase_build()
    if len(argv) == 2 and argv[0] == "--train-turns":
        train_turns(os.path.abspath(argv[1]), card)
        emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                     "count": torch.cuda.device_count()}})
        return 0
    if argv == ["--multichip-only"]:
        phase_multichip(card)
        emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                     "count": torch.cuda.device_count()}})
        return 0
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}")
    fwd_rows = phase_kernel(card)
    grids = measure_backward_grids(
        [(*s[:7], True) for s in BWD_SHAPES] + [(*RING_BWD_SHAPE[:7], False)])
    bwd_rows = phase_kernel_bwd(card, grids)
    # the ring's chain: counts at 0 just before it, read just after
    ring_fwd, ring_bwd, fold_row, chain = phase_ring_kernels(card, grids)
    fwd_rows += ring_fwd
    bwd_rows += ring_bwd
    int8_rows = phase_int8_matmul(card)
    attention_rows, append_rows, rope_rows = phase_decode_kernels(card)
    norm_rows, norm_bwd_rows, gate_rows, gate_bwd_rows = \
        phase_norm_gate_kernels(card)
    (rope_qk_rows, rope_bwd_rows, adamw_rows, loss_rows, loss_bwd_rows,
     global_norm_rows) = phase_train_kernels(card)
    pick_rows = phase_token_pick(card)

    params = init_llama_params(CONFIG_277M, param_dtype=torch.bfloat16,
                               seed=SEED, device="cuda")
    params32 = cast_params(params, torch.float32)
    # the serving path: counts at 0 just before it, read just after
    reset_launch_counts()
    phase_forward(params, params32, card)
    qparams = phase_decode(params, params32, card)
    bench_tokens = phase_serving(params, qparams, card)
    serving = launch_counts()
    by_design = {"serving": design_launch_counts()}
    del params32, qparams
    torch.cuda.empty_cache()
    # the training path, likewise
    reset_launch_counts()
    state, optimizer, step, train_losses = phase_train(params, card)
    phase_train_clipped(params, card, train_losses[0])
    phase_checkpoint(state, optimizer, step, card)
    training = launch_counts()
    by_design["training"] = design_launch_counts()
    del state, params
    torch.cuda.empty_cache()
    # the multi-device path: its ranks set their counts to 0 before it
    multi, ring, ranks_by_design = phase_multichip(card, train_losses,
                                                   bench_tokens)
    by_design.update(ranks_by_design)
    for path, counts, names in (
            ("serving", serving,
             ["flash_attention_fwd", "int8_matmul", "rms_norm", "swiglu",
              "token_pick"] + DECODE_KERNELS),
            ("training", training,
             FLASH_KERNELS + BLOCK_KERNELS + TRAIN_KERNELS + CLIP_KERNELS),
            ("ring chain", chain, ["flash_attention_fwd", "attention_fold"]),
            ("multichip", multi,
             ["int8_matmul", "token_pick"] + DECODE_KERNELS + BLOCK_KERNELS
             + TRAIN_KERNELS),
            ("multichip ring", ring,
             RING_KERNELS + BLOCK_KERNELS + TRAIN_KERNELS)):
        missing = [name for name in names if counts[name] < 1]
        if missing:
            raise RuntimeError(f"the {path} path never launched {missing}")
    for path, designs in by_design.items():
        counts = {"serving": serving, "training": training,
                  "multichip": multi, "ring": ring}[path]
        for name, by in designs.items():
            if sum(by.values()) != counts[name]:
                raise RuntimeError(f"the {path} path's {name} launches by "
                                   f"design {by} do not add up to "
                                   f"{counts[name]}")

    # the paths that run the norm and the gate
    paths = {"serving": serving, "training": training, "multichip": multi,
             "ring": ring}
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
            "llama-277M; B=2 serves)", card,
            launches_by_design={
                path: counts["flash_attention_fwd"]
                for path, counts in by_design.items()},
            launches_by_design_counted="the serving and training paths "
            "of this process and the multichip and ring paths of rank 0 "
            "(every rank's alike)"),
        kernel_entry(
            "flash_attention_bwd_dkv", "flash_attention_bwd.cu",
            f"{pallas}:1121 (_flash_attention_bwd_dkv, kernel :796; "
            "reached from jax.grad through "
            "tpu_operator_libs/examples/llama.py:293)",
            {"training": training["flash_attention_bwd_dkv"],
             "multichip": multi["flash_attention_bwd_dkv"],
             "ring": ring["flash_attention_bwd_dkv"]},
            bwd_rows[0::2],
            "B=16 H=16 S=1024 D=128 bf16 (train step of llama-277M)", card,
            launches_by_design={
                path: counts["flash_attention_bwd_dkv"]
                for path, counts in by_design.items()},
            launches_by_design_counted="the serving and training paths "
            "of this process and the multichip and ring paths of rank 0 "
            "(every rank's alike)"),
        kernel_entry(
            "flash_attention_bwd_dq", "flash_attention_bwd.cu",
            f"{pallas}:1456 (_flash_attention_bwd_dq, kernel :1146; "
            "reached from jax.grad through "
            "tpu_operator_libs/examples/llama.py:293)",
            {"training": training["flash_attention_bwd_dq"],
             "multichip": multi["flash_attention_bwd_dq"],
             "ring": ring["flash_attention_bwd_dq"]},
            bwd_rows[1::2],
            "B=16 H=16 S=1024 D=128 bf16 (train step of llama-277M)", card,
            launches_by_design={
                path: counts["flash_attention_bwd_dq"]
                for path, counts in by_design.items()},
            launches_by_design_counted="the serving and training paths "
            "of this process and the multichip and ring paths of rank 0 "
            "(every rank's alike)"),
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
        decode_entry(
            "decode_attention", "decode_attention.cu", attention_rows,
            serving, multi,
            "tpu_operator_libs/examples/llama_decode.py:216-246 "
            "(forward_with_cache's attention over the cache, mask :181-182; "
            "fused by XLA, no pallas_call)", card),
        decode_entry(
            "rope_kv_append", "kv_append.cu", rope_rows, serving, multi,
            "tpu_operator_libs/examples/llama_decode.py:174, 190-214 "
            "(forward_with_cache's positions, _rope of q and k "
            "(llama.py:117-136), quantize after RoPE and "
            "dynamic_update_slice; fused by XLA, no pallas_call)", card),
        decode_entry(
            "kv_append", "kv_append.cu", append_rows, serving, multi,
            "tpu_operator_libs/examples/llama_decode.py:192-214 "
            "(forward_with_cache's quantize after RoPE and "
            "dynamic_update_slice; fused by XLA, no pallas_call)", card,
            main_paths="none: rope_kv_append, the same kernel body with "
                       "the rotation, writes the cache on every path; this "
                       "rotation-free entry fills caches in the card tests "
                       "and is held to its plain version in phase 3e"),
        block_entry(
            "rms_norm", "rms_norm.cu",
            "tpu_operator_libs/examples/llama.py:108-114 (_rms_norm) with "
            "the residual adds llama.py:307, 312 and llama_decode.py:247, "
            "253 (fused by XLA; no pallas_call)", norm_rows,
            {path: counts["rms_norm"] for path, counts in paths.items()},
            "rows=8 dim=2048 bf16 with the residual add (the bench "
            "decode's step)", card),
        block_entry(
            "rms_norm_bwd", "rms_norm.cu",
            "the gradient of tpu_operator_libs/examples/llama.py:108-114 "
            "and of the residual adds (jax.grad through XLA; no "
            "pallas_call)", norm_bwd_rows,
            {path: counts["rms_norm_bwd"] for path, counts in paths.items()},
            "rows=16384 dim=2048 bf16 with ds (the train step's)", card),
        block_entry(
            "swiglu", "swiglu.cu",
            "tpu_operator_libs/examples/llama.py:311 and llama_decode.py:"
            "251-252 (silu(g) * u, fused by XLA; no pallas_call)", gate_rows,
            {path: counts["swiglu"] for path, counts in paths.items()},
            "rows=8 d_ff=8192 bf16 (the bench decode's step)", card),
        block_entry(
            "swiglu_bwd", "swiglu.cu",
            "the gradient of tpu_operator_libs/examples/llama.py:311 "
            "(jax.grad through XLA; no pallas_call)", gate_bwd_rows,
            {path: counts["swiglu_bwd"] for path, counts in paths.items()},
            "rows=16384 d_ff=8192 bf16 (the train step's)", card),
        block_entry(
            "rope", "rope.cu",
            "tpu_operator_libs/examples/llama.py:117-136 (_rope of q and "
            "k, called at :280, with the flash path's transposes :292-298; "
            "fused by XLA, no pallas_call)", rope_qk_rows,
            {path: counts["rope"] for path, counts in paths.items()},
            "B=16 S=1024 H=16/16 D=128 bf16, q, k and v written head-major "
            "(the flash train step's)", card),
        block_entry(
            "rope_bwd", "rope.cu",
            "the gradient of tpu_operator_libs/examples/llama.py:117-136 "
            "(jax.grad through XLA; no pallas_call)", rope_bwd_rows,
            {path: counts["rope_bwd"] for path, counts in paths.items()},
            "B=16 S=1024 H=16/16 D=128 bf16, from head-major (the flash "
            "train step's)", card),
        block_entry(
            "adamw", "adamw.cu",
            "optax.adamw behind clip_by_global_norm, "
            "tpu_operator_libs/examples/llama.py:400-413 (fused by XLA; no "
            "pallas_call)", adamw_rows,
            {path: counts["adamw"] for path, counts in paths.items()},
            "llama-277M's 39 leaves, 277M elements, bf16, a constant rate "
            "(the train step's)", card),
        block_entry(
            "cross_entropy", "cross_entropy.cu",
            "tpu_operator_libs/examples/llama.py:331-341 (next_token_loss: "
            "log_softmax of the f32 logits, take_along_axis, the mean; "
            "fused by XLA, no pallas_call)", loss_rows,
            {path: counts["cross_entropy"] for path, counts in paths.items()},
            "B=16 S=1024 V=2048 bf16, 1023 positions a row with a target "
            "(the train step's)", card),
        block_entry(
            "cross_entropy_bwd", "cross_entropy.cu",
            "the gradient of tpu_operator_libs/examples/llama.py:331-341 "
            "(jax.grad through XLA; no pallas_call)", loss_bwd_rows,
            {path: counts["cross_entropy_bwd"]
             for path, counts in paths.items()},
            "B=16 S=1024 V=2048 bf16, dlogits of the whole logits (the "
            "train step's)", card),
        block_entry(
            "global_norm", "adamw.cu",
            "optax.global_norm under clip_by_global_norm, "
            "tpu_operator_libs/examples/llama.py:400-404 (fused by XLA; no "
            "pallas_call)", global_norm_rows,
            {path: counts["global_norm"] for path, counts in paths.items()},
            "llama-277M's 39 gradient leaves, 277M elements, bf16 (the "
            "clipped train step's)", card),
        block_entry(
            "token_pick", "token_pick.cu",
            "tpu_operator_libs/examples/llama_decode.py:288-333 (_pick_next: "
            "argmax, or top-k, the top-p nucleus and "
            "jax.random.categorical, and the logprob; fused by XLA, no "
            "pallas_call)", pick_rows,
            {path: counts["token_pick"] for path, counts in paths.items()},
            "B=8 V=2048 bf16, greedy (the bench decode's and the serving "
            "burst's pick)", card),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
