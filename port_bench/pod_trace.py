"""What the tensor-parallel pod's readers share: the NCCL kernels and
the device operations that start inside the traced generations'
``decode.generate`` spans (the port's spans, ``program_spans``), and
the cuBLAS products of the stretch.

A device operation is NCCL's where its name holds ``nccl``. cuBLAS's
products are what is left of the stretch once NCCL's kernels, the
port's own kernels (the ``__global__`` functions of
``tpu_operator_libs_torch/csrc``, by :data:`PORT_KERNELS`), PyTorch's
``at::native`` copies and elementwise ops and the runtime's copies and
sets are taken out.
"""

from __future__ import annotations

import re

from port_bench import program_spans

NCCL = re.compile(r"nccl", re.IGNORECASE)
#: the port's hand-written kernels, by the names of their entry points
PORT_KERNELS = re.compile(
    r"flash_fwd|flash_bwd|attention_fold|int8_matmul|decode_attention"
    r"|kv_append|rms_norm|swiglu|rope_kernel|adamw_kernel"
    r"|global_norm_kernel|cross_entropy|token_pick")
#: PyTorch's own kernels and the runtime's copies and sets
NOT_PRODUCTS = re.compile(r"at::native|^Memcpy|^Memset|^memcpy|^memset")


def inside_generations(reading) -> "list | None":
    """The stretch's device operations that start inside a
    ``decode.generate`` span; None where the program recorded none."""
    spans = [(s.start, s.end) for s in program_spans.records(reading)
             if s.name == "decode.generate"]
    if not spans:
        return None
    return [op for op in reading.ops
            if any(start <= op[1] <= end for start, end in spans)]


def nccl(ops) -> list:
    return [op for op in ops if NCCL.search(op[0])]


def cublas(ops) -> list:
    return [op for op in ops
            if not (NCCL.search(op[0]) or PORT_KERNELS.search(op[0])
                    or NOT_PRODUCTS.search(op[0]))]
