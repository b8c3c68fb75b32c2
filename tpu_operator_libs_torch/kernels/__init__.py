"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version: flash attention (forward, dK/dV, dQ), the ring-attention block
fold and the int8-weight matmul of the decode path."""

from tpu_operator_libs_torch.kernels import (
    attention_fold,
    flash_attention,
    int8_matmul,
)

#: every CUDA source under ``csrc/`` that a kernel of the port is built from
SOURCES = flash_attention.SOURCES + (attention_fold.SOURCE,
                                     int8_matmul.SOURCE)
#: every kernel's wrapper, by the name its launch count reports under
WRAPPERS = {**flash_attention.WRAPPERS, **attention_fold.WRAPPERS,
            **int8_matmul.WRAPPERS}
