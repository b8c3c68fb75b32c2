"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version: flash attention (forward, dK/dV, dQ), the ring-attention block
fold, and the decode path's int8-weight matmul, cache write and cached
attention."""

from tpu_operator_libs_torch.kernels import (
    attention_fold,
    decode_attention,
    flash_attention,
    int8_matmul,
    kv_append,
)

#: every CUDA source under ``csrc/`` that a kernel of the port is built from
SOURCES = flash_attention.SOURCES + (attention_fold.SOURCE,
                                     int8_matmul.SOURCE,
                                     decode_attention.SOURCE,
                                     kv_append.SOURCE)
#: every kernel's wrapper, by the name its launch count reports under
WRAPPERS = {**flash_attention.WRAPPERS, **attention_fold.WRAPPERS,
            **int8_matmul.WRAPPERS, **decode_attention.WRAPPERS,
            **kv_append.WRAPPERS}
