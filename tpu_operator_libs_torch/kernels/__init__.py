"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version: flash attention (forward, dK/dV, dQ), the ring-attention block
fold, the decode path's int8-weight matmul, cache write and cached
attention, the Llama block's RMSNorm (with the residual add), SwiGLU gate
and the batch forward's RoPE, forward and backward, and the training
step's next-token loss (forward and backward), the clip's global norm
and the AdamW update."""

from tpu_operator_libs_torch.kernels import (
    adamw,
    attention_fold,
    cross_entropy,
    decode_attention,
    flash_attention,
    global_norm,
    int8_matmul,
    kv_append,
    rms_norm,
    rope,
    swiglu,
)

#: every CUDA source under ``csrc/`` that a kernel of the port is built from
SOURCES = flash_attention.SOURCES + (attention_fold.SOURCE,
                                     int8_matmul.SOURCE,
                                     decode_attention.SOURCE,
                                     kv_append.SOURCE, rms_norm.SOURCE,
                                     swiglu.SOURCE, rope.SOURCE,
                                     adamw.SOURCE, cross_entropy.SOURCE)
#: every kernel's wrapper, by the name its launch count reports under
WRAPPERS = {**flash_attention.WRAPPERS, **attention_fold.WRAPPERS,
            **int8_matmul.WRAPPERS, **decode_attention.WRAPPERS,
            **kv_append.WRAPPERS, **rms_norm.WRAPPERS, **swiglu.WRAPPERS,
            **rope.WRAPPERS, **adamw.WRAPPERS, **cross_entropy.WRAPPERS,
            **global_norm.WRAPPERS}
