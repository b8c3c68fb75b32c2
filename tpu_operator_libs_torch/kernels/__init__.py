"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version: flash attention (forward, dK/dV, dQ), the ring-attention block
fold, the decode path's int8-weight matmul, cache write and cached
attention, the Llama block's RMSNorm (with the residual add), SwiGLU gate
and the batch forward's RoPE, forward and backward, the training
step's next-token loss (forward and backward), the clip's global norm
and the AdamW update, and the decode step's token pick."""

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
    token_pick,
)

#: every CUDA source under ``csrc/`` that a kernel of the port is built from
SOURCES = flash_attention.SOURCES + (attention_fold.SOURCE,
                                     int8_matmul.SOURCE,
                                     decode_attention.SOURCE,
                                     kv_append.SOURCE, rms_norm.SOURCE,
                                     swiglu.SOURCE, rope.SOURCE,
                                     adamw.SOURCE, cross_entropy.SOURCE,
                                     token_pick.SOURCE)
#: every kernel's wrapper, by the name its launch count reports under
WRAPPERS = {**flash_attention.WRAPPERS, **attention_fold.WRAPPERS,
            **int8_matmul.WRAPPERS, **decode_attention.WRAPPERS,
            **kv_append.WRAPPERS, **rms_norm.WRAPPERS, **swiglu.WRAPPERS,
            **rope.WRAPPERS, **adamw.WRAPPERS, **cross_entropy.WRAPPERS,
            **global_norm.WRAPPERS, **token_pick.WRAPPERS}


def save_launches():
    """Every wrapper's launch count, and the flash kernels' by design, to
    set back by :func:`restore_launches` after a measurement (a
    measurement is not the path)."""
    return ({name: w.launches for name, w in WRAPPERS.items()},
            {name: dict(w.launches_by_design) for name, w in WRAPPERS.items()
             if hasattr(w, "launches_by_design")})


def restore_launches(saved) -> None:
    """Set every count, in all and by design, back to ``saved``, what
    :func:`save_launches` read."""
    counts, by_design = saved
    for name, count in counts.items():
        WRAPPERS[name].launches = count
    for name, by in by_design.items():
        WRAPPERS[name].launches_by_design.clear()
        WRAPPERS[name].launches_by_design.update(by)
