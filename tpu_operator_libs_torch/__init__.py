"""PyTorch and CUDA port of the compute in ``tpu_operator_libs``.

The JAX package stays the reference: each module here names the module
and function it mirrors, and the tests in ``tests/test_torch_*.py`` hold
the two against each other on the CPU. This package imports ``torch``,
numpy and the standard library, never ``jax`` or ``tpu_operator_libs``.

Entry points take ``device=None``, which means the CUDA device. Without
CUDA they raise unless the caller passes ``device="cpu"``: nothing here
carries on on the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device; raises when CUDA is asked for (or
    implied) and absent."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: tpu_operator_libs_torch runs on the "
            "card by default; pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    return resolved
