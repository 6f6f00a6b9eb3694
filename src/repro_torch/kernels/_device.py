"""Device resolution for the port's entry points.

The port runs on an NVIDIA Hopper card (compute capability 9.x) unless
the caller asks for the CPU.  There is no fallback: with no device given
and no CUDA, or on a card of another generation, this raises.

Kernel dispatch does not come through here — each wrapper in
:mod:`repro_torch.kernels.ops` picks its backend from the device of the
tensor it is given.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must be capability 9.x.

    Resolving a CUDA device also sets two process-wide cuBLAS switches:
    reduced-precision bf16 reductions off
    (``allow_bf16_reduced_precision_reduction``, default True), so a bf16
    matrix product accumulates in f32 and rounds once, as
    ``models.layers.linear`` promises and as the JAX package's
    ``preferred_element_type=f32`` does; and TF32 off for f32 products
    (``allow_tf32``, already False by default), so prefill attention's
    f32 einsums run in full f32.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(idx)
    if major != 9:
        raise RuntimeError(f"{torch.cuda.get_device_name(idx)} is compute "
                           f"capability {major}.{minor}; the kernels are "
                           "built for Hopper (sm_90a)")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", idx)
