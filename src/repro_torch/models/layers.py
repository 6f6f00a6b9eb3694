"""Shared building blocks (port of ``repro/models/layers.py:19-123``).

Plain functions on dicts of tensors, as the JAX package has them:
``init_*`` returns a params dict on a given device from an explicit
``torch.Generator``; the apply functions take ``(params, inputs)``.
bf16 semantics follow the JAX package:

  * ``linear`` accumulates in f32 and rounds once to the input dtype
    (``preferred_element_type=f32`` there).  A bf16 x bf16 ``matmul``
    does this in PyTorch's CPU BLAS and in cuBLAS, whose reduced-
    precision bf16 reductions ``kernels/_device.resolve_device`` turns
    off;
  * ``mlp`` applies ``silu`` (as ``x * sigmoid(x)``) in f32, then casts;
  * ``apply_rope`` rotates interleaved (even, odd) pairs, not halves.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dense_init(gen: torch.Generator, shape: tuple[int, ...],
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) with fan_in = shape[0], as the JAX init."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(max(shape[0], 1)))).to(dtype)


def init_rmsnorm(d: int, device: torch.device) -> dict:
    return {"w": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * p["w"].to(torch.float32)
    return out.to(dt)


def init_linear(gen: torch.Generator, d_in: int, d_out, *,
                bias: bool = False, dtype=torch.bfloat16,
                device: torch.device) -> dict:
    shape = (d_in,) + (d_out if isinstance(d_out, tuple) else (d_out,))
    p = {"w": _dense_init(gen, shape, dtype, device)}
    if bias:
        p["b"] = torch.zeros(shape[1:], dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, *out] -> [..., *out]; f32 accumulate."""
    w = p["w"]
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 1e4
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> cos/sin f32 [..., dim/2]."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, H, dim]; cos/sin broadcastable [..., T, 1, dim/2]."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(dt)


def init_mlp(gen: torch.Generator, d: int, f: int, *, dtype=torch.bfloat16,
             device: torch.device) -> dict:
    return {"gate": init_linear(gen, d, f, dtype=dtype, device=device),
            "up": init_linear(gen, d, f, dtype=dtype, device=device),
            "down": init_linear(gen, f, d, dtype=dtype, device=device)}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = linear(p["gate"], x).to(torch.float32)
    # x * sigmoid(x), the form jax.nn.silu computes: F.silu's
    # x / (1 + exp(-x)) differs from it in the last f32 bit far more often
    h = (g * torch.sigmoid(g)).to(x.dtype)
    h = h * linear(p["up"], x)
    return linear(p["down"], h)


def init_embed(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.bfloat16, device: torch.device) -> dict:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return {"w": (w * 0.02).to(dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["w"])


def init_lm_head(gen: torch.Generator, d: int, vocab: int, *,
                 dtype=torch.bfloat16, device: torch.device) -> dict:
    return init_linear(gen, d, vocab, dtype=dtype, device=device)


def lm_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p, x)
