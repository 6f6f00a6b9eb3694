"""Shared building blocks (port of ``repro/models/layers.py:19-173``).

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
  * ``apply_rope`` rotates interleaved (even, odd) pairs, not halves;
  * the losses take logits in f32; ``chunked_cross_entropy`` recomputes
    each chunk's logits in the backward (``torch.utils.checkpoint``, as
    ``jax.checkpoint`` there), so one chunk's f32 logits are live at a
    time.

Under a mesh whose ``model`` axis is larger than one (tensor
parallelism, ``distributed/tp.py``), a layer's params are this rank's
shards under the rule table and the layers issue GSPMD's collectives:
``mlp``'s gate and up are column-parallel (:func:`column_linear`: no
collective forward, the input gradient's partial summed backward) and
its down projection row-parallel (its f32 partial summed over the
ranks, then rounded), ``embed`` looks up this rank's rows of the vocab
and sums, ``lm_logits``/``last_logits`` gather the vocab columns, so
every rank returns the whole ``[..., V]``, and ``chunked_cross_entropy``
never gathers them: each chunk's loss is the vocab-parallel
cross-entropy of this rank's columns (``tp.vocab_cross_entropy``); a
vocab that does not divide the axis keeps the embedding and the head
whole (``tp.Whole``): the plain lookup, logits and loss on every rank.
A leaf the rule table keeps whole over the model axis (``tp.Whole``: wq,
wk, wv, their biases, wo where the heads do not divide it) is the plain
product in :func:`column_linear` and ``tp.row_parallel``, no sum forward
or backward, but for wk's and wv's under split query heads, whose input
gradient and weight gradient are partials summed over the ranks.  With a
model axis of one each is the plain form above.

Under sequence parallelism (``axes.set_sp``, a layer body within
``tp.seq_parallel``) a layer's input and output are this rank's S block
of the residual stream: :func:`rmsnorm` runs on the block (its weight's
gradient summed over ``model``), ``tp.gather_seq`` gathers the normed
block before the mixers, the column-parallel products reduce-scatter
their input gradient's partials, and ``mlp``'s down projection, like
every mixer's row-parallel output, is reduce-scattered to the block
(``tp.row_parallel``).

Under a data axis larger than one the layers take this rank's rows of
the batch, and every weight is read through ``tp.weight`` at its use:
an FSDP block (``tp.Fsdp``) is gathered over ``data`` just before its
product, and a weight's gradient is summed over ``data`` in f32 and
rounded once; ``chunked_cross_entropy`` sums its loss and token count
over ``data`` (the global mean) and ``lm_logits`` returns the whole
batch's logits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tp


def _dense_init(gen: torch.Generator, shape: tuple[int, ...],
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) with fan_in = shape[0], as the JAX init."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(max(shape[0], 1)))).to(dtype)


def init_rmsnorm(d: int, device: torch.device) -> dict:
    return {"w": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim.  On this rank's S block of the residual
    stream (``tp.on_block``: sequence parallelism) the weight, replicated
    over ``model``, sees S/m rows only: its f32 gradient is a partial,
    summed over ``model``."""
    dt = x.dtype
    w = tp.Whole(p["w"], True) if tp.on_block(x) else p["w"]
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * tp.weight(w).to(torch.float32)
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


def column_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`linear` of a weight whose output dims are split over the
    ``model`` axis (q/k/v, the MLP's gate and up, the LM head): the same
    product through ``tp.column_parallel``, whose backward sums the input
    gradient over the ranks; the bias (this rank's block) adds locally.
    The weight may be an FSDP block (``tp.Fsdp``)."""
    y = tp.column_parallel(x, p["w"])
    if "b" in p:
        y = y + tp.weight(p["b"]).to(y.dtype)
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
    g = column_linear(p["gate"], x).to(torch.float32)
    # x * sigmoid(x), the form jax.nn.silu computes: F.silu's
    # x / (1 + exp(-x)) differs from it in the last f32 bit far more often
    h = (g * torch.sigmoid(g)).to(x.dtype)
    h = h * column_linear(p["up"], x)
    return tp.row_parallel(h, p["down"]["w"])


def init_embed(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.bfloat16, device: torch.device) -> dict:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return {"w": (w * 0.02).to(dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return tp.vocab_embed(p["w"], tokens)


def init_lm_head(gen: torch.Generator, d: int, vocab: int, *,
                 dtype=torch.bfloat16, device: torch.device) -> dict:
    return init_linear(gen, d, vocab, dtype=dtype, device=device)


def lm_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    return tp.gather_vocab(column_linear(p, x),
                           split=not isinstance(p["w"], tp.Whole))


def last_logits(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """A model's logits [B, V] at the last position of hidden states [B,
    S, D]: ``final_norm`` then ``lm_head`` on that row only."""
    x = rmsnorm(params["final_norm"], x[:, -1:], eps)
    return lm_logits(params["lm_head"], x)[:, 0]


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[target]`` in f32."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean masked token cross-entropy in f32."""
    nll = _nll(logits, targets)
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def chunked_cross_entropy(head_p: dict, x: torch.Tensor,
                          targets: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          chunk: int = 2048) -> torch.Tensor:
    """CE over the vocab head without materialising [B, S, V] logits.

    The sequence is cut into equal chunks (padded at the end, as the JAX
    version pads), each chunk's logits computed under
    ``torch.utils.checkpoint`` so that only one chunk's f32 logits are
    live in the forward and the backward.  Under a model axis a chunk's
    logits are this rank's vocab columns and its loss the vocab-parallel
    cross-entropy (``tp.vocab_cross_entropy``); the recompute issues its
    all-reduces again, on every rank alike.
    """
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    n_chunks = max(1, (s + chunk - 1) // chunk)
    c = (s + n_chunks - 1) // n_chunks
    pad = n_chunks * c - s
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    mask = mask.to(torch.float32)

    split = not isinstance(head_p["w"], tp.Whole)

    def one(xi, ti, mi):
        logits = column_linear(head_p, xi).to(torch.float32)
        nll = tp.vocab_cross_entropy(logits, ti, split)
        return (nll * mi).sum(), mi.sum()

    one = tp.under_mesh(one)           # the recompute's thread
    parts = [checkpoint(one, x[:, i * c:(i + 1) * c],
                        targets[:, i * c:(i + 1) * c],
                        mask[:, i * c:(i + 1) * c], use_reentrant=False)
             for i in range(n_chunks)]
    nll = torch.stack([p[0] for p in parts]).sum()
    cnt = torch.stack([p[1] for p in parts]).sum()
    if tp.rows_split():                # the sums of every rank's rows
        nll, cnt = tp.reduce_from_data(torch.stack([nll, cnt]))
    return nll / cnt.clamp(min=1.0)
