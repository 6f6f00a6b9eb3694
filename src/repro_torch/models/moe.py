"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): top-k
routing, capacity-bounded dispatch into an [E, C, D] buffer, per-expert
SwiGLU, gate-weighted combine.  DeepSeek-style shared
experts (always on) ride beside the routed ones; arctic's dense residual
FFN is added by the caller (``transformer._ffn_apply``).

Semantics kept from the JAX version, each of which decides bits:

  * routing in f32 (the router is f32); ``top_k`` takes ties in index
    order (a stable descending sort), as ``lax.top_k`` does;
  * a (token, choice) takes the next slot of its expert in the flat
    [T * k] order (a cumulative count), and slots past the capacity go to
    a trash slot that the combine reads as 0 — the dispatch writes every
    kept entry once and only the trash slot twice (with zeros);
  * the expert products take bf16 operands and keep f32 outputs
    (``preferred_element_type=f32`` there): the SwiGLU hidden state stays
    f32 until it is rounded once for the down projection.  On the card
    ``torch.bmm(..., out_dtype=float32)`` does this without widening the
    weights; on the CPU, which lacks that overload, the operands are
    widened (bf16 products are exact in f32);
  * the combine sums each token's k contributions in choice order,
    starting from 0, as the scatter-add ``out.at[tok].add`` does.

Expert parallelism (JAX's ``shard_map`` path): under a mesh with a
``model`` axis (``distributed/axes.use_mesh``) a rank holds its E/m
experts ``[midx * e_local, (midx + 1) * e_local)`` only (``sharding.
local_params``; :func:`init_moe` draws the others and keeps nothing of
them), routes the tokens of its rows (the rank's rows of the batch under
a data axis, ``tp.rows_split``, which JAX's ``in_specs=P(dp, None)``
hands each device) through them with the capacity of that token count,
and the f32 partial outputs are summed over ``model``
(``tp.reduce_from_model``).  The backward follows JAX's transpose of the
``shard_map`` (``distributed/tp.py``): the FFN input's gradient summed
over ``model`` (``tp.copy_to_model``), the router's f32 gradient summed
over ``model`` (a ``tp.Whole`` leaf read by this rank's experts only)
and, as every replicated leaf's, over ``data``; the experts' own
gradients are this rank's, summed over ``data`` only.  The shared
experts stay outside, as in JAX, where GSPMD runs them tensor-parallel
under the rule table: a rank holds its columns of their gate and up and
its rows of their down (whole, ``tp.Whole``, where their width does not
divide the axis), which ``layers.mlp`` runs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import axes as AX
from repro_torch.distributed import tp

from . import layers as L


def init_moe(gen: torch.Generator, d: int, f_expert: int, n_experts: int,
             n_shared: int = 0, *, dtype=torch.bfloat16,
             device: torch.device, block=None) -> dict:
    """Router [D, E] in f32, experts stacked {gate, up: [E, D, F], down:
    [E, F, D]}, and ``shared`` (one MLP n_shared * F wide) if asked for.
    Experts are drawn one at a time into the stack, so the f32 draw of
    one expert is the largest temporary.  ``block``: a function of a
    stack's name and whole shape giving the slices of each dim a rank
    keeps (``sharding.Local.block``): every expert is drawn, and the
    stack holds only the kept experts' kept blocks."""
    p = {"router": L.init_linear(gen, d, n_experts, dtype=torch.float32,
                                 device=device)}
    whole = {"gate": (n_experts, d, f_expert), "up": (n_experts, d, f_expert),
             "down": (n_experts, f_expert, d)}
    cut = {k: block(k, sh) if block else [slice(0, n) for n in sh]
           for k, sh in whole.items()}
    experts = {k: {"w": torch.empty(tuple(s.stop - s.start for s in c),
                                    dtype=dtype, device=device)}
               for k, c in cut.items()}
    for e in range(n_experts):
        one = L.init_mlp(gen, d, f_expert, dtype=dtype, device=device)
        for k, v in one.items():
            lo = cut[k][0]
            if lo.start <= e < lo.stop:
                experts[k]["w"][e - lo.start] = v["w"][cut[k][1], cut[k][2]]
    p["experts"] = experts
    if n_shared:
        p["shared"] = L.init_mlp(gen, d, n_shared * f_expert, dtype=dtype,
                                 device=device)
    return p


def _capacity(n_tokens: int, top_k: int, n_experts: int,
              factor: float = 1.25) -> int:
    return max(8, int(math.ceil(n_tokens * top_k / n_experts * factor)))


def _probs(router: dict, x2d: torch.Tensor) -> torch.Tensor:
    return torch.softmax(tp.replicated(x2d.to(torch.float32), router["w"]),
                         dim=-1)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router: dict, x2d: torch.Tensor, top_k: int, n_experts: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """x2d [T, D] -> (gates [T, k] f32, experts [T, k] int64)."""
    gates, idx = _top_k(_probs(router, x2d), top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates.to(torch.float32), idx


class _ExpertMatmul(torch.autograd.Function):
    """[E, C, a] x [E, a, b] -> [E, C, b] in f32 from bf16 operands (``b``
    may be f32 holding bf16 values: a stack gathered over ``data`` or
    widened for the data axis's sum, ``tp.weight``).

    The backward forms each gradient in f32 from the f32 cotangent and
    the other operand widened, then rounds it once to bf16, as JAX's
    transpose of a ``preferred_element_type=f32`` product does (so a
    backward widens one expert stack at a time); a widened stack's
    gradient is those bf16 values in f32, for the data axis's sum.
    """

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        bb = b.to(a.dtype)
        ctx.save_for_backward(a, bb)
        ctx.b_dtype = b.dtype
        if a.is_cuda:
            return torch.bmm(a, bb, out_dtype=torch.float32)
        return torch.bmm(a.to(torch.float32), bb.to(torch.float32))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        f32 = torch.float32
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.to(f32).transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(f32).transpose(1, 2), g).to(b.dtype).to(
                ctx.b_dtype)
        return ga, gb


def _moe_local(p: dict, x2d: torch.Tensor, top_k: int, n_experts: int,
               e_offset: int, e_local: int, capacity: int) -> torch.Tensor:
    """Route T tokens through experts [e_offset, e_offset + e_local);
    returns [T, D] in f32."""
    t, d = x2d.shape
    gates, idx = _route(p["router"], x2d, top_k, n_experts)

    flat_e = idx.reshape(-1)                                  # [T*k]
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)
    pos = torch.cumsum(onehot, dim=0) - 1                     # within expert
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    local = (flat_e >= e_offset) & (flat_e < e_offset + e_local)
    keep = (pos < capacity) & local
    e_loc = torch.where(keep, flat_e - e_offset, 0)
    slot = torch.where(keep, pos, capacity)                   # cap = dropped

    # dispatch: [E_loc, C + 1, D], the last slot the trash bin
    tok = torch.arange(t, device=x2d.device).repeat_interleave(top_k)
    buf = x2d.new_zeros((e_local, capacity + 1, d))
    buf[e_loc, slot] = torch.where(keep[:, None], x2d[tok], 0).to(buf.dtype)
    xe = buf[:, :capacity]                                    # [E, C, D]

    w = p["experts"]
    g = _ExpertMatmul.apply(xe, w["gate"]["w"])               # f32 [E, C, F]
    h = g * torch.sigmoid(g)                                  # jax.nn.silu
    h = h * _ExpertMatmul.apply(xe, w["up"]["w"])
    ye = _ExpertMatmul.apply(h.to(xe.dtype), w["down"]["w"])  # f32 [E, C, D]

    # combine: each (token, choice) reads its slot, weighted by its gate
    ye = torch.cat([ye, ye.new_zeros((e_local, 1, d))], dim=1)
    contrib = ye[e_loc, slot] * torch.where(keep, gates.reshape(-1),
                                            0.0)[:, None]
    contrib = contrib.reshape(t, top_k, d)
    out = contrib[:, 0]
    for j in range(1, top_k):                                 # choice order
        out = out + contrib[:, j]
    return out


def _moe_sharded(p: dict, x2d: torch.Tensor, top_k: int, n_experts: int,
                 capacity_factor: float, summed: bool = True
                 ) -> torch.Tensor:
    """The expert-parallel path: this rank's rows ``x2d`` (its data
    shard's tokens, as they are) through its own experts (``p["experts"]``
    holds them alone), the f32 partials summed over ``model`` (unless
    ``summed`` is False: the caller reduce-scatters them).  Returns [T, D]
    in f32, this rank's rows."""
    m = tp.model_size()
    if n_experts % m:
        raise ValueError(f"{n_experts} experts do not split over a model "
                         f"axis of {m}")
    if tp.data_size() > 1 and not tp.rows_split():
        raise NotImplementedError(
            f"a batch whose rows do not divide the data axis of "
            f"{tp.data_size()} stays whole on every rank, which JAX's "
            f"shard_map cannot route ({tp.ROADMAP_ITEM})")
    e_local = n_experts // m
    router = p["router"]["w"]
    if m > 1:                       # each rank's gates: a partial gradient
        router = tp.Whole(router, partial=True)
    pp = {"router": {"w": router},
          "experts": {k: {"w": tp.weight(v["w"])}
                      for k, v in p["experts"].items()}}
    cap = _capacity(x2d.shape[0], top_k, n_experts, capacity_factor)
    out = _moe_local(pp, tp.copy_to_model(x2d), top_k, n_experts,
                     tp.model_rank() * e_local, e_local, cap)
    return tp.reduce_from_model(out) if summed else out


def moe_ffn(p: dict, x: torch.Tensor, *, top_k: int, n_experts: int,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """[B, S, D] -> [B, S, D]; the expert-parallel path when a mesh with
    a "model" axis is active (``distributed.axes.current_mesh``).  Under
    sequence parallelism x is the gathered sequence, routed as a whole
    (the capacity and the drops of the same tokens as without it, as JAX's
    shard_map takes its rows over ``P(dp, None)``), and the experts' f32
    partials are reduce-scattered to this rank's S block
    (``tp.sum_seq``)."""
    b, s, d = x.shape
    mesh = AX.current_mesh()
    x2d = x.reshape(b * s, d)
    if mesh is None or "model" not in AX.mesh_axes(mesh):
        cap = _capacity(b * s, top_k, n_experts, capacity_factor)
        out = _moe_local(p, x2d, top_k, n_experts, 0, n_experts, cap)
    elif tp.seq_whole(x):
        out = tp.sum_seq(_moe_sharded(p, x2d, top_k, n_experts,
                                      capacity_factor, summed=False)
                         .view(b, s, d))
    else:
        out = _moe_sharded(p, x2d, top_k, n_experts, capacity_factor)
    y = out.reshape(b, -1, d).to(x.dtype)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x)
    return y


def aux_load_balance_loss(p: dict, x: torch.Tensor, *, top_k: int,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean fraction * prob)."""
    b, s, d = x.shape
    probs = _probs(p["router"], x.reshape(b * s, d))
    _, idx = _top_k(probs, top_k)
    frac = torch.nn.functional.one_hot(idx, n_experts).to(
        torch.float32).mean(dim=(0, 1))
    return n_experts * torch.sum(frac * probs.mean(dim=0))
