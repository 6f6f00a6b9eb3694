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
``model`` axis (``distributed/axes.use_mesh``), every rank holds the whole
activation, routes the tokens of its data shard through its own experts
``[midx * e_local, (midx + 1) * e_local)`` (sliced from the full stack
every rank holds) with the capacity of a
shard's token count, and the partial outputs are summed over the
``model`` group; a data axis larger than one then gathers the shards'
rows, so every rank returns the whole output, as JAX's global array
holds it.  The shared experts stay outside, as in JAX, where GSPMD runs
them tensor-parallel under the rule table: with a model axis larger than
one each rank takes its columns of their gate and up and its rows of
their down (:func:`_local_mlp`) through ``layers.mlp``'s row-parallel
path.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed import axes as AX
from repro_torch.distributed import tp

from . import layers as L


def init_moe(gen: torch.Generator, d: int, f_expert: int, n_experts: int,
             n_shared: int = 0, *, dtype=torch.bfloat16,
             device: torch.device) -> dict:
    """Router [D, E] in f32, experts stacked {gate, up: [E, D, F], down:
    [E, F, D]}, and ``shared`` (one MLP n_shared * F wide) if asked for.
    Experts are drawn one at a time into the stack, so the f32 draw of
    one expert is the largest temporary."""
    p = {"router": L.init_linear(gen, d, n_experts, dtype=torch.float32,
                                 device=device)}
    experts = None
    for e in range(n_experts):
        one = L.init_mlp(gen, d, f_expert, dtype=dtype, device=device)
        if experts is None:
            experts = {k: {"w": torch.empty((n_experts,) + v["w"].shape,
                                            dtype=dtype, device=device)}
                       for k, v in one.items()}
        for k, v in one.items():
            experts[k]["w"][e] = v["w"]
    p["experts"] = experts
    if n_shared:
        p["shared"] = L.init_mlp(gen, d, n_shared * f_expert, dtype=dtype,
                                 device=device)
    return p


def _capacity(n_tokens: int, top_k: int, n_experts: int,
              factor: float = 1.25) -> int:
    return max(8, int(math.ceil(n_tokens * top_k / n_experts * factor)))


def _probs(router: dict, x2d: torch.Tensor) -> torch.Tensor:
    return torch.softmax(L.linear(router, x2d.to(torch.float32)), dim=-1)


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
    """[E, C, a] x [E, a, b] -> [E, C, b] in f32 from bf16 operands.

    The backward forms each gradient in f32 from the f32 cotangent and
    the other operand widened, then rounds it once to the operand's
    dtype, as JAX's transpose of a ``preferred_element_type=f32`` product
    does (so a backward widens one expert stack at a time).
    """

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.to(torch.float32), b.to(torch.float32))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        f32 = torch.float32
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.to(f32).transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(f32).transpose(1, 2), g).to(b.dtype)
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


def _moe_sharded(p: dict, x2d: torch.Tensor, mesh, top_k: int,
                 n_experts: int, capacity_factor: float) -> torch.Tensor:
    """The expert-parallel path: this rank's data shard of ``x2d``
    through its experts, summed over "model", the shards' rows gathered
    over the data axes (pod-major).  Returns [T, D] in f32."""
    sizes = AX.mesh_axes(mesh)
    m = sizes["model"]
    if n_experts % m:
        raise ValueError(f"{n_experts} experts do not split over a model "
                         f"axis of {m}")
    e_local = n_experts // m
    dp = AX.dp_axes()
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    t = x2d.shape[0]
    if t % dp_size:
        raise ValueError(f"{t} tokens do not split over {dp_size} data "
                         "ranks")
    t_loc = max(1, t // dp_size)
    cap = _capacity(t_loc, top_k, n_experts, capacity_factor)
    dpi = 0
    for a in dp:                                    # major to minor
        dpi = dpi * sizes[a] + mesh.get_local_rank(a)
    midx = mesh.get_local_rank("model")
    mine = slice(midx * e_local, (midx + 1) * e_local)   # of the full stack
    pp = {"router": p["router"],
          "experts": {k: {"w": v["w"][mine]} for k, v in p["experts"].items()}}
    out = _moe_local(pp, x2d[dpi * t_loc:(dpi + 1) * t_loc], top_k,
                     n_experts, midx * e_local, e_local, cap)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group("model"))
    for a in reversed(dp):                          # minor axis first
        if sizes[a] > 1:
            parts = [torch.empty_like(out) for _ in range(sizes[a])]
            dist.all_gather(parts, out, group=mesh.get_group(a))
            out = torch.cat(parts)
    return out


def _local_mlp(p: dict) -> dict:
    """This rank's shard of a dense MLP held whole (the shared experts):
    columns of gate and up, rows of down, block ``model_rank`` of
    ``model_size``, as the rule table lays them out; the MLP itself with
    a model axis of one."""
    m = tp.model_size()
    if m == 1:
        return p
    if p["gate"]["w"].shape[-1] % m:
        raise NotImplementedError(
            f"shared experts of width {p['gate']['w'].shape[-1]} do not "
            f"split over a model axis of {m} ({tp.ROADMAP_ITEM})")
    f = p["gate"]["w"].shape[-1] // m
    mine = slice(tp.model_rank() * f, (tp.model_rank() + 1) * f)
    return {"gate": {"w": p["gate"]["w"][:, mine]},
            "up": {"w": p["up"]["w"][:, mine]},
            "down": {"w": p["down"]["w"][mine]}}


def moe_ffn(p: dict, x: torch.Tensor, *, top_k: int, n_experts: int,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """[B, S, D] -> [B, S, D]; the expert-parallel path when a mesh with
    a "model" axis is active (``distributed.axes.current_mesh``)."""
    b, s, d = x.shape
    mesh = AX.current_mesh()
    x2d = x.reshape(b * s, d)
    if mesh is None or "model" not in AX.mesh_axes(mesh):
        cap = _capacity(b * s, top_k, n_experts, capacity_factor)
        out = _moe_local(p, x2d, top_k, n_experts, 0, n_experts, cap)
    else:
        out = _moe_sharded(p, x2d, mesh, top_k, n_experts, capacity_factor)
    y = out.reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        y = y + L.mlp(_local_mlp(p["shared"]), x)
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
