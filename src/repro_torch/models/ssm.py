"""State-space and recurrent sequence mixers: Mamba, mLSTM, sLSTM (port
of ``repro/models/ssm.py``).

* Mamba (selective SSM, diagonal A): Hymba's parallel-head branch.  The
  full-sequence form scans time step by step (the JAX default); with
  ``CHUNKED_SCAN`` it scans chunks of ``SCAN_CHUNK`` steps, each chunk
  by a log-depth (Hillis-Steele) scan in plain tensor ops.  Its combine
  order differs from XLA's ``associative_scan``, so the two forms agree
  to f32 rounding, not bit for bit.
* mLSTM (matrix-memory LSTM, xLSTM): a q-chunked parallel quadratic form
  for training, an O(1)-state recurrent step for decode.
* sLSTM (scalar-memory LSTM, xLSTM): a time scan with exponential gating
  and a stabiliser state.

Plain functions on dicts of tensors; a Python ``for`` over time where
JAX has ``lax.scan`` (its trips go through ``trips.steps``, so that the
dry run counts them without running each).  bf16 follows the JAX
package: the causal conv sums its ``conv`` products in bf16 in JAX's
order, mLSTM's keys are
divided by ``sqrt(dh)`` rounded to bf16, ``softplus`` is
``logaddexp(x, 0)`` (``torch.nn.functional.softplus`` switches to the
identity above a threshold) and ``log_sigmoid`` is ``-softplus(-x)``,
as JAX writes them.  The decode steps return new states; the models
write them into their caches.

Under the model axis (``distributed/tp.py``; JAX's rule table, whose
GSPMD program the port's parity tests hold these against) each function
takes this rank's shards and every weight is read through ``tp.weight``
(an FSDP block gathered over ``data``, a gradient summed over it):

* Mamba runs on the rank's block of the d_inner channels.  ``in_proj``
  is split over its 2 d_inner columns, so a rank's contiguous block holds
  u for the first m/2 ranks and z for the rest: the projection's block is
  gathered over ``model`` and each rank keeps its own channels of u and
  of z (:func:`_mamba_in`, the gather's gradient summed and cut back).
  ``x_proj`` is row-parallel (dt, B and C summed over ``model`` in f32 and
  rounded once, then read by every rank's channels: their gradient summed
  over ``model``, ``tp.copy_to_model``); ``dt_proj``, the conv, ``a_log``
  and ``d_skip`` are the rank's channels; the time scan runs on them with
  no collective; ``out_proj`` is row-parallel.  The state ``h`` [B, di/m,
  n] is the rank's channels.  Where d_inner does not divide the axis
  (:func:`channels_whole`) every leaf but ``in_proj`` is whole, and so is
  the mixer on every rank: ``in_proj``'s block (split at 2 d_inner where
  that divides the axis, straddling u and z) is gathered, and nothing
  else is summed.
* mLSTM: ``up`` and ``gate_z`` are column-parallel, u is gathered over
  ``model`` for ``wq``/``wk``/``wv`` (the rank's columns) and the f32
  ``w_if`` (whole, its gradient a partial summed over ``model``,
  ``tp.summed_weight``), ``down`` is row-parallel.  The parallel form runs
  on the rank's heads where the heads divide the axis; where the axis
  divides the heads a head spans m/H ranks: q and k are gathered and each
  rank computes its head's scores for its block of the value dims.  The
  decode step gathers q, k and v (every head) and updates its block of
  the key dim of C and n (``cache_specs`` splits them there), the
  numerator and the normaliser summed over ``model``.  Where the heads
  do not lie along the axis's blocks (di or the head width not dividing
  it, or heads that neither divide it nor are divided by it) every rank
  runs every head from q, k and v gathered whole (:func:`_mlstm_whole`),
  its decode state whole, and keeps its columns of h for ``down``.
* sLSTM: ``wx``'s gate-major columns are gathered over ``model`` and every
  rank runs the whole recurrence (``r`` whole, or gathered where it is
  split over heads), its gradient the same on every rank.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import tp
from repro_torch.kernels._device import resolve_device

from . import layers as L
from . import trips

NEG_INF = -1e30
f32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def _gate(y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """``y.astype(dtype) * silu(z.astype(f32)).astype(dtype)``."""
    return y.to(dtype) * silu(z.to(f32)).to(dtype)


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, d: int, d_inner: int, state: int,
               conv: int = 4, *, dtype=torch.bfloat16,
               device: torch.device) -> dict:
    dt_rank = max(1, math.ceil(d / 16))
    a = torch.arange(1, state + 1, dtype=f32, device=device).expand(
        d_inner, state)
    conv_w = torch.randn((conv, d_inner), generator=gen, device=device,
                         dtype=f32) * 0.1
    return {
        "in_proj": L.init_linear(gen, d, 2 * d_inner, dtype=dtype,
                                 device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": L.init_linear(gen, d_inner, dt_rank + 2 * state,
                                dtype=dtype, device=device),
        "dt_proj": L.init_linear(gen, dt_rank, d_inner, bias=True,
                                 dtype=dtype, device=device),
        "a_log": torch.log(a).contiguous(),
        "d_skip": torch.ones((d_inner,), dtype=f32, device=device),
        "out_proj": L.init_linear(gen, d_inner, d, dtype=dtype,
                                  device=device),
    }


def _local_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`layers.linear` on this rank's columns of a weight whose
    input is whole on every rank but whose output each rank reads alone
    (its gradient summed upstream): no sum forward or backward."""
    y = tp.replicated(x, p["w"])
    if "b" in p:
        y = y + tp.weight(p["b"]).to(y.dtype)
    return y


def channels_whole(p: dict) -> bool:
    """Whether Mamba's channel leaves are whole over the model axis (a
    d_inner that does not divide it: the rule table keeps the conv,
    x_proj, dt_proj, a_log, d_skip and out_proj whole), so that every
    rank runs the whole mixer."""
    return isinstance(p["conv_w"], tp.Whole)


def _mamba_in(p: dict, x: torch.Tensor):
    """(u, z) [B, S, di] of ``in_proj``: this rank's channels of each
    under a model axis, or every channel where they are whole
    (:func:`channels_whole`: ``in_proj``'s block, split over its 2 d_inner
    columns where they divide the axis, gathered whole; its gradient, the
    same on every rank, cut back unsummed)."""
    ux = L.column_linear(p["in_proj"], x)
    if tp.model_size() == 1 or isinstance(p["in_proj"]["w"], tp.Whole):
        return ux.chunk(2, dim=-1)
    whole = channels_whole(p)
    u, z = tp.gather_model(ux, summed=not whole).chunk(2, dim=-1)
    if whole:
        return u, z
    return tp.model_block(u), tp.model_block(z)


def _mamba_ssm_inputs(p: dict, u: torch.Tensor, state: int):
    """u [B, S, di] (post-conv, post-silu) -> (dA, dBu [B, S, di, n] f32,
    c [B, S, n] f32), discretised."""
    xp = tp.row_parallel(u, p["x_proj"]["w"], seq=False).to(f32)
    if not channels_whole(p):       # every rank's channels read it
        xp = tp.copy_to_model(xp)
    dt_rank = xp.shape[-1] - 2 * state
    dt, bmat, cmat = torch.split(xp, [dt_rank, state, state], dim=-1)
    delta = softplus(_local_linear(p["dt_proj"], dt.to(u.dtype)).to(f32))
    a = -torch.exp(tp.weight(p["a_log"]).to(f32))      # [di, n]
    da = torch.exp(delta[..., None] * a)
    dbu = (delta * u.to(f32))[..., None] * bmat[:, :, None, :]
    return da, dbu, cmat


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv.  u [B, S, di]; w [cw, di].  The products
    are summed in u's dtype in JAX's order, ``((p0 + p1) + p2) + p3``,
    then the bias is added."""
    cw, s = w.shape[0], u.shape[1]
    if init_state is None:
        pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    else:
        pad = init_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    out = up[:, 0:s] * w[0].to(u.dtype)
    for i in range(1, cw):
        out = out + up[:, i:i + s] * w[i].to(u.dtype)
    return out + b.to(u.dtype)


# The chunked time scan: S sequential steps become S / SCAN_CHUNK, each
# chunk a log-depth scan.  The default is the sequential scan, as in JAX.
CHUNKED_SCAN = False
SCAN_CHUNK = 256


def _assoc_scan(a: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a, b) under ``(a1, b1) .
    (a2, b2) = (a2 * a1, a2 * b1 + b2)``: ceil(log2(C)) Hillis-Steele
    rounds, each combining every element with the one ``off`` before it."""
    c, off = a.shape[1], 1
    while off < c:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _scan_chunked(da, dbu, cmat, h0):
    """da/dbu [B, S, di, n]; cmat [B, S, n] -> (h_last, y [B, S, di])."""
    s = da.shape[1]
    c = min(SCAN_CHUNK, s)
    h, ys = h0, []
    for i in range(0, s, c):
        acc_a, acc_b = _assoc_scan(da[:, i:i + c], dbu[:, i:i + c])
        h_all = acc_a * h[:, None] + acc_b               # [B, C, di, n]
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, cmat[:, i:i + c]))
        h = h_all[:, -1]
    return h, torch.cat(ys, dim=1)


def _scan_sequential(da, dbu, cmat, h0):
    s = da.shape[1]
    h, ys = h0, []
    for t in trips.steps(s):
        h = da[:, t] * h + dbu[:, t]                     # [B, di, n]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    return h, trips.stack(ys, s, dim=1)


def mamba_forward(p: dict, x: torch.Tensor, state: int,
                  return_state: bool = False):
    """Full-sequence Mamba via a (chunked) scan over time.  With
    ``return_state``: (out, h_last [B, di, n] f32, conv_tail [B, cw-1,
    di]), the state a decode step continues from (di this rank's channels
    under a model axis)."""
    b = x.shape[0]
    u_pre, z = _mamba_in(p, x)
    conv_w = tp.weight(p["conv_w"])
    u = silu(_causal_conv(u_pre, conv_w, tp.weight(p["conv_b"])).to(f32)
             ).to(x.dtype)
    da, dbu, cmat = _mamba_ssm_inputs(p, u, state)
    h0 = torch.zeros((b, u.shape[-1], state), dtype=f32, device=x.device)
    scan = _scan_chunked if CHUNKED_SCAN else _scan_sequential
    h_last, y = scan(da, dbu, cmat, h0)
    y = y + tp.weight(p["d_skip"]) * u.to(f32)
    out = tp.row_parallel(_gate(y, z, x.dtype), p["out_proj"]["w"])
    if not return_state:
        return out
    cw = conv_w.shape[0]
    pad = u_pre.new_zeros((b, cw - 1, u_pre.shape[-1]))
    conv_tail = torch.cat([pad, u_pre], dim=1)[:, -(cw - 1):]
    return out, h_last, conv_tail


def mamba_decode(p: dict, x: torch.Tensor, h: torch.Tensor,
                 conv_state: torch.Tensor, state: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step.  x [B, 1, D]; h [B, di, n]; conv_state [B, cw-1, di]
    -> (y [B, 1, D], h', conv_state'); di this rank's channels under a
    model axis."""
    u, z = _mamba_in(p, x)
    u_conv = _causal_conv(u, tp.weight(p["conv_w"]), tp.weight(p["conv_b"]),
                          init_state=conv_state)
    new_conv = torch.cat([conv_state[:, 1:], u.to(conv_state.dtype)], dim=1)
    u_act = silu(u_conv.to(f32)).to(x.dtype)
    da, dbu, cmat = _mamba_ssm_inputs(p, u_act, state)
    h = da[:, 0] * h + dbu[:, 0]
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None, :]
    y = y + tp.weight(p["d_skip"]) * u_act.to(f32)
    return (tp.row_parallel(_gate(y, z, x.dtype), p["out_proj"]["w"]), h,
            new_conv)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, d: int, n_heads: int,
               proj_factor: int = 2, *, dtype=torch.bfloat16,
               device: torch.device) -> dict:
    di = proj_factor * d

    def lin(d_in, d_out, **kw):
        return L.init_linear(gen, d_in, d_out, device=device,
                             **{"dtype": dtype, **kw})
    return {"up": lin(d, di), "gate_z": lin(d, di), "wq": lin(di, di),
            "wk": lin(di, di), "wv": lin(di, di),
            "w_if": lin(di, 2 * n_heads, bias=True, dtype=f32),
            "down": lin(di, d)}


def _key_scale(u: torch.Tensor, n_heads: int) -> torch.Tensor:
    """sqrt(dh) of the whole inner width ``u`` [..., di] rounded to u's
    dtype, as JAX's ``jnp.sqrt(f32(dh)).astype(u.dtype)`` (22.625, not
    22.627, at 512); a tensor on u's device, so that the card divides (a
    CPU scalar divisor becomes a product with its reciprocal there)."""
    dh = u.shape[-1] // n_heads
    return torch.full((), float(torch.tensor(math.sqrt(dh), dtype=f32)),
                      dtype=u.dtype, device=u.device)


def _mlstm_in(p: dict, x: torch.Tensor, n_heads: int):
    """(u whole [B, S, di], z, q, k, v [B, S, di/m]: this rank's columns,
    i_pre, f_pre [B, S, H] f32, every head)."""
    u = L.column_linear(p["up"], x)
    z = L.column_linear(p["gate_z"], x)
    uw = tp.gather_model(u)
    q = tp.replicated(uw, p["wq"]["w"])
    k = tp.replicated(uw, p["wk"]["w"]) / _key_scale(uw, n_heads)
    v = tp.replicated(uw, p["wv"]["w"])
    wif = p["w_if"]
    gif = torch.matmul(uw.to(f32), tp.summed_weight(wif["w"])) \
        + tp.summed_weight(wif["b"])
    i_pre, f_pre = gif.chunk(2, dim=-1)
    return uw, z, q, k, v, i_pre, f_pre


def mlstm_aligned(p: dict, n_heads: int) -> bool:
    """Whether the mLSTM's heads lie along the model axis's blocks: its
    inner width di and head width di/H divide the axis, and the heads
    divide it or it them.  Then a rank runs its heads (or its share of
    one); else every rank runs every head (:func:`_mlstm_whole`)."""
    m = tp.model_size()
    if m == 1:
        return True
    w = p["up"]["w"]
    if isinstance(w, tp.Whole):
        return False
    di = (w.block if isinstance(w, (tp.Fsdp, tp.Layer)) else w).shape[-1] * m
    return (di // n_heads) % m == 0 and (n_heads % m == 0
                                         or m % n_heads == 0)


def _mlstm_whole(p: dict, x: torch.Tensor, n_heads: int):
    """(q, k, v [B, S, H, dh], i_pre, f_pre [B, S, H], z) of every head on
    every rank, where they do not lie along the axis's blocks
    (:func:`mlstm_aligned`): u, and q, k and v from the rank's columns of
    wq, wk and wv, gathered over ``model`` where those leaves are split
    (di divides the axis; else they are whole), each gathered gradient the
    same on every rank and cut back unsummed; the products' input
    gradients summed over ``model`` (``tp.column_parallel``); the gates
    from the whole ``w_if``.  z is the rank's columns (or whole)."""
    b, s, _ = x.shape
    split = not isinstance(p["up"]["w"], tp.Whole)
    u = L.column_linear(p["up"], x)
    z = L.column_linear(p["gate_z"], x)
    uw = tp.gather_model(u, summed=False) if split else u
    q, k, v = (tp.column_parallel(uw, p[n]["w"]) for n in ("wq", "wk", "wv"))
    k = k / _key_scale(uw, n_heads)
    if split:
        q, k, v = (tp.gather_model(t, summed=False) for t in (q, k, v))
    wif = p["w_if"]
    gif = torch.matmul(uw.to(f32), tp.weight(wif["w"])) + tp.weight(wif["b"])
    i_pre, f_pre = gif.chunk(2, dim=-1)
    q, k, v = (t.reshape(b, s, n_heads, -1) for t in (q, k, v))
    return q, k, v, i_pre, f_pre, z


def _mlstm_out(p: dict, h: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """The gated output through ``down`` (row-parallel): h [B, S, w] of
    every head where every rank ran them all (wider than the rank's z) cut
    to the rank's columns, its gradient gathered back whole
    (``tp.scatter_model``)."""
    if h.shape[-1] != z.shape[-1]:
        h = tp.scatter_model(h)
    return tp.row_parallel(_gate(h, z, dtype), p["down"]["w"])


def _mlstm_qkvif(p: dict, x: torch.Tensor, n_heads: int):
    """(q, k, v [B, S, h, d], i_pre, f_pre [B, S, h], z): the rank's h
    heads and the value dims it computes (every head with no model axis;
    under one its H/m heads, or, where a head spans g = m/H ranks, its
    head's whole q and k and its 1/g of the value dims; every head where
    they do not lie along the axis's blocks, :func:`_mlstm_whole`)."""
    if not mlstm_aligned(p, n_heads):
        return _mlstm_whole(p, x, n_heads)
    b, s, _ = x.shape
    _, z, q, k, v, i_pre, f_pre = _mlstm_in(p, x, n_heads)
    m = tp.model_size()
    if m > 1 and n_heads % m:                   # a head spans m/H ranks
        head = tp.model_rank() // (m // n_heads)
        q, k = (tp.gather_model(t).reshape(b, s, n_heads, -1)
                .narrow(2, head, 1) for t in (q, k))
        v = v.reshape(b, s, 1, -1)
        i_pre, f_pre = (t.narrow(-1, head, 1) for t in (i_pre, f_pre))
    else:
        h = n_heads // m
        q, k, v = (t.reshape(b, s, h, -1) for t in (q, k, v))
        i_pre, f_pre = (tp.model_block(t) for t in (i_pre, f_pre))
    return q, k, v, i_pre, f_pre, z                   # gates [B, S, h]


def mlstm_forward(p: dict, x: torch.Tensor, n_heads: int,
                  chunk: int = 512) -> torch.Tensor:
    """The parallel (quadratic, q-chunked) stabilised mLSTM form."""
    b, s, _ = x.shape
    q, k, v, i_pre, f_pre, z = _mlstm_qkvif(p, x, n_heads)
    fcum = torch.cumsum(log_sigmoid(f_pre), dim=1)       # F_t [B, S, H]
    n_chunks = max(1, (s + chunk - 1) // chunk)
    c = (s + n_chunks - 1) // n_chunks
    key_pos = torch.arange(s, device=x.device)
    kf, vf = k.to(f32), v.to(f32)
    outs = []
    for i in range(0, s, c):
        qi, fci = q[:, i:i + c].to(f32), fcum[:, i:i + c]
        # D~[i, j] = F_i - F_j + itilde_j for j <= i (else -inf)
        dmat = (fci[:, :, None, :] - fcum[:, None, :, :]
                + i_pre[:, None, :, :])                  # [B, c, S, H]
        causal = key_pos[i:i + c, None] >= key_pos[None, :]
        dmat = torch.where(causal[None, :, :, None], dmat,
                           dmat.new_tensor(NEG_INF))
        m = dmat.amax(dim=2, keepdim=True)               # [B, c, 1, H]
        sc = torch.einsum("bchd,bthd->bcth", qi, kf) * torch.exp(dmat - m)
        norm = torch.maximum(sc.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))
        outs.append(torch.einsum("bcth,bthd->bchd", sc, vf)
                    / norm[..., None])
    h = torch.cat(outs, dim=1).reshape(b, s, -1)
    return _mlstm_out(p, h, z, x.dtype)


def mlstm_init_state(b: int, n_heads: int, dh: int,
                     device: torch.device | str | None = None) -> dict:
    device = resolve_device(device)
    return {"C": torch.zeros((b, n_heads, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((b, n_heads, dh), dtype=f32, device=device),
            "m": torch.full((b, n_heads), -math.inf, dtype=f32,
                            device=device)}


def mlstm_decode(p: dict, x: torch.Tensor, st: dict, n_heads: int
                 ) -> tuple[torch.Tensor, dict]:
    """One recurrent step; x [B, 1, D].  At the first step m is -inf:
    the stabiliser takes i_t and the old state's weight is 0 (``where``,
    so no -inf - -inf reaches the exponent's result).  Under a model axis
    ``st`` is this rank's blocks as ``cache_specs`` cuts them (C and n
    over their key dim; m over the heads where they divide the axis, else
    whole): see :func:`_mlstm_decode_tp`; where the heads do not lie along
    the axis's blocks (:func:`mlstm_aligned`) ``st`` is whole and every
    rank updates all of it."""
    if tp.model_size() > 1 and mlstm_aligned(p, n_heads):
        return _mlstm_decode_tp(p, x, st, n_heads)
    q, k, v, i_pre, f_pre, z = _mlstm_qkvif(p, x, n_heads)
    q, k, v = (a[:, 0].to(f32) for a in (q, k, v))
    i_t = i_pre[:, 0]
    logf = log_sigmoid(f_pre)[:, 0]                      # [B, H]
    m_prev = st["m"]
    first = torch.isinf(m_prev)
    m_new = torch.where(first, i_t, torch.maximum(logf + m_prev, i_t))
    fp = torch.where(first, torch.zeros_like(m_new),
                     torch.exp(logf + m_prev - m_new))
    ip = torch.exp(i_t - m_new)
    c_new = (fp[..., None, None] * st["C"]
             + ip[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v))
    n_new = fp[..., None] * st["n"] + ip[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, c_new)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(x.shape[0], 1, -1)
    return (_mlstm_out(p, h, z, x.dtype),
            {"C": c_new, "n": n_new, "m": m_new})


def _mlstm_decode_tp(p: dict, x: torch.Tensor, st: dict, n_heads: int
                     ) -> tuple[torch.Tensor, dict]:
    """:func:`mlstm_decode` on this rank's blocks of the state: q, k and v
    of every head gathered over ``model`` (one all-gather of the three
    stacked), the gates of every head, the rank's block of C's and n's key
    dim updated, the numerator and the normaliser's dot summed over
    ``model`` (one all-reduce of both), then the rank's columns of h for
    ``gate_z`` and the row-parallel ``down``."""
    b = x.shape[0]
    _, z, q, k, v, i_pre, f_pre = _mlstm_in(p, x, n_heads)
    qkv = tp.gather_model(torch.stack([q, k, v], dim=2)[:, 0])
    q, k, v = (t.reshape(b, n_heads, -1).to(f32) for t in qkv.unbind(1))
    i_t = i_pre[:, 0]
    logf = log_sigmoid(f_pre)[:, 0]                      # [B, H]
    m_prev = st["m"]
    split_m = m_prev.shape[-1] != n_heads
    if split_m:
        m_prev = tp.all_gather(m_prev, -1, "model")
    first = torch.isinf(m_prev)
    m_new = torch.where(first, i_t, torch.maximum(logf + m_prev, i_t))
    fp = torch.where(first, torch.zeros_like(m_new),
                     torch.exp(logf + m_prev - m_new))
    ip = torch.exp(i_t - m_new)
    kb, qb = (tp.model_block(t) for t in (k, q))         # [B, H, dh/m]
    c_new = (fp[..., None, None] * st["C"]
             + ip[..., None, None] * torch.einsum("bhk,bhv->bhkv", kb, v))
    n_new = fp[..., None] * st["n"] + ip[..., None] * kb
    part = torch.cat([torch.einsum("bhk,bhkv->bhv", qb, c_new),
                      torch.einsum("bhk,bhk->bh", qb, n_new)[..., None]],
                     dim=-1)
    part = tp.all_reduce(part, "model")
    num, den = part[..., :-1], part[..., -1]
    den = torch.maximum(den.abs(), torch.exp(-m_new))
    h = tp.model_block((num / den[..., None]).reshape(b, 1, -1))
    return (tp.row_parallel(_gate(h, z, x.dtype), p["down"]["w"]),
            {"C": c_new, "n": n_new,
             "m": tp.model_block(m_new) if split_m else m_new})


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory)
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, d: int, n_heads: int, *,
               dtype=torch.bfloat16, device: torch.device) -> dict:
    dh = d // n_heads
    r = torch.randn((n_heads, dh, 4 * dh), generator=gen, device=device,
                    dtype=f32) / math.sqrt(dh)
    return {"wx": L.init_linear(gen, d, 4 * d, bias=True, dtype=dtype,
                                device=device),
            "r": r}


def slstm_init_state(b: int, d: int,
                     device: torch.device | str | None = None) -> dict:
    device = resolve_device(device)
    def full(v):
        return torch.full((b, d), v, dtype=f32, device=device)
    return {"h": full(0.0), "c": full(0.0), "n": full(1.0), "m": full(0.0)}


def _slstm_x(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Wx x + b [B, S, 4d], whole on every rank: under a model axis the
    rank's gate-major columns (of the weight and of the bias) gathered,
    the gradient, the same on every rank, cut back to them."""
    if isinstance(p["wx"]["w"], tp.Whole):
        return L.column_linear(p["wx"], x)
    return tp.gather_model(L.column_linear(p["wx"], x), summed=False)


def _slstm_r(p: dict, n_heads: int) -> torch.Tensor:
    """The recurrent kernel [H, dh, 4dh], whole: gathered over ``model``
    where the rule table splits it over the heads."""
    r = tp.weight(p["r"])
    if r.shape[0] != n_heads:
        r = tp.gather_model(r, 0, summed=False)
    return r


def _slstm_step(p: dict, st: dict, x_t: torch.Tensor, n_heads: int,
                r: torch.Tensor | None = None) -> tuple[dict, torch.Tensor]:
    """x_t [B, 4d] (pre-projected Wx x) -> (state', h [B, d]); ``r`` the
    whole recurrent kernel (:func:`_slstm_r`)."""
    b, d = st["h"].shape
    hh = st["h"].reshape(b, n_heads, d // n_heads)
    r = p["r"] if r is None else r
    rec = torch.einsum("bhk,hkj->bhj", hh, r).reshape(b, 4 * d)
    zi, ii, ff, oo = (x_t.to(f32) + rec).chunk(4, dim=-1)
    zt, ot = torch.tanh(zi), torch.sigmoid(oo)
    logf = log_sigmoid(ff)
    m_new = torch.maximum(logf + st["m"], ii)
    ip = torch.exp(ii - m_new)
    fp = torch.exp(logf + st["m"] - m_new)
    c_new = fp * st["c"] + ip * zt
    n_new = fp * st["n"] + ip
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}, h_new


def slstm_forward(p: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    xw = _slstm_x(p, x)                                  # [B, S, 4d]
    r = _slstm_r(p, n_heads)
    st, hs = slstm_init_state(b, d, x.device), []
    for t in trips.steps(s):
        st, h = _slstm_step(p, st, xw[:, t], n_heads, r)
        hs.append(h)
    return trips.stack(hs, s, dim=1).to(x.dtype)


def slstm_decode(p: dict, x: torch.Tensor, st: dict, n_heads: int
                 ) -> tuple[torch.Tensor, dict]:
    """One step on the whole state (the caller gathers a rank's blocks)."""
    st, h = _slstm_step(p, st, _slstm_x(p, x)[:, 0], n_heads,
                        _slstm_r(p, n_heads))
    return h[:, None, :].to(x.dtype), st
