"""The port's sequence mixers (``repro_torch/models/ssm.py``) vs the JAX
package, on the CPU.

Two parts:

* twins of ``tests/test_ssm.py``'s six tests on the port, in f32 with the
  same shapes and tolerances: the parallel mLSTM equals the recurrent
  one, Mamba's scan equals its step, ``return_state`` continues decode,
  sLSTM's scan equals its step, a closed forget gate forgets, and the
  chunked scan equals the sequential one (the port's log-depth scan
  combines in another order than XLA's ``associative_scan``, so both
  are held to ``test_ssm.py``'s 2e-4);
* each function against its JAX counterpart on the same inputs: JAX's
  bf16 params carried over bit for bit (``params.from_numpy``), inputs
  made with numpy from a seed, the JAX side jitted with
  ``xla_allow_excess_precision`` off (``tests/test_torch_decode.py``'s
  ``jit_exact``).

Tolerances, each from what the two packages do differently:

* bf16 results of bf16 products and sums that both packages round the
  same way (the causal conv, Mamba's conv tail, the gate projections):
  bit-equal;
* f32 results of f32 transcendental functions (``softplus``,
  ``log_sigmoid``, the discretised ``dA``/``dBu``): XLA's CPU ``exp``,
  ``log1p`` and ``tanh`` are other polynomials than PyTorch's and differ
  by a few f32 ULPs: rtol 1e-6 of the largest |value| (1e-6 is 8 f32
  ULPs);
* f32 states after a scan or a recurrent step (Mamba's h, mLSTM's C, n,
  m, sLSTM's h, c, n, m): rtol 1e-5 of the largest |value| (f32 sums in
  another order, those ULPs carried through the steps);
* a mixer's bf16 output: within 2 bf16 ULPs of the array's largest
  |value| (``test_torch_decode.py``'s whole-model bound: one input
  value that rounds the other way moves every output it feeds);
* ``mlstm_decode``'s first step from m = -inf: finite, and its new m
  equals i_t exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as S
from repro_torch.models.params import from_numpy, tree_map

from test_torch_decode import (_f32, assert_elementwise_ulps,
                               assert_model_ulps, jit_exact)

F32_TRANSCENDENTAL_RTOL = 1e-6
F32_STATE_RTOL = 1e-5


def assert_rel(got, want, rtol: float) -> None:
    """``got`` within ``rtol`` of the largest |want|, elementwise."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    err = np.abs(g - w).max()
    assert err <= rtol * max(np.abs(w).max(), 1e-30), (err, np.abs(w).max())


def assert_bits(got, want) -> None:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# twins of tests/test_ssm.py (f32)
# ---------------------------------------------------------------------------

def _f32_params(p: dict) -> dict:
    return tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                    p)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _normal(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_mlstm_parallel_matches_recurrent():
    d, h, b, s = 32, 4, 2, 24
    p = _f32_params(S.init_mlstm(_gen(0), d, h, device="cpu"))
    x = _normal((b, s, d), 1)
    y_par = S.mlstm_forward(p, x, h, chunk=8)
    st = S.mlstm_init_state(b, h, (2 * d) // h, "cpu")
    ys = []
    for t in range(s):
        y, st = S.mlstm_decode(p, x[:, t:t + 1], st, h)
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-4)


def _mamba_steps(p, x, n):
    b, s, _ = x.shape
    di = p["conv_w"].shape[1]
    h = torch.zeros((b, di, n))
    conv = torch.zeros((b, p["conv_w"].shape[0] - 1, di))
    ys = []
    for t in range(s):
        y, h, conv = S.mamba_decode(p, x[:, t:t + 1], h, conv, n)
        ys.append(y)
    return torch.cat(ys, 1)


def test_mamba_scan_matches_step():
    d, di, n, b, s = 16, 32, 4, 2, 12
    p = _f32_params(S.init_mamba(_gen(0), d, di, n, device="cpu"))
    x = _normal((b, s, d), 1)
    np.testing.assert_allclose(S.mamba_forward(p, x, n).numpy(),
                               _mamba_steps(p, x, n).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_mamba_forward_state_continues_decode():
    d, di, n, b, s = 16, 32, 4, 2, 10
    p = _f32_params(S.init_mamba(_gen(2), d, di, n, device="cpu"))
    x = _normal((b, s + 1, d), 3)
    _, h, conv = S.mamba_forward(p, x[:, :s], n, return_state=True)
    y_next, _, _ = S.mamba_decode(p, x[:, s:s + 1], h, conv, n)
    y_full = S.mamba_forward(p, x, n)
    np.testing.assert_allclose(y_next[:, 0].numpy(), y_full[:, s].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_slstm_scan_matches_step():
    d, h, b, s = 32, 4, 2, 12
    p = _f32_params(S.init_slstm(_gen(0), d, h, device="cpu"))
    x = _normal((b, s, d), 1)
    y_full = S.slstm_forward(p, x, h)
    st = S.slstm_init_state(b, d, "cpu")
    ys = []
    for t in range(s):
        y, st = S.slstm_decode(p, x[:, t:t + 1], st, h)
        ys.append(y)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_mlstm_decay_actually_forgets():
    d, h, b = 16, 2, 1
    p = _f32_params(S.init_mlstm(_gen(0), d, h, device="cpu"))
    p["w_if"]["b"][h:] = -20.0                           # forget ~0
    x = _normal((b, 8, d), 1)
    x2 = x.clone()
    x2[:, 0] += 10.0
    y1, y2 = S.mlstm_forward(p, x, h), S.mlstm_forward(p, x2, h)
    d_last = float((y1[:, -1] - y2[:, -1]).abs().max())
    d_first = float((y1[:, 0] - y2[:, 0]).abs().max())
    assert d_last < 1e-3 * max(d_first, 1.0)


def test_mamba_chunked_scan_matches_sequential(monkeypatch):
    d, di, n, b, s = 16, 32, 4, 2, 50   # s not a multiple of the chunk
    p = _f32_params(S.init_mamba(_gen(4), d, di, n, device="cpu"))
    x = _normal((b, s, d), 5)
    y_seq, h_ref, conv_ref = S.mamba_forward(p, x, n, return_state=True)
    monkeypatch.setattr(S, "CHUNKED_SCAN", True)
    monkeypatch.setattr(S, "SCAN_CHUNK", 16)
    y_chk, h, conv = S.mamba_forward(p, x, n, return_state=True)
    np.testing.assert_allclose(y_seq.numpy(), y_chk.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(conv.numpy(), conv_ref.numpy())


# ---------------------------------------------------------------------------
# each function against JAX's
# ---------------------------------------------------------------------------

D, DI, N, H, B, SEQ = 32, 64, 4, 4, 2, 13


@functools.lru_cache(maxsize=None)
def jax_params(kind: str):
    """(JAX params, the port's copy of their bits)."""
    key = jax.random.PRNGKey({"mamba": 0, "mlstm": 1, "slstm": 2}[kind])
    p = {"mamba": lambda: JS.init_mamba(key, D, DI, N),
         "mlstm": lambda: JS.init_mlstm(key, D, H),
         "slstm": lambda: JS.init_slstm(key, D, H)}[kind]()
    return p, from_numpy(jax.tree.map(np.asarray, p))


def bf16_pair(shape, seed: int, scale: float = 1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()


def f32_pair(shape, seed: int, scale: float = 1.0):
    x = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def tree_spec(tree) -> dict:
    """{path: (shape, dtype name)} of a params tree of either package."""
    return {jax.tree_util.keystr(p): (tuple(leaf.shape),
                                      str(leaf.dtype).replace("torch.", ""))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_init_tree_matches_jax(kind):
    """The port's init makes JAX's tree: keys, shapes and dtypes; the
    deterministic leaves (A's log, the skip, zero biases) equal."""
    jp, _ = jax_params(kind)
    tp = {"mamba": lambda: S.init_mamba(_gen(0), D, DI, N, device="cpu"),
          "mlstm": lambda: S.init_mlstm(_gen(0), D, H, device="cpu"),
          "slstm": lambda: S.init_slstm(_gen(0), D, H, device="cpu")}[kind]()
    assert tree_spec(tp) == tree_spec(jp)
    if kind == "mamba":
        for key in ("a_log", "d_skip", "conv_b"):
            assert_bits(tp[key], jp[key])
        assert abs(float(tp["conv_w"].float().std()) - 0.1) < 0.02


def test_activations_match_jax():
    jx, tx = f32_pair((4096,), 40, 6.0)
    for got, want in ((S.softplus(tx), jax.nn.softplus(jx)),
                      (S.log_sigmoid(tx), jax.nn.log_sigmoid(jx)),
                      (S.silu(tx), jax.nn.silu(jx))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TRANSCENDENTAL_RTOL,
                                   atol=F32_TRANSCENDENTAL_RTOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_bit_equal(with_state):
    jp, tp = jax_params("mamba")
    ju, tu = bf16_pair((B, SEQ, DI), 41)
    js, ts = bf16_pair((B, 3, DI), 42) if with_state else (None, None)
    want = jit_exact(JS._causal_conv)(ju, jp["conv_w"], jp["conv_b"] + 0.25,
                                      js)
    got = S._causal_conv(tu, tp["conv_w"], tp["conv_b"] + 0.25, ts)
    assert got.dtype == torch.bfloat16
    assert_bits(got, want)


def test_mamba_ssm_inputs_match_jax():
    jp, tp = jax_params("mamba")
    ju, tu = bf16_pair((B, SEQ, DI), 43)
    want = jit_exact(lambda p, u: JS._mamba_ssm_inputs(p, u, N))(jp, ju)
    for g, w in zip(S._mamba_ssm_inputs(tp, tu, N), want):
        assert g.dtype == torch.float32
        assert_rel(g, w, F32_TRANSCENDENTAL_RTOL)


def test_chunked_scan_matches_jax(monkeypatch):
    """The port's chunked scan against JAX's ``_scan_chunked`` (XLA's
    ``associative_scan``) on the same f32 inputs, 50 steps in chunks of
    16 (the last one short)."""
    rng = np.random.default_rng(44)
    da = rng.uniform(0.5, 1.0, (B, 50, DI, N)).astype(np.float32)
    dbu = rng.standard_normal((B, 50, DI, N)).astype(np.float32)
    c = rng.standard_normal((B, 50, N)).astype(np.float32)
    h0 = rng.standard_normal((B, DI, N)).astype(np.float32)
    monkeypatch.setattr(S, "SCAN_CHUNK", 16)
    old = JS.SCAN_CHUNK
    JS.SCAN_CHUNK = 16
    try:
        wh, wy = JS._scan_chunked(*(jnp.asarray(a) for a in (da, dbu, c, h0)))
    finally:
        JS.SCAN_CHUNK = old
    gh, gy = S._scan_chunked(*(torch.from_numpy(a) for a in (da, dbu, c, h0)))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("scan", ["sequential", "chunked"])
def test_mamba_forward_matches_jax(scan, monkeypatch):
    jp, tp = jax_params("mamba")
    jx, tx = bf16_pair((B, SEQ, D), 45)
    if scan == "chunked":
        monkeypatch.setattr(S, "CHUNKED_SCAN", True)
        monkeypatch.setattr(S, "SCAN_CHUNK", 4)
    want = jit_exact(lambda p, x: JS.mamba_forward(p, x, N,
                                                   return_state=True))(jp, jx)
    got = S.mamba_forward(tp, tx, N, return_state=True)
    assert_model_ulps(got[0], want[0])
    assert_rel(got[1], want[1], F32_STATE_RTOL if scan == "sequential"
               else 2e-4)
    assert_bits(got[2], want[2])


def test_mamba_decode_matches_jax():
    jp, tp = jax_params("mamba")
    jx, tx = bf16_pair((B, 1, D), 46)
    jh, th = f32_pair((B, DI, N), 47)
    jc, tc = bf16_pair((B, 3, DI), 48)
    want = jit_exact(lambda p, x, h, c: JS.mamba_decode(p, x, h, c, N))(
        jp, jx, jh, jc)
    got = S.mamba_decode(tp, tx, th, tc, N)
    assert_model_ulps(got[0], want[0])
    assert_rel(got[1], want[1], F32_STATE_RTOL)
    assert_bits(got[2], want[2])


def test_mlstm_qkvif_matches_jax():
    """q, k, v and z: bf16 projections within one bf16 ULP elementwise
    (``tests/test_torch_layers.py``'s bound for ``linear``), k divided by
    sqrt(dh) rounded to bf16; the input and forget gates f32 products of
    f32 weights, rtol 1e-5 of the largest (f32 sums in another order)."""
    jp, tp = jax_params("mlstm")
    jx, tx = bf16_pair((B, SEQ, D), 49)
    want = jit_exact(lambda p, x: JS._mlstm_qkvif(p, x, H))(jp, jx)
    got = S._mlstm_qkvif(tp, tx, H)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (3, 4):
            assert g.dtype == torch.float32
            assert_rel(g, w, F32_STATE_RTOL)
        else:
            assert g.dtype == torch.bfloat16
            assert_elementwise_ulps(g, w, 1)


def test_mlstm_key_scale_is_bf16():
    """At dh 512 (xlstm-350m) the keys are divided by 22.625, sqrt(512)
    rounded to bf16, not by 22.627."""
    eye = torch.eye(2048, dtype=torch.bfloat16)
    p = {"up": {"w": torch.ones((4, 2048), dtype=torch.bfloat16)},
         "gate_z": {"w": torch.ones((4, 2048), dtype=torch.bfloat16)},
         "wq": {"w": eye}, "wk": {"w": eye}, "wv": {"w": eye},
         "w_if": {"w": torch.zeros((2048, 8)), "b": torch.zeros(8)}}
    x = torch.ones((1, 1, 4), dtype=torch.bfloat16)
    k = S._mlstm_qkvif(p, x, 4)[1]
    assert float(k[0, 0, 0, 0]) == float(torch.tensor(4.0 / 22.625).bfloat16())


def test_mlstm_forward_matches_jax():
    jp, tp = jax_params("mlstm")
    jx, tx = bf16_pair((B, SEQ, D), 50)
    for chunk in (512, 5):
        want = jit_exact(lambda p, x: JS.mlstm_forward(p, x, H, chunk=chunk)
                         )(jp, jx)
        assert_model_ulps(S.mlstm_forward(tp, tx, H, chunk=chunk), want)


def test_mlstm_decode_matches_jax():
    """Two steps from the initial state: the first from m = -inf (no NaN),
    the second from the state the first left."""
    jp, tp = jax_params("mlstm")
    dh = 2 * D // H
    jst = JS.mlstm_init_state(B, H, dh)
    tst = S.mlstm_init_state(B, H, dh, "cpu")
    step = jit_exact(lambda p, x, st: JS.mlstm_decode(p, x, st, H))
    for i in range(2):
        jx, tx = bf16_pair((B, 1, D), 51 + i)
        jy, jst = step(jp, jx, jst)
        ty, tst = S.mlstm_decode(tp, tx, tst, H)
        assert torch.isfinite(ty.float()).all()
        assert_model_ulps(ty, jy)
        for key in ("C", "n", "m"):
            assert torch.isfinite(tst[key]).all()
            assert_rel(tst[key], jst[key], F32_STATE_RTOL)
        if i == 0:
            _, _, _, i_pre, _, _ = S._mlstm_qkvif(tp, tx, H)
            assert torch.equal(tst["m"], i_pre[:, 0])


def test_slstm_forward_matches_jax():
    jp, tp = jax_params("slstm")
    jx, tx = bf16_pair((B, SEQ, D), 53)
    want = jit_exact(lambda p, x: JS.slstm_forward(p, x, H))(jp, jx)
    got = S.slstm_forward(tp, tx, H)
    assert got.dtype == torch.bfloat16
    assert_model_ulps(got, want)


def test_slstm_decode_matches_jax():
    jp, tp = jax_params("slstm")
    jst, tst = JS.slstm_init_state(B, D), S.slstm_init_state(B, D, "cpu")
    step = jit_exact(lambda p, x, st: JS.slstm_decode(p, x, st, H))
    for i in range(3):
        jx, tx = bf16_pair((B, 1, D), 54 + i)
        jy, jst = step(jp, jx, jst)
        ty, tst = S.slstm_decode(tp, tx, tst, H)
        assert_model_ulps(ty, jy)
        for key in ("h", "c", "n", "m"):
            assert_rel(tst[key], jst[key], F32_STATE_RTOL)
