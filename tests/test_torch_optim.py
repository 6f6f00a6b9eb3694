"""The port's AdamW (``repro_torch/optim/adamw.py``) vs the JAX package's,
on the CPU.

Both run on identical params, gradients and state, made with numpy from
a seed (bf16 weight leaves, an f32 norm leaf, a leaf whose last dim is
not a multiple of 128 and so stays f32 under the tile codecs).  The JAX
update runs eagerly, op by op as the port does; its
``bdi_value._pow2_scale`` is replaced, for these tests only, by the same
exponent arithmetic with 2^e built from bits (the port's construction):
moment scales sit far outside the range where XLA's CPU ``exp2`` is
exact (v is about g^2 / 127).

What must match:

* ``adamw_init``: every leaf, bit for bit, under each moment dtype;
* the port's live ``bdi8`` masks are the tile kernels' bit planes; a
  state is compared in JAX's byte layout (``adamw.export_state``), and
  JAX's state enters the port through ``adamw.import_state``;
* ``adamw_update`` with the clip idle (clip scale exactly 1): the whole
  state — step, m and v, the ``bdi8`` deltas, base, scale and byte-layout
  mask, the ``q8`` deltas and scale — bit for bit, and the params within
  one bf16 ULP (the bias corrections ``b ** step`` may differ by an f32
  ULP between XLA's and PyTorch's ``pow``; they reach only the params);
  the global norm within rtol 1e-6 (its sums run in another order);
* with the clip firing: the clip scale within rtol 1e-6 (it comes from
  the global norm, summed in another order, and scales every gradient),
  so every stored moment within 1e-5 of its leaf's largest magnitude of
  JAX's (bf16 moments 2^-7, two ULPs of their type; relative to the
  largest because a moment is a running sum that cancels near zero),
  plus one quantisation step of its tile where it is stored as tiles;
  the params within one bf16 ULP;
* the big-leaf path (rows of dim 0 in groups of at most ``BIG_LEAF``
  elements, reached by lowering ``BIG_LEAF``): the same bits as JAX's
  whole-leaf update.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import bdi_value as jbv
from repro.optim import adamw as JO
from repro_torch.core import bdi_value as bv
from repro_torch.kernels import ref
from repro_torch.models.params import from_numpy, to_numpy
from repro_torch.optim import adamw as O

DTYPES = ("f32", "bf16", "bdi8", "q8")


def _exact_pow2_scale(maxres, qmax):
    ratio = (maxres / qmax).astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(ratio, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0)
    s = jax.lax.bitcast_convert_type(
        jnp.where(e >= -126, (e + 127) << 23, 1 << 22).astype(jnp.int32),
        jnp.float32)
    return jnp.where(maxres > 0, s, jnp.float32(1.0))


@pytest.fixture(autouse=True)
def exact_jax_scale(monkeypatch):
    monkeypatch.setattr(jbv, "_pow2_scale", _exact_pow2_scale)


def _params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    bf = ml_dtypes.bfloat16
    return {"blocks": {"w": rng.standard_normal((3, 64, 256)).astype(bf),
                       "ln": (1 + 0.1 * rng.standard_normal((3, 64))
                              ).astype(np.float32)},
            "odd": rng.standard_normal((256, 40)).astype(bf)}


def _grads(step: int, scale: float) -> dict:
    """Gradients of step ``step``: zero-mean, with a few large and many
    tiny elements a tile, as real gradients have."""
    rng = np.random.default_rng(100 + step)

    def g(shape, dtype):
        x = rng.standard_normal(shape) * np.exp(rng.uniform(-6, 0, shape))
        return (x * scale).astype(dtype)
    bf = ml_dtypes.bfloat16
    return {"blocks": {"w": g((3, 64, 256), bf), "ln": g((3, 64),
                                                          np.float32)},
            "odd": g((256, 40), bf)}


def _flat(tree) -> list:
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port_np(tree) -> dict:
    return to_numpy(tree, ml_dtypes.bfloat16)


def _state_np(state) -> dict:
    """The port's state as JAX holds it."""
    return _port_np(O.export_state(state))


def _assert_bits_equal(got: dict, want) -> None:
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def _assert_bf16_ulp(got: dict, want) -> None:
    for (path, a), (_, b) in zip(_flat(got), _flat(want)):
        a, b = a.astype(np.float32), b.astype(np.float32)
        mag = np.maximum(np.abs(a), np.abs(b))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
        assert (np.abs(a - b) <= ulp).all(), path


def _run(md: str, clip: float, steps: int = 3):
    """``steps`` updates in both packages; returns their last params,
    states and metrics."""
    jcfg = JO.AdamWConfig(moment_dtype=md, grad_clip=clip)
    tcfg = O.AdamWConfig(moment_dtype=md, grad_clip=clip)
    jp = _jax_tree(_params())
    tp = from_numpy(_params())
    js, ts = JO.adamw_init(jp, jcfg), O.adamw_init(tp, tcfg)
    for step in range(steps):
        g = _grads(step, 1e-2 if clip > 1 else 1.0)
        jp, js, jm = JO.adamw_update(jp, _jax_tree(g), js, jcfg)
        tp, ts, tm = O.adamw_update(tp, from_numpy(g), ts, tcfg)
    return (jp, js, jm), (tp, ts, tm)


@pytest.mark.parametrize("md", DTYPES)
def test_adamw_init_matches_jax(md):
    jst = JO.adamw_init(_jax_tree(_params()), JO.AdamWConfig(moment_dtype=md))
    tst = O.adamw_init(from_numpy(_params()), O.AdamWConfig(moment_dtype=md))
    _assert_bits_equal(_state_np(tst), jst)
    assert O.opt_state_bytes(tst, O.AdamWConfig(moment_dtype=md)) == \
        JO.opt_state_bytes(jst, JO.AdamWConfig(moment_dtype=md))


@pytest.mark.parametrize("md", DTYPES)
def test_adamw_update_clip_idle_matches_jax_bit_for_bit(md):
    (jp, js, jm), (tp, ts, tm) = _run(md, clip=1e9)
    assert float(tm["clip_scale"]) == float(jm["clip_scale"]) == 1.0
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    _assert_bits_equal(_state_np(ts), js)
    _assert_bf16_ulp(_port_np(tp), jp)


@pytest.mark.parametrize("md", ["bdi8", "q8"])
def test_jax_state_continues_in_port(md):
    """JAX's params and state after two updates, carried over by
    ``params.from_numpy`` (the 0-d int32 step, the tile-store dicts) and
    ``adamw.import_state`` (byte-layout masks to bit planes), take the
    third update in the port with the same bits as in JAX."""
    cfg_j = JO.AdamWConfig(moment_dtype=md, grad_clip=1e9)
    jp = _jax_tree(_params())
    js = JO.adamw_init(jp, cfg_j)
    for step in range(2):
        jp, js, _ = JO.adamw_update(jp, _jax_tree(_grads(step, 1e-2)), js,
                                    cfg_j)
    tp = from_numpy(jax.tree.map(np.asarray, jp))
    ts = O.import_state(from_numpy(jax.tree.map(np.asarray, js)))
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    g = _grads(2, 1e-2)
    jp, js, _ = JO.adamw_update(jp, _jax_tree(g), js, cfg_j)
    tp, ts, _ = O.adamw_update(tp, from_numpy(g), ts,
                               O.AdamWConfig(moment_dtype=md, grad_clip=1e9))
    _assert_bits_equal(_state_np(ts), js)
    _assert_bf16_ulp(_port_np(tp), jp)


def _moments(state, params, md: str) -> list:
    """Every moment leaf loaded to f32 (by the JAX ``_load``), with its
    quantisation step per element (the tile's scale; 0 when not tiled)."""
    def is_store(x):
        return isinstance(x, dict) and "deltas" in x
    out = []
    for key in ("m", "v"):
        for s, p in zip(jax.tree.leaves(state[key], is_leaf=is_store),
                        jax.tree.leaves(params)):
            vals = np.asarray(JO._load(_jax_tree(s), md, np.shape(p)))
            step = (np.repeat(np.asarray(s["scale"]).reshape(-1), 128)
                    if is_store(s) else np.zeros(vals.size, np.float32))
            out.append((vals.reshape(-1), step))
    return out


@pytest.mark.parametrize("md", DTYPES)
def test_adamw_update_clip_firing_matches_jax(md):
    (jp, js, jm), (tp, ts, tm) = _run(md, clip=1.0)
    assert float(jm["clip_scale"]) < 0.5
    np.testing.assert_allclose(float(tm["clip_scale"]),
                               float(jm["clip_scale"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    rtol = 2.0 ** -7 if md == "bf16" else 1e-5
    for (g, qg), (w, qw) in zip(_moments(_state_np(ts), jp, md),
                                _moments(js, jp, md)):
        assert (np.abs(g - w) <= np.maximum(qg, qw)
                + rtol * np.abs(w).max()).all()
    _assert_bf16_ulp(_port_np(tp), jp)


@pytest.mark.parametrize("md", DTYPES)
def test_big_leaves_update_in_row_groups(md, monkeypatch):
    """With ``BIG_LEAF`` at 2^10 every leaf of >= 1024 elements updates in
    groups of rows (one row of [3, 64, 256], 25 rows of [256, 40]); JAX
    updates them whole.  Same bits."""
    monkeypatch.setattr(O, "BIG_LEAF", 1 << 10)
    seen = []
    groups = O._groups

    def spy(t):
        out = groups(t)
        seen.append((tuple(t.shape), len(out)))
        return out
    monkeypatch.setattr(O, "_groups", spy)
    (jp, js, _), (tp, ts, _) = _run(md, clip=1e9, steps=2)
    assert ((3, 64, 256), 3) in seen and ((256, 40), 11) in seen
    _assert_bits_equal(_state_np(ts), js)
    _assert_bf16_ulp(_port_np(tp), jp)


def test_bdi8_lost_second_moment_moves_as_in_jax():
    """Kept from the reference on purpose: bdi8 stores v in int8 steps of
    its tile's range, so a small v next to a large one loads as 0 while
    its m survives; when that element's next gradient is 0 it moves by lr
    * m / eps.  Both packages move it by the same amount (277.5 here),
    over 10^5 times what f32 moments move it by (5.0e-4 over the two
    steps)."""
    g1 = np.zeros((1, 128), np.float32)
    g1[0, :3] = [0.5, 0.02, 1.0]           # element 2 sets v's tile step
    g2 = g1.copy()
    g2[0, 1] = 0.0                         # element 1: no gradient now
    moved = {}
    for md in ("bdi8", "f32"):
        jcfg = JO.AdamWConfig(moment_dtype=md, grad_clip=0.0,
                              weight_decay=0.0)
        tcfg = O.AdamWConfig(moment_dtype=md, grad_clip=0.0,
                             weight_decay=0.0)
        jp = {"w": jnp.zeros((1, 128), jnp.float32)}
        tp = {"w": torch.zeros((1, 128))}
        js, ts = JO.adamw_init(jp, jcfg), O.adamw_init(tp, tcfg)
        for g in (g1, g2):
            jp, js, _ = JO.adamw_update(jp, {"w": jnp.asarray(g)}, js, jcfg)
            tp, ts, _ = O.adamw_update(tp, {"w": torch.from_numpy(g)}, ts,
                                       tcfg)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6)
        if md == "bdi8":
            assert float(_load_v(ts)[0, 1]) == 0.0
        moved[md] = abs(float(tp["w"][0, 1]))
    assert moved["bdi8"] > 1e5 * moved["f32"] > 0


def _load_v(state) -> torch.Tensor:
    return O._load(state["v"]["w"], (1, 128))


def test_mask_layouts_convert_both_ways():
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((57, 128)) < 0.4)
    bitplane = ref.pack_mask_bitplane(mask)
    assert torch.equal(O.to_byte_mask(bitplane), bv.pack_mask(mask))
    assert torch.equal(O.to_bitplane_mask(bv.pack_mask(mask)), bitplane)
    np.testing.assert_array_equal(
        bv.pack_mask(mask).numpy(), np.asarray(jbv.pack_mask(
            jnp.asarray(mask.numpy()))))


# ---------------------------------------------------------------------------
# the JAX package's optimizer tests (tests/test_substrate.py), on the port
# ---------------------------------------------------------------------------

def _quad_problem():
    target = torch.tensor([1.0, -2.0, 3.0, 0.5] * 32)
    params = {"w": torch.zeros(128)}

    def loss(p):
        return ((p["w"] - target) ** 2).mean()
    return params, loss


def _grad(loss, params):
    w = params["w"].detach().requires_grad_()
    return {"w": torch.autograd.grad(loss({"w": w}), w)[0]}


@pytest.mark.parametrize("md", DTYPES)
def test_adamw_converges(md):
    params, loss = _quad_problem()
    cfg = O.AdamWConfig(lr=5e-2, weight_decay=0.0, moment_dtype=md)
    state = O.adamw_init(params, cfg)
    for _ in range(300):
        params, state, _ = O.adamw_update(params, _grad(loss, params),
                                          state, cfg)
    assert float(loss(params)) < 1e-2


def test_bdi8_moments_match_f32_trajectory():
    params_a, loss = _quad_problem()
    params_b = {"w": params_a["w"].clone()}
    ca = O.AdamWConfig(lr=1e-2, weight_decay=0.0, moment_dtype="f32")
    cb = O.AdamWConfig(lr=1e-2, weight_decay=0.0, moment_dtype="bdi8")
    sa, sb = O.adamw_init(params_a, ca), O.adamw_init(params_b, cb)
    for _ in range(50):
        params_a, sa, _ = O.adamw_update(params_a, _grad(loss, params_a),
                                         sa, ca)
        params_b, sb, _ = O.adamw_update(params_b, _grad(loss, params_b),
                                         sb, cb)
    np.testing.assert_allclose(params_a["w"].numpy(), params_b["w"].numpy(),
                               atol=5e-2)


def test_grad_clipping():
    params = {"w": torch.zeros(4)}
    cfg = O.AdamWConfig(grad_clip=1.0, weight_decay=0.0)
    state = O.adamw_init(params, cfg)
    _, _, metrics = O.adamw_update(params, {"w": torch.full((4,), 100.0)},
                                   state, cfg)
    assert float(metrics["grad_norm"]) > 100
    assert float(metrics["clip_scale"]) < 0.01
