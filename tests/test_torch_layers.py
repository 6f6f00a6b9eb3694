"""The port's model layers vs the JAX package on the reduced yi-6b config.

Inputs are made with numpy from a seed and go through both; parameters
are the JAX init carried over bit-exactly.  Tolerances:

* bf16 outputs: at most one bf16 ULP apart elementwise.  Both sides
  accumulate in f32 and round once to bf16, but XLA's and PyTorch's CPU
  kernels sum in different orders, so a value near a rounding boundary
  can land on either neighbour.
* f32 outputs (rope angles): 2 f32 ULPs (rtol 2.4e-7) — XLA and PyTorch
  use different cos/sin/pow implementations.
* the embedding gather is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_arch
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.api import get_model
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import from_numpy, layer
from repro_torch.models.transformer import init_params


@pytest.fixture(scope="module")
def model():
    jcfg = jax_arch("yi-6b").reduced(n_layers=2, d_model=64)
    jparams = get_model(jcfg).init(jax.random.PRNGKey(0))
    params = from_numpy(jax.tree.map(np.asarray, jparams))
    cfg = get_arch("yi-6b").reduced(n_layers=2, d_model=64)
    return cfg, jax.tree.map(lambda a: a[1], jparams["blocks"]), jparams, \
        layer(params["blocks"], 1), params


def _bf16_pair(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale)
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)


def assert_bf16_ulp(got: torch.Tensor, want, ulps: int = 1):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert (np.abs(g - w) <= ulps * ulp).all(), np.abs(g - w).max()


def test_rmsnorm(model):
    _, jb, _, tb, _ = model
    jx, tx = _bf16_pair((4, 9, 64), 0, 3.0)
    assert_bf16_ulp(L.rmsnorm(tb["ln1"], tx), JL.rmsnorm(jb["ln1"], jx))


@pytest.mark.parametrize("name", ["wq", "wk", "wv"])
def test_linear_head_projections(model, name):
    _, jb, _, tb, _ = model
    jx, tx = _bf16_pair((4, 9, 64), 1)
    assert_bf16_ulp(L.linear(tb["attn"][name], tx),
                    JL.linear(jb["attn"][name], jx))


def test_rope(model):
    cfg = model[0]
    pos = np.random.default_rng(2).integers(0, 4096, (3, 7)).astype(np.int32)
    jc, js = JL.rope_angles(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    tc, ts = L.rope_angles(torch.from_numpy(pos), cfg.head_dim,
                           cfg.rope_theta)
    for g, w in ((tc, jc), (ts, js)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2.4e-7,
                                   atol=2.4e-7)
    # apply_rope rotates interleaved (even, odd) pairs; feed both sides the
    # same angles so only the rotation itself is compared
    jx, tx = _bf16_pair((3, 7, 4, cfg.head_dim), 3)
    assert_bf16_ulp(L.apply_rope(tx, tc[:, :, None, :], ts[:, :, None, :]),
                    JL.apply_rope(jx, jnp.asarray(tc.numpy())[:, :, None, :],
                                  jnp.asarray(ts.numpy())[:, :, None, :]))


def test_mlp(model):
    _, jb, _, tb, _ = model
    jx, tx = _bf16_pair((4, 9, 64), 4)
    assert_bf16_ulp(L.mlp(tb["ffn"], tx), JL.mlp(jb["ffn"], jx))


def test_embed_and_lm_logits(model):
    cfg, _, jp, _, tp = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 11))
    np.testing.assert_array_equal(
        L.embed(tp["embed"], torch.from_numpy(toks)).view(torch.int16)
        .numpy(),
        np.asarray(JL.embed(jp["embed"], jnp.asarray(toks))).view(np.int16))
    jx, tx = _bf16_pair((3, 11, 64), 6)
    assert_bf16_ulp(L.lm_logits(tp["lm_head"], tx),
                    JL.lm_logits(jp["lm_head"], jx))


def test_proj_out(model):
    _, jb, _, tb, _ = model
    jx, tx = _bf16_pair((4, 9, 4, 16), 7)
    assert_bf16_ulp(A._proj_out(tb["attn"], tx), JA._proj_out(jb["attn"], jx))


@pytest.mark.parametrize("per_row", [False, True])
def test_gqa_kv(model, per_row):
    cfg, jb, _, tb, _ = model
    jx, tx = _bf16_pair((3, 9, 64), 8)
    rng = np.random.default_rng(9)
    pos = (rng.integers(0, 500, (3, 9)) if per_row
           else np.arange(9) + 40).astype(np.int32)
    jk, jv = JA.gqa_kv(jb["attn"], jx, jnp.asarray(pos), cfg.rope_theta)
    tk, tv = A.gqa_kv(tb["attn"], tx, torch.from_numpy(pos), cfg.rope_theta)
    assert_bf16_ulp(tk, jk)
    assert_bf16_ulp(tv, jv)


def test_params_bridge_round_trips_bf16_bit_exact(model):
    _, _, jp, _, tp = model
    jl = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jl:
        t = tp
        for k in path:
            t = t[k.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape, path
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def test_torch_native_init_has_the_jax_layout(model):
    """Same tree, shapes and dtypes as the JAX init; values from a
    torch.Generator (so not the JAX numbers), deterministic per seed."""
    cfg, _, jp, _, _ = model
    a = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jl:
        ta, tb_ = a, b
        for k in path:
            ta, tb_ = ta[k.key], tb_[k.key]
        assert tuple(ta.shape) == leaf.shape, path
        assert str(ta.dtype).removeprefix("torch.") == str(leaf.dtype), path
        assert torch.equal(ta, tb_)
    wq = a["blocks"]["attn"]["wq"]["w"].float()
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02   # N(0, 1/fan_in)
