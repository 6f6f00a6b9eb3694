"""The recurrent and encoder-decoder families of the port vs the JAX
package, on the CPU: xlstm-350m (``models/xlstm.py``), hymba-1.5b
(``models/hybrid.py``) and seamless-m4t-large-v2 (``models/encdec.py``),
with ``models/frontends.py``, ``models/api.py``'s dispatch and
``launch/serve.dense_generate``.

Reduced configs (2 layers, d_model 64; xlstm with ``slstm_every=2`` so
that one block of each kind runs; hymba with one global layer and one
of window 8, whose ring wraps while decoding; seamless with 2 encoder
and 2 decoder layers).  Parameters are JAX's init carried over bit for
bit (``params.from_numpy``); inputs are made with numpy from a seed; the
JAX side is jitted with ``xla_allow_excess_precision`` off
(``tests/test_torch_decode.py``'s ``jit_exact``).

Tolerances, each from what the two packages do differently:

* logits and caches of the whole model (forward, prefill, each decode
  step): within 2 bf16 ULPs of the array's largest |value|
  (``test_torch_decode.py``'s bound; measured here 0-1.125);
* cache leaves from ``init_cache``: equal (structure, shape, dtype,
  value: zeros, and xLSTM's m = -inf and sLSTM's n = 1);
* the scalar loss: rtol 2e-4.  ``tests/test_torch_train.py`` holds 1e-4
  on yi-6b; here hymba's input to its second layer's norm differs in
  one of 1792 values (f32 sums of ``rmsnorm`` in another order), and
  that value moves both branches: measured 1.33e-4.  JAX's own default
  build (excess precision on) is 1.06e-4 from its exact build on the
  same input, so 1e-4 is tighter than the reference's own spread;
* gradients: relative Frobenius error per leaf <= 2e-2.  The transformer
  tests hold 1e-2; here hymba's Mamba branch runs its backward through
  f32 ``exp``, ``log1p`` and ``softplus`` (XLA's CPU versions are other
  polynomials than PyTorch's, a few f32 ULPs apart) and through the
  time scan: measured 1.29e-2 at worst (``x_proj``), every other leaf
  of the three families under 1e-2;
* greedy tokens of ``dense_generate`` against JAX's prefill/decode loop
  on the same params, prompts and frames: equal up to ties that
  ``serving/parity.GreedyParity`` reports (two logits within one bf16
  ULP);
* the port's own ``tests/test_models.py:87`` (prefill then one decode
  step against forward): 0.1 for xlstm, whose decode is the recurrent
  form of the parallel mLSTM, 2e-2 for the others, as there.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_arch as jax_arch
from repro.models import api as japi
from repro.models import frontends as JF
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch.serve import dense_generate
from repro_torch.models import api, frontends
from repro_torch.models.params import from_numpy, leaves, unflatten
from repro_torch.models.transformer import cache_bytes
from repro_torch.serving.parity import GreedyParity

from test_torch_decode import _f32, assert_model_ulps, jit_exact

CASES = {"xlstm-350m": {"slstm_every": 2}, "hymba-1.5b": {},
         "seamless-m4t-large-v2": {}}
PROMPT, STEPS, ENC = 10, 4, 12      # prompt, decode steps, encoder frames
LOSS_RTOL = 2e-4
GRAD_RTOL = 2e-2


@functools.lru_cache(maxsize=None)
def pair(name: str):
    """(JAX cfg, port cfg, JAX model, port model, JAX params, port params,
    jitted JAX functions)."""
    jcfg = jax_arch(name).reduced(**CASES[name])
    cfg = get_arch(name).reduced(**CASES[name])
    jm = japi.get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    fns = {"forward": jit_exact(jm.forward),
           "loss": jit_exact(jax.value_and_grad(jm.loss)),
           "prefill": jit_exact(jm.prefill, static_argnums=2),
           "decode": jit_exact(jm.decode_step)}
    return (jcfg, cfg, jm, api.get_model(cfg), jp,
            from_numpy(jax.tree.map(np.asarray, jp)), fns)


def inputs(name: str, seed: int = 3, s: int = PROMPT + STEPS):
    """(JAX batch, port batch, tokens): tokens and targets [2, s]; frames
    [2, ENC, D] for the encoder-decoder."""
    cfg = pair(name)[1]
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (2, s)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    tb = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt)}
    if cfg.is_encdec:
        e = (rng.standard_normal((2, ENC, cfg.d_model)) * 0.02).astype(
            np.float32)
        jb["enc_embeds"], tb["enc_embeds"] = jnp.asarray(e), \
            torch.from_numpy(e)
    return jb, tb, toks


def cut(batch: dict, n: int) -> dict:
    """The prompt's first ``n`` tokens (and the frames), no targets."""
    return {k: v[:, :n] if k == "tokens" else v for k, v in batch.items()
            if k != "targets"}


def tree_spec(tree) -> dict:
    """{path: (shape, dtype name)} of a tree of either package."""
    return {jax.tree_util.keystr(p): (tuple(leaf.shape),
                                      str(leaf.dtype).replace("torch.", ""))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# dispatch, init, frontends
# ---------------------------------------------------------------------------

def test_get_model_takes_every_config():
    """Every registry config gets the module JAX's ``get_model`` picks."""
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        mod = api.family_module(get_arch(name))
        want = japi.get_model(jax_arch(name)).init.func.__module__
        assert mod.__name__.split(".")[-1] == want.split(".")[-1], name
        assert isinstance(api.get_model(get_arch(name)), api.ModelAPI)
    with pytest.raises(ValueError, match="decoder-only transformer"):
        api.get_model(dataclasses.replace(get_arch("yi-6b"),
                                          attn_kind="none"))


@pytest.mark.parametrize("name", list(CASES))
def test_cli_serves_every_family(name, monkeypatch, capsys):
    """The serve CLI without a mode flag decodes each family densely."""
    import sys
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", name, "--smoke", "--device", "cpu", "--batch",
        "2", "--prompt-len", "5", "--gen", "3"])
    serve.main()
    assert "6 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", list(CASES))
def test_init_tree_matches_jax(name):
    """The port's init (a torch generator) makes JAX's tree: every block
    of xLSTM holds both cells' params, as JAX's ``vmap`` init makes
    them."""
    _, cfg, _, m, jp, _, _ = pair(name)
    tp = m.init(torch.Generator().manual_seed(0), "cpu")
    assert tree_spec(tp) == tree_spec(jp)


SHAPES = [("train", 16, 2, "train"), ("decode", 8192, 4, "decode"),
          ("prefill", 32, 1, "prefill")]


@pytest.mark.parametrize("name", list(CASES) + ["internvl2-76b", "yi-6b"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_frontends_match_jax(name, shape):
    """``batch_struct``, ``decode_struct`` and ``make_batch``: JAX's keys,
    shapes and dtypes (meta tensors where JAX has ShapeDtypeStructs);
    ``enc_len_for`` equal."""
    jcfg, cfg = jax_arch(name).reduced(), get_arch(name).reduced()
    jsh, sh = JShape(*shape), ShapeConfig(*shape)
    want = tree_spec(JF.batch_struct(jcfg, jsh))
    got = frontends.batch_struct(cfg, sh)
    assert all(t.device.type == "meta" for t in got.values())
    assert tree_spec(got) == want
    assert tree_spec(frontends.decode_struct(cfg, sh)) == tree_spec(
        JF.decode_struct(jcfg, jsh))
    made = frontends.make_batch(cfg, sh, torch.Generator().manual_seed(0))
    assert tree_spec(made) == want
    if cfg.frontend == "vision":
        assert float(made["loss_mask"][:, :cfg.n_frontend_embeds].sum()) == 0
    assert frontends.enc_len_for(cfg, sh) == JF.enc_len_for(jcfg, jsh)
    assert frontends.ENC_LEN_DECODE == JF.ENC_LEN_DECODE


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.0, 1e4])
def test_cross_attention_matches_jax(theta):
    """``gqa_forward`` with ``kv_x``/``kv_positions``, bidirectional: 11
    queries over a 7-row memory; theta 0 leaves K unroped.  Within 2 bf16
    ULPs elementwise, ``test_torch_decode.py``'s bound for one attention
    layer; ``kv`` given as (k, v) from ``gqa_kv`` equal to ``kv_x``."""
    from repro.models import attention as JA
    from repro_torch.models import attention as A
    from repro_torch.models.params import layer
    from test_torch_decode import _bf16_pair, assert_elementwise_ulps
    _, cfg, _, _, jp, tp, _ = pair("seamless-m4t-large-v2")
    jc = jax.tree.map(lambda a: a[1], jp["dec_blocks"]["cross"])
    tc = layer(tp["dec_blocks"], 1)["cross"]
    jx, tx = _bf16_pair((2, 11, cfg.d_model), 60)
    jm, tm = _bf16_pair((2, 7, cfg.d_model), 61)
    qpos, mpos = np.arange(11, dtype=np.int32), np.arange(7, dtype=np.int32)
    want = jit_exact(lambda p, x, m: JA.gqa_forward(
        p, x, jnp.asarray(qpos), causal=False, theta=theta, kv_x=m,
        kv_positions=jnp.asarray(mpos)))(jc, jx, jm)
    tq, tk = torch.from_numpy(qpos), torch.from_numpy(mpos)
    got = A.gqa_forward(tc, tx, tq, causal=False, theta=theta, kv_x=tm,
                        kv_positions=tk)
    assert_elementwise_ulps(got, want, 2)
    kv = A.gqa_kv(tc, tm, tk, theta=theta)
    assert torch.equal(A.gqa_forward(tc, tx, tq, causal=False, theta=theta,
                                     kv=kv, kv_positions=tk), got)
    if theta == 0.0:
        assert torch.equal(kv[0], A.L.linear(tc["wk"], tm))
    with pytest.raises(ValueError, match="exclusive"):
        A.gqa_forward(tc, tx, tq, kv=kv, kv_x=tm)


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_forward_loss_and_gradients_match_jax(name):
    _, _, _, m, jp, tp, fns = pair(name)
    jb, tb, _ = inputs(name)
    with torch.no_grad():
        assert_model_ulps(m.forward(tp, tb), fns["forward"](jp, jb))
    jloss, jgrads = fns["loss"](jp, jb)
    tl = [t.detach().requires_grad_() for t in leaves(tp)]
    loss = m.loss(unflatten(tp, tl), tb)
    grads = torch.autograd.grad(loss, tl)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(paths) == len(grads)
    for (path, w), g in zip(paths, grads):
        w, g = _f32(w), _f32(g)
        assert g.shape == w.shape
        n = np.linalg.norm(w)
        err = np.linalg.norm(g - w) / n if n else np.linalg.norm(g)
        assert err <= GRAD_RTOL, (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# caches, prefill, decode
# ---------------------------------------------------------------------------

def _init_caches(name: str):
    jcfg, cfg, jm, m, _, _, _ = pair(name)
    kw = {"enc_len": ENC} if cfg.is_encdec else {}
    return jm.init_cache(2, PROMPT + STEPS, **kw), m.init_cache(
        2, PROMPT + STEPS, device="cpu", **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_init_cache_matches_jax(name):
    want, got = _init_caches(name)
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for f, g, w in zip(got._fields, got, want):
        assert (tuple(g.shape), str(g.dtype).replace("torch.", "")) == (
            w.shape, str(w.dtype)), f
        np.testing.assert_array_equal(_f32(g), _f32(w), err_msg=f)
    assert cache_bytes(got) == sum(w.nbytes for w in want)


def _jax_decode(name, jb, toks):
    jp, fns = pair(name)[4], pair(name)[6]
    logits, cache = fns["prefill"](jp, cut(jb, PROMPT), PROMPT + STEPS)
    out = [logits]
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = fns["decode"](jp, cache, jnp.asarray(toks[:, i]),
                                      jnp.int32(i))
        out.append(logits)
    return out, cache


def _port_decode(name, tb, toks):
    m, tp = pair(name)[3], pair(name)[5]
    logits, cache = m.prefill(tp, cut(tb, PROMPT), PROMPT + STEPS)
    out = [logits]
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = m.decode_step(tp, cache, torch.from_numpy(toks[:, i]),
                                      i)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_match_jax(name):
    jb, tb, toks = inputs(name)
    want, wcache = _jax_decode(name, jb, toks)
    got, gcache = _port_decode(name, tb, toks)
    for g, w in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert_model_ulps(g, w)
    assert gcache._fields == wcache._fields
    for f, g, w in zip(gcache._fields, gcache, wcache):
        assert tuple(g.shape) == w.shape, f
        if f != "mm":                      # xLSTM's m: -inf in sLSTM layers
            assert_model_ulps(g, w)
    if name == "hymba-1.5b":               # the window-8 ring wrapped
        assert gcache.ring_k.shape[:3] == (1, 2, 8)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_decode_matches_forward(name):
    """The port's own ``tests/test_models.py:87``."""
    _, cfg, _, m, _, tp, _ = pair(name)
    _, full, toks = inputs(name, seed=4, s=12)
    with torch.no_grad():
        want = m.forward(tp, full).float()
    last, cache = m.prefill(tp, cut(full, 11), 12)
    step, _ = m.decode_step(tp, cache, torch.from_numpy(toks[:, -1]), 11)
    tol = 0.1 if cfg.family == "ssm" else 2e-2
    for g, w in ((last, want[:, -2]), (step, want[:, -1])):
        np.testing.assert_allclose(_f32(g), w.numpy(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# greedy generation against JAX's loop
# ---------------------------------------------------------------------------

GEN = {"xlstm-350m": dict(batch=2, prompt_len=12, gen=8),
       "hymba-1.5b": dict(batch=2, prompt_len=12, gen=8),
       "seamless-m4t-large-v2": dict(batch=2, prompt_len=10, gen=8)}


@pytest.mark.parametrize("name", list(GEN))
def test_generate_tokens_match_jax(name):
    """``dense_generate`` fed the prompts and frames JAX's ``generate``
    makes (its keys), against JAX's prefill/decode loop on them."""
    jcfg, cfg, _, _, jp, tp, fns = pair(name)
    b, s, gen = GEN[name]["batch"], GEN[name]["prompt_len"], GEN[name]["gen"]
    key = jax.random.PRNGKey(1)
    prompts = jax.random.randint(key, (b, s), 1, cfg.vocab, jnp.int32)
    jb = {"tokens": prompts}
    enc = None
    if cfg.is_encdec:
        jb["enc_embeds"] = jax.random.normal(key, (b, s, cfg.d_model)) * 0.02
        enc = torch.from_numpy(np.array(jb["enc_embeds"]))
    logits, cache = fns["prefill"](jp, jb, s + gen)
    toks = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [toks]
    for t in range(s, s + gen - 1):
        logits, cache = fns["decode"](jp, cache, toks, jnp.int32(t))
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(toks)
    want = np.stack([np.asarray(w) for w in want], axis=1).tolist()
    got = dense_generate(cfg, tp, torch.from_numpy(np.array(prompts)), gen,
                         enc_embeds=enc, keep_logits=True)
    assert np.shape(got["tokens"]) == np.shape(want) == (b, gen)
    assert got["cache_bytes"] > 0
    par = GreedyParity()
    for j in range(gen):
        par.check(j, {i: w[j] for i, w in enumerate(want)},
                  {i: g[j] for i, g in enumerate(got["tokens"])},
                  lambda sid, j=j: got["logits"][j, sid])
    print(f"{name}: {par.compared} tokens equal, ties {par.ties}")
    assert par.compared + len(par.ties) >= b * gen


def test_dense_generate_needs_frames_for_encdec():
    """JAX's ``generate`` feeds the encoder f32 frames; the port's takes
    them as an argument (``generate`` draws them from a seed)."""
    assert "enc_embeds" in inspect.signature(dense_generate).parameters
    cfg, tp = pair("seamless-m4t-large-v2")[1], pair(
        "seamless-m4t-large-v2")[5]
    with pytest.raises(ValueError, match="enc_embeds"):
        dense_generate(cfg, tp, torch.ones((1, 4), dtype=torch.int64), 2)
