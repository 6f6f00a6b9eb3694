"""The port's MoE and MLA vs the JAX package, on the CPU.

``models/moe.py`` (routing, capacity dispatch, experts, combine, shared
experts, the load-balance loss), arctic's dense residual FFN
(``transformer._ffn_apply``), ``models/attention.py``'s MLA
(``mla_forward``, the absorbed ``mla_decode``, ``mla_prefill_cache``),
and training of deepseek-v2-lite-16b and arctic-480b, held against the
JAX package on their reduced configs.  Parameters are the JAX init
carried over bit for bit; inputs are made with numpy from a seed.  The
JAX side runs in process; the whole-model loss and gradients are jitted
with ``xla_allow_excess_precision`` off (``test_torch_decode.jit_exact``).

Tolerances, each from what the two packages do differently:

* routing: gates within 1e-6 relative, expert indices equal.  XLA's and
  PyTorch's softmax may differ in the last f32 bits, so a choice may
  flip only where the two competing probabilities lie within 2 f32 ULPs;
  such a flip is reported (printed) and its token left out of the
  comparisons that follow from it;
* MoE outputs in f32 (``_moe_local``): within 2 bf16 ULPs of the largest
  |value| (the SwiGLU hidden state is rounded once to bf16 before the
  down projection; a value on a rounding boundary lands on either side);
* bf16 outputs of one layer (``moe_ffn``, the dense residual): within
  2 bf16 ULPs elementwise, as ``tests/test_torch_train.py`` holds
  ``gqa_forward``; MLA's outputs within 2 bf16 ULPs of their largest
  |value| (its output projection sums values up to ~14 to small ones: a
  quarter-ULP difference of the large values is 20 ULPs of a result
  near 0.007, measured here);
* caches written by one layer (the latent and its roped key): within one
  bf16 ULP elementwise;
* the load-balance loss: rtol 1e-6;
* loss and gradients of the whole model, on one pipeline batch of 3 x 24
  tokens: ``tests/test_torch_train.py``'s bounds, loss rtol 1e-4 and each
  gradient leaf within a relative Frobenius error of 1e-2 (measured:
  loss 2.2e-6 for deepseek).  The loss bound is tight for bf16 logits:
  on 4 x 32 tokens one hidden value of deepseek's that rounds one bf16
  ULP apart at position 18 moves the logits after it by up to 1.6 ULPs
  and the loss by 1.2e-4 relative.  ``train()``'s step is held on the
  loss test's batch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as TP
from repro_torch.launch.train import train
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.params import layer, leaves
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import export_state
from test_torch_decode import (_bf16_pair, _f32, _ulp, assert_elementwise_ulps,
                               assert_model_ulps, jit_exact, pair)

MOE = ("deepseek-v2-lite-16b", "arctic-480b")


def _block(name: str):
    """(cfg, JAX block 0, port block 0) of ``name``'s reduced config."""
    _, cfg, _, _, jp, tp = pair(name)
    return cfg, jax.tree.map(lambda a: a[0], jp["blocks"]), \
        layer(tp["blocks"], 0)


def _x2d(cfg, t: int, seed: int):
    return _bf16_pair((t, cfg.d_model), seed)


def _f32_ulp(v: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(v).astype(np.float32))


def route_flips(cfg, jb, tb, jx, tx) -> list[tuple[int, int]]:
    """Compare ``_route`` of both packages: gates within 1e-6 relative;
    every (token, choice) whose expert differs must be a near-tie (the
    two experts' probabilities within 2 f32 ULPs in the port), returned
    for the report."""
    jg, ji = JM._route(jb["ffn"]["router"], jx, cfg.top_k, cfg.n_experts)
    tg, ti = M._route(tb["ffn"]["router"], tx, cfg.top_k, cfg.n_experts)
    jg, ji, tg, ti = np.asarray(jg), np.asarray(ji), tg.numpy(), ti.numpy()
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=0)
    probs = M._probs(tb["ffn"]["router"], tx).numpy()
    flips = []
    for tok, k in zip(*np.nonzero(ti != ji)):
        pa, pb = probs[tok, ti[tok, k]], probs[tok, ji[tok, k]]
        assert abs(pa - pb) <= 2 * _f32_ulp(max(pa, pb)), (tok, k, pa, pb)
        flips.append((int(tok), int(k)))
    if flips:
        print(f"{cfg.name}: near-tie routing flips at {flips}")
    return flips


@pytest.mark.parametrize("name", MOE)
def test_route_matches_jax(name):
    cfg, jb, tb = _block(name)
    jx, tx = _x2d(cfg, 96, 40)
    route_flips(cfg, jb, tb, jx, tx)


def test_route_takes_ties_in_index_order():
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1, in order, with equal gates."""
    cfg, jb, tb = _block("deepseek-v2-lite-16b")
    jr = jax.tree.map(jnp.zeros_like, jb["ffn"]["router"])
    tr = {k: torch.zeros_like(v) for k, v in tb["ffn"]["router"].items()}
    jx, tx = _x2d(cfg, 5, 41)
    jg, ji = JM._route(jr, jx, cfg.top_k, cfg.n_experts)
    tg, ti = M._route(tr, tx, cfg.top_k, cfg.n_experts)
    want = np.tile(np.arange(cfg.top_k), (5, 1))
    np.testing.assert_array_equal(np.asarray(ji), want)
    np.testing.assert_array_equal(ti.numpy(), want)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("capacity", [8, None])    # None: dropless
def test_moe_local_matches_jax(name, capacity):
    cfg, jb, tb = _block(name)
    t = 64
    cap = t * cfg.top_k if capacity is None else capacity
    jx, tx = _x2d(cfg, t, 42)
    flips = route_flips(cfg, jb, tb, jx, tx)
    want = np.asarray(JM._moe_local(jb["ffn"], jx, cfg.top_k, cfg.n_experts,
                                    0, cfg.n_experts, cap))
    got = M._moe_local(tb["ffn"], tx, cfg.top_k, cfg.n_experts, 0,
                       cfg.n_experts, cap)
    assert got.dtype == torch.float32
    _, idx = M._route(tb["ffn"]["router"], tx, cfg.top_k, cfg.n_experts)
    load = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    assert bool((load > cap).any()) == (capacity is not None), load
    rows = np.ones(t, bool)
    rows[[tok for tok, _ in flips]] = False
    if capacity is not None and flips:
        # a flip moves the later tokens' slots, so what the capacity drops
        rows[min(tok for tok, _ in flips):] = False
    assert_model_ulps(got.numpy()[rows], want[rows])


@pytest.mark.parametrize("name", MOE)
def test_ffn_matches_jax(name):
    """``moe_ffn`` with deepseek's shared expert; arctic's routed experts
    plus its dense residual FFN (``_ffn_apply``)."""
    cfg, jb, tb = _block(name)
    jcfg = pair(name)[0]
    jx, tx = _bf16_pair((3, 7, cfg.d_model), 43)
    assert ("shared" in tb["ffn"]) == (name == "deepseek-v2-lite-16b")
    assert ("dense_ffn" in tb) == (name == "arctic-480b")
    assert_elementwise_ulps(T._ffn_apply(cfg, tb, tx),
                            JT._ffn_apply(jcfg, jb, jx), 2)


@pytest.mark.parametrize("name", MOE)
def test_aux_load_balance_loss_matches_jax(name):
    cfg, jb, tb = _block(name)
    jx, tx = _bf16_pair((2, 9, cfg.d_model), 44)
    kw = dict(top_k=cfg.top_k, n_experts=cfg.n_experts)
    np.testing.assert_allclose(
        float(M.aux_load_balance_loss(tb["ffn"], tx, **kw)),
        float(JM.aux_load_balance_loss(jb["ffn"], jx, **kw)), rtol=1e-6)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla():
    cfg, jb, tb = _block("deepseek-v2-lite-16b")
    return cfg, jb["attn"], tb["attn"]


def test_mla_forward_matches_jax():
    """The value width (16) differs from the q/k width (16 + 8)."""
    cfg, ja, ta = _mla()
    assert cfg.v_head_dim != cfg.qk_nope_dim + cfg.qk_rope_dim
    jx, tx = _bf16_pair((2, 11, cfg.d_model), 45)
    pos = np.arange(11, dtype=np.int32)
    assert_model_ulps(
        A.mla_forward(ta, tx, torch.from_numpy(pos), cfg.qk_nope_dim,
                      cfg.qk_rope_dim, cfg.rope_theta),
        JA.mla_forward(ja, jx, jnp.asarray(pos), cfg.qk_nope_dim,
                       cfg.qk_rope_dim, cfg.rope_theta))


@pytest.mark.parametrize("cache_len", [16, 7])
def test_mla_prefill_cache_matches_jax(cache_len):
    cfg, ja, ta = _mla()
    jx, tx = _bf16_pair((2, 11, cfg.d_model), 46)
    pos = np.arange(11, dtype=np.int32)
    want = JA.mla_prefill_cache(ja, jx, jnp.asarray(pos), cache_len,
                                cfg.rope_theta)
    got = A.mla_prefill_cache(ta, tx, torch.from_numpy(pos), cache_len,
                              cfg.rope_theta)
    for g, w in zip(got, want):
        assert_elementwise_ulps(g, w, 1)


@pytest.mark.parametrize("t", [0, 9])
def test_mla_decode_matches_jax(t):
    cfg, ja, ta = _mla()
    jx, tx = _bf16_pair((3, 1, cfg.d_model), 47)
    jc, tc = _bf16_pair((3, 12, cfg.kv_lora_rank), 48)
    jk, tk = _bf16_pair((3, 12, cfg.qk_rope_dim), 49)
    jy, jc2, jk2 = JA.mla_decode(ja, jx, jc, jk, jnp.int32(t),
                                 cfg.qk_nope_dim, cfg.qk_rope_dim,
                                 cfg.rope_theta)
    ty, tc2, tk2 = A.mla_decode(ta, tx, tc, tk, t, cfg.qk_nope_dim,
                                cfg.qk_rope_dim, cfg.rope_theta)
    assert tc2 is tc and tk2 is tk                  # written in place
    assert_model_ulps(ty, jy)
    assert_elementwise_ulps(tc2, jc2, 1)
    assert_elementwise_ulps(tk2, jk2, 1)


# ---------------------------------------------------------------------------
# training: the native init's tree, loss and gradients, a train() step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_native_init_has_the_jax_layout(name):
    """The port's own init: the JAX tree leaf for leaf (router f32,
    experts stacked [L, E, D, F], shared, dense_ffn, MLA's {"w": ...})."""
    _, cfg, _, _, jp, _ = pair(name)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = [(jax.tree_util.keystr(p), a.shape, str(a.dtype))
            for p, a in jax.tree_util.tree_leaves_with_path(jp)]
    got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in store.leaf_paths(tp)]
    assert got == want
    experts = tp["blocks"]["ffn"]["experts"]["gate"]["w"]
    assert experts.shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                             cfg.d_ff_expert)
    assert not torch.equal(experts[0, 0], experts[0, 1])


def _train_batch(cfg, seq_len: int, batch: int, step: int = 0) -> dict:
    return TP.make_train_batch(cfg, ShapeConfig("t", seq_len, batch, "train"),
                               TP.DataConfig(seed=0), step)


@functools.lru_cache(maxsize=None)
def _jax_loss(name):
    """JAX's loss and gradients of ``name`` on the 3 x 24 batch."""
    _, cfg, jm, _, jp, _ = pair(name)
    jb = {k: jnp.asarray(v) for k, v in _train_batch(cfg, 24, 3).items()}
    return jit_exact(jax.value_and_grad(lambda p: jm.loss(p, jb)))(jp)


@pytest.mark.parametrize("name", MOE)
def test_loss_and_gradients_every_leaf(name):
    _, cfg, _, m, _, tp = pair(name)
    batch = _train_batch(cfg, 24, 3)
    jloss, jgrads = _jax_loss(name)
    params = T.P.tree_map(lambda t: t.clone().requires_grad_(), tp)
    flat = leaves(params)
    loss = m.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(want) == len(grads)
    for (path, w), g in zip(want, grads):
        w, g = _f32(w), g.float().numpy()
        assert g.shape == w.shape, path
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-2, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("name", MOE)
def test_one_train_step(name, tmp_path):
    """``launch/train.train`` takes one step from a checkpoint of the JAX
    init: its loss is the port's and JAX's loss of the same params and
    batch (rtol 1e-4), and every leaf moves."""
    _, cfg, _, m, _, tp = pair(name)
    state = export_state(adamw_init(tp, AdamWConfig()))
    store.save(str(tmp_path), 0, (tp, state),
               extra={"next_step": 0, "data_seed": 0, "loss": None})
    out = train(name, steps=1, seq_len=24, batch=3, ckpt_dir=str(tmp_path),
                ckpt_every=1, log_every=100, device="cpu")
    batch = _train_batch(cfg, 24, 3)
    with torch.no_grad():
        own = m.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out["losses"][0] == float(own)
    jloss, _ = _jax_loss(name)
    np.testing.assert_allclose(out["losses"][0], float(jloss), rtol=1e-4)
    for a, b in zip(leaves(out["params"]), leaves(tp)):
        assert torch.isfinite(a.float()).all()
        assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# the paged engines refuse MoE and MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["PagedKVEngine", "ReferencePagedKVEngine"])
@pytest.mark.parametrize("name", MOE)
def test_paged_engines_refuse_moe_and_mla(engine, name):
    """The engines' layers run the dense MLP over GQA pages: an MoE (arctic)
    or MLA (deepseek) config is refused by name at construction."""
    from repro_torch.serving import engine as E
    from repro_torch.serving import reference as R
    cls = {"PagedKVEngine": E.PagedKVEngine,
           "ReferencePagedKVEngine": R.ReferencePagedKVEngine}[engine]
    _, cfg, _, _, _, tp = pair(name)
    with pytest.raises(ValueError, match=cfg.name):
        cls(cfg, tp, page_size=4, n_pool_pages=16, device="cpu")
