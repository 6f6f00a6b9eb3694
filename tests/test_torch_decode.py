"""The port's dense decode path vs the JAX package, on the CPU.

``models/attention.py``'s ``gqa_decode`` (ring and full caches, the
window mask) and ``gqa_prefill_cache``, ``models/transformer.py``'s
``prefill``, ``decode_step``, ``_quant_vec`` and ``decode_step_quant``,
and ``launch/serve.dense_generate`` (the dense ``generate`` loop), held
against the JAX package on reduced configs.  Parameters are the JAX
init carried over bit for bit (``params.from_numpy``); inputs are made
with numpy from a seed.

Two ways of running the JAX side:

* in process (module and whole-model parity): the whole-model functions
  are jitted with the compile option ``xla_allow_excess_precision``
  off (:func:`jit_exact`).  With XLA's default the compiled ``lax.scan``
  body keeps bf16 intermediates in f32 and drifts from any op-by-op
  implementation: 4.5 bf16 ULPs of the largest logit measured here on
  deepseek's fourth decode step, 0 with the option off;
* in one subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=false``
  (greedy tokens): JAX's own ``launch/serve.generate``, whose tokens the
  port's loop, fed the same params and prompts, must equal up to ties
  that ``serving/parity.GreedyParity`` reports (two logits within one
  bf16 ULP).

Tolerances, each from what the two packages do differently:

* one attention layer's output (``gqa_decode``): within 2 bf16 ULPs
  elementwise (f32 sums in another order, one rounding to bf16, and a
  one-ULP flip of an input moves it by at most another ULP), as
  ``tests/test_torch_train.py`` holds ``gqa_forward``;
* cache rows written by one layer (K/V projections, roped): within one
  bf16 ULP elementwise (``tests/test_torch_layers.py``'s bound);
* whole-model logits and caches: within 2 bf16 ULPs of the largest
  |value| of the array (measured here: 1.3 at worst, gemma3's six
  layers; deepseek and arctic equal; a hidden value that flipped by one
  ULP in layer 1 moves every value it feeds by the same absolute amount,
  which is several ULPs of a small value);
* ``_quant_vec``: bit-equal (the JAX side's ``_pow2_scale`` swapped, for
  these tests only, for the exact construction of 2^e that the port
  uses; XLA's CPU ``exp2`` is a few ULPs off for large exponents);
* ``decode_step_quant`` over 12 steps: logits as the whole model's; the
  cache (int8 deltas, f32 bases and scales) bit-equal — the K/V it
  quantises came out bit-equal here (exact jit, JAX's ``_pow2_scale``
  swapped as above);
* the port's own versions of the JAX checks keep their tolerances:
  prefill + decode against forward (2e-2, ``tests/test_models.py``),
  quantised against dense decode (rtol 0.1, atol 0.15), the paged engine
  against dense decode (``tests/test_substrate.py``).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _workers  # noqa: F401  (shares the cores among xdist workers)

from repro.configs.registry import get_arch as jax_arch
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.api import get_model as jax_model
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve
from repro_torch.launch.serve import dense_generate
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.models.params import from_numpy, layer
from repro_torch.serving.parity import GreedyParity

REPO = Path(__file__).resolve().parents[1]
# the seven transformer-family configs; gemma3 at 6 layers (5 local with
# window 8, then 1 global), so its decode mixes ring and full pools
CONFIGS = {"yi-6b": {}, "yi-9b": {}, "qwen2.5-14b": {},
           "gemma3-27b": {"n_layers": 6}, "internvl2-76b": {},
           "deepseek-v2-lite-16b": {}, "arctic-480b": {}}
PROMPT, STEPS = 10, 4              # prefill 10 tokens, then 4 decode steps
MODEL_ULPS = 2
# JAX's generate() arguments for the greedy-token cases: gemma3's ring of
# 8 slots wraps inside the prompt and again while decoding
GEN = {"yi-6b": dict(batch=4, prompt_len=16, gen=16),
       "gemma3-27b": dict(batch=2, prompt_len=12, gen=12),
       "deepseek-v2-lite-16b": dict(batch=2, prompt_len=12, gen=10)}


@functools.lru_cache(maxsize=None)
def pair(name: str, n_layers: int | None = None):
    """(JAX cfg, port cfg, JAX model, port model, JAX params, port params)
    of ``name``'s reduced config, the port's params the JAX init's bits."""
    kw = {} if n_layers is None else {"n_layers": n_layers}
    jcfg, cfg = jax_arch(name).reduced(**kw), get_arch(name).reduced(**kw)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, cfg, jm, get_model(cfg), jp, from_numpy(
        jax.tree.map(np.asarray, jp))


def jit_exact(fn, **kw):
    """``jax.jit`` with bf16 intermediates rounded as written."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False},
                   **kw)


def _ulp(mag):
    return np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_elementwise_ulps(got, want, ulps: int) -> None:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    mag = np.maximum(np.abs(g), np.abs(w))
    assert (np.abs(g - w) <= ulps * _ulp(mag)).all(), np.abs(g - w).max()


def assert_model_ulps(got, want, ulps: int = MODEL_ULPS) -> None:
    """Within ``ulps`` bf16 ULPs of the array's largest |value|."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    if not g.size:                           # an unused pool
        return
    err = np.abs(g - w).max()
    assert err <= ulps * _ulp(np.abs(w).max()), (err, np.abs(w).max())


def _bf16_pair(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)


def model_inputs(cfg, seed: int = 3, s: int = PROMPT + STEPS):
    """tokens [2, s] (numpy) and, for a frontend config, embeds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (2, s)).astype(np.int32)
    emb = None
    if cfg.n_frontend_embeds:
        emb = _bf16_pair((2, cfg.n_frontend_embeds, cfg.d_model), seed + 1,
                         0.02)
    return toks, emb


def _batches(toks, emb, n):
    jb = {"tokens": jnp.asarray(toks[:, :n])}
    tb = {"tokens": torch.from_numpy(toks[:, :n])}
    if emb is not None:
        jb["embeds"], tb["embeds"] = emb
    return jb, tb


# ---------------------------------------------------------------------------
# gqa_decode, gqa_prefill_cache
# ---------------------------------------------------------------------------

def _gqa_layer():
    _, cfg, _, _, jp, tp = pair("yi-6b")
    return (cfg, jax.tree.map(lambda a: a[1], jp["blocks"]["attn"]),
            layer(tp["blocks"], 1)["attn"])


@pytest.mark.parametrize("ring,t,window", [
    (True, 5, 0),      # ring not full: slots past t masked
    (True, 13, 0),     # ring wrapped: slot t % 8 overwritten
    (False, 9, 0),     # full cache
    (False, 11, 4)])   # full cache, window mask
def test_gqa_decode_matches_jax(ring, t, window):
    cfg, jattn, tattn = _gqa_layer()
    tc = 8 if ring else 16
    jx, tx = _bf16_pair((3, 1, cfg.d_model), 20)
    jk, tk = _bf16_pair((3, tc, cfg.n_kv_heads, cfg.head_dim), 21)
    jv, tv = _bf16_pair((3, tc, cfg.n_kv_heads, cfg.head_dim), 22)
    jy, jk2, jv2 = JA.gqa_decode(jattn, jx, jk, jv, jnp.int32(t), ring=ring,
                                 theta=cfg.rope_theta, window=window)
    ty, tk2, tv2 = A.gqa_decode(tattn, tx, tk, tv, t, ring=ring,
                                theta=cfg.rope_theta, window=window)
    assert tk2 is tk and tv2 is tv                  # written in place
    assert_elementwise_ulps(ty, jy, 2)
    assert_elementwise_ulps(tk2, jk2, 1)
    assert_elementwise_ulps(tv2, jv2, 1)


@pytest.mark.parametrize("ring,cache_len", [(True, 8), (True, 16),
                                            (False, 16), (False, 6)])
def test_gqa_prefill_cache_matches_jax(ring, cache_len):
    cfg, jattn, tattn = _gqa_layer()
    jx, tx = _bf16_pair((2, 11, cfg.d_model), 23)
    pos = np.arange(11, dtype=np.int32) + 3
    jk, jv = JA.gqa_prefill_cache(jattn, jx, jnp.asarray(pos), cache_len,
                                  ring=ring, theta=cfg.rope_theta)
    kv = A.gqa_kv(tattn, tx, torch.from_numpy(pos), cfg.rope_theta)
    for got in (A.gqa_prefill_cache(tattn, tx, torch.from_numpy(pos),
                                    cache_len, ring=ring,
                                    theta=cfg.rope_theta),
                A.gqa_prefill_cache(tattn, tx, torch.from_numpy(pos),
                                    cache_len, ring=ring, kv=kv)):
        assert_elementwise_ulps(got[0], jk, 1)
        assert_elementwise_ulps(got[1], jv, 1)


# ---------------------------------------------------------------------------
# the whole model: prefill and decode_step on the seven configs
# ---------------------------------------------------------------------------

def _jax_decode(name, toks, emb):
    jcfg, _, jm, _, jp, _ = pair(name, CONFIGS[name].get("n_layers"))
    off = jcfg.n_frontend_embeds
    jb, _ = _batches(toks, emb, PROMPT)
    logits, cache = jit_exact(jm.prefill, static_argnums=2)(
        jp, jb, off + PROMPT + STEPS)
    out = [logits]
    step = jit_exact(jm.decode_step)
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = step(jp, cache, jnp.asarray(toks[:, i]),
                             jnp.int32(off + i))
        out.append(logits)
    return out, cache


def _port_decode(name, toks, emb):
    _, cfg, _, m, _, tp = pair(name, CONFIGS[name].get("n_layers"))
    off = cfg.n_frontend_embeds
    _, tb = _batches(toks, emb, PROMPT)
    logits, cache = m.prefill(tp, tb, off + PROMPT + STEPS)
    out = [logits]
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = m.decode_step(tp, cache, torch.from_numpy(toks[:, i]),
                                      off + i)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_jax(name):
    cfg = pair(name, CONFIGS[name].get("n_layers"))[1]
    toks, emb = model_inputs(cfg)
    want, wcache = _jax_decode(name, toks, emb)
    got, gcache = _port_decode(name, toks, emb)
    for g, w in zip(got, want):
        assert_model_ulps(g, w)
    assert gcache._fields == wcache._fields
    for g, w in zip(gcache, wcache):
        assert tuple(g.shape) == w.shape
        assert_model_ulps(g, w)
    if name == "gemma3-27b":
        assert gcache.ring_k.shape[:3] == (5, 2, 8)
        assert gcache.full_k.shape[:3] == (1, 2, PROMPT + STEPS)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_decode_matches_forward(name):
    """The port's own ``tests/test_models.py:87``: logits of prefill on
    the prompt less its last token equal forward's at that position, and
    one decode step gives forward's last."""
    _, cfg, _, m, _, tp = pair(name, CONFIGS[name].get("n_layers"))
    toks, emb = model_inputs(cfg, seed=4, s=12)
    _, full = _batches(toks, emb, 12)
    _, cut = _batches(toks, emb, 11)
    off = cfg.n_frontend_embeds
    with torch.no_grad():
        want = m.forward(tp, full).float()
    last, cache = m.prefill(tp, cut, off + 12)
    step, _ = m.decode_step(tp, cache, torch.from_numpy(toks[:, -1]),
                            off + 11)
    for g, w in ((last, want[:, -2]), (step, want[:, -1])):
        np.testing.assert_allclose(_f32(g), w.numpy(), rtol=2e-2, atol=2e-2)


def test_ring_slot_off_by_one_is_refused(monkeypatch):
    """Decode writing its ring slot one off (the prefill layout and the
    read side unchanged) keeps a position the window left and drops one
    inside it: gemma3's decode logits leave the whole-model bound."""
    cfg = pair("gemma3-27b", 6)[1]
    toks, emb = model_inputs(cfg)
    want, _ = _jax_decode("gemma3-27b", toks, emb)
    monkeypatch.setattr(A, "_ring_slot", lambda pos, tc: (
        (pos + 1) % tc if isinstance(pos, int) else pos % tc))
    got, _ = _port_decode("gemma3-27b", toks, emb)
    assert_model_ulps(got[0], want[0])       # prefill does not read rings
    with pytest.raises(AssertionError):
        for g, w in zip(got[1:], want[1:]):
            assert_model_ulps(g, w)


# ---------------------------------------------------------------------------
# the quantised cache
# ---------------------------------------------------------------------------

def exact_pow2_scale(maxres, qmax):
    """JAX's ``_pow2_scale`` with 2^e built from its bits (test-only)."""
    ratio = (maxres / qmax).astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(ratio, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0)
    s = jax.lax.bitcast_convert_type(
        jnp.where(e >= -126, (e + 127) << 23, 1 << 22).astype(jnp.int32),
        jnp.float32)
    return jnp.where(maxres > 0, s, jnp.float32(1.0))


@pytest.fixture
def exact_jax_pow2(monkeypatch):
    from repro.core import bdi_value as jbv
    monkeypatch.setattr(jbv, "_pow2_scale", exact_pow2_scale)


def test_quant_vec_bit_equal(exact_jax_pow2):
    jx, tx = _bf16_pair((3, 5, 4, 16), 30, 4.0)
    rows = np.zeros((4, 16), np.float32)
    rows[1] = 3.0                                    # flat row: scale 1
    rows[2, ::2] = 1e-30                             # tiny residuals
    rows[3] = np.linspace(-1e4, 1e4, 16)             # large residuals
    jr = jnp.asarray(rows, jnp.bfloat16)
    jx = jx.at[0, 0].set(jr)
    tx[0, 0] = torch.from_numpy(np.array(jr.astype(jnp.float32))).bfloat16()
    for g, w in zip(T._quant_vec(tx), JT._quant_vec(jx)):
        w = np.asarray(w)
        assert g.dtype == {"int8": torch.int8, "float32": torch.float32}[
            str(w.dtype)]
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)


QuantFields = ("kd", "kb", "ks", "vd", "vb", "vs")


def test_decode_step_quant_matches_jax(exact_jax_pow2):
    jcfg, cfg, _, _, jp, tp = pair("yi-6b")
    toks = np.random.default_rng(31).integers(1, cfg.vocab, (2, 12))
    jc = JT.init_quant_cache(jcfg, 2, 16)
    tc = T.init_quant_cache(cfg, 2, 16, device="cpu")
    step = jit_exact(lambda p, c, tok, t: JT.decode_step_quant(jcfg, p, c,
                                                               tok, t))
    for t in range(12):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
        tl, tc = T.decode_step_quant(cfg, tp, tc, torch.from_numpy(toks[:, t]),
                                     t)
        assert_model_ulps(tl, jl)
    for key in QuantFields:
        g, w = getattr(tc, key).numpy(), np.asarray(getattr(jc, key))
        np.testing.assert_array_equal(g, w, err_msg=key)


def test_quant_decode_tracks_dense():
    """The port's own ``tests/test_models.py:155``: quantised-cache decode
    tracks dense decode (int8 K/V is lossy)."""
    _, cfg, _, m, _, tp = pair("yi-6b")
    toks = torch.from_numpy(
        np.random.default_rng(32).integers(1, cfg.vocab, (2, 12)))
    dense = m.init_cache(2, 16, device="cpu")
    quant = T.init_quant_cache(cfg, 2, 16, device="cpu")
    for t in range(12):
        ld, dense = m.decode_step(tp, dense, toks[:, t], t)
        lq, quant = T.decode_step_quant(cfg, tp, quant, toks[:, t], t)
    np.testing.assert_allclose(_f32(lq), _f32(ld), rtol=0.1, atol=0.15)
    assert T.cache_bytes(quant) < T.cache_bytes(dense)


def test_paged_engine_matches_dense_decode():
    """The port's own ``tests/test_substrate.py:257``: the paged engine's
    greedy tokens against dense decode through the model API."""
    from repro_torch.serving.engine import PagedKVEngine
    _, cfg, _, m, _, tp = pair("yi-6b")
    prompt = list(range(1, 9))
    eng = PagedKVEngine(cfg, tp, page_size=4, n_pool_pages=64, device="cpu")
    eng.add_request(0, prompt)
    got = [eng.decode_one(0) for _ in range(6)]
    ref = dense_generate(cfg, tp, torch.tensor([prompt]), 6)["tokens"][0]
    # compressed KV is lossy (int8): the first tokens must match
    assert got[0] == ref[0]
    assert sum(a == b for a, b in zip(got, ref)) >= 4


# ---------------------------------------------------------------------------
# generate: greedy tokens against JAX's loop (subprocess), the default
# ---------------------------------------------------------------------------

def jax_main(work: str) -> None:
    """Subprocess entry: JAX's dense ``generate`` on each case."""
    from repro.launch.serve import generate
    out = {name: generate(name, smoke=True, **kw)["tokens"]
           for name, kw in GEN.items()}
    Path(work, "generate.json").write_text(json.dumps(out))


@pytest.fixture(scope="module", autouse=True)
def jax_generate_run(tmp_path_factory):
    """Starts the JAX subprocess with the module's first test, so that it
    runs beside the in-process tests; stopped at the module's end."""
    work = tmp_path_factory.mktemp("generate")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.Popen([sys.executable, "-c",
                             "import test_torch_decode as t; "
                             f"t.jax_main({str(work)!r})"], env=env, cwd=REPO)
    yield work, proc
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=60)


@pytest.fixture(scope="module")
def jax_generate(jax_generate_run):
    work, proc = jax_generate_run
    assert proc.wait(timeout=600) == 0
    return json.loads((work / "generate.json").read_text())


@pytest.mark.parametrize("name", list(GEN))
def test_generate_tokens_match_jax(jax_generate, name):
    """The port's loop, fed the params and prompts JAX's ``generate``
    makes (its PRNG keys 0 and 1, the same bits in this process)."""
    kw = GEN[name]
    cfg, params = pair(name)[1], pair(name)[5]
    prompts = jax.random.randint(jax.random.PRNGKey(1),
                                 (kw["batch"], kw["prompt_len"]), 1,
                                 cfg.vocab, jnp.int32)
    got = dense_generate(cfg, params, torch.from_numpy(np.array(prompts)),
                         kw["gen"], keep_logits=True)
    want = jax_generate[name]
    assert np.shape(got["tokens"]) == np.shape(want)
    par = GreedyParity()
    for j in range(kw["gen"]):
        par.check(j, {b: w[j] for b, w in enumerate(want)},
                  {b: g[j] for b, g in enumerate(got["tokens"])},
                  lambda sid, j=j: got["logits"][j, sid])
    print(f"{name}: {par.compared} tokens equal, ties {par.ties}")
    assert par.compared + len(par.ties) >= len(want)
    assert par.compared >= 0.75 * np.size(want)


def test_generate_defaults_to_dense():
    """``generate`` takes JAX's signature and default (``paged=False``):
    dense decode, JAX's result keys, for every family; the paged engine
    and the oracle still refuse the recurrent and encoder-decoder
    families, as the reference's do."""
    import inspect
    assert inspect.signature(serve.generate).parameters[
        "paged"].default is False
    out = serve.generate("qwen2.5-14b", batch=2, prompt_len=6, gen=4,
                         device="cpu")
    assert {"tokens", "tok_per_s"} <= set(out) and "codec" not in out
    assert np.shape(out["tokens"]) == (2, 4)
    for arch in ("xlstm-350m", "hymba-1.5b", "seamless-m4t-large-v2"):
        out = serve.generate(arch, batch=2, prompt_len=4, gen=3,
                             device="cpu")
        assert "codec" not in out and out["cache_bytes"] > 0
        assert np.shape(out["tokens"]) == (2, 3)
        vocab = get_arch(arch).reduced().vocab
        assert all(0 <= t < vocab for row in out["tokens"] for t in row)
        for mode in ("paged", "paged_reference"):
            with pytest.raises(ValueError, match="paged engine serves dense"):
                serve.generate(arch, batch=1, prompt_len=4, gen=2,
                               device="cpu", **{mode: True})


def test_cli_without_a_mode_runs_dense(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "deepseek-v2-lite-16b", "--smoke", "--device",
        "cpu", "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    serve.main()
    assert "(dense decode)" in capsys.readouterr().out


def test_serve_paged_twin_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve_paged
    out = serve_paged.main("cpu", steps=4)
    assert all(len(t) == 16 for t in out["tokens"].values())
    assert out["stats"]["pages_compressed"] > 0
    assert "plain attention on cpu" in capsys.readouterr().out


def test_dense_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch import serve_paged
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.generate("yi-6b", smoke=True)             # dense, the default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_paged.main()
