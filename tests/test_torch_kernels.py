"""The port's kernel layer vs the JAX package, on the CPU.

* The plain BDI row codec (``repro_torch.kernels.ref.compress_kv_pages``)
  is bit-exact with ``repro.kernels.ref.compress_kv_pages`` and with the
  Pallas kernel in interpret mode (``repro.kernels.ops``), and so are
  ``page_nbytes`` and ``page_checksums``.
* The plain decode attention, with and without the tail, is within f32
  tolerance of the JAX oracle and the Pallas kernel (rtol 1e-5 or 2e-5,
  atol 2e-5: the same f32 math summed in another order; the JAX
  package's own kernel tests use these), NaN where a sequence has no
  token, as in JAX.
* The CUDA kernels vs the plain versions: ``tests/test_torch_cuda.py``.

XLA's CPU backend flushes subnormals to zero and its ``exp2`` is a few
ULPs off for integer exponents beyond about +-12, so the JAX oracle's
scale is no exact power of two there.  Those extreme rows are held
against an exact numpy construction of the codec instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codecs as jax_codecs
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.serving import faults as jax_faults
from repro_torch import codecs
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.transformer import init_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import faults


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _kv(seed, pool, kvh, page, d):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((pool, kvh, page, d)) * 2.0).astype(np.float32)
    v = (rng.standard_normal((pool, kvh, page, d)) * 2.0).astype(np.float32)
    # degenerate rows (maxres == 0): all-zero and constant
    k[0, 0, 0] = 0.0
    v[0, 0, 1] = 3.25
    # exact .5 quotients at scale 1 (round half to even decides them)
    k[-1, -1, -1, :6] = [0.0, 100.0, 2.5, -3.5, 0.5, -126.5]
    # residual ratio exactly a power of two, and a wide but normal range
    v[-1, -1, -1, :2] = [0.0, 127.0]
    k[-1, 0, 0] = np.linspace(-3000.0, 3000.0, d)
    return k, v


@pytest.mark.parametrize("pool,kvh,page,d", [(5, 2, 8, 64), (12, 4, 16, 32),
                                             (3, 1, 8, 128)])
def test_compress_kv_pages_bit_exact_with_jax(pool, kvh, page, d):
    k, v = _kv(pool * d, pool, kvh, page, d)
    got = ref.compress_kv_pages(_t(k), _t(v))
    for want in (jax_ref.compress_kv_pages(jnp.asarray(k), jnp.asarray(v)),
                 jax_ops.compress_kv_pages(jnp.asarray(k), jnp.asarray(v),
                                           interpret=True)):
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    # the wrapper picks the plain version for CPU tensors
    for g, w in zip(ops.compress_kv_pages(_t(k), _t(v)), got):
        assert torch.equal(g, w)


def _numpy_codec(x: np.ndarray):
    """The codec in numpy float32, the scale built exactly (np.ldexp),
    subnormals kept: the oracle for rows XLA's CPU backend mangles."""
    base = x[:, 0]
    r = (x - base[:, None]).astype(np.float32)
    maxres = np.abs(r).max(axis=1)
    ratio = (maxres / np.float32(127.0)).astype(np.float32)
    bits = ratio.view(np.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0)
    scale = np.where(maxres > 0, np.ldexp(np.float64(1.0), e),
                     1.0).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        d = np.clip(np.rint(r / scale[:, None]), -127, 127)
    return d.astype(np.int8), base, scale


def test_compress_extreme_rows_match_exact_codec():
    d = 32
    x = np.zeros((6, d), np.float32)
    x[0, 1:] = 1e-40                     # subnormal maxres and ratio
    x[0, 2] = -3e-39
    x[1, 1] = 1.4e-45                    # ratio 0 with maxres > 0: 2^-127
    x[2, 1::2], x[2, 2::2] = 1e38, -1e38   # huge, finite
    x[3, 1] = 127.0 * 2.0 ** -20         # ratio exactly 2^-20
    x[4] = np.linspace(-5e5, 5e5, d)     # e = 13
    x[5, 0], x[5, 1:] = -7.0, np.linspace(0, 1e-3, d - 1)
    got = ref.compress_rows(_t(x))
    for g, w in zip(got, _numpy_codec(x)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_pow2_scale_is_exact_for_every_exponent():
    # ratios 2^e * 1.5 (rounded up to 2^(e+1)) and exact 2^e over the
    # whole float32 range, subnormal ratios included
    e = np.arange(-149, 128)
    ratio = np.concatenate([np.ldexp(1.5, e[e < 127]), np.ldexp(1.0, e)])
    ratio = ratio[ratio < np.finfo(np.float32).max / 127]
    maxres = ratio.astype(np.float32) * np.float32(127.0)
    want = _numpy_codec(np.stack([np.zeros_like(maxres), maxres], 1))[2]
    np.testing.assert_array_equal(ref._pow2_scale(_t(maxres), 127.0).numpy(),
                                  want)


def test_pow2_scale_matches_jax_in_exact_range():
    # scales 2^-12 .. 2^12, where XLA's CPU exp2 is exact, rounded up
    # (x1.3) or hit exactly, plus maxres == 0
    e = np.arange(-12, 12)
    maxres = np.concatenate([[0.0], 127.0 * np.ldexp(1.0, e) * 1.3,
                             127.0 * np.ldexp(1.0, e + 1)]).astype(np.float32)
    from repro.core.bdi_value import _pow2_scale as jax_pow2
    np.testing.assert_array_equal(
        ref._pow2_scale(_t(maxres), 127.0).numpy(),
        np.asarray(jax_pow2(jnp.asarray(maxres), 127.0)))


@pytest.mark.parametrize("with_zero_rows", [False, True])
def test_page_nbytes_and_checksums_bit_equal(with_zero_rows):
    k, v = _kv(11, 6, 2, 8, 16)
    if with_zero_rows:
        k[1] = 0.0                       # whole zero pages: metadata only
        v[2, 1] = 0.0
    jpages = jax_ref.compress_kv_pages(jnp.asarray(k), jnp.asarray(v))
    tpages = ref.CompressedKVPages(*[_t(a) for a in jpages])
    np.testing.assert_array_equal(
        codecs.BDI.page_nbytes(tpages).numpy(),
        np.asarray(jax_codecs.BDI.page_nbytes(jpages)))
    np.testing.assert_array_equal(
        faults.page_checksums(tpages).numpy(),
        np.asarray(jax_faults.page_checksums(jpages)).astype(np.int64))
    # and on pages the port compressed itself
    own = ref.compress_kv_pages(_t(k), _t(v))
    np.testing.assert_array_equal(faults.page_checksums(own).numpy(),
                                  faults.page_checksums(tpages).numpy())


def test_dequant_pages_matches_jax():
    k, v = _kv(5, 4, 2, 8, 16)
    p = jax_ref.compress_kv_pages(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(
        ref.dequant_pages(_t(p.kd), _t(p.kb), _t(p.ks)).numpy(),
        np.asarray(jax_ref.dequant_pages(p.kd, p.kb, p.ks)))


def _attn_case(seed, bsz, kvh, g, d, page, pmax, pool, lengths, tail_len,
               scrambled):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((2, pool, kvh, page, d))
            .astype(np.float32))
    pages = jax_ref.compress_kv_pages(jnp.asarray(k), jnp.asarray(v))
    q = rng.standard_normal((bsz, kvh, g, d)).astype(np.float32)
    if scrambled:
        pt = rng.permutation(np.arange(1, pool))[:bsz * pmax]
    else:
        pt = rng.integers(0, pool, bsz * pmax)
    pt = pt.reshape(bsz, pmax).astype(np.int32)
    tk, tv = rng.standard_normal((2, bsz, kvh, page, d)).astype(np.float32)
    return (q, pages, pt, np.asarray(lengths, np.int32), tk, tv,
            np.asarray(tail_len, np.int32))


ATTN_CASES = {
    # tests/test_serving_batched.py:261, incl. a zero-page sequence
    "serving": dict(seed=7, bsz=3, kvh=2, g=4, d=16, page=8, pmax=4,
                    pool=12, lengths=[16, 0, 32], tail_len=[3, 1, 8],
                    scrambled=False),
    # scrambled page table, ragged and empty rows, yi-6b's G and D
    "scrambled": dict(seed=8, bsz=4, kvh=2, g=8, d=128, page=16, pmax=5,
                      pool=24, lengths=[80, 0, 37, 1], tail_len=[1, 16, 5, 9],
                      scrambled=True),
    # gemma3-27b's head (D 168, G 2) at pages of 16 and 32
    "gemma_p16": dict(seed=9, bsz=3, kvh=2, g=2, d=168, page=16, pmax=4,
                      pool=16, lengths=[64, 0, 37], tail_len=[16, 3, 9],
                      scrambled=True),
    "gemma_p32": dict(seed=10, bsz=3, kvh=2, g=2, d=168, page=32, pmax=3,
                      pool=12, lengths=[96, 0, 45], tail_len=[32, 5, 17],
                      scrambled=True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_paged_attention_tail_matches_jax(case):
    q, pages, pt, lengths, tk, tv, tlen = _attn_case(**ATTN_CASES[case])
    jargs = (jnp.asarray(q), pages, jnp.asarray(pt), jnp.asarray(lengths),
             jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(tlen))
    targs = (_t(q), ref.CompressedKVPages(*[_t(a) for a in pages]), _t(pt),
             _t(lengths), _t(tk), _t(tv), _t(tlen))
    got = ops.paged_attention_tail(*targs).numpy()
    np.testing.assert_array_equal(got,
                                  ref.paged_attention_tail_ref(*targs).numpy())
    for want in (jax_ref.paged_attention_tail_ref(*jargs),
                 jax_ops.paged_attention_tail(*jargs)):   # interpret mode
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=2e-5)


def test_paged_attention_matches_jax():
    q, pages, pt, lengths, _, _, _ = _attn_case(**ATTN_CASES["scrambled"])
    lengths = np.maximum(lengths, 1)          # no tail: keep a valid key
    got = ref.paged_attention_ref(
        _t(q), ref.CompressedKVPages(*[_t(a) for a in pages]), _t(pt),
        _t(lengths)).numpy()
    want = jax_ref.paged_attention_ref(jnp.asarray(q), pages,
                                       jnp.asarray(pt), jnp.asarray(lengths))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=2e-5)


def _paged_case(seed, bsz, kvh, g, d, page, pmax, lengths=None):
    """tests/test_kernels.py's paged-attention cases from a numpy seed:
    each sequence owns a disjoint slab of pages (page 0 unused)."""
    rng = np.random.default_rng(seed)
    n_pages = bsz * pmax + 1
    k, v = rng.standard_normal((2, n_pages, kvh, page, d)).astype(np.float32)
    pages = jax_ref.compress_kv_pages(jnp.asarray(k), jnp.asarray(v))
    q = rng.standard_normal((bsz, kvh, g, d)).astype(np.float32)
    pt = (np.arange(bsz * pmax).reshape(bsz, pmax) + 1).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, pmax * page + 1, bsz)
    return q, pages, pt, np.asarray(lengths, np.int32)


def _both(q, pages, pt, lengths):
    return ((_t(q), ref.CompressedKVPages(*[_t(a) for a in pages]), _t(pt),
             _t(lengths)),
            (jnp.asarray(q), pages, jnp.asarray(pt), jnp.asarray(lengths)))


PAGED_CASES = {
    # tests/test_kernels.py:144-160: ragged lengths, then full ones
    "b2_h2_g2_d128": dict(seed=0, bsz=2, kvh=2, g=2, d=128, page=8, pmax=4),
    "b1_h1_g1_d128": dict(seed=1, bsz=1, kvh=1, g=1, d=128, page=16, pmax=2),
    "b3_h4_g2_d64": dict(seed=2, bsz=3, kvh=4, g=2, d=64, page=8, pmax=3),
    "b2_h1_g8_d128": dict(seed=3, bsz=2, kvh=1, g=8, d=128, page=8, pmax=5),
    "full_lengths": dict(seed=4, bsz=2, kvh=2, g=2, d=128, page=8, pmax=4,
                         lengths=[32, 32]),
    # a sequence with no token: NaN (0/0) in JAX, the kernel and here
    "zero_length": dict(seed=5, bsz=3, kvh=4, g=2, d=64, page=8, pmax=3,
                        lengths=[17, 0, 24]),
    # gemma3-27b's head (D 168, G 2) at pages of 16 and 32
    "b2_h2_g2_d168_p16": dict(seed=6, bsz=2, kvh=2, g=2, d=168, page=16,
                              pmax=3),
    "b2_h2_g2_d168_p32": dict(seed=7, bsz=2, kvh=2, g=2, d=168, page=32,
                              pmax=2, lengths=[64, 33]),
}
# (cases share shapes where they can: each new shape costs an interpret
# compile of the Pallas kernel)
_jax_paged_attention_ref = jax.jit(jax_ref.paged_attention_ref)


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_attention_ref_matches_pallas_kernel(case):
    targs, jargs = _both(*_paged_case(**PAGED_CASES[case]))
    got = ops.paged_attention(*targs).numpy()      # CPU: the plain version
    np.testing.assert_array_equal(got, ref.paged_attention_ref(*targs))
    for want in (_jax_paged_attention_ref(*jargs),
                 jax_ops.paged_attention(*jargs)):      # interpret mode
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5, equal_nan=True)
    empty = targs[3].numpy() == 0
    assert np.isnan(got[empty]).all() and not np.isnan(got[~empty]).any()


def test_paged_attention_ignores_pages_past_length():
    """tests/test_kernels.py:162: pages after the last valid token,
    scrambled, change nothing."""
    q, pages, pt, _ = _paged_case(42, 1, 1, 1, 128, 16, 2)
    lengths = np.array([9], np.int32)
    scram = pages._replace(vd=pages.vd.at[pt[0, 1]:].set(127),
                           kd=pages.kd.at[pt[0, 1]:].set(127))
    outs = []
    for p in (pages, scram):
        targs, jargs = _both(q, p, pt, lengths)
        outs.append(ops.paged_attention(*targs).numpy())
        np.testing.assert_allclose(outs[-1],
                                   np.asarray(jax_ops.paged_attention(*jargs)),
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_cuda_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import bdi_compress, paged_attention
    with pytest.raises(ValueError):
        bdi_compress.bdi_compress_kv(torch.zeros(4, 8))
    q, pages, pt, lengths, tk, tv, tlen = _attn_case(**ATTN_CASES["serving"])
    with pytest.raises(ValueError):
        paged_attention.paged_attention_tail(
            _t(q), ref.CompressedKVPages(*[_t(a) for a in pages]), _t(pt),
            _t(lengths), _t(tk), _t(tv), _t(tlen))
    with pytest.raises(ValueError):
        paged_attention.paged_attention(
            _t(q), ref.CompressedKVPages(*[_t(a) for a in pages]), _t(pt),
            _t(lengths))


# ---------------------------------------------------------------------------
# the attention kernel's shapes (the kernel itself runs on the card only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,d,page,taken", [
    (2, 168, 16, True), (2, 168, 32, True), (8, 128, 32, True),
    (4, 8, 8, True), (3, 20, 12, True), (8, 128, 16, True),
    (1, 256, 4, True), (4, 256, 32, True), (1, 4, 20, True),
    (2, 6, 16, False), (2, 260, 16, False), (2, 168, 36, False),
    (2, 168, 6, False), (66, 16, 8, False), (4, 264, 16, False),
    (0, 16, 16, False), (2, 16, 0, False)])
def test_attention_shape_predicate(g, d, page, taken):
    assert PA.takes(g, d, page) is taken


def test_attention_split_count_follows_the_page():
    # 4 table entries a split up to 16 rows a page, 2 above
    assert [PA.n_split(9, False, p) for p in (4, 16, 20, 32)] == [3, 3, 5, 5]
    assert PA.n_split(9, True, 32) == 6 and PA.n_split(0, True, 8) == 1


@pytest.mark.parametrize("page", [16, 32])
def test_every_dense_gqa_config_is_taken(page):
    served = [c for c in ARCHS.values()
              if c.attn_kind == "gqa" and not c.is_encdec]
    assert {"gemma3-27b", "yi-6b", "qwen2.5-14b"} <= {c.name for c in served}
    for cfg in served:
        assert PA.takes(cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                        page), cfg.name


def test_engine_refuses_untaken_shape_at_construction(monkeypatch):
    """On the card, bdi decodes through the attention kernel, so the engine
    refuses a page it does not take when it is built.  The device is
    faked: the refusal comes before anything touches it."""
    cfg = get_arch("yi-6b").reduced(n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    g, d = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    with pytest.raises(ValueError) as err:
        engine_mod.PagedKVEngine(cfg, params, page_size=36, codec="bdi",
                                 device="cuda")
    assert PA.refusal("paged_attention_tail", g, d, 36) in str(err.value)
