"""The port's page codecs vs the JAX package's, on the CPU.

Every codec the slice ports — ``zero``, ``raw``, ``fpc``, ``gbdi`` and
``adaptive`` — runs the same numpy-made pages as its JAX twin: the
encodings (field by field, compared as bytes: the port keeps fpc's top
halves as int16 with the bits of JAX's uint16), decompression at any
leading dims, the canonical roundtrip, ``page_nbytes``,
``page_checksums`` (adaptive's nested pages included) and ``page_tags``
must be bit-equal.  There is no tolerance: the codecs are exact integer
and bit-pattern functions, and the plain PyTorch version of each kernel
repeats the JAX arithmetic step for step.

GBDI is also held against the JAX oracle (``encode_pages_ref`` /
``decode_pages_ref``) and the Pallas kernels in interpret mode.  XLA's
CPU backend flushes subnormals and its ``exp2`` is a few ULPs off for
integer exponents beyond about +-12, so the JAX oracle's scale is no
exact power of two there: the edge pages whose scales fall outside
2^-12..2^12 are held against an exact numpy construction of the codec
instead, and the page whose anchor span overflows (base 0 is NaN, and
x86 and CUDA give NaN other bits) is left to the kernel-vs-plain check
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codecs as jax_codecs
from repro.kernels import gbdi_codec as jax_gbdi
from repro.kernels import ops as jax_ops
from repro.serving import faults as jax_faults
from repro_torch import codecs
from repro_torch.kernels import gbdi_codec, ops, ref
from repro_torch.serving import faults
from repro_torch.serving._tree import tree_leaves, tree_map

PORTED = ("zero", "raw", "fpc", "gbdi", "adaptive")
PAGE = 8


def _pages(seed, n=4, kvh=2, page=PAGE, d=16):
    """``tests/test_codecs.py:35``'s row classes from numpy: random rows,
    an all-zero row, a repeated-value row and an all-zero page side."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n, kvh, page, d)).astype(np.float32)
    v = rng.standard_normal((n, kvh, page, d)).astype(np.float32)
    k[0, 0, 0] = 0.0
    k[0, 0, 1] = 2.5
    v[1] = 0.0
    return k, v


def _bytes(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_trees_bit_equal(got, want):
    """Port pages (a NamedTuple tree, or a plain tuple of tensors) vs JAX
    pages, leaf by leaf in flatten order."""
    g = tree_leaves(got) if hasattr(got, "_fields") else list(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == b.shape, i
        assert a.element_size() == b.dtype.itemsize, i
        np.testing.assert_array_equal(_bytes(a), _bytes(b), err_msg=str(i))


def _to_port(jax_tree, like):
    """JAX pages -> tensors of the port's dtypes (same bits)."""
    def one(t, j):
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        return torch.from_numpy(np.array(j).view(np_dtype))
    return tree_map(one, like, jax_tree)


@pytest.mark.parametrize("name", PORTED)
def test_codec_bit_equal_to_jax(name):
    tc, jc = codecs.get(name), jax_codecs.get(name)
    k, v = _pages(len(name))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    tpg = tc.compress_kv_pages(tk, tv)
    jpg = jc.compress_kv_pages(jnp.asarray(k), jnp.asarray(v))
    _assert_trees_bit_equal(tpg, jpg)
    np.testing.assert_array_equal(tc.page_nbytes(tpg).numpy(),
                                  np.asarray(jc.page_nbytes(jpg)))
    np.testing.assert_array_equal(
        faults.page_checksums(tpg).numpy(),
        np.asarray(jax_faults.page_checksums(jpg)).astype(np.int64))
    np.testing.assert_array_equal(tc.page_tags(tpg).numpy(),
                                  np.asarray(jc.page_tags(jpg)))
    # decompression from the JAX bits, at [2, 2] leading dims as decode
    # gathers them ([S, PMAX])
    lead = jax.tree.map(lambda a: a.reshape((2, 2) + a.shape[1:]), jpg)
    got = tc.decompress_pages(_to_port(lead, tree_map(
        lambda a: a.reshape((2, 2) + a.shape[1:]), tpg)))
    for g, w in zip(got, jc.decompress_pages(lead)):
        np.testing.assert_array_equal(_bytes(g), _bytes(w))
    for g, w in zip(tc.canonical_roundtrip(tk, tv),
                    jc.canonical_roundtrip(jnp.asarray(k), jnp.asarray(v))):
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


def test_registry_and_flags_match_jax(monkeypatch):
    assert codecs.available() == jax_codecs.available()
    assert set(codecs.available()) == {"bdi", "zero", "raw", "gbdi", "fpc",
                                       "adaptive"}
    for name in codecs.available():
        tc, jc = codecs.get(name), jax_codecs.get(name)
        for flag in ("lossless", "has_fused_kernels", "has_fused_fill",
                     "ulp_stable_sizes"):
            assert getattr(tc, flag) == getattr(jc, flag), (name, flag)
    assert codecs.ADAPTIVE.member_names == jax_codecs.ADAPTIVE.member_names
    assert type(codecs.ADAPTIVE.init_pools(
        1, 2, 1, PAGE, 8, "cpu"))._fields[0] == "tag"
    monkeypatch.delenv("REPRO_CODEC", raising=False)
    assert codecs.resolve(None) is codecs.BDI
    monkeypatch.setenv("REPRO_CODEC", "gbdi")
    assert codecs.resolve(None) is codecs.GBDI
    monkeypatch.setenv("REPRO_CODEC", "nope")
    with pytest.raises(KeyError, match="REPRO_CODEC"):
        codecs.resolve(None)


# ---------------------------------------------------------------------------
# gbdi
# ---------------------------------------------------------------------------

ROWS, D = 16, 16
IN_JAX_RANGE = ("zero", "constant", "span0", "midpoints", "widths", "halves")
EXTREME = ("subnormal", "huge", "wide")


def _edge(names) -> np.ndarray:
    pages = gbdi_codec.edge_pages(ROWS, D)
    return np.stack([pages[n].numpy() for n in names])


def test_gbdi_edge_set_is_covered():
    assert set(gbdi_codec.edge_pages(ROWS, D)) == \
        set(IN_JAX_RANGE) | set(EXTREME) | {"span_inf"}


def _gbdi_inputs() -> np.ndarray:
    """Random pages with the test_codecs row classes + the in-range
    edge pages, as [n, ROWS, D]."""
    k, _ = _pages(3, n=4, kvh=2, page=PAGE, d=D)
    return np.concatenate([k.reshape(4, ROWS, D), _edge(IN_JAX_RANGE)])


def test_gbdi_plain_versions_match_jax_oracle_and_kernels():
    x = _gbdi_inputs()
    got = ref.encode_pages_ref(torch.from_numpy(x))
    _assert_trees_bit_equal(got, jax_gbdi.encode_pages_ref(
        jnp.asarray(x)))
    rows = torch.from_numpy(x.reshape(-1, D))
    flat = gbdi_codec.gbdi_compress_kv_ref(rows, ROWS)
    jflat = jax_gbdi.gbdi_compress(jnp.asarray(x.reshape(-1, D)),
                                   rows_per_page=ROWS, interpret=True)
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(_bytes(a).reshape(-1),
                                      _bytes(b).reshape(-1))
    dec = gbdi_codec.gbdi_decompress_kv_ref(*flat[:4], ROWS)
    jdec = jax_gbdi.gbdi_decompress(*jflat[:4], rows_per_page=ROWS,
                                    interpret=True)
    np.testing.assert_array_equal(_bytes(dec), _bytes(jdec))
    np.testing.assert_array_equal(
        _bytes(ref.decode_pages_ref(*got[:4])),
        _bytes(jax_gbdi.decode_pages_ref(*[jnp.asarray(a.numpy())
                                           for a in got[:4]])))
    # the page-level wrappers: ops picks the plain version on the CPU
    kv = torch.from_numpy(x.reshape(-1, 2, PAGE, D))
    pg = ops.gbdi_compress_kv_pages(kv, kv * 0.5)
    jpg = jax_ops.gbdi_compress_kv_pages(jnp.asarray(kv.numpy()),
                                         jnp.asarray(kv.numpy() * 0.5),
                                         interpret=True)
    _assert_trees_bit_equal(pg, jpg)
    for a, b in zip(ops.gbdi_decompress_kv_pages(pg),
                    jax_ops.gbdi_decompress_kv_pages(jpg, interpret=True)):
        np.testing.assert_array_equal(_bytes(a), _bytes(b))


def test_gbdi_plain_version_matches_jax_kernel_at_gemma_page():
    """gemma3-27b's page, KVH 16 x page 16 = 256 rows of D 168: random
    pages and the in-range edge pages, plain version vs the Pallas
    kernels in interpret mode."""
    rows, d = 256, 168
    rng = np.random.default_rng(16)
    x = (rng.standard_normal((2, rows, d)) * 2.0).astype(np.float32)
    edge = gbdi_codec.edge_pages(rows, d)
    x = np.concatenate([x, np.stack([edge[n].numpy()
                                     for n in IN_JAX_RANGE])])
    flat = gbdi_codec.gbdi_compress_kv_ref(
        torch.from_numpy(x.reshape(-1, d)), rows)
    jflat = jax_gbdi.gbdi_compress(jnp.asarray(x.reshape(-1, d)),
                                   rows_per_page=rows, interpret=True)
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(_bytes(a).reshape(-1),
                                      _bytes(b).reshape(-1))
    dec = gbdi_codec.gbdi_decompress_kv_ref(*flat[:4], rows)
    jdec = jax_gbdi.gbdi_decompress(*jflat[:4], rows_per_page=rows,
                                    interpret=True)
    np.testing.assert_array_equal(_bytes(dec), _bytes(jdec))


def _np_pow2(maxres: np.ndarray) -> np.ndarray:
    ratio = (maxres / np.float32(127.0)).astype(np.float32)
    bits = ratio.view(np.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0)
    return np.where(maxres > 0, np.ldexp(np.float64(1.0), e),
                    1.0).astype(np.float32)


def _np_gbdi(x: np.ndarray):
    """The GBDI page encoder in numpy float32 (subnormals kept, 2^e built
    exactly): the oracle where XLA's CPU backend is inexact."""
    a = x[..., 0]
    amin, amax = a.min(-1, keepdims=True), a.max(-1, keepdims=True)
    bases = amin + (amax - amin) * np.float32([0.0, 0.25, 0.5, 1.0])
    bid = np.abs(a[..., None] - bases[:, None, :]).argmin(-1)   # first min
    r = x - np.take_along_axis(bases, bid, 1)[..., None]
    maxr = np.abs(r).max(-1)
    ps = _np_pow2(maxr.max(-1, keepdims=True))
    fits4 = maxr <= np.float32(7.0) * ps
    sc = np.where(fits4, ps, _np_pow2(maxr)).astype(np.float32)
    d = np.clip(np.rint(r / sc[..., None]), -127, 127)
    wid = np.where((d != 0).any(-1), np.where(fits4, 1, 2), 0)
    return (d.astype(np.int8), bases.astype(np.float32), bid.astype(np.int8),
            sc, wid.astype(np.int8))


def test_gbdi_extreme_pages_match_exact_codec():
    x = _edge(EXTREME + IN_JAX_RANGE)
    got = ref.encode_pages_ref(torch.from_numpy(x))
    for g, w in zip(got, _np_gbdi(x)):
        np.testing.assert_array_equal(g.numpy(), w)
    # and they decode to d * scale + base exactly
    dec = ref.decode_pages_ref(*got[:4]).numpy()
    d, bases, bid, sc, _ = _np_gbdi(x)
    want = (d.astype(np.float32) * sc[..., None]
            + np.take_along_axis(bases, bid.astype(np.int64), 1)[..., None])
    np.testing.assert_array_equal(dec, want)


def test_gbdi_span_overflow_page_encodes_as_the_plain_contract():
    """Anchors at +-3e38: the span is inf, base 0 = amin + inf * 0 is
    NaN, every row binds to it (NaN distances never compare smaller),
    and the row encodes with scale 1 and width 2 (the kernel must give
    these bits too: tests/test_torch_cuda.py, chip_smoke.py)."""
    x = torch.from_numpy(_edge(["span_inf"]))
    d, bases, bid, sc, wid = ref.encode_pages_ref(x)
    assert torch.isnan(bases[0, 0]) and torch.isinf(bases[0, 1:]).all()
    assert (bid == 0).all() and (sc == 1.0).all() and (wid == 2).all()


def test_gbdi_width_classes_fire():
    """All three width tags occur and cost what the JAX accounting says
    (``tests/test_codecs.py:339``)."""
    x = torch.from_numpy(_edge(["widths"])).view(1, 2, PAGE, D)
    pg = codecs.GBDI.compress_kv_pages(x, x)
    assert set(pg.kwid.unique().tolist()) == {0, 1, 2}
    jpg = jax_codecs.GBDI.compress_kv_pages(jnp.asarray(x.numpy()),
                                            jnp.asarray(x.numpy()))
    assert int(codecs.GBDI.page_nbytes(pg)[0]) == \
        int(jax_codecs.GBDI.page_nbytes(jpg)[0])


# ---------------------------------------------------------------------------
# fpc and zero: bit patterns
# ---------------------------------------------------------------------------

def test_fpc_edge_patterns_bit_equal_to_jax():
    """-0.0 (class 2, not 0), NaN payloads kept as exceptions, repeat
    chains (NaN repeats included: bit equality), bf16-exact words."""
    words = np.zeros((1, 1, PAGE, 8), np.uint32)
    words[0, 0, 0, 0] = 0x80000000                       # -0.0
    words[0, 0, 1] = 0x3FC00000                          # 1.5, repeated
    words[0, 0, 2, :3] = [0x7FC00001, 0x7FC00001, 0xFF800001]  # NaN payloads
    words[0, 0, 3, ::2] = 0x3DCCCCCD                     # 0.1: exceptions
    words[0, 0, 4] = [0xBF800000, 0x40200000, 0xC2F70000, 0x7F800000,
                      0xFF800000, 0x00010000, 0x80000000, 0x3F800000]
    words[0, 0, 5] = np.arange(8, dtype=np.uint32) * 0x01010101
    x = words.view(np.float32)
    tx = torch.from_numpy(x)
    tpg = codecs.FPC.compress_kv_pages(tx, tx)
    jpg = jax_codecs.FPC.compress_kv_pages(jnp.asarray(x), jnp.asarray(x))
    _assert_trees_bit_equal(tpg, jpg)
    assert set(tpg.kcls.unique().tolist()) == {0, 1, 2, 3}
    for g in codecs.FPC.decompress_pages(tpg):
        np.testing.assert_array_equal(_bytes(g), _bytes(x))   # lossless
    assert int(codecs.FPC.page_nbytes(tpg)[0]) == \
        int(jax_codecs.FPC.page_nbytes(jpg)[0])


def test_zero_codec_mixed_signed_zero_row_decodes_to_plus_zero():
    """A row of mixed +0.0/-0.0 compares equal to its first element, so
    both packages class it ZERO and decode +0.0: not bit-lossless there,
    kept as JAX has it."""
    x = np.zeros((1, 1, PAGE, 8), np.float32)
    x[0, 0, 0, 1::2] = -0.0
    x[0, 0, 1, 0] = -0.0                          # first element -0.0
    x[0, 0, 2] = 7.0                              # repeated value
    x[0, 0, 3, 5] = 1.0                           # exception
    tx = torch.from_numpy(x)
    tpg = codecs.ZERO.compress_kv_pages(tx, tx)
    jpg = jax_codecs.ZERO.compress_kv_pages(jnp.asarray(x), jnp.asarray(x))
    _assert_trees_bit_equal(tpg, jpg)
    assert tpg.kf[0, 0, :4].tolist() == [0, 0, 1, 2]
    k, _ = codecs.ZERO.decompress_pages(tpg)
    np.testing.assert_array_equal(_bytes(k), _bytes(
        jax_codecs.ZERO.decompress_pages(jpg)[0]))
    assert not np.signbit(k.numpy()[0, 0, :2]).any()      # -0.0 lost
    np.testing.assert_array_equal(k.numpy()[0, 0, 2:], x[0, 0, 2:])
