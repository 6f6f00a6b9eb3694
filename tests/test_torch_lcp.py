"""The port's Linearly Compressed Pages vs the JAX package, on the CPU.

``repro_torch.core.lcp`` on the workloads of ``tests/test_lcp.py``,
made from a numpy seed: ``compress_page``, ``decompress_page``,
``read_line`` for every line, ``write_line`` (type-1 overflow, a
compressible update, a page overflow), ``recompact_page``,
``page_nbytes`` and ``page_compression_ratio`` — all bit-exact.  The
exception region ``exc`` is compared on pages that do not overflow:
there every slot takes one line and zeros, so the scatter-add's order
cannot show; on an overflowed page lines collide in the last slot.

Those workloads' smooth lines (base ~100, spread 1e-3) have scales near
2^-15, where XLA's CPU ``exp2`` is a few ULPs off (ROADMAP Queue 3), so
JAX's ``bdi_value._pow2_scale`` is replaced, for these tests only, by
the same exponent arithmetic with 2^e built from bits — the port's
construction.  ``test_jax_scale_differs_only_by_exp2`` shows that this
is the only difference, and ``test_in_range_page_matches_unpatched_jax``
holds the port against the JAX package as it is on a page whose scales
XLA gets exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bdi_value as jbv
from repro.core import lcp as jlcp
from repro_torch.core import lcp

_jax_pow2_scale = jbv._pow2_scale


def _exact_pow2_scale(maxres, qmax):
    ratio = (maxres / qmax).astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(ratio, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0)
    s = jax.lax.bitcast_convert_type(
        jnp.where(e >= -126, (e + 127) << 23, 1 << 22).astype(jnp.int32),
        jnp.float32)
    return jnp.where(maxres > 0, s, jnp.float32(1.0))


@pytest.fixture
def exact_jax_scale(monkeypatch):
    monkeypatch.setattr(jbv, "_pow2_scale", _exact_pow2_scale)


def _page_data(seed, n=64, length=128, wild_rows=(), spread=1e-3):
    """tests/test_lcp.py's pages: smooth lines (large base, tiny spread)
    and gaussian 'wild' rows that become exceptions at tight tolerance."""
    rng = np.random.default_rng(seed)
    base = 100.0 + 10.0 * rng.standard_normal((n, 1))
    x = base + rng.standard_normal((n, length)) * spread
    for r in wild_rows:
        x[r] = np.random.default_rng(1000 + r).standard_normal(length) * 2.0
    return np.ascontiguousarray(x, dtype=np.float32)


def _equal(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _assert_same_page(p: lcp.LCPPage, jp: jlcp.LCPPage):
    for name, g, w in zip(p._fields, p, jp):
        if name == "exc" and bool(jp.overflow):
            continue
        assert g.shape == tuple(np.shape(w)), name
        _equal(g.numpy(), w, name)


def _assert_same_reads(p: lcp.LCPPage, jp: jlcp.LCPPage):
    _equal(lcp.decompress_page(p).numpy(), jlcp.decompress_page(jp))
    for i in range(p.n_lines):
        _equal(lcp.read_line(p, i).numpy(), jlcp.read_line(jp, jnp.int32(i)),
               f"line {i}")
    _equal(lcp.read_line(p, torch.tensor(3)).numpy(),
           jlcp.read_line(jp, jnp.int32(3)))
    for eb in (2, 4):
        assert lcp.page_nbytes(p, eb).item() == int(jlcp.page_nbytes(jp, eb))
        assert lcp.page_compression_ratio(p, eb).item() == \
            float(jlcp.page_compression_ratio(jp, eb))


# (seed, wild rows, exception slots, raw_rtol): tests/test_lcp.py's pages
PAGES = {
    "roundtrip": (0, (), 8, 0.05),
    "exceptions": (1, (3, 17), 8, 1e-4),
    "read_line": (2, (5,), 4, 1e-4),
    "overflow": (3, (), 4, 1e-9),
    "type1": (4, (), 4, 1e-4),
    "compressible": (5, (), 4, 0.05),
    "recompact": (6, (1,), 4, 1e-4),
    "ratio": (7, (), 8, 0.05),
}


@pytest.mark.parametrize("case", list(PAGES))
def test_compress_page_bit_exact_with_jax(case, exact_jax_scale):
    seed, wild, slots, rtol = PAGES[case]
    x = _page_data(seed, wild_rows=wild)
    p = lcp.compress_page(torch.from_numpy(x), slots, rtol)
    jp = jlcp.compress_page(jnp.asarray(x), slots, rtol)
    _assert_same_page(p, jp)
    _assert_same_reads(p, jp)
    assert bool(p.overflow) == (case == "overflow")
    if wild and rtol < 1e-3:
        for r in wild:                       # exceptions come back exact
            _equal(lcp.read_line(p, r).numpy(), x[r])


# (page, line written, new line): type-1 overflow, a compressible
# update, an update that overflows the page, and recompaction
WRITES = {
    "type1": ("type1", 7, "wild"),
    "compressible": ("compressible", 0, "const"),
    "page_overflow": ("exceptions", 40, "wild"),
    "recompact": ("recompact", 1, "ones"),
}


@pytest.mark.parametrize("case", list(WRITES))
def test_write_line_bit_exact_with_jax(case, exact_jax_scale):
    page, i, kind = WRITES[case]
    seed, wild, slots, rtol = PAGES[page]
    if case == "page_overflow":
        slots = 2                            # both slots taken by wild rows
    x = _page_data(seed, wild_rows=wild)
    new = {"wild": np.random.default_rng(99).standard_normal(128) * 2.0,
           "const": np.full(128, 2.5),
           "ones": np.ones(128)}[kind].astype(np.float32)
    p = lcp.compress_page(torch.from_numpy(x), slots, rtol)
    jp = jlcp.compress_page(jnp.asarray(x), slots, rtol)
    p2, t1 = lcp.write_line(p, i, torch.from_numpy(new), rtol)
    jp2, jt1 = jlcp.write_line(jp, jnp.int32(i), jnp.asarray(new), rtol)
    assert bool(t1) == bool(jt1) == (kind == "wild")
    _assert_same_page(p2, jp2)
    _assert_same_reads(p2, jp2)
    assert bool(p2.overflow) == (case == "page_overflow")
    p3 = lcp.recompact_page(p2, rtol)
    _assert_same_page(p3, jlcp.recompact_page(jp2, rtol))
    if case == "recompact":
        assert int(p3.n_exc) == 0


def test_jax_scale_differs_only_by_exp2():
    x = jnp.asarray(_page_data(0))
    maxres = jnp.abs(x - x[:, :1]).max(axis=1)
    exact, jax_ = _exact_pow2_scale(maxres, 127.0), _jax_pow2_scale(maxres,
                                                                     127.0)
    ulps = np.abs(np.asarray(exact).view(np.int32)
                  - np.asarray(jax_).view(np.int32))
    assert ulps.max() <= 8 and (ulps > 0).any()


def test_in_range_page_matches_unpatched_jax():
    x = _page_data(11, wild_rows=(2, 9), spread=1.0)   # scales ~2^-5
    p = lcp.compress_page(torch.from_numpy(x), 4, 1e-3)
    jp = jlcp.compress_page(jnp.asarray(x), 4, 1e-3)
    assert int(jp.n_exc) == 2 and not bool(jp.overflow)
    _assert_same_page(p, jp)
    _assert_same_reads(p, jp)
