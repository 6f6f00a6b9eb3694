"""The port's value-space BDI tile codec vs the JAX package, on the CPU.

* ``repro_torch.core.bdi_value`` is bit-exact with ``repro.core.bdi_value``
  (int8 and int16 deltas, with and without ``raw_rtol``), and so are
  its size accounting, byte-layout mask packing and tensor folding.
* The plain versions of the tile kernels (``kernels/ref.py``
  ``compress_ref``, ``decompress_ref``) are bit-exact with JAX's oracles
  and with the Pallas kernels in interpret mode (``repro.kernels.ops``),
  and the port's ``ops`` wrappers (plain versions for CPU tensors) and
  ``roundtrip_tensor`` with JAX's.
* XLA's CPU backend flushes subnormals and its ``exp2`` is a few ULPs
  off for integer exponents beyond about +-12, so the JAX oracle's scale
  is no power of two there: the edge tiles with such scales are held
  against an exact numpy construction of the codec instead.
* The CUDA kernels vs the plain versions: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bdi_value as jbv
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import bdi_value as bv
from repro_torch.kernels import bdi_compress, ops, ref


# jitted: one XLA compile per shape instead of one per op (the sweep
# below has twelve shapes); the same ops, so the same bits
_jax_compress_ref = jax.jit(jax_ref.compress_ref)
_jax_decompress_ref = jax.jit(jax_ref.decompress_ref)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _equal(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _tile_data(seed: int, n: int, t: int, kind: str) -> np.ndarray:
    """The five data kinds of tests/test_kernels.py, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        x = rng.standard_normal((n, t)) * 3.0
    elif kind == "zeros":
        x = np.zeros((n, t))
    elif kind == "rep":
        x = np.broadcast_to(rng.standard_normal((n, 1)), (n, t))
    elif kind == "sparse_cluster":
        big = 50.0 + rng.standard_normal((n, t))
        x = np.where(rng.random((n, t)) < 0.5, big,
                     rng.standard_normal((n, t)) * 1e-2)
        x[:, 0] = big[:, 0]
    elif kind == "mixed":
        x = np.concatenate([np.zeros((1, t)), np.full((1, t), 7.5),
                            rng.standard_normal((max(n - 2, 1), t))])[:n]
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(x, dtype=np.float32)


# edge tiles whose scales XLA's CPU exp2 gets exactly (2^-12 .. 2^12)
JAX_EXACT_EDGES = ("zero", "neg_zero", "mixed_zero", "constant",
                   "half_base", "halves", "sparse_cluster")


# ---------------------------------------------------------------------------
# core/bdi_value.py
# ---------------------------------------------------------------------------

def _value_data(seed: int, t: int = 128) -> np.ndarray:
    """Gaussian, sparse-cluster, zero, constant and mixed +-0.0 tiles,
    an element at exactly base/2; max residuals of 8 or more, so the
    scales of int8 and of int16 deltas lie inside 2^-12..2^12."""
    x = np.concatenate([_tile_data(seed, 12, t, "gauss") * 40.0,
                        _tile_data(seed + 1, 8, t, "sparse_cluster") * 8.0,
                        _tile_data(seed + 2, 4, t, "mixed") * 8.0])
    x[-1] = -0.0
    x[-1, 1::2] = 0.0
    x[-2, 0], x[-2, 1] = 4.0, 2.0                # base/2 takes the zero base
    return x


@pytest.mark.parametrize("delta_dtype,raw_rtol", [
    ("int8", None), ("int8", 1e-3), ("int16", None), ("int16", 2e-5)])
def test_compress_tiles_bit_exact_with_jax(delta_dtype, raw_rtol):
    x = _value_data(3)
    got = bv.compress_tiles(_t(x), delta_dtype=getattr(torch, delta_dtype),
                            raw_rtol=raw_rtol)
    want = jbv.compress_tiles(jnp.asarray(x),
                              delta_dtype=getattr(jnp, delta_dtype),
                              raw_rtol=raw_rtol)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == getattr(torch, str(np.asarray(w).dtype)), name
        _equal(g.numpy(), w, name)
    if raw_rtol is not None:
        assert (got.enc == bv.ENC_RAW).any()     # the tag is exercised
    assert (got.enc == bv.ENC_ZERO).sum() == 2 and got.base[-1].item() == 0
    assert not torch.signbit(got.base[-1])       # mixed +-0.0: base +0.0
    assert not got.mask[-2, 1]                   # base/2: the zero base
    _equal(bv.decompress_tiles(got).numpy(), jbv.decompress_tiles(want))
    _equal(bv.decompress_tiles(got, torch.bfloat16).float().numpy(),
           jbv.decompress_tiles(want, jnp.bfloat16).astype(jnp.float32))
    _equal(bv.error_bound(got).numpy(), jbv.error_bound(want))
    for eb in (2, 4):
        _equal(bv.tile_size_bytes(got.enc, 128, eb).numpy(),
               jbv.tile_size_bytes(want.enc, 128, eb))
        assert bv.compression_ratio(got, eb).item() == \
            float(jbv.compression_ratio(want, eb))


def test_tile_size_bytes_every_encoding():
    enc = np.array([0, 1, 2, 3, 7, 5], np.int8)
    for t, eb in ((128, 2), (64, 4), (256, 1)):
        _equal(bv.tile_size_bytes(_t(enc), t, eb).numpy(),
               jbv.tile_size_bytes(jnp.asarray(enc), t, eb))


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 128), (7, 16)])
def test_pack_mask_matches_jax(shape):
    m = np.random.default_rng(len(shape)).random(shape) < 0.4
    got = bv.pack_mask(_t(m))
    _equal(got.numpy(), jbv.pack_mask(jnp.asarray(m)))
    assert got.dtype == torch.uint8
    assert torch.equal(bv.unpack_mask(got), _t(m))
    with pytest.raises(ValueError):
        bv.pack_mask(torch.zeros(3, 12, dtype=torch.bool))


def test_bit_plane_and_byte_layouts_differ():
    m = torch.zeros(1, 128, dtype=torch.bool)
    m[0, 1] = True                      # element 1: byte 0 bit 1 vs byte 1
    assert bv.pack_mask(m)[0, 0] == 2
    assert ref.pack_mask_bitplane(m)[0, 1] == 1
    mp = np.random.default_rng(0).random((4, 256)) < 0.5
    got = ref.pack_mask_bitplane(_t(mp))
    _equal(got.numpy(), jax_ref.pack_mask_bitplane(jnp.asarray(mp)))
    assert torch.equal(ref.unpack_mask_bitplane(got), _t(mp))


@pytest.mark.parametrize("shape,tile", [((3, 37, 5), 128), ((1000,), 128),
                                        ((4, 32), 64), ((11,), 8)])
def test_fold_and_tensor_codec_match_jax(shape, tile):
    x = np.random.default_rng(tile).standard_normal(shape).astype(np.float32)
    tiles, n = bv.fold_to_tiles(_t(x), tile)
    jtiles, jn = jbv.fold_to_tiles(jnp.asarray(x), tile)
    assert n == jn
    _equal(tiles.numpy(), jtiles)
    _equal(bv.unfold_from_tiles(tiles, n, shape).numpy(), x)
    c, n = bv.compress_tensor(_t(x), tile)
    jc, _ = jbv.compress_tensor(jnp.asarray(x), tile)
    for name, g, w in zip(c._fields, c, jc):
        _equal(g.numpy(), w, name)
    _equal(bv.decompress_tensor(c, n, shape).numpy(),
           jbv.decompress_tensor(jc, n, shape))


# ---------------------------------------------------------------------------
# kernels/ref.py tile half, the ops wrappers and the Pallas kernels
# ---------------------------------------------------------------------------

N_ROWS = (8, 16, 64, 100)
KINDS = ("gauss", "zeros", "rep", "sparse_cluster", "mixed")


@pytest.mark.parametrize("n", N_ROWS)
@pytest.mark.parametrize("t", [128, 256, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_codec_bit_exact_with_jax(n, t, kind):
    x = _tile_data(n * t, n, t, kind)
    got = ref.compress_ref(_t(x))
    for name, g, w in zip(got._fields, got,
                          _jax_compress_ref(jnp.asarray(x))):
        _equal(g.numpy(), w, name)
    for g, w in zip(ops.compress(_t(x)), got):        # CPU: plain version
        assert torch.equal(g, w)
    jp = jax_ref.PackedTiles(*(jnp.asarray(a.numpy()) for a in got))
    out = ref.decompress_ref(got)
    assert torch.equal(ops.decompress(got), out)
    _equal(out.numpy(), _jax_decompress_ref(jp))


@pytest.mark.parametrize("t", [128, 256, 512])
def test_tile_codec_bit_exact_with_pallas_kernels(t):
    """Against the Pallas kernels in interpret mode, on every (n, kind)
    block of the sweep above stacked into one call per t (one interpret
    compile each, not twenty)."""
    x = np.concatenate([_tile_data(n * t, n, t, kind)
                        for n in N_ROWS for kind in KINDS])
    got = ref.compress_ref(_t(x))
    for name, g, w in zip(got._fields, got, jax_ops.compress(jnp.asarray(x))):
        _equal(g.numpy(), w, name)
    jp = jax_ref.PackedTiles(*(jnp.asarray(a.numpy()) for a in got))
    _equal(ref.decompress_ref(got).numpy(), jax_ops.decompress(jp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip_tensor_bit_exact_with_jax(dtype):
    x = (np.random.default_rng(9).standard_normal((3, 37, 5)) * 4.0
         ).astype(np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = ops.roundtrip_tensor(tx)
    want = jax_ops.roundtrip_tensor(jx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _numpy_tile_codec(x: np.ndarray):
    """The tile codec in numpy float32, the scale built exactly
    (np.ldexp), subnormals kept: the oracle for tiles XLA's CPU backend
    mangles."""
    base = x[:, 0]
    with np.errstate(over="ignore", invalid="ignore"):
        rb = (x - base[:, None]).astype(np.float32)
        mask = np.abs(rb) < np.abs(x)
        r = np.where(mask, rb, x)
        maxres = np.abs(r).max(axis=1)
        ratio = (maxres / np.float32(127.0)).astype(np.float32)
        bits = ratio.view(np.int32)
        e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0)
        scale = np.where(maxres > 0, np.ldexp(np.float64(1.0), e),
                         1.0).astype(np.float32)
        d = np.clip(np.rint(r / scale[:, None]), -127, 127)
    is_zero = np.abs(x).max(axis=1) == 0
    is_rep = (x == base[:, None]).all(axis=1) & ~is_zero
    enc = np.where(is_zero, 0, np.where(is_rep, 1, 2)).astype(np.int32)
    simple = (is_zero | is_rep)[:, None]
    d = np.where(simple, 0, d).astype(np.int8)
    mask = np.where(is_zero[:, None], False, np.where(is_rep[:, None], True,
                                                      mask))
    w = x.shape[1] // 8
    planes = mask.reshape(len(x), 8, w).astype(np.uint8)
    maskp = (planes << np.arange(8, dtype=np.uint8)[:, None]).sum(
        axis=1).astype(np.uint8)
    base = np.where(is_zero, np.float32(0.0), base).astype(np.float32)
    return d, base[:, None], scale[:, None], maskp, enc[:, None]


@pytest.mark.parametrize("t", [16, 128, 512])
def test_edge_tiles_match_exact_codec(t):
    edges = bdi_compress.edge_tiles(t)
    x = torch.cat(list(edges.values()))
    got = ref.compress_ref(x)
    for name, g, w in zip(got._fields, got, _numpy_tile_codec(x.numpy())):
        _equal(g.numpy(), w, name)
    names = list(edges)
    assert got.enc[names.index("mixed_zero"), 0] == bv.ENC_ZERO
    assert got.enc[names.index("neg_zero"), 0] == bv.ENC_ZERO
    assert got.base[names.index("neg_zero"), 0].view(torch.int32) == 0
    assert got.scale[names.index("ratio0"), 0].item() == 2.0 ** -127
    huge = names.index("huge_overflow")
    assert torch.isinf(x[huge, 1] - x[huge, 0])            # residual inf
    assert not ref.unpack_mask_bitplane(got.maskp)[huge, 1]  # zero base
    # the decompressor reproduces the masked FMA exactly
    out = ref.decompress_ref(got)
    d, b, s, mp, _ = _numpy_tile_codec(x.numpy())
    m = ref.unpack_mask_bitplane(torch.from_numpy(mp)).numpy()
    _equal(out.numpy(), (d.astype(np.float32) * s
                         + m.astype(np.float32) * b).astype(np.float32))
    # where XLA is exact, JAX agrees too
    keep = [names.index(k) for k in JAX_EXACT_EDGES]
    want = jax_ref.compress_ref(jnp.asarray(x.numpy()[keep]))
    for name, g, w in zip(got._fields, got, want):
        _equal(g.numpy()[keep], w, name)


def test_cuda_tile_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import bdi_decompress
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError):
        bdi_compress.bdi_compress(x)
    with pytest.raises(ValueError):
        bdi_decompress.bdi_decompress(ref.compress_ref(x))
