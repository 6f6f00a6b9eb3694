"""The port's CUDA kernels vs their plain versions, on the card.

Every test here needs an NVIDIA Hopper card and nvcc: they carry the
``cuda`` marker and skip without a card.  On the machine with the card
(which has no jax, so this file imports none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the BDI row and tile codecs and the GBDI page codec are
bit-exact (float outputs compared as int32 bit patterns, so a NaN base
compares too); decode attention, with or without the tail, is within
rtol 1e-4 / atol 1e-4 (f32 sums over up to ~4100 keys in another order,
and q scaled before the dot instead of after it), NaN where a sequence
has no token, as in the plain version, and the same bits at every
launch.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import (bdi_compress, bdi_decompress, gbdi_codec,
                                 ops, paged_attention, ref)
from repro_torch.models.params import to_device
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import PagedKVEngine
from repro_torch.serving.parity import GreedyParity, engine_logits

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card and nvcc (run on the chip)")
    from repro_torch.kernels._device import resolve_device
    return resolve_device("cuda")


def _rows(n: int, d: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 2.0).astype(np.float32)
    x[0] = 0.0                                   # all zero
    x[1] = 3.25                                  # constant
    x[2, :6] = [0.0, 100.0, 2.5, -3.5, 0.5, -126.5]   # .5 quotients
    x[3, 1:] = 1e-40                             # subnormal ratio
    x[4, 1:] = 0.0
    x[4, 1] = 1.4e-45                            # ratio 0: 2^-127
    x[5, 1::2], x[5, 2::2] = 1e38, -1e38         # huge, finite
    x[6] = np.linspace(-5e5, 5e5, d)
    return torch.from_numpy(x)


@pytest.mark.parametrize("n,d", [(4096, 128), (520, 16), (77, 64)])
def test_bdi_compress_kv_bit_exact(dev, n, d):
    x = _rows(n, d, n).to(dev)
    for got, want in zip(bdi_compress.bdi_compress_kv(x),
                         ref.compress_rows(x)):
        assert torch.equal(got, want)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# GBDI pages: the staged instance at yi-6b's page (64 x 128, 300 pages),
# small pages and gemma3-27b's (256 x 168: 172 KB of shared memory);
# the generic instance at a D that is no multiple of 4 (77) and at a page
# over the shared-memory budget (512 x 128: 256 KB).  Every case carries
# the edge pages.
@pytest.mark.parametrize("rows,d,pages", [(64, 128, 300), (16, 16, 7),
                                          (24, 36, 5), (256, 168, 6),
                                          (16, 77, 5), (512, 128, 3)])
def test_gbdi_kernels_bit_exact(dev, rows, d, pages):
    gen = torch.Generator().manual_seed(rows + d)
    x = torch.randn((pages, rows, d), generator=gen) * 2.0
    edge = torch.stack(list(gbdi_codec.edge_pages(rows, d).values()))
    x = torch.cat([x, edge]).reshape(-1, d).to(dev)
    got = gbdi_codec.gbdi_compress_kv(x, rows)
    want = gbdi_codec.gbdi_compress_kv_ref(x, rows)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    out = gbdi_codec.gbdi_decompress_kv(*got[:4], rows)
    assert torch.equal(_bits(out),
                       _bits(gbdi_codec.gbdi_decompress_kv_ref(*got[:4],
                                                               rows)))


def test_gbdi_wrappers_count_launches(dev):
    k, v = torch.randn((2, 5, 4, 16, 128), device=dev)
    before = dict(ops.LAUNCHES)
    pages = ops.gbdi_compress_kv_pages(k, v)
    ops.gbdi_decompress_kv_pages(pages)
    assert ops.LAUNCHES["gbdi_compress_kv"] == before["gbdi_compress_kv"] + 2
    assert ops.LAUNCHES["gbdi_decompress_kv"] == \
        before["gbdi_decompress_kv"] + 2


# Tile counts: T 128 takes the 128 instance (4 tiles a warp; the cases
# add 2n + 13 tiles, so no count divides by 4), every other T the generic
# one.
@pytest.mark.parametrize("n,t", [(4096, 128), (77, 8), (300, 256),
                                 (129, 512), (40, 1024), (1, 128),
                                 (33, 128), (4097, 128)])
def test_bdi_tile_kernels_bit_exact(dev, n, t):
    gen = torch.Generator().manual_seed(n + t)
    x = torch.randn((n, t), generator=gen) * 3.0
    big = 50.0 + torch.randn((n, t), generator=gen)
    cluster = torch.where(torch.rand((n, t), generator=gen) < 0.5, big,
                          torch.randn((n, t), generator=gen) * 1e-2)
    cluster[:, 0] = big[:, 0]
    edge = torch.cat(list(bdi_compress.edge_tiles(t).values()))
    x = torch.cat([x, cluster, edge]).to(dev)
    before = dict(ops.LAUNCHES)
    got = ops.compress(x)
    want = ref.compress_ref(x)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(_bits(a), _bits(b)), name
    out = ops.decompress(got)
    assert torch.equal(_bits(out), _bits(ref.decompress_ref(got)))
    assert torch.equal(_bits(out),
                       _bits(bdi_decompress.bdi_decompress(got)))
    assert ops.LAUNCHES["bdi_compress"] == before["bdi_compress"] + 1
    assert ops.LAUNCHES["bdi_decompress"] == before["bdi_decompress"] + 1


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 33, 4097])
def test_bdi_tile_compress_any_tile_count(dev, n):
    """Exactly n tiles of 128, and the same tiles 4 bytes off a 16-byte
    boundary (the launcher then takes the generic instance)."""
    gen = torch.Generator().manual_seed(n)
    x = torch.randn((n, 128), generator=gen) * 3.0
    x[0, 5:9] = x[0, 0]                           # a few base picks
    want = ref.compress_ref(x)
    flat = torch.empty(n * 128 + 1, device=dev)
    shifted = flat[1:].view(n, 128)
    shifted.copy_(x.to(dev))
    for xd in (x.to(dev), shifted):
        got = bdi_compress.bdi_compress(xd)
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(_bits(a.cpu()), _bits(b)), name


def test_roundtrip_tensor_on_card_matches_cpu(dev):
    x = torch.randn((3, 1000, 7), generator=torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        got = ops.roundtrip_tensor(x.to(dtype).to(dev))
        assert torch.equal(_bits(got.float().cpu()),
                           _bits(ops.roundtrip_tensor(x.to(dtype)).float()))


def _attn_args(dev, seed, bsz, kvh, g, d, page, pmax, pool, lengths,
               tail_len):
    gen = torch.Generator().manual_seed(seed)
    k, v = torch.randn((2, pool, kvh, page, d), generator=gen)
    pages = ref.compress_kv_pages(k, v)
    pt = (torch.randperm(pool - 1, generator=gen)[:bsz * pmax] + 1)
    tk, tv = torch.randn((2, bsz, kvh, page, d), generator=gen)
    args = (torch.randn((bsz, kvh, g, d), generator=gen),
            ref.CompressedKVPages(*(t.contiguous() for t in pages)),
            pt.view(bsz, pmax).to(torch.int32),
            torch.tensor(lengths, dtype=torch.int32), tk, tv,
            torch.tensor(tail_len, dtype=torch.int32))
    return tuple(a.to(dev) if isinstance(a, torch.Tensor)
                 else ref.CompressedKVPages(*(t.to(dev) for t in a))
                 for a in args)


# Decode attention cases: the small config and yi-6b's decode shape,
# then lengths at a split edge (64 and 128 tokens at page 16 are 4 and 8
# pages, one split of 4 table entries each) and one past it (65), a
# row with only a tail (a prompt shorter than a page), every row empty,
# a long context (PMAX 256, up to 4096 tokens), D 32 / 64, a G the
# kernel is not specialised for (5) and G 1 at D 16 with pages of 4.
ATTN_CASES = [
    dict(seed=1, bsz=3, kvh=2, g=2, d=16, page=8, pmax=4, pool=16,
         lengths=[16, 0, 29], tail_len=[3, 1, 8]),
    dict(seed=2, bsz=8, kvh=4, g=8, d=128, page=16, pmax=64, pool=600,
         lengths=[1024, 0, 517, 1000, 16, 33, 700, 1023],
         tail_len=[1, 16, 7, 3, 16, 1, 9, 12]),
    dict(seed=5, bsz=5, kvh=2, g=8, d=128, page=16, pmax=16, pool=96,
         lengths=[64, 128, 65, 256, 63], tail_len=[1, 16, 0, 5, 2]),
    dict(seed=6, bsz=3, kvh=4, g=8, d=64, page=16, pmax=4, pool=16,
         lengths=[0, 0, 20], tail_len=[5, 16, 3]),
    dict(seed=7, bsz=2, kvh=2, g=4, d=32, page=16, pmax=4, pool=12,
         lengths=[0, 0], tail_len=[0, 0]),
    dict(seed=8, bsz=4, kvh=2, g=8, d=128, page=16, pmax=256, pool=1100,
         lengths=[4096, 4000, 17, 4095], tail_len=[3, 0, 16, 8]),
    dict(seed=9, bsz=2, kvh=2, g=5, d=64, page=16, pmax=8, pool=24,
         lengths=[100, 37], tail_len=[4, 0]),
    dict(seed=10, bsz=2, kvh=3, g=1, d=16, page=4, pmax=8, pool=20,
         lengths=[30, 5], tail_len=[2, 4]),
    # the generic D: gemma3-27b's head (D 168, G 2) at pages of 16 and 32,
    # D 8 and D 20 (G 3, pages of 12); yi-6b's instance at pages of 32
    # (two warps a page, two pages a split), one length ending in the
    # second half of a page
    dict(seed=11, bsz=4, kvh=3, g=2, d=168, page=16, pmax=12, pool=60,
         lengths=[192, 0, 77, 161], tail_len=[16, 5, 0, 1]),
    dict(seed=12, bsz=4, kvh=3, g=2, d=168, page=32, pmax=6, pool=30,
         lengths=[192, 0, 77, 161], tail_len=[32, 17, 0, 16]),
    dict(seed=13, bsz=3, kvh=2, g=8, d=128, page=32, pmax=9, pool=40,
         lengths=[288, 57, 15], tail_len=[31, 0, 20]),
    dict(seed=14, bsz=3, kvh=2, g=4, d=8, page=8, pmax=5, pool=20,
         lengths=[40, 3, 0], tail_len=[8, 2, 0]),
    dict(seed=15, bsz=2, kvh=2, g=3, d=20, page=12, pmax=5, pool=16,
         lengths=[60, 25], tail_len=[12, 7]),
]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_paged_attention_tail_matches_plain(dev, case):
    args = _attn_args(dev, **case)
    before = dict(ops.LAUNCHES)
    got = ops.paged_attention_tail(*args)
    assert ops.LAUNCHES["paged_attention_tail"] == \
        before["paged_attention_tail"] + 1
    torch.testing.assert_close(got, ref.paged_attention_tail_ref(*args),
                               rtol=1e-4, atol=1e-4, equal_nan=True)
    empty = (args[3] == 0) & (args[6] == 0)
    assert got[empty].isnan().all() and not got[~empty].isnan().any()
    # two launches on the same inputs give the same bits
    assert _same_bits(got, paged_attention.paged_attention_tail(*args))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_paged_attention_matches_plain(dev, case):
    q, pages, pt, lengths, _, _, _ = _attn_args(dev, **case)
    before = dict(ops.LAUNCHES)
    got = ops.paged_attention(q, pages, pt, lengths)
    assert ops.LAUNCHES["paged_attention"] == before["paged_attention"] + 1
    want = ref.paged_attention_ref(q, pages, pt, lengths)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)
    empty = lengths == 0
    assert got[empty].isnan().all() and not got[~empty].isnan().any()
    assert _same_bits(got, paged_attention.paged_attention(q, pages, pt,
                                                           lengths))


def test_paged_attention_refuses_shapes_it_does_not_take(dev):
    """D 6 (no multiple of 4), D 260 (over 256), G*D 1056, pages of 36
    and of 6 rows raise before any launch."""
    args = _attn_args(dev, **ATTN_CASES[0])           # G 2, D 16, page 8
    q, pages = args[0], args[1]
    for bad_q in (q[..., :6].contiguous(),            # D 6
                  q.repeat(1, 1, 1, 17)[..., :260].contiguous(),  # D 260
                  q.repeat(1, 1, 33, 1)):             # G 66, D 16: G*D 1056
        with pytest.raises(ValueError):
            paged_attention.paged_attention(bad_q, pages, *args[2:4])
    for rows in (36, 6):
        bad = ref.CompressedKVPages(*(
            t.repeat_interleave(5, dim=2)[:, :, :rows].contiguous()
            for t in pages))
        with pytest.raises(ValueError):
            paged_attention.paged_attention(q, bad, *args[2:4])


def test_engine_refuses_untaken_shape_on_card(dev):
    cfg = get_arch("yi-6b").reduced(n_layers=1)       # D 16, G 2
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="page=36"):
        PagedKVEngine(cfg, params, page_size=36, codec="bdi", device=dev)
    PagedKVEngine(cfg, params, page_size=36, codec="gbdi", device=dev)


@pytest.mark.parametrize("codec", ["bdi", "gbdi", "adaptive"])
def test_engine_cuda_matches_cpu(dev, codec):
    """The engine on the card (kernels) vs on the CPU (plain versions):
    host decisions equal, greedy tokens equal up to reported bf16 ties,
    and the codec's kernels launched."""
    cfg = get_arch("yi-6b").reduced(n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = {i: [1 + (i * 7 + j * 5) % 250 for j in range(9 + 13 * i)]
               for i in range(6)}
    engs = [PagedKVEngine(cfg, to_device(params, d), page_size=8,
                          n_pool_pages=256, max_batch=8, codec=codec,
                          device=d)
            for d in (dev, "cpu")]
    ops.reset_launches()
    for e in engs:
        e.add_requests(prompts)
    parity = GreedyParity()
    for step in range(20):
        want, got = engs[1].decode_batch(), engs[0].decode_batch()
        parity.check(step, want, got, engine_logits(engs[0]),
                     engine_logits(engs[1]))
    st = [dict(e.stats) for e in engs]
    if not engs[0].codec.ulp_stable_sizes:      # sizes read exact bits
        b = [s.pop("bytes_compressed") for s in st]
        assert abs(b[0] - b[1]) <= 8 * st[0]["pages_compressed"]
    assert st[0] == st[1]
    assert torch.equal(engs[0]._page_table().cpu(), engs[1]._page_table())
    assert (engs[0].page_codec_id == engs[1].page_codec_id).all()
    want = {"bdi": ("bdi_compress_kv", "paged_attention_tail"),
            "gbdi": ("gbdi_compress_kv", "gbdi_decompress_kv"),
            "adaptive": ("bdi_compress_kv", "gbdi_compress_kv",
                         "gbdi_decompress_kv")}[codec]
    assert all(ops.LAUNCHES[k] > 0 for k in want), ops.LAUNCHES
    if codec != "bdi":
        assert ops.LAUNCHES["paged_attention_tail"] == 0, ops.LAUNCHES
