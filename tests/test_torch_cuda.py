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
from repro_torch.models.params import leaves, to_device
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
    # the shapes of the split over 16-row slots: pages of 64 and 128 (a
    # split a page, half a page), 36 (slots of 16, 16 and 4) and 6 (no
    # multiple of 4: P.V's padding masked), G 16 at D 128 (two head
    # groups), D 6 and D 260 (byte rows), and 5,001 splits (the combine
    # in chunks)
    dict(seed=16, bsz=3, kvh=2, g=8, d=128, page=64, pmax=5, pool=16,
         lengths=[320, 0, 65], tail_len=[64, 3, 0]),
    dict(seed=17, bsz=2, kvh=2, g=8, d=128, page=128, pmax=3, pool=8,
         lengths=[384, 129], tail_len=[100, 17]),
    dict(seed=18, bsz=3, kvh=2, g=2, d=168, page=36, pmax=4, pool=14,
         lengths=[144, 37, 0], tail_len=[36, 0, 20]),
    dict(seed=19, bsz=2, kvh=2, g=4, d=16, page=6, pmax=6, pool=14,
         lengths=[35, 6], tail_len=[5, 6]),
    dict(seed=20, bsz=2, kvh=2, g=16, d=128, page=16, pmax=6, pool=14,
         lengths=[96, 17], tail_len=[16, 3]),
    dict(seed=21, bsz=2, kvh=2, g=4, d=6, page=16, pmax=5, pool=12,
         lengths=[80, 9], tail_len=[3, 16]),
    dict(seed=22, bsz=2, kvh=2, g=2, d=260, page=16, pmax=5, pool=12,
         lengths=[80, 9], tail_len=[3, 16]),
    dict(seed=23, bsz=1, kvh=1, g=2, d=16, page=4, pmax=20000, pool=20001,
         lengths=[79999], tail_len=[3]),
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


def test_paged_attention_takes_every_shape(dev):
    """D 6 (no multiple of 4), D 260 (over 256), G*D 1056, pages of 36
    and of 6 rows: each launches and matches the plain version."""
    args = _attn_args(dev, **ATTN_CASES[0])           # G 2, D 16, page 8
    q, pages = args[0], args[1]
    for bad_q in (q[..., :6].contiguous(),            # D 6
                  q.repeat(1, 1, 1, 17)[..., :260].contiguous(),  # D 260
                  q.repeat(1, 1, 33, 1)):             # G 66, D 16: G*D 1056
        d = bad_q.shape[-1]
        pg = ref.compress_kv_pages(
            *(torch.randn(pages.kd.shape[:3] + (d,), device=dev,
                          generator=torch.Generator(dev).manual_seed(d))
              for _ in range(2)))
        torch.testing.assert_close(
            paged_attention.paged_attention(bad_q, pg, *args[2:4]),
            ref.paged_attention_ref(bad_q, pg, *args[2:4]), rtol=1e-4,
            atol=1e-4, equal_nan=True)
    for rows in (36, 6):
        pg = ref.CompressedKVPages(*(
            t.repeat_interleave(5, dim=2)[:, :, :rows].contiguous()
            for t in pages))
        torch.testing.assert_close(
            paged_attention.paged_attention(q, pg, *args[2:4]),
            ref.paged_attention_ref(q, pg, *args[2:4]), rtol=1e-4,
            atol=1e-4, equal_nan=True)


def test_engine_serves_any_page_on_card(dev):
    """The engine builds at a page of 36 rows under bdi, whose decode
    goes through the kernel, and its steps match the CPU's."""
    cfg = get_arch("yi-6b").reduced(n_layers=1)       # D 16, G 2
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engines = [PagedKVEngine(cfg, params, page_size=36, codec="bdi",
                             device=d) for d in (dev, "cpu")]
    for e in engines:
        e.add_requests({0: list(range(1, 80)), 1: list(range(3, 40))})
    before = dict(ops.LAUNCHES)
    for _ in range(4):
        got, want = (e.decode_batch() for e in engines)
        assert got == want
    assert ops.LAUNCHES["paged_attention_tail"] > \
        before["paged_attention_tail"]


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


@pytest.mark.parametrize("codec", ["bdi", "gbdi"])
def test_scheduler_cuda_matches_cpu(dev, codec):
    """The scheduler over a prefix-cached engine on the card and on the
    CPU, in lockstep: scheduler and engine stats, page tables and the
    cache's state equal after every iteration, tokens equal up to
    reported bf16 ties, warm hits taken and the codec's kernels
    launched."""
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg = get_arch("yi-6b").reduced(n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sysp = [1 + (j * 7) % 250 for j in range(24)]
    prompts = {i: sysp + [1 + (i * 5 + j * 3) % 250 for j in range(3 + 4 * i)]
               for i in range(6)}
    scheds = [ContinuousScheduler(
        PagedKVEngine(cfg, to_device(params, d), page_size=8,
                      n_pool_pages=64, max_batch=4, codec=codec,
                      prefix_cache=PrefixCache.for_model(cfg, 8), device=d),
        token_budget=24) for d in (dev, "cpu")]
    gpu, rows = scheds[0].engine, {}
    inner = gpu.mixed_step

    def mixed_step(*a, **kw):            # keep the rows of the step's tokens
        out, completed = inner(*a, **kw)
        rows.update({s: gpu.last_logits[gpu.seqs[s].slot] for s in out})
        return out, completed

    gpu.mixed_step = mixed_step
    ops.reset_launches()
    parity = GreedyParity()
    for it in range(300):
        for s in scheds:
            if it < len(prompts):
                s.submit(it, prompts[it], max_new_tokens=10)
        if it >= len(prompts) and all(s.idle for s in scheds):
            break
        got, want = (s.step()["decoded"] for s in scheds)
        parity.check(it, want, got, rows.__getitem__)
        if parity.ties:
            break                      # the schedules may part after a tie
        a, b = (s.engine for s in scheds)
        assert scheds[0].stats == scheds[1].stats
        assert a.stats == b.stats
        assert torch.equal(a._page_table().cpu(), b._page_table())
        assert a.prefix_cache.state() == b.prefix_cache.state()
    assert scheds[0].stats["prefix_cached_tokens"] > 0
    want = {"bdi": ("bdi_compress_kv", "paged_attention_tail"),
            "gbdi": ("gbdi_compress_kv", "gbdi_decompress_kv")}[codec]
    assert all(ops.LAUNCHES[k] > 0 for k in want), ops.LAUNCHES


def _tiered(cfg, params, d, *, codec="bdi"):
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.tier import TieredPageStore
    eng = PagedKVEngine(cfg, to_device(params, torch.device(d)), page_size=8,
                        n_pool_pages=96, max_batch=4, codec=codec,
                        prefix_cache=PrefixCache.for_model(cfg, 8), device=d)
    eng.attach_tier(TieredPageStore.for_model(cfg, 8, eng.codec, host_mb=4))
    return eng


def _chain_bytes(eng, chain) -> list[bytes]:
    from repro_torch.serving._tree import tree_leaves
    pools = [lf.cpu() for lf in tree_leaves(eng.pools)]
    return [b"".join(lf[li, eng.prefix_cache.entries[eid].pages[li]]
                     .contiguous().view(torch.uint8).numpy().tobytes()
                     for lf in pools for li in range(eng.cfg.n_layers))
            for eid in chain]


@pytest.mark.parametrize("codec", ["bdi", "gbdi"])
def test_tier_round_trip_on_card_byte_equal_to_cpu(dev, codec, tmp_path):
    """Pages demoted from the card and promoted back are the bits they
    were; the tier persisted on the card restores on the CPU with the
    same slot bytes and checksums, and the CPU engine promotes the same
    page bytes out of it."""
    from repro_torch.serving.tier import TieredPageStore
    cfg = get_arch("yi-6b").reduced(n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = [1 + (j * 7) % 250 for j in range(33)]
    gpu = _tiered(cfg, params, dev, codec=codec)
    gpu.add_requests({0: prompt})
    before = _chain_bytes(gpu, gpu.seqs[0].chain)
    gpu.release(0)
    gpu.recycle_device_pool()
    assert gpu.add_requests({1: prompt})[1] == 32
    assert _chain_bytes(gpu, gpu.seqs[1].chain) == before
    gpu.release(1)
    gpu.debug_validate()
    gpu.tier.persist(str(tmp_path))
    cpu_tier = TieredPageStore.restore(str(tmp_path), cfg, gpu.codec,
                                       host_mb=4)
    assert np.array_equal(cpu_tier.tier_arrays()["tier_data"],
                          gpu.tier.tier_arrays()["tier_data"])
    assert cpu_tier.meta_state()["records"] \
        == gpu.tier.meta_state()["records"]
    cpu = _tiered(cfg, params, "cpu", codec=codec)
    cpu.tier = None
    cpu.attach_tier(cpu_tier)
    assert cpu.add_requests({2: prompt})[2] == 32
    assert _chain_bytes(cpu, cpu.seqs[2].chain) == before
    cpu.debug_validate()


def test_bit_flip_in_device_pool_caught_by_verify_seq(dev):
    from repro_torch.serving import faults as F
    cfg = get_arch("yi-6b").reduced(n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = PagedKVEngine(cfg, to_device(params, dev), page_size=8,
                        n_pool_pages=64, max_batch=4, device=dev)
    eng.add_requests({0: [1 + (j * 3) % 250 for j in range(21)]})
    assert eng.verify_seq(0)
    pid = eng.seqs[0].pages[1][-1]
    F.FaultInjector(seed=0).corrupt_page(eng, 1, pid)
    assert eng.pools.kd.device.type == "cuda"        # flipped in place there
    assert not eng.verify_seq(0) and eng.seqs[0].corrupted


def test_snapshot_on_card_restores_on_cpu(dev, tmp_path):
    """A scheduler snapshot taken mid-stream on the card finishes on the
    CPU with the tokens the card's uninterrupted run gives."""
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.snapshot import restore_snapshot, save_snapshot
    cfg = get_arch("yi-6b").reduced(n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = PagedKVEngine(cfg, to_device(params, dev), page_size=8,
                        n_pool_pages=96, max_batch=2, device=dev,
                        prefix_cache=PrefixCache.for_model(cfg, 8))
    sched = ContinuousScheduler(eng, token_budget=24)
    sysp = [1 + (j * 7) % 250 for j in range(16)]
    for r in range(3):
        sched.submit(r, sysp + [3 + r, 9, 27 + r], max_new_tokens=10)
    while not sched._running:
        sched.step()
    sched.step()
    save_snapshot(str(tmp_path), eng, sched)
    fin = sched.run()
    eng2, sched2 = restore_snapshot(str(tmp_path), cfg, params, device="cpu")
    assert eng2.device.type == "cpu"
    fin2 = sched2.run()
    eng2.debug_validate()
    assert {r: t.out_tokens for r, t in fin2.items()} \
        == {r: t.out_tokens for r, t in fin.items()}


def _count_device_reads(monkeypatch) -> list:
    """Count every read of a CUDA tensor's values on the host (``.cpu``,
    ``.item``, ``.tolist``, ``int``/``float``/``bool``): each is a sync."""
    reads = []
    for name in ("cpu", "item", "tolist", "__int__", "__float__",
                 "__bool__", "__index__"):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, _real=real, _name=name, **kw):
            if self.is_cuda:
                reads.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return reads


def test_observatory_publish_rides_the_single_host_sync(dev, monkeypatch):
    """An adaptive publish with an observatory attached reads every
    member's would-be page bytes back in the one device-to-host copy the
    publish makes without it: one read a publish either way."""
    from repro_torch.serving.observatory import Observatory
    from repro_torch.serving.telemetry import Telemetry
    cfg = get_arch("yi-6b").reduced(n_layers=2)
    params = to_device(init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu"), dev)
    prompts = {i: [1 + (i * 7 + j * 5) % 250 for j in range(25)]
               for i in range(3)}
    per_publish = {}
    for observe in (False, True):
        tel = Telemetry()
        eng = PagedKVEngine(cfg, params, page_size=8, n_pool_pages=64,
                            max_batch=4, codec="adaptive", telemetry=tel,
                            observatory=Observatory(tel) if observe
                            else None, device=dev)
        inner, counts = eng._publish, []

        def publish(*a, _inner=inner, _counts=counts, **kw):
            reads = _count_device_reads(monkeypatch)
            _inner(*a, **kw)
            _counts.append(list(reads))
            monkeypatch.undo()
        eng._publish = publish
        eng.add_requests(prompts)
        assert counts
        per_publish[observe] = counts
        if observe:
            wb = eng.obs.codec_shadow.bytes
            assert set(wb) == {"bdi", "zero", "raw", "gbdi", "fpc"}
            assert eng.obs.codec_shadow.pages == eng.stats[
                "pages_compressed"]
    assert per_publish[True] == per_publish[False]
    assert all(c == ["cpu"] for c in per_publish[True])


def test_reference_oracle_pools_on_host_math_on_card(dev):
    """The oracle on ``device="cuda"``: its pools stay on the host, its
    tails, scratch and model math on the card, its publishes through the
    codec's kernel; tokens equal the CPU oracle's up to reported ties."""
    from repro_torch.serving._tree import tree_leaves
    from repro_torch.serving.reference import ReferencePagedKVEngine
    cfg = get_arch("yi-6b").reduced(n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = {i: [1 + (i * 7 + j * 5) % 250 for j in range(9 + 13 * i)]
               for i in range(3)}
    engs = [ReferencePagedKVEngine(cfg, to_device(params, d), page_size=8,
                                   n_pool_pages=96, device=d)
            for d in (dev, "cpu")]
    ops.reset_launches()
    for e in engs:
        e.add_requests(prompts)
    assert ops.LAUNCHES["bdi_compress_kv"] > 0, ops.LAUNCHES
    parity = GreedyParity()
    for step in range(10):
        got = {s: engs[0].decode_one(s) for s in prompts}
        want = {s: engs[1].decode_one(s) for s in prompts}
        parity.check(step, want, got, engs[0].last_logits.__getitem__,
                     engs[1].last_logits.__getitem__)
    card = engs[0]
    assert {lf.device.type for lf in tree_leaves(card.pools)} == {"cpu"}
    assert card.seqs[0].tail_k.device.type == "cuda"
    assert card.params["embed"]["w"].device.type == "cuda"
    assert card.last_logits[0].device.type == "cuda"
    assert card.stats == engs[1].stats
    assert (card.page_bytes == engs[1].page_bytes).all()


# ---------------------------------------------------------------------------
# training: AdamW's tile-stored moments through the tile kernels
# ---------------------------------------------------------------------------

def _opt_inputs(step: int) -> tuple[dict, dict]:
    """Params (bf16 weights, an f32 norm, a leaf not in 128-wide tiles)
    and step ``step``'s gradients, made with numpy."""
    rng = np.random.default_rng(step)

    def t(shape, scale, dtype):
        g = rng.standard_normal(shape) * np.exp(rng.uniform(-6, 0, shape))
        return torch.from_numpy((g * scale).astype(np.float32)).to(dtype)
    shapes = {"w": ((3, 64, 256), torch.bfloat16),
              "ln": ((3, 64), torch.float32),
              "odd": ((256, 40), torch.bfloat16)}
    params = {k: t(s, 1.0, d) for k, (s, d) in shapes.items()}
    grads = {k: t(s, 1e-2, d) for k, (s, d) in shapes.items()}
    return params, grads


@pytest.mark.parametrize("md", ["bdi8", "q8"])
def test_adamw_on_card_matches_cpu(dev, md, monkeypatch):
    """Three updates on the card and on the CPU from the same inputs, big
    leaves in row groups: the moment state bit-equal (under bdi8 made by
    the tile kernels, under q8 by plain tensor ops), the params within
    one bf16 ULP (``b ** step`` may differ by an f32 ULP)."""
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "BIG_LEAF", 1 << 12)
    cfg = adamw.AdamWConfig(moment_dtype=md, grad_clip=1e9)
    params = _opt_inputs(0)[0]
    cpu = {k: v.clone() for k, v in params.items()}
    card = to_device(params, dev)
    s_cpu, s_card = adamw.adamw_init(cpu, cfg), adamw.adamw_init(card, cfg)
    ops.reset_launches()
    for step in range(1, 4):
        g = _opt_inputs(step)[1]
        cpu, s_cpu, _ = adamw.adamw_update(cpu, g, s_cpu, cfg)
        card, s_card, _ = adamw.adamw_update(card, to_device(g, dev),
                                             s_card, cfg)
    torch.cuda.synchronize()
    want = md == "bdi8"
    assert (ops.LAUNCHES["bdi_compress"] > 0) == want, ops.LAUNCHES
    assert (ops.LAUNCHES["bdi_decompress"] > 0) == want, ops.LAUNCHES
    for key in ("m", "v"):
        for a, b in zip(leaves(s_cpu[key]), leaves(s_card[key])):
            assert a.dtype == b.dtype and torch.equal(_bits(a),
                                                      _bits(b.cpu()))
    assert int(s_card["step"]) == 3
    for k in params:
        a, b = cpu[k].float(), card[k].float().cpu()
        mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((a - b).abs() <= ulp).all()), k


def test_moment_mask_layout_round_trip_on_card(dev):
    """The state's byte-layout mask and the tile kernels' bit planes
    convert both ways on the card, as on the CPU."""
    from repro_torch.core import bdi_value as bv
    from repro_torch.optim import adamw
    mask = torch.from_numpy(np.random.default_rng(4).random((999, 128))
                            < 0.3)
    byte, plane = bv.pack_mask(mask), ref.pack_mask_bitplane(mask)
    got = adamw.to_byte_mask(plane.to(dev))
    assert torch.equal(got.cpu(), byte)
    assert torch.equal(adamw.to_bitplane_mask(got).cpu(), plane)
    # a compress on the card, converted, equals the CPU store's mask
    x = torch.randn((999, 128), generator=torch.Generator().manual_seed(5))
    p = ops.compress(x.to(dev))
    assert torch.equal(adamw.to_byte_mask(p.maskp).cpu(),
                       bv.pack_mask(bv.compress_tiles(x).mask))


def test_train_runs_on_card_through_the_tile_kernels(dev, tmp_path):
    """``train()`` on the card under bdi8 and on the CPU, each resuming
    one step-0 checkpoint of a CPU init, through both tile kernels on the
    card (the default device): the first loss within rtol 1e-4, the six
    within 1e-2; then the card resumes the CPU run's step-5 checkpoint and
    takes step 6 as the CPU did, held to ``tests/test_torch_train.py``'s
    one-step bounds (params within one bf16 ULP for 99% of each leaf,
    moments within a relative error of 2e-2)."""
    import shutil

    from test_torch_train import (_copy, assert_one_step_matches,
                                  load_ckpt)

    from repro_torch.checkpoint import store
    from repro_torch.launch.train import train
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import export_state
    cfg = get_arch("yi-6b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    store.save(str(tmp_path / "init"), 0, (params, export_state(adamw_init(
        params, AdamWConfig(moment_dtype="bdi8")))),
        extra={"next_step": 0, "data_seed": 0, "loss": None})
    for d in ("card", "cpu"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    kw = dict(smoke=True, steps=6, seq_len=32, batch=4, moment_dtype="bdi8",
              log_every=100, ckpt_every=5)
    ops.reset_launches()
    card = train("yi-6b", ckpt_dir=str(tmp_path / "card"), **kw)
    assert card["params"]["embed"]["w"].device.type == "cuda"
    assert ops.LAUNCHES["bdi_compress"] > 0, ops.LAUNCHES
    assert ops.LAUNCHES["bdi_decompress"] > 0, ops.LAUNCHES
    cpu = train("yi-6b", device="cpu", ckpt_dir=str(tmp_path / "cpu"), **kw)
    assert all(np.isfinite(card["losses"]))
    np.testing.assert_allclose(card["losses"][0], cpu["losses"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-2)
    one = _copy(tmp_path / "cpu", tmp_path / "card_from_cpu", steps={5})
    train("yi-6b", ckpt_dir=one, **kw)
    assert_one_step_matches(load_ckpt(tmp_path / "cpu", "bdi8", 5),
                            load_ckpt(one, "bdi8", 6),
                            load_ckpt(tmp_path / "cpu", "bdi8", 6))


@pytest.mark.parametrize("shape,dtype", [((3, 4096), torch.bfloat16),
                                         ((300,), torch.float32),
                                         ((5, 128), torch.float32)])
def test_all_reduce_bdi_nccl_one_rank_bit_equal_cpu(dev, shape, dtype):
    """``all_reduce_bdi`` on a one-rank NCCL mesh (tile kernels 4 and 5,
    the all-gather a copy) against the same call on a one-rank gloo mesh
    (the plain versions): mean and residual bit-equal."""
    import torch.distributed as dist

    from repro_torch.distributed import compress_comm as cc
    from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.standard_normal(shape) * 1e-3).astype(
        np.float32)).to(dtype)
    x[0] = 0.0                                   # a zero tile or more
    r = torch.from_numpy((rng.standard_normal(shape) * 1e-6).astype(
        np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        mesh = make_host_mesh(1, 1, device=d)
        try:
            assert dist.get_backend() == ("nccl" if d.type == "cuda"
                                          else "gloo")
            ops.reset_launches()
            m, nr = cc.all_reduce_bdi(x.to(d), mesh.get_group("data"),
                                      r.to(d))
            out[d.type] = (m.cpu(), nr.cpu())
            launched = (ops.LAUNCHES["bdi_compress"],
                        ops.LAUNCHES["bdi_decompress"])
            assert launched == ((1, 2) if d.type == "cuda" else (0, 0))
        finally:
            destroy_mesh()
    (gm, gr), (cm, cr) = out["cuda"], out["cpu"]
    assert gm.dtype == dtype and torch.equal(
        gm.float().view(torch.int32), cm.float().view(torch.int32))
    assert torch.equal(gr.view(torch.int32), cr.view(torch.int32))
