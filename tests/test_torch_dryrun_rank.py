"""The port's dry run traces one rank of the mesh: its row against JAX's
per-device program under GSPMD, on the CPU.

``launch/dryrun.trace`` runs a cell's step at one coordinate of an
abstract mesh on that rank's own ``meta`` tensors (its param blocks under
the rule table, its ZeRO-1 state, its rows, its cache blocks), every
collective of ``distributed/tp.py`` counted and none sent.  JAX lowers
the same cell (``lower_cell``'s jit: ``param_shardings(fsdp=True)``,
``batch_specs``, ``cache_specs``, donation) for a hand-built mesh of
four host devices and compiles it, in subprocesses started with
``XLA_FLAGS=--xla_force_host_platform_device_count=4
--xla_allow_excess_precision=false``, as the TP tests start theirs.

Cells (reduced configs, B = 2, S = 64): on ``(1, 4)`` yi-6b train
(also with the sequence-parallel residual stream, ``yi6b-train-sp``),
prefill and decode with its KV heads widened to 4 (K/V split like Q) and
decode at its 2 (K/V whole, the cache over T), deepseek-v2-lite-16b train
(experts and MLA), hymba-1.5b train, xlstm-350m prefill and seamless
decode (KV heads 4, as ``tests/test_torch_tp_families.py`` widens them);
yi-6b train on ``(2, 2)`` and on ``(2, 1, 2)`` (the pod axis) with the
FSDP threshold lowered to 4 KiB in both packages.

What must match:

* argument, output and alias bytes: the 4-device ``memory_analysis``,
  exactly;
* ``traced_flops``: ``hlo_cost`` of the compiled per-device HLO, exactly
  up to gaps each named by the operation and computed from the shapes
  (``CELLS``): the port recomputes each cross-entropy chunk's
  logits (this rank's vocab block) in the backward, where XLA keeps the
  forward's on a model axis alone (under a data axis its remat
  recomputes them too); XLA's remat drops each layer's last product, the
  row-parallel down projection of the dense MLP (MoE: of the shared
  experts), whose output the backward does not read, where
  ``torch.utils.checkpoint`` reruns it (at m > 1: at m = 1 XLA keeps it,
  ``tests/test_torch_dryrun.py``); Mamba's backward outer product (a
  ``bmm`` of size-1 contractions to PyTorch); ``hlo_cost`` counts
  xLSTM's idle sLSTM branch in every layer, and GSPMD contracts mLSTM's
  ``w_if`` over each rank's block of the inner width and sums, where the
  port contracts the gathered whole;
* collective bytes, by kind, against ``collective_bytes`` of the same
  HLO (the sequence-parallel cell ``yi6b-train-sp``, JAX lowered with
  ``set_sp(True)``, has a test of its own): exactly for the cells whose
  layout both packages share (the dense GQA decoder with its heads
  split, prefill, decode and train; seamless's decode), up to named
  gaps: the port hands every rank the
  whole logits (``tp.gather_vocab``: an all-gather of ``[rows, V/m]``
  bf16) where a jit with ``out_shardings=None`` leaves them split, and
  its cross-entropy recompute issues the row max's all-reduce again,
  which XLA's remat does not (the counts differ where XLA sends a tuple
  all-reduce; the bytes do not).  Elsewhere GSPMD picks its own
  resharding (the KV heads split over pairs of ranks with
  collective-permutes, Mamba's and mLSTM's channels moved by all-to-all,
  FSDP blocks gathered in f32, MoE sums): there the rank's total, less
  the named gaps, is at most GSPMD's;
* the production matrix: ``tp.check_layout`` and ``adamw.plan`` take
  every registry config at ``(16, 16)`` and ``(2, 16, 16)`` under the
  dry run's moment dtypes, arctic-480b's q8 included (its ``wo`` tiles
  straddle the data blocks: the rank owns a block of the head dim);
* other coordinates: a ``(2, 4)`` trace of one train cell and one decode
  cell at every coordinate gives the same FLOPs and collectives; of the
  peak, only the decode rank that holds row t writes the new K/V
  (``tp.write_row``, counted in ``writes``), which allocates nothing, so
  the peaks are equal too.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _workers  # noqa: F401  (shares the cores among xdist workers)

from repro_torch.configs.base import SHAPES, ShapeConfig, applicable_shapes
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.launch import dryrun as D
from repro_torch.launch import elastic as EL
from repro_torch.launch.mesh import production_axes
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim import adamw as AW

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 64
REAL = 64 << 20
GQA4 = {"n_kv_heads": 4}


@pytest.fixture(autouse=True)
def _sp_restored():
    """``axes.set_sp`` is process-wide and the dry run leaves it as its
    last call set it (as JAX's ``lower_cell``): each test restores it."""
    prev = AX.SP_ENABLED
    yield
    AX.set_sp(prev)


def _names(mesh: tuple) -> tuple:
    return ("pod", "data", "model") if len(mesh) == 3 else ("data", "model")


def _m(mesh: tuple) -> int:
    return mesh[-1]


def _rows(mesh: tuple) -> int:
    d = int(np.prod(mesh[:-1]))
    return B // d if B % d == 0 else B


# -- FLOP gaps: port - JAX, each from the shapes -----------------------------

def _ce_recompute(cfg, mesh):
    """The cross-entropy chunk's logits (this rank's vocab block) once
    more, in the backward."""
    return 2 * _rows(mesh) * S * cfg.d_model * (cfg.vocab // _m(mesh))


def _down_recompute(cfg, mesh):
    """Each layer's last product, the row-parallel down projection of its
    dense MLP (of an MoE layer's shared experts), rerun by the recompute."""
    width = cfg.n_shared_experts * cfg.d_ff_expert if cfg.is_moe \
        else cfg.d_ff
    return cfg.n_layers * 2 * _rows(mesh) * S * cfg.d_model \
        * (width // _m(mesh))


def _mamba_outer(cfg, mesh):
    """The scan's backward outer product, every layer, this rank's
    channels."""
    return cfg.n_layers * 2 * _rows(mesh) * S \
        * (cfg.ssm_expand * cfg.d_model // _m(mesh)) * cfg.ssm_state


def _idle_slstm(cfg, mesh):
    """xLSTM's sLSTM cell (this rank's block of its input product and its
    heads' recurrent product) a token, counted by ``hlo_cost`` in every
    layer, which runs mLSTM."""
    d, h, m = cfg.d_model, cfg.n_heads, _m(mesh)
    rows = _rows(mesh)
    return -cfg.n_layers * S * (2 * rows * d * 4 * d // m
                                + 2 * rows * (h // m) * (d // h) * 4
                                * (d // h))


def _w_if_whole(cfg, mesh):
    """mLSTM's input and forget gates (``w_if``, [d_inner, 2H]) contracted
    over the whole inner width on every rank, where GSPMD contracts each
    rank's block of it and sums."""
    inner, m = cfg.ssm_expand * cfg.d_model, _m(mesh)
    return cfg.n_layers * S * 2 * _rows(mesh) * (inner - inner // m) \
        * 2 * cfg.n_heads


# -- collective gaps: port - JAX, by kind ------------------------------------

def _logits_gather(cfg, mesh):
    """The last logits' vocab columns gathered over ``model``."""
    return {"all-gather": _rows(mesh) * (cfg.vocab // _m(mesh)) * 2}


def _ce_max(cfg, mesh):
    """The cross-entropy chunk's row max, all-reduced once more by its
    recompute."""
    return {"all-reduce": _rows(mesh) * S * 4}


# cell -> (arch, overrides, kind, mesh, FSDP threshold, FLOP gaps,
#          collective gaps, collectives exact)
CELLS = {
    "yi6b-train": ("yi-6b", GQA4, "train", (1, 4), REAL,
                   (_ce_recompute, _down_recompute), (_ce_max,), True),
    "yi6b-prefill": ("yi-6b", GQA4, "prefill", (1, 4), REAL, (),
                     (_logits_gather,), True),
    "yi6b-decode": ("yi-6b", GQA4, "decode", (1, 4), REAL, (),
                    (_logits_gather,), True),
    "yi6b-decode-kv-whole": ("yi-6b", {}, "decode", (1, 4), REAL, (),
                             (_logits_gather,), False),
    "deepseek-train": ("deepseek-v2-lite-16b", {}, "train", (1, 4), REAL,
                       (_ce_recompute, _down_recompute), (_ce_max,), False),
    "hymba-train": ("hymba-1.5b", GQA4, "train", (1, 4), REAL,
                    (_ce_recompute, _down_recompute, _mamba_outer),
                    (_ce_max,), False),
    "xlstm-prefill": ("xlstm-350m", {}, "prefill", (1, 4), REAL,
                      (_idle_slstm, _w_if_whole), (_logits_gather,), False),
    "seamless-decode": ("seamless-m4t-large-v2", GQA4, "decode", (1, 4),
                        REAL, (), (_logits_gather,), True),
    "yi6b-train-dp": ("yi-6b", {}, "train", (2, 2), 4 << 10,
                      (_down_recompute,), (), False),
    "yi6b-train-pod": ("yi-6b", {}, "train", (2, 1, 2), 4 << 10,
                       (_down_recompute,), (), False),
    "yi6b-train-sp": ("yi-6b", GQA4, "train", (1, 4), REAL,
                      (_down_recompute,), (_ce_max,), False),
}
# cells traced and lowered with the sequence-parallel residual stream
SP = ("yi6b-train-sp",)
# the JAX compiles, a process each (about equal shares of the time)
GROUPS = (("yi6b-train", "yi6b-prefill", "yi6b-decode",
           "yi6b-decode-kv-whole", "seamless-decode"),
          ("deepseek-train", "xlstm-prefill", "yi6b-train-sp"),
          ("hymba-train", "yi6b-train-dp", "yi6b-train-pod"))
KINDS = ("all-reduce", "all-gather", "all-to-all", "reduce-scatter")
IO = ("argument_size_in_bytes", "output_size_in_bytes",
      "alias_size_in_bytes")


def cell_cfg(cell: str, package_get_arch=get_arch):
    arch, kw = CELLS[cell][:2]
    return package_get_arch(arch).reduced(**kw)


class threshold:
    """``FSDP_THRESHOLD_BYTES`` of a rule table (``module``) set to a
    cell's for a while (test-only)."""

    def __init__(self, cell: str, module=SH):
        self.module, self.value = module, CELLS[cell][4]

    def __enter__(self):
        self.prev = self.module.FSDP_THRESHOLD_BYTES
        self.module.FSDP_THRESHOLD_BYTES = self.value

    def __exit__(self, *exc):
        self.module.FSDP_THRESHOLD_BYTES = self.prev


# ---------------------------------------------------------------------------
# JAX: lower_cell's jit on a hand-built mesh of four host devices
# ---------------------------------------------------------------------------

def jax_cells(cells: list, out: str) -> None:
    """Entry of a JAX process: each cell's per-device ``hlo_cost`` FLOPs,
    ``collective_bytes`` and ``memory_analysis`` into ``out`` (JSON)."""
    import functools

    import jax
    import jax.numpy as jnp
    jax.devices()                     # four, before the dry run's import
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.registry import get_arch as jax_arch
    from repro.distributed import axes as JAX_AX
    from repro.distributed import sharding as JSH
    from repro.models import frontends as JF
    from repro.models.api import get_model as jax_model
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw_init as jadamw_init
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jd
    os.environ["XLA_FLAGS"] = saved
    rows = {}
    for cell in cells:
        _, _, kind, shape, _, _, _, _ = CELLS[cell]
        JAX_AX.set_sp(cell in SP)
        with threshold(cell, JSH):
            cfg = cell_cfg(cell, jax_arch)
            model = jax_model(cfg)
            mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:int(
                np.prod(shape))]).reshape(shape), _names(shape))
            named = lambda specs: jax.tree.map(                 # noqa: E731
                lambda s: jax.sharding.NamedSharding(mesh, s), specs,
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            sh = JShape("x", S, B, kind)
            kw = {"enc_len": JF.enc_len_for(cfg, sh)} if cfg.is_encdec \
                else {}
            with JAX_AX.use_mesh(mesh):
                params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
                psh = JSH.param_shardings(params, mesh, fsdp=True)
                if kind == "train":
                    ocfg = JAdamWConfig()
                    opt = jax.eval_shape(
                        functools.partial(jadamw_init, cfg=ocfg), params)
                    osh = JSH.param_shardings(opt, mesh, fsdp=True)
                    batch = JF.batch_struct(cfg, sh)
                    low = jax.jit(
                        jd.build_train_step(model, ocfg, 1, jnp.float32),
                        in_shardings=(psh, osh, named(JSH.batch_specs(
                            batch, mesh))),
                        out_shardings=(psh, osh, None),
                        donate_argnums=(0, 1)).lower(params, opt, batch)
                elif kind == "prefill":
                    batch = JF.batch_struct(cfg, sh)
                    cache = jax.eval_shape(
                        lambda: model.init_cache(B, S, **kw))
                    low = jax.jit(
                        lambda p, b: model.prefill(p, b, S),
                        in_shardings=(psh, named(JSH.batch_specs(batch,
                                                                 mesh))),
                        out_shardings=(None, named(JSH.cache_specs(
                            cache, mesh)))).lower(params, batch)
                else:
                    cache = jax.eval_shape(
                        lambda: model.init_cache(B, S, **kw))
                    csh = named(JSH.cache_specs(cache, mesh))
                    tok = jax.ShapeDtypeStruct((B,), jnp.int32)
                    low = jax.jit(
                        lambda p, c, t, i: model.decode_step(p, c, t, i),
                        in_shardings=(psh, csh, named(JSH.batch_specs(
                            tok, mesh)), None),
                        out_shardings=(None, csh),
                        donate_argnums=(1,)).lower(
                            params, cache, tok,
                            jax.ShapeDtypeStruct((), jnp.int32))
                compiled = low.compile(compiler_options={
                    "xla_allow_excess_precision": False})
            text = compiled.as_text()
            mem = compiled.memory_analysis()
            rows[cell] = {"flops": jd.hlo_cost(text)["flops"],
                          "collectives": jd.collective_bytes(text),
                          **{k: int(getattr(mem, k)) for k in IO}}
    with open(out, "w") as f:
        json.dump(rows, f)


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """{cell: JAX's per-device row}, from one process a group of cells,
    all started at once."""
    work = tmp_path_factory.mktemp("dryrun_rank")
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1", XLA_FLAGS=(
                   os.environ.get("XLA_FLAGS", "")
                   + " --xla_force_host_platform_device_count=4"
                   " --xla_allow_excess_precision=false").strip())
    procs = []
    for i, group in enumerate(GROUPS):
        out = work / f"jax_{i}.json"
        code = ("import test_torch_dryrun_rank as t; "
                f"t.jax_cells({list(group)!r}, {str(out)!r})")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       env=env, cwd=REPO), out))
    try:
        rcs = [p.wait(timeout=300) for p, _ in procs]
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * len(procs), rcs
    rows = {}
    for _, out in procs:
        rows.update(json.loads(out.read_text()))
    return rows


def port_row(cell: str, coord: dict | None = None) -> dict:
    _, _, kind, shape, _, _, _, _ = CELLS[cell]
    with threshold(cell):
        return D.trace(cell_cfg(cell), ShapeConfig("x", S, B, kind),
                       EL.abstract_mesh(shape, _names(shape), coord),
                       AdamWConfig(), 1, torch.float32, sp=cell in SP)


# ---------------------------------------------------------------------------
# the rank's row against JAX's per-device numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", sorted(CELLS))
def test_rank_io_bytes_equal_memory_analysis(jax_rows, cell):
    row = port_row(cell)
    for key in IO:
        assert row[key] == jax_rows[cell][key], key


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_rank_flops_against_hlo_cost(jax_rows, cell):
    _, _, _, shape, _, gaps, _, _ = CELLS[cell]
    cfg = cell_cfg(cell)
    want = int(jax_rows[cell]["flops"])
    assert want > 0
    got = port_row(cell)["traced_flops"]
    assert got - want == sum(g(cfg, shape) for g in gaps), (got, want)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_rank_collectives_against_collective_bytes(jax_rows, cell):
    _, _, _, shape, _, _, gaps, exact = CELLS[cell]
    cfg = cell_cfg(cell)
    row = port_row(cell)["collectives"]
    want = jax_rows[cell]["collectives"]
    gap = {k: sum(g(cfg, shape).get(k, 0) for g in gaps) for k in KINDS}
    assert row["total"] == sum(row[k] for k in KINDS)
    by_axis = row["by_axis"]
    for k in KINDS:
        op = k.replace("-", "_")
        assert row[k] == sum(c[f"{op}_bytes"] for c in by_axis.values())
        assert row["counts"][k] == sum(c[op] for c in by_axis.values())
    if exact:
        assert set(want) - set(KINDS) <= {"total", "counts"}, want
        for k in KINDS:
            assert row[k] - want.get(k, 0) == gap[k], (k, row[k], want)
    else:
        assert row["total"] - sum(gap.values()) <= want["total"], \
            (row, want)


def test_sp_rank_against_gspmd(jax_rows):
    """yi-6b train on ``(1, 4)`` with the sequence-parallel residual
    stream against JAX's program with ``set_sp(True)``: argument bytes
    exactly; FLOPs up to the down projection's recompute alone (under
    sequence parallelism XLA's remat recomputes the cross-entropy chunk's
    logits too, from the head's input gathered again); collectives by
    kind: XLA on the CPU forms no reduce-scatter (an all-reduce and a
    dynamic slice of the same operand), so the port's reduce-scatters and
    all-reduces, less the recompute's row max, are GSPMD's all-reduces
    exactly, and its gathers (bf16) at most GSPMD's (f32, gathered again
    in the remat); the rank's peak below the same cell's without it."""
    cell = "yi6b-train-sp"
    cfg, shape = cell_cfg(cell), CELLS[cell][3]
    row, want = port_row(cell), jax_rows[cell]
    assert row["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert row["traced_flops"] - int(want["flops"]) == \
        _down_recompute(cfg, shape)
    coll, jc = row["collectives"], want["collectives"]
    assert coll["reduce-scatter"] > 0 and "reduce-scatter" not in jc
    assert coll["all-reduce"] + coll["reduce-scatter"] \
        - _ce_max(cfg, shape)["all-reduce"] == jc["all-reduce"]
    assert 0 < coll["all-gather"] <= jc["all-gather"]
    assert coll["all-to-all"] == jc.get("all-to-all", 0) == 0
    assert row["temp_size_in_bytes"] < port_row("yi6b-train")[
        "temp_size_in_bytes"]


@pytest.mark.parametrize("mb", [8, 4])
def test_arctic_perf_iteration_sp_cells_trace(mb):
    """JAX's perf-iteration cells B2 and B3 (``arctic-480b train_4k
    --microbatches 8 --sp`` and ``4 --sp``) trace at ``(16, 16)`` with no
    refusal, at 2 of its layers: the stream's reduce-scatters over
    ``model`` only, and the rank's peak below the same cell's without
    sequence parallelism."""
    cfg = dataclasses.replace(get_arch("arctic-480b"), n_layers=2)
    ocfg = AdamWConfig(moment_dtype=D.MOMENT_DTYPE["arctic-480b"])

    def row(sp):
        return D.trace(cfg, SHAPES["train_4k"], EL.abstract_mesh(
            (16, 16), ("data", "model")), ocfg, mb, torch.float32, sp=sp)
    on, off = row(True), row(False)
    by_axis = on["collectives"]["by_axis"]
    assert by_axis["model"]["reduce_scatter"] > 0
    assert by_axis["data"]["reduce_scatter"] == 0
    assert off["collectives"]["reduce-scatter"] == 0
    assert on["temp_size_in_bytes"] < off["temp_size_in_bytes"]
    assert on["traced_flops"] == off["traced_flops"]


# ---------------------------------------------------------------------------
# the production matrix on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_matrix_lays_out(multi_pod):
    """Every registry config at the production mesh: the layout, and the
    optimizer's plan under the dry run's moment dtype where it trains;
    arctic-480b's q8 ``wo`` (56 tiles of D over the data axes) owns a
    block of its head dim, as the rule table splits its ``deltas``."""
    mesh = EL.abstract_mesh(*production_axes(multi_pod))
    d = int(np.prod(list(mesh.shape.values())[:-1]))
    with AX.use_mesh(mesh):
        for name in sorted(ARCHS):
            cfg = get_arch(name)
            tp.check_layout(cfg)
            if "train_4k" not in applicable_shapes(cfg):
                continue
            whole = get_model(cfg).init(torch.Generator(), "meta")
            local = SH.local_params(whole, mesh, fsdp=True)
            ocfg = AdamWConfig(moment_dtype=D.MOMENT_DTYPE.get(name, "f32"))
            lay = AW.plan(local, whole, ocfg)
            assert len(lay) == len(AW.P.leaves(local))
            if name != "arctic-480b":
                assert all(leaf.owner in (None, leaf.data)
                           or leaf.data is None for leaf in lay), name
                continue
            paths = [p for p, _ in SH.leaf_paths(whole)]
            wo = lay[paths.index("['blocks']['attn']['wo']['w']")]
            assert (wo.data, wo.owner) == (3, 2)
            state = adamw_init(local, ocfg, whole=whole)
            deltas = state["m"]["blocks"]["attn"]["wo"]["w"]["deltas"]
            assert tuple(deltas.shape) == (35, 56, 128 // d, 56, 128)


# ---------------------------------------------------------------------------
# other coordinates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "decode"])
def test_every_coordinate_traces_the_same_program(kind):
    """A ``(2, 4)`` rank at each of its 8 coordinates: the same FLOPs,
    collectives and peak; in decode over a cache split over T the one
    rank whose block holds row t writes it (``writes``), and the row
    names that rank."""
    cfg = get_arch("yi-6b").reduced()
    shape = ShapeConfig("x", 16, 4, kind)
    rows = {}
    for dr in range(2):
        for mr in range(4):
            before = tp.counts()
            rows[dr, mr] = (D.trace(
                cfg, shape, EL.abstract_mesh((2, 4), ("data", "model"),
                                             {"data": dr, "model": mr}),
                AdamWConfig(), 1, torch.float32),
                tp.counts_since(before)["model"]["writes"])
    first, _ = rows[0, 0]
    for (dr, mr), (row, writes) in rows.items():
        assert row["rank"]["coordinate"] == {"data": dr, "model": mr}
        for key in ("traced_flops", "temp_size_in_bytes",
                    "argument_size_in_bytes"):
            assert row[key] == first[key], (key, dr, mr)
        assert {k: v for k, v in row["collectives"].items()
                if k != "by_axis"} == {k: v for k, v in
                                       first["collectives"].items()
                                       if k != "by_axis"}
        # K and V a layer, on the rank that holds row t only
        holds = kind == "decode" and mr == 3
        assert writes == 2 * cfg.n_layers * holds, (dr, mr, writes)
    if kind == "decode":
        assert "model coordinate 3" in first["rank"]["differs"][0]


@pytest.mark.parametrize("arch", ["gemma3-27b", "hymba-1.5b"])
def test_a_ring_cache_over_its_window_traces_on_meta(arch):
    """A prefill whose ring cache is split over its window (one KV head
    over a model axis of 2): each rank scatters its slots with no count
    that depends on data (a boolean index has no size on ``meta``), at
    both coordinates alike."""
    cfg = get_arch(arch).reduced(n_kv_heads=1)
    rows = [D.trace(cfg, ShapeConfig("x", 24, 2, "prefill"),
                    EL.abstract_mesh((1, 2), ("data", "model"),
                                     {"model": r}), AdamWConfig(), 1,
                    torch.float32) for r in range(2)]
    assert rows[0]["traced_flops"] == rows[1]["traced_flops"] > 0
    assert rows[0]["temp_size_in_bytes"] == rows[1]["temp_size_in_bytes"]


def test_a_rank_traces_a_model_axis_share():
    """yi-6b at full width, 2 of its layers, train_4k on (16, 16): the
    rank's FLOPs are within the model axis's share of the data-parallel
    rank's with whole weights and twice that (what the axis repeats on
    every rank: K/V over 4 KV heads, the norms, the residual stream's
    elementwise work), its peak under half, and its collectives the
    mesh's."""
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=2)
    n_micro = D.MICROBATCHES["yi-6b"]

    def row(mesh):
        return D.trace(cfg, SHAPES["train_4k"], EL.abstract_mesh(
            mesh, ("data", "model")), AdamWConfig(), n_micro, torch.float32)
    rank, dp_rank = row((16, 16)), row((16, 1))
    assert rank["rank"]["coordinate"] == {"data": 0, "model": 0}
    assert dp_rank["traced_flops"] / 16 < rank["traced_flops"] \
        < dp_rank["traced_flops"] / 8
    assert rank["temp_size_in_bytes"] < dp_rank["temp_size_in_bytes"] / 2
    by_axis = rank["collectives"]["by_axis"]
    assert by_axis["model"]["all_reduce"] > 0 \
        and by_axis["data"]["all_reduce"] > 0
    assert "collectives.tensor_parallel_fsdp" not in rank["not_measured"]
    assert rank["dp_compressed"]["total"] > 0
