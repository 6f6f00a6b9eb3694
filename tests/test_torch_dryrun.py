"""The port's dry run (``repro_torch/launch/dryrun.py``) vs the JAX
package's (``repro/launch/dryrun.py``), on the CPU.

What must match:

* ``param_bytes_global``: the bytes of ``jax.eval_shape`` of each
  registry config's init, exactly;
* argument, output and alias bytes of every applicable cell at the
  production meshes (16, 16) and (2, 16, 16): the same arithmetic over
  JAX's ``eval_shape`` trees and JAX's sharding specs on JAX's abstract
  mesh, exactly, with arctic's q8 moments and one ``--kv-compressed``
  decode cell; which parameters a step takes and the dtype of its logits
  come from JAX's own trace of the step (``jax.make_jaxpr`` at reduced
  size, then the dead-code elimination of ``jit``'s ``keep_unused=False``:
  the trees do not change with the sizes);
* ``traced_flops`` against JAX's ``hlo_cost`` of the compiled one-device
  HLO (``lower(...).compile().as_text()``: the unoptimised text has no
  ``%`` names and counts 0) at reduced size, exactly up to gaps each
  named by the operation that causes it and computed from the shapes:
  the port recomputes each cross-entropy chunk's logits in the backward
  (``torch.utils.checkpoint``) where XLA reuses the forward's; Mamba's
  scan forms an outer product in the backward as a size-1 contraction,
  a ``bmm`` to PyTorch and a multiply to XLA; ``hlo_cost`` counts both
  branches of xLSTM's ``lax.cond`` (mLSTM and sLSTM) in every layer,
  where a layer runs one.  The same compiles' ``memory_analysis`` equals
  the port's bytes at mesh (1, 1);
* the ``models/trips`` multiplier: the same FLOPs and peak as the full
  trace, exactly, at small S (xLSTM prefill, xLSTM training with sLSTM
  layers, hymba training, a step of 5 microbatches);
* ``build_train_step`` against JAX's at reduced size with 1 and 2
  microbatches (bf16 accumulation once): the loss within rtol 1e-4;
  params and moments within ``test_torch_train.py``'s one-step bounds
  (params within one bf16 ULP for >= 99% of each leaf, each moment leaf
  within a relative Frobenius error of 2e-2: the gradients are each
  package's own, so ``test_torch_optim.py``'s bounds for identical
  gradients do not apply);
* the CLI and the row schema, ``resolve_device("meta")``, the kernel
  wrappers' refusal of meta tensors, and the cache and state
  constructors' ``device``.

Importing ``repro.launch.dryrun`` appends
``--xla_force_host_platform_device_count=512`` to ``XLA_FLAGS`` (its
lines 1-4), which takes effect only where JAX's backend has not started.
The ``jd`` fixture starts it first (one CPU device, as every other test
file of the worker has) and puts ``XLA_FLAGS`` back as it was, so neither
this worker's JAX nor a subprocess a later test file starts sees 512
devices.
"""

import functools
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
from jax._src.interpreters import partial_eval as pe
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_arch as jax_arch
from repro.distributed import sharding as JSH
from repro.launch import elastic as JEL
from repro.models import frontends as JF
from repro.models import transformer as JT
from repro.models.api import get_model as jax_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import store
from repro_torch.configs.base import SHAPES, ShapeConfig, applicable_shapes
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.distributed import axes as AX
from repro_torch.kernels import ops
from repro_torch.kernels._device import resolve_device
from repro_torch.launch import dryrun as D
from repro_torch.launch import elastic as EL
from repro_torch.launch.mesh import production_axes
from repro_torch.models import ssm, trips
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.models.params import from_numpy, to_numpy
from repro_torch.optim import AdamWConfig, adamw_init

REPO = Path(__file__).resolve().parents[1]
META = torch.device("meta")
STEP_ULP_SHARE = 0.99                   # test_torch_train.py's one-step
STEP_MOMENT_RTOL = 2e-2                 # bounds
# the row keys of the JAX dry run (repro/launch/dryrun.py lower_cell, run)
JAX_KEYS = ("arch", "shape", "microbatches", "mesh", "n_devices", "lower_s",
            "compile_s", "param_bytes_global", "flops", "bytes_accessed",
            "hlo_flops", "hlo_bytes", "seq_depth", "collectives",
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")


@pytest.fixture(scope="module")
def jd():
    """``repro.launch.dryrun``, imported with JAX's backend started and
    ``XLA_FLAGS`` put back (module docstring)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


@functools.lru_cache(maxsize=None)
def port_params(name: str) -> dict:
    return get_model(get_arch(name)).init(torch.Generator(), META)


@functools.lru_cache(maxsize=None)
def jax_params(name: str):
    return jax.eval_shape(jax_model(jax_arch(name)).init,
                          jax.random.PRNGKey(0))


def _nbytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# (a) parameter bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_bytes_global_equal_jax(name):
    assert D.param_bytes(port_params(name)) == _nbytes(jax_params(name))


# ---------------------------------------------------------------------------
# (b) argument, output and alias bytes: the arithmetic over JAX's trees
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, jax.sharding.PartitionSpec)


def _jax_shard_bytes(leaf, spec, sizes) -> int:
    n = 1
    for i, d in enumerate(leaf.shape):
        s = spec[i] if i < len(spec) else None
        f = int(np.prod([sizes[a] for a in (
            () if s is None else s if isinstance(s, tuple) else (s,))]))
        n *= -(-d // f)
    return n * leaf.dtype.itemsize


def _jax_bytes(tree, specs, sizes, keep=None) -> int:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sl = jax.tree.leaves(specs, is_leaf=_is_spec)
    return sum(_jax_shard_bytes(leaf, s, sizes)
               for (path, leaf), s in zip(flat, sl)
               if keep is None or keep(jax.tree_util.keystr(path)))


@functools.lru_cache(maxsize=None)
def jax_step_sig(name: str, kind: str, kv_compressed: bool = False):
    """JAX's own trace of a reduced prefill or decode step: the keystrs of
    the parameter and batch leaves it uses (``jit`` drops the others) and
    its logits' dtype."""
    cfg = jax_arch(name).reduced()
    model = jax_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    if kind == "prefill":
        sh = JShape("p", 8 + cfg.n_frontend_embeds, 2, "prefill")
        args = (params, JF.batch_struct(cfg, sh))

        def fn(p, b):
            return model.prefill(p, b, sh.seq_len)
    else:
        sh = JShape("d", 8, 2, "decode")
        if kv_compressed:
            cache = jax.eval_shape(lambda: JT.init_quant_cache(cfg, 2, 8))

            def fn(p, c, tok, t):
                return JT.decode_step_quant(cfg, p, c, tok, t)
        else:
            kw = {"enc_len": JF.enc_len_for(cfg, sh)} if cfg.is_encdec \
                else {}
            cache = jax.eval_shape(lambda: model.init_cache(2, 8, **kw))

            def fn(p, c, tok, t):
                return model.decode_step(p, c, tok, t)
        args = (params, cache, jax.ShapeDtypeStruct((2,), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32))
    closed = jax.make_jaxpr(fn)(*args)
    # jit's keep_unused=False: the inputs left after dead-code elimination
    _, used = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(args[:2])[0]]
    kept = {p for p, u in zip(paths, used) if u}
    return kept, jax.eval_shape(fn, *args)[0].dtype


def jax_io(name: str, shape_name: str, multi_pod: bool,
           kv_compressed: bool = False) -> dict:
    """The dry run's argument, output and alias bytes of a rank, from
    JAX's trees and specs, with XLA's conventions (each checked against
    ``memory_analysis`` in ``test_traced_flops_against_hlo_cost``)."""
    cfg, shape = jax_arch(name), SHAPES[shape_name]
    jshape = JShape(shape.name, shape.seq_len, shape.global_batch,
                    shape.kind)
    mesh = JEL.abstract_mesh(*production_axes(multi_pod))
    sizes = dict(mesh.shape)
    params = jax_params(name)
    psp = JSH.param_specs(params, mesh)
    if shape.kind == "train":
        ocfg = JAdamWConfig(moment_dtype=D.MOMENT_DTYPE.get(name, "f32"))
        opt = jax.eval_shape(functools.partial(jadamw_init, cfg=ocfg), params)
        batch = JF.batch_struct(cfg, jshape)
        p = _jax_bytes(params, psp, sizes)
        o = _jax_bytes(opt, JSH.param_specs(opt, mesh), sizes)
        n_out = len(jax.tree.leaves((params, opt))) + 3
        return {"argument_size_in_bytes": p + o + _jax_bytes(
                    batch, JSH.batch_specs(batch, mesh), sizes),
                "output_size_in_bytes": p + o + 12 + 8 * n_out,
                "alias_size_in_bytes": p + o}
    kept, dtype = jax_step_sig(name, shape.kind, kv_compressed)
    b = shape.global_batch
    p = _jax_bytes(params, psp, sizes,
                   keep=lambda k: f"[0]{k}" in kept)
    kw = {"enc_len": JF.enc_len_for(cfg, jshape)} if cfg.is_encdec else {}
    if shape.kind == "prefill":
        batch = JF.batch_struct(cfg, jshape)
        args = p + _jax_bytes(batch, JSH.batch_specs(batch, mesh), sizes,
                              keep=lambda k: f"[1]{k}" in kept)
        cache = jax.eval_shape(lambda: jax_model(cfg).init_cache(
            b, shape.seq_len, **kw))
    elif kv_compressed:
        cache = jax.eval_shape(lambda: JT.init_quant_cache(
            cfg, b, shape.seq_len))
    else:
        cache = jax.eval_shape(lambda: jax_model(cfg).init_cache(
            b, shape.seq_len, **kw))
    c = _jax_bytes(cache, JSH.cache_specs(cache, mesh), sizes)
    if shape.kind == "decode":
        tok = jax.ShapeDtypeStruct((b,), jnp.int32)
        args = p + c + _jax_shard_bytes(
            tok, JSH.batch_specs(tok, mesh), sizes) + 4
    dp = [a for a in ("pod", "data") if a in sizes]
    dps = int(np.prod([sizes[a] for a in dp]))
    logits = jax.ShapeDtypeStruct((b, cfg.vocab), dtype)
    lspec = (tuple(dp) if b % dps == 0 else None,
             "model" if cfg.vocab % sizes["model"] == 0 else None)
    n_out = 1 + len(jax.tree.leaves(cache))
    return {"argument_size_in_bytes": args,
            "output_size_in_bytes": _jax_shard_bytes(logits, lspec, sizes)
            + c + 8 * n_out,
            "alias_size_in_bytes": c if shape.kind == "decode" else 0}


def port_io(name: str, shape_name: str, multi_pod: bool,
            kv_compressed: bool = False) -> dict:
    cfg = get_arch(name)
    return D.io_bytes(
        get_model(cfg), SHAPES[shape_name],
        EL.abstract_mesh(*production_axes(multi_pod)),
        AdamWConfig(moment_dtype=D.MOMENT_DTYPE.get(name, "f32")),
        port_params(name), kv_compressed=kv_compressed)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_io_bytes_equal_jax_arithmetic(name):
    cells = [(s, mp) for s in applicable_shapes(get_arch(name))
             for mp in (False, True)]
    assert len(cells) in (6, 8)
    for shape_name, multi_pod in cells:
        assert port_io(name, shape_name, multi_pod) \
            == jax_io(name, shape_name, multi_pod), (shape_name, multi_pod)


def test_io_bytes_of_a_kv_compressed_decode_cell():
    for multi_pod in (False, True):
        assert port_io("yi-6b", "decode_32k", multi_pod, True) \
            == jax_io("yi-6b", "decode_32k", multi_pod, True)


def test_matrix_has_33_cells_a_mesh():
    assert sum(len(applicable_shapes(c)) for c in ARCHS.values()) == 33


# ---------------------------------------------------------------------------
# (c) traced FLOPs against hlo_cost; memory_analysis against the port
# ---------------------------------------------------------------------------

B, S = 2, 64


def _ce_recompute(cfg, rows: int) -> int:
    """The logits product of the cross-entropy, once more a step."""
    return 2 * rows * S * cfg.d_model * cfg.vocab


def _mamba_outer(cfg, rows: int) -> int:
    """The scan's backward outer product, every layer."""
    return cfg.n_layers * 2 * rows * S * cfg.ssm_expand * cfg.d_model \
        * cfg.ssm_state


def _idle_slstm(cfg, rows: int) -> int:
    """xLSTM's sLSTM cell (input and recurrent products) a token, in every
    layer, which runs mLSTM (the reduced config has no sLSTM layer)."""
    d, h = cfg.d_model, cfg.n_heads
    return -cfg.n_layers * S * (2 * rows * d * 4 * d
                                + 2 * rows * h * (d // h) * 4 * (d // h))


# (arch, kind, microbatches, kv_compressed, gap: port - JAX)
FLOP_CELLS = {
    "yi6b-train-1": ("yi-6b", "train", 1, False, _ce_recompute),
    "yi6b-train-2": ("yi-6b", "train", 2, False, _ce_recompute),
    "yi6b-prefill": ("yi-6b", "prefill", 1, False, lambda cfg, rows: 0),
    "yi6b-decode": ("yi-6b", "decode", 1, False, lambda cfg, rows: 0),
    "yi6b-decode-quant": ("yi-6b", "decode", 1, True, lambda cfg, rows: 0),
    "deepseek-train": ("deepseek-v2-lite-16b", "train", 1, False,
                       _ce_recompute),
    "xlstm-prefill": ("xlstm-350m", "prefill", 1, False, _idle_slstm),
    "hymba-train": ("hymba-1.5b", "train", 1, False,
                    lambda cfg, rows: _ce_recompute(cfg, rows)
                    + _mamba_outer(cfg, rows)),
    "seamless-decode": ("seamless-m4t-large-v2", "decode", 1, False,
                        lambda cfg, rows: 0),
}


@functools.lru_cache(maxsize=None)
def jax_compiled(jd, name: str, kind: str, n_micro: int, kv_compressed: bool,
                 acc: str):
    """JAX's step of the reduced config at (B * n_micro) x S, compiled for
    one CPU device without excess precision."""
    cfg = jax_arch(name).reduced()
    model = jax_model(cfg)
    rows = B * n_micro
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opts = {"xla_allow_excess_precision": False}
    sh = JShape("x", S, rows, kind)
    if kind == "train":
        opt = jax.eval_shape(functools.partial(jadamw_init,
                                               cfg=JAdamWConfig()), params)
        step = jax.jit(jd.build_train_step(
            model, JAdamWConfig(), n_micro,
            jnp.float32 if acc == "f32" else jnp.bfloat16),
            donate_argnums=(0, 1))
        low = step.lower(params, opt, JF.batch_struct(cfg, sh))
    elif kind == "prefill":
        low = jax.jit(lambda p, b: model.prefill(p, b, S)).lower(
            params, JF.batch_struct(cfg, sh))
    else:
        if kv_compressed:
            cache = jax.eval_shape(lambda: JT.init_quant_cache(cfg, rows, S))

            def fn(p, c, tok, t):
                return JT.decode_step_quant(cfg, p, c, tok, t)
        else:
            kw = {"enc_len": JF.enc_len_for(cfg, sh)} if cfg.is_encdec \
                else {}
            cache = jax.eval_shape(lambda: model.init_cache(rows, S, **kw))

            def fn(p, c, tok, t):
                return model.decode_step(p, c, tok, t)
        low = jax.jit(fn, donate_argnums=(1,)).lower(
            params, cache, jax.ShapeDtypeStruct((rows,), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32))
    return low.compile(compiler_options=opts)


@pytest.mark.parametrize("cell", sorted(FLOP_CELLS))
def test_traced_flops_against_hlo_cost(jd, cell):
    name, kind, n_micro, quant, gap = FLOP_CELLS[cell]
    compiled = jax_compiled(jd, name, kind, n_micro, quant, "f32")
    cfg = get_arch(name).reduced()
    rows = B * n_micro
    row = D.trace(cfg, ShapeConfig("x", S, rows, kind),
                  EL.abstract_mesh((1, 1), ("data", "model")),
                  AdamWConfig(), n_micro, torch.float32,
                  kv_compressed=quant)
    want = jd.hlo_cost(compiled.as_text())["flops"]
    assert want > 0
    assert row["traced_flops"] - int(want) == gap(cfg, rows), \
        (row["traced_flops"], want)
    mem = compiled.memory_analysis()
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes"):
        assert row[key] == getattr(mem, key), key


# ---------------------------------------------------------------------------
# (d) the trips multiplier against the full trace
# ---------------------------------------------------------------------------

TRIP_CELLS = {
    "xlstm-prefill": ("xlstm-350m", {}, "prefill", 32, 2, 1),
    "xlstm-train-slstm": ("xlstm-350m", {"slstm_every": 2}, "train", 24, 2,
                          1),
    "hymba-train": ("hymba-1.5b", {}, "train", 32, 2, 1),
    "yi6b-5-microbatches": ("yi-6b", {}, "train", 16, 10, 5),
}


@pytest.mark.parametrize("cell", sorted(TRIP_CELLS))
def test_trips_multiplier_equals_the_full_trace(cell, monkeypatch):
    name, kw, kind, seq, rows, n_micro = TRIP_CELLS[cell]
    cfg = get_arch(name).reduced(**kw)
    mesh = EL.abstract_mesh((1, 1), ("data", "model"))

    def row():
        return D.trace(cfg, ShapeConfig("x", seq, rows, kind), mesh,
                       AdamWConfig(), n_micro, torch.float32)
    cut = row()
    monkeypatch.setattr(trips, "TRACED", 10 ** 9)      # every trip
    full = row()
    assert cut["traced_flops"] == full["traced_flops"]
    assert cut["temp_size_in_bytes"] == full["temp_size_in_bytes"]


def test_trips_are_range_outside_a_count():
    assert trips.steps(7) == range(7)
    ys = [torch.full((2,), float(i)) for i in range(5)]
    assert torch.equal(trips.stack(ys, 5, 1), torch.stack(ys, 1))


# ---------------------------------------------------------------------------
# (e) build_train_step against JAX's
# ---------------------------------------------------------------------------

def _ulp(mag):
    return np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("n_micro,acc", [(1, "f32"), (2, "f32"),
                                         (2, "bf16")])
def test_build_train_step_matches_jax(jd, n_micro, acc):
    model = get_model(get_arch("yi-6b").reduced())
    params = to_numpy(model.init(torch.Generator().manual_seed(0), "cpu"),
                      ml_dtypes.bfloat16)
    rng = np.random.default_rng(n_micro)
    rows = B * n_micro
    vocab = model.cfg.vocab
    batch = {"tokens": rng.integers(0, vocab, (rows, S), np.int32),
             "targets": rng.integers(0, vocab, (rows, S), np.int32),
             "loss_mask": np.ones((rows, S), np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    jp, js, jm = jax_compiled(jd, "yi-6b", "train", n_micro, False, acc)(
        jp, jadamw_init(jp, JAdamWConfig()),
        jax.tree.map(jnp.asarray, batch))
    step = D.build_train_step(model, AdamWConfig(), n_micro,
                              torch.float32 if acc == "f32"
                              else torch.bfloat16)
    tp = from_numpy(params)
    tp, ts, tm = step(tp, adamw_init(tp, AdamWConfig()),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert int(ts["step"]) == int(js["step"]) == 1
    for (path, a), b in zip(store.leaf_paths(tp), jax.tree.leaves(jp)):
        a = a.detach().float().numpy()
        b = np.asarray(b).astype(np.float32)
        share = float((np.abs(a - b) <= _ulp(np.maximum(np.abs(a),
                                                        np.abs(b)))).mean())
        assert share >= STEP_ULP_SHARE, (path, share)
    for key in ("m", "v"):
        for (path, a), b in zip(store.leaf_paths(ts[key]),
                                jax.tree.leaves(js[key])):
            a, b = a.float().numpy(), np.asarray(b)
            err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            assert err <= STEP_MOMENT_RTOL, (key, path, err)


def test_a_step_frees_its_gradients_when_it_returns():
    """Nothing of a step outlives it but its loss and metrics (the
    accumulated gradients once stayed in a reference cycle of
    ``params.unflatten`` until the collector ran)."""
    model = get_model(get_arch("yi-6b").reduced())
    params = model.init(torch.Generator(), META)
    opt = adamw_init(params, AdamWConfig())
    batch = D._batch(model.cfg, ShapeConfig("x", 8, 4, "train"), 4)
    for n_micro in (1, 2):
        with D.Count() as count:
            _, _, metrics = D.build_train_step(model, AdamWConfig(),
                                               n_micro)(params, opt, batch)
            assert count.live <= 4 * 8, (n_micro, count.live)


def test_build_train_step_refuses_rows_that_do_not_split():
    model = get_model(get_arch("yi-6b").reduced())
    params = model.init(torch.Generator(), META)
    batch = D._batch(model.cfg, ShapeConfig("x", 8, 3, "train"), 3)
    with pytest.raises(ValueError, match="do not split into 2"):
        D.build_train_step(model, AdamWConfig(), 2)(
            params, adamw_init(params, AdamWConfig()), batch)


# ---------------------------------------------------------------------------
# (f) the CLI and the row
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def cli_proc(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun`` on xlstm-350m long_500k in
    a fresh process, which must import neither jax nor repro; started
    with the module's first test, beside the others."""
    out = tmp_path_factory.mktemp("dryrun") / "cell.json"
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--arch', 'xlstm-350m', '--shape', "
            f"'long_500k', '--out', {str(out)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro'))\n"
            "assert not bad, bad\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    yield proc, out
    proc.kill()
    proc.wait()


@pytest.fixture
def cli_row(cli_proc):
    proc, out = cli_proc
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-2000:]
    return json.loads(out.read_text())


def _check_row(info: dict, n_devices: int) -> None:
    assert info["n_devices"] == n_devices
    assert info["traced_flops"] > 0
    assert info["collectives"]["total"] >= 0
    assert all(k in info for k in JAX_KEYS)
    nulls = {k for k in JAX_KEYS if info[k] is None}
    assert nulls == {"lower_s", "compile_s", "flops", "bytes_accessed",
                     "hlo_flops", "hlo_bytes", "seq_depth",
                     "generated_code_size_in_bytes"}
    assert nulls <= set(info["not_measured"])
    assert all(isinstance(v, str) and v for v in
               info["not_measured"].values())


def test_cli_row_single_pod(cli_row):
    _check_row(cli_row, 256)
    assert cli_row["mesh"] == "16x16" and cli_row["microbatches"] == 0


def test_cli_row_multi_pod(tmp_path):
    out = tmp_path / "cell.json"
    D.run("xlstm-350m", "long_500k", True, str(out))
    info = json.loads(out.read_text())
    _check_row(info, 512)
    assert info["mesh"] == "2x16x16"


def test_train_row_reports_the_dp_all_reduce():
    """The compressed DP all-reduce of a pure data-parallel run, kept
    under ``dp_compressed`` beside the rank's own ``collectives``."""
    info = D.trace(get_arch("yi-6b").reduced(),
                   ShapeConfig("x", 16, 32, "train"),
                   EL.abstract_mesh((16, 1), ("data", "model")),
                   AdamWConfig(), 2, torch.float32)
    coll = info["dp_compressed"]
    leaves = coll["leaves"]
    assert coll["all-gather"] == sum(v["compressed"] for v in leaves.values())
    assert coll["raw"]["all-reduce"] == 4 + sum(
        v["raw"] for v in leaves.values())
    assert coll["total"] == coll["all-gather"] + 4
    assert info["microbatches"] == 2 and info["n_devices"] == 16


def test_sp_raises():
    """``--sp`` no longer raises: the cell traces with the sequence-
    parallel switch on and, a decode cell (whose step never splits the
    residual stream, as JAX's ``decode_step`` never calls ``shard_seq``),
    gives the row it gives with it off; ``trace_cell`` switches it on
    every call, as JAX's ``lower_cell`` does."""
    keys = ("traced_flops", "temp_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes")
    on = D.trace_cell("xlstm-350m", "long_500k", False, sp=True)
    assert AX.SP_ENABLED
    off = D.trace_cell("xlstm-350m", "long_500k", False)
    assert not AX.SP_ENABLED
    assert {k: on[k] for k in keys} == {k: off[k] for k in keys}
    assert on["collectives"]["counts"] == off["collectives"]["counts"]
    assert on["collectives"]["reduce-scatter"] == 0


def test_full_attention_arch_on_long_500k_skips_as_jax():
    with pytest.raises(SystemExit, match="SKIP: long_500k not applicable "
                       "to yi-6b \\(full-attention arch; see DESIGN.md\\)"):
        D.trace_cell("yi-6b", "long_500k", False)


def test_count_refuses_data_on_another_device():
    with D.Count(), pytest.raises(ValueError, match="meta tensors only"):
        torch.ones(4) + 1


# ---------------------------------------------------------------------------
# (g) meta: device resolution, kernels, constructors
# ---------------------------------------------------------------------------

def test_resolve_device_meta():
    assert resolve_device("meta") == META
    assert resolve_device(META) == META


def test_kernel_wrappers_refuse_meta_tensors():
    tiles = torch.empty((4, 128), device=META)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.compress(tiles)
    k = torch.empty((2, 1, 16, 32), device=META)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.compress_kv_pages(k, k)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_constructors_build_on_the_device_given(name):
    cache = get_model(get_arch(name).reduced()).init_cache(2, 8,
                                                           device="meta")
    assert all(t.device == META for t in cache)


def test_quant_cache_and_states_build_on_the_device_given():
    cache = T.init_quant_cache(get_arch("yi-6b").reduced(), 2, 8,
                               device="meta")
    assert all(t.device == META for t in cache)
    for st in (ssm.mlstm_init_state(2, 4, 8, device="meta"),
               ssm.slstm_init_state(2, 16, device="meta")):
        assert all(t.device == META for t in st.values())


def test_mamba_chunked_flag_sets_the_chunked_scan(monkeypatch, tmp_path):
    monkeypatch.setattr(ssm, "CHUNKED_SCAN", False)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "xlstm-350m", "--shape", "long_500k",
        "--mamba-chunked", "--out", str(tmp_path / "h.json")])
    D.main()
    assert ssm.CHUNKED_SCAN
