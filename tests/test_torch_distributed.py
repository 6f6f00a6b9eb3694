"""The port's distributed layer vs the JAX package, on the CPU.

``repro_torch.distributed.compress_comm`` (the BDI-compressed gradient
all-reduce with error feedback, the EC plan, wire bytes, residuals, the
data-parallel train step) and ``models/moe.py``'s expert-parallel path,
held against ``repro.distributed.compress_comm`` and ``repro.models.moe``
on the same numpy inputs (made from seeds), at one and at two ranks.

* One rank, in process: the port on a one-rank gloo mesh
  (``launch/mesh.make_host_mesh(1, 1, device="cpu")``), JAX's
  ``shard_map`` on a ``(1,)`` mesh, jitted with
  ``xla_allow_excess_precision`` off.
* Two ranks: one module fixture starts two port ranks (gloo, rendezvous
  through a ``FileStore`` in the test's temporary directory, no TCP port
  chosen here) and one JAX process with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=2
  --xla_allow_excess_precision=false``, all three at once; each runs all
  its workloads once and writes ``.npz`` files.

On both sides ``repro.core.bdi_value._pow2_scale`` is swapped, before its
first trace, for the exact construction of 2^e from bits that the port
uses (``tests/test_torch_decode.exact_pow2_scale``): gradients have tile
scales far outside XLA's exact ``exp2`` range.  That swap is for the
tests only.

Tolerances, each from what the two packages do differently:

* ``all_reduce_bdi`` and ``tree_all_reduce`` (mean and every residual),
  over 20 error-feedback steps too, at one and two ranks: bit-equal.  The
  codec is the same arithmetic (``tests/test_torch_tile_codec.py``), the
  decompression one unfused product and sum in both, and the sum over
  ranks in rank order is ``jnp.sum`` over two values;
* ``plan_compression`` and ``wire_bytes``: equal (the same numpy
  percentile of the same values);
* the data-parallel step from one state, compressed or not, at one and
  two ranks: the loss within rtol 1e-4 and the params within one bf16
  ULP for at least 99% of each leaf, ``tests/test_torch_train.py``'s
  one-step rule (the gradients come from two backward passes that round
  differently; the collective itself is held bit-equal by feeding both
  packages' gradients to both ``tree_all_reduce``);
* ``moe_ffn`` under a ``(1, 2)`` and a ``(2, 1)`` mesh, each rank on its
  experts and its rows: within 2 bf16 ULPs elementwise of JAX's rows,
  ``tests/test_torch_moe.py``'s bound for ``moe_ffn`` (the partial sums
  over the model axis are the same values as JAX's; the expert products
  round as that file states).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _workers  # noqa: F401  (shares the cores among xdist workers)

from repro.distributed import compress_comm as jcc
from repro.models.api import get_model as jax_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as TP
from repro_torch.distributed import compress_comm as cc
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
from repro_torch.models import params as P
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from test_torch_decode import _ulp, exact_pow2_scale
from test_torch_train import jax_params, port_params

REPO = Path(__file__).resolve().parents[1]
STEP_ULP_SHARE = 0.99
LOSS_RTOL = 1e-4
MOE_ULPS = 2
LR = 1e-3
EF_STEPS = 20
MOE_MESHES = ((1, 2), (2, 1))


# ---------------------------------------------------------------------------
# inputs, made the same way on both sides
# ---------------------------------------------------------------------------

def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, kept as f32 (exact in both packages)."""
    return np.asarray(np.asarray(a, np.float32).astype(ml_dtypes.bfloat16),
                      np.float32)


def leaf_inputs() -> dict:
    """(x, residual) pairs: test_substrate's 300-element input, a zero
    tile, a repeated tile, a 300-element leaf (padded tail), gradient-size
    values, and a bf16 leaf."""
    rng = np.random.default_rng(5)
    sub = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (300,)) * 2)
    zero = np.zeros((2, 128), np.float32)
    zero[1] = rng.standard_normal(128)
    rep = np.full((2, 128), 0.375, np.float32)
    rep[1] = rng.standard_normal(128)
    cases = {"substrate": (sub, np.zeros_like(sub)),
             "zero_tile": (zero, np.zeros_like(zero)),
             "repeated_tile": (rep, np.zeros_like(rep)),
             "padded_300": (rng.standard_normal(300).astype(np.float32),
                            (rng.standard_normal(300) * 1e-2).astype(
                                np.float32)),
             "grad_sized": ((rng.standard_normal((3, 256)) * 1e-3).astype(
                 np.float32), (rng.standard_normal((3, 256)) * 1e-6).astype(
                     np.float32))}
    return cases


def ef_grads(n_ranks: int) -> np.ndarray:
    """[ranks, 20, 256]: test_substrate's error-feedback gradients (rank
    0), other normals for rank 1."""
    first = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                         (EF_STEPS, 256)))
    rest = np.random.default_rng(6).standard_normal(
        (n_ranks - 1, EF_STEPS, 256)).astype(np.float32)
    return np.concatenate([first[None], rest])


def tree_inputs(rank: int) -> tuple[dict, dict, dict]:
    """A small gradient tree (bf16 and f32 leaves, a padded one, one the
    plan ships raw), this rank's residuals, and the plan."""
    rng = np.random.default_rng(10 + rank)
    grads = {"a": {"w": _bf16(rng.standard_normal((3, 256)) * 1e-2)},
             "b": (rng.standard_normal(300) * 1e-3).astype(np.float32),
             "c": rng.standard_normal((2, 128)).astype(np.float32)}
    res = {"a": {"w": (rng.standard_normal((3, 256)) * 1e-5).astype(
        np.float32)},
        "b": (rng.standard_normal(300) * 1e-6).astype(np.float32),
        "c": np.zeros((2, 128), np.float32)}
    plan = {"['a']['w']": True, "['b']": True, "['c']": False}
    return grads, res, plan


BF16_LEAVES = ("['a']['w']",)


def dp_batch(cfg) -> dict:
    return TP.make_train_batch(cfg, ShapeConfig("t", 16, 4, "train"),
                               TP.DataConfig(seed=3), step=1)


def moe_input(cfg) -> np.ndarray:
    return _bf16(np.random.default_rng(7).standard_normal((4, 6,
                                                           cfg.d_model)))


def _bits(a) -> np.ndarray:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   np.float32)
    return a.view(np.int32)


def _port_tree(grads: dict, res: dict) -> tuple[dict, dict]:
    def t(path, a):
        x = torch.from_numpy(np.array(a))
        return x.to(torch.bfloat16) if path in BF16_LEAVES else x
    g = store._rebuild(grads, iter(t(p, a) for p, a in
                                   store.leaf_paths(grads)))
    r = store._rebuild(res, iter(torch.from_numpy(np.array(a))
                                 for _, a in store.leaf_paths(res)))
    return g, r


def _jax_tree(grads: dict) -> dict:
    return store._rebuild(grads, iter(
        jnp.asarray(a, jnp.bfloat16 if p in BF16_LEAVES else jnp.float32)
        for p, a in store.leaf_paths(grads)))


# ---------------------------------------------------------------------------
# one rank, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    mesh = make_host_mesh(1, 1, device="cpu")
    yield mesh
    destroy_mesh()


@pytest.fixture
def exact_jax_pow2(monkeypatch):
    from repro.core import bdi_value as jbv
    monkeypatch.setattr(jbv, "_pow2_scale", exact_pow2_scale)


def _jax_reduce(n_dev: int = 1):
    """JAX's all_reduce_bdi over a (n_dev,) mesh: x and residual stacked
    [n_dev, ...] over "data" -> (mean, residuals [n_dev, ...])."""
    mesh = jax.make_mesh((n_dev,), ("data",))
    f = jcc.shard_map(
        lambda x, r: (lambda m, nr: (m, nr[None]))(
            *jcc.all_reduce_bdi(x[0], "data", r[0])),
        mesh=mesh, in_specs=(JP("data"), JP("data")),
        out_specs=(JP(), JP("data")))
    return jax.jit(f, compiler_options={"xla_allow_excess_precision": False})


@pytest.mark.parametrize("case", sorted(leaf_inputs()))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_all_reduce_bdi_one_rank_bit_equal(mesh1, exact_jax_pow2, case,
                                           dtype):
    x, r = leaf_inputs()[case]
    if dtype == "bf16":
        x = _bf16(x)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want_m, want_r = _jax_reduce()(jx[None], jnp.asarray(r)[None])
    tx = torch.from_numpy(np.array(x))
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    got_m, got_r = cc.all_reduce_bdi(tx, mesh1.get_group("data"),
                                     torch.from_numpy(np.array(r)))
    assert got_m.dtype == tx.dtype and got_r.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got_m), _bits(want_m))
    np.testing.assert_array_equal(_bits(got_r), _bits(want_r[0]))
    if dtype == "f32":      # one worker: mean + residual == x + r
        np.testing.assert_allclose(got_m.numpy() + got_r.numpy(), x + r,
                                   rtol=1e-6, atol=1e-6)


def test_error_feedback_twenty_steps_bit_equal(mesh1, exact_jax_pow2):
    grads = ef_grads(1)[0]
    f = _jax_reduce()
    jr = jnp.zeros((1, 256))
    tr = torch.zeros(256)
    applied = torch.zeros(256)
    for g in grads:
        jm, jr = f(jnp.asarray(g)[None], jr)
        tm, tr = cc.all_reduce_bdi(torch.from_numpy(np.array(g)),
                                   mesh1.get_group("data"), tr)
        np.testing.assert_array_equal(_bits(tm), _bits(jm))
        np.testing.assert_array_equal(_bits(tr), _bits(jr[0]))
        applied += tm
    np.testing.assert_allclose((applied + tr).numpy(), grads.sum(0),
                               rtol=1e-4, atol=1e-4)


def _jax_tree_reduce(grads, res, plan, n_dev: int = 1):
    mesh = jax.make_mesh((n_dev,), ("data",))

    def body(g, r):
        g = jax.tree.map(lambda a: a[0], g)
        r = jax.tree.map(lambda a: a[0], r)
        out, nr = jcc.tree_all_reduce(g, r, "data", plan)
        return out, jax.tree.map(lambda a: a[None], nr)
    f = jcc.shard_map(body, mesh=mesh, in_specs=(JP("data"), JP("data")),
                      out_specs=(JP(), JP("data")))
    return jax.jit(f, compiler_options={
        "xla_allow_excess_precision": False})(grads, res)


def test_tree_all_reduce_one_rank_bit_equal(mesh1, exact_jax_pow2):
    grads, res, plan = tree_inputs(0)
    stack = lambda t: jax.tree.map(lambda a: a[None], t)   # noqa: E731
    want_g, want_r = _jax_tree_reduce(stack(_jax_tree(grads)),
                                      stack(jax.tree.map(jnp.asarray, res)),
                                      plan)
    tg, tr = _port_tree(grads, res)
    got_g, got_r = cc.tree_all_reduce(tg, tr, mesh1.get_group("data"), plan)
    assert got_g is tg and got_r is tr                       # in place
    for (p, a), (_, b) in zip(store.leaf_paths(got_g),
                              store.leaf_paths(want_g)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=p)
    for (p, a), (_, b) in zip(store.leaf_paths(got_r),
                              store.leaf_paths(want_r)):
        np.testing.assert_array_equal(_bits(a), _bits(b[0]), err_msg=p)


@pytest.mark.parametrize("shape", [(1024,), (4096, 4096), (32, 4096, 11008),
                                   (102400, 2048), (300,), (1,)])
def test_wire_bytes_equal_jax(shape):
    for compressed in (True, False):
        assert cc.wire_bytes(shape, compressed) == \
            jcc.wire_bytes(shape, compressed)


def _yi_grads() -> dict:
    """Gradients of the reduced yi-6b at the port's init (numpy f32)."""
    cfg, params = port_params("yi-6b")
    leaves = [t.requires_grad_() for t in P.leaves(params)]
    loss = get_model(cfg).loss(params, {k: torch.from_numpy(v) for k, v in
                                        dp_batch(cfg).items()})
    grads = torch.autograd.grad(loss, leaves)
    return P.unflatten(params, [g.float().numpy() for g in grads])


@pytest.mark.parametrize("tree", ["ec_plan_shapes", "yi-6b"])
def test_plan_compression_equal_jax(exact_jax_pow2, tree):
    if tree == "ec_plan_shapes":
        grads = {"a": np.zeros((256, 4), np.float32),
                 "b": np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                   (128,)) * 1e3)}
    else:
        grads = _yi_grads()
    want = jcc.plan_compression(jax.tree.map(jnp.asarray, grads))
    got = cc.plan_compression(P.tree_map(
        lambda a: torch.from_numpy(np.array(a)), grads))
    assert got == want
    if tree == "ec_plan_shapes":
        assert got["['a']"]                   # zeros compress perfectly
    else:
        assert set(got.values()) == {True, False}, got


def test_init_residuals_shapes_equal_jax(mesh1):
    cfg, params = port_params("yi-6b")
    jp = jax.eval_shape(jax_model(cfg).init, jax.random.PRNGKey(0))
    want = jcc.init_residuals(jp, 1)
    got = cc.init_residuals(params, 1)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [(p, tuple(t.shape), t.dtype) for p, t in store.leaf_paths(got)] \
        == [(jax.tree_util.keystr(k), v.shape, torch.float32)
            for k, v in flat_w]
    assert all(v.dtype == jnp.float32 for _, v in flat_w)
    assert all(not t.any() for t in P.leaves(got))


# -- the data-parallel step, one rank ----------------------------------------

def _jax_step(cfg, params, batch, compress: bool, n_dev: int = 1):
    """One JAX DP step from ``params`` (zero moments, zero residuals):
    (loss, params')."""
    jm = jax_model(cfg)
    ocfg = JAdamWConfig(lr=LR)
    mesh = jax.make_mesh((n_dev,), ("data",))
    step = jcc.make_dp_train_step(
        jm.loss, lambda p, g, s: jadamw_update(p, g, s, ocfg), mesh,
        compress=compress)
    args = (params, jadamw_init(params, ocfg),
            jcc.init_residuals(params, n_dev),
            {k: jnp.asarray(v) for k, v in batch.items()})
    exe = step.lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False})
    p, _, _, m = exe(*args)
    return float(m["loss"]), p


def _port_step(cfg, params, batch, mesh, compress: bool):
    ocfg = AdamWConfig(lr=LR)
    step = cc.make_dp_train_step(
        get_model(cfg).loss, lambda p, g, s: adamw_update(p, g, s, ocfg),
        mesh, compress=compress)
    p, _, res, m = step(params, adamw_init(params, ocfg),
                        cc.init_residuals(params, 1),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    return m, p, res


def assert_one_step(got: dict, want) -> None:
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, a), (k, b) in zip(store.leaf_paths(got), flat_w):
        assert path == jax.tree_util.keystr(k)
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        ulp = _ulp(np.maximum(np.abs(a), np.abs(b)))
        share = float((np.abs(a - b) <= ulp).mean())
        assert share >= STEP_ULP_SHARE, (path, share)


@pytest.mark.parametrize("compress", [True, False])
def test_dp_step_one_rank_matches_jax(tmp_path, mesh1, exact_jax_pow2,
                                      compress):
    cfg, params = port_params("yi-6b")
    store.save(str(tmp_path / "params" / "yi-6b"), 0, params)
    _, jp = jax_params(str(tmp_path), "yi-6b")
    batch = dp_batch(cfg)
    want_loss, want_p = _jax_step(cfg, jp, batch, compress)
    m, got_p, res = _port_step(cfg, params, batch, mesh1, compress)
    np.testing.assert_allclose(m["loss"], want_loss, rtol=LOSS_RTOL)
    assert_one_step(got_p, want_p)
    # the residual is what the codec left of each gradient
    assert any(bool(t.any()) for t in P.leaves(res)) == compress


@pytest.mark.parametrize("source", ["jax", "port"])
def test_tree_all_reduce_on_model_gradients_bit_equal(tmp_path, mesh1,
                                                      exact_jax_pow2,
                                                      source):
    """Both packages' gradients of the reduced yi-6b (bf16 leaves) through
    both ``tree_all_reduce``: the collective is bit-equal, whichever
    backward made its input."""
    cfg, params = port_params("yi-6b")
    if source == "port":
        grads = P.tree_map(lambda a: _bf16(a), _yi_grads())
    else:
        store.save(str(tmp_path / "params" / "yi-6b"), 0, params)
        _, jp = jax_params(str(tmp_path), "yi-6b")
        batch = {k: jnp.asarray(v) for k, v in dp_batch(cfg).items()}
        jg = jax.jit(jax.grad(jax_model(cfg).loss), compiler_options={
            "xla_allow_excess_precision": False})(jp, batch)
        grads = jax.tree.map(lambda a: np.asarray(a, np.float32), jg)
    rng = np.random.default_rng(8)
    res = P.tree_map(lambda a: (rng.standard_normal(a.shape) * 1e-6).astype(
        np.float32), grads)
    stack = lambda t: jax.tree.map(lambda a: a[None], t)   # noqa: E731
    want_g, want_r = _jax_tree_reduce(
        stack(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads)),
        stack(jax.tree.map(jnp.asarray, res)), None)
    tg = P.tree_map(lambda a: torch.from_numpy(np.array(a)).to(
        torch.bfloat16), grads)
    tr = P.tree_map(lambda a: torch.from_numpy(np.array(a)), res)
    cc.tree_all_reduce(tg, tr, mesh1.get_group("data"), None)
    for (p, a), (_, b) in zip(store.leaf_paths(tg),
                              store.leaf_paths(want_g)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=p)
    for (p, a), (_, b) in zip(store.leaf_paths(tr),
                              store.leaf_paths(want_r)):
        np.testing.assert_array_equal(_bits(a), _bits(b[0]), err_msg=p)


# ---------------------------------------------------------------------------
# two ranks: port ranks (gloo) and a JAX process with two host devices
# ---------------------------------------------------------------------------

def port_rank(rank: int, work: str) -> None:
    """Entry of one port rank: every two-rank workload, into
    ``work/port_<rank>.npz``."""
    import torch.distributed as dist
    from repro_torch.distributed.axes import use_mesh
    from repro_torch.models import moe as M
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "rendezvous"), 2), rank=rank, world_size=2)
    out = {}
    try:
        mesh = make_host_mesh(2, 1, device="cpu")
        group = mesh.get_group("data")
        for name, (x, r) in leaf_inputs().items():
            # rank 1 reduces other values of the same shape
            x = x if rank == 0 else x[::-1].copy() * 0.5 + 0.25
            m, nr = cc.all_reduce_bdi(torch.from_numpy(np.array(x)), group,
                                      torch.from_numpy(np.array(r)))
            out[f"leaf/{name}/mean"], out[f"leaf/{name}/res"] = m.numpy(), \
                nr.numpy()
        res = torch.zeros(256)
        for i, g in enumerate(ef_grads(2)[rank]):
            m, res = cc.all_reduce_bdi(torch.from_numpy(np.array(g)), group,
                                       res)
            out[f"ef/{i}/mean"], out[f"ef/{i}/res"] = m.numpy(), res.numpy()
        grads, res_np, plan = tree_inputs(rank)
        tg, tr = _port_tree(grads, res_np)
        cc.tree_all_reduce(tg, tr, group, plan)
        for p, t in store.leaf_paths(tg):
            out[f"tree/mean{p}"] = t.float().numpy()
        for p, t in store.leaf_paths(tr):
            out[f"tree/res{p}"] = t.numpy()
        cfg, _ = port_params("yi-6b")
        for compress in (True, False):
            m, p, _ = _port_step(cfg, port_params("yi-6b")[1],
                                 dp_batch(cfg), mesh, compress)
            out[f"dp/{compress}/loss"] = np.float64(m["loss"])
            for path, t in store.leaf_paths(p):
                out[f"dp/{compress}/params{path}"] = t.detach().float() \
                    .numpy()
        mcfg, mparams = port_params("deepseek-v2-lite-16b")
        ffn = P.layer(mparams["blocks"], 0)["ffn"]
        x = torch.from_numpy(moe_input(mcfg)).to(torch.bfloat16)
        for shape in MOE_MESHES:
            mesh = make_host_mesh(*shape, device="cpu")
            with use_mesh(mesh):
                # this rank's experts and rows, as the rule table and
                # batch_specs lay them out
                mine = SH.local_params({"blocks": {"ffn": ffn}}, mesh,
                                       layers=mcfg.n_layers)
                y = M.moe_ffn(mine["blocks"]["ffn"],
                              SH.local_batch({"x": x}, mesh)["x"],
                              top_k=mcfg.top_k, n_experts=mcfg.n_experts,
                              capacity_factor=mcfg.capacity_factor)
            out[f"moe/{shape}"] = y.float().numpy()
    finally:
        destroy_mesh()
    np.savez(os.path.join(work, f"port_{rank}.npz"), **out)


def jax_two_devices(work: str) -> None:
    """Entry of the JAX process (two host devices): every two-rank
    workload, into ``work/jax.npz``."""
    from repro.core import bdi_value as jbv
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    from repro.distributed.axes import use_mesh
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models import moe as JM
    assert len(jax.devices()) == 2
    out = {}
    f = _jax_reduce(2)
    for name, (x, r) in leaf_inputs().items():
        xs = np.stack([x, x[::-1] * 0.5 + 0.25]).astype(np.float32)
        m, nr = f(jnp.asarray(xs), jnp.asarray(np.stack([r, r])))
        out[f"leaf/{name}/mean"], out[f"leaf/{name}/res"] = np.asarray(m), \
            np.asarray(nr)
    grads = ef_grads(2)
    res = jnp.zeros((2, 256))
    for i in range(EF_STEPS):
        m, res = f(jnp.asarray(grads[:, i]), res)
        out[f"ef/{i}/mean"], out[f"ef/{i}/res"] = np.asarray(m), \
            np.asarray(res)
    trees = [tree_inputs(r) for r in (0, 1)]
    stack = lambda ts: jax.tree.map(                        # noqa: E731
        lambda *a: jnp.stack(a), *ts)
    g, r = _jax_tree_reduce(stack([_jax_tree(t[0]) for t in trees]),
                            stack([jax.tree.map(jnp.asarray, t[1])
                                   for t in trees]), trees[0][2], 2)
    for p, a in store.leaf_paths(g):
        out[f"tree/mean{p}"] = np.asarray(a, np.float32)
    for p, a in store.leaf_paths(r):
        out[f"tree/res{p}"] = np.asarray(a)
    cfg, params = jax_params(work, "yi-6b")
    for compress in (True, False):
        loss, p = _jax_step(cfg, params, dp_batch(cfg), compress, 2)
        out[f"dp/{compress}/loss"] = np.float64(loss)
        for k, a in jax.tree_util.tree_flatten_with_path(p)[0]:
            out[f"dp/{compress}/params{jax.tree_util.keystr(k)}"] = \
                np.asarray(a, np.float32)
    mcfg, mparams = jax_params(work, "deepseek-v2-lite-16b")
    ffn = jax.tree.map(lambda a: a[0], mparams["blocks"])["ffn"]
    x = jnp.asarray(moe_input(mcfg), jnp.bfloat16)
    for shape in MOE_MESHES:
        with use_mesh(jmesh(*shape)):
            y = jax.jit(lambda p, x: JM.moe_ffn(
                p, x, top_k=mcfg.top_k, n_experts=mcfg.n_experts,
                capacity_factor=mcfg.capacity_factor))(ffn, x)
        out[f"moe/{shape}"] = np.asarray(y, np.float32)
    np.savez(os.path.join(work, "jax.npz"), **out)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both sides' two-rank records: {"jax": npz, "port": [rank 0, 1]}."""
    work = tmp_path_factory.mktemp("two_ranks")
    for name in ("yi-6b", "deepseek-v2-lite-16b"):
        store.save(str(work / "params" / name), 0, port_params(name)[1])
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path)
    jenv = dict(env, XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
        + " --xla_allow_excess_precision=false").strip())
    def start(call: str, e: dict):
        code = f"import test_torch_distributed as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    procs = [start(f"port_rank({r}, {str(work)!r})", env) for r in (0, 1)]
    procs.append(start(f"jax_two_devices({str(work)!r})", jenv))
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0, 0, 0], rcs
    load = lambda name: dict(np.load(work / name))           # noqa: E731
    return {"jax": load("jax.npz"),
            "port": [load(f"port_{r}.npz") for r in (0, 1)]}


def _bit_equal_rows(rec: dict, prefix: str) -> int:
    """Means (replicated) and each rank's residual under ``prefix``,
    bit-equal to JAX's; returns how many arrays were compared."""
    jax_rec, ports = rec["jax"], rec["port"]
    keys = [k for k in jax_rec if k.startswith(prefix)]
    assert keys
    for k in keys:
        for r, port in enumerate(ports):
            want = jax_rec[k]
            if "/res" in k:
                want = want[r]
            np.testing.assert_array_equal(_bits(port[k]), _bits(want),
                                          err_msg=f"{k} rank {r}")
    return len(keys)


@pytest.mark.parametrize("case", sorted(leaf_inputs()))
def test_all_reduce_bdi_two_ranks_bit_equal(two_ranks, case):
    assert _bit_equal_rows(two_ranks, f"leaf/{case}/") == 2


def test_error_feedback_two_ranks_twenty_steps_bit_equal(two_ranks):
    assert _bit_equal_rows(two_ranks, "ef/") == 2 * EF_STEPS


def test_tree_all_reduce_two_ranks_bit_equal(two_ranks):
    assert _bit_equal_rows(two_ranks, "tree/") == 6


@pytest.mark.parametrize("compress", [True, False])
def test_dp_step_two_ranks_matches_jax(two_ranks, compress):
    jax_rec = two_ranks["jax"]
    for port in two_ranks["port"]:
        np.testing.assert_allclose(port[f"dp/{compress}/loss"],
                                   jax_rec[f"dp/{compress}/loss"],
                                   rtol=LOSS_RTOL)
        keys = [k for k in jax_rec if k.startswith(f"dp/{compress}/params")]
        assert len(keys) == len(P.leaves(port_params("yi-6b")[1]))
        for k in keys:
            a, b = port[k], jax_rec[k]
            share = float((np.abs(a - b) <= _ulp(np.maximum(
                np.abs(a), np.abs(b)))).mean())
            assert share >= STEP_ULP_SHARE, (k, share)
    # the ranks hold the same params after the step
    for k in jax_rec:
        if k.startswith(f"dp/{compress}/params"):
            np.testing.assert_array_equal(two_ranks["port"][0][k],
                                          two_ranks["port"][1][k])


@pytest.mark.parametrize("shape", MOE_MESHES)
def test_moe_expert_parallel_two_ranks_matches_jax(two_ranks, shape):
    """Each rank runs its experts on its rows (the whole batch under
    ``(1, 2)``, half of it under ``(2, 1)``) and returns those rows."""
    whole = two_ranks["jax"][f"moe/{shape}"]
    for r, port in enumerate(two_ranks["port"]):
        n = whole.shape[0] // shape[0]
        lo = (r // shape[1]) * n
        want = whole[lo:lo + n]
        got = port[f"moe/{shape}"]
        assert got.shape == want.shape
        mag = np.maximum(np.abs(got), np.abs(want))
        assert (np.abs(got - want) <= MOE_ULPS * _ulp(mag)).all(), \
            np.abs(got - want).max()
