"""FSDP over the layer dim of stacked leaves: the port's train step on
``(3, 1)`` and ``(3, 2)`` meshes vs JAX's GSPMD program on three or six
host devices, on the CPU.

JAX's rule table (``param_shardings(fsdp=True)``) shards the largest
replicated dim of a leaf above ``FSDP_THRESHOLD_BYTES`` that the data
axes divide.  Where they divide the depth and none of the widths, that
dim is the stack's layers.  Every case has 3 layers (a layer a data
rank) and widths 3 does not divide (d_model 64, 4 heads of 16), with the
threshold lowered to 8 KiB in both packages (a test-only patch of the
module constant, as ``tests/test_torch_dp_tp.py`` lowers it):

* ``yi-6b`` (dense GQA, d_ff 128) and ``seamless`` (seamless-m4t-large-v2:
  3 encoder and 3 decoder layers, cross attention) on ``(3, 1)``: every
  stacked matrix (wq, wk, wv, wo, gate, up, down; seamless's cross
  attention too) split over the layer dim;
* ``deepseek`` (deepseek-v2-lite-16b: MLA and 8 routed experts beside a
  shared one) on ``(3, 1)``: wo and the experts' and shared expert's
  matrices over the layer dim, wq over its head width (an FSDP block
  beside them);
* ``hymba`` (hymba-1.5b: attention heads beside Mamba channels) and
  ``xlstm`` (xlstm-350m, its middle layer an sLSTM) on ``(3, 2)``: the
  layer split beside a model axis, each layer's block cut over ``model``
  too (hymba's wq, wo, MLP and Mamba projections; every mLSTM and sLSTM
  matrix, mLSTM's ``w_if`` read by each rank's heads only).

The norms, the embedding and the head stay whole over ``data``.  A rank
holds its layer (``sharding.local_params`` or
``init_params(local=Local(..., layers=3))``, the same bytes); each
layer's product reads the layer broadcast from its owner
(``tp.layer_gather``), forward and again in the layer's recompute, and
the layer's f32 gradient is summed over ``data`` onto the owner and
rounded once.

One module fixture starts, all at once (gloo over a ``FileStore`` a
mesh, each process writing ``.npz``): the port's ranks of each mesh, and
one JAX process a case with
``XLA_FLAGS=--xla_force_host_platform_device_count=<ranks>
--xla_allow_excess_precision=false``.  The JAX process swaps its
``_pow2_scale`` for the exact construction of 2^e (test-only).

What must match (``tests/test_torch_dp_tp.py``'s bounds, for the same
reasons):

* bit for bit: each rank's params, cut from the whole model (and for
  the dense decoder drawn by the layer-wise init), against JAX's
  addressable shard on device r;
* the loss: rtol 1e-4 (and the same bits on every rank); each gradient
  block against JAX's gradient cut to the rank's block: relative
  Frobenius error <= 1e-2 (the dense decoder) or 2e-2 (the other
  families, ``tests/test_torch_families.py``'s bound);
* one step from the zero state under f32 and bdi8 moments (bdi8: gate's
  and up's moments in tiles of 128, through the tile codec): params
  within one bf16 ULP for at least 99% of each block, loaded moments
  within a relative Frobenius error of 2e-2;
* the step's collectives on each rank: one broadcast of each split
  leaf's layer at each layer that reads it (xLSTM's mLSTM leaves at its
  mLSTM layers, its sLSTM leaves at its sLSTM layer), forward and
  recompute, and the counts and bytes
  of every kind equal to the dry run's trace of the step at the rank's
  coordinate (``launch/dryrun.trace``).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _workers  # noqa: F401  (shares the cores among xdist workers)

from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as TP
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.launch import dryrun as D
from repro_torch.launch import elastic as EL
from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim import adamw as AW
from test_torch_decode import _ulp, exact_pow2_scale
from test_torch_dp_tp import _f32, _moments, _np
from test_torch_train import STEP_MOMENT_RTOL, STEP_ULP_SHARE

REPO = Path(__file__).resolve().parents[1]
ATTN = ("['wq']['w']", "['wk']['w']", "['wv']['w']", "['wo']['w']")
MLP = ("['gate']['w']", "['up']['w']", "['down']['w']")
# case -> (arch, reduced() overrides, the stacked leaves split over the
# layer dim by the end of their path, mesh (data, model))
CASES = {
    "yi-6b": ("yi-6b", {"n_layers": 3, "d_model": 64, "d_ff": 128,
                        "n_heads": 4, "n_kv_heads": 2, "vocab": 256},
              ATTN + MLP, (3, 1)),
    "seamless": ("seamless-m4t-large-v2", {
        "n_layers": 3, "enc_layers": 3, "d_model": 64, "d_ff": 128,
        "n_heads": 4, "n_kv_heads": 4, "vocab": 128}, ATTN + MLP, (3, 1)),
    "deepseek": ("deepseek-v2-lite-16b", {"n_layers": 3},
                 ("['wo']['w']",) + MLP, (3, 1)),
    "hymba": ("hymba-1.5b", {"n_layers": 3},
              ("['wq']['w']", "['wo']['w']", "['in_proj']['w']",
               "['out_proj']['w']") + MLP, (3, 2)),
    "xlstm": ("xlstm-350m", {"n_layers": 3, "slstm_every": 2},
              ("['wq']['w']", "['wk']['w']", "['wv']['w']", "['up']['w']",
               "['down']['w']", "['gate_z']['w']", "['w_if']['w']",
               "['slstm']['r']", "['wx']['w']"), (3, 2)),
}
MESHES = sorted({c[3] for c in CASES.values()})
# the cases beside a model axis: each also runs with no mesh (one
# process) and on its mesh with no FSDP at all
WHOLE = ("hymba", "xlstm")
THRESHOLD = 8 << 10
DTYPES = ("f32", "bdi8")
SHAPE = ShapeConfig("t", 32, 3, "train")     # 3 rows: one a rank
LOSS_RTOL = 1e-4
# relative Frobenius error of a gradient block: tests/test_torch_dp_tp.py's
# for the dense decoder, tests/test_torch_families.py's for the other
# families (with no mesh at all, the encoder-decoder's whole model's
# cross-attention wk gradient here is already nearly 1e-2 from JAX's)
GRAD_RTOL = {"yi-6b": 1e-2, "seamless": 2e-2, "deepseek": 2e-2,
             "hymba": 2e-2, "xlstm": 2e-2}
# Beside a model axis every leaf is held to the bounds plus the port's
# own distance from JAX with no mesh, at the rank's block, as
# tests/test_torch_tp_families.py holds its time-scanned leaves: on
# (3, 2) the model axis alone puts these families' step a few 1e-3 off
# the run with no mesh (mLSTM's wv's bdi8 v lies 2.02e-2 from JAX on
# rank 0 with or without the layer split, 1.25e-2 with no mesh), and
# test_layer_split_equals_the_mesh_without_fsdp holds the layer split to
# the same mesh's run without it, bit for bit.


def cfg_of(case: str, package_get_arch=get_arch):
    arch, kw, _, _ = CASES[case]
    return package_get_arch(arch).reduced(**kw)


def ranks(mesh: tuple) -> int:
    return mesh[0] * mesh[1]


class threshold:
    """``FSDP_THRESHOLD_BYTES`` of a rule table (``module``) at
    ``THRESHOLD`` for a while (test-only)."""

    def __init__(self, module=SH):
        self.module = module

    def __enter__(self):
        self.prev = self.module.FSDP_THRESHOLD_BYTES
        self.module.FSDP_THRESHOLD_BYTES = THRESHOLD

    def __exit__(self, *exc):
        self.module.FSDP_THRESHOLD_BYTES = self.prev


def full_params(case: str) -> dict:
    return get_model(cfg_of(case)).init(torch.Generator().manual_seed(0),
                                        "cpu")


def batch_np(cfg) -> dict:
    return TP.make_train_batch(cfg, SHAPE, TP.DataConfig(seed=2), step=0)


def _coord(rank: int, mesh: tuple) -> dict:
    return {"data": rank // mesh[1], "model": rank % mesh[1]}


# ---------------------------------------------------------------------------
# the port: one rank
# ---------------------------------------------------------------------------

def port_case(case: str, mesh, prefix: str | None = None) -> dict:
    """Placement, loss, gradients and one step under each moment dtype of
    one case on the active mesh, keyed ``prefix`` (the case's name) +
    ``/`` + what."""
    cfg = cfg_of(case)
    model = get_model(cfg)
    out = {}
    local = SH.local_params(full_params(case), mesh, fsdp=True)
    if cfg.family == "dense":       # the init that cuts a layer at a time
        drawn = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                              local=SH.Local(mesh, fsdp=True,
                                             layers=cfg.n_layers))
        out["init_local_equal"] = np.asarray(all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                store.leaf_paths(drawn), store.leaf_paths(local))))
    for path, leaf in store.leaf_paths(local):
        out[f"shard{path}"] = _np(leaf)
    whole = model.init(torch.Generator(), "meta")
    out["layers"] = np.asarray([d == 0 for _, _, d in
                                tp.placement(whole, local)])
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    # the gradients of this rank's rows, from a thread with no mesh
    # active (on the card autograd runs the backward and the recompute on
    # its own); zeros for a block no layer reads, as the train step
    # takes them (an xLSTM rank that holds only its sLSTM layer's rows)
    params = P.tree_map(torch.clone, local)
    flat = [t.requires_grad_() for t in P.leaves(params)]
    loss = model.loss(params, SH.local_batch(batch, mesh))
    with ThreadPoolExecutor(1) as pool:
        grads = pool.submit(torch.autograd.grad, loss, flat,
                            allow_unused=True,
                            materialize_grads=True).result()
    out["loss0"] = np.float32(float(loss.detach()))
    for (path, _), g in zip(store.leaf_paths(params), grads):
        out[f"grad{path}"] = _f32(g)
    for md in DTYPES:
        ocfg = AdamWConfig(moment_dtype=md)
        params = P.tree_map(torch.clone, local)
        state = adamw_init(params, ocfg, whole=whole)
        owner = [leaf.owner for leaf in AW.plan(params, whole, ocfg)]
        out[f"{md}/owner"] = np.asarray([-1 if o is None else o
                                         for o in owner])
        params, state, met = make_train_step(model, ocfg)(params, state,
                                                          batch)
        out[f"{md}/loss"] = np.float32(met["loss"])
        out[f"{md}/counts"] = _counts(met["collectives"])
        for path, p in store.leaf_paths(params):
            out[f"{md}/step/param{path}"] = _f32(p)
        for k, v in _moments(params, state).items():
            out[f"{md}/step/{k}"] = v
    return {f"{prefix or case}/{k}": v for k, v in out.items()}


def port_whole(case: str, work: str) -> None:
    """Entry of the port's run of a case with scanned leaves with no mesh
    (one process, the whole model): its gradients and one step (params
    and loaded moments) under each moment dtype, into
    ``work/whole_<case>.npz``."""
    cfg = cfg_of(case)
    model = get_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    params = P.tree_map(torch.clone, full_params(case))
    flat = [t.requires_grad_() for t in P.leaves(params)]
    grads = torch.autograd.grad(model.loss(params, batch), flat,
                                allow_unused=True, materialize_grads=True)
    out = {f"grad{path}": _f32(g)
           for (path, _), g in zip(store.leaf_paths(params), grads)}
    for md in DTYPES:
        ocfg = AdamWConfig(moment_dtype=md)
        params = full_params(case)
        params, state, _ = make_train_step(model, ocfg)(
            params, adamw_init(params, ocfg), batch)
        for path, p in store.leaf_paths(params):
            out[f"{md}/step/param{path}"] = _f32(p)
        for k, v in _moments(params, state).items():
            out[f"{md}/step/{k}"] = v
    np.savez(os.path.join(work, f"whole_{case}.npz"), **out)


def port_rank(shape: tuple, rank: int, work: str) -> None:
    """Entry of one port rank of a ``shape`` (data, model) mesh: every
    case on that mesh, into ``work/port_<d>x<m>_<rank>.npz``."""
    import torch.distributed as dist
    tag = "%dx%d" % shape
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, f"rendezvous_{tag}"), ranks(shape)), rank=rank,
        world_size=ranks(shape))
    out = {}
    try:
        mesh = make_host_mesh(*shape, device="cpu")
        with AX.use_mesh(mesh):
            for case, c in CASES.items():
                if c[3] != shape:
                    continue
                with threshold():
                    out.update(port_case(case, mesh))
                if case in WHOLE:      # the same mesh, no FSDP at all
                    out.update(port_case(case, mesh, f"{case}/base"))
    finally:
        destroy_mesh()
    np.savez(os.path.join(work, f"port_{tag}_{rank}.npz"), **out)


def _counts(c: dict) -> np.ndarray:
    """Counts and bytes of every kind by axis, in ``tp.AXES`` order."""
    return np.asarray([[c[a][op], c[a][f"{op}_bytes"]] for a in tp.AXES
                       for op in tp.OPS])


# ---------------------------------------------------------------------------
# JAX: one process, three host devices
# ---------------------------------------------------------------------------

def jax_run(case: str, work: str) -> None:
    """Entry of a JAX process (one a case): the addressable shards, the
    loss and gradients, and one ``adamw_update`` under each moment dtype,
    jitted under GSPMD on the case's mesh, into
    ``work/jax_<case>.npz``."""
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.core import bdi_value as jbv
    from repro.distributed import sharding as JSH
    from repro.distributed.axes import use_mesh
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models.api import get_model as jax_model
    from repro.optim import adamw as JO
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    shape = CASES[case][3]
    assert len(jax.devices()) == ranks(shape)
    mesh = jmesh(*shape)
    where = {d: i for i, d in enumerate(mesh.devices.flat)}
    opts = {"xla_allow_excess_precision": False}
    named = lambda specs: jax.tree.map(                       # noqa: E731
        lambda s: jax.sharding.NamedSharding(mesh, s), specs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    out = {}
    with use_mesh(mesh), threshold(JSH):
        jcfg = cfg_of(case, jax_arch)
        jm = jax_model(jcfg)
        like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        psh = JSH.param_shardings(like, mesh, fsdp=True)
        params = jstore.restore(os.path.join(work, "params", case), like,
                                target_shardings=psh)[0]
        for k, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            for s in leaf.addressable_shards:
                out[f"shard/{where[s.device]}"
                    f"{jax.tree_util.keystr(k)}"] = _np(s.data)
        states = {md: JO.adamw_init(params, JO.AdamWConfig(moment_dtype=md))
                  for md in DTYPES}
        osh = {md: JSH.param_shardings(s, mesh, fsdp=True)
               for md, s in states.items()}
        states = jax.device_put(states, osh)
        tb = {k: jax.device_put(jnp.asarray(v), named(JSH.batch_specs(
            jnp.asarray(v), mesh))) for k, v in batch_np(jcfg).items()}

        def both(params, states, batch):
            loss, grads = jax.value_and_grad(jm.loss)(params, batch)
            upd = {md: JO.adamw_update(params, grads, st, JO.AdamWConfig(
                moment_dtype=md))[:2] for md, st in states.items()}
            return loss, grads, upd
        loss, grads, upd = jax.jit(
            both, out_shardings=(None, psh, {
                md: (psh, osh[md]) for md in DTYPES}),
            compiler_options=opts)(params, states, tb)
        out["loss0"] = np.float32(loss)
        for k, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"grad{jax.tree_util.keystr(k)}"] = _f32(g)
        for md in DTYPES:
            p2, s2 = upd[md]
            trees = {"param": p2, **{k: jax.tree.map(
                lambda p, s, md=md: JO._load(s, md, p.shape), params,
                s2[k]) for k in ("m", "v")}}
            for key, tree in trees.items():
                for k, leaf in jax.tree_util.tree_flatten_with_path(
                        tree)[0]:
                    out[f"{md}/step/{key}{jax.tree_util.keystr(k)}"] = \
                        _f32(leaf)
    np.savez(os.path.join(work, f"jax_{case}.npz"), **out)


# ---------------------------------------------------------------------------
# the fixture: all processes at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax": {case: npz}, "port": {case: [npz of each rank of its
    mesh]}, "whole": {case: npz of the port with no mesh}}."""
    work = tmp_path_factory.mktemp("tp_layers")
    for case in CASES:
        store.save(str(work / "params" / case), 0, full_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tp_layers as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    def jenv(case: str) -> dict:
        return dict(env, XLA_FLAGS=(
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
              f"{ranks(CASES[case][3])}"
            + " --xla_allow_excess_precision=false").strip())
    procs = [start(f"jax_run({case!r}, {str(work)!r})", jenv(case))
             for case in CASES]
    procs += [start(f"port_rank({shape!r}, {r}, {str(work)!r})", env)
              for shape in MESHES for r in range(ranks(shape))]
    procs += [start(f"port_whole({case!r}, {str(work)!r})", env)
              for case in WHOLE]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * len(procs), rcs
    port = {shape: [dict(np.load(work / f"port_{shape[0]}x{shape[1]}_{r}"
                                           ".npz"))
                    for r in range(ranks(shape))] for shape in MESHES}
    return {"jax": {c: dict(np.load(work / f"jax_{c}.npz")) for c in CASES},
            "port": {c: port[CASES[c][3]] for c in CASES},
            "whole": {c: dict(np.load(work / f"whole_{c}.npz"))
                      for c in WHOLE}}


def _paths(case: str) -> list[str]:
    return [p for p, _ in store.leaf_paths(full_params(case))]


def _split(case: str) -> set:
    """The leaves the rule table splits over the layer dim: every stacked
    leaf whose path ends as the case names (encoder and decoder stacks
    alike)."""
    return {p for p in _paths(case) if SH.STACKS.match(p)
            and p.endswith(CASES[case][2])}


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _share(a: np.ndarray, b: np.ndarray) -> float:
    """The share of ``a`` within one bf16 ULP of ``b``."""
    return float((np.abs(a - b) <= _ulp(np.maximum(np.abs(a), np.abs(b)))
                  ).mean())


def _rank_block(case: str, whole: np.ndarray, path: str, rank: int,
                like: tuple, owner: int) -> np.ndarray:
    """What rank ``rank`` keeps of a whole params-shaped array whose block
    there has shape ``like``: its param block (the last dim whole where
    a moment's tiles straddle the model shards), cut to the rank's 1/d
    along ``owner`` where ZeRO-1 splits a moment of a leaf whole over
    data."""
    b = _block(case, whole, path, rank)
    if like[-1] != b.shape[-1]:
        b = _block(case, whole, path, rank, model_cut=False)
    return _cut_to(like, b, _coord(rank, CASES[case][3])["data"], owner)


def _cut_to(like: tuple, b: np.ndarray, dr: int, dim: int) -> np.ndarray:
    """``b`` as it is, or where its shape is not ``like`` block ``dr`` of
    it along ``dim``."""
    if tuple(like) == b.shape:
        return b
    n = like[dim]
    return np.take(b, range(dr * n, (dr + 1) * n), axis=dim)


def _slack(records, case: str, key: str, path: str, rank: int,
           like: tuple, owner: int) -> float:
    """Beside a model axis (``WHOLE``), the port's run with no mesh's
    distance from JAX at rank ``rank``'s block (``grad`` and the moments:
    relative Frobenius; ``step/param``: 1 - the share within one bf16
    ULP); 0 elsewhere."""
    if case not in WHOLE:
        return 0.0
    got, want = (_rank_block(case, rec[f"{key}{path}"], path, rank, like,
                             owner)
                 for rec in (records["whole"][case], records["jax"][case]))
    return 1 - _share(got, want) if key.endswith("param") \
        else _rel(got, want)


def _broadcasts(case: str) -> int:
    """Broadcasts over ``data`` of a step: one of each split leaf's layer
    at each layer that reads it, forward and recompute.  An xLSTM layer
    reads its own mixer's leaves only."""
    cfg = cfg_of(case)
    split = _split(case)
    if cfg.family != "ssm":
        return 2 * cfg.n_layers * len(split)
    return 2 * sum(sum(("['slstm']" in p) == bool(s) for p in split)
                   for s in X.layer_is_slstm(cfg))


def _block(case: str, whole: np.ndarray, path: str, rank: int,
           model_cut: bool = True) -> np.ndarray:
    """Rank ``rank``'s block of a whole params-shaped leaf under
    ``param_specs(fsdp=True)`` at ``THRESHOLD`` (the param's dtype sets
    the bytes the rule table reads).  ``model_cut`` False: the last dim
    whole over ``model``, as a moment whose tiles straddle the model
    shards is kept (``optim/adamw._wide``)."""
    shape = CASES[case][3]
    mesh = EL.abstract_mesh(shape, ("data", "model"))
    with threshold():
        spec = SH._spec_for(path, whole.shape, mesh, _itemsize(case, path),
                            True)
    if not model_cut and spec[-1] == "model":
        spec = type(spec)(*spec[:-1], None)
    return SH.local_shards({"x": torch.from_numpy(whole)}, {"x": spec}, mesh,
                           coord=_coord(rank, shape))["x"].numpy()


def _itemsize(case: str, path: str) -> int:
    return dict(store.leaf_paths(full_params(case)))[path].element_size()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_placement_equals_jax_addressable_shards(records, case):
    """The case's stacked leaves split over ``data`` along their layer
    dim, one layer a data rank; each rank's blocks (and, for the dense
    decoder, those its init draws a layer at a time) JAX's shards bit for
    bit."""
    paths, split = _paths(case), _split(case)
    assert split
    for r, port in enumerate(records["port"][case]):
        if f"{case}/init_local_equal" in port:
            assert bool(port[f"{case}/init_local_equal"])
        layered = {p for p, s in zip(paths, port[f"{case}/layers"]) if s}
        assert layered == split, layered ^ split
        for path in paths:
            got = port[f"{case}/shard{path}"]
            want = records["jax"][case][f"shard/{r}{path}"]
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (path, r, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {r}")
            if path in split:
                assert got.shape[0] == 1


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(records, case):
    want = records["jax"][case]
    for r, port in enumerate(records["port"][case]):
        assert port[f"{case}/loss0"] == \
            records["port"][case][0][f"{case}/loss0"]
        np.testing.assert_allclose(port[f"{case}/loss0"], want["loss0"],
                                   rtol=LOSS_RTOL)
        for path in _paths(case):
            got = port[f"{case}/grad{path}"]
            ref = _block(case, want[f"grad{path}"], path, r)
            assert got.shape == ref.shape, (path, got.shape, ref.shape)
            err = _rel(got, ref)
            assert err <= GRAD_RTOL[case] + _slack(
                records, case, "grad", path, r, got.shape, 0), (path, r, err)


@pytest.mark.parametrize("case,md", [(c, md) for c in CASES
                                     for md in DTYPES])
def test_one_step_matches_jax(records, case, md):
    """One step from the zero state: each rank's params and the moments
    of the blocks it owns (ZeRO-1: its own layer of a split leaf, its 1/3
    of a whole leaf's moments where the rule table splits them) against
    JAX's, cut to the rank's blocks."""
    want = records["jax"][case]
    for r, port in enumerate(records["port"][case]):
        np.testing.assert_allclose(port[f"{case}/{md}/loss"],
                                   want["loss0"], rtol=LOSS_RTOL)
        owner = port[f"{case}/{md}/owner"]
        for i, path in enumerate(_paths(case)):
            for k in ("param", "m", "v"):
                key = f"{md}/step/{k}"
                a = port[f"{case}/{key}{path}"]
                b = _rank_block(case, want[f"{key}{path}"], path, r,
                                a.shape, int(owner[i]))
                slack = _slack(records, case, key, path, r, a.shape,
                               int(owner[i]))
                if k == "param":
                    assert _share(a, b) >= STEP_ULP_SHARE - slack, \
                        (md, path, r, _share(a, b), slack)
                else:
                    assert _rel(a, b) <= STEP_MOMENT_RTOL + slack, \
                        (md, k, path, r, _rel(a, b), slack)


@pytest.mark.parametrize("case", WHOLE)
def test_layer_split_equals_the_mesh_without_fsdp(records, case):
    """Beside a model axis, the layer split changes no bit: each rank's
    loss, gradients, and params and moments after one step under each
    moment dtype equal, bit for bit, those of the same mesh's run with
    no FSDP (the real threshold: every leaf whole over ``data``), cut to
    the rank's layer (and, for a moment, its ZeRO-1 block)."""
    d = CASES[case][3][0]
    for r, port in enumerate(records["port"][case]):
        dr = _coord(r, CASES[case][3])["data"]
        assert port[f"{case}/loss0"] == port[f"{case}/base/loss0"]
        keys = ["grad"] + [f"{md}/step/{k}" for md in DTYPES
                           for k in ("param", "m", "v")]
        for i, path in enumerate(_paths(case)):
            for key in keys:
                a = port[f"{case}/{key}{path}"]
                b = port[f"{case}/base/{key}{path}"]
                dim = next((j for j in range(a.ndim)
                            if a.shape[j] * d == b.shape[j]), 0)
                np.testing.assert_array_equal(
                    a, _cut_to(a.shape, b, dr, dim), err_msg=f"{key}{path}")


@pytest.mark.parametrize("case,md", [(c, md) for c in CASES
                                     for md in DTYPES])
def test_step_collectives_equal_trace(records, case, md):
    """Each rank's step: one broadcast over ``data`` of each split leaf's
    layer at each layer that reads it, forward and recompute, in bf16;
    every kind's count and bytes equal to the dry run's trace of the step
    at the rank's coordinate."""
    cfg, shape = cfg_of(case), CASES[case][3]
    ops = list(tp.OPS)
    for r, port in enumerate(records["port"][case]):
        got = port[f"{case}/{md}/counts"]
        data = len(ops)                            # tp.AXES: model, data
        assert got[data + ops.index("broadcast"), 0] == _broadcasts(case)
        with threshold():
            row = D.trace(cfg, SHAPE, EL.abstract_mesh(
                shape, ("data", "model"), _coord(r, shape)),
                AdamWConfig(moment_dtype=md), 1, torch.float32,
                batch={k: torch.empty(v.shape, dtype=torch.from_numpy(
                    v).dtype, device="meta")
                    for k, v in batch_np(cfg).items()})
        by_axis = row["collectives"]["by_axis"]
        want = np.asarray([[by_axis[a][op], by_axis[a][f"{op}_bytes"]]
                           for a in tp.AXES for op in tp.OPS])
        np.testing.assert_array_equal(got, want, err_msg=f"{md} {r}")


MESH = (3, 1)


@pytest.mark.parametrize("arch,kw", [
    ("yi-6b", CASES["yi-6b"][1]),
    ("deepseek-v2-lite-16b", {"n_layers": 3, "d_model": 64, "vocab": 128}),
    ("arctic-480b", {"n_layers": 3, "d_model": 64, "vocab": 128})])
def test_layerwise_init_equals_cut_of_whole(arch, kw):
    """``init_params(local=Local(..., layers=L))``, which draws the model a
    layer at a time (MoE expert stacks an expert at a time) and keeps a
    rank's layers of each leaf split over the layer dim, equals the
    rank's blocks cut from the whole model, at every coordinate of an
    abstract ``(3, 1)`` mesh (no collective runs)."""
    cfg = get_arch(arch).reduced(**kw)
    full = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = EL.abstract_mesh(MESH, ("data", "model"))
    with threshold():
        split = {p for p, t in store.leaf_paths(full) if SH._spec_for(
            p, tuple(t.shape), mesh, t.element_size(), True)[0] == "data"}
        assert any("experts" in p for p in split) == cfg.is_moe, split
        for r in range(ranks(MESH)):
            coord = _coord(r, MESH)
            want = SH.local_params(full, mesh, coord, fsdp=True)
            got = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                local=SH.Local(mesh, coord, fsdp=True,
                                               layers=cfg.n_layers))
            for (p, a), (_, b) in zip(store.leaf_paths(got),
                                      store.leaf_paths(want)):
                assert torch.equal(a, b), (p, r)
                if p in split:
                    assert a.shape[0] == 1, (p, a.shape)
