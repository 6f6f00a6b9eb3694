"""The pod axis and moment tiles that straddle data blocks: real gloo
ranks of the port against JAX's GSPMD program on the same mesh, on the
CPU (``tests/test_torch_dp_tp.py``'s pattern: gloo over a
``FileStore``, each process writing ``.npz``, all started at once).

Cases:

* ``pod``: reduced yi-6b at d_model 256, d_ff 256, 4/2 heads, vocab 256,
  2 layers on ``(2, 1, 2)`` (``pod``, ``data``, ``model``; FSDP at a
  threshold of 64 KiB, test-only, so that its blocks lie over the pod
  axis): the batch's rows and the FSDP blocks over ``("pod", "data")``,
  the port's data group the mesh's pod and data dims flattened
  (``tp.data_group``);
* ``straddle``: reduced yi-6b widened to d_model 384 with 3 heads of 128
  (one KV head), d_ff 256, vocab 255, on ``(2, 1)`` with FSDP at 16 KiB:
  wo's 3 tiles of D (and down's and the embedding's) over 2 data blocks
  under ``q8`` and ``bdi8``.  As for arctic-480b's production ``wo``, the
  rule table splits wo's ``deltas`` over its head dim and keeps its
  ``scale`` whole; a rank keeps the moments of its block of the head dim
  (``optim/adamw.plan``), moved from its FSDP block of D by an
  all-to-all (``tp.all_to_all``, as GSPMD reshards it) and back.  The
  embedding's 255 rows divide no data axis (as arctic's dense ``down``
  at the multi-pod mesh): every rank updates its whole moments.

What must match (``tests/test_torch_dp_tp.py``'s bounds, for its
reasons):

* each rank's param blocks, bit for bit, JAX's addressable shards;
* the pod case's prefill and decode logits within 2 bf16 ULPs of the
  array's largest |value|, its loss within rtol 1e-4;
* one ``make_train_step`` step (f32 moments; q8 and bdi8 too in the
  straddle case) against JAX's jitted step from the same state: the
  loss within rtol 1e-4, ``grad_norm`` within 1e-3, params within one
  bf16 ULP for at least 99% of each block, loaded moments within a
  relative Frobenius error of 2e-2;
* the straddling moment stores bit for bit: one ``adamw_update`` from
  the zero state on the same gradient (no clip, so that neither side's
  norm enters) in both packages; each rank's store leaves equal the block
  of JAX's whole store that the rank's region covers, and wo's ``deltas``
  equal JAX's addressable shard of that device itself;
* the rank's collectives (``tp.COUNTS`` over the step, by axis: counts,
  bytes by kind, backward) and its FLOPs (``FlopCounterMode`` of the
  step) equal the dry run's trace of that rank (``launch/dryrun.
  build_train_step`` on ``meta`` at the rank's coordinate of an abstract
  mesh): ``launch/train.make_train_step`` runs that step.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

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
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as AW
from test_torch_decode import _ulp, assert_model_ulps, exact_pow2_scale
from test_torch_dp_tp import _f32, _moments, _np
from test_torch_train import STEP_MOMENT_RTOL, STEP_ULP_SHARE

REPO = Path(__file__).resolve().parents[1]
YI = {"d_model": 256, "d_ff": 256, "n_heads": 4, "n_kv_heads": 2,
      "vocab": 256}
WIDE = {"d_model": 384, "d_ff": 256, "n_heads": 3, "n_kv_heads": 1,
        "vocab": 255}
# case -> (reduced() overrides of yi-6b, mesh, FSDP threshold, dtypes)
CASES = {"pod": (YI, (2, 1, 2), 64 << 10, ("f32",)),
         "straddle": (WIDE, (2, 1), 16 << 10, ("f32", "q8", "bdi8"))}
STRADDLES = ("q8", "bdi8")
BATCH, PROMPT = 4, 8
SHAPE = ShapeConfig("t", 32, BATCH, "train")
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
WO = "['blocks']['attn']['wo']['w']"


def _names(shape: tuple) -> tuple:
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _coord(case: str, rank: int) -> dict:
    shape = CASES[case][1]
    idx = np.unravel_index(rank, shape)
    return {a: int(i) for a, i in zip(_names(shape), idx)}


def case_cfg(case: str):
    return get_arch("yi-6b").reduced(**CASES[case][0])


def case_params(case: str) -> dict:
    return T.init_params(case_cfg(case), torch.Generator().manual_seed(0),
                         "cpu")


def case_grads(case: str) -> dict:
    """A gradient tree of the params' shapes and dtype (seed 5)."""
    rng = np.random.default_rng(5)
    return {path: (rng.standard_normal(t.shape) * 1e-2).astype(np.float32)
            for path, t in store.leaf_paths(case_params(case))}


def ocfg(md: str, clip: bool = True) -> AdamWConfig:
    return AdamWConfig(moment_dtype=md,
                       grad_clip=AdamWConfig.grad_clip if clip else 0.0)


class threshold:
    """``FSDP_THRESHOLD_BYTES`` of a rule table (``module``) set to a
    case's for a while (test-only)."""

    def __init__(self, case: str, module=SH):
        self.module, self.value = module, CASES[case][2]

    def __enter__(self):
        self.prev = self.module.FSDP_THRESHOLD_BYTES
        self.module.FSDP_THRESHOLD_BYTES = self.value

    def __exit__(self, *exc):
        self.module.FSDP_THRESHOLD_BYTES = self.prev


def tokens(cfg) -> np.ndarray:
    return np.random.default_rng(3).integers(
        1, cfg.vocab, (BATCH, PROMPT + 1)).astype(np.int32)


def train_batch(cfg) -> dict:
    return TP.make_train_batch(cfg, SHAPE, TP.DataConfig(seed=2), step=0)


def _stores(state: dict, md: str) -> dict:
    """Every moment store leaf as JAX holds it (bdi8 masks in bytes)."""
    if md == "bdi8":
        state = AW.export_state(state)
    return {f"{k}{path}": _np(t) for k in ("m", "v")
            for path, t in store.leaf_paths(state[k])}


# ---------------------------------------------------------------------------
# the port: one rank
# ---------------------------------------------------------------------------

def _predicted(case: str, md: str, coord: dict, whole: dict) -> tuple:
    """The dry run's trace of this rank's step: its collectives and FLOPs
    (``build_train_step`` on ``meta`` under an abstract mesh)."""
    cfg = case_cfg(case)
    shape = CASES[case][1]
    mesh = EL.abstract_mesh(shape, _names(shape), coord)
    d = int(np.prod(shape[:-1]))
    with AX.use_mesh(mesh):
        local = SH.local_params(whole, mesh, fsdp=True)
        state = adamw_init(local, ocfg(md), whole=whole)
        batch = D._batch(cfg, SHAPE, BATCH // d)
        step = D.build_train_step(get_model(cfg), ocfg(md), 1,
                                  torch.float32, whole)
        before = tp.counts()
        with D.Count() as count:
            step(local, state, batch)
        return tp.counts_since(before), count.flops


def _counts(c: dict) -> np.ndarray:
    return np.asarray([[c[a][k] for k in (*tp.OPS, "bytes", "backward",
                                         *(f"{op}_bytes" for op in tp.OPS))]
                       for a in tp.AXES])


def port_case(case: str, rank: int) -> dict:
    cfg = case_cfg(case)
    model = get_model(cfg)
    mesh = AX.current_mesh()
    coord = _coord(case, rank)
    out = {}
    full = case_params(case)
    whole = model.init(torch.Generator(), "meta")
    local = SH.local_params(full, mesh, fsdp=True)
    for path, leaf in store.leaf_paths(local):
        out[f"shard{path}"] = _np(leaf)
    rows = lambda t: SH.local_batch(                          # noqa: E731
        {"t": torch.from_numpy(t)}, mesh)["t"]
    toks = tokens(cfg)
    logits, cache = T.prefill(cfg, local, {"tokens": rows(toks[:, :PROMPT])},
                              PROMPT + 1)
    out["logits/0"] = _f32(logits)
    logits, _ = T.decode_step(cfg, local, cache, rows(toks[:, PROMPT]),
                              PROMPT)
    out["logits/1"] = _f32(logits)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    with torch.no_grad():
        out["loss0"] = np.float32(float(model.loss(
            local, SH.local_batch(batch, mesh))))
    for md in CASES[case][3]:
        params = P.tree_map(torch.clone, local)
        state = adamw_init(params, ocfg(md), whole=whole)
        before = tp.counts()
        with FlopCounterMode(display=False) as fc:
            params, state, met = make_train_step(model, ocfg(md))(
                params, state, batch)
        out[f"{md}/counts"] = _counts(tp.counts_since(before))
        out[f"{md}/flops"] = np.int64(fc.get_total_flops())
        got, flops = _predicted(case, md, coord, whole)
        out[f"{md}/predicted_counts"] = _counts(got)
        out[f"{md}/predicted_flops"] = np.int64(flops)
        out[f"{md}/loss"] = np.float32(met["loss"])
        out[f"{md}/grad_norm"] = np.float32(met["grad_norm"])
        for path, p in store.leaf_paths(params):
            out[f"{md}/step/param{path}"] = _f32(p)
        for k, v in _moments(params, state).items():
            out[f"{md}/step/{k}"] = v
        lay = AW.plan(local, whole, ocfg(md))
        out[f"{md}/owner"] = np.asarray(
            [-1 if leaf.owner is None else leaf.owner for leaf in lay])
        out[f"{md}/data"] = np.asarray(
            [-1 if leaf.data is None else leaf.data for leaf in lay])
        if md in STRADDLES:
            grads = SH.local_params(P.tree_map(
                lambda a: torch.from_numpy(a).to(torch.bfloat16),
                _unflatten(full, case_grads(case))), mesh, fsdp=True)
            params = P.tree_map(torch.clone, local)
            state = adamw_init(params, ocfg(md, clip=False), whole=whole)
            adamw_update(params, grads, state, ocfg(md, clip=False),
                         whole=whole)
            for k, v in _stores(state, md).items():
                out[f"{md}/store/{k}"] = v
    return {f"{case}/{k}": v for k, v in out.items()}


def _unflatten(like: dict, flat: dict) -> dict:
    return store._rebuild(like, iter(flat[path] for path, _ in
                                     store.leaf_paths(like)))


def port_rank(case: str, rank: int, work: str) -> None:
    """Entry of one port rank of a case's mesh, into
    ``work/port_<case>_<rank>.npz``."""
    import torch.distributed as dist
    shape = CASES[case][1]
    world = int(np.prod(shape))
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, f"rendezvous_{case}"), world), rank=rank,
        world_size=world)
    try:
        mesh = make_host_mesh(*shape[-2:], device="cpu",
                              pod=shape[0] if len(shape) == 3 else 1)
        assert {a: mesh.get_local_rank(a) for a in _names(shape)} == \
            _coord(case, rank)
        with threshold(case), AX.use_mesh(mesh):
            out = port_case(case, rank)
    finally:
        destroy_mesh()
    np.savez(os.path.join(work, f"port_{case}_{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# JAX: one process a case
# ---------------------------------------------------------------------------

def jax_case(case: str, work: str) -> None:
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.core import bdi_value as jbv
    from repro.distributed import sharding as JSH
    from repro.distributed.axes import use_mesh
    from repro.models.api import get_model as jax_model
    from repro.optim import adamw as JO
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    shape = CASES[case][1]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(shape),
                             _names(shape))
    where = {d: i for i, d in enumerate(mesh.devices.flat)}
    opts = {"xla_allow_excess_precision": False}
    named = lambda specs: jax.tree.map(                       # noqa: E731
        lambda s: jax.sharding.NamedSharding(mesh, s), specs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))

    def put_rows(x):
        x = jnp.asarray(x)
        return jax.device_put(x, named(JSH.batch_specs(x, mesh)))

    def jcfg_of(md, clip=True):
        return JO.AdamWConfig(moment_dtype=md, grad_clip=(
            JO.AdamWConfig.grad_clip if clip else 0.0))
    out = {}
    with use_mesh(mesh), threshold(case, JSH):
        jcfg = jax_arch("yi-6b").reduced(**CASES[case][0])
        jm = jax_model(jcfg)
        like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        psh = JSH.param_shardings(like, mesh, fsdp=True)
        params = jstore.restore(os.path.join(work, "params", case), like,
                                target_shardings=psh)[0]
        for k, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            for s in leaf.addressable_shards:
                out[f"shard/{where[s.device]}{jax.tree_util.keystr(k)}"] = \
                    _np(s.data)
        toks = tokens(jcfg)
        logits, cache = jax.jit(jm.prefill, static_argnums=2,
                                compiler_options=opts)(
            params, {"tokens": put_rows(toks[:, :PROMPT])}, PROMPT + 1)
        out["logits/0"] = _f32(logits)
        logits, _ = jax.jit(jm.decode_step, compiler_options=opts)(
            params, cache, put_rows(toks[:, PROMPT]), jnp.int32(PROMPT))
        out["logits/1"] = _f32(logits)
        tb = {k: put_rows(v) for k, v in train_batch(jcfg).items()}
        dtypes = CASES[case][3]
        states = {md: JO.adamw_init(params, jcfg_of(md)) for md in dtypes}
        osh = {md: JSH.param_shardings(s, mesh, fsdp=True)
               for md, s in states.items()}
        states = jax.device_put(states, osh)

        def both(params, states, batch):
            loss, grads = jax.value_and_grad(jm.loss)(params, batch)
            return loss, {md: JO.adamw_update(params, grads, st,
                                              jcfg_of(md))
                          for md, st in states.items()}
        loss, upd = jax.jit(both, out_shardings=(None, {
            md: (psh, osh[md], None) for md in dtypes}),
            compiler_options=opts)(params, states, tb)
        out["loss0"] = np.float32(loss)
        for md in dtypes:
            p2, s2, met = upd[md]
            out[f"{md}/grad_norm"] = np.float32(met["grad_norm"])
            trees = {"param": p2, **{k: jax.tree.map(
                lambda p, s, md=md: JO._load(s, md, p.shape), params,
                s2[k]) for k in ("m", "v")}}
            for key, tree in trees.items():
                for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    out[f"{md}/step/{key}{jax.tree_util.keystr(k)}"] = \
                        _f32(leaf)
        grads = jax.device_put(jax.tree.map(
            lambda p, g: jnp.asarray(g, jnp.bfloat16), params,
            jstore.restore(os.path.join(work, "grads", case), jax.tree.map(
                lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32),
                like))[0]), psh)
        for md in set(dtypes) & set(STRADDLES):
            st = jax.device_put(JO.adamw_init(params, jcfg_of(md)), osh[md])
            _, s2, _ = jax.jit(
                lambda p, g, s, md=md: JO.adamw_update(p, g, s,
                                                       jcfg_of(md, False)),
                out_shardings=(psh, osh[md], None),
                compiler_options=opts)(params, grads, st)
            for k in ("m", "v"):
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        s2[k])[0]:
                    key = f"{md}/store/{k}{jax.tree_util.keystr(path)}"
                    out[key] = _np(leaf)
                    for s in leaf.addressable_shards:
                        out[f"{key}/shard/{where[s.device]}"] = _np(s.data)
    np.savez(os.path.join(work, f"jax_{case}.npz"), **out)


# ---------------------------------------------------------------------------
# the fixture: all processes at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{case: (JAX's npz, [each port rank's npz])}."""
    work = tmp_path_factory.mktemp("tp_pod")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
        store.save(str(work / "grads" / case), 0, _unflatten(
            case_params(case), case_grads(case)))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tp_pod as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    procs = []
    for case, (_, shape, _, _) in CASES.items():
        n = int(np.prod(shape))
        procs.append(start(f"jax_case({case!r}, {str(work)!r})", dict(
            env, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                            + f" --xla_force_host_platform_device_count={n}"
                            " --xla_allow_excess_precision=false").strip())))
        procs += [start(f"port_rank({case!r}, {r}, {str(work)!r})", env)
                  for r in range(n)]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * len(procs), rcs
    load = lambda name: dict(np.load(work / name))           # noqa: E731
    return {case: (load(f"jax_{case}.npz"),
                   [load(f"port_{case}_{r}.npz")
                    for r in range(int(np.prod(CASES[case][1])))])
            for case in CASES}


def _paths(case: str) -> list[str]:
    return [p for p, _ in store.leaf_paths(case_params(case))]


def _spec(case: str, path: str, shape: tuple):
    mesh = EL.abstract_mesh(CASES[case][1], _names(CASES[case][1]))
    with threshold(case):
        return SH._spec_for(path, shape, mesh, 2, True)


def _block(case: str, whole: np.ndarray, path: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole params-shaped array."""
    shape = CASES[case][1]
    return SH.local_shards(
        {"x": torch.from_numpy(whole)}, {"x": _spec(case, path, whole.shape)},
        EL.abstract_mesh(shape, _names(shape)),
        coord=_coord(case, rank))["x"].numpy()


def _region(case: str, path: str, shape: tuple, rank: int, owner: int,
            data: int) -> list[slice]:
    """The slices of a whole params-shaped leaf whose moments rank
    ``rank`` keeps (``optim/adamw.plan``): the rank's block but along the
    data dim, whole there, and cut along the owner dim instead."""
    cuts = SH._cuts(path, shape, _spec(case, path, shape),
                    dict(zip(_names(CASES[case][1]), CASES[case][1])),
                    _coord(case, rank))
    if owner != data:
        if data >= 0:
            cuts[data] = slice(0, shape[data])
        if owner >= 0:
            d = int(np.prod(CASES[case][1][:-1]))
            n = shape[owner] // d
            coord, sizes = _coord(case, rank), CASES[case][1]
            r = coord["data"] + (coord["pod"] * sizes[1]
                                 if "pod" in coord else 0)
            cuts[owner] = slice(r * n, (r + 1) * n)
    return cuts


def _store_cut(leaf: np.ndarray, cuts: list[slice], key: str) -> np.ndarray:
    """The part of a whole moment store leaf (tile-last layout) over the
    params region ``cuts``: the leaf's dims but the last as the param's,
    the param's last dim as tiles (and, for ``deltas``/``maskp``, the
    tile's own last dim whole)."""
    last = cuts[-1]
    idx = list(cuts[:-1])
    if key.endswith(("['deltas']", "['maskp']", "['scale']", "['base']")):
        idx.append(slice(last.start // 128, last.stop // 128))
    else:                            # an f32 leaf of the param's shape
        idx.append(last)
    return leaf[tuple(idx)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_placement_equals_jax_addressable_shards(records, case):
    jax_rec, ports = records[case]
    cut = 0
    for r, port in enumerate(ports):
        for path, leaf in store.leaf_paths(case_params(case)):
            got = port[f"{case}/shard{path}"]
            want = jax_rec[f"shard/{r}{path}"]
            assert got.shape == want.shape, (path, r, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {r}")
            cut += got.size < leaf.numel()
    assert cut >= 5 * len(ports)         # FSDP (and model) blocks


def test_pod_logits_and_loss_match_jax(records):
    jax_rec, ports = records["pod"]
    for r, port in enumerate(ports):
        for i in range(2):
            got = port[f"pod/logits/{i}"]
            assert got.shape == jax_rec[f"logits/{i}"].shape
            assert_model_ulps(got, jax_rec[f"logits/{i}"])
        np.testing.assert_allclose(port["pod/loss0"], jax_rec["loss0"],
                                   rtol=LOSS_RTOL)


STEP_CASES = [(c, md) for c in CASES for md in CASES[c][3]]


@pytest.mark.parametrize("case,md", STEP_CASES)
def test_one_step_matches_jax(records, case, md):
    jax_rec, ports = records[case]
    paths = _paths(case)
    for r, port in enumerate(ports):
        np.testing.assert_allclose(port[f"{case}/{md}/loss"],
                                   jax_rec["loss0"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(port[f"{case}/{md}/grad_norm"],
                                   jax_rec[f"{md}/grad_norm"],
                                   rtol=GNORM_RTOL)
        for i, path in enumerate(paths):
            a = port[f"{case}/{md}/step/param{path}"]
            b = _block(case, jax_rec[f"{md}/step/param{path}"], path, r)
            assert a.shape == b.shape, (path, a.shape, b.shape)
            gap = np.abs(a - b) - _ulp(np.maximum(np.abs(a), np.abs(b)))
            assert float((gap <= 0).mean()) >= STEP_ULP_SHARE, (md, path, r)
            for k in ("m", "v"):
                a = port[f"{case}/{md}/step/{k}{path}"]
                whole = jax_rec[f"{md}/step/{k}{path}"]
                b = whole[tuple(_region(
                    case, path, whole.shape, r,
                    int(port[f"{case}/{md}/owner"][i]),
                    int(port[f"{case}/{md}/data"][i])))]
                assert a.shape == b.shape, (k, path, a.shape, b.shape)
                err = float(np.linalg.norm(a - b)
                            / max(np.linalg.norm(b), 1e-30))
                assert err <= STEP_MOMENT_RTOL, (md, k, path, r, err)


@pytest.mark.parametrize("md", STRADDLES)
def test_straddling_moment_stores_equal_jax(records, md):
    jax_rec, ports = records["straddle"]
    paths = _paths("straddle")
    whole = case_params("straddle")
    moved = 0
    for r, port in enumerate(ports):
        owner, data = port[f"straddle/{md}/owner"], port[f"straddle/{md}/data"]
        for i, path in enumerate(paths):
            shape = tuple(store.leaf_paths(whole)[i][1].shape)
            cuts = _region("straddle", path, shape, r, int(owner[i]),
                           int(data[i]))
            moved += owner[i] != data[i]
            for k in ("m", "v"):
                prefix = f"{md}/store/{k}{path}"
                keys = [key for key in jax_rec if key.startswith(prefix)
                        and "/shard/" not in key]
                assert keys, prefix
                for key in keys:
                    got = port[f"straddle/{key}"]
                    want = _store_cut(jax_rec[key], cuts, key)
                    assert got.shape == want.shape, (key, got.shape,
                                                     want.shape)
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{key} {r}")
        # wo's deltas: the rule table's own block of the store
        key = f"{md}/store/m{WO}['deltas']"
        np.testing.assert_array_equal(port[f"straddle/{key}"],
                                      jax_rec[f"{key}/shard/{r}"])
    assert moved >= 3 * len(ports)      # wo, down and the embedding
    emb = paths.index("['embed']['w']")
    assert int(ports[0][f"straddle/{md}/owner"][emb]) == -1


@pytest.mark.parametrize("case,md", STEP_CASES)
def test_rank_counts_and_flops_equal_its_trace(records, case, md):
    _, ports = records[case]
    for r, port in enumerate(ports):
        got = port[f"{case}/{md}/counts"]
        np.testing.assert_array_equal(got,
                                      port[f"{case}/{md}/predicted_counts"])
        assert int(port[f"{case}/{md}/flops"]) == \
            int(port[f"{case}/{md}/predicted_flops"])
        data = dict(zip(tp.AXES, got))["data"]
        assert data[0] > 0                     # the data axes' sums
        if md in STRADDLES:
            assert data[2] > 0                 # the straddling all-to-alls
