"""The model and data axes for the recurrent and encoder-decoder families:
the port vs JAX's GSPMD program on the CPU.

JAX's rule table lays Mamba's channels, mLSTM's and sLSTM's projections
and cross-attention out over ``model`` (``distributed/sharding.py``), and
``cache_specs`` splits their decode states: Mamba's over the state dim n
(its conv tail over the channels), mLSTM's C and n over their key dim,
sLSTM's over d, hymba's attention caches over T and over the window (its
heads do not divide the axis), seamless's cross cache over its KV heads.
The port lays out the same (``models/ssm.py``, ``hybrid.py``,
``xlstm.py``, ``encdec.py`` over ``distributed/tp.py``).  JAX places
params with ``param_shardings`` and pins every cache to ``cache_specs``
with ``out_shardings``, as its dry run does.

One module fixture starts, all at once, four port ranks (gloo over a
``FileStore`` in the test's temporary directory, each writing ``.npz``),
which run the ``(1, 4)`` cases on one mesh and then the ``(2, 2)`` case
on another, and a JAX process a case with ``XLA_FLAGS=--xla_force_host_
platform_device_count=4 --xla_allow_excess_precision=false``.  Rank 0
also runs every case without a mesh, the port's own m = 1 reference.
Cases, each chosen to hit one trouble spot:

* ``hymba``: reduced hymba-1.5b with 5 heads and 1 KV head (Q, K, V and
  wo whole on every rank), vocab 257 (whole), window 8 under prompts of
  12 (the rings wrap; each rank holds 2 of the 8 slots), 3 layers with
  one full-attention layer (its cache over T), the Mamba state over n;
* ``xlstm``: reduced xlstm-350m with 2 heads, so that a head spans two
  ranks (as 4 heads do over 16), an mLSTM and an sLSTM layer;
* ``seamless``: reduced seamless-m4t-large-v2 (4 heads and 4 KV heads,
  MHA as the config) with vocab 258, which divides 2, not 4 (whole),
  encoder frames from a seeded stub;
* ``xlstm-2x2``: reduced xlstm-350m at d_model 128 on ``(2, 2)``, each
  side's ``FSDP_THRESHOLD_BYTES`` lowered to 64 KiB (test-only) so that
  FSDP engages (wq, wk, wv, wx and sLSTM's r, whose 2 tiles of 128 split
  over the data axis; at d_model 64 its one tile would straddle two data
  blocks, which stays refused): the heads divide m, ``wx``'s gate-major
  block does not.

The params are the port's init from seed 0, restored by the JAX store;
JAX's ``_pow2_scale`` is swapped for the exact construction of 2^e
(``tests/test_torch_decode.exact_pow2_scale``, test-only).

Tolerances (``tests/test_torch_tp_moe.py``'s): bit for bit, the
``local_shards`` of the params and of JAX's caches against JAX's
addressable shards, every moment store's bytes after one AdamW update
from one given state and gradient, the norms across the ranks; logits
and the cache blocks within 2 bf16 ULPs of the array's largest |value|,
against JAX's and the port's m = 1 run; greedy tokens equal up to
one-ULP ties; training: the first loss rtol 1e-4, the norm 1e-3,
gradients within 1e-2 relative Frobenius error, after the first step at
least 98% of each param leaf within one bf16 ULP of JAX's and the
moments within 2e-2, 3 losses within 1e-2 of the m = 1 run; for the
leaves of the time-scanned cells (Mamba's, sLSTM's), whose m = 1 run
differs from JAX's by up to 2e-2 already, the mesh adds at most those
tolerances to the m = 1 run's distance from JAX (``SCANNED``).
"""

import dataclasses
import functools
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
from repro_torch.launch import elastic as EL
from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
from repro_torch.launch.serve import dense_generate
from repro_torch.launch.train import make_train_step
from repro_torch.models import params as P
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as S
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as AW
from repro_torch.serving.parity import GreedyParity
from test_torch_decode import _ulp, assert_model_ulps, exact_pow2_scale
from test_torch_tp_replicated import _as_f32, _f32, _is_norm, _moments, _np

REPO = Path(__file__).resolve().parents[1]
REAL = SH.FSDP_THRESHOLD_BYTES
XLSTM = {"n_heads": 2, "slstm_every": 2}
# case -> (arch, reduced() overrides, mesh (data, model), FSDP threshold)
CASES = {"hymba": ("hymba-1.5b", {"n_layers": 3, "n_heads": 5,
                                  "n_kv_heads": 1, "head_dim": 16,
                                  "vocab": 257, "window": 8,
                                  "n_full_attn": 1}, (1, 4), REAL),
         "xlstm": ("xlstm-350m", XLSTM, (1, 4), REAL),
         "seamless": ("seamless-m4t-large-v2", {"vocab": 258,
                                                "n_kv_heads": 4},
                      (1, 4), REAL),
         "xlstm-2x2": ("xlstm-350m", {**XLSTM, "d_model": 128}, (2, 2),
                       64 << 10)}
MESHES = ((1, 4), (2, 2))
WORLD = 4
BATCH, PROMPT, STEPS, GEN, ENC = 4, 12, 4, 8, 8
CACHE = PROMPT + GEN
SHAPE = ShapeConfig("t", 16, 4, "train")
TRAIN_STEPS = 3
DTYPES = ("f32", "bdi8")
TILED = ("bdi8", "q8")
MODEL_ULPS = 2
LOSS_RTOL, GNORM_RTOL, GRAD_RTOL = 1e-4, 1e-3, 1e-2
TRAJ_RTOL = 1e-2
ULP_SHARE, MOMENT_RTOL = 0.98, 2e-2
# The time scans' f32 exp and log1p (Mamba's, sLSTM's gates) differ from
# XLA's by ULPs, so the port's gradients of those cells' leaves differ from
# JAX's already without a mesh (9.6e-3 for Mamba's conv and sLSTM's bias
# here, 2e-2 on one rank's block; tests/test_torch_families.py holds them
# to 2e-2), and 2.9% of Mamba's dt bias lands more than one ULP off after
# one step.  The mesh is held to adding at most the tolerances above to
# the port's own m = 1 distance from JAX on the same block.
SCANNED = ("['blocks']['mamba']", "['blocks']['slstm']")


def _share(a: np.ndarray, b: np.ndarray) -> float:
    """The share of ``a``'s elements within one bf16 ULP of ``b``'s."""
    gap = np.abs(a - b) - _ulp(np.maximum(np.abs(a), np.abs(b)))
    return float((gap <= 0).mean())


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def case_cfg(case: str):
    arch, kw, _, _ = CASES[case]
    return get_arch(arch).reduced(**kw)


def cases_of(shape: tuple) -> list[str]:
    return [c for c, v in CASES.items() if v[2] == shape]


class threshold:
    """``FSDP_THRESHOLD_BYTES`` of ``module`` (the port's rule table, or
    JAX's) set to a case's for a while (test-only)."""

    def __init__(self, case: str, module=SH):
        self.module, self.value = module, CASES[case][3]

    def __enter__(self):
        self.prev = self.module.FSDP_THRESHOLD_BYTES
        self.module.FSDP_THRESHOLD_BYTES = self.value

    def __exit__(self, *exc):
        self.module.FSDP_THRESHOLD_BYTES = self.prev


def case_params(case: str) -> dict:
    return get_model(case_cfg(case)).init(torch.Generator().manual_seed(0),
                                          "cpu")


def case_tokens(cfg) -> np.ndarray:
    rng = np.random.default_rng(3)
    return rng.integers(1, cfg.vocab, (BATCH, PROMPT + STEPS)).astype(
        np.int32)


def case_frames(cfg) -> np.ndarray | None:
    """The encoder's frames [B, ENC, D] of a seeded stub (encdec only)."""
    if not cfg.is_encdec:
        return None
    rng = np.random.default_rng(4)
    return (rng.standard_normal((BATCH, ENC, cfg.d_model)) * 0.02).astype(
        np.float32)


def train_batches(cfg) -> list[dict]:
    return [TP.make_train_batch(cfg, SHAPE, TP.DataConfig(seed=2), step=i)
            for i in range(TRAIN_STEPS)]


def update_grads(case: str) -> dict:
    """A gradient for the one-update bit test: bf16 values of N(0, 1e-2)
    from seed 5, the whole params' shapes (numpy f32)."""
    rng = np.random.default_rng(5)
    return {path: torch.from_numpy((rng.standard_normal(tuple(t.shape))
                                    * 1e-2).astype(np.float32)).to(
                                        torch.bfloat16).float().numpy()
            for path, t in store.leaf_paths(case_params(case))}


def _rows(t: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(t)
    mesh = AX.current_mesh()
    return t if mesh is None else SH.local_batch({"t": t}, mesh)["t"]


# ---------------------------------------------------------------------------
# the port: one rank (or no mesh)
# ---------------------------------------------------------------------------

def port_serve(case: str, params: dict) -> dict:
    cfg = case_cfg(case)
    model = get_model(cfg)
    out = {}
    toks, frames = case_tokens(cfg), case_frames(cfg)
    batch = {"tokens": _rows(toks[:, :PROMPT])}
    if frames is not None:
        batch["enc_embeds"] = _rows(frames)
    c0 = tp.counts()
    logits, cache = model.prefill(params, batch, CACHE)
    out["logits/0"] = _f32(logits)
    c1 = tp.counts()
    for i in range(STEPS):
        logits, cache = model.decode_step(
            params, cache, _rows(toks[:, PROMPT + i]), PROMPT + i)
        out[f"logits/{i + 1}"] = _f32(logits)
    c2 = tp.counts()
    out["serve/collectives"] = np.asarray(
        [[c1[a][k] - c0[a][k], (c2[a][k] - c1[a][k]) / STEPS]
         for a in tp.AXES for k in ("all_reduce", "all_gather", "bytes")])
    for path, leaf in store.leaf_paths(cache):
        out[f"cache{path}"] = _np(leaf)
    g = dense_generate(cfg, params, torch.from_numpy(toks[:, :PROMPT]), GEN,
                       keep_logits=True, enc_embeds=None if frames is None
                       else torch.from_numpy(frames))
    out["greedy/tokens"] = np.asarray(g["tokens"])
    out["greedy/logits"] = g["logits"].numpy()
    return out


def port_train(case: str, md: str, params: dict, whole: dict | None
               ) -> dict:
    """The loss and gradients of the first batch, then ``TRAIN_STEPS``
    steps of ``make_train_step`` from the zero state."""
    cfg = case_cfg(case)
    model = get_model(cfg)
    ocfg = AdamWConfig(moment_dtype=md)
    params = P.tree_map(torch.clone, params)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in train_batches(cfg)]
    out = {}
    state = adamw_init(params, ocfg, whole=whole)
    out["wide"] = np.asarray(tp.check_moments(params, md))
    if md == "f32":
        flat = [t.requires_grad_() for t in P.leaves(params)]
        b = batches[0] if tp.data_size() == 1 else SH.local_batch(
            batches[0], AX.current_mesh())
        loss = model.loss(params, b)
        with ThreadPoolExecutor(1) as pool:    # a thread with no mesh
            grads = pool.submit(torch.autograd.grad, loss, flat,
                                allow_unused=True,
                                materialize_grads=True).result()
        for t in flat:
            t.requires_grad_(False)
        out["loss0"] = np.float32(float(loss.detach()))
        for (path, _), g in zip(store.leaf_paths(params), grads):
            out[f"grad{path}"] = _f32(g)
    step = make_train_step(model, ocfg)
    for i, batch in enumerate(batches):
        params, state, met = step(params, state, batch)
        out[f"loss/{i}"] = np.float32(met["loss"])
        out[f"grad_norm/{i}"] = np.float32(met["grad_norm"])
        out[f"collectives/{i}"] = np.asarray(
            [met["collectives"][a][k] for a in tp.AXES
             for k in ("all_reduce", "all_gather", "backward", "bytes")])
        for path, p in store.leaf_paths(params):
            if _is_norm(path):
                out[f"norm/{i}{path}"] = _np(p)
        for k, v in _moments(params, state).items():
            if _is_norm(k):
                out[f"norm/{i}/{k}"] = v
        if i == 0:
            for path, p in store.leaf_paths(params):
                out[f"step/param{path}"] = _f32(p)
            out.update({f"step/{k}": v
                        for k, v in _moments(params, state).items()})
    return out


def port_update(case: str, md: str, params: dict, whole: dict | None,
                mesh) -> dict:
    """One AdamW update with :func:`update_grads` (this rank's blocks)
    from the zero state, clipping off: the moment stores' bytes in JAX's
    layout."""
    ocfg = AdamWConfig(moment_dtype=md, grad_clip=0.0)
    params = P.tree_map(torch.clone, params)
    ug = update_grads(case)
    grads = store._rebuild(params, iter(
        torch.from_numpy(ug[path]).to(p.dtype)
        for path, p in store.leaf_paths(case_params(case))))
    grads = SH.local_shards(grads, SH.param_specs(
        grads, mesh, fsdp=CASES[case][3] != REAL), mesh)
    state = adamw_init(params, ocfg, whole=whole)
    params, state, _ = adamw_update(params, grads, state, ocfg, whole=whole)
    ex = AW.export_state(state)
    return {f"update/{k}{path}": _np(t) for k in ("m", "v")
            for path, t in store.leaf_paths(ex[k])}


def port_mamba(case: str, params: dict) -> dict:
    """Layer 0's Mamba (``ssm.mamba_forward`` on the layer's view of this
    rank's params, ``hybrid.placed``) on one input: this rank's u and z
    from ``in_proj`` (``ssm._mamba_in``), the output, and the gradient of
    the input from one cotangent."""
    cfg = case_cfg(case)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(
        (BATCH, PROMPT, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    gy = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32)).to(torch.bfloat16)
    layer = HY.placed(cfg, params)[1][0]["mamba"]
    with torch.no_grad():
        u, z = S._mamba_in(layer, x)
    x.requires_grad_()
    y = S.mamba_forward(layer, x, cfg.ssm_state)
    (gx,) = torch.autograd.grad(y, [x], gy)
    return {"mamba/u": _f32(u), "mamba/z": _f32(z), "mamba/y": _f32(y),
            "mamba/gx": _f32(gx)}


def port_case(case: str, mesh) -> dict:
    cfg = case_cfg(case)
    full = case_params(case)
    fsdp = CASES[case][3] != REAL
    out = {}
    with threshold(case):
        if mesh is None:
            local, whole = full, None
        else:
            local = SH.local_params(full, mesh, fsdp=fsdp)
            whole = get_model(cfg).init(torch.Generator(), "meta")
            for path, leaf in store.leaf_paths(local):
                out[f"shard{path}"] = _np(leaf)
        if cfg.family == "hybrid":
            out.update(port_mamba(case, local))
        out.update(port_serve(case, local))
        for md in DTYPES:
            out.update({f"{md}/{k}": v for k, v in
                        port_train(case, md, local, whole).items()})
        if mesh is not None:
            for md in TILED:
                out.update({f"{md}/{k}": v for k, v in port_update(
                    case, md, local, whole, mesh).items()})
    return {f"{case}/{k}": v for k, v in out.items()}


def port_rank(rank: int, work: str) -> None:
    """Entry of one port rank: the ``(1, 4)`` cases, then the ``(2, 2)``
    case on a second mesh of the same group, into ``work/port_<rank>.npz``;
    rank 0 then runs every case without a mesh (``one/`` keys)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "rendezvous"), WORLD), rank=rank,
        world_size=WORLD)
    out = {}
    try:
        for shape in MESHES:
            mesh = make_host_mesh(*shape, device="cpu")
            with AX.use_mesh(mesh):
                for case in cases_of(shape):
                    out.update(port_case(case, mesh))
    finally:
        destroy_mesh()
    if rank == 0:
        for case in CASES:
            out.update({f"one/{k}": v
                        for k, v in port_case(case, None).items()})
    np.savez(os.path.join(work, f"port_{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# JAX: one process a case, four host devices
# ---------------------------------------------------------------------------

def jax_case(case: str, work: str, out: dict) -> None:
    """One case on its mesh under GSPMD: params (and states) placed by
    ``param_shardings``, batches by ``batch_specs``, every cache pinned
    to ``cache_specs`` as the dry run pins it."""
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.distributed import sharding as JSH
    from repro.distributed.axes import use_mesh
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models.api import get_model as jax_model
    from repro.optim import adamw as JO
    arch, kw, shape, _ = CASES[case]
    fsdp = CASES[case][3] != REAL
    mesh = jmesh(*shape)
    where = {d: i for i, d in enumerate(mesh.devices.flat)}
    opts = {"xla_allow_excess_precision": False}
    named = lambda specs: jax.tree.map(                       # noqa: E731
        lambda s: jax.sharding.NamedSharding(mesh, s), specs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))

    def put_rows(x):
        x = jnp.asarray(x)
        return jax.device_put(x, named(JSH.batch_specs(x, mesh)))

    def shards(prefix: str, tree) -> None:
        for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            for s in leaf.addressable_shards:
                out[f"{case}/{prefix}/{where[s.device]}"
                    f"{jax.tree_util.keystr(k)}"] = _np(s.data)

    with use_mesh(mesh), threshold(case, JSH):
        jcfg = jax_arch(arch).reduced(**kw)
        jm = jax_model(jcfg)
        like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        psh = JSH.param_shardings(like, mesh, fsdp=fsdp)
        params = jstore.restore(os.path.join(work, "params", case), like,
                                target_shardings=psh)[0]
        shards("shard", params)
        toks, frames = case_tokens(jcfg), case_frames(jcfg)
        batch = {"tokens": put_rows(toks[:, :PROMPT])}
        if frames is not None:
            batch["enc_embeds"] = put_rows(frames)
        cache_like = jax.eval_shape(lambda p, b: jm.prefill(p, b, CACHE),
                                    params, batch)[1]
        csh = named(JSH.cache_specs(cache_like, mesh))
        prefill = jax.jit(jm.prefill, static_argnums=2,
                          out_shardings=(None, csh), compiler_options=opts)
        step = jax.jit(jm.decode_step, out_shardings=(None, csh),
                       compiler_options=opts)
        logits, cache = prefill(params, batch, CACHE)
        out[f"{case}/logits/0"] = _f32(logits)
        for i in range(STEPS):
            logits, cache = step(params, cache, put_rows(toks[:, PROMPT + i]),
                                 jnp.int32(PROMPT + i))
            out[f"{case}/logits/{i + 1}"] = _f32(logits)
        for path, leaf in store.leaf_paths(cache):
            out[f"{case}/cache{path}"] = _np(leaf)
        shards("cache_shard", cache)
        # greedy, as dense_generate: the prompt only, CACHE rows
        logits, cache = prefill(params, batch, CACHE)
        tok = jnp.argmax(logits, -1)
        got, rows = [tok], [_f32(logits)]
        for t in range(PROMPT, PROMPT + GEN - 1):
            logits, cache = step(params, cache, put_rows(tok), jnp.int32(t))
            tok = jnp.argmax(logits, -1)
            got.append(tok)
            rows.append(_f32(logits))
        out[f"{case}/greedy/tokens"] = np.stack([np.asarray(t) for t in got],
                                                1)
        out[f"{case}/greedy/logits"] = np.stack(rows)
        # the loss, its gradients and one update under each moment dtype
        # from the zero state, the moments loaded, in one program
        tb = {k: put_rows(v) for k, v in train_batches(jcfg)[0].items()}

        def both(params, batch):
            loss, grads = jax.value_and_grad(jm.loss)(params, batch)
            upd = {}
            for md in DTYPES:
                ocfg = JO.AdamWConfig(moment_dtype=md)
                p2, s2, met = JO.adamw_update(params, grads,
                                              JO.adamw_init(params, ocfg),
                                              ocfg)
                upd[md] = {"param": p2, "grad_norm": met["grad_norm"],
                           **{k: jax.tree.map(lambda p, s, md=md: JO._load(
                               s, md, p.shape), params, s2[k])
                              for k in ("m", "v")}}
            return loss, grads, upd
        loss, grads, upd = jax.jit(
            both, out_shardings=(None, psh, None),
            compiler_options=opts)(params, tb)
        out[f"{case}/loss0"] = np.float32(loss)
        for k, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"{case}/grad{jax.tree_util.keystr(k)}"] = _f32(g)
        for md in DTYPES:
            out[f"{case}/{md}/grad_norm"] = np.float32(
                upd[md].pop("grad_norm"))
            for key, tree in upd[md].items():
                for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    out[f"{case}/{md}/step/{key}"
                        f"{jax.tree_util.keystr(k)}"] = _f32(leaf)
        # one update from the zero state with one given gradient under each
        # tiled dtype, the states placed by the rule table
        ug = update_grads(case)
        flat, tdef = jax.tree_util.tree_flatten_with_path(params)
        g = jax.device_put(jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(ug[jax.tree_util.keystr(k)], leaf.dtype)
            for k, leaf in flat]), psh)
        ocfgs = {md: JO.AdamWConfig(moment_dtype=md, grad_clip=0.0)
                 for md in TILED}
        ssh = {md: JSH.param_shardings(jax.eval_shape(
            lambda p, o=o: JO.adamw_init(p, o), params), mesh, fsdp=fsdp)
            for md, o in ocfgs.items()}
        sts = jax.jit(lambda p, g: {md: JO.adamw_update(
            p, g, JO.adamw_init(p, o), o)[1] for md, o in ocfgs.items()},
            out_shardings=ssh, compiler_options=opts)(params, g)
        for md, st in sts.items():
            for k in ("m", "v"):
                for path, leaf in store.leaf_paths(st[k]):
                    out[f"{case}/{md}/update/{k}{path}"] = _np(leaf)


def jax_one(case: str, work: str) -> None:
    """Entry of a JAX process: one case (the compiles are most of the
    file's time), into ``work/jax_<case>.npz``."""
    from repro.core import bdi_value as jbv
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    assert len(jax.devices()) == WORLD
    out = {}
    jax_case(case, work, out)
    np.savez(os.path.join(work, f"jax_{case}.npz"), **out)


# ---------------------------------------------------------------------------
# the fixture: all processes at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax": npz, "port": [npz of each rank]}."""
    work = tmp_path_factory.mktemp("tp_families")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tp_families as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    jenv = dict(env, XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={WORLD}"
        + " --xla_allow_excess_precision=false").strip())
    procs = [start(f"jax_one({case!r}, {str(work)!r})", jenv)
             for case in CASES]
    procs += [start(f"port_rank({r}, {str(work)!r})", env)
              for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * len(procs), rcs
    jax_rec = {}
    for case in CASES:
        jax_rec.update(np.load(work / f"jax_{case}.npz"))
    return {"jax": jax_rec,
            "port": [dict(np.load(work / f"port_{r}.npz"))
                     for r in range(WORLD)]}


def _mesh(case: str):
    return EL.abstract_mesh(CASES[case][2], ("data", "model"))


def _coord(case: str, rank: int) -> dict:
    m = CASES[case][2][1]
    return {"data": rank // m, "model": rank % m}


def _paths(case: str) -> list[str]:
    return [p for p, _ in store.leaf_paths(case_params(case))]


@functools.lru_cache(maxsize=None)
def _itemsizes(case: str) -> dict:
    return {path: t.element_size() for path, t in store.leaf_paths(
        get_model(case_cfg(case)).init(torch.Generator(), "meta"))}


def _spec(case: str, path: str, shape: tuple):
    with threshold(case):
        return SH._spec_for(path, shape, _mesh(case),
                            _itemsizes(case)[path], CASES[case][3] != REAL)


def _cut(case: str, whole: np.ndarray, spec, rank: int) -> np.ndarray:
    return SH.local_shards({"x": torch.from_numpy(whole)}, {"x": spec},
                           _mesh(case), coord=_coord(case, rank))["x"].numpy()


def _block(case: str, whole: np.ndarray, path: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole params-shaped array."""
    return _cut(case, whole, _spec(case, path, whole.shape), rank)


_LAYOUTS: dict = {}


def _layout(case: str, md: str) -> dict:
    """By param path, on the abstract mesh from shapes alone: (the
    param's spec, whether its moment tiles straddle the model shards,
    the ZeRO-1 owner dim where the param is whole over data, or -1)."""
    if (case, md) in _LAYOUTS:
        return _LAYOUTS[case, md]
    cfg = case_cfg(case)
    mesh = _mesh(case)
    ocfg = AdamWConfig(moment_dtype=md)
    with threshold(case), AX.use_mesh(mesh):
        whole = get_model(cfg).init(torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord=_coord(case, 0),
                                fsdp=CASES[case][3] != REAL)
        wide = tp.check_moments(local, md)
        lay = AW.plan(local, whole, ocfg) or [None] * len(wide)
    out = {path: (_spec(case, path, tuple(t.shape)), w,
                  -1 if x is None or x.owner is None or x.data is not None
                  else x.owner)
           for (path, t), w, x in zip(store.leaf_paths(whole), wide, lay)}
    _LAYOUTS[case, md] = out
    return out


def _moment_block(case: str, md: str, whole: np.ndarray, path: str,
                  rank: int, part: str = "") -> np.ndarray:
    """What rank ``rank`` keeps of a whole moment leaf (loaded, params-
    shaped; or a store's ``part``): its param block, whole over model
    where the tiles straddle, narrowed to its 1/d along a ZeRO-1 owner
    dim where the param is whole over data."""
    spec, wide, owner = _layout(case, md)[path]
    spec = list(spec)
    if wide:
        spec[-1] = None
    if part in ("deltas", "maskp"):
        spec.append(None)
    x = _cut(case, whole, SH.P(*spec), rank)
    if owner >= 0:
        d = CASES[case][2][0]
        n = x.shape[owner] // d
        r = _coord(case, rank)["data"]
        x = np.take(x, range(r * n, (r + 1) * n), axis=owner)
    return x


def _cache_like(case: str):
    cfg = case_cfg(case)
    kw = {"enc_len": ENC} if cfg.is_encdec else {}
    return get_model(cfg).init_cache(BATCH, CACHE, device="meta", **kw)


def _jax_cache(records, case: str):
    """JAX's whole cache as port tensors, and each rank's block of it."""
    like = _cache_like(case)
    glob = store._rebuild(like, iter(
        torch.from_numpy(records["jax"][f"{case}/cache{p}"])
        for p, _ in store.leaf_paths(like)))
    return like, glob, [SH.local_shards(
        glob, SH.cache_specs(glob, _mesh(case)), _mesh(case),
        coord=_coord(case, r)) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_local_shards_equal_jax_addressable_shards(records, case):
    """Params and JAX's decode cache: the port's ``local_shards`` of the
    whole equals each device's shard, and each rank's cache has the
    block's shape (``init_cache`` under the mesh)."""
    jax_rec, ports = records["jax"], records["port"]
    _, _, cuts = _jax_cache(records, case)
    for r, port in enumerate(ports):
        for path in _paths(case):
            got, want = port[f"{case}/shard{path}"], \
                jax_rec[f"{case}/shard/{r}{path}"]
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (path, r)
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {r}")
        for path, leaf in store.leaf_paths(cuts[r]):
            want = jax_rec[f"{case}/cache_shard/{r}{path}"]
            np.testing.assert_array_equal(_np(leaf), want,
                                          err_msg=f"{path} {r}")
            assert port[f"{case}/cache{path}"].shape == want.shape, path


def test_cache_specs_cut_where_the_port_computes(records):
    """The splits that each family's decode path reads: hymba's full cache
    over T and its rings over the window (its KV head does not divide 4),
    the Mamba state over n and the conv tail over the channels; xLSTM's
    C and n over their key dim, its m whole (2 heads over 4) or over the
    heads (2 over 2), sLSTM's states over d; seamless's self and cross
    caches over their KV heads."""
    want = {"hymba": {"full_k": 2, "ring_k": 2, "ssm_h": 3, "conv": 3},
            "xlstm": {"mC": 3, "mn": 3, "mm": None, "sh": 2},
            "xlstm-2x2": {"mC": 3, "mn": 3, "mm": 2, "sh": 2},
            "seamless": {"self_k": 3, "cross_k": 3}}
    for case, leaves in want.items():
        like = _cache_like(case)
        spec = SH.cache_specs(like, _mesh(case))
        for f, dim in leaves.items():
            got = [i for i, a in enumerate(getattr(spec, f)) if a == "model"]
            assert got == ([] if dim is None else [dim]), (case, f, got)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_match_jax(records, case):
    """Each rank's cache (its block of every leaf) within 2 ULPs of JAX's
    block (bf16 ULPs of the leaf's largest |value|: the f32 recurrent
    states too)."""
    like, _, cuts = _jax_cache(records, case)
    for r, port in enumerate(records["port"]):
        for (path, want), (_, leaf) in zip(store.leaf_paths(cuts[r]),
                                           store.leaf_paths(like)):
            got = port[f"{case}/cache{path}"]
            want = _np(want)
            assert got.shape == want.shape, (path, r)
            g, w = _as_f32(got, leaf.dtype), _as_f32(want, leaf.dtype)
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=path)
            if fin.any():
                assert_model_ulps(np.where(fin, g, 0), np.where(fin, w, 0),
                                  MODEL_ULPS)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_logits_match_jax(records, case):
    jax_rec, ports = records["jax"], records["port"]
    for port in ports:
        for i in range(STEPS + 1):
            k = f"{case}/logits/{i}"
            assert_model_ulps(port[k], jax_rec[k], MODEL_ULPS)
            np.testing.assert_array_equal(port[k], ports[0][k])


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_one_rank(records, case):
    """The port's sharded logits against its own run without a mesh."""
    one = records["port"][0]
    for port in records["port"]:
        for k in port:
            if k.startswith(f"{case}/") and "logits" in k:
                assert_model_ulps(port[k], one[f"one/{k}"], MODEL_ULPS)
        np.testing.assert_array_equal(port[f"{case}/greedy/tokens"],
                                      one[f"one/{case}/greedy/tokens"])


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_jax(records, case):
    """``dense_generate``'s tokens as JAX's loop's up to one-ULP ties."""
    jax_rec, ports = records["jax"], records["port"]
    want = jax_rec[f"{case}/greedy/tokens"]
    for port in ports:
        got = port[f"{case}/greedy/tokens"]
        assert got.shape == want.shape == (BATCH, GEN)
        rows = torch.from_numpy(port[f"{case}/greedy/logits"])
        ref = torch.from_numpy(jax_rec[f"{case}/greedy/logits"])
        par = GreedyParity()
        for j in range(GEN):
            par.check(j, {b: int(want[b, j]) for b in range(BATCH)},
                      {b: int(got[b, j]) for b in range(BATCH)},
                      lambda sid, j=j: rows[j, sid],
                      lambda sid, j=j: ref[j, sid])
        assert par.compared >= 0.75 * want.size, par


@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax_and_one_rank(records, case, md):
    jax_rec, ports = records["jax"], records["port"]
    one, pre = ports[0], f"one/{case}/{md}/"
    for r, port in enumerate(ports):
        got = f"{case}/{md}/"
        np.testing.assert_allclose(port[f"{got}loss/0"],
                                   jax_rec[f"{case}/loss0"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(port[f"{got}grad_norm/0"],
                                   jax_rec[f"{case}/{md}/grad_norm"],
                                   rtol=GNORM_RTOL)
        for i in range(TRAIN_STEPS):
            np.testing.assert_allclose(port[f"{got}loss/{i}"],
                                       one[f"{pre}loss/{i}"], rtol=TRAJ_RTOL)
            for k in ("loss", "grad_norm"):
                assert port[f"{got}{k}/{i}"] == ports[0][f"{got}{k}/{i}"]
        for path in _paths(case):
            scanned = path.startswith(SCANNED)
            a = port[f"{got}step/param{path}"]
            b = _block(case, jax_rec[f"{case}/{md}/step/param{path}"], path,
                       r)
            assert a.shape == b.shape, (path, a.shape, b.shape)
            want = ULP_SHARE
            if scanned:
                want -= 1 - _share(_block(case, one[f"{pre}step/param{path}"],
                                          path, r), b)
            assert _share(a, b) >= want, (md, path, r, _share(a, b), want)
            for k in ("m", "v"):
                a = port[f"{got}step/{k}{path}"]
                b = _moment_block(case, md,
                                  jax_rec[f"{case}/{md}/step/{k}{path}"],
                                  path, r)
                assert a.shape == b.shape, (k, path, a.shape, b.shape)
                want = MOMENT_RTOL
                if scanned:
                    want += _rel(_moment_block(
                        case, md, one[f"{pre}step/{k}{path}"], path, r), b)
                assert _rel(a, b) <= want, (md, k, path, r, _rel(a, b))
        if md == "f32":
            np.testing.assert_allclose(port[f"{case}/f32/loss0"],
                                       jax_rec[f"{case}/loss0"],
                                       rtol=LOSS_RTOL)
            for path in _paths(case):
                w = _block(case, jax_rec[f"{case}/grad{path}"], path, r)
                g = port[f"{case}/f32/grad{path}"]
                assert g.shape == w.shape, (path, g.shape, w.shape)
                if not w.any():         # the idle cell of an xLSTM block
                    assert not g.any(), path
                    continue
                want = GRAD_RTOL
                if path.startswith(SCANNED):
                    want += _rel(_block(case, one[f"one/{case}/f32/grad"
                                                  f"{path}"], path, r), w)
                assert _rel(g, w) <= want, (path, r, _rel(g, w), want)


@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_norms_stay_bit_equal_across_ranks(records, case, md):
    ports = records["port"]
    keys = sorted(k for k in ports[0] if k.startswith(f"{case}/{md}/norm/"))
    assert len(keys) == TRAIN_STEPS * 3 * sum(map(_is_norm, _paths(case)))
    for port in ports[1:]:
        for k in keys:
            np.testing.assert_array_equal(port[k], ports[0][k], err_msg=k)


@pytest.mark.parametrize("md", TILED)
@pytest.mark.parametrize("case", list(CASES))
def test_moment_bytes_equal_jax(records, case, md):
    """After one update from one given state and gradient, every rank's
    bytes of each moment store equal its block of JAX's GSPMD update (in
    JAX's mask layout), the leaves whose tiles straddle the model shards
    whole over model."""
    jax_rec, ports = records["jax"], records["port"]
    lay = _layout(case, md)
    differ = []
    for r, port in enumerate(ports):
        pre = f"{case}/{md}/update/"
        keys = sorted(k for k in port if k.startswith(pre))
        assert len(keys) == sum(1 for k in jax_rec if k.startswith(pre))
        for k in keys:
            path, part = k[len(pre) + 1:], ""
            if path not in lay:
                path, part = path[:path.rindex("['")], \
                    path[path.rindex("['") + 2:-2]
            want = _moment_block(case, md, jax_rec[k], path, r, part)
            got = port[k]
            assert got.shape == want.shape, (k, r, got.shape, want.shape)
            if not np.array_equal(got, want):
                differ.append((r, k[len(pre):], float(
                    np.mean(got != want))))
    assert not differ, differ


def test_mamba_takes_its_channels_of_u_and_of_z(records):
    """``in_proj`` is split over its 2 d_inner columns, so rank r's
    contiguous block holds u for r < m/2 and z for the rest; each rank's u
    and z are its channels' block of each (not the halves of its own
    block, which the whole u and z, different, tell apart), and layer 0's
    Mamba gives the whole layer's output and input gradient."""
    one = records["port"][0]
    u, z = one["one/hymba/mamba/u"], one["one/hymba/mamba/z"]
    assert not np.array_equal(u, z)
    m = CASES["hymba"][2][1]
    w = u.shape[-1] // m
    ux = np.concatenate([u, z], axis=-1)
    wrong = 0
    for r, port in enumerate(records["port"]):
        gu, gz = port["hymba/mamba/u"], port["hymba/mamba/z"]
        np.testing.assert_array_equal(gu, u[..., r * w:(r + 1) * w])
        np.testing.assert_array_equal(gz, z[..., r * w:(r + 1) * w])
        blk = ux[..., 2 * r * w:2 * (r + 1) * w]
        wrong += not (np.array_equal(gu, blk[..., :w])
                      and np.array_equal(gz, blk[..., w:]))
        assert_model_ulps(port["hymba/mamba/y"], one["one/hymba/mamba/y"],
                          1)
        g, wg = port["hymba/mamba/gx"], one["one/hymba/mamba/gx"]
        assert np.linalg.norm(g - wg) <= GRAD_RTOL * np.linalg.norm(wg)
    assert wrong == m


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_equal_the_chip_predictor(records, case):
    """Each rank's model-axis collectives and their bytes, of the prefill,
    a decode step and a train step (f32 and bdi8: one gather a leaf whose
    tiles straddle the shards), equal ``chip_smoke.fam_counts``'s for its
    rows, the predictor phase 20 holds the card's ranks to; nothing over
    data on a model axis alone."""
    cs = _chip_smoke()
    cfg, (d, m) = case_cfg(case), CASES[case][2]
    mesh = _mesh(case)
    with AX.use_mesh(mesh), threshold(case):
        whole = get_model(cfg).init(torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord=_coord(case, 0),
                                fsdp=CASES[case][3] != REAL)
        sharded = sum(tp.sharded_leaves(whole, local))
        wide = {md: [t.numel() * t.element_size() for t, w in zip(
            P.leaves(local), tp.check_moments(local, md)) if w]
            for md in DTYPES}
    assert not wide["f32"] and bool(wide["bdi8"]) == (m == 4)
    for md in DTYPES:
        want = cs.fam_counts(cfg, m, (BATCH // d, PROMPT, ENC),
                             (SHAPE.global_batch // d, SHAPE.seq_len),
                             sharded, wide[md])
        for port in records["port"]:
            got = port[f"{case}/serve/collectives"]
            assert got[:3, 0].tolist() == want["prefill"], (md, "prefill")
            assert got[:3, 1].tolist() == want["decode_step"], md
            assert d > 1 or not got[3:].any()
            for i in range(TRAIN_STEPS):
                c = port[f"{case}/{md}/collectives/{i}"]
                assert c[:4].tolist() == want["train_step"], (md, i)
                assert d > 1 or not c[4:].any()


# ---------------------------------------------------------------------------
# shapes alone (abstract meshes: no collective runs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b",
                                  "seamless-m4t-large-v2"])
def test_production_mesh_takes_the_families(arch):
    """JAX's dry run lays these out on ``(16, 16)``.  On an abstract mesh
    of that shape the port takes them (``tp.check_layout``;
    ``tp.check_moments`` under every moment dtype), each rank's blocks of
    the params (FSDP under the training layout) and of the decode cache
    (32 rows, 2 a data rank) have the shapes of JAX's specs, and
    ``optim/adamw.plan`` takes the moments under every moment dtype
    (tiles straddling two data blocks included).  At 2 layers (4 for
    xlstm, so that an sLSTM layer is among them; seamless 2 + 2)."""
    from jax.sharding import AbstractMesh
    from repro.configs.registry import get_arch as jax_arch
    from repro.distributed import sharding as JSH
    from repro.models.api import get_model as jax_model
    kw = {"n_layers": 2}
    if arch == "xlstm-350m":
        kw = {"n_layers": 8}
    if arch == "seamless-m4t-large-v2":
        kw["enc_layers"] = 2
    cfg = dataclasses.replace(get_arch(arch), **kw)
    jcfg = dataclasses.replace(jax_arch(arch), **kw)
    mesh = EL.abstract_mesh((16, 16), ("data", "model"))
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}

    def blocks(like, specs) -> list[tuple]:
        flat = jax.tree_util.tree_flatten_with_path(like)[0]
        spec = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec))
        out = []
        for (_, leaf), s in zip(flat, spec):
            shape = list(leaf.shape)
            for d, a in enumerate(s):
                for name in () if a is None else (
                        a if isinstance(a, tuple) else (a,)):
                    shape[d] //= sizes[name]
            out.append(tuple(shape))
        return out
    model = get_model(cfg)
    jm = jax_model(jcfg)
    with AX.use_mesh(mesh):
        tp.check_layout(cfg)
        whole = model.init(torch.Generator(), "meta")
        jlike = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        for fsdp in (False, True):
            local = SH.local_params(whole, mesh, coord={"data": 3,
                                                        "model": 5},
                                    fsdp=fsdp)
            assert [tuple(t.shape) for t in P.leaves(local)] == blocks(
                jlike, JSH.param_specs(jlike, jmesh, fsdp=fsdp)), fsdp
        paths = [p for p, _ in store.leaf_paths(local)]
        for md in AW.MOMENT_DTYPES:
            wide = tp.check_moments(local, md)
            assert not any(wide) or md in TILED, md
            AW.plan(local, whole, AdamWConfig(moment_dtype=md))
        assert len(paths) == len(wide)
        kw = {"enc_len": 4096} if cfg.is_encdec else {}
        port = model.init_cache(2, 4096, device="meta", **kw)
        jc = jax.eval_shape(lambda: jm.init_cache(32, 4096, **kw))
        assert [tuple(t.shape) for t in port] == blocks(
            jc, JSH.cache_specs(jc, jmesh))
