"""The model axis where the heads do not divide it, and bdi8/q8 moment
tiles that straddle the model shards: the port vs JAX's GSPMD program on
the CPU.

Where a dense GQA decoder's KV heads (or heads) do not divide the model
axis, JAX's rule table drops ``model`` from wk and wv (and wq, wo and the
QKV biases) and keeps them whole, and ``cache_specs`` shards the decode
cache over T; where a leaf's last dim is split over ``model`` but its
moment tiles of 128 do not divide the axis, it keeps the moments whole.
The port lays out the same (``distributed/tp.py``: ``tp.Whole`` leaves,
``softmax_over_rows``, ``write_row``; ``optim/adamw.py``: whole moments
from the gradient gathered over ``model``).  JAX places params with
``param_shardings`` and pins every cache to ``cache_specs`` with
``out_shardings``, as its dry run does (unpinned, GSPMD keeps the cache
split 2 x 2 over heads).

One module fixture starts, all at once, four port ranks (gloo over a
``FileStore`` in the test's temporary directory, each writing ``.npz``),
which run the ``(1, 4)`` cases on one mesh and then the ``(2, 2)`` case
on another, and a JAX process a mesh shape (the compiles are most of
the file's time) with ``XLA_FLAGS=--xla_force_host_platform_device_
count=4 --xla_allow_excess_precision=false``.  Rank 0
also runs every case without a mesh, the port's own m = 1 reference.
Cases:

* ``yi-6b``: reduced yi-6b (4 heads, 2 KV heads, d_ff 128, vocab 256)
  on ``(1, 4)``: one query head a rank, K/V whole, the cache over T;
  gate, up (1 tile) and lm_head (2 tiles) straddle under bdi8/q8;
* ``qwen2.5-14b``: reduced qwen2.5-14b at 6 heads and 2 KV heads, QKV
  biases from seed 1, on ``(1, 4)``: Q, wo and K/V whole, attention whole
  on every rank;
* ``yi-6b-2x2``: reduced yi-6b at d_model 256, 4 heads, 1 KV head, d_ff
  384 (3 tiles) on ``(2, 2)``, each side's ``FSDP_THRESHOLD_BYTES``
  lowered to 16 KiB (test-only), so that FSDP engages and the straddling
  gate and up are FSDP blocks too (over data on D; a block of D is one
  tile where data splits the last dim).

The params are the port's init from seed 0, restored by the JAX store;
JAX's ``_pow2_scale`` is swapped for the exact construction of 2^e
(``tests/test_torch_decode.exact_pow2_scale``, test-only).

Tolerances (``tests/test_torch_tensor_parallel.py``'s and ``tests/
test_torch_tp_train.py``'s, for the same reasons):

* bit for bit: ``local_shards`` of the params and of JAX's dense and
  quantised caches against JAX's addressable shards; the port's
  quantised cache blocks against JAX's; the straddling bdi8/q8 moment
  bytes after one AdamW update from one given state and gradient
  (clipping off, so that the norm's order of sums does not enter); the
  norms and their moments across the ranks after each step;
* prefill, teacher-forced decode and quantised decode logits, and the
  dense cache blocks: within 2 bf16 ULPs of the array's largest |value|,
  against JAX's and against the port's m = 1 run;
* greedy tokens: equal to JAX's loop up to one-ULP ties
  (``serving/parity.GreedyParity``);
* training under f32 and bdi8 moments: the first loss rtol 1e-4 and the
  norm 1e-3 against JAX's; gradients within a relative Frobenius error
  of 1e-2 (qwen's QKV biases 2e-2: XLA sums them in bf16); after the
  first step at least 98% of each param leaf within one bf16 ULP of
  JAX's and the loaded moments within 2e-2; the 3 losses within 1e-2 of
  the port's m = 1 run.
"""

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
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as AW
from repro_torch.serving.parity import GreedyParity
from test_torch_decode import _ulp, assert_model_ulps, exact_pow2_scale

REPO = Path(__file__).resolve().parents[1]
REAL = SH.FSDP_THRESHOLD_BYTES
# case -> (arch, reduced() overrides, mesh (data, model), FSDP threshold)
CASES = {"yi-6b": ("yi-6b", {}, (1, 4), REAL),
         "qwen2.5-14b": ("qwen2.5-14b", {"n_heads": 6, "n_kv_heads": 2},
                         (1, 4), REAL),
         "yi-6b-2x2": ("yi-6b", {"d_model": 256, "n_kv_heads": 1,
                                 "d_ff": 384}, (2, 2), 16 << 10)}
MESHES = ((1, 4), (2, 2))
WORLD = 4
BATCH, PROMPT, STEPS, GEN = 4, 8, 4, 8
CACHE = PROMPT + GEN             # rows of every dense cache: divide m
QUANT_LEN, QUANT_STEPS = 8, 6    # the last rank's rows stay past the steps
SHAPE = ShapeConfig("t", 32, 4, "train")
TRAIN_STEPS = 3
DTYPES = ("f32", "bdi8")
TILED = ("bdi8", "q8")           # the one-update bit test
MODEL_ULPS = 2
LOSS_RTOL, GNORM_RTOL, GRAD_RTOL, BIAS_GRAD_RTOL = 1e-4, 1e-3, 1e-2, 2e-2
TRAJ_RTOL = 1e-2
ULP_SHARE, MOMENT_RTOL = 0.98, 2e-2


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
    """The port's init from seed 0; qwen's QKV biases (zeros at init)
    drawn from seed 1, so that their slicing and gradients show."""
    params = T.init_params(case_cfg(case), torch.Generator().manual_seed(0),
                           "cpu")
    gen = torch.Generator().manual_seed(1)
    for name in ("wq", "wk", "wv"):
        b = params["blocks"]["attn"][name].get("b")
        if b is not None:
            b.copy_(torch.randn(b.shape, generator=gen) * 0.5)
    return params


def case_tokens(cfg) -> np.ndarray:
    rng = np.random.default_rng(3)
    return rng.integers(1, cfg.vocab, (BATCH, PROMPT + STEPS)).astype(
        np.int32)


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


def _np(t) -> np.ndarray:
    """A tensor or array as numpy: bf16 as its int16 bits."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t.view(torch.int16).numpy().copy() \
            if t.dtype == torch.bfloat16 else t.numpy().copy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _is_norm(path: str) -> bool:
    return "norm" in path or "['ln" in path


# ---------------------------------------------------------------------------
# the port: one rank (or no mesh)
# ---------------------------------------------------------------------------

def _rows(t: np.ndarray) -> torch.Tensor:
    """This rank's rows of a batch-first array (all of it without a
    mesh)."""
    t = torch.from_numpy(t)
    mesh = AX.current_mesh()
    return t if mesh is None else SH.local_batch({"t": t}, mesh)["t"]


def port_serve(cfg, params: dict) -> dict:
    out = {}
    toks = case_tokens(cfg)
    batch = {"tokens": _rows(toks[:, :PROMPT])}
    logits, cache = T.prefill(cfg, params, batch, CACHE)
    out["logits/0"] = _f32(logits)
    for i in range(STEPS):
        logits, cache = T.decode_step(cfg, params, cache,
                                      _rows(toks[:, PROMPT + i]), PROMPT + i)
        out[f"logits/{i + 1}"] = _f32(logits)
    for path, leaf in store.leaf_paths(cache):
        out[f"cache{path}"] = _np(leaf)
    qc = T.init_quant_cache(cfg, batch["tokens"].shape[0], QUANT_LEN,
                            device="cpu")
    for t in range(QUANT_STEPS):
        logits, qc = T.decode_step_quant(cfg, params, qc, _rows(toks[:, t]),
                                         t)
        out[f"quant/logits/{t}"] = _f32(logits)
    for path, leaf in store.leaf_paths(qc):
        out[f"quant/cache{path}"] = _np(leaf)
    g = dense_generate(cfg, params, torch.from_numpy(toks[:, :PROMPT]), GEN,
                       keep_logits=True)
    out["greedy/tokens"] = np.asarray(g["tokens"])
    out["greedy/logits"] = g["logits"].numpy()
    out["greedy/step_model"] = np.asarray(
        [g["collectives"]["per_step"]["model"][k]
         for k in ("all_reduce", "all_gather", "writes")])
    return out


def _moments(params: dict, state: dict) -> dict:
    """Every moment leaf loaded to f32 (what this rank keeps: whole over
    model where its tiles straddle), keyed ``m``/``v`` + the path."""
    return {f"{k}{path}": _f32(AW._load(s, s["deltas"].shape[:-2] + (
                s["deltas"].shape[-2] * 128,) if isinstance(s, dict)
                else s.shape))
            for k in ("m", "v")
            for (path, _), s in zip(store.leaf_paths(params),
                                    AW._store_leaves(state[k]))}


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
            grads = pool.submit(torch.autograd.grad, loss, flat).result()
        for t in flat:
            t.requires_grad_(False)
        out["loss0"] = np.float32(float(loss))
        for (path, _), g in zip(store.leaf_paths(params), grads):
            out[f"grad{path}"] = _f32(g)
    step = make_train_step(model, ocfg)
    for i, batch in enumerate(batches):
        params, state, met = step(params, state, batch)
        out[f"loss/{i}"] = np.float32(met["loss"])
        out[f"grad_norm/{i}"] = np.float32(met["grad_norm"])
        out[f"collectives/{i}"] = np.asarray(
            [met["collectives"]["model"][k]
             for k in ("all_reduce", "all_gather", "backward")])
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
    """Two AdamW updates with :func:`update_grads` (this rank's blocks)
    from the zero state, clipping off: the moment stores' bytes in JAX's
    layout after each."""
    ocfg = AdamWConfig(moment_dtype=md, grad_clip=0.0)
    params = P.tree_map(torch.clone, params)
    ug = update_grads(case)
    grads = store._rebuild(params, iter(
        torch.from_numpy(ug[path]).to(p.dtype)
        for path, p in store.leaf_paths(case_params(case))))
    if mesh is not None:
        grads = SH.local_shards(grads, SH.param_specs(
            grads, mesh, fsdp=CASES[case][3] != REAL), mesh)
    state = adamw_init(params, ocfg, whole=whole)
    out = {}
    for i in range(2):
        params, state, _ = adamw_update(params, grads, state, ocfg,
                                        whole=whole)
        ex = AW.export_state(state)
        out.update({f"update/{i}/{k}{path}": _np(t) for k in ("m", "v")
                    for path, t in store.leaf_paths(ex[k])})
    return out


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
            drawn = T.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu",
                local=SH.Local(mesh, fsdp=fsdp, layers=cfg.n_layers))
            out["init_local_equal"] = np.asarray(all(
                torch.equal(a, b) for (pa, a), (_, b) in zip(
                    store.leaf_paths(drawn), store.leaf_paths(local))
                if "['b']" not in pa))
        out.update(port_serve(cfg, local))
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
# JAX: one process, four host devices
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
    from repro.models import transformer as JT
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
        toks = case_tokens(jcfg)
        batch = {"tokens": put_rows(toks[:, :PROMPT])}
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
        qc = JT.init_quant_cache(jcfg, BATCH, QUANT_LEN)
        qsh = named(JSH.cache_specs(qc, mesh))
        qc = jax.device_put(qc, qsh)
        qstep = jax.jit(lambda p, c, tok, t: JT.decode_step_quant(
            jcfg, p, c, tok, t), out_shardings=(None, qsh),
            compiler_options=opts)
        for t in range(QUANT_STEPS):
            logits, qc = qstep(params, qc, put_rows(toks[:, t]),
                               jnp.int32(t))
            out[f"{case}/quant/logits/{t}"] = _f32(logits)
        for path, leaf in store.leaf_paths(qc):
            out[f"{case}/quant/cache{path}"] = _np(leaf)
        shards("quant_shard", qc)
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
        states = {md: JO.adamw_init(params, JO.AdamWConfig(moment_dtype=md))
                  for md in DTYPES}
        osh = {md: JSH.param_shardings(s, mesh, fsdp=fsdp)
               for md, s in states.items()}
        states = jax.device_put(states, osh)
        tb = {k: put_rows(v) for k, v in train_batches(jcfg)[0].items()}

        def both(params, states, batch):
            loss, grads = jax.value_and_grad(jm.loss)(params, batch)
            upd = {}
            for md, st in states.items():
                p2, s2, met = JO.adamw_update(
                    params, grads, st, JO.AdamWConfig(moment_dtype=md))
                upd[md] = (p2, s2, met["grad_norm"])
            return loss, grads, upd
        loss, grads, upd = jax.jit(
            both, out_shardings=(None, psh, {
                md: (psh, osh[md], None) for md in DTYPES}),
            compiler_options=opts)(params, states, tb)
        out[f"{case}/loss0"] = np.float32(loss)
        for k, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"{case}/grad{jax.tree_util.keystr(k)}"] = _f32(g)
        for md in DTYPES:
            p2, s2, gnorm = upd[md]
            out[f"{case}/{md}/grad_norm"] = np.float32(gnorm)
            trees = {"param": p2, **{k: jax.tree.map(
                lambda p, s, md=md: JO._load(s, md, p.shape), params,
                s2[k]) for k in ("m", "v")}}
            for key, tree in trees.items():
                for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    out[f"{case}/{md}/step/{key}"
                        f"{jax.tree_util.keystr(k)}"] = _f32(leaf)
        # two updates from the zero state with one given gradient
        ug = update_grads(case)
        flat, tdef = jax.tree_util.tree_flatten_with_path(params)
        g = jax.device_put(jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(ug[jax.tree_util.keystr(k)], leaf.dtype)
            for k, leaf in flat]), psh)
        for md in TILED:
            ocfg = JO.AdamWConfig(moment_dtype=md, grad_clip=0.0)
            st = JO.adamw_init(params, ocfg)
            ssh = JSH.param_shardings(st, mesh, fsdp=fsdp)
            st = jax.device_put(st, ssh)
            # the first update jitted under GSPMD (from the zero state
            # XLA's fused multiply-adds give the unfused values); the
            # second op by op on one device (jitted, XLA fuses b1 m +
            # (1 - b1) g into one FMA, which the port's two roundings do
            # not match)
            p2, st = jax.jit(lambda p, g, s, ocfg=ocfg: JO.adamw_update(
                p, g, s, ocfg)[:2], out_shardings=(psh, ssh),
                compiler_options=opts)(params, g, st)
            for i in range(2):
                if i:
                    one = jax.tree.map(lambda a: jnp.asarray(
                        np.asarray(a)), (p2, g, st))
                    p2, st = JO.adamw_update(*one, ocfg)[:2]
                for k in ("m", "v"):
                    for path, leaf in store.leaf_paths(st[k]):
                        out[f"{case}/{md}/update/{i}/{k}{path}"] = _np(leaf)


def jax_mesh(shape: tuple, work: str) -> None:
    """Entry of a JAX process: the cases of one mesh shape, into
    ``work/jax_<d><m>.npz``."""
    from repro.core import bdi_value as jbv
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    assert len(jax.devices()) == WORLD
    out = {}
    for case in cases_of(shape):
        jax_case(case, work, out)
    np.savez(os.path.join(work, f"jax_{shape[0]}{shape[1]}.npz"), **out)


# ---------------------------------------------------------------------------
# the fixture: all processes at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax": npz, "port": [npz of each rank]}."""
    work = tmp_path_factory.mktemp("tp_replicated")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tp_replicated as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    jenv = dict(env, XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={WORLD}"
        + " --xla_allow_excess_precision=false").strip())
    procs = [start(f"jax_mesh({shape}, {str(work)!r})", jenv)
             for shape in MESHES]
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
    for shape in MESHES:
        jax_rec.update(np.load(work / f"jax_{shape[0]}{shape[1]}.npz"))
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


def _spec(case: str, path: str, shape: tuple):
    with threshold(case):
        return SH._spec_for(path, shape, _mesh(case), 2,
                            CASES[case][3] != REAL)


def _cut(case: str, whole: np.ndarray, spec, rank: int) -> np.ndarray:
    return SH.local_shards({"x": torch.from_numpy(whole)}, {"x": spec},
                           _mesh(case), coord=_coord(case, rank))["x"].numpy()


def _block(case: str, whole: np.ndarray, path: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole params-shaped array."""
    return _cut(case, whole, _spec(case, path, whole.shape), rank)


@functools.lru_cache(maxsize=None)
def _layout(case: str, md: str) -> dict:
    """By param path, on the abstract mesh from shapes alone: (the
    param's spec, whether its moment tiles straddle the model shards,
    the ZeRO-1 owner dim where the param is whole over data, or -1)."""
    cfg = case_cfg(case)
    mesh = _mesh(case)
    ocfg = AdamWConfig(moment_dtype=md)
    with threshold(case), AX.use_mesh(mesh):
        whole = T.init_params(cfg, torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord=_coord(case, 0),
                                fsdp=CASES[case][3] != REAL)
        wide = tp.check_moments(local, md)
        lay = AW.plan(local, whole, ocfg) or [None] * len(wide)
    return {path: (_spec(case, path, tuple(t.shape)), w,
                   -1 if x is None or x.owner is None or x.data is not None
                   else x.owner)
            for (path, t), w, x in zip(store.leaf_paths(whole), wide, lay)}


def _moment_block(case: str, md: str, whole: np.ndarray, path: str,
                  rank: int, part: str = "") -> np.ndarray:
    """What rank ``rank`` keeps of a whole moment leaf (loaded, params-
    shaped; or a store's ``part``, whose leading dims are the param's
    with the tile count last): its param block, whole over model where
    the tiles straddle, the tile count cut in whole tiles, narrowed to
    its 1/d along a ZeRO-1 owner dim where the param is whole over
    data."""
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


def _cache_like(case: str, quant: bool):
    cfg = case_cfg(case)
    if quant:
        return T.init_quant_cache(cfg, BATCH, QUANT_LEN, device="meta")
    return T.init_cache(cfg, BATCH, CACHE, device="meta")


def _as_f32(bits: np.ndarray, dtype) -> np.ndarray:
    if dtype == torch.bfloat16:
        return torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
    return bits


def _q_split(case: str) -> bool:
    cfg = case_cfg(case)
    return cfg.n_heads % CASES[case][2][1] == 0


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_local_shards_equal_jax_addressable_shards(records, case):
    """Params, and JAX's dense and quantised caches (sharded over T):
    the port's ``local_shards`` of the whole equals each device's shard."""
    jax_rec, ports = records["jax"], records["port"]
    for r, port in enumerate(ports):
        assert bool(port[f"{case}/init_local_equal"])
        for path in _paths(case):
            got, want = port[f"{case}/shard{path}"], \
                jax_rec[f"{case}/shard/{r}{path}"]
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (path, r)
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {r}")
        for prefix, quant in (("cache", False), ("quant/cache", True)):
            like = _cache_like(case, quant)
            glob = store._rebuild(like, iter(
                torch.from_numpy(jax_rec[f"{case}/{prefix}{p}"])
                for p, _ in store.leaf_paths(like)))
            cut = SH.local_shards(glob, SH.cache_specs(glob, _mesh(case)),
                                  _mesh(case), coord=_coord(case, r))
            shard = "quant_shard" if quant else "cache_shard"
            for path, leaf in store.leaf_paths(cut):
                want = jax_rec[f"{case}/{shard}/{r}{path}"]
                np.testing.assert_array_equal(leaf.numpy(), want,
                                              err_msg=f"{path} {r}")
    spec = SH.cache_specs(_cache_like(case, False), _mesh(case)).full_k
    assert spec[2] == "model" and spec[3] is None          # over T


@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_match_jax(records, case):
    """Each rank's dense cache (its T block) within 2 ULPs of JAX's, its
    quantised cache bit-equal; the blocks are ``cache_specs``'s."""
    jax_rec, ports = records["jax"], records["port"]
    for quant in (False, True):
        prefix = "quant/cache" if quant else "cache"
        like = _cache_like(case, quant)
        glob = store._rebuild(like, iter(
            torch.from_numpy(jax_rec[f"{case}/{prefix}{p}"])
            for p, _ in store.leaf_paths(like)))
        for r, port in enumerate(ports):
            cut = SH.local_shards(glob, SH.cache_specs(glob, _mesh(case)),
                                  _mesh(case), coord=_coord(case, r))
            for (path, want), (_, leaf) in zip(store.leaf_paths(cut),
                                               store.leaf_paths(like)):
                got = port[f"{case}/{prefix}{path}"]
                want = want.numpy()
                assert got.shape == want.shape, (path, r)
                if quant:
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{path} {r}")
                else:
                    assert_model_ulps(_as_f32(got, leaf.dtype),
                                      _as_f32(want, leaf.dtype), MODEL_ULPS)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_logits_match_jax(records, case):
    jax_rec, ports = records["jax"], records["port"]
    keys = [f"logits/{i}" for i in range(STEPS + 1)] + [
        f"quant/logits/{t}" for t in range(QUANT_STEPS)]
    for port in ports:
        for k in keys:
            assert_model_ulps(port[f"{case}/{k}"], jax_rec[f"{case}/{k}"],
                              MODEL_ULPS)
            np.testing.assert_array_equal(port[f"{case}/{k}"],
                                          ports[0][f"{case}/{k}"])


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_layout_matches_one_rank(records, case):
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
    """Tokens as JAX's up to one-ULP ties; a decode step's collectives
    over the model axis: per layer the MAX and the SUM that combine the
    T blocks, the MLP's sum and, where Q is split, wo's sum and the
    gather of the query heads; the embedding's sum and the logits' gather;
    one rank writes each layer's K and V."""
    jax_rec, ports = records["jax"], records["port"]
    want = jax_rec[f"{case}/greedy/tokens"]
    n = case_cfg(case).n_layers
    q = _q_split(case)
    writes = 0
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
        ar, ag, w = port[f"{case}/greedy/step_model"]
        assert (ar, ag) == ((4 if q else 3) * n + 1, (n if q else 0) + 1)
        writes += w
    # each step's K and V of every layer, written once over the ranks of
    # a data group, in every data group
    assert writes == 2 * n * CASES[case][2][0]


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
            a = port[f"{got}step/param{path}"]
            b = _block(case, jax_rec[f"{case}/{md}/step/param{path}"], path,
                       r)
            assert a.shape == b.shape, (path, a.shape, b.shape)
            gap = np.abs(a - b) - _ulp(np.maximum(np.abs(a), np.abs(b)))
            share = float((gap <= 0).mean())
            assert share >= ULP_SHARE, (md, path, r, share)
            bound = MOMENT_RTOL * (2 if path.endswith("['b']") else 1)
            for k in ("m", "v"):
                a = port[f"{got}step/{k}{path}"]
                b = _moment_block(case, md,
                                  jax_rec[f"{case}/{md}/step/{k}{path}"],
                                  path, r)
                assert a.shape == b.shape, (k, path, a.shape, b.shape)
                err = float(np.linalg.norm(a - b)
                            / max(np.linalg.norm(b), 1e-30))
                assert err <= bound, (md, k, path, r, err)
        if md == "f32":
            np.testing.assert_allclose(port[f"{case}/f32/loss0"],
                                       jax_rec[f"{case}/loss0"],
                                       rtol=LOSS_RTOL)
            for path in _paths(case):
                w = _block(case, jax_rec[f"{case}/grad{path}"], path, r)
                g = port[f"{case}/f32/grad{path}"]
                assert g.shape == w.shape, (path, g.shape, w.shape)
                err = np.linalg.norm(g - w) / np.linalg.norm(w)
                bound = BIAS_GRAD_RTOL if path.endswith("['b']") \
                    else GRAD_RTOL
                assert err <= bound, (path, r, err)


@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_norms_stay_bit_equal_across_ranks(records, case, md):
    ports = records["port"]
    keys = sorted(k for k in ports[0] if k.startswith(f"{case}/{md}/norm/"))
    assert len(keys) == TRAIN_STEPS * 3 * sum(map(_is_norm, _paths(case)))
    for port in ports[1:]:
        for k in keys:
            np.testing.assert_array_equal(port[k], ports[0][k], err_msg=k)


@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_collectives_of_a_train_step(records, case, md):
    """Over the model axis (PR 26's count, ``test_torch_tp_train``): the
    embedding's sum, the attention's and the MLP's sums a layer and the
    loss's two, forward and in the recompute; backward the input
    gradients of q, k, v, gate and up a layer and of the head, and wk's
    and wv's weight gradients a layer (whole K/V read by split Q); the
    clip norm's sum.  Where Q is whole attention issues nothing.  Under
    bdi8 one all-gather a straddling leaf, its gradient for the whole
    moments."""
    n = case_cfg(case).n_layers
    if _q_split(case):
        backward = 5 * n + 1 + 2 * n
        total = (1 + 2 * n + 2) + (n + 2) + backward + 1
    else:
        backward = 2 * n + 1
        total = (1 + n + 2) + 2 + backward + 1
    for port in records["port"]:
        wide = int(port[f"{case}/{md}/wide"].sum())
        assert wide == (0 if md == "f32" else
                        (2 if case == "yi-6b-2x2" else 3))
        for i in range(TRAIN_STEPS):
            np.testing.assert_array_equal(
                port[f"{case}/{md}/collectives/{i}"],
                [total, wide, backward])


@pytest.mark.parametrize("md", TILED)
@pytest.mark.parametrize("case", list(CASES))
def test_straddling_moment_bytes_equal_jax(records, case, md):
    """After one update from one given state and gradient, every rank's
    bytes of each moment store equal its block of JAX's (in JAX's mask
    layout), the straddling leaves' (gate, up and, at m = 4, the head's:
    tiles across the model shards) whole over model: from the zero state
    against JAX's GSPMD step, then from that state against JAX's update
    op by op."""
    jax_rec, ports = records["jax"], records["port"]
    lay = _layout(case, md)
    straddling = [p for p, (_, w, _) in lay.items() if w]
    assert len(straddling) == (2 if case == "yi-6b-2x2" else 3)
    differ = []
    for r, port in enumerate(ports):
        pre = f"{case}/{md}/update/"
        keys = sorted(k for k in port if k.startswith(pre))
        assert len(keys) == sum(1 for k in jax_rec if k.startswith(pre))
        for k in keys:
            path, part = k[len(pre) + 3:], ""
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


# ---------------------------------------------------------------------------
# shapes alone (abstract meshes: no collective runs)
# ---------------------------------------------------------------------------

def test_sharded_leaves_follow_the_spec_after_the_drop():
    """The clip norm sums a leaf's squares over ``model`` only where the
    rule table still splits it once it has dropped the axis from a dim
    that does not divide: reduced yi-6b at m = 4 keeps wk and wv (2 KV
    heads) whole, so each adds its squares once, as the norms do; wq
    (4 heads), wo, the MLP and the vocab leaves stay split."""
    cfg = case_cfg("yi-6b")
    mesh = _mesh("yi-6b")
    with AX.use_mesh(mesh):
        whole = T.init_params(cfg, torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord=_coord("yi-6b", 1))
        got = dict(zip(_paths("yi-6b"), tp.sharded_leaves(whole, local)))
    whole_leaves = {p for p, split in got.items() if not split}
    assert whole_leaves == {p for p in got if "['w" in p and (
        "['wk']" in p or "['wv']" in p) or _is_norm(p)}, whole_leaves
    with AX.use_mesh(None):
        assert not any(tp.sharded_leaves(whole, whole))


PRODUCTION = ("yi-6b", "yi-9b", "qwen2.5-14b", "internvl2-76b", "gemma3-27b")


@pytest.mark.parametrize("arch", PRODUCTION)
def test_production_mesh_takes_every_dense_gqa_decoder(arch):
    """JAX's dry run lays every cell out on ``(16, 16)``: params by
    ``param_specs(fsdp=True)``, caches by ``cache_specs``.  On an
    abstract mesh of that shape the port takes each dense GQA decoder
    (``tp.check_layout``, ``tp.check_moments`` under every moment dtype),
    and each rank's blocks of the params, of the decode cache (32 rows of
    4096 positions, 2 a data rank) and of the quantised cache have the
    shapes of JAX's specs; where the KV heads do not divide 16 the cache
    is split over T.  ``optim/adamw.plan`` takes the moments under every
    moment dtype (straddles over ``data`` included)."""
    from jax.sharding import AbstractMesh
    from repro.configs.registry import get_arch as jax_arch
    from repro.distributed import sharding as JSH
    from repro.models import transformer as JT
    from repro.models.api import get_model as jax_model
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    mesh = EL.abstract_mesh((16, 16), ("data", "model"))
    jmesh = AbstractMesh((16, 16), ("data", "model"))

    def blocks(like, specs) -> list[tuple]:
        sizes = {"data": 16, "model": 16}
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
    with AX.use_mesh(mesh):
        tp.check_layout(cfg)
        whole = T.init_params(cfg, torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord={"data": 3, "model": 5},
                                fsdp=True)
        jlike = jax.eval_shape(jax_model(jcfg).init, jax.random.PRNGKey(0))
        assert [tuple(t.shape) for t in P.leaves(local)] == blocks(
            jlike, JSH.param_specs(jlike, jmesh, fsdp=True))
        for md in AW.MOMENT_DTYPES:
            wide = tp.check_moments(local, md)
            assert len(wide) == len(P.leaves(local))
            AW.plan(local, whole, AdamWConfig(moment_dtype=md))
        caches = [(T.init_cache(cfg, 2, 4096, device="meta"),
                   jax.eval_shape(lambda: JT.init_cache(jcfg, 32, 4096)))]
        if not T.cache_slots(cfg)[2][1]:
            caches.append((
                T.init_quant_cache(cfg, 2, 4096, device="meta"),
                jax.eval_shape(lambda: JT.init_quant_cache(jcfg, 32, 4096))))
        for port, jc in caches:
            assert [tuple(t.shape) for t in port] == blocks(
                jc, JSH.cache_specs(jc, jmesh))
        full_k = caches[0][0].full_k.shape
        assert full_k[2:4] == ((4096, cfg.n_kv_heads // 16)
                               if cfg.n_kv_heads % 16 == 0
                               else (4096 // 16, cfg.n_kv_heads))
