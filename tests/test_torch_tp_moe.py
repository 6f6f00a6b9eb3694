"""The model and data axes for the MoE and MLA decoders: the port vs
JAX's GSPMD program on the CPU.

JAX's rule table lays the experts out over ``model`` (expert
parallelism: ``moe_ffn``'s ``shard_map`` routes each device's rows
through its E/m experts and sums over ``model``), splits MLA's heads
(wq, wuk, wuv, wo) and replicates wdkv, wkr, kv_norm and the router;
``cache_specs`` splits the latent cache over its last dim.  The port
lays out the same (``distributed/tp.py``: ``copy_to_model`` and
``reduce_from_model`` around the rank's experts, ``heads_broadcast`` of
the rope key; ``models/moe.py``; ``models/attention.py``), each rank
drawing only its experts (``sharding.Local``).  JAX places params with
``param_shardings`` and pins every cache to ``cache_specs`` with
``out_shardings``, as its dry run does.

One module fixture starts, all at once, four port ranks (gloo over a
``FileStore`` in the test's temporary directory, each writing ``.npz``),
which run the ``(1, 4)`` cases on one mesh and then the ``(2, 2)`` case
on another, and a JAX process a case with ``XLA_FLAGS=--xla_force_host_
platform_device_count=4 --xla_allow_excess_precision=false``.  Rank
0 also runs every case without a mesh, the port's own m = 1 reference.
Cases:

* ``deepseek``: reduced deepseek-v2-lite-16b (MLA, 4 heads, latent 16,
  rope 8; 8 experts top-2 and 1 shared expert, each 384 wide) on ``(1,
  4)``: one head and 2 experts a rank, the latent cache split over its
  last dim; the shared expert's gate and up (3 tiles) and the head (2)
  straddle the shards under bdi8/q8, the expert stacks keep whole tiles;
* ``arctic``: reduced arctic-480b (4 heads, 2 KV heads: K/V whole at m
  = 4, the cache over T; 8 experts top-2 beside a dense residual FFN 384
  wide, which straddles) on ``(1, 4)`` at the config's own capacity
  factor of 1.25, so that tokens are dropped (held below), dense and
  quantised cache;
* ``deepseek-2x2``: reduced deepseek-v2-lite-16b on ``(2, 2)``, each
  side's ``FSDP_THRESHOLD_BYTES`` lowered to 16 KiB (test-only), so that
  the expert stacks are FSDP blocks over data (on D; on F for down).

The params are the port's init from seed 0, restored by the JAX store;
JAX's ``_pow2_scale`` is swapped for the exact construction of 2^e
(``tests/test_torch_decode.exact_pow2_scale``, test-only).

Tolerances (``tests/test_torch_tp_replicated.py``'s, for the same
reasons):

* bit for bit: ``local_shards`` of the params and of JAX's dense and
  quantised caches against JAX's addressable shards; the port's
  quantised cache blocks against JAX's; every moment store's bytes after
  one AdamW update from one given state and gradient (clipping off), the
  straddling leaves' whole over model; the norms and their moments
  across the ranks after each step;
* prefill, teacher-forced decode and quantised decode logits, and the
  dense cache blocks: within 2 bf16 ULPs of the array's largest |value|,
  against JAX's and against the port's m = 1 run;
* greedy tokens: equal to JAX's loop up to one-ULP ties
  (``serving/parity.GreedyParity``);
* training under f32 and bdi8 moments: the first loss rtol 1e-4 and the
  norm 1e-3 against JAX's; gradients within a relative Frobenius error
  of 1e-2; after the first step at least 98% of each param leaf within
  one bf16 ULP of JAX's and the loaded moments within 2e-2; the 3
  losses within 1e-2 of the port's m = 1 run.
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
from repro_torch.models import moe as M
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as AW
from repro_torch.serving.parity import GreedyParity
from test_torch_decode import _ulp, assert_model_ulps, exact_pow2_scale
from test_torch_tp_replicated import _as_f32, _f32, _is_norm, _moments, _np

REPO = Path(__file__).resolve().parents[1]
REAL = SH.FSDP_THRESHOLD_BYTES
# case -> (arch, reduced() overrides, mesh (data, model), FSDP threshold)
CASES = {"deepseek": ("deepseek-v2-lite-16b", {"d_ff_expert": 384}, (1, 4),
                      REAL),
         "arctic": ("arctic-480b", {"d_ff": 384, "capacity_factor": 1.25},
                    (1, 4), REAL),
         "deepseek-2x2": ("deepseek-v2-lite-16b", {}, (2, 2), 16 << 10)}
MESHES = ((1, 4), (2, 2))
WORLD = 4
BATCH, PROMPT, STEPS, GEN = 4, 8, 4, 8
CACHE = PROMPT + GEN
QUANT_LEN, QUANT_STEPS = 8, 6
SHAPE = ShapeConfig("t", 32, 4, "train")
TRAIN_STEPS = 3
DTYPES = ("f32", "bdi8")
TILED = ("bdi8", "q8")
MODEL_ULPS = 2
LOSS_RTOL, GNORM_RTOL, GRAD_RTOL = 1e-4, 1e-3, 1e-2
TRAJ_RTOL = 1e-2
ULP_SHARE, MOMENT_RTOL = 0.98, 2e-2
FFN = "['blocks']['ffn']"


def case_cfg(case: str):
    arch, kw, _, _ = CASES[case]
    return get_arch(arch).reduced(**kw)


def cases_of(shape: tuple) -> list[str]:
    return [c for c, v in CASES.items() if v[2] == shape]


def _mla(case: str) -> bool:
    return case_cfg(case).attn_kind == "mla"


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
    return T.init_params(case_cfg(case), torch.Generator().manual_seed(0),
                         "cpu")


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


def _rows(t: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(t)
    mesh = AX.current_mesh()
    return t if mesh is None else SH.local_batch({"t": t}, mesh)["t"]


# ---------------------------------------------------------------------------
# the port: one rank (or no mesh)
# ---------------------------------------------------------------------------

def port_serve(case: str, params: dict) -> dict:
    cfg = case_cfg(case)
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
    if not _mla(case):
        qc = T.init_quant_cache(cfg, batch["tokens"].shape[0], QUANT_LEN,
                                device="cpu")
        for t in range(QUANT_STEPS):
            logits, qc = T.decode_step_quant(cfg, params, qc,
                                             _rows(toks[:, t]), t)
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
        out["loss0"] = np.float32(float(loss.detach()))
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


def _ffn_input(cfg, seed: int = 9) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (BATCH, PROMPT, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)


def port_ffn(case: str, params: dict) -> dict:
    """Layer 0's MoE FFN (``moe_ffn``, on the layer's view of this rank's
    params, ``transformer.placed``) on this rank's rows of one input and
    its backward from one cotangent: the output, the gradients of the
    input and of the router, and the collectives by axis."""
    cfg = case_cfg(case)
    params = P.tree_map(torch.clone, params)
    router = params["blocks"]["ffn"]["router"]["w"].requires_grad_()
    x = _rows(_ffn_input(cfg).float().numpy()).to(torch.bfloat16)
    x.requires_grad_()
    layer = T.placed(cfg, params)[1][0]["ffn"]
    c0 = tp.counts()
    y = M.moe_ffn(layer, x, top_k=cfg.top_k, n_experts=cfg.n_experts,
                  capacity_factor=cfg.capacity_factor)
    c1 = tp.counts()
    gy = _rows(_ffn_input(cfg, 10).float().numpy()).to(torch.bfloat16)
    gx, gr = torch.autograd.grad(y, [x, router], gy)
    c2 = tp.counts()
    return {"ffn/y": _f32(y), "ffn/gx": _f32(gx), "ffn/grouter": _f32(gr[0]),
            "ffn/fwd": np.asarray([c1["model"]["all_reduce"]
                                   - c0["model"]["all_reduce"],
                                   c1["data"]["all_gather"]
                                   - c0["data"]["all_gather"]]),
            "ffn/bwd": np.asarray([c2[a][k] - c1[a][k] for a in tp.AXES
                                   for k in ("all_reduce", "all_gather",
                                             "backward")])}


def _drops(case: str, params: dict) -> dict:
    """Tokens dropped by the capacity in the first batch's loss (layer by
    layer, this process's MoE calls; test-only instrumentation) and that
    loss against a dropless capacity."""
    cfg = case_cfg(case)
    seen = []
    real = M._moe_local

    def counting(p, x2d, top_k, n_experts, e_offset, e_local, capacity):
        with torch.no_grad():
            _, idx = M._route(p["router"], x2d, top_k, n_experts)
            load = torch.bincount(idx.reshape(-1), minlength=n_experts)
            seen.append(int((load - capacity).clamp(min=0).sum()))
        return real(p, x2d, top_k, n_experts, e_offset, e_local, capacity)
    batch = {k: torch.from_numpy(v) for k, v in train_batches(cfg)[0].items()}
    M._moe_local = counting
    try:
        with torch.no_grad():
            loss = float(get_model(cfg).loss(params, batch))
    finally:
        M._moe_local = real
    dropless = float(get_model(dataclasses.replace(
        cfg, capacity_factor=8.0)).loss(params, batch))
    return {"drops": np.asarray(seen), "drops/loss": np.float32(loss),
            "drops/dropless": np.float32(dropless)}


def port_case(case: str, mesh) -> dict:
    cfg = case_cfg(case)
    full = case_params(case)
    fsdp = CASES[case][3] != REAL
    out = {}
    with threshold(case):
        if mesh is None:
            local, whole = full, None
            if cfg.capacity_factor < 8.0:
                out.update(_drops(case, full))
        else:
            local = SH.local_params(full, mesh, fsdp=fsdp)
            whole = get_model(cfg).init(torch.Generator(), "meta")
            for path, leaf in store.leaf_paths(local):
                out[f"shard{path}"] = _np(leaf)
            drawn = T.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu",
                local=SH.Local(mesh, fsdp=fsdp, layers=cfg.n_layers))
            out["init_local_equal"] = np.asarray(all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    store.leaf_paths(drawn), store.leaf_paths(local))))
            out["experts_held"] = np.asarray(
                drawn["blocks"]["ffn"]["experts"]["gate"]["w"].shape)
        out.update(port_ffn(case, local))
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
        if jcfg.attn_kind != "mla":
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
        # layer 0's MoE FFN and its vjp (the shard_map's transpose), as
        # port_ffn runs it
        from repro.models import moe as JM
        ffn0 = jax.tree.map(lambda a: a[0], params["blocks"]["ffn"])

        def ffn(x, router, gy):
            y, vjp = jax.vjp(lambda x, r: JM.moe_ffn(
                {**ffn0, "router": {"w": r}}, x, top_k=jcfg.top_k,
                n_experts=jcfg.n_experts,
                capacity_factor=jcfg.capacity_factor), x, router)
            return (y, *vjp(gy))
        y, gx, gr = jax.jit(ffn, compiler_options=opts)(
            put_rows(_ffn_input(jcfg).float().numpy().astype(jnp.bfloat16)),
            ffn0["router"]["w"],
            put_rows(_ffn_input(jcfg, 10).float().numpy().astype(
                jnp.bfloat16)))
        out.update({f"{case}/ffn/y": _f32(y), f"{case}/ffn/gx": _f32(gx),
                    f"{case}/ffn/grouter": _f32(gr)})
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
        # tiled dtype, jitted under GSPMD, the states placed by the rule
        # table (from the zero state XLA's fused multiply-adds give the
        # unfused values)
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
    work = tmp_path_factory.mktemp("tp_moe")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tp_moe as t; t.{call}"
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


def _cache_like(case: str, quant: bool):
    cfg = case_cfg(case)
    if quant:
        return T.init_quant_cache(cfg, BATCH, QUANT_LEN, device="meta")
    return T.init_cache(cfg, BATCH, CACHE, device="meta")


def _caches(case: str) -> tuple:
    return (False,) if _mla(case) else (False, True)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_local_shards_equal_jax_addressable_shards(records, case):
    """Params, and JAX's dense (and quantised) caches: the port's
    ``local_shards`` of the whole equals each device's shard; a rank that
    draws its params (``sharding.Local``) holds the same blocks and only
    its E/m experts; the MLA latent cache splits its last dim."""
    jax_rec, ports = records["jax"], records["port"]
    cfg = case_cfg(case)
    for r, port in enumerate(ports):
        assert bool(port[f"{case}/init_local_equal"])
        assert port[f"{case}/experts_held"][1] == \
            cfg.n_experts // CASES[case][2][1]
        for path in _paths(case):
            got, want = port[f"{case}/shard{path}"], \
                jax_rec[f"{case}/shard/{r}{path}"]
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (path, r)
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {r}")
        for quant in _caches(case):
            prefix = "quant/cache" if quant else "cache"
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
    spec = SH.cache_specs(_cache_like(case, False), _mesh(case))
    if _mla(case):
        assert spec.mla_c[3] == spec.mla_kr[3] == "model"
    else:
        assert spec.full_k[2] == "model" and spec.full_k[3] is None


@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_match_jax(records, case):
    """Each rank's dense cache (its block of the latent, or of T) within 2
    ULPs of JAX's, its quantised cache bit-equal."""
    jax_rec, ports = records["jax"], records["port"]
    for quant in _caches(case):
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
    keys = [f"logits/{i}" for i in range(STEPS + 1)]
    if not _mla(case):
        keys += [f"quant/logits/{t}" for t in range(QUANT_STEPS)]
    for port in ports:
        for k in keys:
            assert_model_ulps(port[f"{case}/{k}"], jax_rec[f"{case}/{k}"],
                              MODEL_ULPS)
            np.testing.assert_array_equal(port[f"{case}/{k}"],
                                          ports[0][f"{case}/{k}"])


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
    """Tokens as JAX's up to one-ULP ties; a decode step's collectives
    over the model axis, per layer: MLA's wo sum and the gathers of the
    latent and the rope key (GSPMD's [B, H, T] gather of the softmax
    weights and its all-to-all are not needed, ``distributed/tp.py``),
    or arctic's MAX and SUM over the T blocks, wo's sum and the gather of
    the query heads; the experts' sum and the shared experts' or the
    dense FFN's sum; then the embedding's sum and the logits' gather."""
    jax_rec, ports = records["jax"], records["port"]
    want = jax_rec[f"{case}/greedy/tokens"]
    n = case_cfg(case).n_layers
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
        ar, ag, _ = port[f"{case}/greedy/step_model"]
        if _mla(case):
            assert (ar, ag) == (3 * n + 1, 2 * n + 1)
        else:
            assert (ar, ag) == (5 * n + 1, n + 1)


def _backward(case: str) -> int:
    """Backward sums over the model axis of a train step: per layer the
    input gradients of wq and, for the latent, of wuk and wuv, the rope
    key's, the router's and the FFN input's, the shared experts' gate and
    up (MLA); or of q, k, v, wk's and wv's weight gradients (whole K/V),
    the router's and the FFN input's, the dense FFN's gate and up
    (arctic); then the head's input gradient."""
    return (8 if _mla(case) else 9) * case_cfg(case).n_layers + 1


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
            for k in ("m", "v"):
                a = port[f"{got}step/{k}{path}"]
                b = _moment_block(case, md,
                                  jax_rec[f"{case}/{md}/step/{k}{path}"],
                                  path, r)
                assert a.shape == b.shape, (k, path, a.shape, b.shape)
                err = float(np.linalg.norm(a - b)
                            / max(np.linalg.norm(b), 1e-30))
                assert err <= MOMENT_RTOL, (md, k, path, r, err)
        if md == "f32":
            np.testing.assert_allclose(port[f"{case}/f32/loss0"],
                                       jax_rec[f"{case}/loss0"],
                                       rtol=LOSS_RTOL)
            for path in _paths(case):
                w = _block(case, jax_rec[f"{case}/grad{path}"], path, r)
                g = port[f"{case}/f32/grad{path}"]
                assert g.shape == w.shape, (path, g.shape, w.shape)
                err = np.linalg.norm(g - w) / np.linalg.norm(w)
                assert err <= GRAD_RTOL, (path, r, err)


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
    """Over the model axis: forward the embedding's sum, per layer wo's,
    the experts' and the shared experts' (or dense FFN's) sums, the
    loss's two; the recompute the loss's two and per layer wo's and the
    experts' sums again (the shared or dense FFN's sum lies past the
    layer's last saved tensor); the backward's (:func:`_backward`); the
    clip norm's sum.  Under bdi8 one all-gather a straddling leaf, its
    gradient for the whole moments."""
    n = case_cfg(case).n_layers
    backward = _backward(case)
    total = (1 + 3 * n + 2) + (2 + 2 * n) + backward + 1
    straddling = {"deepseek": 3, "arctic": 3, "deepseek-2x2": 0}[case]
    for port in records["port"]:
        wide = int(port[f"{case}/{md}/wide"].sum())
        assert wide == (0 if md == "f32" else straddling)
        for i in range(TRAIN_STEPS):
            np.testing.assert_array_equal(
                port[f"{case}/{md}/collectives/{i}"],
                [total, wide, backward])


@pytest.mark.parametrize("md", TILED)
@pytest.mark.parametrize("case", list(CASES))
def test_moment_bytes_equal_jax(records, case, md):
    """After one update from one given state and gradient, every rank's
    bytes of each moment store equal its block of JAX's GSPMD update (in
    JAX's mask layout): the expert stacks' tiles on their E/m experts (and
    FSDP blocks), the straddling leaves' (the shared experts' or the dense
    FFN's gate and up, the head) whole over model."""
    jax_rec, ports = records["jax"], records["port"]
    lay = _layout(case, md)
    straddling = sorted(p for p, (_, w, _) in lay.items() if w)
    assert len(straddling) == {"deepseek": 3, "arctic": 3,
                               "deepseek-2x2": 0}[case], straddling
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


# ---------------------------------------------------------------------------
# the expert-parallel FFN alone: the repairs
# ---------------------------------------------------------------------------

def _ffn_whole(records, case: str) -> dict:
    """Layer 0's FFN without a mesh (rank 0's ``one/`` run)."""
    one = records["port"][0]
    return {k: one[f"one/{case}/ffn/{k}"] for k in ("y", "gx", "grouter")}


def _rows_of(case: str, x: np.ndarray, rank: int) -> np.ndarray:
    d = CASES[case][2][0]
    n = x.shape[0] // d
    r = _coord(case, rank)["data"]
    return x[r * n:(r + 1) * n]


@pytest.mark.parametrize("case", ["deepseek", "arctic"])
def test_expert_sum_has_a_backward_and_is_counted(records, case):
    """Each rank routes through its own experts: the f32 outputs summed
    over ``model`` (counted in ``tp.COUNTS``, beside deepseek's shared
    expert's down sum), and backward the input's and the router's
    gradients summed over ``model`` (counted, each a backward sum; beside
    the shared expert's gate and up input gradients), so that the output
    and both gradients equal the whole FFN's."""
    whole = _ffn_whole(records, case)
    shared = int("shared" in case_params(case)["blocks"]["ffn"])
    for port in records["port"]:
        assert_model_ulps(port[f"{case}/ffn/y"], whole["y"], 1)
        for k in ("gx", "grouter"):
            g, w = port[f"{case}/ffn/{k}"], whole[k]
            assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w), k
        np.testing.assert_array_equal(port[f"{case}/ffn/fwd"],
                                      [1 + shared, 0])
        n = 2 + 2 * shared
        np.testing.assert_array_equal(port[f"{case}/ffn/bwd"],
                                      [n, 0, n, 0, 0, 0])


@pytest.mark.parametrize("case", list(CASES))
def test_expert_parallel_ffn_matches_jax_shard_map(records, case):
    """Layer 0's FFN on each rank against JAX's ``shard_map`` and its
    transpose (``jax.vjp`` under GSPMD), which pins the dtype and the
    order of the backward's sums: the output and the input's gradient
    (each rank's bf16 partial widened, summed over ``model`` in f32,
    rounded once) bit-equal where the routed experts alone make them
    (arctic, whose dense FFN lies outside ``moe_ffn``), within one bf16
    ULP elementwise where the shared expert's sums add to them (their
    order of adds); the router's f32 gradient, summed over ``model`` and
    ``data``, within 1e-6 relative (XLA's and PyTorch's f32 dots and
    sums add in other orders: 2-3e-7 here)."""
    jax_rec = records["jax"]
    for r, port in enumerate(records["port"]):
        for k in ("y", "gx"):
            g = port[f"{case}/ffn/{k}"]
            w = _rows_of(case, jax_rec[f"{case}/ffn/{k}"], r)
            assert g.shape == w.shape, (k, r)
            if case == "arctic":
                np.testing.assert_array_equal(g, w, err_msg=k)
            gap = np.abs(g - w) - _ulp(np.maximum(np.abs(g), np.abs(w)))
            assert (gap <= 0).all(), (k, r, float(gap.max()))
        g, w = port[f"{case}/ffn/grouter"], jax_rec[f"{case}/ffn/grouter"]
        assert np.linalg.norm(g - w) <= 1e-6 * np.linalg.norm(w), r


def test_split_rows_are_routed_as_they_are(records):
    """Under a data axis each rank's FFN takes its rows as they are and
    returns them (JAX's ``in_specs=P(dp, None)``): equal to those rows of
    the whole FFN's output, the input's gradient those rows' too; forward
    nothing is gathered over ``data`` but the three expert stacks' FSDP
    blocks; backward the router's gradient is summed over ``model`` and
    over ``data`` (a replicated leaf's) and equals the whole's."""
    case = "deepseek-2x2"
    whole = _ffn_whole(records, case)
    for r, port in enumerate(records["port"]):
        assert_model_ulps(port[f"{case}/ffn/y"],
                          _rows_of(case, whole["y"], r), 1)
        g, w = port[f"{case}/ffn/gx"], _rows_of(case, whole["gx"], r)
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w)
        gr, wr = port[f"{case}/ffn/grouter"], whole["grouter"]
        assert np.linalg.norm(gr - wr) <= GRAD_RTOL * np.linalg.norm(wr)
        np.testing.assert_array_equal(port[f"{case}/ffn/fwd"], [2, 3])
        # model: the input's, the router's, the shared gate's and up's
        # input gradients; data: the router's
        np.testing.assert_array_equal(port[f"{case}/ffn/bwd"],
                                      [4, 0, 4, 1, 0, 1])


def test_shared_experts_come_from_the_ranks_shard(records):
    """A rank holds its columns of the shared expert's gate and up and its
    rows of its down (``local_params``) and ``moe_ffn`` runs them as they
    are, with no second cut: the FFN's output equals the whole's."""
    case = "deepseek"
    cfg = case_cfg(case)
    f = cfg.n_shared_experts * cfg.d_ff_expert // CASES[case][2][1]
    whole = _ffn_whole(records, case)
    for r, port in enumerate(records["port"]):
        gate = port[f"{case}/shard{FFN}['shared']['gate']['w']"]
        down = port[f"{case}/shard{FFN}['shared']['down']['w']"]
        assert gate.shape[-1] == down.shape[-2] == f
        assert_model_ulps(port[f"{case}/ffn/y"], whole["y"], 1)


def test_capacity_drops_happen_and_match(records):
    """At arctic's own capacity factor of 1.25 the first batch drops
    tokens in every layer, which changes the loss against a dropless
    capacity; the mesh routes and drops exactly as one device (its loss,
    logits and tokens are held to JAX's and to the m = 1 run above)."""
    one = records["port"][0]
    drops = one["one/arctic/drops"]
    assert len(drops) == case_cfg("arctic").n_layers and (drops > 0).all()
    assert one["one/arctic/drops/loss"] != one["one/arctic/drops/dropless"]


# ---------------------------------------------------------------------------
# shapes alone (abstract meshes: no collective runs)
# ---------------------------------------------------------------------------

PRODUCTION = {"deepseek-v2-lite-16b": ("['blocks']['ffn']['shared']['gate']"
                                        "['w']", "['blocks']['ffn']['shared']"
                                        "['up']['w']"),
              "arctic-480b": ("['blocks']['dense_ffn']['gate']['w']",
                              "['blocks']['dense_ffn']['up']['w']",
                              "['lm_head']['w']")}


@pytest.mark.parametrize("arch", list(PRODUCTION))
def test_production_mesh_takes_the_moe_decoders(arch):
    """JAX's dry run lays every cell out on ``(16, 16)``.  On an abstract
    mesh of that shape the port takes deepseek-v2-lite-16b and
    arctic-480b (``tp.check_layout``; ``tp.check_moments`` under every
    moment dtype: under bdi8/q8 the tiles of the shared experts' or the
    dense FFN's gate and up straddle the shards, and arctic's head's),
    and each rank's blocks of the params (the expert stacks split over E,
    FSDP over D; a rank that draws them keeps the same) and of the decode
    cache (32 rows of 4096 positions, 2 a data rank: the latent split
    over its last dim, or arctic's cache over T) have the shapes of JAX's
    specs.  The clip norm sums the experts' squares over ``model`` and
    counts the router's, wdkv's, wkr's and kv_norm's once.
    ``optim/adamw.plan`` takes the moments under every moment dtype
    (straddles over ``data`` included).  At 4 of deepseek's 27 layers and
    2 of arctic's 35 (the meta init draws every expert), where the expert
    stacks are FSDP blocks already (92 MB and 1.1 GB a model shard)."""
    from jax.sharding import AbstractMesh
    from repro.configs.registry import get_arch as jax_arch
    from repro.distributed import sharding as JSH
    from repro.models import transformer as JT
    from repro.models.api import get_model as jax_model
    depth = {"deepseek-v2-lite-16b": 4, "arctic-480b": 2}[arch]
    cfg = dataclasses.replace(get_arch(arch), n_layers=depth)
    jcfg = dataclasses.replace(jax_arch(arch), n_layers=depth)
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
    with AX.use_mesh(mesh):
        tp.check_layout(cfg)
        whole = T.init_params(cfg, torch.Generator(), "meta")
        coord = {"data": 3, "model": 5}
        local = SH.local_params(whole, mesh, coord=coord, fsdp=True)
        drawn = T.init_params(cfg, torch.Generator(), "meta",
                              local=SH.Local(mesh, coord, fsdp=True,
                                             layers=depth))
        assert [t.shape for t in P.leaves(drawn)] == \
            [t.shape for t in P.leaves(local)]
        jlike = jax.eval_shape(jax_model(jcfg).init, jax.random.PRNGKey(0))
        assert [tuple(t.shape) for t in P.leaves(local)] == blocks(
            jlike, JSH.param_specs(jlike, jmesh, fsdp=True))
        stacks = {k: v["w"].shape for k, v in
                  local["blocks"]["ffn"]["experts"].items()}
        e, d = cfg.n_experts // 16, cfg.d_model // 16
        assert stacks == {"gate": (depth, e, d, cfg.d_ff_expert),
                          "up": (depth, e, d, cfg.d_ff_expert),
                          "down": (depth, e, cfg.d_ff_expert, d)} or \
            stacks["down"] == (depth, e, cfg.d_ff_expert // 16,
                               cfg.d_model), stacks
        paths = [p for p, _ in store.leaf_paths(local)]
        split = dict(zip(paths, tp.sharded_leaves(whole, local)))
        for p, s in split.items():
            if "['experts']" in p:
                assert s, p
            if any(k in p for k in ("['router']", "['wdkv']", "['wkr']",
                                    "['kv_norm']")):
                assert not s, p
        for md in AW.MOMENT_DTYPES:
            wide = {p for p, w in zip(paths, tp.check_moments(local, md))
                    if w}
            assert wide == (set(PRODUCTION[arch]) if md in TILED
                            else set()), (md, wide)
            AW.plan(local, whole, AdamWConfig(moment_dtype=md))
        caches = [(T.init_cache(cfg, 2, 4096, device="meta"),
                   jax.eval_shape(lambda: JT.init_cache(jcfg, 32, 4096)))]
        if cfg.attn_kind == "gqa":
            caches.append((
                T.init_quant_cache(cfg, 2, 4096, device="meta"),
                jax.eval_shape(lambda: JT.init_quant_cache(jcfg, 32, 4096))))
        for port, jc in caches:
            assert [tuple(t.shape) for t in port] == blocks(
                jc, JSH.cache_specs(jc, jmesh))
