"""Leaves and decode caches that JAX's rule table keeps whole over the
model axis: the port vs JAX's GSPMD program on the CPU.

The rule table decides each leaf by its own dims: where a dim does not
divide the model axis it drops ``model`` from it.  A dense MLP whose d_ff
does not divide m keeps gate, up and down whole (``tp.Whole``: the plain
MLP on every rank, no sum; under the sequence-parallel stream on the
rank's S block, each weight gradient summed over ``model``), and
``cache_specs`` splits a decode cache at its KV heads, else its rows of T
(or a ring's window), else its head dim, else keeps it whole.  The port
lays out the same (``distributed/tp.new_cache``: each leaf's split;
``models/attention.py``: ``attend_rows``, ``attend_dh``,
``attend_whole``).  JAX places params with ``param_shardings`` and pins
every cache to ``cache_specs`` with ``out_shardings``, as its dry run
does.

Cases (reduced configs, 4 rows; the train batch 4 x 20, which 4 and 5
divide, so that the sequence-parallel stream splits):

* ``yi-6b-dh``: d_ff 90, one KV head, on ``(1, 4)``: the MLP whole, K/V
  whole, a cache of 7 rows split over its head dim (16 / 4);
* ``yi-6b-whole``: the same at d_model 40 (head dim 10): the cache of 7
  rows whole on every rank;
* ``hymba``: hymba-1.5b at 5 heads and 5 KV heads, d_model 40, d_ff 72,
  on ``(1, 5)``: heads, KV heads and Mamba's channels split, the MLP and
  the vocabulary whole, a prompt past the window (the rings wrap);
* ``yi-6b-2x2``: d_model 128, d_ff 91, one KV head on ``(2, 2)``, each
  side's ``FSDP_THRESHOLD_BYTES`` lowered to 4 KiB (test-only): FSDP
  blocks of the whole MLP's leaves, the cache over its head dim (32 / 2).

Two port process groups (gloo over a ``FileStore`` in the test's
temporary directory), of four ranks (the ``(1, 4)`` cases, then the
``(2, 2)`` one on a second mesh) and of five, and a JAX process a group
(``XLA_FLAGS=--xla_force_host_platform_device_count=N
--xla_allow_excess_precision=false``), all started at once; rank 0 of
each group also runs its cases without a mesh, the port's m = 1
reference.  The params are the port's init from seed 0, restored by the
JAX store; JAX's ``_pow2_scale`` is swapped for the exact construction
(test-only).

Tolerances (``tests/test_torch_tp_replicated.py``'s and
``tests/test_torch_tp_families.py``'s, for the same reasons):

* bit for bit: ``local_shards`` of the params against JAX's addressable
  shards; each rank's quantised cache blocks, and the dense GQA
  decoders' dense ones, against JAX's (the other families' within 2 bf16
  ULPs of each leaf's largest |value|, as ``tests/test_torch_tp_
  families.py`` and ``test_torch_tp_moe.py`` hold them: ``EXACT_CACHE``);
* prefill, teacher-forced decode and quantised decode logits: within 2
  bf16 ULPs of the array's largest |value|, against JAX's and against the
  port's m = 1 run; greedy tokens equal to JAX's loop up to one-ULP ties;
* one bdi8 train step, with and without the sequence-parallel stream
  (JAX's ``set_sp``): the loss rtol 1e-4, the gradients within a relative
  Frobenius error of 1e-2, the params after it at least 98% of each leaf
  within one bf16 ULP of JAX's, the loaded moments within 2e-2; Mamba's
  leaves, whose m = 1 run differs from JAX's already (the scan's f32
  exp/log1p), add the m = 1 run's own distance from JAX.
"""

import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

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
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim import adamw as AW
from repro_torch.serving.parity import GreedyParity
from test_torch_decode import _ulp, assert_model_ulps, exact_pow2_scale

REPO = Path(__file__).resolve().parents[1]
REAL = SH.FSDP_THRESHOLD_BYTES
YI = {"d_ff": 90, "n_kv_heads": 1}
DS = {"n_experts": 4, "n_heads": 6, "kv_lora_rank": 18, "qk_rope_dim": 6}


class Case(NamedTuple):
    arch: str
    kw: dict                 # reduced() overrides
    mesh: tuple              # (data, model)
    split: dict              # cache field -> the dim it is split at
    prompt: int = 4
    steps: int = 3           # the cache holds prompt + steps rows
    frames: int = 0          # the encoder's, serving
    a2a: int = 0             # all-to-alls a decode step
    writes: int = 0          # rows written into one rank's T block a step
    threshold: int = REAL    # FSDP_THRESHOLD_BYTES (test-only)


CASES = {
    "yi-6b-dh": Case("yi-6b", YI, (1, 4), {"full_k": 4}, a2a=2),
    "yi-6b-whole": Case("yi-6b", {**YI, "d_model": 40}, (1, 4),
                        {"full_k": None}),
    "yi-6b-2x2": Case("yi-6b", {**YI, "d_model": 128, "d_ff": 91}, (2, 2),
                      {"full_k": 4}, a2a=2, threshold=4 << 10),
    "hymba": Case("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5,
                                 "d_model": 40, "d_ff": 72}, (1, 5),
                  {"full_k": 3, "ring_k": 3, "ssm_h": 2}, prompt=10),
    "hymba-35": Case("hymba-1.5b", {"d_model": 35}, (1, 4),
                     {"full_k": 4, "ring_k": 2, "ssm_h": 3, "conv": None},
                     prompt=10, a2a=1, writes=2),
    "xlstm": Case("xlstm-350m", {"n_heads": 3, "d_model": 48, "n_layers": 4,
                                 "slstm_every": 2}, (1, 2),
                  {"mC": 3, "mn": 3, "mm": None, "sh": 2}),
    "deepseek": Case("deepseek-v2-lite-16b", DS, (1, 4),
                     {"mla_c": None, "mla_kr": None}),
    "deepseek-rows": Case("deepseek-v2-lite-16b", DS, (1, 4),
                          {"mla_c": 2, "mla_kr": 2}, prompt=5, writes=4),
    "seamless": Case("seamless-m4t-large-v2", {"n_kv_heads": 2}, (1, 4),
                     {"self_k": 4, "cross_k": 2}, frames=8, a2a=2),
    "seamless-dh": Case("seamless-m4t-large-v2", {"n_kv_heads": 2}, (1, 4),
                        {"self_k": 4, "cross_k": 4}, frames=6, a2a=4)}
# the port's process groups and JAX's processes: (world, cases), started
# together (the JAX compiles are most of the time)
PORT_JOBS = ((4, ("yi-6b-dh", "yi-6b-whole", "yi-6b-2x2", "hymba-35")),
             (4, ("deepseek", "deepseek-rows", "seamless", "seamless-dh")),
             (5, ("hymba",)), (2, ("xlstm",)))
JAX_JOBS = ((4, ("yi-6b-dh",)), (4, ("yi-6b-whole",)), (4, ("yi-6b-2x2",)),
            (4, ("hymba-35",)), (4, ("seamless",)), (4, ("seamless-dh",)),
            (4, ("deepseek", "deepseek-rows")), (5, ("hymba",)),
            (2, ("xlstm",)))
BATCH = 4
SHAPE = ShapeConfig("t", 20, BATCH, "train")
MD = "bdi8"
MODEL_ULPS = 2
LOSS_RTOL, GRAD_RTOL, BIAS_GRAD_RTOL = 1e-4, 1e-2, 2e-2
ULP_SHARE, MOMENT_RTOL = 0.98, 2e-2
SCANNED = ("['blocks']['mamba']", "['blocks']['slstm']")
# the cases whose dense decode caches equal JAX's bit for bit; the others
# are held within 2 bf16 ULPs of each leaf's largest |value|, as
# tests/test_torch_tp_families.py and test_torch_tp_moe.py hold them:
# the time scans' f32 exp/log1p differ from XLA's by f32 ULPs already at
# m = 1 (hymba's Mamba state and the K/V projected from the stream it
# feeds, xlstm's recurrent states), and the MoE layer's and the encoder's
# sums, whose f32 order is GSPMD's own, move a later layer's latent or
# the cross K/V by ULPs
EXACT_CACHE = ("yi-6b-dh", "yi-6b-whole", "yi-6b-2x2")


def case_cfg(case: str, package_get_arch=get_arch):
    return package_get_arch(CASES[case].arch).reduced(**CASES[case].kw)


def _rows(case: str) -> int:
    return CASES[case].prompt + CASES[case].steps


def _world(case: str) -> int:
    return int(np.prod(CASES[case].mesh))


def case_frames(case: str) -> np.ndarray | None:
    """The encoder's frames for serving (f32, seed 4), or None."""
    n = CASES[case].frames
    if not n:
        return None
    rng = np.random.default_rng(4)
    return (rng.standard_normal((BATCH, n, case_cfg(case).d_model))
            * 0.02).astype(np.float32)


class threshold:
    """``FSDP_THRESHOLD_BYTES`` of ``module`` (the port's rule table, or
    JAX's) set to a case's for a while (test-only)."""

    def __init__(self, case: str, module=SH):
        self.module, self.value = module, CASES[case].threshold

    def __enter__(self):
        self.prev = self.module.FSDP_THRESHOLD_BYTES
        self.module.FSDP_THRESHOLD_BYTES = self.value

    def __exit__(self, *exc):
        self.module.FSDP_THRESHOLD_BYTES = self.prev


class sp:
    """``axes.set_sp`` of a package for a while (process-wide in both)."""

    def __init__(self, on: bool, module=AX):
        self.module, self.on = module, on

    def __enter__(self):
        self.prev = self.module.SP_ENABLED
        self.module.set_sp(self.on)

    def __exit__(self, *exc):
        self.module.set_sp(self.prev)


def case_params(case: str) -> dict:
    return get_model(case_cfg(case)).init(torch.Generator().manual_seed(0),
                                          "cpu")


def case_tokens(case: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    return rng.integers(1, case_cfg(case).vocab, (BATCH, _rows(case))
                        ).astype(np.int32)


def train_batch(cfg) -> dict:
    return TP.make_train_batch(cfg, SHAPE, TP.DataConfig(seed=2), step=0)


def _quant(cfg) -> bool:
    return cfg.family not in ("ssm", "hybrid") and not cfg.is_encdec \
        and cfg.attn_kind == "gqa" and not T.cache_slots(cfg)[2][1]


def _np(t) -> np.ndarray:
    """A tensor or array as numpy: bf16 as its int16 bits."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t.view(torch.int16).numpy().copy() \
            if t.dtype == torch.bfloat16 else t.numpy().copy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _bits_f32(a: np.ndarray) -> np.ndarray:
    """An array of :func:`_np` (bf16 as int16 bits) as f32 values."""
    if a.dtype == np.int16:
        return torch.from_numpy(a).view(torch.bfloat16).float().numpy()
    return a


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the port: one rank (or no mesh)
# ---------------------------------------------------------------------------

def _local_rows(t: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(t)
    mesh = AX.current_mesh()
    return t if mesh is None else SH.local_batch({"t": t}, mesh)["t"]


def port_serve(case: str, params: dict) -> dict:
    cfg = case_cfg(case)
    model = get_model(cfg)
    c = CASES[case]
    toks = case_tokens(case)
    frames = case_frames(case)
    batch = {"tokens": _local_rows(toks[:, :c.prompt])}
    if frames is not None:
        batch["enc_embeds"] = _local_rows(frames)
    out = {}
    logits, cache = model.prefill(params, batch, _rows(case))
    out["logits/0"] = _f32(logits)
    for i in range(c.steps):
        logits, cache = model.decode_step(
            params, cache, _local_rows(toks[:, c.prompt + i]), c.prompt + i)
        out[f"logits/{i + 1}"] = _f32(logits)
    out["split"] = np.asarray([-1 if tp.split_dim(t) is None
                               else tp.split_dim(t) for t in cache])
    for path, leaf in store.leaf_paths(cache):
        out[f"cache{path}"] = _np(leaf)
    if _quant(cfg):
        qc = T.init_quant_cache(cfg, _local_rows(toks).shape[0], _rows(case),
                                device="cpu")
        for t in range(_rows(case)):
            logits, qc = T.decode_step_quant(cfg, params, qc,
                                             _local_rows(toks[:, t]), t)
            out[f"quant/logits/{t}"] = _f32(logits)
        for path, leaf in store.leaf_paths(qc):
            out[f"quant/cache{path}"] = _np(leaf)
    g = dense_generate(cfg, params, torch.from_numpy(toks[:, :c.prompt]),
                       c.steps, keep_logits=True,
                       enc_embeds=None if frames is None
                       else torch.from_numpy(frames))
    out["greedy/tokens"] = np.asarray(g["tokens"])
    out["greedy/logits"] = g["logits"].numpy()
    out["greedy/step_model"] = np.asarray(
        [g["collectives"]["per_step"]["model"][k]
         for k in ("all_to_all", "writes")])
    return out


def port_train(case: str, params: dict, whole: dict | None,
               on: bool) -> dict:
    """The loss and gradients of the batch, then one bdi8 step from the
    zero state, with the sequence-parallel stream where ``on``."""
    cfg = case_cfg(case)
    model = get_model(cfg)
    ocfg = AdamWConfig(moment_dtype=MD)
    params = P.tree_map(torch.clone, params)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    out = {}
    with sp(on):
        flat = [t.requires_grad_() for t in P.leaves(params)]
        b = batch if tp.data_size() == 1 else SH.local_batch(
            batch, AX.current_mesh())
        loss = model.loss(params, b)
        with ThreadPoolExecutor(1) as pool:    # a thread with no mesh
            grads = pool.submit(torch.autograd.grad, loss, flat,
                                allow_unused=True).result()
        for t in flat:
            t.requires_grad_(False)
        out["loss"] = np.float32(float(loss.detach()))
        for (path, t), g in zip(store.leaf_paths(params), grads):
            out[f"grad{path}"] = _f32(torch.zeros_like(t) if g is None
                                      else g)
        state = adamw_init(params, ocfg, whole=whole)
        params, state, met = make_train_step(model, ocfg)(params, state,
                                                          batch)
    out["step/loss"] = np.float32(met["loss"])
    for path, p in store.leaf_paths(params):
        out[f"step/param{path}"] = _f32(p)
    for k in ("m", "v"):
        for (path, _), st in zip(store.leaf_paths(params),
                                 AW._store_leaves(state[k])):
            shape = st["deltas"].shape[:-2] + (
                st["deltas"].shape[-2] * 128,) if isinstance(st, dict) \
                else st.shape
            out[f"step/{k}{path}"] = _f32(AW._load(st, shape))
    return out


def port_case(case: str, mesh) -> dict:
    full = case_params(case)
    out = {}
    with threshold(case):
        if mesh is None:
            local, whole = full, None
        else:
            local = SH.local_params(full, mesh,
                                    fsdp=CASES[case].threshold != REAL)
            whole = get_model(case_cfg(case)).init(torch.Generator(), "meta")
            for path, leaf in store.leaf_paths(local):
                out[f"shard{path}"] = _np(leaf)
        out.update(port_serve(case, local))
        for on in (False, True):
            out.update({f"sp{int(on)}/{k}": v for k, v in
                        port_train(case, local, whole, on).items()})
    return {f"{case}/{k}": v for k, v in out.items()}


def port_rank(job: int, rank: int, work: str) -> None:
    """Entry of one port rank of ``PORT_JOBS[job]``: its cases in turn,
    each on its mesh, into ``work/port_<job>_<rank>.npz``; rank 0 then
    runs them without a mesh (``one/`` keys)."""
    import torch.distributed as dist
    world, cases = PORT_JOBS[job]
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, f"rendezvous_{job}"), world), rank=rank,
        world_size=world)
    out = {}
    try:
        for shape in dict.fromkeys(CASES[c].mesh for c in cases):
            mesh = make_host_mesh(*shape, device="cpu")
            with AX.use_mesh(mesh):
                for case in cases:
                    if CASES[case].mesh == shape:
                        out.update(port_case(case, mesh))
    finally:
        destroy_mesh()
    if rank == 0:
        for case in cases:
            out.update({f"one/{k}": v
                        for k, v in port_case(case, None).items()})
    np.savez(os.path.join(work, f"port_{job}_{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# JAX: one process a job, its host devices
# ---------------------------------------------------------------------------

def jax_case(case: str, work: str, out: dict) -> None:
    """One case on its mesh under GSPMD: params placed by
    ``param_shardings``, batches by ``batch_specs``, every cache pinned
    to ``cache_specs``."""
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.distributed import axes as JAX_AX
    from repro.distributed import sharding as JSH
    from repro.distributed.axes import use_mesh
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models import transformer as JT
    from repro.models.api import get_model as jax_model
    from repro.optim import adamw as JO
    c = CASES[case]
    fsdp = c.threshold != REAL
    mesh = jmesh(*c.mesh)
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
        jcfg = case_cfg(case, jax_arch)
        jm = jax_model(jcfg)
        like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        psh = JSH.param_shardings(like, mesh, fsdp=fsdp)
        params = jstore.restore(os.path.join(work, "params", case), like,
                                target_shardings=psh)[0]
        shards("shard", params)
        toks = case_tokens(case)
        rows = _rows(case)
        batch = {"tokens": put_rows(toks[:, :c.prompt])}
        if c.frames:
            batch["enc_embeds"] = put_rows(case_frames(case))
        cache_like = jax.eval_shape(lambda p, b: jm.prefill(p, b, rows),
                                    params, batch)[1]
        csh = named(JSH.cache_specs(cache_like, mesh))
        prefill = jax.jit(jm.prefill, static_argnums=2,
                          out_shardings=(None, csh), compiler_options=opts)
        step = jax.jit(jm.decode_step, out_shardings=(None, csh),
                       compiler_options=opts)
        logits, cache = prefill(params, batch, rows)
        out[f"{case}/logits/0"] = _f32(logits)
        for i in range(c.steps):
            logits, cache = step(params, cache,
                                 put_rows(toks[:, c.prompt + i]),
                                 jnp.int32(c.prompt + i))
            out[f"{case}/logits/{i + 1}"] = _f32(logits)
        shards("cache_shard", cache)
        if _quant(case_cfg(case)):
            qc = JT.init_quant_cache(jcfg, BATCH, rows)
            qsh = named(JSH.cache_specs(qc, mesh))
            qc = jax.device_put(qc, qsh)
            qstep = jax.jit(lambda p, c, tok, t: JT.decode_step_quant(
                jcfg, p, c, tok, t), out_shardings=(None, qsh),
                compiler_options=opts)
            for t in range(rows):
                logits, qc = qstep(params, qc, put_rows(toks[:, t]),
                                   jnp.int32(t))
                out[f"{case}/quant/logits/{t}"] = _f32(logits)
            shards("quant_shard", qc)
        # greedy, as dense_generate: the prompt only
        logits, cache = prefill(params, batch, rows)
        tok = jnp.argmax(logits, -1)
        got, kept = [tok], [_f32(logits)]
        for t in range(c.prompt, rows - 1):
            logits, cache = step(params, cache, put_rows(tok), jnp.int32(t))
            tok = jnp.argmax(logits, -1)
            got.append(tok)
            kept.append(_f32(logits))
        out[f"{case}/greedy/tokens"] = np.stack([np.asarray(t) for t in got],
                                                1)
        out[f"{case}/greedy/logits"] = np.stack(kept)
        # the loss, its gradients and one bdi8 update, with and without
        # the sequence-parallel stream
        ocfg = JO.AdamWConfig(moment_dtype=MD)
        state = JO.adamw_init(params, ocfg)
        osh = JSH.param_shardings(state, mesh, fsdp=fsdp)
        state = jax.device_put(state, osh)
        tb = {k: put_rows(v) for k, v in train_batch(jcfg).items()}

        def both(params, state, batch):
            loss, grads = jax.value_and_grad(jm.loss)(params, batch)
            p2, s2, _ = JO.adamw_update(params, grads, state, ocfg)
            return loss, grads, p2, s2
        for on in (False, True):
            with sp(on, JAX_AX):
                loss, grads, p2, s2 = jax.jit(
                    both, out_shardings=(None, psh, psh, osh),
                    compiler_options=opts)(params, state, tb)
            pre = f"{case}/sp{int(on)}"
            out[f"{pre}/loss"] = np.float32(loss)
            for k, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
                out[f"{pre}/grad{jax.tree_util.keystr(k)}"] = _f32(g)
            trees = {"param": p2, **{k: jax.tree.map(
                lambda p, s: JO._load(s, MD, p.shape), params, s2[k])
                for k in ("m", "v")}}
            for key, tree in trees.items():
                for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    out[f"{pre}/step/{key}{jax.tree_util.keystr(k)}"] = \
                        _f32(leaf)


def jax_job(job: int, work: str) -> None:
    """Entry of a JAX process: the cases of ``JAX_JOBS[job]``, into
    ``work/jax_<job>.npz``."""
    from repro.core import bdi_value as jbv
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    world, cases = JAX_JOBS[job]
    assert len(jax.devices()) == world
    out = {}
    for case in cases:
        jax_case(case, work, out)
    np.savez(os.path.join(work, f"jax_{job}.npz"), **out)


# ---------------------------------------------------------------------------
# the fixture: all processes at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax": npz of every job, "port": {case: [npz of each rank]}}."""
    work = tmp_path_factory.mktemp("tp_whole")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tp_whole as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    procs = []
    for job, (world, _) in enumerate(JAX_JOBS):
        jenv = dict(env, XLA_FLAGS=(
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={world}"
            + " --xla_allow_excess_precision=false").strip())
        procs.append(start(f"jax_job({job}, {str(work)!r})", jenv))
    for job, (world, _) in enumerate(PORT_JOBS):
        procs += [start(f"port_rank({job}, {r}, {str(work)!r})", env)
                  for r in range(world)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * len(procs), rcs
    jax_rec, port = {}, {}
    for job in range(len(JAX_JOBS)):
        jax_rec.update(np.load(work / f"jax_{job}.npz"))
    for job, (world, cases) in enumerate(PORT_JOBS):
        ranks = [dict(np.load(work / f"port_{job}_{r}.npz"))
                 for r in range(world)]
        for case in cases:
            port[case] = ranks
    return {"jax": jax_rec, "port": port}


def _mesh(case: str):
    return EL.abstract_mesh(CASES[case].mesh, ("data", "model"))


def _coord(case: str, rank: int) -> dict:
    m = CASES[case].mesh[1]
    return {"data": rank // m, "model": rank % m}


def _paths(case: str) -> list[str]:
    return [p for p, _ in store.leaf_paths(case_params(case))]


def _block(case: str, whole: np.ndarray, path: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole params-shaped array (its spec under
    the rule table, FSDP where the case lowers the threshold)."""
    with threshold(case):
        spec = SH._spec_for(path, whole.shape, _mesh(case), 2,
                            CASES[case].threshold != REAL)
    return SH.local_shards({"x": torch.from_numpy(whole)}, {"x": spec},
                           _mesh(case), coord=_coord(case, rank))["x"].numpy()


@functools.lru_cache(maxsize=None)
def _layout(case: str) -> dict:
    """By param path, on the abstract mesh from shapes alone: (the
    param's spec, whether its moment tiles straddle the model shards,
    the dim whose block the rank owns of its moments, or -1)."""
    cfg = case_cfg(case)
    mesh = _mesh(case)
    fsdp = CASES[case].threshold != REAL
    with threshold(case), AX.use_mesh(mesh):
        whole = get_model(cfg).init(torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord=_coord(case, 0),
                                fsdp=fsdp)
        wide = tp.check_moments(local, MD)
        lay = AW.plan(local, whole, AdamWConfig(moment_dtype=MD)) \
            or [None] * len(wide)
        specs = {path: SH._spec_for(path, tuple(t.shape), mesh,
                                    t.element_size(), fsdp)
                 for path, t in store.leaf_paths(whole)}
    return {path: (specs[path], w,
                   -1 if x is None or x.owner is None else x.owner)
            for (path, _), w, x in zip(store.leaf_paths(whole), wide, lay)}


def _moment_block(case: str, whole: np.ndarray, path: str,
                  rank: int) -> np.ndarray:
    """What rank ``rank`` keeps of a whole loaded moment leaf: its param
    block, whole over model where the tiles straddle, its 1/d along the
    dim it owns (``adamw.plan``: a ZeRO-1 leaf's, or another dim's where
    the tiles would straddle the param's data blocks) in place of the
    param's data split."""
    spec, wide, owner = _layout(case)[path]
    spec = list(spec)
    if wide:
        spec[-1] = None
    if owner >= 0:
        spec = [s if s == "model" else None for s in spec]
    x = SH.local_shards({"x": torch.from_numpy(whole)}, {"x": SH.P(*spec)},
                        _mesh(case), coord=_coord(case, rank))["x"].numpy()
    if owner >= 0:
        d = CASES[case].mesh[0]
        n = x.shape[owner] // d
        x = np.take(x, range(_coord(case, rank)["data"] * n,
                             (_coord(case, rank)["data"] + 1) * n),
                    axis=owner)
    return x


def _share(a: np.ndarray, b: np.ndarray) -> float:
    """The share of ``a``'s elements within one bf16 ULP of ``b``'s."""
    gap = np.abs(a - b) - _ulp(np.maximum(np.abs(a), np.abs(b)))
    return float((gap <= 0).mean())


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_each_leaf_is_laid_out_by_its_own_dims(case):
    """On the abstract mesh, from shapes alone: ``tp.check_layout`` takes
    the config; the leaves ``tp.placed`` keeps whole over ``model`` are
    those whose rule-table spec names the model axis only at dims that do
    not divide it; the decode cache's leaves are split where
    ``cache_specs`` splits them (``Case.split``)."""
    cfg = case_cfg(case)
    model = get_model(cfg)
    mesh = _mesh(case)
    m = CASES[case].mesh[1]
    kw = {"enc_len": CASES[case].frames} if cfg.is_encdec else {}
    with threshold(case), AX.use_mesh(mesh):
        tp.check_layout(cfg)
        whole = model.init(torch.Generator(), "meta")
        local = SH.local_params(whole, mesh, coord=_coord(case, 0),
                                fsdp=CASES[case].threshold != REAL)
        kept = set(tp.model_whole(tp.placement(whole, local)))
        cache = model.init_cache(BATCH // CASES[case].mesh[0], _rows(case),
                                 device="meta", **kw)
        split = {f: tp.split_dim(getattr(cache, f))
                 for f in CASES[case].split}
    want = set()
    for path, t in store.leaf_paths(whole):
        tpl = SH.rule_template(path)
        dims = [len(t.shape) - len(tpl) + i for i, a in enumerate(tpl)
                if a == "m"]
        if dims and all(t.shape[d] % m for d in dims):
            want.add(path)
    assert kept == want and kept
    assert split == CASES[case].split


@pytest.mark.parametrize("case", list(CASES))
def test_shards_and_cache_blocks_equal_jax(records, case):
    """Params: each rank's ``local_shards`` equal its device's shard of
    JAX's; the decode cache after prefill and the decode steps, and the
    quantised cache, equal each device's shard of JAX's cache pinned to
    ``cache_specs``, bit for bit, in the layout ``Case.split`` names."""
    jax_rec, ports = records["jax"], records["port"][case]
    for r in range(_world(case)):
        port = ports[r]
        for path in _paths(case):
            got, want = port[f"{case}/shard{path}"], \
                jax_rec[f"{case}/shard/{r}{path}"]
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (path, r)
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {r}")
        for prefix, shard in (("cache", "cache_shard"),
                              ("quant/cache", "quant_shard")):
            keys = [k for k in port if k.startswith(f"{case}/{prefix}")]
            assert keys or prefix == "quant/cache"
            for k in keys:
                path = k[len(f"{case}/{prefix}"):]
                want = jax_rec[f"{case}/{shard}/{r}{path}"]
                if case not in EXACT_CACHE and prefix == "cache":
                    a, b = _bits_f32(port[k]), _bits_f32(want)
                    fin = np.isfinite(b)        # mLSTM's m starts at -inf
                    np.testing.assert_array_equal(a[~fin], b[~fin])
                    assert_model_ulps(np.where(fin, a, 0), np.where(fin, b, 0),
                                      MODEL_ULPS)
                else:
                    np.testing.assert_array_equal(port[k], want,
                                                  err_msg=f"{k} {r}")


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_jax_and_one_rank(records, case):
    """Prefill, teacher-forced decode and quantised decode logits within
    2 bf16 ULPs of JAX's GSPMD program and of the port's m = 1 run; the
    same on every rank."""
    jax_rec, ports = records["jax"], records["port"][case]
    one = ports[0]
    keys = [k[len(case) + 1:] for k in ports[0]
            if k.startswith(f"{case}/") and "logits/" in k
            and "greedy" not in k]
    assert len(keys) >= 1 + CASES[case].steps
    for r in range(_world(case)):
        port = ports[r]
        for k in keys:
            assert_model_ulps(port[f"{case}/{k}"], jax_rec[f"{case}/{k}"],
                              MODEL_ULPS)
            assert_model_ulps(port[f"{case}/{k}"], one[f"one/{case}/{k}"],
                              MODEL_ULPS)
            np.testing.assert_array_equal(port[f"{case}/{k}"],
                                          ports[0][f"{case}/{k}"])


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_jax(records, case):
    """Tokens as JAX's loop up to one-ULP ties.  A decode step all-to-alls
    the context once a layer whose cache is split over its head dim
    (``attention.attend_dh``, where K's blocks and, for split query heads,
    the softmax weights are gathered), and writes each new row on the one
    rank holding it where a cache is split over T (``Case``)."""
    jax_rec, ports = records["jax"], records["port"][case]
    want = jax_rec[f"{case}/greedy/tokens"]
    c = CASES[case]
    writes = 0
    for r in range(_world(case)):
        port = ports[r]
        got = port[f"{case}/greedy/tokens"]
        assert got.shape == want.shape == (BATCH, c.steps)
        rows = torch.from_numpy(port[f"{case}/greedy/logits"])
        ref = torch.from_numpy(jax_rec[f"{case}/greedy/logits"])
        par = GreedyParity()
        for j in range(c.steps):
            par.check(j, {b: int(want[b, j]) for b in range(BATCH)},
                      {b: int(got[b, j]) for b in range(BATCH)},
                      lambda sid, j=j: rows[j, sid],
                      lambda sid, j=j: ref[j, sid])
        assert par.compared >= 0.75 * want.size, par
        a2a, w = port[f"{case}/greedy/step_model"]
        assert a2a == c.a2a
        writes += w
    assert writes == c.writes * c.mesh[0]


@pytest.mark.parametrize("on", [False, True], ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(records, case, on):
    """The loss and gradients of one batch, and one bdi8 step from the
    zero state, against JAX's (``set_sp(on)`` on both sides): each rank's
    blocks of JAX's gradients and of its params and loaded moments after
    the step; a whole leaf's gradient the same on every rank."""
    jax_rec, ports = records["jax"], records["port"][case]
    one = ports[0]
    pre = f"sp{int(on)}"
    kept = None
    for r in range(_world(case)):
        port = ports[r]
        got = f"{case}/{pre}/"
        np.testing.assert_allclose(port[f"{got}loss"],
                                   jax_rec[f"{case}/{pre}/loss"],
                                   rtol=LOSS_RTOL)
        assert port[f"{got}step/loss"] == port[f"{got}loss"]
        for path in _paths(case):
            scanned = path.startswith(SCANNED)
            w = _block(case, jax_rec[f"{case}/{pre}/grad{path}"], path, r)
            g = port[f"{got}grad{path}"]
            assert g.shape == w.shape, (path, g.shape, w.shape)
            bound = BIAS_GRAD_RTOL if path.endswith("['b']") else GRAD_RTOL
            if scanned:
                bound += _rel(_block(case, one[f"one/{got}grad{path}"], path,
                                     r), w)
            assert _rel(g, w) <= bound, (path, r, _rel(g, w), bound)
            a = port[f"{got}step/param{path}"]
            b = _block(case, jax_rec[f"{case}/{pre}/step/param{path}"],
                       path, r)
            want = ULP_SHARE
            if scanned:
                want -= 1 - _share(_block(
                    case, one[f"one/{got}step/param{path}"], path, r), b)
            assert _share(a, b) >= want, (path, r, _share(a, b), want)
            for k in ("m", "v"):
                a = port[f"{got}step/{k}{path}"]
                b = _moment_block(
                    case, jax_rec[f"{case}/{pre}/step/{k}{path}"], path, r)
                assert a.shape == b.shape, (k, path, a.shape, b.shape)
                bound = MOMENT_RTOL
                if scanned:
                    bound += _rel(_moment_block(
                        case, one[f"one/{got}step/{k}{path}"], path, r), b)
                assert _rel(a, b) <= bound, (k, path, r, _rel(a, b), bound)
        if CASES[case].threshold == REAL:
            whole = sorted(p for p, (spec, _, _) in _layout(case).items()
                           if "model" not in spec
                           and "m" in SH.rule_template(p))
            assert whole
            mine = [port[f"{got}grad{p}"] for p in whole]
            kept = kept or mine
            for a, b in zip(mine, kept):
                np.testing.assert_array_equal(a, b)
