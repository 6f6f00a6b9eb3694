"""DP x TP: the port's serving and train step on a ``(d, m)`` mesh vs
JAX's GSPMD program on the same mesh, on the CPU.

The port's dense GQA decoders on ``(2, 2)`` and ``(2, 1)`` meshes laid
out as JAX's dry run lays out every production cell: params by the rule
table with ``fsdp=True`` (``distributed/sharding.local_params``: FSDP
blocks over ``data`` for the leaves above ``FSDP_THRESHOLD_BYTES`` a
model shard), moments at least as split (ZeRO-1, ``optim/adamw.plan``),
batches by ``batch_specs`` (each rank its rows).  Every collective of
both axes goes through ``distributed/tp.py`` over gloo.  JAX places the
same params, states and batches with ``param_shardings(fsdp=True)`` and
``batch_specs`` and runs prefill, decode steps and one jitted train step
(the loss, its gradients and ``adamw_update`` under f32, bf16, bdi8 and
q8 moments), GSPMD inserting its collectives.

One module fixture starts, all at once (``tests/test_torch_tp_train.py``'s
pattern: gloo over a ``FileStore``, each process writing ``.npz``): four
port ranks for the ``(2, 2)`` cases, two for the ``(2, 1)`` case, and a
JAX process a case (its train step's compile is most of a case's time)
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (or 2)
``--xla_allow_excess_precision=false``.  Each side lowers its own
``FSDP_THRESHOLD_BYTES`` before its first spec (a test-only patch of the
module constant, both packages' rule tables reading it at call time), so
that FSDP engages at reduced widths.  Cases:

* ``yi-6b``: reduced yi-6b at d_model 256, d_ff 256, 4/2 heads, vocab
  256, 2 layers, threshold 64 KiB, on ``(2, 2)``: wq, gate and up split
  over data on D, wo and down on their last dim (one moment tile a
  block), wk, wv, the embedding and the head whole over data with their
  f32 moments split (ZeRO-1);
* ``yi-6b-dp``: the same at the real 64 MiB, pure DP x TP;
* ``internvl2-76b``: reduced internvl2-76b with its frontend embeddings,
  d_ff 256, threshold 4 KiB, on ``(2, 2)``;
* ``yi-6b-d2``: the first case on ``(2, 1)``, where every matrix is an
  FSDP block.

Rank 0 of each world also runs every case without a mesh, the port's
own d = m = 1 reference.  The params are the port's init from seed 0,
restored by the JAX store; JAX's ``_pow2_scale`` is swapped for the
exact construction of 2^e (``tests/test_torch_decode.exact_pow2_scale``,
test-only).

Tolerances (those of ``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tp_train.py``, for the same reasons: the port's
partial sums over ranks are f32 sums in another order than XLA's):

* prefill, teacher-forced decode and quantised decode logits (and
  ``forward``'s, against the port's own run): within 2 bf16 ULPs of the
  array's largest |value|; the dense cache's blocks too; the quantised
  cache's blocks bit-equal;
* greedy tokens of ``launch/serve.dense_generate``: equal to JAX's loop
  up to ties that ``serving/parity.GreedyParity`` reports;
* the loss: rtol 1e-4; each gradient block: relative Frobenius error
  <= 1e-2; ``grad_norm``: rtol 1e-3;
* one step from one state under each moment dtype (f32, bf16 and q8 in
  every case, bdi8 in ``yi-6b``'s: its JAX compile is two thirds of a
  case's time): params within one bf16 ULP for at least 99% of each
  block, loaded moments within a relative Frobenius error of 2e-2;
* bit for bit: the placement against JAX's addressable shards, the
  zero state against the blocks of the whole one, the loss and the norm
  on every rank, every block whole over data across the data ranks
  after the step (params, and the moments a rank does not own alone).
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
from repro_torch.launch import elastic as EL
from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
from repro_torch.launch.serve import dense_generate
from repro_torch.launch.train import make_train_step
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init, opt_state_bytes
from repro_torch.optim import adamw as AW
from repro_torch.serving.parity import GreedyParity
from test_torch_decode import _ulp, assert_model_ulps, exact_pow2_scale
from test_torch_train import STEP_MOMENT_RTOL, STEP_ULP_SHARE

REPO = Path(__file__).resolve().parents[1]
YI = {"d_model": 256, "d_ff": 256, "n_heads": 4, "n_kv_heads": 2,
      "vocab": 256}
REAL = SH.FSDP_THRESHOLD_BYTES
# case -> (arch, reduced() overrides, mesh (data, model), FSDP threshold)
CASES = {"yi-6b": ("yi-6b", YI, (2, 2), 64 << 10),
         "yi-6b-dp": ("yi-6b", YI, (2, 2), REAL),
         "internvl2-76b": ("internvl2-76b", {"d_ff": 256}, (2, 2), 4 << 10),
         "yi-6b-d2": ("yi-6b", YI, (2, 1), 64 << 10)}
MESHES = ((2, 2), (2, 1))
DTYPES = ("f32", "bf16", "bdi8", "q8")
BDI8_CASES = ("yi-6b",)         # its JAX compile is ~2/3 of a case's time
BATCH, PROMPT, STEPS, GEN = 4, 8, 4, 5
WHOLE_ROWS = 3                  # prompts that do not divide d (2, 1) case
SHAPE = ShapeConfig("t", 32, 4, "train")
TRAIN_STEPS = 1
LOSS_RTOL, GRAD_RTOL, GNORM_RTOL = 1e-4, 1e-2, 1e-3
MODEL_ULPS = 2


def case_cfg(case: str):
    arch, kw, _, _ = CASES[case]
    return get_arch(arch).reduced(**kw)


def cases_of(shape: tuple) -> list[str]:
    return [c for c, v in CASES.items() if v[2] == shape]


def dtypes_of(case: str) -> tuple:
    """The moment dtypes a case trains under: bdi8 only where
    ``BDI8_CASES`` says (its tiles split over data along D and along the
    last dim), the others everywhere."""
    return tuple(md for md in DTYPES
                 if md != "bdi8" or case in BDI8_CASES)


STEP_CASES = [(c, md) for c in CASES for md in dtypes_of(c)]


class threshold:
    """``SH.FSDP_THRESHOLD_BYTES`` (or JAX's, ``module``) set to a case's
    for a while (test-only)."""

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


def case_inputs(cfg) -> tuple[np.ndarray, np.ndarray | None]:
    """tokens [BATCH, PROMPT + STEPS] and, for a frontend config, embeds
    [BATCH, n, D] (bf16 values as f32)."""
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab, (BATCH, PROMPT + STEPS)).astype(
        np.int32)
    emb = None
    if cfg.n_frontend_embeds:
        emb = (rng.standard_normal((BATCH, cfg.n_frontend_embeds,
                                    cfg.d_model)) * 0.02).astype(np.float32)
        emb = torch.from_numpy(emb).to(torch.bfloat16).float().numpy()
    return toks, emb


def train_batch(cfg) -> list[dict]:
    return [TP.make_train_batch(cfg, SHAPE, TP.DataConfig(seed=2), step=i)
            for i in range(TRAIN_STEPS)]


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


# ---------------------------------------------------------------------------
# the port: one rank (or no mesh)
# ---------------------------------------------------------------------------

def _rows(t: np.ndarray) -> torch.Tensor:
    """This rank's rows of a batch-first array (all of it without a
    mesh)."""
    t = torch.from_numpy(t)
    mesh = AX.current_mesh()
    return t if mesh is None else SH.local_batch({"t": t}, mesh)["t"]


def port_serve(cfg, params: dict, whole_rows: bool) -> dict:
    """Forward, prefill, teacher-forced and quantised decode, and the
    greedy loop of one case on whatever mesh is active (``whole_rows``:
    also the greedy loop of ``WHOLE_ROWS`` prompts)."""
    out = {}
    toks, emb = case_inputs(cfg)
    off = cfg.n_frontend_embeds
    batch = {"tokens": _rows(toks[:, :PROMPT])}
    if emb is not None:
        batch["embeds"] = _rows(emb).to(torch.bfloat16)
    with torch.no_grad():
        out["forward"] = _f32(T.forward(cfg, params, batch))
    logits, cache = T.prefill(cfg, params, batch, off + PROMPT + GEN)
    out["logits/0"] = _f32(logits)
    for i in range(STEPS):
        logits, cache = T.decode_step(cfg, params, cache,
                                      _rows(toks[:, PROMPT + i]),
                                      off + PROMPT + i)
        out[f"logits/{i + 1}"] = _f32(logits)
    for path, leaf in store.leaf_paths(cache):
        out[f"cache{path}"] = _np(leaf)
    qc = T.init_quant_cache(cfg, batch["tokens"].shape[0], STEPS + 2,
                            device="cpu")
    for t in range(STEPS):
        logits, qc = T.decode_step_quant(cfg, params, qc,
                                         _rows(toks[:, t]), t)
        out[f"quant/logits/{t}"] = _f32(logits)
    for path, leaf in store.leaf_paths(qc):
        out[f"quant/cache{path}"] = _np(leaf)
    g = dense_generate(cfg, params, torch.from_numpy(toks[:, :PROMPT]), GEN,
                       keep_logits=True)
    out["greedy/tokens"] = np.asarray(g["tokens"])
    out["greedy/logits"] = g["logits"].numpy()
    for part in ("prefill", "per_step"):
        for axis in tp.AXES:
            out[f"greedy/collectives/{part}/{axis}"] = np.asarray(
                [g["collectives"][part][axis][k]
                 for k in ("all_reduce", "all_gather")])
    if whole_rows:
        w = dense_generate(cfg, params, torch.from_numpy(
            toks[:WHOLE_ROWS, :PROMPT]), GEN, keep_logits=True)
        out["whole_rows/tokens"] = np.asarray(w["tokens"])
        out["whole_rows/logits"] = w["logits"].numpy()
    return out


def _moments(params: dict, state: dict) -> dict:
    """Every moment leaf loaded to f32 (this rank's blocks), keyed
    ``m``/``v`` + the path."""
    return {f"{k}{path}": _f32(AW._load(s, s["deltas"].shape[:-2] + (
                s["deltas"].shape[-2] * 128,) if isinstance(s, dict)
                else s.shape))
            for k in ("m", "v")
            for (path, _), s in zip(store.leaf_paths(params),
                                    AW._store_leaves(state[k]))}


def _state_bits(state: dict) -> dict:
    return {f"{k}{path}": _np(t) for k in ("m", "v")
            for path, t in store.leaf_paths(state[k])}


def port_train(case: str, md: str, params: dict, whole: dict | None
               ) -> dict:
    """One case under one moment dtype on whatever mesh is active: the
    loss and gradients of the first batch, then ``TRAIN_STEPS`` step(s)
    of ``make_train_step`` from the zero state."""
    cfg = case_cfg(case)
    model = get_model(cfg)
    ocfg = AdamWConfig(moment_dtype=md)
    params = P.tree_map(torch.clone, params)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in train_batch(cfg)]
    out = {}
    state = adamw_init(params, ocfg, whole=whole)
    out["state_bytes"] = np.asarray(opt_state_bytes(state, ocfg))
    out.update({f"zero/{k}": v for k, v in _state_bits(state).items()})
    lay = AW.plan(params, whole, ocfg)
    if lay is not None:
        out["owner"] = np.asarray([-1 if leaf.owner is None else leaf.owner
                                   for leaf in lay])
        out["fsdp"] = np.asarray([leaf.data is not None for leaf in lay])
    step = make_train_step(model, ocfg)
    if md == "f32":
        # the gradients of this rank's rows, from a thread with no mesh
        # active (on the card autograd runs the backward on its own)
        flat = [t.requires_grad_() for t in P.leaves(params)]
        b = batches[0] if lay is None else SH.local_batch(
            batches[0], AX.current_mesh())
        loss = model.loss(params, b)
        with ThreadPoolExecutor(1) as pool:
            grads = pool.submit(torch.autograd.grad, loss, flat).result()
        for t in flat:
            t.requires_grad_(False)
        out["loss0"] = np.float32(float(loss))
        for (path, _), g in zip(store.leaf_paths(params), grads):
            out[f"grad{path}"] = _f32(g)
    for i, batch in enumerate(batches):
        params, state, met = step(params, state, batch)
        out[f"loss/{i}"] = np.float32(met["loss"])
        out[f"grad_norm/{i}"] = np.float32(met["grad_norm"])
        for axis in tp.AXES:
            out[f"collectives/{i}/{axis}"] = np.asarray(
                [met["collectives"][axis][k]
                 for k in ("all_reduce", "all_gather", "backward")])
        for path, p in store.leaf_paths(params):
            out[f"bits/{i}/param{path}"] = _np(p)
        out.update({f"bits/{i}/{k}": v
                    for k, v in _state_bits(state).items()})
        if i == 0:
            for path, p in store.leaf_paths(params):
                out[f"step/param{path}"] = _f32(p)
            for k, v in _moments(params, state).items():
                out[f"step/{k}"] = v
    return out


def port_case(case: str, mesh) -> dict:
    cfg = case_cfg(case)
    full = case_params(case)
    out = {}
    with threshold(case):
        if mesh is None:
            local, whole = full, None
        else:
            local = SH.local_params(full, mesh, fsdp=True)
            whole = get_model(cfg).init(torch.Generator(), "meta")
            for path, leaf in store.leaf_paths(local):
                out[f"shard{path}"] = _np(leaf)
            drawn = T.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu",
                local=SH.Local(mesh, fsdp=True, layers=cfg.n_layers))
            out["init_local_equal"] = np.asarray(all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    store.leaf_paths(drawn), store.leaf_paths(local))))
        out.update(port_serve(cfg, local, case == "yi-6b-d2"))
        for md in dtypes_of(case):
            for k, v in port_train(case, md, local, whole).items():
                out[f"{md}/{k}"] = v
    return {f"{case}/{k}": v for k, v in out.items()}


def port_rank(rank: int, shape: tuple, work: str) -> None:
    """Entry of one port rank of a ``shape`` mesh: every case of that
    mesh, into ``work/port_<d><m>_<rank>.npz``; rank 0 then runs the same
    without a mesh (``one/`` keys)."""
    import torch.distributed as dist
    world = shape[0] * shape[1]
    tag = f"{shape[0]}{shape[1]}"
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, f"rendezvous_{tag}"), world), rank=rank,
        world_size=world)
    out = {}
    try:
        mesh = make_host_mesh(*shape, device="cpu")
        with AX.use_mesh(mesh):
            for case in cases_of(shape):
                out.update(port_case(case, mesh))
    finally:
        destroy_mesh()
    if rank == 0:
        for case in cases_of(shape):
            out.update({f"one/{k}": v
                        for k, v in port_case(case, None).items()})
    np.savez(os.path.join(work, f"port_{tag}_{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# JAX: one process, d x m host devices
# ---------------------------------------------------------------------------

def jax_case(case: str, work: str) -> None:
    """Entry of a JAX process (one a case: the train step's compile
    takes most of a case's time): the case on its mesh under GSPMD,
    params and states placed by ``param_shardings(fsdp=True)`` and
    batches by ``batch_specs``, into ``work/jax_<case>.npz``."""
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.core import bdi_value as jbv
    from repro.distributed import sharding as JSH
    from repro.distributed.axes import use_mesh
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models import transformer as JT
    from repro.models.api import get_model as jax_model
    from repro.optim import adamw as JO
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    shape = CASES[case][2]
    assert len(jax.devices()) == shape[0] * shape[1]
    mesh = jmesh(*shape)
    where = {d: i for i, d in enumerate(mesh.devices.flat)}
    opts = {"xla_allow_excess_precision": False}
    named = lambda specs: jax.tree.map(                       # noqa: E731
        lambda s: jax.sharding.NamedSharding(mesh, s), specs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))

    def put_rows(x):
        x = jnp.asarray(x)
        return jax.device_put(x, named(JSH.batch_specs(x, mesh)))
    out = {}
    with use_mesh(mesh):
        arch, kw, _, _ = CASES[case]
        with threshold(case, JSH):
            jcfg = jax_arch(arch).reduced(**kw)
            jm = jax_model(jcfg)
            like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
            psh = JSH.param_shardings(like, mesh, fsdp=True)
            params = jstore.restore(os.path.join(work, "params", case),
                                    like, target_shardings=psh)[0]
            for k, leaf in jax.tree_util.tree_flatten_with_path(
                    params)[0]:
                for s in leaf.addressable_shards:
                    out[f"{case}/shard/{where[s.device]}"
                        f"{jax.tree_util.keystr(k)}"] = _np(s.data)
            toks, emb = case_inputs(jcfg)
            off = jcfg.n_frontend_embeds
            batch = {"tokens": put_rows(toks[:, :PROMPT])}
            if emb is not None:
                batch["embeds"] = put_rows(jnp.asarray(emb,
                                                       jnp.bfloat16))
            prefill = jax.jit(jm.prefill, static_argnums=2,
                              compiler_options=opts)
            step = jax.jit(jm.decode_step, compiler_options=opts)
            logits, cache = prefill(params, batch, off + PROMPT + GEN)
            out[f"{case}/logits/0"] = _f32(logits)
            for i in range(STEPS):
                logits, cache = step(params, cache,
                                     put_rows(toks[:, PROMPT + i]),
                                     jnp.int32(off + PROMPT + i))
                out[f"{case}/logits/{i + 1}"] = _f32(logits)
            for path, leaf in store.leaf_paths(cache):
                out[f"{case}/cache{path}"] = _np(leaf)
            qc = JT.init_quant_cache(jcfg, BATCH, STEPS + 2)
            qc = jax.device_put(qc, named(JSH.cache_specs(qc, mesh)))
            qstep = jax.jit(lambda p, c, tok, t: JT.decode_step_quant(
                jcfg, p, c, tok, t), compiler_options=opts)
            for t in range(STEPS):
                logits, qc = qstep(params, qc, put_rows(toks[:, t]),
                                   jnp.int32(t))
                out[f"{case}/quant/logits/{t}"] = _f32(logits)
            for path, leaf in store.leaf_paths(qc):
                out[f"{case}/quant/cache{path}"] = _np(leaf)
            # greedy, as dense_generate: the prompt only
            logits, cache = prefill(params, {"tokens": batch["tokens"]},
                                    PROMPT + GEN)
            tok = jnp.argmax(logits, -1)
            got, rows = [tok], [_f32(logits)]
            for t in range(PROMPT, PROMPT + GEN - 1):
                logits, cache = step(params, cache, put_rows(tok),
                                     jnp.int32(t))
                tok = jnp.argmax(logits, -1)
                got.append(tok)
                rows.append(_f32(logits))
            out[f"{case}/greedy/tokens"] = np.stack(
                [np.asarray(t) for t in got], 1)
            out[f"{case}/greedy/logits"] = np.stack(rows)
            # one train step under each moment dtype
            states = {md: JO.adamw_init(params, JO.AdamWConfig(
                moment_dtype=md)) for md in dtypes_of(case)}
            osh = {md: JSH.param_shardings(s, mesh, fsdp=True)
                   for md, s in states.items()}
            states = jax.device_put(states, osh)
            tb = {k: put_rows(v)
                  for k, v in train_batch(jcfg)[0].items()}

            def both(params, states, batch):
                loss, grads = jax.value_and_grad(jm.loss)(params, batch)
                upd = {}
                for md, st in states.items():
                    p2, s2, met = JO.adamw_update(
                        params, grads, st, JO.AdamWConfig(
                            moment_dtype=md))
                    upd[md] = (p2, s2, met["grad_norm"])
                return loss, grads, upd
            loss, grads, upd = jax.jit(
                both, out_shardings=(None, psh, {
                    md: (psh, osh[md], None) for md in dtypes_of(case)}),
                compiler_options=opts)(params, states, tb)
            out[f"{case}/loss0"] = np.float32(loss)
            for k, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
                out[f"{case}/grad{jax.tree_util.keystr(k)}"] = _f32(g)
            for md in dtypes_of(case):
                p2, s2, gnorm = upd[md]
                out[f"{case}/{md}/grad_norm"] = np.float32(gnorm)
                trees = {"param": p2, **{k: jax.tree.map(
                    lambda p, s, md=md: JO._load(s, md, p.shape),
                    params, s2[k]) for k in ("m", "v")}}
                for key, tree in trees.items():
                    for k, leaf in jax.tree_util.tree_flatten_with_path(
                            tree)[0]:
                        out[f"{case}/{md}/step/{key}"
                            f"{jax.tree_util.keystr(k)}"] = _f32(leaf)
    np.savez(os.path.join(work, f"jax_{case}.npz"), **out)


# ---------------------------------------------------------------------------
# the fixture: all processes at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax": {case: npz}, "port": {shape: [npz of each rank]}}."""
    work = tmp_path_factory.mktemp("dp_tp")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_dp_tp as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    procs = []
    for case, (_, _, shape, _) in CASES.items():
        jenv = dict(env, XLA_FLAGS=(
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={shape[0] * shape[1]}"
            + " --xla_allow_excess_precision=false").strip())
        procs.append(start(f"jax_case({case!r}, {str(work)!r})", jenv))
    for shape in MESHES:
        procs += [start(f"port_rank({r}, {shape}, {str(work)!r})", env)
                  for r in range(shape[0] * shape[1])]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * len(procs), rcs
    load = lambda name: dict(np.load(work / name))           # noqa: E731
    return {"jax": {c: load(f"jax_{c}.npz") for c in CASES},
            "port": {s: [load(f"port_{s[0]}{s[1]}_{r}.npz")
                         for r in range(s[0] * s[1])] for s in MESHES}}


def _ranks(records, case: str):
    shape = CASES[case][2]
    return shape, records["jax"][case], records["port"][shape]


def _coord(shape: tuple, rank: int) -> dict:
    return {"data": rank // shape[1], "model": rank % shape[1]}


def _abstract(shape: tuple):
    return EL.abstract_mesh(shape, ("data", "model"))


def _paths(case: str) -> list[str]:
    return [p for p, _ in store.leaf_paths(case_params(case))]


def _block(case: str, whole: np.ndarray, path: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole params-shaped leaf under
    ``param_specs(fsdp=True)`` at the case's threshold: what the rank
    holds of a param or a gradient."""
    shape = CASES[case][2]
    mesh = _abstract(shape)
    with threshold(case):
        spec = SH._spec_for(path, whole.shape, mesh, 2, True)
    return SH.local_shards({"x": torch.from_numpy(whole)}, {"x": spec}, mesh,
                           coord=_coord(shape, rank))["x"].numpy()


def _moment_block(case: str, whole: np.ndarray, path: str, rank: int,
                  owner: int, fsdp: bool) -> np.ndarray:
    """The block of a whole params-shaped moment (loaded) whose moments
    rank ``rank`` keeps: its param block, narrowed to the rank's 1/d
    along ``owner`` where the param is whole over data."""
    x = _block(case, whole, path, rank)
    if owner < 0 or fsdp:
        return x
    d = CASES[case][2][0]
    n = x.shape[owner] // d
    r = _coord(CASES[case][2], rank)["data"]
    return np.take(x, range(r * n, (r + 1) * n), axis=owner)


def _assert_step(got: dict, want: dict, pg: str, pw: str, case: str,
                 port: dict, md: str, rank: int, blocks: bool) -> None:
    """One step's params and loaded moments against ``want``'s (whole
    arrays when ``blocks``, cut to the rank's blocks; else the rank's
    own)."""
    owner, fsdp = port[f"{case}/{md}/owner"], port[f"{case}/{md}/fsdp"]
    for i, path in enumerate(_paths(case)):
        a = got[f"{pg}step/param{path}"]
        b = want[f"{pw}step/param{path}"]
        b = _block(case, b, path, rank) if blocks else b
        assert a.shape == b.shape, (path, a.shape, b.shape)
        gap = np.abs(a - b) - _ulp(np.maximum(np.abs(a), np.abs(b)))
        share = float((gap <= 0).mean())
        assert share >= STEP_ULP_SHARE, (md, path, rank, share)
        for k in ("m", "v"):
            a = got[f"{pg}step/{k}{path}"]
            b = want[f"{pw}step/{k}{path}"]
            if blocks:
                b = _moment_block(case, b, path, rank, int(owner[i]),
                                  bool(fsdp[i]))
            assert a.shape == b.shape, (k, path, a.shape, b.shape)
            err = float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                     1e-30))
            assert err <= STEP_MOMENT_RTOL, (md, k, path, rank, err)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_placement_equals_jax_addressable_shards(records, case):
    _, jax_rec, ports = _ranks(records, case)
    paths = _paths(case)
    split = 0
    for r, port in enumerate(ports):
        assert bool(port[f"{case}/init_local_equal"])
        for path in paths:
            got = port[f"{case}/shard{path}"]
            want = jax_rec[f"{case}/shard/{r}{path}"]
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (path, r, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {r}")
        split += int(port[f"{case}/f32/fsdp"].sum())
    if CASES[case][3] == REAL:
        assert split == 0                  # pure DP x TP at the real size
    else:
        assert split >= 5 * len(ports)     # FSDP engaged


@pytest.mark.parametrize("case", list(CASES))
def test_serving_logits_match_jax(records, case):
    _, jax_rec, ports = _ranks(records, case)
    keys = ["forward"] + [f"logits/{i}" for i in range(STEPS + 1)] + [
        f"quant/logits/{t}" for t in range(STEPS)]
    one = ports[0]
    for port in ports:
        for k in keys:
            if k != "forward":         # JAX's forward: test_torch_decode
                assert_model_ulps(port[f"{case}/{k}"],
                                  jax_rec[f"{case}/{k}"], MODEL_ULPS)
            assert_model_ulps(port[f"{case}/{k}"], one[f"one/{case}/{k}"],
                              MODEL_ULPS)
            # every rank returns the whole batch's logits, the same
            np.testing.assert_array_equal(port[f"{case}/{k}"],
                                          ports[0][f"{case}/{k}"])


@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_match_jax(records, case):
    """The dense cache's blocks within 2 ULPs, the quantised cache's
    bit-equal (batch over data, KV heads over model: ``cache_specs``)."""
    shape, jax_rec, ports = _ranks(records, case)
    cfg = case_cfg(case)
    mesh = _abstract(shape)
    for prefix, like in (
            ("cache", T.init_cache(cfg, BATCH, cfg.n_frontend_embeds
                                   + PROMPT + GEN, device="cpu")),
            ("quant/cache", T.init_quant_cache(cfg, BATCH, STEPS + 2,
                                               device="cpu"))):
        glob = store._rebuild(like, iter(
            torch.from_numpy(jax_rec[f"{case}/{prefix}{p}"])
            for p, _ in store.leaf_paths(like)))
        for r, port in enumerate(ports):
            block = SH.local_shards(glob, SH.cache_specs(glob, mesh), mesh,
                                    coord=_coord(shape, r))
            for path, want in store.leaf_paths(block):
                got = port[f"{case}/{prefix}{path}"]
                want = want.numpy()
                assert got.shape == want.shape, (path, got.shape, want.shape)
                if prefix == "cache":
                    as32 = lambda a: torch.from_numpy(a).view(    # noqa
                        torch.bfloat16).float().numpy()
                    assert_model_ulps(as32(got), as32(want), MODEL_ULPS)
                else:
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{path} {r}")


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_jax(records, case):
    _, jax_rec, ports = _ranks(records, case)
    want = jax_rec[f"{case}/greedy/tokens"]
    for port in ports:
        got = port[f"{case}/greedy/tokens"]
        assert got.shape == want.shape == (BATCH, GEN)
        np.testing.assert_array_equal(got, ports[0][f"{case}/greedy/tokens"])
        np.testing.assert_array_equal(got, ports[0][
            f"one/{case}/greedy/tokens"])
        rows = torch.from_numpy(port[f"{case}/greedy/logits"])
        ref = torch.from_numpy(jax_rec[f"{case}/greedy/logits"])
        par = GreedyParity()
        for j in range(GEN):
            par.check(j, {b: int(want[b, j]) for b in range(BATCH)},
                      {b: int(got[b, j]) for b in range(BATCH)},
                      lambda sid, j=j: rows[j, sid],
                      lambda sid, j=j: ref[j, sid])
        assert par.compared >= 0.75 * want.size, par


def test_whole_rows_serve_as_one_rank(records):
    """3 prompts on a data axis of 2: every rank keeps the whole batch
    (``batch_specs`` replicates it), no row is gathered, and the tokens
    and logits equal the run without a mesh."""
    case = "yi-6b-d2"
    _, _, ports = _ranks(records, case)
    for port in ports:
        np.testing.assert_array_equal(port[f"{case}/whole_rows/tokens"],
                                      ports[0][f"one/{case}/whole_rows/"
                                               f"tokens"])
        assert_model_ulps(port[f"{case}/whole_rows/logits"],
                          ports[0][f"one/{case}/whole_rows/logits"],
                          MODEL_ULPS)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_and_norm_match_jax(records, case):
    _, jax_rec, ports = _ranks(records, case)
    for r, port in enumerate(ports):
        for md in dtypes_of(case):
            np.testing.assert_allclose(port[f"{case}/{md}/loss/0"],
                                       jax_rec[f"{case}/loss0"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(port[f"{case}/{md}/grad_norm/0"],
                                       jax_rec[f"{case}/{md}/grad_norm"],
                                       rtol=GNORM_RTOL)
        np.testing.assert_allclose(port[f"{case}/f32/loss0"],
                                   jax_rec[f"{case}/loss0"], rtol=LOSS_RTOL)
        for path in _paths(case):
            w = _block(case, jax_rec[f"{case}/grad{path}"], path, r)
            g = port[f"{case}/f32/grad{path}"]
            assert g.shape == w.shape, (path, g.shape, w.shape)
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= GRAD_RTOL, (path, r, err)
    # the same loss and norm, to the bit, on every rank and step
    for port in ports[1:]:
        for md in dtypes_of(case):
            for i in range(TRAIN_STEPS):
                for k in ("loss", "grad_norm"):
                    assert port[f"{case}/{md}/{k}/{i}"] == \
                        ports[0][f"{case}/{md}/{k}/{i}"], (md, k, i)


@pytest.mark.parametrize("case,md", STEP_CASES)
def test_one_step_matches_jax(records, case, md):
    _, jax_rec, ports = _ranks(records, case)
    for r, port in enumerate(ports):
        _assert_step(port, jax_rec, f"{case}/{md}/", f"{case}/{md}/", case,
                     port, md, r, blocks=True)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_tp_matches_one_rank(records, case):
    """The port's blocks against the port's own run without a mesh: the
    loss, the norm, the gradients and one step under each dtype."""
    _, _, ports = _ranks(records, case)
    one = ports[0]
    for r, port in enumerate(ports):
        for md in dtypes_of(case):
            pre = f"one/{case}/{md}/"
            np.testing.assert_allclose(port[f"{case}/{md}/loss/0"],
                                       one[f"{pre}loss/0"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(port[f"{case}/{md}/grad_norm/0"],
                                       one[f"{pre}grad_norm/0"],
                                       rtol=GNORM_RTOL)
            want = {k[len(pre):]: v for k, v in one.items()
                    if k.startswith(f"{pre}step/")}
            want = {f"w/{k}": v for k, v in want.items()}
            _assert_step(port, want, f"{case}/{md}/", "w/", case, port, md,
                         r, blocks=True)
        for path in _paths(case):
            w = _block(case, one[f"one/{case}/f32/grad{path}"], path, r)
            g = port[f"{case}/f32/grad{path}"]
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= GRAD_RTOL, (path, r, err)


@pytest.mark.parametrize("case,md", STEP_CASES)
def test_replicated_blocks_bit_identical_over_data(records, case, md):
    """After each step, a param block whole over data (a norm, wk/wv, a
    ZeRO-1 leaf after its gather) and the moments of a leaf no rank owns
    alone are the same bits on every data rank of a model coordinate;
    the zero state is the blocks of the whole zero state."""
    shape, _, ports = _ranks(records, case)
    m = shape[1]
    fsdp = ports[0][f"{case}/{md}/fsdp"]
    owner = ports[0][f"{case}/{md}/owner"]
    paths = _paths(case)
    checked = 0
    for j in range(m):
        a, b = ports[j], ports[m + j]          # data ranks 0 and 1
        for i in range(TRAIN_STEPS):
            for n, path in enumerate(paths):
                if not fsdp[n]:
                    k = f"{case}/{md}/bits/{i}/param{path}"
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    checked += 1
                if owner[n] < 0:
                    for key in a:
                        if key.startswith(f"{case}/{md}/bits/{i}/m{path}") \
                                or key.startswith(
                                    f"{case}/{md}/bits/{i}/v{path}"):
                            np.testing.assert_array_equal(a[key], b[key],
                                                          err_msg=key)
    assert checked > 0
    # the zero state of a rank is its blocks of the whole zero state
    ocfg = AdamWConfig(moment_dtype=md)
    whole = AW.adamw_init(case_params(case), ocfg)
    for port in ports:
        for k in ("m", "v"):
            for n, (path, s) in enumerate(zip(paths, AW._store_leaves(
                    whole[k]))):
                parts = s.items() if isinstance(s, dict) else [("", s)]
                for name, t in parts:
                    got = port[f"{case}/{md}/zero/{k}{path}"
                               + (f"['{name}']" if name else "")]
                    assert got.dtype == _np(t).dtype, (path, name)
                    assert (got == _np(t).flat[0]).all(), (path, name)


@pytest.mark.parametrize("case,md", STEP_CASES)
def test_moment_bytes_within_rule_table_share(records, case, md):
    """A rank's moment bytes at most the rule table's share of every
    moment leaf (its bytes over the sizes of the axes its spec names)."""
    shape, _, ports = _ranks(records, case)
    ocfg = AdamWConfig(moment_dtype=md)
    whole = AW.adamw_init(T.init_params(case_cfg(case), torch.Generator(),
                                        "meta"), ocfg)
    mesh = _abstract(shape)
    sizes = {"data": shape[0], "model": shape[1]}
    with threshold(case):
        specs = SH.param_specs({"m": whole["m"], "v": whole["v"]}, mesh,
                               fsdp=True)
    share = 0
    for (_, t), (_, spec) in zip(
            store.leaf_paths({"m": whole["m"], "v": whole["v"]}),
            SH.spec_leaves(specs)):
        n = int(np.prod([sizes[a] for a in AX.spec_axes(spec)]))
        share += t.numel() * t.element_size() // n
    for port in ports:
        got = int(port[f"{case}/{md}/state_bytes"])
        assert got <= share, (got, share)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_of_a_step(records, case):
    """A step's collectives by axis, counted from the placement.  Over
    ``data``: forward, an all-gather of each FSDP leaf at its use (a
    layer's again in its recompute, the head's again in the loss chunk's);
    backward, one f32 all-reduce of each leaf's gradient (9 a layer, the
    embedding, the final norm, the head); the loss's sum, the clip norm's
    one where a leaf is split over data; the update's all-gather of each
    ZeRO-1 block.  Over ``model``: PR 26's count.  Serving: an all-gather
    of each FSDP leaf at its use and of the logits' rows a step."""
    shape, _, ports = _ranks(records, case)
    m = shape[1]
    cfg = case_cfg(case)
    n = cfg.n_layers
    paths = _paths(case)
    for md in dtypes_of(case):
        fsdp = ports[0][f"{case}/{md}/fsdp"]
        owner = ports[0][f"{case}/{md}/owner"]
        layer = sum(bool(f) for p, f in zip(paths, fsdp)
                    if p.startswith("['blocks']"))
        top = {p: bool(f) for p, f in zip(paths, fsdp)
               if not p.startswith("['blocks']")}
        gathers = (top["['embed']['w']"] + 2 * layer * n
                   + 2 * top["['lm_head']['w']"]
                   + sum((o >= 0) and not f for o, f in zip(owner, fsdp)))
        reduces = (9 * n + 3) + 1 + bool(fsdp.any())
        model = [0, 0, 0]
        if m > 1:
            backward = 5 * n + 1
            model = [(1 + 2 * n + 2) + (n + 2) + backward + 1, 0, backward]
        for port in ports:
            for i in range(TRAIN_STEPS):
                np.testing.assert_array_equal(
                    port[f"{case}/{md}/collectives/{i}/data"],
                    [reduces, gathers, 9 * n + 3], err_msg=f"{md} {i}")
                np.testing.assert_array_equal(
                    port[f"{case}/{md}/collectives/{i}/model"], model,
                    err_msg=f"{md} {i}")
    fsdp = ports[0][f"{case}/f32/fsdp"]
    uses = (sum(bool(f) for p, f in zip(paths, fsdp)
                if p.startswith("['blocks']")) * n
            + bool(fsdp[paths.index("['embed']['w']")])
            + bool(fsdp[paths.index("['lm_head']['w']")]))
    for port in ports:
        np.testing.assert_array_equal(
            port[f"{case}/greedy/collectives/per_step/data"], [0, uses + 1])
        np.testing.assert_array_equal(
            port[f"{case}/greedy/collectives/per_step/model"],
            [2 * n + 1, 1] if m > 1 else [0, 0])


# ---------------------------------------------------------------------------
# refusals and the batch's rows (abstract meshes: no collective runs)
# ---------------------------------------------------------------------------

def test_local_batch_cuts_rows_or_keeps_them_whole():
    mesh = _abstract((2, 2))
    b = {"tokens": torch.arange(8).reshape(4, 2),
         "embeds": torch.arange(24.0).reshape(4, 3, 2)}
    got = SH.local_batch(b, mesh, coord={"data": 1, "model": 0})
    assert torch.equal(got["tokens"], b["tokens"][2:])
    assert torch.equal(got["embeds"], b["embeds"][2:])
    three = {"tokens": torch.arange(6).reshape(3, 2)}
    assert torch.equal(SH.local_batch(three, mesh, coord={
        "data": 1, "model": 1})["tokens"], three["tokens"])


@pytest.mark.parametrize("what", ["pod_axis", "data_straddle"])
def test_what_dp_tp_still_refuses(what):
    """A pod axis beside the data and model axes (the multi-pod mesh), at
    every entry point; ``bdi8``/``q8`` moments whose tiles straddle two
    data blocks (reduced yi-6b at d_model 256 on a data axis of 4: down's
    and wo's 2 tiles of D over 4 blocks), while f32 and bf16 moments are
    laid out.  Each raises naming the ROADMAP item."""
    cfg = case_cfg("yi-6b")
    model = get_model(cfg)
    if what == "pod_axis":
        toks = torch.ones((2, 4), dtype=torch.int64)
        calls = [lambda: model.prefill({}, {"tokens": toks}, 8),
                 lambda: model.decode_step({}, None, toks[:, 0], 4),
                 lambda: model.forward({}, {"tokens": toks}),
                 lambda: model.loss({}, {"tokens": toks, "targets": toks}),
                 lambda: make_train_step(model, AdamWConfig())(
                     {}, {}, {"tokens": toks, "targets": toks})]
        with AX.use_mesh(EL.abstract_mesh((2, 2, 2),
                                          ("pod", "data", "model"))):
            for call in calls:
                with pytest.raises(NotImplementedError,
                                   match="pod axis.*ROADMAP Queue 1 item 2"):
                    call()
        return
    mesh = EL.abstract_mesh((4, 1), ("data", "model"))
    with threshold("yi-6b"), AX.use_mesh(mesh):
        local = SH.local_params(case_params("yi-6b"), mesh,
                                coord={"data": 0, "model": 0}, fsdp=True)
        whole = model.init(torch.Generator(), "meta")
        for md in ("bdi8", "q8"):
            with pytest.raises(NotImplementedError,
                               match=r"straddle two blocks.*ROADMAP Queue 1 "
                                     r"item 2"):
                AW.plan(local, whole, AdamWConfig(moment_dtype=md))
        for md in ("f32", "bf16"):
            lay = AW.plan(local, whole, AdamWConfig(moment_dtype=md))
            assert sum(leaf.data is not None for leaf in lay) >= 5
