"""Training under tensor parallelism: the port's train step vs JAX's
GSPMD train step, on the CPU.

The port's dense GQA decoders under a ``(1, m)`` mesh: each rank holds
its shards of the params (``distributed/sharding.local_params``), of the
gradients and of the AdamW moments (``adamw_init`` of the local params),
every rank takes the same batch, and every collective of the model axis,
forward and backward, goes through ``distributed/tp.py`` over gloo: the
vocab-parallel cross-entropy, the column-parallel products' input
gradients summed in f32 and rounded once, the row-parallel sums, the clip
norm's sums of squares of the sharded leaves.  JAX runs ``jax.value_and_
grad`` of the same loss and ``adamw_update`` jitted under ``use_mesh``,
the params and moments placed by ``param_shardings(fsdp=False)``, GSPMD
inserting its collectives.

One module fixture starts, all at once (``tests/test_torch_tensor_
parallel.py``'s pattern: gloo over a ``FileStore``, each process writing
``.npz``): two port ranks and one JAX process with ``XLA_FLAGS=--xla_
force_host_platform_device_count=2 --xla_allow_excess_precision=false``
for the ``(1, 2)`` cases (reduced yi-6b, qwen2.5-14b with random QKV
biases, gemma3-27b whose windows of 8 cut the 32 positions, internvl2-76b
with frontend embeddings, each at d_ff 256 so that the MLP's moment tiles
of 128 split evenly), and four port ranks and a JAX process with four
host devices for reduced yi-6b at 8 heads, 4 KV heads, d_ff 512 and vocab
512 under ``(1, 4)``.  Each case trains under ``f32`` and ``bdi8``
moments (on the CPU ``bdi8`` goes through the tile kernels' plain
versions).  Rank 0 also runs every case without a mesh, the port's own
m = 1 reference.  The params are the port's init from seed 0, restored by
the JAX store; JAX's ``_pow2_scale`` is swapped for the exact
construction of 2^e (``tests/test_torch_decode.exact_pow2_scale``,
test-only).  JAX's whole arrays are cut to a rank's block by the port's
``local_shards``, which ``test_torch_tensor_parallel.py`` holds equal to
JAX's addressable shards.

Tolerances, each those of ``tests/test_torch_train.py`` (the port at m = 1
against JAX), for the same reasons:

* the loss: rtol 1e-4 (the vocab's sum of exp is summed over the ranks
  in another order than one device sums it);
* each rank's gradient shard of every leaf: relative Frobenius error
  <= 1e-2 (bf16 gradients from f32 sums in another order);
* ``grad_norm``: rtol 1e-3 (the norm of bf16 gradients within the bound
  above; measured here: 4.6e-5 at worst, against JAX);
* one step from one state: the params within one bf16 ULP for at least
  99% of each shard, and each loaded moment leaf (m and v) within a
  relative Frobenius error of 2e-2;
* qwen2.5's QKV bias leaves against JAX: their gradient is the sum of
  the B S = 64 bf16 gradients of the biased outputs, which XLA adds in
  bf16, rounding each add (measured here: up to 1.2e-2 from the port's
  f32 sum of the same values rounded once; at m = 1 too), so they
  are held to 2e-2; after one step the bias params within one bf16 ULP
  plus 2 lr (AdamW's first step moves an element by lr sign(g), and that
  sum's rounding can flip the sign of a gradient near 0), and their
  moments within 4e-2 (v is g squared: twice g's relative error);
* the same bounds against the port's own m = 1 run (the bias leaves at
  the general bounds: both are the port's arithmetic);
* the losses of steps 2 and 3 against the m = 1 run: test_torch_train's
  trajectory bounds (rtol 2e-3 under f32 moments, 1e-2 under bdi8);
* ``tp.vocab_cross_entropy`` and its gradient against the whole
  cross-entropy of the whole logits: within 2 bf16 ULPs elementwise;
* bit for bit: ``adamw_init`` of the local params against
  ``local_shards`` of the whole state, and the replicated leaves (the
  norms and their moments) across the ranks after each of 3 steps.
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
from repro_torch.launch.train import make_train_step, train
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import _load, _store_leaves, plan
from test_torch_decode import _ulp, exact_pow2_scale
from test_torch_train import STEP_MOMENT_RTOL, STEP_ULP_SHARE, TRAJ_RTOL

REPO = Path(__file__).resolve().parents[1]
# case -> (arch, reduced() overrides, model axis)
CASES = {"yi-6b": ("yi-6b", {"d_ff": 256}, 2),
         "qwen2.5-14b": ("qwen2.5-14b", {"d_ff": 256}, 2),
         "gemma3-27b": ("gemma3-27b", {"d_ff": 256}, 2),
         "internvl2-76b": ("internvl2-76b", {"d_ff": 256}, 2),
         "yi-6b-m4": ("yi-6b", {"n_heads": 8, "n_kv_heads": 4,
                                "d_ff": 512, "vocab": 512}, 4)}
WORLDS = (2, 4)
DTYPES = ("f32", "bdi8")
SHAPE = ShapeConfig("t", 32, 2, "train")
STEPS = 3
LOSS_RTOL, GRAD_RTOL, GNORM_RTOL = 1e-4, 1e-2, 1e-3
BIAS_GRAD_RTOL = 2e-2            # against JAX's bf16 sums (docstring)
CE_ULPS = 2
CE_VOCAB = 48                    # columns a rank, vocab_cross_entropy test


def case_cfg(case: str):
    arch, kw, _ = CASES[case]
    return get_arch(arch).reduced(**kw)


def cases_of(world: int) -> list[str]:
    return [c for c, (_, _, m) in CASES.items() if m == world]


def case_params(case: str) -> dict:
    """The port's init of the case from seed 0; qwen's QKV biases (zeros
    at init) drawn from seed 1, so that their gradients show."""
    params = T.init_params(case_cfg(case), torch.Generator().manual_seed(0),
                           "cpu")
    gen = torch.Generator().manual_seed(1)
    for name in ("wq", "wk", "wv"):
        b = params["blocks"]["attn"][name].get("b")
        if b is not None:
            b.copy_(torch.randn(b.shape, generator=gen) * 0.5)
    return params


def case_batches(cfg) -> list[dict]:
    """``STEPS`` batches of the synthetic stream (numpy; internvl's with
    its frontend embeddings)."""
    return [TP.make_train_batch(cfg, SHAPE, TP.DataConfig(seed=2), step=i)
            for i in range(STEPS)]


def ce_inputs(world: int) -> dict:
    rng = np.random.default_rng(7)
    v = CE_VOCAB * world
    return {"logits": (rng.standard_normal((3, 13, v)) * 3).astype(
                np.float32),
            "targets": rng.integers(0, v, (3, 13)).astype(np.int64),
            "g": rng.standard_normal((3, 13)).astype(np.float32)}


def _f32(t) -> np.ndarray:
    """A copy as f32 (the train step updates params and moments in
    place)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy().copy()


def _is_norm(path: str) -> bool:
    return "norm" in path or "['ln" in path


# ---------------------------------------------------------------------------
# the port: one rank (or no mesh)
# ---------------------------------------------------------------------------

def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _loss_and_grads(model, params: dict, batch: dict):
    """The loss, and its gradients from a thread with no mesh active: on
    the card autograd runs the backward (and the layers' recompute) on a
    device thread of its own, where ``axes.use_mesh`` of the caller's
    thread is not seen."""
    flat = [t.requires_grad_() for t in P.leaves(params)]
    loss = model.loss(params, batch)
    with ThreadPoolExecutor(1) as pool:
        grads = pool.submit(torch.autograd.grad, loss, flat).result()
    for t in flat:
        t.requires_grad_(False)
    return float(loss.detach()), grads


def _moments(params: dict, state: dict) -> dict:
    """Every moment leaf loaded to f32, keyed ``m``/``v`` + the path."""
    return {f"{k}{path}": _f32(_load(s, p.shape))
            for k in ("m", "v")
            for (path, p), s in zip(store.leaf_paths(params),
                                    _store_leaves(state[k]))}


def port_train(case: str, md: str, mesh) -> dict:
    """One case under one moment dtype on whatever mesh is active (the
    whole params with ``mesh`` None): the loss and gradients, then
    ``STEPS`` train steps."""
    cfg = case_cfg(case)
    model = get_model(cfg)
    ocfg = AdamWConfig(moment_dtype=md)
    full = case_params(case)
    params = full if mesh is None else P.tree_map(
        torch.clone, SH.local_params(full, mesh))
    batches = [_torch_batch(b) for b in case_batches(cfg)]
    out = {}
    out["loss0"], grads = _loss_and_grads(model, params, batches[0])
    if md == "f32":
        for (path, _), g in zip(store.leaf_paths(params), grads):
            out[f"grad{path}"] = _f32(g)
    del grads
    state = adamw_init(params, ocfg)
    if mesh is not None:
        with AX.use_mesh(None):
            whole = adamw_init(full, ocfg)
        want = SH.local_shards(whole, SH.param_specs(whole, mesh,
                                                     fsdp=False), mesh)
        same = [pa for (pa, a), (pb, b) in zip(store.leaf_paths(state),
                                               store.leaf_paths(want))
                if pa != pb or a.dtype != b.dtype or not torch.equal(a, b)]
        out["init_mismatch"] = np.asarray(
            ",".join(same) if len(P.leaves(state)) == len(P.leaves(want))
            else "leaf count")
    step = make_train_step(model, ocfg)
    for i, batch in enumerate(batches):
        params, state, met = step(params, state, batch)
        out[f"loss/{i}"] = np.float32(met["loss"])
        out[f"grad_norm/{i}"] = np.float32(met["grad_norm"])
        out[f"collectives/{i}"] = np.asarray(
            [met["collectives"]["model"][k] for k in ("all_reduce",
                                                      "backward",
                                                      "all_gather")]
            + [sum(met["collectives"]["data"].values())])
        for path, p in store.leaf_paths(params):
            if _is_norm(path):
                out[f"norm/{i}{path}"] = _bits(p)
        for k, v in _moments(params, state).items():
            if _is_norm(k):
                out[f"norm/{i}/{k}"] = v
        if i == 0:
            for path, p in store.leaf_paths(params):
                out[f"step/param{path}"] = _f32(p)
            for k, v in _moments(params, state).items():
                out[f"step/{k}"] = v
    return out


def port_ce(world: int) -> dict:
    """This rank's columns of :func:`ce_inputs` through
    ``tp.vocab_cross_entropy``: the loss per token and the gradient of
    ``sum(loss * g)`` with respect to the local logits."""
    c = ce_inputs(world)
    r = tp.model_rank()
    logits = torch.from_numpy(
        c["logits"][..., r * CE_VOCAB:(r + 1) * CE_VOCAB]).requires_grad_()
    nll = tp.vocab_cross_entropy(logits, torch.from_numpy(c["targets"]))
    (dl,) = torch.autograd.grad((nll * torch.from_numpy(c["g"])).sum(),
                                logits)
    return {"ce/nll": _f32(nll), "ce/dl": _f32(dl)}


def port_rank(rank: int, world: int, work: str) -> None:
    """Entry of one port rank of a ``(1, world)`` mesh: every case of that
    world under each moment dtype, into ``work/port_<world>_<rank>.npz``;
    rank 0 then runs the same without a mesh (``one/`` keys)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, f"rendezvous_{world}"), world), rank=rank,
        world_size=world)
    out = {}
    try:
        mesh = make_host_mesh(1, world, device="cpu")
        with AX.use_mesh(mesh):
            out.update(port_ce(world))
            for case in cases_of(world):
                for md in DTYPES:
                    for k, v in port_train(case, md, mesh).items():
                        out[f"{case}/{md}/{k}"] = v
    finally:
        destroy_mesh()
    if rank == 0:
        for case in cases_of(world):
            for md in DTYPES:
                for k, v in port_train(case, md, None).items():
                    out[f"one/{case}/{md}/{k}"] = v
    np.savez(os.path.join(work, f"port_{world}_{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# JAX: one process, ``world`` host devices
# ---------------------------------------------------------------------------

def jax_world(world: int, work: str) -> None:
    """Entry of the JAX process: every case of a ``(1, world)`` mesh under
    GSPMD (the loss, the gradients and one ``adamw_update`` under each
    moment dtype, in one jitted step), into ``work/jax_<world>.npz``."""
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.core import bdi_value as jbv
    from repro.distributed import sharding as JSH
    from repro.distributed.axes import use_mesh
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models.api import get_model as jax_model
    from repro.optim import adamw as JO
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    assert len(jax.devices()) == world
    mesh = jmesh(1, world)
    opts = {"xla_allow_excess_precision": False}
    out = {}

    def lower(jcfg, like, states):
        """The jitted step: the loss, its gradients and one update under
        each moment dtype, params and states placed and returned as a
        train step places them (the dry run's ``in_shardings`` and
        ``out_shardings``)."""
        jm = jax_model(jcfg)
        psh = JSH.param_shardings(like, mesh, fsdp=False)
        osh = {md: JSH.param_shardings(s, mesh, fsdp=False)
               for md, s in states.items()}

        def both(params, states, batch):
            loss, grads = jax.value_and_grad(jm.loss)(params, batch)
            upd = {}
            for md, st in states.items():
                p2, s2, met = JO.adamw_update(
                    params, grads, st, JO.AdamWConfig(moment_dtype=md))
                upd[md] = (p2, s2, met["grad_norm"])
            return loss, grads, upd
        return jax.jit(both, in_shardings=(psh, osh, None),
                       out_shardings=(None, psh, {
                           md: (psh, osh[md], None) for md in states}),
                       compiler_options=opts)

    with use_mesh(mesh):
        for case in cases_of(world):
            arch, kw, _ = CASES[case]
            jcfg = jax_arch(arch).reduced(**kw)
            like = jax.eval_shape(jax_model(jcfg).init, jax.random.PRNGKey(0))
            params = jstore.restore(
                os.path.join(work, "params", case), like,
                target_shardings=JSH.param_shardings(like, mesh,
                                                     fsdp=False))[0]
            states = {md: JO.adamw_init(params, JO.AdamWConfig(
                moment_dtype=md)) for md in DTYPES}
            states = jax.device_put(states, {
                md: JSH.param_shardings(s, mesh, fsdp=False)
                for md, s in states.items()})
            batch = {k: jnp.asarray(v)
                     for k, v in case_batches(jcfg)[0].items()}
            compiled = lower(jcfg, like, states).lower(
                params, states, batch).compile()
            loss, grads, upd = compiled(params, states, batch)
            out[f"{case}/all_gathers"] = np.asarray(
                compiled.as_text().count(" all-gather("))
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
                    for k, leaf in jax.tree_util.tree_flatten_with_path(
                            tree)[0]:
                        out[f"{case}/{md}/step/{key}"
                            f"{jax.tree_util.keystr(k)}"] = _f32(leaf)
        if world == 2:
            # reduced yi-6b at its own d_ff of 128: one moment tile of the
            # MLP's gate and up across the two shards; JAX gathers
            jcfg = jax_arch("yi-6b").reduced()
            like = jax.eval_shape(jax_model(jcfg).init, jax.random.PRNGKey(0))
            st = {"bdi8": jax.eval_shape(lambda p: JO.adamw_init(
                p, JO.AdamWConfig(moment_dtype="bdi8")), like)}
            b = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in case_batches(jcfg)[0].items()}
            hlo = lower(jcfg, like, st).lower(like, st, b).compile().as_text()
            out["straddle/all_gathers"] = np.asarray(
                hlo.count(" all-gather("))
    np.savez(os.path.join(work, f"jax_{world}.npz"), **out)


# ---------------------------------------------------------------------------
# the fixture: all processes at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax": {world: npz}, "port": {world: [npz of each rank]}}."""
    work = tmp_path_factory.mktemp("tp_train")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tp_train as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    procs = []
    for world in WORLDS:
        jenv = dict(env, XLA_FLAGS=(
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={world}"
            + " --xla_allow_excess_precision=false").strip())
        procs.append(start(f"jax_world({world}, {str(work)!r})", jenv))
        procs += [start(f"port_rank({r}, {world}, {str(work)!r})", env)
                  for r in range(world)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * len(procs), rcs
    load = lambda name: dict(np.load(work / name))           # noqa: E731
    return {"jax": {w: load(f"jax_{w}.npz") for w in WORLDS},
            "port": {w: [load(f"port_{w}_{r}.npz") for r in range(w)]
                     for w in WORLDS}}


def _ranks(records, case: str):
    world = CASES[case][2]
    return world, records["jax"][world], records["port"][world]


def _block(whole: np.ndarray, path: str, world: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole params-shaped leaf at ``path``
    under ``param_specs(fsdp=False)`` (the port's ``local_shards``)."""
    mesh = EL.abstract_mesh((1, world), ("data", "model"))
    spec = SH._spec_for(path, whole.shape, mesh, 2, False)
    return SH.local_shards({"x": torch.from_numpy(whole)}, {"x": spec}, mesh,
                           coord={"data": 0, "model": rank})["x"].numpy()


def _paths(case: str) -> list[str]:
    return [p for p, _ in store.leaf_paths(case_params(case))]


def _jax_bias(path: str, jax_side: bool) -> bool:
    return jax_side and path.endswith("['b']")


def assert_grads_match(got: dict, want: dict, prefix_got: str,
                       prefix_want: str, paths: list[str], world: int,
                       rank: int, jax_side: bool) -> None:
    for path in paths:
        w = _block(want[f"{prefix_want}grad{path}"], path, world, rank)
        g = got[f"{prefix_got}grad{path}"]
        assert g.shape == w.shape, (path, g.shape, w.shape)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        bound = BIAS_GRAD_RTOL if _jax_bias(path, jax_side) else GRAD_RTOL
        assert err <= bound, (path, rank, err)


def assert_step_matches(got: dict, want: dict, prefix_got: str,
                        prefix_want: str, paths: list[str], world: int,
                        rank: int, jax_side: bool) -> None:
    """One step's params and loaded moments (this rank's block of the
    whole ones in ``want``): test_torch_train's one-step bounds."""
    for path in paths:
        a = got[f"{prefix_got}step/param{path}"]
        b = _block(want[f"{prefix_want}step/param{path}"], path, world, rank)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        gap = np.abs(a - b) - _ulp(np.maximum(np.abs(a), np.abs(b)))
        bound = STEP_MOMENT_RTOL
        if _jax_bias(path, jax_side):
            assert (gap <= 2 * AdamWConfig().lr).all(), (path, rank)
            bound = 2 * BIAS_GRAD_RTOL
        else:
            share = float((gap <= 0).mean())
            assert share >= STEP_ULP_SHARE, (path, rank, share)
        for k in ("m", "v"):
            a = got[f"{prefix_got}step/{k}{path}"]
            b = _block(want[f"{prefix_want}step/{k}{path}"], path, world,
                       rank)
            err = float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                     1e-30))
            assert err <= bound, (k, path, rank, err)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grad_norm_match_jax(records, case, md):
    _, jax_rec, ports = _ranks(records, case)
    for port in ports:
        np.testing.assert_allclose(port[f"{case}/{md}/loss0"],
                                   jax_rec[f"{case}/loss0"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(port[f"{case}/{md}/loss/0"],
                                   jax_rec[f"{case}/loss0"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(port[f"{case}/{md}/grad_norm/0"],
                                   jax_rec[f"{case}/{md}/grad_norm"],
                                   rtol=GNORM_RTOL)
    # the same loss and norm on every rank, at every step
    for port in ports[1:]:
        for i in range(STEPS):
            for k in ("loss", "grad_norm"):
                assert port[f"{case}/{md}/{k}/{i}"] == \
                    ports[0][f"{case}/{md}/{k}/{i}"], (k, i)


@pytest.mark.parametrize("case", list(CASES))
def test_gradient_shards_match_jax(records, case):
    world, jax_rec, ports = _ranks(records, case)
    paths = _paths(case)
    assert sum(k.startswith(f"{case}/grad") for k in jax_rec) == len(paths)
    for r, port in enumerate(ports):
        assert_grads_match(port, jax_rec, f"{case}/f32/", f"{case}/", paths,
                           world, r, jax_side=True)


@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_jax(records, case, md):
    world, jax_rec, ports = _ranks(records, case)
    for r, port in enumerate(ports):
        assert_step_matches(port, jax_rec, f"{case}/{md}/", f"{case}/{md}/",
                            _paths(case), world, r, jax_side=True)


@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_matches_one_rank(records, case, md):
    """The port's TP step against the port's own run without a mesh."""
    world, _, ports = _ranks(records, case)
    one, pre = ports[0], f"one/{case}/{md}/"
    for r, port in enumerate(ports):
        np.testing.assert_allclose(port[f"{case}/{md}/loss0"],
                                   one[f"{pre}loss0"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(port[f"{case}/{md}/grad_norm/0"],
                                   one[f"{pre}grad_norm/0"], rtol=GNORM_RTOL)
        if md == "f32":
            assert_grads_match(port, one, f"{case}/f32/", pre, _paths(case),
                               world, r, jax_side=False)
        assert_step_matches(port, one, f"{case}/{md}/", pre, _paths(case),
                            world, r, jax_side=False)
        for i in range(1, STEPS):
            np.testing.assert_allclose(port[f"{case}/{md}/loss/{i}"],
                                       one[f"{pre}loss/{i}"],
                                       rtol=TRAJ_RTOL[md])


@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_local_moments_equal_local_shards_of_whole_state(records, case, md):
    _, _, ports = _ranks(records, case)
    for r, port in enumerate(ports):
        assert str(port[f"{case}/{md}/init_mismatch"]) == "", r


@pytest.mark.parametrize("md", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_norms_stay_bit_equal_across_ranks(records, case, md):
    """The replicated leaves (the norms and their moments) after each of
    the 3 steps."""
    _, _, ports = _ranks(records, case)
    keys = sorted(k for k in ports[0] if k.startswith(f"{case}/{md}/norm/"))
    n_norms = sum(_is_norm(p) for p in _paths(case))
    assert n_norms == 3 and len(keys) == STEPS * 3 * n_norms
    for port in ports[1:]:
        for k in keys:
            np.testing.assert_array_equal(port[k], ports[0][k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_of_a_step(records, case):
    """Every model-axis collective of a step goes through ``tp.py``, each
    one JAX's HLO carries (no all-gather there either): forward, the
    embedding's sum, two sums a layer and the loss's max and sum a chunk;
    the layers' recompute, the attention's sum again (the MLP's is not
    needed) and the loss chunk's two; backward, the input gradients of
    q, k, v, gate and up a layer and of the LM head; the clip norm's one
    sum of the sharded leaves' squares."""
    _, jax_rec, ports = _ranks(records, case)
    n = case_cfg(case).n_layers
    backward = 5 * n + 1
    total = (1 + 2 * n + 2) + (n + 2) + backward + 1
    assert int(jax_rec[f"{case}/all_gathers"]) == 0
    for port in ports:
        for md in DTYPES:
            for i in range(STEPS):
                np.testing.assert_array_equal(
                    port[f"{case}/{md}/collectives/{i}"],
                    [total, backward, 0, 0])


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_cross_entropy_matches_whole(records, world):
    """Each rank's loss and its gradient on its columns against the whole
    cross-entropy, within 2 bf16 ULPs elementwise."""
    c = ce_inputs(world)
    logits = torch.from_numpy(c["logits"]).requires_grad_()
    tg = torch.from_numpy(c["targets"])
    gold = torch.gather(logits, -1, tg[..., None])[..., 0]
    nll = torch.logsumexp(logits, -1) - gold
    (dl,) = torch.autograd.grad((nll * torch.from_numpy(c["g"])).sum(),
                                logits)
    want_nll, want_dl = _f32(nll), _f32(dl)
    for r, port in enumerate(records["port"][world]):
        for got, want in ((port["ce/nll"], want_nll),
                          (port["ce/dl"], want_dl[..., r * CE_VOCAB:
                                                  (r + 1) * CE_VOCAB])):
            assert got.shape == want.shape
            mag = np.maximum(np.abs(got), np.abs(want))
            assert (np.abs(got - want) <= CE_ULPS * _ulp(mag)).all(), \
                (r, np.abs(got - want).max())


# ---------------------------------------------------------------------------
# refusals (an abstract mesh: each raises before any collective)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["straddling_tiles", "data_axis",
                                  "train_driver", "family"])
def test_what_training_under_tp_still_refuses(records, what, monkeypatch):
    """Laid out now: ``bdi8``/``q8`` moment tiles that straddle two data
    blocks (reduced yi-6b at d_model 256 on a ``(4, 2)`` mesh, FSDP at a
    threshold of 64 KiB, test-only: wo's 2 tiles of D over 4 blocks, the
    rank keeping the moments of its block of the head dim; tiles that
    straddle the model shards, one of gate and up at d_ff 128 under m =
    2, where JAX's step gathers, ``tests/test_torch_tp_replicated.py``),
    and a pod axis beside the data and model axes (``tests/test_torch_tp_
    pod.py``), where a loss of CPU tensors under the dry run's abstract
    mesh raises at its first collective.  Each of these raises naming the
    ROADMAP item: ``launch/train.train()`` under a mesh, and the loss of
    a config this slice
    does not lay out (an MoE whose experts do not divide the model axis,
    xLSTM heads that neither divide it nor are divided by it; the MoE and
    MLA decoders are, ``tests/test_torch_tp_moe.py``, and the recurrent
    and encoder-decoder families, ``tests/test_torch_tp_families.py``)."""
    cfg = get_arch("yi-6b").reduced()
    batch = _torch_batch(case_batches(cfg)[0])
    axes = ((2, 2, 2), ("pod", "data", "model")) if what == "data_axis" \
        else ((4, 2), ("data", "model")) if what == "straddling_tiles" \
        else ((1, 2), ("data", "model"))
    with AX.use_mesh(EL.abstract_mesh(*axes)):
        mesh = AX.current_mesh()
        if what == "straddling_tiles":
            assert int(records["jax"][2]["straddle/all_gathers"]) > 0
            monkeypatch.setattr(SH, "FSDP_THRESHOLD_BYTES", 64 << 10)
            whole = T.init_params(get_arch("yi-6b").reduced(
                d_model=256, d_ff=256, vocab=256), torch.Generator(), "meta")
            local = SH.local_params(whole, mesh, fsdp=True,
                                    coord={"data": 0, "model": 0})
            paths = [path for path, _ in store.leaf_paths(whole)]
            wo = paths.index("['blocks']['attn']['wo']['w']")
            for md in ("bdi8", "q8"):
                lay = plan(local, whole, AdamWConfig(moment_dtype=md))
                assert (lay[wo].data, lay[wo].owner) == (3, 2), md
                state = adamw_init(local, AdamWConfig(moment_dtype=md),
                                   whole=whole)
                assert state["m"]["blocks"]["attn"]["wo"]["w"][
                    "deltas"].shape == (2, 2, 16, 2, 128)
            for md in ("f32", "bf16"):           # no tiles, no limit
                lay = plan(local, whole, AdamWConfig(moment_dtype=md))
                assert (lay[wo].data, lay[wo].owner) == (3, 3), md
        elif what == "data_axis":
            tp.check_layout(cfg)
            params = SH.local_params(T.init_params(
                cfg, torch.Generator(), "cpu"), mesh)
            with pytest.raises(ValueError, match="meta tensors only"):
                get_model(cfg).loss(params, batch)
        elif what == "train_driver":
            with pytest.raises(NotImplementedError,
                               match=r"train\(\) under a model axis.*"
                                     r"ROADMAP Queue 1 item 2"):
                train("yi-6b", steps=1, device="cpu")
        else:
            # experts that do not divide the model axis; xLSTM heads that
            # neither divide it nor are divided by it (the recurrent
            # family is laid out, tests/test_torch_tp_families.py)
            tp.check_layout(get_arch("xlstm-350m").reduced())
            for kw in ({"arch": "deepseek-v2-lite-16b", "n_experts": 3},
                       {"arch": "xlstm-350m", "n_heads": 3,
                        "d_model": 96}):
                kw = dict(kw)
                m = get_model(get_arch(kw.pop("arch")).reduced(**kw))
                with pytest.raises(NotImplementedError,
                                   match=r"ROADMAP Queue 1 item 2"):
                    make_train_step(m, AdamWConfig())({}, {}, batch)
