"""The sequence-parallel residual stream (JAX's ``axes.set_sp``) over the
model axis: the port vs JAX's GSPMD program on the CPU, and vs its own
run without it.

With ``set_sp(True)`` JAX's layer bodies constrain the residual stream
``[B, S, D]`` to ``(DP, "model", None)`` (``shard_seq``) where the model
axis divides S; GSPMD then holds each layer's input as the rank's block
of S/m positions and picks the collectives around it.  Its HLO (a train
step of reduced yi-6b on ``(1, 4)``) holds, per layer: the norms on the
block and their weights' f32 gradients summed over ``model``; the normed
block gathered before the projections; the row-parallel outputs summed
and cut to the block (an all-reduce and a dynamic slice on the CPU, where
XLA forms no reduce-scatter); the projections' input-gradient partials
summed and cut likewise; the final norm on the block, gathered before the
head.  The port lays out the same (``distributed/tp.py``'s
``seq_parallel``, ``gather_seq``, ``sum_seq``, ``scatter_seq``), with a
reduce-scatter where the CPU's HLO sums and slices (the same values).

One module fixture starts, all at once, four port ranks (gloo over a
``FileStore`` in the test's temporary directory, each writing ``.npz``),
which run the ``(1, 4)`` cases on one mesh and the ``(2, 2)`` case on
another, each case with and without sequence parallelism, and JAX
processes with ``XLA_FLAGS=--xla_force_host_platform_device_count=4
--xla_allow_excess_precision=false`` and ``set_sp(True)``.  Cases (B = 2,
S = 64):

* ``yi-6b``: reduced yi-6b, 2 KV heads over 4 ranks (K/V whole);
* ``yi-6b-kv4``: its KV heads widened to 4 (K/V split like Q);
* ``deepseek``: reduced deepseek-v2-lite-16b (MoE with a shared expert,
  MLA), the gathered tokens routed;
* ``arctic``: reduced arctic-480b, its dense residual FFN beside the
  experts, capacity factor 1.25 (tokens dropped: the routes must be those
  of the whole sequence);
* ``hymba``: reduced hymba-1.5b with 5 heads and 1 KV head (Q, K, V and
  wo whole on every rank: the whole output cut to the block), Mamba
  beside attention, ``_fuse``'s norms on the block;
* ``xlstm``: reduced xlstm-350m with 2 heads (a head over two ranks), an
  mLSTM and an sLSTM layer (the sLSTM's whole output cut to the block);
* ``yi-6b-2x2``: reduced yi-6b on ``(2, 2)``, each side's
  ``FSDP_THRESHOLD_BYTES`` lowered to 4 KiB (test-only).

Besides, on the ``(1, 4)`` mesh: reduced yi-6b at S = 62, which 4 does
not divide (JAX's fallback: the stream whole, exactly the run without
sequence parallelism), and seamless-m4t-large-v2, whose ``_hidden`` JAX
never points at ``shard_seq`` (unchanged under ``set_sp(True)``).

The params are the port's init from seed 0, restored by the JAX store;
JAX's ``_pow2_scale`` is swapped for the exact construction
(``tests/test_torch_decode.exact_pow2_scale``, test-only).

Tolerances (``tests/test_torch_tp_families.py``'s): logits within 2 bf16
ULPs of the array's largest |value|; the loss rtol 1e-4, the clip norm
1e-3, gradients within 1e-2 relative Frobenius error, after one AdamW
step (f32 moments) at least 98% of each param leaf within one bf16 ULP.
The time-scanned cells' leaves (Mamba's, sLSTM's), whose f32 ``exp`` and
``log1p`` differ from XLA's by ULPs with no mesh at all, and the MoE
cases (logits, losses, clip norm and every leaf), whose near-tied expert
choices flip between the port and XLA with no mesh at all, are held to
the port's own distance from JAX without sequence parallelism plus those
tolerances (``SCANNED``, ``ROUTED``); against that run itself the MoE
cases are held to the tolerances alone, the scanned leaves to them plus
the same distance.  The norms' weights and gradients are bit-equal
across the ranks; the runs at S = 62 and of seamless equal the runs
without sequence parallelism bit for bit.
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
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.launch import dryrun as D
from repro_torch.launch import elastic as EL
from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models import params as P
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init
from test_torch_decode import _ulp, assert_model_ulps, exact_pow2_scale
from test_torch_tp_replicated import _f32, _is_norm, _np

REPO = Path(__file__).resolve().parents[1]
REAL = SH.FSDP_THRESHOLD_BYTES
HYMBA = {"n_layers": 3, "n_heads": 5, "n_kv_heads": 1, "head_dim": 16,
         "vocab": 257, "window": 8, "n_full_attn": 1}
# case -> (arch, reduced() overrides, mesh (data, model), FSDP threshold)
CASES = {"yi-6b": ("yi-6b", {}, (1, 4), REAL),
         "yi-6b-kv4": ("yi-6b", {"n_kv_heads": 4}, (1, 4), REAL),
         "deepseek": ("deepseek-v2-lite-16b", {"d_ff_expert": 384}, (1, 4),
                      REAL),
         "arctic": ("arctic-480b", {"d_ff": 384, "capacity_factor": 1.25},
                    (1, 4), REAL),
         "hymba": ("hymba-1.5b", HYMBA, (1, 4), REAL),
         "xlstm": ("xlstm-350m", {"n_heads": 2, "slstm_every": 2}, (1, 4),
                   REAL),
         "yi-6b-2x2": ("yi-6b", {}, (2, 2), 4 << 10)}
# the port alone: (arch, overrides, sequence length)
UNCHANGED = {"yi-6b-s62": ("yi-6b", {}, 62),
             "seamless": ("seamless-m4t-large-v2", {"vocab": 258,
                                                    "n_kv_heads": 4}, 64)}
MESHES = ((1, 4), (2, 2))
# the JAX compiles, a process each (about equal shares of the time)
GROUPS = (("yi-6b", "yi-6b-kv4", "yi-6b-2x2"), ("deepseek", "arctic"),
          ("hymba", "xlstm"))
WORLD = 4
B, S = 2, 64
MODEL_ULPS = 2
LOSS_RTOL, GNORM_RTOL, GRAD_RTOL, ULP_SHARE = 1e-4, 1e-3, 1e-2, 0.98
SCANNED = ("['blocks']['mamba']", "['blocks']['slstm']")
# At a random init the routing is near uniform and bf16-level differences
# in the router's input flip near-tied expert choices between the port
# and XLA with no sequence parallelism at all (here on both of the port's
# runs, which equal each other: deepseek's clip norm 1.3e-3 and gradients
# 0.8% from JAX's; arctic's loss 1.04e-4, its logits 4 ULPs and its
# router's gradient 2.8%); these cases' logits, losses, clip norms and
# leaves are held as the scanned leaves are.
ROUTED = ("deepseek", "arctic")


@pytest.fixture(autouse=True)
def _sp_restored():
    """``axes.set_sp`` is process-wide and the dry run leaves it as its
    last call set it (as JAX's ``lower_cell``): each test restores it."""
    prev = AX.SP_ENABLED
    yield
    AX.set_sp(prev)


def case_cfg(case: str):
    arch, kw = (CASES.get(case) or UNCHANGED[case])[:2]
    return get_arch(arch).reduced(**kw)


def case_params(case: str) -> dict:
    return get_model(case_cfg(case)).init(torch.Generator().manual_seed(0),
                                          "cpu")


def case_batch(cfg, s: int = S) -> dict:
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab, (B, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        batch["enc_embeds"] = (rng.standard_normal((B, 8, cfg.d_model))
                               * 0.02).astype(np.float32)
    return batch


class threshold:
    """``FSDP_THRESHOLD_BYTES`` of ``module`` (the port's rule table, or
    JAX's) set to a case's for a while (test-only)."""

    def __init__(self, case: str, module=SH):
        self.module = module
        self.value = CASES[case][3] if case in CASES else REAL

    def __enter__(self):
        self.prev = self.module.FSDP_THRESHOLD_BYTES
        self.module.FSDP_THRESHOLD_BYTES = self.value

    def __exit__(self, *exc):
        self.module.FSDP_THRESHOLD_BYTES = self.prev


class sp:
    """``axes.set_sp`` for a while: the switch is process-wide, as JAX's."""

    def __init__(self, on: bool, module=AX):
        self.module, self.on = module, on

    def __enter__(self):
        self.prev = self.module.SP_ENABLED
        self.module.set_sp(self.on)

    def __exit__(self, *exc):
        self.module.set_sp(self.prev)


# ---------------------------------------------------------------------------
# the port: one rank
# ---------------------------------------------------------------------------

def port_run(case: str, mesh, s: int = S) -> dict:
    """The logits of the batch, the loss and its gradients (taken on a
    worker thread, where the caller's mesh is not seen, as autograd's
    thread on the card), then one ``make_train_step`` step from the zero
    state (f32 moments) and its collectives."""
    cfg = case_cfg(case)
    model = get_model(cfg)
    fsdp = case in CASES and CASES[case][3] != REAL
    full = case_params(case)
    out = {}
    with threshold(case):
        params = SH.local_params(full, mesh, fsdp=fsdp)
        whole = model.init(torch.Generator(), "meta")
        batch = {k: torch.from_numpy(v) for k, v in case_batch(cfg, s).items()}
        local = SH.local_batch(batch, mesh)
        with torch.no_grad():
            out["logits"] = _f32(model.forward(params, {
                k: v for k, v in local.items() if k != "targets"}))
        flat = [t.requires_grad_() for t in P.leaves(params)]
        c0 = tp.counts()
        loss = model.loss(params, local)
        with ThreadPoolExecutor(1) as pool:          # a thread with no mesh
            grads = pool.submit(torch.autograd.grad, loss, flat,
                                allow_unused=True,
                                materialize_grads=True).result()
        out["loss/counts"] = _counts(tp.counts_since(c0))
        for t in flat:
            t.requires_grad_(False)
        out["loss"] = np.float32(float(loss.detach()))
        for (path, _), g in zip(store.leaf_paths(params), grads):
            out[f"grad{path}"] = _f32(g)
        ocfg = AdamWConfig()
        step = make_train_step(model, ocfg)
        params, _, met = step(P.tree_map(torch.clone, params),
                              adamw_init(params, ocfg, whole=whole), batch)
        out["step/loss"] = np.float32(met["loss"])
        out["step/grad_norm"] = np.float32(met["grad_norm"])
        out["step/counts"] = _counts(met["collectives"])
        for path, p in store.leaf_paths(params):
            out[f"step/param{path}"] = _f32(p)
    return out


def _counts(c: dict) -> np.ndarray:
    """Counts and bytes of every kind by axis, in ``tp.AXES`` order."""
    return np.asarray([[c[a][op], c[a][f"{op}_bytes"]] for a in tp.AXES
                       for op in tp.OPS])


def port_rank(rank: int, work: str) -> None:
    """Entry of one port rank: each case with and without sequence
    parallelism on its mesh, into ``work/port_<rank>.npz``."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "rendezvous"), WORLD), rank=rank,
        world_size=WORLD)
    out = {}
    try:
        for shape in MESHES:
            mesh = make_host_mesh(*shape, device="cpu")
            names = [c for c, v in CASES.items() if v[2] == shape]
            if shape == (1, 4):
                names += list(UNCHANGED)
            with AX.use_mesh(mesh):
                for case in names:
                    s = UNCHANGED[case][2] if case in UNCHANGED else S
                    for on in (False, True):
                        with sp(on):
                            out.update({f"{case}/{on}/{k}": v for k, v in
                                        port_run(case, mesh, s).items()})
    finally:
        destroy_mesh()
    np.savez(os.path.join(work, f"port_{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# JAX: GSPMD with set_sp(True), four host devices
# ---------------------------------------------------------------------------

def jax_case(case: str, work: str, out: dict) -> None:
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.distributed import sharding as JSH
    from repro.distributed.axes import use_mesh
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models.api import get_model as jax_model
    from repro.optim import adamw as JO
    arch, kw, shape, _ = CASES[case]
    mesh = jmesh(*shape)
    opts = {"xla_allow_excess_precision": False}

    def put_rows(x):
        x = jnp.asarray(x)
        return jax.device_put(x, jax.sharding.NamedSharding(
            mesh, JSH.batch_specs(x, mesh)))

    with use_mesh(mesh), threshold(case, JSH):
        jcfg = jax_arch(arch).reduced(**kw)
        jm = jax_model(jcfg)
        like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        psh = JSH.param_shardings(like, mesh, fsdp=CASES[case][3] != REAL)
        params = jstore.restore(os.path.join(work, "params", case), like,
                                target_shardings=psh)[0]
        batch = {k: put_rows(v) for k, v in case_batch(jcfg).items()}
        logits = jax.jit(jm.forward, compiler_options=opts)(
            params, {"tokens": batch["tokens"]})
        out[f"{case}/logits"] = _f32(logits)
        ocfg = JO.AdamWConfig()

        def both(params, batch):
            loss, grads = jax.value_and_grad(jm.loss)(params, batch)
            p2, _, met = JO.adamw_update(params, grads,
                                         JO.adamw_init(params, ocfg), ocfg)
            return loss, grads, p2, met["grad_norm"]
        loss, grads, p2, gnorm = jax.jit(
            both, out_shardings=(None, psh, psh, None),
            compiler_options=opts)(params, batch)
        out[f"{case}/loss"] = np.float32(loss)
        out[f"{case}/grad_norm"] = np.float32(gnorm)
        for key, tree in (("grad", grads), ("step/param", p2)):
            for k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                out[f"{case}/{key}{jax.tree_util.keystr(k)}"] = _f32(leaf)


def jax_group(cases: list, work: str, out_path: str) -> None:
    """Entry of a JAX process: ``cases`` with ``set_sp(True)``."""
    from repro.core import bdi_value as jbv
    from repro.distributed import axes as JAX_AX
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    assert len(jax.devices()) == WORLD
    JAX_AX.set_sp(True)
    out = {}
    for case in cases:
        jax_case(case, work, out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax": npz, "port": [npz of each rank]}."""
    work = tmp_path_factory.mktemp("tp_sp")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tp_sp as t; t.{call}"
        return subprocess.Popen([sys.executable, "-c", code], env=e,
                                cwd=REPO)
    jenv = dict(env, XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={WORLD}"
        + " --xla_allow_excess_precision=false").strip())
    procs = [start(f"jax_group({list(g)!r}, {str(work)!r}, "
                   f"{str(work / f'jax_{i}.npz')!r})", jenv)
             for i, g in enumerate(GROUPS)]
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
    for i in range(len(GROUPS)):
        jax_rec.update(np.load(work / f"jax_{i}.npz"))
    return {"jax": jax_rec,
            "port": [dict(np.load(work / f"port_{r}.npz"))
                     for r in range(WORLD)]}


# ---------------------------------------------------------------------------
# helpers: a rank's block of a whole leaf
# ---------------------------------------------------------------------------

def _mesh(case: str):
    return EL.abstract_mesh(CASES[case][2], ("data", "model"))


def _coord(case: str, rank: int) -> dict:
    m = CASES[case][2][1]
    return {"data": rank // m, "model": rank % m}


def _paths(case: str) -> list[str]:
    return [p for p, _ in store.leaf_paths(case_params(case))]


def _block(case: str, whole: np.ndarray, path: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole params-shaped array."""
    itemsize = dict(store.leaf_paths(get_model(case_cfg(case)).init(
        torch.Generator(), "meta")))[path].element_size()
    with threshold(case):
        spec = SH._spec_for(path, whole.shape, _mesh(case), itemsize,
                            CASES[case][3] != REAL)
    return SH.local_shards({"x": torch.from_numpy(whole)}, {"x": spec},
                           _mesh(case), coord=_coord(case, rank))["x"].numpy()


def _share(a: np.ndarray, b: np.ndarray) -> float:
    """The share of ``a``'s elements within one bf16 ULP of ``b``'s."""
    gap = np.abs(a - b) - _ulp(np.maximum(np.abs(a), np.abs(b)))
    return float((gap <= 0).mean())


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _held(got: dict, want: dict, case: str, rank: int, whole: bool,
          slack: dict | None = None) -> None:
    """The bounds of the module docstring: ``got``'s keys (this rank's)
    against ``want``'s (whole where ``whole``: cut to the rank's blocks);
    ``slack``: by key, the distance added for a scanned leaf."""
    slack = slack or {}
    assert_model_ulps(got["logits"], want["logits"],
                      MODEL_ULPS + slack.get("logits", 0))
    for k in ("loss", "step/loss"):
        np.testing.assert_allclose(got[k], want["loss"],
                                   rtol=LOSS_RTOL + slack.get("loss", 0))
    np.testing.assert_allclose(got["step/grad_norm"], want["grad_norm"],
                               rtol=GNORM_RTOL + slack.get("grad_norm", 0))
    for path in _paths(case):
        for key in ("grad", "step/param"):
            w = want[f"{key}{path}"]
            if whole:
                w = _block(case, w, path, rank)
            g = got[f"{key}{path}"]
            assert g.shape == w.shape, (key, path, g.shape, w.shape)
            if key == "grad":
                if not w.any():         # the idle cell of an xLSTM block
                    assert not g.any(), path
                    continue
                bound = GRAD_RTOL + slack.get(f"{key}{path}", 0.0)
                assert _rel(g, w) <= bound, (path, rank, _rel(g, w), bound)
            else:
                bound = ULP_SHARE - slack.get(f"{key}{path}", 0.0)
                assert _share(g, w) >= bound, (path, rank, _share(g, w))


def _rank_rec(port: dict, case: str, on: bool) -> dict:
    pre = f"{case}/{on}/"
    out = {k[len(pre):]: v for k, v in port.items() if k.startswith(pre)}
    out["grad_norm"] = out["step/grad_norm"]     # JAX's record's key
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _slack(case: str, base: dict, jax_rec: dict, rank: int,
           routed: bool) -> dict:
    """By key, the port's distance from JAX without sequence parallelism:
    of the scanned leaves, and where ``routed`` of the logits (in ULPs of
    their largest |value|), the losses, the clip norm and every leaf."""
    out = {}
    if routed:
        w = jax_rec["logits"]
        out["logits"] = int(np.ceil(np.abs(base["logits"] - w).max()
                                    / _ulp(np.abs(w).max())))
        for k in ("loss", "grad_norm"):
            out[k] = abs(base[k] / jax_rec[k] - 1)
    for path in _paths(case):
        if path.startswith(SCANNED) or routed:
            out[f"grad{path}"] = _rel(base[f"grad{path}"], _block(
                case, jax_rec[f"grad{path}"], path, rank))
            out[f"step/param{path}"] = 1 - _share(
                base[f"step/param{path}"],
                _block(case, jax_rec[f"step/param{path}"], path, rank))
    return out


def _jax_rec(records, case: str) -> dict:
    return {k[len(case) + 1:]: v for k, v in records["jax"].items()
            if k.startswith(f"{case}/")}


@pytest.mark.parametrize("case", list(CASES))
def test_sp_matches_jax(records, case):
    """Each rank's logits, loss, gradients and first step under sequence
    parallelism against JAX's GSPMD program with ``set_sp(True)``."""
    jax_rec = _jax_rec(records, case)
    for r, port in enumerate(records["port"]):
        got, base = _rank_rec(port, case, True), _rank_rec(port, case, False)
        _held(got, jax_rec, case, r, True,
              _slack(case, base, jax_rec, r, case in ROUTED))


@pytest.mark.parametrize("case", list(CASES))
def test_sp_matches_the_run_without_it(records, case):
    """The same bounds against the port's own run on the same mesh without
    sequence parallelism (the scanned leaves: plus that run's distance
    from JAX, as ``tests/test_torch_tp_families.py`` bounds them against
    the run with no mesh); the loss of the step equal on every rank."""
    jax_rec = _jax_rec(records, case)
    for r, port in enumerate(records["port"]):
        got, base = _rank_rec(port, case, True), _rank_rec(port, case, False)
        _held(got, base, case, r, False,
              _slack(case, base, jax_rec, r, False))
        assert got["step/loss"] == records["port"][0][f"{case}/True/step/loss"]


@pytest.mark.parametrize("case", list(CASES))
def test_norms_bit_equal_across_ranks(records, case):
    """The norm weights' gradients (f32 partials of each rank's S block,
    summed over ``model``) and the weights after the step are the same
    bits on every rank."""
    ports = records["port"]
    keys = [f"{case}/True/{k}{p}" for p in _paths(case) if _is_norm(p)
            for k in ("grad", "step/param")]
    assert keys
    for port in ports[1:]:
        for k in keys:
            np.testing.assert_array_equal(port[k], ports[0][k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_sp_collectives(records, case):
    """Under sequence parallelism the step reduce-scatters over ``model``
    (never over ``data``) and its model-axis all-reduces carry fewer bytes
    than without it; each rank's collectives equal the dry run's trace of
    the same step at its coordinate (``launch/dryrun.trace(sp=True)``)."""
    cfg, (d, m) = case_cfg(case), CASES[case][2]
    ops = list(tp.OPS)
    ar, rs = ops.index("all_reduce"), ops.index("reduce_scatter")
    for r, port in enumerate(records["port"]):
        on, off = port[f"{case}/True/step/counts"], \
            port[f"{case}/False/step/counts"]
        assert on[rs, 0] > 0 and off[rs, 0] == 0
        assert on[len(ops) + rs, 0] == 0             # none over data
        assert on[ar, 1] < off[ar, 1]
        with threshold(case):
            row = D.trace(cfg, ShapeConfig("x", S, B, "train"),
                          EL.abstract_mesh((d, m), ("data", "model"),
                                           _coord(case, r)),
                          AdamWConfig(), 1, torch.float32,
                          fsdp=CASES[case][3] != REAL, sp=True)
        by_axis = row["collectives"]["by_axis"]
        want = np.asarray([[by_axis[a][op], by_axis[a][f"{op}_bytes"]]
                           for a in tp.AXES for op in tp.OPS])
        np.testing.assert_array_equal(on, want, err_msg=f"{case} {r}")


@pytest.mark.parametrize("case", list(UNCHANGED))
def test_unsplit_streams_are_the_run_without_sp(records, case):
    """At S = 62, which the model axis of 4 does not divide, the stream
    stays whole (JAX's fallback layout), and seamless's encoder-decoder
    never splits it: logits, loss, gradients, the step and its
    collectives equal the run without sequence parallelism bit for bit."""
    for port in records["port"]:
        got, base = _rank_rec(port, case, True), _rank_rec(port, case, False)
        assert set(got) == set(base)
        for k in got:
            np.testing.assert_array_equal(got[k], base[k], err_msg=k)
        assert not got["step/counts"][list(tp.OPS).index("reduce_scatter"),
                                      0]


def test_seq_layout_follows_jax_rule():
    """``axes.seq_split`` and ``shard_seq``: off by default and with no
    mesh; under a model axis of 4 the stream is split where 4 divides S
    (a whole tensor cut to the block, a block kept), else whole; a data
    axis alone never splits it."""
    x = torch.zeros(2, 8, 3, device="meta")
    assert not AX.SP_ENABLED and not AX.seq_split(8)
    with sp(True):
        assert not AX.seq_split(8) and AX.shard_seq(x, 8) is x
        with AX.use_mesh(EL.abstract_mesh((1, 4), ("data", "model"))):
            assert AX.seq_split(8) and not AX.seq_split(6)
            assert tuple(AX.shard_seq(x, 8).shape) == (2, 2, 3)
            blk = torch.zeros(2, 2, 3, device="meta")
            assert AX.shard_seq(blk, 8) is blk
            y = torch.zeros(2, 6, 3, device="meta")
            assert AX.shard_seq(y, 6) is y
            with pytest.raises(ValueError):
                AX.shard_seq(torch.zeros(2, 3, 3, device="meta"), 8)
        with AX.use_mesh(EL.abstract_mesh((4, 1), ("data", "model"))):
            assert not AX.seq_split(8)
    with AX.use_mesh(EL.abstract_mesh((1, 4), ("data", "model"))):
        assert not AX.seq_split(8) and AX.shard_seq(x, 8) is x
