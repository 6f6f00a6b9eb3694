"""Tensor-parallel serving of the port vs the JAX package, on the CPU.

The port's dense GQA decoders under a ``(1, m)`` mesh: each rank holds
its shards of the params (``distributed/sharding.local_params``) and of
the decode cache, and the model axis's collectives go through
``distributed/tp.py`` over gloo.  JAX runs the same configs under
``use_mesh`` with the params placed by ``param_shardings(fsdp=False)``
and the quantised cache by ``cache_specs``, GSPMD inserting its
collectives.

One module fixture starts, all at once: two port ranks and one JAX
process with ``XLA_FLAGS=--xla_force_host_platform_device_count=2
--xla_allow_excess_precision=false`` for the ``(1, 2)`` cases (reduced
yi-6b, qwen2.5-14b with random QKV biases, gemma3-27b at 6 layers whose
rings of 8 wrap, internvl2-76b with frontend embeddings), and four port
ranks and a JAX process with four host devices for reduced yi-6b at 8
heads and 4 KV heads under ``(1, 4)``.  Each writes ``.npz`` files
(``tests/test_torch_distributed.py``'s pattern: gloo over a
``FileStore`` in the test's temporary directory).  The params are the
port's init from seed 0, restored by the JAX store; JAX's
``_pow2_scale`` is swapped for the exact construction of 2^e
(``tests/test_torch_decode.exact_pow2_scale``, test-only).

Tolerances, each from what the packages do differently:

* logits of ``forward``, of the prefill and of 8 teacher-forced decode
  steps, and every bf16 cache leaf: within 2 bf16 ULPs of the array's
  largest |value| (``tests/test_torch_decode.py``'s whole-model bound;
  the partial sums of the row-parallel products are f32 dots of the
  same values, summed over the ranks in f32 and rounded once, as JAX's
  HLO does, but each rank's dot sums in another order than XLA's);
* the same bound for the port's TP logits against the port's own m = 1
  run (measured here: equal);
* the quantised cache (int8 deltas, f32 bases and scales): bit-equal to
  JAX's block, as at m = 1 in ``test_torch_decode.py``;
* greedy tokens of ``launch/serve.dense_generate``: equal to JAX's greedy
  loop up to ties that ``serving/parity.GreedyParity`` reports (two
  logits within one bf16 ULP);
* ``local_shards`` against JAX's ``addressable_shards``: bit-equal, leaf
  by leaf, on every rank.
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
from jax.sharding import PartitionSpec as JP

import _workers  # noqa: F401  (shares the cores among xdist workers)

from repro_torch.checkpoint import store
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as TP
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.launch import elastic as EL
from repro_torch.launch.mesh import destroy_mesh, make_host_mesh
from repro_torch.launch.serve import dense_generate
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.serving.parity import GreedyParity
from test_torch_decode import assert_model_ulps, exact_pow2_scale

REPO = Path(__file__).resolve().parents[1]
# case -> (arch, reduced() overrides, model axis)
CASES = {"yi-6b": ("yi-6b", {}, 2),
         "qwen2.5-14b": ("qwen2.5-14b", {}, 2),
         "gemma3-27b": ("gemma3-27b", {"n_layers": 6}, 2),
         "internvl2-76b": ("internvl2-76b", {}, 2),
         "yi-6b-m4": ("yi-6b", {"n_heads": 8, "n_kv_heads": 4}, 4)}
WORLDS = (2, 4)
PROMPT, STEPS = 10, 8          # prefill 10 tokens, then 8 decode steps
GEN = STEPS + 1                # greedy tokens of dense_generate
QUANT_STEPS = 8
MODEL_ULPS = 2


def case_cfg(case: str):
    arch, kw, _ = CASES[case]
    return get_arch(arch).reduced(**kw)


def cases_of(world: int) -> list[str]:
    return [c for c, (_, _, m) in CASES.items() if m == world]


def case_params(case: str) -> dict:
    """The port's init of the case from seed 0; qwen's QKV biases (zeros
    at init) drawn from seed 1, so that their slicing shows."""
    cfg = case_cfg(case)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    for name in ("wq", "wk", "wv"):
        b = params["blocks"]["attn"][name].get("b")
        if b is not None:
            b.copy_(torch.randn(b.shape, generator=gen) * 0.5)
    return params


def case_inputs(cfg) -> tuple[np.ndarray, np.ndarray | None]:
    """tokens [2, PROMPT + STEPS] and, for a frontend config, embeds
    [2, n, D] (bf16 values as f32)."""
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)
    emb = None
    if cfg.n_frontend_embeds:
        emb = (rng.standard_normal((2, cfg.n_frontend_embeds, cfg.d_model))
               * 0.02).astype(np.float32)
        emb = torch.from_numpy(emb).to(torch.bfloat16).float().numpy()
    return toks, emb


def has_quant(cfg) -> bool:
    return not T.cache_slots(cfg)[2][1]


def _np(t) -> np.ndarray:
    """A tensor or array as numpy: bf16 as its int16 bits."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the port: one rank
# ---------------------------------------------------------------------------

def port_run(cfg, params: dict, toks: np.ndarray, emb) -> dict:
    """Forward, prefill, teacher-forced decode steps, the quantised cache
    and the greedy loop of one case, on whatever mesh is active."""
    out = {}
    off = cfg.n_frontend_embeds
    batch = {"tokens": torch.from_numpy(toks[:, :PROMPT])}
    if emb is not None:
        batch["embeds"] = torch.from_numpy(emb).to(torch.bfloat16)
    out["forward"] = _f32(T.forward(cfg, params, batch))
    logits, cache = T.prefill(cfg, params, batch, off + PROMPT + STEPS + 1)
    out["logits/0"] = _f32(logits)
    for i in range(STEPS):
        logits, cache = T.decode_step(cfg, params, cache, torch.from_numpy(
            toks[:, PROMPT + i]), off + PROMPT + i)
        out[f"logits/{i + 1}"] = _f32(logits)
    for path, leaf in store.leaf_paths(cache):
        out[f"cache{path}"] = _np(leaf)
    if has_quant(cfg):
        qc = T.init_quant_cache(cfg, 2, QUANT_STEPS + 2, device="cpu")
        for t in range(QUANT_STEPS):
            logits, qc = T.decode_step_quant(cfg, params, qc, torch.from_numpy(
                toks[:, t]), t)
            out[f"quant/logits/{t}"] = _f32(logits)
        for path, leaf in store.leaf_paths(qc):
            out[f"quant/cache{path}"] = _np(leaf)
    g = dense_generate(cfg, params, torch.from_numpy(toks[:, :PROMPT]), GEN,
                       keep_logits=True)
    out["greedy/tokens"] = np.asarray(g["tokens"])
    out["greedy/logits"] = g["logits"].numpy()
    out["greedy/collectives"] = np.asarray(
        [g["collectives"]["per_step"]["model"][k] for k in ("all_reduce",
                                                            "all_gather")]
        + [sum(g["collectives"]["per_step"]["data"].values())])
    return out


def port_rank(rank: int, world: int, work: str) -> None:
    """Entry of one port rank of a ``(1, world)`` mesh: every case of that
    world, into ``work/port_<world>_<rank>.npz``."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, f"rendezvous_{world}"), world), rank=rank,
        world_size=world)
    out = {}
    try:
        mesh = make_host_mesh(1, world, device="cpu")
        with AX.use_mesh(mesh):
            for case in cases_of(world):
                cfg = case_cfg(case)
                full = case_params(case)
                local = SH.local_params(full, mesh)
                for path, leaf in store.leaf_paths(local):
                    out[f"{case}/shard{path}"] = _np(leaf)
                drawn = T.init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu", local=SH.Local(mesh))
                same = all(torch.equal(a, b) for (pa, a), (_, b) in zip(
                    store.leaf_paths(drawn), store.leaf_paths(local))
                    if "['b']" not in pa)
                out[f"{case}/init_local_equal"] = np.asarray(same)
                for k, v in port_run(cfg, local, *case_inputs(cfg)).items():
                    out[f"{case}/{k}"] = v
    finally:
        destroy_mesh()
    np.savez(os.path.join(work, f"port_{world}_{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# JAX: one process, ``world`` host devices
# ---------------------------------------------------------------------------

def jax_world(world: int, work: str) -> None:
    """Entry of the JAX process: every case of a ``(1, world)`` mesh under
    GSPMD, into ``work/jax_<world>.npz``."""
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.core import bdi_value as jbv
    from repro.distributed import sharding as JSH
    from repro.distributed.axes import use_mesh
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models import transformer as JT
    from repro.models.api import get_model as jax_model
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    assert len(jax.devices()) == world
    mesh = jmesh(1, world)
    where = {d: i for i, d in enumerate(mesh.devices.flat)}
    opts = {"xla_allow_excess_precision": False}
    out = {}
    with use_mesh(mesh):
        for case in cases_of(world):
            arch, kw, _ = CASES[case]
            jcfg = jax_arch(arch).reduced(**kw)
            jm = jax_model(jcfg)
            like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
            params = jstore.restore(
                os.path.join(work, "params", case), like,
                target_shardings=JSH.param_shardings(like, mesh,
                                                     fsdp=False))[0]
            for k, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
                for s in leaf.addressable_shards:
                    out[f"{case}/shard/{where[s.device]}"
                        f"{jax.tree_util.keystr(k)}"] = _np(s.data)
            toks, emb = case_inputs(jcfg)
            off = jcfg.n_frontend_embeds
            batch = {"tokens": jnp.asarray(toks[:, :PROMPT])}
            if emb is not None:
                batch["embeds"] = jnp.asarray(emb, jnp.bfloat16)
            prefill = jax.jit(jm.prefill, static_argnums=2,
                              compiler_options=opts)
            step = jax.jit(jm.decode_step, compiler_options=opts)
            out[f"{case}/forward"] = _f32(jax.jit(
                jm.forward, compiler_options=opts)(params, batch))
            logits, cache = prefill(params, batch, off + PROMPT + STEPS + 1)
            out[f"{case}/logits/0"] = _f32(logits)
            for i in range(STEPS):
                logits, cache = step(params, cache,
                                     jnp.asarray(toks[:, PROMPT + i]),
                                     jnp.int32(off + PROMPT + i))
                out[f"{case}/logits/{i + 1}"] = _f32(logits)
            for path, leaf in store.leaf_paths(cache):
                out[f"{case}/cache{path}"] = _np(leaf)
            if has_quant(case_cfg(case)):
                qc = JT.init_quant_cache(jcfg, 2, QUANT_STEPS + 2)
                qc = jax.device_put(qc, jax.tree.map(
                    lambda s: jax.sharding.NamedSharding(mesh, s),
                    JSH.cache_specs(qc, mesh),
                    is_leaf=lambda s: isinstance(s, JP)))
                qstep = jax.jit(lambda p, c, tok, t: JT.decode_step_quant(
                    jcfg, p, c, tok, t), compiler_options=opts)
                for t in range(QUANT_STEPS):
                    logits, qc = qstep(params, qc, jnp.asarray(toks[:, t]),
                                       jnp.int32(t))
                    out[f"{case}/quant/logits/{t}"] = _f32(logits)
                for path, leaf in store.leaf_paths(qc):
                    out[f"{case}/quant/cache{path}"] = _np(leaf)
            # greedy, as dense_generate: prompt only, max_len PROMPT + GEN
            logits, cache = prefill(params, {"tokens": batch["tokens"]},
                                    PROMPT + GEN)
            tok = jnp.argmax(logits, -1)
            got, rows = [tok], [_f32(logits)]
            for t in range(PROMPT, PROMPT + GEN - 1):
                logits, cache = step(params, cache, tok, jnp.int32(t))
                tok = jnp.argmax(logits, -1)
                got.append(tok)
                rows.append(_f32(logits))
            out[f"{case}/greedy/tokens"] = np.stack(
                [np.asarray(t) for t in got], 1)
            out[f"{case}/greedy/logits"] = np.stack(rows)
    np.savez(os.path.join(work, f"jax_{world}.npz"), **out)


# ---------------------------------------------------------------------------
# the fixture: all processes at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"jax": {world: npz}, "port": {world: [npz of each rank]}}."""
    work = tmp_path_factory.mktemp("tensor_parallel")
    for case in CASES:
        store.save(str(work / "params" / case), 0, case_params(case))
    path = os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               OMP_NUM_THREADS="1")

    def start(call: str, e: dict):
        code = f"import test_torch_tensor_parallel as t; t.{call}"
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


def _keys(rec: dict, case: str, prefix: str) -> list[str]:
    keys = sorted(k for k in rec if k.startswith(f"{case}/{prefix}"))
    assert keys, (case, prefix)
    return keys


def _cache_block(jax_rec: dict, case: str, prefix: str, cache, world: int,
                 rank: int) -> list[tuple[str, np.ndarray]]:
    """JAX's global cache leaves of ``case`` cut to rank ``rank``'s block
    by the port's ``cache_specs`` and ``local_shards`` (``cache`` gives
    the tree's structure)."""
    glob = store._rebuild(cache, iter(
        torch.from_numpy(jax_rec[f"{case}/{prefix}{path}"])
        for path, _ in store.leaf_paths(cache)))
    mesh = EL.abstract_mesh((1, world), ("data", "model"))
    block = SH.local_shards(glob, SH.cache_specs(glob, mesh), mesh,
                            coord={"data": 0, "model": rank})
    return [(p, leaf.numpy()) for p, leaf in store.leaf_paths(block)]


def _as_f32(bits: np.ndarray, like) -> np.ndarray:
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
    return bits


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_local_shards_equal_jax_addressable_shards(records, case):
    world, jax_rec, ports = _ranks(records, case)
    keys = _keys(ports[0], case, "shard")
    assert len(keys) == len(P.leaves(case_params(case)))
    for r, port in enumerate(ports):
        for k in keys:
            path = k[len(f"{case}/shard"):]
            want = jax_rec[f"{case}/shard/{r}{path}"]
            assert port[k].dtype == want.dtype and port[k].shape == \
                want.shape, (k, r)
            np.testing.assert_array_equal(port[k], want, err_msg=f"{k} {r}")
        assert bool(port[f"{case}/init_local_equal"])


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_logits_match_jax(records, case):
    _, jax_rec, ports = _ranks(records, case)
    keys = _keys(jax_rec, case, "logits/")
    assert len(keys) == STEPS + 1
    keys.append(f"{case}/forward")
    assert jax_rec[keys[-1]].shape[1] == case_cfg(case).n_frontend_embeds \
        + PROMPT
    for port in ports:
        for k in keys:
            assert_model_ulps(port[k], jax_rec[k], MODEL_ULPS)
    # every rank returns the same whole logits
    for port in ports[1:]:
        for k in keys:
            np.testing.assert_array_equal(port[k], ports[0][k])


@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_match_jax(records, case):
    world, jax_rec, ports = _ranks(records, case)
    cfg = case_cfg(case)
    like = T.init_cache(cfg, 2, cfg.n_frontend_embeds + PROMPT + STEPS + 1,
                        device="cpu")
    for r, port in enumerate(ports):
        for path, want in _cache_block(jax_rec, case, "cache", like, world,
                                       r):
            got = port[f"{case}/cache{path}"]
            assert got.shape == want.shape, (path, got.shape, want.shape)
            leaf = getattr(like, path.lstrip("."))
            assert_model_ulps(_as_f32(got, leaf), _as_f32(want, leaf))
        if case == "gemma3-27b":
            assert port[f"{case}/cache.ring_k"].shape[:4] == \
                (5, 2, 8, cfg.n_kv_heads // world)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if has_quant(case_cfg(c))])
def test_quant_decode_matches_jax(records, case):
    world, jax_rec, ports = _ranks(records, case)
    cfg = case_cfg(case)
    like = T.init_quant_cache(cfg, 2, QUANT_STEPS + 2, device="cpu")
    for r, port in enumerate(ports):
        for t in range(QUANT_STEPS):
            k = f"{case}/quant/logits/{t}"
            assert_model_ulps(port[k], jax_rec[k], MODEL_ULPS)
        for path, want in _cache_block(jax_rec, case, "quant/cache", like,
                                       world, r):
            np.testing.assert_array_equal(port[f"{case}/quant/cache{path}"],
                                          want, err_msg=f"{path} rank {r}")


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_jax(records, case):
    world, jax_rec, ports = _ranks(records, case)
    want = jax_rec[f"{case}/greedy/tokens"]
    for port in ports:
        got = port[f"{case}/greedy/tokens"]
        assert got.shape == want.shape == (2, GEN)
        np.testing.assert_array_equal(got, ports[0][f"{case}/greedy/tokens"])
        rows = torch.from_numpy(port[f"{case}/greedy/logits"])
        ref = torch.from_numpy(jax_rec[f"{case}/greedy/logits"])
        par = GreedyParity()
        for j in range(GEN):
            par.check(j, {b: int(want[b, j]) for b in range(2)},
                      {b: int(got[b, j]) for b in range(2)},
                      lambda sid, j=j: rows[j, sid],
                      lambda sid, j=j: ref[j, sid])
        print(f"{case}: {par.compared} tokens equal, ties {par.ties}")
        assert par.compared >= 0.75 * want.size, par
        # one all-reduce after each attention and MLP, one for the
        # embedding, one gather of the logits, every step; nothing over
        # the data axis of one
        np.testing.assert_array_equal(
            port[f"{case}/greedy/collectives"],
            [2 * case_cfg(case).n_layers + 1, 1, 0])


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_matches_one_rank(records, case):
    """The port's TP logits against the port's own run without a mesh."""
    _, _, ports = _ranks(records, case)
    cfg = case_cfg(case)
    want = port_run(cfg, case_params(case), *case_inputs(cfg))
    for port in ports:
        for k, v in want.items():
            if "logits" in k:
                assert_model_ulps(port[f"{case}/{k}"], v, MODEL_ULPS)
        np.testing.assert_array_equal(port[f"{case}/greedy/tokens"],
                                      want["greedy/tokens"])


# ---------------------------------------------------------------------------
# refusals (an abstract mesh: each raises before any collective)
# ---------------------------------------------------------------------------

def _abstract(model: int):
    return AX.use_mesh(EL.abstract_mesh((1, model), ("data", "model")))


def test_training_under_a_model_axis_is_refused(monkeypatch):
    """Training runs under a model axis (``tests/test_torch_tp_train.py``,
    ``tests/test_torch_tp_replicated.py``: moment tiles that straddle the
    model shards too), beside a data axis (``tests/test_torch_dp_
    tp.py``) and a pod axis (``tests/test_torch_tp_pod.py``), and with
    ``bdi8`` moments whose tile of 128 straddles two data blocks (reduced
    yi-6b at d_model 256 on a data axis of 4, FSDP at a threshold of 64
    KiB, test-only: wo's 2 tiles of D over 4 blocks, whose moments a rank
    keeps for its block of the head dim).  Still refused, naming the
    ROADMAP item: ``launch/train.train()``, which runs no mesh.  A step of
    CPU tensors under an abstract mesh (the dry run's, which traces
    ``meta`` tensors) raises at its first collective."""
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = case_cfg("yi-6b")
    params = case_params("yi-6b")
    batch = {k: torch.from_numpy(v) for k, v in TP.make_train_batch(
        cfg, ShapeConfig("t", 8, 2, "train"), TP.DataConfig(seed=3),
        step=0).items()}
    wide = get_arch("yi-6b").reduced(d_model=256, d_ff=256, vocab=256)
    monkeypatch.setattr(SH, "FSDP_THRESHOLD_BYTES", 64 << 10)
    with AX.use_mesh(EL.abstract_mesh((4, 1), ("data", "model"))):
        whole = T.init_params(wide, torch.Generator(), "meta")
        local = SH.local_params(whole, AX.current_mesh(), fsdp=True,
                                coord={"data": 0, "model": 0})
        state = adamw_init(local, AdamWConfig(moment_dtype="bdi8"),
                           whole=whole)
        assert state["m"]["blocks"]["attn"]["wo"]["w"]["deltas"].shape == \
            (2, 4, 16, 2, 128)
    monkeypatch.undo()
    with _abstract(2):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 2"):
            train("yi-6b", steps=1, device="cpu")
    with AX.use_mesh(EL.abstract_mesh((2, 1, 2),
                                      ("pod", "data", "model"))):
        tp.check_layout(cfg)
        local = SH.local_params(params, AX.current_mesh())
        step = make_train_step(get_model(cfg), AdamWConfig())
        with pytest.raises(ValueError, match="meta tensors only"):
            step(local, {}, batch)
    assert float(get_model(cfg).loss(params, batch)) > 0     # no mesh


@pytest.mark.parametrize("what", ["kv_heads", "family", "data_axis"])
def test_layouts_this_slice_does_not_take_are_refused(what):
    """Caches whose KV heads and rows (or a ring's window) do not divide m
    are laid out as JAX's ``cache_specs`` lays them out (the ``kv_heads``
    case, held on an abstract mesh of 2 and of 3 against the blocks JAX's
    specs give, dense and quantised, gemma3's rings among them; computed
    on against JAX's GSPMD program in ``tests/test_torch_tp_whole.py``):
    over T or the window where they divide m, else over the head dim,
    else whole.  Still refused, each entry point naming the ROADMAP item:
    an MoE config whose experts do not divide m (JAX's ``moe_ffn``
    asserts; the MoE and MLA decoders are laid out, ``tests/test_torch_
    tp_moe.py``, and so are the recurrent and encoder-decoder families,
    ``tests/test_torch_tp_families.py``, whose caches come out as each
    rank's blocks); on the data axes (a pod axis beside the data and
    model axes is laid out, ``tests/test_torch_tp_pod.py``), an MoE
    batch whose rows do not divide them (JAX refuses such a batch in
    every family, at the stream's batch constraint)."""
    cfg, axes = case_cfg("yi-6b"), ((1, 2), ("data", "model"))
    toks = torch.ones((2, 4), dtype=torch.int64)
    if what == "kv_heads":
        from repro.configs.registry import get_arch as jax_arch
        from repro.distributed import sharding as JSH
        from repro.models import transformer as JT
        for arch, kw, m, rows in (
                ("gemma3-27b", {"n_kv_heads": 1}, 2, (8, 7)),
                ("yi-6b", {"n_kv_heads": 1}, 2, (8, 7)),
                ("yi-6b", {"n_kv_heads": 1}, 3, (9, 7)),
                ("yi-6b", {"n_kv_heads": 1, "d_model": 40}, 4, (8, 7))):
            port_cfg, jcfg = get_arch(arch).reduced(**kw), \
                jax_arch(arch).reduced(**kw)
            sizes = {"data": 1, "model": m}
            jmesh = type("Mesh", (), {"shape": sizes,
                                      "axis_names": ("data", "model")})()
            with _abstract(m):
                tp.check_layout(port_cfg)
                for n in rows:
                    got = [get_model(port_cfg).init_cache(2, n,
                                                          device="meta")]
                    want = [jax.eval_shape(lambda: JT.init_cache(jcfg, 2,
                                                                 n))]
                    if not T.cache_slots(port_cfg)[2][1]:
                        got.append(T.init_quant_cache(port_cfg, 2, n,
                                                      device="meta"))
                        want.append(jax.eval_shape(
                            lambda: JT.init_quant_cache(jcfg, 2, n)))
                    for port, jc in zip(got, want):
                        specs = jax.tree.leaves(
                            JSH.cache_specs(jc, jmesh),
                            is_leaf=lambda x: isinstance(x, JP))
                        blocks = [tuple(d // (m if a == "model" else 1)
                                        for d, a in zip(leaf.shape,
                                                        tuple(sp) + (None,)
                                                        * leaf.ndim))
                                  for leaf, sp in zip(jax.tree.leaves(jc),
                                                      specs)]
                        assert [tuple(t.shape) for t in port] == blocks, \
                            (arch, m, n)
                        assert [tp.split_dim(t) for t in port] == [
                            next((i for i, a in enumerate(sp)
                                  if a == "model"), None)
                            for sp in specs], (arch, m, n)
        return
    if what == "family":
        cfg = get_arch("deepseek-v2-lite-16b").reduced(n_experts=3)
    else:
        # 3 rows over the pod and data axes of 4: JAX's shard_map cannot
        # route them (every other entry point of yi-6b is laid out there)
        moe = get_model(get_arch("deepseek-v2-lite-16b").reduced())
        with AX.use_mesh(EL.abstract_mesh((2, 2, 2),
                                          ("pod", "data", "model"))):
            tp.check_layout(cfg)
            whole = moe.init(torch.Generator(), "meta")
            local = SH.local_params(whole, AX.current_mesh(), fsdp=True)
            three = torch.ones((3, 4), dtype=torch.int64, device="meta")
            with tp.whole_rows(), pytest.raises(
                    NotImplementedError, match="ROADMAP Queue 1 item 2"):
                moe.forward(local, {"tokens": three})
        return
    m = get_model(cfg)
    calls = [lambda: m.prefill({}, {"tokens": toks}, 8),
             lambda: m.decode_step({}, None, toks[:, 0], 4),
             lambda: m.init_cache(2, 8, device="cpu"),
             lambda: m.forward({}, {"tokens": toks})]
    if what != "family":
        calls.append(lambda: T.init_quant_cache(cfg, 2, 8, device="cpu"))
    with AX.use_mesh(EL.abstract_mesh(*axes)):
        for call in calls:
            with pytest.raises(NotImplementedError,
                               match="ROADMAP Queue 1 item 2"):
                call()
    if what == "family":
        for family in ("xlstm-350m", "hymba-1.5b", "seamless-m4t-large-v2"):
            with _abstract(2):
                cache = get_model(get_arch(family).reduced(
                    n_heads=4, n_kv_heads=4)).init_cache(2, 8, device="meta")
            whole = get_model(get_arch(family).reduced(
                n_heads=4, n_kv_heads=4)).init_cache(2, 8, device="meta")
            assert sum(t.numel() for t in cache) * 2 == \
                sum(t.numel() for t in whole), family


def test_collectives_are_plain_ops_without_a_model_axis():
    """At m = 1 each function of ``tp.py`` is the single-device form and
    issues nothing (the counters stay); beside a data axis too, where
    every rank holds the whole batch (``tp.whole_rows``)."""
    before = tp.counts()
    x = torch.randn(3, 5, 8).to(torch.bfloat16)
    w = torch.randn(8, 6).to(torch.bfloat16)
    for mesh in (None, EL.abstract_mesh((2, 1), ("data", "model"))):
        with AX.use_mesh(mesh), tp.whole_rows():
            assert tp.model_size() == 1 and tp.model_rank() == 0
            assert torch.equal(tp.row_parallel(x, w), torch.matmul(x, w))
            toks = torch.tensor([[0, 5, 7]])
            assert torch.equal(tp.vocab_embed(w, toks), w[toks])
            assert tp.gather_vocab(x) is x
            p = torch.ones(3)
            assert tp.reduce_from_model(p) is p
    assert tp.counts() == before
    with pytest.raises(TypeError, match="f32"):
        tp.reduce_from_model(x)
