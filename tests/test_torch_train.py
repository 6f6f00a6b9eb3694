"""The port's training path vs the JAX package, on the CPU.

``repro_torch``'s data pipeline, losses, full-sequence attention, dense
forward, loss and gradients, and ``launch/train.train`` with its
checkpoints, held against the JAX package on the reduced yi-6b config
(gemma3-27b's reduced config for the sliding window), and a ``train()``
step of each of the xlstm-350m, hymba-1.5b and seamless-m4t-large-v2
reduced configs from a step-0 checkpoint the port writes.  Inputs are made
with numpy from a seed.  Parameters are the port's init, handed to the
JAX side bit for bit through a checkpoint the port writes in the JAX
on-disk format; both packages' ``train()`` start from one step-0
checkpoint (the port's init, zero moments) that the port writes, so
every training run resumes a checkpoint of the other package or its own.

The JAX side runs in one subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (with XLA's default its
jitted code keeps bf16 intermediates in f32 and drifts from any op-by-op
implementation), and with ``repro.core.bdi_value._pow2_scale`` replaced,
before its first trace, by the exact construction of 2^e from bits that
the port uses: optimizer moments have scales far outside XLA's exact
``exp2`` range (about 2^-12..2^12).  That swap is for these tests only.

Tolerances, each from what the two packages do differently:

* pipeline batches: equal, byte for byte (the same numpy code);
* f32 results of f32 inputs (cross-entropy, ``_chunked_attn``): rtol
  1e-6 / atol 1e-6 (softmax and logsumexp sums in another order);
* bf16 results of one layer (``gqa_forward``, the chunked loss's input
  gradients): within 2 bf16 ULPs elementwise (f32 sums reordered, then
  one rounding to bf16; a value near a rounding boundary lands on either
  side, and one such flip in an input moves the output by at most
  another ULP);
* logits of the whole model: within 2 bf16 ULPs of the largest |logit|
  (a hidden value that flipped by one ULP in layer 1 moves every logit
  it feeds by the same absolute amount, which is several ULPs of a
  small logit);
* scalar losses, and the first loss of a run resumed from the other
  package's checkpoint against the other package's loss at that step
  (the same state, restored bit for bit): rtol 1e-4;
* gradients: relative Frobenius error per leaf <= 1e-2 (bf16 gradients,
  whose ULP is 2^-8 relative, from f32 sums in another order);
* one ``train()`` step from one state (a run resumed from the other
  package's step-9 checkpoint against the other package's step 10): the
  params within one bf16 ULP for at least 99% of each leaf's elements,
  and each loaded moment leaf (m and v) within a relative Frobenius error
  of 2e-2.  Measured here, at steps 5 and 9, both ways: 99.70% and 6.0e-3
  at worst.  A step whose params were not updated, whose moments were
  zeroed or whose bdi8 masks stayed in the byte layout fails them
  (``test_one_step_bounds_refuse_a_faulty_step``).  States are not
  compared after 10 steps: under ``bdi8`` a one-ULP gradient difference
  that flips a second moment's rounding to zero moves that element by lr
  * m / eps, and after 5 steps a few percent of elements differ by
  hundreds of ULPs (the same algorithm in both packages: a single update
  on identical inputs is bit-equal, ``tests/test_torch_optim.py``);
* ``train()`` losses over 10 steps: rtol 2e-3 under ``f32`` moments and
  1e-2 under ``bdi8`` (the largest port-vs-JAX gaps measured here: 1.7e-4
  and 3.5e-3).  These hold the trajectories near each other; they cannot
  tell ``bdi8`` from ``f32`` moments (1.8e-3 apart here), which the state
  checks above do.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _workers  # noqa: F401  (shares the cores among xdist workers)

from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as TP
from repro_torch.launch.train import train
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.models.params import layer, leaves
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import (_load, _store_leaves, export_state,
                                     import_state)

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("yi-6b", "gemma3-27b")          # gemma3: window 8 on every layer
FAMILIES = ("xlstm-350m", "hymba-1.5b", "seamless-m4t-large-v2")
REMAT = {"yi-6b": (True, False), "gemma3-27b": (True,)}
TRAIN = dict(smoke=True, seq_len=32, batch=4, log_every=100)
DTYPES = ("f32", "bdi8")
TRAJ_RTOL = {"f32": 2e-3, "bdi8": 1e-2}
STEP_ULP_SHARE = 0.99                   # params within 1 bf16 ULP, a leaf
STEP_MOMENT_RTOL = 2e-2                 # loaded m, v: relative Frobenius


# ---------------------------------------------------------------------------
# inputs, made the same way on both sides
# ---------------------------------------------------------------------------

def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, kept as f32 (exact in both packages)."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.view(np.float32)


def ce_inputs() -> dict:
    rng = np.random.default_rng(11)
    return {"logits": (rng.standard_normal((3, 13, 50)) * 3).astype(
                np.float32),
            "targets": rng.integers(0, 50, (3, 13)).astype(np.int32),
            "mask": (rng.random((3, 13)) > 0.2).astype(np.float32),
            "x": _bf16(rng.standard_normal((3, 13, 64))),
            "head": _bf16(rng.standard_normal((64, 50)) / 8)}


def attn_inputs() -> dict:
    rng = np.random.default_rng(12)
    return {"q": rng.standard_normal((2, 13, 2, 2, 16)).astype(np.float32),
            "k": rng.standard_normal((2, 13, 2, 16)).astype(np.float32),
            "v": rng.standard_normal((2, 13, 2, 16)).astype(np.float32),
            "x": _bf16(rng.standard_normal((2, 16, 64)))}


def model_batch(cfg) -> dict:
    return TP.make_train_batch(cfg, ShapeConfig("t", 24, 3, "train"),
                               TP.DataConfig(seed=2), step=5)


def port_params(name: str):
    """The port's init of the reduced config (the JAX side restores the
    same numbers from the fixture's checkpoint, :func:`jax_params`)."""
    cfg = get_arch(name).reduced()
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _copy(src, dst, steps=None) -> str:
    """Copy a checkpoint directory; only the steps in ``steps`` if given."""
    src, dst = str(src), str(dst)
    shutil.copytree(src, dst, ignore=None if steps is None else (
        lambda d, names: [n for n in names if n.startswith("step_")
                          and int(n[5:]) not in steps] if d == src else []))
    return dst


# ---------------------------------------------------------------------------
# the JAX side (subprocess)
# ---------------------------------------------------------------------------

def exact_pow2_scale(maxres, qmax):
    """``bdi_value._pow2_scale`` with 2^e built from its bits."""
    import jax
    import jax.numpy as jnp
    ratio = (maxres / qmax).astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(ratio, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0)
    s = jax.lax.bitcast_convert_type(
        jnp.where(e >= -126, (e + 127) << 23, 1 << 22).astype(jnp.int32),
        jnp.float32)
    return jnp.where(maxres > 0, s, jnp.float32(1.0))


def jax_params(work: str, name: str):
    """The port's params of ``name``, restored by the JAX store."""
    import jax
    from repro.checkpoint import store as jstore
    from repro.configs.registry import get_arch as jax_arch
    from repro.models.api import get_model
    cfg = jax_arch(name).reduced()
    like = jax.eval_shape(get_model(cfg).init, jax.random.PRNGKey(0))
    return cfg, jstore.restore(os.path.join(work, "params", name), like)[0]


def jax_main(work: str) -> None:
    """Subprocess entry: the JAX records, into ``work``."""
    import jax
    import jax.numpy as jnp
    from repro.core import bdi_value as jbv
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    from repro.launch.train import train as jtrain
    from repro.models import attention as JA
    from repro.models import layers as JL
    from repro.models import transformer as JT

    out = {}
    c = ce_inputs()
    logits, tg = jnp.asarray(c["logits"]), jnp.asarray(c["targets"])
    out["ce"] = np.asarray(JL.cross_entropy(logits, tg,
                                            jnp.asarray(c["mask"])))
    out["ce_nomask"] = np.asarray(JL.cross_entropy(logits, tg))

    def cce(x, head):
        return JL.chunked_cross_entropy({"w": head}, x, tg,
                                        jnp.asarray(c["mask"]), chunk=5)
    x, head = (jnp.asarray(c[k], jnp.bfloat16) for k in ("x", "head"))
    val, (gx, gh) = jax.value_and_grad(cce, argnums=(0, 1))(x, head)
    out["cce"], out["cce_gx"], out["cce_gh"] = (
        np.asarray(t.astype(jnp.float32)) for t in (val, gx, gh))

    a = attn_inputs()
    pos = jnp.arange(13, dtype=jnp.int32)
    _, params = jax_params(work, "yi-6b")
    attn = jax.tree.map(lambda t: t[0], params["blocks"]["attn"])
    for w in (0, 8):
        out[f"attn_w{w}"] = np.asarray(JA._chunked_attn(
            *(jnp.asarray(a[k]) for k in "qkv"), pos, pos, True, w,
            chunk=5))
        out[f"gqa_w{w}"] = np.asarray(JA.gqa_forward(
            attn, jnp.asarray(a["x"], jnp.bfloat16),
            jnp.arange(16, dtype=jnp.int32), window=w).astype(jnp.float32))

    for name in ARCHS:
        cfg, params = jax_params(work, name)
        batch = {k: jnp.asarray(v) for k, v in model_batch(cfg).items()}
        for remat in REMAT[name]:
            out[f"{name}_logits_{remat}"] = np.asarray(JT.forward(
                cfg, params, batch, remat).astype(jnp.float32))
        if name == "yi-6b":
            loss, grads = jax.value_and_grad(
                lambda p: JT.loss_fn(cfg, p, batch))(params)
            out["loss"] = np.asarray(loss)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
                out[f"grad{jax.tree_util.keystr(path)}"] = np.asarray(
                    g.astype(jnp.float32))
    np.savez(os.path.join(work, "jax.npz"), **out)

    runs = {}
    for md in DTYPES:
        d = os.path.join(work, md)
        runs[f"{md}_whole"] = jtrain(
            "yi-6b", steps=10, ckpt_dir=_copy(f"{d}/init", f"{d}/jax_whole"),
            ckpt_every=9, moment_dtype=md, **TRAIN)["losses"]
        runs[f"{md}_from_port"] = jtrain(
            "yi-6b", steps=10, ckpt_dir=_copy(f"{d}/port_whole",
                                              f"{d}/jax_from_port", {9}),
            ckpt_every=9, moment_dtype=md, **TRAIN)["losses"]
    for name in FAMILIES:
        d = os.path.join(work, "families", name)
        runs[f"{name}_jax"] = jtrain(
            name, steps=2, ckpt_dir=_copy(f"{d}/init", f"{d}/jax"),
            ckpt_every=1, **TRAIN)["losses"]
    Path(work, "jax_runs.json").write_text(json.dumps(runs))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port writes the params and each dtype's step-0 training
    checkpoint and makes the 10-step run whose step-9 checkpoint the JAX
    side resumes; then the JAX subprocess runs; the records of both sides
    come back.  Every 10-step run checkpoints steps 9 and 10."""
    work = tmp_path_factory.mktemp("train")
    for name in ARCHS:
        store.save(str(work / "params" / name), 0, port_params(name)[1])
    port = {}
    for md in DTYPES:
        d = work / md
        params = port_params("yi-6b")[1]
        state = export_state(adamw_init(params, AdamWConfig(moment_dtype=md)))
        store.save(str(d / "init"), 0, (params, state),
                   extra={"next_step": 0, "data_seed": 0, "loss": None})
        port[md] = train("yi-6b", steps=10,
                         ckpt_dir=_copy(d / "init", d / "port_whole"),
                         ckpt_every=9, moment_dtype=md, device="cpu",
                         **TRAIN)["losses"]
    for name in FAMILIES:                     # f32 moments, zero
        params = get_model(get_arch(name).reduced()).init(
            torch.Generator().manual_seed(0), "cpu")
        state = export_state(adamw_init(params, AdamWConfig()))
        store.save(str(work / "families" / name / "init"), 0,
                   (params, state),
                   extra={"next_step": 0, "data_seed": 0, "loss": None})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c",
                    "import test_torch_train as t; "
                    f"t.jax_main({str(work)!r})"],
                   env=env, cwd=REPO, check=True, timeout=600)
    with np.load(work / "jax.npz") as z:
        rec = dict(z)
    return {"work": work, "port": port, "rec": rec,
            "jax": json.loads((work / "jax_runs.json").read_text())}


def _ulp(mag):
    return np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)


def assert_bf16_ulps(got: torch.Tensor, want: np.ndarray, ulps: int = 2):
    g = got.detach().float().numpy()
    assert g.shape == want.shape
    mag = np.maximum(np.abs(g), np.abs(want))
    assert (np.abs(g - want) <= ulps * _ulp(mag)).all(), \
        np.abs(g - want).max()


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "internvl2-76b"])
@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (3, 7, 0, 1), (1, 12, 1, 2),
                          (5, 2, 3, 4)])
def test_pipeline_batches_equal_jax(arch, seed, step, shard, n_shards):
    from repro.configs.registry import get_arch as jax_arch
    from repro.data import pipeline as JP
    cfg = get_arch(arch).reduced()
    shape = ShapeConfig("s", 48, 8, "train")
    got = TP.make_train_batch(cfg, shape, TP.DataConfig(seed=seed), step,
                              shard, n_shards)
    want = JP.make_train_batch(jax_arch(arch).reduced(), shape,
                               JP.DataConfig(seed=seed), step, shard,
                               n_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_iterator_resumes_the_stream():
    cfg = get_arch("yi-6b").reduced()
    shape = ShapeConfig("s", 16, 2, "train")
    it = TP.DataIterator(cfg, shape, TP.DataConfig(seed=1))
    batches = [next(it) for _ in range(3)]
    it2 = TP.DataIterator(cfg, shape, TP.DataConfig(seed=1), start_step=2)
    np.testing.assert_array_equal(batches[2]["tokens"], next(it2)["tokens"])
    assert it2.state() == {"step": 3, "seed": 1}


# ---------------------------------------------------------------------------
# losses and attention
# ---------------------------------------------------------------------------

def test_cross_entropy(records):
    c, rec = ce_inputs(), records["rec"]
    logits, tg = torch.from_numpy(c["logits"]), torch.from_numpy(c["targets"])
    np.testing.assert_allclose(
        float(L.cross_entropy(logits, tg, torch.from_numpy(c["mask"]))),
        rec["ce"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(L.cross_entropy(logits, tg)),
                               rec["ce_nomask"], rtol=1e-6, atol=1e-6)


def test_chunked_cross_entropy_pads_and_recomputes(records):
    """chunk 5 over 13 positions: 3 chunks of 5, 2 padded positions."""
    c, rec = ce_inputs(), records["rec"]
    x = torch.from_numpy(c["x"]).to(torch.bfloat16).requires_grad_()
    head = torch.from_numpy(c["head"]).to(torch.bfloat16).requires_grad_()
    val = L.chunked_cross_entropy({"w": head}, x,
                                  torch.from_numpy(c["targets"]),
                                  torch.from_numpy(c["mask"]), chunk=5)
    np.testing.assert_allclose(float(val.detach()), rec["cce"], rtol=1e-4)
    gx, gh = torch.autograd.grad(val, (x, head))
    assert_bf16_ulps(gx, rec["cce_gx"])
    assert_bf16_ulps(gh, rec["cce_gh"])


@pytest.mark.parametrize("window", [0, 8])
def test_chunked_attn_pads_queries(records, window):
    """chunk 5 over 13 queries: the padded query positions are -1."""
    a = attn_inputs()
    pos = torch.arange(13, dtype=torch.int32)
    got = A._chunked_attn(*(torch.from_numpy(a[k]) for k in "qkv"), pos,
                          pos, True, window, chunk=5)
    np.testing.assert_allclose(got.numpy(), records["rec"][f"attn_w{window}"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_forward(records, window):
    attn = layer(port_params("yi-6b")[1]["blocks"], 0)["attn"]
    x = torch.from_numpy(attn_inputs()["x"]).to(torch.bfloat16)
    got = A.gqa_forward(attn, x, torch.arange(16, dtype=torch.int32),
                        window=window)
    assert_bf16_ulps(got, records["rec"][f"gqa_w{window}"])


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients
# ---------------------------------------------------------------------------

def _batch(cfg) -> dict:
    return {k: torch.from_numpy(v) for k, v in model_batch(cfg).items()}


@pytest.mark.parametrize("name,remat", [(n, r) for n in ARCHS
                                        for r in REMAT[n]])
def test_forward_logits(records, name, remat):
    cfg, params = port_params(name)
    with torch.no_grad():
        got = T.forward(cfg, params, _batch(cfg), remat).float().numpy()
    want = records["rec"][f"{name}_logits_{remat}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * _ulp(np.abs(want).max()))


def test_loss_and_gradients_every_leaf(records):
    cfg, params = port_params("yi-6b")
    rec = records["rec"]
    flat = [t.requires_grad_() for t in leaves(params)]
    loss = T.loss_fn(cfg, params, _batch(cfg))
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), rec["loss"], rtol=1e-4)
    paths = [p for p, _ in store.leaf_paths(params)]
    assert len(paths) == len(grads) == sum(k.startswith("grad")
                                           for k in rec)
    for path, g in zip(paths, grads):
        want = rec[f"grad{path}"]
        g = g.float().numpy()
        assert g.shape == want.shape, path
        err = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert err <= 1e-2, (path, err)


def test_remat_does_not_change_the_gradients():
    """The layer checkpoint recomputes the forward exactly."""
    cfg, params = port_params("yi-6b")
    batch = _batch(cfg)
    flat = [t.requires_grad_() for t in leaves(params)]
    out = []
    for remat in (True, False):
        x = T._hidden(cfg, params, batch, remat)
        loss = L.chunked_cross_entropy(params["lm_head"], x,
                                       batch["targets"], batch["loss_mask"])
        out.append(torch.autograd.grad(loss, flat))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# train(): trajectories and checkpoints across the packages
# ---------------------------------------------------------------------------

def load_ckpt(ckpt: Path, md: str, step: int) -> tuple[dict, dict]:
    """Params and live optimizer state of a training checkpoint."""
    params = port_params("yi-6b")[1]
    state = export_state(adamw_init(params, AdamWConfig(moment_dtype=md)))
    (params, state), _ = store.restore(str(ckpt), (params, state), step=step)
    return params, import_state(state)


def assert_one_step_matches(start, got, want) -> None:
    """``got`` and ``want``: ``(params, state)`` one step after ``start``'s
    (the tolerances of the module docstring)."""
    p0, (pg, sg), (pw, sw) = start[0], got, want
    assert int(sg["step"]) == int(sw["step"]) == int(start[1]["step"]) + 1
    for (path, a), (_, b) in zip(store.leaf_paths(pg), store.leaf_paths(pw)):
        a, b = a.float().numpy(), b.float().numpy()
        ulp = _ulp(np.maximum(np.abs(a), np.abs(b)))
        share = float((np.abs(a - b) <= ulp).mean())
        assert share >= STEP_ULP_SHARE, (path, share)
    for key in ("m", "v"):
        for (path, p), x, y in zip(store.leaf_paths(p0),
                                   _store_leaves(sg[key]),
                                   _store_leaves(sw[key])):
            assert type(x) is type(y), (key, path)
            a, b = _load(x, p.shape), _load(y, p.shape)
            err = float((a - b).norm() / b.norm())
            assert err <= STEP_MOMENT_RTOL, (key, path, err)


@pytest.mark.parametrize("md", DTYPES)
def test_train_losses_match_jax(records, md):
    """Both resume the port's step-0 checkpoint and run 10 steps."""
    got, want = records["port"][md], records["jax"][f"{md}_whole"]
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL[md])


@pytest.mark.parametrize("md", DTYPES)
def test_jax_checkpoint_resumes_in_port(records, md):
    """JAX's step-9 checkpoint, resumed by the port's train(), takes step
    10 as JAX's uninterrupted run did."""
    d = records["work"] / md
    ckpt = _copy(d / "jax_whole", d / "port_from_jax", steps={9})
    assert store.latest_step(ckpt) == 9
    out = train("yi-6b", steps=10, ckpt_dir=ckpt, ckpt_every=9,
                moment_dtype=md, device="cpu", **TRAIN)
    assert out["steps_run"] == 1
    np.testing.assert_allclose(out["losses"][0],
                               records["jax"][f"{md}_whole"][9], rtol=1e-4)
    assert_one_step_matches(load_ckpt(d / "jax_whole", md, 9),
                            load_ckpt(Path(ckpt), md, 10),
                            load_ckpt(d / "jax_whole", md, 10))


@pytest.mark.parametrize("md", DTYPES)
def test_port_checkpoint_resumes_in_jax(records, md):
    """The port's step-9 checkpoint, resumed by JAX's train(), takes step
    10 as the port's uninterrupted run did."""
    d = records["work"] / md
    got = records["jax"][f"{md}_from_port"]
    assert len(got) == 1
    np.testing.assert_allclose(got[0], records["port"][md][9], rtol=1e-4)
    assert_one_step_matches(load_ckpt(d / "port_whole", md, 9),
                            load_ckpt(d / "jax_from_port", md, 10),
                            load_ckpt(d / "port_whole", md, 10))


def _fault(start: tuple, want: tuple, fault: str, md: str) -> tuple:
    """``want`` with ``fault`` planted."""
    params, st = want
    if fault == "params not updated":
        return start[0], st
    if fault == "moments zeroed":
        zero = adamw_init(params, AdamWConfig(moment_dtype=md))
        return params, {**zero, "step": st["step"]}
    return params, export_state(st)          # byte masks read as planes


@pytest.mark.parametrize("md,fault", [
    ("f32", "params not updated"), ("f32", "moments zeroed"),
    ("bdi8", "params not updated"), ("bdi8", "moments zeroed"),
    ("bdi8", "masks in the byte layout")])
def test_one_step_bounds_refuse_a_faulty_step(records, md, fault):
    """The one-step bounds refuse JAX's step 10 with one fault planted:
    the params left at step 9, the moments zeroed, or the bdi8 masks
    left in the checkpoints' byte layout."""
    d = records["work"] / md
    start = load_ckpt(d / "jax_whole", md, 9)
    want = load_ckpt(d / "jax_whole", md, 10)
    assert_one_step_matches(start, want, want)
    with pytest.raises(AssertionError):
        assert_one_step_matches(start, _fault(start, want, fault, md), want)


def test_restart_continuity(tmp_path):
    """Crash after 20 steps, relaunch to 30: the same loss as an
    uninterrupted 30-step run (test_system's rtol 1e-5)."""
    kw = dict(smoke=True, seq_len=32, batch=4, log_every=100, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    train("yi-6b", steps=20, ckpt_dir=ckpt, ckpt_every=10, **kw)
    out2 = train("yi-6b", steps=30, ckpt_dir=ckpt, ckpt_every=10, **kw)
    assert out2["steps_run"] == 10
    ref = train("yi-6b", steps=30, ckpt_dir=str(tmp_path / "ckpt2"),
                ckpt_every=30, **kw)
    np.testing.assert_allclose(out2["final_loss"], ref["final_loss"],
                               rtol=1e-5)
    assert sorted(os.listdir(ckpt)) == [f"step_{s:010d}"
                                        for s in (10, 20, 30)]


def test_deadline_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = train("yi-6b", smoke=True, steps=10_000, seq_len=32, batch=4,
                ckpt_dir=ckpt, ckpt_every=10_000, deadline_s=1,
                log_every=100_000, device="cpu")
    assert out["steps_run"] < 10_000
    assert store.latest_step(ckpt) == out["steps_run"]


@pytest.mark.parametrize("name", FAMILIES)
def test_train_other_families_match_jax(records, name):
    """xLSTM, the Hymba hybrid and the encoder-decoder train through
    ``train()``: from the port's step-0 checkpoint, the port's first loss
    equals JAX's (which resumed the same checkpoint); from JAX's step-1
    checkpoint, the port's step-2 loss equals JAX's step 2."""
    d = records["work"] / "families" / name
    want = records["jax"][f"{name}_jax"]
    assert len(want) == 2
    out = train(name, steps=1, ckpt_dir=_copy(d / "init", d / "port"),
                ckpt_every=1, device="cpu", **TRAIN)
    np.testing.assert_allclose(out["losses"][0], want[0], rtol=1e-4)
    ckpt = _copy(d / "jax", d / "port_from_jax", steps={1})
    out = train(name, steps=2, ckpt_dir=ckpt, ckpt_every=1, device="cpu",
                **TRAIN)
    assert out["steps_run"] == 1 and store.latest_step(ckpt) == 2
    np.testing.assert_allclose(out["losses"][0], want[1], rtol=1e-4)
