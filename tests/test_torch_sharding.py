"""The port's sharding rules, mesh context and elastic restore vs the JAX
package, on the CPU.

``repro_torch.distributed.sharding`` (``param_specs`` with and without
FSDP, ``batch_specs``, ``cache_specs``), ``distributed/axes.py``
(``PartitionSpec``, ``resolve``, ``shard``), ``launch/mesh.py`` and
``launch/elastic.py`` (``abstract_mesh``, ``reshard_plan``,
``restore_elastic``, and ``checkpoint/store.restore(target_shardings=)``)
held against ``repro.distributed.sharding``, ``repro.distributed.axes``
and ``repro.launch.elastic``.

The port's shape trees are the models' inits on ``device="meta"`` (every
registry config at full width, arctic-480b's 480 B parameters included,
without allocating), JAX's are ``jax.eval_shape`` of its inits.  The
meshes are abstract: (16, 16) and (2, 16, 16) with a ``pod`` axis (the
production meshes), (2, 2) and (1, 1).  Everything compared is exact:
specs as ``str()``, reports as dicts, restored leaves bit for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro.checkpoint import store as jstore
from repro.configs.registry import get_arch as jax_arch
from repro.distributed import axes as JAX_AX
from repro.distributed import sharding as JSH
from repro.launch import elastic as JEL
from repro.models.api import get_model as jax_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.data import pipeline as TP
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.launch import elastic as EL
from repro_torch.launch.mesh import (destroy_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig, adamw_init

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
FAMILIES = ("yi-6b", "gemma3-27b", "deepseek-v2-lite-16b", "internvl2-76b",
            "xlstm-350m", "hymba-1.5b", "seamless-m4t-large-v2")


@functools.lru_cache(maxsize=None)
def meta_params(name: str, reduced: bool = False) -> dict:
    cfg = get_arch(name)
    cfg = cfg.reduced() if reduced else cfg
    return get_model(cfg).init(torch.Generator(), "meta")


def jax_shapes(name: str, reduced: bool = False):
    cfg = jax_arch(name)
    cfg = cfg.reduced() if reduced else cfg
    return jax.eval_shape(jax_model(cfg).init, jax.random.PRNGKey(0))


def _port(tree) -> dict:
    return {p: str(s) for p, s in SH.spec_leaves(tree)}


def _jax(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(k): str(s) for k, s in flat}


def _meshes():
    return [(EL.abstract_mesh(*m), JEL.abstract_mesh(*m))
            for m in MESHES.values()]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_equal_jax_at_full_width(name):
    ours, theirs = meta_params(name), jax_shapes(name)
    assert [(p, tuple(t.shape)) for p, t in store.leaf_paths(ours)] == [
        (jax.tree_util.keystr(k), tuple(v.shape))
        for k, v in jax.tree_util.tree_flatten_with_path(theirs)[0]]
    for tm, jm in _meshes():
        for fsdp in (True, False):
            got = _port(SH.param_specs(ours, tm, fsdp=fsdp))
            assert got == _jax(JSH.param_specs(theirs, jm, fsdp=fsdp))
    # every config shards something over the production mesh's model axis
    specs = _port(SH.param_specs(ours, _meshes()[0][0]))
    assert any("model" in s for s in specs.values())


@pytest.mark.parametrize("md", ["bdi8", "q8"])
@pytest.mark.parametrize("name", ["yi-6b", "deepseek-v2-lite-16b"])
def test_opt_state_specs_equal_jax(name, md):
    """Moment leaves (deltas, base, scale, maskp) take their parameter's
    rule, at reduced size (whose 128-wide leaves are tiled)."""
    state = adamw_init(meta_params(name, True), AdamWConfig(moment_dtype=md))
    jstate = jax.eval_shape(
        functools.partial(jadamw_init, cfg=JAdamWConfig(moment_dtype=md)),
        jax_shapes(name, True))
    paths = [p for p, _ in store.leaf_paths(state)]
    assert paths == [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert any(p.endswith("['deltas']") for p in paths)
    for tm, jm in _meshes():
        for fsdp in (True, False):
            assert _port(SH.param_specs(state, tm, fsdp=fsdp)) == \
                _jax(JSH.param_specs(jstate, jm, fsdp=fsdp))


@pytest.mark.parametrize("name", FAMILIES)
def test_batch_and_cache_specs_equal_jax(name):
    cfg, jcfg = get_arch(name).reduced(), jax_arch(name).reduced()
    batch = TP.make_train_batch(cfg, ShapeConfig("t", 8, 32, "train"),
                                TP.DataConfig(seed=1), step=0)
    kw = {"enc_len": 8} if cfg.is_encdec else {}
    cache = get_model(cfg).init_cache(32, 16, device="cpu", **kw)
    jcache = jax.eval_shape(lambda: jax_model(jcfg).init_cache(32, 16, **kw))
    assert [(p, tuple(t.shape)) for p, t in store.leaf_paths(cache)] == [
        (jax.tree_util.keystr(k), tuple(v.shape))
        for k, v in jax.tree_util.tree_flatten_with_path(jcache)[0]]
    for tm, jm in _meshes():
        assert _port(SH.batch_specs(batch, tm)) == \
            _jax(JSH.batch_specs(batch, jm))
        assert _port(SH.cache_specs(cache, tm)) == \
            _jax(JSH.cache_specs(jcache, jm))


@pytest.mark.parametrize("name", ["yi-6b", "deepseek-v2-lite-16b"])
def test_reshard_plan_equal_jax(name):
    old, new = ((16, 16), ("data", "model")), ((2, 2), ("data", "model"))
    got = EL.reshard_plan(meta_params(name), EL.abstract_mesh(*old),
                          EL.abstract_mesh(*new))
    want = JEL.reshard_plan(jax_shapes(name), JEL.abstract_mesh(*old),
                            JEL.abstract_mesh(*new))
    assert got == want
    assert got and max(v["replicated_growth"] for v in got.values()) >= 8


def test_partition_spec_and_resolve_equal_jax():
    assert (AX.DP, AX.MODEL) == (JAX_AX.DP, JAX_AX.MODEL)
    specs = [(None, "model"), (("pod", "data"), None), (), ("data",),
             (("data",), None), (AX.DP, None, AX.MODEL),
             (("pod", "model"), "data", None)]
    for spec in specs:
        assert str(AX.P(*spec)) == str(jax.sharding.PartitionSpec(*spec))
    dev = np.asarray(jax.devices()[:1])
    for names in (("data", "model"), ("pod", "data", "model"), ("model",)):
        jmesh = jax.sharding.Mesh(dev.reshape((1,) * len(names)), names)
        tmesh = EL.abstract_mesh((1,) * len(names), names)
        with JAX_AX.use_mesh(jmesh), AX.use_mesh(tmesh):
            assert AX.dp_axes() == JAX_AX.dp_axes()
            for spec in specs:
                assert str(AX.resolve(spec)) == str(JAX_AX.resolve(spec))
    assert AX.current_mesh() is None and str(AX.resolve((AX.DP, "model"))) \
        == "PartitionSpec('data', None)"


@pytest.fixture
def mesh1():
    mesh = make_host_mesh(1, 1, device="cpu")
    yield mesh
    destroy_mesh()


def test_shard_follows_the_mesh(mesh1):
    x = torch.arange(12.0).reshape(3, 4)
    assert AX.shard(x, AX.DP, None) is x                      # no mesh
    with AX.use_mesh(mesh1):
        assert AX.current_mesh() is mesh1
        assert AX.shard(x, AX.DP, AX.MODEL) is x              # size-1 axes
        y = x[None]
        assert AX.shard_seq(y) is y and AX.shard_seq(x) is x
        ns = AX.named_sharding(AX.DP, AX.MODEL)
        assert str(ns.spec) == "PartitionSpec('data', 'model')"
        d = AX.shard(torch.distributed.tensor.distribute_tensor(
            x, mesh1, ns.placements), None, None)
        assert isinstance(d, DTensor) and torch.equal(d.full_tensor(), x)
    with AX.use_mesh(EL.abstract_mesh((1, 2), ("data", "model"))):
        # a plain tensor over a model axis of 2 is this rank's block: the
        # block's shape is taken, any other raises
        assert AX.shard(x, None, AX.MODEL, global_shape=(3, 8)) is x
        assert AX.shard(x, AX.DP, None, global_shape=(3, 4)) is x
        with pytest.raises(ValueError, match=r"is \(3, 2\), not \(3, 4\)"):
            AX.shard(x, None, AX.MODEL, global_shape=(3, 4))
        with pytest.raises(TypeError, match="global_shape"):
            AX.shard(x, None, AX.MODEL)
    with AX.use_mesh(EL.abstract_mesh((2, 2), ("data", "model"))):
        # DP x TP: a block over the data and the model axes is taken too
        assert AX.shard(x, AX.DP, AX.MODEL, global_shape=(6, 8)) is x
        with pytest.raises(ValueError, match=r"is \(3, 4\), not \(3, 2\)"):
            AX.shard(x[:, :2], AX.DP, AX.MODEL, global_shape=(6, 8))
    with AX.use_mesh(EL.abstract_mesh((2, 1, 2), ("pod", "data", "model"))):
        with pytest.raises(NotImplementedError,
                           match="pod axis is not ported.*ROADMAP Queue 1 "
                                 "item 2"):
            AX.shard(x, AX.DP, AX.MODEL, global_shape=(6, 8))
    assert AX.current_mesh() is None


def test_make_production_mesh_raises_on_one_rank(mesh1):
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_make_host_mesh_needs_the_world_it_names():
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        make_host_mesh(2, 1, device="cpu")
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model")
        assert torch.distributed.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="needs 2 ranks"):
            make_host_mesh(1, 2, device="cpu")
    finally:
        destroy_mesh()
    assert not torch.distributed.is_initialized()


def _assert_on_mesh_bit_equal(out, want, mesh):
    for (p, a), (_, b) in zip(store.leaf_paths(out), store.leaf_paths(want)):
        assert isinstance(a, DTensor) and a.device_mesh is mesh, p
        a = a.to_local()
        b = torch.as_tensor(np.asarray(b)) if not isinstance(
            b, torch.Tensor) else b
        assert a.dtype == b.dtype and a.shape == b.shape, p
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), p


def test_restore_elastic_onto_a_one_rank_mesh(tmp_path, mesh1):
    cfg = get_arch("yi-6b").reduced()
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    state = adamw_init(params, AdamWConfig(moment_dtype="bdi8"))
    store.save(str(tmp_path), 3, (params, state))
    like = (meta_params("yi-6b", True),
            adamw_init(meta_params("yi-6b", True),
                       AdamWConfig(moment_dtype="bdi8")))
    out, man = EL.restore_elastic(str(tmp_path), like, mesh1)
    assert man["step"] == 3
    _assert_on_mesh_bit_equal(out, (params, state), mesh1)
    # a corrupted leaf is refused on this path too
    f = tmp_path / "step_0000000003" / man["entries"][0]["file"]
    f.write_bytes(b"x" + f.read_bytes()[1:])
    with pytest.raises(IOError, match="sha mismatch"):
        EL.restore_elastic(str(tmp_path), like, mesh1)


def test_restore_elastic_of_a_jax_checkpoint(tmp_path, mesh1):
    jcfg = jax_arch("yi-6b").reduced()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    jstore.save(str(tmp_path), 5, jparams)
    want = jax.tree.map(lambda a: np.asarray(a).view(np.int16)
                        if a.dtype == jax.numpy.bfloat16 else np.asarray(a),
                        jparams)
    out, man = EL.restore_elastic(str(tmp_path), meta_params("yi-6b", True),
                                  mesh1)
    assert man["step"] == 5
    for (p, a), (_, b) in zip(store.leaf_paths(out), store.leaf_paths(want)):
        assert isinstance(a, DTensor) and a.device_mesh is mesh1, p
        a = a.to_local()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        np.testing.assert_array_equal(a.numpy(), b, err_msg=p)
