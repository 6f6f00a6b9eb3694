"""The port's checkpoint store (``repro_torch/checkpoint/store.py``) vs
the JAX package's (``repro/checkpoint/store.py``).

The on-disk format must be the same byte for byte: the same flat dict or
nested tree (dicts, NamedTuples, lists) saved by both packages gives
identical manifests — leaf paths and their order, file names, codecs,
shapes, dtype strings, SHA-256 — and identical files; a checkpoint
written by either loads in the other with the same bits (bfloat16
included, which the port writes and reads as an int16 view, without
``ml_dtypes``).  Corruption, a wrong component kind, ``prune_old`` and
``latest_step`` behave as in JAX (the port raises ``ValueError`` where
JAX asserts).  Pure host code: both packages run in this process.
"""

import os
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store as pstore

REPO = Path(__file__).resolve().parents[1]


class Pages(NamedTuple):
    kd: object
    kb: object


def _arrays(seed: int = 0) -> dict:
    """Numpy leaves of every kind the store meets: compressible and not,
    small (stored raw regardless), bf16, 0-d."""
    rng = np.random.default_rng(seed)
    return {
        "zeros_f32": np.zeros((64, 32), np.float32),
        "ramp_i32": np.arange(2048, dtype=np.int32).reshape(32, 64),
        "noise_f32": rng.standard_normal((40, 17)).astype(np.float32),
        "codes_i8": rng.integers(-3, 4, (128, 16), dtype=np.int8),
        "tiny_u8": np.arange(5, dtype=np.uint8),
        "scalar_i64": np.asarray(7, np.int64),
        "weights_bf16": rng.standard_normal((16, 48)).astype(
            ml_dtypes.bfloat16),
        "sums_u32": rng.integers(0, 2**32, 300, dtype=np.uint32),
    }


def _torch_leaf(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _nested(arrs: dict, leaf=lambda a: a):
    return {"blocks": [Pages(leaf(arrs["codes_i8"]), leaf(arrs["noise_f32"])),
                       Pages(leaf(arrs["zeros_f32"]), None)],
            "embed": leaf(arrs["weights_bf16"]),
            "aux": {"b": leaf(arrs["ramp_i32"]), "a": leaf(arrs["tiny_u8"])}}


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy().tobytes()
    return np.asarray(x).tobytes()


def _dir_files(d: Path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())}


def test_flat_manifest_and_files_match_jax(tmp_path):
    arrs = _arrays()
    mj = jstore.save(str(tmp_path / "j"), 3, arrs, extra={"kind": "x"})
    mp = pstore.save(str(tmp_path / "p"), 3,
                     {k: _torch_leaf(a) for k, a in arrs.items()},
                     extra={"kind": "x"})
    assert mp == mj
    assert {e["codec"] for e in mp["entries"]} == {"raw", "bdi"}
    assert _dir_files(tmp_path / "p" / "step_0000000003") \
        == _dir_files(tmp_path / "j" / "step_0000000003")


def test_nested_tree_paths_and_order_match_jax(tmp_path):
    arrs = _arrays(1)
    mj = jstore.save(str(tmp_path / "j"), 0, _nested(arrs))
    mp = pstore.save(str(tmp_path / "p"), 0, _nested(arrs, _torch_leaf))
    assert [e["path"] for e in mj["entries"]] == [
        "['aux']['a']", "['aux']['b']", "['blocks'][0].kd",
        "['blocks'][0].kb", "['blocks'][1].kd", "['embed']"]
    assert mp == mj
    # numpy leaves through the port give the same manifest too
    assert pstore.save(str(tmp_path / "n"), 0, _nested(arrs)) == mj
    assert [k for k, _ in pstore.leaf_paths(_nested(arrs))] \
        == [e["path"] for e in mj["entries"]]


def test_jax_checkpoint_loads_in_port(tmp_path):
    arrs = _arrays(2)
    jstore.save(str(tmp_path), 5, _nested(arrs))
    like = _nested(arrs, lambda a: torch.zeros(1))
    tree, man = pstore.restore(str(tmp_path), like)
    assert man["step"] == 5
    got = [leaf for _, leaf in pstore.leaf_paths(tree)]
    want = [leaf for _, leaf in pstore.leaf_paths(_nested(arrs))]
    assert all(isinstance(g, torch.Tensor) for g in got)
    assert [_bits(g) for g in got] == [_bits(w) for w in want]
    assert tree["embed"].dtype == torch.bfloat16
    assert isinstance(tree["blocks"][0], Pages)
    assert tree["blocks"][1].kb is None
    flat_dir = tmp_path / "flat"
    jstore.persist(str(flat_dir), 1, arrs, {"n": 1}, kind="tier-cache")
    got, meta, _ = pstore.restore_component(str(flat_dir), kind="tier-cache")
    assert meta == {"n": 1} and got.keys() == arrs.keys()
    for k, a in arrs.items():
        assert _bits(got[k]) == a.tobytes(), k
        if a.dtype != ml_dtypes.bfloat16:
            assert isinstance(got[k], np.ndarray) and got[k].dtype == a.dtype


def test_port_checkpoint_loads_in_jax(tmp_path):
    arrs = _arrays(3)
    pstore.save(str(tmp_path), 2, _nested(arrs, _torch_leaf))
    tree, _ = jstore.restore(str(tmp_path), _nested(arrs))
    import jax
    got = [np.asarray(x) for x in jax.tree.leaves(tree)]
    want = [a for _, a in pstore.leaf_paths(_nested(arrs))]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    flat_dir = tmp_path / "flat"
    pstore.save(str(flat_dir), 0, {k: _torch_leaf(a)
                                   for k, a in arrs.items()})
    flat, _ = jstore.load_flat(str(flat_dir))
    for k, a in arrs.items():
        assert flat[k].dtype == a.dtype and flat[k].tobytes() == a.tobytes()


def test_bfloat16_roundtrips_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` cannot be imported, bf16 tensors
    save and load bit for bit."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import store\n"
        "x = torch.randn(33, 7, generator=torch.Generator().manual_seed(0))"
        ".to(torch.bfloat16)\n"
        f"m = store.save({str(tmp_path)!r}, 0, {{'w': x, 's': x[0, 0]}})\n"
        "assert [e['dtype'] for e in m['entries']] == ['bfloat16'] * 2\n"
        f"flat, _ = store.load_flat({str(tmp_path)!r})\n"
        "assert flat['w'].dtype == torch.bfloat16\n"
        "assert torch.equal(flat['w'].view(torch.int16), "
        "x.view(torch.int16))\n"
        f"t, _ = store.restore({str(tmp_path)!r}, {{'w': x, 's': x[0, 0]}})\n"
        "assert torch.equal(t['s'].view(torch.int16), "
        "x[0, 0].view(torch.int16))\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    flat, _ = jstore.load_flat(str(tmp_path))      # and JAX reads them
    assert flat["w"].dtype == ml_dtypes.bfloat16 and flat["w"].shape == (33, 7)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_flipped_byte_raises_ioerror(tmp_path, side):
    """A byte flipped in a stored file fails its SHA-256 in the port,
    whichever package wrote it."""
    arrs = _arrays(4)
    (pstore if side == "port" else jstore).save(str(tmp_path), 0, arrs)
    d = tmp_path / "step_0000000000"
    f = sorted(p for p in d.iterdir() if p.name != "manifest.json")[2]
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checkpoint corruption"):
        pstore.load_flat(str(tmp_path))
    with pytest.raises(IOError, match="checkpoint corruption"):
        pstore.restore(str(tmp_path), arrs)


def test_wrong_kind_is_refused(tmp_path):
    jstore.persist(str(tmp_path), 0, {"x": np.zeros(4, np.uint8)}, {"a": 1},
                   kind="engine-snapshot")
    with pytest.raises(ValueError, match="kind"):
        pstore.restore_component(str(tmp_path), kind="tier-cache")
    with pytest.raises(AssertionError, match="kind"):      # JAX's refusal
        jstore.restore_component(str(tmp_path), kind="tier-cache")
    _, meta, _ = pstore.restore_component(str(tmp_path),
                                          kind="engine-snapshot")
    assert meta == {"a": 1}


def test_prune_old_and_latest_step_as_in_jax(tmp_path):
    for pkg, d in ((jstore, tmp_path / "j"), (pstore, tmp_path / "p")):
        assert pkg.latest_step(str(d)) is None
        for step in (3, 11, 7, 20, 1):
            pkg.save(str(d), step, {"x": np.full(8, step, np.int32)})
        pkg.prune_old(str(d), keep=3)
        pkg.prune_old(str(tmp_path / "missing"))        # a no-op
    assert sorted(os.listdir(tmp_path / "p")) \
        == sorted(os.listdir(tmp_path / "j")) \
        == ["step_0000000007", "step_0000000011", "step_0000000020"]
    assert pstore.latest_step(str(tmp_path / "p")) == 20
    flat, man = pstore.load_flat(str(tmp_path / "j"))
    assert man["step"] == 20 and flat["x"].tolist() == [20] * 8
    with pytest.raises(FileNotFoundError):
        pstore.load_flat(str(tmp_path / "missing"))
