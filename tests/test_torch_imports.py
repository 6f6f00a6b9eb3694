"""The port stands alone: no jax, no ``repro``, no ``ml_dtypes``, and no
silent CPU fallback."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _modules() -> list[str]:
    import repro_torch
    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]


def test_import_loads_neither_jax_nor_repro():
    mods = _modules()
    assert "repro_torch.serving.engine" in mods
    assert "repro_torch.launch.quickstart" in mods
    for m in ("trace", "telemetry", "scheduler", "prefix_cache", "faults",
              "tier", "snapshot", "audit", "reuse", "shadow", "observatory",
              "reference"):
        assert f"repro_torch.serving.{m}" in mods
    assert "repro_torch.launch.observe" in mods
    assert "repro_torch.checkpoint.store" in mods
    for m in ("data.pipeline", "optim", "optim.adamw", "models.api",
              "models.transformer", "launch.train", "launch.train_lm",
              "launch.compressed_checkpointing", "distributed",
              "distributed.axes", "distributed.sharding",
              "distributed.compress_comm", "launch.mesh",
              "launch.elastic", "launch.dryrun", "models.trips"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.') or m == 'ml_dtypes')\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300,
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src")))


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch)|import\s+ml_dtypes\b|from\s+ml_dtypes\b)",
    re.M)


def test_sources_import_neither_jax_nor_repro():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedKVEngine
    from repro_torch.serving.reference import ReferencePagedKVEngine
    cfg = get_arch("yi-6b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReferencePagedKVEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate("yi-6b", paged=True, smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate("yi-6b", paged=False, paged_reference=True, smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate("yi-6b", smoke=True, scheduler=True, observatory=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate("yi-6b", smoke=True, scheduler=True, prefix_cache=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate("yi-6b", smoke=True, multi_turn=2, tier_host_mb=4)
    from repro_torch.serving.snapshot import restore_snapshot
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        # the device is resolved before the snapshot directory is read
        restore_snapshot("/nonexistent", cfg, params)
    from repro_torch.launch import quickstart
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main()
    from repro_torch.launch import compressed_checkpointing, train, train_lm
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train("yi-6b", steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compressed_checkpointing.main()
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(cfg).init_cache(1, 4)             # caches default to cuda
    PagedKVEngine(cfg, params, device="cpu")        # explicit CPU is fine
    ReferencePagedKVEngine(cfg, params, device="cpu")
