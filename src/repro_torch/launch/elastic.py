"""Elastic scaling: restore a checkpoint onto a different topology (port
of ``repro/launch/elastic.py``).

The checkpoint stores tensors logically (``checkpoint/store.py``), so a
job that trained on N ranks can resume on M: build the new mesh, derive
the sharding rules for it, and ``restore(..., target_shardings=...)``,
which places each leaf on the mesh as a DTensor.  :func:`reshard_plan`
audits which parameters lose sharding on the new mesh (the
capacity-planning signal an operator needs before shrinking a fleet),
on abstract meshes that need no devices.

Usage (library):
    plan = reshard_plan(params_shape, old_mesh, new_mesh)
    params, _ = restore_elastic(ckpt_dir, params_shape, new_mesh)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.axes import mesh_axes


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices (JAX's
    ``AbstractMesh``)."""
    axis_names: tuple[str, ...]
    shape: dict = field(hash=False)


def abstract_mesh(sizes: tuple[int, ...], names: tuple[str, ...]
                  ) -> AbstractMesh:
    if len(sizes) != len(names):
        raise ValueError(f"sizes {sizes} and names {names} differ in length")
    return AbstractMesh(tuple(names), dict(zip(names, map(int, sizes))))


def reshard_plan(shape_tree, old_mesh, new_mesh) -> dict:
    """Audit how sharding changes between meshes.

    Returns {path: {"old": spec, "new": spec, "bytes": n,
                    "replicated_growth": factor}} for leaves whose
    per-device footprint grows on the new mesh.
    """
    flat = store.leaf_paths(shape_tree)
    flat_old = SH.spec_leaves(SH.param_specs(shape_tree, old_mesh))
    flat_new = SH.spec_leaves(SH.param_specs(shape_tree, new_mesh))

    def shard_factor(spec, mesh):
        sizes = mesh_axes(mesh)
        f = 1
        for s in spec:
            if s is None:
                continue
            for ax in (s if isinstance(s, tuple) else (s,)):
                f *= sizes.get(ax, 1)
        return f

    report = {}
    for (path, leaf), (_, so), (_, sn) in zip(flat, flat_old, flat_new):
        fo = shard_factor(so, old_mesh)
        fn = shard_factor(sn, new_mesh)
        if fn < fo:
            nbytes = int(np.prod(leaf.shape)) * leaf.element_size()
            report[path] = {
                "old": str(so), "new": str(sn), "bytes": nbytes,
                "replicated_growth": fo / fn,
            }
    return report


def restore_elastic(ckpt_dir: str, shape_tree, new_mesh,
                    step: int | None = None):
    """Restore a checkpoint sharded for whatever mesh the new job has:
    each leaf a DTensor on ``new_mesh`` (``shape_tree`` may be ``meta``
    tensors).  Returns ``(tree, manifest)``."""
    shardings = SH.param_shardings(shape_tree, new_mesh)
    return store.restore(ckpt_dir, shape_tree, step=step,
                         target_shardings=shardings)
