"""Mesh construction (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims over
the default process group: NCCL on the card, gloo on the CPU.  The group
is made here only for a one-rank mesh, in process, over a ``HashStore``
(no TCP port); any larger mesh needs the caller (``torchrun``, or a
test's spawner) to have made the group of the right size.  There is no
fallback: on the card the group is NCCL, and a failure to make it
raises.  One exception, made by the caller and never chosen here: a
gloo group on the card is taken when the world has more ranks than the
machine has cards, since NCCL refuses two ranks on one device
("Duplicate GPU detected : rank 0 and rank 1 both on CUDA device").
Every mesh prints the backend it runs on.  :func:`destroy_mesh` tears
the group down, so that a process can build one mesh after another.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels._device import resolve_device

BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _mesh(shape: tuple[int, ...], names: tuple[str, ...],
          device) -> DeviceMesh:
    dev = resolve_device(device)
    n = int(np.prod(shape))
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a process group of {n} ranks "
                "(torchrun, or init_process_group in each rank)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(BACKEND[dev.type], store=dist.HashStore(),
                                rank=0, world_size=1,
                                device_id=dev if dev.type == "cuda" else None)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {dict(zip(names, shape))} needs {n} ranks; "
                           f"the process group has {dist.get_world_size()}")
    backend = dist.get_backend()
    shared = (dev.type == "cuda" and backend == "gloo"
              and n > torch.cuda.device_count())
    if BACKEND[dev.type] not in backend.split(",") and not shared:
        raise RuntimeError(f"a {dev.type} mesh needs a {BACKEND[dev.type]} "
                           f"process group, not {backend!r}"
                           + (" (gloo is taken on the card only for more "
                              "ranks than cards)" if backend == "gloo"
                              else ""))
    print(f"mesh {dict(zip(names, shape))}: {backend} on {dev.type}"
          + (f", {n} ranks on {torch.cuda.device_count()} card(s)"
             if shared else ""), file=sys.stderr, flush=True)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def production_axes(multi_pod: bool = False
                    ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's sizes and axis names: (16, 16) over ("data",
    "model"), or (2, 16, 16) with a "pod" axis.  ``make_production_mesh``
    builds it; the dry run (``launch/dryrun.py``) lays it out as an
    abstract mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None
                         ) -> DeviceMesh:
    """The mesh of :func:`production_axes`: builds only in a world of 256
    (512) ranks, and raises otherwise."""
    shape, axes = production_axes(multi_pod)
    n = int(np.prod(shape))
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 1
        raise RuntimeError(f"the production mesh {shape} needs {n} ranks; "
                           f"this world has {have}")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: str | torch.device | None = None) -> DeviceMesh:
    """A ("data", "model") mesh of data x model ranks on ``device`` (the
    card unless ``device="cpu"``)."""
    return _mesh((data, model), ("data", "model"), device)


def destroy_mesh() -> None:
    """Destroy the default process group and every group of its meshes."""
    if dist.is_initialized():
        dist.destroy_process_group()
