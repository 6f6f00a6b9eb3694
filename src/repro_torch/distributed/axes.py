"""Mesh context and activation-sharding helpers (port of
``repro/distributed/axes.py``).

A launcher activates a ``DeviceMesh`` with :func:`use_mesh`; code that
has a mesh-parallel path (``models/moe.py``'s expert parallelism, the
tensor-parallel layers through ``distributed/tp.py``) reads it back with
:func:`current_mesh`.  With no mesh active, :func:`shard`
returns its tensor unchanged, so model code never branches.

Axis conventions, as in the JAX package:

  * ``DP``      -- data parallelism: ("pod", "data") when a pod axis
                   exists, else ("data",).  Batch and token dims shard here.
  * ``"model"`` -- tensor and expert parallelism.

A spec is a :class:`PartitionSpec` (``P``): one entry per tensor dim,
each None (replicated), a mesh axis name, or a tuple of names.  Its
``str()`` is the JAX package's, so reports that carry specs
(``launch/elastic.reshard_plan``) compare with JAX's as strings.  Where
JAX has a ``NamedSharding``, the port has the mesh and the DTensor
placements of the resolved spec (:func:`placements`,
:func:`named_sharding`).

JAX's ``shard_map`` wrapper has no counterpart: a caller runs its
per-rank body directly and calls the collective on the mesh's process
group for the axis (``mesh.get_group("data")``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

_state = threading.local()

DP = "__dp__"          # sentinel expanded to the mesh's data axes
MODEL = "model"


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: a tuple of per-dim entries.  A one-name
    tuple entry is kept as the bare name, as JAX keeps it, so that
    ``str()`` and equality agree with JAX's."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        if len(self) == 1:
            return f"PartitionSpec({self[0]!r},)"
        return f"PartitionSpec({', '.join(repr(p) for p in self)})"

    __str__ = __repr__


P = PartitionSpec


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of an
    abstract mesh (``launch/elastic.abstract_mesh``: ``axis_names`` and a
    ``shape`` dict, no devices)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def current_mesh() -> DeviceMesh | None:
    return getattr(_state, "mesh", None)


def dp_axes() -> tuple[str, ...]:
    mesh = current_mesh()
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def resolve(spec: tuple) -> PartitionSpec:
    """Expand the DP sentinel and drop axes absent from the current mesh."""
    mesh = current_mesh()
    names = set(mesh_axes(mesh)) if mesh is not None else set()
    out: list = []
    for s in spec:
        if s == DP:
            axes = dp_axes()
            out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        elif s is None:
            out.append(None)
        elif isinstance(s, tuple):
            kept = tuple(a for a in s if a in names)
            out.append(kept if kept else None)
        else:
            out.append(s if s in names else None)
    return P(*out)


def spec_axes(spec: tuple) -> list[str]:
    """The mesh axis names a spec shards over, in dim order."""
    return [a for s in spec if s is not None
            for a in (s if isinstance(s, tuple) else (s,))]


def placements(spec: tuple, mesh) -> list[Placement]:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d names that axis, else ``Replicate()``.
    A dim over several axes (``('pod', 'data')``) shards over them major
    to minor, as JAX's tuple does and as DTensor orders mesh dims."""
    out: list[Placement] = []
    for name in mesh_axes(mesh):
        dims = [d for d, s in enumerate(spec) if s is not None
                and name in (s if isinstance(s, tuple) else (s,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


@dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a mesh, a spec, and the spec's DTensor
    placements on it (a leaf of a tree, not a tuple)."""
    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> list[Placement]:
        return placements(self.spec, self.mesh)


def named_sharding(*spec) -> NamedSharding:
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("named_sharding requires an active mesh")
    return NamedSharding(mesh, resolve(spec))


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """The shape of one rank's block of a global ``shape`` laid out as
    ``spec`` on ``mesh``: each dim divided by the sizes of the axes it
    names."""
    sizes = mesh_axes(mesh)
    out = []
    for n, s in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        for a in () if s is None else (s if isinstance(s, tuple) else (s,)):
            n //= sizes[a]
        out.append(n)
    return tuple(out)


def shard(x: torch.Tensor, *spec, global_shape: tuple | None = None
          ) -> torch.Tensor:
    """Lay ``x`` out as ``spec`` says when a mesh is active; unchanged
    otherwise.  A DTensor is redistributed to the spec's placements.  A
    plain tensor is taken as this rank's block (the tensor- and
    data-parallel layers, ``distributed/tp.py``, hold plain blocks): it
    comes back unchanged where its shape is the block's of
    ``global_shape`` (the global array's, needed where the spec names an
    axis of size > 1: ``model``, ``data`` or ``pod``); a wrong shape
    raises."""
    mesh = current_mesh()
    if mesh is None:
        return x
    ns = named_sharding(*spec)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, ns.placements)
    sizes = mesh_axes(mesh)
    split = [a for a in spec_axes(ns.spec) if sizes[a] > 1]
    if split:
        if global_shape is None:
            raise TypeError(f"shard: a plain tensor split over {split} needs "
                            "the global_shape it is a block of")
        want = local_shape(tuple(global_shape), ns.spec, mesh)
        if tuple(x.shape) != want:
            raise ValueError(f"shard: a block of {tuple(global_shape)} under "
                             f"{ns.spec} is {want}, not {tuple(x.shape)}")
    return x


SP_ENABLED = False   # sequence-parallel residual stream (JAX's set_sp)


def set_sp(enabled: bool) -> None:
    """Turn the sequence-parallel residual stream on or off, for the whole
    process (every thread, autograd's recompute among them), as JAX's
    module switch does.  Off by default."""
    global SP_ENABLED
    SP_ENABLED = bool(enabled)


def seq_split(seq_len: int) -> bool:
    """Whether a residual stream of ``seq_len`` positions lies over
    ``(DP, "model", None)``: sequence parallelism on, a mesh whose model
    axis m > 1, and m dividing ``seq_len``.  Otherwise it lies over
    ``(DP, None, None)``, JAX's fallback."""
    mesh = current_mesh()
    if not SP_ENABLED or mesh is None:
        return False
    m = mesh_axes(mesh).get(MODEL, 1)
    return m > 1 and seq_len % m == 0


def shard_seq(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """The residual stream's layout: [B, S, D] activations (``seq_len`` =
    S, the whole sequence; ``x`` whole or this rank's S block) over (DP,
    None, None), or with sequence parallelism over (DP, "model", None)
    where :func:`seq_split` says so: ``distributed/tp.seq_parallel``'s
    cut, which a layer body enters itself.  A no-op with no mesh, as in
    JAX.  A plain tensor outside sequence parallelism is the rank's rows
    already and comes back as it is; a DTensor is laid out over (DP, None,
    None)."""
    mesh = current_mesh()
    if mesh is None or x.ndim != 3:
        return x
    if isinstance(x, DTensor) and not seq_split(seq_len):
        return shard(x, DP, None, None)
    from . import tp
    with tp.seq_parallel(x, seq_len) as x:
        return x
