"""Parameter, batch and cache sharding rules for the production mesh
(port of ``repro/distributed/sharding.py``).

Axes: ``model`` = tensor/expert parallelism, ``data`` (+ ``pod``) = data
parallelism; FSDP-style weight sharding over the data axes kicks in for
params whose per-model-shard size exceeds a threshold (arctic-480b cannot
replicate its experts across DP).  ZeRO-1: optimizer moments reuse the
parameter specs (so they are at least as sharded as the weights).

The rule table is path-pattern based (first match wins) on the keystr
paths of ``checkpoint/store.leaf_paths``, which are JAX's, so the
patterns are the JAX package's unchanged.  The rules read shapes and
dtypes only: a tree of ``meta`` tensors (the model's init on
``device="meta"``, whose draws allocate nothing) sizes any config,
arctic-480b included.  A mesh is a ``DeviceMesh`` or an abstract mesh
(``launch/elastic.abstract_mesh``).

Where JAX places a tree with ``device_put`` and each device then holds
its block, a rank of the port holds that block as a plain tensor:
:func:`local_shards` cuts it out of the whole leaf (:func:`local_params`
for the serving layout, ``fsdp=False``, or the training one, ``fsdp=True``;
:func:`local_batch` a batch's rows).  ``FSDP_THRESHOLD_BYTES`` is read at
each call.
"""

from __future__ import annotations

import re

import numpy as np

from repro_torch.checkpoint.store import _rebuild, leaf_paths

from .axes import NamedSharding, P, PartitionSpec, mesh_axes

# (path regex, spec template) -- templates use "m" for the model axis, None
# for replicated; applied to the *trailing* dims (leading scan/layer dims
# padded with None). First match wins.
_RULES: list[tuple[str, tuple]] = [
    (r"embed.*\['w'\]", ("m", None)),
    (r"lm_head.*\['w'\]", (None, "m")),
    # attention
    (r"\['attn'\]\['w[qkv]'\]\['w'\]", (None, "m", None)),
    (r"\['attn'\]\['w[qkv]'\]\['b'\]", ("m", None)),
    (r"\['attn'\]\['wo'\]\['w'\]", ("m", None, None)),
    (r"\['cross'\]\['w[qkv]'\]\['w'\]", (None, "m", None)),
    (r"\['cross'\]\['w[qkv]'\]\['b'\]", ("m", None)),
    (r"\['cross'\]\['wo'\]\['w'\]", ("m", None, None)),
    # MLA
    (r"\['attn'\]\['wu[kv]'\]\['w'\]", (None, "m", None)),
    (r"\['attn'\]\['wdkv'\]", (None, None)),
    (r"\['attn'\]\['wkr'\]", (None, None)),
    # MoE experts (EP over model)
    (r"\['experts'\]\['(gate|up|down)'\]\['w'\]", ("m", None, None)),
    (r"\['router'\]", (None, None)),
    # dense MLPs (column/row parallel)
    (r"\['(gate|up)'\]\['w'\]", (None, "m")),
    (r"\['down'\]\['w'\]", ("m", None)),
    # mamba
    (r"\['mamba'\]\['in_proj'\]", (None, "m")),
    (r"\['mamba'\]\['conv_w'\]", (None, "m")),
    (r"\['mamba'\]\['conv_b'\]", ("m",)),
    (r"\['mamba'\]\['x_proj'\]", ("m", None)),
    (r"\['mamba'\]\['dt_proj'\]\['w'\]", (None, "m")),
    (r"\['mamba'\]\['dt_proj'\]\['b'\]", ("m",)),
    (r"\['mamba'\]\['a_log'\]", ("m", None)),
    (r"\['mamba'\]\['d_skip'\]", ("m",)),
    (r"\['mamba'\]\['out_proj'\]", ("m", None)),
    # xLSTM cells
    (r"\['mlstm'\]\['(up|gate_z)'\]", (None, "m")),
    (r"\['mlstm'\]\['w[qkv]'\]", (None, "m")),
    (r"\['mlstm'\]\['w_if'\]", (None, None)),
    (r"\['mlstm'\]\['down'\]", ("m", None)),
    (r"\['slstm'\]\['wx'\]", (None, "m")),
    (r"\['slstm'\]\['r'\]", ("m", None, None)),
    # norms & everything else: replicated
    (r".*", ()),
]

FSDP_THRESHOLD_BYTES = 64 << 20      # shard over DP above 64MB/model-shard


def _dp_axes(mesh) -> tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def data_dim(spec) -> int | None:
    """The dim of ``spec`` split over the data axes (``"data"``, or
    ``("pod", "data")`` on the multi-pod mesh), or None."""
    for i, s in enumerate(spec):
        if s == "data" or isinstance(s, tuple) and "data" in s:
            return i
    return None


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


_MOMENT_SUFFIX = re.compile(r"(\['(deltas|base|scale|maskp|enc)'\])$")


def rule_template(path: str) -> tuple:
    """The rule table's template of a params leaf's path (the first
    pattern that matches): ``"m"`` for a dim sharded over ``model``,
    applied to the trailing dims."""
    for pat, template in _RULES:
        if re.search(pat, path):
            return tuple(template)
    raise AssertionError("the last rule matches every path")


def _spec_for(path: str, shape: tuple[int, ...], mesh,
              itemsize: int, fsdp: bool) -> PartitionSpec:
    # BDI-compressed moment leaves (tile-last layout, optim/adamw.py):
    # derive the spec from the underlying parameter's rule. deltas/maskp
    # carry one extra trailing tile dim; base/scale/enc replace the last
    # parameter dim with the tile count.
    msuf = _MOMENT_SUFFIX.search(path)
    extra_trailing = 0
    if msuf:
        if msuf.group(2) in ("deltas", "maskp"):
            extra_trailing = 1
        path = path[:msuf.start()]
    template = rule_template(path) + (None,) * extra_trailing
    if len(template) > len(shape):
        return P(*([None] * len(shape)))
    spec = [None] * (len(shape) - len(template)) + [
        ("model" if s == "m" else s) for s in template]
    sizes = mesh_axes(mesh)
    msize = sizes.get("model", 1)
    # drop model sharding if the dim does not divide
    for i, s in enumerate(spec):
        if s == "model" and shape[i] % msize != 0:
            spec[i] = None

    if fsdp:
        dp = _dp_axes(mesh)
        dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1
        if dp_size > 1:
            shard_elems = np.prod(shape) / max(
                msize if "model" in spec else 1, 1)
            if shard_elems * itemsize > FSDP_THRESHOLD_BYTES:
                # shard the largest replicated dim divisible by dp_size
                cands = [i for i, s in enumerate(spec)
                         if s is None and shape[i] % dp_size == 0]
                if cands:
                    i = max(cands, key=lambda j: shape[j])
                    spec[i] = dp if len(dp) > 1 else dp[0]
    return P(*spec)


def param_specs(shape_tree, mesh, *, fsdp: bool = True):
    """Tree of PartitionSpec for a params/opt-state shape tree (tensors,
    ``meta`` ones included: only shapes and dtypes are read)."""
    specs = [_spec_for(path, tuple(leaf.shape), mesh, leaf.element_size(),
                       fsdp)
             for path, leaf in leaf_paths(shape_tree)]
    return _rebuild(shape_tree, iter(specs))


def spec_leaves(spec_tree) -> list[tuple[str, PartitionSpec]]:
    """``(keystr, spec)`` pairs of a tree of specs (a spec is a tuple, so
    a plain flatten would descend into it)."""
    return leaf_paths(spec_tree, is_leaf=_is_spec)


def local_shards(tree, specs, mesh, coord: dict | None = None):
    """This rank's block of every leaf of ``tree`` (a params tree, whether
    made by the port or bridged from JAX by ``models/params.from_numpy``,
    or a decode cache) laid out as ``specs`` (the tree of specs of
    :func:`param_specs` or :func:`cache_specs`) on ``mesh``.

    Along each dim that names mesh axes the leaf is cut into n contiguous
    blocks, n the product of those axes' sizes, and block i is kept, i
    this rank's coordinates on them read major to minor: the block JAX's
    ``NamedSharding`` gives the device at those coordinates.  ``coord``
    maps axis names to coordinates; by default this rank's on a
    ``DeviceMesh``.  A leaf cut anywhere comes back as a compact copy, so
    that the whole one can be freed; the others as they are."""
    sizes = mesh_axes(mesh)
    if coord is None:
        coord = {a: mesh.get_local_rank(a) for a in sizes}
    leaves, spec_list = leaf_paths(tree), spec_leaves(specs)
    if len(leaves) != len(spec_list):
        raise ValueError("local_shards: the tree and its specs differ")
    out = []
    for (path, leaf), (_, spec) in zip(leaves, spec_list):
        x = leaf
        for d, c in enumerate(_cuts(path, tuple(leaf.shape), spec, sizes,
                                    coord)):
            if c.stop - c.start < leaf.shape[d]:
                x = x.narrow(d, c.start, c.stop - c.start)
        out.append(x if x is leaf else x.clone())
    return _rebuild(tree, iter(out))


def _layer_spec(path: str, shape: tuple, mesh, itemsize: int, fsdp: bool,
                layers: int | None):
    """The spec of the leaf at ``path`` (keyed as in the whole tree) of
    ``shape``; under ``['blocks']`` with ``layers``, ``shape`` is one
    layer's of a stack of that many, whose bytes FSDP reads, and a spec
    that splits the layers themselves raises."""
    if layers is None or not path.startswith("['blocks']"):
        return _spec_for(path, shape, mesh, itemsize, fsdp)
    spec = _spec_for(path, (layers, *shape), mesh, itemsize, fsdp)
    if spec[0] is not None:
        raise NotImplementedError(f"{path}: {spec} splits the layers; "
                                  "a layer is not cut on its own")
    return P(*spec[1:])


def local_params(tree, mesh, coord: dict | None = None, *,
                 fsdp: bool = False, layers: int | None = None):
    """:func:`local_shards` of a params tree (or a subtree keyed as in the
    whole tree) under ``param_specs(fsdp=fsdp)``: the serving layout by
    default, the training layout of JAX's dry run (FSDP blocks over the
    data axes) with ``fsdp=True``.  ``layers``: the leaves under
    ``['blocks']`` are one layer of a stack of that many (an init that
    cuts each layer as it is drawn, :class:`Local`)."""
    specs = [_layer_spec(path, tuple(leaf.shape), mesh, leaf.element_size(),
                         fsdp, layers) for path, leaf in leaf_paths(tree)]
    return local_shards(tree, _rebuild(tree, iter(specs)), mesh, coord)


def _cuts(path: str, shape: tuple, spec, sizes: dict, coord: dict
          ) -> list[slice]:
    """The slice of each dim of the leaf at ``path`` of ``shape`` that the
    rank at ``coord`` keeps under ``spec``: along each dim that names mesh
    axes, block i of n contiguous ones, n the product of those axes'
    sizes and i this rank's coordinates on them read major to minor."""
    out = []
    for d, n_d in enumerate(shape):
        s = spec[d] if d < len(spec) else None
        axes = () if s is None else (s if isinstance(s, tuple) else (s,))
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        if n_d % n:
            raise ValueError(f"{path}: dim {d} of {tuple(shape)} does not "
                             f"split into {n} blocks")
        b = n_d // n
        out.append(slice(i * b, (i + 1) * b))
    return out


class Local:
    """``local_params(tree, mesh, coord, fsdp=fsdp, layers=layers)`` as a
    function of a subtree (``models/transformer.init_params(local=)``),
    which also gives one leaf's block before the leaf exists
    (:meth:`block`), so that an init can draw the parts a rank does not
    keep without holding them (the MoE experts, ``models/moe.init_moe``)."""

    def __init__(self, mesh, coord: dict | None = None, *,
                 fsdp: bool = False, layers: int | None = None):
        self.mesh, self.fsdp, self.layers = mesh, fsdp, layers
        self.coord = coord if coord is not None else {
            a: mesh.get_local_rank(a) for a in mesh_axes(mesh)}

    def __call__(self, tree):
        return local_params(tree, self.mesh, self.coord, fsdp=self.fsdp,
                            layers=self.layers)

    def block(self, path: str, shape: tuple, itemsize: int = 2
              ) -> list[slice]:
        """The slices of each dim of the leaf at ``path`` (keyed as in the
        whole tree) of whole ``shape`` (one layer's, under ``['blocks']``
        with ``layers``) that this rank keeps."""
        spec = _layer_spec(path, tuple(shape), self.mesh, itemsize,
                           self.fsdp, self.layers)
        return _cuts(path, tuple(shape), spec, mesh_axes(self.mesh),
                     self.coord)


def param_shardings(shape_tree, mesh, *, fsdp: bool = True):
    """Tree of :class:`axes.NamedSharding` (mesh, spec, placements)."""
    specs = [s for _, s in spec_leaves(param_specs(shape_tree, mesh,
                                                   fsdp=fsdp))]
    return _rebuild(shape_tree, iter(NamedSharding(mesh, s) for s in specs))


def batch_specs(batch_shape_tree, mesh):
    """Batch dims shard over DP; everything else replicated."""
    dp = _dp_axes(mesh)
    dpa = dp if len(dp) > 1 else (dp[0] if dp else None)
    sizes = mesh_axes(mesh)

    def spec(leaf):
        if len(leaf.shape) == 0:
            return P()
        dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1
        if leaf.shape[0] % max(dp_size, 1) == 0 and dp_size > 1:
            return P(*([dpa] + [None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return _rebuild(batch_shape_tree, iter(
        spec(leaf) for _, leaf in leaf_paths(batch_shape_tree)))


def local_batch(batch: dict, mesh, coord: dict | None = None) -> dict:
    """This rank's rows of a batch (a dict of arrays with the batch first)
    under :func:`batch_specs`: dim 0 cut over the data axes, or the whole
    batch where its rows do not divide them, as JAX replicates it."""
    return local_shards(batch, batch_specs(batch, mesh), mesh, coord)


def cache_specs(cache_shape_tree, mesh, batch_axis: int = 1):
    """Decode-cache sharding: batch over DP; KV-heads or T over model.

    Cache arrays look like [L, B, T, K, Dh] (attention), [L, B, ...] (ssm).
    Preference order for the model axis: K (head parallel) > T (sequence
    parallel storage) > feature dim > replicated.
    """
    dp = _dp_axes(mesh)
    dpa = dp if len(dp) > 1 else (dp[0] if dp else None)
    sizes = mesh_axes(mesh)
    dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1
    msize = sizes.get("model", 1)

    def spec(leaf):
        nd = len(leaf.shape)
        s: list = [None] * nd
        if nd > batch_axis and leaf.shape[batch_axis] % max(dp_size, 1) == 0 \
                and dp_size > 1:
            s[batch_axis] = dpa
        if msize > 1:
            if nd == 5 and leaf.shape[3] % msize == 0:      # K heads
                s[3] = "model"
            elif nd == 5 and leaf.shape[2] % msize == 0:    # T
                s[2] = "model"
            elif nd >= 3:
                for i in range(nd - 1, batch_axis, -1):
                    if s[i] is None and leaf.shape[i] % msize == 0 \
                            and leaf.shape[i] >= msize:
                        s[i] = "model"
                        break
        return P(*s)

    return _rebuild(cache_shape_tree, iter(
        spec(leaf) for _, leaf in leaf_paths(cache_shape_tree)))
