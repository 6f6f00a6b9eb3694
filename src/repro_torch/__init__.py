"""PyTorch/CUDA port of the compression stack in ``repro``.

The JAX package ``repro`` is the reference; this package re-implements
it for an NVIDIA H100, path by path: compressed-KV paged serving of a
dense-GQA model (``yi-6b``) through :class:`serving.engine.PagedKVEngine`
under every page codec, and the value-space BDI tile codec with LCP
pages (``core/``, ``kernels.ops.compress``/``decompress``, the
quickstart in ``launch/quickstart.py``).  Every TPU kernel of the JAX
package has a CUDA C++ counterpart under ``csrc/``, built at first use
by :mod:`kernels._build`.

Entry points run on the card unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
Nothing here imports ``jax`` or ``repro``.
"""
