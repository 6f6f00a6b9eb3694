"""PyTorch/CUDA port of the compressed-KV serving stack in ``repro``.

The JAX package ``repro`` is the reference; this package re-implements
its main path for an NVIDIA H100: compressed-KV paged serving of a
dense-GQA model (``yi-6b``) through :class:`serving.engine.PagedKVEngine`
with the ``bdi`` page codec.  The two kernels on that path — the BDI
row codec and decode attention over compressed pages — are CUDA C++
under ``csrc/``, built at first use by :mod:`kernels._build`.

Entry points run on the card unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
Nothing here imports ``jax`` or ``repro``.
"""
