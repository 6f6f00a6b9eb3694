"""Kernels of the port: CUDA sources in ``../csrc``, launchers, plain
versions (``ref``) and the device-dispatching wrappers (``ops``)."""
