"""The compression mechanisms: value-space BDI tiles (``bdi_value``), LCP
pages (``lcp``), and the numpy models of the thesis' host-side codecs and
policies (``bdi_exact``, ``patterns``, ``camp``, ``toggle``, ``prior``),
copied from ``repro/core`` so the port imports nothing of ``repro``."""
