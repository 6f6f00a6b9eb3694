"""Quickstart: the thesis' compression stack in five stages (port of
``examples/quickstart.py``).

  1. BDI lossless codec on cache lines (Chapter 3),
  2. value-space BDI on a tensor through the tile kernels,
  3. an LCP compressed page with exceptions (Chapter 5),
  4. CAMP size-aware cache management (Chapter 4),
  5. toggle-aware EC on a wire stream (Chapter 6).

Stages 1, 4 and 5 are the numpy models of ``repro_torch.core`` and print
the JAX quickstart's numbers.  Stages 2 and 3 make their inputs from a
``torch.Generator`` on the device and run there: stage 2 through
``ops.compress``/``ops.decompress`` (the CUDA tile kernels on the card,
their plain versions on the CPU), stage 3 through ``core.lcp``.  Runs on
the card unless asked for the CPU; raises without CUDA.

Run: PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import bdi_exact as bx
from repro_torch.core import camp, lcp, patterns, toggle
from repro_torch.kernels import ops
from repro_torch.kernels._device import resolve_device


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"quickstart: {what}")


def main(device: str | torch.device | None = None) -> dict:
    """Run the five stages on ``device`` (default ``cuda``); returns the
    numbers it prints."""
    dev = resolve_device(device)
    res = {"device": str(dev)}

    # 1 -- lossless BDI on the thesis' cache-line patterns
    lines = patterns.thesis_mix(4096, seed=0)
    res["bdi_ratio"] = bx.effective_ratio(bx.bdi_sizes(lines))
    print(f"[1] BDI effective compression ratio on the thesis mix: "
          f"{res['bdi_ratio']:.2f}x (paper: ~1.5x)")
    _check((bx.bdi_decompress(bx.bdi_compress(lines)) == lines).all(),
           "BDI round trip is not bit-exact")
    print("    round-trip: bit-exact")

    # 2 -- value-space BDI through the tile kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((512, 128), generator=gen, device=dev) * 3
    packed = ops.compress(x)
    xhat = ops.decompress(packed)
    err = (xhat - x).abs()
    _check(bool((err <= 0.5 * packed.scale).all()),
           "tile error above scale/2")
    res["tile_err"] = float(err.max())
    res["tile_bound"] = float(0.5 * packed.scale.max())
    print(f"[2] BDI tile kernels on {dev.type}: {x.numel() * 4} B -> "
          f"~{x.numel() + x.numel() // 8} B, max err {res['tile_err']:.4f} "
          f"(bound {res['tile_bound']:.4f})")

    # 3 -- an LCP page
    gen = torch.Generator(device=dev).manual_seed(1)
    page_data = torch.cat([
        100.0 + 1e-3 * torch.randn((60, 128), generator=gen, device=dev),
        torch.randn((4, 128), generator=gen, device=dev) * 2,  # exceptions
    ])
    page = lcp.compress_page(page_data, exc_slots=8, raw_rtol=1e-4)
    res["lcp_ratio"] = float(lcp.page_compression_ratio(page))
    res["lcp_exceptions"] = int(page.n_exc)
    print(f"[3] LCP page: ratio {res['lcp_ratio']:.2f}x, "
          f"{res['lcp_exceptions']} exception lines, "
          f"overflow={bool(page.overflow)}")
    line = lcp.read_line(page, 62)               # O(1) address computation
    _check(torch.equal(line, page_data[62]), "exception line not exact")

    # 4 -- CAMP
    trace = camp.soplex_like_trace(n_epochs=8)
    for pol in ("lru", "rrip", "camp", "gcamp"):
        r = camp.run_policy(trace, pol, capacity_bytes=32 << 10)
        res[f"miss_rate_{pol}"] = r["miss_rate"]
        print(f"[4] {pol:6s} miss rate {r['miss_rate']:.3f}")

    # 5 -- toggle-aware EC
    stats = toggle.ec_stream(patterns.narrow_lines(1024, seed=3),
                             e_toggle=4.0, e_byte=1.0)
    raw = max(stats["raw_toggles"], 1)
    print(f"[5] EC: compression {stats['comp_ratio']:.2f}x raises toggles "
          f"{stats['comp_toggles'] / raw:.2f}x; EC keeps "
          f"{stats['ec_ratio']:.2f}x at {stats['ec_toggles'] / raw:.2f}x "
          f"toggles")
    res["ec"] = stats
    print("quickstart OK")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    main(ap.parse_args().device)
