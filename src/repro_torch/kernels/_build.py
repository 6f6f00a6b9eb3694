"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with its own ``nvcc`` process (all started
together; they include the ``*.cuh`` headers beside them) and the
objects link into one shared library with a plain C interface, loaded
with ``ctypes``.  The library lives under ``build/repro_torch/<hash>/``
at the repository root, keyed by a hash of the sources, headers and
flags, so a changed file rebuilds and an unchanged tree is reused.
Nothing is built at import: :func:`load` runs at the first
kernel launch.  A failed build raises with the compiler's output.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3`` and, on purpose, no
``--use_fast_math`` (the BDI and GBDI codecs need IEEE division and
subnormals).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (argtypes, restype); see the extern "C" functions in csrc/
    "bdi_compress_kv": ([_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                         _P], ctypes.c_int),
    "paged_attention_tail": ([_P] * 14 + [ctypes.c_int] * 7 + [_P],
                             ctypes.c_int),
    "gbdi_compress_kv": ([_P] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, _P], ctypes.c_int),
    "gbdi_decompress_kv": ([_P] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, _P], ctypes.c_int),
    "bdi_compress": ([_P] * 6 + [ctypes.c_longlong, ctypes.c_int, _P],
                     ctypes.c_int),
    "bdi_decompress": ([_P] * 5 + [ctypes.c_longlong, ctypes.c_int, _P],
                       ctypes.c_int),
    "paged_attention": ([_P] * 11 + [ctypes.c_int] * 7 + [_P], ctypes.c_int),
}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(SOURCES_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCES_DIR.glob("*.cu*")):      # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, str]:
    """Compile the sources if this hash has no library yet.

    Returns the library path and the compilers' output (``-Xptxas -v``
    register and shared-memory report; empty when the library existed).
    """
    out = library_path()
    if out.is_file():
        return out, ""
    nvcc = _nvcc()
    tmp = out.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(log))
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp)]
            + [str(obj) for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)      # atomic: concurrent builds agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, "\n".join(log)


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_tensor(t, name: str, dtype, shape: tuple[int, ...],
                 device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``: what a C entry point takes as a raw pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
