"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with :mod:`ctypes`. The build runs at
first use, never at import, into ``build/`` at the repository root, and is
keyed by a hash of the sources and flags, so an edited kernel is rebuilt and
an unchanged one is loaded as it is.

Counterpart in spirit of ``safepy_tpu/native/__init__.py``, but with no
fallback: if ``nvcc`` is missing, the build fails or a launch is refused,
this module raises. The plain torch versions in :mod:`ops.apsp_cuda` and
:mod:`ops.hypergeom_table` serve CPU tensors only; a CUDA tensor goes through
a kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("minplus.cu", "hypergeom_table.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F, _D = ctypes.c_float, ctypes.c_double
# C entry point -> argtypes; every pointer and the stream are c_void_p
_SIGNATURES = {
    "safepy_relax_panel": (_P, _I64, _P, _I64, _P, _I64, _P, _I64,
                           _I, _I, _I, _P),
    "safepy_relax_band_rows": (_P, _I64, _I64, _P, _I64, _I64, _P, _I64,
                               _I64, _P, _I64, _I64, _I, _I, _I, _I, _P),
    "safepy_relax_window_sym": (_P, _I, _P, _P, _P, _I64, _I64, _I, _I, _I,
                                _P),
    "safepy_close_diag": (_P, _I64, _P, _I, _P),
    "safepy_relax_skew_sym": (_P, _I, _P, _P, _I64, _P, _I64, _I, _I, _P),
    "safepy_relax_skew": (_P, _I, _P, _P, _I64, _P, _I64, _I, _I, _P),
    "safepy_relax_full": (_P, _I64, _P, _I64, _P, _I64, _I, _I, _I, _P),
    "safepy_relax_full_banded": (_P, _I, _P, _I64, _P, _I64, _P, _I64, _I,
                                 _I, _I, _I, _P),
    "safepy_minplus_product": (_P, _I64, _P, _I64, _P, _I64, _I, _I, _I, _P),
    "safepy_addmin_probe": (_P, ctypes.c_float, _I, _I, _P),
    "safepy_logsf_table": (_P, _P, _I, _I, _I, _D, _D, _F, _F, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsafepy_minplus-{_digest()}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists.

    nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``safepy_<name>``; raise if it reports a CUDA error."""
    err = getattr(lib(), f"safepy_{name}")(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
