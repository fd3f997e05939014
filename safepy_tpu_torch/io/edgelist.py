"""The native host parser of tab edge lists (``csrc/edgelist.cpp``).

Port of ``safepy_tpu/native/__init__.py``: the C++ source is compiled with
``g++`` at first use, never at import, into ``build/`` at the repository
root, keyed by a hash of the source and flags, and bound with
:mod:`ctypes`. A host accelerant of the text loader, not a device kernel:
:func:`parse_edgelist` returns None where the toolchain or the build fails,
and the loader's ``engine='auto'`` then takes its Python parser.

Unlike the JAX package's build (a ``threading.Lock`` and one shared
``.tmp`` name, which lets the worker processes of a parallel test run race
and mark the build failed), the build here holds a cross-process file lock
and renames a per-process temporary file into place atomically.
"""

from __future__ import annotations

import ctypes
import fcntl
import gzip
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "edgelist.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsafepy_edgelist-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser unless a library of the same hash exists. Raises
    where g++ is missing or the compile fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".edgelist.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compiler across processes
        if so.exists():  # built by the process that held the lock before
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
    return so


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError) as e:
            logging.info("native edge-list parser unavailable (%s); using the "
                         "Python parser", e)
            _build_failed = True
            return None
        lib.el_parse.restype = ctypes.c_void_p
        lib.el_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
        lib.el_error.restype = ctypes.c_char_p
        lib.el_error.argtypes = [ctypes.c_void_p]
        for name in ("el_num_edges", "el_num_nodes", "el_keys_size",
                     "el_labels_size"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("el_copy_edges", "el_copy_weights"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for name in ("el_copy_keys", "el_copy_labels"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.el_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _strings(lib, handle, size_fn, copy_fn) -> list[str]:
    size = size_fn(handle)
    buf = ctypes.create_string_buffer(size)
    copy_fn(handle, buf)
    return buf.raw[:size].decode("utf-8").split("\n")[:-1]


def parse_edgelist(path: str, ncols: int, *, skip_header: bool = False):
    """Parse a 3- or 5-column tab edge list (``.gz`` read transparently).

    Returns (labels, keys, edges int32 (E, 2), weights f64): nodes numbered
    by first appearance of their label, every first-column endpoint before
    every second-column one; or None where the parser cannot be built."""
    lib = _load()
    if lib is None:
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        buf = f.read()
    if skip_header:
        nl = buf.find(b"\n")
        buf = buf[nl + 1:] if nl >= 0 else b""

    handle = lib.el_parse(buf, len(buf), ncols)
    try:
        err = lib.el_error(handle)
        if err:
            raise ValueError(f"native edgelist parse failed: {err.decode()}")
        num_edges = lib.el_num_edges(handle)
        edges = np.empty((num_edges, 2), np.int32)
        lib.el_copy_edges(handle, edges.ctypes.data_as(ctypes.c_void_p))
        weights = np.empty(num_edges, np.float64)
        lib.el_copy_weights(handle, weights.ctypes.data_as(ctypes.c_void_p))
        keys = _strings(lib, handle, lib.el_keys_size, lib.el_copy_keys)
        labels = _strings(lib, handle, lib.el_labels_size, lib.el_copy_labels)
        return labels, keys, edges, weights
    finally:
        lib.el_free(handle)
