"""Native (C++) replay core — build + ctypes loader (the reference's
``native/__init__.py``, building the port's own copy of
``replay_core.cpp``).

``load()`` compiles ``replay_core.cpp`` with ``g++`` on first use into
``build/_replay_core-<hash>.so`` inside the package (the hash is the
source's, so an edited source rebuilds; ``build/`` is gitignored) and
returns the ctypes library, or None when there is no compiler or the build
fails. Callers then take the numpy path, which stays the semantic
reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().with_name("replay_core.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_c_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_u8pp = ctypes.POINTER(_c_u8p)


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"_replay_core-{digest}.so"


def _build(out: Path) -> bool:
    """Compile to a process-unique temp path, then rename into place —
    atomic, so concurrent builders never leave a half-written library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(  # ddq: allow(blocking.under-lock) — build-once
            # gate: _lock exists to make the first caller compile while
            # the rest wait; nothing hot shares this module lock
            ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load() -> ctypes.CDLL | None:
    """Build (if needed) and load the native core; None on any failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.st_set.argtypes = [_c_double_p, ctypes.c_int64, _c_int64_p,
                               _c_double_p, ctypes.c_int64]
        lib.st_set.restype = None
        lib.st_sample_stratified.argtypes = [
            _c_double_p, ctypes.c_int64, _c_double_p, _c_int64_p,
            ctypes.c_int64]
        lib.st_sample_stratified.restype = None
        lib.staged_append.argtypes = [
            _c_u8pp, _c_u8pp, _c_int64_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64]
        lib.staged_append.restype = ctypes.c_int64
        lib.crc32c.argtypes = [ctypes.c_uint32, _c_u8p, ctypes.c_int64]
        lib.crc32c.restype = ctypes.c_uint32
        _lib = lib
        return _lib


def as_double_p(a) -> _c_double_p:
    return a.ctypes.data_as(_c_double_p)


def as_int64_p(a) -> _c_int64_p:
    return a.ctypes.data_as(_c_int64_p)


def as_uint8_p(a) -> _c_u8p:
    return a.ctypes.data_as(_c_u8p)


def uint8_pp(ptrs) -> _c_u8pp:
    """Pack c_uint8 pointers into the pointer-array argument
    ``staged_append`` takes for its dst/src column tables."""
    arr = (_c_u8p * len(ptrs))(*ptrs)
    return ctypes.cast(arr, _c_u8pp)
