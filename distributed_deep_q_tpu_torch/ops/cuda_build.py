"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` inside
the package (the hash is the source's, so an edited source rebuilds), then
loaded with ``ctypes``. Nothing is built when the package is imported: the
first CUDA call of a kernel builds its library, and ``build_all`` starts one
``nvcc`` per source at once for callers that want the build up front.
``Entry`` is how a kernel wrapper calls a C entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("ring_gather", "fused_loss")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the package's kernels")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC_DIR / f"{name}.cu").read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns seconds per
    source built (0.0 when it already existed); each compiler log (with
    ``-Xptxas -v``'s register and spill report) lands in ``build_logs``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


class Entry:
    """One C entry point of a kernel library, called as
    ``entry(device, *args)``: it appends PyTorch's current stream on
    ``device`` to ``args``, makes ``device`` current for the call when it
    is not, and returns the entry's CUDA error code (0 = launched).

    Its library is loaded (built first, if need be) and the function looked
    up at the first call, and kept: a wrapper's per-call host cost is then
    the ctypes call and a stream lookup, which matters because a flush or a
    grad step is host-bound."""

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib, self.symbol = lib, symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]    # + the stream
        self._fn = None

    def __call__(self, device: torch.device, *args) -> int:
        fn = self._fn
        if fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        index = device.index
        current = torch.cuda.current_device()
        if index is None:
            index = current
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index == current:
            return fn(*args, stream)
        with torch.cuda.device(index):
            return fn(*args, stream)
