"""Crash-consistent durability primitives: CRC32C, atomic writes, and a
generational snapshot store (a copy of the reference
``utils/durability.py``; host only).

Podracer-style deployments treat preemption as routine (PAPERS.md
arXiv:2104.06272) — which is only survivable if the persisted state a warm
boot depends on is *trustworthy*: a crash mid-``np.savez`` used to leave a
torn ``.npz`` at the final path that ``_restore()`` loaded blind or died
on. This module is the one place persisted bytes are produced and checked:

- ``crc32c``       — CRC-32C (Castagnoli), the checksum storage systems
  use end to end, computed by the native core (``native/replay_core.cpp``)
  when it builds. The reference's numpy version stays as the plain one
  (``crc32c_numpy``): the standard library has no CRC-32C, so its hot path is a numpy-vectorized chunked CRC: the buffer is split
  into 2^k equal chunks front-padded with zeros (a no-op for the raw
  CRC), all chunk states advance one byte per iteration as one table
  lookup across the chunk axis, and the per-chunk remainders are folded
  with GF(2) carry-less shift matrices. ~100-500 MB/s on large buffers
  vs ~3 MB/s for a pure-Python byte loop.
- ``atomic_write`` — tmp file in the destination directory + flush +
  fsync + ``os.replace`` + directory fsync: a crash at any point leaves
  either the old file or the new file, never a torn one. The ``torn=``
  chaos verb (rpc/faultinject.py) injects the disk-level failure this
  cannot prevent — a truncated or garbage-filled span that *does* reach
  the final path — so recovery is exercised, not assumed.
- ``GenerationStore`` — each snapshot is a ``gen-NNNNNNNN/`` directory
  of payload files plus a ``MANIFEST.json`` written last (the commit
  point) holding schema, per-file sizes + CRC32C, and caller metadata
  (``params_version``, ``env_steps``). Restore walks newest→oldest,
  verifies every byte against the manifest, and *quarantines* (renames +
  counts) any generation that fails instead of crashing the warm boot.
  Retention keeps the newest N generations.

The port's ``atomic_write`` also takes a writer callable, so a multi-GB
replay npz streams to disk (``replay/persistence.py``).
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import tempfile
import threading
from collections.abc import Callable
from typing import Any, BinaryIO

import numpy as np

from distributed_deep_q_tpu_torch import native

log = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_SCHEMA = 1
GEN_PREFIX = "gen-"
QUARANTINE_PREFIX = "quarantine-"

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli) — table-driven, numpy-vectorized for large buffers
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78  # reflected Castagnoli polynomial


def _build_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table[i] = c
    return table


_TABLE = _build_table()
_TABLE_LIST = [int(v) for v in _TABLE]  # python ints for the small-path loop

# GF(2) matrices are 32 uint32 columns: mat[j] = image of unit vector e_j.
# _POWS[i] advances a raw CRC state by 2^i zero BYTES; extended lazily.
_POWS: list[np.ndarray] = []
_POWS_LOCK = threading.Lock()
_BITS = np.arange(32, dtype=np.uint32)


def _mat_apply(mat: np.ndarray, states: np.ndarray) -> np.ndarray:
    """Apply one GF(2) matrix to a vector of uint32 states at once."""
    bits = ((states[:, None] >> _BITS[None, :]) & 1).astype(bool)
    return np.bitwise_xor.reduce(np.where(bits, mat[None, :], 0), axis=1)


def _mat_square(mat: np.ndarray) -> np.ndarray:
    return _mat_apply(mat, mat)


def _byte_matrix() -> np.ndarray:
    """Operator advancing a raw CRC state past one zero byte."""
    units = np.uint32(1) << _BITS
    return _TABLE[(units & 0xFF).astype(np.uint8)] ^ (units >> np.uint32(8))


def _pow_matrix(nbytes: int) -> np.ndarray:
    """``_POWS[log2(nbytes)]`` for a power-of-two byte count."""
    idx = nbytes.bit_length() - 1
    with _POWS_LOCK:
        if not _POWS:
            _POWS.append(_byte_matrix())
        while len(_POWS) <= idx:
            _POWS.append(_mat_square(_POWS[-1]))
        return _POWS[idx]


def _shift_state(state: int, nbytes: int) -> int:
    """Advance a raw CRC state past ``nbytes`` zero bytes."""
    vec = np.array([state], np.uint32)
    i = 0
    while nbytes:
        if nbytes & 1:
            vec = _mat_apply(_pow_matrix(1 << i), vec)
        nbytes >>= 1
        i += 1
    return int(vec[0])


def _raw_small(buf: bytes, state: int = 0) -> int:
    tbl = _TABLE_LIST
    for b in buf:
        state = tbl[(state ^ b) & 0xFF] ^ (state >> 8)
    return state


_SMALL = 512  # below this the python byte loop beats numpy call overhead


def _raw_crc(buf: np.ndarray) -> int:
    """Raw (unconditioned) CRC of ``buf``: state starts at 0, no final
    xor. Linear in the message, so leading zero bytes are a no-op — the
    chunked path exploits exactly that for its front padding."""
    n = buf.size
    if n <= _SMALL:
        return _raw_small(buf.tobytes())
    # P chunks × L bytes, both powers of two, P*L ≥ n, padding at the FRONT
    p_target = max(1, int((4 * n) ** 0.5))
    P = 1 << min(max(p_target.bit_length() - 1, 0), 16)
    L = 1 << max((-(-n // P) - 1).bit_length(), 0)
    padded = np.zeros(P * L, np.uint8)
    padded[P * L - n:] = buf
    # (L, P) contiguous rows: row j holds byte j of every chunk
    cols = np.ascontiguousarray(padded.reshape(P, L).T)
    states = np.zeros(P, np.uint32)
    eight = np.uint32(8)
    for j in range(L):
        states = _TABLE[((states ^ cols[j]) & 0xFF).astype(np.uint8)] \
            ^ (states >> eight)
    # tree-fold chunk remainders: raw(A||B) = M^(8|B|)·raw(A) ^ raw(B);
    # chunk lengths double each level, so each level is one fixed matrix
    span = L
    while states.size > 1:
        states = _mat_apply(_pow_matrix(span), states[0::2]) ^ states[1::2]
        span *= 2
    return int(states[0])


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).ravel()
    return np.frombuffer(memoryview(data), np.uint8)


def crc32c_numpy(data, value: int = 0) -> int:
    """The reference's numpy CRC-32C (the plain version of ``crc32c``)."""
    buf = _as_bytes(data)
    init = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    raw = _raw_crc(buf)
    return (raw ^ _shift_state(init, buf.size) ^ 0xFFFFFFFF) & 0xFFFFFFFF


def crc32c(data, value: int = 0) -> int:
    """CRC-32C of ``data`` (bytes-like or uint8-viewable ndarray);
    ``value`` continues a previous crc32c result (streaming use).

    Computed by the native core's slicing-by-8 loop when it builds (GB/s,
    and the call releases the interpreter lock, so serve threads verifying
    wire trailers do not stall the learner), else by ``crc32c_numpy``;
    both give the reference's value bit for bit."""
    lib = native.load()
    if lib is None:
        return crc32c_numpy(data, value)
    buf = _as_bytes(data)
    return int(lib.crc32c(value & 0xFFFFFFFF, native.as_uint8_p(buf),
                          buf.size))


# ---------------------------------------------------------------------------
# Atomic write primitive (+ torn-write chaos hook)
# ---------------------------------------------------------------------------


def _fsync_dir(dirpath: str) -> None:
    """Persist a rename: fsync the containing directory (POSIX)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds — best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _maybe_tear(f, nbytes: int, path: str) -> None:
    """Chaos hook: with ``torn=p`` active, damage the just-written bytes
    the way a disk-level tear would — truncate to a random prefix or
    garbage-fill a random span — BEFORE the rename, so the damaged file
    lands at the final path exactly as a mid-write crash leaves it."""
    from distributed_deep_q_tpu_torch.rpc import faultinject  # lazy: no cycle

    plan = faultinject.active()
    if plan is None or getattr(plan, "torn", 0.0) <= 0:
        return
    rng = plan._rng
    if rng.random() >= plan.torn:
        return
    plan._fire("file/torn")
    if nbytes == 0 or rng.random() < 0.5:
        f.truncate(int(rng.integers(0, max(nbytes, 1))))
    else:
        off = int(rng.integers(0, nbytes))
        span = int(rng.integers(1, max(nbytes - off, 2)))
        f.seek(off)
        f.write(rng.integers(0, 256, size=span, dtype=np.uint8).tobytes())
    log.warning("chaos torn=: damaged write of %s (%d bytes)", path, nbytes)


def atomic_write(path: str,
                 data: bytes | memoryview | Callable[[BinaryIO], Any],
                 ) -> None:
    """Write ``data`` to ``path`` atomically: tmp file in the same
    directory, flush + fsync, ``os.replace``, directory fsync. A crash at
    any point leaves either the previous file or the complete new one at
    ``path`` — never a torn write (absent the chaos hook, which models the
    disk-level failure atomicity cannot see).

    ``data`` is bytes-like, or a callable that writes the contents into
    the open binary tmp file it is given: a multi-GB npz then streams to
    disk instead of being built in memory first (the bytes on disk are
    the same)."""
    path = os.fspath(path)
    dirpath = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=dirpath)
    try:
        with os.fdopen(fd, "wb") as f:
            if callable(data):
                data(f)
            else:
                f.write(memoryview(data))
            _maybe_tear(f, f.tell(), path)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        tmp = None
        _fsync_dir(dirpath)
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def savez_bytes(**arrays: Any) -> bytes:
    """Serialize arrays/scalars to npz bytes in memory — the capture/
    serialize split that lets callers checksum and ``atomic_write`` the
    result instead of ``np.savez``-ing straight to a final path."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Generational snapshot store
# ---------------------------------------------------------------------------


class IntegrityError(RuntimeError):
    """A snapshot generation failed manifest/size/checksum verification."""


class GenerationStore:
    """Directory of checksummed snapshot generations with retention.

    Layout::

        <root>/gen-00000007/server.npz
        <root>/gen-00000007/replay.npz
        <root>/gen-00000007/MANIFEST.json   <- commit point, written last
        <root>/quarantine-gen-00000006/...  <- failed verification

    ``commit`` writes every payload file atomically, then the manifest
    (schema, per-file size + crc32c, caller meta) — a generation without
    a valid manifest was never committed. ``latest_valid`` walks
    newest→oldest, quarantining (rename + counter + loud log) anything
    whose manifest or checksums fail, and never raises on damage: the
    worst case is a cold boot.
    """

    def __init__(self, root: str, keep: int = 3):
        self.root = os.fspath(root)
        self.keep = max(1, int(keep))
        self.quarantined = 0  # generations this instance quarantined

    # -- layout helpers ----------------------------------------------------

    def _gen_dir(self, gen: int) -> str:
        return os.path.join(self.root, f"{GEN_PREFIX}{gen:08d}")

    def generations(self) -> list[int]:
        """Committed-or-attempted generation numbers, ascending."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for name in names:
            if name.startswith(GEN_PREFIX):
                try:
                    out.append(int(name[len(GEN_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    # -- write path --------------------------------------------------------

    def commit(self, files: dict[str, bytes],
               meta: dict[str, Any] | None = None) -> int:
        """Write one generation: payload files first (each atomic), the
        manifest last. Returns the generation number. Prunes retention
        after the commit so the newest generation is never the casualty."""
        os.makedirs(self.root, exist_ok=True)
        gens = self.generations()
        gen = gens[-1] + 1 if gens else 0
        gdir = self._gen_dir(gen)
        if os.path.isdir(gdir):  # leftover of a crashed uncommitted attempt
            shutil.rmtree(gdir, ignore_errors=True)
        os.makedirs(gdir, exist_ok=True)
        manifest: dict[str, Any] = {
            "schema": MANIFEST_SCHEMA, "generation": gen,
            "files": {}, "meta": dict(meta or {}),
        }
        for name, blob in files.items():
            atomic_write(os.path.join(gdir, name), blob)
            manifest["files"][name] = {
                "size": len(blob), "crc32c": f"{crc32c(blob):08x}"}
        atomic_write(os.path.join(gdir, MANIFEST_NAME),
                     json.dumps(manifest, indent=1, sort_keys=True).encode())
        _fsync_dir(self.root)
        self._prune()
        return gen

    def _prune(self) -> None:
        for gen in self.generations()[:-self.keep]:
            shutil.rmtree(self._gen_dir(gen), ignore_errors=True)
        try:
            quars = sorted(n for n in os.listdir(self.root)
                           if n.startswith(QUARANTINE_PREFIX))
        except OSError:
            return
        for name in quars[:-self.keep]:  # bound quarantine disk use too
            shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)

    # -- read path ---------------------------------------------------------

    def verify(self, gen: int) -> tuple[dict[str, str], dict[str, Any]]:
        """Verify one generation end to end; returns ``(name → path,
        manifest meta)``. Raises ``IntegrityError`` naming the first
        failure: unparseable/missing manifest, schema mismatch, missing
        payload file, size drift, or checksum mismatch."""
        gdir = self._gen_dir(gen)
        mpath = os.path.join(gdir, MANIFEST_NAME)
        try:
            with open(mpath, encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
            raise IntegrityError(
                f"gen {gen}: manifest unreadable ({type(e).__name__}: {e})")
        if not isinstance(manifest, dict) \
                or manifest.get("schema") != MANIFEST_SCHEMA \
                or not isinstance(manifest.get("files"), dict):
            raise IntegrityError(f"gen {gen}: manifest schema mismatch "
                                 f"(want {MANIFEST_SCHEMA})")
        paths: dict[str, str] = {}
        for name, entry in manifest["files"].items():
            fpath = os.path.join(gdir, name)
            try:
                with open(fpath, "rb") as f:
                    blob = f.read()
            except OSError as e:
                raise IntegrityError(f"gen {gen}: {name} unreadable ({e})")
            if len(blob) != entry.get("size"):
                raise IntegrityError(
                    f"gen {gen}: {name} is {len(blob)} bytes, manifest "
                    f"says {entry.get('size')} (torn write)")
            got = f"{crc32c(blob):08x}"
            if got != entry.get("crc32c"):
                raise IntegrityError(
                    f"gen {gen}: {name} crc32c {got} != manifest "
                    f"{entry.get('crc32c')} (corrupt)")
            paths[name] = fpath
        return paths, dict(manifest.get("meta", {}))

    def quarantine(self, gen: int, reason: str = "") -> None:
        """Move a damaged generation aside (kept for postmortem, out of
        the restore walk) and count it. Loud by design: silent snapshot
        rot is exactly the failure this store exists to surface."""
        self.quarantined += 1
        gdir = self._gen_dir(gen)
        qdir = os.path.join(self.root,
                            QUARANTINE_PREFIX + os.path.basename(gdir))
        log.error("snapshot generation %d QUARANTINED: %s (moved to %s)",
                  gen, reason or "verification failed", qdir)
        try:
            if os.path.isdir(qdir):
                shutil.rmtree(qdir, ignore_errors=True)
            os.replace(gdir, qdir)
        except OSError:
            shutil.rmtree(gdir, ignore_errors=True)

    def latest_valid(self) -> tuple[int, dict[str, str],
                                    dict[str, Any]] | None:
        """Newest generation that verifies clean, quarantining every
        newer one that does not. ``None`` = no valid generation (cold
        boot)."""
        for gen in reversed(self.generations()):
            try:
                paths, meta = self.verify(gen)
                return gen, paths, meta
            except (IntegrityError, OSError) as e:
                self.quarantine(gen, str(e))
        return None
