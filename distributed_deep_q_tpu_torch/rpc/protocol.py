"""Wire protocol — length-prefixed binary messages of numpy arrays/scalars.

A copy of the reference ``rpc/protocol.py`` (host only), its imports rewritten
to this package.

The reference's distribution plane is "parameter-server RPC — HTTP or raw-TCP
transport of serialized numpy arrays" (SURVEY.md §2.3 [M][P][R]); this is the
rebuilt equivalent for the actor↔learner boundary (SURVEY §5.8: the DCN
plane). Pure stdlib (struct + socket): no pickle (no code execution on
receive), no HTTP framing overhead, zero-copy numpy buffer sends.

A message is a dict[str, ndarray | int | float | bool | str | None]:

    u8  magic 0xD9   (frame-boundary guard: a desynced or corrupted stream
    u8  version 4     is detected HERE, not as a reshape error in dispatch)
    u32 LE  total payload length   (excludes the trailer)
    u16 LE  item count
    per item:
      u16 LE keylen, key utf-8
      u8 kind  (0 ndarray, 1 int64, 2 float64, 3 str, 4 bool, 5 none)
      ndarray: u8 dtypelen, dtype str, u8 ndim, u32×ndim shape, u64 nbytes, raw
      int64/float64: 8 bytes; str: u32 len + utf-8; bool: u8
    u32 LE  CRC-32C of the payload  (v4+ trailer)

Every length/offset in ``decode`` is bounds-checked and the ndarray item
enforces ``nbytes == prod(shape) * itemsize``, so truncated or bit-flipped
frames raise ``ProtocolError`` instead of over-reading or mis-parsing into a
valid-looking message. Structural checks alone cannot catch a bit flip
inside array *data*, which would silently poison replay — the v4 CRC-32C
trailer closes that hole: ``recv_msg_sized`` verifies it before decode and
raises ``ChecksumError`` (counted as ``rpc/checksum_errors`` server-side).
``ProtocolError`` subclasses ``ValueError`` so existing transient-failure
handlers (heartbeat backoff, client socket drop) classify it as a retryable
stream fault; ``ChecksumError`` subclasses ``ProtocolError`` so the retry
plane re-sends a corrupted frame instead of admitting it.

Evolution without a version bump: NEW PLAIN DICT KEYS never need one —
v2→v3 added credits/SHED reply fields, the telemetry spine rides
``tm_*`` arrays on add_transitions, and the tracing plane
rides causal context the same way: ``tr_trace``/``tr_span``/
``tr_sent_at`` on requests, ``tr_recv_at``/``tr_done_at`` reply stamps
(NTP-style skew correction), and an optional ``tr_birth`` float64 array
of per-row lineage birth times. Peers that don't know the keys ignore
them; the canonical names live in ``tracing.KEY_*``.
"""

from __future__ import annotations

import socket
import struct
from typing import Any

import numpy as np

from distributed_deep_q_tpu_torch import tracing
from distributed_deep_q_tpu_torch.utils.durability import crc32c

MAX_MESSAGE = 1 << 30  # 1 GiB sanity cap

MAGIC = 0xD9
# v3: add_transitions replies grew credit/SHED/params_version
# fields. Payload encoding is byte-identical to v2 (the new surface is
# plain dict entries), so v2 frames remain decodable — see ``reframe``.
# v4: CRC-32C trailer appended after the payload. The payload
# encoding itself is still byte-identical, so v2/v3 stored frames are
# re-stamped by ``reframe`` (which computes the missing trailer), and
# ``recv_msg_sized`` still accepts trailer-less v3 peers.
WIRE_VERSION = 4
_COMPAT_PAYLOAD_VERSIONS = (2, 3, 4)
_TRAILERLESS_VERSIONS = (3,)  # live peers accepted without a trailer
_HEADER = struct.Struct("<BBI")  # magic, version, payload length
HEADER_SIZE = _HEADER.size
_TRAILER = struct.Struct("<I")  # CRC-32C of the payload (v4+)
TRAILER_SIZE = _TRAILER.size

_KIND_NDARRAY, _KIND_INT, _KIND_FLOAT, _KIND_STR, _KIND_BOOL, _KIND_NONE = range(6)

# decode caps — far above anything the trainer ships, low enough that a
# corrupted length field fails fast instead of allocating gigabytes
_MAX_NDIM = 32
_MAX_ITEMS = 4096


class ProtocolError(ValueError):
    """Malformed / truncated / desynced wire frame."""


class ChecksumError(ProtocolError):
    """Frame payload failed CRC-32C verification — corrupt in transit or
    at rest. Subclasses ``ProtocolError`` (hence retryable), but counted
    separately so silent-corruption pressure is visible in telemetry."""


def encode(msg: dict[str, Any]) -> bytes:
    parts: list[bytes] = [struct.pack("<H", len(msg))]
    for key, val in msg.items():
        kb = key.encode()
        parts.append(struct.pack("<H", len(kb)))
        parts.append(kb)
        if isinstance(val, np.ndarray):
            db = str(val.dtype).encode()
            # asarray(order="C"), NOT ascontiguousarray: the latter
            # promotes 0-d arrays to 1-d and the roundtrip loses the shape
            val = np.asarray(val, order="C")
            parts.append(struct.pack("<BB", _KIND_NDARRAY, len(db)))
            parts.append(db)
            parts.append(struct.pack("<B", val.ndim))
            parts.append(struct.pack(f"<{val.ndim}I", *val.shape))
            parts.append(struct.pack("<Q", val.nbytes))
            parts.append(val.tobytes())
        elif isinstance(val, bool):  # before int: bool is an int subclass
            parts.append(struct.pack("<BB", _KIND_BOOL, int(val)))
        elif isinstance(val, (int, np.integer)):
            parts.append(struct.pack("<Bq", _KIND_INT, int(val)))
        elif isinstance(val, (float, np.floating)):
            parts.append(struct.pack("<Bd", _KIND_FLOAT, float(val)))
        elif isinstance(val, str):
            sb = val.encode()
            parts.append(struct.pack("<BI", _KIND_STR, len(sb)))
            parts.append(sb)
        elif val is None:
            parts.append(struct.pack("<B", _KIND_NONE))
        else:
            raise TypeError(f"unsupported message value {key}={type(val)}")
    payload = b"".join(parts)
    # header length counts the payload only; the CRC trailer rides after
    return (_HEADER.pack(MAGIC, WIRE_VERSION, len(payload)) + payload
            + _TRAILER.pack(crc32c(payload)))


def decode(payload: bytes) -> dict[str, Any]:
    try:
        return _decode(payload)
    except ProtocolError:
        raise
    except (struct.error, UnicodeDecodeError, OverflowError, TypeError,
            ValueError) as e:
        # struct under-reads, bad utf-8, bogus dtype strings — anything a
        # corrupted frame can trip inside the parser surfaces as ONE type
        raise ProtocolError(f"malformed frame: {type(e).__name__}: {e}") \
            from e


def _need(payload: bytes, off: int, n: int, what: str) -> None:
    if off + n > len(payload):
        raise ProtocolError(
            f"truncated frame: {what} needs {n} bytes at offset {off}, "
            f"payload is {len(payload)}")


def _decode(payload: bytes) -> dict[str, Any]:
    msg: dict[str, Any] = {}
    _need(payload, 0, 2, "item count")
    (count,), off = struct.unpack_from("<H", payload), 2
    if count > _MAX_ITEMS:
        raise ProtocolError(f"item count {count} exceeds cap {_MAX_ITEMS}")
    for _ in range(count):
        _need(payload, off, 2, "key length")
        (klen,) = struct.unpack_from("<H", payload, off)
        off += 2
        _need(payload, off, klen, "key")
        key = payload[off:off + klen].decode()
        off += klen
        _need(payload, off, 1, "kind")
        (kind,) = struct.unpack_from("<B", payload, off)
        off += 1
        if kind == _KIND_NDARRAY:
            _need(payload, off, 1, "dtype length")
            (dlen,) = struct.unpack_from("<B", payload, off)
            off += 1
            _need(payload, off, dlen, "dtype")
            dtype = np.dtype(payload[off:off + dlen].decode())
            if dtype.hasobject:
                raise ProtocolError(f"object dtype {dtype} not allowed")
            off += dlen
            _need(payload, off, 1, "ndim")
            (ndim,) = struct.unpack_from("<B", payload, off)
            off += 1
            if ndim > _MAX_NDIM:
                raise ProtocolError(f"ndim {ndim} exceeds cap {_MAX_NDIM}")
            _need(payload, off, 4 * ndim, "shape")
            shape = struct.unpack_from(f"<{ndim}I", payload, off)
            off += 4 * ndim
            _need(payload, off, 8, "nbytes")
            (nbytes,) = struct.unpack_from("<Q", payload, off)
            off += 8
            # the frame-boundary integrity check: the byte count must agree
            # with the declared geometry, or the stream is desynced/corrupt
            expected = int(np.prod(shape, dtype=np.uint64)) * dtype.itemsize
            if nbytes != expected:
                raise ProtocolError(
                    f"ndarray {key!r}: nbytes={nbytes} disagrees with "
                    f"shape {tuple(shape)} × {dtype} (= {expected})")
            _need(payload, off, nbytes, f"ndarray {key!r} data")
            arr = np.frombuffer(payload, dtype, count=nbytes // dtype.itemsize
                                if dtype.itemsize else 0,
                                offset=off).reshape(shape)
            msg[key] = arr.copy()  # own the memory past the recv buffer
            off += nbytes
        elif kind == _KIND_INT:
            _need(payload, off, 8, "int64")
            (msg[key],) = struct.unpack_from("<q", payload, off)
            off += 8
        elif kind == _KIND_FLOAT:
            _need(payload, off, 8, "float64")
            (msg[key],) = struct.unpack_from("<d", payload, off)
            off += 8
        elif kind == _KIND_STR:
            _need(payload, off, 4, "str length")
            (slen,) = struct.unpack_from("<I", payload, off)
            off += 4
            _need(payload, off, slen, "str")
            msg[key] = payload[off:off + slen].decode()
            off += slen
        elif kind == _KIND_BOOL:
            _need(payload, off, 1, "bool")
            (b,) = struct.unpack_from("<B", payload, off)
            msg[key] = bool(b)
            off += 1
        elif kind == _KIND_NONE:
            msg[key] = None
        else:
            raise ProtocolError(f"bad message kind {kind}")
    if off != len(payload):
        raise ProtocolError(
            f"{len(payload) - off} trailing bytes after {count} items")
    return msg


def reframe(frame: bytes) -> bytes:
    """Re-stamp a stored wire frame to the CURRENT protocol version.

    Warm-boot snapshots persist the published θ frame verbatim
    (``params_wire``); after a version bump that frame would fail the
    receiver's version check even though the run is otherwise resumable.
    Payload-compatible versions are re-stamped in place — v2/v3 frames
    (no trailer) get the CRC-32C trailer computed and appended; a v4
    frame has its trailer *verified* (the snapshot sat on disk) and is
    returned as-is. Anything else is a real format change and must fail
    loudly rather than mis-parse."""
    if len(frame) < HEADER_SIZE:
        raise ProtocolError(f"stored frame of {len(frame)} bytes is shorter "
                            "than a header")
    magic, version, length = _HEADER.unpack_from(frame)
    if magic != MAGIC:
        raise ProtocolError(f"stored frame has bad magic 0x{magic:02x}")
    if version not in _COMPAT_PAYLOAD_VERSIONS:
        raise ProtocolError(
            f"stored frame speaks wire version {version}; payload format "
            f"is not compatible with {WIRE_VERSION}")
    trailer = TRAILER_SIZE if version >= 4 else 0
    if length != len(frame) - HEADER_SIZE - trailer:
        raise ProtocolError(
            f"stored v{version} frame length {length} disagrees with "
            f"{len(frame) - HEADER_SIZE - trailer} payload bytes")
    payload = frame[HEADER_SIZE:HEADER_SIZE + length]
    if trailer:
        (want,) = _TRAILER.unpack_from(frame, HEADER_SIZE + length)
        got = crc32c(payload)
        if got != want:
            raise ChecksumError(
                f"stored frame crc32c {got:08x} != trailer {want:08x} — "
                "snapshot corrupt at rest")
        return frame
    return (_HEADER.pack(MAGIC, WIRE_VERSION, length) + payload
            + _TRAILER.pack(crc32c(payload)))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("socket closed mid-message")
        got += r
    return bytes(buf)


def send_msg(sock: socket.socket, msg: dict[str, Any]) -> None:
    sock.sendall(encode(msg))


def recv_msg(sock: socket.socket) -> dict[str, Any]:
    return recv_msg_sized(sock)[0]


def recv_msg_sized(sock: socket.socket) -> tuple[dict[str, Any], int]:
    """Receive one message and its wire payload size in bytes — the size
    feeds the server's per-method payload histograms without re-encoding."""
    # the header read is NOT spanned: a server thread blocks here waiting
    # for the peer's next request, which is idle time, not pipeline work
    magic, version, length = _HEADER.unpack(_recv_exact(sock, HEADER_SIZE))
    if magic != MAGIC:
        raise ProtocolError(
            f"bad magic 0x{magic:02x} (expected 0x{MAGIC:02x}) — stream "
            "desynced or peer speaks a different protocol")
    if version != WIRE_VERSION and version not in _TRAILERLESS_VERSIONS:
        raise ProtocolError(
            f"wire version {version} (this side speaks {WIRE_VERSION})")
    if length > MAX_MESSAGE:
        raise ProtocolError(f"message of {length} bytes exceeds cap")
    with tracing.span("wire_recv"):
        payload = _recv_exact(sock, length)
        trail = (_recv_exact(sock, TRAILER_SIZE) if version >= 4 else b"")
    if version >= 4:
        with tracing.span("crc_verify"):
            (want,) = _TRAILER.unpack(trail)
            got = crc32c(payload)
        if got != want:
            raise ChecksumError(
                f"payload crc32c {got:08x} != trailer {want:08x} — frame "
                "corrupted in transit")
    with tracing.span("wire_decode"):
        return decode(payload), length
