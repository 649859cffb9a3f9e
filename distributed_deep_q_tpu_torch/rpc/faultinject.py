"""Chaos harness — an injectable socket shim for the RPC plane.

A copy of the reference ``rpc/faultinject.py`` (host only), its imports rewritten
to this package.

Podracer-style preemption tolerance (PAPERS.md, arXiv:2104.06272) is only
real if it is *exercised*: this module wraps the raw sockets on both sides
of the ``ReplayFeed`` boundary with configurable faults so tests and smoke
runs can prove the retry/dedup/warm-boot machinery absorbs them:

- ``drop``      — close the connection mid-operation (raises ConnectionError)
- ``delay``     — sleep before the operation (latency spikes / slow links)
- ``truncate``  — send only a prefix of the frame, then drop (half-sent
                  frames; the receiver's magic/length validation must catch
                  the desync)
- ``corrupt``   — flip one byte of an outgoing frame (bit rot; the decode
                  bounds/geometry checks must reject structural damage)
- ``stall``     — sleep before a receive (server hiccup as seen by peers)
- ``throttle``  — bandwidth cap in bytes/second on sends (slow link), so
                  overload can be induced at the transport layer instead
                  of by fleet sizing
- ``torn``      — damage a snapshot file mid-write (truncate to a random
                  prefix or garbage-fill a random span) before the atomic
                  rename, modeling the disk-level tear that tmp+fsync+
                  rename cannot prevent; the generation store's manifest
                  checksums must quarantine it on restore.
                  Fires inside ``utils.durability.atomic_write``, not on
                  sockets.

Install programmatically (``install("drop=0.05,seed=1")``) or via the
``DDQ_CHAOS`` environment variable, which spawned actor processes inherit —
so one env var puts the whole fleet under chaos. The shim is a no-op (the
raw socket passes through untouched) when no plan is active.

Spec grammar: comma-separated ``name=value`` pairs. Probabilities are per
operation in [0, 1]; ``delay`` and ``stall`` take ``p:ms`` (probability and
max sleep). Example::

    DDQ_CHAOS="drop=0.02,delay=0.05:40,truncate=0.01,corrupt=0.01,seed=7"

Faults are injected from a seeded RNG so chaos runs are reproducible per
process; ``ChaosPlan.counters`` records every fault fired for assertions.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from dataclasses import dataclass, field

import numpy as np

ENV_VAR = "DDQ_CHAOS"


@dataclass
class ChaosPlan:
    """Per-operation fault probabilities (all default off)."""

    drop: float = 0.0        # P(close + ConnectionError) per send/recv
    delay_p: float = 0.0     # P(sleep before send)
    delay_ms: float = 20.0   # max sleep, uniform [0, delay_ms]
    truncate: float = 0.0    # P(send a prefix then drop) per send
    corrupt: float = 0.0     # P(flip one byte) per send
    stall_p: float = 0.0     # P(sleep before recv)
    stall_ms: float = 50.0   # max stall, uniform [0, stall_ms]
    throttle: float = 0.0    # bytes/second bandwidth cap on sends (0 = off)
    torn: float = 0.0        # P(tear a snapshot file write) per atomic_write
    seed: int = 0
    counters: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed or None)
        self._lock = threading.Lock()

    def _fire(self, name: str) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + 1

    def total_faults(self) -> int:
        with self._lock:
            return sum(self.counters.values())

    @classmethod
    def from_spec(cls, spec: str) -> "ChaosPlan":
        kv: dict = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            name, _, val = item.partition("=")
            if name in ("delay", "stall"):
                p, _, ms = val.partition(":")
                kv[f"{name}_p"] = float(p)
                if ms:
                    kv[f"{name}_ms"] = float(ms)
            elif name == "seed":
                kv["seed"] = int(val)
            elif name in ("drop", "truncate", "corrupt", "throttle", "torn"):
                kv[name] = float(val)
            else:
                raise ValueError(f"unknown chaos knob {name!r} in {spec!r}")
        return cls(**kv)


_installed: ChaosPlan | None = None
_env_checked = False


def install(plan: ChaosPlan | str) -> ChaosPlan:
    """Activate chaos process-wide; returns the live plan (for counters)."""
    global _installed
    if isinstance(plan, str):
        plan = ChaosPlan.from_spec(plan)
    _installed = plan
    return plan


def uninstall() -> None:
    global _installed, _env_checked
    _installed = None
    _env_checked = False  # re-read the env on next active() call


def active() -> ChaosPlan | None:
    """The installed plan, else one lazily parsed from ``DDQ_CHAOS``."""
    global _installed, _env_checked
    if _installed is None and not _env_checked:
        _env_checked = True
        spec = os.environ.get(ENV_VAR, "")
        if spec:
            _installed = ChaosPlan.from_spec(spec)
    return _installed


def wrap(sock: socket.socket, side: str = "client"):
    """Wrap ``sock`` with the active chaos plan; pass-through when idle."""
    plan = active()
    if plan is None:
        return sock
    return ChaosSocket(sock, plan, side)


class ChaosSocket:
    """Socket proxy injecting faults on the data plane.

    Only the operations the protocol layer uses (``sendall`` /
    ``recv_into``) inject; everything else delegates verbatim, so the shim
    composes with timeouts, TCP_NODELAY, and close/shutdown handling.
    """

    def __init__(self, sock: socket.socket, plan: ChaosPlan, side: str):
        self._sock = sock
        self._plan = plan
        self._side = side

    def __getattr__(self, name):
        return getattr(self._sock, name)

    def _roll(self, p: float) -> bool:
        return p > 0 and self._plan._rng.random() < p

    def sendall(self, data) -> None:
        plan = self._plan
        if plan.throttle > 0:
            # deterministic bandwidth cap: pay the frame's wire time up
            # front. Deliberately not probabilistic — a slow link is slow
            # for every frame, and determinism keeps soak timings stable
            plan._fire(f"{self._side}/throttle")
            time.sleep(len(data) / plan.throttle)
        if self._roll(plan.delay_p):
            plan._fire(f"{self._side}/delay")
            time.sleep(plan._rng.random() * plan.delay_ms / 1e3)
        if self._roll(plan.drop):
            plan._fire(f"{self._side}/drop_send")
            self._sock.close()
            raise ConnectionError("chaos: connection dropped before send")
        if self._roll(plan.truncate):
            plan._fire(f"{self._side}/truncate")
            cut = int(plan._rng.integers(1, max(len(data), 2)))
            try:
                self._sock.sendall(bytes(data)[:cut])
            finally:
                self._sock.close()
            raise ConnectionError("chaos: frame truncated mid-send")
        if self._roll(plan.corrupt):
            plan._fire(f"{self._side}/corrupt")
            buf = bytearray(data)
            if buf:
                i = int(plan._rng.integers(len(buf)))
                buf[i] ^= 1 << int(plan._rng.integers(8))
            return self._sock.sendall(bytes(buf))
        return self._sock.sendall(data)

    def recv_into(self, buf, nbytes: int = 0, flags: int = 0) -> int:
        plan = self._plan
        if self._roll(plan.stall_p):
            plan._fire(f"{self._side}/stall")
            time.sleep(plan._rng.random() * plan.stall_ms / 1e3)
        if self._roll(plan.drop):
            plan._fire(f"{self._side}/drop_recv")
            self._sock.close()
            raise ConnectionError("chaos: connection dropped before recv")
        return self._sock.recv_into(buf, nbytes, flags)

    def recv(self, bufsize: int, flags: int = 0) -> bytes:
        plan = self._plan
        if self._roll(plan.stall_p):
            plan._fire(f"{self._side}/stall")
            time.sleep(plan._rng.random() * plan.stall_ms / 1e3)
        if self._roll(plan.drop):
            plan._fire(f"{self._side}/drop_recv")
            self._sock.close()
            raise ConnectionError("chaos: connection dropped before recv")
        return self._sock.recv(bufsize, flags)
