"""Sampling distributed tracer — causal spans across the data path.

The telemetry spine (``metrics.py``) answers "how slow is the pipeline on
average"; this module answers "WHERE does a transition's time go":
actor env-step → flush (token-bucket wait, SHED/retry cycles) → server
recv/CRC/decode → ``replay_lock`` wait vs hold → ring insert → sample →
host→device transfer → fused-chain step, plus the durability plane's
snapshot/restore. Every hop records a span; causal context (trace id +
parent span id) crosses the RPC boundary as plain ``tr_*`` dict keys on
existing wire frames — the same piggyback the ``tm_*`` telemetry arrays
use, so NO wire version bump and v4 peers without context stay valid
(rpc/protocol.py documents the precedent).

Design constraints, in order:

1. **Near-zero cost when disabled.** ``ENABLED`` is a module-level bool;
   every entry point branches on it ONCE and returns a preallocated
   singleton (``span()`` → ``_NULL``, a no-op context manager) or an
   empty constant. No dict/list/closure allocation on the disabled path.
2. **Never block the data path.** Spans buffer in per-thread ring
   buffers: bounded, drop-OLDEST on overflow, drop counter exposed
   (``drop_count``/``counters``). A burst costs old spans, never memory
   or latency.
3. **Cross-process timestamps must be comparable.** Each process anchors
   ``time.perf_counter()`` to the wall clock once at import
   (``now() = t0_wall + (perf_counter() - t0_mono)``) so timestamps are
   monotonic *within* a process; the NTP-style ``estimate_skew`` (four
   stamps riding a request/reply pair) measures the remaining
   cross-process offset, which corrects lineage birth stamps before
   they are sent and shifts exported shards at merge time
   (the port's ``trace_report.py``).

**Sampling** is deterministic and counter-based (every k-th cycle, k
from ``sample_rate``) rather than RNG-based: no random() call on the
hot path and reproducible overhead. Span names are drawn from the
closed ``STAGES``/``PORT_STAGES``/``EVENTS`` tables below.

Pure stdlib (json/os/threading/time): importable by scripts and actor
processes without touching torch. A copy of the reference ``tracing.py``:
the span names and ``KEY_*`` wire keys are the reference's letter for
letter, so the reference's trace report reads a port export.
"""

from __future__ import annotations

import json
import os
import threading
import time

# -- the closed span-name tables (the reference enforces them statically) -
# Durations ("X" complete events). Server-side ``wire_recv`` covers the
# post-header payload read only — the blocking wait for a peer's next
# request is idle time, not pipeline work.
STAGES = (
    "env_step",        # one environment step on an actor
    "flush",           # whole add_transitions cycle incl. retries/sheds
    "bucket_wait",     # client token-bucket backpressure sleep
    "rpc_call",        # one wire round trip (send → reply decoded)
    "wire_recv",       # payload+trailer bytes off the socket
    "crc_verify",      # wire-v4 CRC-32C check
    "wire_decode",     # frame bytes → message dict
    "lock_wait",       # waiting to acquire a traced lock
    "lock_hold",       # critical section under a traced lock
    "ingest_parse",    # add_transitions payload parse/prep, OFF-lock
    "ring_insert",     # replay add_batch under replay_lock
    "staged_append",   # columnar stage memcpy (replay/columnar.py)
    "ingest_drain",    # batched staging→device flush (drain thread)
    "sample",          # replay sample (host compose / device draw)
    "stage_batch",     # DeviceStager cycle (sample + device_put)
    "device_put",      # host→device transfer of a sampled batch
    "train_step",      # train-step dispatch (fused chain or per-step)
    "param_pull",      # actor get_params round trip
    "infer_wait",      # inference serve thread waiting on its microbatch
    "infer_batch",     # microbatch cut: stack + pad to a compiled bucket
    "infer_forward",   # the ONE device-resident jit'd policy forward
    "infer_shadow",    # mirrored shadow-tenant forwards + drift diff
    "remote_infer",    # actor-side infer round trip (obs out, action back)
    "vector_step",     # one vectorized actor tick (N actions + batched step)
    "vector_infer",    # vector actor's batched infer round trip (one RPC)
    "anakin_superstep",  # fully-jitted act+insert+train dispatch (host side)
    "snapshot_capture",  # durability: state capture under locks
    "snapshot_write",  # durability: serialize + atomic write (off-lock)
    "restore",         # durability: warm-boot generation walk
)
# Points in time ("i" instant events).
EVENTS = (
    "shed",            # server shed this flush; client will re-send
    "retry",           # client retry after a transport error
    "reconnect",       # client re-established its connection
    "degraded",        # flow controller tripped degraded mode
)

# Durations the port adds, inside the fused dispatch. Kept apart from
# ``STAGES``, which stays the reference's letter for letter: the host's
# enqueue of one dispatch's inputs, of one grad step's three passes on the
# eager body, and of a CUDA graph's replay of the whole dispatch.
PORT_STAGES = (
    "dispatch_inputs",  # flush, cursors, betas, keys, uniforms, copies
    "step_forward",     # online/target forwards, burn-in, unrolls, loss
    "step_backward",    # autograd, the gradient all-reduce, global norm
    "step_optimizer",   # step increment, optimizer, target refresh
    "dispatch_replay",  # the captured dispatch's replay (first: capture)
)

_VALID_NAMES = frozenset(STAGES) | frozenset(PORT_STAGES) | frozenset(EVENTS)

# wire piggyback keys (plain dict entries — no wire version bump; see
# rpc/protocol.py "evolution without a version bump")
KEY_TRACE = "tr_trace"      # int: trace id of the sender's current span
KEY_SPAN = "tr_span"        # int: sender's span id (the remote parent)
KEY_SENT_AT = "tr_sent_at"  # float: sender's anchored wall clock at send
KEY_RECV_AT = "tr_recv_at"  # float: server clock on request entry (t2)
KEY_DONE_AT = "tr_done_at"  # float: server clock on reply build (t3)
KEY_BIRTH = "tr_birth"      # float64[n]: per-row birth stamps (lineage)

ENABLED = False  # module flag: the single branch on every hot path

_SAMPLE_EVERY = 100   # 1 / sample_rate, rounded (counter-based sampling)
_LINEAGE_EVERY = 20   # 1 / lineage_rate
_BUFFER_SPANS = 8192  # per-thread ring capacity
_EXPORT_DIR = "traces"

# per-process clock anchor: monotonic within the process, wall-aligned
# across processes up to OS clock skew (estimate_skew measures the rest)
_T0_WALL = time.time()
_T0_MONO = time.perf_counter()
_PID = os.getpid()


def now() -> float:
    """Anchored wall clock: wall at import + monotonic elapsed since."""
    return _T0_WALL + (time.perf_counter() - _T0_MONO)


def to_perf_counter(ts_us: float) -> float:
    """An event's ``ts`` (anchored wall clock, µs) as the
    ``time.perf_counter()`` seconds it was stamped at: the clock a
    ``torch.profiler`` window is aligned to by its caller."""
    return ts_us / 1e6 - _T0_WALL + _T0_MONO


# -- id generation ---------------------------------------------------------
_id_lock = threading.Lock()
_id_counter = 0


def _new_id() -> int:
    """Process-unique 63-bit id: (pid << 40) | counter — collision-free
    across the processes of one run without coordination or RNG."""
    global _id_counter
    with _id_lock:
        _id_counter += 1
        return ((_PID & 0x7FFFFF) << 40) | _id_counter


# -- per-thread state: span stack + bounded ring ---------------------------
class _Ring:
    """Fixed-capacity drop-oldest event buffer. ``append`` overwrites the
    oldest un-drained slot when full and counts the casualty."""

    __slots__ = ("buf", "cap", "n", "dropped")

    def __init__(self, cap: int):
        self.cap = max(int(cap), 1)
        self.buf: list = [None] * self.cap
        self.n = 0        # total appended since last drain
        self.dropped = 0  # overwritten before being drained

    def append(self, ev) -> None:
        i = self.n % self.cap
        if self.n >= self.cap:
            self.dropped += 1
        self.buf[i] = ev
        self.n += 1

    def grow(self, cap: int) -> None:
        """A larger capacity, keeping every un-drained event; a smaller
        ``cap`` leaves the ring as it is. The larger buffer is in place
        before the capacity grows, so an ``append`` racing this indexes
        in range (its event may be lost)."""
        if cap <= self.cap:
            return
        kept = self.drain()
        self.buf = kept + [None] * (cap - len(kept))
        self.cap = cap
        self.n = len(kept)

    def drain(self) -> list:
        """Oldest-first snapshot; clears the ring (drop counter survives
        for ``counters()`` until ``reset()``)."""
        if self.n <= self.cap:
            out = self.buf[: self.n]
        else:
            i = self.n % self.cap
            out = self.buf[i:] + self.buf[:i]
        self.buf = [None] * self.cap
        self.n = 0
        return out


class _ThreadState(threading.local):
    def __init__(self):
        self.ring = _Ring(_BUFFER_SPANS)
        self.stack: list = []     # [(trace_id, span_id), ...]
        self.tick = 0             # sampling counter (span_sampled)
        self.lineage_tick = 0
        self.tid = None           # small per-process thread index
        with _reg_lock:
            _rings.append(self.ring)
            self.tid = len(_rings)
            _tid_names[self.tid] = threading.current_thread().name


_reg_lock = threading.Lock()
_rings: list[_Ring] = []
_tid_names: dict[int, str] = {}
_tls = _ThreadState()

# cross-process clock skew (this process → the server's clock), kept as
# the estimate with the smallest RTT seen (least queueing noise)
_skew_lock = threading.Lock()
_skew_s = 0.0
_skew_rtt_s = float("inf")
_skew_samples = 0


def estimate_skew(t1: float, t2: float, t3: float, t4: float
                  ) -> tuple[float, float]:
    """NTP-style offset of the PEER clock relative to ours, from four
    stamps: t1 our send, t2 peer recv, t3 peer send, t4 our recv.
    Returns ``(offset, rtt)``: peer_clock ≈ our_clock + offset; exact
    when the two network legs are symmetric, off by at most rtt/2."""
    offset = ((t2 - t1) + (t3 - t4)) / 2.0
    rtt = (t4 - t1) - (t3 - t2)
    return offset, rtt


def record_skew(offset_s: float, rtt_s: float) -> None:
    """Keep the minimum-RTT skew estimate (standard NTP filter)."""
    global _skew_s, _skew_rtt_s, _skew_samples
    with _skew_lock:
        _skew_samples += 1
        if rtt_s < _skew_rtt_s:
            _skew_rtt_s = rtt_s
            _skew_s = offset_s


def skew_s() -> float:
    """Best-estimate offset to the server clock (0.0 until measured)."""
    with _skew_lock:
        return _skew_s


def to_server_clock(t: float) -> float:
    return t + skew_s()


# -- spans -----------------------------------------------------------------
class _NullSpan:
    """The disabled path: one shared instance, no allocation, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "trace", "span", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _tls
        if st.stack:
            self.trace = st.stack[-1][0]
        else:
            self.trace = _new_id()
        self.span = _new_id()
        st.stack.append((self.trace, self.span))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        st = _tls
        st.stack.pop()
        parent = st.stack[-1][1] if st.stack else 0
        st.ring.append({
            "name": self.name, "ph": "X",
            "ts": (_T0_WALL + (self.t0 - _T0_MONO)) * 1e6,
            "dur": (t1 - self.t0) * 1e6,
            "pid": _PID, "tid": st.tid,
            "args": {"trace": self.trace, "span": self.span,
                     "parent": parent},
        })
        return False


def span(name: str):
    """Duration span context manager. ``name`` must be in ``STAGES`` or
    ``PORT_STAGES`` (statically enforced). Disabled → the ``_NULL``
    singleton."""
    if not ENABLED:
        return _NULL
    return _Span(name)


def span_sampled(name: str):
    """Like ``span`` but records only every k-th call per thread
    (k = 1/sample_rate) — for per-env-step hot paths where tracing
    every iteration would itself become the bottleneck."""
    if not ENABLED:
        return _NULL
    st = _tls
    st.tick += 1
    if st.tick % _SAMPLE_EVERY:
        return _NULL
    return _Span(name)


def instant(name: str, **args) -> None:
    """Point event (``EVENTS`` table): shed/retry/reconnect/degraded."""
    if not ENABLED:
        return
    st = _tls
    parent = st.stack[-1] if st.stack else (0, 0)
    a = {"trace": parent[0], "span": 0, "parent": parent[1]}
    if args:
        a.update(args)
    st.ring.append({
        "name": name, "ph": "i", "s": "t",
        "ts": now() * 1e6, "dur": 0,
        "pid": _PID, "tid": st.tid, "args": a,
    })


class _Activation:
    """Adopt a remote parent (from ``tr_*`` wire keys) for the handling
    of one request, so server-side spans join the sender's trace."""

    __slots__ = ("ctx",)

    def __init__(self, trace_id: int, span_id: int):
        self.ctx = (trace_id, span_id)

    def __enter__(self):
        _tls.stack.append(self.ctx)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()
        return False


def activate(req: dict):
    """Context manager joining the sender's trace if the request carries
    context; ``_NULL`` otherwise (disabled, or an un-traced v4 peer)."""
    if not ENABLED:
        return _NULL
    trace_id = req.get(KEY_TRACE)
    if trace_id is None:
        return _NULL
    return _Activation(int(trace_id), int(req.get(KEY_SPAN, 0)))


def wire_context() -> dict:
    """``tr_*`` keys to piggyback on an outgoing request (empty when
    disabled or no span is open — peers treat absence as 'untraced')."""
    if not ENABLED:
        return {}
    st = _tls
    if not st.stack:
        return {}
    trace_id, span_id = st.stack[-1]
    return {KEY_TRACE: trace_id, KEY_SPAN: span_id, KEY_SENT_AT: now()}


class _LockedTracer:
    """``with locked(lock):`` — splits lock WAIT from lock HOLD so
    contention is visible separately from the work under the lock."""

    __slots__ = ("lock", "hold")

    def __init__(self, lock):
        self.lock = lock

    def __enter__(self):
        with _Span("lock_wait"):
            self.lock.acquire()
        self.hold = _Span("lock_hold")
        self.hold.__enter__()
        return self

    def __exit__(self, *exc):
        self.hold.__exit__()
        self.lock.release()
        return False


def locked(lock):
    """Trace-aware lock context: disabled → the lock itself (its native
    ``with`` protocol, zero overhead); enabled → wait/hold split."""
    if not ENABLED:
        return lock
    return _LockedTracer(lock)


def lineage_sample() -> bool:
    """True on every k-th call per thread (k = 1/lineage_rate): the
    caller attaches per-row birth stamps to this flush."""
    if not ENABLED:
        return False
    st = _tls
    st.lineage_tick += 1
    return st.lineage_tick % _LINEAGE_EVERY == 0


# -- configuration ---------------------------------------------------------
def configure(enabled: bool = False, sample_rate: float = 0.01,
              lineage_rate: float = 0.05, buffer_spans: int = 8192,
              export_dir: str = "traces") -> None:
    """Set module state from config values (``cfg.trace``). Rings that
    exist already (the importing thread's among them) grow to a larger
    ``buffer_spans`` and never shrink, so no un-drained span is lost:
    call it while no thread records spans."""
    global ENABLED, _SAMPLE_EVERY, _LINEAGE_EVERY, _BUFFER_SPANS
    global _EXPORT_DIR
    _SAMPLE_EVERY = max(1, int(round(1.0 / max(sample_rate, 1e-9))))
    _LINEAGE_EVERY = max(1, int(round(1.0 / max(lineage_rate, 1e-9))))
    _BUFFER_SPANS = max(int(buffer_spans), 1)
    with _reg_lock:
        for r in _rings:
            r.grow(_BUFFER_SPANS)
    _EXPORT_DIR = export_dir or "traces"
    ENABLED = bool(enabled)


def configure_from(trace_cfg) -> None:
    """``configure`` from a ``config.TraceConfig`` instance."""
    configure(enabled=trace_cfg.enabled,
              sample_rate=trace_cfg.sample_rate,
              lineage_rate=trace_cfg.lineage_rate,
              buffer_spans=trace_cfg.buffer_spans,
              export_dir=trace_cfg.dir)


def disable() -> None:
    global ENABLED
    ENABLED = False


# -- drain / export / counters ---------------------------------------------
def drain() -> list[dict]:
    """All buffered events from every thread's ring, oldest-first per
    thread; clears the rings (drop counters survive)."""
    out: list[dict] = []
    with _reg_lock:
        rings = list(_rings)
    for r in rings:
        out.extend(r.drain())
    return out


def drop_count() -> int:
    with _reg_lock:
        return sum(r.dropped for r in _rings)


def counters() -> dict[str, float]:
    """Tracer health for the metrics spine (all cheap, all finite)."""
    with _reg_lock:
        dropped = sum(r.dropped for r in _rings)
        buffered = sum(min(r.n, r.cap) for r in _rings)
    with _skew_lock:
        skew_ms = 0.0 if _skew_samples == 0 else _skew_s * 1e3
        samples = _skew_samples
    return {
        "trace/spans_dropped": float(dropped),
        "trace/spans_buffered": float(buffered),
        "trace/clock_skew_ms": round(skew_ms, 3),
        "trace/skew_samples": float(samples),
    }


def reset() -> None:
    """Test hook: clear rings, drop counters, skew, and thread stacks
    registered so far (per-thread stacks of OTHER threads are left to
    unwind naturally)."""
    global _skew_s, _skew_rtt_s, _skew_samples
    with _reg_lock:
        for r in _rings:
            r.drain()
            r.dropped = 0
    with _skew_lock:
        _skew_s, _skew_rtt_s, _skew_samples = 0.0, float("inf"), 0


def export(path: str | None = None) -> str | None:
    """Write this process's buffered events as one Chrome trace-event
    JSON shard (Perfetto-loadable on its own; the port's ``trace_report``
    merges shards and aligns clocks). Returns the path, or None when
    there was nothing to write."""
    events = drain()
    if not events:
        return None
    if path is None:
        os.makedirs(_EXPORT_DIR, exist_ok=True)
        path = os.path.join(_EXPORT_DIR, f"trace-{_PID}.json")
    with _reg_lock:
        names = dict(_tid_names)
    meta = [{"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
             "args": {"name": tname}} for tid, tname in names.items()]
    doc = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "pid": _PID,
            "skew_s": skew_s(),
            "spans_dropped": drop_count(),
            "anchored_at": _T0_WALL,
        },
    }
    tmp = f"{path}.tmp.{_PID}"
    with open(tmp, "w") as fh:       # ddq: allow(durability.raw-write)
        json.dump(doc, fh)           # trace shards are diagnostics, not
        fh.flush()                   # recovery state — a torn shard
        os.fsync(fh.fileno())        # loses a trace, never data
    os.replace(tmp, path)
    return path


# -- attribution (shared by bench --trace-ingest and trace_report) ---------
def self_times(events: list[dict]) -> dict:
    """Per-(pid, tid) SELF-time attribution: for every "X" event, self =
    dur − Σ(direct children) on the same thread. Returns::

        {(pid, tid): {"stages": {name: us}, "counts": {name: n},
                      "wall_us": last_end - first_ts, "traced_us": Σself}}

    The per-thread ``wall_us − traced_us`` gap is the UNTRACED residue —
    surfaced by the report, never hidden.
    """
    by_thread: dict[tuple, list[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        by_thread.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    out: dict = {}
    for key, evs in by_thread.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        child: list[float] = [0.0] * len(evs)
        stack: list[int] = []  # indices of open enclosing spans
        for i, ev in enumerate(evs):
            while stack and (evs[stack[-1]]["ts"] + evs[stack[-1]]["dur"]
                             <= ev["ts"] + 1e-9):
                stack.pop()
            if stack:
                child[stack[-1]] += ev["dur"]
            stack.append(i)
        stages: dict[str, float] = {}
        counts: dict[str, int] = {}
        for i, ev in enumerate(evs):
            self_us = max(ev["dur"] - child[i], 0.0)
            stages[ev["name"]] = stages.get(ev["name"], 0.0) + self_us
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
        first = min(e["ts"] for e in evs)
        last = max(e["ts"] + e["dur"] for e in evs)
        out[key] = {"stages": stages, "counts": counts,
                    "wall_us": last - first,
                    "traced_us": sum(stages.values())}
    return out


def attribution_table(events: list[dict],
                      wall_s: float | None = None) -> str:
    """Human-readable per-stage table over ``self_times``. Per thread:
    each stage's self time, share of thread wall, and the untraced gap
    so 'stages sum to ≈ wall' is checkable at a glance."""
    threads = self_times(events)
    if not threads:
        return "no span events"
    lines = []
    agg: dict[str, float] = {}
    for (pid, tid), t in sorted(threads.items()):
        wall = t["wall_us"]
        if wall_s is not None:
            wall = max(wall, wall_s * 1e6)
        lines.append(f"-- pid {pid} tid {tid} "
                     f"(wall {wall / 1e6:.3f}s, traced "
                     f"{t['traced_us'] / 1e6:.3f}s, coverage "
                     f"{100.0 * t['traced_us'] / max(wall, 1e-9):.1f}%)")
        lines.append(f"   {'stage':<18}{'self_ms':>12}{'count':>8}"
                     f"{'share':>8}")
        for name, us in sorted(t["stages"].items(), key=lambda kv: -kv[1]):
            agg[name] = agg.get(name, 0.0) + us
            lines.append(f"   {name:<18}{us / 1e3:>12.2f}"
                         f"{t['counts'][name]:>8}"
                         f"{100.0 * us / max(wall, 1e-9):>7.1f}%")
        gap = max(wall - t["traced_us"], 0.0)
        lines.append(f"   {'(untraced)':<18}{gap / 1e3:>12.2f}{'':>8}"
                     f"{100.0 * gap / max(wall, 1e-9):>7.1f}%")
    lines.append("-- all threads (self time)")
    total = sum(agg.values())
    for name, us in sorted(agg.items(), key=lambda kv: -kv[1]):
        lines.append(f"   {name:<18}{us / 1e3:>12.2f}{'':>8}"
                     f"{100.0 * us / max(total, 1e-9):>7.1f}%")
    return "\n".join(lines)
