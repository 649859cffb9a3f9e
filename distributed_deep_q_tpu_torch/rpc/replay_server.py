"""``ReplayFeed`` — the actor↔learner RPC service (SURVEY.md §5.8 [M]).

A copy of the reference ``rpc/replay_server.py`` (host only), its imports rewritten
to this package.

The reference keeps CPU actors feeding the replay buffer "over the same RPC
boundary" while the learner owns the accelerator (north star [M]). This is
that boundary, rebuilt: a threaded raw-TCP service colocated with the
learner, speaking ``rpc/protocol.py`` messages:

- ``add_transitions`` — actors push transition chunks (pixel streams carry
  frames + episode flags; vector streams carry explicit n-step transitions;
  recurrent actors carry whole R2D2 sequences with their stored LSTM carry).
  Each actor stream id pins to a replay shard so the device ring's temporal
  adjacency invariant holds.
- ``get_params``      — actors pull fresh θ every ~``param_sync_period`` env
  steps (replaces the reference PS pull path; there is NO gradient plane
  over this boundary — ``lax.pmean`` over ICI replaced the push path).
- ``heartbeat`` / ``stats`` — failure detection (SURVEY §5.3) and the
  env-steps/episode-return counters the north-star metrics need.

Thread-safety: one lock guards the replay buffer (writer threads vs the
learner's sampler) and a second guards the published parameter snapshot.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from collections import deque
from typing import Any

import numpy as np

from distributed_deep_q_tpu_torch import health, tracing
from distributed_deep_q_tpu_torch.metrics import Histogram
from distributed_deep_q_tpu_torch.rpc import faultinject
from distributed_deep_q_tpu_torch.rpc.flowcontrol import FlowConfig, FlowController
from distributed_deep_q_tpu_torch.rpc.protocol import (
    ChecksumError, ProtocolError, encode, recv_msg, recv_msg_sized, reframe,
    send_msg)
from distributed_deep_q_tpu_torch.utils.durability import (
    GenerationStore, savez_bytes)

log = logging.getLogger(__name__)

# elastic-fleet verbs delegated to an attached MembershipRegistry
# (actors/membership.py keeps the authoritative FLEET_METHODS tuple;
# spelled out here so the wire layer stays import-light — membership is
# only imported by whoever attaches a registry)
_FLEET_METHODS = ("fleet_join", "fleet_leave", "fleet_lease",
                  "fleet_view")


class ServerTelemetry:
    """Server-side RPC + fleet accounting (observability spine).

    Every served request records into per-method latency (ms) and
    request-payload-size (bytes) histograms; actors piggyback their own
    counters (``tm_*`` keys on ``add_transitions`` — θ-pull latency,
    heartbeat RTT, env-step time) which aggregate into fleet-wide
    histograms plus per-actor env-step counters, so the learner-side
    ``Metrics`` holds a fleet view without any extra RPC traffic.
    One lock guards all structures: they are touched from every serve
    thread.
    """

    # actor-shipped sample arrays → fleet histogram names
    ACTOR_KEYS = {
        "tm_param_pull_ms": "fleet/param_pull_ms",
        "tm_heartbeat_rtt_ms": "fleet/heartbeat_rtt_ms",
        "tm_env_step_ms": "fleet/env_step_ms",
        # vectorized acting plane: whole-tick batched env
        # step, batched-infer round trip + rows per RPC, auto-resets
        "tm_vector_step_ms": "actor/vector_step_ms",
        "tm_vector_infer_ms": "actor/infer_rtt_ms",
        "tm_vector_rows": "actor/vector_rows",
        "tm_vector_resets": "actor/auto_resets",
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.method_calls: dict[str, int] = {}
        self.method_lat: dict[str, Histogram] = {}
        self.method_bytes: dict[str, Histogram] = {}
        self.fleet: dict[str, Histogram] = {}
        self.actor_env_steps: dict[int, int] = {}
        self.last_pulled_version: dict[int, int] = {}
        # robustness gauges: dispatch failures answered with an error dict
        # (instead of a dead serve thread) and retried flushes the seq
        # dedup absorbed (each one is a prevented double-insert)
        self.dispatch_errors = 0
        self.duplicate_flushes = 0
        # overload plane: flushes answered with an explicit SHED (total and
        # per actor — the fleet view of who is being backpressured) and
        # serve threads reaped by the socket recv/send deadline
        self.shed_flushes = 0
        self.actor_sheds: dict[int, int] = {}
        self.conn_timeouts = 0
        # durability plane: frames rejected by the wire-v4 CRC trailer
        # (each one is a prevented silent replay poisoning — the client
        # re-sends through its retry policy), snapshot cadence/size/stall
        # gauges, and generations quarantined by integrity checks
        self.checksum_errors = 0
        self.snapshot_count = 0
        self.snapshot_skipped = 0
        self.snapshot_capture_ms = 0.0  # lock-hold time (the stall)
        self.snapshot_write_ms = 0.0    # off-lock serialize + fsync
        self.snapshot_bytes = 0
        self.snapshot_generations = 0
        self.snapshot_quarantined = 0
        # tracing plane: ingest lag (actor env-step birth → server insert,
        # ms, skew-corrected on the actor side) from lineage-stamped
        # flushes. Covers every replay tier, including the device-resident
        # ones whose rows have no host slot index for full time_to_learn
        self.ingest_lag = Histogram(1e-3, 1e5)

    def record_dispatch_error(self) -> None:
        with self._lock:
            self.dispatch_errors += 1

    def record_checksum_error(self) -> None:
        with self._lock:
            self.checksum_errors += 1

    def record_snapshot(self, capture_ms: float, write_ms: float,
                        nbytes: int, generations: int) -> None:
        with self._lock:
            self.snapshot_count += 1
            self.snapshot_capture_ms = capture_ms
            self.snapshot_write_ms = write_ms
            self.snapshot_bytes = nbytes
            self.snapshot_generations = generations

    def record_snapshot_skip(self) -> None:
        with self._lock:
            self.snapshot_skipped += 1

    def record_quarantined(self, n: int) -> None:
        if n:
            with self._lock:
                self.snapshot_quarantined += n

    def record_duplicate_flush(self) -> None:
        with self._lock:
            self.duplicate_flushes += 1

    def record_shed(self, actor_id: int) -> None:
        with self._lock:
            self.shed_flushes += 1
            if actor_id >= 0:
                self.actor_sheds[actor_id] = \
                    self.actor_sheds.get(actor_id, 0) + 1

    def record_conn_timeout(self) -> None:
        with self._lock:
            self.conn_timeouts += 1

    def record_call(self, method: str, ms: float, nbytes: int) -> None:
        with self._lock:
            self.method_calls[method] = self.method_calls.get(method, 0) + 1
            lat = self.method_lat.get(method)
            if lat is None:
                lat = self.method_lat[method] = Histogram(1e-3, 1e5)
            lat.observe(ms)
            size = self.method_bytes.get(method)
            if size is None:
                # requests span ~60 B heartbeats to multi-MB θ frames
                size = self.method_bytes[method] = Histogram(1.0, 1e10,
                                                             per_decade=5)
            size.observe(nbytes)

    def record_pull(self, actor_id: int, version: int) -> None:
        if actor_id >= 0:
            with self._lock:
                self.last_pulled_version[actor_id] = version

    def on_transitions(self, actor_id: int, n: int,
                       req: dict[str, Any]) -> None:
        """Account one add_transitions: per-actor env steps + any
        piggybacked ``tm_*`` counter arrays into the fleet histograms."""
        with self._lock:
            if actor_id >= 0:
                self.actor_env_steps[actor_id] = \
                    self.actor_env_steps.get(actor_id, 0) + n
            for key, name in self.ACTOR_KEYS.items():
                samples = req.get(key)
                if samples is None:
                    continue
                h = self.fleet.get(name)
                if h is None:
                    h = self.fleet[name] = Histogram(1e-3, 1e5)
                h.observe_many(np.atleast_1d(samples))
            births = req.get(tracing.KEY_BIRTH)
            if births is not None:
                now = tracing.now()
                lags = (now - np.atleast_1d(births).astype(np.float64)) * 1e3
                # a slightly-over-corrected skew can push a lag below zero;
                # clamp to the histogram floor rather than dropping it
                self.ingest_lag.observe_many(np.maximum(lags, 1e-3))

    def summary(self, params_version: int = 0) -> dict[str, float]:
        """Flat scalar view for ``Metrics.log`` / the ``stats`` RPC:
        per-method call counts + latency/size percentiles, fleet
        histograms, and the params-version lag gauge (how far the most
        stale actor's pulled θ trails the published version)."""
        with self._lock:
            out: dict[str, float] = {}
            for m, c in self.method_calls.items():
                out[f"rpc/{m}_calls"] = c
            for m, h in self.method_lat.items():
                out.update(h.summary(prefix=f"rpc/{m}_ms"))
            for m, h in self.method_bytes.items():
                out[f"rpc/{m}_bytes_p95"] = h.percentile(0.95)
                out[f"rpc/{m}_bytes_max"] = h.vmax
            for name, h in self.fleet.items():
                out.update(h.summary(prefix=name))
            out["queue/params_version"] = params_version
            if self.last_pulled_version:
                out["queue/params_version_lag"] = params_version - min(
                    self.last_pulled_version.values())
            out["rpc/dispatch_errors"] = self.dispatch_errors
            out["rpc/duplicate_flushes"] = self.duplicate_flushes
            out["rpc/shed_flushes"] = self.shed_flushes
            out["rpc/conn_timeouts"] = self.conn_timeouts
            out["rpc/checksum_errors"] = self.checksum_errors
            out["durability/snapshot_count"] = self.snapshot_count
            out["durability/snapshot_skipped"] = self.snapshot_skipped
            out["durability/snapshot_capture_ms"] = self.snapshot_capture_ms
            out["durability/snapshot_write_ms"] = self.snapshot_write_ms
            out["durability/snapshot_bytes"] = self.snapshot_bytes
            out["durability/generations"] = self.snapshot_generations
            out["durability/quarantined"] = self.snapshot_quarantined
            if self.ingest_lag.count:  # only when a traced run fed it
                out.update(self.ingest_lag.summary(
                    prefix="trace/ingest_lag_ms"))
            return out

    def latency_snapshots(self) -> dict[str, Histogram]:
        """Point-in-time copies of the cumulative per-method latency
        histograms, keyed by their metric prefix — the health plane
        diffs consecutive snapshots into sliding-window p99 series
        (``Histogram.delta``), which cumulative percentiles can't give
        (a cumulative p99 never recovers from one bad minute)."""
        with self._lock:
            return {f"rpc/{m}_ms": h.snapshot()
                    for m, h in self.method_lat.items()}

    def per_actor_env_steps(self) -> tuple[np.ndarray, np.ndarray]:
        with self._lock:
            ids = sorted(self.actor_env_steps)
            return (np.asarray(ids, np.int64),
                    np.asarray([self.actor_env_steps[i] for i in ids],
                               np.int64))

    def per_actor_sheds(self) -> tuple[np.ndarray, np.ndarray]:
        with self._lock:
            ids = sorted(self.actor_sheds)
            return (np.asarray(ids, np.int64),
                    np.asarray([self.actor_sheds[i] for i in ids],
                               np.int64))

    def robustness_counters(self) -> dict[str, int]:
        """Locked read of the robustness gauges — summary/verdict paths
        must not read them raw while serve threads increment."""
        with self._lock:
            return {"dispatch_errors": self.dispatch_errors,
                    "duplicate_flushes": self.duplicate_flushes,
                    "shed_flushes": self.shed_flushes,
                    "conn_timeouts": self.conn_timeouts,
                    "checksum_errors": self.checksum_errors,
                    "snapshot_quarantined": self.snapshot_quarantined,
                    "snapshot_skipped": self.snapshot_skipped}


class ReplayFeedServer:
    """Threaded TCP server wrapping a replay buffer + parameter snapshot."""

    # rate limit for dispatch/frame error logging: chaos mode or a broken
    # actor can fail thousands of times a second — log a sample, count all
    ERR_LOG_PERIOD = 5.0

    # lineage map bound: oldest mappings evict FIFO past this — at the
    # default lineage rate one entry rides in every ~20th transition, so
    # this covers minutes of ingest while bounding a day-long run
    LINEAGE_CAP = 16384

    def __init__(self, replay, host: str = "127.0.0.1", port: int = 0,
                 snapshot_path: str = "", flow: FlowConfig | None = None,
                 snapshot_keep: int = 3):
        self.replay = replay
        # whether the replay's add_batch takes a stream id, read once: the
        # signature lookup costs ~0.1 ms, more than the rest of a small
        # flush's bookkeeping
        self._stream_kw = _takes_stream(replay)
        self.telemetry = ServerTelemetry()
        self.snapshot_keep = snapshot_keep
        # serializes snapshot attempts; held across the async write so an
        # overlapping cadence tick skips instead of racing the generation
        # counter. Acquired in the caller, released by the writer thread —
        # legal for a plain Lock, and why this is NOT an RLock.
        self._snap_lock = threading.Lock()
        self._restored_generation = -1  # set by a generational warm boot
        # RLock: stats/mean_recent_return may be read under an already-held
        # guard (e.g. inside the add_transitions/stats handlers)
        self.replay_lock = threading.RLock()
        # overload plane: credit ledger + admission controller + watchdog,
        # sharing replay_lock so admission is atomic with the insert it
        # gates. Ephemeral by design — credits/rates rebuild within one
        # EWMA half-life after a warm boot, so it rides in no snapshot
        self.flow = FlowController(flow or FlowConfig(), self.replay_lock,
                                   replay)
        # health plane: this server's local monitor — sampled
        # on every `health` scrape, so a run that never scrapes pays
        # nothing beyond construction (and the module flag keeps even
        # scrapes free when cfg.health is off)
        self.health_monitor = health.HealthMonitor(
            rules=health.default_server_rules(),
            trends=health.default_server_trends(), name="replay")
        self._params_wire: bytes | None = None  # pre-encoded θ frame
        self._params_version = 0
        self._params_lock = threading.Lock()
        self.last_seen: dict[int, float] = {}
        self.env_steps = 0
        self.episodes = 0
        # bounded: only the recent tail is ever read (mean_recent_return)
        self.returns: deque[float] = deque(maxlen=1000)
        # idempotent-flush dedup: highest flush_seq inserted per actor.
        # Guarded by replay_lock — the seq check and the insert must be one
        # atomic step or an ambiguous retry could still double-insert.
        self._flush_seq: dict[int, int] = {}
        # transition lineage: ring slot → (birth stamp, env_steps at
        # insert) for lineage-sampled rows. Guarded by replay_lock (the
        # slot index is only meaningful against the ring state it was
        # written under). Bounded FIFO — a sampled diagnostic, not a
        # ledger; see LINEAGE_CAP
        self._lineage: dict[int, tuple[float, int]] = {}
        self._err_log_at = 0.0
        self._err_suppressed = 0
        # elastic-fleet plane (membership.py): the seed host attaches a
        # MembershipRegistry so fleet_* verbs answer on this wire. Set
        # once before actors connect, read-only afterwards — no lock
        self.membership = None
        # live accepted connections, closed on shutdown so reconnecting
        # actors fail fast into their retry policy instead of blocking on
        # a half-dead socket
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # dispatches between recv and reply; shutdown drains this to zero
        # before snapshotting, so a request racing the shutdown is either
        # fully in the snapshot (its lost-ack retry dedups) or never ran
        self._inflight = 0
        self._inflight_cv = threading.Condition()

        # warm boot BEFORE the listener opens: an actor reconnecting into a
        # half-restored server could double-insert (dedup map not yet
        # loaded) or pull a stale θ version
        if snapshot_path:
            self._restore(snapshot_path)

        self.flow.start_watchdog()
        # device-resident replay tiers expose start_drain: a background
        # staging→device transfer thread sharing replay_lock, so serve
        # threads pay a cursor bump + notify instead of the device dispatch
        #. Host-tier replays have no staged plane — no drain.
        self._drain = None
        start_drain = getattr(self.replay, "start_drain", None)
        if start_drain is not None:
            self._drain = start_drain(self.replay_lock)
        self._sock = socket.create_server((host, port))
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="replayfeed-accept", daemon=True)
        self._accept_thread.start()

    # -- learner-side API ---------------------------------------------------

    def attach_membership(self, registry) -> None:
        """Install the fleet registry (actors/membership.py) so this
        server answers the ``fleet_*`` verbs. Called once at bring-up,
        before any actor connects."""
        self.membership = registry

    def publish_params(self, weights: list[np.ndarray]) -> int:
        """Install a new θ snapshot for actors to pull; returns version.

        The snapshot is encoded to its WIRE frame once, here — every pull
        then ships the same cached bytes (``sendall``, no per-pull
        serialization). At 256 actors / 400-step sync the old per-pull
        ``encode`` re-serialized the full dense θ hundreds of times per
        publish on the learner host."""
        msg: dict[str, Any] = {f"w{i}": np.asarray(w)
                               for i, w in enumerate(weights)}
        msg["n"] = len(weights)
        with self._params_lock:
            self._params_version += 1
            msg["version"] = self._params_version
            self._params_wire = encode(msg)
            return self._params_version

    def _published_version(self) -> int:
        with self._params_lock:
            return self._params_version

    def mean_recent_return(self, k: int = 100) -> float:
        with self.replay_lock:
            tail = list(self.returns)[-k:]
        return float(np.mean(tail)) if tail else float("nan")

    def stream_seq_of(self, actor_id: int) -> int:
        """Highest flush_seq landed for one actor (−1 = never). The
        autoscale executor polls this during a retirement drain — a
        quiet seq means nothing of the actor's is mid-wire."""
        with self.replay_lock:
            return self._flush_seq.get(int(actor_id), -1)

    def retire_stream(self, actor_id: int) -> None:
        """Evict a permanently-retired actor's exactly-once dedup stamp
        and contact stamp. ``reset_stream`` covers the
        REPLACEMENT case (a fresh process reusing the id); this covers
        scale-down, where no replacement is coming and a lingering stamp
        is pure leak. Seals the stream's replay slot the same way."""
        with self.replay_lock:
            if hasattr(self.replay, "reset_stream"):
                self.replay.reset_stream(int(actor_id))
            self._flush_seq.pop(int(actor_id), None)
        self.last_seen.pop(int(actor_id), None)

    def note_consumed(self, rows: int) -> None:
        """Learner-side feed for the credit formula: ``rows`` were sampled
        for training. Drives consumption-rate-based credits and the
        ingest-mismatch shed branch; costs one EWMA update per call."""
        self.flow.note_consumed(rows)

    def flow_counters(self) -> dict:
        """Locked snapshot of the overload gauges (degraded flag/trips,
        sheds, consume/ingest rates, per-actor credits)."""
        return self.flow.counters()

    def counters(self) -> dict[str, int]:
        """Locked, mutually consistent read of the ingest counters for
        the checkpoint/summary paths — a raw ``server.env_steps`` read
        can interleave with an ``add_transitions`` mid-increment."""
        with self.replay_lock:
            return {
                "env_steps": self.env_steps,
                "episodes": self.episodes,
                "replay_size": (len(self.replay)
                                if self.replay is not None else 0),
            }

    def close(self) -> None:
        self._stop.set()
        # shutdown() before close(): on Linux a blocked accept() is NOT
        # woken by close() from another thread — the port would stay in
        # LISTEN and a warm reboot on the same port would get EADDRINUSE
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self.flow.close()
        if self._drain is not None:
            with self.replay_lock:
                replay = self.replay
            replay.stop_drain()
            self._drain = None

    # -- restart survival ---------------------------------------------------
    #
    # A learner restart used to be fatal for the run: actors storm-restarted
    # against a dead port and the replay warm-fill started from zero. The
    # snapshot/warm-boot pair below makes the server a resumable process:
    # ``shutdown(path)`` quiesces and dumps replay + counters + the θ frame;
    # a new ``ReplayFeedServer(..., snapshot_path=path)`` on the SAME port
    # comes back with its state intact, and actors simply reconnect through
    # their retry policy — no restarts, no lost replay, no duplicate
    # flushes (the dedup map rides in the snapshot).

    def _capture_state(self) -> tuple[dict[str, Any], dict | None,
                                      int, float]:
        """Capture everything a snapshot persists, under ``replay_lock``
        only as long as the copy takes. Returns ``(server state, replay
        state | None, params_version, capture_ms)`` — all owned data the
        caller may serialize and fsync with no lock held."""
        from distributed_deep_q_tpu_torch.replay.persistence import replay_state

        t0 = time.perf_counter()
        with tracing.span("snapshot_capture"), self.replay_lock:
            with self._params_lock:
                wire = self._params_wire
                version = self._params_version
            ids = sorted(self._flush_seq)
            state: dict[str, Any] = {
                "schema": 1,
                "env_steps": self.env_steps,
                "episodes": self.episodes,
                "returns": np.asarray(list(self.returns), np.float64),
                "flush_ids": np.asarray(ids, np.int64),
                "flush_seqs": np.asarray(
                    [self._flush_seq[i] for i in ids], np.int64),
                "params_version": version,
                "params_wire": np.frombuffer(wire, np.uint8)
                if wire is not None else np.zeros(0, np.uint8),
            }
            rstate = None
            if self.replay is not None:
                try:
                    rstate = replay_state(self.replay)
                except TypeError as e:  # tier without persistence support
                    log.warning("server snapshot: replay not persisted "
                                "(%s); counters/params saved", e)
        return state, rstate, version, 1e3 * (time.perf_counter() - t0)

    def _write_snapshot(self, path: str, cap: tuple) -> int:
        """Serialize + commit one captured generation. Runs with NO lock
        but ``_snap_lock`` held by the caller (sync) or inherited from it
        (async)."""
        state, rstate, version, capture_ms = cap
        t0 = time.perf_counter()
        with tracing.span("snapshot_write"):
            files = {"server.npz": savez_bytes(**state)}
            if rstate is not None:
                files["replay.npz"] = savez_bytes(**rstate)
            store = GenerationStore(path, keep=self.snapshot_keep)
            gen = store.commit(
                files, meta={"params_version": version,
                             "env_steps": int(state["env_steps"])})
        nbytes = sum(len(b) for b in files.values())
        self.telemetry.record_snapshot(
            capture_ms, 1e3 * (time.perf_counter() - t0), nbytes,
            len(store.generations()))
        return gen

    def snapshot(self, path: str) -> int:
        """Dump server state (+ replay when its tier supports persistence)
        as one checksummed snapshot generation, without stopping service.
        ``replay_lock`` is held only for the in-memory capture; serialize
        + fsync happen off-lock, so serving continues through the dump.
        Returns the committed generation number."""
        with self._snap_lock:
            return self._write_snapshot(path, self._capture_state())

    def snapshot_async(self, path: str) -> bool:
        """Non-blocking checkpoint-cadence snapshot: capture under the
        locks briefly, then serialize + fsync in a background thread so
        the learner loop never stalls on disk. Returns False (and counts
        a skip) when a previous dump is still writing — steady progress
        beats a pile-up of overlapping dumps."""
        if not self._snap_lock.acquire(blocking=False):
            self.telemetry.record_snapshot_skip()
            return False
        try:
            cap = self._capture_state()
        except BaseException:
            self._snap_lock.release()
            raise
        threading.Thread(target=self._write_and_release,
                         args=(path, cap), name="replayfeed-snapshot",
                         daemon=True).start()
        return True

    def _write_and_release(self, path: str, cap: tuple) -> None:
        try:
            self._write_snapshot(path, cap)
        except Exception:  # noqa: BLE001 — a failed background dump must
            # not kill the process; the next cadence tick tries again
            log.exception("async snapshot to %s failed", path)
        finally:
            self._snap_lock.release()

    def shutdown(self, path: str, drain_timeout: float = 5.0) -> None:
        """Graceful stop for a warm reboot: stop accepting, sever live
        connections (clients retry into the reboot), drain in-flight
        dispatches, snapshot state. Blocks on ``_snap_lock``, so an
        in-flight async dump completes before the final generation."""
        self.close()
        with self._inflight_cv:
            self._inflight_cv.wait_for(lambda: self._inflight == 0,
                                       timeout=drain_timeout)
        self.snapshot(path)

    def _reset_boot_state(self) -> None:
        """Back out a partially applied restore so the next candidate
        generation (or a cold boot) starts from clean counters."""
        self.env_steps = 0
        self.episodes = 0
        self.returns.clear()
        self._flush_seq = {}
        self._lineage = {}
        self._params_version = 0
        self._params_wire = None

    def _load_generation(self, files: dict[str, str]) -> None:
        from distributed_deep_q_tpu_torch.replay.persistence import load_replay

        z = np.load(files["server.npz"], allow_pickle=False)
        self.env_steps = int(z["env_steps"])
        self.episodes = int(z["episodes"])
        self.returns.extend(float(r) for r in z["returns"])
        self._flush_seq = {int(i): int(s) for i, s in
                           zip(z["flush_ids"], z["flush_seqs"])}
        self._params_version = int(z["params_version"])
        wire = z["params_wire"]
        # snapshots persist the θ frame verbatim; re-stamp frames written
        # by a previous (payload-compatible) wire version so resumed
        # actors don't reject the pull. reframe also re-verifies the v4
        # CRC trailer — a frame corrupt at rest fails HERE, not in actors
        self._params_wire = reframe(wire.tobytes()) if wire.size else None
        if self.replay is not None and "replay.npz" in files:
            load_replay(self.replay, files["replay.npz"])

    def _restore(self, path: str) -> None:
        """Warm boot from the newest VALID snapshot generation. Every
        candidate is checksum-verified first; one that verifies but still
        fails to load (schema drift, geometry mismatch) is quarantined
        too and the walk continues. Worst case is a loud cold boot —
        a damaged snapshot can no longer crash the reboot."""
        store = GenerationStore(path, keep=self.snapshot_keep)
        while True:
            pick = store.latest_valid()
            if pick is None:
                break
            gen, files, _meta = pick
            try:
                with tracing.span("restore"):
                    self._load_generation(files)
            except Exception as e:  # noqa: BLE001 — any load failure
                # must fall back, not kill the boot
                self._reset_boot_state()
                store.quarantine(gen, f"load failed: {e}")
                continue
            self._restored_generation = gen
            self.telemetry.record_quarantined(store.quarantined)
            log.info("warm boot from %s gen %d: env_steps=%d replay=%s "
                     "θ-version=%d (%d generation(s) quarantined)",
                     path, gen, self.env_steps,
                     len(self.replay) if self.replay is not None else "-",
                     self._params_version, store.quarantined)
            return
        self.telemetry.record_quarantined(store.quarantined)
        # legacy flat layout (pre-generational snapshots): {path}.server.npz
        server_file = f"{path}.server.npz"
        replay_file = f"{path}.replay.npz"
        if not os.path.exists(server_file):
            if store.quarantined:
                log.error("COLD BOOT: all %d snapshot generation(s) under "
                          "%s failed verification", store.quarantined, path)
            return  # cold boot: first run with snapshotting enabled
        files = {"server.npz": server_file}
        if os.path.exists(replay_file):
            files["replay.npz"] = replay_file
        try:
            with tracing.span("restore"):
                self._load_generation(files)
        except Exception as e:  # noqa: BLE001 — truncated/corrupt legacy
            # npz (torn write by an old build) must not crash the boot
            self._reset_boot_state()
            self.telemetry.record_quarantined(1)
            log.error("COLD BOOT: legacy snapshot %s is corrupt (%s: %s)",
                      server_file, type(e).__name__, e)
            return
        log.info("warm boot from legacy snapshot %s: env_steps=%d "
                 "replay=%s θ-version=%d", path, self.env_steps,
                 len(self.replay) if self.replay is not None else "-",
                 self._params_version)

    # -- wire loop ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed
            threading.Thread(target=self._serve, args=(conn,),
                             name="replayfeed-serve", daemon=True).start()

    def _log_error(self, what: str, e: BaseException) -> None:
        """Rate-limited error logging: one line per ERR_LOG_PERIOD with a
        suppressed-count, so a chaos storm can't flood the log while a
        serve-thread death still always leaves a trace."""
        now = time.monotonic()
        with self._conns_lock:
            if now - self._err_log_at < self.ERR_LOG_PERIOD:
                self._err_suppressed += 1
                return
            suppressed, self._err_suppressed = self._err_suppressed, 0
            self._err_log_at = now
        log.warning("replayfeed %s: %s: %s (+%d similar suppressed)",
                    what, type(e).__name__, e, suppressed)

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # recv/send deadline: a wedged or half-dead peer cannot pin a serve
        # thread (and its connection slot) forever. Healthy-but-idle actors
        # heartbeat every ~5 s over this socket, far inside the bound
        deadline = self.flow.cfg.conn_deadline_s
        if deadline and deadline > 0:
            conn.settimeout(deadline)
        conn = faultinject.wrap(conn, side="server")
        with self._conns_lock:
            self._conns.add(conn)
        try:
            while not self._stop.is_set():
                try:
                    req, nbytes = recv_msg_sized(conn)
                except TimeoutError as e:
                    # conn deadline expired mid-recv: reap the thread; a
                    # live client reconnects through its retry policy
                    self.telemetry.record_conn_timeout()
                    self._log_error("conn deadline", e)
                    return
                except ChecksumError as e:
                    # payload failed the wire-v4 CRC: structure may even
                    # have parsed, but the bytes are not what the peer
                    # sent — count separately (silent-corruption pressure)
                    # and drop the conn; the client re-sends on a clean
                    # stream and the flush-seq dedup keeps it exactly-once
                    self.telemetry.record_checksum_error()
                    self._log_error("checksum", e)
                    return
                except ProtocolError as e:
                    # desynced/corrupt stream: the frame boundary is gone,
                    # so no error reply is possible — log, count, drop the
                    # connection; the client reconnects on a clean stream
                    self.telemetry.record_dispatch_error()
                    self._log_error("bad frame", e)
                    return
                t0 = time.perf_counter()
                with self._inflight_cv:
                    self._inflight += 1
                try:
                    try:
                        resp = self._dispatch(req)
                    except Exception as e:  # noqa: BLE001 — malformed
                        # payloads (KeyError on a missing field, shape
                        # mismatch, ...) must never kill the serve thread
                        # silently: answer with an error dict so the
                        # caller fails loudly
                        self.telemetry.record_dispatch_error()
                        self._log_error(f"dispatch {req.get('method')!r}", e)
                        resp = {"error": f"{type(e).__name__}: {e}"}
                finally:
                    with self._inflight_cv:
                        self._inflight -= 1
                        self._inflight_cv.notify_all()
                if isinstance(resp, (bytes, bytearray)):
                    conn.sendall(resp)  # pre-encoded frame (θ snapshot)
                else:
                    send_msg(conn, resp)
                # latency covers dispatch + response serialization + send —
                # what the actor actually waits on past its own upload
                self.telemetry.record_call(
                    str(req.get("method")),
                    1e3 * (time.perf_counter() - t0), nbytes)
        except TimeoutError:
            self.telemetry.record_conn_timeout()  # deadline expired mid-send
        except (ConnectionError, OSError):
            pass  # actor went away; supervisor handles liveness
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _dispatch(self, req: dict[str, Any]) -> dict[str, Any] | bytes:
        method = req.get("method")
        actor_id = int(req.get("actor_id", -1))
        if actor_id >= 0:
            self.last_seen[actor_id] = time.monotonic()

        if method == "add_transitions":
            # adopt the actor's causal context (tr_* keys on the frame, if
            # any) so the server-side spans hang off the client's rpc_call
            with tracing.activate(req):
                return self._add_transitions(req, actor_id)

        if method == "get_params":
            with self._params_lock:
                if self._params_wire is None:
                    return {"version": 0}
                self.telemetry.record_pull(actor_id, self._params_version)
                if req.get("have_version") == self._params_version:
                    return {"version": self._params_version}  # no-op refresh
                return self._params_wire  # cached frame, sent verbatim

        if method == "reset_stream":
            # a fresh actor process announcing itself on a (possibly reused)
            # stream id: seal the stream's current slot so no sampled window
            # straddles the previous writer's half-episode (SURVEY §5.3)
            with self.replay_lock:
                if hasattr(self.replay, "reset_stream") and actor_id >= 0:
                    self.replay.reset_stream(actor_id)
                # a fresh actor process restarts its flush_seq from 1; the
                # dead predecessor can never retry again, so dropping its
                # stamp here is what lets the replacement's flushes land
                if actor_id >= 0:
                    self._flush_seq.pop(actor_id, None)
            return {"ok": True}

        if method == "heartbeat":
            return {"ok": True}

        if method == "retire_stream":
            # graceful scale-down: the autoscale executor has
            # terminated this actor FOR GOOD — evict its exactly-once
            # dedup stamp (and contact stamp) so scale-down churn cannot
            # grow the (actor_id, flush_seq) map unboundedly. Idempotent:
            # evicting an absent stamp is the same no-op twice
            if actor_id >= 0:
                self.retire_stream(actor_id)
            return {"ok": True}

        if method == "stream_seq":
            # elastic remap support (actors/membership.py): the highest
            # flush_seq this shard has LANDED for the asking actor. A
            # remapped actor queries its old shard's importer before
            # releasing an in-flight resend — a floor at or above the
            # in-flight seq means the flush traveled inside the handoff
            # snapshot and must not be re-sent elsewhere
            with self.replay_lock:
                return {"ok": True,
                        "seq": self._flush_seq.get(actor_id, -1)}

        if method in _FLEET_METHODS:
            # elastic-fleet verbs delegate to the attached registry —
            # its own _dispatch owns the method branches (and the
            # protocol-drift pass reads them from there)
            registry = self.membership
            if registry is None:
                return {"error": "no membership registry on this host"}
            return registry._dispatch(req)

        if method == "health":
            # one scrape = sample current telemetry into the windowed
            # rings + evaluate SLO/trend rules → flat wire verdict
            return self.health_scrape()

        if method == "stats":  # ddq: allow(protocol.orphan-handler) — the scrape verb of operators and tests; the port's own code reads this telemetry in process
            with self.replay_lock:
                out = {
                    "env_steps": self.env_steps,
                    "episodes": self.episodes,
                    "replay_size": (len(self.replay)
                                    if self.replay is not None else 0),
                    "mean_return": self.mean_recent_return(),
                }
            # server health for actors/bench/tests without reaching into
            # internals: per-method latency/size summaries, queue gauges,
            # and the fleet counters the actors flushed back
            out.update(self.telemetry_summary())
            ids, steps = self.telemetry.per_actor_env_steps()
            out["actor_ids"] = ids
            out["actor_env_steps"] = steps
            shed_ids, shed_counts = self.telemetry.per_actor_sheds()
            out["shed_actor_ids"] = shed_ids
            out["shed_counts"] = shed_counts
            return out

        return {"error": f"unknown method {method!r}"}

    def _add_transitions(self, req: dict[str, Any],
                         actor_id: int) -> dict[str, Any]:
        # NTP recv stamp (server clock): paired with the done stamp below,
        # it gives the client a skew sample on every traced flush reply
        t2 = tracing.now() if (tracing.ENABLED
                               and tracing.KEY_SENT_AT in req) else 0.0
        # row count up front: the admission controller needs it before
        # any insert happens (sequence batches carry explicit env_steps;
        # overlapping windows would double-count otherwise)
        if "init_c" in req:
            n = int(req.get("env_steps", len(req["action"])))
        else:
            n = len(req["action"])
        # off-lock parse/prep: scalar conversions,
        # episode-return unpacking, and lineage stamp prep read only the
        # request — the hold below used to cover all of it, serializing
        # every serve thread behind pure-Python parsing. Only ring-state
        # mutation remains under the lock; the shape is pinned by
        # tests/test_columnar_ingest.py::test_add_transitions_lock_shape
        with tracing.span("ingest_parse"):
            seq = int(req.get("flush_seq", -1))
            episodes = int(req.get("episodes", 0))
            ep_returns = [float(r) for r in np.atleast_1d(
                req.get("ep_returns", np.zeros(0, np.float32)))]
            births = req.get(tracing.KEY_BIRTH)
            if births is not None:
                births = np.atleast_1d(births).astype(np.float64)
        with tracing.locked(self.replay_lock):
            # idempotent-flush dedup: a resilient client resends a
            # failed flush with the SAME flush_seq; if the first send
            # actually landed (ack lost — the ambiguous failure), the
            # stamp is already recorded and the retry must be a no-op
            # or replay would hold duplicated transitions. Dedup wins
            # over admission: the data is already in, shedding the
            # retry would only make the client resend a third time
            if seq >= 0 and actor_id >= 0 \
                    and seq <= self._flush_seq.get(actor_id, -1):
                self.telemetry.record_duplicate_flush()
                return {"ok": True, "duplicate": True,
                        "env_steps": self.env_steps,
                        "credits": self.flow.grant(actor_id),
                        "params_version": self._published_version(),
                        **self._reply_stamps(t2)}
            admitted, retry_ms = self.flow.admit(actor_id, n)
            if not admitted:
                # explicit SHED — never a silent drop. The seq stays
                # unstamped, so the client re-sends the SAME flush
                # after retry_after_ms and it lands exactly once when
                # the backlog clears (the zero-loss contract holds)
                self.telemetry.record_shed(actor_id)
                return {"ok": False, "shed": True,
                        "retry_after_ms": retry_ms,
                        "credits": self.flow.grant(actor_id),
                        "params_version": self._published_version(),
                        **self._reply_stamps(t2)}
            if "init_c" in req:  # R2D2 sequence batch → SequenceReplay
                with tracing.span("ring_insert"):
                    idx = self.replay.add_batch(
                        {k: req[k] for k in
                         ("obs", "action", "reward", "discount", "mask",
                          "init_c", "init_h")})
            elif "frame" in req:  # pixel stream → frame/device ring
                batch = {k: req[k] for k in
                         ("frame", "action", "reward", "done", "boundary")
                         if k in req}
                with tracing.span("ring_insert"):
                    if self._stream_kw:
                        idx = self.replay.add_batch(batch, stream=actor_id)
                    else:
                        idx = self.replay.add_batch(batch)
            else:  # explicit n-step transitions (vector envs)
                with tracing.span("ring_insert"):
                    idx = self.replay.add_batch(
                        {k: req[k] for k in
                         ("obs", "action", "reward", "next_obs",
                          "discount")})
            self.env_steps += n
            self.episodes += episodes
            self.returns.extend(ep_returns)
            # stamp AFTER the insert succeeded: a failed insert must
            # leave the seq unclaimed (the client is told via the
            # error dict; only a clean landing may absorb its retries)
            if seq >= 0 and actor_id >= 0:
                self._flush_seq[actor_id] = seq
            self._record_lineage(births, idx)
            self.flow.on_ingest(actor_id, n)
            credits = self.flow.grant(actor_id)
            total = self.env_steps
        self.telemetry.on_transitions(actor_id, n, req)
        # credits + published θ version ride every reply: the client's
        # token bucket and staleness guard get their inputs for free
        return {"ok": True, "env_steps": total, "credits": credits,
                "params_version": self._published_version(),
                **self._reply_stamps(t2)}

    @staticmethod
    def _reply_stamps(t2: float) -> dict[str, float]:
        """NTP reply stamps (server recv / reply built, server clock) for
        the client's skew estimator. Empty unless the request carried a
        send stamp — untraced peers get byte-identical replies."""
        if not t2:
            return {}
        return {tracing.KEY_RECV_AT: t2, tracing.KEY_DONE_AT: tracing.now()}

    def _record_lineage(self, births: np.ndarray | None, idx) -> None:
        """Map written ring slots → (birth stamp, env_steps at insert) for
        the learner's ``time_to_learn`` lookup. ``births`` arrives
        pre-parsed (float64, off-lock — off the lock); caller holds
        ``replay_lock`` for the stamp writes, which pair with the ring
        state. Only host replay tiers return slot indices from
        ``add_batch``; device/fused tiers fall back to the flush-level
        ``trace/ingest_lag_ms`` histogram in ``ServerTelemetry``."""
        if births is None or not isinstance(idx, np.ndarray):
            return
        slots = np.ravel(idx)
        if slots.size != births.size:
            # sequence batches write slots ≠ rows (overlapping windows);
            # a row→slot pairing would be wrong, so those tiers keep the
            # flush-level ingest-lag histogram only
            return
        pos = self.env_steps  # ddq: allow(locks.unguarded) — caller holds
        for slot, birth in zip(slots, births):
            self._lineage[int(slot)] = (float(birth), pos)  # ddq: allow(locks.unguarded)
        while len(self._lineage) > self.LINEAGE_CAP:  # ddq: allow(locks.unguarded)
            self._lineage.pop(next(iter(self._lineage)))  # ddq: allow(locks.unguarded)

    def lineage_ages(self, indices) -> np.ndarray:
        """Ages (seconds, server clock) of the lineage-stamped rows among
        the sampled ring slots ``indices`` — env-step birth to now, i.e.
        ``time_to_learn`` when called at gradient consumption. A mapping
        whose slot the ring has since wrapped past is dropped (that slot
        now holds a younger row than the stamp describes)."""
        if not tracing.ENABLED:
            return np.zeros(0, np.float64)
        now = tracing.now()
        ages = []
        with self.replay_lock:
            cap = int(getattr(self.replay, "capacity", 0) or 0)
            steps = self.env_steps
            for slot in np.ravel(np.asarray(indices)):
                ent = self._lineage.get(int(slot))
                if ent is None:
                    continue
                birth, pos = ent
                if cap and steps - pos >= cap:
                    self._lineage.pop(int(slot), None)
                    continue
                ages.append(max(now - birth, 0.0))
        return np.asarray(ages, np.float64)

    # -- telemetry ----------------------------------------------------------

    def telemetry_summary(self) -> dict[str, float]:
        """Flat scalar server-health view (histogram summaries + queue
        gauges), ready for ``Metrics.log(step, **summary)`` on the
        learner and for the ``stats`` RPC. Queue gauges cover replay
        fill, staged-but-unflushed rows (the ingest-OOM signal),
        and the fleet's params-version lag."""
        with self._params_lock:
            version = self._params_version
        out = self.telemetry.summary(params_version=version)
        with self.replay_lock:
            if self.replay is not None:
                out["queue/replay_size"] = len(self.replay)
                pending = getattr(self.replay, "pending_rows", None)
                if pending is not None:
                    out["queue/staged_rows"] = int(pending())
                # per-shard data plane: each multi-host
                # learner process serves exactly its hash-assigned actor
                # slice, so this server's replay IS the shard — expose
                # its fill, its ingest rate, and which host owns it (the
                # probe the linearity bench and ops dashboards key on).
                # 0 on a single-process replay
                out["shard/rows"] = len(self.replay)
                out["shard/owner_host"] = int(
                    getattr(self.replay, "_pid", 0))
        out["fleet/actors_seen"] = len(self.last_seen)
        if self._drain is not None:
            dc = self._drain.counters()
            out["ingest/drained_rows"] = dc["rows"]
            out["ingest/drain_flushes"] = dc["flushes"]
        fc = self.flow.counters()
        out["flow/degraded"] = fc["degraded"]
        out["flow/degraded_trips"] = fc["degraded_trips"]
        out["flow/shed_total"] = fc["shed_total"]
        out["flow/consume_rate"] = round(fc["consume_rate"], 3)
        out["flow/ingest_rate"] = round(fc["ingest_rate"], 3)
        # leading overload indicator (health plane): fraction of the
        # fleet pinned at/below the credit floor before any shed
        out["flow/credit_starvation"] = round(fc["credit_starvation"], 4)
        # shard-local ingest rate: with per-host data planes this equals
        # the flow-plane rate because nothing else feeds the shard
        out["shard/ingest_rate"] = round(fc["ingest_rate"], 3)
        if tracing.ENABLED:  # span-buffer/drop + clock-skew gauges
            out.update(tracing.counters())
        return out

    def health_scrape(self) -> dict[str, Any]:
        """Body of the ``health`` RPC verb (also callable in-process by
        the supervisor's ``FleetHealth``): sample the current telemetry
        summary + per-method latency snapshots into this server's
        monitor, evaluate the SLO/trend rules, and return the verdict
        as a flat wire dict (findings JSON-encoded — the protocol
        carries no nested structures)."""
        if not health.ENABLED:
            return health.verdict_to_wire(health.NULL_VERDICT)
        return self.health_monitor.scrape(
            gauges=self.telemetry_summary(),
            hists=self.telemetry.latency_snapshots())


def _takes_stream(replay) -> bool:
    import inspect
    try:
        return "stream" in inspect.signature(replay.add_batch).parameters
    except (TypeError, ValueError):
        return False


class ReplayFeedClient:
    """Actor-side stub: one persistent connection, blocking request/reply.

    Reconnects lazily after a network error: the failed call still raises
    (callers own the retry policy — e.g. the heartbeat thread backs off,
    the env loop treats it as fatal), but the broken socket is dropped so
    the NEXT call opens a clean connection instead of failing forever on
    a desynced stream."""

    def __init__(self, host: str, port: int, actor_id: int = 0,
                 timeout: float = 30.0):
        self.actor_id = int(actor_id)
        self._addr = (host, port)
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        with self._lock:
            self._connect()

    def _connect(self) -> None:
        # the conn mutex (self._lock) is HELD here by design: its whole
        # purpose is to serialize connect/request/reply on one socket —
        # no other state shares it, so nothing hot can queue behind it
        sock = socket.create_connection(  # ddq: allow(blocking.under-lock)
            self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = faultinject.wrap(sock, side="client")

    def rehost(self, host: str, port: int) -> None:
        """Point the stub at a new server address. The live socket (if
        any) is dropped so the NEXT call reconnects to the new address —
        a learner host changing address is just a reconnect, which is
        what makes consistent-hash actor→host assignment
        ride the existing resilience plane: the actor's HOST (hash slot)
        is stable, only its transport endpoint moves."""
        with self._lock:
            self._addr = (host, port)
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def call(self, method: str, **kwargs: Any) -> dict[str, Any]:
        with self._lock:
            if self._sock is None:
                tracing.instant("reconnect", method=method)
                self._connect()
            try:
                # wire I/O under the conn mutex is the mutex's job: one
                # request/reply in flight per socket (see _connect)
                send_msg(  # ddq: allow(blocking.under-lock) — conn mutex
                    self._sock, {"method": method,
                                 "actor_id": self.actor_id, **kwargs})
                return recv_msg(self._sock)  # ddq: allow(blocking.under-lock) — conn mutex
            except Exception:
                # ANY mid-frame failure — half-sent frame, decode desync
                # (recv_msg raises ValueError on bad kind/oversized
                # length), timeout — leaves the stream position unknown:
                # drop the socket so the next call reconnects cleanly
                # instead of misparsing the same bytes forever
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                raise

    def add_transitions(self, **batch: Any) -> dict[str, Any]:
        return self.call("add_transitions", **batch)

    def health(self) -> dict[str, Any]:
        """Scrape the server's health verdict (flat wire dict; decode
        with ``health.verdict_from_wire``)."""
        return self.call("health")

    def get_params(self, have_version: int = -1):
        """Returns (version, weights-or-None if unchanged/unpublished)."""
        resp = self.call("get_params", have_version=have_version)
        version = resp["version"]
        if "n" not in resp:
            return version, None
        return version, [resp[f"w{i}"] for i in range(resp["n"])]

    def close(self) -> None:
        try:
            if self._sock is not None:  # dropped after a failed call
                self._sock.close()
        except OSError:
            pass
