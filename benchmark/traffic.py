"""The one traffic generator: a mix (``mixes/<name>.json``) is data it
reads.

The learner's dispatch is driven back to back through the program's own
``FusedStepStream``, as its train loop drives it, one grad step's metrics
at a time. A mix with an ``ingest`` section adds actor writers:
``writers`` threads, writer i streaming chunks of ``chunk_rows`` rows
(made from the seed) into ring stream i, paced together to
``offered_per_s`` transitions/s through the ring's ``IngestDrain``, each
chunk added under the program's replay lock (a ``threading.RLock``, as
the ``ReplayFeedServer``'s serve threads add under theirs), which the
stream's dispatch holds too. Pacing debt is forgiven (a writer held up
re-anchors instead of bursting), a writer waits while more than
``staged_cap_rows`` rows are staged, and every ``event_every``-th chunk
it waits for the ring writes enqueued so far to complete on the card.

The window opens and closes on a fence (the step counter read to the
host). Set-up runs ``warmup_dispatches`` of the window's dispatch first
and, under ingest, ``settle_s`` seconds of it with the writers running.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from benchmark.trace import Stretch


class Writers:
    """The paced actor writers of an ``ingest`` section."""

    def __init__(self, system, ingest: dict):
        self.system, self.lock = system, system.lock
        self.n = int(ingest["writers"])
        self.chunk = int(ingest["chunk_rows"])
        self.cap = int(ingest["staged_cap_rows"])
        self.every = int(ingest["event_every"])
        self.interval = self.chunk * self.n / float(ingest["offered_per_s"])
        if self.n > system.streams:
            raise ValueError(f"{self.n} writers need as many ring streams "
                             f"(the configuration has {system.streams})")
        self.stop_ev = threading.Event()
        self.first_t = list(system.next_t[:self.n])
        self.counted = [0] * self.n
        # per chunk: (stream, due, sent, rows staged by then), in lock order
        self.chunks: list = []
        self.staged = 0
        self.errors: list = []
        self._threads: list = []

    def start(self) -> None:
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          name=f"bench-writer-{i}",
                                          daemon=True)
                         for i in range(self.n)]
        for th in self._threads:
            th.start()

    def stop(self) -> None:
        self.stop_ev.set()
        for th in self._threads:
            th.join(timeout=60.0)
        if any(th.is_alive() for th in self._threads):
            raise RuntimeError("a writer did not stop")
        if self.errors:
            raise RuntimeError("a writer failed") from self.errors[0]

    def _run(self, stream: int) -> None:
        try:
            self._loop(stream)
        except BaseException as e:  # surfaced by stop()
            self.errors.append(e)

    def _loop(self, stream: int) -> None:
        sysm, k = self.system, 0
        t = self.first_t[stream]
        due = time.perf_counter()
        while not self.stop_ev.is_set():
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            while sysm.pending_rows() > self.cap and not self.stop_ev.is_set():
                time.sleep(0.005)
            payload = sysm.rows(stream, t, self.chunk)
            ev = None
            with self.lock:
                sysm.add(payload, stream)
                self.staged += self.chunk
                self.chunks.append((stream, due, time.perf_counter(),
                                    self.staged))
                if k % self.every == self.every - 1:
                    ev = sysm.write_event()
            if ev is not None:
                ev.synchronize()
            self.counted[stream] += self.chunk
            t += self.chunk
            k += 1
            due = max(due + self.interval, time.perf_counter())


class Outcome:
    """What a run measured, for the metrics and their readers."""

    def __init__(self):
        self.window_s = 0.0
        self.steps = 0
        self.dispatches = 0
        self.losses: list = []
        self.dispatch_s: list = []      # host s of each dispatching call
        self.lock_hold_s: list = []     # the learner's hold of the lock
        self.spans: list = []           # the learner's (name, t0, t1)
        self.t_open = self.t_close = 0.0
        self.landed = (0, 0)            # ring rows at the fences
        self.writers: Writers | None = None
        self.flushes: list = []         # (time, rows landed since start)
        self.stretch: Stretch | None = None
        self.stretch_landed = (0, 0)
        self.outside = (0, 0.0)         # steps and seconds off the stretch
        self.setup_end = 0.0


def _landed(system) -> int:
    with system.lock.inner:
        return system.landed_rows()


def run(system, mix: dict, seconds: float, traced: bool) -> Outcome:
    """Warm up, settle, and measure one window of ``seconds``."""
    out = Outcome()
    ingest = mix.get("ingest")
    if ingest and not system.supports_ingest:
        raise ValueError(f"configuration {system.cfg['name']} takes no "
                         "actor ingest")
    for _ in range(int(system.cfg["warmup_dispatches"])):
        system.dispatch()
    system.steps()
    writers = None
    if ingest:
        system.start_ingest()
        writers = out.writers = Writers(system, ingest)
        base = _landed(system)
        if traced:
            _watch_flushes(system, out, base)
        writers.start()
        end = time.perf_counter() + float(ingest["settle_s"])
        while time.perf_counter() < end:
            system.dispatch()
        system.steps()
    # the profiler traces the card (a run on the CPU, in the tests, has no
    # stretch, and the readers of device metrics find nothing to read).
    # The stretch closes a traced window: what the per-layer metrics read
    # on the host clock comes from before it, untouched by the profiler
    stretch_at = (0.75 * seconds if traced and system.device.type == "cuda"
                  else None)
    try:
        out.setup_end = time.perf_counter()
        s0 = system.steps()
        t0 = out.t_open = time.perf_counter()
        if ingest:
            out.landed = (_landed(system), 0)
        while time.perf_counter() - t0 < seconds:
            if stretch_at is not None and \
                    time.perf_counter() - t0 >= stretch_at:
                out.outside = (system.steps() - s0, time.perf_counter() - t0)
                out.stretch = _stretch(system, out,
                                       int(mix.get("trace_dispatches", 4)))
                break
            _one(system, out)
        s_end = system.steps()
        out.t_close = time.perf_counter()
        if ingest:
            out.landed = (out.landed[0], _landed(system))
    finally:
        if writers is not None:
            writers.stop()
            system.stop_ingest()
    if out.stretch is not None:
        # the slow export runs once the writers have stopped and their
        # last rows landed, so no chunk waits on it
        out.stretch.collect()
    out.window_s = out.t_close - t0
    out.steps = s_end - s0
    if out.stretch is None:
        out.outside = (out.steps, out.window_s)
    if out.steps != out.dispatches * system.chain:
        raise RuntimeError(f"{out.dispatches} dispatches of chain "
                           f"{system.chain} advanced the step counter by "
                           f"{out.steps}")
    return out


def _one(system, out: Outcome) -> None:
    """One dispatch through the stream, and the chain's per-step rows.
    The host time of the dispatching call is kept net of the wait for the
    replay lock, whose hold the lock itself timed."""
    t_ask = time.perf_counter()
    secs, losses = system.dispatch()
    t_end = time.perf_counter()
    wait = 0.0
    if system.lock is not None:
        asked, got, released = system.lock.holds[-1]
        wait = got - asked
        out.lock_hold_s.append(released - got)
        out.spans += [("lock_wait", asked, got), ("dispatch", got, released),
                      ("steps", released, t_end)]
    else:
        out.spans += [("dispatch", t_ask, t_ask + secs),
                      ("steps", t_ask + secs, t_end)]
    out.losses += losses
    out.dispatches += 1
    out.dispatch_s.append(secs - wait)


def _stretch(system, out: Outcome, n: int) -> Stretch:
    """``n`` dispatches under the profiler. Their steps count in the
    window; their host times do not."""
    st = Stretch()
    lock = system.lock
    with (lock.inner if lock is not None else contextlib.nullcontext()):
        st.start()
        if lock is not None:
            out.stretch_landed = (system.landed_rows(), 0)
    keep = (list(out.dispatch_s), list(out.lock_hold_s))
    out.spans = []
    for _ in range(n):
        _one(system, out)
    with (lock.inner if lock is not None else contextlib.nullcontext()):
        st.close()
        if lock is not None:
            out.stretch_landed = (out.stretch_landed[0],
                                  system.landed_rows())
    out.dispatch_s, out.lock_hold_s = keep
    return st


def _watch_flushes(system, out: Outcome, base: int) -> None:
    """Record when each flush of the ring returns and how many writer rows
    have landed by then (a flush runs under the replay lock)."""
    replay = system.replay
    flush = replay.flush

    def timed_flush():
        flush()
        out.flushes.append((time.perf_counter(),
                            system.landed_rows() - base))

    replay.flush = timed_flush


def chunk_latencies(out: Outcome) -> list:
    """Seconds from each window chunk's due time to the return of the
    flush that landed its last row, for the chunks sent before a traced
    stretch."""
    w, fl = out.writers, out.flushes
    if w is None or not fl:
        return []
    until = out.stretch.t0 if out.stretch is not None else out.t_close
    lat, j = [], 0
    for _, due, sent, pos in sorted(w.chunks, key=lambda c: c[3]):
        while j < len(fl) and fl[j][1] < pos:
            j += 1
        if j == len(fl):
            break
        if out.t_open <= sent <= until:
            lat.append(fl[j][0] - due)
    return lat


def window_chunks(out: Outcome) -> int:
    w = out.writers
    if w is None:
        return 0
    return sum(1 for c in w.chunks if out.t_open <= c[2] <= out.t_close)


def nonfinite_steps(out: Outcome) -> int:
    if not out.losses:
        return 0
    return int((~torch.isfinite(torch.stack(out.losses))).sum())
