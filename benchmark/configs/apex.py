"""The ``apex`` configuration, built: the program's Ape-X learner
(``Solver`` over a ``DevicePERFrameReplay``), its seeded weights, and its
ring filled through its actor streams from the seed. It also takes actor
ingest: the writers' rows, their landing, and the check that every row a
writer counted landed once, in its stream, with its bytes and metadata.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import data, system
from benchmark.reference import apex as reference


def fill_counts(cfg: dict) -> list:
    """Rows the fill writes into each stream: whole ``fill_chunk`` chunks,
    ``fill_rows`` split over the streams."""
    streams, chunk = cfg["replay"]["num_streams"], cfg["fill_chunk"]
    return [cfg["fill_rows"] // streams // chunk * chunk] * streams


class ApexSystem(system.System):
    supports_ingest = True

    def __init__(self, cfg: dict, seed: int, device):
        from distributed_deep_q_tpu_torch.replay.device_per import (
            DevicePERFrameReplay)
        from distributed_deep_q_tpu_torch.solver import Solver

        super().__init__(cfg, seed, device, reference)
        config = system.program_config(cfg, seed, device)
        self.solver = Solver(config, backend=config.mesh.backend)
        system.load_weights(self.solver.state, self.p0)
        net = cfg["net"]
        self.hw = tuple(net["frame_shape"])
        self.row_len = self.hw[0] * self.hw[1]
        self.streams = cfg["replay"]["num_streams"]
        self.replay = DevicePERFrameReplay(
            config.replay, self.solver.device, self.hw, stack=net["stack"],
            gamma=config.train.gamma, seed=seed,
            write_chunk=config.replay.write_chunk,
            num_streams=self.streams, num_shards=self.solver.num_shards,
            local_shards=self.solver.local_shards)
        # each stream's next time index
        self.next_t = [0] * self.streams

    # -- rows ----------------------------------------------------------------

    def rows(self, stream: int, t0: int, n: int, xp=np) -> dict:
        """Stream ``stream``'s rows ``t0 .. t0+n`` as an ``add_batch``
        payload (frames made on the device for the fill, on the host for a
        writer)."""
        frames = data.frame_rows(self.seed, data.FRAMES, stream,
                                 np.arange(t0, t0 + n) if xp is np
                                 else torch.arange(t0, t0 + n),
                                 self.row_len, xp=xp,
                                 device=None if xp is np else self.device)
        if xp is not np:
            frames = frames.cpu().numpy()
        m = data.transition_meta(self.seed, stream, t0, n,
                                 self.cfg["net"]["num_actions"],
                                 self.cfg["done_every"])
        return {"frame": frames.reshape(n, *self.hw), "action": m["action"],
                "reward": m["reward"], "done": m["done"]}

    def fill_ring(self) -> None:
        """``fill_rows`` rows, ``fill_chunk`` at a time, round robin over
        the streams, as actors would stream them in."""
        chunk = self.cfg["fill_chunk"]
        per = fill_counts(self.cfg)[0]
        for t0 in range(0, per, chunk):
            for s in range(self.streams):
                self.replay.add_batch(self.rows(s, t0, chunk, xp=torch),
                                      stream=s)
        self.replay.flush()
        self.fill = [per] * self.streams
        self.next_t = list(self.fill)

    def priorities(self) -> torch.Tensor:
        return self.replay.dstate["prio"]

    # -- ingest ---------------------------------------------------------------

    def start_ingest(self) -> None:
        self.replay.start_drain(self.lock)

    def stop_ingest(self) -> None:
        self.replay.stop_drain()

    def add(self, payload: dict, stream: int) -> None:
        self.replay.add_batch(payload, stream=stream)

    def write_event(self):
        return self.replay.write_event()

    def pending_rows(self) -> int:
        return self.replay.pending_rows()

    def landed_rows(self) -> int:
        """Rows the ring holds on the device side: every row added, less
        those still staged. Call under the writers' lock."""
        return (sum(self.replay.stream_rows(s) for s in range(self.streams))
                - self.replay.pending_rows())

    def stream_rows(self, stream: int) -> int:
        return self.replay.stream_rows(stream)

    @torch.no_grad()
    def rows_wrong(self, counted: list, first_t: list) -> int:
        """After the writers stopped and the last flush: the rows writer s
        counted, ``counted[s]`` from time ``first_t[s]``, that did not land
        once in stream s's slot with their bytes and metadata; and every
        row still staged."""
        rp, st = self.replay, self.replay.dstate
        wrong = rp.pending_rows()
        frames = st["frames"].view(-1, rp.rowb // 4)
        for s in range(self.streams):
            advance = rp.stream_rows(s) - first_t[s]
            wrong += abs(advance - counted[s])
            n = min(advance, counted[s])
            if first_t[s] + n > rp.slot_cap:
                raise ValueError("the ingest check reads rings that have "
                                 "not wrapped")
            for t0 in range(first_t[s], first_t[s] + n, 4096):
                t1 = min(t0 + 4096, first_t[s] + n)
                t = torch.arange(t0, t1, device=self.device)
                # stream s writes slot s: padded row s·slot_pad + t, real
                # row s·slot_cap + t (one shard)
                got = frames[s * rp.slot_pad + t].contiguous().view(
                    torch.uint8)[:, :self.row_len]
                want = data.frame_rows(self.seed, data.FRAMES, s, t,
                                       self.row_len, xp=torch,
                                       device=self.device)
                bad = (got != want).any(dim=1)
                m = data.transition_meta(self.seed, s, t0, t1 - t0,
                                         self.cfg["net"]["num_actions"],
                                         self.cfg["done_every"])
                real = s * rp.slot_cap + t
                for name, col in (("action", m["action"]),
                                  ("reward", m["reward"]),
                                  ("done", m["done"]),
                                  ("boundary", m["done"])):
                    want_c = torch.as_tensor(col, device=self.device)
                    bad |= st[name][real] != want_c.to(st[name].dtype)
                wrong += int(bad.sum())
        return int(wrong)


def build(cfg: dict, seed: int, device) -> ApexSystem:
    sys_ = ApexSystem(cfg, seed, device)
    sys_.fill_ring()
    return sys_
