"""The ``r2d2`` configuration, built: the program's R2D2 learner
(``SequenceSolver`` over a ``DeviceSequenceReplay``), its seeded weights,
and its sequence replay filled from the seed: sequence q's frame stream and
metadata as ``benchmark.data`` makes them, handed over stacked, as an
actor's ``SequenceBuilder`` hands them.
"""

from __future__ import annotations

import torch
from numpy.lib.stride_tricks import sliding_window_view

from benchmark import data, system
from benchmark.reference import r2d2 as reference


def fill_counts(cfg: dict) -> list:
    """The fill writes ``fill_sequences`` sequences into the first slots
    of a replay that holds ``replay.sequences``."""
    return [min(cfg["fill_sequences"], cfg["replay"]["sequences"])]


class R2d2System(system.System):

    def __init__(self, cfg: dict, seed: int, device):
        from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
            SequenceSolver)
        from distributed_deep_q_tpu_torch.replay.device_sequence import (
            DeviceSequenceReplay)

        super().__init__(cfg, seed, device, reference)
        config = system.program_config(cfg, seed, device)
        net, rp = cfg["net"], cfg["replay"]
        self.hw = tuple(net["frame_shape"])
        self.solver = SequenceSolver(config, obs_dim=self.hw[0] * self.hw[1],
                                     backend=config.mesh.backend)
        system.load_weights(self.solver.state, self.p0)
        self.replay = DeviceSequenceReplay(
            rp["sequences"], rp["sequence_length"], self.hw + (net["stack"],),
            self.solver.device, net["lstm_size"],
            alpha=rp["priority_alpha"], beta0=rp["priority_beta0"],
            beta_steps=rp["priority_beta_steps"], eps=rp["priority_eps"],
            seed=seed, write_chunk=rp["write_chunk"])

    def fill_ring(self, block: int = 64) -> None:
        """``fill_counts`` sequences, ``block`` streams made on the device
        at a time."""
        rp, stack = self.cfg["replay"], self.cfg["net"]["stack"]
        n, W = fill_counts(self.cfg)[0], (stack - 1) + rp["sequence_length"] + 1
        row_len = self.hw[0] * self.hw[1]
        for q0 in range(0, n, block):
            q = torch.arange(q0, min(q0 + block, n), device=self.device)
            rows = torch.arange(W, device=self.device)
            streams = data.frame_rows(
                self.seed, data.SEQ_FRAMES,
                q[:, None].expand(len(q), W).reshape(-1), rows.repeat(len(q)),
                row_len, xp=torch, device=self.device).view(
                    len(q), W, *self.hw).cpu().numpy()
            for j, qq in enumerate(range(q0, q0 + len(q))):
                seq = reference.sequence(self.cfg, self.seed, qq)
                # obs[t][..., i] = stream row t + i
                seq["obs"] = sliding_window_view(streams[j], stack, axis=0)
                self.replay.add_sequence(seq)
        self.replay.flush()
        self.fill = [n]

    def priorities(self) -> torch.Tensor:
        return self.replay.dmeta["prio"]


def build(cfg: dict, seed: int, device) -> R2d2System:
    sys_ = R2d2System(cfg, seed, device)
    sys_.fill_ring()
    return sys_
