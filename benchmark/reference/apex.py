"""Plain reference of the ``apex`` learner: prioritized n-step dueling
Double DQN on a Nature-CNN torso (Horgan et al. 2018, Ape-X's learner).

It follows the program's first grad steps from the same inputs: the ring's
rows as the fill made them (``benchmark.data``), the same initial weights,
and the same sampling uniforms, worked out again here from the seed and
the step. One replay row is one frame with the action taken at it, the
reward after it and whether the episode ended there. A draw picks a row
∝ its priority among the rows whose stack and n-step window lie inside
their stream's written rows, and the transition is

- obs: the frames of steps t−3 .. t, each zeroed if an episode ended
  between it and t;
- the n-step return r_t + γ·r_{t+1} + γ²·r_{t+2}, cut at the first
  episode end, and the bootstrap discount γⁿ, or 0 after an episode end;
- next obs: the frames of t+n−3 .. t+n, zeroed likewise from t+n.

Each followed step is one Double-DQN step on 512 such transitions with
their IS weights (Schaul et al. 2016): Q(s) from θ, argmax over θ(s'),
bootstrap from θ⁻(s'), the weighted Huber loss, the global-norm clip and
the configuration's optimizer (Ape-X's centered RMSProp), then the row
priorities (|TD| + ε)^α. A dispatch draws every step's
batch from the priorities as they stood at its start.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import data
from benchmark.reference import common


def param_spec(cfg: dict) -> list:
    net = cfg["net"]
    hw = tuple(net["frame_shape"])
    return (common.torso_spec(net["stack"], hw)
            + common.head_spec(512, net["num_actions"]))


class Ring:
    """The rows the fill wrote, as the reference sees them: stream s's
    ``fill[s]`` rows at real rows ``s·slot_cap + t``; metadata on
    ``device``, frames made on demand."""

    def __init__(self, cfg: dict, seed: int, fill: list, device):
        rp = cfg["replay"]
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.streams = rp["num_streams"]
        self.slot_cap = rp["capacity"] // self.streams
        self.capacity = self.slot_cap * self.streams
        self.stack, self.n = cfg["net"]["stack"], rp["n_step"]
        self.hw = tuple(cfg["net"]["frame_shape"])
        self.row_len = self.hw[0] * self.hw[1]
        self.fill = list(fill)
        if max(self.fill) >= self.slot_cap:
            raise ValueError("the reference follows rings that have not "
                             "wrapped")
        act = np.zeros(self.capacity, np.int64)
        rew = np.zeros(self.capacity, np.float32)
        done = np.zeros(self.capacity, bool)
        valid = np.zeros(self.capacity, bool)
        for s, n in enumerate(self.fill):
            m = data.transition_meta(seed, s, 0, n,
                                     cfg["net"]["num_actions"],
                                     cfg["done_every"])
            base = s * self.slot_cap
            act[base:base + n] = m["action"]
            rew[base:base + n] = m["reward"]
            done[base:base + n] = m["done"]
            t = np.arange(n)
            valid[base:base + n] = (t >= self.stack - 1) & (t + self.n < n)
        dev = self.device
        self.action = torch.as_tensor(act, device=dev)
        self.reward = torch.as_tensor(rew, device=dev)
        self.done = torch.as_tensor(done, device=dev)
        self.valid = torch.as_tensor(valid, device=dev)
        self.n_live = self.valid.sum().float()

    def initial_priorities(self) -> torch.Tensor:
        """Fresh rows enter at the running maximum 1, to the α: 1."""
        prio = torch.zeros(self.capacity, device=self.device)
        for s, n in enumerate(self.fill):
            prio[s * self.slot_cap:s * self.slot_cap + n] = 1.0
        return prio

    def transitions(self, idx: torch.Tensor, gamma: float) -> dict:
        """The transitions anchored at real rows ``idx``."""
        s, t = idx // self.slot_cap, idx % self.slot_cap
        stack, n = self.stack, self.n
        off = torch.arange(-(stack - 1), n + 1, device=idx.device)
        rows = idx[:, None] + off[None, :]              # [B, stack + n]
        d = self.done[rows]
        ret = self.reward[idx].clone()
        cont = ~d[:, stack - 1]
        ended = d[:, stack - 1].clone()
        for k in range(1, n):
            ret = ret + self.reward[idx + k] * cont * (gamma ** k)
            ended = ended | (d[:, stack - 1 + k] & cont)
            cont = cont & ~d[:, stack - 1 + k]
        disc = torch.where(ended, torch.zeros_like(ret),
                           torch.full_like(ret, gamma ** n))

        def stack_valid(last):      # last: column of the anchor in rows
            bits = [torch.ones_like(cont)]
            for j in range(1, stack):
                bits.insert(0, bits[0] & ~d[:, last - j])
            return torch.stack(bits, dim=1)             # [B, stack]

        frames = data.frame_rows(
            self.seed, data.FRAMES, s[:, None].expand_as(rows).reshape(-1),
            (t[:, None] + off[None, :]).reshape(-1), self.row_len, xp=torch,
            device=idx.device).view(len(idx), stack + n, *self.hw)
        ov = stack_valid(stack - 1)[..., None, None].to(torch.uint8)
        nv = stack_valid(stack - 1 + n)[..., None, None].to(torch.uint8)
        return {"obs": frames[:, :stack] * ov,
                "next_obs": frames[:, n:n + stack] * nv,
                "action": self.action[idx], "reward": ret, "discount": disc}


def q_values(p: dict, frames: torch.Tensor, prec: str) -> torch.Tensor:
    return common.head(p, common.torso(p, frames, prec), prec)


def _loss(p: dict, tp: dict, batch: dict, weight: torch.Tensor,
          tcfg: dict, prec: str, fault: str | None = None):
    """The weighted Huber loss of one Double-DQN step and |TD|."""
    q = q_values(p, batch["obs"], prec)
    with torch.no_grad():
        a_star = q_values(p, batch["next_obs"], prec).argmax(dim=-1)
        q_next = q_values(tp, batch["next_obs"], prec)
        target = batch["reward"] + batch["discount"] * q_next.gather(
            -1, a_star[:, None])[:, 0]
    td = q.gather(-1, batch["action"][:, None].long())[:, 0] - target
    per = weight * common.huber(td, tcfg["huber_delta"])
    if fault == "half_batch":
        per = per[:len(per) // 2]
    return per.mean(), td.detach().abs()


class Model:
    """What ``common.follow`` needs of the ``apex`` learner."""

    def __init__(self, cfg: dict, seed: int, fill: list, device):
        self.ring = Ring(cfg, seed, fill, device)
        self.tcfg = cfg["train"]
        self.constants = cfg.get("optimizer_constants", {})
        self.p0 = data.make_weights(seed, param_spec(cfg), device)
        self.prio0 = self.ring.initial_priorities()
        self.valid = self.ring.valid
        self.n_live = self.ring.n_live

    def batch(self, idx):
        return self.ring.transitions(idx, self.tcfg["gamma"])

    def step(self, p, tp, opt, batch, w, prec, fault):
        return common.train_step(
            lambda: _loss(p, tp, batch, w, self.tcfg, prec, fault),
            p, tp, opt, fault)


def run(cfg: dict, seed: int, fill: list, device, plan: list,
        cand: dict | None = None, prec: str = "f32",
        fault: str | None = None) -> dict:
    """``common.follow`` over the ``apex`` learner's first dispatches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return common.follow(Model(cfg, seed, fill, device), seed,
                         cfg["replay"], plan, cand, prec, fault)
