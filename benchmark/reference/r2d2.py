"""Plain reference of the ``r2d2`` learner: recurrent Double DQN on
sequences with a stored-state burn-in and value rescaling (Kapturowski et
al. 2019), on the Nature-CNN torso with an LSTM of 512.

It follows the program's first grad steps from the same inputs: each
sequence's frame stream and metadata as ``benchmark.data`` made them for
the fill, the same initial weights and the same sampling uniforms, worked
out again here from the seed and the step. Sequence q sits in slot q. A
draw picks a sequence ∝ its priority, with IS weights ``(N·P)^−β`` over
their maximum. For a drawn sequence of T steps (burn-in b):

- obs[t] stacks the stream's frames t .. t+3, zeroed past its last valid
  step; the torso maps every obs to 512 features (bfloat16 in the
  configuration, float32 here);
- from the stored carry, each net's LSTM runs the first b steps without a
  gradient, then the train window;
- Q over the window from θ, bootstraps from θ⁻ at the action θ picks one
  step on, targets h(r + γ_t·h⁻¹(Q⁻)), the masked Huber loss per sequence
  over its valid steps, weighted and averaged;
- the global-norm clip (where the configuration sets one) and Adam,
  then each sequence's priority
  (η·max|TD| + (1−η)·mean|TD| + ε)^α.

Only the window's first T−b steps take a gradient: the last step's Q
serves the bootstrap alone.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import data
from benchmark.reference import common


def param_spec(cfg: dict) -> list:
    net = cfg["net"]
    hw = tuple(net["frame_shape"])
    h = net["lstm_size"]
    return (common.torso_spec(net["stack"], hw)
            + [("lstm.weight_ih", (4 * h, 512), 512),
               ("lstm.weight_hh", (4 * h, h), h),
               ("lstm.bias_hh", (4 * h,), 0)]
            + common.head_spec(h, net["num_actions"]))


def sequence(cfg: dict, seed: int, q: int) -> dict:
    """Sequence ``q``'s host metadata and its frame stream's times."""
    net, rp = cfg["net"], cfg["replay"]
    return data.sequence_meta(seed, q, rp["sequence_length"], rp["burn_in"],
                              net["num_actions"], net["lstm_size"],
                              cfg["train"]["gamma"], cfg["end_every"])


class Store:
    """The ``n`` sequences the fill wrote into the first slots of a replay
    of ``capacity``: metadata on ``device``, frames made on demand."""

    def __init__(self, cfg: dict, seed: int, n: int, device):
        rp, net = cfg["replay"], cfg["net"]
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.n, self.capacity = int(n), rp["sequences"]
        self.T, self.stack = rp["sequence_length"], net["stack"]
        self.W = (self.stack - 1) + self.T + 1
        self.hw = tuple(net["frame_shape"])
        metas = [sequence(cfg, seed, q) for q in range(self.n)]
        self.meta = {k: torch.as_tensor(np.stack([m[k] for m in metas]),
                                        device=self.device)
                     for k in metas[0]}

    def batch(self, idx: torch.Tensor) -> dict:
        b = len(idx)
        T, stack = self.T, self.stack
        out = {k: v[idx] for k, v in self.meta.items()}
        rows = torch.arange(self.W, device=idx.device)
        frames = data.frame_rows(
            self.seed, data.SEQ_FRAMES,
            idx[:, None].expand(b, self.W).reshape(-1),
            rows.repeat(b), self.hw[0] * self.hw[1], xp=torch,
            device=idx.device).view(b, self.W, *self.hw)
        obs = torch.stack([frames[:, j:j + T + 1] for j in range(stack)],
                          dim=2)                        # [b, T+1, S, H, W]
        n_valid = out["mask"].sum(dim=1)
        keep = torch.arange(T + 1, device=idx.device)[None, :] \
            <= n_valid[:, None]
        out["obs"] = obs * keep[..., None, None, None].to(torch.uint8)
        return out


def _features(p, obs, prec):
    """Torso over ``[b, t, S, H, W]`` → ``[b, t, 512]``."""
    b, t = obs.shape[:2]
    return common.torso(p, obs.reshape(b * t, *obs.shape[2:]),
                        prec).reshape(b, t, -1)


def _loss(p: dict, tp: dict, batch: dict, weight: torch.Tensor,
          cfg: dict, prec: str, lstm_prec: str, fault: str | None = None):
    """The R2D2 loss of one step, each sequence's priority, and the online
    Q over the training window."""
    tcfg, burn = cfg["train"], cfg["replay"]["burn_in"]
    obs, T = batch["obs"], cfg["replay"]["sequence_length"]
    carry0 = (batch["init_c"], batch["init_h"])
    with torch.no_grad():
        f_burn = _features(p, obs[:, :burn], prec)
        f_last = _features(p, obs[:, T:T + 1], prec)
        f_tg = _features(tp, obs, prec)
        c_on = common.lstm(p, f_burn, carry0, lstm_prec)[1]
        c_tg = common.lstm(tp, f_tg[:, :burn], carry0, lstm_prec)[1]
        h_tg, _ = common.lstm(tp, f_tg[:, burn:], c_tg, lstm_prec)
        q_tg = common.head(tp, h_tg, prec)[:, 1:]        # [b, T-burn, A]
    f_on = _features(p, obs[:, burn:T], prec)
    h_on, c_end = common.lstm(p, f_on, c_on, lstm_prec)
    q = common.head(p, h_on, prec)                      # [b, T-burn, A]
    with torch.no_grad():
        h_last, _ = common.lstm(p, f_last, (c_end[0].detach(),
                                            c_end[1].detach()), lstm_prec)
        q_on_next = torch.cat([q[:, 1:].detach(),
                               common.head(p, h_last, prec)], dim=1)
        a_star = q_on_next.argmax(dim=-1)
        q_sel = q_tg.gather(-1, a_star[..., None])[..., 0]
        rew, disc = batch["reward"][:, burn:], batch["discount"][:, burn:]
        if tcfg["value_rescale"]:
            target = common.value_rescale(
                rew + disc * common.value_rescale_inv(q_sel))
        else:
            target = rew + disc * q_sel
    mask = batch["mask"][:, burn:]
    td = (q.gather(-1, batch["action"][:, burn:, None].long())[..., 0]
          - target) * mask
    denom = torch.clamp(mask.sum(dim=1), min=1.0)
    per_seq = (common.huber(td, tcfg["huber_delta"]) * mask).sum(dim=1) \
        / denom
    per = weight * per_seq
    if fault == "half_batch":
        per = per[:len(per) // 2]
    a = td.detach().abs()
    eta = tcfg["priority_eta"]
    priority = eta * a.max(dim=1).values + (1.0 - eta) * a.sum(dim=1) / denom
    return per.mean(), priority


class Model:
    """What ``common.follow`` needs of the ``r2d2`` learner."""

    def __init__(self, cfg: dict, seed: int, n: int, device,
                 lstm_prec: str):
        self.cfg, self.lstm_prec = cfg, lstm_prec
        self.store = Store(cfg, seed, n, device)
        self.tcfg = cfg["train"]
        self.constants = cfg.get("optimizer_constants", {})
        self.p0 = data.make_weights(seed, param_spec(cfg), device)
        # fresh sequences enter at the running maximum 1, to the α: 1
        self.prio0 = torch.zeros(self.store.capacity,
                                 device=self.store.device)
        self.prio0[:self.store.n] = 1.0
        self.valid = (self.prio0 > 0).float()
        self.n_live = torch.tensor(float(self.store.n),
                                   device=self.store.device)

    def batch(self, idx):
        return self.store.batch(idx)

    def step(self, p, tp, opt, batch, w, prec, fault):
        return common.train_step(
            lambda: _loss(p, tp, batch, w, self.cfg, prec, self.lstm_prec,
                          fault), p, tp, opt, fault)


def run(cfg: dict, seed: int, fill, device, plan: list,
        cand: dict | None = None, prec: str = "f32",
        fault: str | None = None, lstm_prec: str = "f32") -> dict:
    """``common.follow`` over the ``r2d2`` learner's first dispatches
    (``fill``: the sequences filled, ``[n]``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return common.follow(Model(cfg, seed, fill[0], device, lstm_prec), seed,
                         cfg["replay"], plan, cand, prec, fault)
