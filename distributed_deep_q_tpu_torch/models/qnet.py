"""Q-network models in PyTorch — counterparts of the reference's Flax modules.

- ``MlpQNet``       — MLP for vector envs.
- ``NatureCnnQNet`` — Nature-DQN CNN: stack×84×84 → conv(32,8,4) →
  conv(64,4,2) → conv(64,3,1) → FC512 → FC|A|; optional dueling head.
- ``R2d2QNet``      — recurrent Q-net: Nature CNN or MLP torso → LSTM →
  (dueling) head over ``[B, T, ...]`` sequences.
- ``QNet``          — the numpy-facing wrapper the actors act with.

Layers follow Flax's ``dtype`` semantics: parameters stay float32 and each
layer casts its input, weight and bias to the compute dtype (``bfloat16``
for the Pong preset) before the op; Q-values come back in float32. uint8
pixels are normalized to [0, 1] inside the net.

Initialization matches Flax's defaults in distribution (not in bits):
lecun-normal weights (truncated normal, fan-in scaling) and zero biases, so
the optimizer dynamics resemble the reference's even without converted
weights (``convert.py`` brings exact reference weights over).

Layouts: torch convolutions are NCHW with OIHW weights; the public
``forward`` takes the reference's ``[B, H, W, stack]`` uint8 frames and
permutes them, while the fused train step feeds its gathered
``[B, stack, H, W]`` windows straight to ``forward_nchw``. The flatten before
``fc4`` is CHW here and HWC in the reference; ``convert.py`` permutes the
``fc4`` rows accordingly.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_deep_q_tpu_torch.config import NetConfig

# Flax's truncated-normal stddev correction for truncation at ±2σ
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _to_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast input to compute dtype; normalize uint8 pixels to [0, 1]."""
    if x.dtype == torch.uint8:
        return x.to(dtype) / 255.0
    return x.to(dtype)


class _Dense(nn.Module):
    """Flax ``nn.Dense`` twin: weight ``[out, in]`` (Flax keeps ``[in, out]``)."""

    def __init__(self, fan_in: int, features: int, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, fan_in))
        self.bias = nn.Parameter(torch.zeros(features))
        _lecun_normal_(self.weight.data, fan_in, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _Conv(nn.Module):
    """Flax ``nn.Conv`` (VALID padding) twin: weight OIHW (Flax keeps HWIO)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.dtype, self.stride = dtype, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        _lecun_normal_(self.weight.data, cin * kernel * kernel, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride)


class _Head(nn.Module):
    """Final Q head: plain FC|A| or dueling value/advantage streams."""

    def __init__(self, fan_in: int, num_actions: int, dueling: bool,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.dueling = dueling
        if dueling:
            self.value = _Dense(fan_in, 1, dtype, gen)
            self.advantage = _Dense(fan_in, num_actions, dtype, gen)
        else:
            self.q = _Dense(fan_in, num_actions, dtype, gen)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if not self.dueling:
            q = self.q(h)
        else:
            v = self.value(h)
            a = self.advantage(h)
            q = v + a - a.mean(dim=-1, keepdim=True)
        return q.float()  # Q-values / losses always in fp32


def conv_out_hw(frame_shape: tuple[int, int]) -> tuple[int, int]:
    """Spatial size of the Nature torso's conv3 output for ``frame_shape``
    (84×84 → 7×7, 52×52 → 3×3, 36×36 → 1×1)."""
    h, w = frame_shape
    for k, s in ((8, 4), (4, 2), (3, 1)):
        h, w = (h - k) // s + 1, (w - k) // s + 1
    return h, w


class _NatureTorso(nn.Module):
    """The Nature-DQN conv stack: NCHW frames → [B, 512]."""

    def __init__(self, stack: int, frame_shape: tuple[int, int],
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _Conv(stack, 32, 8, 4, dtype, gen)
        self.conv2 = _Conv(32, 64, 4, 2, dtype, gen)
        self.conv3 = _Conv(64, 64, 3, 1, dtype, gen)
        h3, w3 = conv_out_hw(frame_shape)
        self.fc4 = _Dense(64 * h3 * w3, 512, dtype, gen)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        h = _to_compute(frames, self.dtype)
        h = F.relu(self.conv1(h))
        h = F.relu(self.conv2(h))
        h = F.relu(self.conv3(h))
        return F.relu(self.fc4(h.flatten(1)))   # CHW flatten


class NatureCnnQNet(nn.Module):
    """Nature-DQN CNN Q-network (presets pong, breakout, apex)."""

    def __init__(self, num_actions: int, stack: int = 4,
                 frame_shape: tuple[int, int] = (84, 84),
                 dueling: bool = False, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.frame_shape = tuple(frame_shape)
        self.torso = _NatureTorso(stack, self.frame_shape, dtype, gen)
        self.head = _Head(512, num_actions, dueling, dtype, gen)

    def forward_nchw(self, frames: torch.Tensor) -> torch.Tensor:
        """Q-values for ``[B, stack, H, W]`` frames (the fused path's layout)."""
        return self.head(self.torso(frames))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """Q-values for ``[B, H, W, stack]`` frames, the reference layout."""
        return self.forward_nchw(frames.permute(0, 3, 1, 2))


class _MlpTorso(nn.ModuleDict):
    """Flat observation → ``relu(fc_i(...))`` features (the reference's
    ``MlpTorso``); layers ``fc0, fc1, ...``."""

    def __init__(self, obs_dim: int, hidden: Sequence[int],
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        fan_in = obs_dim
        for i, width in enumerate(hidden):
            self[f"fc{i}"] = _Dense(fan_in, width, dtype, gen)
            fan_in = width
        self.width = fan_in

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        h = _to_compute(obs.reshape(obs.shape[0], -1), self.dtype)
        for layer in self.values():
            h = F.relu(layer(h))
        return h


class MlpQNet(nn.Module):
    """MLP Q-network (CartPole preset)."""

    def __init__(self, num_actions: int, obs_dim: int,
                 hidden: Sequence[int] = (64, 64), dueling: bool = False,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.torso = _MlpTorso(obs_dim, hidden, dtype, gen)
        self.head = _Head(self.torso.width, num_actions, dueling, dtype, gen)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.torso(obs))

    def forward_nchw(self, frames: torch.Tensor) -> torch.Tensor:
        """``[B, stack, H, W]`` frames (the ring paths' layout), flattened
        in the reference's ``[B, H, W, stack]`` order."""
        return self.forward(frames.permute(0, 2, 3, 1))


def lstm_cell(x: torch.Tensor, carry, w_ih: torch.Tensor,
              w_hh: torch.Tensor, b_hh: torch.Tensor):
    """One step of Flax's ``OptimizedLSTMCell``, written out: the carry is
    ``(c, h)``, gates ``i, f, g, o`` in that order along ``4H``, each
    ``(h·W_h + b) + x·W_i`` (the input kernels have no bias), then
    ``c' = f·c + i·g`` and ``h' = o·tanh(c')``. The executable spec the
    tests hold ``R2d2QNet``'s LSTM to. Returns ``((c', h'), h')``."""
    c, h = carry
    dense_h = F.linear(h, w_hh, b_hh)
    dense_i = F.linear(x, w_ih)
    hi, hf, hg, ho = dense_h.chunk(4, dim=-1)
    ii, if_, ig, io = dense_i.chunk(4, dim=-1)
    i = torch.sigmoid(hi + ii)
    f = torch.sigmoid(hf + if_)
    g = torch.tanh(hg + ig)
    o = torch.sigmoid(ho + io)
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    return (new_c, new_h), new_h


class _Lstm(nn.Module):
    """Flax's ``OptimizedLSTMCell`` scanned over time, as PyTorch's LSTM
    (``torch.lstm``, cuDNN on the card) computes it, in float32. Torch's
    gate order is Flax's (i, f, g, o); Flax has no input bias, so
    ``bias_ih`` is a buffer of zeros, not a parameter. Parameters:
    ``weight_ih [4H, F]``, ``weight_hh [4H, H]``, ``bias_hh [4H]``."""

    def __init__(self, fan_in: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, fan_in))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))
        self.register_buffer("bias_ih", torch.zeros(4 * hidden))
        # Flax initializes each gate's kernel alone: lecun-normal input
        # kernels, orthogonal recurrent kernels
        _lecun_normal_(self.weight_ih.data, fan_in, gen)
        for block in self.weight_hh.data.chunk(4, dim=0):
            nn.init.orthogonal_(block, generator=gen)

    def forward(self, feats: torch.Tensor, carry):
        """``feats [B, T, F]`` float32, carry ``(c, h)`` each ``[B, H]`` →
        (outputs ``[B, T, H]``, carry ``(c, h)``)."""
        c, h = carry
        out, h_n, c_n = torch.lstm(
            feats, (h[None].contiguous(), c[None].contiguous()),
            (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh),
            True, 1, 0.0, self.training, False, True)
        return out, (c_n[0], h_n[0])


class R2d2QNet(nn.Module):
    """Recurrent Q-net over ``[B, T, ...]`` sequences (the reference's
    ``R2d2QNet`` and its ``r2d2_*`` helpers).

    The torso (Nature CNN or MLP, in the compute dtype) runs once over all
    ``B·T`` frames (``features``), then the LSTM in float32 (``burn_carry``
    advances the carry only; ``recur`` also applies the head, in the
    compute dtype). The carry is Flax's ``(c, h)``, each ``[B, H]``.

    Layouts: ``forward``/``features`` take the reference's observations
    (``[B, T, H, W, stack]`` uint8 frames, or ``[B, T, ...]`` vectors for
    the MLP torso); ``features_stacked`` takes the sequence ring's
    ``[B, T, stack, H·W]`` planes and hands them to the CNN as NCHW.
    Parameter names: ``torso.*`` (``torso.fc{i}`` for the MLP),
    ``lstm.{weight_ih, weight_hh, bias_hh}``, ``head.*``.
    """

    def __init__(self, num_actions: int, lstm_size: int = 512,
                 torso: str = "nature_cnn", hidden: Sequence[int] = (64, 64),
                 dueling: bool = True, stack: int = 4,
                 frame_shape: tuple[int, int] = (84, 84), obs_dim: int = 4,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.lstm_size = int(lstm_size)
        self.num_actions = int(num_actions)
        self.frame_shape = tuple(frame_shape)
        self.cnn = torso == "nature_cnn"
        if self.cnn:
            self.torso = _NatureTorso(stack, self.frame_shape, dtype, gen)
            fan_in = 512
        elif torso == "mlp":
            self.torso = _MlpTorso(obs_dim, tuple(hidden), dtype, gen)
            fan_in = self.torso.width
        else:
            raise ValueError(f"unknown r2d2 torso: {torso!r}")
        self.lstm = _Lstm(fan_in, self.lstm_size, gen)
        self.head = _Head(self.lstm_size, num_actions, dueling, dtype, gen)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        """``[B, T, ...]`` observations in the reference's layout → ``[B, T,
        F]`` float32 features, the torso applied once over ``B·T``."""
        b, t = obs.shape[:2]
        flat = obs.reshape((b * t,) + obs.shape[2:])
        if self.cnn:
            flat = flat.permute(0, 3, 1, 2)            # NHWC → NCHW
        return self.torso(flat).reshape(b, t, -1).float()

    def features_stacked(self, planes: torch.Tensor) -> torch.Tensor:
        """``[B, T, stack, H·W]`` uint8 planes (``compose_sequence_block``)
        → ``[B, T, F]`` float32 features."""
        b, t, stack = planes.shape[:3]
        flat = planes.reshape(b * t, stack, *self.frame_shape)
        if not self.cnn:
            flat = flat.permute(0, 2, 3, 1)            # the MLP reads HWC
        return self.torso(flat).reshape(b, t, -1).float()

    def burn_carry(self, feats: torch.Tensor, carry):
        """Advance the carry over ``[B, T, F]`` features (no Q)."""
        return self.lstm(feats, carry)[1]

    def recur(self, feats: torch.Tensor, carry):
        """LSTM + head over ``[B, T, F]`` features → (q ``[B, T, A]``,
        carry)."""
        b, t = feats.shape[:2]
        hs, carry = self.lstm(feats, carry)
        q = self.head(hs.reshape(b * t, -1))
        return q.reshape(b, t, self.num_actions), carry

    def forward(self, obs: torch.Tensor, carry):
        """(q ``[B, T, A]``, final carry) for ``[B, T, ...]`` observations."""
        return self.recur(self.features(obs), carry)


def build_qnet(cfg: NetConfig, obs_dim: int = 4, seed: int = 0) -> nn.Module:
    """The net ``cfg`` describes, on the CPU (move it with ``.to``)."""
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.kind == "mlp":
        return MlpQNet(cfg.num_actions, obs_dim, tuple(cfg.hidden),
                       cfg.dueling, dtype, seed)
    if cfg.kind == "nature_cnn":
        return NatureCnnQNet(cfg.num_actions, cfg.stack,
                             tuple(cfg.frame_shape), cfg.dueling, dtype, seed)
    if cfg.kind == "r2d2":
        return R2d2QNet(cfg.num_actions, cfg.lstm_size, cfg.torso,
                        tuple(cfg.hidden), cfg.dueling, cfg.stack,
                        tuple(cfg.frame_shape), obs_dim, dtype, seed)
    raise ValueError(f"unknown net kind: {cfg.kind!r}")


class QNet:
    """The reference's numpy-facing net wrapper (its ``models/qnet.py``
    ``QNet``): what the actors act with and what θ crosses the wire into.

    Holds the ``nn.Module`` that ``build_qnet`` makes, on the CPU unless the
    caller names a device, in eval mode. Numpy in, numpy out; every forward
    runs under ``torch.inference_mode()``.

    - ``forward(obs)`` — Q-values for a batch (a batch axis is added when
      ``obs`` is one observation, and dropped again); for r2d2,
      ``forward(obs [B, T, ...], carry)`` → ``(q [B, T, A], carry)`` with
      the carry ``(c, h)``, each ``[B, H]``, in the order the reference's
      Flax LSTM carry has;
    - ``argmax_action(obs)``, ``initial_state(batch_size)``;
    - ``get_weights()`` / ``set_weights(leaves)`` — θ as the reference's
      Flax leaves in ``jax.tree_util.tree_leaves`` order and layouts (the θ
      wire, ``convert.flax_leaves``); ``num_params()``.
    """

    def __init__(self, cfg: NetConfig, seed: int = 0, obs_dim: int = 4,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.module = build_qnet(cfg, obs_dim, seed).to(self.device).eval()
        self._frame_shape = tuple(cfg.frame_shape)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- forward -----------------------------------------------------------

    @torch.inference_mode()
    def forward(self, obs: np.ndarray, carry=None):
        """Q-values (numpy) for a batch of observations; r2d2 also takes
        and returns the carry (see the class docstring)."""
        obs = np.asarray(obs)
        if self.cfg.kind == "r2d2":
            if carry is None:
                carry = self.initial_state(obs.shape[0])
            q, (c, h) = self.module(
                self._tensor(obs), (self._tensor(carry[0]),
                                    self._tensor(carry[1])))
            return q.cpu().numpy(), (c.cpu().numpy(), h.cpu().numpy())
        expected = 2 if self.cfg.kind == "mlp" else 4
        squeeze = obs.ndim == expected - 1
        if squeeze:
            obs = obs[None]
        q = self.module(self._tensor(obs)).cpu().numpy()
        return q[0] if squeeze else q

    def argmax_action(self, obs: np.ndarray) -> int:
        return int(np.argmax(self.forward(obs)))

    def initial_state(self, batch_size: int):
        """The zero carry ``(c, h)``, each ``[batch_size, lstm_size]``."""
        assert self.cfg.kind == "r2d2"
        z = np.zeros((batch_size, self.cfg.lstm_size), np.float32)
        return (z, z.copy())

    # -- weight IO (numpy; the θ wire) --------------------------------------

    def get_weights(self) -> list[np.ndarray]:
        from distributed_deep_q_tpu_torch.convert import flax_leaves
        return flax_leaves(self.module, self._frame_shape)

    def set_weights(self, flat: list[np.ndarray]) -> None:
        from distributed_deep_q_tpu_torch.convert import load_flax_leaves
        load_flax_leaves(self.module, flat, self._frame_shape)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())
