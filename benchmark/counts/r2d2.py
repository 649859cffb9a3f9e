"""Operations and bytes of the ``r2d2`` learner, from its shapes alone.

One grad step on B sequences of T steps with a burn-in of b (T + 1
observations each; the last serves the bootstrap only). Multiply-adds:

- the torso (bfloat16), M_t = 9,342,976 a frame (conv1 3,276,800, conv2
  2,654,208, conv3 1,806,336, fc4 1,605,632): θ and θ⁻ forward over all
  T + 1 frames, and the backward over the T − b trained frames, weight
  gradients and input gradients but conv1's: (2(T+1)M_t + (T−b)(2M_t −
  conv1))·B;
- the LSTM (float32, H = 512 over 512 features), M_l = 4H·512 + 4H·H =
  2,097,152 a step: each net over T + 1 steps, and the backward over the
  T − b trained steps, weight and input gradients of both matmuls except
  the first step's carry, which takes none: (2(T+1)M_l + (T−b)·2M_l −
  4H·H)·B;
- the dueling head (bfloat16), M_h = H(1 + A): θ over the T − b + 1
  window steps, θ⁻ over the same, the backward's weight and input
  gradients over the T − b trained steps: (2(T−b+1) + 2(T−b))·M_h·B.

At B = 64, T = 80, b = 40, A = 18: 272.8 GFLOP in bfloat16 and 64.8 GFLOP
in float32 a step.

Bytes of B1 (``gather_windows``) per dispatch: chain × B windows of
(stack − 1) + T + 1 frames of H·W pixel bytes, read once and written once.
"""

from __future__ import annotations

from benchmark.counts.apex import _macs


def flops_per_step(cfg: dict) -> dict:
    net, rp = cfg["net"], cfg["replay"]
    B, T, b = rp["batch_size"], rp["sequence_length"], rp["burn_in"]
    H, A = net["lstm_size"], net["num_actions"]
    m_all, conv1 = _macs(tuple(net["frame_shape"]), net["stack"], A)
    m_t = m_all - 512 * (1 + A)
    m_h = H * (1 + A)
    m_l = 4 * H * 512 + 4 * H * H
    tr = T - b
    torso = 2 * (T + 1) * m_t + tr * (2 * m_t - conv1)
    head = (2 * (tr + 1) + 2 * tr) * m_h
    lstm = 2 * (T + 1) * m_l + tr * 2 * m_l - 4 * H * H
    return {"bf16": 2.0 * B * (torso + head), "fp32": 2.0 * B * lstm}


def gather_bytes(cfg: dict, chain: int) -> float:
    net, rp = cfg["net"], cfg["replay"]
    h, w = net["frame_shape"]
    rows = (net["stack"] - 1) + rp["sequence_length"] + 1
    return 2.0 * chain * rp["batch_size"] * rows * h * w


def scatter_bytes_per_row(cfg: dict) -> float:
    h, w = cfg["net"]["frame_shape"]
    return 2.0 * h * w
