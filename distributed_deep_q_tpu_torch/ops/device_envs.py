"""The synthetic pixel envs as batched tensor programs — the Anakin acting
substrate (port of the reference ``ops/jax_envs.py``).

``actors/game.py``'s ``SignalAtari`` / ``VelocitySignalAtari`` step
functions over a leading env axis, so acting runs on the card beside the
learner with no host round trip. Semantics follow the reference's JAX envs
op for op: background 20 / band 220, the reward keyed on the target BEFORE
the step, the returned frame rendered from the target after it, and the
auto-reset folded into ``step`` (both draws are made and ``done`` selects).
The RNG is ``ops/threefry.py``, bitwise jax's, so a port env and a
reference env fed the same keys give the same frames; like the
reference's, it is its own stream and not the numpy envs' Philox one.

Every env is a ``(reset_fn, step_fn)`` pair over a dict-of-tensors state
with a leading env axis:
``reset_fn(keys [n, 2]) -> (state, frames [n, H, W] u8)``,
``step_fn(state, action [n]) -> (state, frames, reward f32 [n],
done bool [n])``.
"""

from __future__ import annotations

import torch

from distributed_deep_q_tpu_torch.ops import threefry


def _band_frames(frame_shape, orientation: str, lo: torch.Tensor,
                 width: int) -> torch.Tensor:
    """``[n, H, W]`` u8 frames: background 20, one band of 220 covering
    axis positions ``[lo, lo+width)`` (mod the axis length) — vertical
    bands are column ranges, horizontal ones row ranges."""
    h, w = frame_shape
    axis = w if orientation == "v" else h
    pos = torch.arange(axis, dtype=torch.int64, device=lo.device)
    mask = ((pos[None, :] - lo.long()[:, None]) % axis) < width
    band = torch.where(mask, 220, 20).to(torch.uint8)        # [n, axis]
    if orientation == "v":
        return band[:, None, :].expand(-1, h, w)
    return band[:, :, None].expand(-1, h, w)


def make_signal_env(frame_shape=(84, 84), num_actions: int = 4,
                    episode_len: int = 32, orientation: str = "v"):
    """``SignalAtari``: a static band at ``target · band_width``; the target
    is drawn again EVERY step, so the reward needs the current frame."""
    h, w = frame_shape
    axis = w if orientation == "v" else h
    band = max(axis // num_actions, 1)

    def render(target):
        return _band_frames(frame_shape, orientation, target * band, band)

    def reset_fn(keys):
        k = threefry.split(keys, 2)
        target = threefry.randint(k[:, 1], 0, num_actions)
        state = {"t": torch.zeros_like(target), "target": target,
                 "key": k[:, 0]}
        return state, render(target)

    def step_fn(state, action):
        k = threefry.split(state["key"], 3)
        reward = (action == state["target"]).float()
        t = state["t"] + 1
        done = t >= episode_len
        # the numpy caller steps (one draw) then, on done, resets (another
        # draw); both draws happen here and done selects
        target = torch.where(done, threefry.randint(k[:, 2], 0, num_actions),
                             threefry.randint(k[:, 1], 0, num_actions))
        t = torch.where(done, torch.zeros_like(t), t)
        state = {"t": t, "target": target, "key": k[:, 0]}
        return state, render(target), reward, done

    return reset_fn, step_fn


def make_velocity_signal_env(frame_shape=(84, 84), num_actions: int = 4,
                             episode_len: int = 32, orientation: str = "v",
                             segment: int = 8):
    """``VelocitySignalAtari``: a band MOVES at one of ``num_actions``
    signed velocities; the velocity index is the right action, so the
    policy must read ≥ 2 frames. ``segment=0`` holds the velocity for the
    whole episode (the memory-gate tier)."""
    h, w = frame_shape
    axis = w if orientation == "v" else h
    seg = int(segment) if segment else episode_len + 1
    band_width = max(3, axis // 8)
    unit = max(2, axis // 16)
    half = num_actions // 2
    units = list(range(-half, 0)) + list(range(1, num_actions - half + 1))
    vel = [unit * m for m in units]
    tables: dict = {}      # the velocity table, once per device

    def velocities(device):
        if device not in tables:
            tables[device] = torch.tensor(vel, dtype=torch.int32,  # ddq: allow(purity.captured-write) — per-device constant cache, filled on the first call: fill it before a capture (ROADMAP item 8)
                                          device=device)
        return tables[device]

    def render(pos):
        return _band_frames(frame_shape, orientation, pos, band_width)

    def _redraw(kv, kp):
        # numpy order: velocity index first, then position
        return (threefry.randint(kv, 0, num_actions),
                threefry.randint(kp, 0, axis))

    def reset_fn(keys):
        k = threefry.split(keys, 3)
        v_idx, pos = _redraw(k[:, 1], k[:, 2])
        state = {"t": torch.zeros_like(v_idx), "v_idx": v_idx, "pos": pos,
                 "key": k[:, 0]}
        return state, render(pos)

    def step_fn(state, action):
        k = threefry.split(state["key"], 5)
        reward = (action == state["v_idx"]).float()
        t = state["t"] + 1
        redraw = (t % seg) == 0
        v_draw, p_draw = _redraw(k[:, 1], k[:, 2])
        step_v = velocities(state["pos"].device)[state["v_idx"].long()]
        advanced = (state["pos"] + step_v) % axis
        v_idx = torch.where(redraw, v_draw, state["v_idx"])
        pos = torch.where(redraw, p_draw, advanced)
        done = t >= episode_len
        v_reset, p_reset = _redraw(k[:, 3], k[:, 4])
        v_idx = torch.where(done, v_reset, v_idx)
        pos = torch.where(done, p_reset, pos)
        t = torch.where(done, torch.zeros_like(t), t)
        state = {"t": t, "v_idx": v_idx, "pos": pos, "key": k[:, 0]}
        return state, render(pos), reward, done

    return reset_fn, step_fn


def make_device_env(cfg):
    """``make_env``'s dispatch for the kinds with a tensor port.

    ``cfg`` is an ``EnvConfig`` with ``kind == "signal_atari"``; id
    suffixes select as the numpy dispatcher does ("-h" horizontal, "-vel"
    velocity, "-ep" whole-episode velocity hold).
    """
    if cfg.kind != "signal_atari":
        raise ValueError(
            f"no JAX port for env kind {cfg.kind!r} — Anakin covers the "
            "signal_atari family; other envs act through the vectorized "
            "or per-env host loops")
    orientation = "h" if cfg.id.endswith("-h") else "v"
    if "-vel" in cfg.id:
        return make_velocity_signal_env(
            frame_shape=tuple(cfg.frame_shape), orientation=orientation,
            segment=0 if "-ep" in cfg.id else 8)
    return make_signal_env(frame_shape=tuple(cfg.frame_shape),
                           orientation=orientation)
