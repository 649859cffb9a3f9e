"""Seeded inputs of the benchmark: frames, transition metadata, sequences
and initial weights, each a pure function of ``--seed`` and an index.

Every value comes from a counter hash (``mix``, the "lowbias32" integer
finalizer) of (seed, purpose, stream or sequence, time, word), so any row
can be made again anywhere from its coordinates: the fill and the writers
make rows for the program, the plain reference makes the rows it drew,
and the ingest check makes the rows that should have landed. The hash is
integer arithmetic on int64 holding uint32 words, so numpy on the host and
torch on either device give the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
# purpose tags: each stream of values hashes under its own key
FRAMES, META, SEQ_FRAMES, SEQ_META, WEIGHTS = 1, 2, 3, 4, 5


def mix(x):
    """The lowbias32 finalizer on int64 values holding uint32 words (numpy
    arrays, torch tensors or Python ints alike)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def key(seed: int, *tags: int) -> int:
    """A 32-bit key for ``seed`` (any non-negative int, 64 bits are read)
    and the tags."""
    seed = int(seed)
    h = mix(((seed >> 32) & M32) ^ 0x243F6A88)
    h = mix(h ^ (seed & M32))
    for t in tags:
        h = mix(h ^ (int(t) & M32))
    return h


def _rows_hash(k, t):
    """One 32-bit hash per row ``t`` (int64) under the per-row keys ``k``."""
    return mix(mix(t ^ k) ^ 0x85EBCA6B)


def _bytes_from_words(h, row_len: int, xp):
    """[n, words] uint32 words → [n, row_len] uint8, little-endian."""
    if xp is np:
        b = np.stack([(h >> s) & 255 for s in (0, 8, 16, 24)], axis=-1)
        return b.reshape(h.shape[0], -1)[:, :row_len].astype(np.uint8)
    b = torch.stack([(h >> s) & 255 for s in (0, 8, 16, 24)], dim=-1)
    return b.reshape(h.shape[0], -1)[:, :row_len].to(torch.uint8)


def _as_i64(a, xp, device=None):
    if xp is np:
        return np.asarray(a, np.int64)
    return torch.as_tensor(a, dtype=torch.int64, device=device)


def frame_rows(seed: int, tag: int, owner, t, row_len: int, *, xp=np,
               device=None):
    """Pixel rows: row i is the frame at time ``t[i]`` of stream or
    sequence ``owner[i]`` (``owner`` may be one int), ``[n, row_len]``
    uint8 from numpy (``xp=np``) or torch on ``device``."""
    t = _as_i64(t, xp, device)
    n = t.shape[0]
    base = key(seed, tag)
    own = (int(owner) if np.ndim(owner) == 0 and not torch.is_tensor(owner)
           else _as_i64(owner, xp, device))
    hrow = _rows_hash(mix(own ^ base), t)
    words = -(-row_len // 4)
    w = (np.arange(words, dtype=np.int64) if xp is np
         else torch.arange(words, dtype=torch.int64, device=device))
    h = mix((hrow.reshape(n, 1) + w.reshape(1, words) * GOLD) & M32)
    return _bytes_from_words(h, row_len, xp)


def transition_meta(seed: int, stream: int, t0: int, n: int,
                    num_actions: int, done_every: int) -> dict:
    """Host metadata of stream ``stream``'s rows ``t0 .. t0+n``: action
    uniform over the actions, reward +1 / −1 / 0 with probabilities 1/16,
    1/16, 7/8, an episode end with probability 1/``done_every`` (the
    boundary is the episode end: no truncations)."""
    t = np.arange(t0, t0 + n, dtype=np.int64)
    h = _rows_hash(mix(int(stream) ^ key(seed, META)), t)
    h2 = mix(h ^ 0x68E31DA4)
    h3 = mix(h2 ^ 0xB5297A4D)
    r = h2 % 16
    return {
        "action": (h % num_actions).astype(np.int32),
        "reward": np.where(r == 0, 1.0, np.where(r == 1, -1.0, 0.0)
                           ).astype(np.float32),
        "done": (h3 % done_every) == 0,
    }


def sequence_meta(seed: int, q: int, seq_len: int, burn_in: int,
                  num_actions: int, lstm: int, gamma: float,
                  end_every: int) -> dict:
    """Host metadata of sequence ``q``: per-step actions and rewards as in
    ``transition_meta``; one sequence in ``end_every`` ends its episode at
    a step inside the training window (its mask is 0 after that step and
    its terminal step's discount 0, else γ); the stored carry ``(c, h)``
    uniform in (−1, 1) and (−0.5, 0.5)."""
    t = np.arange(seq_len, dtype=np.int64)
    kq = mix(int(q) ^ key(seed, SEQ_META))
    h = _rows_hash(kq, t)
    h2 = mix(h ^ 0x68E31DA4)
    r = h2 % 16
    hq = mix(kq ^ 0x1B873593)
    steps = seq_len
    if hq % end_every == 0:
        steps = burn_in + 1 + (mix(hq) % (seq_len - burn_in))
    mask = (t < steps).astype(np.float32)
    discount = np.full(seq_len, gamma, np.float32) * mask
    if steps < seq_len:
        discount[steps - 1] = 0.0
    c = _unit(_rows_hash(kq ^ 0x2545F491, np.arange(lstm, dtype=np.int64)))
    hh = _unit(_rows_hash(kq ^ 0x9E3779B1, np.arange(lstm, dtype=np.int64)))
    return {
        "action": (h % num_actions).astype(np.int32),
        "reward": np.where(r == 0, 1.0, np.where(r == 1, -1.0, 0.0)
                           ).astype(np.float32) * mask,
        "discount": discount,
        "mask": mask,
        "init_c": (2.0 * c - 1.0).astype(np.float32),
        "init_h": (hh - 0.5).astype(np.float32),
    }


def _unit(h: np.ndarray) -> np.ndarray:
    """uint32 words → float64 in [0, 1) from their top 24 bits."""
    return (h >> 8).astype(np.float64) / float(1 << 24)


def make_weights(seed: int, spec, device) -> dict[str, torch.Tensor]:
    """Initial float32 parameters from ``seed`` on ``device``: ONE normal
    draw from a ``torch.Generator`` there, cut into the leaves of ``spec``
    (``(name, shape, fan_in)``; ``fan_in`` 0 for a zero bias), each weight
    scaled by 1/√fan_in (LeCun normal)."""
    device = torch.device(device)
    total = sum(int(np.prod(shape)) for _, shape, fan in spec if fan)
    gen = torch.Generator(device=device)
    gen.manual_seed(key(seed, WEIGHTS) | (int(seed) & M32) << 32)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, fan in spec:
        if not fan:
            out[name] = torch.zeros(shape, device=device)
            continue
        n = int(np.prod(shape))
        out[name] = (flat[at:at + n] / float(np.sqrt(fan))).view(shape)
        at += n
    return out
