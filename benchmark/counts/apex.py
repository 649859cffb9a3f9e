"""Operations and bytes of the ``apex`` learner, from its shapes alone.

FLOPs of one grad step (batch B): let M be the multiply-adds of one
Nature-CNN forward on one 84×84×4 observation with the dueling head,

    conv1  20·20·32 outputs × 8·8·4  = 3,276,800
    conv2   9·9·64  outputs × 4·4·32 = 2,654,208
    conv3   7·7·64  outputs × 3·3·64 = 1,806,336
    fc4     3136 × 512               = 1,605,632
    head    512 × (1 + A)            = 9,728 at A = 18

so M = 9,352,704. A step needs three forwards (θ on s, θ on s' for the
Double-DQN argmax, θ⁻ on s') and one backward: every layer's weight
gradient (M) and every layer's input gradient but conv1's, whose input is
data (M − conv1). That is 5M − conv1 multiply-adds a sample, 2 FLOPs
each: 44.53 GFLOP at B = 512, all of it in the configuration's bfloat16.

Bytes of B1 (``gather_windows``) per dispatch: chain × B windows of
stack + n frames of H·W pixel bytes, each read once and written once
(the ring's row padding is the program's layout, not the algorithm's
need). Bytes of B2 (``scatter_rows``) per row landed: H·W read from the
staging buffer and written into the ring.
"""

from __future__ import annotations


def _macs(hw, stack: int, actions: int) -> tuple[int, int]:
    """(multiply-adds of one forward, of its first conv)."""
    h, w = hw
    cin, total, first = stack, 0, None
    for cout, k, s in ((32, 8, 4), (64, 4, 2), (64, 3, 1)):
        h, w = (h - k) // s + 1, (w - k) // s + 1
        macs = h * w * cout * k * k * cin
        first = macs if first is None else first
        total += macs
        cin = cout
    total += h * w * cin * 512 + 512 * (1 + actions)
    return total, first


def flops_per_step(cfg: dict) -> dict:
    """FLOPs of one grad step by the precision they run in."""
    net, b = cfg["net"], cfg["replay"]["batch_size"]
    m, conv1 = _macs(tuple(net["frame_shape"]), net["stack"],
                     net["num_actions"])
    return {"bf16": 2.0 * b * (5 * m - conv1)}


def gather_bytes(cfg: dict, chain: int) -> float:
    """Bytes one B1 launch of a chain-``chain`` dispatch needs."""
    net, rp = cfg["net"], cfg["replay"]
    h, w = net["frame_shape"]
    windows = chain * rp["batch_size"]
    return 2.0 * windows * (net["stack"] + rp["n_step"]) * h * w


def scatter_bytes_per_row(cfg: dict) -> float:
    h, w = cfg["net"]["frame_shape"]
    return 2.0 * h * w
