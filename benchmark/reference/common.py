"""What both plain references share: the sampling keys and uniforms, the
prioritized draw, the Nature-CNN torso and dueling head, the LSTM cell, the
losses, Adam with the clip and the target refresh, the lowered precisions
of the control, and the comparison of a candidate's trace with the
reference's.

Plain PyTorch and NumPy, written from the published algorithms and the
configuration; nothing here imports the program. Float32 throughout, with
TF32 off, unless a lower precision is asked for (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
ADAM_B1, ADAM_B2 = 0.9, 0.999

# -- randomness: the sampling keys and uniforms ------------------------------


def step_keys(seed: int, first_step: int, count: int) -> np.ndarray:
    """The sampling key of each grad step ``first_step .. +count`` (one
    shard): a splitmix64 pass over (seed, step), as two uint32 words
    ``[count, 2]``."""
    steps = np.uint64(first_step) + np.arange(count, dtype=np.uint64)
    g = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        x = steps + np.uint64(seed) * g + g
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return np.stack([(x >> np.uint64(32)).astype(np.uint32),
                     (x & np.uint64(M32)).astype(np.uint32)], axis=-1)


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 arrays holding uint32 words."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a, b = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in rot[i % 2]:
            a = (a + b) & M32
            b = (((b << r) | (b >> (32 - r))) & M32) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def uniforms(keys: np.ndarray, n: int) -> np.ndarray:
    """``n`` float32 uniforms in [0, 1) per key (``[..., 2]``): draw i is the
    xor of the Threefry words of the counters (0, i), its top 23 bits made
    the mantissa of a float in [1, 2), minus 1."""
    k = np.asarray(keys).astype(np.int64)
    i = np.arange(n, dtype=np.int64)
    a, b = _threefry(k[..., 0, None], k[..., 1, None], np.zeros_like(i), i)
    bits = ((a ^ b) >> 9) | 0x3F800000
    return np.maximum(bits.astype(np.int32).view(np.float32) - 1.0,
                      0.0).astype(np.float32)


def beta_at(samples: int, beta0: float, beta_steps: int) -> float:
    """The IS exponent after ``samples`` draws: β₀ → 1 linearly."""
    return beta0 + min(samples / max(beta_steps, 1), 1.0) * (1.0 - beta0)


def prioritized_draw(prio_masked: torch.Tensor, n_live: torch.Tensor,
                     u: torch.Tensor, beta: float):
    """Inverse-CDF draws ∝ priority from one CDF (float32, inclusive), and
    their IS weights ``(N·P(i))^−β`` over their maximum. Returns (rows,
    weights)."""
    cdf = torch.cumsum(prio_masked.view(1, -1), -1)
    mass = cdf[:, -1]
    x = (u.view(1, -1) * mass[:, None])
    idx = torch.searchsorted(cdf, x, right=True).clamp(
        0, prio_masked.numel() - 1)[0]
    p = prio_masked[idx] / torch.clamp(mass, min=1e-12)
    w = (n_live * torch.clamp(p, min=1e-12)) ** (-beta)
    return idx, (w / torch.clamp(w.max(), min=1e-12)).float()


# -- precision ---------------------------------------------------------------


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` through float8 ``dtype`` with one scale per tensor (its largest
    magnitude at the format's ``top``), back in float32."""
    s = top / torch.clamp(x.abs().max(), min=1e-12)
    return (x.float() * s).to(dtype).float() / s


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa, in float32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


ROUNDING = {
    # (forward, backward): what a tensor and its gradient are held in
    "bf16": (lambda t: t.to(torch.bfloat16).float(),
             lambda g: g.to(torch.bfloat16).float()),
    # float8 training's usual pair: e4m3 values, e5m2 gradients
    "fp8": (lambda t: _fp8(t, torch.float8_e4m3fn, 448.0),
            lambda g: _fp8(g, torch.float8_e5m2, 57344.0)),
    "tf32": (_tf32, _tf32),
}


class _Round(torch.autograd.Function):
    """A tensor rounded to a precision forward, its gradient rounded to the
    same precision backward."""

    @staticmethod
    def forward(ctx, x, prec):
        ctx.prec = prec
        return ROUNDING[prec][0](x.detach())

    @staticmethod
    def backward(ctx, g):
        return ROUNDING[ctx.prec][1](g), None


def lowered(prec: str):
    """The rounding a precision name puts on a layer's tensors: ``f32``
    none; ``bf16``, ``fp8`` (per-tensor scaled e4m3 values and e5m2
    gradients) or ``tf32`` forward and backward."""
    if prec == "f32":
        return lambda t: t.float()
    if prec not in ROUNDING:
        raise ValueError(f"unknown precision {prec!r}")
    return lambda t: _Round.apply(t.float(), prec)


# -- the nets -----------------------------------------------------------------


CONVS = (("conv1", 32, 8, 4), ("conv2", 64, 4, 2), ("conv3", 64, 3, 1))


def conv_out(hw: tuple[int, int]) -> tuple[int, int]:
    h, w = hw
    for _, _, k, s in CONVS:
        h, w = (h - k) // s + 1, (w - k) // s + 1
    return h, w


def torso_spec(stack: int, hw: tuple[int, int]) -> list:
    """(name, shape, fan_in) of the Nature-CNN torso (Mnih et al. 2015):
    conv 32×8×8/4, 64×4×4/2, 64×3×3/1, FC 512, OIHW weights, a CHW flatten;
    fan_in 0 marks a zero-initialized bias."""
    out, cin = [], stack
    for name, cout, k, _ in CONVS:
        out += [(f"torso.{name}.weight", (cout, cin, k, k), cin * k * k),
                (f"torso.{name}.bias", (cout,), 0)]
        cin = cout
    h, w = conv_out(hw)
    out += [("torso.fc4.weight", (512, 64 * h * w), 64 * h * w),
            ("torso.fc4.bias", (512,), 0)]
    return out


def head_spec(fan_in: int, actions: int) -> list:
    """The dueling head (Wang et al. 2016): value and advantage streams."""
    return [("head.value.weight", (1, fan_in), fan_in),
            ("head.value.bias", (1,), 0),
            ("head.advantage.weight", (actions, fan_in), fan_in),
            ("head.advantage.bias", (actions,), 0)]


def torso(p: dict, frames: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """``[N, stack, H, W]`` uint8 frames → ``[N, 512]`` features: pixels over
    255, three ReLU convolutions, a ReLU FC. Every tensor a layer takes or
    gives (input, weight, bias, output) is rounded to ``prec``, as a
    program computing in that precision holds it."""
    lo = lowered(prec)
    h = frames.float() / 255.0
    for name, _, _, s in CONVS:
        h = F.relu(lo(F.conv2d(lo(h), lo(p[f"torso.{name}.weight"]),
                               lo(p[f"torso.{name}.bias"]), stride=s)))
    return F.relu(lo(F.linear(lo(h.flatten(1)), lo(p["torso.fc4.weight"]),
                              lo(p["torso.fc4.bias"]))))


def head(p: dict, h: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Dueling Q: V + A − mean(A), rounded as ``torso`` rounds."""
    lo = lowered(prec)
    v = lo(F.linear(lo(h), lo(p["head.value.weight"]),
                    lo(p["head.value.bias"])))
    a = lo(F.linear(lo(h), lo(p["head.advantage.weight"]),
                    lo(p["head.advantage.bias"])))
    return lo(v + a - a.mean(dim=-1, keepdim=True))


def lstm(p: dict, x: torch.Tensor, carry, prec: str = "f32"):
    """An LSTM over ``x [B, T, F]`` from the carry ``(c, h)``: per step the
    gates i, f, g, o = h·W_hhᵀ + b_hh + x·W_ihᵀ (no input bias), then
    c' = σ(f)·c + σ(i)·tanh(g), h' = σ(o)·tanh(c'). Returns ([B, T, H],
    (c, h)). The matmul operands are rounded to ``prec``."""
    lo = lowered(prec)
    c, h = carry
    w_ih, w_hh, b = lo(p["lstm.weight_ih"]), lo(p["lstm.weight_hh"]), \
        p["lstm.bias_hh"]
    xs = F.linear(lo(x), w_ih)                       # [B, T, 4H]
    outs = []
    for t in range(x.shape[1]):
        gates = F.linear(lo(h), w_hh, b) + xs[:, t]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1), (c, h)


# -- losses and the optimizer -------------------------------------------------


def huber(x: torch.Tensor, delta: float) -> torch.Tensor:
    a = x.abs()
    q = torch.clamp(a, max=delta)
    return 0.5 * q * q + delta * (a - q)


def value_rescale(x, eps=1e-3):
    """h(x) = sign(x)(√(|x|+1) − 1) + εx (Pohlen et al. 2018)."""
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def value_rescale_inv(x, eps=1e-3):
    return torch.sign(x) * (((torch.sqrt(1.0 + 4.0 * eps * (x.abs() + 1.0
                                                             + eps)) - 1.0)
                             / (2.0 * eps)) ** 2 - 1.0)


class Optimizer:
    """The global-norm clip, then Adam (Kingma & Ba) or centered RMSProp
    (Graves 2013: ε inside the root, no momentum), and the periodic target
    copy, on dicts of float32 leaves. ``stat`` is the optimizer's running
    mean of the clipped gradients (Adam's first moment, RMSProp's mean
    gradient): the gradient as the optimizer holds it."""

    def __init__(self, params: dict, tcfg: dict, constants: dict):
        self.kind = tcfg["optimizer"]
        if self.kind not in ("adam", "rmsprop"):
            raise ValueError(f"unknown optimizer {self.kind!r}")
        self.lr, self.clip = tcfg["lr"], tcfg["grad_clip_norm"]
        self.period = tcfg["target_update_period"]
        if self.kind == "adam":
            self.eps = tcfg["adam_eps"]
        else:
            self.decay = constants["rmsprop_decay"]
            self.eps = constants["rmsprop_eps"]
        self.stat = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, target: dict, grads: dict) -> None:
        """Updates ``params``, ``target`` and the state in place."""
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads.values()))
        scale = min(1.0, self.clip / max(gnorm, 1e-12)) if self.clip > 0 \
            else 1.0
        self.count += 1
        for k, p in params.items():
            g = grads[k] * scale
            if self.kind == "adam":
                self.stat[k] = ADAM_B1 * self.stat[k] + (1.0 - ADAM_B1) * g
                self.v[k] = ADAM_B2 * self.v[k] + (1.0 - ADAM_B2) * g * g
                bc1 = 1.0 - ADAM_B1 ** self.count
                bc2 = 1.0 - ADAM_B2 ** self.count
                p -= self.lr * (self.stat[k] / bc1) / (
                    torch.sqrt(self.v[k] / bc2) + self.eps)
            else:
                d = self.decay
                self.stat[k] = d * self.stat[k] + (1.0 - d) * g
                self.v[k] = d * self.v[k] + (1.0 - d) * g * g
                p -= self.lr * g / torch.sqrt(
                    self.v[k] - self.stat[k] ** 2 + self.eps)
        if self.count % self.period == 0:
            for k in target:
                target[k].copy_(params[k])


# -- comparing a candidate with the reference ---------------------------------


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf_gap(cand: dict, ref: dict, skip=()) -> float:
    """The largest gap between a candidate's leaf norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    keys = [k for k in ref if k not in skip]
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(cand[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def quiet_leaves(grad_norms: dict) -> list:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: they move by round-off alone and are left out of the change."""
    med = float(np.median(list(grad_norms.values())))
    return [k for k, v in grad_norms.items() if v < 1e-3 * med]


def written_priorities(rows: list, vals: list, cand: torch.Tensor):
    """The priority each written row should hold after the steps in order,
    and the rows written: a later step overwrites an earlier one; a row
    drawn twice in one step may hold either value, so the one nearer the
    candidate's is expected."""
    expect = {}
    for r, v in zip(rows, vals):
        r, v = r.cpu().numpy(), v.double().cpu().numpy()
        got = cand[torch.as_tensor(r, device=cand.device)].double().cpu(
        ).numpy()
        step = {}
        for i in range(len(r)):
            key = int(r[i])
            if key in step and abs(step[key] - got[i]) <= abs(v[i] - got[i]):
                continue
            step[key] = float(v[i])
        expect.update(step)
    idx = np.fromiter(expect.keys(), np.int64, len(expect))
    val = np.fromiter(expect.values(), np.float64, len(expect))
    return idx, val


def priority_gap(cand: torch.Tensor, before: torch.Tensor, idx: np.ndarray,
                 val: np.ndarray, alpha: float, eps: float,
                 skip: np.ndarray | None = None) -> float:
    """The written priorities' gap in |TD| units: each priority p read
    back as p^(1/α) − ε, then ‖candidate − expected‖ / ‖expected‖ over the
    rows written, where every row neither written nor in ``skip`` must
    still hold its value from ``before``: a row that changed unwritten
    counts its whole change. (Under the power α a small |TD|'s round-off
    would swell.)"""
    def td(p):
        return torch.clamp(p.double().cpu(), min=0.0) ** (1.0 / alpha) - eps

    expect = before.double().cpu().clone()
    i = torch.as_tensor(idx)
    expect[i] = torch.as_tensor(val)
    diff = td(cand) - td(expect)
    if skip is not None and len(skip):
        diff[torch.as_tensor(skip)] = 0.0
    return float(diff.norm() / torch.clamp(td(expect)[i].norm(), min=1e-30))


def plan_for(cfg: dict) -> list:
    """The steps of each dispatch that set-up drives and the reference
    follows: one at the window's chain, drawn from the fresh priorities,
    then one of P mod chain steps (P the target period; chain where that
    is 0), so that every later dispatch at the window's chain ends on a
    step ≡ P, and step P, the first target refresh, ends one."""
    chain = int(cfg["replay"]["fused_chain"])
    return [chain, int(cfg["train"]["target_update_period"]) % chain
            or chain]


def follow(model, seed: int, rp: dict, plan: list, cand: dict | None = None,
           prec: str = "f32", fault: str | None = None) -> dict:
    """Follow the program's first two dispatches, of ``plan`` steps each.
    Each dispatch draws all its steps from the priorities as they stood at
    its start.

    The first runs at the window's chain from the fresh priorities, which
    are all 1: every partial sum of the CDF is an integer, whatever the
    order of the sum, so every draw is exact and every IS weight 1. The
    second draws from the priorities the first wrote, with IS weights.

    Standing in for the program (``cand`` None: the control, or a planted
    fault) it returns its trace: every step's loss; after the first
    dispatch the optimizer's mean gradient (``stat``), the change of θ,
    θ itself and the priorities; the change of θ over the second.

    Judging a candidate it also gives the gap of the priorities the first
    dispatch wrote (``prio_gap``: the rows whose last write was its first
    step, whose |TD| came from θ₀ alone; ``prio_all_gap``: every row, each
    by its last write), then follows the second dispatch from the
    candidate's θ and priorities, with its own optimizer state. A float32
    CUDA cumsum over a million unequal priorities may round differently
    from one call to the next, so a draw of the second dispatch near a
    row's edge may land on its neighbour: what it compares is the change
    of θ, to which one row in thousands adds little.

    ``model`` gives ``p0``, ``prio0`` (the seeded weights and the fresh
    priorities), ``valid`` (the rows a draw may pick), ``n_live``,
    ``tcfg`` and ``constants`` (the optimizer's), ``batch(idx)`` and
    ``step(p, tp, opt, batch, w, prec, fault)`` → (loss, the priority
    base: |TD| or the sequence's mixed |TD|)."""
    alpha, eps, b = rp["priority_alpha"], rp["priority_eps"], \
        rp["batch_size"]
    p0 = model.p0
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    tp = {k: v.clone() for k, v in p0.items()}
    opt = Optimizer(p, model.tcfg, model.constants)
    prio = model.prio0.clone()
    out = {"losses": [], "plan": list(plan)}
    step, start = 0, p0
    for d, n in enumerate(plan):
        if d == 1:
            if cand is not None:
                c = cand["snapshot"].to(prio.device)
                later = torch.cat(rows[1:]).unique().cpu().numpy() \
                    if len(rows) > 1 else np.zeros(0, np.int64)
                idx, val = written_priorities(rows[:1], vals[:1], c)
                keep = ~np.isin(idx, later)
                out["prio_gap"] = priority_gap(
                    c, model.prio0, idx[keep], val[keep], alpha, eps,
                    skip=later)
                out["prio_all_gap"] = priority_gap(
                    c, model.prio0, *written_priorities(rows, vals, c),
                    alpha, eps)
                prio = c.clone()
                with torch.no_grad():
                    for k in p:
                        p[k].copy_(cand["theta1"][k].to(p[k].device))
            out["snapshot"] = prio.detach().cpu().clone()
            out["theta1"] = {k: v.detach().cpu().clone()
                             for k, v in p.items()}
            start = {k: v.detach().clone() for k, v in p.items()}
        pm = prio * model.valid
        u = torch.as_tensor(uniforms(step_keys(seed, step, n), b),
                            device=prio.device)
        rows, vals = [], []
        for j in range(n):
            step += 1
            beta = beta_at(step, rp["priority_beta0"],
                           rp["priority_beta_steps"])
            idx, w = prioritized_draw(pm, model.n_live, u[j], beta)
            loss, td = model.step(p, tp, opt, model.batch(idx), w, prec,
                                  fault)
            out["losses"].append(loss)
            new = (td + eps) ** alpha
            prio[idx] = new
            rows.append(idx)
            vals.append(new)
        change = leaf_norms({k: p[k].detach() - start[k] for k in p})
        if d == 0:
            out["stat"] = leaf_norms(opt.stat)
            out["dtheta1"] = change
        else:
            out["dtheta2"] = change
    return out


def train_step(model_loss, p: dict, tp: dict, opt: Optimizer,
               fault: str | None):
    """One step from ``model_loss() → (loss, priority base)``: the
    gradient, then the optimizer, unless the fault ``frozen`` leaves the
    state unchanged. Returns (loss, priority base)."""
    loss, base = model_loss()
    names = list(p)
    grads = dict(zip(names, torch.autograd.grad(loss, [p[k] for k in names])))
    if fault != "frozen":
        opt.step(p, tp, grads)
    return float(loss.detach()), base


NUMBERS = ("loss1_gap", "grad_gap", "dtheta1_gap", "prio_gap",
           "dtheta2_gap", "loss_last_gap", "loss2_gap", "prio_all_gap")


def follow_and_compare(ref: dict, cand: dict) -> dict:
    """The compared numbers from the reference's trace and a candidate's:
    step 1's relative loss gap; the worst-leaf gaps of the optimizer's
    mean gradient after the first dispatch and of θ's change over it and
    over the second; the priority gaps; and, logged, the relative loss
    gaps of the first dispatch's last step and of the second's first
    (the latter's IS weights are normalized by the batch's largest, so
    one draw that lands on a neighbour row of low priority rescales them
    all). Leaves whose reference mean gradient is quiet are left out of
    the changes."""
    def rel(c, r):
        return abs(c - r) / max(abs(r), 1e-30)

    quiet = quiet_leaves(ref["stat"])
    n1 = ref["plan"][0]
    return {
        "loss1_gap": rel(cand["losses"][0], ref["losses"][0]),
        "loss_last_gap": rel(cand["losses"][n1 - 1], ref["losses"][n1 - 1]),
        "loss2_gap": rel(cand["losses"][n1], ref["losses"][n1]),
        "grad_gap": worst_leaf_gap(cand["stat"], ref["stat"]),
        "dtheta1_gap": worst_leaf_gap(cand["dtheta1"], ref["dtheta1"],
                                      skip=quiet),
        "dtheta2_gap": worst_leaf_gap(cand["dtheta2"], ref["dtheta2"],
                                      skip=quiet),
        "prio_gap": ref["prio_gap"],
        "prio_all_gap": ref["prio_all_gap"],
        "quiet_leaves": quiet,
    }
