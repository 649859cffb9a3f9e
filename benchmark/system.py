"""What every configuration module shares: the program's configuration
from a preset and the file's sections, the seeded weights loaded into the
program, the first steps driven through the window's own call with what
the plain reference needs from them captured, and the comparison that
decides ``correct``.

A configuration module (``configs/<name>.py``) defines ``build(cfg,
seed, device)`` returning a ``System``: the program's solver and replay,
filled; ``attach`` then gives it the program's ``FusedStepStream``, whose
dispatch (``dispatch()``) the window repeats.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import threading
import time
from pathlib import Path

import torch

from benchmark import data
from benchmark.reference import common

BENCH_DIR = Path(__file__).resolve().parent
# the configuration file's keys that are not fields of the program's
# dataclasses: the harness reads them
HARNESS_KEYS = {"replay": {"num_streams", "sequences"}}


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``, loaded by path."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(cfg: dict, seed: int, device):
    """The program's ``Config``: its preset with the file's ``net``,
    ``replay`` and ``train`` sections over it. A key that is neither a
    field nor a harness key is refused."""
    from distributed_deep_q_tpu_torch.config import PRESETS

    c = PRESETS[cfg["preset"]]()
    for section in ("net", "replay", "train"):
        node = getattr(c, section)
        fields = {f.name for f in dataclasses.fields(node)}
        over = {}
        for k, v in cfg[section].items():
            if k in fields:
                over[k] = tuple(v) if isinstance(v, list) else v
            elif k not in HARNESS_KEYS.get(section, ()):
                raise KeyError(f"{cfg['name']}: {section}.{k} is not a "
                               "field of the program's configuration")
        setattr(c, section, dataclasses.replace(node, **over))
    # the program's seed keys its sampling uniforms
    c.train = dataclasses.replace(c.train, seed=int(seed))
    c.mesh.backend = "cuda" if torch.device(device).type == "cuda" else "cpu"
    return c


def load_weights(state, weights: dict) -> None:
    """The seeded weights into θ and θ⁻, leaf by leaf by name."""
    for module in (state.net, state.target_net):
        named = dict(module.named_parameters())
        if set(named) != set(weights):
            raise KeyError(f"the program's leaves {sorted(named)} are not "
                           f"the reference's {sorted(weights)}")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(weights[k].to(p.device, p.dtype))


class TimedLock:
    """The program's replay lock (the ``ReplayFeedServer``'s
    ``threading.RLock``), timing each outermost hold of one thread, the
    learner's: ``holds`` gets ``(asked, got, released)`` for each."""

    def __init__(self, lock, owner: int):
        self._lock, self.owner = lock, owner
        # the harness's own holds (its reads at the fences) take the lock
        # itself, untimed
        self.inner = lock
        self._depth = 0
        self._asked = self._got = 0.0
        self.holds: list = []

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if threading.get_ident() != self.owner:
            return self._lock.acquire(blocking, timeout)
        t = time.perf_counter()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            if self._depth == 0:
                self._asked, self._got = t, time.perf_counter()
            self._depth += 1
        return ok

    def release(self) -> None:
        if threading.get_ident() == self.owner:
            self._depth -= 1
            if self._depth == 0:
                self.holds.append((self._asked, self._got,
                                   time.perf_counter()))
        self._lock.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


# a steps budget no dispatch reaches: every dispatch runs the full chain
ENDLESS = 1 << 40


class System:
    """A built configuration: ``solver``, ``replay``, ``chain``, the
    reference module and the seeded ``p0``. Subclasses fill the replay
    and may take ingest. ``attach`` hands it the program's dispatch
    stream; ``steps_done`` counts the grad steps dispatched (on the
    host)."""

    supports_ingest = False

    def __init__(self, cfg: dict, seed: int, device, reference):
        self.cfg, self.seed = cfg, int(seed)
        self.device = torch.device(device)
        self.reference = reference
        self.chain = int(cfg["replay"]["fused_chain"])
        self.plan = common.plan_for(cfg)
        self.period = int(cfg["train"]["target_update_period"])
        self.p0 = data.make_weights(seed, reference.param_spec(cfg),
                                    self.device)
        self.fill: list = []
        self.trace: dict | None = None
        self.lock: TimedLock | None = None
        self.stream = None
        self.steps_done = 0
        self.at_period: tuple | None = None

    def attach(self, ingest: bool) -> None:
        """The program's dispatch stream (``FusedStepStream``), under the
        program's replay lock when writers share the ring."""
        from distributed_deep_q_tpu_torch.solver import FusedStepStream

        if ingest:
            self.lock = TimedLock(threading.RLock(), threading.get_ident())
        self.stream = FusedStepStream(self.solver, self.replay, self.chain,
                                      dispatch_lock=self.lock)

    def dispatch(self, steps: int | None = None):
        """One dispatch of ``steps`` (the chain) grad steps through the
        stream, and the per-step rows it hands out. Returns (host seconds
        of the call that dispatched, every step's loss). Where it ends on
        step P, the first target refresh, θ and θ⁻ are kept for the
        check."""
        n = steps or self.chain
        t = time.perf_counter()
        m = self.stream.next(n if steps else ENDLESS)
        secs = time.perf_counter() - t
        losses = [m["loss"]]
        for i in range(1, n):
            losses.append(self.stream.next(n - i if steps else ENDLESS)
                          ["loss"])
        self.steps_done += n
        if self.steps_done == self.period:
            st = self.solver.state
            self.at_period = (
                {k: p.detach().clone() for k, p in st.net.named_parameters()},
                {k: p.detach().clone()
                 for k, p in st.target_net.named_parameters()})
        return secs, losses

    def steps(self) -> int:
        """The fence: the step counter read to the host, which waits for
        every step dispatched so far."""
        return int(self.solver.state.step)

    def priorities(self) -> torch.Tensor:
        raise NotImplementedError

    def first_steps(self) -> None:
        """Drive ``plan`` through the window's stream and keep what the
        reference compares: every step's loss; after the first dispatch
        the optimizer's mean gradient (Adam's first moment, RMSProp's mean
        gradient), θ, its change and the priorities; θ's change over the
        second; and θ⁻'s largest departure from θ₀ (none before step
        P)."""
        st = self.solver.state
        trace = {"losses": []}
        theta = None
        for d, n in enumerate(self.plan):
            _, losses = self.dispatch(n)
            trace["losses"] += [float(x) for x in losses]
            theta = {k: p.detach().float().clone()
                     for k, p in st.net.named_parameters()}
            if d == 0:
                trace["stat"] = common.leaf_norms(
                    {k: v.float() for k, v in st.opt_state["mu"].items()})
                trace["dtheta1"] = common.leaf_norms(
                    {k: v - self.p0[k] for k, v in theta.items()})
                trace["theta1"] = {k: v.cpu() for k, v in theta.items()}
                trace["snapshot"] = self.priorities().detach().cpu().clone()
                start = theta
            else:
                trace["dtheta2"] = common.leaf_norms(
                    {k: v - start[k] for k, v in theta.items()})
        trace["target_early"] = max_gap(
            dict(st.target_net.named_parameters()), self.p0)
        self.trace = trace

    def target_gap(self) -> float:
        """θ⁻ against what the configuration's period makes it: θ₀ until
        step P (read after the first steps), θ at step P right after the
        refresh there, where the run reached it. 0 when exact."""
        gap = self.trace["target_early"]
        if self.at_period is not None:
            gap = max(gap, max_gap(self.at_period[1], self.at_period[0]))
        return gap

    def free(self) -> None:
        """Drop the program's state and hand its memory back."""
        self.solver = self.replay = self.stream = None
        self.p0 = self.at_period = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@torch.no_grad()
def max_gap(a: dict, b: dict) -> float:
    """The largest elementwise gap between two dicts of leaves."""
    return max(float((a[k].float() - b[k].to(a[k].device).float()).abs()
                     .max()) for k in b)


def judge(cfg: dict, seed: int, fill: list, device, plan: list,
          trace: dict, reference):
    """The compared numbers of a candidate's ``trace`` against the plain
    reference, each with its limit from the configuration file, ``[(name,
    value, limit), ...]``, and for the log every number and the losses."""
    ref = reference.run(cfg, seed, fill, device, plan, cand=trace)
    nums = common.follow_and_compare(ref, trace)
    lim = cfg["limits"]
    checks = [(k, nums[k], lim[k]) for k in common.NUMBERS if k in lim]
    diag = {"losses": trace["losses"][:3] + trace["losses"][-3:],
            "reference_losses": ref["losses"][:3] + ref["losses"][-3:],
            "not_compared": {k: nums[k] for k in common.NUMBERS
                             if k not in lim},
            "quiet_leaves": nums["quiet_leaves"]}
    return checks, diag
