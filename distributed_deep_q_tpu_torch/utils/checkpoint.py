"""Checkpoint / resume of the learner's train state (port of the reference
``utils/checkpoint.py``, which writes through Orbax; the port needs none).

One snapshot carries the complete learner state — θ, θ⁻, the optimizer's
name and state (Adam's count, μ and ν, or RMSProp's μ and ν), and the
step — so a resumed run continues exactly (optimizer
moments and the θ⁻ refresh phase included). The replay buffer is not in
it: that is ``replay/persistence.py``, behind ``replay.persist_path``.

Layout: ``<dir>/<step>/`` holding ``extra.json`` (small host bookkeeping)
and ``state.pt`` (``torch.save`` of host tensors, named as the nets'
``named_parameters()``), the newest ``keep`` steps retained. Both files go
through ``atomic_write``, ``state.pt`` last: a step directory counts once
its ``state.pt`` exists.

``save`` copies every tensor to the host before it returns, so a later
in-place Adam step cannot reach a snapshot that is still being written;
the files are written by a background thread (at most one in flight), as
Orbax's asynchronous save does. ``wait=True``, ``wait()``,
``latest_step()`` and ``restore`` block until the write is on disk and
raise the writer's error.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from distributed_deep_q_tpu_torch.utils.durability import atomic_write

_STATE, _EXTRA = "state.pt", "extra.json"


def _jsonable(v: Any):
    """JSON-safe coercion that PRESERVES int/float distinction: counters
    like ``env_steps`` must round-trip as ints (a blanket ``float(v)``
    silently turned them into floats, and consumers doing exact-step
    arithmetic inherited float error past 2**53). Bools pass through as
    bools; numpy scalars land as their Python kind."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    return float(v)


def _host(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Owned host copies (a CPU tensor is copied too, not aliased)."""
    return {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}


def _snapshot(state) -> dict[str, Any]:
    """The host copy of a ``TrainState`` that ``state.pt`` holds."""
    opt = state.opt_state
    snap_opt = {"name": opt["name"], "mu": _host(opt["mu"]),
                "nu": _host(opt["nu"])}
    if "count" in opt:
        snap_opt["count"] = int(opt["count"])
    return {
        "step": int(state.step),
        "params": _host(dict(state.net.named_parameters())),
        "target_params": _host(dict(state.target_net.named_parameters())),
        "opt_state": snap_opt,
    }


def _check_leaves(want: dict[str, torch.Tensor],
                  got: dict[str, torch.Tensor], what: str) -> None:
    if want.keys() != got.keys():
        raise ValueError(
            f"checkpoint {what} do not match the net: missing "
            f"{sorted(want.keys() - got.keys())}, unexpected "
            f"{sorted(got.keys() - want.keys())}")
    for name, t in want.items():
        if tuple(got[name].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {what} {name!r} has shape "
                             f"{tuple(got[name].shape)}, the net "
                             f"{tuple(t.shape)}")


@torch.no_grad()
def _install(state, snap: dict[str, Any]) -> None:
    """Write ``snap`` into ``state`` in place, onto its tensors' devices
    and dtypes. Buffers are not touched (the recurrent net's zero
    ``bias_ih`` stays a zero buffer). A snapshot of another optimizer's
    state raises before anything is written (snapshots that name no
    optimizer hold Adam's)."""
    opt = state.opt_state
    saved = snap["opt_state"].get("name", "adam")
    if saved != opt["name"]:
        raise ValueError(
            f"checkpoint holds {saved} optimizer state; the train state "
            f"uses {opt['name']} (train.optimizer must match the run that "
            "saved it)")
    for module, key in ((state.net, "params"),
                        (state.target_net, "target_params")):
        params = dict(module.named_parameters())
        _check_leaves(params, snap[key], key)
        for name, p in params.items():
            p.copy_(snap[key][name])
    for key in ("mu", "nu"):
        _check_leaves(opt[key], snap["opt_state"][key],
                      f"{opt['name']} {key}")
        opt[key] = {name: snap["opt_state"][key][name].to(
            device=t.device, dtype=t.dtype, copy=True)
            for name, t in opt[key].items()}
    if "count" in opt:
        opt["count"] = torch.tensor(int(snap["opt_state"]["count"]),
                                    dtype=opt["count"].dtype,
                                    device=opt["count"].device)
    state.step = torch.tensor(int(snap["step"]), dtype=state.step.dtype,
                              device=state.step.device)


class Checkpointer:
    """Save/restore the learner ``TrainState`` (feed-forward or sequence)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = max(int(keep), 1)
        os.makedirs(self.directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, state, extra: dict[str, Any] | None = None,
             wait: bool = False) -> int:
        """Snapshot ``state`` at its current step; the files are written in
        the background unless ``wait``. ``extra`` carries small host-side
        bookkeeping (e.g. env-step counters)."""
        self.wait()
        snap = _snapshot(state)
        step = snap["step"]
        meta = {k: _jsonable(v) for k, v in (extra or {}).items()}
        self._writer = threading.Thread(
            target=self._write, args=(step, snap, meta),
            name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        if wait:
            self.wait()
        return step

    def _write(self, step: int, snap: dict, meta: dict) -> None:
        try:
            d = os.path.join(self.directory, str(step))
            os.makedirs(d, exist_ok=True)
            atomic_write(os.path.join(d, _EXTRA), json.dumps(meta).encode())
            atomic_write(os.path.join(d, _STATE),
                         lambda f: torch.save(snap, f))
            for old in self._steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        except Exception as e:  # re-raised by wait() on the caller
            self._error = e

    def _steps(self) -> list[int]:
        """Complete snapshots' steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, _STATE)))

    def latest_step(self) -> int | None:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_template):
        """Restore the newest snapshot INTO ``state_template`` (in place:
        its modules, devices and dtypes; values from disk). Returns (the
        template, extra dict). Raises if no checkpoint exists."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.directory!r}")
        d = os.path.join(self.directory, str(step))
        snap = torch.load(os.path.join(d, _STATE), map_location="cpu",
                          weights_only=True)
        with open(os.path.join(d, _EXTRA)) as f:
            extra = json.load(f)
        _install(state_template, snap)
        return state_template, extra

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def maybe_checkpointer(cfg) -> Checkpointer | None:
    """Build from ``TrainConfig`` (checkpoint_dir/checkpoint_every)."""
    if cfg.checkpoint_dir and cfg.checkpoint_every > 0:
        return Checkpointer(cfg.checkpoint_dir)
    return None
