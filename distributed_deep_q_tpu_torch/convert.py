"""Weights and train state between the Flax reference and the port.

Inputs and outputs are nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, tree)`` gives for a Flax param tree), so this
module never needs jax. ``flax_leaves``/``load_flax_leaves`` read and
write a port net's parameters as the reference's flat leaf list, the θ
wire layout.

Reference leaf names (as ``NatureCnnQNet`` / ``MlpQNet`` build them):

- ``torso/conv1..conv3/{kernel,bias}`` — kernels HWIO, e.g. ``(8,8,4,32)``,
  ``(4,4,32,64)``, ``(3,3,64,64)``; the port keeps OIHW.
- ``torso/fc4`` (or ``torso/fc{i}`` for the MLP) and ``_Head_0/{q, value,
  advantage}`` — Dense kernels ``[in, out]``; the port keeps ``[out, in]``.
- ``fc4``'s input rows are the conv3 output flattened in HWC order in the
  reference and CHW order in the port, so its rows are permuted; that needs
  the frame shape (``frame_shape``) to know conv3's spatial size.

``R2d2QNet`` trees name the head ``head`` and hold the LSTM cell under a
third key, Flax's class-derived scope (``OptimizedLSTMCell_0`` in flax
0.12.3; found as the key that is neither ``torso`` nor ``head``, as the
reference's ``r2d2_param_split`` finds it). The cell keeps eight leaves:
input kernels ``ii, if, ig, io`` ``[F, H]`` without bias and hidden
kernels ``hi, hf, hg, ho`` ``[H, H]`` with bias ``[H]``. The port stacks
them in gate order i, f, g, o: ``lstm.weight_ih [4H, F]``,
``lstm.weight_hh [4H, H]`` (each block the kernel transposed) and
``lstm.bias_hh`` (the hidden biases); its zero ``bias_ih`` is a buffer,
not a parameter.

Port names are the ``named_parameters()`` of ``models/qnet.py``:
``torso.conv1.weight``, ``head.q.bias``, ``lstm.weight_ih``, ...

A train state is ``{"params", "target_params", "opt_state": {"name",
"count", "mu", "nu"}, "step"}``: θ, θ⁻, the optimizer state and the step
counter. For ``adam`` it is what optax's ``ScaleByAdamState`` holds; for
``rmsprop`` what its ``ScaleByRStdDevState`` holds, with no ``count``
(``mu``/``nu`` have the params' structure either way). In the reference
that state sits in optax's chain — ``(EmptyState, (ScaleByRStdDevState(mu,
nu), EmptyState, EmptyState))`` for RMSProp with the clip, its inner tuple
without — and ``optax_opt_leaves``/``opt_state_from_optax_leaves`` convert
it through the tree's leaves, which are the same list with the clip and
without (the ``EmptyState`` nodes hold none).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from distributed_deep_q_tpu_torch.models.qnet import conv_out_hw

_SCOPES = (("torso", "torso"), ("_Head_0", "head"))
LSTM_SCOPE = "OptimizedLSTMCell_0"   # flax 0.12.3's name for R2D2's cell
_GATES = ("i", "f", "g", "o")        # Flax's and torch's gate order


def _fc4_rows_hwc_to_chw(k: np.ndarray, frame_shape) -> np.ndarray:
    h3, w3 = conv_out_hw(frame_shape)
    c = k.shape[0] // (h3 * w3)
    return k.reshape(h3, w3, c, -1).transpose(2, 0, 1, 3).reshape(k.shape)


def _fc4_rows_chw_to_hwc(k: np.ndarray, frame_shape) -> np.ndarray:
    h3, w3 = conv_out_hw(frame_shape)
    c = k.shape[0] // (h3 * w3)
    return k.reshape(c, h3, w3, -1).transpose(1, 2, 0, 3).reshape(k.shape)


def _lstm_from_flax(cell: dict) -> dict[str, np.ndarray]:
    return {
        "lstm.weight_ih": np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES]),
        "lstm.weight_hh": np.concatenate(
            [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES]),
        "lstm.bias_hh": np.concatenate(
            [np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES]),
    }


def _lstm_to_flax(params: dict[str, Any]) -> dict:
    w_ih = np.split(np.asarray(params["lstm.weight_ih"]), 4)
    w_hh = np.split(np.asarray(params["lstm.weight_hh"]), 4)
    b_hh = np.split(np.asarray(params["lstm.bias_hh"]), 4)
    cell: dict = {}
    for g, wi, wh, bh in zip(_GATES, w_ih, w_hh, b_hh):
        cell[f"i{g}"] = {"kernel": np.array(wi.T, order="C")}
        cell[f"h{g}"] = {"kernel": np.array(wh.T, order="C"),
                         "bias": np.array(bh)}
    return cell


def params_from_flax(tree: dict, frame_shape=None) -> dict[str, np.ndarray]:
    """Flax param tree → ``{port name: array}`` in the port's layouts.
    ``frame_shape`` is required for a Nature CNN (the fc4 row permutation)."""
    out: dict[str, np.ndarray] = {}
    scopes = list(_SCOPES)
    if "head" in tree:                   # an R2d2QNet tree
        scopes[1] = ("head", "head")
        (cell,) = [k for k in tree if k not in ("torso", "head")]
        out.update(_lstm_from_flax(tree[cell]))
    for flax_scope, port_scope in scopes:
        for layer, leaves in tree[flax_scope].items():
            k = np.asarray(leaves["kernel"])
            if k.ndim == 4:
                w = k.transpose(3, 2, 0, 1)              # HWIO → OIHW
            else:
                if layer == "fc4":
                    k = _fc4_rows_hwc_to_chw(k, frame_shape)
                w = k.T                                  # [in,out] → [out,in]
            out[f"{port_scope}.{layer}.weight"] = np.array(w, order="C")
            out[f"{port_scope}.{layer}.bias"] = np.array(leaves["bias"])
    return out


def params_to_flax(params: dict[str, Any], frame_shape=None,
                   lstm_scope: str = LSTM_SCOPE) -> dict:
    """Inverse of ``params_from_flax`` (accepts numpy arrays or CPU
    tensors; returns numpy). An R2D2 tree's cell goes under
    ``lstm_scope``."""
    port_to_flax = dict((p, f) for f, p in _SCOPES)
    tree: dict = {}
    if "lstm.weight_ih" in params:       # an R2d2QNet
        port_to_flax["head"] = "head"
        tree[lstm_scope] = _lstm_to_flax(params)
    for name, value in params.items():
        if name.startswith("lstm."):
            continue
        scope, layer, leaf = name.split(".")
        a = np.asarray(value)
        if leaf == "weight":
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)              # OIHW → HWIO
            else:
                a = a.T
                if layer == "fc4":
                    a = _fc4_rows_chw_to_hwc(a, frame_shape)
            leaf = "kernel"
        tree.setdefault(port_to_flax[scope], {}).setdefault(layer, {})[
            leaf] = np.array(a, order="C")
    return tree


def tree_leaves(tree) -> list[np.ndarray]:
    """The leaves of a nested dict in ``jax.tree_util.tree_leaves`` order:
    keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [np.asarray(tree)]


def tree_unflatten(skeleton, leaves):
    """Rebuild ``skeleton``'s nesting from ``leaves`` (an iterator in
    ``tree_leaves`` order), each leaf cast to its skeleton leaf's dtype."""
    if isinstance(skeleton, dict):
        return {k: tree_unflatten(skeleton[k], leaves)
                for k in sorted(skeleton)}
    return np.asarray(next(leaves), skeleton.dtype)


def _net_flax_tree(net, frame_shape) -> dict:
    return params_to_flax({k: p.detach().float().cpu().numpy()
                           for k, p in net.named_parameters()}, frame_shape)


def flax_leaves(net, frame_shape=None) -> list[np.ndarray]:
    """θ of a port net as the reference's ``get_weights`` gives it: the
    leaves of the Flax param tree in ``jax.tree_util.tree_leaves`` order,
    in Flax layouts. This is the θ wire layout
    (``ReplayFeedServer.publish_params``)."""
    return tree_leaves(_net_flax_tree(net, frame_shape))


def named_from_flax_leaves(net, leaves,
                           frame_shape=None) -> dict[str, np.ndarray]:
    """``leaves`` (``flax_leaves`` order and layout, e.g. θ pulled over the
    wire) as ``{parameter name: array}`` in ``net``'s layouts, each shape
    checked against the net's."""
    skeleton = _net_flax_tree(net, frame_shape)
    leaves = list(leaves)
    want = len(tree_leaves(skeleton))
    if len(leaves) != want:
        raise ValueError(f"got {len(leaves)} weights, the net has {want} "
                         "leaves")
    named = params_from_flax(tree_unflatten(skeleton, iter(leaves)),
                             frame_shape)
    for name, p in net.named_parameters():
        if tuple(named[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(named[name].shape)} "
                             f"against the net's {tuple(p.shape)}")
    return {name: np.ascontiguousarray(named[name])
            for name, _ in net.named_parameters()}


def load_flax_leaves(net, leaves, frame_shape=None) -> None:
    """Install ``leaves`` (``flax_leaves`` order and layout) into ``net``'s
    parameters, in place."""
    named = named_from_flax_leaves(net, leaves, frame_shape)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(named[name]))


def opt_state_from_flax(name: str, mu: dict, nu: dict, count=None,
                        frame_shape=None) -> dict:
    """Flax-layout moment trees → the port's optimizer-state dict (numpy);
    ``count`` is Adam's and ignored for RMSProp."""
    out = {"name": name, "mu": params_from_flax(mu, frame_shape),
           "nu": params_from_flax(nu, frame_shape)}
    if name == "adam":
        out["count"] = np.int32(count)
    return out


def train_state_from_flax(params: dict, target_params: dict, count, mu: dict,
                          nu: dict, step, frame_shape=None,
                          optimizer: str = "adam") -> dict:
    """Reference ``TrainState`` pieces → the port's train-state dict
    (``count`` is ignored for RMSProp, whose state has none)."""
    return {
        "params": params_from_flax(params, frame_shape),
        "target_params": params_from_flax(target_params, frame_shape),
        "opt_state": opt_state_from_flax(optimizer, mu, nu, count,
                                         frame_shape),
        "step": np.int32(step),
    }


def train_state_to_flax(state: dict, frame_shape=None) -> dict:
    """The port's train-state dict → ``{"params", "target_params",
    "optimizer", "count", "mu", "nu", "step"}`` with Flax-layout nested
    dicts (``count`` for Adam only)."""
    opt = state["opt_state"]
    out = {
        "params": params_to_flax(state["params"], frame_shape),
        "target_params": params_to_flax(state["target_params"], frame_shape),
        "optimizer": opt.get("name", "adam"),
        "mu": params_to_flax(opt["mu"], frame_shape),
        "nu": params_to_flax(opt["nu"], frame_shape),
        "step": np.int32(state["step"]),
    }
    if "count" in opt:
        out["count"] = np.int32(opt["count"])
    return out


def optax_opt_leaves(opt: dict, frame_shape=None) -> list[np.ndarray]:
    """The port's optimizer-state dict as the leaves of the reference's
    optax state tree, in ``jax.tree_util.tree_leaves`` order: Adam's
    ``count``, then ``mu``'s leaves, then ``nu``'s; RMSProp's ``mu`` then
    ``nu``. The list is the same with the clip and without, so
    ``tree_unflatten`` of either structure takes it."""
    out = [np.asarray(opt["count"], np.int32)] if opt["name"] == "adam" \
        else []
    for key in ("mu", "nu"):
        out += tree_leaves(params_to_flax(
            {k: np.asarray(v) for k, v in opt[key].items()}, frame_shape))
    return out


def opt_state_from_optax_leaves(leaves, name: str, params: dict,
                                frame_shape=None) -> dict:
    """Inverse of ``optax_opt_leaves``: the leaves of a reference optax
    state (either structure) → the port's optimizer-state dict (numpy).
    ``params`` (``{port name: array}``) gives the Flax skeleton."""
    skeleton = params_to_flax({k: np.asarray(v) for k, v in params.items()},
                              frame_shape)
    leaves = list(leaves)
    want = 2 * len(tree_leaves(skeleton)) + (name == "adam")
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} leaves for a {name} state of this "
                         f"net, which has {want}")
    it = iter(leaves)
    count = next(it) if name == "adam" else None
    mu = tree_unflatten(skeleton, it)
    nu = tree_unflatten(skeleton, it)
    return opt_state_from_flax(name, mu, nu, count, frame_shape)
