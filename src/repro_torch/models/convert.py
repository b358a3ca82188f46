"""Carry parameters and optimizer state between the reference package's
layout and the port, both ways.

``params_from_jax(tree, cfg)`` takes the numpy tree that
``jax.tree.map(np.asarray, params)`` gives for the reference's
``init_params(cfg, key)`` and returns a ``Transformer`` holding the same
values; ``params_to_jax(model)`` is its inverse.  Layouts are the same on
both sides, so the conversion is a copy: the layer stack
``blocks/<group>/<name> [L, ...]`` is split into
``layers.<i>.<group>.<name>`` and stacked back, and the vision family's
``cross_blocks/<group>/<name> [G, ...]`` likewise into
``cross_layers.<g>.<group>.<name>``.  Types must match
exactly.  numpy has no bfloat16 of its own: the reference's bfloat16
arrays (the ``ml_dtypes`` extension type, which ``torch.from_numpy``
rejects) are carried over bit for bit through ``uint16``, and the port
hands its bfloat16 tensors out as their ``uint16`` bits, as the
checkpoints store them.  ``opt_state_to_jax`` / ``opt_state_from_jax``
do the same for the AdamW state (``step``, ``m``, ``v``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..optim import AdamState
from .config import ModelConfig
from .transformer import Transformer, n_cross_layers

# the reference's layer stacks and the port's module lists
_STACKS = {"blocks": "layers", "cross_blocks": "cross_layers"}
_LISTS = {v: k for k, v in _STACKS.items()}


def to_tensor(a, dtype=None) -> torch.Tensor:
    """A numpy array (float32, int, or the bfloat16 extension type) as a
    CPU tensor of the same type and bits; ``uint16`` bits become
    bfloat16 when ``dtype`` is ``torch.bfloat16``.  A tensor is returned
    as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (dtype == torch.bfloat16
                                      and a.dtype == np.uint16):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as its ``uint16``
    bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree, cfg):
    """The reference's nested tree as ``{port name: array}``."""
    n_cross = n_cross_layers(cfg)
    sizes = {"blocks": cfg.n_layers - n_cross, "cross_blocks": n_cross}
    flat = {k: v for k, v in tree.items() if k not in _STACKS}
    for stack, port in _STACKS.items():
        for key, val in tree.get(stack, {}).items():
            groups = val.items() if isinstance(val, dict) else [(None, val)]
            for name, arr in groups:
                if len(arr) != sizes[stack]:
                    raise ValueError(f"{stack}/{key}/{name}: {len(arr)} "
                                     f"layers, config has {sizes[stack]}")
                for i in range(sizes[stack]):
                    path = f"{port}.{i}.{key}" + (f".{name}" if name
                                                  else "")
                    flat[path] = arr[i]
    return flat


def _unflatten(named):
    """``{port name: tensor}`` as the reference's nested tree of host
    tensors, the layers stacked on a leading axis: the inverse of
    ``_flatten``."""
    tree, stacks = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in _LISTS:
            stacks.setdefault((_LISTS[parts[0]], *parts[2:]), {})[
                int(parts[1])] = t
        else:
            tree[name] = t.detach().cpu()
    for path, per_layer in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack([per_layer[i].detach().cpu()
                                      for i in sorted(per_layer)])
    return tree


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def param_tree(model: Transformer):
    """The model's parameters as the reference's nested tree of host
    tensors (``blocks/attn/wq [L, ...]``, ``cross_blocks/attn/gate
    [G]`` ...)."""
    return _unflatten(dict(model.named_parameters()))


def params_to_jax(model: Transformer):
    """The model's parameters as the reference's nested tree of numpy
    arrays (bfloat16 as ``uint16`` bits): the inverse of
    ``params_from_jax``."""
    return _map(to_numpy, param_tree(model))


@torch.no_grad()
def load_params(model: Transformer, tree):
    """Copy a tree in the reference's layout (numpy arrays, ``uint16``
    bits for bfloat16, or tensors) into ``model``'s parameters; raises
    unless names, shapes and types all agree."""
    flat = _flatten(tree, model.cfg)
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"parameter names disagree: only in the tree "
                         f"{sorted(set(flat) - set(params))}, only in the "
                         f"port {sorted(set(params) - set(flat))}")
    for name, arr in flat.items():
        p = params[name]
        t = to_tensor(arr, p.dtype)
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: tree has {tuple(t.shape)} {t.dtype}, "
                             f"the port {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` holding the reference's parameters
    ``tree`` (nested dicts of numpy arrays)."""
    return load_params(Transformer(cfg, device=resolve_device(device)),
                       tree)


def opt_state_to_jax(state: AdamState):
    """The AdamW state as ``{"step", "m", "v"}`` in the reference's
    layout, numpy (``repro.optim.AdamState(**...)`` rebuilds it)."""
    return {"step": to_numpy(state.step),
            "m": _map(to_numpy, _unflatten(state.m)),
            "v": _map(to_numpy, _unflatten(state.v))}


def opt_state_from_jax(tree, cfg: ModelConfig, device="cuda") -> AdamState:
    """An ``AdamState`` on ``device`` from the reference's AdamW state
    (its ``AdamState`` or a ``{"step", "m", "v"}`` dict of numpy
    trees)."""
    dev = resolve_device(device)
    get = tree.get if isinstance(tree, dict) else \
        (lambda k: getattr(tree, k))

    def moments(t):
        return {n: to_tensor(a).to(dev)
                for n, a in _flatten(t, cfg).items()}

    step = torch.tensor(np.asarray(get("step")).item(), dtype=torch.int32)
    return AdamState(step=step, m=moments(get("m")),
                     v=moments(get("v")))
