"""Carry the reference package's parameters across to the port.

``params_from_jax(tree, cfg)`` takes the numpy tree that
``jax.tree.map(np.asarray, params)`` gives for the reference's
``init_params(cfg, key)`` and returns a ``Transformer`` holding the same
values.  Layouts are the same on both sides, so the conversion is a
copy: the layer stack ``blocks/<group>/<name> [L, ...]`` is split into
``layers.<i>.<group>.<name>``.  Types must match exactly; a bfloat16
array (numpy's ``bfloat16`` extension type, which ``torch.from_numpy``
rejects) is carried over bit for bit through ``uint16``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .transformer import Transformer


def to_tensor(a) -> torch.Tensor:
    """A numpy array (float32, int, or the bfloat16 extension type) as a
    CPU tensor of the same type and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree, cfg):
    if "cross_blocks" in tree:
        raise NotImplementedError("cross-attention blocks are not ported "
                                  "to repro_torch yet (ROADMAP.md)")
    flat = {k: v for k, v in tree.items() if k != "blocks"}
    for key, val in tree.get("blocks", {}).items():
        groups = val.items() if isinstance(val, dict) else [(None, val)]
        for name, arr in groups:
            if len(arr) != cfg.n_layers:
                raise ValueError(f"blocks/{key}/{name}: {len(arr)} layers, "
                                 f"config has {cfg.n_layers}")
            for i in range(cfg.n_layers):
                path = f"layers.{i}.{key}" + (f".{name}" if name else "")
                flat[path] = arr[i]
    return flat


@torch.no_grad()
def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` holding the reference's parameters
    ``tree`` (nested dicts of numpy arrays)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    flat = _flatten(tree, cfg)
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"parameter names disagree: only in the tree "
                         f"{sorted(set(flat) - set(params))}, only in the "
                         f"port {sorted(set(params) - set(flat))}")
    for name, arr in flat.items():
        t = to_tensor(arr)
        p = params[name]
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: tree has {tuple(t.shape)} {t.dtype}, "
                             f"the port {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model
