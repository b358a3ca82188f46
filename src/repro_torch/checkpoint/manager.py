"""Fault-tolerant checkpoints of the port's training state, in the
reference package's on-disk layout (``repro/checkpoint/manager.py``):

* atomic: write to ``<dir>/tmp.<step>`` then ``os.replace`` to
  ``<dir>/step_<step>`` — a preempted writer never corrupts the latest
  checkpoint;
* keep-N garbage collection;
* ``params.npz`` and ``opt_state.npz`` with the reference's joined-path
  keys (``blocks/attn/wq`` stacked over layers; ``.step``, ``.m/...``,
  ``.v/...`` for AdamW), dtypes preserved (bfloat16 stored as its
  ``uint16`` bits, named in ``__meta__``), and ``meta.json``.

So a checkpoint the reference writes restores into the port, and the
reverse.  ``restore`` loads into an existing model and ``AdamState`` in
place.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from ..models.convert import _flatten, _unflatten, load_params, param_tree, \
    to_numpy, to_tensor


def _flat_keys(tree, prefix=""):
    """A nested tree as ``{"a/b/c": leaf}`` (the reference's keys)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_keys(v, key + "/"))
        else:
            out[key] = v
    return out


def _nest(flat):
    """The inverse of ``_flat_keys``."""
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def save_flat(path, flat):
    """``{key: tensor}`` to an ``.npz``; bfloat16 as ``uint16`` bits,
    named in ``__meta__``."""
    meta = {k: "bfloat16" for k, t in flat.items()
            if t.dtype == torch.bfloat16}
    np.savez(path, __meta__=json.dumps(meta),
             **{k: to_numpy(t) for k, t in flat.items()})


def load_flat(path):
    """``{key: tensor}`` from an ``.npz`` that ``save_flat`` or the
    reference's ``save_pytree`` wrote."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return {k: to_tensor(a, torch.bfloat16 if meta.get(k) == "bfloat16"
                         else None) for k, a in flat.items()}


def _opt_flat(state):
    flat = {".step": state.step}
    for part in ("m", "v"):
        for k, t in _flat_keys(_unflatten(getattr(state, part))).items():
            flat[f".{part}/{k}"] = t
    return flat


@torch.no_grad()
def _load_opt(state, flat, cfg):
    want = set(_opt_flat(state))
    if set(flat) != want:
        raise ValueError(f"optimizer checkpoint keys disagree: extra "
                         f"{sorted(set(flat) - want)}, missing "
                         f"{sorted(want - set(flat))}")
    state.step.copy_(flat[".step"].reshape(()))
    for part in ("m", "v"):
        mine = getattr(state, part)
        tree = _nest({k[len(part) + 2:]: t for k, t in flat.items()
                      if k.startswith(f".{part}/")})
        for name, t in _flatten(tree, cfg).items():
            if t.shape != mine[name].shape or t.dtype != mine[name].dtype:
                raise ValueError(f"{part}/{name}: checkpoint has "
                                 f"{tuple(t.shape)} {t.dtype}, the state "
                                 f"{tuple(mine[name].shape)} "
                                 f"{mine[name].dtype}")
            mine[name].copy_(t)


class CheckpointManager:
    def __init__(self, directory, keep=3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dirs(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        return sorted(out)

    @property
    def latest_step(self):
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def save(self, step, model, opt_state=None, extra=None):
        """Writes ``step_<step>`` (the model's parameters, the AdamW
        state when given, ``extra`` in ``meta.json``) and returns its
        path."""
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        save_flat(os.path.join(tmp, "params.npz"),
                  _flat_keys(param_tree(model)))
        if opt_state is not None:
            save_flat(os.path.join(tmp, "opt_state.npz"),
                      _opt_flat(opt_state))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "extra": extra or {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                       # atomic publish
        self._gc()
        return final

    def restore(self, model, opt_state=None, step=None):
        """Loads checkpoint ``step`` (default the latest) into ``model``
        and ``opt_state`` in place; returns ``{"step", "extra"}``, or
        None when there is none."""
        step = step if step is not None else self.latest_step
        if step is None:
            return None
        d = os.path.join(self.dir, f"step_{step}")
        load_params(model, _nest(load_flat(os.path.join(d, "params.npz"))))
        if opt_state is not None:
            _load_opt(opt_state, load_flat(os.path.join(d,
                                                        "opt_state.npz")),
                      model.cfg)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return {"step": step, "extra": meta.get("extra", {})}

    def _gc(self):
        dirs = self._step_dirs()
        for _, path in dirs[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)
