"""Parameter, optimizer-state, batch and cache placements on a
``DeviceMesh`` (DP + TP + SP + FSDP + EP), and the helpers that place a
model, its AdamW state, a batch and a cache as DTensors.

The rules are the reference's (``repro/models/params.py``), kept here in
a copy of their own:

* TP over the ``model`` axis: attention heads, FFN hidden, MoE hidden,
  vocab — with divisibility checks and a greedy fallback to other dims
  (hymba's 25 heads do not divide 16, so d_model is split instead).
* ZeRO-3 / FSDP over the ``data`` axis: every weight also splits its
  largest remaining divisible dim over ``data`` (the optimizer state
  mirrors the parameters).
* ``pod``: pure data parallelism for parameters (replicated); the batch
  is split over ``(pod, data)``.

The port's layout has no layer-stack dimension (``layers.<i>.<group>.
<name>``, one cache dict per layer in ``layer_order``), so each spec is
the reference's with its leading stack dimension(s) dropped.  A spec is
a tuple with one entry per tensor dimension: an axis name, a tuple of
axis names (split over their product, the first the slowest), or None.
``to_placements`` turns it into DTensor placements.  The specs read only
the mesh's axis names and sizes (``mesh_dim_names``, ``shape``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

# preferred (model_dim, data_dim) picks by leaf name, indexed from the END
# of the shape (negative = from the right), None = greedy
_PREFS = {
    "embed":    (-2, -1),    # [.., V, D]: vocab->model, D->data
    "lm_head":  (-1, -2),    # [.., D, V]: vocab->model, D->data
    "wq":       (-2, -3),    # [.., D, H, dh]: heads->model, D->data
    "wk":       (-2, -3),
    "wv":       (-2, -3),
    "wo":       (-2, -1),    # [.., Hdh, D]
    "w1":       (-1, -2),    # [.., (E,) D, F]
    "w3":       (-1, -2),
    "w2":       (-2, -1),    # [.., (E,) F, D]
    "in_proj":  (-1, -2),
    "out_proj": (-2, -1),
}

CACHE_KV = ("k", "v", "k_scale", "v_scale")


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape), strict=True))


def _axis_size(mesh, name):
    return axis_sizes(mesh).get(name, 1)


def _dp(mesh, dp_axes):
    """(split axes, their total size, the spec entry) of the DP axes
    larger than one."""
    dp = tuple(a for a in dp_axes if _axis_size(mesh, a) > 1)
    size = math.prod(_axis_size(mesh, a) for a in dp)
    entry = (dp if len(dp) > 1 else dp[0]) if dp else None
    return dp, size, entry


def _spec_for(shape, name, model_size, data_size, model_axis="model",
              data_axis="data"):
    """The spec of one parameter of ``shape`` named ``name``."""
    nd = len(shape)
    spec = [None] * nd

    def try_assign(dim, axis, size):
        if dim is None or size <= 1:
            return False
        if dim < 0:
            dim = nd + dim
        if not 0 <= dim < nd:
            return False
        if spec[dim] is not None or shape[dim] % size != 0 \
                or shape[dim] < size:
            return False
        spec[dim] = axis
        return True

    pref_m, pref_d = _PREFS.get(name, (None, None))
    by_size = sorted(range(nd), key=lambda i: -shape[i])
    # model axis: preferred dim, else greedy largest divisible
    if not try_assign(pref_m, model_axis, model_size) and model_size > 1:
        for dim in by_size:
            if try_assign(dim, model_axis, model_size):
                break
    # data axis (ZeRO-3): preferred, else greedy largest remaining
    if not try_assign(pref_d, data_axis, data_size) and data_size > 1:
        for dim in by_size:
            if try_assign(dim, data_axis, data_size):
                break
    return tuple(spec)


def _named(tree):
    """``(name, tensor)`` pairs of a module's parameters or a mapping."""
    if isinstance(tree, nn.Module):
        return tree.named_parameters()
    return tree.items()


def param_pspecs(cfg, mesh, params, zero3=True):
    """``{name: spec}`` for every parameter of ``params`` (a
    ``Transformer`` or a ``{name: tensor}`` mapping such as an AdamW
    moment dict).  Vectors and scalars are replicated."""
    model_size = _axis_size(mesh, "model")
    data_size = _axis_size(mesh, "data") if zero3 else 1
    specs = {}
    for name, t in _named(params):
        if t.dim() <= 1:
            specs[name] = (None,) * t.dim()
        else:
            specs[name] = _spec_for(tuple(t.shape), name.rsplit(".", 1)[-1],
                                    model_size, data_size)
    return specs


def opt_pspecs(cfg, mesh, state, zero3=True):
    """The AdamW state's specs: ``m``/``v`` mirror the parameters', the
    step (a host scalar) is replicated."""
    return {"step": (), "m": param_pspecs(cfg, mesh, state.m, zero3),
            "v": param_pspecs(cfg, mesh, state.v, zero3)}


def batch_pspecs(mesh, batch, dp_axes):
    """``{name: spec}``: each input's batch dim over the DP axes when it
    divides, the rest replicated."""
    dp, dp_size, entry = _dp(mesh, dp_axes)
    specs = {}
    for name, t in batch.items():
        spec = [None] * t.dim()
        if dp and t.dim() >= 1 and t.shape[0] % dp_size == 0 \
                and t.shape[0] >= dp_size:
            spec[0] = entry
        specs[name] = tuple(spec)
    return specs


def _cache_leaf_spec(name, shape, model_size, dp, dp_size, dp_entry):
    nd = len(shape)
    spec = [None] * nd
    if nd == 0:
        return ()
    batch_ok = dp and shape[0] % dp_size == 0 and shape[0] >= dp_size
    if name in CACHE_KV and nd >= 4:
        s_dim, h_dim = 1, 2
        if batch_ok:
            spec[0] = dp_entry
        elif dp and shape[s_dim] % dp_size == 0:
            spec[s_dim] = dp_entry
        if shape[h_dim] % model_size == 0 and shape[h_dim] >= model_size:
            spec[h_dim] = "model"
        elif spec[s_dim] is None and shape[s_dim] % model_size == 0:
            spec[s_dim] = "model"
    elif name in ("state", "conv") and nd >= 2:
        if batch_ok:
            spec[0] = dp_entry
        for dim in sorted(range(1, nd), key=lambda i: -shape[i]):
            if shape[dim] % model_size == 0 and shape[dim] >= model_size:
                spec[dim] = "model"
                break
    return tuple(spec)


def cache_pspecs(cfg, mesh, cache, dp_axes):
    """KV / SSM cache placements, the structure of ``cache`` (a list of
    per-layer dicts, ``make_cache``'s) with a spec per tensor: batch over
    the DP axes when it divides, else the cache *sequence* over them
    (long-context decode); KV heads over ``model`` when they divide, else
    the sequence over ``model``; an SSM state or conv window's largest
    divisible dim over ``model``."""
    model_size = _axis_size(mesh, "model")
    dp, dp_size, entry = _dp(mesh, dp_axes)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _cache_leaf_spec(name, tuple(node.shape), model_size, dp,
                                dp_size, entry)

    return [walk(layer) for layer in cache]


# --------------------------------------------------------------- DTensors
def to_placements(mesh, spec):
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh dim that tensor dim ``d`` is split over (a dim on
    ``("pod", "data")`` is ``Shard`` on both), ``Replicate`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(d)
    return out


def local_shape(shape, mesh, placements):
    """The local shard's shape of a tensor of ``shape``: every split dim
    divided by its mesh dims' sizes (the specs only split dims that
    divide)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(md)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over mesh dim {md} of {n}")
            out[p.dim] //= n
    return tuple(out)


def place(t, mesh, spec, device=None, fill=None):
    """``t`` as a DTensor on ``mesh`` placed by ``spec``.  A meta ``t``
    becomes only its local shard, allocated on ``device`` (default: the
    meta device; ``fill`` a value to write into it, else it is left
    unset): no full tensor is materialised.  A tensor with values is
    sliced to this rank's shard (every rank must hold the same
    values)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(mesh, spec)
    if t.device.type != "meta":
        return distribute_tensor(t.detach(), mesh, placements,
                                 src_data_rank=None)
    local = torch.empty(local_shape(t.shape, mesh, placements),
                        dtype=t.dtype, device=device or "meta")
    if fill is not None:
        local.fill_(fill)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _set_param(model, name, value):
    prefix, _, leaf = name.rpartition(".")
    mod = model.get_submodule(prefix) if prefix else model
    if isinstance(mod, nn.ParameterDict):
        mod[leaf] = value
    else:
        setattr(mod, leaf, value)


@torch.no_grad()
def place_model(model, mesh, zero3=True, device=None):
    """Replace every parameter of ``model`` by a DTensor placed by
    ``param_pspecs``, in place; returns the specs.  A meta model gets
    unset local shards on ``device`` (see ``place``)."""
    specs = param_pspecs(model.cfg, mesh, model, zero3)
    for name, p in list(model.named_parameters()):
        _set_param(model, name, nn.Parameter(
            place(p, mesh, specs[name], device),
            requires_grad=p.requires_grad))
    return specs


def place_opt_state(cfg, state, mesh, zero3=True, device=None):
    """An ``AdamState`` placed by ``opt_pspecs``: its moments as their
    parameters, ``step`` the host scalar, replicated by construction (a
    meta state becomes zeroed local shards on ``device``)."""
    specs = opt_pspecs(cfg, mesh, state, zero3)
    moments = [{n: place(t, mesh, specs[part][n], device, fill=0.0)
                for n, t in getattr(state, part).items()}
               for part in ("m", "v")]
    return type(state)(step=state.step, m=moments[0], v=moments[1])


def place_batch(batch, mesh, dp_axes, device=None):
    """``{name: DTensor}``: each input placed by ``batch_pspecs``."""
    specs = batch_pspecs(mesh, batch, dp_axes)
    return {n: place(t, mesh, specs[n], device, fill=0)
            for n, t in batch.items()}


def place_cache(cfg, cache, mesh, dp_axes, device=None):
    """The cache list with every tensor placed by ``cache_pspecs`` (a
    meta cache becomes zeroed local shards on ``device``)."""
    specs = cache_pspecs(cfg, mesh, cache, dp_axes)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return place(node, mesh, spec, device, fill=0)

    return [walk(c, s) for c, s in zip(cache, specs)]
