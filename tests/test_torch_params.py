"""The port's placements (``repro_torch.models.params``) against the
reference's ``PartitionSpec``s, leaf by leaf and exactly, for all ten
architectures at full width on both production meshes.

The reference's ``param_pspecs`` / ``batch_pspecs`` / ``cache_pspecs``
read only the mesh's axis names and device-array shape, so they get a
stand-in mesh (``axis_names``, ``devices=np.empty(shape)``) and need no
forced host devices; the port's read ``mesh_dim_names`` and ``shape``.
The reference stacks layers on leading dims (``blocks [L, ...]``, the
vision family's self caches ``[G, k-1, B, ...]``); the port keeps one
tensor per layer, so each reference spec is compared with its stack
dims dropped.  Covered: parameters with ZeRO-3 on and off, the AdamW
moments (the reference dry run's ``_opt_specs``: m/v mirror the
parameters, the step replicated), every applicable shape's batch, and
the ``decode_32k`` caches in the activation type, int8 and the ring
(where the reference's dry run makes one), and ``long_500k``'s.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import Transformer, make_cache  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402
from repro_torch.models.transformer import layer_order  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    shape, axes = MESHES[kind]
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    port = types.SimpleNamespace(mesh_dim_names=axes, shape=shape,
                                 size=lambda i: shape[i])
    return ref, port


def _dp(axes):
    return tuple(a for a in ("pod", "data") if a in axes)


def _spec(p):
    """A reference ``PartitionSpec`` as the port's tuple."""
    return tuple(p)


def _flat_params(tree, cfg):
    """The reference's parameter tree of specs as ``{port name: spec}``,
    the stack dim dropped."""
    out = {}
    stacks = {"blocks": "layers", "cross_blocks": "cross_layers"}
    for key, val in tree.items():
        if key not in stacks:
            out[key] = _spec(val)
            continue
        n = (jm.transformer.n_cross_layers(cfg) if key == "cross_blocks"
             else cfg.n_layers - jm.transformer.n_cross_layers(cfg))
        for group, sub in val.items():
            leaves = sub.items() if isinstance(sub, dict) else [(None, sub)]
            for name, spec in leaves:
                for i in range(n):
                    path = f"{stacks[key]}.{i}.{group}" + (
                        f".{name}" if name else "")
                    out[path] = _spec(spec)[1:]
    return out


_REF_PARAMS = {}


def _ref_params(arch):
    if arch not in _REF_PARAMS:
        cfg = jcfgs.get_config(arch)
        p_abs = jm.abstract_params(cfg)
        _REF_PARAMS[arch] = (cfg, p_abs,
                             jax.eval_shape(JAdamW(lr=1e-4).init, p_abs))
    return _REF_PARAMS[arch]


@pytest.mark.parametrize("zero3", [True, False])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", tcfgs.ARCH_NAMES)
def test_param_and_opt_specs_match_reference(arch, mesh_kind, zero3):
    jcfg, p_abs, o_abs = _ref_params(arch)
    rmesh, pmesh = _meshes(mesh_kind)
    want = _flat_params(jm.param_pspecs(jcfg, rmesh, p_abs, zero3=zero3),
                        jcfg)
    cfg = tcfgs.get_config(arch)
    model = Transformer(cfg, device="meta")
    got = tp.param_pspecs(cfg, pmesh, model, zero3=zero3)
    assert got == want
    # every split divides: the local shard of each parameter exists
    for name, p in model.named_parameters():
        tp.local_shape(p.shape, pmesh, tp.to_placements(pmesh, got[name]))
    # AdamW: m / v mirror the parameters, the step replicated
    state = AdamW().init(model)
    opt = tp.opt_pspecs(cfg, pmesh, state, zero3=zero3)
    assert opt["step"] == ()
    for part in ("m", "v"):
        ref = _flat_params(jm.param_pspecs(jcfg, rmesh, getattr(o_abs, part),
                                           zero3=zero3), jcfg)
        assert opt[part] == ref == got


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", tcfgs.ARCH_NAMES)
def test_batch_specs_match_reference(arch, mesh_kind):
    rmesh, pmesh = _meshes(mesh_kind)
    axes = MESHES[mesh_kind][1]
    jcfg, cfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    shapes = [s for s in tcfgs.SHAPES.values()
              if tcfgs.shape_applicable(cfg, s)]
    assert len(shapes) == (4 if cfg.sub_quadratic else 3)
    for shape in shapes:
        want = jm.batch_pspecs(rmesh, jcfgs.input_specs(jcfg, shape),
                               _dp(axes))
        batch = tcfgs.input_specs(cfg, shape)
        assert set(batch) == set(want)
        for k, t in batch.items():
            ref = jcfgs.input_specs(jcfg, shape)[k]
            assert tuple(t.shape) == ref.shape
            assert str(t.dtype).split(".")[-1] == str(ref.dtype)
        got = tp.batch_pspecs(pmesh, batch, _dp(axes))
        assert got == {k: _spec(v) for k, v in want.items()}, shape.name


def _cache_variants():
    """(arch, shape, variant) of every cache the reference dry run
    makes at decode: the activation type and int8 everywhere, the ring
    where its build_cell makes one; long_500k where applicable."""
    out = []
    for arch in tcfgs.ARCH_NAMES:
        cfg = tcfgs.get_config(arch)
        variants = ["act", "int8"]
        if cfg.window > 0 and not cfg.global_every and not cfg.swa_all_but:
            variants.append("ring")
        out += [(arch, "decode_32k", v) for v in variants]
        if cfg.sub_quadratic:
            out.append((arch, "long_500k", "act"))
    return out


def _cache_cfg(mod, arch, shape, variant):
    """The reference dry run's ``build_cell`` overrides for a decode
    cell."""
    cfg = mod.get_config(arch)
    cache_len = shape.seq_len
    over = dict(kv_cache_dtype="int8" if variant == "int8" else "none")
    if variant == "ring":
        cache_len = min(cache_len, cfg.window)
        over["window_ring_cache"] = True
    over["max_cache_len"] = cache_len
    return dataclasses.replace(cfg, **over), cache_len


def _flat_cache(tree, cfg):
    """The reference's cache tree (of specs or shapes) as the port's list
    of per-layer dicts in ``layer_order``, stack dims dropped (every layer
    of a stack has the same)."""
    if not cfg.cross_attn_every:
        return [_drop(tree["blocks"], 1) for _ in range(cfg.n_layers)]
    return [_drop(tree["cross"], 1) if cross else _drop(tree["self"], 2)
            for cross, _ in layer_order(cfg)]


def _drop(node, n):
    if isinstance(node, dict):
        return {k: _drop(v, n) for k, v in node.items()}
    return _spec(node)[n:]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch,shape_name,variant", _cache_variants())
def test_cache_specs_match_reference(arch, shape_name, variant, mesh_kind):
    rmesh, pmesh = _meshes(mesh_kind)
    axes = MESHES[mesh_kind][1]
    shape = tcfgs.SHAPES[shape_name]
    jcfg, L = _cache_cfg(jcfgs, arch, shape, variant)
    cfg, _ = _cache_cfg(tcfgs, arch, shape, variant)
    B = shape.global_batch
    c_abs = jax.eval_shape(lambda: jm.make_cache(jcfg, B, L))
    want = _flat_cache(jm.cache_pspecs(jcfg, rmesh, c_abs, _dp(axes)), cfg)
    cache = make_cache(cfg, B, L, "meta")
    got = tp.cache_pspecs(cfg, pmesh, cache, _dp(axes))
    assert got == want
    # the shapes agree too, stack dims dropped
    ref_shapes = _flat_cache(jax.tree.map(lambda a: tuple(a.shape), c_abs),
                             cfg)
    shapes = jax.tree.map(lambda t: tuple(t.shape), cache)
    assert shapes == ref_shapes


def test_to_placements_splits_a_dim_over_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 16, 16))
    spec = (("pod", "data"), None, "model")
    assert tp.to_placements(mesh, spec) == [Shard(0), Shard(0), Shard(2)]
    assert tp.to_placements(mesh, (None, None)) == [Replicate()] * 3
