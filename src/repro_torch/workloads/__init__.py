"""Workload layer of the PyTorch port: the recipe generators, copied
from ``repro.workloads.recipes`` so the port builds the same recipe
instances (``montage-77-s0`` sits in the mini survey's graph axis).

Only the recipe grammar of ``resolve_workload`` is carried over;
WfFormat ingestion and the dataset manifests are still to port
(ROADMAP, "workloads/wfformat.py and datasets.py")."""
from .recipes import (Recipe, RECIPE_FAMILIES, PEGASUS_EQUIVALENT,
                      instance_rng_seed, make_instance, parse_instance,
                      sample_dist)

__all__ = [
    "Recipe", "RECIPE_FAMILIES", "PEGASUS_EQUIVALENT", "instance_rng_seed",
    "make_instance", "parse_instance", "sample_dist", "resolve_workload",
]


def resolve_workload(name: str, seed: int = 0):
    """Build a recipe instance (``<family>-<n>-s<seed>``) by name, or
    return ``None`` when the name is not one — the registry's signal to
    raise its own KeyError.  ``wf:<path>`` raises ``NotImplementedError``:
    the WfFormat reader is not ported yet."""
    if name.startswith("wf:"):
        raise NotImplementedError(
            f"{name!r}: WfFormat files are not supported by repro_torch "
            f"yet (ROADMAP: port workloads/wfformat.py and datasets.py)")
    if parse_instance(name) is not None:
        return make_instance(name, seed=seed)
    return None
