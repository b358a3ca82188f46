"""Workload layer of the PyTorch port — a copy of ``repro.workloads``:
WfFormat ingestion, the recipe generators and the dataset manifests
with adaptive bucket edges.

The graph registry (``core.graphs.make_graph``) falls back to
``resolve_workload`` for any name it does not know, so recipe instances
(``montage-220-s1``) and WfFormat files (``wf:<path.json>``) work
everywhere registered generator names do: the survey's ``--dataset``
axis, the parity suites and the manifests."""
from .recipes import (Recipe, RECIPE_FAMILIES, PEGASUS_EQUIVALENT,
                      instance_rng_seed, make_instance, parse_instance,
                      sample_dist)
from .wfformat import load_wfformat, dump_wfformat, save_wfformat
from .datasets import (Manifest, MANIFESTS, WFCOMMONS_MINI, build_dataset,
                       compute_bucket_edges, compute_w_buckets,
                       default_manifest, get_manifest, w_bucket)

__all__ = [
    "Recipe", "RECIPE_FAMILIES", "PEGASUS_EQUIVALENT", "instance_rng_seed",
    "make_instance", "parse_instance", "sample_dist",
    "load_wfformat", "dump_wfformat", "save_wfformat",
    "Manifest", "MANIFESTS", "WFCOMMONS_MINI", "build_dataset",
    "compute_bucket_edges", "compute_w_buckets", "default_manifest",
    "get_manifest", "w_bucket", "resolve_workload",
]


def resolve_workload(name: str, seed: int = 0):
    """Build a workload by name: a recipe instance
    (``<family>-<n>-s<seed>``) or a WfFormat file (``wf:<path>``).
    Returns ``None`` when the name matches neither grammar — the
    registry's signal to raise its own KeyError.  For ``wf:`` instances
    the trace data is fixed; ``seed`` only perturbs the user-imode
    estimate sampling (recipe instances resample everything)."""
    if name.startswith("wf:"):
        return load_wfformat(name[3:], seed=seed)
    if parse_instance(name) is not None:
        return make_instance(name, seed=seed)
    return None
