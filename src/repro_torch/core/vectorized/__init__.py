"""The port's vectorized ESTEE simulator: padded graph specs, in-loop
schedulers, the batched static and dynamic simulators, the grid runner
and the grid engine (``engine.py``: ``ShardedGridRunner``,
``DoubleBufferQueue``).  The names are the reference package's
(``__all__`` of ``repro.core.vectorized``) but for its XLA-only ones:
``abstract_spec``, the jit trace counters and the compile caches
(``engine.py`` says why); ``capture_counter`` counts the CUDA graphs of
the event step instead, and ``span_log`` reads the span record that
every runner call leaves (``_spans``)."""
from .specs import (GraphSpec, BucketedGraphSpec, BucketGroup, encode_graph,
                    as_bucketed, bucket_shape, pad_spec, pad_specs, pad_to,
                    round_up, spec_from_numpy, stack_specs,
                    t_bucket, T_EDGES, PAD_MULTIPLE, FRONTIER_FLOOR,
                    frontier_cap, frontier_caps_for, frontier_caps_for_spec)
from .sim import (make_simulator, simulate_batch, make_dynamic_simulator,
                  simulate_dynamic_grid, make_bucket_simulator,
                  make_bucket_dynamic_simulator, DynamicGridRunner,
                  BucketedGridRunner, DOWNLOAD_SLOTS, PAIR_SLOTS, SimResult)
from .api import SimConfig, build, build_for_graph, make_grid_runner
from .engine import ShardedGridRunner, DoubleBufferQueue, capture_counter
from ._spans import span_log
from .scheduling import (VEC_SCHEDULERS, make_vec_scheduler,
                         make_bucket_scheduler, bucket_ready_tasks,
                         frontier_mask, make_static_blevel_scheduler,
                         make_static_tlevel_scheduler,
                         make_static_mcp_scheduler, make_etf_scheduler,
                         make_random_scheduler, make_greedy_placer,
                         make_bucket_greedy_placer, make_blevel_fn,
                         make_tlevel_fn, make_transfer_costs,
                         bucket_transfer_costs, bucket_blevel, bucket_tlevel,
                         rank_priorities)
from .waterfill import waterfill, waterfill_simple

__all__ = ["GraphSpec", "BucketedGraphSpec", "BucketGroup", "encode_graph",
           "as_bucketed", "bucket_shape", "pad_spec", "pad_specs", "pad_to",
           "round_up", "spec_from_numpy", "stack_specs",
           "t_bucket", "T_EDGES", "PAD_MULTIPLE", "FRONTIER_FLOOR",
           "frontier_cap", "frontier_caps_for", "frontier_caps_for_spec",
           "make_simulator", "simulate_batch",
           "make_dynamic_simulator", "simulate_dynamic_grid",
           "make_bucket_simulator", "make_bucket_dynamic_simulator",
           "DynamicGridRunner", "BucketedGridRunner",
           "DOWNLOAD_SLOTS", "PAIR_SLOTS", "SimResult",
           "SimConfig", "build", "build_for_graph", "make_grid_runner",
           "ShardedGridRunner", "DoubleBufferQueue", "capture_counter",
           "span_log",
           "VEC_SCHEDULERS", "make_vec_scheduler", "make_bucket_scheduler",
           "bucket_ready_tasks", "frontier_mask",
           "make_static_blevel_scheduler", "make_static_tlevel_scheduler",
           "make_static_mcp_scheduler", "make_etf_scheduler",
           "make_random_scheduler", "make_greedy_placer",
           "make_bucket_greedy_placer",
           "make_blevel_fn", "make_tlevel_fn", "make_transfer_costs",
           "bucket_transfer_costs", "bucket_blevel", "bucket_tlevel",
           "rank_priorities", "waterfill", "waterfill_simple"]
