"""The port's vectorized ESTEE simulator: padded graph specs, in-loop
schedulers, the batched dynamic simulator and its grid runner."""
from .specs import (GraphSpec, BucketedGraphSpec, BucketGroup, encode_graph,
                    as_bucketed, bucket_shape, pad_spec, pad_specs, pad_to,
                    round_up, spec_from_numpy, stack_specs, t_bucket,
                    T_EDGES, PAD_MULTIPLE, FRONTIER_FLOOR, frontier_cap,
                    frontier_caps_for, frontier_caps_for_spec)
from .sim import (make_bucket_dynamic_simulator, BucketedGridRunner,
                  DynamicGridRunner, simulate_dynamic_grid,
                  DOWNLOAD_SLOTS, PAIR_SLOTS, SimResult)
from .api import SimConfig, build, build_for_graph, make_grid_runner
from .scheduling import (VEC_SCHEDULERS, make_bucket_scheduler,
                         make_bucket_greedy_placer, bucket_ready_tasks,
                         bucket_transfer_costs, frontier_mask,
                         bucket_blevel, bucket_tlevel, rank_priorities)
from .waterfill import waterfill, waterfill_simple

__all__ = ["GraphSpec", "BucketedGraphSpec", "BucketGroup", "encode_graph",
           "as_bucketed", "bucket_shape", "pad_spec", "pad_specs", "pad_to",
           "round_up", "spec_from_numpy", "stack_specs", "t_bucket",
           "T_EDGES", "PAD_MULTIPLE", "FRONTIER_FLOOR", "frontier_cap",
           "frontier_caps_for", "frontier_caps_for_spec",
           "make_bucket_dynamic_simulator", "BucketedGridRunner",
           "DynamicGridRunner", "simulate_dynamic_grid",
           "DOWNLOAD_SLOTS", "PAIR_SLOTS", "SimResult",
           "SimConfig", "build", "build_for_graph", "make_grid_runner",
           "VEC_SCHEDULERS", "make_bucket_scheduler",
           "make_bucket_greedy_placer", "bucket_ready_tasks",
           "bucket_transfer_costs", "frontier_mask",
           "bucket_blevel", "bucket_tlevel", "rank_priorities",
           "waterfill", "waterfill_simple"]
