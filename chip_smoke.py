"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card

Drives the port's main paths through the entry points a user calls,
and checks them: the paper survey's batched dynamic simulator, the
static simulator and the ``genetic-vec`` scheduler on it, all with the
max-min waterfill kernel (K1), serving and training Hymba-1.5B with
the flash attention (K2) and Mamba-2 SSD scan (K3) kernels, serving
the other seven architecture families through K2, and training the
audio, vision and MoE families through K2, and the mesh path (a
placed model on a one-card mesh, rank 0's share of a 256-card plan, and
the dry run).  Phases, each
printing one JSON line:

1. ``env``: the card's name and power limit.
2. ``build``: compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, started
   together) and prints the seconds taken.
3. ``kernel_waterfill``: both routes of the waterfill kernel (``warp``
   and ``block``, forced through the wrapper's private entry) against
   the plain PyTorch version on the card, bitwise or fail — random flow
   sets at R = 4096 for W in {1, 8, 16, 32} (F = 4W) and the block
   route alone at W 64 (F 256), edge cases at each W (all inactive,
   single-source contention, equal-share ties, worker ids outside
   [0, W), max_rounds 3), R 1, 7 and 33, and F 100 at W 20.  Both
   routes are timed in turns (warp, block, block, warp) at the survey's
   shape (R 96, W 32, F 128) and at R 4096: ``ms`` is device time of
   calls replayed from a CUDA graph, ``eager_ms`` CUDA events around a
   loop of calls, ``host_us`` the host's enqueue time per call; the
   plain version by CUDA events around eager calls.  Then K1 on the
   main path's own inputs: a hook of this script copies the inputs of
   every K1 call of one blevel run of the ``survey_full_width`` cell;
   both routes must be bitwise equal to the plain version on all of
   them, and each replays them from a CUDA graph (in turns); the plain
   version gives the filling rounds per row.  Last, the per-edge
   simulator's solve: F 992 and F 2016 flows per row (R 96, W 32), more
   than one block's threads, on the block route: bitwise, timed from a
   CUDA graph, beside the plain version and a bytes bound.
3b. ``kernel_greedy_place``: greedy's placement kernel against its plain
   version (``scheduling.greedy_place_plain`` on the card), bitwise in
   the proposed workers and the placer-iteration tally, or fail: the
   pegasus buckets of the benchmark's greedy cell at W 16 (R 360 at
   T160, R 240 at T512), R 1800 at T512 and W 32, W 40 (a lane strides
   over two words of workers); equal costs and loads, no worker with
   enough cores, no row placing, no input edge (D 0), and cybershake's
   80-input task placing in every other row.  Each cell shape is timed,
   with 30 % and with 3 % of the tasks placing:
   ``ms`` replayed from a CUDA graph, ``eager_ms`` by CUDA events, the
   plain version by CUDA events, beside a bytes bound (each input byte
   the placement needs read once, ``new_pw`` written once, at 3.35
   TB/s).
3c. ``kernel_list_schedule``: the static list schedule's kernel against
   its plain version (``scheduling.list_schedule_plain`` and
   ``blevel_priorities_plain`` on the card), bitwise in the assignment
   and the priorities, for ``blevel``, ``tlevel`` and ``mcp``, and in
   greedy's priorities alone, one launch a call, or fail: the
   benchmark cells' calls (elementary T512 at R 1800 and a four-card
   rank's 450, T160 at R 120 and 30, irw's T160 at E 2368 and T512 at R
   360, W 32 and C 16; a single-sim request of each pegasus bucket, R 1
   at W 16), the T2048 bucket, zero durations (b-level ties), no worker
   with a task's cores, bandwidths from 1e-30 to +inf MiB/s and W 40
   (a lane strides over two words of workers).  Each cell call is timed
   by CUDA events (placing and priorities alone), beside the plain
   version and a bound (its inputs read once, its outputs written once,
   the rank's T² comparisons and each task's terms over the workers).
4. ``golden``: the dynamic simulator against the reference package's
   recorded ``BENCH_PR7.json`` dynamic rows (blevel, maxmin, frontier
   on, 100 MiB/s, exact imode, msd 0).
5. ``survey_mini``: the mini survey grid without the agreement pass;
   every simulation must be ok.
6. ``survey_agreement``: the mini grid again through ``survey(...)``
   with the agreement pass: 512 ok simulations, 16 agreement rows and
   the ``__pergraph_path__`` row; each ``makespan_ratio`` (batched
   makespan on the card over the reference event loop's deterministic
   twin on the host) must equal the reference package's recorded value
   (``MINI_AGREEMENT``) within rtol 1e-5.  Prints the survey's wall
   time and events/s, the agreement pass's wall time, the geomean
   ``speedup`` and the per-graph against bucketed cold seconds.
7. ``survey_dataset``: the mini grid over ``--dataset wfcommons-mini``
   with the agreement pass: the derived edges must be (128, 288), all
   768 simulations ok, and the two bucket labels and 24 ratios equal
   the reference's recorded ones (``DATASET_AGREEMENT``); prints K1's
   launches by route.
8. ``survey_full_width``: the full grid's T512 bucket on cluster 32x4
   (W = 32, 128 flow slots, 64 resources), all 24 points, blevel and
   greedy on maxmin, through K1's plain version and K1 in turns
   (plain, kernel, kernel, plain) on the card; the results must agree
   and every launch of the main path must take the warp route.  Only
   K1 differs between the turns: greedy's placement kernel runs in
   both, as often in each.  One
   more blevel run through the kernel, under ``torch.profiler`` and
   outside the timed turns, gives the card's busy and idle share during
   a survey and K1's share of the device time.  Then the agreement at
   full width, at point 0 (32 MiB/s, exact, msd 0): each graph's twin
   makespan must equal the reference twin's recorded value exactly,
   and the kernel run's batched makespan the reference package's
   recorded one within rtol 1e-5 (``FULL_WIDTH_AGREEMENT``; crossvx
   under blevel, where the reference's frontier overflows, is printed
   and not compared).
9. ``survey_engine``: the same T512 x 32x4 group (24 points, blevel and
   greedy, maxmin) through the grid engine: all 96 rows in one
   simulator call with every step issued from the host (``vmap``
   eager) and with the event step replayed from a CUDA graph (``vmap``
   graph), and the rows streamed onto the card in 3 chunks of 32
   (``sharded`` graph, ``ShardedGridRunner``), in turns (a, b, c, c, b,
   a); then one eager streamed run.  Every run bitwise equal in every
   field, each graph run launching K1 as often as the eager run of the
   same calls (all ``warp``), and greedy's placement once a loop step,
   one capture per simulator call (3 for
   ``sharded``).  Prints events/s and wall ms per loop step of each,
   and the device busy and idle share of one more blevel graph run
   under the profiler.
10. ``survey_ranks``: the grid engine over two ranks, both on the one
   card (``cuda:0``), in a gloo group over localhost (the port's test
   arrangement; NCCL across physical cards stays unchecked here): (a)
   the same T512 x 32x4 group, blevel and greedy, through
   ``ShardedGridRunner(devices=2, stream_rows=32)`` in two processes
   (3 chunks of 32 rows, 16 a rank), against this process's one-card
   sharded run of the group: both ranks' gathered results bitwise in
   every field, one capture per chunk on each rank, each rank's K1
   launches all ``warp`` and one per loop step; each rank's wall time
   and events/s (time-sliced on one card: no multi-card speed); (b)
   ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
   repro_torch.survey --mini --no-agreement --engine sharded --devices 2
   --assert-compiles`` beside a one-card ``--devices 1`` run of the
   same command: both gates pass and the CSVs are equal.  A rank that
   fails or outlives 300 s ends the others and the phase.
11. ``static_golden``: the static simulator against the reference's
   recorded ``BENCH_PR7.json`` static rows (merge_triplets at 8x4,
   t2048_layered at 16x4): each graph scheduled by the port's
   ``build(..., scheduler="blevel")`` from exact estimates, padded to
   its bucket and simulated by ``build(...)`` with no scheduler through
   K1; events, steps and makespan exactly, ``transferred`` within rtol
   1e-5.
12. ``static_full_width``: the T512 bucket on 32x4 (W 32, 128 flow
    slots) through the static simulator: each graph x the five static
    schedules (placed on the card) x 100 and 512 MiB/s, 40 rows in one
    call with full-coverage frontier caps, through the plain waterfill
    and K1 in turns (plain, kernel, kernel, plain), then one kernel run
    with the step issued eagerly: every run bitwise equal, K1 launched
    as often eagerly as from the graph, and ``ok``, events, steps and
    makespan exactly the values the reference package recorded on a
    CPU (``STATIC_FULL_WIDTH``, ``tools/record_static_reference.py``);
    events/s of each, and one more kernel run under the profiler.
13. ``genetic_vec``: the reference event loop on fastcrossv at 32x4 with
    the port's ``make_scheduler("genetic-vec", seed=0)`` at its defaults
    (population 32, 16 generations: 17 batched calls of 32 rows through
    K1): makespan and every task's worker equal to the reference's
    recorded run (``GENETIC_VEC``); then 2 generations on the plain
    waterfill and on K1, both equal to the reference's 2-generation
    run; wall time per generation.
14. ``kernel_flash_attention``: K2 against its plain version on the card
   (float32 and bfloat16) at Hymba's prefill shape (B 4, Hq 25, Hkv 5,
   Sq 1536, Skv 1568, kv_len 1536, window 1024 and 0, the KV cache's
   strided layout), its decode shape (Sq 1), ``train_hymba``'s shape
   (Sq = Skv = 2048, no kv_len, the transposed projections; window 1024
   and 0: the forward pass and remat recompute of the bf16 training
   run, ``tc``), gemma3's head dim 256, an
   MQA case (one kv head), a non-causal case, head dims 128
   (qwen3-32b-like: Hq 64, Hkv 8) and 160 (stablelm-12b-like: Hq 32,
   Hkv 8) at prefill (Sq 512) and decode, then bfloat16 cases at
   the edges of the tensor-core and split routes (``Sq``, ``Skv`` and
   ``kv_len`` off the tile, a window ending inside a tile, decode at
   ``kv_len`` 1, with one split and with several, more than 8 query
   heads per kv head, D 160 and D 128 off the tile and windowed), and
   the served families' shapes (chatglm3-6b's group of 16 and mixtral's
   group of 6 with its window of 4096 at D 128, musicgen's MHA at D 64,
   the vision model's non-causal cross-attention over 1600 tokens at
   prefill and decode and with a 2048-token prompt, Sq > kv_len), and
   the family training phases' shapes at batch 4 x 2048 with no kv_len
   (musicgen MHA at D 64, the vision model's self layers at 32/8, D 128,
   mixtral's 48/8 with its window of 4096; the vision cross layers'
   Sq 2048 over 1600 is ``cross_sq2048_s1600``); fails
   above atol/rtol 1e-5 (float32) or atol
   4e-3 / rtol 8e-3 (bfloat16).  The split route's two kernels are also
   held alone against ``ref.attention_partials`` (atol/rtol 1e-4) and
   ``ref.combine_splits`` (the bfloat16 limits).  Times the kernel, the
   plain version and ``scaled_dot_product_attention`` with the same
   boolean mask (the yardstick only; the port never calls it) with CUDA
   events around eager calls.  At decode (Sq 1) one call takes less
   time on the card than on the host's clock, so an eager loop times
   the host: there ``ms`` and ``library_ms`` are device times of calls
   replayed from a CUDA graph, and the eager times stand beside them
   (``eager_ms``, ``library_eager_ms``).  Hymba's six cases, the
   four D 128/160 cases, the served families' and the three training
   shapes are timed.
15. ``kernel_ssd``: K3's three kernels (``ssd_chunk_state``,
    ``ssd_state_pass``, ``ssd_chunk_scan``) each alone against its plain
    piece (``ref.ssd_chunk_states``, ``ssd_pass_states``,
    ``ssd_chunk_scan``), and the whole call against ``ssd_chunked`` and
    the sequential final state, at Hymba's prefill shape (Bt 4, L 1536,
    H 50, P 64, N 16), mamba2-130m's (H 24, N 128), ``train_hymba``'s
    (Bt 4, L 2048) and edge cases (one
    chunk, chunk 32, P 16, N 128, a short last head group, a decay that
    overflows above the diagonal, Q/P/N off a multiple of 4, the smoke
    serve's L 8); fails above atol/rtol 1e-4.  Times the call and each
    phase alone with CUDA events around eager calls.
16. ``serve_hymba``: ``repro_torch.launch.serve`` at full width in
    bfloat16 (batch 4, prompt 1536, gen 32) through the kernels, with the
    launches of K2 (32 layers x 33 forward passes) and K3 (32); then the
    same prompt in float32, prefill and 4 teacher-forced decode steps,
    through the kernels and through the plain versions on the card:
    logits within atol/rtol 1e-3 and equal greedy tokens.  K2's launches
    are also counted by route (bf16: ``tc`` at prefill, ``split`` at
    decode; float32: ``f32``), and the prefill profile gives K2's and
    K3's device time and share.
17. ``train_hymba``: training Hymba-1.5B.  First a gradient check:
    ``get_config("hymba-1.5b")`` at full width in float32 cut to 4
    layers (layer 0 global, 1-3 a window of 1024), batch 2, seq 2048,
    one ``make_train_step`` through the kernels and one through the
    plain versions from the same parameters: loss within rtol 1e-5,
    each parameter's gradient within a relative L2 error of 1e-4, K2
    (``f32``) and K3 each launched twice a layer (the forward pass and
    the remat recompute; the backward goes through their plain
    versions).  Then ``repro_torch.launch.train`` on the unchanged
    config (32 layers, bf16, remat ``full``, 1.64 B parameters), batch
    4, seq 2048: 3 steps at accum 1 with a checkpoint at the end, one
    more warm step under the profiler (K2's, K3's and the plain
    backwards' share), then a restart that must resume at step 3 and
    runs 2 steps at accum 2; finite losses, K2 (``tc``) and K3 each 64
    launches a microbatch.  Prints ms/step (first and warm), tokens/s,
    model TFLOP/s, peak memory and the seconds of each checkpoint save
    and restore.
18. ``serve_dense``: ``launch.serve.serve`` (bf16, through the kernels)
    of chatglm3-6b (28 layers), stablelm-12b (40) and qwen3-32b (64)
    whole, batch 4, prompt 1536, 16 generated tokens: a cold run (the
    main path, K2 counted: ``tc`` once a layer, ``split`` once a layer
    a step) and a warm ``generate`` of the same prompts on the same
    weights (equal tokens); prefill ms, decode ms/step, tokens/s and
    peak memory of each.  Then the int8 KV cache on the qwen3-32b
    weights: a timed serve and, teacher-forced on the bf16 tokens at
    batch 2, how far its logits are from the bf16 cache's through the
    kernels and through the plain versions: the kernels' gap at most the
    plain path's plus the kernels' own distance from it with the bf16
    cache.  Then each
    config in float32 cut to 2 layers, batch 2, prompt 512 and 4
    teacher-forced decode steps through the kernels (K2 ``f32``) and
    the plain versions: logits within 1e-3, greedy tokens equal (qwen3
    with both caches); and qwen3's int8 cache within the reference's own
    bound of the float32 cache at the reference check's depth and type
    (2 layers, float32: 0.05 x the logits' scale).
19. ``serve_moe``: mixtral-8x22b and llama4-scout at full width cut to 8
    layers (the whole models are 281 and 204 GB; one card), served as
    above (dense dispatch); on the mixtral weights the gather and dense
    dispatches in turns (gather, gather, dense), then the ring KV cache:
    batch 1, a 4096-token prompt that fills the window and 32 decode
    steps that wrap it, against a full-length cache in bf16, the
    router's choices logged: each served step's largest difference and
    router flips, then every router call pinned to the full-length
    run's choices through the kernels and the plain versions (the
    kernels' pinned gap at most the plain path's plus the kernels' own
    distance from it; every served step beyond the pinned gap shows a
    router flip at that step).  The float32
    checks (mixtral's with both dispatches), and the ring at full width
    in float32 on 2 layers: within 5e-4 x the logits' scale of the
    full-length cache (the reference's own bound), greedy tokens
    equal.
20. ``serve_vision``: llama-3.2-vision-11b whole (32 self and 8 cross
    layers) over the vision stub's 1600 encoder states, served as above;
    then one 2048-token prompt (longer than the vision tokens, every
    gate 0.5); the float32 check on one group of 5 layers with every
    gate 0.5.
21. ``serve_audio``: musicgen-large whole (48 layers, [B, S, 4] codebook
    prompts, [B, 16, 4] tokens), served as above; the float32 check.
22. ``train_audio``: training musicgen-large.  First a gradient check
    as ``train_hymba``'s: the config in float32 at full width cut to 2
    layers, batch 2 x 512 ([B, S, 4] codebook tokens), one
    ``make_train_step`` through the kernels and one through the plain
    versions from the same parameters: loss within rtol 1e-5, each
    parameter's gradient within a relative L2 error of 1e-4, K2
    (``f32``) twice a layer (forward and remat recompute).  Then
    ``repro_torch.launch.train`` on the whole model (48 layers, 3.25 B
    parameters, bf16, remat full), batch 4 x 2048, 3 steps: finite
    losses, K2 (``tc``) twice a layer a step; ms/step (first and warm),
    tokens/s, model TFLOP/s (``launch.roofline.model_flops``, 6 x active
    parameters x tokens) and its share of the H100's bf16 peak, peak
    memory, the parameters as built; then one more warm step under the
    profiler.
23. ``train_vision``: llama-3.2-vision-11b likewise: the gradient check
    on one group of 5 layers (4 self + 1 cross, every cross gate 0.5
    before either path runs: at the initial gate of 0 the
    cross-attention weights take no gradient) over 1600 vision tokens;
    the bf16 run on 10 layers (8 self + 2 cross, 2.88 B parameters as
    built; the whole model with AdamW is some 120 GB), ``launch.train
    --layers 10``.
24. ``train_moe``: mixtral-8x22b likewise: the gradient check at 1 layer
    with the dense dispatch, dense with ``moe_fold_gates`` and gather on
    one set of weights (the router's choices logged on both paths; where
    one flips, the plain path runs again pinned to the kernel path's
    choices, and the flips are reported); the bf16 run at 1 layer
    (2.91 B; at 2 layers, 5.41 B, the step does not fit the card's 80
    GB with AdamW) with the dense dispatch, then one step each of
    gather, fold, dense, dense, fold, gather in turns on its weights.
    The three phases print their wall seconds and their total on the
    ``kernels`` line.
25. ``mesh``: the port's mesh and placements on the card.  (a) A real
    one-rank NCCL group and a ``(1, 1)`` ``("data", "model")`` mesh:
    hymba-1.5b served at full width (32 layers, bf16, batch 4, prompt
    1536, 8 greedy tokens) with its parameters and caches placed by
    ``param_pspecs`` / ``cache_pspecs`` and ``ShardingPolicy(seq_axis=
    "model")``, and the float32 train step of hymba cut to 4 layers at
    batch 2 x 2048, each against the unmeshed path on the same weights
    in the same call: logits, tokens, loss and every gradient equal bit
    for bit, K2 (by route) and K3 launched as often (a (1, 1) mesh issues
    no collective and runs the same local ops).  (b) Rank 0's share of
    mixtral-8x22b on a ``(16, 16)`` mesh of a fake group of 256 ranks on
    the card: only its local shards are built (by the dry run's
    ``build_cell``), one ``decode_32k`` step and, when the dry run's
    argument bytes for ``train_4k`` fit the card's 80 GB, one
    ``train_4k`` step (whose running out of memory is reported, not
    failed): peak memory beside the dry run's argument bytes for the
    same cell (the shards' bytes must equal them), the local K2 shapes
    and launches, ms.  Fake collectives return unset
    memory, so no value of (b) is compared or printed as a result.
    (c) The dry run itself (``launch.dryrun.run_cell``, in a child process
    on the CPU while (a) and (b) run): hymba-1.5b ``train_4k`` single,
    mixtral-8x22b ``decode_32k`` multi (and the mixtral cells that (b)
    compares with), each record's key numbers and ``trace_s``.
26. ``escape_hatches``: the simulators' per-edge escape hatches
    (``flow_slots=False``: one max-min flow per input edge, K1 at F = E;
    ``frontier=False``: every edge and task scanned per event).  The
    golden rows per hatch, in turns with the default path (default,
    flow_slots off, frontier off, and back): GOLDEN's events and steps
    exactly, makespan and transferred within RTOL, events/s each turn.
    The mini survey's T160 group (every scheduler x netmodel, 8x4 and
    1x8+4x2) and the full grid's T512 blevel group on 32x4 (in turns)
    per hatch against the default path in the same call: makespan, ok,
    steps and events bitwise, transferred within 1e-5.  Every simulator
    call captures one CUDA graph; K1's launches on the hatch runs count
    toward its main path.
27. ``simlint``: ``repro_torch.analysis`` on the card: the source rules
    over the port and the step checks of the 27 targets
    (``check_all(device="cuda")``): no active finding and no host read
    inside any step; the counts per rule.
28. ``kernels``: each kernel with its launches on the main paths (K1's
    summed over its path phases and ``escape_hatches``, K2's over
    ``serve_hymba``,
    ``train_hymba``, the four serve family phases, the three train
    family phases and ``mesh``, K3's over ``serve_hymba``,
    ``train_hymba`` and ``mesh``, greedy's placement over the same
    main-path runs as K1's in ``survey_agreement``, ``survey_dataset``,
    ``survey_full_width``, ``survey_engine``, ``survey_ranks`` and
    ``escape_hatches``, each zeroed just before its run and read just
    after, the list schedule's over the same runs in this process (the
    ranks of ``survey_ranks`` count in their own); K1 and K2 also by
    route); needs every kernel's check phase and the phases of its paths
    in the same run.

Every simulator phase but ``survey_engine``'s eager turns, the eager
turn of ``static_full_width`` and the input recording of
``kernel_waterfill`` runs with the default ``step_graph="auto"``: each
simulator call replays its event step from a CUDA graph, and the
mini-grid phases require one capture per simulator call.

The last lines are the card's ``nvidia-smi`` name and power limit, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Imports nothing of JAX or of
the reference package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PHASES = ("env", "build", "kernel_waterfill", "kernel_greedy_place",
          "kernel_list_schedule", "golden", "survey_mini",
          "survey_agreement", "survey_dataset", "survey_full_width",
          "survey_engine", "survey_ranks", "static_golden",
          "static_full_width", "genetic_vec",
          "kernel_flash_attention", "kernel_ssd", "serve_hymba",
          "train_hymba", "serve_dense", "serve_moe", "serve_vision",
          "serve_audio", "train_audio", "train_vision", "train_moe",
          "mesh", "escape_hatches", "simlint", "kernels")

# the recorded dynamic rows of BENCH_PR7.json (reference package, CPU)
GOLDEN = {
    "merge_triplets": dict(cluster="8x4", makespan=249.30433654785156,
                           n_events=232, n_steps=232,
                           transferred=8741974016.0),
    "t2048_layered": dict(cluster="16x4", makespan=61.638973236083984,
                          n_events=1908, n_steps=1801,
                          transferred=60276342784.0),
}
RTOL = 1e-5

# the static simulator's rows of BENCH_PR7.json (frontier on: blevel
# from the exact estimates, padded to the bucket, the shape's caps) record
# the same values as its dynamic rows
STATIC_GOLDEN = GOLDEN

# the static_full_width cell's 40 rows, recorded from the reference
# package (JAX on a CPU) by ``tools/record_static_reference.py``: the
# T512 bucket on 32x4, each graph placed by the reference's bucket
# scheduler from exact estimates (seed 0) and simulated with
# full-coverage frontier caps (E, T); (ok, n_events, n_steps, makespan,
# transferred) by (scheduler, MiB/s, graph)
STATIC_SCHEDULERS = ("blevel", "tlevel", "mcp", "etf", "random")
STATIC_BANDWIDTHS_MIB = (100, 512)
STATIC_FULL_WIDTH = {
    ('blevel', 100, 'fork1'):
        (True, 457, 410, 118.05352783203125, 16462643200.0),
    ('blevel', 100, 'size_stairs'):
        (True, 377, 346, 262.2301330566406, 18371051520.0),
    ('blevel', 100, 'crossvx'):
        (True, 681, 577, 1343.089599609375, 41694330880.0),
    ('blevel', 100, 'epigenomics-204-s0'):
        (True, 433, 433, 432.3298645019531, 4002148608.0),
    ('blevel', 512, 'fork1'):
        (True, 456, 397, 118.41110229492188, 16357785600.0),
    ('blevel', 512, 'size_stairs'):
        (True, 377, 344, 143.61370849609375, 18371051520.0),
    ('blevel', 512, 'crossvx'):
        (True, 677, 460, 1023.5889282226562, 41871904768.0),
    ('blevel', 512, 'epigenomics-204-s0'):
        (True, 434, 434, 441.82513427734375, 3951829248.0),
    ('tlevel', 100, 'fork1'):
        (True, 485, 428, 128.82240295410156, 19398656000.0),
    ('tlevel', 100, 'size_stairs'):
        (True, 375, 351, 267.0175476074219, 18447597568.0),
    ('tlevel', 100, 'crossvx'):
        (True, 467, 312, 1223.587890625, 22185697280.0),
    ('tlevel', 100, 'epigenomics-204-s0'):
        (True, 338, 338, 446.063232421875, 2480946944.0),
    ('tlevel', 512, 'fork1'):
        (True, 468, 402, 128.69496154785156, 17616076800.0),
    ('tlevel', 512, 'size_stairs'):
        (True, 376, 349, 144.22218322753906, 18631098368.0),
    ('tlevel', 512, 'crossvx'):
        (True, 467, 312, 1054.6788330078125, 22185697280.0),
    ('tlevel', 512, 'epigenomics-204-s0'):
        (True, 338, 338, 444.034423828125, 2480946944.0),
    ('mcp', 100, 'fork1'):
        (True, 457, 410, 118.05352783203125, 16462643200.0),
    ('mcp', 100, 'size_stairs'):
        (True, 377, 346, 262.2301330566406, 18371051520.0),
    ('mcp', 100, 'crossvx'):
        (True, 681, 577, 1343.089599609375, 41694330880.0),
    ('mcp', 100, 'epigenomics-204-s0'):
        (True, 433, 433, 432.3298645019531, 4002148608.0),
    ('mcp', 512, 'fork1'):
        (True, 456, 397, 118.41110229492188, 16357785600.0),
    ('mcp', 512, 'size_stairs'):
        (True, 377, 344, 143.61370849609375, 18371051520.0),
    ('mcp', 512, 'crossvx'):
        (True, 677, 460, 1023.5889282226562, 41871904768.0),
    ('mcp', 512, 'epigenomics-204-s0'):
        (True, 434, 434, 441.82513427734375, 3951829248.0),
    ('etf', 100, 'fork1'):
        (True, 416, 399, 116.24382019042969, 12163481600.0),
    ('etf', 100, 'size_stairs'):
        (True, 377, 351, 262.8668212890625, 18371051520.0),
    ('etf', 100, 'crossvx'):
        (True, 492, 377, 1214.4302978515625, 22188308480.0),
    ('etf', 100, 'epigenomics-204-s0'):
        (True, 333, 333, 445.1790466308594, 2440725248.0),
    ('etf', 512, 'fork1'):
        (True, 421, 400, 115.56745910644531, 12687769600.0),
    ('etf', 512, 'size_stairs'):
        (True, 377, 353, 139.98721313476562, 18371051520.0),
    ('etf', 512, 'crossvx'):
        (True, 492, 377, 1051.1544189453125, 22188310528.0),
    ('etf', 512, 'epigenomics-204-s0'):
        (True, 333, 333, 442.9508056640625, 2437606144.0),
    ('random', 100, 'fork1'):
        (True, 490, 415, 246.23240661621094, 19922944000.0),
    ('random', 100, 'size_stairs'):
        (True, 379, 350, 291.5271301269531, 18683527168.0),
    ('random', 100, 'crossvx'):
        (True, 805, 544, 1768.6761474609375, 51647746048.0),
    ('random', 100, 'epigenomics-204-s0'):
        (True, 492, 492, 764.00390625, 5200154624.0),
    ('random', 512, 'fork1'):
        (True, 490, 400, 246.23240661621094, 19922944000.0),
    ('random', 512, 'size_stairs'):
        (True, 379, 350, 179.90623474121094, 18683527168.0),
    ('random', 512, 'crossvx'):
        (True, 805, 545, 1600.251953125, 51647750144.0),
    ('random', 512, 'epigenomics-204-s0'):
        (True, 492, 492, 758.7047119140625, 5200154112.0),
}

# the reference event loop on fastcrossv at 32x4 (maxmin, 100 MiB/s) with
# the reference's genetic-vec (seed 0, population 32) at 16 (its
# default) and 2 generations, recorded by the same script (JAX on a
# CPU): (makespan, each task's worker) by generations
GENETIC_VEC = {
    16: (158.1911558649453, [
         31, 31, 0, 15, 30, 31, 10, 28, 31, 30, 11, 25, 30, 14,
         31, 28, 9, 15, 7, 28, 9, 20, 15, 25, 23, 0, 6, 25, 24, 3,
         29, 11, 13, 14, 12, 23, 14, 1, 6, 0, 20, 12, 26, 14, 20,
         26, 26, 7, 2, 9, 2, 23, 24, 9, 1, 4, 1, 0, 25, 30, 4, 20,
         22, 0, 18, 10, 13, 28, 7, 2, 31, 20, 4, 4, 31, 4, 14, 24,
         14, 13, 2, 22, 26, 18, 25, 28, 22, 16]),
    2: (187.99836037741963, [
         31, 31, 0, 23, 28, 22, 14, 5, 4, 31, 12, 9, 17, 22, 1,
         14, 25, 15, 7, 7, 9, 20, 15, 25, 27, 2, 6, 25, 24, 19,
         29, 6, 10, 14, 12, 23, 14, 23, 6, 31, 30, 4, 7, 7, 20, 1,
         26, 20, 30, 9, 2, 23, 9, 9, 1, 4, 1, 31, 25, 30, 23, 20,
         22, 20, 18, 10, 13, 28, 7, 14, 10, 18, 4, 4, 16, 0, 14,
         21, 28, 27, 2, 15, 26, 18, 17, 28, 22, 16]),
}

# the reference package's agreement rows (``benchmarks.survey.survey``,
# JAX on a CPU): ``makespan_ratio`` of the first cluster (8x4) on maxmin
# at the first point (32 MiB/s, exact imode, msd 0), by (graph,
# scheduler).  fastcrossv's 0.9 % under blevel and 0.3 % under etf are
# the reference's own gap (equal-priority downloads admitted in another
# order by the twin), kept, not repaired.
MINI_AGREEMENT = {
    ("merge_triplets", "blevel"): 1.0000000482825693,
    ("merge_triplets", "random"): 1.0000000661360724,
    ("merge_triplets", "etf"): 1.0000000482825693,
    ("merge_triplets", "greedy"): 0.9999999430160557,
    ("fastcrossv", "blevel"): 1.0089501486911263,
    ("fastcrossv", "random"): 1.000000095528131,
    ("fastcrossv", "etf"): 0.9973245098278471,
    ("fastcrossv", "greedy"): 1.0000001172150574,
    ("sipht", "blevel"): 1.0000000967933749,
    ("sipht", "random"): 1.000000022031648,
    ("sipht", "etf"): 1.0000000967933749,
    ("sipht", "greedy"): 0.9999999938955136,
    ("montage-77-s0", "blevel"): 1.0000000160654554,
    ("montage-77-s0", "random"): 1.000000098542022,
    ("montage-77-s0", "etf"): 1.0000000160654554,
    ("montage-77-s0", "greedy"): 1.0000000955980914,
}

# the same over ``dataset="wfcommons-mini"`` (reference package, JAX on a
# CPU): derived edges, bucket labels and the 24 ratios
DATASET_EDGES = (128, 288)
DATASET_BUCKETS = {
    "T128xO160xE224": ("montage-77-s0", "cybershake-104-s0",
                       "epigenomics-84-s0"),
    "T288xO448xE544": ("montage-220-s1", "cybershake-257-s1",
                       "epigenomics-204-s1"),
}
DATASET_AGREEMENT = {
    ("montage-77-s0", "blevel"): 1.0000000160654554,
    ("cybershake-104-s0", "blevel"): 0.9999998962777956,
    ("epigenomics-84-s0", "blevel"): 1.0000000329239538,
    ("montage-220-s1", "blevel"): 1.0000001139469195,
    ("cybershake-257-s1", "blevel"): 1.0000000263225237,
    ("epigenomics-204-s1", "blevel"): 1.000000097037555,
    ("montage-77-s0", "random"): 1.000000098542022,
    ("cybershake-104-s0", "random"): 0.9999999449282616,
    ("epigenomics-84-s0", "random"): 1.000000116388402,
    ("montage-220-s1", "random"): 0.9999999568163955,
    ("cybershake-257-s1", "random"): 0.9999999481465672,
    ("epigenomics-204-s1", "random"): 0.9999999669237336,
    ("montage-77-s0", "etf"): 1.0000000160654554,
    ("cybershake-104-s0", "etf"): 0.9999999889216464,
    ("epigenomics-84-s0", "etf"): 0.9999999823311638,
    ("montage-220-s1", "etf"): 1.0000001139469195,
    ("cybershake-257-s1", "etf"): 0.9999999724103024,
    ("epigenomics-204-s1", "etf"): 1.000000018823098,
    ("montage-77-s0", "greedy"): 1.0000000955980914,
    ("cybershake-104-s0", "greedy"): 0.9999996082406636,
    ("epigenomics-84-s0", "greedy"): 0.9999999097351874,
    ("montage-220-s1", "greedy"): 1.0000000903638595,
    ("cybershake-257-s1", "greedy"): 1.000000046415712,
    ("epigenomics-204-s1", "greedy"): 0.9999999633295135,
}

# the T512 bucket on 32x4, maxmin, point 0 (32 MiB/s, exact, msd 0):
# (reference package's batched makespan, JAX on a CPU; the reference
# event loop's twin makespan) by (scheduler, graph).  The reference's
# blevel run of crossvx overflows its spec-derived frontier (None).
FULL_WIDTH_AGREEMENT = {
    ("blevel", "fork1"): (129.60316467285156, 129.6031635621222),
    ("blevel", "size_stairs"): (627.4307861328125, 627.4308240257641),
    ("blevel", "crossvx"): (None, 2160.9993905861115),
    ("blevel", "epigenomics-204-s0"): (456.88427734375, 456.88428325455067),
    ("greedy", "fork1"): (129.2369842529297, 129.2369876105791),
    ("greedy", "size_stairs"): (1507.3096923828125, 1507.3097556032444),
    ("greedy", "crossvx"): (8054.41015625, 8054.410844914582),
    ("greedy", "epigenomics-204-s0"): (1436.7587890625, 1436.7587918781019),
}

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# non-tensor float32 operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# dense bfloat16 tensor-core operations/s (same data sheet)
BF16_OPS_PER_S = 989e12


T_START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line per phase, with the seconds since the script began
    (``at_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


# the card's nvidia-smi name and power limit, set by phase_env; the LM
# phases carry it on their lines
CARD = None


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def t2048_graph(layers=8, width=72, fanin=4):
    """Synthetic layered workflow in the T2048 shape bucket (T = 576,
    E = 2016), built as the reference benchmark builds it."""
    from repro_torch.core import MiB, TaskGraph
    g = TaskGraph("t2048_layered")
    prev = []
    for layer in range(layers):
        cur = []
        for i in range(width):
            k = layer * width + i
            inputs = ([prev[(i * 3 + j * 7) % len(prev)].outputs[0]
                       for j in range(fanin)] if prev else ())
            cur.append(g.new_task(0.5 + 0.01 * (k % 37), inputs=inputs,
                                  outputs=[(20 + k % 50) * MiB],
                                  expected_duration=0.6 + 0.01 * (k % 29)))
        prev = cur
    return g


# ---------------------------------------------------------------- phases
def phase_env():
    import torch
    global CARD
    line = CARD = nvidia_smi_line()
    emit("env", device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=bool(os.environ.get("PTXAS_VERBOSE")))
    emit("build", seconds=time.perf_counter() - t0,
         libs={n: os.path.relpath(str(p), HERE) for n, p in libs.items()})


def _flow_sets(rng, R, W, F, p_active=0.6):
    src = rng.integers(0, W, (R, F)).astype("int32")
    dst = rng.integers(0, W, (R, F)).astype("int32")
    active = rng.random((R, F)) < p_active
    caps = rng.uniform(50, 150, (R, W)).astype("float32")
    return src, dst, active, caps


def _edge_cases(W, F):
    import numpy as np
    cases = {}
    z = np.zeros((4, F), np.int32)
    cases["all_inactive"] = (z, z, np.zeros((4, F), bool),
                             np.full((4, W), 100.0, np.float32))
    src = np.zeros((4, F), np.int32)
    dst = np.broadcast_to(1 + (np.arange(F) % max(W - 1, 1)),
                          (4, F)).astype(np.int32) % W
    cases["single_source"] = (src, dst, np.ones((4, F), bool),
                              np.full((4, W), 90.0, np.float32))
    ring_s = np.broadcast_to(np.arange(F) % W, (4, F)).astype(np.int32)
    ring_d = ((ring_s + 1) % W).astype(np.int32)
    cases["equal_share_ties"] = (ring_s, ring_d, np.ones((4, F), bool),
                                 np.full((4, W), 64.0, np.float32))
    # every third flow with a worker id outside [0, W): treated as
    # inactive by the kernels
    rng = np.random.default_rng(W)
    src, dst, active, caps = _flow_sets(rng, 4, W, F, p_active=0.9)
    src[:, ::3] = np.where(np.arange(4)[:, None] % 2, W, -1)
    dst[:, 1::3] = W + 3
    cases["ids_out_of_range"] = (src, dst, active, caps)
    return cases


def _plain_rates(plain, src, dst, active, caps, max_rounds=None):
    """The plain version's rates, with flows whose ids fall outside
    ``[0, W)`` made inactive (what the kernels do with them; the plain
    version indexes by id)."""
    W = caps.shape[1]
    inside = (src >= 0) & (src < W) & (dst >= 0) & (dst < W)
    return plain(src.clamp(0, W - 1), dst.clamp(0, W - 1),
                 active & inside, caps, caps, max_rounds)


def _compare(got, want):
    import torch
    got, want = got.double(), want.double()
    abs_err = (got - want).abs()
    rel = abs_err / want.abs().clamp(min=1e-30)
    return (float(abs_err.max()) if abs_err.numel() else 0.0,
            float(rel.max()) if rel.numel() else 0.0,
            bool(torch.equal(got, want)))


def _waterfill_work(rounds, R, F, W):
    """(bytes, operations) the function needs on these inputs: each
    input read once and the output written once; per row, its filling
    rounds (from the plain version) x (4F count/use increments + 12W
    share, min, test and capacity ops)."""
    nbytes = R * (F * 4 * 2 + F * 1 + W * 4 * 2 + F * 4)
    ops = int(rounds.sum()) * (4 * F + 12 * W)
    return nbytes, ops


@functools.lru_cache(maxsize=None)
def _full_width_group():
    """(encoded graphs, the T512 group, cores, points) of the full grid's
    T512 bucket on 32x4 — the survey_full_width cell."""
    import numpy as np
    from repro_torch.core import parse_cluster
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.survey import FULL_GRID, grid_points
    encoded, groups = encode_graph_batch(
        survey_names(FULL_GRID["graphs_per_family"]), seed=0, bucket=True)
    grp = next(g for g in groups if g.shape[0] == 512)
    cores = np.asarray(parse_cluster("32x4"), np.int32)[None, :]
    return encoded, grp, cores, grid_points(FULL_GRID)


def _full_width_runner(sched, impl, **opts):
    from repro_torch.core.vectorized import make_grid_runner
    from repro_torch.survey import full_frontier_caps
    encoded, grp, cores, _ = _full_width_group()
    return make_grid_runner(
        [encoded[n] for n in grp.names], sched, 32, cores,
        netmodel="maxmin", shape=grp.shape, batch=grp.batch,
        device="cuda", waterfill_impl=impl,
        frontier_caps=full_frontier_caps(grp.shape), **opts)


def _record_path_inputs(sched="blevel"):
    """The inputs of every K1 call of one run of the survey_full_width
    cell (``sched`` on maxmin), copied by a hook on the kernel wrapper
    that this script installs for the run and removes after it.  The run
    is eager: a hook inside a captured step would copy once, at capture,
    when the step's inputs do not exist yet."""
    from repro_torch.kernels import waterfill as wk
    calls = []
    wrapped = wk.waterfill

    def hook(src, dst, active, caps_up, caps_down, max_rounds=None):
        calls.append(tuple(x.clone() for x in (src, dst, active, caps_up,
                                               caps_down)))
        return wrapped(src, dst, active, caps_up, caps_down, max_rounds)

    wk.waterfill = hook
    try:
        _full_width_runner(sched, "auto", step_graph="eager")(
            _full_width_group()[3])
    finally:
        wk.waterfill = wrapped
    return calls


def _turns(routes, fn):
    """``fn(route)`` for each route in turns (a, b, b, a): ``{route:
    [result, result]}``."""
    out = {r: [] for r in routes}
    for r in list(routes) + list(reversed(routes)):
        out[r].append(fn(r))
    return out


def _host_us(fn, calls=200, repeats=5):
    """Host microseconds per call of ``fn`` (the enqueue, on the host's
    clock; the device drains after each loop): the least and the median
    of ``repeats`` loops, since the host's clock is noisy."""
    import torch
    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    out.sort()
    return dict(min=out[0], median=out[len(out) // 2])


def phase_kernel_waterfill(seed=0, path_rows=96, path_w=32):
    import numpy as np
    import torch
    from repro_torch.core.vectorized.waterfill import waterfill as plain
    from repro_torch.core.vectorized.waterfill import waterfill_rounds
    from repro_torch.kernels import waterfill as wk  # the module
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    checks = []
    worst_abs = 0.0

    def check(name, src, dst, active, caps, max_rounds=None):
        """Every route that takes the shape against the plain version:
        bitwise, or fail."""
        nonlocal worst_abs
        t = [torch.as_tensor(x, device=dev) for x in (src, dst, active, caps)]
        F, W = t[0].shape[1], t[3].shape[1]
        want = _plain_rates(plain, *t, max_rounds)
        routes = wk.ROUTES if wk.route_for(F, W) == "warp" else ("block",)
        for route in routes:
            got = wk._waterfill(t[0], t[1], t[2], t[3], t[3], max_rounds,
                                route=route)
            torch.cuda.synchronize()
            a, r, exact = _compare(got, want)
            worst_abs = max(worst_abs, a)
            checks.append(dict(case=name, route=route, rows=int(t[0].shape[0]),
                               W=W, F=F, max_rounds=max_rounds, max_abs=a,
                               max_rel=r, bitwise=exact))
            if not exact:
                emit("kernel_waterfill", checks=checks, ok=False)
                raise AssertionError(f"waterfill {route} route is not "
                                     f"bitwise equal to the plain version "
                                     f"on {name}: abs {a}, rel {r}")

    for W in (1, 8, 16, 32, 64):
        F = 4 * W
        check(f"random_W{W}", *_flow_sets(rng, 4096, W, F))
        for name, case in _edge_cases(W, F).items():
            check(f"{name}_W{W}", *case)
        check(f"random_W{W}_max_rounds_3", *_flow_sets(rng, 64, W, F),
              max_rounds=3)
    for rows in (1, 7, 33):
        check(f"random_R{rows}", *_flow_sets(rng, rows, path_w, 4 * path_w))
    check("random_W20_F100", *_flow_sets(rng, 300, 20, 100))
    check("random_path_shape", *_flow_sets(rng, path_rows, path_w,
                                           4 * path_w))

    # both routes timed in turns at the survey's full-width shape and at
    # R 4096: ms is device time of calls replayed from a CUDA graph, and
    # the eager time (CUDA events around a loop of calls) and the host's
    # enqueue time per call stand beside it
    timings = {}
    for rows in (path_rows, 4096):
        src, dst, active, caps = (torch.as_tensor(x, device=dev)
                                  for x in _flow_sets(rng, rows, path_w,
                                                      4 * path_w))

        def timed(route):
            def kernel():
                return wk._waterfill(src, dst, active, caps, caps,
                                     route=route)
            return dict(ms=cuda_graph_ms(kernel, iters=200),
                        eager_ms=cuda_time_ms(kernel, iters=200),
                        host_us=_host_us(kernel))

        by_route = _turns(wk.ROUTES, timed)
        p_ms = cuda_time_ms(lambda: plain(src, dst, active, caps, caps),
                            iters=20, warmup=2)
        _, rounds = waterfill_rounds(src, dst, active, caps, caps)
        nbytes, ops = _waterfill_work(rounds, rows, 4 * path_w, path_w)
        bound_ms, bound_by = _bound(nbytes, ops, F32_OPS_PER_S)
        warp = by_route["warp"]
        timings[rows] = dict(
            rows=rows, W=path_w, F=4 * path_w, order="warp,block,block,warp",
            routes=by_route,
            ms=sum(x["ms"] for x in warp) / len(warp), timed="cuda_graph",
            eager_ms=sum(x["eager_ms"] for x in warp) / len(warp),
            plain_ms=p_ms, rounds_mean=float(rounds.float().mean()),
            rounds_max=int(rounds.max()), bytes=nbytes, ops=ops,
            bound_ms=bound_ms, bound_by=bound_by)
    # the per-edge simulator's solve (flow_slots=False): F = E flows per
    # row (992 at the T512 bucket, 2016 at T2048), past one block of
    # threads, on the block route; bitwise, then timed
    per_edge = []
    for F in (992, 2016):
        sets = _flow_sets(rng, path_rows, path_w, F)
        check(f"per_edge_F{F}", *sets)
        src, dst, active, caps = (torch.as_tensor(x, device=dev)
                                  for x in sets)

        def kernel():
            return wk._waterfill(src, dst, active, caps, caps)
        p_ms = cuda_time_ms(lambda: plain(src, dst, active, caps, caps),
                            iters=5, warmup=1)
        _, rounds = waterfill_rounds(src, dst, active, caps, caps)
        nbytes, ops = _waterfill_work(rounds, path_rows, F, path_w)
        bound_ms, bound_by = _bound(nbytes, ops, F32_OPS_PER_S)
        per_edge.append(dict(
            rows=path_rows, W=path_w, F=F, route=wk.route_for(F, path_w),
            ms=cuda_graph_ms(kernel, iters=50), timed="cuda_graph",
            eager_ms=cuda_time_ms(kernel, iters=50), plain_ms=p_ms,
            rounds_mean=float(rounds.float().mean()),
            rounds_max=int(rounds.max()), bytes=nbytes, ops=ops,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    path = _path_input_timing()
    worst_abs = max(worst_abs, path["max_abs"])
    emit("kernel_waterfill", checks=checks, max_abs=worst_abs,
         all_bitwise=all(c["bitwise"] for c in checks),
         timing=list(timings.values()), per_edge=per_edge,
         path_inputs=path, card=CARD)
    return dict(max_abs_err=worst_abs, path=timings[path_rows],
                per_edge=per_edge)


# graphs and bucket shapes of the greedy cell's two pegasus buckets
PLACE_T160 = (("montage", "cybershake", "sipht"), (160, 160, 224))
PLACE_T512 = (("epigenomics", "ligo"), (512, 320, 320))


def _place_inputs(graphs, shape, R, W, seed, p_place=0.3, ties=False,
                  fit_none=False):
    """Seeded inputs of one greedy placement on the card, row r on graph
    ``r % len(graphs)`` padded to ``shape``: the wrapper's positional
    arguments (``tally`` at 0).  Every 7th row places nothing; the task
    with the most inputs places in every other row (unless ``p_place``
    is 0).  ``ties``: sizes whole MiB of 0-3, loads 0-2; ``fit_none``:
    no worker has any task's cores."""
    import numpy as np
    import torch
    from repro_torch.core.graphs import make_graph
    from repro_torch.core.vectorized.scheduling import edge_table, graph_view
    from repro_torch.core.vectorized.specs import (encode_graph, pad_spec,
                                                   stack_specs)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    specs = [pad_spec(encode_graph(make_graph(n, seed=0)), shape)
             for n in graphs]
    g = graph_view(stack_specs([specs[r % len(specs)] for r in range(R)])
                   .to(dev))
    T, O = g.T, g.O
    table = edge_table(g).contiguous()
    placing = rng.random((R, T)) < p_place
    widest = (table >= 0).sum(dim=2).argmax(dim=1).cpu().numpy()
    if p_place > 0:
        placing[np.arange(0, R, 2), widest[::2]] = True
    placing[::7] = False
    placing = torch.as_tensor(placing, device=dev) & g.task_valid
    if ties:
        sizes = rng.integers(0, 4, (R, O)).astype(np.float32) * 2 ** 20
        load0 = rng.integers(0, 3, (R, W))
    else:
        sizes = rng.lognormal(17, 2, (R, O)).astype(np.float32)
        load0 = rng.integers(0, 6, (R, W))
    cores = rng.integers(1, 5, (R, W))
    cores[1::3, -1] = 0
    if fit_none:
        cores[:] = 0
    return (placing, table, g.e_obj.contiguous(),
            torch.where(g.obj_valid, torch.as_tensor(sizes, device=dev),
                        0.0),
            torch.as_tensor(rng.random((R, O, W)) < 0.6, device=dev),
            g.cpus.contiguous(), torch.as_tensor(cores, device=dev),
            torch.as_tensor(load0, device=dev),
            torch.zeros(3, dtype=torch.int64, device=dev))


def _place_bytes(args):
    """The bytes one placement needs: the placing flags, each placing
    task's cores and input-edge entries and objects, each object those
    edges reach (its size and W missing flags) once a row, the workers'
    cores and loads, read once; ``new_pw`` written once."""
    import torch
    placing, table, e_obj, _, missing, _, cores, _, _ = args
    R, T = placing.shape
    O, W = missing.shape[1], missing.shape[2]
    ids = torch.where(placing[:, :, None], table, -1)
    valid = ids >= 0
    n_edges = int(valid.sum())
    objs = torch.gather(e_obj, 1, ids.clamp(min=0).reshape(R, -1))
    reached = torch.zeros(R, O + 1, dtype=torch.bool, device=objs.device)
    reached.scatter_(1, torch.where(valid.reshape(R, -1), objs, O), True)
    n_objs = int(reached[:, :O].sum())
    return (R * T + 8 * int(placing.sum()) + 16 * n_edges
            + n_objs * (4 + W) + 16 * R * W + 8 * R * T)


def phase_kernel_greedy_place(seed=0):
    import torch
    from repro_torch.core.vectorized.scheduling import greedy_place_plain
    from repro_torch.kernels import greedy_place as gk
    checks, timing = [], []
    # the cells' shapes, timed at p_place 0.3 and 0.03 (the main path
    # places about 6 tasks in its widest row a step)
    cells = {"t160_r360_w16": (PLACE_T160, 360, 16),
             "t512_r240_w16": (PLACE_T512, 240, 16),
             "t512_r1800_w32": (PLACE_T512, 1800, 32)}
    cells.update({f"{k}_sparse": v + (dict(p_place=0.03),)
                  for k, v in list(cells.items())})
    cases = dict(cells)
    cases.update({
        "t512_r240_w40": (PLACE_T512, 240, 40, {}),
        "ties_t160_w16": (PLACE_T160, 360, 16, dict(ties=True)),
        "fit_none_t160_w16": (PLACE_T160, 96, 16, dict(fit_none=True)),
        "nothing_placing_t512_w16": (PLACE_T512, 96, 16,
                                     dict(p_place=0.0)),
        "d0_t160_w16": (PLACE_T160, 96, 16, dict(ties=True, d0=True)),
    })
    for i, (name, case) in enumerate(cases.items()):
        (graphs, shape), R, W = case[:3]
        kw = dict(case[3]) if len(case) > 3 else {}
        d0 = kw.pop("d0", False)
        args = list(_place_inputs(graphs, shape, R, W, seed + i, **kw))
        if d0:
            args[1] = args[1][:, :, :0].contiguous()
        want_tally = torch.zeros(3, dtype=torch.int64, device="cuda")
        want = greedy_place_plain(*args[:8], want_tally)
        got = gk.greedy_place(*args)
        # a second launch adds to the tally once more: its scratch reset
        again = gk.greedy_place(*args)
        torch.cuda.synchronize()
        tally = args[8].tolist()
        ok = (torch.equal(got, want) and torch.equal(again, want)
              and tally == [2 * int(want_tally[0]), 0, 0])
        checks.append(dict(case=name, R=R, W=W, T=shape[0],
                           D=args[1].shape[2], placing_max=int(
                               args[0].sum(dim=1).amax()),
                           tally=tally, bitwise=ok))
        if not ok:
            raise AssertionError(f"kernel_greedy_place {name}: the kernel "
                                 f"differs from the plain version "
                                 f"({checks[-1]})")
        if name in cells:
            nbytes = _place_bytes(args)
            bound_ms, bound_by = _bound(nbytes, 0, F32_OPS_PER_S)

            def kernel():
                return gk.greedy_place(*args)
            timing.append(dict(
                case=name, R=R, W=W, T=shape[0], D=args[1].shape[2],
                ms=cuda_graph_ms(kernel, iters=50), timed="cuda_graph",
                eager_ms=cuda_time_ms(kernel, iters=50),
                plain_ms=cuda_time_ms(lambda: greedy_place_plain(
                    *args[:8], want_tally), iters=5, warmup=1),
                bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None))
    emit("kernel_greedy_place", checks=checks,
         all_bitwise=all(c["bitwise"] for c in checks), timing=timing,
         card=CARD)
    return dict(max_abs_err=0.0, path=timing[0], timing=timing)


# the list schedule's cases: (graphs, clusters, rows, bucket shape).  The
# benchmark cells' calls are timed: a blevel grid call of each elementary
# bucket and a four-card rank's block of it, irw's two, a single-sim
# request of each pegasus bucket; the T2048 bucket is checked only
SCHEDULE_CELLS = {
    "t512_r1800_w32": (("fork1", "size_stairs", "grid", "fern"),
                       ("32x4", "32x16"), 1800, (512, 416, 704)),
    "t160_r120_w32": (("merge_triplets",), ("32x4", "32x16"), 120,
                      (160, 128, 128)),
    "t512_r450_w32": (("fork1", "size_stairs", "grid", "fern"),
                      ("32x4", "32x16"), 450, (512, 416, 704)),
    "t160_r30_w32": (("merge_triplets",), ("32x4", "32x16"), 30,
                     (160, 128, 128)),
    "irw_t160_r360_w32": (("crossv", "fastcrossv", "mapreduce48"),
                          ("32x4", "32x16"), 360, (160, 2368, 2368)),
    "irw_t512_r360_w32": (("gridcat", "crossvx", "nestedcrossv"),
                          ("32x4", "32x16"), 360, (512, 416, 992)),
    "t160_r1_w16": (("montage",), ("16x8",), 1, (160, 160, 224)),
    "t512_r1_w16": (("epigenomics",), ("16x4",), 1, (512, 320, 320)),
}
SCHEDULE_CHECKS = {
    "t2048_r8_w32": (("t2048_layered",), ("32x4", "1x8+4x2"), 8,
                     (2048, 576, 2016)),
    "zero_durations": (("montage", "cybershake", "crossv"),
                       ("32x16", "1x8+4x2"), 64, (160, 160, 416),
                       dict(zero_dur=True)),
    "no_worker_fits": (("montage", "cybershake", "crossv"),
                       ("32x16", "1x8+4x2"), 64, (160, 160, 416),
                       dict(tiny_cores=True)),
    "bandwidth_extremes": (("montage", "cybershake", "crossv"),
                           ("32x16", "1x8+4x2"), 64, (160, 160, 416),
                           dict(bandwidths=(1e-30, 1e-3, 1e30,
                                            float("inf")))),
    "w40_stride": (("montage", "sipht"), ("40x4", "8x4"), 32,
                   (160, 160, 224)),
}


def _schedule_graph(name):
    from repro_torch.core.graphs import irw, make_graph
    if name == "mapreduce48":
        return irw.mapreduce(0, maps=48, reduces=48)
    if name == "t2048_layered":
        return t2048_graph()
    return make_graph(name, seed=0)


def _schedule_inputs(graphs, clusters, R, shape, seed, zero_dur=False,
                     bandwidths=(32.0, 1024.0, 8192.0), tiny_cores=False):
    """Seeded inputs of one schedule call on the card, row r on graph ``r
    % len(graphs)`` padded to ``shape`` and cluster ``r % len(clusters)``
    padded to the widest with zero-core workers: ``(g, args)``, ``args``
    the wrapper's positional arguments after the order, ``max_cores``
    last.  ``zero_dur``: every estimated duration 0; ``bandwidths`` in
    MiB/s, a row each in turn; ``tiny_cores``: every worker 1 core."""
    import numpy as np
    import torch
    from repro_torch.core import parse_cluster
    from repro_torch.core.vectorized.scheduling import graph_view
    from repro_torch.core.vectorized.specs import (encode_graph, pad_spec,
                                                   stack_specs)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    specs = [pad_spec(encode_graph(_schedule_graph(n)), shape)
             for n in graphs]
    g = graph_view(stack_specs([specs[r % len(specs)] for r in range(R)])
                   .to(dev))
    lists = [parse_cluster(c) for c in clusters]
    cores = np.zeros((R, max(len(c) for c in lists)), np.int64)
    for r in range(R):
        cores[r, :len(lists[r % len(lists)])] = lists[r % len(lists)]
    C = int(cores.max())
    if tiny_cores:
        cores = np.minimum(cores, 1)
    dur = rng.lognormal(2, 1, (R, g.T)).astype(np.float32)
    if zero_dur:
        dur[:] = 0.0
    size = rng.lognormal(17, 2, (R, g.O)).astype(np.float32)
    bw = np.asarray([bandwidths[r % len(bandwidths)] for r in range(R)],
                    np.float32) * np.float32(2 ** 20)
    return g, (g.e_task, g.prod_e, g.e_obj, g.edge_valid, g.cpus,
               torch.where(g.task_valid, torch.as_tensor(dur, device=dev),
                           0.0),
               torch.where(g.obj_valid, torch.as_tensor(size, device=dev),
                           0.0),
               torch.as_tensor(bw, device=dev),
               torch.as_tensor(cores, device=dev), C)


def _schedule_work(g, args):
    """(bytes, operations) one schedule call needs: each input byte read
    once (edges 33 B, tasks 16 B, objects 4 B, workers 8 B, a row's
    bandwidth) and the outputs written once (12 B a task); per row the
    rank's T² comparisons, each valid edge's terms over the W workers,
    and each task's start, argmin and commit over W and C."""
    R, T, E, O = g.R, g.T, g.E, g.O
    W, C = args[8].shape[1], args[9]
    n_edges = int(g.edge_valid.sum())
    nbytes = R * (33 * E + 16 * T + 4 * O + 8 * W + 4) + R * T * 12
    ops = R * T * T + n_edges * 3 * W + R * T * (4 * W + 2 * C)
    return nbytes, ops


def phase_kernel_list_schedule(seed=0):
    import torch
    from repro_torch.core.vectorized.scheduling import (
        LIST_ORDERS, blevel_priorities_plain, list_schedule_plain)
    from repro_torch.kernels import LIST_SCHEDULE_LAUNCHES as L
    from repro_torch.kernels import list_schedule as lk
    checks, timing = [], []
    cases = dict(SCHEDULE_CELLS)
    cases.update(SCHEDULE_CHECKS)
    for i, (name, case) in enumerate(cases.items()):
        graphs, clusters, R, shape = case[:4]
        g, args = _schedule_inputs(graphs, clusters, R, shape, seed + i,
                                   **(case[4] if len(case) > 4 else {}))
        *tensors, C = args
        edges = (g.e_task, g.prod_e, g.edge_valid, tensors[5])
        for order in LIST_ORDERS:
            want = list_schedule_plain(order, *tensors, C)
            before = L.count
            got = lk.list_schedule(order, *tensors, C)
            torch.cuda.synchronize()
            ok = (torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1]) and L.count == before + 1)
            if order == "blevel":
                prio = lk.blevel_priorities(*edges)
                torch.cuda.synchronize()
                ok = (ok and torch.equal(prio, want[1]) and torch.equal(
                    prio, blevel_priorities_plain(*edges))
                    and L.count == before + 2)
            checks.append(dict(case=name, order=order, R=R, T=g.T, E=g.E,
                               W=args[8].shape[1], C=C, bitwise=ok))
            if not ok:
                raise AssertionError(f"kernel_list_schedule {name} {order}: "
                                     f"the kernel differs from the plain "
                                     f"version ({checks[-1]})")
        if name in SCHEDULE_CELLS:
            nbytes, ops = _schedule_work(g, args)
            bound_ms, bound_by = _bound(nbytes, ops, F32_OPS_PER_S)
            timing.append(dict(
                case=name, R=R, T=g.T, E=g.E, W=args[8].shape[1], C=C,
                order="blevel", timed="cuda_events",
                ms=cuda_time_ms(lambda: lk.list_schedule(
                    "blevel", *tensors, C), iters=20, warmup=2),
                priorities_ms=cuda_time_ms(
                    lambda: lk.blevel_priorities(*edges), iters=20,
                    warmup=2),
                plain_ms=cuda_time_ms(lambda: list_schedule_plain(
                    "blevel", *tensors, C), iters=2, warmup=1),
                plain_priorities_ms=cuda_time_ms(
                    lambda: blevel_priorities_plain(*edges),
                    iters=2, warmup=1),
                bytes=nbytes, ops=ops, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None))
    emit("kernel_list_schedule", checks=len(checks),
         all_bitwise=all(c["bitwise"] for c in checks),
         cases=sorted(cases), timing=timing, card=CARD)
    return dict(max_abs_err=0.0, path=timing[0], timing=timing)


def _path_input_timing(plain_sample=16):
    """K1 on the main path's own inputs: every call of one blevel run of
    the survey_full_width cell, recorded, then checked bitwise on both
    routes and replayed from a CUDA graph per route in turns; rounds per
    row from the plain version, which is timed on a sample of the calls."""
    import torch
    from repro_torch.core.vectorized.waterfill import waterfill as plain
    from repro_torch.core.vectorized.waterfill import waterfill_rounds
    from repro_torch.kernels import waterfill as wk
    calls = _record_path_inputs("blevel")
    n = len(calls)
    cat = [torch.cat([c[i] for c in calls]) for i in range(5)]
    want, rounds = waterfill_rounds(*cat)
    R, F = calls[0][0].shape
    W = calls[0][3].shape[1]
    exact, worst = {}, 0.0
    for route in wk.ROUTES:
        got = wk._waterfill(*cat, route=route)
        torch.cuda.synchronize()
        a, _, exact[route] = _compare(got, want)
        worst = max(worst, a)
    if not all(exact.values()):
        raise AssertionError(f"waterfill disagrees with the plain version "
                             f"on the main path's inputs: {exact}")

    def timed(route):
        def replay():
            for c in calls:
                wk._waterfill(*c, route=route)
        return dict(ms=cuda_graph_ms(replay, iters=1) / n,
                    eager_ms=cuda_time_ms(replay, iters=2, warmup=1) / n)

    by_route = _turns(wk.ROUTES, timed)
    step = max(1, n // plain_sample)
    sample = calls[::step][:plain_sample]
    p_ms = cuda_time_ms(lambda: [plain(*c) for c in sample], iters=2,
                        warmup=1) / len(sample)
    nbytes, ops = _waterfill_work(rounds, R * n, F, W)
    bound_ms, bound_by = _bound(nbytes / n, ops / n, F32_OPS_PER_S)
    live_rows = rounds > 0
    warp = by_route["warp"]
    return dict(calls=n, rows_per_call=R, F=F, W=W, bitwise=exact,
                max_abs=worst, order="warp,block,block,warp", routes=by_route,
                ms=sum(x["ms"] for x in warp) / len(warp),
                plain_ms=p_ms, plain_sample=len(sample),
                rounds_mean=float(rounds.float().mean()),
                rounds_mean_live_rows=float(rounds[live_rows].float().mean())
                if bool(live_rows.any()) else 0.0,
                rounds_max=int(rounds.max()),
                rows_without_live_flow=float((~live_rows).float().mean()),
                bytes_per_call=nbytes / n, ops_per_call=ops / n,
                bound_ms=bound_ms, bound_by=bound_by)


def _golden_row(name, spec_graph, **opts):
    import numpy as np
    import torch
    from repro_torch.core import parse_cluster
    from repro_torch.core.imodes import encode_imode
    from repro_torch.core.vectorized import make_bucket_dynamic_simulator
    from repro_torch.core.vectorized.specs import (encode_graph, pad_spec,
                                                   pad_to, round_up,
                                                   t_bucket)
    want = GOLDEN[name]
    spec = encode_graph(spec_graph)
    shape = (t_bucket(spec.T), round_up(spec.O), round_up(spec.E))
    cores = parse_cluster(want["cluster"])
    d, s = encode_imode(spec_graph, "exact")
    from repro_torch.core.vectorized import capture_counter
    run = make_bucket_dynamic_simulator(len(cores), cores, "blevel",
                                        "maxmin", device="cuda",
                                        **(opts or dict(frontier=True)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture_counter() as cc:
        res = run(pad_spec(spec, shape), pad_to(d, shape[0]),
                  pad_to(s, shape[1]), 0.0, 0.0,
                  np.float32(100 * 1024 * 1024), 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(makespan=float(res.makespan), transferred=float(
        res.transferred), n_events=int(res.n_events),
        n_steps=int(res.n_steps), ok=bool(res.ok))
    good = (got["ok"] and got["n_events"] == want["n_events"]
            and got["n_steps"] == want["n_steps"]
            and abs(got["makespan"] - want["makespan"])
            <= RTOL * abs(want["makespan"])
            and abs(got["transferred"] - want["transferred"])
            <= RTOL * abs(want["transferred"]))
    return dict(graph=name, shape=list(shape), got=got, want=want,
                match=good, wall_s=wall, sim_calls=cc.calls,
                captures=cc.captures,
                events_per_s=got["n_events"] / wall), good


def phase_golden():
    from repro_torch.core.graphs import make_graph
    from repro_torch.kernels import WATERFILL_LAUNCHES
    WATERFILL_LAUNCHES.reset()
    rows = []
    for name, graph in (("merge_triplets", make_graph("merge_triplets",
                                                      seed=0)),
                        ("t2048_layered", t2048_graph())):
        row, good = _golden_row(name, graph)
        rows.append(row)
        if not good:
            emit("golden", rows=rows, ok=False)
            raise AssertionError(f"golden row {name} does not match: {row}")
    emit("golden", rows=rows, ok=True,
         waterfill_launches=WATERFILL_LAUNCHES.count)


# the per-edge escape hatches of the simulators, beside the default path
HATCHES = {"default": {}, "flow_slots_off": dict(flow_slots=False),
           "frontier_off": dict(frontier=False)}
HATCH_TURNS = ("default", "flow_slots_off", "frontier_off", "frontier_off",
               "flow_slots_off", "default")


def _mini_t160_group():
    """(entries, shape, batch, W, cores, points, caps) of the mini
    survey's T160 bucket on its one cluster group (8x4, 1x8+4x2)."""
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.survey import (MINI_GRID, cluster_groups,
                                    full_frontier_caps, grid_points)
    encoded, groups = encode_graph_batch(
        survey_names(MINI_GRID["graphs_per_family"]), seed=0, bucket=True)
    grp = next(g for g in groups if g.shape[0] == 160)
    (wb, _, cores2d), = cluster_groups(MINI_GRID["clusters"])
    return ([encoded[n] for n in grp.names], grp, wb, cores2d,
            grid_points(MINI_GRID), full_frontier_caps(grp.shape))


def _reset_launches():
    """Zero K1's, greedy placement's and the list schedule's launch
    counts: a main-path run's counts are zeroed just before it and read
    just after."""
    from repro_torch.kernels import (GREEDY_PLACE_LAUNCHES,
                                     LIST_SCHEDULE_LAUNCHES,
                                     WATERFILL_LAUNCHES)
    WATERFILL_LAUNCHES.reset()
    GREEDY_PLACE_LAUNCHES.reset()
    LIST_SCHEDULE_LAUNCHES.reset()


# the list schedule's launches on the main-path runs, summed as each run's
# counts are read (``_greedy_launches``)
MAIN_PATH_SCHEDULES = [0]


def _greedy_launches():
    """Greedy placement's launches since ``_reset_launches``; the list
    schedule's since then go into ``MAIN_PATH_SCHEDULES``."""
    from repro_torch.kernels import (GREEDY_PLACE_LAUNCHES,
                                     LIST_SCHEDULE_LAUNCHES)
    MAIN_PATH_SCHEDULES[0] += LIST_SCHEDULE_LAUNCHES.count
    return GREEDY_PLACE_LAUNCHES.count


def _hatch_call(runner, points):
    """One call of a grid runner: ``(result, wall s, K1 launches, K1
    routes, simulator calls, captures, greedy placement launches)``, the
    counts zeroed just before."""
    import torch
    from repro_torch.core.vectorized import capture_counter
    from repro_torch.kernels import WATERFILL_LAUNCHES
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture_counter() as cc:
        r = runner(points)
    torch.cuda.synchronize()
    return (r, time.perf_counter() - t0, WATERFILL_LAUNCHES.count,
            dict(WATERFILL_LAUNCHES.routes), cc.calls, cc.captures,
            _greedy_launches())


def _same_as_default(res, base):
    """makespan, ok, n_steps, n_events bitwise; transferred within 1e-5."""
    import numpy as np
    exact = all(np.array_equal(getattr(res, f), getattr(base, f),
                               equal_nan=True)
                for f in ("makespan", "ok", "n_steps", "n_events"))
    x_rel = float(np.max(np.abs(res.transferred - base.transferred)
                         / np.maximum(np.abs(base.transferred), 1.0)))
    return exact, x_rel


def phase_escape_hatches():
    """The simulators' per-edge escape hatches on the card
    (``flow_slots=False``: one max-min flow per input edge, K1 at F = E;
    ``frontier=False``: every edge and task scanned per event).  (a) The
    golden rows per hatch, in turns with the default path: GOLDEN's
    events and steps exactly, makespan and transferred within RTOL.  (b)
    The mini survey's T160 group (every scheduler x netmodel) and the
    full grid's T512 blevel group on 32x4 (in turns) per hatch against
    the default path in the same call: makespan, ok, steps and events
    bitwise, transferred within 1e-5.  Every simulator call captures one
    CUDA graph.  Returns K1's launches and routes, and greedy
    placement's launches, on the hatch runs."""
    import numpy as np
    from repro_torch.core.graphs import make_graph
    from repro_torch.core.vectorized import make_grid_runner
    launches = [0, {"warp": 0, "block": 0}, 0]
    failures = []

    def count(call):
        launches[0] += call[2]
        for r, n in call[3].items():
            launches[1][r] += n
        launches[2] += call[6]

    golden = []
    for name, graph in (("merge_triplets", make_graph("merge_triplets",
                                                      seed=0)),
                        ("t2048_layered", t2048_graph())):
        by_mode = {m: [] for m in HATCHES}
        for mode in HATCH_TURNS:
            from repro_torch.kernels import WATERFILL_LAUNCHES
            _reset_launches()
            row, good = _golden_row(name, graph, **HATCHES[mode])
            row.update(k1=WATERFILL_LAUNCHES.count,
                       k1_routes=dict(WATERFILL_LAUNCHES.routes))
            if mode != "default":
                count((None, None, row["k1"], row["k1_routes"], None, None,
                       _greedy_launches()))
            by_mode[mode].append(row)
            if not (good and row["sim_calls"] == row["captures"] == 1):
                failures.append(f"golden {name} {mode}: {row}")
        golden.append(dict(
            graph=name, order=",".join(HATCH_TURNS),
            got={m: rs[0]["got"] for m, rs in by_mode.items()},
            events_per_s={m: [r["events_per_s"] for r in rs]
                          for m, rs in by_mode.items()},
            k1_routes={m: rs[0]["k1_routes"] for m, rs in by_mode.items()},
            captures={m: [r["captures"] for r in rs]
                      for m, rs in by_mode.items()}))
        # F = E: the block route past 128 flows (merge_triplets fits a
        # warp)
        E = by_mode["flow_slots_off"][0]["shape"][2]
        if E > 128 and by_mode["flow_slots_off"][0]["k1_routes"][
                "block"] <= 0:
            failures.append(f"golden {name}: flow_slots=False did not "
                            f"launch K1's block route at F = E = {E}")

    # (b) the mini survey's T160 group, every scheduler x netmodel
    from repro_torch.survey import MINI_GRID
    entries, grp, wb, cores2d, points, caps = _mini_t160_group()
    mini = []
    for sched in MINI_GRID["schedulers"]:
        for netmodel in MINI_GRID["netmodels"]:
            calls = {}
            for mode in HATCHES:
                runner = make_grid_runner(
                    entries, sched, wb, cores2d, netmodel=netmodel,
                    shape=grp.shape, batch=grp.batch, device="cuda",
                    frontier_caps=caps, **HATCHES[mode])
                calls[mode] = _hatch_call(runner, points)
                if mode != "default":
                    count(calls[mode])
            base = calls["default"][0]
            row = dict(scheduler=sched, netmodel=netmodel,
                       rows=int(base.ok.size), all_ok=bool(base.ok.all()),
                       events=int(base.n_events.sum()))
            for mode, c in calls.items():
                exact, x_rel = _same_as_default(c[0], base)
                row[mode] = dict(wall_s=c[1], k1=c[2], k1_routes=c[3],
                                 greedy_place=c[6],
                                 sim_calls=c[4], captures=c[5],
                                 bitwise=exact, transferred_max_rel=x_rel)
                if not (exact and x_rel <= 1e-5 and c[4] == c[5] == 1):
                    failures.append(f"T160 {sched}/{netmodel} {mode}: "
                                    f"{row[mode]}")
            mini.append(row)

    # (b) the full grid's T512 blevel group on 32x4, in turns
    _, grp512, _, points512 = _full_width_group()
    runners = {m: _full_width_runner("blevel", "auto", **HATCHES[m])
               for m in HATCHES}
    turns = {m: [] for m in HATCHES}
    for mode in HATCH_TURNS:
        turns[mode].append(_hatch_call(runners[mode], points512))
    base = turns["default"][0][0]
    ev = int(base.n_events.sum())
    full = dict(scheduler="blevel", bucket=grp512.label, cluster="32x4",
                rows=int(base.ok.size), all_ok=bool(base.ok.all()),
                events=ev, order=",".join(HATCH_TURNS))
    for mode, cs in turns.items():
        if mode != "default":
            for c in cs:
                count(c)
        checks = [_same_as_default(c[0], base) for c in cs]
        full[mode] = dict(wall_s=[c[1] for c in cs],
                          events_per_s=[ev / c[1] for c in cs],
                          k1=[c[2] for c in cs], k1_routes=[c[3] for c in cs],
                          sim_calls=[c[4] for c in cs],
                          captures=[c[5] for c in cs],
                          bitwise=[x[0] for x in checks],
                          transferred_max_rel=[x[1] for x in checks])
        if not (all(x[0] and x[1] <= 1e-5 for x in checks)
                and all(c[4] == c[5] == 1 for c in cs)):
            failures.append(f"T512 blevel {mode}: {full[mode]}")
    if full["flow_slots_off"]["k1_routes"][0]["block"] <= 0:
        failures.append("T512: flow_slots=False did not launch K1's block "
                        "route at F = E")
    ok = not failures and full["all_ok"] and all(r["all_ok"] for r in mini)
    emit("escape_hatches", golden=golden, t160=mini, t512=full,
         waterfill_launches=launches[0], waterfill_launch_routes=launches[1],
         greedy_place_launches=launches[2], failures=failures, card=CARD,
         ok=ok)
    if not ok:
        raise AssertionError(f"escape_hatches: {failures}")
    return tuple(launches)


def phase_simlint():
    """The port's simlint on the card: the source rules over the port
    (``check_paths``) and the step checks of all 27 targets
    (``check_all(device="cuda")``).  Fails unless no finding is active,
    every target ran its step, and no step read the host."""
    from repro_torch.analysis import RULES, active, check_all, check_paths
    t0 = time.perf_counter()
    ast_found = check_paths()
    stats = {}
    step_found = check_all(device="cuda", stats=stats)
    found = ast_found + step_found
    act = active(found)
    host_reads = sum(s["host_reads"] for s in stats.values())
    ok = not act and host_reads == 0 and len(stats) == 27
    emit("simlint", targets=len(stats), active=len(act),
         per_rule={r: sum(f.rule == r for f in act) for r in sorted(RULES)},
         suppressed_per_rule={r: sum(f.rule == r and f.suppressed
                                     for f in found) for r in sorted(RULES)},
         host_reads_in_steps=host_reads,
         step_ops=sum(s["ops"]["step"] for s in stats.values()),
         findings=[f.render() for f in act],
         seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError(f"simlint: {len(act)} active finding(s), "
                             f"{host_reads} host read(s) in steps, "
                             f"{len(stats)} targets")


def phase_survey_mini():
    from repro_torch.kernels import WATERFILL_LAUNCHES
    from repro_torch.survey import MINI_GRID, survey
    WATERFILL_LAUNCHES.reset()
    rows, _, stats = survey(MINI_GRID, out_dir=os.path.join(
        HERE, "results", "chip_smoke"), device="cuda", agreement=False)
    emit("survey_mini", rows=len(rows), sims=stats["sims"],
         groups=stats["groups"], events=stats["events"],
         wall_s=stats["wall_s"], events_per_s=stats["events_per_s"],
         all_ok=stats["all_ok"], waterfill_launches=WATERFILL_LAUNCHES.count,
         sim_calls=stats["sim_calls"], graph_captures=stats["captures"])
    if (not stats["all_ok"] or len(rows) != 512
            or stats["captures"] != stats["sim_calls"]):
        raise AssertionError(f"mini survey failed: {len(rows)} rows, "
                             f"all_ok={stats['all_ok']}")


def _agreement_survey(phase, dataset, want):
    """The mini grid over ``dataset`` through ``survey(...)`` with the
    agreement pass on the card, K1's launches counted from just before
    to just after, and greedy placement's with them.  Returns ``(rows,
    stats, line, good)``: ``line`` the phase's fields, ``good`` whether
    every simulation was ok, K1 and greedy's placement ran and every
    ratio equals ``want[(graph, scheduler)]`` within RTOL."""
    from repro_torch.kernels import WATERFILL_LAUNCHES
    from repro_torch.survey import MINI_GRID, geomean, survey
    grid = dict(MINI_GRID, dataset=dataset)
    _reset_launches()
    rows, agree, stats = survey(grid, out_dir=os.path.join(
        HERE, "results", "chip_smoke", phase), device="cuda",
        agreement=True)
    launches = WATERFILL_LAUNCHES.count
    routes = dict(WATERFILL_LAUNCHES.routes)
    greedy = _greedy_launches()
    plain = [a for a in agree if a["graph_name"] != "__pergraph_path__"]
    per = [a for a in agree if a["graph_name"] == "__pergraph_path__"]
    ratios, worst = [], 0.0
    for a in plain:
        key = (a["graph_name"], a["scheduler_name"])
        ref = want.get(key)
        rel = (abs(a["makespan_ratio"] - ref) / abs(ref)
               if ref is not None else None)
        ratios.append(dict(graph=key[0], scheduler=key[1],
                           cluster=a["cluster_name"], bucket=a["bucket"],
                           ratio=a["makespan_ratio"], reference=ref,
                           rel_err=rel))
        worst = max(worst, rel if rel is not None else float("inf"))
    line = dict(dataset=stats["dataset"], t_edges=stats["t_edges"],
                buckets=stats["buckets"], rows=len(rows),
                sims=stats["sims"], groups=stats["groups"],
                events=stats["events"], all_ok=stats["all_ok"],
                survey_wall_s=stats["wall_s"],
                events_per_s=stats["events_per_s"],
                agreement_wall_s=stats["agreement_s"],
                speedup_geomean=(geomean([a["speedup"] for a in plain])
                                 if plain else None),
                bucket_cold_s=per[0]["bucket_cold_s"] if per else None,
                pergraph_cold_s=per[0]["pergraph_cold_s"] if per else None,
                agreement_rows=len(plain), pergraph_rows=len(per),
                sim_calls=stats["sim_calls"], graph_captures=stats["captures"],
                ratios=ratios, worst_rel_err=worst,
                waterfill_launches=launches,
                waterfill_launch_routes=routes,
                greedy_place_launches=greedy, card=CARD)
    good = (stats["all_ok"] and len(plain) == len(want) and len(per) == 1
            and {(r["graph"], r["scheduler"]) for r in ratios} == set(want)
            and worst <= RTOL and launches > 0 and greedy > 0
            and stats["captures"] == stats["sim_calls"] == stats["groups"])
    return rows, stats, line, good


def phase_survey_agreement():
    rows, _, line, good = _agreement_survey("survey_agreement", "default",
                                            MINI_AGREEMENT)
    good = good and len(rows) == 512
    emit("survey_agreement", **line, ok=good)
    if not good:
        raise AssertionError("survey_agreement: the mini survey's agreement "
                             "rows disagree with the reference's")
    return (line["waterfill_launches"], line["waterfill_launch_routes"],
            line["greedy_place_launches"])


def phase_survey_dataset():
    rows, stats, line, good = _agreement_survey(
        "survey_dataset", "wfcommons-mini", DATASET_AGREEMENT)
    buckets = dict(b.split(":") for b in stats["buckets"])
    good = (good and len(rows) == 768
            and tuple(stats["t_edges"]) == DATASET_EDGES
            and buckets == {k: ",".join(v)
                            for k, v in DATASET_BUCKETS.items()})
    emit("survey_dataset", **line, ok=good)
    if not good:
        raise AssertionError("survey_dataset: the wfcommons-mini survey "
                             "disagrees with the reference's")
    return (line["waterfill_launches"], line["waterfill_launch_routes"],
            line["greedy_place_launches"])


def _full_width_agreement(sched, res, points):
    """Agreement rows of the T512 bucket on 32x4 at point 0: the kernel
    run's batched makespan over the reference event loop's twin, each
    held against the reference's recorded values."""
    from repro_torch.core import parse_cluster
    from repro_torch.survey import time_reference_twin
    _, grp, _, _ = _full_width_group()
    cores = parse_cluster("32x4")
    out = []
    for b, gname in enumerate(grp.names):
        want_vec, want_twin = FULL_WIDTH_AGREEMENT[(sched, gname)]
        reps, ref_us = time_reference_twin(gname, sched, len(cores), cores,
                                           points[:1])
        vec = float(res.makespan[0, b, 0])
        twin = reps[0].makespan
        out.append(dict(
            graph=gname, batched=vec, twin=twin, ratio=vec / twin,
            ref_us=ref_us, reference_batched=want_vec,
            reference_twin=want_twin, twin_equal=twin == want_twin,
            batched_rel_err=(abs(vec - want_vec) / abs(want_vec)
                             if want_vec is not None else None)))
    return out


def phase_survey_full_width(schedulers=("blevel", "greedy")):
    import numpy as np
    import torch
    from repro_torch.kernels import WATERFILL_LAUNCHES
    _, grp, _, points = _full_width_group()
    out = []
    main_path = dict(count=0, routes=dict.fromkeys(WATERFILL_LAUNCHES.routes,
                                                   0), greedy_place=0)
    for sched in schedulers:
        runners = {impl: _full_width_runner(sched, impl)
                   for impl in ("auto", "torch")}
        res = {"auto": [], "torch": []}
        # in turns (plain, kernel, kernel, plain) on one card, so host
        # noise does not favour either side; "plain" is K1's plain
        # version: greedy's placement kernel runs in every turn
        for impl in ("torch", "auto", "auto", "torch"):
            # the main path's own counts: zeroed just before, read just
            # after
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = runners[impl](points)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res[impl].append((r, wall, WATERFILL_LAUNCHES.count,
                              dict(WATERFILL_LAUNCHES.routes),
                              _greedy_launches()))
        ra, la, routes = (res["auto"][0][i] for i in (0, 2, 3))
        rt, lt = res["torch"][0][0], res["torch"][0][2]
        greedy = [x[4] for impl in res for x in res[impl]]
        main_path["count"] += la
        main_path["greedy_place"] += res["auto"][0][4]
        for k, v in routes.items():
            main_path["routes"][k] += v
        runs = [x[0] for impl in res for x in res[impl]]
        same_counts = all(np.array_equal(getattr(x, f), getattr(rt, f))
                          for x in runs
                          for f in ("ok", "n_events", "n_steps"))
        ms_rel = max(float(np.max(np.abs(x.makespan - rt.makespan)
                                  / np.abs(rt.makespan))) for x in runs)
        x_rel = max(float(np.max(np.abs(x.transferred - rt.transferred)
                                 / np.maximum(np.abs(rt.transferred), 1.0)))
                    for x in runs)
        ev = int(ra.n_events.sum())
        k_walls = [x[1] for x in res["auto"]]
        p_walls = [x[1] for x in res["torch"]]
        row = dict(scheduler=sched, bucket=grp.label, graphs=list(grp.names),
                   cluster="32x4", points=len(points),
                   rows=int(ra.ok.size), all_ok=bool(ra.ok.all()),
                   events=ev, max_steps=int(ra.n_steps.max()),
                   order="plain,kernel,kernel,plain",
                   plain_means="K1's plain version (waterfill_impl "
                               "'torch'); greedy's placement kernel runs "
                               "in every turn",
                   kernel_wall_s=k_walls,
                   kernel_events_per_s=[ev / w for w in k_walls],
                   plain_wall_s=p_walls,
                   plain_events_per_s=[ev / w for w in p_walls],
                   kernel_launches=[x[2] for x in res["auto"]],
                   kernel_launch_routes=[x[3] for x in res["auto"]],
                   plain_launches=[x[2] for x in res["torch"]],
                   greedy_place_launches=greedy,
                   counts_equal=same_counts, makespan_max_rel=ms_rel,
                   transferred_max_rel=x_rel,
                   bitwise_makespan=all(np.array_equal(x.makespan,
                                                       rt.makespan)
                                        for x in runs))
        if sched == "blevel":
            # one more kernel run, outside the timed turns, under the
            # profiler: how busy the card is during a survey, and K1's
            # share of its device time
            row["profile"] = _device_profile(lambda: runners["auto"](points))
        # the agreement at full width, after the timed turns: the first
        # kernel run's makespans at point 0 against the twins
        agree = _full_width_agreement(sched, ra, points)
        row["agreement"] = agree
        agree_ok = all(a["twin_equal"] and (a["batched_rel_err"] is None
                                            or a["batched_rel_err"] <= RTOL)
                       for a in agree)
        out.append(row)
        if not (row["all_ok"] and same_counts and ms_rel <= RTOL
                and x_rel <= RTOL and la > 0 and lt == 0
                and routes["warp"] == la and agree_ok
                and all(n == 0 for n in row["plain_launches"])
                and len(set(greedy)) == 1
                and (greedy[0] > 0) == (sched == "greedy")):
            emit("survey_full_width", rows=out, ok=False)
            raise AssertionError(f"full-width group disagrees: {row}")
    ratios = [a["ratio"] for r in out for a in r["agreement"]]
    emit("survey_full_width", rows=out, ok=True, card=CARD,
         agreement_worst_abs_ratio_minus_1=max(abs(x - 1) for x in ratios),
         waterfill_launches=main_path["count"],
         waterfill_launch_routes=main_path["routes"],
         greedy_place_launches=main_path["greedy_place"])
    return (main_path["count"], main_path["routes"],
            main_path["greedy_place"])


ENGINE_TURNS = (("vmap", "eager"), ("vmap", "graph"), ("sharded", "graph"))


def _engine_turn(runner, points):
    """One timed call of ``runner``: ``(result, wall s, K1 launches, K1
    routes, capture_counter, greedy placement launches)``, the counts
    zeroed just before."""
    import torch
    from repro_torch.core.vectorized import capture_counter
    from repro_torch.kernels import WATERFILL_LAUNCHES
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture_counter() as cc:
        r = runner(points)
    torch.cuda.synchronize()
    return (r, time.perf_counter() - t0, WATERFILL_LAUNCHES.count,
            dict(WATERFILL_LAUNCHES.routes), cc, _greedy_launches())


def phase_survey_engine(schedulers=("blevel", "greedy"), stream_rows=32):
    """The survey_full_width group through the grid engine: one call of
    all rows (``vmap``) eager and from a CUDA graph of the event step,
    and the rows streamed in chunks of ``stream_rows`` (``sharded``)
    from the graph, in turns (a, b, c, c, b, a) inside this call; then
    one eager streamed run for its K1 count.  Fails unless every run is
    bitwise equal, each graph run launches K1 as often as the eager run
    of the same calls (all ``warp``), greedy's placement once a loop
    step (none for blevel), and each graph run captures once per
    simulator call (chunks for ``sharded``).  Returns K1's launches and
    routes, and greedy placement's launches, of each scheduler's first
    streamed graph turn."""
    import numpy as np
    _, grp, _, points = _full_width_group()
    out, k1 = [], [0, {}, 0]
    for sched in schedulers:
        runners = {(eng, sg): _full_width_runner(
            sched, "auto", step_graph=sg, engine=eng,
            stream_rows=stream_rows if eng == "sharded" else None)
            for eng, sg in ENGINE_TURNS + (("sharded", "eager"),)}
        turns = {key: [] for key in runners}
        for key in ENGINE_TURNS + ENGINE_TURNS[::-1]:
            turns[key].append(_engine_turn(runners[key], points))
        # not timed in turns: the eager streamed run's K1 count
        turns[("sharded", "eager")].append(
            _engine_turn(runners[("sharded", "eager")], points))
        ref = turns[("vmap", "eager")][0][0]
        rows = int(ref.ok.size)
        chunk, padded = runners[("sharded", "graph")]._row_chunks(rows)
        chunks = padded // chunk
        ev = int(ref.n_events.sum())
        bitwise = all(np.array_equal(getattr(t[0], f), getattr(ref, f),
                                     equal_nan=True)
                      for ts in turns.values() for t in ts
                      for f in ref._fields)
        row = dict(scheduler=sched, bucket=grp.label, cluster="32x4",
                   points=len(points), rows=rows, all_ok=bool(ref.ok.all()),
                   events=ev, max_steps=int(ref.n_steps.max()),
                   stream_rows=stream_rows, chunks=chunks,
                   order="vmap-eager,vmap-graph,sharded-graph,sharded-graph,"
                         "vmap-graph,vmap-eager", bitwise=bitwise, card=CARD)
        good = row["all_ok"] and bitwise and chunks >= 3
        for (eng, sg), ts in turns.items():
            launches = [t[2] for t in ts]
            # loop steps of these calls: step 0 of each call + the replays
            # of the graph turn of the same engine (the same loops)
            g = turns[(eng, "graph")][0][4]
            steps = g.calls + g.replays
            row[f"{eng}_{sg}"] = dict(
                wall_s=[t[1] for t in ts],
                events_per_s=[ev / t[1] for t in ts],
                wall_ms_per_step=[t[1] * 1e3 / steps for t in ts],
                loop_steps=steps, k1_launches=launches,
                k1_routes=[t[3] for t in ts],
                greedy_place_launches=[t[5] for t in ts],
                sim_calls=[t[4].calls for t in ts],
                captures=[t[4].captures for t in ts],
                replays=[t[4].replays for t in ts])
            calls = chunks if eng == "sharded" else 1
            eager_launches = turns[(eng, "eager")][0][2]
            good = (good and all(t[4].calls == calls for t in ts)
                    and all(t[4].captures == (calls if sg == "graph" else 0)
                            for t in ts)
                    and all(n == eager_launches and n == steps for n
                            in launches)
                    and all(t[3]["warp"] == t[2] for t in ts)
                    and all(t[5] == (steps if sched == "greedy" else 0)
                            for t in ts))
        sg = row["sharded_graph"]
        k1[0] += sg["k1_launches"][0]
        for r, n in sg["k1_routes"][0].items():
            k1[1][r] = k1[1].get(r, 0) + n
        k1[2] += sg["greedy_place_launches"][0]
        if sched == "blevel":
            # one more graph run of all rows, outside the turns, under
            # the profiler: the card's busy and idle share with the step
            # replayed from a graph
            row["profile"] = _device_profile(
                lambda: runners[("vmap", "graph")](points))
        out.append(row)
        if not good:
            emit("survey_engine", rows=out, ok=False)
            raise AssertionError(f"survey_engine: {sched} disagrees between "
                                 f"engines or step modes: {row}")
    emit("survey_engine", rows=out, ok=True, card=CARD,
         waterfill_launches=k1[0], waterfill_launch_routes=k1[1],
         greedy_place_launches=k1[2])
    return tuple(k1)


# ------------------------------------------- the grid engine over ranks
RANKS = 2
RANKS_TIMEOUT_S = 300
# one rank of survey_ranks (a): the survey_full_width group through
# ShardedGridRunner(devices=2) in a gloo group over localhost
RANK_CHILD = """
import json, os, sys, time
from datetime import timedelta
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke as cs
rank, port, out = int(os.environ["RANK"]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=cs.RANKS,
                        timeout=timedelta(seconds=cs.RANKS_TIMEOUT_S))
from repro_torch.core.vectorized import capture_counter
from repro_torch.kernels import GREEDY_PLACE_LAUNCHES, WATERFILL_LAUNCHES
points = cs._full_width_group()[3]
rec = {}
for sched in sys.argv[4].split(","):
    runner = cs._full_width_runner(sched, "auto", engine="sharded",
                                   devices=cs.RANKS, stream_rows=32)
    WATERFILL_LAUNCHES.reset()
    GREEDY_PLACE_LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture_counter() as cc:
        res = runner(points)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    np.savez(os.path.join(out, f"{sched}_rank{rank}.npz"), **res._asdict())
    rec[sched] = dict(
        rank=rank, device=str(runner.device), n_devices=runner.n_devices,
        chunks=runner._row_chunks(int(res.ok.size)), wall_s=wall,
        events=int(res.n_events.sum()), calls=cc.calls,
        captures=cc.captures, replays=cc.replays,
        k1_launches=WATERFILL_LAUNCHES.count,
        k1_routes=dict(WATERFILL_LAUNCHES.routes),
        greedy_place_launches=GREEDY_PLACE_LAUNCHES.count)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
dist.destroy_process_group()
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait_all(procs, what, timeout=RANKS_TIMEOUT_S):
    """Wait for every process of ``procs`` (``{name: Popen}``, output to
    a pipe); the first that fails or the deadline kills the rest and
    raises.  Returns ``{name: output}``."""
    deadline = time.perf_counter() + timeout
    try:
        while any(p.poll() is None for p in procs.values()):
            failed = [n for n, p in procs.items()
                      if p.poll() not in (None, 0)]
            if failed or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    logs = {n: p.communicate()[0] for n, p in procs.items()}
    bad = {n: (p.returncode, logs[n][-3000:]) for n, p in procs.items()
           if p.returncode != 0}
    if bad:
        raise AssertionError(f"{what}: failed or timed out: {bad}")
    return logs


def _rank_env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
                OMP_NUM_THREADS="1", **extra)


def _survey_cli(out_dir, ranks):
    """``repro_torch.survey --mini --no-agreement --engine sharded
    --assert-compiles`` into ``out_dir``: under ``torch.distributed.run``
    with ``ranks`` ranks above 1, else one process."""
    args = ["-m", "repro_torch.survey", "--mini", "--no-agreement",
            "--engine", "sharded", "--devices", str(ranks),
            "--assert-compiles", "--out", out_dir]
    if ranks > 1:
        args = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ranks), *args]
    return subprocess.Popen([sys.executable, *args], env=_rank_env(),
                            cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _read_csv(path):
    import csv
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def phase_survey_ranks(schedulers=("blevel", "greedy"), stream_rows=32):
    """The grid engine over two ranks sharing the one card: (a) the
    survey_full_width group through ``ShardedGridRunner(devices=2,
    stream_rows=32)`` in two processes of a gloo group, each on
    ``cuda:0``, against this process's one-card sharded run of the same
    group: every field bitwise on both ranks, one capture per chunk on
    each rank, every K1 launch ``warp`` and as many as the rank's loop
    steps; (b) the mini survey's CLI under ``torch.distributed.run``
    with two ranks (``--assert-compiles``) against a one-card run of the
    same command: equal CSVs.  Each rank's wall time and events/s are
    printed; two ranks time-slice one card, so they are no multi-card
    speed.  Returns K1's launches of (a) on both ranks, by route."""
    import shutil
    import tempfile

    import numpy as np
    t0 = time.perf_counter()
    _, grp, _, points = _full_width_group()
    one = {sched: _full_width_runner(sched, "auto", engine="sharded",
                                     devices=1, stream_rows=stream_rows)(
        points) for sched in schedulers}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="survey_ranks_",
                           dir=os.path.join(HERE, "build"))
    try:
        port = _free_port()
        procs = {r: subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD, HERE, str(port), tmp,
             ",".join(schedulers)],
            env=_rank_env(RANK=str(r), LOCAL_RANK=str(r),
                          WORLD_SIZE=str(RANKS)),
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(RANKS)}
        _wait_all(procs, "survey_ranks (a)")
        recs = []
        for r in range(RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        k1, routes, greedy, out, good = 0, {}, 0, [], True
        for sched in schedulers:
            ref = one[sched]
            rows = int(ref.ok.size)
            for r in range(RANKS):
                rec = recs[r][sched]
                got = np.load(os.path.join(tmp, f"{sched}_rank{r}.npz"))
                rec["bitwise"] = all(np.array_equal(got[f], getattr(ref, f),
                                                    equal_nan=True)
                                     for f in ref._fields)
                rec["events_per_s"] = rec["events"] / rec["wall_s"]
                chunks = rec["chunks"][1] // rec["chunks"][0]
                steps = rec["calls"] + rec["replays"]
                rec["ok"] = (rec["bitwise"] and bool(ref.ok.all())
                             and rec["n_devices"] == RANKS
                             and rec["device"] == "cuda:0"
                             and rec["calls"] == rec["captures"] == chunks
                             and chunks == -(-rows // stream_rows)
                             and rec["k1_launches"] == steps > 0
                             and rec["k1_routes"].get("warp", 0)
                             == rec["k1_launches"]
                             and rec["greedy_place_launches"]
                             == (steps if sched == "greedy" else 0))
                good &= rec["ok"]
                emit("survey_ranks_rank", scheduler=sched, bucket=grp.label,
                     cluster="32x4", rows=rows, **rec, card=CARD)
                k1 += rec["k1_launches"]
                greedy += rec["greedy_place_launches"]
                for rt, n in rec["k1_routes"].items():
                    routes[rt] = routes.get(rt, 0) + n
                out.append(dict(scheduler=sched, **{
                    k: rec[k] for k in ("rank", "wall_s", "events_per_s",
                                        "captures", "k1_launches",
                                        "bitwise", "ok")}))
        if not good:
            emit("survey_ranks", rows=out, ok=False)
            raise AssertionError(f"survey_ranks: two ranks differ from the "
                                 f"one-card run: {out}")
        # (b) the survey's CLI, two ranks and one card at once
        cli = {n: os.path.join(tmp, f"cli{n}") for n in (RANKS, 1)}
        logs = _wait_all({n: _survey_cli(d, n) for n, d in cli.items()},
                         "survey_ranks (b)")
        passed = [line for line in logs[RANKS].splitlines()
                  if line.startswith("# compile-count assertion passed")]
        two_csv = _read_csv(os.path.join(cli[RANKS], "survey_torch.csv"))
        one_csv = _read_csv(os.path.join(cli[1], "survey_torch.csv"))
        cli_rec = dict(rows=len(two_csv), equal_csv=two_csv == one_csv,
                       assertions_passed=passed)
        if not (cli_rec["equal_csv"] and len(passed) == RANKS and two_csv):
            emit("survey_ranks", rows=out, cli=cli_rec, ok=False)
            raise AssertionError(f"survey_ranks: the two-rank survey CLI "
                                 f"differs from one card: {cli_rec}\n"
                                 f"{logs[RANKS][-3000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("survey_ranks", rows=out, cli=cli_rec, ranks=RANKS,
         shared_card="cuda:0",
         speed_note="both ranks time-slice one card: their walls and "
                    "events/s are not a multi-card speed",
         nccl_across_cards="not checked: one card", card=CARD, ok=True,
         waterfill_launches=k1, waterfill_launch_routes=routes,
         greedy_place_launches=greedy, seconds=time.perf_counter() - t0)
    return k1, routes, greedy


# ------------------------------------------- the static simulator, genetic-vec
def _static_golden_row(name, graph):
    """One ``BENCH_PR7.json`` static row: blevel from the exact
    estimates by ``build(..., scheduler="blevel")``, padded to the
    bucket, then the static simulator (``build`` with no scheduler, the
    shape's frontier caps) through K1."""
    import numpy as np
    import torch
    from repro_torch.core import MiB, parse_cluster
    from repro_torch.core.imodes import encode_imode
    from repro_torch.core.vectorized import build
    from repro_torch.core.vectorized.specs import (encode_graph, pad_spec,
                                                   pad_to, round_up,
                                                   t_bucket)
    want = STATIC_GOLDEN[name]
    spec = encode_graph(graph)
    shape = (t_bucket(spec.T), round_up(spec.O), round_up(spec.E))
    cores = parse_cluster(want["cluster"])
    bw = np.float32(100 * MiB)
    d, s = encode_imode(graph, "exact")
    aw, prio = build(spec, n_workers=len(cores), cores=cores,
                     scheduler="blevel", device="cuda")(d, s, bw)
    run = build(None, n_workers=len(cores), cores=cores, device="cuda")
    args = (pad_spec(spec, shape), pad_to(aw.cpu().numpy(), shape[0], 0),
            pad_to(prio.cpu().numpy(), shape[0], 0.0), None, None, bw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(makespan=float(res.makespan), transferred=float(
        res.transferred), n_events=int(res.n_events),
        n_steps=int(res.n_steps), ok=bool(res.ok))
    good = (got["ok"] and got["n_events"] == want["n_events"]
            and got["n_steps"] == want["n_steps"]
            and got["makespan"] == want["makespan"]
            and abs(got["transferred"] - want["transferred"])
            <= RTOL * abs(want["transferred"]))
    return dict(graph=name, shape=list(shape), got=got, want=want,
                match=good, wall_s=wall,
                events_per_s=got["n_events"] / wall), good


def phase_static_golden():
    from repro_torch.core.graphs import make_graph
    from repro_torch.kernels import WATERFILL_LAUNCHES
    rows, launches = [], 0
    routes = dict.fromkeys(WATERFILL_LAUNCHES.routes, 0)
    for name, graph in (("merge_triplets", make_graph("merge_triplets",
                                                      seed=0)),
                        ("t2048_layered", t2048_graph())):
        # the path's own count: zeroed just before, read just after
        WATERFILL_LAUNCHES.reset()
        row, good = _static_golden_row(name, graph)
        row["waterfill_launches"] = WATERFILL_LAUNCHES.count
        good = good and WATERFILL_LAUNCHES.count > 0
        launches += WATERFILL_LAUNCHES.count
        for k, v in WATERFILL_LAUNCHES.routes.items():
            routes[k] += v
        rows.append(row)
        if not good:
            emit("static_golden", rows=rows, ok=False)
            raise AssertionError(f"static golden row {name} does not "
                                 f"match: {row}")
    emit("static_golden", rows=rows, ok=True, card=CARD,
         waterfill_launches=launches, waterfill_launch_routes=routes)
    return launches, routes


def _static_full_width_rows():
    """The 40 rows of the static_full_width cell: each graph of the T512
    bucket x the five static schedules x 100 and 512 MiB/s, scheduled by
    the port's bucket schedulers on the card from exact estimates
    (seed 0), as ``(keys, spec rows, assignments, priorities,
    bandwidths)``."""
    import numpy as np
    from repro_torch.core import MiB
    from repro_torch.core.imodes import encode_imode
    from repro_torch.core.vectorized import build
    from repro_torch.core.vectorized.specs import pad_to
    encoded, grp, cores, _ = _full_width_group()
    T, O, _E = grp.shape
    est = [encode_imode(encoded[n][0], "exact") for n in grp.names]
    D = np.stack([pad_to(d, T) for d, _ in est])
    S = np.stack([pad_to(s, O) for _, s in est])
    keys, rows_b, rows_a, rows_p, rows_bw = [], [], [], [], []
    for sched in STATIC_SCHEDULERS:
        fn = build(None, n_workers=32, cores=cores[0], scheduler=sched,
                   device="cuda")
        for mib in STATIC_BANDWIDTHS_MIB:
            bw = np.full(len(grp.names), mib * MiB, np.float32)
            aw, prio = fn(grp.batch, D, S, bw, 0)
            for b, name in enumerate(grp.names):
                keys.append((sched, mib, name))
                rows_b.append(b)
                rows_a.append(aw[b].cpu().numpy())
                rows_p.append(prio[b].cpu().numpy())
                rows_bw.append(mib * MiB)
    spec = grp.batch.map(lambda x: np.asarray(x)[rows_b])
    return (keys, spec, np.stack(rows_a), np.stack(rows_p),
            np.asarray(rows_bw, np.float32))


def phase_static_full_width():
    import numpy as np
    import torch
    from repro_torch.core.vectorized import build
    from repro_torch.kernels import WATERFILL_LAUNCHES
    _, grp, cores, _ = _full_width_group()
    T, _O, E = grp.shape
    t0 = time.perf_counter()
    keys, spec, A, P, BW = _static_full_width_rows()
    schedule_s = time.perf_counter() - t0
    runs = {impl: build(None, n_workers=32, cores=cores[0],
                        frontier_caps=(E, T), device="cuda",
                        waterfill_impl=impl) for impl in ("auto", "torch")}
    # the same kernel path with every step issued from the host
    runs["eager"] = build(None, n_workers=32, cores=cores[0],
                          frontier_caps=(E, T), device="cuda",
                          step_graph="eager")
    res = {"auto": [], "torch": [], "eager": []}
    # in turns (plain, kernel, kernel, plain) on one card, both from the
    # step's CUDA graph; then one eager kernel turn
    for impl in ("torch", "auto", "auto", "torch", "eager"):
        WATERFILL_LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = runs[impl](spec, A, P, None, None, BW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = {f: getattr(r, f).cpu().numpy() for f in r._fields}
        res[impl].append((r, wall, WATERFILL_LAUNCHES.count,
                          dict(WATERFILL_LAUNCHES.routes)))
    ra, la, routes = res["auto"][0][0], res["auto"][0][2], \
        res["auto"][0][3]
    rt = res["torch"][0][0]
    every = [x[0] for impl in res for x in res[impl]]
    bitwise = all(np.array_equal(x[f], rt[f], equal_nan=True)
                  for x in every for f in rt)
    mismatches = []
    for i, key in enumerate(keys):
        ok, n_ev, n_st, ms, xfer = STATIC_FULL_WIDTH[key]
        good = (bool(ra["ok"][i]) == ok and int(ra["n_events"][i]) == n_ev
                and int(ra["n_steps"][i]) == n_st
                and float(ra["makespan"][i]) == ms
                and abs(float(ra["transferred"][i]) - xfer)
                <= RTOL * abs(xfer))
        if not good:
            mismatches.append(dict(
                key=list(key), want=[ok, n_ev, n_st, ms, xfer],
                got=[bool(ra["ok"][i]), int(ra["n_events"][i]),
                     int(ra["n_steps"][i]), float(ra["makespan"][i]),
                     float(ra["transferred"][i])]))
    ev = int(ra["n_events"].sum())
    k_walls = [x[1] for x in res["auto"]]
    p_walls = [x[1] for x in res["torch"]]
    line = dict(bucket=grp.label, graphs=list(grp.names), cluster="32x4",
                schedulers=list(STATIC_SCHEDULERS),
                bandwidths_mib=list(STATIC_BANDWIDTHS_MIB), rows=len(keys),
                all_ok=bool(ra["ok"].all()), events=ev,
                max_steps=int(ra["n_steps"].max()), schedule_s=schedule_s,
                order="plain,kernel,kernel,plain", kernel_wall_s=k_walls,
                kernel_events_per_s=[ev / w for w in k_walls],
                plain_wall_s=p_walls,
                plain_events_per_s=[ev / w for w in p_walls],
                kernel_launches=[x[2] for x in res["auto"]],
                kernel_launch_routes=[x[3] for x in res["auto"]],
                plain_launches=[x[2] for x in res["torch"]],
                eager_wall_s=res["eager"][0][1],
                eager_events_per_s=ev / res["eager"][0][1],
                eager_launches=res["eager"][0][2],
                kernel_plain_bitwise=bitwise,
                reference_mismatches=mismatches, card=CARD)
    # one more kernel run, outside the timed turns, under the profiler:
    # the card's busy and idle share and K1's share
    line["profile"] = _device_profile(
        lambda: runs["auto"](spec, A, P, None, None, BW))
    good = (line["all_ok"] and bitwise and not mismatches
            and len(keys) == len(STATIC_FULL_WIDTH)
            and all(n == 0 for n in line["plain_launches"])
            and la > 0 and routes["warp"] == la
            and all(x[2] == la for x in res["auto"] + res["eager"]))
    emit("static_full_width", **line, ok=good)
    if not good:
        raise AssertionError("static_full_width: the rows disagree with the "
                             "reference's or between kernel and plain")
    return la, routes


def _genetic_run(impl, **kw):
    """The reference event loop on fastcrossv at 32x4 with the port's
    ``genetic-vec`` (seed 0): (makespan, each task's worker, wall s)."""
    import torch
    from repro_torch.core import (Simulator, make_scheduler, parse_cluster,
                                  resolve_workers)
    from repro_torch.core.graphs import make_graph
    g = make_graph("fastcrossv", seed=0)
    sched = make_scheduler("genetic-vec", seed=0, device="cuda",
                           waterfill_impl=impl, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = Simulator(g, resolve_workers(parse_cluster("32x4")), sched).run()
    torch.cuda.synchronize()
    return (rep.makespan, [rep.task_records[t].worker for t in g.tasks],
            time.perf_counter() - t0, sched)


def phase_genetic_vec(short_generations=2):
    from repro_torch.kernels import WATERFILL_LAUNCHES
    WATERFILL_LAUNCHES.reset()
    ms, workers, wall, sched = _genetic_run("auto")
    launches = WATERFILL_LAUNCHES.count
    routes = dict(WATERFILL_LAUNCHES.routes)
    gens = sched.generations
    want_ms, want_workers = GENETIC_VEC[gens]
    short = {}
    for impl in ("torch", "auto"):
        s_ms, s_workers, s_wall, _ = _genetic_run(
            impl, generations=short_generations)
        short[impl] = dict(makespan=s_ms, wall_s=s_wall,
                           reference_equal=(
                               (s_ms, s_workers)
                               == GENETIC_VEC[short_generations]))
    line = dict(graph="fastcrossv", cluster="32x4",
                population=sched.population, generations=gens,
                batched_calls=gens + 1, makespan=ms,
                reference_makespan=want_ms,
                schedule_equal=workers == want_workers,
                wall_s=wall, wall_s_per_generation=wall / gens,
                wall_s_per_fitness_call=wall / (gens + 1),
                short_generations=short_generations, short_runs=short,
                waterfill_launches=launches,
                waterfill_launch_routes=routes, card=CARD)
    good = (ms == want_ms and workers == want_workers
            and all(r["reference_equal"] for r in short.values())
            and launches > 0)
    emit("genetic_vec", **line, ok=good)
    if not good:
        raise AssertionError("genetic_vec: the port's schedule differs from "
                             "the reference's")
    return launches, routes


# ------------------------------------------------------- LM kernels, serve
def _bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _close(got, want, atol, rtol):
    """(max abs error, every element within atol + rtol * |want|)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) \
        and bool(got.isfinite().all())
    return float(err.max()), ok


# name, B, Hq, Hkv, Sq, Skv, D, kv_len, window, causal, cache layout
ATTN_CASES = (
    ("prefill_w1024", 4, 25, 5, 1536, 1568, 64, 1536, 1024, True, True),
    ("prefill_w0", 4, 25, 5, 1536, 1568, 64, 1536, 0, True, True),
    ("decode_w1024", 4, 25, 5, 1, 1568, 64, 1552, 1024, True, True),
    ("decode_w0", 4, 25, 5, 1, 1568, 64, 1552, 0, True, True),
    # train_hymba's forward pass and remat recompute: batch 4 x 2048, the
    # projections transposed (the cache's layout), no kv_len
    ("train_w1024", 4, 25, 5, 2048, 2048, 64, None, 1024, True, True),
    ("train_w0", 4, 25, 5, 2048, 2048, 64, None, 0, True, True),
    ("gemma3_d256", 2, 4, 1, 512, 512, 256, 512, 256, True, False),
    ("mqa_d32", 2, 8, 1, 300, 300, 32, 300, 0, True, False),
    ("noncausal_d16", 2, 4, 2, 100, 100, 16, 100, 0, False, False),
    # head dims 128 (qwen3-32b-like: 64 query heads on 8 kv heads) and
    # 160 (stablelm-12b-like: 32 on 8), prefill and decode
    ("qwen3_d128_prefill", 2, 64, 8, 512, 512, 128, 512, 0, True, True),
    ("qwen3_d128_decode", 2, 64, 8, 1, 520, 128, 513, 0, True, True),
    ("stablelm_d160_prefill", 2, 32, 8, 512, 512, 160, 512, 0, True, True),
    ("stablelm_d160_decode", 2, 32, 8, 1, 520, 160, 513, 0, True, True),
    # the served families' own shapes (batch 4, prompt 1536, the KV
    # cache of a 16-token generation): chatglm3-6b (group 16), mixtral
    # (group 6, window 4096), musicgen (MHA at D 64), llama-3.2-vision's
    # cross-attention over 1600 vision tokens (non-causal) and its
    # 2048-token prompt (Sq > kv_len)
    ("chatglm3_g16_prefill", 4, 32, 2, 1536, 1552, 128, 1536, 0, True,
     True),
    ("chatglm3_g16_decode", 4, 32, 2, 1, 1552, 128, 1537, 0, True, True),
    ("mixtral_g6_prefill", 4, 48, 8, 1536, 1552, 128, 1536, 4096, True,
     True),
    ("mixtral_g6_decode", 4, 48, 8, 1, 1552, 128, 1537, 4096, True, True),
    ("musicgen_mha_prefill", 4, 32, 32, 1536, 1552, 64, 1536, 0, True,
     True),
    ("musicgen_mha_decode", 4, 32, 32, 1, 1552, 64, 1537, 0, True, True),
    ("cross_s1600_prefill", 4, 32, 8, 1536, 1600, 128, 1600, 0, False,
     True),
    ("cross_s1600_decode", 4, 32, 8, 1, 1600, 128, 1600, 0, False, True),
    ("cross_sq2048_s1600", 4, 32, 8, 2048, 1600, 128, 1600, 0, False,
     True),
    # the other served self-attention shapes: llama4-scout (group 5),
    # qwen3-32b (group 8) and stablelm-12b (D 160) at batch 4 x 1536 over
    # the 1552-position cache; the vision model's self layers (32/8) at
    # its 1536- and 2048-token prompts; mixtral's ring (batch 1): the
    # prompt that fills the 4096 positions, then a wrapped decode that
    # sees every slot (non-causal, window 4096)
    ("llama4_g5_prefill", 4, 40, 8, 1536, 1552, 128, 1536, 0, True, True),
    ("llama4_g5_decode", 4, 40, 8, 1, 1552, 128, 1537, 0, True, True),
    ("qwen3_g8_prefill", 4, 64, 8, 1536, 1552, 128, 1536, 0, True, True),
    ("qwen3_g8_decode", 4, 64, 8, 1, 1552, 128, 1537, 0, True, True),
    ("stablelm_d160_prefill_b4", 4, 32, 8, 1536, 1552, 160, 1536, 0, True,
     True),
    ("stablelm_d160_decode_b4", 4, 32, 8, 1, 1552, 160, 1537, 0, True,
     True),
    ("vision_self_prefill", 4, 32, 8, 1536, 1552, 128, 1536, 0, True,
     True),
    ("vision_self_decode", 4, 32, 8, 1, 1552, 128, 1537, 0, True, True),
    ("vision_self_sq2048_prefill", 4, 32, 8, 2048, 2064, 128, 2048, 0,
     True, True),
    ("vision_self_sq2048_decode", 4, 32, 8, 1, 2064, 128, 2049, 0, True,
     True),
    ("mixtral_ring_prefill", 1, 48, 8, 4096, 4096, 128, 4096, 4096, True,
     True),
    ("mixtral_ring_decode", 1, 48, 8, 1, 4096, 128, 4096, 4096, False,
     True),
    # the family training phases' forward pass and remat recompute, batch
    # 4 x 2048, no kv_len: musicgen (MHA, D 64), the vision model's self
    # layers (32/8; its cross layers are cross_sq2048_s1600's shape) and
    # mixtral (48/8, window 4096)
    ("musicgen_train", 4, 32, 32, 2048, 2048, 64, None, 0, True, True),
    ("vision_self_train", 4, 32, 8, 2048, 2048, 128, None, 0, True, True),
    ("mixtral_train_w4096", 4, 48, 8, 2048, 2048, 128, None, 4096, True,
     True),
    # the mesh phase's rank 0 of mixtral-8x22b on (16, 16): 3 of the 48
    # query heads and the KV head they read, the batch over 16; decode_32k
    # over the whole gathered 32768-position cache, and train_4k
    ("mixtral_rank0_decode", 8, 3, 1, 1, 32768, 128, 32768, 4096, True,
     True),
    ("mixtral_rank0_train", 16, 3, 1, 4096, 4096, 128, None, 4096, True,
     True),
)
ATTN_PATH = ("prefill_w1024", "prefill_w0", "decode_w1024", "decode_w0",
             "train_w1024", "train_w0")
# timed beside the path's cases: the head dims 128 and 160, the served
# families' shapes
ATTN_TIMED = ATTN_PATH + ("qwen3_d128_prefill", "qwen3_d128_decode",
                          "stablelm_d160_prefill", "stablelm_d160_decode",
                          "chatglm3_g16_prefill", "chatglm3_g16_decode",
                          "mixtral_g6_prefill", "mixtral_g6_decode",
                          "musicgen_mha_prefill", "musicgen_mha_decode",
                          "cross_s1600_prefill", "cross_s1600_decode",
                          "cross_sq2048_s1600", "llama4_g5_prefill",
                          "llama4_g5_decode", "qwen3_g8_prefill",
                          "qwen3_g8_decode", "stablelm_d160_prefill_b4",
                          "stablelm_d160_decode_b4", "vision_self_prefill",
                          "vision_self_decode", "vision_self_sq2048_prefill",
                          "vision_self_sq2048_decode",
                          "mixtral_ring_prefill", "mixtral_ring_decode",
                          "musicgen_train", "vision_self_train",
                          "mixtral_train_w4096", "mixtral_rank0_decode",
                          "mixtral_rank0_train")
# bfloat16 only: the edges of the tensor-core (Sq > 1) and split (Sq 1)
# routes
ATTN_EDGE_CASES = (
    # Sq, Skv, kv_len off the 64 tile; window ends inside a tile;
    # kv_len < Skv at prefill
    ("edge_sq1000_w100", 2, 8, 2, 1000, 1100, 64, 1030, 100, True, True),
    ("edge_d256_sq600_w100", 1, 8, 2, 600, 650, 256, 630, 100, True, True),
    ("edge_noncausal_w64", 2, 4, 1, 130, 200, 32, 190, 64, False, False),
    ("edge_decode_kv1", 4, 25, 5, 1, 1568, 64, 1, 0, True, True),
    ("edge_decode_1split", 4, 25, 5, 1, 1568, 64, 30, 0, True, True),
    ("edge_decode_7splits", 4, 25, 5, 1, 1568, 64, 200, 0, True, True),
    ("edge_decode_w100", 4, 25, 5, 1, 1568, 64, 1000, 100, True, True),
    ("edge_decode_d256_g12", 1, 12, 1, 1, 300, 256, 250, 0, True, True),
    ("edge_decode_d16", 2, 6, 2, 1, 300, 16, 299, 0, True, False),
    # D 160's swizzled row tail and its whole-warp decode lanes at the
    # edges; D 128 with a window ending inside a tile
    ("edge_d160_sq100_w40", 1, 4, 2, 100, 130, 160, 120, 40, True, True),
    ("edge_decode_d160_g12", 1, 12, 1, 1, 300, 160, 250, 0, True, True),
    ("edge_d128_sq300_w70", 1, 8, 2, 300, 320, 128, 310, 70, True, False),
    ("edge_decode_d128_w100", 2, 16, 2, 1, 700, 128, 650, 100, True, True),
)


def _attn_inputs(case, dtype, seed):
    import torch
    _, B, Hq, Hkv, Sq, Skv, D, _, _, _, cache_layout = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q = randn(B, Sq, Hq, D).transpose(1, 2)
    if cache_layout:     # the model's KV cache [B, S, Hkv, D], transposed
        k = randn(B, Skv, Hkv, D).transpose(1, 2)
        v = randn(B, Skv, Hkv, D).transpose(1, 2)
    else:
        k, v = randn(B, Hkv, Skv, D), randn(B, Hkv, Skv, D)
    return q, k, v


def _attn_work(case, itemsize):
    """(bytes, operations) this call needs: q read and o written once,
    each key and value that some query sees read once; 4 D operations
    per visible (query, key) pair."""
    from repro_torch.kernels.ref import attention_mask
    _, B, Hq, Hkv, Sq, Skv, D, kv_len, window, causal, _ = case
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          kv_len=kv_len, device="cuda")
    keys = int(mask.any(dim=0).sum())
    nbytes = (2 * B * Hq * Sq * D + 2 * B * Hkv * keys * D) * itemsize
    ops = 4 * D * int(mask.sum()) * B * Hq
    return nbytes, ops, mask


def cuda_graph_ms(fn, iters=20):
    """Device time of one call of ``fn``, from ``iters`` calls captured
    in a CUDA graph and replayed (no host cost per call)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check_split_kernels(case, seed, tol_bf16):
    """The split route's two kernels alone: the partials against
    ``ref.attention_partials`` (float32 sums over up to 128 keys in
    another order: atol/rtol 1e-4), the combine kernel against
    ``ref.combine_splits`` on the same partials (the bfloat16 limits)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    name, B, Hq, Hkv, Sq, Skv, D, kv_len, window, causal, _ = case
    q, k, v = _attn_inputs(case, torch.bfloat16, seed)
    plan, (o, m, l) = fa.split_partials(q, k, v, window=window,
                                        kv_len=kv_len)
    bounds = fa.split_bounds(*plan, kv_len)
    wo, wm, wl = ref.attention_partials(q, k, v, bounds, causal=causal,
                                        window=window, kv_len=kv_len)
    got = fa.combine_splits(o, m, l)
    want = ref.combine_splits(o[..., None, :], m[..., None], l[..., None],
                              torch.bfloat16)
    torch.cuda.synchronize()
    errs = [_close(x, y[..., 0, :] if y.dim() == 5 else y[..., 0],
                   1e-4, 1e-4) for x, y in ((o, wo), (m, wm), (l, wl))]
    c_err, c_ok = _close(got.float(), want.float(), *tol_bf16)
    row = dict(case=name, splits=plan[2], keys_per_split=plan[1],
               partials_max_abs=max(e for e, _ in errs),
               partials_ok=all(ok for _, ok in errs),
               combine_max_abs=c_err, combine_ok=c_ok)
    row["ok"] = row["partials_ok"] and c_ok
    return row


def phase_kernel_flash_attention(seed=0):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     route_for, split_plan)
    # (atol, rtol): float32 to rounding; bfloat16 about two units in the
    # last place of the output
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 8e-3)}
    checks, timings, split_checks = [], {}, []
    worst = 0.0
    runs = [(dtype, i, case) for dtype in (torch.float32, torch.bfloat16)
            for i, case in enumerate(ATTN_CASES)]
    runs += [(torch.bfloat16, len(ATTN_CASES) + i, case)
             for i, case in enumerate(ATTN_EDGE_CASES)]
    for dtype, i, case in runs:
        name, B, Hq, Hkv, Sq, Skv, D, kv_len, window, causal, _ = case
        q, k, v = _attn_inputs(case, dtype, seed + i)
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        got = flash_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = _close(got.float(), want.float(), *tol[dtype])
        worst = max(worst, err)
        checks.append(dict(case=name, dtype=str(dtype)[6:], max_abs=err,
                           atol=tol[dtype][0], rtol=tol[dtype][1],
                           route=route_for(dtype, Sq), ok=ok,
                           out_dtype=str(got.dtype)[6:]))
        if not ok or got.dtype != q.dtype:
            emit("kernel_flash_attention", card=CARD, checks=checks,
                 ok=False)
            raise AssertionError(f"flash attention kernel disagrees "
                                 f"with the plain version: {checks[-1]}")
        if dtype != torch.bfloat16:
            continue
        if Sq == 1:
            split_checks.append(_check_split_kernels(
                case, seed + i, tol[torch.bfloat16]))
            if not split_checks[-1]["ok"]:
                emit("kernel_flash_attention", card=CARD, checks=checks,
                     split_checks=split_checks, ok=False)
                raise AssertionError(f"split route kernels disagree with "
                                     f"their plain versions: "
                                     f"{split_checks[-1]}")
        if name not in ATTN_TIMED:
            continue
        nbytes, ops, mask = _attn_work(case, q.element_size())
        bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
        ke = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
        ve = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
        qc = q.contiguous()
        iters = 20 if Sq > 1 else 200
        k_ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw),
                            iters=iters)
        p_ms = cuda_time_ms(lambda: ref.attention_ref(q, k, v, **kw),
                            iters=max(iters // 10, 3), warmup=2)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qc, ke, ve, attn_mask=mask), iters=iters)
        lib_err = float((F.scaled_dot_product_attention(
            qc, ke, ve, attn_mask=mask).float() - want.float())
            .abs().max())
        row = dict(case=name, dtype="bfloat16", route=route_for(dtype, Sq),
                   head_dim=D,
                   timed="eager", ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   library_max_abs=lib_err, bytes=nbytes, ops=ops,
                   bound_ms=bound_ms, bound_by=bound_by)
        if Sq == 1:
            # one decode call is shorter on the card than on the host's
            # clock, so an eager loop times the host: ms and library_ms
            # are device times (CUDA graph) here, the eager times beside
            row.update(timed="cuda_graph", eager_ms=k_ms,
                       library_eager_ms=lib_ms,
                       splits=split_plan(kv_len, window, B, Hkv, Hq)[2],
                       ms=cuda_graph_ms(lambda: flash_attention(q, k, v,
                                                                **kw)),
                       library_ms=cuda_graph_ms(
                           lambda: F.scaled_dot_product_attention(
                               qc, ke, ve, attn_mask=mask)))
        row.update(frac_of_bound=bound_ms / row["ms"],
                   vs_library=row["library_ms"] / row["ms"])
        timings[name] = row
    emit("kernel_flash_attention", card=CARD, checks=checks,
         split_checks=split_checks, max_abs=worst,
         timing=list(timings.values()), ok=True)
    return dict(max_abs_err=worst, path=timings["prefill_w1024"],
                timing=timings)


def _ssd_inputs(Bt, L, H, P, N, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return (randn(Bt, L, H, P), 0.001 + 0.099 * rand(Bt, L, H),
            -(0.5 + 1.5 * rand(H)), randn(Bt, L, N), randn(Bt, L, N),
            randn(H))


def _ssd_work(Bt, L, H, P, N, Q=64):
    """(bytes, operations): every input read once, y and the final state
    written once; per (batch, head, chunk) the causal C Bᵀ and G (dt x)
    products, the inter-chunk term, the state update and the skip."""
    tri = Q * (Q + 1) // 2
    per_chunk = 2 * tri * N + 2 * tri * P + 2 * Q * N * P \
        + 2 * N * P * Q + 2 * N * P + 2 * Q * P
    ops = per_chunk * Bt * H * (L // Q)
    nbytes = 4 * (2 * Bt * L * H * P + Bt * L * H + 2 * H + 2 * Bt * L * N
                  + Bt * H * N * P)
    return nbytes, ops


# name, Bt, L, H, P, N, chunk, (A, dt) held constant or None; the first
# two are the models' prefill shapes, the third train_hymba's forward
# pass and remat recompute, and are timed
SSD_CASES = (
    ("hymba", 4, 1536, 50, 64, 16, 64, None),
    ("mamba2_130m", 4, 1536, 24, 64, 128, 64, None),
    ("hymba_train", 4, 2048, 50, 64, 16, 64, None),
    ("single_chunk", 2, 64, 6, 64, 16, 64, None),
    ("chunk32", 2, 256, 10, 64, 16, 32, None),
    ("n128_p32", 1, 128, 3, 32, 128, 64, None),
    # 53 heads: the last head group of both phases runs short
    ("ragged_group_h53", 4, 1536, 53, 64, 16, 64, None),
    ("p16", 2, 512, 12, 16, 16, 64, None),
    # exp(cum_i - cum_j) grows to e^50 above the diagonal: Γ's select
    ("strong_decay", 2, 256, 8, 64, 16, 64, (-8.0, 0.1)),
    # Q, P and N off a multiple of 4: padded tiles, 4-byte copies
    ("odd_q9_p10_n6", 2, 36, 3, 10, 6, 9, None),
    ("smoke_serve_l8", 2, 8, 4, 16, 8, 64, None),
)
SSD_TIMED = ("hymba", "mamba2_130m", "hymba_train")
# the single-kernel K3 that the three-phase design replaced, at Hymba's
# shape (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W)
SSD_EARLIER_MS = 0.8908240318298339


def _ssd_case_inputs(case, seed):
    import torch
    _, Bt, L, H, P, N, _, decay = case
    x, dt, A, B, C, D = _ssd_inputs(Bt, L, H, P, N, seed)
    if decay is not None:
        A, dt = torch.full_like(A, decay[0]), torch.full_like(dt, decay[1])
    return x, dt, A, B, C, D


def phase_kernel_ssd(seed=0):
    """Each of K3's three kernels alone against its plain piece, fed the
    plain piece's inputs, and the whole call against ``ssd_chunked`` and
    the sequential final state, all at atol/rtol 1e-4; times at the
    models' prefill shapes, each phase alone at Hymba's."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as sk
    out, worst, timings = [], 0.0, {}
    for i, case in enumerate(SSD_CASES):
        name, Bt, L, H, P, N, chunk, _ = case
        x, dt, A, B, C, D = _ssd_case_inputs(case, seed + i)
        S_ref, tot_ref = ref.ssd_chunk_states(x, dt, A, B, chunk=chunk)
        h_ref, fin_ref = ref.ssd_pass_states(S_ref, tot_ref)
        y_ref = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
        got = dict(S_loc=sk.chunk_states(x, dt, A, B, chunk=chunk))
        got["pass"] = sk.pass_states(S_ref, tot_ref)
        got["scan"] = sk.chunk_scan(x, dt, A, B, C, D, h_ref, chunk=chunk)
        got["ssd_scan"] = sk.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                                      return_state=True)
        torch.cuda.synchronize()
        pairs = dict(
            chunk_state_S=(got["S_loc"][0], S_ref),
            chunk_state_total=(got["S_loc"][1], tot_ref),
            state_pass_h_in=(got["pass"][0], h_ref),
            state_pass_final=(got["pass"][1], fin_ref),
            chunk_scan_y=(got["scan"], ref.ssd_chunk_scan(
                x, dt, A, B, C, D, h_ref, chunk=chunk)),
            y=(got["ssd_scan"][0], y_ref),
            state=(got["ssd_scan"][1], ref.ssd_final_state(x, dt, A, B)))
        errs = {k: _close(a, w, 1e-4, 1e-4) for k, (a, w) in pairs.items()}
        row = dict(case=name, Bt=Bt, L=L, H=H, P=P, N=N,
                   Q=min(chunk, L), max_abs={k: e for k, (e, _) in
                                             errs.items()},
                   ok=all(ok for _, ok in errs.values()))
        worst = max([worst] + [e for e, _ in errs.values()])
        out.append(row)
        if not row["ok"]:
            emit("kernel_ssd", card=CARD, rows=out, ok=False)
            raise AssertionError(f"ssd kernels disagree with their plain "
                                 f"versions: {row}")
        if name not in SSD_TIMED:
            continue
        Q = min(chunk, L)
        nbytes, ops = _ssd_work(Bt, L, H, P, N, Q)
        bound_ms, bound_by = _bound(nbytes, ops, F32_OPS_PER_S)
        k_ms = cuda_time_ms(lambda: sk.ssd_scan(x, dt, A, B, C, D,
                                                return_state=True), iters=20)
        p_ms = cuda_time_ms(lambda: ref.ssd_chunked(x, dt, A, B, C, D),
                            iters=3, warmup=1)
        # each phase alone, on the call's own scratch (the pass rewrites
        # its buffer in place on every launch; its time does not depend
        # on the values)
        S, tot = got["S_loc"]
        h_in = S.clone()
        state = torch.empty_like(got["ssd_scan"][1])
        phase_ms = dict(
            chunk_state=cuda_time_ms(
                lambda: sk._chunk_states(x, dt, A, B, Q), iters=20),
            state_pass=cuda_time_ms(
                lambda: sk._pass_states(h_in, tot, state), iters=20),
            chunk_scan=cuda_time_ms(
                lambda: sk._chunk_scan(x, dt, A, B, C, D, S, Q), iters=20))
        row.update(ms=k_ms, phase_ms=phase_ms, earlier_ms=(
            SSD_EARLIER_MS if name == "hymba" else None), plain_ms=p_ms,
            library_ms=None, bytes=nbytes, ops=ops, bound_ms=bound_ms,
            bound_by=bound_by, frac_of_bound=bound_ms / k_ms)
        timings[name] = row
    emit("kernel_ssd", card=CARD, rows=out, max_abs=worst, ok=True)
    return dict(max_abs_err=worst, path=timings["hymba"])


def _device_profile(fn):
    """Wall time, device busy time and idle share of one call of ``fn``,
    and the device time of K1 and of the top kernels, from the raw device
    events of ``torch.profiler`` with CUDA activity only: a survey run
    makes some 500,000 device events, whose summary by ``key_averages``
    takes minutes, and recording no host ops slows the host less (the
    idle share is still an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, events = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            events += 1
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    if not events:
        raise AssertionError("the profiled run recorded no device event")
    busy_ms = sum(by_name.values()) / 1e6
    # K1: both kernels of csrc/waterfill.cu are named waterfill_*
    k1_ms = sum(v for k, v in by_name.items() if "waterfill_" in k) / 1e6
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms,
                device_events=events, k1_device_ms=k1_ms,
                k1_share=k1_ms / busy_ms,
                top_device=[(k[:70], v / 1e6) for k, v in top])


def _profile(fn, ranges=()):
    """Wall time, device busy time and the top device kernels and host
    ops of one call of ``fn`` under ``torch.profiler`` (the profiler
    slows the host, so the idle share is an upper bound).  ``ranges``:
    names of ``record_function`` ranges whose device time (the kernels
    launched inside them) is reported under ``range_device_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    # device-side events only (kernels, copies): a host op's device time
    # repeats the time of the kernels it launched; a range's span on the
    # device timeline is not work
    on_dev = [e for e in avg if e.device_type == DeviceType.CUDA
              and e.key not in ranges]
    on_host = [e for e in avg if e.device_type == DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    # K2: every kernel of csrc/flash_attention.cu is named flash_*
    k2_ms = sum(e.self_device_time_total for e in on_dev
                if "flash_" in e.key) / 1e3
    # K3: every kernel of csrc/ssd.cu is named ssd_*
    k3_ms = sum(e.self_device_time_total for e in on_dev
                if e.key.startswith("ssd_") or "::ssd_" in e.key) / 1e3
    top_dev = sorted(on_dev, key=lambda e: e.self_device_time_total,
                     reverse=True)[:10]
    top_host = sorted(on_host, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:10]
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / (wall * 1e3),
               device_events=sum(e.count for e in on_dev),
               k2_device_ms=k2_ms, k2_share=k2_ms / busy_ms,
               k3_device_ms=k3_ms, k3_share=k3_ms / busy_ms,
               top_device=[(e.key[:70], e.self_device_time_total / 1e3,
                            e.count) for e in top_dev],
               top_host=[(e.key[:70], e.self_cpu_time_total / 1e3,
                          e.count) for e in top_host])
    if ranges:
        ms = {r: sum(e.device_time_total for e in on_host if e.key == r)
              / 1e3 for r in ranges}
        out.update(range_device_ms=ms,
                   range_share={r: v / busy_ms for r, v in ms.items()})
    return out


def _profile_serve(model, prompts, forced, cache_len):
    """Profiles of one prefill and of two decode steps (bf16 model)."""
    from repro_torch.models import decode_step, prefill
    state = {}

    def run_prefill():
        state["out"] = prefill(model, prompts, cache_len=cache_len)

    def run_decode():
        _, cache, pos = state["out"]
        for i in range(forced.shape[1]):
            _, cache, pos = decode_step(model, forced[:, i:i + 1], cache,
                                        pos)

    return dict(prefill=_profile(run_prefill),
                decode_steps=forced.shape[1], decode=_profile(run_decode))


def phase_serve_hymba(seed=0, gen=32, prompt_len=1536, forced=4):
    import gc

    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels import SSD_LAUNCHES as SS
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_params, prefill
    dev = torch.device("cuda")
    argv = ["--arch", "hymba-1.5b", "--batch", "4", "--prompt-len",
            str(prompt_len), "--gen", str(gen), "--seed", str(seed)]
    # the main path's own counts: zeroed just before, read just after
    FA.reset()
    SS.reset()
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(flash_attention=FA.count, ssd=SS.count)
    routes = dict(FA.routes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = res["cfg"]
    del res["model"]
    # a second, warm run of the same entry point (the first one pays for
    # first-use set-up: library handles, module loading), then a profile
    warm = serve.main(argv)
    profile = _profile_serve(warm["model"], warm["prompts"],
                             warm["tokens"][:, :2], prompt_len + gen)
    warm = dict({k: warm[k] for k in ("prefill_ms", "decode_ms_per_token",
                                      "tokens_per_s")},
                same_tokens=bool(torch.equal(warm["tokens"], res["tokens"])))
    gc.collect()
    torch.cuda.empty_cache()
    want = dict(flash_attention=cfg.n_layers * (gen + 1), ssd=cfg.n_layers)
    # bf16: the tensor-core route at prefill, the split route at decode
    want_routes = dict(tc=cfg.n_layers, split=cfg.n_layers * gen, f32=0)
    tokens, prompts = res["tokens"], res["prompts"]
    bf16 = dict(dtype=cfg.dtype, batch=4, prompt=prompt_len, gen=gen,
                params=cfg.param_count(),
                prefill_ms=res["prefill_ms"],
                decode_ms_per_token=res["decode_ms_per_token"],
                tokens_per_s=res["tokens_per_s"], warm_run=warm,
                profile=profile, peak_mem_gb=peak_gb,
                launches=launches, launches_expected=want,
                launch_routes=routes, launch_routes_expected=want_routes,
                tokens_in_vocab=bool((tokens >= 0).all()
                                     and (tokens < cfg.vocab_size).all()),
                first_tokens=tokens[0, :8].tolist())
    del res
    gc.collect()
    torch.cuda.empty_cache()
    if launches != want or routes != want_routes \
            or not bf16["tokens_in_vocab"] or tokens.shape != (4, gen):
        emit("serve_hymba", card=CARD, bf16=bf16, ok=False)
        raise AssertionError(f"serve_hymba: bf16 run wrong: {bf16}")

    # float32: the same prompt, kernels vs plain versions on the card
    cfg32 = dataclasses.replace(cfg, dtype="float32", max_cache_len=0)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg32, g, device=dev)
    teacher = tokens[:, :forced]
    runs = {}
    for impl in ("auto", "torch"):
        FA.reset()
        SS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = prefill(model, prompts,
                                     cache_len=prompt_len + forced, impl=impl)
        outs = [logits]
        for i in range(forced):
            logits, cache, pos = decode_step(model, teacher[:, i:i + 1],
                                             cache, pos, impl=impl)
            outs.append(logits)
        torch.cuda.synchronize()
        runs[impl] = dict(logits=outs, wall_s=time.perf_counter() - t0,
                          launches=dict(flash_attention=FA.count,
                                        ssd=SS.count),
                          routes=dict(FA.routes))
        del cache
    steps = []
    ok = True
    for i, (a, b) in enumerate(zip(runs["auto"]["logits"],
                                   runs["torch"]["logits"])):
        err, close = _close(a, b, 1e-3, 1e-3)
        same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
        steps.append(dict(step=i, max_abs=err, close=close,
                          greedy_equal=same,
                          logit_absmax=float(b.abs().max())))
        ok = ok and close and same
    f32 = dict(dtype="float32", forced_steps=forced,
               kernel_wall_s=runs["auto"]["wall_s"],
               plain_wall_s=runs["torch"]["wall_s"],
               kernel_launches=runs["auto"]["launches"],
               plain_launches=runs["torch"]["launches"],
               kernel_launch_routes=runs["auto"]["routes"], steps=steps)
    ok = ok and runs["torch"]["launches"] == dict(flash_attention=0, ssd=0) \
        and runs["auto"]["launches"] == dict(
            flash_attention=cfg32.n_layers * (forced + 1),
            ssd=cfg32.n_layers) \
        and runs["auto"]["routes"] == dict(
            tc=0, split=0, f32=cfg32.n_layers * (forced + 1))
    emit("serve_hymba", card=CARD, bf16=bf16, f32=f32, ok=ok)
    if not ok:
        raise AssertionError("serve_hymba: the kernel path disagrees with "
                             "the plain path in float32")
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, routes


# ------------------------------------------------------------ train
# the record_function ranges of the kernels' plain backwards
# (repro_torch.kernels._grad.plain_backward)
PLAIN_BACKWARDS = ("flash_attention_backward_plain",
                   "ssd_scan_backward_plain")


class _GradRecorder:
    """An optimizer for ``make_train_step`` that keeps the gradients and
    leaves the parameters as they are."""

    def update(self, grads, state, model):
        self.grads = grads
        return state


def _grad_errors(got, want):
    """Each parameter's relative L2 error of ``got`` from ``want``, and
    the worst by parameter leaf name."""
    errs = {n: float((a - want[n]).norm()
                     / want[n].norm().clamp_min(1e-30))
            for n, a in got.items()}
    by_leaf = {}
    for n, e in errs.items():
        leaf = n.rsplit(".", 1)[-1]
        by_leaf[leaf] = max(e, by_leaf.get(leaf, 0.0))
    return errs, by_leaf


def _train_grad_check(seed, layers=4, batch=2, seq=2048):
    """Hymba-1.5B at full width in float32, cut to ``layers`` layers:
    one ``make_train_step`` through the kernels and one through the plain
    versions from the same parameters; loss within rtol 1e-5, each
    parameter's gradient within a relative L2 error of 1e-4, K2 (``f32``)
    and K3 each launched twice a layer (forward and remat recompute)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels import SSD_LAUNCHES as SS
    from repro_torch.models import init_params, make_train_step
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("hymba-1.5b"), dtype="float32",
                              n_layers=layers)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg, g, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device=dev)
    runs = {}
    for impl in ("auto", "torch"):
        FA.reset()
        SS.reset()
        rec = _GradRecorder()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = make_train_step(cfg, rec, impl=impl)(model, None,
                                                       {"tokens": tokens})
        loss = float(metrics["loss"])
        runs[impl] = dict(loss=loss, grads=rec.grads,
                          wall_s=time.perf_counter() - t0,
                          launches=dict(flash_attention=FA.count,
                                        ssd=SS.count),
                          routes=dict(FA.routes))
    errs, by_leaf = _grad_errors(runs["auto"]["grads"],
                                 runs["torch"]["grads"])
    worst = max(errs, key=errs.get)
    la, lt = runs["auto"]["loss"], runs["torch"]["loss"]
    want = dict(flash_attention=2 * layers, ssd=2 * layers)
    line = dict(layers=layers, windows=list(cfg.window_pattern()),
                batch=batch, seq=seq, dtype="float32", remat=cfg.remat,
                loss_kernel=la, loss_plain=lt,
                loss_rel_err=abs(la - lt) / abs(lt),
                grad_rel_l2_worst=errs[worst], grad_worst_param=worst,
                grad_rel_l2_by_param=by_leaf,
                kernel_wall_s=runs["auto"]["wall_s"],
                plain_wall_s=runs["torch"]["wall_s"],
                kernel_launches=runs["auto"]["launches"],
                kernel_launch_routes=runs["auto"]["routes"],
                plain_launches=runs["torch"]["launches"])
    ok = (line["loss_rel_err"] <= 1e-5 and errs[worst] <= 1e-4
          and all(math.isfinite(v) for v in errs.values())
          and runs["auto"]["launches"] == want
          and runs["auto"]["routes"] == dict(tc=0, split=0, f32=2 * layers)
          and runs["torch"]["launches"] == dict(flash_attention=0, ssd=0))
    return line, ok


def _plain_backward_bounds(cfg, batch, seq):
    """Bounds (ms per step, bound_by) of the work the two plain backwards
    stand in for, summed over the layers.  Attention: 10 D operations
    per visible (query, key) pair (the scores recomputed, then dV, dP, dQ
    and dK, as a flash-attention backward does) at the bf16 rate; q, o,
    dO read and dq written, k, v read and dk, dv written, in bf16.  The
    SSD scan: twice the forward's operations (each product's gradient is
    two products) and bytes (dy read, a gradient written per input), at
    the float32 rate."""
    from repro_torch.kernels.ref import attention_mask
    D, Hq, Hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    ops = nbytes = 0
    for w in cfg.window_pattern():
        pairs = int(attention_mask(seq, seq, window=w, device="cuda").sum())
        ops += 10 * D * pairs * batch * Hq
        nbytes += 2 * (4 * batch * Hq * seq * D + 4 * batch * Hkv * seq * D)
    b, o = _ssd_work(batch, seq, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state)
    return {"flash_attention_backward_plain": _bound(nbytes, ops,
                                                     BF16_OPS_PER_S),
            "ssd_scan_backward_plain": _bound(2 * b * cfg.n_layers,
                                              2 * o * cfg.n_layers,
                                              F32_OPS_PER_S)}


def phase_train_hymba(seed=0, batch=4, seq=2048):
    """``repro_torch.launch.train`` on full Hymba-1.5B (bf16, remat full):
    3 steps at accum 1 with a checkpoint at the end, one more warm step
    under the profiler, then a restart that resumes at step 3 and runs 2
    steps at accum 2.  Before it, the float32 gradient check
    (``_train_grad_check``)."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels import SSD_LAUNCHES as SS
    from repro_torch.launch import train

    grad, grad_ok = _train_grad_check(seed)
    gc.collect()
    torch.cuda.empty_cache()
    if not grad_ok:
        emit("train_hymba", card=CARD, grad_check=grad, ok=False)
        raise AssertionError(f"train_hymba: the kernel path's gradients "
                             f"disagree with the plain path's: {grad}")

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_hymba_ckpt.",
                            dir=os.path.join(HERE, "build"))
    base = ["--arch", "hymba-1.5b", "--batch", str(batch), "--seq",
            str(seq), "--ckpt-dir", ckpt, "--ckpt-every", "100", "--seed",
            str(seed), "--log-every", "1"]
    runs, launches, routes = [], {}, None
    try:
        # (steps, accum, the step it starts from)
        for steps, accum, want_start in ((3, 1, 0), (5, 2, 3)):
            argv = ["--steps", str(steps), "--accum", str(accum)]
            n_steps = steps - want_start
            micro = n_steps * accum
            # the main path's own counts: zeroed just before, read after
            FA.reset()
            SS.reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = train.run(base + argv)
            wall = time.perf_counter() - t0
            got = dict(flash_attention=FA.count, ssd=SS.count)
            got_routes = dict(FA.routes)
            cfg = res["cfg"]
            n = cfg.param_count()
            tokens = batch * seq
            run = dict(argv=argv, start_step=res["start_step"],
                       losses=res["losses"], step_ms=res["step_ms"],
                       first_ms=res["step_ms"][0] if res["step_ms"]
                       else None, warm_ms=res["warm_ms"],
                       tokens_per_s=res["tokens_per_s"],
                       model_tflops=6 * n * tokens / res["warm_ms"] / 1e9,
                       model_tflops_with_recompute=8 * n * tokens
                       / res["warm_ms"] / 1e9,
                       run_wall_s=wall,
                       outside_steps_s=wall - sum(res["step_ms"]) / 1e3,
                       ckpt_restore_s=res["ckpt_s"]["restore"],
                       ckpt_save_s=res["ckpt_s"]["save"],
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches=got, launch_routes=got_routes,
                       per_microbatch=dict(
                           flash_attention=got["flash_attention"] / micro,
                           ssd=got["ssd"] / micro))
            want = dict(flash_attention=2 * cfg.n_layers * micro,
                        ssd=2 * cfg.n_layers * micro)
            good = (res["start_step"] == want_start
                    and len(res["losses"]) == n_steps
                    and all(math.isfinite(v) for v in res["losses"])
                    and got == want
                    and got_routes == dict(tc=want["flash_attention"],
                                           split=0, f32=0)
                    and cfg.remat == "full" and cfg.dtype == "bfloat16")
            if want_start == 0:
                # one more warm step of the same trainer (accum 1), after
                # its checkpoint and outside the counted run
                prof = _profile(
                    lambda r=res: r["step_fn"](r["model"], r["opt_state"],
                                               r["make_batch"](3)),
                    ranges=PLAIN_BACKWARDS)
                bounds = _plain_backward_bounds(cfg, batch, seq)
                prof["plain_backwards"] = {
                    r: dict(device_ms=prof["range_device_ms"][r],
                            calls=cfg.n_layers,
                            ms_per_call=prof["range_device_ms"][r]
                            / cfg.n_layers, bound_ms=bounds[r][0],
                            bound_by=bounds[r][1])
                    for r in PLAIN_BACKWARDS}
                run.update(profile=prof, params=n)
            runs.append(run)
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            routes = got_routes if routes is None else {
                r: routes[r] + got_routes[r] for r in routes}
            del res
            gc.collect()
            torch.cuda.empty_cache()
            if not good:
                emit("train_hymba", card=CARD, grad_check=grad, runs=runs,
                     ok=False)
                raise AssertionError(f"train_hymba: run {argv} wrong: "
                                     f"{run}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit("train_hymba", card=CARD, grad_check=grad, runs=runs, ok=True)
    return launches, routes


# ------------------------------------------------------- serve families
# the families that phases 17-20 serve, each at full width (the MoE
# models cut in depth: one card holds no 281 or 204 GB model)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1536, 16
# the float32 kernels-vs-plain check: depth 2 (the vision model one group
# of 5), batch 2, prompt 512, 4 teacher-forced decode steps; logits
# within 1e-3 as serve_hymba's, greedy tokens equal
CHECK_LAYERS, CHECK_BATCH, CHECK_PROMPT, CHECK_STEPS = 2, 2, 512, 4
MOE_LAYERS = 8
RING_STEPS = 32
VISION_LONG_PROMPT = 2048
GATE = 0.5


def _free():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _teacher_forced(model, prompts, teacher, vision=None, impl="auto",
                    cache_len=None):
    """Prefill ``prompts``, then decode the ``teacher`` tokens one by one:
    the logits of each step (prefill's last position first)."""
    from repro_torch.models import decode_step, prefill
    S, n = prompts.shape[1], teacher.shape[1]
    logits, cache, pos = prefill(model, prompts, impl=impl, vision=vision,
                                 cache_len=cache_len or S + n)
    # a copy: the last position's view would keep all S positions' logits
    outs = [logits.clone()]
    for i in range(n):
        logits, cache, pos = decode_step(model, teacher[:, i:i + 1], cache,
                                         pos, impl=impl)
        outs.append(logits)
    return outs


def _serve_model(cfg, seed=0):
    """``launch.serve.serve`` of ``cfg`` through the kernels (cold: the
    first call on a new model), then a warm ``generate`` of the same
    prompts on the same weights.  The main path's K2 counts are zeroed
    just before the cold run and read just after it.  Returns (row,
    result of the cold run, K2 launches, K2 routes)."""
    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.launch import serve
    _free()
    torch.cuda.reset_peak_memory_stats()
    batch, prompt, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    FA.reset()
    t0 = time.perf_counter()
    res = serve.serve(cfg, batch=batch, prompt_len=prompt, gen=gen,
                      device="cuda", seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = FA.count, dict(FA.routes)
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = serve.generate(res["model"], res["prompts"], gen, res["vision"])
    tokens = res["tokens"]
    cfg = res["cfg"]
    row = dict(arch=cfg.name, layers=cfg.n_layers,
               cross_layers=(cfg.n_layers // cfg.cross_attn_every
                             if cfg.cross_attn_every else 0),
               params=cfg.param_count(),
               params_gb_bf16=cfg.param_count() * 2 / 1e9,
               # what the model as built holds (``param_count`` is the
               # config's own estimate)
               params_built_gb_bf16=sum(
                   p.numel() for p in res["model"].parameters()) * 2 / 1e9,
               dtype=cfg.dtype, kv_cache_dtype=cfg.kv_cache_dtype,
               moe_dispatch=cfg.moe_dispatch if cfg.moe_experts else None,
               batch=batch, prompt=prompt, gen=gen,
               prefill_ms=dict(cold=res["prefill_ms"],
                               warm=warm["prefill_ms"]),
               decode_ms_per_step=dict(cold=res["decode_ms_per_token"],
                                       warm=warm["decode_ms_per_token"]),
               tokens_per_s=dict(cold=res["tokens_per_s"],
                                 warm=warm["tokens_per_s"]),
               cold_wall_s=wall, peak_mem_gb=peak,
               k2_launches=launches, k2_routes=routes,
               # every attention layer (self and cross) once at prefill
               # and once a decode step
               k2_routes_expected=dict(tc=cfg.n_layers,
                                       split=cfg.n_layers * gen, f32=0),
               warm_same_tokens=bool(torch.equal(warm["tokens"], tokens)),
               tokens_shape=list(tokens.shape),
               tokens_in_vocab=bool((tokens >= 0).all()
                                    and (tokens < cfg.vocab_size).all()),
               first_tokens=tokens[0, :6].tolist())
    row["ok"] = (routes == row["k2_routes_expected"]
                 and launches == cfg.n_layers * (gen + 1)
                 and row["tokens_in_vocab"] and row["warm_same_tokens"]
                 and tokens.shape[:2] == (batch, gen))
    return row, res, launches, routes


def _f32_check(cfg, seed=0, gate=None, model_cfgs=None):
    """``cfg`` in float32 cut to ``CHECK_LAYERS`` layers (``cfg``'s own
    depth when it is already cut), prefill and ``CHECK_STEPS``
    teacher-forced decode steps through the kernels and through the
    plain versions on the card: logits within atol/rtol 1e-3 and equal
    greedy tokens, K2 on the ``f32`` route only.  ``gate``: every cross
    layer's gate; ``model_cfgs``: configs (of the same weights) to check
    in turn, default ``cfg`` alone."""
    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    _free()
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg, g, device=dev)
    if gate is not None:
        for layer in model.cross_layers:
            layer.attn["gate"].data.fill_(gate)
    toks, vision = serve.make_inputs(cfg, CHECK_BATCH,
                                     CHECK_PROMPT + CHECK_STEPS, g, dev)
    prompts, teacher = toks[:, :CHECK_PROMPT], toks[:, CHECK_PROMPT:]
    rows, ok = [], True
    for mcfg in model_cfgs or [cfg]:
        model.cfg = mcfg
        runs = {}
        for impl in ("auto", "torch"):
            FA.reset()
            runs[impl] = (_teacher_forced(model, prompts, teacher, vision,
                                          impl=impl), FA.count,
                          dict(FA.routes))
        steps = []
        for i, (a, b) in enumerate(zip(runs["auto"][0], runs["torch"][0])):
            err, close = _close(a, b, 1e-3, 1e-3)
            steps.append(dict(step=i, max_abs=err, close=close,
                              greedy_equal=bool(torch.equal(
                                  a.argmax(-1), b.argmax(-1))),
                              logit_absmax=float(b.abs().max())))
        n = mcfg.n_layers * (CHECK_STEPS + 1)
        good = (all(s["close"] and s["greedy_equal"] for s in steps)
                and runs["auto"][1:] == (n, dict(tc=0, split=0, f32=n))
                and runs["torch"][1] == 0)
        rows.append(dict(layers=mcfg.n_layers, batch=CHECK_BATCH,
                         prompt=CHECK_PROMPT, steps=CHECK_STEPS,
                         moe_dispatch=(mcfg.moe_dispatch
                                       if mcfg.moe_experts else None),
                         gate=gate, kernel_launch_routes=runs["auto"][2],
                         max_abs=max(s["max_abs"] for s in steps),
                         worst_step=max(steps, key=lambda s: s["max_abs"]),
                         ok=good))
        ok = ok and good
    return rows, ok, model


def _family_phase(phase, runs, checks):
    """Serve each config of ``runs`` (bf16, through the kernels) with its
    extra checks, then each float32 check of ``checks``; prints one line
    for the phase and fails it on any check.  ``runs``: (cfg, extra)
    where ``extra(row, res)`` adds fields to the row and returns whether
    they pass; ``checks``: (name, thunk returning (rows, ok, model)).
    Returns the main path's K2 launches and routes."""
    import torch
    t0 = time.perf_counter()
    rows, f32, launches, routes, ok = [], {}, 0, None, True
    try:
        for cfg, extra in runs:
            row, res, n, rt = _serve_model(cfg)
            launches += n
            routes = rt if routes is None else {
                r: routes[r] + rt[r] for r in routes}
            if extra is not None:
                row["ok"] = extra(row, res) and row["ok"]
            rows.append(row)
            ok = ok and row["ok"]
            del res
            _free()
            if not ok:
                break
        for name, thunk in checks if ok else ():
            got, good, model = thunk()
            f32[name] = got
            ok = ok and good
            del model
            _free()
    except Exception:
        emit(phase, card=CARD, models=rows, f32=f32, ok=False,
             wall_s=time.perf_counter() - t0)
        raise
    emit(phase, card=CARD, models=rows, f32=f32, ok=ok,
         wall_s=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"{phase}: a check failed (see its line)")
    torch.cuda.synchronize()
    return launches, routes


def _cut(cfg, layers):
    return dataclasses.replace(cfg, n_layers=layers)


def _max_diff(a, b):
    """The largest difference between two lists of step logits."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def _int8_error(model, cfg, prompts, teacher):
    """The largest logit difference of the int8 KV cache from the
    activation-type cache on the same weights, teacher-forced, and the
    logits' scale."""
    model.cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    int8 = _teacher_forced(model, prompts, teacher)
    model.cfg = dataclasses.replace(cfg, kv_cache_dtype="none")
    full = _teacher_forced(model, prompts, teacher)
    model.cfg = cfg
    return _max_diff(int8, full), max(float(f.float().abs().max())
                                      for f in full)


def _int8_check(row, res):
    """The int8 KV cache on the same weights: a timed greedy serve of the
    same prompts (K2 routes as the bf16 cache's, tokens in the
    vocabulary).  Then, on the first ``CHECK_BATCH`` prompts
    teacher-forced on the bf16 serve's tokens, how far the int8 cache's
    logits are from the bf16 cache's, through the kernels and through
    the plain versions (``impl="torch"``).  Held: the kernel path's gap
    is at most the plain path's plus the kernels' own distance from the
    plain path with the bf16 cache (what K2's rounding alone moves the
    logits at this depth).  The reference's bound is held at its own
    depth and type in ``_qwen3_f32``."""
    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.launch import serve
    model, cfg = res["model"], res["cfg"]
    model.cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    FA.reset()
    torch.cuda.reset_peak_memory_stats()
    run = serve.generate(model, res["prompts"], SERVE_GEN, res["vision"])
    routes = dict(FA.routes)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prompts = res["prompts"][:CHECK_BATCH]
    teacher = res["tokens"][:CHECK_BATCH, :CHECK_STEPS]
    logits = {}
    for impl in ("auto", "torch"):
        for kv in ("int8", "none"):
            model.cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
            logits[impl, kv] = _teacher_forced(model, prompts, teacher,
                                               impl=impl)
    model.cfg = cfg
    gap = {impl: _max_diff(logits[impl, "int8"], logits[impl, "none"])
           for impl in ("auto", "torch")}
    margin = _max_diff(logits["auto", "none"], logits["torch", "none"])
    toks = run["tokens"]
    row["int8"] = dict(
        prefill_ms=run["prefill_ms"],
        decode_ms_per_step=run["decode_ms_per_token"],
        tokens_per_s=run["tokens_per_s"], peak_mem_gb=peak,
        k2_routes=routes,
        greedy_agree=float((toks == res["tokens"]).float().mean()),
        tokens_in_vocab=bool((toks >= 0).all()
                             and (toks < cfg.vocab_size).all()),
        witness=dict(batch=CHECK_BATCH, steps=CHECK_STEPS,
                     kernel_gap=gap["auto"], plain_gap=gap["torch"],
                     kernel_vs_plain_bf16_cache=margin,
                     logit_scale=max(float(f.float().abs().max())
                                     for f in logits["torch", "none"]),
                     within=gap["auto"] <= gap["torch"] + margin))
    return (routes == row["k2_routes_expected"]
            and row["int8"]["tokens_in_vocab"]
            and row["int8"]["witness"]["within"])


def _qwen3_f32():
    """The float32 check of qwen3-32b with the activation-type and the
    int8 KV cache (kernels vs plain), then the int8 cache's logits
    against the float32 cache's through the kernels at the depth and
    type of the reference's own check (2 layers, float32;
    ``tests/test_models.py``): within 0.05 x the logits' scale."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = _cut(get_config("qwen3-32b", dtype="float32"), CHECK_LAYERS)
    rows, ok, model = _f32_check(cfg, model_cfgs=[
        cfg, dataclasses.replace(cfg, kv_cache_dtype="int8")])
    g = torch.Generator(device="cuda").manual_seed(4)
    toks, _ = serve.make_inputs(cfg, CHECK_BATCH,
                                CHECK_PROMPT + CHECK_STEPS, g,
                                torch.device("cuda"))
    err, scale = _int8_error(model, cfg, toks[:, :CHECK_PROMPT],
                             toks[:, CHECK_PROMPT:])
    int8 = dict(max_abs_vs_f32_cache=err, logit_scale=scale,
                bound=0.05 * max(scale, 1.0))
    rows.append(dict(int8_f32=int8))
    return rows, ok and err < int8["bound"], model


def _ring_inputs(cfg, g):
    """Batch 1: a prompt that fills the window (4096 tokens for
    mixtral) and ``RING_STEPS`` decode tokens that wrap the ring."""
    import torch
    from repro_torch.launch import serve
    toks, _ = serve.make_inputs(cfg, 1, cfg.window + RING_STEPS, g,
                                torch.device("cuda"))
    return toks[:, :cfg.window], toks[:, cfg.window:]


def _ring_compare(model, cfg, g, atol, rtol, bound):
    """Each teacher-forced step's logits of the ring cache against a
    full-length cache's (``_ring_inputs``)."""
    import torch
    prompts, teacher = _ring_inputs(cfg, g)
    model.cfg = dataclasses.replace(cfg, window_ring_cache=True)
    ring = _teacher_forced(model, prompts, teacher, cache_len=cfg.window)
    model.cfg = cfg
    full = _teacher_forced(model, prompts, teacher)
    scale = max(float(f.float().abs().max()) for f in full)
    errs = [_close(a.float(), b.float(), atol, rtol)
            for a, b in zip(ring, full)]
    agree = [bool(torch.equal(a.argmax(-1), b.argmax(-1)))
             for a, b in zip(ring, full)]
    worst = max(e for e, _ in errs)
    return dict(batch=1, prompt=cfg.window, steps=RING_STEPS,
                cache=cfg.window, max_abs=worst,
                step_max_abs=[e for e, _ in errs], logit_scale=scale,
                atol=atol, rtol=rtol, greedy_equal_steps=sum(agree),
                within=all(c for _, c in errs)
                and worst < bound * max(scale, 1.0),
                all_greedy_equal=all(agree))


@contextlib.contextmanager
def _routes(pin=None):
    """The MoE router's choices (``layers._route``) in call order: the
    yielded list receives each call's experts.  With ``pin`` (such a
    list), each call takes the next pinned experts instead of its own
    top k, gated by the softmax of its own logits at them."""
    import torch
    from repro_torch.models import layers
    own, log, it = layers._route, [], iter(pin or ())

    def route(x, router, k):
        if pin is None:
            gates, idx = own(x, router, k)
        else:
            idx = next(it)
            logits = layers.mm(x.float(), router.float())
            gates = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
        log.append(idx)
        return gates, idx

    layers._route = route
    try:
        yield log
    finally:
        layers._route = own


def _ring_check(row, res):
    """The ring cache on the bf16 mixtral weights against the
    full-length cache (``_ring_inputs``), with the router's choices
    logged: the served ring (its own choices), then the ring with every
    router call pinned to the full-length run's choices, through the
    kernels and through the plain versions (pinned to the same).  Held:
    (1) pinned, the kernel path's largest gap is at most the plain
    path's plus the kernels' own distance from the plain path on the
    full-length cache; (2) every served step further off than the
    pinned kernel gap plus that distance shows a router choice that
    differs from the full-length run's at that step."""
    import torch
    model, cfg = res["model"], res["cfg"]
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts, teacher = _ring_inputs(cfg, g)
    ring_cfg = dataclasses.replace(cfg, window_ring_cache=True)

    def run(impl, ring, pin=None):
        model.cfg = ring_cfg if ring else cfg
        with _routes(pin) as log:
            out = _teacher_forced(model, prompts, teacher, impl=impl,
                                  cache_len=cfg.window if ring else None)
        model.cfg = cfg
        return out, log

    full, chosen = run("auto", False)
    served, served_chosen = run("auto", True)
    pinned, _ = run("auto", True, chosen)
    plain_full, _ = run("torch", False, chosen)
    plain_ring, _ = run("torch", True, chosen)
    L = cfg.n_layers
    flips = [sum(not torch.equal(a.sort(-1).values, b.sort(-1).values)
                 for a, b in zip(chosen[s * L:(s + 1) * L],
                                 served_chosen[s * L:(s + 1) * L]))
             for s in range(RING_STEPS + 1)]
    served_err = [_max_diff([a], [b]) for a, b in zip(served, full)]
    gap_k, gap_p = _max_diff(pinned, full), _max_diff(plain_ring,
                                                      plain_full)
    margin = _max_diff(full, plain_full)
    beyond = [s for s, e in enumerate(served_err) if e > gap_k + margin]
    row["ring_bf16"] = dict(
        batch=1, prompt=cfg.window, steps=RING_STEPS, cache=cfg.window,
        logit_scale=max(float(f.float().abs().max()) for f in full),
        served_step_max_abs=served_err, served_router_flips=flips,
        served_greedy_equal_steps=sum(
            bool(torch.equal(a.argmax(-1), b.argmax(-1)))
            for a, b in zip(served, full)),
        pinned_kernel_gap=gap_k, pinned_plain_gap=gap_p,
        kernel_vs_plain_full=margin, steps_beyond_pinned=beyond,
        kernel_within_plain=gap_k <= gap_p + margin,
        beyond_steps_flip=all(flips[s] > 0 for s in beyond))
    return (row["ring_bf16"]["kernel_within_plain"]
            and row["ring_bf16"]["beyond_steps_flip"])


def _moe_turns(row, res):
    """Both dispatches on the same weights, in turns after the cold dense
    run: gather, gather, dense (capacity 1.25 drops overflow tokens, so
    the two dispatches' tokens may differ: their agreement is
    reported)."""
    from repro_torch.launch import serve
    model, cfg = res["model"], res["cfg"]
    turns = []
    for dispatch in ("gather", "gather", "dense"):
        model.cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
        run = serve.generate(model, res["prompts"], SERVE_GEN)
        turns.append(dict(
            moe_dispatch=dispatch, prefill_ms=run["prefill_ms"],
            decode_ms_per_step=run["decode_ms_per_token"],
            tokens_per_s=run["tokens_per_s"],
            greedy_agree_with_cold_dense=float(
                (run["tokens"] == res["tokens"]).float().mean())))
    model.cfg = cfg
    row["dispatch_turns"] = turns
    return turns[-1]["greedy_agree_with_cold_dense"] == 1.0


def phase_serve_dense():
    """chatglm3-6b, stablelm-12b and qwen3-32b whole, then the int8 KV
    cache on the qwen3-32b weights; the float32 check of each."""
    from repro_torch.configs import get_config
    runs = [(get_config("chatglm3-6b"), None),
            (get_config("stablelm-12b"), None),
            (get_config("qwen3-32b"), _int8_check)]
    checks = [(a, functools.partial(_f32_check, _cut(get_config(
        a, dtype="float32"), CHECK_LAYERS)))
        for a in ("chatglm3-6b", "stablelm-12b")]
    checks.append(("qwen3-32b", _qwen3_f32))
    return _family_phase("serve_dense", runs, checks)


def _mixtral_f32():
    """The float32 check of mixtral (both dispatches on one set of
    weights), then the ring at full width in float32 against the
    full-length cache within the reference's own bound (5e-4 x the
    logits' scale) with equal greedy tokens."""
    import torch
    from repro_torch.configs import get_config
    cfg = _cut(get_config("mixtral-8x22b", dtype="float32"), CHECK_LAYERS)
    rows, ok, model = _f32_check(cfg, model_cfgs=[
        cfg, dataclasses.replace(cfg, moe_dispatch="gather")])
    g = torch.Generator(device="cuda").manual_seed(2)
    ring = _ring_compare(model, cfg, g, 1e-3, 1e-3, 5e-4)
    rows.append(dict(ring_f32=ring))
    return rows, ok and ring["within"] and ring["all_greedy_equal"], model


def phase_serve_moe():
    """mixtral-8x22b and llama4-scout at full width, cut to
    ``MOE_LAYERS`` layers; both dispatches in turns and the ring cache on
    the mixtral weights; the float32 check of each."""
    from repro_torch.configs import get_config

    def mixtral_extra(row, res):
        return _moe_turns(row, res) and _ring_check(row, res)

    runs = [(_cut(get_config("mixtral-8x22b"), MOE_LAYERS), mixtral_extra),
            (_cut(get_config("llama4-scout-17b-a16e"), MOE_LAYERS), None)]
    checks = [("mixtral-8x22b", _mixtral_f32),
              ("llama4-scout-17b-a16e", functools.partial(
                  _f32_check, _cut(get_config("llama4-scout-17b-a16e",
                                              dtype="float32"),
                                   CHECK_LAYERS)))]
    return _family_phase("serve_moe", runs, checks)


def _long_prompt(row, res):
    """One prompt of ``VISION_LONG_PROMPT`` tokens, longer than the 1600
    vision tokens (K2 ``tc`` with Sq > kv_len), every gate 0.5."""
    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.launch import serve
    model, cfg = res["model"], res["cfg"]
    for layer in model.cross_layers:
        layer.attn["gate"].data.fill_(GATE)
    g = torch.Generator(device="cuda").manual_seed(3)
    prompts, vision = serve.make_inputs(cfg, SERVE_BATCH,
                                        VISION_LONG_PROMPT, g,
                                        torch.device("cuda"))
    FA.reset()
    run = serve.generate(model, prompts, SERVE_GEN, vision)
    toks = run["tokens"]
    row["long_prompt"] = dict(
        prompt=VISION_LONG_PROMPT, cross_tokens=cfg.cross_tokens,
        gate=GATE, prefill_ms=run["prefill_ms"],
        decode_ms_per_step=run["decode_ms_per_token"],
        tokens_per_s=run["tokens_per_s"], k2_routes=dict(FA.routes),
        tokens_in_vocab=bool((toks >= 0).all()
                             and (toks < cfg.vocab_size).all()))
    return (row["long_prompt"]["tokens_in_vocab"]
            and row["long_prompt"]["k2_routes"] == row["k2_routes_expected"])


def phase_serve_vision():
    """llama-3.2-vision-11b whole (32 self and 8 cross layers) over the
    vision stub, then a prompt longer than the vision tokens; the float32
    check on one group of 5 layers with every gate 0.5."""
    from repro_torch.configs import get_config
    cfg = get_config("llama-3.2-vision-11b")
    check = _cut(get_config("llama-3.2-vision-11b", dtype="float32"),
                 cfg.cross_attn_every)
    return _family_phase(
        "serve_vision", [(cfg, _long_prompt)],
        [("llama-3.2-vision-11b",
          functools.partial(_f32_check, check, gate=GATE))])


def phase_serve_audio():
    """musicgen-large whole ([B, S, 4] codebook prompts, [B, gen, 4]
    tokens); the float32 check."""
    from repro_torch.configs import get_config
    return _family_phase(
        "serve_audio", [(get_config("musicgen-large"), None)],
        [("musicgen-large", functools.partial(_f32_check, _cut(get_config(
            "musicgen-large", dtype="float32"), CHECK_LAYERS)))])


FAMILY_PHASES = {"serve_dense": phase_serve_dense,
                 "serve_moe": phase_serve_moe,
                 "serve_vision": phase_serve_vision,
                 "serve_audio": phase_serve_audio}


# ------------------------------------------------------- train families
# phases 21-23: training the audio, vision and MoE families through K2,
# at full width; the bf16 runs at batch 4 x 2048, remat full, with AdamW
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 3
# the float32 gradient check: batch 2 x 512 (the vision model's 1600
# vision tokens), loss within rtol 1e-5, each gradient within a relative
# L2 error of 1e-4, as train_hymba's
GRAD_BATCH, GRAD_SEQ = 2, 512
# depth cuts: llama-3.2-vision whole is 10.1 B parameters, some 120 GB
# with AdamW (12 bytes a parameter before activations); two groups of 5
# fit.  mixtral-8x22b whole is 141 B; at 2 layers (5.41 B) the step ran
# out of the card's 80 GB in the gradient clip, so 1 layer (2.91 B)
MOE_TRAIN_LAYERS = 1
VISION_TRAIN_LAYERS = 10
# the dispatches the MoE phase trains on one set of weights
MOE_DISPATCHES = {"dense": dict(moe_dispatch="dense"),
                  "fold": dict(moe_dispatch="dense", moe_fold_gates=True),
                  "gather": dict(moe_dispatch="gather")}


def _family_grad_check(cfg, seed=0, gate=None, dispatches=None):
    """``cfg`` (float32, full width, cut in depth): one ``make_train_step``
    through the kernels and one through the plain versions from the same
    parameters and batch (``GRAD_BATCH`` x ``GRAD_SEQ``; ``gate``: every
    cross layer's gate, set before either runs).  Loss within rtol 1e-5,
    each parameter's gradient within a relative L2 error of 1e-4, K2
    (``f32``) launched twice a layer, self and cross (forward and remat
    recompute), the plain path never.  ``dispatches``: names of
    ``MOE_DISPATCHES`` checked in turn on the same weights.  The MoE
    router's choices are logged on both paths; where one differs, the
    plain path runs again with every router call pinned to the kernel
    path's choices, and that run is compared (the flips are reported)."""
    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.launch import serve
    from repro_torch.models import init_params, make_train_step
    dev = torch.device("cuda")
    _free()
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg, g, device=dev)
    if gate is not None:
        for layer in model.cross_layers:
            layer.attn["gate"].data.fill_(gate)
    tokens, vision = serve.make_inputs(cfg, GRAD_BATCH, GRAD_SEQ, g, dev)
    batch = {"tokens": tokens}
    if vision is not None:
        batch["vision"] = vision
    rows, ok = [], True
    for name in dispatches or [None]:
        model.cfg = cfg if name is None else dataclasses.replace(
            cfg, **MOE_DISPATCHES[name])

        def run(impl, pin=None):
            FA.reset()
            rec = _GradRecorder()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _routes(pin) as chosen:
                metrics = make_train_step(model.cfg, rec, impl=impl)(
                    model, None, batch)
                loss = float(metrics["loss"])
            return dict(loss=loss, grads=rec.grads, chosen=chosen,
                        wall_s=time.perf_counter() - t0, launches=FA.count,
                        routes=dict(FA.routes))
        kern = run("auto")
        plain = run("torch")
        flips = sum(not torch.equal(a.sort(-1).values, b.sort(-1).values)
                    for a, b in zip(kern["chosen"], plain["chosen"]))
        if flips:
            plain = run("torch", pin=kern["chosen"])
        errs, by_leaf = _grad_errors(kern["grads"], plain["grads"])
        worst = max(errs, key=errs.get)
        n = 2 * model.cfg.n_layers
        row = dict(layers=model.cfg.n_layers,
                   cross_layers=len(model.cross_layers),
                   moe_dispatch=name, gate=gate, batch=GRAD_BATCH,
                   seq=GRAD_SEQ, dtype="float32", remat=model.cfg.remat,
                   loss_kernel=kern["loss"], loss_plain=plain["loss"],
                   loss_rel_err=abs(kern["loss"] - plain["loss"])
                   / abs(plain["loss"]),
                   grad_rel_l2_worst=errs[worst], grad_worst_param=worst,
                   grad_rel_l2_by_param=by_leaf,
                   router_calls=len(kern["chosen"]),
                   router_flips=int(flips),
                   plain_pinned_to_kernel_routes=bool(flips),
                   kernel_wall_s=kern["wall_s"],
                   plain_wall_s=plain["wall_s"],
                   kernel_launch_routes=kern["routes"],
                   plain_launches=plain["launches"])
        row["ok"] = (row["loss_rel_err"] <= 1e-5 and errs[worst] <= 1e-4
                     and all(math.isfinite(v) for v in errs.values())
                     and kern["launches"] == n
                     and kern["routes"] == dict(tc=0, split=0, f32=n)
                     and plain["launches"] == 0)
        rows.append(row)
        ok = ok and row["ok"]
        del kern, plain
    del model
    _free()
    return rows, ok


def _train_run(arch, layers=0):
    """``launch.train.run`` of ``arch`` in bf16 (remat full), cut to
    ``layers`` layers when given: ``TRAIN_STEPS`` steps at ``TRAIN_BATCH``
    x ``TRAIN_SEQ``, K2 counted (zeroed just before the run, read just
    after).  Returns (row, the run's result, K2 launches, K2 routes)."""
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.launch import roofline, train
    _free()
    argv = ["--arch", arch, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--seed", "0",
            "--log-every", "1"] + (["--layers", str(layers)] if layers
                                   else [])
    torch.cuda.reset_peak_memory_stats()
    FA.reset()
    t0 = time.perf_counter()
    res = train.run(argv)
    wall = time.perf_counter() - t0
    launches, routes = FA.count, dict(FA.routes)
    cfg = res["cfg"]
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    flops = roofline.model_flops(cfg, shape)
    warm_s = res["warm_ms"] / 1e3
    want = 2 * cfg.n_layers * TRAIN_STEPS
    row = dict(arch=cfg.name, argv=argv, layers=cfg.n_layers,
               cross_layers=(cfg.n_layers // cfg.cross_attn_every
                             if cfg.cross_attn_every else 0),
               params_built=sum(p.numel()
                                for p in res["model"].parameters()),
               params_config=cfg.param_count(),
               active_params=cfg.active_param_count(),
               dtype=cfg.dtype, remat=cfg.remat,
               moe_dispatch=cfg.moe_dispatch if cfg.moe_experts else None,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=res["losses"],
               step_ms=res["step_ms"], first_ms=res["step_ms"][0],
               warm_ms=res["warm_ms"], tokens_per_s=res["tokens_per_s"],
               model_flops_per_step=flops,
               model_tflops=flops / warm_s / 1e12,
               mfu_bf16=flops / warm_s / roofline.H100_SXM.peak_flops_bf16,
               run_wall_s=wall, peak_mem_gb=torch.cuda.max_memory_allocated()
               / 1e9, k2_launches=launches, k2_routes=routes,
               k2_routes_expected=dict(tc=want, split=0, f32=0))
    row["ok"] = (len(res["losses"]) == TRAIN_STEPS
                 and all(math.isfinite(v) for v in res["losses"])
                 and launches == want and routes == row["k2_routes_expected"]
                 and cfg.remat == "full" and cfg.dtype == "bfloat16")
    return row, res, launches, routes


def _profile_step(res):
    """One more warm step of the run's trainer under the profiler,
    outside the counted run: device busy and idle share, K2's share and
    the plain attention backward's device time."""
    step = len(res["losses"])
    return _profile(lambda: float(res["step_fn"](
        res["model"], res["opt_state"], res["make_batch"](step))["loss"]),
        ranges=PLAIN_BACKWARDS[:1])


def _dispatch_turns(res, order=("gather", "fold", "dense", "dense", "fold",
                                "gather")):
    """The MoE trainer's model and AdamW state stepped on in turns with
    each dispatch of ``order`` (one step each, the next step's batch):
    ms/step, loss and peak memory of each."""
    import torch
    model, cfg = res["model"], res["cfg"]
    turns = []
    step = len(res["losses"])
    for name in order:
        model.cfg = dataclasses.replace(cfg, **MOE_DISPATCHES[name])
        batch = res["make_batch"](step)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(res["step_fn"](model, res["opt_state"], batch)["loss"])
        turns.append(dict(moe_dispatch=name, step=step,
                          ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                          peak_mem_gb=torch.cuda.max_memory_allocated()
                          / 1e9))
        step += 1
    model.cfg = cfg
    by = {}
    for t in turns:
        by.setdefault(t["moe_dispatch"], []).append(t["ms"])
    return dict(turns=turns, ms_mean={k: sum(v) / len(v)
                                      for k, v in by.items()},
                ok=all(math.isfinite(t["loss"]) for t in turns))


def _train_phase(phase, checks, arch, layers=0, extra=None):
    """The float32 gradient checks (``checks``: name -> thunk returning
    (rows, ok)), then the bf16 ``launch.train.run`` of ``arch`` (the
    main path), one profiled step and ``extra(res)`` (a dict with
    ``ok``); one line for the phase, failed on any check.  Returns the
    main path's K2 launches and routes and the phase's wall seconds."""
    t0 = time.perf_counter()
    grad, row, ok = {}, None, True
    try:
        for name, thunk in checks:
            grad[name], good = thunk()
            ok = ok and good
        if ok:
            row, res, launches, routes = _train_run(arch, layers)
            ok = row["ok"]
            row["profile"] = _profile_step(res)
            if extra is not None:
                row["extra"] = extra(res)
                ok = ok and row["extra"]["ok"]
            del res
            _free()
    except Exception:
        emit(phase, card=CARD, grad_check=grad, train=row, ok=False,
             wall_s=time.perf_counter() - t0)
        raise
    wall = time.perf_counter() - t0
    emit(phase, card=CARD, grad_check=grad, train=row, ok=ok, wall_s=wall)
    if not ok:
        raise AssertionError(f"{phase}: a check failed (see its line)")
    return launches, routes, wall


def phase_train_audio():
    """musicgen-large: the float32 gradient check at 2 layers, then the
    whole model (48 layers, 3.25 B) for ``TRAIN_STEPS`` bf16 steps."""
    from repro_torch.configs import get_config
    check = _cut(get_config("musicgen-large", dtype="float32"), 2)
    return _train_phase("train_audio", [(
        "musicgen-large", functools.partial(_family_grad_check, check))],
        "musicgen-large")


def phase_train_vision():
    """llama-3.2-vision-11b: the float32 gradient check on one group of 5
    layers (4 self + 1 cross) with every gate 0.5, then
    ``VISION_TRAIN_LAYERS`` layers (8 self + 2 cross) in bf16."""
    from repro_torch.configs import get_config
    cfg = get_config("llama-3.2-vision-11b", dtype="float32")
    check = _cut(cfg, cfg.cross_attn_every)
    return _train_phase("train_vision", [(
        "llama-3.2-vision-11b", functools.partial(_family_grad_check, check,
                                                  gate=GATE))],
        "llama-3.2-vision-11b", VISION_TRAIN_LAYERS)


def phase_train_moe():
    """mixtral-8x22b: the float32 gradient check at 1 layer with the
    dense dispatch, dense with folded gates and gather, on one set of
    weights; then ``MOE_TRAIN_LAYERS`` layers in bf16 (dense, the main
    path) and the dispatches in turns on its weights."""
    from repro_torch.configs import get_config
    check = _cut(get_config("mixtral-8x22b", dtype="float32"), 1)
    return _train_phase("train_moe", [(
        "mixtral-8x22b", functools.partial(_family_grad_check, check,
                                           dispatches=list(MOE_DISPATCHES)))],
        "mixtral-8x22b", MOE_TRAIN_LAYERS, extra=_dispatch_turns)


TRAIN_PHASES = {"train_audio": phase_train_audio,
                "train_vision": phase_train_vision,
                "train_moe": phase_train_moe}


# ------------------------------------------------------------------ mesh
MESH_SERVE = dict(batch=4, prompt=1536, gen=8)
MESH_TRAIN = dict(layers=4, batch=2, seq=2048)
# phase (c): the dry run's cells, run by the card machine's Python on its
# CPU while (a) and (b) use the card: (arch, shape, mesh)
MESH_DRYRUN_CELLS = (("hymba-1.5b", "train_4k", "single"),
                     ("mixtral-8x22b", "decode_32k", "multi"),
                     ("mixtral-8x22b", "decode_32k", "single"),
                     ("mixtral-8x22b", "train_4k", "single"))
# phase (b) trains one step too when the dry run's argument bytes for
# mixtral-8x22b train_4k on one card of (16, 16) fit the card's memory
CARD_BYTES = 80e9


def _start_mesh_dryrun(out_dir):
    """The dry run of ``MESH_DRYRUN_CELLS`` in a child process on the CPU
    (no card visible to it); returns the process."""
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"for a, s, m in {MESH_DRYRUN_CELLS!r}:\n"
            "    dryrun.run_cell(a, s, m, dryrun.POLICIES['baseline'],\n"
            "                    sys.argv[1],\n"
            "                    with_roofline=(m == 'single'))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(HERE, "src"))
    return subprocess.Popen([sys.executable, "-c", code, out_dir], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=HERE)


def _mesh_record(out_dir, arch, shape, mesh):
    with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")) as f:
        rec = json.load(f)
    keep = {k: rec.get(k) for k in ("ok", "n_chips", "memory",
                                    "params_total", "params_active",
                                    "trace_s", "error")}
    rf = rec.get("roofline")
    if rf:
        keep["roofline"] = {k: rf[k] for k in (
            "flops_per_chip", "hbm_bytes_per_chip",
            "collective_bytes_per_chip", "compute_s", "memory_s",
            "collective_s", "dominant", "useful_flops_ratio")}
        keep["roofline"]["collective_counts"] = \
            rf["collectives"]["counts_by_op"]
    return keep


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _mesh_greedy(model, prompts, gen, policy):
    """Prefill ``prompts`` and decode ``gen`` greedy tokens through the
    kernels with ``policy``: every step's logits (local), the tokens, the
    launches and the wall seconds."""
    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels import SSD_LAUNCHES as SS
    from repro_torch.launch.serve import greedy
    from repro_torch.models import decode_step, prefill
    FA.reset()
    SS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, pos = prefill(model, prompts,
                                 cache_len=prompts.shape[1] + gen,
                                 policy=policy)
    outs, toks = [_local(logits)], []
    tok = greedy(logits)
    for _ in range(gen):
        toks.append(_local(tok))
        logits, cache, pos = decode_step(model, tok, cache, pos,
                                         policy=policy)
        outs.append(_local(logits))
        tok = greedy(logits)
    torch.cuda.synchronize()
    return dict(logits=outs, tokens=torch.cat(toks, dim=1),
                wall_s=time.perf_counter() - t0,
                launches=dict(flash_attention=FA.count, ssd=SS.count),
                routes=dict(FA.routes))


def _mesh_parity(seed=0):
    """(a): a real one-rank NCCL group and a (1, 1) mesh on the card;
    hymba-1.5b served at full width (bf16) and the f32 train step cut to
    ``MESH_TRAIN["layers"]`` layers, placed by ``param_pspecs`` /
    ``cache_pspecs`` with ``ShardingPolicy(seq_axis="model")``, against
    the unmeshed path on the same weights: bit for bit, equal launches."""
    import copy
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels import SSD_LAUNCHES as SS
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params, make_train_step
    from repro_torch.models.params import place_batch, place_model
    from repro_torch.models.transformer import NO_POLICY, ShardingPolicy
    dev = torch.device("cuda", torch.cuda.current_device())
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, device_id=dev)
    main_path = dict(flash_attention=0, ssd=0)
    k2_routes = None
    try:
        mesh = make_test_mesh((1, 1), device_type="cuda")
        sp = ShardingPolicy(mesh=mesh, batch_axes=("data",),
                            seq_axis="model")
        B, P, gen = MESH_SERVE["batch"], MESH_SERVE["prompt"], \
            MESH_SERVE["gen"]
        cfg = get_config("hymba-1.5b")
        g = torch.Generator(device=dev).manual_seed(seed)
        plain = init_params(cfg, g, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                                device=dev)
        placed = copy.deepcopy(plain)
        place_model(placed, mesh)
        pprompts = place_batch({"tokens": prompts}, mesh, ("data",))[
            "tokens"]
        runs = {}
        for name, model, toks, pol in (("plain", plain, prompts, NO_POLICY),
                                       ("mesh", placed, pprompts, sp),
                                       ("mesh_warm", placed, pprompts, sp),
                                       ("plain_warm", plain, prompts,
                                        NO_POLICY)):
            runs[name] = _mesh_greedy(model, toks, gen, pol)
        serve = dict(batch=B, prompt=P, gen=gen, layers=cfg.n_layers,
                     dtype=cfg.dtype)
        serve["logits_equal"] = all(
            torch.equal(a, b) for a, b in zip(runs["plain"]["logits"],
                                             runs["mesh"]["logits"]))
        serve["tokens_equal"] = bool(torch.equal(runs["plain"]["tokens"],
                                                 runs["mesh"]["tokens"]))
        serve["warm_equal"] = all(
            torch.equal(a, b) for a, b in zip(runs["mesh"]["logits"],
                                             runs["mesh_warm"]["logits"]))
        for name, r in runs.items():
            serve[f"{name}_wall_s"] = r["wall_s"]
            serve[f"{name}_launches"] = r["launches"]
            serve[f"{name}_routes"] = r["routes"]
        want = dict(tc=cfg.n_layers, split=cfg.n_layers * gen, f32=0)
        serve_ok = (serve["logits_equal"] and serve["tokens_equal"]
                    and runs["plain"]["launches"] == runs["mesh"]["launches"]
                    == dict(flash_attention=cfg.n_layers * (gen + 1),
                            ssd=cfg.n_layers)
                    and runs["plain"]["routes"] == runs["mesh"]["routes"]
                    == want)
        main_path = dict(runs["mesh"]["launches"])
        k2_routes = dict(runs["mesh"]["routes"])
        del plain, placed, runs
        _free()

        # the f32 train step, cut in depth
        L, Bt, S = MESH_TRAIN["layers"], MESH_TRAIN["batch"], \
            MESH_TRAIN["seq"]
        cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=L)
        g = torch.Generator(device=dev).manual_seed(seed)
        plain = init_params(cfg32, g, device=dev)
        tokens = torch.randint(0, cfg32.vocab_size, (Bt, S), generator=g,
                               device=dev)
        placed = copy.deepcopy(plain)
        place_model(placed, mesh)
        train = dict(layers=L, batch=Bt, seq=S, dtype="float32",
                     remat=cfg32.remat)
        res = {}
        for name, model, batch, pol in (
                ("plain", plain, {"tokens": tokens}, NO_POLICY),
                ("mesh", placed, place_batch({"tokens": tokens}, mesh,
                                             ("data",)), sp)):
            FA.reset()
            SS.reset()
            rec = _GradRecorder()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = make_train_step(cfg32, rec, policy=pol)(model, None, batch)
            torch.cuda.synchronize()
            res[name] = dict(loss=_local(m["loss"]),
                             grads={n: _local(v)
                                    for n, v in rec.grads.items()},
                             wall_s=time.perf_counter() - t0,
                             launches=dict(flash_attention=FA.count,
                                           ssd=SS.count),
                             routes=dict(FA.routes))
        train["loss"] = float(res["plain"]["loss"])
        train["loss_equal"] = bool(torch.equal(res["plain"]["loss"],
                                               res["mesh"]["loss"]))
        unequal = sorted(n for n, v in res["plain"]["grads"].items()
                         if not torch.equal(v, res["mesh"]["grads"][n]))
        train["grads_unequal"] = unequal
        train["n_grads"] = len(res["plain"]["grads"])
        for name, r in res.items():
            train[f"{name}_wall_s"] = r["wall_s"]
            train[f"{name}_launches"] = r["launches"]
            train[f"{name}_routes"] = r["routes"]
        train_ok = (train["loss_equal"] and not unequal
                    and res["plain"]["launches"] == res["mesh"]["launches"]
                    == dict(flash_attention=2 * L, ssd=2 * L)
                    and res["plain"]["routes"] == res["mesh"]["routes"])
        for k in main_path:
            main_path[k] += res["mesh"]["launches"][k]
        k2_routes = {r: k2_routes[r] + res["mesh"]["routes"][r]
                     for r in k2_routes}
        del plain, placed, res
        _free()
    finally:
        dist.destroy_process_group()
    return dict(serve=serve, train=train), serve_ok and train_ok, \
        main_path, k2_routes


def _mesh_rank0_step(shape_name):
    """(b): rank 0's local shards of mixtral-8x22b on a (16, 16) mesh of
    a fake group of 256 ranks on the card, one step through the kernels:
    peak memory, the shards' bytes, the local K2/K3 calls and their
    launches, ms.  Fake collectives return unset memory: no value of
    this run is a result."""
    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels import SSD_LAUNCHES as SS
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_production_mesh
    calls = {}
    real = ops.flash_attention

    def recording(q, k, v, **kw):
        key = (tuple(q.shape), tuple(k.shape), str(q.dtype))
        calls[key] = calls.get(key, 0) + 1
        return real(q, k, v, **kw)

    _free()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.flash_attention = recording
    try:
        with dryrun.fake_group(256):
            mesh = make_production_mesh(device_type="cuda")
            cfg, shape, fn, args = dryrun.build_cell(
                "mixtral-8x22b", shape_name, mesh,
                dryrun.POLICIES["baseline"], device="cuda", impl="auto")
            shards = roofline.memory_stats(args, (), ())[
                "argument_size_in_bytes"]
            FA.reset()
            SS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(flash_attention=FA.count, ssd=SS.count)
            routes = dict(FA.routes)
            del args
    finally:
        ops.flash_attention = real
    peak = torch.cuda.max_memory_allocated() - base
    _free()
    return dict(shape=shape_name, layers=cfg.n_layers, ms=ms,
                peak_allocated_bytes=peak, shard_bytes=shards,
                k2_local_calls=[dict(q=q, k=k, dtype=dt, calls=n)
                                for (q, k, dt), n in calls.items()],
                launches=launches, routes=routes)


def phase_mesh():
    """The mesh phase: (a) the (1, 1) mesh against the unmeshed path,
    bit for bit; (b) rank 0's share of mixtral-8x22b on the card; (c) the
    dry run on the CPU, beside them."""
    import shutil
    import tempfile

    import torch
    t0 = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="mesh_dryrun_",
                               dir=os.path.join(HERE, "build"))
    child = _start_mesh_dryrun(out_dir)
    try:
        parity, ok, launches, routes = _mesh_parity()
        emit("mesh_parity", card=CARD, **parity, ok=ok)
        if not ok:
            raise AssertionError("mesh: the (1, 1) mesh path differs from "
                                 "the unmeshed path")
        rank0 = [_mesh_rank0_step("decode_32k")]
        log, _ = child.communicate(timeout=900)
        if child.returncode != 0:
            raise AssertionError(f"mesh: the dry run failed:\n{log[-3000:]}")
        cells = {f"{a} {s} {m}": _mesh_record(out_dir, a, s, m)
                 for a, s, m in MESH_DRYRUN_CELLS}
        if not all(c["ok"] for c in cells.values()):
            raise AssertionError(f"mesh: a dry-run cell failed: {cells}")
        train_args = cells["mixtral-8x22b train_4k single"]["memory"][
            "argument_size_in_bytes"]
        train_oom = None
        if train_args < CARD_BYTES:
            # the arguments fit; whether the step's temporaries do too is
            # what this run measures
            try:
                rank0.append(_mesh_rank0_step("train_4k"))
            except torch.OutOfMemoryError as e:
                train_oom = dict(error=str(e).splitlines()[0],
                                 peak_allocated_bytes=
                                 torch.cuda.max_memory_allocated())
            _free()
        for r in rank0:
            r["dryrun_argument_bytes"] = cells[
                f"mixtral-8x22b {r['shape']} single"]["memory"][
                "argument_size_in_bytes"]
            for k in launches:
                launches[k] += r["launches"][k]
            routes = {k: routes[k] + r["routes"][k] for k in routes}
        for r in rank0:
            if r["shard_bytes"] != r["dryrun_argument_bytes"]:
                raise AssertionError(f"mesh: the card's shards differ from "
                                     f"the dry run's: {r}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    emit("mesh", card=CARD, rank0=rank0, dryrun=cells,
         train_4k_tried=train_args < CARD_BYTES, train_4k_oom=train_oom,
         launches=launches, launch_routes=routes,
         seconds=time.perf_counter() - t0, ok=True)
    return launches, routes


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of phases (default all)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's smoke "
              "run needs one card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    # float32 products in full float32 on the card (no TF32), as the
    # plain versions and the reference compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = phase_env()
    if "build" in phases:
        phase_build()
    wf = gp = ls = None
    if "kernel_waterfill" in phases:
        wf = phase_kernel_waterfill()
    if "kernel_greedy_place" in phases:
        gp = phase_kernel_greedy_place()
    if "kernel_list_schedule" in phases:
        ls = phase_kernel_list_schedule()
    if "golden" in phases:
        phase_golden()
    if "survey_mini" in phases:
        phase_survey_mini()
    launches = {}
    k1 = []          # (launches, by route) of each of K1's path phases
    greedy = []      # greedy placement's launches of each greedy path phase
    for phase, run in (("survey_agreement", phase_survey_agreement),
                       ("survey_dataset", phase_survey_dataset),
                       ("survey_full_width", phase_survey_full_width),
                       ("survey_engine", phase_survey_engine),
                       ("survey_ranks", phase_survey_ranks)):
        if phase in phases:
            n, rt, g = run()
            k1.append((n, rt))
            greedy.append(g)
    if "static_golden" in phases:
        k1.append(phase_static_golden())
    if "static_full_width" in phases:
        k1.append(phase_static_full_width())
    if "genetic_vec" in phases:
        k1.append(phase_genetic_vec())
    k1_routes = None
    if k1:
        launches["waterfill"] = sum(n for n, _ in k1)
        k1_routes = {r: sum(rt[r] for _, rt in k1) for r in k1[0][1]}
    fa = ss = None
    if "kernel_flash_attention" in phases:
        fa = phase_kernel_flash_attention()
    if "kernel_ssd" in phases:
        ss = phase_kernel_ssd()
    k2_routes = None
    if "serve_hymba" in phases:
        serve_launches, k2_routes = phase_serve_hymba()
        launches.update(serve_launches)
    if "train_hymba" in phases:
        train_launches, train_routes = phase_train_hymba()
        for name, n in train_launches.items():
            launches[name] = launches.get(name, 0) + n
        k2_routes = train_routes if k2_routes is None else {
            r: k2_routes[r] + train_routes[r] for r in k2_routes}
    for phase, run in FAMILY_PHASES.items():
        if phase in phases:
            n, rt = run()
            launches["flash_attention"] = launches.get("flash_attention",
                                                       0) + n
            k2_routes = rt if k2_routes is None else {
                r: k2_routes[r] + rt[r] for r in k2_routes}
    train_walls = {}
    for phase, run in TRAIN_PHASES.items():
        if phase in phases:
            n, rt, train_walls[phase] = run()
            launches["flash_attention"] = launches.get("flash_attention",
                                                       0) + n
            k2_routes = rt if k2_routes is None else {
                r: k2_routes[r] + rt[r] for r in k2_routes}
    if "mesh" in phases:
        n, rt = phase_mesh()
        for name, c in n.items():
            launches[name] = launches.get(name, 0) + c
        k2_routes = rt if k2_routes is None else {
            r: k2_routes[r] + rt[r] for r in k2_routes}
    if "escape_hatches" in phases:
        n, rt, g = phase_escape_hatches()
        greedy.append(g)
        launches["waterfill"] = launches.get("waterfill", 0) + n
        k1_routes = rt if k1_routes is None else {
            r: k1_routes[r] + rt[r] for r in k1_routes}
    if "simlint" in phases:
        phase_simlint()
    if greedy:
        launches["greedy_place"] = sum(greedy)
        launches["list_schedule"] = MAIN_PATH_SCHEDULES[0]
    kernels = []
    for name, res, src, replaces, lib in (
            ("waterfill", wf, "waterfill.cu",
             "src/repro/kernels/waterfill.py:30", False),
            ("greedy_place", gp, "greedy_place.cu",
             "none (the reference's placer is a fori_loop under jit, "
             "src/repro/core/vectorized/scheduling.py:541)", False),
            ("list_schedule", ls, "list_schedule.cu",
             "none (the reference's list schedule is fori_loops under jit, "
             "src/repro/core/vectorized/scheduling.py:142, :201)", False),
            ("flash_attention", fa, "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:25", True),
            ("ssd", ss, "ssd.cu", "src/repro/kernels/ssd.py:24", False)):
        if res is None:
            continue
        # launches: null unless this run drove the kernel's path
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=replaces, launches=launches.get(name),
            max_abs_err=res["max_abs_err"], ms=res["path"]["ms"],
            plain_ms=res["path"]["plain_ms"],
            bound_ms=res["path"]["bound_ms"],
            bound_by=res["path"]["bound_by"],
            library_ms=res["path"]["library_ms"] if lib else None))
        # the main path's launches by route (null without its phase)
        if name == "waterfill":
            kernels[-1]["launch_routes"] = k1_routes
            kernels[-1]["per_edge"] = [
                {k: r[k] for k in ("F", "ms", "plain_ms", "bound_ms",
                                   "bound_by")} for r in res["per_edge"]]
        if name == "flash_attention":
            kernels[-1]["launch_routes"] = k2_routes
    if "kernels" in phases:
        emit("kernels", kernels=[dict(name=k["name"],
                                      launches=k["launches"],
                                      held_against_plain=True)
                                 for k in kernels],
             train_families_s=dict(train_walls,
                                   total=sum(train_walls.values())),
             total_s=time.perf_counter() - t_start)
        # every kernel held against its plain version and launched on its
        # path in this run
        checked = {k["name"] for k in kernels}
        missing = sorted({"waterfill", "greedy_place", "list_schedule",
                          "flash_attention", "ssd"}
                         - (checked & set(launches)))
        if missing:
            raise AssertionError(
                f"the kernels phase needs every kernel's check and path "
                f"phases; not run for {missing}")
        never = sorted(n for n, c in launches.items() if c <= 0)
        if never:
            raise AssertionError(f"the main path never launched {never}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
