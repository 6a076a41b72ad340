#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bang_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py                   # from the repo root; one CUDA card
    python3 chip_smoke.py --scale 10000000  # instead: the scale run (scale_run)
    python3 chip_smoke.py --real sift1m     # instead: the real-corpus run (real_run)

Phases, each printing progress; any failure raises and exits non-zero:
  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), torch, CUDA and nvcc versions.
  2. build    — build the eight sources of bang_tpu_torch/csrc: the six
                kernel sources (seven wrappers: lookup_packed launches K1's),
                graph_loop.cu (the captured search's WHILE node,
                models/compiled.py) and stage_clock.cu (ENABLE_GPU_STATS's
                stamp, ops/stage_clock.py), one nvcc per source, all
                started together.
  3. kernels  — K1 pq_lookup, K2 frontier_lookup and K3 exact_frontier
                against their plain PyTorch versions on the card at the main
                paths' shapes and others: ids bit-exact; K1 and K2 (both on
                bf16-pair tables, pack_tables) distances within rtol 1e-5
                plus atol 1e-5 x the row's largest distance (f32 summation
                order is all that differs), at shapes that take each of
                their copy paths (16-byte, 4-byte, byte) and candidates or
                parents in groups; K1 also on code tiles 4 and 1 bytes off
                a 16-byte boundary, bit for bit equal to its aligned launch;
                K2 also with parents outside [0, N) (id -1, +inf); at the
                main shape K2, and K1 on the codes of the same rows,
                identical bit for bit to K6 row_gather + K5 frontier_packed
                on the same parents (the same sum in the same order); K3
                distances bit-exact for integer queries at D <= 128 (every
                partial sum is an integer below 2^24), else within rtol
                1e-5 plus atol 1e-5 x (||q||^2 + the row's largest norm),
                at shapes that take each of its row-copy paths (16-byte,
                4-byte, byte) and parents in groups, and with parents
                outside [0, N) (id -1, +inf). Times each at its main path's
                shape; K1's and K2's bounds count the packed tables' bytes.
  visited     — the traversal's visited filter (ops/visited.visited_filter,
                csrc/visited_filter.cu) against its plain version
                (visited_filter_plain, the sorted mask's composition), new
                and dist bit for bit, on random ids with INVALID_ID in all
                three lists, inactive queries and invalid parents, at the
                benchmark cell's step (Q=10K, beam 2, R=64, L=40, V=52),
                both searches' profiled shapes (in-memory L=128 V=140,
                exact L=100 V=106), beam 3 at R=24 (C=72, L and V odd),
                beam 16 and L=512 beam 1;
                the sorted mask equal to its dense form at each. At the
                cell's shape the kernel and the plain version timed (plain,
                kernel, kernel, plain) beside the kernel's bound.
  probes      — lookup_packed (K1's kernel), K5 frontier_packed (with and
                without id planes) and K6 row_gather, the counterparts of
                the six Pallas probes in scripts/, against their plain
                versions at the probes' shape and at R=24 m=12 beam 4 with
                ids up to 2^30 (ids and gathered bytes bit-exact, distances
                as K1's: the bf16 entries are the same, only the f32
                summation order may differ; lookup_packed equal to K5 bit
                for bit), K6 also at widths 5120, 4352 and 100 with odd
                and out-of-range parents (zero rows); times each, K6 beside
                torch.index_select. Then runs the five probe scripts
                (bang_tpu_torch.scripts.exp_*.main("cuda")) at their own
                sizes, each with the launch counts zeroed before and read
                after: each must launch its kernels and no other.
  4. bundle   — build the bench's headline bundle on the card with the
                port's builders (bench.py's settings: 1M x 128 u8 clustered
                data, 10K queries at noise 2.0, Vamana R=64 l_build 48 batch
                4096 alpha 1.44 2 passes, PQ m=64) and write it in the
                reference's file formats to a temp dir.
  5. search   — BANGSearch("inmemory") on the fused-row layout (K2), L in
                {32, 64, 128, 256, 512}, beam 2, extra_iters 11: recall@10,
                iterations, wall time and QPS; recall@10 >= 90 at the best L.
                Phases 5-17 search through the captured loop, as a user's
                calls do (bang_alloc runs the eager loop once, then
                captures; each kernel counts its launches on the card, so
                a graph replay's launches count as the eager loop's do).
                Then one call at L=128 under torch.profiler, after three
                timed ones: kernel device ms by name, busy share,
                peak memory; and the eager loop (a replay cannot be split
                into stages) profiled: kernel device ms by traversal stage.
  6. scattered — the same bundle on the scattered-codes layout (K1 over the
                packed tables) at the best L: ids and iterations identical
                to phase 5's (K1 and K2 sum the same entries in the same
                order). Then one call at L=512 under torch.profiler, as
                phase 5's.
  7. exact    — BANGSearch("exactdistance") on the fused exact rows (K3),
                L in {10, 16, 30, 60, 100}, beam 1, extra_iters 6: recall@10
                >= 90 at the best L; no re-rank, so the distances checked are
                K3's own. Then the L=100 profile, as phase 5's.
  8. exact scattered — the scattered exact layout (plain fetch, no kernel)
                at the best L: ids identical to phase 7 for every query.
  9. sampled  — entry_mode="sampled" at each variant's best L (K3, K2):
                recall@10 >= 90; and at its sweep's smallest L. Both printed
                beside the medoid runs.
 10. base     — BANGSearch("base") on the same bundle at bench.py::
                sweep_base's operating point: the packed graph read into host
                RAM (mmap=False), the PQ codes on the card, 8 pipeline
                sub-batches (one CUDA stream each), L in {30, 45, 60, 90},
                beam 2, extra_iters 16, ENABLE_GPU_STATS on: recall@10, device
                steps, readback waits, the four stage ms, wall and QPS per L;
                recall@10 >= 90 at the best L; K1 launched once per device
                step and no other kernel. At the best L: one sub-batch
                (serial) must return the pipelined run's ids for every query
                (its wall gives the pipeline's speedup), and sampled entry
                recall@10 >= 90. Then the native host gather alone on one
                sub-batch's parents, and one call under torch.profiler
                (kernel ms by name and by step stage, the code gather's ms,
                the card's busy share over the union of kernel intervals on
                all streams, peak memory), on the eager step, then the
                captured step's busy share.
 18. captured — the captured loop (models/compiled.py: one CUDA graph a
                search, its traversal a WHILE node; base: one graph replay a
                sub-batch's step) against the eager loop, its plain version,
                on the bundle: in-memory fused L=128 (exact and bloom mode,
                medoid and sampled entry), exact fused L=10 (medoid,
                sampled) and L=100, the serving batch of 128 (in-memory
                L=64, exact L=30), base L=90 with 1 sub-batch (scattered
                L=512 and base with 8 sub-batches are cut for the time
                limit: phases 20 and 14 hold their captures against the
                eager loop); calls in the order eager, captured,
                captured, eager after each key's capture: ids, distances,
                iterations, distance computations and K1/K2/K3 launches (as
                the kernels count them on the card) identical (base: steps
                and readback waits too), the path's kernel once a step
                (and in exact mode the visited filter);
                walls, blocking host waits a call, peak GB allocated, peak
                GB reserved from an emptied cache (captured with its pool,
                eager with the graphs dropped), graph pool GB by part,
                capture s, and one profiled call of each (kernel ms, busy
                share). Runs after phase 10.
 19. captured loops — the Vamana build and the streaming index captured
                (the chunk-sharded base's capture is checked in phase 14),
                each against its eager plain version on the card. The
                Vamana build (formats/vamana.build_vamana_graph: each
                pass's first batch eager, then one graph launch a batch) on
                100K points of the bench's clustered u8 data at phase 4's
                settings (R=64, l_build 48,
                batch 4096, alpha 1.44, 2 passes), against
                build_vamana_graph_eager, in the order eager, captured,
                captured, eager: adj, degrees and every batch's dropped
                count identical bit for bit (u8: integer distances below
                2^24); the captured build's blocking host waits outside its
                eager first batches and its captures equal to the
                heartbeats plus two synchronises (the build's last and the
                wall's); walls, waits,
                capture s, pool GB, peak GB; one batch profiled on each
                (busy share). The streaming index at phase
                13's point, one index eager (`captured` False) and one
                captured: the states identical after every insert, the
                delete, the consolidate (the medoid among the victims, so
                re-elected) and the re-insert into the freed slots; search
                ids and distances identical (eager, captured, captured,
                eager) before the churn and after each step; inserts/s,
                walls, pools, one insert and one search profiled on each.
                No kernel launches.
 22. stats    — ENABLE_GPU_STATS on the captured HBM searches (after 19),
                at the benchmark cells' search settings (gpubench/configs:
                in-memory L=40 beam 2 extra 11, exact L=10 beam 1 extra 6)
                on phase 4's bundle, loaded once a search and captured
                without the stats, then with them: ids and distances
                identical bit for bit; the stage clock's stamps (ops/stage_clock, counted by
                the kernel on the card) 5 a step plus 2 in the prologue and
                2 in the epilogue, 5 (iters - 1) + 4, a stats-on call, none
                a stats-off call; the path's kernel and the visited filter
                once a step of a captured call; `dev.visited` with the
                filter's kernel, and again captured with its plain version
                (the answers identical); one host wait a stats-on call; the graph's
                device span from the stamps (`dev.graph`) within 3% of a
                CUDA event pair around the same launch (median of 5, the
                queries on the card); the stage split printed. Then
                %globaltimer's step, from 200 pairs of back-to-back stamps.
 11. bloom    — visited_mode="bloom" (ops/bloom.py, plain PyTorch) on each
                search of the bundle: in-memory fused L in {64, 128, 256}
                (K2), in-memory scattered L=512 (K1), exact fused L in {30,
                60, 100} (K3), base L in {30, 90} (K1 once a device step),
                each run in the order exact, bloom, bloom, exact: each L's
                recall@10 >= the exact mode's at that L - 1.5 (the JAX
                package's bar, tests/test_large_l.py) and >= 90 at the best
                L, the same ids in both runs of a mode; walls, iterations
                and peak memory beside the exact mode's. Then the fused
                L=128 profile in bloom mode, the hash, query and insert in
                profiler ranges.
 12. warm-up and serving — ENABLE_CACHE_WARMUP on the three variants: the
                touched count equal to the BFS count from the medoid, the ids
                identical to a call without the bit. SearchServer("inmemory",
                batch_size=128) over the 10K queries: ids and distances
                identical to bang_query at Q=128, latency percentiles. The
                latency probes: measure_device_batch_latency at 128 queries
                (in-memory, exact) and measure_base_device_step_ms at 1,250
                (exact, bloom, bloom, exact), each launching its variant's
                kernel.
 13. streaming — bang_tpu_torch/bench.streaming_row (bench.py::streaming_row's
                point): StreamingIndex from empty
                over 200K x 128 f32 clustered points (seed 11, 200 clusters),
                R=32, l_build 32, inserts of 4,096; search at L=64, beam 2,
                extra_iters 24 over 2,048 queries; 10% churn (delete,
                consolidate(batch=4096), re-insert 4,096 into freed slots):
                recall@10 over the live set >= 90 before and after the churn,
                no kernel launched. The timed inserts and searches hold the
                captured loops only (each key's eager call and capture run
                before the clock starts).
 14. sharded  — parallel/ on the bundle's data, every mesh on [card] * n
                (one card): K1 against its plain version and timed at each
                code width the sharded paths give it (m/4 chunks, and the dry
                run's 1 and 8); the card's kNN graph against numpy's on 20K
                points (rows reported); 4 node shards of 250K points (R=64,
                m=64, the bundle's codebook) searched on a (1, 4) mesh at L in
                {128, 256}, fused (K2) and scattered (K1): ids and every
                shard's iterations identical, recall@10 >= 90 at the best L;
                the merge equal to each shard searched alone with
                search_inmemory and merged on the host; exact shards at L=256
                (no kernel), recall@10 >= 90; search_data_parallel on a (2, 1)
                mesh, ids identical to search_inmemory; ShardedBaseSearcher
                on a (1, 4) mesh (8 sub-batches, base L in {30, 90}, medoid
                and sampled entry), captured (its shards share the card)
                beside one on the eager step, in the order eager, captured,
                captured, eager: ids, distances, steps, readback waits and
                K1 launches identical, K1 launched 4 times a step (and 4
                times per sub-batch's sampled entries) as the kernel counts
                it on the card; ids equal to the single-card base's on
                >= 98% of slots, recall@10 >= 90; walls, pools, one
                profiled call of each at L=90; then
                entry.dryrun_multichip(4). Walls, iterations and peak memory.
                At each fused L, search_sharded's first call (its shards
                stepped together in rounds on the eager loop, then each
                shard's walk captured) beside its captured calls (one graph
                launch a shard, one wait) and the per-shard loop (each shard
                searched to its end in turn), in the order captured, loop,
                loop, captured: ids and every shard's iterations identical,
                the captured calls' distance computations and launches
                identical to the rounds', the walls; data parallel's rounds
                and captured call against search_inmemory.
 15. sharded build — formats/bigbuild.py: BlockGen at N=1M x 128 u8 on the
                card, build_sharded_vamana (4 shards, overlap 2, R=64, l_build
                48, batch 4096, one pass; no kernel), k-means and the
                assignment run again and equal, each shard's measured
                peak memory beside shard_build_hbm_bytes; the int8 ground
                truth for 10K queries equal to formats/accel.
                compute_groundtruth's distances on every slot; PQ (m=64,
                trained on 16,384 points) encoded on the card; in-memory search
                (K2) over the merged graph at L in {64, 128}, recall@10 >= 90.
 16. scale    — bang_tpu_torch/scripts/build_100m.py (scripts/build_100m.py's
                recipe: R=32, m=32, l_build 24, one pass, overlap 2, batch
                16384) at N=262,144 in 4 shards, block 65,536, PQ trained on
                16,384 points, 10K queries, into a temp dir, each shard's peak
                beside shard_build_hbm_bytes; run again: every stage skipped.
                BANGSearch("base") on that bundle memory-mapped (the default)
                and read into RAM at L in {30, 60, 90}: ids and steps
                identical, K1 once a device step, recall@10 >= 90 at the best
                L. Then run_eval.py's base branch once (--mmap).
 17. bench    — the port's bench (bang_tpu_torch/bench.py) through its own
                functions, on phase 4's bundle: sweep_variant for
                exactdistance (K3) and inmemory (K2) over VARIANT_CONFIGS'
                grids, refined by _refine_knee (bisected L, fewer
                extra_iters, beams 1/2/4, sampled entry), measured again
                (5 calls, 6 in flight) with the serving rows: the refined
                point's recall@10 >= 90. The breadth rows at their bench
                sizes, their bundles built under bench_data/ by three
                spawned processes started with phase 4 (their numpy PQ
                training takes minutes) and joined here: gist960 (100K x
                960 f32, m=120, K2), glove200_mips (100K x 201 f32, exact,
                scattered, no kernel), spacev_int8 (100K x 100 int8, m=50,
                K2), each refined, recall@10 >= 90. K2 against its plain
                version, timed, with bounds, at the two breadth shapes (Q=2048,
                100K rows, R=32, m=120 and m=50, beam 2). merge_bench_json on
                the phase's rows. Any failed row fails the phase.
 20. layouts  — the JAX package's last search options, on phase 4's bundle
                (after 17). The neighbor-aligned code layout
                (`neighbor_codes=True`: nbr_codes [N, R*m] u8 4.1 GB and
                adj_planes [N, 4R] u8 0.26 GB, K1 over each parent's code
                row) beside the fused (K2) and scattered (K1) layouts at
                in-memory L in {32, 64, 128}, beam 2, Q=10K, each through
                phase 18's pattern (eager, captured, captured, eager):
                ids, distances, iterations and distance computations
                identical across the three layouts, the path's kernel and
                the visited filter once a step; walls, busy shares, pools. Every pq_impl through the
                three variants (in-memory on all three layouts at L=64,
                exact fused and scattered at L=30, base at L=45): "pallas"
                and "pallas_dma" identical to "auto", "pallas_dma" without
                fused rows raising; "xla" (the f32 lookups, no kernel)
                within 1.0 recall@10 point of "auto", its share of
                identical id rows reported. BANG_MERGE_IMPL=ranked at
                fused L=128 and exact L=100: identical to the sort merge,
                and profile_base_step's merge_sort and merge_ranked ms at
                those shapes. SearchServer over the new layout, 10 requests
                of 128: identical to the fused layout's server. Then the
                three layout probes (bang_tpu_torch.scripts.exp_fused32,
                exp_gather, exp_decode at their own sizes, each counted: K2
                at R=32 m=32 bit-exact ids over 1.2M rows and timed at
                10M against the neighbor-aligned path; the seven code
                gathers at 10M; f32 against u8-packed distances), their
                times printed beside the card's name and power limit.
 21. real corpus — bang_tpu_torch/scripts/get_real_data.py (after 16) on
                two fabricated TexMex corpora in a temp dir, each in its
                DATASETS layout (.fvecs base and queries, .ivecs top-100
                ground truth from formats/accel.compute_groundtruth on the
                card): siftsmall at its published shape (10,000 x 128,
                integer values as SIFT's, 100 queries) and gist1m at GIST's
                widths (20,000 x 960 f32, 200 queries). The script runs in
                this process with --skip-download --device cuda: convert,
                true ground-truth distances, Vamana graph, PQ, then the
                harness driver's in-memory auto sweep to recall@10 90.
                K2 launched and no other kernel; rc 0; the stage seconds
                printed; the last L's best recall@10 >= 90 over true
                distances; the truthset's distances within 1e-5 relative
                of float64. The
                same ids' recall over a zero-distance truthset (the JAX
                script's) is printed beside it.
--real NAME   — not a phase: the real-corpus pipeline on a corpus
                fabricated at its published shape (sift1m: 1,000,000 x 128,
                10,000 queries, top-100 ground truth), phase 21's bars.
                Results in <out>/real_<NAME>.json (stage seconds, each L's
                walls, QPS and recall@10 under both truthsets, K2's
                launches, the card's name and power limit); no kernels
                line, no "ok" line.
--scale N     — not a phase: build_100m at N in 4 shards (the rest of its
                recipe as it is), each shard's peak beside the model; base
                through run_eval.py memory-mapped and in RAM at L in {30, 60,
                90, 128, 180, 256} (extra_iters 24, 8 sub-batches, each with
                its sampled-entry probe); a fresh mapping's first call against
                its second; the base profile at the in-RAM row's L; in-memory
                through run_eval.py; K1 and K2 at the bundle's widths against
                their plain versions, timed, with bounds. Results in
                <out>/scale_<N>*.json (--out, bench_data/scale by default);
                no kernels line, no "ok" line.
Each probe script and each search phase zeroes every launch count just
before it and reads them just after: the kernels of its path must have
launched and no other (the visited filter, which every exact-mode
traversal step launches, is counted there and checked once a step where a
phase counts steps: 18, 20 and 22). The second-to-last line is a JSON object describing
each kernel (its launches summed over those runs, its bound from this run's
byte and operation counts); the last is {"ok": true, "device": {...}}.
"""

import contextlib
import importlib
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

N, D, Q, K = 1_000_000, 128, 10_000, 10
R, M = 64, 64
# bench.py's operating points (VARIANT_CONFIGS) and Vamana settings
BEAM_EXTRA = {"inmemory": (2, 11), "exactdistance": (1, 6)}
L_SWEEP = (32, 64, 128, 256, 512)
PROFILE_L = 128  # the in-memory L whose fused search is profiled (PERF.md §5)
SCATTERED_PROFILE_L = 512  # the in-memory L whose scattered search is profiled
EXACT_L_SWEEP = (10, 16, 30, 60, 100)
EXACT_PROFILE_L = 100  # the exact L whose fused search is profiled
VAMANA = {"l_build": 48, "batch": 4096, "alpha": 1.44, "n_passes": 2, "seed": 0}
RECALL_TARGET = 90.0
# phase 22: the benchmark cells' search settings (gpubench/configs/*.json)
STATS_POINTS = (("inmemory", 40), ("exactdistance", 10))
STATS_CALLS = 5
SPIN_CYCLES = 5_000_000  # ~3 ms of the card's clock: longer than a launch's enqueue
# base: bench.py::sweep_base's operating point (bench.py:502-503), the graph
# read into RAM as in the reference's configuration
BASE_L_SWEEP = (30, 45, 60, 90)
BASE_BEAM, BASE_EXTRA, BASE_PIPELINE = 2, 16, 8
# phase 18: the captured loop against the eager loop at these points:
# (label, variant, L, fused_frontier, entry_mode, visited_mode, queries).
# Cut for the run's time limit: scattered L=512 (25.6 s; phase 20 holds the
# scattered layout's captured calls against its eager ones at L 32-128) and
# base with 8 sub-batches (42 s; phase 14 holds the chunk-sharded base's 8
# captured sub-batches against its eager step)
CAPTURED_POINTS = (
    ("inmemory fused", "inmemory", PROFILE_L, None, "medoid", "exact", Q),
    ("exact fused", "exactdistance", 10, None, "medoid", "exact", Q),
    ("exact fused", "exactdistance", EXACT_PROFILE_L, None, "medoid", "exact", Q),
    ("inmemory fused bloom", "inmemory", PROFILE_L, None, "medoid", "bloom", Q),
    ("inmemory fused sampled", "inmemory", PROFILE_L, None, "sampled", "exact", Q),
    ("exact fused sampled", "exactdistance", 10, None, "sampled", "exact", Q),
    # the serving batch at phase 12's Ls
    ("inmemory fused batch 128", "inmemory", 64, None, "medoid", "exact", 128),
    ("exact fused batch 128", "exactdistance", 30, None, "medoid", "exact", 128),
)
CAPTURED_BASE = ((90, 1),)  # (L, sub-batches)
# phase 19: the captured Vamana build at phase 4's settings on this many of
# the bench's points; the streaming index at phase 13's point
CAPTURED_BUILD_N = 100_000  # a check, not a timing: keeps the run inside its limit
# phase 11: the Ls searched in bloom mode, and the JAX package's bar for the
# recall bloom may lose against the exact mask at the same L
BLOOM_L = {"inmemory": (64, 128, 256), "exactdistance": (30, 60, 100)}
BLOOM_BASE_L = (30, 90)
BLOOM_RECALL_SLACK = 1.5
# phase 12: each variant's L for the warm-up and the probes; the server's batch
WARMUP_L = {"inmemory": 64, "exactdistance": 30, "base": 30}
SERVER_BATCH = 128
# phase 13: bench.py::streaming_row's point (bench.py:628-717)
STREAM_N, STREAM_R, STREAM_Q, STREAM_CHUNK = 200_000, 32, 2048, 4096

# phase 14: the bundle's data in SHARDS node shards (or chunk shards for
# base), each mesh on [card] * n; the node-sharded and chunk-sharded Ls. A
# shard's graph is partition.py's kNN + random edges, not Vamana: at 250K
# points in ~1000 clusters the walk finds the query's cluster through the
# random edges, so recall needs a longer walk than the bundle's graph
# (75.5 at L=64, 88.8 at L=128 on the card, PERF.md)
SHARDS = 4
SHARD_L = (128, 256)
EXACT_SHARD_L = 256
TP_BASE_L = (30, 90)
KNN_CHECK_N = 20_000  # the card's kNN graph against numpy's on this many points
# phase 20: the neighbor-aligned layout against the other two at these
# Ls; each search option's point (pq_impl through the three variants);
# the ranked merge at the two profiled searches; the server's requests
NBR_L = (32, 64, 128)
IMPL_L = {"inmemory": 64, "exactdistance": 30, "base": 45}
PQ_IMPLS = ("auto", "pallas", "pallas_dma", "xla")
# "xla" walks on f32 tables where the others read bf16 pairs: recall@10
# within this many points of "auto" (tests/test_torch_search.py's bar)
XLA_RECALL_SLACK = 1.0
NBR_SERVER_REQUESTS = 10
LAYOUT_PROBES = (("exp_fused32", {"frontier_lookup", "pq_lookup"}),
                 ("exp_gather", set()), ("exp_decode", set()))
# phase 16: scripts/build_100m.py's recipe (R=32, m=32, l_build 24, one pass,
# overlap 2, batch 16384) cut to 262,144 points in 4 shards, the generator's
# block to 65,536 and the PQ training sample to PQ_SAMPLE; base at these Ls
SCALE_N, SCALE_BLOCK, SCALE_SHARDS = 262_144, 65_536, 4
SCALE_R, SCALE_M, SCALE_LBUILD, SCALE_BATCH = 32, 32, 24, 16384
SCALE_L = (30, 60, 90)
# `--scale N`: build_100m at N in 4 shards (the rest of its recipe as it is),
# then base at these Ls (run_eval's --extra 24, 8 sub-batches) and in-memory
SCALE_RUN_L = (30, 60, 90, 128, 180, 256)
SCALE_RUN_EXTRA = 24
SCALE_RUN_IM_L = (10, 16, 24, 32, 48, 64, 96, 128)
SCALE_RUN_FIRST_TOUCH_L = 60
# phase 21: fabricated TexMex corpora through scripts/get_real_data.py, each
# in its DATASETS layout: (dataset, points, dim, queries, integer values as
# SIFT's, seed); siftsmall at its published shape, gist1m at GIST's widths
REAL_CORPORA = (("siftsmall", 10_000, 128, 100, True, 21),
                ("gist1m", 20_000, 960, 200, False, 22))
# `--real NAME`: a corpus fabricated at its published shape
REAL_RUNS = {"sift1m": (1_000_000, 128, 10_000, True, 23)}
REAL_GT_K = 100  # the TexMex ground truth's width
REAL_DIST_RTOL = 1e-5  # the truthset's f32 distances against float64
REAL_STAGES = ("convert", "distances", "graph", "pq_train", "encode")
# K1 at the code widths the sharded paths launch it with: (label, Q, C, m)
K1_WIDTHS = (
    ("the chunk-sharded base, m/4 chunks a shard", Q // BASE_PIPELINE, BASE_BEAM * R,
     M // SHARDS),
    ("the dry run's base, 1 chunk a shard", 8, 64, 1),
    ("the dry run's node shards", 8, 24, 8),
    ("phase 16's base sub-batch, R=32 m=32", Q // BASE_PIPELINE, BASE_BEAM * SCALE_R,
     SCALE_M),
)
# phase 17: the longest wait for a breadth bundle's build (started with
# phase 4; gist960's took 220.5 s alone on one H100, PERF.md)
BREADTH_BUILD_WAIT_S = 600
# the thread-count variables set to 1 in those builds' processes
BUILD_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# phase 15: the sharded build's dataset, the PQ training sample, the Ls
BIG_N = 1_000_000
PQ_SAMPLE = 16_384
BIG_L = (64, 128)

# (label, Q, N rows, R, m, beam, ids drawn below): the main path's shape,
# then the other shapes the kernels must take.
KERNEL_SHAPES = (
    ("main Q=10K R=64 m=64 beam=2", Q, N, R, M, 2, N),
    ("R=32 m=32", Q, 200_000, 32, 32, 2, 200_000),
    ("R=24 m=12 beam=4", 4096, 100_000, 24, 12, 4, 100_000),
    ("ids up to 2^30", 4096, 50_000, 64, 64, 2, 1 << 30),
    # K2's other copy paths: 4-byte and byte copies of rows whose width is
    # not a multiple of 16 (or 4), parents in groups of 3 + 2, and a table
    # so large that each parent is a group of its own
    ("R=20 m=13 beam=3 (4-byte row copies)", 4096, 50_000, 20, 13, 3, 50_000),
    ("R=15 m=9 beam=2 (byte row copies)", 4096, 50_000, 15, 9, 2, 50_000),
    ("R=64 m=64 beam=5 (parents in groups)", 4096, 100_000, 64, 64, 5, 100_000),
    ("R=64 m=200 beam=2 (a parent a group)", 2048, 20_000, 64, 200, 2, 20_000),
    # K1's groups of candidates at the scattered route's largest C (beam 16
    # x R=64: six groups of 171), and the largest table K1 and K2 take
    # (m=453: one candidate, one parent a group)
    ("R=64 m=64 beam=16 (candidates in groups)", 4096, 100_000, 64, 64, 16, 100_000),
    ("R=1 m=453 beam=16 (the largest table)", 512, 5_000, 1, 453, 16, 5_000),
)
# K3: (label, Q, N rows, R, D, beam, ids drawn below, integer queries)
EXACT_SHAPES = (
    ("main Q=10K R=64 D=128 beam=1", Q, N, R, D, 1, N, True),
    ("R=32 D=96 beam=4", 4096, 200_000, 32, 96, 4, 200_000, True),
    ("R=24 D=100 beam=2", 4096, 100_000, 24, 100, 2, 100_000, True),
    ("ids up to 2^30", 4096, 50_000, 64, 128, 2, 1 << 30, True),
    ("non-integer queries", 4096, 100_000, 64, 128, 1, 100_000, False),
    ("R=16 D=45 beam=3 (byte reads of the vectors)", 4096, 50_000, 16, 45, 3, 50_000, True),
    # K3's other copy paths: 4-byte and byte copies of rows whose width is
    # not a multiple of 16 (or 4), and a beam whose rows go in groups
    ("R=20 D=13 beam=3 (4-byte row copies)", 4096, 50_000, 20, 13, 3, 50_000, True),
    ("R=15 D=9 beam=2 (byte row copies)", 4096, 50_000, 15, 9, 2, 50_000, True),
    ("R=64 D=128 beam=16 (parents in groups)", 4096, 100_000, 64, 128, 16, 100_000, True),
)
GRAPH_REPS = 20  # the visited filter's calls in one timed CUDA graph
# the visited filter: (label, Q, beam, R, L, V = max_iters * beam); the
# first, the benchmark cell's step (gpubench sift1m-inmemory), is timed
VISITED_SHAPES = (
    ("cell L=40 beam 2", Q, 2, R, 40, 52),
    ("inmemory L=128 beam 2", Q, 2, R, 128, 140),
    ("exactdistance L=100 beam 1", Q, 1, R, 100, 106),
    ("R=24 beam 3 L=37 V=22", 4096, 3, 24, 37, 22),
    ("beam 16 L=128", 2048, 16, R, 128, 144),
    ("L=512 beam 1", Q, 1, R, 512, 562),
)
# lookup_packed/K5: (label, Q, N rows, R, m, beam, ids drawn below)
PROBE_SHAPES = (
    ("probes Q=10K R=64 m=64 beam=2", Q, N, R, M, 2, N),
    ("R=24 m=12 beam=4, ids up to 2^30", 4096, 100_000, 24, 12, 4, 1 << 30),
)
GATHER_WIDTHS = (5120, 4352, 100)  # K6: TPU-tiled, flat PQ row, ragged
# the probe scripts and the kernels each launches
PROBE_SCRIPTS = (
    ("exp_lookup", {"pq_lookup", "lookup_packed", "row_gather"}),
    ("exp_flat_lookup", {"lookup_packed", "row_gather"}),
    ("exp_flat2", {"lookup_packed", "frontier_packed", "row_gather"}),
    ("exp_fused", {"frontier_packed", "row_gather"}),
    ("exp_dma_tiled", {"row_gather", "frontier_lookup", "frontier_packed",
                       "exact_frontier"}),
)
# wrapper name -> (source, the TPU kernel it replaces, the other TPU kernels
# it replaces)
KERNEL_SOURCES = {
    "pq_lookup": ("bang_tpu_torch/csrc/pq_lookup.cu", "bang_tpu/ops/pq_pallas.py:74", []),
    "frontier_lookup": ("bang_tpu_torch/csrc/frontier_lookup.cu",
                        "bang_tpu/ops/pq_pallas.py:267", ["bang_tpu/ops/pq_pallas.py:411"]),
    "exact_frontier": ("bang_tpu_torch/csrc/exact_frontier.cu",
                       "bang_tpu/ops/pq_pallas.py:564", []),
    "lookup_packed": ("bang_tpu_torch/csrc/pq_lookup.cu", "scripts/exp_lookup.py:85",
                      ["scripts/exp_flat_lookup.py:90", "scripts/exp_flat2.py:106"]),
    "frontier_packed": ("bang_tpu_torch/csrc/frontier_packed.cu", "scripts/exp_fused.py:79",
                        ["scripts/exp_flat2.py:148"]),
    "row_gather": ("bang_tpu_torch/csrc/row_gather.cu", "scripts/exp_dma_tiled.py:71", []),
    # no TPU kernel: the JAX package leaves the visited filter to XLA
    "visited_filter": ("bang_tpu_torch/csrc/visited_filter.cu", None, []),
}
# one H100 SXM (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


_T0 = time.perf_counter()


def log(msg):
    print(f"[chip_smoke {time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card only")
    smi = _smi()
    print(smi, flush=True)
    from bang_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc}")
    log(f"device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return smi


def phase_build():
    from bang_tpu_torch.ops import _build

    t0 = time.perf_counter()
    # the kernels' sources, the captured search's WHILE node (graph_loop)
    # and the stage clock's stamp (stage_clock)
    libraries = sorted({os.path.basename(src)[: -len(".cu")]
                        for src, _, _ in KERNEL_SOURCES.values()}
                       | {"graph_loop", "stage_clock"})
    _build.build_libraries(libraries)
    for name in libraries:
        info = _build.BUILD_INFO[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines() if "ptxas info" in ln]
        log(f"built {name} in {info['seconds']:.2f}s (cached={info['cached']}): "
            + " | ".join(ptxas))
    secs = time.perf_counter() - t0
    log(f"build {secs:.2f}s")
    return secs


def _fused_inputs(gen, q, n, r, m, beam, id_hi, dev):
    from bang_tpu_torch.scripts import _common as cm

    tables = cm.tables(gen, q, m, dev)
    rows, ids = cm.fused_rows(gen, n, r, m, id_hi, dev)
    parents = torch.randint(0, n, (q, beam), generator=gen, device=dev,
                            dtype=torch.int32)
    return tables, rows, parents, ids


def _bound(result, name, nbytes, ops=0):
    """Record the least time the card could take: the larger of `nbytes`
    over the HBM rate and `ops` f32 operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    result[name]["bound_ms"] = max(t_bytes, t_ops)
    result[name]["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"bound {name}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G op -> "
        f"{result[name]['bound_ms']:.4f} ms ({result[name]['bound_by']})")


def _unique_rows(parents):
    """How many distinct rows `parents` reads: the rows a call must move."""
    return int(torch.unique(parents).numel())


def _time_ms(fn, reps=20):
    """Mean device ms per call over `reps` calls, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_of(fn):
    """A callable that replays GRAPH_REPS calls of fn captured in one CUDA
    graph (fn runs once first, outside the capture)."""
    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_REPS):
            fn()
    return graph.replay


def _time_pair(result, name, label, kern, plain, calls=1):
    """Time a kernel and its plain version in the order plain, kernel,
    kernel, plain; record the means (over `calls` calls a run of kern or
    plain)."""
    p1, k1, k2, p2 = (_time_ms(fn) / calls for fn in (plain, kern, kern, plain))
    result[name]["ms"] = (k1 + k2) / 2
    result[name]["plain_ms"] = (p1 + p2) / 2
    log(f"time {name} at {label}: kernel {k1:.4f} / {k2:.4f} ms, "
        f"plain {p1:.4f} / {p2:.4f} ms")


def phase_exact_kernel(gen, dev, result):
    """K3 against exact_frontier_plain at EXACT_SHAPES; times the first."""
    from bang_tpu_torch.ops import exact_kernels as ek
    from bang_tpu_torch.ops.l2 import decode_exact_frontier_rows
    from bang_tpu_torch.scripts import _common as cm

    for i, (label, q, n, r, d, beam, id_hi, integer) in enumerate(EXACT_SHAPES):
        rows = cm.exact_rows(gen, n, r, d, id_hi, dev)
        parents = torch.randint(0, n, (q, beam), generator=gen, device=dev,
                                dtype=torch.int32)
        if integer:
            queries = torch.randint(0, 256, (q, d), generator=gen, device=dev).float()
        else:
            queries = torch.rand((q, d), generator=gen, device=dev) * 255.0
        got_ids, got_d = ek.exact_frontier(queries, rows, parents)
        torch.cuda.synchronize()
        want_ids, want_d = ek.exact_frontier_plain(queries, rows, parents)
        if not torch.equal(got_ids, want_ids):
            raise AssertionError(f"exact_frontier {label}: ids differ")
        if id_hi > 1 << 24 and int(got_ids.max()) < 1 << 24:
            raise AssertionError(f"exact_frontier {label}: id plane 3 never set")
        err = (got_d - want_d).abs()
        if integer and d <= 128:
            if not torch.equal(got_d, want_d):
                raise AssertionError(f"exact_frontier {label}: distances not "
                                     f"bit-exact, max err {float(err.max())}")
        else:
            norms = decode_exact_frontier_rows(rows[parents.long()], r, d)[1]
            scale = (queries ** 2).sum(1, keepdim=True) + norms.amax(1, keepdim=True)
            bad = int((err > 1e-5 * want_d.abs() + 1e-5 * scale).sum())
            if bad or not torch.isfinite(got_d).all():
                raise AssertionError(f"exact_frontier {label}: {bad} distances "
                                     f"out of tolerance, max err {float(err.max())}")
        e3 = float(err.max())
        result["exact_frontier"]["max_abs_err"] = max(
            result["exact_frontier"]["max_abs_err"], e3)
        log(f"kernels exact {label}: ids exact, max abs err K3 {e3:.3g}")
        if i == 0:
            _time_pair(result, "exact_frontier", label,
                       lambda: ek.exact_frontier(queries, rows, parents),
                       lambda: ek.exact_frontier_plain(queries, rows, parents))
            c = beam * r
            _bound(result, "exact_frontier",
                   queries.numel() * 4 + _unique_rows(parents) * rows.shape[1]
                   + parents.numel() * 4 + q * c * 8, 2 * q * c * d)
        del rows, parents, queries, got_ids, got_d, want_ids, want_d, err
        torch.cuda.empty_cache()
    _k3_out_of_range(gen, dev)


def _k3_out_of_range(gen, dev):
    """K3 with parents outside [0, N): id -1 and +inf on their lanes, the
    rest bit-exact against the plain version (integer queries)."""
    from bang_tpu_torch.ops import exact_kernels as ek
    from bang_tpu_torch.scripts import _common as cm

    n = 5_000
    rows = cm.exact_rows(gen, n, R, D, n, dev)
    parents = torch.randint(0, n, (256, 2), generator=gen, device=dev, dtype=torch.int32)
    parents[::3, 0] = -1
    parents[1::3, 1] = n
    queries = torch.randint(0, 256, (256, D), generator=gen, device=dev).float()
    ids, d = ek.exact_frontier(queries, rows, parents)
    torch.cuda.synchronize()
    bad = ((parents < 0) | (parents >= n)).repeat_interleave(R, dim=1)
    want_ids, want_d = ek.exact_frontier_plain(queries, rows, parents.clamp(0, n - 1))
    cm.same("exact_frontier out-of-range ids", ids, torch.where(bad, -1, want_ids))
    cm.same("exact_frontier out-of-range dists", d,
            torch.where(bad, float("inf"), want_d))
    log("kernels K3 parents outside [0, N): id -1 and +inf, the rest as plain")


def _visited_inputs(gen, q, beam, r, l, v, dev):
    """The visited filter's inputs: ids from a small range, so candidates
    hit both lists and each other; INVALID_ID among the candidates and as
    the lists' tails; a fifth of the queries inactive and of the parents
    invalid."""
    def ids(cols):
        return torch.randint(0, max(2 * (l + v) // 3, 8), (q, cols), generator=gen,
                             device=dev, dtype=torch.int32)

    def coin(shape, p):
        return torch.rand(shape, generator=gen, device=dev) < p

    c = beam * r
    cand, wl, vis = ids(c), ids(l), ids(v)
    cand[coin((q, c), 0.05)] = -1
    wl[:, 3 * l // 4 :] = -1
    vis[:, v // 2 :] = -1
    raw = torch.rand((q, c), generator=gen, device=dev) * 1e3
    return cand, raw, wl, vis, ~coin((q, beam), 0.2), ~coin((q,), 0.2)


def phase_visited(dev, result):
    """The visited filter against its plain version at VISITED_SHAPES (the
    module docstring's `visited`); the sorted mask against its dense form
    at each; the first shape timed beside its bound."""
    from bang_tpu_torch.ops import visited

    gen = torch.Generator(device=dev).manual_seed(2)
    for i, (label, q, beam, r, l, v) in enumerate(VISITED_SHAPES):
        args = _visited_inputs(gen, q, beam, r, l, v, dev)
        new, dist = visited.visited_filter(*args, beam)
        torch.cuda.synchronize()
        want_new, want_dist = visited.visited_filter_plain(*args, beam)
        if not (torch.equal(new, want_new)
                and torch.equal(dist.view(torch.int32), want_dist.view(torch.int32))):
            raise AssertionError(
                f"visited_filter {label}: differs from the plain version on "
                f"{int((new != want_new).sum())} masks, "
                f"{int((dist.view(torch.int32) != want_dist.view(torch.int32)).sum())} "
                "distances")
        cand, _, wl, vis = args[:4]
        if not torch.equal(visited.exact_new_mask(cand, wl, vis),
                           visited.exact_new_mask_dense(cand, wl, vis)):
            raise AssertionError(f"exact_new_mask {label}: differs from the dense form")
        log(f"visited {label} (Q={q} C={beam * r} L={l} V={v}): kernel identical to "
            f"the plain version bit for bit ({float(new.float().mean()):.3f} new); "
            "the sorted mask identical to the dense form")
        if i == 0:  # in CUDA graphs: a launch takes the host longer than the kernel
            kern = _graph_of(lambda: visited.visited_filter(*args, beam))
            plain = _graph_of(lambda: visited.visited_filter_plain(*args, beam))
            _time_pair(result, "visited_filter", label, kern, plain, GRAPH_REPS)
            c = beam * r
            # read cand, raw, wl, vis, parent_valid, active; write new, dist
            _bound(result, "visited_filter", q * (8 * c + 4 * (l + v) + beam + 1 + 5 * c))
        del args, new, dist, want_new, want_dist, cand, wl, vis
    torch.cuda.empty_cache()


def _against_k6_k5(packed, rows, parents, ids, dists):
    """K2 at the main shape against K6 row_gather + K5 frontier_packed on the
    same parents and packed tables, and K1 on the codes of the same rows
    made candidate-major: identical bit for bit."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.ops import probe_kernels as prk
    from bang_tpu_torch.scripts._common import same

    q, beam = parents.shape
    m = packed.shape[1]
    r = ids.shape[1] // beam
    gathered = prk.row_gather(rows, parents.view(-1)).view(q, beam, rows.shape[1])
    ids5, d5 = prk.frontier_packed(packed, gathered, r, 4)
    codes = gathered[..., 4 * r :].reshape(q, beam, m, r).transpose(2, 3).reshape(
        q, beam * r, m)
    d1 = pk.pq_lookup(packed, codes)
    torch.cuda.synchronize()
    same("frontier_lookup vs row_gather + frontier_packed ids", ids, ids5)
    same("frontier_lookup vs row_gather + frontier_packed dists", dists, d5)
    same("pq_lookup vs row_gather + frontier_packed dists", d1, d5)
    log("kernels K2, and K1 on the same codes, identical bit for bit to K6 + K5 "
        "on the same parents")


def _k1_unaligned(packed, codes):
    """K1 on copies of `codes` 4 and 1 bytes off a 16-byte boundary (its
    4-byte and byte copy paths): bit for bit its aligned launch's sums."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts._common import same

    want = pk.pq_lookup(packed, codes)
    for off in (4, 1):
        buf = torch.empty(codes.numel() + 16, dtype=torch.uint8, device=codes.device)
        moved = buf[off : off + codes.numel()].view(codes.shape)
        moved.copy_(codes)
        got = pk.pq_lookup(packed, moved)
        torch.cuda.synchronize()
        same(f"pq_lookup codes {off} bytes off a 16-byte boundary", got, want)
    log("kernels K1 on codes 4 and 1 bytes off a 16-byte boundary: as aligned")


def _k1_empty(packed, codes):
    """K1's two wrappers on empty batches (C=0, Q=0): an empty result, and
    no launch counted, since none is made."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.ops import probe_kernels as prk

    counts = pk.launch_counts()
    before = (counts["pq_lookup"], counts["lookup_packed"])
    for wrapper in (pk.pq_lookup, prk.lookup_packed):
        for p, c in ((packed, codes[:, :0]), (packed[:0], codes[:0])):
            out = wrapper(p, c.contiguous())
            if out.shape != c.shape[:2]:
                raise AssertionError(
                    f"{wrapper.__name__} on codes {tuple(c.shape)}: "
                    f"result {tuple(out.shape)}")
    counts = pk.launch_counts()
    after = (counts["pq_lookup"], counts["lookup_packed"])
    if after != before:
        raise AssertionError(f"K1 on empty batches counted launches: {before} -> {after}")
    log("kernels K1 on empty batches (C=0, Q=0): empty results, no launch counted")


def _k2_out_of_range(gen, dev):
    """K2 with parents outside [0, N): id -1 and +inf on their lanes, the
    rest as the plain version."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts._common import dist_err, same

    tables, rows, parents, _ = _fused_inputs(gen, 256, 5_000, R, M, 2, 5_000, dev)
    parents[::3, 0] = -1
    parents[1::3, 1] = rows.shape[0]
    packed = pk.pack_tables(tables)
    ids, d = pk.frontier_lookup(packed, rows, parents)
    torch.cuda.synchronize()
    want_ids, want_d = pk.frontier_lookup_plain(packed, rows, parents)
    same("frontier_lookup out-of-range ids", ids, want_ids)
    bad = want_ids < 0
    same("frontier_lookup out-of-range lanes", torch.isinf(d), bad)
    dist_err("frontier_lookup out-of-range dists", d[~bad], want_d[~bad])
    log("kernels K2 parents outside [0, N): id -1 and +inf, the rest as plain")


def _k2_at(gen, label, q, n, r, m, beam, dev):
    """K2 against frontier_lookup_plain on random fused rows at one shape
    (ids below n): ids identical, distances within dist_err's tolerance;
    timed (plain, kernel, kernel, plain) beside its bound. Returns the
    shape's record."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts._common import dist_err

    tables, rows, parents, _ids = _fused_inputs(gen, q, n, r, m, beam, n, dev)
    packed = pk.pack_tables(tables)
    del tables
    got_ids, got_d = pk.frontier_lookup(packed, rows, parents)
    want_ids, want_d = pk.frontier_lookup_plain(packed, rows, parents)
    if not torch.equal(got_ids, want_ids):
        raise AssertionError(f"frontier_lookup at {label}: ids differ")
    rec = {"frontier_lookup": {"shape": label, "max_abs_err": dist_err(
        f"frontier_lookup at {label}", got_d, want_d)}}
    _time_pair(rec, "frontier_lookup", label,
               lambda: pk.frontier_lookup(packed, rows, parents),
               lambda: pk.frontier_lookup_plain(packed, rows, parents))
    _bound(rec, "frontier_lookup", packed.numel() * 4 + _unique_rows(parents)
           * rows.shape[1] + parents.numel() * 4 + q * beam * r * 8, q * beam * r * m)
    return rec["frontier_lookup"]


def phase_kernels(dev):
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts._common import dist_err

    gen = torch.Generator(device=dev).manual_seed(0)
    result = {name: {"max_abs_err": 0.0, "library_ms": None} for name in KERNEL_SOURCES}
    for i, (label, q, n, r, m, beam, id_hi) in enumerate(KERNEL_SHAPES):
        tables, rows, parents, ids = _fused_inputs(gen, q, n, r, m, beam, id_hi, dev)
        packed = pk.pack_tables(tables)
        del tables  # both kernels read the packed tables
        got_ids, got_d = pk.frontier_lookup(packed, rows, parents)
        torch.cuda.synchronize()
        want_ids, want_d = pk.frontier_lookup_plain(packed, rows, parents)
        if not torch.equal(got_ids, want_ids) or not torch.equal(
                got_ids, ids[parents.long()].reshape(q, -1)):
            raise AssertionError(f"frontier_lookup {label}: ids differ")
        e2 = dist_err(f"frontier_lookup {label}", got_d, want_d)

        codes = torch.randint(0, 256, (q, beam * r, m), generator=gen,
                              device=dev, dtype=torch.uint8)
        got = pk.pq_lookup(packed, codes)
        torch.cuda.synchronize()
        e1 = dist_err(f"pq_lookup {label}", got, pk.lookup_packed_plain(packed, codes))
        result["pq_lookup"]["max_abs_err"] = max(result["pq_lookup"]["max_abs_err"], e1)
        result["frontier_lookup"]["max_abs_err"] = max(
            result["frontier_lookup"]["max_abs_err"], e2)
        log(f"kernels {label}: ids exact, max abs err K1 {e1:.3g} K2 {e2:.3g}")

        if i == 0:  # time at the main path's shape
            _against_k6_k5(packed, rows, parents, got_ids, got_d)
            _k1_unaligned(packed, codes)
            _k1_empty(packed, codes)
            _time_pair(result, "pq_lookup", label,
                       lambda: pk.pq_lookup(packed, codes),
                       lambda: pk.lookup_packed_plain(packed, codes))
            _time_pair(result, "frontier_lookup", label,
                       lambda: pk.frontier_lookup(packed, rows, parents),
                       lambda: pk.frontier_lookup_plain(packed, rows, parents))
            c = beam * r
            _bound(result, "pq_lookup",
                   packed.numel() * 4 + codes.numel() + q * c * 4, q * c * m)
            _bound(result, "frontier_lookup",
                   packed.numel() * 4 + _unique_rows(parents) * rows.shape[1]
                   + parents.numel() * 4 + q * c * 8, q * c * m)
        del packed, rows, parents, ids, codes, got_ids, got_d, want_ids, want_d, got
        torch.cuda.empty_cache()
    _k2_out_of_range(gen, dev)
    phase_exact_kernel(gen, dev, result)
    return result


def _note_err(result, name, err):
    result[name]["max_abs_err"] = max(result[name]["max_abs_err"], err)
    return err


def phase_probes(dev, result):
    """lookup_packed (K1's kernel), K5 and K6 against their plain versions
    at PROBE_SHAPES and GATHER_WIDTHS; times each at the probes' shape."""
    from bang_tpu_torch.ops import probe_kernels as prk
    from bang_tpu_torch.ops.pq_kernels import pack_tables
    from bang_tpu_torch.scripts._common import dist_err, fused_rows, same, tables, u8

    gen = torch.Generator(device=dev).manual_seed(1)
    for i, (label, q, n, r, m, beam, id_hi) in enumerate(PROBE_SHAPES):
        rows, ids = fused_rows(gen, n, r, m, id_hi, dev)
        packed = pack_tables(tables(gen, q, m, dev))
        parents = torch.randint(0, n, (q * beam,), generator=gen, device=dev,
                                dtype=torch.int32)
        c, w = beam * r, (4 + m) * r
        gathered = prk.row_gather(rows, parents)
        torch.cuda.synchronize()
        same(f"row_gather {label}", gathered, prk.row_gather_plain(rows, parents))
        gathered = gathered.view(q, beam, w)

        ids5, d5 = prk.frontier_packed(packed, gathered, r, 4)
        torch.cuda.synchronize()
        want_ids, want_d = prk.frontier_packed_plain(packed, gathered, r, 4)
        same(f"frontier_packed ids {label}", ids5, want_ids)
        same(f"frontier_packed ids {label} vs adjacency", ids5,
             ids[parents.long()].reshape(q, c))
        if id_hi > 1 << 24 and int(ids5.max()) < 1 << 24:
            raise AssertionError(f"frontier_packed {label}: id plane 3 never set")
        e5 = _note_err(result, "frontier_packed",
                       dist_err(f"frontier_packed {label}", d5, want_d))
        codes_cm = gathered[..., 4 * r :].contiguous()  # v7's rows: no id planes
        ids7, d7 = prk.frontier_packed(packed, codes_cm, r, 0)
        if ids7 is not None:
            raise AssertionError("frontier_packed without id planes returned ids")
        # same entries summed in the same order as with id planes
        same(f"frontier_packed no-ids {label}", d7, d5)
        codes = codes_cm.view(q, beam, m, r).transpose(2, 3).reshape(q, c, m)
        d4 = prk.lookup_packed(packed, codes)
        torch.cuda.synchronize()
        e4 = _note_err(result, "lookup_packed",
                       dist_err(f"lookup_packed {label}", d4,
                                prk.lookup_packed_plain(packed, codes)))
        same(f"lookup_packed vs frontier_packed {label}", d4, d5)
        log(f"probes {label}: ids and gathers exact, max abs err lookup_packed "
            f"{e4:.3g} K5 {e5:.3g}")

        if i == 0:  # time at the probes' shape
            _time_pair(result, "lookup_packed", label,
                       lambda: prk.lookup_packed(packed, codes),
                       lambda: prk.lookup_packed_plain(packed, codes))
            _time_pair(result, "frontier_packed", label,
                       lambda: prk.frontier_packed(packed, gathered, r, 4),
                       lambda: prk.frontier_packed_plain(packed, gathered, r, 4))
            _time_pair(result, "row_gather", f"{q * beam} rows of {w} B",
                       lambda: prk.row_gather(rows, parents),
                       lambda: prk.row_gather_plain(rows, parents))
            lib = [_time_ms(lambda: torch.index_select(rows, 0, parents))
                   for _ in range(2)]
            result["row_gather"]["library_ms"] = sum(lib) / 2
            log(f"time torch.index_select beside row_gather: {lib[0]:.4f} / "
                f"{lib[1]:.4f} ms")
            _bound(result, "lookup_packed",
                   packed.numel() * 4 + codes.numel() + q * c * 4, q * c * m)
            _bound(result, "frontier_packed",
                   packed.numel() * 4 + gathered.numel() + q * c * 8, q * c * m)
            _bound(result, "row_gather",
                   _unique_rows(parents) * w + parents.numel() * (w + 4))
        del rows, ids, packed, parents, gathered, ids5, d5, want_ids, want_d
        del codes_cm, d7, codes, d4
        torch.cuda.empty_cache()

    n = 100_000
    for s in GATHER_WIDTHS:
        rows = u8(gen, (n, s), dev)
        parents = torch.randint(0, n // 2, (4096,), generator=gen, device=dev,
                                dtype=torch.int32) * 2 + 1  # odd rows
        parents[-2:] = torch.tensor([-1, n], dtype=torch.int32, device=dev)
        got = prk.row_gather(rows, parents)
        torch.cuda.synchronize()
        same(f"row_gather S={s}", got[:-2], prk.row_gather_plain(rows, parents[:-2]))
        if got[-2:].any():
            raise AssertionError(f"row_gather S={s}: out-of-range parents not zero")
        log(f"probes row_gather S={s}: odd parents exact, out-of-range rows zero")
        del rows, parents, got
    torch.cuda.empty_cache()


def probe_scripts(totals):
    """Run each probe script at its own sizes, its launches counted."""
    for name, launched in PROBE_SCRIPTS:
        mod = importlib.import_module(f"bang_tpu_torch.scripts.{name}")
        t0 = time.perf_counter()
        counted(f"probe {name}", launched, lambda: mod.main("cuda"), totals)
        log(f"probe {name} took {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()


def build_bundle(prefix, dev, n=N, d=D, q=Q, r=R, m=M):
    """The bench's headline bundle (bench.py build_bundle, graph='vamana'),
    built with the port's builders on `dev` (scripts/bundles.py); returns
    stage seconds."""
    from bang_tpu_torch.scripts import bundles

    t = bundles.build_bundle(prefix, n, d, r, m, "vamana", q, seed=VAMANA["seed"],
                             l_build=VAMANA["l_build"], build_batch=VAMANA["batch"],
                             device=dev)
    log(f"bundle N={n} D={d} R={r} m={m} Q={q} built in {t['total']:.1f}s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in t.items()))
    return t


def _check_output(ids, dists, queries, vectors, n):
    """Shape, range, finiteness, ascending order, and the returned distances
    against a float64 numpy recomputation on the first 200 queries."""
    if ids.shape != (len(queries), K) or ids.dtype != np.int64:
        raise AssertionError(f"ids {ids.shape} {ids.dtype}")
    if not ((ids >= 0) & (ids < n)).all() or not np.isfinite(dists).all():
        raise AssertionError("ids out of range or distances not finite")
    if (np.diff(dists, axis=1) < 0).any():
        raise AssertionError("distances not ascending")
    qs = queries[:200].astype(np.float64)
    ref = ((vectors[ids[:200]].astype(np.float64) - qs[:, None]) ** 2).sum(-1)
    if not np.allclose(dists[:200], ref, rtol=1e-6, atol=1e-3):
        raise AssertionError(f"returned distances off the reference by "
                             f"{np.abs(dists[:200] - ref).max()}")


def run_search(prefix, dev, variant, l_values, fused_frontier=None,
               entry_mode="medoid", visited_mode="exact"):
    """BANGSearch(variant) over `l_values` at bench.py's beam and
    extra_iters; one row per L (with the returned ids and the query call's
    peak memory)."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.formats.graph import load_graph_index
    from bang_tpu_torch.utils.recall import calculate_recall

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    vectors = load_graph_index(prefix).vectors
    beam, extra = BEAM_EXTRA[variant]
    s = BANGSearch(variant, device=dev)
    t0 = time.perf_counter()
    s.bang_load(prefix, fused_frontier=fused_frontier)
    ix = s._index
    fused = ix.fused_rows is not None or ix.fused_vec_rows is not None
    layout = "fused" if fused else "scattered"
    label = f"{variant} {layout} {entry_mode} {visited_mode}"
    log(f"bang_load {variant} {layout} layout in {time.perf_counter() - t0:.1f}s")
    rows = []
    for L in l_values:
        s.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra,
                                entry_mode=entry_mode, visited_mode=visited_mode)
        s.bang_alloc(len(queries))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ids, dists = s.bang_query(queries)  # host arrays: the device is done
        wall = time.perf_counter() - t0
        _check_output(ids, dists, queries, vectors, len(vectors))
        row = {"search": label, "L": L,
               "recall": calculate_recall(gt_ids, ids, K, gt_dists),
               "iters": s.last_stats.iters, "dist_comps": s.last_stats.n_dist_comps,
               "wall_s": wall, "qps": len(queries) / wall, "ids": ids,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"search {label} L={L} recall@10={row['recall']:.2f} "
            f"iters={row['iters']} dist_comps={row['dist_comps']} wall={wall:.4f}s "
            f"qps={row['qps']:.1f} peak={row['peak_gb']:.2f}GB")
        rows.append(row)
    s.bang_unload()
    torch.cuda.empty_cache()
    return rows


def profile_search(prefix, dev, variant, L, fused_frontier=None, visited_mode="exact"):
    """BANGSearch(variant) at L on the layout `fused_frontier` picks (the
    fused one by default): three timed calls of the captured loop, then one
    under torch.profiler (kernel device ms by name, the device's busy share
    over the call's wall, peak memory). Then the eager loop (its plain
    version) under torch.profiler: the device ms of each traversal stage
    (exp_iter_profile.PROFILE_STAGES), which a graph replay cannot split;
    in bloom mode also the filter's ms a step (hash, query and insert)."""
    from torch.profiler import ProfilerActivity, profile

    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.formats.bin_io import load_bin
    from bang_tpu_torch.models import compiled, exactdistance, inmemory
    from bang_tpu_torch.scripts import exp_iter_profile as eip

    queries = load_bin(prefix + "_query.bin", np.uint8)
    beam, extra = BEAM_EXTRA[variant]
    s = BANGSearch(variant, device=dev)
    s.bang_load(prefix, fused_frontier=fused_frontier)
    ix = s._index
    layout = ("fused" if ix.fused_rows is not None or ix.fused_vec_rows is not None
              else "scattered")
    s.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra,
                            visited_mode=visited_mode)
    s.bang_alloc(len(queries))
    label = f"profile {variant} {layout} L={L} {visited_mode}"
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.bang_query(queries)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.bang_query(queries)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} captured: {s.last_stats.iters} iterations; walls of 3 timed calls "
        + " / ".join(f"{w:.4f}" for w in walls) + f" s; profiled call {wall:.4f} s")
    total, _, _ = eip.read_profile(prof, label + " captured", ())
    log(f"{label} captured: kernels {total:.3f} ms in a {wall * 1e3:.3f} ms wall, busy "
        f"{total / (wall * 1e3):.1%}; peak {peak / 1e9:.2f} GB")

    eager = (inmemory.search_inmemory_eager if variant == "inmemory"
             else exactdistance.search_exact_eager)
    q = torch.as_tensor(queries)
    label = f"profile {variant} {layout} L={L} eager {visited_mode}"
    with eip.traversal_stages():
        compiled.readback(*eager(ix, q, s._params)[:2])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            compiled.readback(*eager(ix, q, s._params)[:2])
            wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total, stages, _ = eip.read_profile(prof, label, eip.PROFILE_STAGES)
    log(f"{label}: kernels {total:.3f} ms in a {wall * 1e3:.3f} ms wall, busy "
        f"{total / (wall * 1e3):.1%}; peak {peak / 1e9:.2f} GB")
    if visited_mode == "bloom":
        ms = sum(stages.get(name, (0.0, 0))[0] for name in eip.BLOOM_STAGES)
        steps = stages.get("bloom_query", (0.0, 0))[1]
        if not steps:
            raise AssertionError(f"{label}: the bloom filter was never queried")
        log(f"{label}: bloom hash + query + insert {ms:.3f} ms over {steps} "
            f"steps, {ms / steps:.4f} ms a step")
    s.bang_unload()
    torch.cuda.empty_cache()


def run_base(prefix, dev, l_values, n_pipeline_batches=BASE_PIPELINE,
             entry_mode="medoid", visited_mode="exact", mmap=False):
    """BANGSearch("base") over `l_values` at bench.py::sweep_base's beam and
    extra_iters, the graph read into RAM (mmap=True: memory-mapped, the
    facade's default), ENABLE_GPU_STATS on; one row per L
    (the returned ids, device steps, readback waits, stage ms, the query
    call's peak memory). Returns
    (rows, steps): every device step of these calls, the warm-ups of
    bang_alloc included."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.constants import ENABLE_GPU_STATS
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.utils.recall import calculate_recall

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    s = BANGSearch("base", device=dev)
    t0 = time.perf_counter()
    s.bang_load(prefix, mmap=mmap, n_pipeline_batches=n_pipeline_batches)
    searcher = s._searcher
    vectors = searcher.raw[:, : searcher.vec_bytes]  # u8 data: the vectors' bytes
    label = (f"base pipeline={n_pipeline_batches} {entry_mode} {visited_mode}"
             + " mmap" * mmap)
    log(f"bang_load base in {time.perf_counter() - t0:.1f}s: "
        f"{searcher.raw.nbytes / 1e6:.1f} MB of records "
        f"{'memory-mapped' if mmap else 'in host RAM'}, "
        f"{searcher.codes.numel() / 1e6:.1f} MB of codes on the card")
    rows, steps = [], 0
    for L in l_values:
        s.bang_set_searchparams(K, L, beam_width=BASE_BEAM, extra_iters=BASE_EXTRA,
                                entry_mode=entry_mode, visited_mode=visited_mode,
                                capabilities=ENABLE_GPU_STATS)
        s.bang_alloc(len(queries))
        steps += searcher.last_n_steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ids, dists = s.bang_query(queries)  # host arrays: the device is done
        wall = time.perf_counter() - t0
        steps += searcher.last_n_steps
        _check_output(ids, dists, queries, vectors, len(vectors))
        row = {"search": label, "L": L,
               "recall": calculate_recall(gt_ids, ids, K, gt_dists),
               "steps": searcher.last_n_steps, "d2h": searcher.last_n_d2h,
               "stages": dict(searcher.timers.ms), "wall_s": wall,
               "qps": len(queries) / wall, "ids": ids,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"search {label} L={L} recall@10={row['recall']:.2f} "
            f"steps={row['steps']} d2h waits={row['d2h']} wall={wall:.4f}s "
            f"qps={row['qps']:.1f} peak={row['peak_gb']:.2f}GB; stage ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in row["stages"].items()))
        rows.append(row)
    s.bang_unload()
    torch.cuda.empty_cache()
    return rows, steps


def _k1_per_step(label, steps):
    """K1 launched once per device step of the phase just counted."""
    from bang_tpu_torch.ops import pq_kernels as pk

    k1 = pk.launch_counts()["pq_lookup"]
    if k1 != steps:
        raise AssertionError(f"{label}: K1 launched {k1} times "
                             f"for {steps} device steps")
    log(f"{label}: K1 launches {steps} = device steps dispatched")


def host_gather_alone(prefix, dev):
    """The native host gather alone (bench.py:610-617) on one sub-batch's
    parents (Q/8 x beam random ids) and on the serial call's (Q x beam),
    into pinned buffers as the pipeline calls it, at the automatic thread
    count (native.ROWS_PER_THREAD) and at 1, 2, 4 and 8 threads, each twice
    in the order 1, 2, 4, 8, auto, auto, 8, 4, 2, 1: ms per call over 10
    calls after one warm-up. Returns the automatic count's mean ms on one
    sub-batch."""
    from bang_tpu_torch.models.base import BaseVariantSearcher

    searcher = BaseVariantSearcher(prefix, n_pipeline_batches=BASE_PIPELINE,
                                   mmap=False, device=dev)
    m = searcher.meta
    rng = np.random.default_rng(0)
    pin = dev.type == "cuda"
    out = None
    for rows in (Q // BASE_PIPELINE * BASE_BEAM, Q * BASE_BEAM):
        parents = rng.integers(0, m.n, rows).astype(np.int32)
        nbrs = torch.empty((rows, m.degree), dtype=torch.int32, pin_memory=pin)
        vecs = torch.empty((rows, searcher.vec_bytes), dtype=torch.uint8,
                           pin_memory=pin)
        times = {}  # thread count -> ms, in the order 1 .. 8, auto, auto .. 1
        for threads in (1, 2, 4, 8, 0, 0, 8, 4, 2, 1):
            searcher.n_threads = threads
            searcher._host_gather(parents, nbrs.numpy(), vecs.numpy())  # warm
            t0 = time.perf_counter()
            for _ in range(10):
                searcher._host_gather(parents, nbrs.numpy(), vecs.numpy())
            times.setdefault(threads, []).append((time.perf_counter() - t0) / 10 * 1e3)
        log(f"host gather alone, {rows} parents "
            f"({rows * (m.degree * 4 + searcher.vec_bytes) / 1e6:.2f} MB out): "
            + ", ".join(f"{'auto' if t == 0 else t} threads "
                        + " / ".join(f"{ms:.4f}" for ms in v) + " ms"
                        for t, v in times.items()))
        out = sum(times[0]) / 2 if out is None else out
    return out


def phase_base(prefix, dev, totals):
    """Phase 10 on the bundle at `prefix`; adds its launch counts (not the
    profiled call's) to `totals`."""
    from bang_tpu_torch.scripts.profile_base_step import profile_base

    rows, steps = counted("search base", {"pq_lookup"},
                          lambda: run_base(prefix, dev, BASE_L_SWEEP), totals)
    _k1_per_step("search base", steps)
    best = _best(rows, "base")
    (serial,), steps = counted(
        "search base serial", {"pq_lookup"},
        lambda: run_base(prefix, dev, (best["L"],), n_pipeline_batches=1), totals)
    _k1_per_step("search base serial", steps)
    same = (serial["ids"] == best["ids"]).all(axis=1)
    if not same.all():
        raise AssertionError(f"base L={best['L']}: one sub-batch's ids differ from "
                             f"the pipelined run's on {int((~same).sum())} queries")
    log(f"base L={best['L']}: ids of 1 and {BASE_PIPELINE} sub-batches identical "
        f"on all {len(same)} queries; wall {serial['wall_s']:.4f} s serial, "
        f"{best['wall_s']:.4f} s pipelined: speedup "
        f"{serial['wall_s'] / best['wall_s']:.3f}")
    (samp,), steps = counted(
        "search base sampled", {"pq_lookup"},
        lambda: run_base(prefix, dev, (best["L"],), entry_mode="sampled"), totals)
    _k1_per_step("search base sampled", steps)
    log(f"entry at L={best['L']}: base sampled recall@10 {samp['recall']:.2f} steps "
        f"{samp['steps']} | medoid recall@10 {best['recall']:.2f} steps {best['steps']}")
    if samp["recall"] < RECALL_TARGET:
        raise AssertionError(f"base sampled: recall@10 {samp['recall']:.2f} "
                             f"< {RECALL_TARGET}")
    pure = host_gather_alone(prefix, dev)
    in_loop = best["stages"]["host_gather"] / best["steps"]
    log(f"host gather per step: {pure:.4f} ms alone, {in_loop:.4f} ms in the loop "
        f"(L={best['L']})")
    for captured in (False, True):
        profile_base(prefix, dev, best["L"], BASE_BEAM, BASE_EXTRA, BASE_PIPELINE, K,
                     captured=captured)
    return best, rows


@contextlib.contextmanager
def _host_waits(inside=()):
    """Count the host's blocking waits on the card while on: reads of a
    CUDA tensor (bool, int, float, item, tolist, cpu) and synchronize calls
    (device, stream, event). Yields a two-item list: the waits made outside
    the functions `inside` ((owner, name) pairs, wrapped while on), then
    those made inside them."""
    count, saved, depth = [0, 0], [], [0]

    def wrap(owner, name, cuda_tensor):
        orig = getattr(owner, name)

        def counted(*args, **kwargs):
            if not cuda_tensor or args[0].is_cuda:
                count[depth[0] > 0] += 1
            return orig(*args, **kwargs)

        saved.append((owner, name, orig))
        setattr(owner, name, counted)

    def enter(owner, name):
        orig = getattr(owner, name)

        def entered(*args, **kwargs):
            depth[0] += 1
            try:
                return orig(*args, **kwargs)
            finally:
                depth[0] -= 1

        saved.append((owner, name, orig))
        setattr(owner, name, entered)

    for name in ("__bool__", "__int__", "__float__", "item", "tolist", "cpu"):
        wrap(torch.Tensor, name, True)
    for owner in (torch.cuda.Event, torch.cuda.Stream):
        wrap(owner, "synchronize", False)
    wrap(torch.cuda, "synchronize", False)
    for owner, name in inside:
        enter(owner, name)
    try:
        yield count
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def _launches():
    from bang_tpu_torch.ops import pq_kernels as pk

    return pk.launch_counts()


def _delta(before):
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


def _step_launches(kernel, steps, visited_mode="exact"):
    """The launches of a captured search of `steps` steps: its path's
    kernel (None: none) once a step, and in exact mode the visited filter
    once a step."""
    want = {} if kernel is None else {kernel: steps}
    if visited_mode == "exact":
        want["visited_filter"] = steps
    return want


_PROFILER_STARTED = []


def _start_profiler(dev):
    """Open and close one torch.profiler session on `dev` before the first
    CUDA graph is captured: a graph captured before the process's first
    session lists almost none of its kernels in later traces (7.0 of ~97 ms
    at fused L=128, even after a discarded session; graphs captured after
    the first session list them all; measured on one H100)."""
    from torch.profiler import ProfilerActivity, profile

    if not _PROFILER_STARTED:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize(dev)
        _PROFILER_STARTED.append(True)


def _profiled_busy(fn):
    """(kernel ms, busy ms: the union of kernel intervals, wall ms) of one
    synchronised call of fn under torch.profiler; busy None when the trace
    holds no kernel (kernels launched from a graph may not be listed)."""
    from torch.profiler import ProfilerActivity, profile

    from bang_tpu_torch.scripts import exp_iter_profile as eip

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    try:
        busy = eip.busy_ms(prof, ())
    except AssertionError:
        busy = None
    return total, busy, wall


def _busy_text(prof):
    total, busy, wall = prof
    share = "not measured (no kernel in the trace)" if busy is None else f"{busy / wall:.1%}"
    return f"kernels {total:.3f} ms, busy {share} of a {wall:.3f} ms wall"


def _hbm_call(fn, index, queries, params):
    """One search call through fn and the readback: ids, distances, the
    counters, the kernels it launched (counted by the kernels on the card),
    wall, blocking waits, peak GB allocated and reserved."""
    from bang_tpu_torch.models import compiled

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _launches()
    with _host_waits() as waits:
        t0 = time.perf_counter()
        ids, dists, stats = fn(index, queries, params)
        ids, dists, values = compiled.readback(ids, dists, stats.device_values())
        wall = time.perf_counter() - t0
    stats.sync(values.tolist())
    return {"ids": ids.numpy().copy(), "dists": dists.numpy().copy(),
            "iters": stats.iters, "dist_comps": stats.n_dist_comps,
            "launches": _delta(before), "wall_s": wall, "waits": waits[0],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _peak_reserved_gb(fn):
    """GB the allocator held at most during one synchronised call of fn,
    started from an emptied cache: the memory a call needs beside what
    stays allocated (a captured loop's pool stays reserved throughout)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_reserved() / 1e9


def _same_result(label, a, b, keys=("ids", "dists", "iters", "dist_comps")):
    """Raise unless the two calls' `keys` are identical."""
    for key in keys:
        same = (np.array_equal(a[key], b[key]) if isinstance(a[key], np.ndarray)
                else a[key] == b[key])
        if not same:
            rows = (f" on {int((a[key] != b[key]).any(1).sum())} queries"
                    if key in ("ids", "dists") else f": {a[key]} vs {b[key]}")
            raise AssertionError(f"{label}: {key} differ{rows}")


def _same_run(label, a, b, keys):
    """Raise unless the eager call `a` and the captured call `b` agree."""
    _same_result(f"captured {label}, the eager against the captured loop", a, b, keys)


def _captured_point(index, variant, L, entry_mode, visited_mode, queries, label):
    """One search point: the key's first call (the eager loop, then the
    capture), then eager, captured, captured, eager calls (ids, distances,
    iterations, distance computations and kernel launches identical; the
    path's kernel once a step, and in exact mode the visited filter), then
    one profiled call of each."""
    from bang_tpu_torch.models import compiled, exactdistance, inmemory
    from bang_tpu_torch.utils.config import SearchParams

    fns = {"inmemory": (inmemory.search_inmemory_eager, inmemory.search_inmemory),
           "exactdistance": (exactdistance.search_exact_eager,
                             exactdistance.search_exact)}[variant]
    beam, extra = BEAM_EXTRA[variant]
    params = SearchParams(L=L, k=K, beam_width=beam, extra_iters=extra,
                          entry_mode=entry_mode, visited_mode=visited_mode)
    q = torch.as_tensor(queries)
    t0 = time.perf_counter()
    compiled.readback(fns[1](index, q, params)[0])
    first = time.perf_counter() - t0
    loop = compiled.graph_cache(index).loops[0]
    runs = {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        runs[kind].append(_hbm_call(fns[kind == "captured"], index, q, params))
    e, c = runs["eager"][0], runs["captured"][0]
    keys = ("ids", "dists", "iters", "dist_comps", "launches")
    _same_run(f"{label} L={L}", e, c, keys)
    _same_run(f"{label} L={L} (second calls)", runs["eager"][1], runs["captured"][1],
              keys)
    kernel = {"inmemory": "frontier_lookup", "exactdistance": "exact_frontier"}[variant]
    if index.fused_rows is None and variant == "inmemory":
        kernel = "pq_lookup"
    if c["launches"] != _step_launches(kernel, c["iters"] - 1, visited_mode):
        raise AssertionError(f"captured {label} L={L}: launches {c['launches']}, "
                             f"expected {kernel} (and in exact mode the visited "
                             f"filter) once in each of {c['iters'] - 1} steps")
    calls = {kind: lambda fn=fns[kind == "captured"]: compiled.readback(
        *fn(index, q, params)[:2]) for kind in ("eager", "captured")}
    # peak reserved: captured with its pool; eager with the graphs dropped,
    # as a process that never captures; then the capture again
    reserved = {"captured": _peak_reserved_gb(calls["captured"])}
    compiled.drop_graphs(index)
    reserved["eager"] = _peak_reserved_gb(calls["eager"])
    calls["captured"]()
    prof = {kind: _profiled_busy(call) for kind, call in calls.items()}
    walls = {k: " / ".join(f"{r['wall_s']:.4f}" for r in v) for k, v in runs.items()}
    log(f"captured {label} L={L} Q={q.shape[0]}: ids, distances, iterations "
        f"({c['iters']}), distance "
        f"computations ({c['dist_comps']}) and launches {c['launches']} identical to "
        f"the eager loop's; walls eager {walls['eager']} s, captured {walls['captured']}"
        f" s; host waits a call eager {e['waits']}, captured {c['waits']}; peak GB "
        f"allocated eager {e['peak_gb']:.2f}, captured {c['peak_gb']:.2f} (the pool's "
        f"live tensors included); peak GB reserved eager {reserved['eager']:.2f}, "
        f"captured {reserved['captured']:.2f}; graph pool {loop.graph_bytes / 1e9:.2f}"
        f" GB (" + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in loop.part_bytes.items())
        + f"); capture {loop.capture_s:.3f} s (first call, "
        f"eager loop + capture: {first:.3f} s); eager {_busy_text(prof['eager'])}; "
        f"captured {_busy_text(prof['captured'])}")
    return {"label": label, "L": L, "iters": c["iters"], "walls": runs, "prof": prof,
            "capture_s": loop.capture_s, "graph_gb": loop.graph_bytes / 1e9,
            "part_gb": {k: v / 1e9 for k, v in loop.part_bytes.items()},
            "reserved_gb": reserved}


def _base_call(searcher, queries, params):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _launches()
    with _host_waits() as waits:
        t0 = time.perf_counter()
        ids, dists = searcher.search(queries, params)
        wall = time.perf_counter() - t0
    return {"ids": ids, "dists": dists, "steps": searcher.last_n_steps,
            "d2h": searcher.last_n_d2h, "launches": _delta(before), "wall_s": wall,
            "waits": waits[0], "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _captured_base(prefix, dev, L, n_pipe, queries):
    """Base at L with n_pipe sub-batches, the graph in RAM: one searcher on
    the eager step, one capturing its sub-batches (its first call runs the
    eager step, then captures); calls in the order eager, captured,
    captured, eager: ids, distances, steps, readback waits and K1 launches
    (one a step) identical; one profiled call of each."""
    from bang_tpu_torch.models.base import BaseVariantSearcher
    from bang_tpu_torch.utils.config import SearchParams

    params = SearchParams(L=L, k=K, beam_width=BASE_BEAM, extra_iters=BASE_EXTRA)
    searchers = {"eager": BaseVariantSearcher(prefix, n_pipe, mmap=False, device=dev),
                 "captured": BaseVariantSearcher(prefix, n_pipe, mmap=False, device=dev)}
    searchers["eager"].captured = False
    t0 = time.perf_counter()
    for s in searchers.values():
        s.search(queries, params)
    first = time.perf_counter() - t0
    subs = searchers["captured"]._subs
    captures = (" / ".join(f"{sb.capture_s:.3f}" for sb in subs) + " s, graph pools "
                f"{sum(sb.graph_bytes for sb in subs) / 1e9:.3f} GB in all")
    del subs  # drop_graphs below must free them
    runs = {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        runs[kind].append(_base_call(searchers[kind], queries, params))
    e, c = runs["eager"][0], runs["captured"][0]
    label = f"base L={L} {n_pipe} sub-batches"
    _same_run(label, e, c, ("ids", "dists", "steps", "d2h", "launches"))
    if c["launches"] != {"pq_lookup": c["steps"]}:
        raise AssertionError(f"captured {label}: launches {c['launches']} for "
                             f"{c['steps']} steps")
    calls = {k: lambda s=s: s.search(queries, params) for k, s in searchers.items()}
    # peak reserved: captured with its pools; eager with them dropped (as a
    # process that never captures); then the captures again
    reserved = {"captured": _peak_reserved_gb(calls["captured"])}
    searchers["captured"].drop_graphs()
    reserved["eager"] = _peak_reserved_gb(calls["eager"])
    calls["captured"]()
    prof = {k: _profiled_busy(call) for k, call in calls.items()}
    walls = {k: " / ".join(f"{r['wall_s']:.4f}" for r in v) for k, v in runs.items()}
    log(f"captured {label}: ids, distances, steps ({c['steps']}: one replay each), "
        f"readback waits ({c['d2h']}) and launches {c['launches']} identical to the "
        f"eager step's; walls eager {walls['eager']} s, captured {walls['captured']} s;"
        f" host waits a call eager {e['waits']}, captured {c['waits']}; peak GB "
        f"allocated eager {e['peak_gb']:.2f}, captured {c['peak_gb']:.2f}; peak GB "
        f"reserved eager {reserved['eager']:.2f}, captured {reserved['captured']:.2f};"
        f" capture {captures} (both searchers' first calls {first:.3f} s); eager "
        f"{_busy_text(prof['eager'])}; captured {_busy_text(prof['captured'])}")
    del searchers
    torch.cuda.empty_cache()
    return {"label": label, "walls": runs, "prof": prof}


def phase_captured(prefix, dev, points=CAPTURED_POINTS, base=CAPTURED_BASE):
    """Phase 18: the captured loop (models/compiled.py; base's captured
    step) against the eager loop, its plain version, at `points` and
    `base`; the 4-shard sharded search's check runs in phase 14, where its
    shards are built. Returns the rows."""
    from bang_tpu_torch.formats.bin_io import load_bin
    from bang_tpu_torch.models.index import device_index_from_files

    queries = load_bin(prefix + "_query.bin", np.uint8)
    _start_profiler(dev)
    rows, indexes = [], {}
    for label, variant, L, fused, entry_mode, visited_mode, nq in points:
        key = (variant, fused)
        if key not in indexes:
            indexes.clear()
            torch.cuda.empty_cache()
            indexes[key] = device_index_from_files(prefix, dev, variant,
                                                   fused_frontier=fused)
        rows.append(_captured_point(indexes[key], variant, L, entry_mode, visited_mode,
                                    queries[:nq], label))
    indexes.clear()
    torch.cuda.empty_cache()
    for L, n_pipe in base:
        rows.append(_captured_base(prefix, dev, L, n_pipe, queries))
    return rows


@contextlib.contextmanager
def _recorded(owner, name, out):
    """Wrap owner.name while on: each call's result is appended to `out`."""
    orig = getattr(owner, name)

    def recording(*args, **kwargs):
        result = orig(*args, **kwargs)
        out.append(result)
        return result

    setattr(owner, name, recording)
    try:
        yield out
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def _captures_recorded():
    """Record each CapturedLoop made while on: (capture s, pool bytes)."""
    from bang_tpu_torch.models import compiled

    out, init = [], compiled.CapturedLoop.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        out.append((self.capture_s, self.graph_bytes))

    compiled.CapturedLoop.__init__ = recording
    try:
        yield out
    finally:
        compiled.CapturedLoop.__init__ = init


def _vamana_build(vectors, medoid, dev, eager):
    """One build of `vectors` (on the card) at phase 4's settings, verbose
    (the heartbeat on), through build_vamana_graph (captured) or
    build_vamana_graph_eager: adj, degrees, the dropped count of every
    batch, wall, host waits (outside the eager loops and the captures, and
    inside them), captures and peak GB."""
    from bang_tpu_torch.formats import vamana
    from bang_tpu_torch.models import compiled

    fn = vamana.build_vamana_graph_eager if eager else vamana.build_vamana_graph
    kw = {k: VAMANA[k] for k in ("l_build", "batch", "alpha", "n_passes", "seed")}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with _recorded(vamana, "_insert_batch", []) as dropped, _captures_recorded() as caps, \
            _host_waits(inside=((compiled, "run_eager"),
                                (compiled.CapturedLoop, "__init__"))) as waits:
        t0 = time.perf_counter()
        adj, deg, _ = fn(vectors, R, dev, medoid=medoid, return_device=True,
                         verbose=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"adj": adj, "deg": deg, "dropped": torch.stack(dropped).cpu().numpy(),
            "wall_s": wall, "waits": list(waits), "captures": caps,
            "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9}


def _captured_build(dev):
    """Phase 19, the build: build_vamana_graph on CAPTURED_BUILD_N points of
    the bench's data (bundles.build_bundle's clustered u8 recipe at that N)
    at phase 4's settings, eager, captured,
    captured, eager: adj, degrees and every batch's dropped count identical
    (u8 data: every distance an integer below 2^24); the captured builds'
    host waits outside their eager first batches and their captures equal
    to the heartbeats plus two synchronises (the build's last, verbose,
    and the wall's)."""
    from bang_tpu_torch.formats.synthetic import make_clustered_data, medoid_of

    n = CAPTURED_BUILD_N
    vectors = make_clustered_data(n, D, n_clusters=max(64, min(4096, n // 1000)),
                                  dtype=np.uint8, seed=VAMANA["seed"])
    medoid = medoid_of(vectors)
    vec_dev = torch.as_tensor(vectors, device=dev)
    runs = {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        runs[kind].append(_vamana_build(vec_dev, medoid, dev, kind == "eager"))
    ref = runs["eager"][0]
    for kind, rows in runs.items():
        for i, run in enumerate(rows):
            same = (torch.equal(run["adj"], ref["adj"]) and torch.equal(run["deg"], ref["deg"])
                    and np.array_equal(run["dropped"], ref["dropped"]))
            if not same:
                raise AssertionError(f"captured build: {kind} build {i} differs from the "
                                     "first eager build (adjacency, degrees or dropped)")
    n_batches = -(-CAPTURED_BUILD_N // VAMANA["batch"])
    heartbeats = VAMANA["n_passes"] * len(range(0, n_batches, 100))
    for run in runs["captured"]:
        if run["waits"][0] != heartbeats + 2:
            raise AssertionError(f"captured build: {run['waits'][0]} host waits outside "
                                 f"the first batches and the captures, expected "
                                 f"{heartbeats} heartbeats + the build's final synchronise"
                                 f" + the wall's")
        if len(run["captures"]) != VAMANA["n_passes"]:
            raise AssertionError(f"captured build: {len(run['captures'])} captures for "
                                 f"{VAMANA['n_passes']} passes")
    e, c = runs["eager"][0], runs["captured"][0]
    walls = {k: " / ".join(f"{r['wall_s']:.3f}" for r in v) for k, v in runs.items()}
    log(f"captured build N={CAPTURED_BUILD_N} R={R} l_build {VAMANA['l_build']} batch "
        f"{VAMANA['batch']} {VAMANA['n_passes']} passes: adj, degrees and the dropped "
        f"counts of all {len(e['dropped'])} batches (sum {int(e['dropped'].sum())}) "
        f"identical; walls eager {walls['eager']} s, captured {walls['captured']} s; "
        f"blocking host waits a build eager {sum(e['waits'])} ({e['waits'][1]} in its "
        f"eager loops), captured {sum(c['waits'])} ({c['waits'][1]} in each pass's first "
        f"batch and the captures, {c['waits'][0]} = {heartbeats} heartbeats + the "
        f"build's final synchronise + the wall's); captures " + ", ".join(
            f"{cs:.3f} s pool {gb / 1e9:.3f} GB" for cs, gb in c["captures"])
        + f"; peak GB above the vectors eager {e['peak_gb']:.3f}, captured "
        f"{c['peak_gb']:.3f}")
    prof = _insert_busy(vec_dev, e["adj"], e["deg"], medoid, dev)
    log(f"captured build: one batch of {VAMANA['batch']} inserted into the built graph, "
        f"eager {_busy_text(prof['eager'])}; captured {_busy_text(prof['captured'])}")
    return {"walls": runs, "prof": prof}


def _insert_busy(vectors, adj, deg, medoid, dev):
    """One insert batch (phase 4's batch and settings, the last pass's
    alpha) into a copy of the built graph, profiled on the eager insert and
    on the captured one (after the key's eager call and its capture):
    _profiled_busy of each."""
    from bang_tpu_torch.formats import vamana
    from bang_tpu_torch.models import compiled
    from bang_tpu_torch.ops.l2 import squared_norms

    n = vectors.shape[0]
    graph = {kind: (torch.cat([adj, torch.full((1, R), n, dtype=adj.dtype, device=dev)]),
                    torch.cat([deg, deg.new_zeros(1)])) for kind in ("eager", "captured")}
    norms = squared_norms(vectors)
    gen = torch.Generator(device="cpu").manual_seed(5)
    p_ids = torch.randperm(n, generator=gen)[: VAMANA["batch"]].to(torch.int32).to(dev)
    med = torch.full((), medoid, dtype=torch.int32, device=dev)
    kw = dict(r=R, alpha=VAMANA["alpha"], l=VAMANA["l_build"],
              max_iters=VAMANA["l_build"] + 16, k_overflow=max(512, VAMANA["batch"]),
              max_in=R)
    cache = compiled.GraphCache()

    def captured():
        return vamana._insert_batch(*graph["captured"], vectors, norms, p_ids, med,
                                    cache=cache, **kw)

    captured()  # the key's eager call
    captured()  # its capture and first launch
    prof = {"eager": _profiled_busy(lambda: vamana._insert_batch(
                *graph["eager"], vectors, norms, p_ids, medoid, **kw)),
            "captured": _profiled_busy(captured)}
    cache.clear()
    return prof


def _streaming_step(label, ixs, what, fn, walls):
    """fn(index) on the eager index, then the captured one (their states
    compared after), each wall recorded under `what`."""
    out = {}
    for kind in ("eager", "captured"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[kind] = fn(ixs[kind])
        torch.cuda.synchronize()
        walls[kind].setdefault(what, []).append(time.perf_counter() - t0)
    _same_states(label, ixs)
    return out


def _same_states(label, ixs):
    e, c = ixs["eager"], ixs["captured"]
    cap = e.capacity  # the trash row past it takes the dropped writes, in any order
    same = (torch.equal(e.adj[:cap], c.adj[:cap])
            and torch.equal(e.degrees[:cap], c.degrees[:cap])
            and torch.equal(e.deleted, c.deleted) and e.medoid == c.medoid
            and (e.hwm, e.free, e.n_tombstones) == (c.hwm, c.free, c.n_tombstones))
    if not same:
        raise AssertionError(f"captured streaming: the states differ after {label}")


def _streaming_search(label, ixs, queries, params, walls):
    """Searches in the order eager, captured, captured, eager: ids and
    distances identical."""
    got = []
    for kind in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got.append(ixs[kind].search(queries, params))
        walls[kind].setdefault(f"search {label}", []).append(time.perf_counter() - t0)
    for ids, dists in got[1:]:
        if not (np.array_equal(ids, got[0][0]) and np.array_equal(dists, got[0][1])):
            raise AssertionError(f"captured streaming: search {label}: ids or distances "
                                 "differ between the eager and the captured index")
    return got[0][0]


def _captured_streaming(dev):
    """Phase 19, streaming: two StreamingIndexes at phase 13's point, one on
    the eager loop (`captured` False), one captured; every insert made on
    both, their states identical after each; searches (2,048 queries, L=64,
    beam 2) identical before the churn, after the delete, after the
    consolidate (the medoid among the victims: a re-election) and after the
    re-insert into the freed slots."""
    from bang_tpu_torch.formats.synthetic import make_clustered_data
    from bang_tpu_torch.models.streaming import StreamingIndex

    n, chunk = STREAM_N, STREAM_CHUNK
    rng = np.random.default_rng(11)
    pts = make_clustered_data(n, D, n_clusters=max(64, n // 1000), dtype=np.float32,
                              seed=11)
    queries = (pts[rng.integers(0, n, STREAM_Q)]
               + rng.normal(0, 0.05, (STREAM_Q, D)).astype(np.float32))
    ixs = {kind: StreamingIndex(capacity=n + chunk, dim=D, r=STREAM_R, l_build=32,
                                device=dev) for kind in ("eager", "captured")}
    ixs["eager"].captured = False
    walls = {"eager": {}, "captured": {}}
    with _captures_recorded() as caps:
        _streaming_churn(ixs, pts, queries, walls, rng)
    log("captured streaming: captures " + ", ".join(
        f"{cs:.3f} s pool {gb / 1e9:.3f} GB" for cs, gb in caps))
    for ix in ixs.values():
        ix.drop_graphs()
    del ixs
    torch.cuda.empty_cache()
    return walls


def _streaming_churn(ixs, pts, queries, walls, rng):
    """The churn of _captured_streaming on both indexes, then one insert
    and one search of each profiled (_profiled_busy)."""
    from bang_tpu_torch.utils.config import SearchParams

    n, chunk = STREAM_N, STREAM_CHUNK
    for s in range(0, n, chunk):
        _streaming_step(f"insert {s}", ixs, "insert", lambda ix: ix.insert(
            pts[s : s + chunk]), walls)
    params = SearchParams(L=64, k=K, extra_iters=24, beam_width=2)
    _streaming_search("pre-churn", ixs, queries, params, walls)
    victims = rng.choice(n, n // 10, replace=False).astype(np.int32)
    old_medoid = ixs["eager"].medoid
    victims[0] = old_medoid
    victims = np.unique(victims)
    _streaming_step("delete", ixs, "delete", lambda ix: ix.delete(victims), walls)
    _streaming_search("after delete", ixs, queries, params, walls)
    rep = _streaming_step("consolidate", ixs, "consolidate",
                          lambda ix: ix.consolidate(batch=chunk), walls)
    if rep["eager"] != rep["captured"] or ixs["captured"].medoid == old_medoid:
        raise AssertionError(f"captured streaming: repaired {rep}, medoid "
                             f"{old_medoid} -> {ixs['captured'].medoid}")
    _streaming_search("after consolidate (medoid re-elected)", ixs, queries, params,
                      walls)
    back = victims[:chunk]
    ids = _streaming_step("re-insert", ixs, "insert", lambda ix: ix.insert(pts[back]),
                          walls)["captured"]
    if set(ids.tolist()) - set(victims.tolist()):
        raise AssertionError("captured streaming: re-inserted outside the freed slots")
    _streaming_search("after re-insert", ixs, queries, params, walls)
    more = victims[chunk : 3 * chunk]  # into freed slots: the first captures the key
    _streaming_step("insert (capture)", ixs, "insert", lambda ix: ix.insert(
        pts[more[:chunk]]), walls)
    prof = {kind: (_profiled_busy(lambda ix=ix: ix.insert(pts[more[chunk:]])),
                   _profiled_busy(lambda ix=ix: ix.search(queries, params)))
            for kind, ix in ixs.items()}
    _same_states("the profiled inserts", ixs)
    inserts = n + len(back) + chunk
    text = {kind: ", ".join(
        f"{what} {sum(v):.3f} s" + (f" ({len(v)} calls)" if len(v) > 1 else "")
        for what, v in w.items()) for kind, w in walls.items()}
    log(f"captured streaming N={n} R={STREAM_R} inserts of {chunk}: states identical "
        f"after every insert, the delete, the consolidate ({rep['captured']} rows "
        f"repaired, medoid {old_medoid} -> {ixs['captured'].medoid}) and the re-insert; "
        f"search ids and distances identical before the churn and after each step; "
        f"inserts/s eager {inserts / sum(walls['eager']['insert']):.1f}, captured "
        f"{inserts / sum(walls['captured']['insert']):.1f}; eager: {text['eager']}; "
        f"captured: {text['captured']}")
    for kind, (ins, srch) in prof.items():
        log(f"captured streaming, {kind}: one insert of {chunk} {_busy_text(ins)}; one "
            f"search of {STREAM_Q} {_busy_text(srch)}")


def phase_captured_loops(dev):
    """Phase 19: two of the three loops captured in this PR against their
    eager plain versions on the card, the Vamana build and the streaming
    index (the third, the chunk-sharded base step, in phase 14, where its
    searcher is built). No kernel launches."""
    t = {}
    for name, fn in (("build", lambda: _captured_build(dev)),
                     ("streaming", lambda: _captured_streaming(dev))):
        t0 = time.perf_counter()
        fn()
        t[name] = time.perf_counter() - t0
    log("phase 19 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()))


def _against_exact(what, exact_runs, bloom_runs):
    """Each L's bloom rows beside its exact-mode rows, two runs of each
    made in the order exact, bloom, bloom, exact: recall at most
    BLOOM_RECALL_SLACK below the exact mask's, >= RECALL_TARGET at the bloom
    sweep's best L, and the same ids in both runs of a mode."""
    steps = "steps" if "steps" in exact_runs[0][0] else "iters"
    for i, ex in enumerate(exact_runs[0]):
        bl = bloom_runs[0][i]
        for runs in (exact_runs, bloom_runs):
            if not np.array_equal(runs[0][i]["ids"], runs[1][i]["ids"]):
                raise AssertionError(f"{what} L={ex['L']}: two runs of one mode differ")
        walls = [runs[j][i]["wall_s"] for runs, j in
                 ((exact_runs, 0), (bloom_runs, 0), (bloom_runs, 1), (exact_runs, 1))]
        extra = ("" if steps == "steps" else
                 f", dist_comps {bl['dist_comps']} / {ex['dist_comps']}")
        log(f"bloom vs exact {what} L={ex['L']}: recall@10 {bl['recall']:.2f} / "
            f"{ex['recall']:.2f}, {steps} {bl[steps]} / {ex[steps]}{extra}, peak "
            f"{bl['peak_gb']:.2f} / {ex['peak_gb']:.2f} GB; walls exact, bloom, bloom, "
            "exact " + " / ".join(f"{w:.4f}" for w in walls) + " s")
        if bl["recall"] < ex["recall"] - BLOOM_RECALL_SLACK:
            raise AssertionError(f"{what} bloom L={ex['L']}: recall@10 "
                                 f"{bl['recall']:.2f} below the exact mask's "
                                 f"{ex['recall']:.2f} - {BLOOM_RECALL_SLACK}")
    _best(bloom_runs[0], f"{what} bloom")


def _base_rows(prefix, dev, visited_mode, label):
    """Base over BLOOM_BASE_L in `visited_mode`, K1 checked once a step."""
    rows, steps = run_base(prefix, dev, BLOOM_BASE_L, visited_mode=visited_mode)
    _k1_per_step(label, steps)
    return rows


def phase_bloom(prefix, dev, totals):
    """Phase 11: the searches of phases 5-7 and 10 in bloom mode, each beside
    the exact mode in the order exact, bloom, bloom, exact, every call
    counted as its exact-mode phase; then the fused L=128 profile in bloom
    mode."""
    searches = (
        ("inmemory fused", {"frontier_lookup"}, lambda mode: run_search(
            prefix, dev, "inmemory", BLOOM_L["inmemory"], visited_mode=mode)),
        ("inmemory scattered", {"pq_lookup"}, lambda mode: run_search(
            prefix, dev, "inmemory", (SCATTERED_PROFILE_L,), fused_frontier=False,
            visited_mode=mode)),
        ("exactdistance fused", {"exact_frontier"}, lambda mode: run_search(
            prefix, dev, "exactdistance", BLOOM_L["exactdistance"], visited_mode=mode)),
        ("base", {"pq_lookup"}, lambda mode: _base_rows(prefix, dev, mode,
                                                        f"search base {mode}")),
    )
    for what, launched, run in searches:
        runs = {"exact": [], "bloom": []}
        for mode in ("exact", "bloom", "bloom", "exact"):
            runs[mode].append(counted(f"search {what} {mode}", launched,
                                      lambda: run(mode), totals))
        _against_exact(what, runs["exact"], runs["bloom"])
    profile_search(prefix, dev, "inmemory", PROFILE_L, visited_mode="bloom")


def _beam_extra(variant):
    return BEAM_EXTRA.get(variant, (BASE_BEAM, BASE_EXTRA))


def _warmup(prefix, dev, variant, queries):
    """BANGSearch(variant) at WARMUP_L: one bang_alloc + query without
    ENABLE_CACHE_WARMUP, one with it. Returns (touched, the two bang_alloc
    seconds, the two results)."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.constants import ENABLE_CACHE_WARMUP

    beam, extra = _beam_extra(variant)
    s = BANGSearch(variant, device=dev)
    s.bang_load(prefix, **({"mmap": False, "n_pipeline_batches": BASE_PIPELINE}
                           if variant == "base" else {}))
    secs, results = [], []
    for caps in (0, ENABLE_CACHE_WARMUP):
        s.bang_set_searchparams(K, WARMUP_L[variant], beam_width=beam,
                                extra_iters=extra, capabilities=caps)
        t0 = time.perf_counter()
        s.bang_alloc(len(queries))
        secs.append(time.perf_counter() - t0)
        results.append(s.bang_query(queries))
    s.bang_unload()
    torch.cuda.empty_cache()
    return s.warmup_touched, secs, results


def _serve(prefix, dev, queries, gt_ids, gt_dists):
    """SearchServer("inmemory", SERVER_BATCH) over `queries` against one
    BANGSearch warmed up at the same Q."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.harness.serving import SearchServer
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    beam, extra = _beam_extra("inmemory")
    L = WARMUP_L["inmemory"]
    server = SearchServer(prefix, "inmemory", batch_size=SERVER_BATCH,
                          params=SearchParams(L=L, k=K, beam_width=beam, extra_iters=extra),
                          device=dev)
    t0 = time.perf_counter()
    ids, dists = server.query(queries)
    wall = time.perf_counter() - t0
    pct, n = server.latency_percentiles(), len(server.latencies_ms)
    server.close()
    ref = BANGSearch("inmemory", device=dev)
    ref.bang_load(prefix)
    ref.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra)
    ref.bang_alloc(SERVER_BATCH)
    r_ids, r_dists = ref.bang_query(queries)
    ref.bang_unload()
    torch.cuda.empty_cache()
    if not (np.array_equal(ids, r_ids) and np.array_equal(dists, r_dists)):
        raise AssertionError(f"SearchServer differs from bang_query at Q={SERVER_BATCH} "
                             f"on {int((ids != r_ids).any(1).sum())} queries")
    log(f"serve inmemory L={L} batch {SERVER_BATCH}: {n} requests, ids and distances "
        f"identical to bang_query; recall@10 "
        f"{calculate_recall(gt_ids, ids, K, gt_dists):.2f}; latency ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in pct.items())
        + f"; {len(queries)} queries in {wall:.3f} s, qps {len(queries) / wall:.1f}")


def phase_warmup_serving(prefix, dev, totals):
    """Phase 12: ENABLE_CACHE_WARMUP on the three variants, the SearchServer,
    and the latency probes, each counted."""
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.formats.graph import load_graph_index
    from bang_tpu_torch.harness.serving import (
        measure_base_device_step_ms,
        measure_device_batch_latency,
    )
    from bang_tpu_torch.models.base import BaseVariantSearcher
    from bang_tpu_torch.models.index import device_index_from_files
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.graph_tools import bfs_from

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    graph = load_graph_index(prefix)
    t0 = time.perf_counter()
    reach = len(bfs_from(graph.adj, graph.medoid, max_nodes=1_000_000))
    log(f"warmup: the BFS from the medoid reaches {reach} of {graph.adj.shape[0]} "
        f"nodes (host BFS {time.perf_counter() - t0:.2f}s)")
    del graph
    for variant, launched in (("inmemory", {"frontier_lookup"}),
                              ("exactdistance", {"exact_frontier"}),
                              ("base", {"pq_lookup"})):
        touched, secs, (want, got) = counted(
            f"warmup {variant}", launched, lambda: _warmup(prefix, dev, variant, queries),
            totals)
        if touched != reach:
            raise AssertionError(f"warmup {variant}: touched {touched} nodes, the BFS "
                                 f"from the medoid reaches {reach}")
        if not (np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])):
            raise AssertionError(f"warmup {variant}: ids or distances differ from the "
                                 "call without ENABLE_CACHE_WARMUP")
        log(f"warmup {variant} L={WARMUP_L[variant]}: touched {touched} nodes; "
            f"bang_alloc {secs[0]:.3f} s without the bit, {secs[1]:.3f} s with it; "
            "ids and distances identical")

    counted("serve inmemory", {"frontier_lookup"},
            lambda: _serve(prefix, dev, queries, gt_ids, gt_dists), totals)

    for variant, launched in (("inmemory", {"frontier_lookup"}),
                              ("exactdistance", {"exact_frontier"})):
        beam, extra = _beam_extra(variant)
        params = SearchParams(L=WARMUP_L[variant], k=K, beam_width=beam,
                              extra_iters=extra)

        def probe():
            index = device_index_from_files(prefix, dev, variant)
            return measure_device_batch_latency(index, queries[:SERVER_BATCH], params,
                                                variant)

        ms = counted(f"probe {variant} batch latency", launched, probe, totals)
        log(f"probe {variant} L={WARMUP_L[variant]} Q={SERVER_BATCH}: {ms:.4f} ms a "
            "search (CUDA events over 10 searches, the host loop's gaps included)")
        torch.cuda.empty_cache()
    q_b = Q // BASE_PIPELINE
    searcher = BaseVariantSearcher(prefix, BASE_PIPELINE, mmap=False, device=dev)
    for visited_mode in ("exact", "bloom", "bloom", "exact"):
        params = SearchParams(L=WARMUP_L["base"], k=K, beam_width=BASE_BEAM,
                              extra_iters=BASE_EXTRA, visited_mode=visited_mode)
        n_chain = 17
        ms = counted(f"probe base step {visited_mode}", {"pq_lookup"},
                     lambda: measure_base_device_step_ms(searcher, queries[:q_b], params,
                                                         n_chain), totals)
        _k1_per_step(f"probe base step {visited_mode}", n_chain + 1)
        log(f"probe base step {visited_mode} Q={q_b}: {ms:.4f} ms a step (CUDA events "
            f"over {n_chain} steps)")
    del searcher
    torch.cuda.empty_cache()


def phase_streaming(dev, totals):
    """Phase 13 (no kernel may launch): bench.streaming_row at its own point;
    recall@10 over the live set >= RECALL_TARGET before and after the
    churn, the re-inserted points in the freed slots, the live count."""
    from bang_tpu_torch import bench

    row = counted("streaming", set(), lambda: bench.streaming_row(
        STREAM_N, D, STREAM_R, STREAM_Q, STREAM_CHUNK, dev), totals)
    n = STREAM_N
    log(f"streaming: first {STREAM_CHUNK} inserts (the ramp) {row['ramp_s']:.3f} s")
    log(f"streaming: {row['inserts_timed']} inserts timed (the captured insert, after "
        f"the key's eager batch and its capture) in {row['insert_wall_s']:.3f} s "
        f"({row['inserts_per_s']:.1f} inserts/s); search {STREAM_Q} queries qps "
        f"{row['qps_pre_churn']:.1f}, recall@10 {row['recall_pre_churn']:.2f}")
    log(f"streaming: delete {n // 10}, consolidate {row['consolidate_s']:.3f} s "
        f"({row['consolidate_repaired']} rows repaired), re-insert {STREAM_CHUNK} in "
        f"{row['reinsert_s']:.3f} s; search qps {row['qps_post_churn']:.1f}, recall@10 "
        f"{row['recall_post_churn']:.2f}; n_live {row['n_live']}")
    if not row["reinserted_into_freed_slots"]:
        raise AssertionError("streaming: re-inserted points outside the freed slots")
    for what in ("pre", "post"):
        if row[f"recall_{what}_churn"] < RECALL_TARGET:
            raise AssertionError(f"streaming: recall@10 {row[f'recall_{what}_churn']:.2f}"
                                 f" {what} the churn < {RECALL_TARGET}")
    if row["n_live"] != row["n_live_expected"]:
        raise AssertionError(f"streaming: n_live {row['n_live']}, expected "
                             f"{row['n_live_expected']}")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _shard_iters():
    """Record the iterations of each shard's walk in the per-shard loop
    (parallel/sharded.traverse, wrapped); yields the list they are
    appended to."""
    from bang_tpu_torch.parallel import sharded

    iters, alone = [], sharded.traverse

    def alone_recorded(*args, **kwargs):
        state = alone(*args, **kwargs)
        iters.append(int(state.it))
        return state

    sharded.traverse = alone_recorded
    try:
        yield iters
    finally:
        sharded.traverse = alone


def _per_shard_loop(mesh, si, queries, params):
    """The shards searched one after another on the eager loop, each to its
    end (parallel/sharded._local_search, one host read per shard per
    iteration), then merged: what search_sharded computes, and must
    return."""
    from bang_tpu_torch.parallel import sharded

    row = mesh.devices[0]
    parts = []
    for s, dev in enumerate(row):
        sh = si.shard(s, dev)
        parts.append(sharded._local_search(
            sh.adj, sh.vectors, sh.codes, sh.fused_rows, sh.codebook, sh.medoid,
            sh.id_base, torch.as_tensor(queries).to(dev), l=params.L, k=params.k,
            max_iters=params.max_iters, use_bloom=False, beam=params.beam_width))
    return sharded.merge_topk(sharded.all_gather([p[0] for p in parts], row[0]),
                              sharded.all_gather([p[1] for p in parts], row[0]),
                              params.k)


def _sharded_call(mesh, si, queries, params):
    """search_sharded once, synchronised: a dict of its host ids and
    distances, each shard's iterations and distance computations (its
    SearchStats), the kernels it launched, wall and peak GB. A key's first
    call steps the shards in rounds on the eager loop, then captures each
    shard's walk; later calls launch them."""
    from bang_tpu_torch.parallel.sharded import search_sharded

    stats = []
    before = _launches()
    (ids, dists), wall, peak = _timed(lambda: search_sharded(mesh, si, queries, params,
                                                             stats=stats))
    return {"ids": _host_ids(ids), "dists": dists.cpu().numpy(),
            "iters": [st.iters for st in stats],
            "dist_comps": [st.n_dist_comps for st in stats], "launches": _delta(before),
            "wall_s": wall, "peak_gb": peak}


def _rounds_against_loop(mesh, si, queries, L, first):
    """search_sharded at L after its first call `first` (the rounds on the
    eager loop, then the captures), in the order captured, loop, loop,
    captured: the per-shard loop's ids and shard iterations identical to
    the first call's; the captured calls' ids, iterations, distance
    computations and launches identical to it. Returns the walls."""
    from bang_tpu_torch.utils.config import SearchParams

    params = SearchParams(L=L, k=K, beam_width=BEAM_EXTRA["inmemory"][0],
                          extra_iters=BEAM_EXTRA["inmemory"][1])
    walls = {"rounds": [first["wall_s"]], "captured": [], "loop": []}
    for kind in ("captured", "loop", "loop", "captured"):
        if kind == "loop":
            with _shard_iters() as iters:
                (ids, _), wall, _ = _timed(lambda: _per_shard_loop(mesh, si, queries,
                                                                   params))
            run = {"ids": _host_ids(ids), "iters": iters}
            keys = ("ids", "iters")
        else:
            run = _sharded_call(mesh, si, queries, params)
            wall = run["wall_s"]
            keys = ("ids", "dists", "iters", "dist_comps", "launches")
        walls[kind].append(wall)
        for key in keys:
            same = (np.array_equal(run[key], first[key])
                    if isinstance(run[key], np.ndarray) else run[key] == first[key])
            if not same:
                raise AssertionError(f"sharded L={L}: the {kind} differs from "
                                     f"search_sharded's first call in {key}")
    log(f"sharded fused L={L}: first call (rounds, eager loop) "
        f"{walls['rounds'][0]:.4f} s, captured "
        + " / ".join(f"{w:.4f}" for w in walls["captured"]) + " s, per-shard loop "
        + " / ".join(f"{w:.4f}" for w in walls["loop"]) + f" s; ids and shard "
        f"iterations {first['iters']} identical; the captured calls' distance "
        f"computations {first['dist_comps']} and launches {first['launches']} "
        "identical to the rounds'")
    return walls


def _timed(fn):
    """(fn's result, wall s, peak GB) around one synchronised call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def _host_ids(ids):
    return ids.cpu().numpy().astype(np.int64)


def _k1_widths(dev, kern):
    """K1 against its plain version, and timed, at each code width the
    sharded paths launch it with: the chunk-sharded base's sub-batch
    (m/SHARDS chunks a shard), the dry run's base (1 chunk a shard) and
    node shards (8 chunks), on random packed tables and codes."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts import _common as cm

    gen = torch.Generator(device=dev).manual_seed(14)
    for label, q, c, m in K1_WIDTHS:
        packed = pk.pack_tables(cm.tables(gen, q, m, dev))
        codes = torch.randint(0, 256, (q, c, m), generator=gen, device=dev,
                              dtype=torch.uint8)
        got = pk.pq_lookup(packed, codes)
        torch.cuda.synchronize()
        err = _note_err(kern, "pq_lookup", cm.dist_err(
            f"pq_lookup {label}", got, pk.lookup_packed_plain(packed, codes)))
        ms = _time_ms(lambda: pk.pq_lookup(packed, codes))
        plain = _time_ms(lambda: pk.lookup_packed_plain(packed, codes))
        bound = (packed.numel() * 4 + codes.numel() + q * c * 4) / HBM_BYTES_PER_S * 1e3
        log(f"K1 at {label} (Q={q} C={c} m={m}): max abs err {err:.3g}; {ms:.4f} ms "
            f"(plain {plain:.4f} ms), bound {bound:.4f} ms ({bound / ms:.0%} of it)")
    pk.reset_launch_counts()


def _sharded_rows(mesh, si, queries, gt, L, label, beam=BEAM_EXTRA["inmemory"][0],
                  extra=BEAM_EXTRA["inmemory"][1]):
    """search_sharded at L (the key's first call: the eager rounds, then the
    captures): (the call's _sharded_call dict, row) with the row's recall,
    iterations of each shard, wall and peak memory."""
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    params = SearchParams(L=L, k=K, beam_width=beam, extra_iters=extra)
    run = _sharded_call(mesh, si, queries, params)
    wall, peak = run["wall_s"], run["peak_gb"]
    row = {"L": L, "recall": calculate_recall(gt[0], run["ids"], K, gt[1]),
           "iters": run["iters"], "wall_s": wall, "peak_gb": peak}
    log(f"sharded {label} L={L}: recall@10 {row['recall']:.2f}, shard iterations "
        f"{row['iters']}, wall {wall:.4f} s (qps {len(queries) / wall:.1f}), peak "
        f"{peak:.2f} GB")
    return run, row


def _merge_alone(si, queries, params, dev):
    """Each shard searched alone with search_inmemory, merged on the host
    (shard-major, stable): what search_sharded's all_gather and top-k must
    give."""
    from bang_tpu_torch.models.index import DeviceIndex
    from bang_tpu_torch.models.inmemory import search_inmemory
    from bang_tpu_torch.ops.l2 import squared_norms

    ids, dists = [], []
    for s in range(si.n_shards):
        sh = si.shard(s, dev)
        ix = DeviceIndex(adj=None, vectors=sh.vectors,
                         vector_norms=squared_norms(sh.vectors), codes=sh.codes,
                         fused_rows=sh.fused_rows, codebook=sh.codebook,
                         medoid=sh.medoid, n=si.n_local, dim=sh.vectors.shape[1])
        i, d, _ = search_inmemory(ix, queries, params)
        i = _host_ids(i)
        ids.append(np.where(i >= 0, i + sh.id_base, i))
        dists.append(d.cpu().numpy())
    flat_i = np.stack(ids, 1).reshape(len(queries), -1)
    flat_d = np.stack(dists, 1).reshape(len(queries), -1)
    order = np.argsort(flat_d, axis=1, kind="stable")[:, :K]
    return np.take_along_axis(flat_i, order, 1)


def _base_tp_rows(prefix, dev, entry_mode, single):
    """ShardedBaseSearcher on a (1, SHARDS) mesh of one card over the
    bundle (captured: every shard is mesh.home), beside one on the eager
    step (`captured` False), at each L of TP_BASE_L with 8 sub-batches: the
    key's first call (the eager step, then the capture), then calls in the
    order eager, captured, captured, eager: ids, distances, steps, readback
    waits and K1 launches (SHARDS a step, plus SHARDS a sub-batch for
    sampled entries, as the kernel counts them on the card) identical;
    the captured call's recall, steps, wall, stage ms and peak; its ids
    against the single-card base's at the same L (`single`: L -> ids); at
    the last L with medoid entry one profiled call of each. Returns (rows,
    K1 launches expected over all those calls)."""
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.parallel.base_tp import ShardedBaseSearcher
    from bang_tpu_torch.parallel.sharded import make_mesh
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    mesh = make_mesh(1, SHARDS, [dev] * SHARDS)
    tps = {kind: ShardedBaseSearcher(prefix, mesh, n_pipeline_batches=BASE_PIPELINE,
                                     mmap=False) for kind in ("eager", "captured")}
    if not tps["captured"].captured:
        raise AssertionError("ShardedBaseSearcher on one card: captured is False")
    tps["eager"].captured = False
    tps["captured"].timers.enabled = True
    expected, rows = 0, []
    sampled = entry_mode == "sampled"  # one lookup a shard per sub-batch's entries

    def launched(tp):
        return SHARDS * (tp.last_n_steps + sampled * BASE_PIPELINE)

    for L in TP_BASE_L:
        params = SearchParams(L=L, k=K, beam_width=BASE_BEAM, extra_iters=BASE_EXTRA,
                              entry_mode=entry_mode)
        t0 = time.perf_counter()
        tps["captured"].search(queries, params)  # the key's first call
        first = time.perf_counter() - t0
        expected += launched(tps["captured"])
        runs = {"eager": [], "captured": []}
        for kind in ("eager", "captured", "captured", "eager"):
            runs[kind].append(_base_call(tps[kind], queries, params))
            expected += launched(tps[kind])
        e, c = runs["eager"][0], runs["captured"][0]
        label = f"sharded base {entry_mode} L={L}"
        for i in range(2):
            _same_run(label, runs["eager"][i], runs["captured"][i],
                      ("ids", "dists", "steps", "d2h", "launches"))
        want = SHARDS * (c["steps"] + sampled * BASE_PIPELINE)
        if c["launches"] != {"pq_lookup": want}:
            raise AssertionError(f"captured {label}: launches {c['launches']}, expected "
                                 f"pq_lookup {want}")
        ids = c["ids"]
        agree = float((ids == single[L]).mean())
        row = {"L": L, "recall": calculate_recall(gt_ids, ids, K, gt_dists),
               "steps": c["steps"], "agree": agree, "wall_s": c["wall_s"],
               "peak_gb": c["peak_gb"], "stages": dict(tps["captured"].timers.ms)}
        walls = {k: " / ".join(f"{r['wall_s']:.4f}" for r in v) for k, v in runs.items()}
        pools = sum(sb.graph_bytes for sb in tps["captured"]._subs) / 1e9
        log(f"{label}: recall@10 {row['recall']:.2f}, steps {row['steps']}, ids equal to "
            f"the single-card base's on {agree:.2%} of slots, peak {c['peak_gb']:.2f} GB; "
            f"captured against the eager step: ids, distances, steps, readback waits "
            f"({c['d2h']}) and launches {c['launches']} ({SHARDS} a step) identical; walls "
            f"eager {walls['eager']} s, captured {walls['captured']} s (qps "
            f"{Q / c['wall_s']:.1f}); host waits a call eager {e['waits']}, captured "
            f"{c['waits']}; graph pools {pools:.3f} GB; the key's first call (eager step, "
            f"then the capture) {first:.3f} s; captured stage ms " + ", ".join(
                f"{k} {v:.3f}" for k, v in row["stages"].items()))
        if agree < 0.98:
            raise AssertionError(f"{label}: ids agree with the single-card base on "
                                 f"{agree:.2%} < 98%")
        if L == TP_BASE_L[-1] and not sampled:
            prof = {}
            for kind, tp in tps.items():
                prof[kind] = _profiled_busy(lambda tp=tp: tp.search(queries, params))
                expected += launched(tp)
            log(f"{label}: eager {_busy_text(prof['eager'])}; captured "
                f"{_busy_text(prof['captured'])}")
        rows.append(row)
    _best(rows, f"sharded base {entry_mode}")
    tp = tps["captured"]
    codes_mb = sum(c.numel() for c in tp.codes_sharded) / 1e6
    log(f"sharded base: codes {codes_mb:.1f} MB in {SHARDS} chunk slices of "
        f"{tp.codes_sharded[0].shape[1]} chunks")
    del tps, tp
    torch.cuda.empty_cache()
    return rows, expected


def phase_sharded(prefix, dev, totals, kern, base_rows):
    """Phase 14: the sharded paths on the bundle's data, every mesh on
    [dev] * n (one card)."""
    import dataclasses

    from bang_tpu_torch.formats import accel, synthetic
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.formats.graph import load_graph_index
    from bang_tpu_torch.formats.pq import load_pq
    from bang_tpu_torch.models.base import BaseVariantSearcher
    from bang_tpu_torch.models.index import device_index_from_files
    from bang_tpu_torch.models.inmemory import search_inmemory
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.parallel.partition import partition_index
    from bang_tpu_torch.parallel.sharded import make_mesh, search_data_parallel
    from bang_tpu_torch.utils.config import SearchParams

    _k1_widths(dev, kern)
    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt = load_truthset(prefix + "_gt.bin")
    data = load_graph_index(prefix).vectors
    pq = load_pq(prefix)
    n_loc = len(data) // SHARDS

    # the card's kNN graph against the numpy one (JAX's) on a small shard
    part = data[:KNN_CHECK_N]
    kw = dict(n_random=max(2, R // 8), seed=0)
    (a_card, _), secs = _timed(lambda: accel.build_knn_graph(part, R, dev, **kw))[:2]
    t0 = time.perf_counter()
    a_np, _ = synthetic.build_knn_graph(part, R, **kw)
    same_rows = int((a_card == a_np).all(axis=1).sum())
    same_sets = int((np.sort(a_card, 1) == np.sort(a_np, 1)).all(axis=1).sum())
    log(f"sharded: kNN graph of {len(part)} points on the card ({secs:.2f} s) and in "
        f"numpy ({time.perf_counter() - t0:.2f} s): rows identical {same_rows}, "
        f"identical as sets {same_sets} of {len(part)}")

    si, build_s, build_gb = _timed(lambda: partition_index(
        data, SHARDS, R, pq, seed=0, fused_frontier=True, device=dev))
    log(f"sharded: {SHARDS} shards of {n_loc} points (R={R}, m={M}, fused rows) built "
        f"in {build_s:.2f} s, peak {build_gb:.2f} GB")
    si_sc = dataclasses.replace(si, fused_rows=None, _placed={})
    mesh = make_mesh(1, SHARDS, [dev] * SHARDS)

    rows, fused_ids = [], {}
    for L in SHARD_L:
        def fused_rows():
            run, row = _sharded_rows(mesh, si, queries, gt, L, "fused")
            row["walls"] = _rounds_against_loop(mesh, si, queries, L, run)
            return run["ids"], run["dists"], row

        ids_f, d_f, row_f = counted(f"sharded fused L={L}", {"frontier_lookup"},
                                    fused_rows, totals)
        run_s, row_s = counted(f"sharded scattered L={L}", {"pq_lookup"},
                               lambda: _sharded_rows(mesh, si_sc, queries, gt, L,
                                                     "scattered"), totals)
        ids_s = run_s["ids"]
        same = (ids_f == ids_s).all(axis=1)
        if not same.all() or row_f["iters"] != row_s["iters"]:
            raise AssertionError(
                f"sharded L={L}: scattered differs from fused: ids on "
                f"{int((~same).sum())} queries, iterations {row_s['iters']} vs "
                f"{row_f['iters']}")
        _check_output(ids_f, d_f, queries, data, len(data))
        rows.append(row_f)
        fused_ids[L] = ids_f
    best = _best(rows, "sharded fused")
    log(f"sharded: fused and scattered ids and shard iterations identical at L="
        f"{list(SHARD_L)}")

    params = SearchParams(L=best["L"], k=K, beam_width=BEAM_EXTRA["inmemory"][0],
                          extra_iters=BEAM_EXTRA["inmemory"][1])
    alone = counted("sharded merge check", {"frontier_lookup"},
                    lambda: _merge_alone(si, queries, params, dev), totals)
    ids_best = fused_ids[best["L"]]
    if not np.array_equal(alone, ids_best):
        raise AssertionError(f"sharded merge: differs from each shard searched alone and "
                             f"merged on the host on "
                             f"{int((alone != ids_best).any(axis=1).sum())} queries")
    log(f"sharded L={best['L']}: the merge equals {SHARDS} shards searched alone and "
        "merged on the host, for every query")

    si_ex = dataclasses.replace(si, codes=None, codebook=None, fused_rows=None,
                                _placed={})
    ex_run, ex_row = counted(
        f"sharded exact L={EXACT_SHARD_L}", set(),
        lambda: _sharded_rows(mesh, si_ex, queries, gt, EXACT_SHARD_L, "exact",
                              *BEAM_EXTRA["exactdistance"]), totals)
    _check_output(ex_run["ids"], ex_run["dists"], queries, data, len(data))
    _best([ex_row], "sharded exact")
    del si, si_sc, si_ex
    torch.cuda.empty_cache()

    def data_parallel():
        index = device_index_from_files(prefix, dev)
        runs = []
        for _ in range(2):  # the rounds, then the captured walks
            stats = []
            (ids, _), wall, peak = _timed(lambda: search_data_parallel(
                make_mesh(2, 1, [dev] * 2), index, queries, params, stats=stats))
            runs.append((_host_ids(ids), [st.iters for st in stats], wall, peak))
        one = search_inmemory(index, queries, params)[0]
        return runs, _host_ids(one)

    runs, one = counted("data parallel", {"frontier_lookup"}, data_parallel, totals)
    for (dp, iters, wall, peak), kind in zip(runs, ("rounds", "captured")):
        if not np.array_equal(dp, one) or iters != runs[0][1]:
            raise AssertionError(f"data parallel {kind}: ids differ from search_inmemory"
                                 f" on {int((dp != one).any(axis=1).sum())} queries, or "
                                 f"row iterations {iters} from {runs[0][1]}")
        log(f"data parallel (2, 1) L={best['L']} {kind}: ids identical to "
            f"search_inmemory on all {len(dp)} queries, row iterations {iters}; wall "
            f"{wall:.4f} s, peak {peak:.2f} GB")
    torch.cuda.empty_cache()

    single = {"medoid": {r["L"]: r["ids"] for r in base_rows}}

    def single_sampled():
        searcher = BaseVariantSearcher(prefix, BASE_PIPELINE, mmap=False, device=dev)
        return {L: searcher.search(queries, SearchParams(
            L=L, k=K, beam_width=BASE_BEAM, extra_iters=BASE_EXTRA,
            entry_mode="sampled"))[0] for L in TP_BASE_L}

    single["sampled"] = counted("single base sampled", {"pq_lookup"}, single_sampled,
                                totals)
    for entry_mode in ("medoid", "sampled"):
        def run():
            rows, expected = _base_tp_rows(prefix, dev, entry_mode, single[entry_mode])
            k1 = pk.launch_counts()["pq_lookup"]
            if k1 != expected:
                raise AssertionError(f"sharded base {entry_mode}: K1 launched "
                                     f"{k1} times, expected {expected}")
            log(f"sharded base {entry_mode}: K1 launches {expected} = {SHARDS} per step "
                "(and per sub-batch's sampled entries)")
            return rows

        counted(f"sharded base {entry_mode}", {"pq_lookup"}, run, totals)

    from bang_tpu_torch.entry import dryrun_multichip

    counted("dryrun_multichip", {"pq_lookup", "frontier_lookup"},
            lambda: dryrun_multichip(SHARDS, device=dev), totals)
    return best


@contextlib.contextmanager
def _shard_peaks():
    """Record each shard build's peak device memory: formats/vamana.
    build_vamana_graph wrapped, its peak above what was held before it (the
    shard's vectors included); yields the list of (points, bytes)."""
    from bang_tpu_torch.formats import vamana

    peaks, build_vamana = [], vamana.build_vamana_graph

    def measured(vectors, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = build_vamana(vectors, *args, **kwargs)
        torch.cuda.synchronize()
        peaks.append((vectors.shape[0], torch.cuda.max_memory_allocated() - before
                      + vectors.numel()))
        return out

    vamana.build_vamana_graph = measured
    try:
        yield peaks
    finally:
        vamana.build_vamana_graph = build_vamana


def _log_shard_peaks(label, peaks, r, batch, l_build):
    """Each shard's measured peak beside formats/bigbuild.
    shard_build_hbm_bytes; returns [(points, measured, model), ...]."""
    from bang_tpu_torch.formats import bigbuild

    out = []
    for n_s, peak in peaks:
        model = bigbuild.shard_build_hbm_bytes(n_s, D, r, batch, l_build)
        log(f"{label} shard of {n_s} points: measured peak {peak / 1e9:.3f} GB, "
            f"shard_build_hbm_bytes {model / 1e9:.3f} GB ({peak / model:.2f}x)")
        out.append((n_s, peak, model))
    return out


def phase_bigbuild(dev, totals):
    """Phase 15: BlockGen, the sharded Vamana build, the int8 ground truth
    and a search over the merged graph."""
    from bang_tpu_torch.formats import accel, bigbuild, synthetic
    from bang_tpu_torch.models.index import assemble_device_index
    from bang_tpu_torch.models.inmemory import search_inmemory
    from bang_tpu_torch.ops.pq import prepare_pq_codebook
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    t = {}

    def stage(name, fn):
        out, t[name], peak = _timed(fn)
        log(f"bigbuild {name} {t[name]:.2f}s (peak {peak:.2f} GB)")
        return out

    def build():
        gen = stage("blockgen", lambda: bigbuild.BlockGen(BIG_N, D, seed=0, device=dev))
        with _shard_peaks() as shard_peaks:
            adj, degrees, assignment = stage("sharded_vamana", lambda: (
                bigbuild.build_sharded_vamana(
                    gen, r=R, l_build=VAMANA["l_build"], n_shards=SHARDS, overlap=2,
                    batch=VAMANA["batch"], n_passes=1, alpha=VAMANA["alpha"], seed=0)))
        centers = bigbuild.kmeans_device(gen.gen_block(0)[: 1 << 21], SHARDS, iters=12,
                                         seed=1)
        if not np.array_equal(bigbuild.assign_shards(gen, centers, 2)[0], assignment):
            raise AssertionError("bigbuild: k-means and the assignment, run again, "
                                 "differ from the build's")
        counts = [int((assignment == s).any(axis=1).sum()) for s in range(SHARDS)]
        log(f"bigbuild: assignment reproduced; members per shard {counts} (overlap 2 "
            f"over {BIG_N}); degrees "
            f"mean {degrees.mean():.2f} min {degrees.min()}; budget "
            f"{bigbuild._budget(dev) / 1e9:.1f} GB")
        _log_shard_peaks("bigbuild", shard_peaks, R, VAMANA["batch"], VAMANA["l_build"])
        return gen, adj, degrees

    gen, adj, degrees = counted("bigbuild build", set(), build, totals)
    data = stage("materialize", lambda: bigbuild.materialize_host(gen))
    rng = np.random.default_rng(1)
    queries = data[rng.integers(0, BIG_N, Q)].astype(np.float32)
    queries += rng.normal(0, 2.0, queries.shape).astype(np.float32)
    queries = np.clip(np.rint(queries), 0, 255).astype(np.uint8)
    gt_ids, gt_d = stage("groundtruth_u8", lambda: bigbuild.groundtruth_u8_streamed(
        gen, queries, K, q_block=512))
    ref_ids, ref_d = stage("groundtruth_f32", lambda: accel.compute_groundtruth(
        data, queries.astype(np.float32), K, dev))
    if not np.array_equal(gt_d, ref_d):
        raise AssertionError(f"int8 ground truth: distances differ from "
                             f"compute_groundtruth's on {int((gt_d != ref_d).sum())} slots")
    log(f"bigbuild: int8 ground truth distances equal compute_groundtruth's on all "
        f"{gt_d.size} slots; ids equal on {(gt_ids == ref_ids).mean():.4%}")
    medoid = stage("medoid", lambda: bigbuild.medoid_streamed(gen))
    pq = stage("pq_train", lambda: synthetic.train_pq(data, M, sample=PQ_SAMPLE, seed=0))
    codes = stage("pq_encode", lambda: bigbuild.encode_pq_streamed(gen, pq))
    del gen

    def search():
        cb = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, dev)
        index = assemble_device_index(adj, data, codes, cb, medoid, dev)
        rows = []
        for L in BIG_L:
            params = SearchParams(L=L, k=K, beam_width=BEAM_EXTRA["inmemory"][0],
                                  extra_iters=BEAM_EXTRA["inmemory"][1])
            (ids, dists, stats), wall, peak = _timed(
                lambda: search_inmemory(index, queries, params))
            ids = _host_ids(ids)
            _check_output(ids, dists.cpu().numpy(), queries, data, BIG_N)
            row = {"L": L, "recall": calculate_recall(gt_ids, ids, K, gt_d)}
            log(f"bigbuild search L={L}: recall@10 {row['recall']:.2f}, iters "
                f"{stats.iters}, wall {wall:.4f} s, peak {peak:.2f} GB")
            rows.append(row)
        return _best(rows, "bigbuild search")

    best = counted("bigbuild search", {"frontier_lookup"}, search, totals)
    log(f"bigbuild: stage seconds " + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    torch.cuda.empty_cache()
    return best


def phase_scale(dev, totals):
    """Phase 16: build_100m at SCALE_N, run again (every stage skipped), base
    on its bundle memory-mapped and read into RAM (ids identical, K1 once a
    step), and run_eval's base branch once."""
    from bang_tpu_torch.scripts import build_100m, run_eval

    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        kw = dict(n=SCALE_N, r=SCALE_R, m=SCALE_M, n_shards=SCALE_SHARDS,
                  l_build=SCALE_LBUILD, n_passes=1, batch=SCALE_BATCH, block=SCALE_BLOCK,
                  pq_sample=PQ_SAMPLE, n_queries=Q, cache=tmp, device=dev)

        def build():
            with _shard_peaks() as peaks:
                out = build_100m.main(**kw)
            _log_shard_peaks("scale build", peaks, SCALE_R, SCALE_BATCH, SCALE_LBUILD)
            return out

        prefix, ran = counted("scale build", set(), build, totals)
        log("scale build: stage seconds "
            + ", ".join(f"{k} {v:.2f}" for k, v in ran.items()))
        if list(ran) != list(build_100m.STAGES):
            raise AssertionError(f"scale build: ran {list(ran)}, not every stage")
        again = build_100m.main(**kw)[1]
        if again:
            raise AssertionError(f"scale build, second run: ran {list(again)}")
        log("scale build, second run: every stage skipped")

        rows = {}
        for mmap in (True, False):
            rows[mmap], steps = counted(
                f"scale base mmap={mmap}", {"pq_lookup"},
                lambda: run_base(prefix, dev, SCALE_L, mmap=mmap), totals)
            _k1_per_step(f"scale base mmap={mmap}", steps)
        for a, b in zip(rows[True], rows[False]):
            same = (a["ids"] == b["ids"]).all(axis=1)
            if not same.all() or a["steps"] != b["steps"]:
                raise AssertionError(f"scale base L={a['L']}: memory-mapped ids differ "
                                     f"from the in-RAM run's on {int((~same).sum())} "
                                     f"queries, steps {a['steps']} vs {b['steps']}")
        best = _best(rows[True], "scale base mmap")
        log(f"scale base: memory-mapped ids and steps identical to the in-RAM run's at "
            f"L={list(SCALE_L)}; best L={best['L']} recall@10 {best['recall']:.2f}")

        out = os.path.join(tmp, "run_eval_base.json")
        row = counted("scale run_eval", {"pq_lookup"}, lambda: run_eval.main(
            ["--prefix", prefix, "--variant", "base", "--grid", *map(str, SCALE_L),
             "--mmap", "--out", out, "--device", dev.type]), totals)
        log(f"scale run_eval base: L={row['L']} recall@10 {row['recall']:.2f} qps_wall "
            f"{row['qps_wall']:.1f}, steps {row['n_device_steps']}, device step "
            f"{row['device_step_ms']} ms, pipeline speedup "
            f"{row['pipeline_speedup']:.3f}; device {row['device']}")
    return best


def start_breadth_builds(dev):
    """Phase 17's three breadth bundles (bench.BREADTH), each built from here
    on in a spawned process of its own (bench.breadth_bundle) beside phases
    4-16: their PQ training is numpy on the host, as the JAX package's
    (gist960's m=120 takes minutes), and would otherwise take most of phase
    17. Started with phase 4, after the kernels' timings, on `dev`.
    Returns the processes by key."""
    import multiprocessing

    from bang_tpu_torch import bench

    ctx = multiprocessing.get_context("spawn")
    procs = {key: ctx.Process(target=bench.breadth_bundle, args=(key, str(dev)),
                              name=f"build {key}") for key in bench.BREADTH}
    # each on one host thread (BLAS, OpenMP, torch): beside them phases 4-16
    # build and measure host-bound paths, which 3 processes of 8 threads
    # each slowed (the 1M bundle 201.0 -> 316.6 s on one H100, PERF.md)
    saved = {var: os.environ.get(var) for var in BUILD_THREAD_VARS}
    os.environ.update(dict.fromkeys(BUILD_THREAD_VARS, "1"))
    try:
        for proc in procs.values():
            proc.start()
    finally:
        for var, val in saved.items():
            if val is None:
                os.environ.pop(var)
            else:
                os.environ[var] = val
    log(f"breadth bundles: building {list(procs)} in {len(procs)} processes")
    return procs


def stop_builds(procs):
    """End any build process still running (after a failure elsewhere)."""
    for proc in procs.values():
        if proc.is_alive():
            proc.terminate()
        proc.join(10)


def phase_bench(prefix, dev, totals, kern, builds):
    """Phase 17: the port's bench (bang_tpu_torch/bench.py) through its own
    functions, each call counted: sweep_variant for both HBM variants on
    the 1M bundle at `prefix`, refined and with the serving rows, the
    refined point >= RECALL_TARGET; the three breadth rows at their bench
    sizes (bundles cached under bench_data/, built by the processes
    `builds` that start_breadth_builds started), each >= RECALL_TARGET; K2
    against its plain version at the two breadth shapes it runs (timed,
    with bounds, into kern["frontier_lookup"]["other_shapes"]);
    merge_bench_json.merge on the phase's rows. Any failed row raises."""
    from bang_tpu_torch import bench
    from bang_tpu_torch.scripts import merge_bench_json
    from bang_tpu_torch.scripts.bundles import load_bundle

    t0 = time.perf_counter()
    for key, proc in builds.items():
        proc.join(BREADTH_BUILD_WAIT_S)
        if proc.exitcode != 0:
            raise AssertionError(f"bench: building the {key} bundle: exit code "
                                 f"{proc.exitcode} (alive {proc.is_alive()})")
    log(f"bench: the breadth bundles' builds joined after {time.perf_counter() - t0:.1f}"
        " s of waiting")
    queries, gt_ids, gt_dists = load_bundle(prefix, Q)
    rows = {}
    runs = [(variant, launched, lambda variant=variant: bench.sweep_variant(
                prefix, variant, queries, gt_ids, gt_dists, refine=True,
                measure_serving=True, device=dev))
            for variant, launched in (("exactdistance", {"exact_frontier"}),
                                      ("inmemory", {"frontier_lookup"}))]
    runs += [(key, launched, lambda key=key: bench.breadth_row(key, dev))
             for key, launched in (("gist960", {"frontier_lookup"}),
                                   ("glove200_mips", set()),
                                   ("spacev_int8", {"frontier_lookup"}))]
    for key, launched, run in runs:
        t0 = time.perf_counter()
        row = rows[key] = counted(f"bench {key}", launched, run, totals)
        log(f"bench {key} ({time.perf_counter() - t0:.1f} s): " + json.dumps(row))
        if "error" in row or row["recall"] < RECALL_TARGET or not row["frontier"]:
            raise AssertionError(f"bench {key}: not a refined point past "
                                 f"{RECALL_TARGET}: {row}")
    if rows["inmemory"].get("device_ms_full_batch") is None:
        raise AssertionError("bench inmemory: no serving rows on the card")

    gen = torch.Generator(device=dev).manual_seed(17)
    kern["frontier_lookup"]["other_shapes"] = shapes = []
    for key in ("gist960", "spacev_int8"):
        _name, n, _d, r, m, *_ = bench.BREADTH[key]
        beam = rows[key]["beam"]
        rec = _k2_at(gen, f"{key}: Q={bench.BREADTH_Q} N={n} R={r} m={m} beam {beam}",
                     bench.BREADTH_Q, n, r, m, beam, dev)
        _note_err(kern, "frontier_lookup", rec["max_abs_err"])
        shapes.append(rec)
        log(f"bench K2 at {rec['shape']}: {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
            f"ms ({rec['bound_ms'] / rec['ms']:.0%}), plain {rec['plain_ms']:.4f} ms")
    torch.cuda.empty_cache()

    fresh = {"inmemory": rows["inmemory"], "gist960": {"error": "skipped"}}
    earlier = {"gist960": rows["gist960"], "exactdistance": rows["exactdistance"],
               "spacev_int8": {"error": "failed"}}
    merged, carried = merge_bench_json.merge(fresh, earlier, "earlier.json")
    if (carried != ["gist960", "exactdistance"] or "spacev_int8" in merged
            or merged["inmemory"] != rows["inmemory"]
            or merged["gist960"] != dict(rows["gist960"], carried_from="earlier.json")):
        raise AssertionError(f"merge_bench_json: carried {carried}, keys {list(merged)}")
    log(f"bench merge_bench_json: carried {carried}, errored earlier row not carried")
    return rows


def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _xla_close(label, auto, xla, gt_ids, gt_dists):
    """"xla" against "auto": recall@10 within XLA_RECALL_SLACK; the share
    of identical id rows is reported, and on those rows the distances
    (exact re-rank or exact walk) must be identical."""
    from bang_tpu_torch.utils.recall import calculate_recall

    r_a = calculate_recall(gt_ids, auto["ids"], K, gt_dists)
    r_x = calculate_recall(gt_ids, xla["ids"], K, gt_dists)
    same = (auto["ids"] == xla["ids"]).all(1)
    if abs(r_a - r_x) > XLA_RECALL_SLACK:
        raise AssertionError(f"{label}: xla recall@10 {r_x:.2f}, auto {r_a:.2f}")
    if not np.array_equal(auto["dists"][same], xla["dists"][same]):
        raise AssertionError(f"{label}: xla distances differ on identical id rows")
    log(f"{label}: xla recall@10 {r_x:.2f} against auto {r_a:.2f}; ids identical on "
        f"{same.mean():.2%} of queries, iterations {xla['iters']} against {auto['iters']}")


def _captured_hbm(fn, index, queries, params):
    """One search at a key after its first call (the eager loop and the
    capture): the captured loop's `_hbm_call`."""
    from bang_tpu_torch.models import compiled

    compiled.readback(fn(index, queries, params)[0])
    return _hbm_call(fn, index, queries, params)


def _stats_params(engine, variant, L, stats, n):
    """The engine's search at L and BEAM_EXTRA's beam and extra, with or
    without ENABLE_GPU_STATS, captured at Q=n (new parameters drop the
    last capture)."""
    from bang_tpu_torch.constants import ENABLE_GPU_STATS

    beam, extra = BEAM_EXTRA[variant]
    engine.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra,
                                 capabilities=ENABLE_GPU_STATS if stats else 0)
    engine.bang_alloc(n)


def _graph_against_events(engine, queries_dev):
    """(dev.graph ms, event ms) of one launch of the engine's captured loop
    on queries already on the card: the stage clock's span beside a CUDA
    event pair recorded around the launch. A spin kernel runs first, so
    the host has enqueued the launch before the first event fires: the
    pair holds the card's time, not the host's enqueue (about 0.2 ms a
    launch on an H100, 4% of an exact L=10 call)."""
    from bang_tpu_torch.models import compiled

    loop = compiled.graph_cache(engine._index).loops[0]
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    _, stats = loop.launch(queries_dev)
    e1.record()
    e1.synchronize()
    return sum(stats.sync().stage_ms.values()), e0.elapsed_time(e1)


def _timer_step(dev, n=200):
    """%globaltimer's step: the ns between two back-to-back stamps, n
    times; returns (the distinct readings, their greatest common divisor)."""
    import math

    from bang_tpu_torch.ops.stage_clock import StageClock

    clock = StageClock(dev)
    deltas = []
    for _ in range(n):
        clock.start()
        clock.stamp("tables")
        deltas.append(int(clock.buf[0]))
    return sorted(set(deltas)), math.gcd(*deltas)


def phase_stats(prefix, dev, totals):
    """Phase 22 (module docstring); returns its rows."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.formats.bin_io import load_bin
    from bang_tpu_torch.ops import stage_clock as sc

    queries = load_bin(prefix + "_query.bin", np.uint8)
    queries_dev = torch.as_tensor(queries, device=dev).float()
    kernels = {"inmemory": {"frontier_lookup"}, "exactdistance": {"exact_frontier"}}
    rows = {}
    for variant, L in STATS_POINTS:
        label = f"stats {variant} L={L}"
        engine = BANGSearch(variant, device=dev)
        engine.bang_load(prefix)  # once: the stats-off search first, then the stats-on
        _stats_params(engine, variant, L, False, len(queries))
        ids_off, d_off = counted(f"{label} off", kernels[variant],
                                 lambda: engine.bang_query(queries), totals)
        iters_off = engine.last_stats.iters
        if sc.launches():
            raise AssertionError(f"{label}: a stats-off call launched "
                                 f"{sc.stage_clock.launches} stamps")
        _stats_params(engine, variant, L, True, len(queries))
        ids_on, d_on = counted(f"{label} on", kernels[variant],
                               lambda: engine.bang_query(queries), totals)
        iters, stamps = engine.last_stats.iters, sc.launches()
        if not (np.array_equal(ids_on, ids_off) and np.array_equal(d_on, d_off)
                and iters == iters_off):
            raise AssertionError(f"{label}: answers with the stats differ from without")
        if stamps != 5 * (iters - 1) + 4:
            raise AssertionError(f"{label}: {stamps} stamps at {iters} iterations, "
                                 f"expected {5 * (iters - 1) + 4}")
        waits = engine.timers.counts["host_waits"]
        if waits != 1:
            raise AssertionError(f"{label}: {waits} host waits")
        split = {k: round(v, 4) for k, v in sorted(engine.timers.ms.items())}
        pairs = [_graph_against_events(engine, queries_dev) for _ in range(STATS_CALLS)]
        ratios = sorted(g / e for g, e in pairs)
        ratio = ratios[len(ratios) // 2]
        log(f"{label}: ids and distances identical, {iters} iterations, {stamps} "
            f"stamps, 1 host wait; report ms {split}; setup {engine.timers.setup}; "
            "dev.graph / event ms " + ", ".join(f"{g:.4f}/{e:.4f}" for g, e in pairs)
            + f" (median ratio {ratio:.4f})")
        if abs(ratio - 1) > 0.03:
            raise AssertionError(f"{label}: dev.graph / event pair {ratio:.4f}, "
                                 "outside 3%")
        launches = _stats_launches(label, engine, queries, next(iter(kernels[variant])))
        visited_ms = {"kernel": split["dev.visited"],
                      "plain": _plain_visited_ms(label, engine, variant, L, queries,
                                                 ids_on, d_on)}
        log(f"{label}: dev.visited {visited_ms['kernel']:.4f} ms a call with the "
            f"visited filter's kernel, {visited_ms['plain']:.4f} ms captured with its "
            "plain version (answers identical)")
        rows[variant] = {"L": L, "iters": iters, "stamps": stamps, "split_ms": split,
                         "graph_event_ms": pairs, "launches": launches,
                         "visited_ms": visited_ms}
        engine.bang_unload()
        torch.cuda.empty_cache()
    readings, step = _timer_step(dev)
    log(f"stats: %globaltimer back-to-back stamps read {readings[:12]} ns "
        f"({len(readings)} distinct), step {step} ns; on {_smi()}")
    rows["timer_step_ns"] = step
    return rows


def _stats_launches(label, engine, queries, kernel):
    """Phase 22: one more captured call, its launches read: the path's
    kernel and the visited filter once a step."""
    from bang_tpu_torch.ops import pq_kernels as pk

    pk.reset_launch_counts()
    engine.bang_query(queries)
    counts = {k: c for k, c in pk.launch_counts().items() if c}
    steps = engine.last_stats.iters - 1
    if counts != _step_launches(kernel, steps):
        raise AssertionError(f"{label}: launches {counts} a captured call of {steps} steps")
    log(f"{label}: launches a captured call {counts} ({steps} steps)")
    return counts


def _plain_visited_ms(label, engine, variant, L, queries, ids, dists):
    """Phase 22: the engine's stats-on search captured again with the
    visited filter's plain version in the traversal's step (the PyTorch
    composition it replaced); its `dev.visited` ms a call. Its answers
    must be `ids` and `dists`. The plain capture is dropped after."""
    from bang_tpu_torch.models import compiled, traversal
    from bang_tpu_torch.ops import visited

    compiled.drop_graphs(engine._index)
    traversal.visited_filter = visited.visited_filter_plain
    try:
        _stats_params(engine, variant, L, True, len(queries))
        got_ids, got_d = engine.bang_query(queries)
        ms = engine.timers.ms["dev.visited"]
    finally:
        traversal.visited_filter = visited.visited_filter
        compiled.drop_graphs(engine._index)
    if not (np.array_equal(got_ids, ids) and np.array_equal(got_d, dists)):
        raise AssertionError(f"{label}: answers with the plain visited filter differ")
    return ms


def _nbr_layout_points(ixs, queries):
    """Phase 20, layouts: at each L of NBR_L the neighbor-aligned layout
    through phase 18's eager-captured pattern (_captured_point), its ids,
    distances, iterations and distance computations identical to the fused
    and the scattered layouts' captured calls, each layout's kernel once a
    step; at the largest L all three through _captured_point (walls, busy
    shares, pools beside each other)."""
    from bang_tpu_torch.models import compiled, inmemory
    from bang_tpu_torch.utils.config import SearchParams

    beam, extra = BEAM_EXTRA["inmemory"]
    q = torch.as_tensor(queries)
    for L in NBR_L:
        pts = {}
        for name, ix in ixs.items():
            if name == "nbr_codes" or L == NBR_L[-1]:
                pts[name] = _captured_point(ix, "inmemory", L, "medoid", "exact", queries,
                                            f"phase 20 inmemory {name}")
                pts[name]["run"] = pts[name]["walls"]["captured"][0]
            else:
                params = SearchParams(L=L, k=K, beam_width=beam, extra_iters=extra)
                run = _captured_hbm(inmemory.search_inmemory, ix, q, params)
                kernel = "pq_lookup" if ix.fused_rows is None else "frontier_lookup"
                if run["launches"] != _step_launches(kernel, run["iters"] - 1):
                    raise AssertionError(f"phase 20 {name} L={L}: launches "
                                         f"{run['launches']}")
                pts[name] = {"run": run}
            compiled.drop_graphs(ix)
        nbr = pts["nbr_codes"]["run"]
        for other in ("fused", "scattered"):
            _same_result(f"phase 20 nbr_codes against {other} L={L}", nbr,
                         pts[other]["run"])
        log(f"phase 20 L={L}: nbr_codes ids, distances, iterations ({nbr['iters']}) "
            f"and distance computations ({nbr['dist_comps']}) identical to fused and "
            f"scattered; K1 launches a call {nbr['launches']}; captured walls "
            + ", ".join(f"{k} {p['run']['wall_s']:.4f}" for k, p in pts.items())
            + " s; captured " + "; ".join(f"{k} {_busy_text(p['prof']['captured'])}"
                                          for k, p in pts.items() if "prof" in p))


def _impl_points(prefix, dev, ixs, exact_ixs, queries, gt_ids, gt_dists):
    """Phase 20, pq_impl: each value through the three variants at IMPL_L.
    "pallas" and "pallas_dma" identical to "auto" (ids, distances,
    iterations, distance computations, the kernel once a step); "xla" runs
    no kernel (the f32 lookups) and stays within XLA_RECALL_SLACK;
    "pallas_dma" without fused rows raises, as JAX's does."""
    from bang_tpu_torch.models import compiled, exactdistance, inmemory
    from bang_tpu_torch.models.base import BaseVariantSearcher
    from bang_tpu_torch.utils.config import SearchParams

    q = torch.as_tensor(queries)
    variants = [("inmemory", name, ix, inmemory.search_inmemory)
                for name, ix in ixs.items()]
    variants += [("exactdistance", name, ix, exactdistance.search_exact)
                 for name, ix in exact_ixs.items()]
    for variant, name, ix, fn in variants:
        beam, extra = BEAM_EXTRA[variant]
        runs = {}
        for impl in PQ_IMPLS:
            params = SearchParams(L=IMPL_L[variant], k=K, beam_width=beam,
                                  extra_iters=extra, pq_impl=impl)
            fused = ix.fused_rows is not None or ix.fused_vec_rows is not None
            if impl == "pallas_dma" and not fused:
                try:
                    fn(ix, q, params)
                except ValueError as e:
                    if "fused" not in str(e):
                        raise
                    log(f"phase 20 {variant} {name} pallas_dma raises: {e}")
                    continue
                raise AssertionError(f"{variant} {name}: pallas_dma did not raise")
            runs[impl] = _captured_hbm(fn, ix, q, params)
            compiled.drop_graphs(ix)
        kernel = {"fused": "frontier_lookup", "nbr_codes": "pq_lookup",
                  "scattered": "pq_lookup"}[name] if variant == "inmemory" else (
                      "exact_frontier" if name == "fused" else None)
        label = f"phase 20 {variant} {name} L={IMPL_L[variant]}"
        for impl, run in runs.items():
            pq_route = variant == "inmemory" and impl == "xla"
            want = _step_launches(None if pq_route else kernel, run["iters"] - 1)
            if run["launches"] != want:
                raise AssertionError(f"{label} {impl}: launches {run['launches']}, "
                                     f"expected {want}")
            if impl != "auto" and not pq_route:
                _same_result(f"{label} {impl} against auto", run, runs["auto"])
        if variant == "inmemory":
            _xla_close(f"{label}", runs["auto"], runs["xla"], gt_ids, gt_dists)
        log(f"{label}: " + ", ".join(f"{k} {r['wall_s']:.4f} s" for k, r in runs.items())
            + "; pallas and pallas_dma identical to auto")

    searcher = BaseVariantSearcher(prefix, BASE_PIPELINE, mmap=False, device=dev)
    runs = {}
    for impl in PQ_IMPLS:
        params = SearchParams(L=IMPL_L["base"], k=K, beam_width=BASE_BEAM,
                              extra_iters=BASE_EXTRA, pq_impl=impl)
        searcher.search(queries, params)  # the key's eager call, then its capture
        runs[impl] = _base_call(searcher, queries, params)
    label = f"phase 20 base L={IMPL_L['base']}"
    for impl, run in runs.items():
        want = {} if impl == "xla" else {"pq_lookup": run["steps"]}
        if run["launches"] != want:
            raise AssertionError(f"{label} {impl}: launches {run['launches']}, "
                                 f"expected {want}")
        if impl in ("pallas", "pallas_dma"):
            _same_result(f"{label} {impl} against auto", run, runs["auto"],
                         ("ids", "dists", "steps"))
    _xla_close(label, {**runs["auto"], "iters": runs["auto"]["steps"]},
               {**runs["xla"], "iters": runs["xla"]["steps"]}, gt_ids, gt_dists)
    log(f"{label}: " + ", ".join(f"{k} {r['wall_s']:.4f} s" for k, r in runs.items()))
    del searcher


def _ranked_points(dev, ixs, exact_ixs, queries):
    """Phase 20, the ranked merge: BANG_MERGE_IMPL=ranked at the profiled
    fused L=128 and exact L=100 searches, ids, distances, iterations and
    distance computations identical to the sort merge's (a new graph key
    captures it); then profile_base_step's merge_sort and merge_ranked ms
    at those two searches' shapes."""
    from bang_tpu_torch.models import compiled, exactdistance, inmemory
    from bang_tpu_torch.scripts import profile_base_step
    from bang_tpu_torch.utils.config import SearchParams

    q = torch.as_tensor(queries)
    for variant, ix, fn, L in (
            ("inmemory", ixs["fused"], inmemory.search_inmemory, PROFILE_L),
            ("exactdistance", exact_ixs["fused"], exactdistance.search_exact,
             EXACT_PROFILE_L)):
        beam, extra = BEAM_EXTRA[variant]
        params = SearchParams(L=L, k=K, beam_width=beam, extra_iters=extra)
        runs = {"sort": _captured_hbm(fn, ix, q, params)}
        os.environ["BANG_MERGE_IMPL"] = "ranked"
        try:
            runs["ranked"] = _captured_hbm(fn, ix, q, params)
        finally:
            del os.environ["BANG_MERGE_IMPL"]
        compiled.drop_graphs(ix)
        _same_result(f"phase 20 ranked merge {variant} L={L}", runs["ranked"],
                     runs["sort"], ("ids", "dists", "iters", "dist_comps", "launches"))
        log(f"phase 20 ranked merge {variant} L={L}: ids, distances, iterations "
            f"({runs['sort']['iters']}) identical to the sort merge; captured walls "
            f"sort {runs['sort']['wall_s']:.4f} s, ranked {runs['ranked']['wall_s']:.4f} "
            f"s; peak GB sort {runs['sort']['peak_gb']:.2f}, ranked "
            f"{runs['ranked']['peak_gb']:.2f}")
        prof = profile_base_step.main("cuda", q=Q, beam=beam, r=R, m=M, n=N, extra=extra,
                                      l_grid=(L,))
        row = prof["per_L"][str(L)]
        log(f"phase 20 profile_base_step at {variant} L={L} (Q={Q}, beam {beam}, "
            f"R={R}): merge_sort {row['merge_sort']} ms, merge_ranked "
            f"{row['merge_ranked']} ms a merge, on {_smi()}")


def _nbr_server(prefix, dev, queries):
    """Phase 20, serving: SearchServer over the neighbor-aligned layout,
    NBR_SERVER_REQUESTS requests of SERVER_BATCH, ids and distances
    identical to a server on the fused layout."""
    from bang_tpu_torch.harness.serving import SearchServer
    from bang_tpu_torch.utils.config import SearchParams

    beam, extra = BEAM_EXTRA["inmemory"]
    params = SearchParams(L=WARMUP_L["inmemory"], k=K, beam_width=beam, extra_iters=extra)
    qs = queries[: NBR_SERVER_REQUESTS * SERVER_BATCH]
    out = {}
    for name, load in (("nbr_codes", {"neighbor_codes": True}), ("fused", {})):
        server = SearchServer(prefix, "inmemory", batch_size=SERVER_BATCH, params=params,
                              device=dev, **load)
        out[name] = (*server.query(qs), server.latency_percentiles())
        server.close()
        torch.cuda.empty_cache()
    a, b = out["nbr_codes"], out["fused"]
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        raise AssertionError("SearchServer on nbr_codes differs from the fused layout")
    log(f"phase 20 SearchServer nbr_codes, {NBR_SERVER_REQUESTS} requests of "
        f"{SERVER_BATCH}: ids and distances identical to the fused layout's; latency "
        f"ms nbr_codes " + ", ".join(f"{k} {v:.3f}" for k, v in a[2].items())
        + "; fused " + ", ".join(f"{k} {v:.3f}" for k, v in b[2].items()))


def _layout_probes(totals):
    """Phase 20, probes: exp_fused32, exp_gather and exp_decode at their own
    sizes, each counted, their times printed beside the card."""
    smi = _smi()
    for name, launched in LAYOUT_PROBES:
        mod = importlib.import_module(f"bang_tpu_torch.scripts.{name}")
        t0 = time.perf_counter()
        res = counted(f"probe {name}", launched, lambda: mod.main("cuda"), totals)
        log(f"probe {name} took {time.perf_counter() - t0:.1f}s on {smi}: "
            + json.dumps(res, default=str))
        torch.cuda.empty_cache()


def phase_layouts(prefix, dev, totals):
    """Phase 20: the neighbor-aligned layout, every pq_impl, the ranked
    merge, the server over the new layout and the three layout probes
    (see the module docstring)."""
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.models.index import device_index_from_files, free_device_index

    t0 = time.perf_counter()
    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    ixs = {}
    for name, kw in (("nbr_codes", {"neighbor_codes": True}), ("fused", {}),
                     ("scattered", {"fused_frontier": False})):
        t1 = time.perf_counter()
        ixs[name] = device_index_from_files(prefix, dev, "inmemory", **kw)
        ix = ixs[name]
        gb = sum(t.numel() for t in (ix.nbr_codes, ix.adj_planes, ix.fused_rows, ix.adj)
                 if t is not None) / 1e9
        log(f"phase 20 {name} index loaded in {time.perf_counter() - t1:.1f}s, "
            f"{gb:.2f} GB of layout tables")
    exact_ixs = {name: device_index_from_files(prefix, dev, "exactdistance", **kw)
                 for name, kw in (("fused", {}), ("scattered", {"fused_frontier": False}))}
    counted("phase 20 layouts", {"pq_lookup", "frontier_lookup"},
            lambda: _nbr_layout_points(ixs, queries), totals)
    counted("phase 20 pq_impl", {"pq_lookup", "frontier_lookup", "exact_frontier"},
            lambda: _impl_points(prefix, dev, ixs, exact_ixs, queries, gt_ids, gt_dists),
            totals)
    counted("phase 20 ranked merge", {"pq_lookup", "frontier_lookup", "exact_frontier"},
            lambda: _ranked_points(dev, ixs, exact_ixs, queries), totals)
    for ix in (*ixs.values(), *exact_ixs.values()):
        free_device_index(ix)
    del ixs, exact_ixs
    counted("phase 20 server", {"pq_lookup", "frontier_lookup"},
            lambda: _nbr_server(prefix, dev, queries), totals)
    _layout_probes(totals)
    log(f"phase 20 (layouts, pq_impl, ranked merge, probes) "
        f"{time.perf_counter() - t0:.1f}s")


def scale_run(dev, n, out_dir):
    """`--scale N` (not a phase of the default run): build_100m at N in 4
    shards, each shard's peak beside shard_build_hbm_bytes; base through
    run_eval memory-mapped and in RAM (each with its sampled-entry probe)
    at SCALE_RUN_L; the first call against the second under mmap; the base
    profile at the in-RAM row's L; in-memory through run_eval at
    SCALE_RUN_IM_L; K1 and K2 at this bundle's widths against their plain
    versions, timed, with bounds. Writes <out_dir>/scale_<n>*.json."""
    from bang_tpu_torch.models.base import BaseVariantSearcher
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts import build_100m, run_eval
    from bang_tpu_torch.scripts import _common as cm
    from bang_tpu_torch.scripts.bundles import load_bundle
    from bang_tpu_torch.scripts.profile_base_step import profile_base
    from bang_tpu_torch.utils.config import SearchParams

    os.makedirs(out_dir, exist_ok=True)
    result = {"n": n, "shards": 4}
    t0 = time.perf_counter()
    with _shard_peaks() as peaks:
        prefix, result["stages_s"] = build_100m.main(n=n, n_shards=4, device=dev)
    result["build_s"] = time.perf_counter() - t0
    result["shard_peaks"] = _log_shard_peaks("scale build", peaks, SCALE_R, SCALE_BATCH,
                                             SCALE_LBUILD)
    log(f"scale build N={n}: stage seconds {result['stages_s']}")
    counts = {}

    def evaluated(label, args):
        pk.reset_launch_counts()
        out = os.path.join(out_dir, f"scale_{n}_{label}.json")
        row = run_eval.main(["--prefix", prefix, "--out", out, "--device", dev.type,
                             *args])
        counts[label] = pk.launch_counts()
        log(f"scale {label}: launches {counts[label]}")
        return row

    base = ["--variant", "base", "--grid", *map(str, SCALE_RUN_L), "--beam",
            str(BASE_BEAM), "--extra", str(SCALE_RUN_EXTRA), "--n-pipeline",
            str(BASE_PIPELINE), "--probe-sampled-entry"]
    result["base_mmap"] = evaluated("base_mmap", base + ["--mmap"])
    result["base_ram"] = evaluated("base_ram", base + ["--no-mmap"])

    queries = load_bundle(prefix, Q)[0]
    searcher = BaseVariantSearcher(prefix, BASE_PIPELINE, mmap=True, device=dev)
    params = SearchParams(L=SCALE_RUN_FIRST_TOUCH_L, k=K, beam_width=BASE_BEAM,
                          extra_iters=SCALE_RUN_EXTRA)
    walls = []
    for _ in range(2):  # a fresh mapping's first call, then the second
        t1 = time.perf_counter()
        searcher.search(queries, params)
        walls.append(time.perf_counter() - t1)
    result["mmap_first_and_second_call_s"] = walls
    log(f"scale base mmap L={params.L}: first call {walls[0]:.4f} s, second "
        f"{walls[1]:.4f} s")
    del searcher
    result["profile_base"] = profile_base(prefix, dev, result["base_ram"]["L"], BASE_BEAM,
                                          SCALE_RUN_EXTRA, BASE_PIPELINE, K)
    torch.cuda.empty_cache()
    result["inmemory"] = evaluated("inmemory", ["--variant", "inmemory", "--grid",
                                                *map(str, SCALE_RUN_IM_L)])
    result["launches"] = counts
    torch.cuda.empty_cache()

    kern = {name: {"max_abs_err": 0.0} for name in ("pq_lookup", "frontier_lookup")}
    gen = torch.Generator(device=dev).manual_seed(16)
    q_b, c, m = Q // BASE_PIPELINE, BASE_BEAM * SCALE_R, SCALE_M
    packed = pk.pack_tables(cm.tables(gen, q_b, m, dev))
    codes = cm.u8(gen, (q_b, c, m), dev)
    kern["pq_lookup"]["max_abs_err"] = cm.dist_err(
        "pq_lookup", pk.pq_lookup(packed, codes), pk.lookup_packed_plain(packed, codes))
    label = f"base sub-batch Q={q_b} C={c} m={m}"
    _time_pair(kern, "pq_lookup", label, lambda: pk.pq_lookup(packed, codes),
               lambda: pk.lookup_packed_plain(packed, codes))
    _bound(kern, "pq_lookup", packed.numel() * 4 + codes.numel() + q_b * c * 4,
           q_b * c * m)
    kern["frontier_lookup"] = _k2_at(gen, f"Q={Q} N={n} R={SCALE_R} m={m} beam 2", Q, n,
                                     SCALE_R, m, BEAM_EXTRA["inmemory"][0], dev)
    result["kernels"] = kern
    with open(os.path.join(out_dir, f"scale_{n}.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    log(f"scale run N={n}: {json.dumps(kern)}")


def _write_vecs(path, arr):
    """A TexMex vecs file: each row as <int32 dim><dim 4-byte elements>."""
    rec = np.empty((arr.shape[0], 1 + arr.shape[1]), "<i4")
    rec[:, 0] = arr.shape[1]
    rec[:, 1:] = np.ascontiguousarray(arr).view("<i4")
    rec.tofile(path)


def write_corpus(root, name, n, d, nq, integer, seed, dev):
    """Fabricate a TexMex corpus under `root` in the layout DATASETS[name]
    of scripts/get_real_data.py names: make_clustered_data points (u8
    values stored as f32 where `integer`, as SIFT's are), queries = points
    + noise, the top-REAL_GT_K ground truth ids from formats/accel.
    compute_groundtruth on `dev`. Returns (base, queries) f32."""
    from bang_tpu_torch.formats.accel import compute_groundtruth
    from bang_tpu_torch.formats.synthetic import make_clustered_data
    from bang_tpu_torch.scripts.get_real_data import DATASETS

    rng = np.random.default_rng(seed)
    base = make_clustered_data(n, d, n_clusters=max(64, n // 1000),
                               dtype=np.uint8 if integer else np.float32,
                               seed=seed).astype(np.float32)
    picks = base[rng.integers(0, n, nq)]
    if integer:
        queries = np.clip(np.rint(picks + rng.normal(0, 2.0, (nq, d))), 0, 255)
    else:
        queries = picks + rng.normal(0, 0.05, (nq, d))
    queries = queries.astype(np.float32)
    gt_ids, _ = compute_groundtruth(base, queries, REAL_GT_K, dev)
    cfg = DATASETS[name]
    for key, arr in (("base", base), ("query", queries), ("gt", gt_ids.astype(np.int32))):
        path = os.path.join(root, cfg[key])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _write_vecs(path, arr)
    return base, queries


class _Tee:
    """A stdout that also keeps what it was given."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_real(root, name, nq, dev):
    """scripts/get_real_data.py on the corpus under `root` with
    --skip-download, on `dev`, in this process. Each of the harness
    driver's calls is recorded by L: its reps (wall ms, QPS, recall@10
    over the truthset's true distances, and the same ids' recall@10 over
    a zero-distance truthset, as the JAX script writes), and the rep the
    harness driver's `best` row reports (the fastest after the first).
    Returns {"rc", "stages_s" (the script's printed line), "rows"}."""
    import sys

    from bang_tpu_torch.harness import driver
    from bang_tpu_torch.scripts import get_real_data

    rows, zero = [], []
    run_L, recall = driver.run_L, driver.calculate_recall

    def scored(gt_ids, ids, k, gt_dists):
        zero.append(recall(gt_ids, ids, k, np.zeros_like(gt_dists)))
        return recall(gt_ids, ids, k, gt_dists)

    def by_L(engine, queries, gt_ids, gt_dists, L, *args, **kwargs):
        first = len(zero)
        reps = run_L(engine, queries, gt_ids, gt_dists, L, *args, **kwargs)
        reps = [{"wall_ms": w, "qps": q, "recall": r, "recall_zero_dists": z}
                for (w, q, r), z in zip(reps, zero[first:], strict=True)]
        best = max(reps[1:] or reps, key=lambda rep: rep["qps"])
        rows.append({"L": L, "reps": reps, "best": best})
        return [(rep["wall_ms"], rep["qps"], rep["recall"]) for rep in reps]

    tee = _Tee(sys.stdout)
    driver.run_L, driver.calculate_recall = by_L, scored
    try:
        with contextlib.redirect_stdout(tee):
            rc = get_real_data.main([name, "--dir", root, "--skip-download", "--device",
                                     dev.type, "--num-queries", str(nq)])
    finally:
        driver.run_L, driver.calculate_recall = run_L, recall
    marker = "[real] stage seconds "
    stages = [line[len(marker):] for line in "".join(tee.parts).splitlines()
              if line.startswith(marker)]
    return {"rc": rc, "stages_s": json.loads(stages[-1]) if stages else None,
            "rows": rows}


def check_real(name, root, base, queries, res):
    """Phase 21's bars on one run_real result: rc 0, every stage timed, the
    harness driver's last `best` recall@10 >= RECALL_TARGET over true
    distances, the truthset's distances equal to a float64 recomputation
    within REAL_DIST_RTOL. Logs each L's walls, QPS and both recalls."""
    from bang_tpu_torch.formats.bin_io import load_truthset

    if res["rc"] != 0:
        raise AssertionError(f"real {name}: get_real_data returned {res['rc']}")
    stages = res["stages_s"] or {}
    if not set(REAL_STAGES) <= set(stages):
        raise AssertionError(f"real {name}: stage seconds {stages}, want {REAL_STAGES}")
    log(f"real {name}: stage seconds " + ", ".join(f"{k} {v:.3f}"
                                                   for k, v in stages.items()))
    for row in res["rows"]:
        b = row["best"]
        log(f"real {name} L={row['L']}: best wall {b['wall_ms']:.3f} ms, QPS "
            f"{b['qps']:.1f}, recall@10 {b['recall']:.2f} over true distances, "
            f"{b['recall_zero_dists']:.2f} over zero distances (reps: " + "; ".join(
                f"{r['wall_ms']:.3f} ms {r['recall']:.2f}/{r['recall_zero_dists']:.2f}"
                for r in row["reps"]) + ")")
    if not res["rows"] or res["rows"][-1]["best"]["recall"] < RECALL_TARGET:
        raise AssertionError(f"real {name}: the sweep ended below recall@10 "
                             f"{RECALL_TARGET}: {res['rows'][-1:]}")
    ids, dists = load_truthset(os.path.join(root, name + "_gt.bin"))
    want = ((base[ids.astype(np.int64)].astype(np.float64)
             - queries[: len(ids), None, :].astype(np.float64)) ** 2).sum(-1)
    err = float((np.abs(dists - want) / np.maximum(want, 1e-30)).max())
    if not np.allclose(dists, want, rtol=REAL_DIST_RTOL, atol=0.0):
        raise AssertionError(f"real {name}: truthset distances off by {err:.3e} "
                             f"relative (> {REAL_DIST_RTOL})")
    log(f"real {name}: truthset distances within {err:.3e} relative of float64 "
        f"({ids.shape[0]} x {ids.shape[1]})")
    return err


def phase_real(dev, totals):
    """Phase 21: the real-corpus pipeline (scripts/get_real_data.py) on
    each of REAL_CORPORA, fabricated into a temp dir: K2 launched and no
    other kernel, check_real's bars. Returns {dataset: the last L's best}."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        for name, n, d, nq, integer, seed in REAL_CORPORA:
            t0 = time.perf_counter()
            base, queries = write_corpus(tmp, name, n, d, nq, integer, seed, dev)
            log(f"real {name}: {n} x {d} f32, {nq} queries, top-{REAL_GT_K} ground "
                f"truth written in {time.perf_counter() - t0:.2f}s")
            t0 = time.perf_counter()
            res = counted(f"real {name}", {"frontier_lookup"},
                          lambda: run_real(tmp, name, nq, dev), totals)
            log(f"real {name}: script {time.perf_counter() - t0:.2f}s")
            check_real(name, tmp, base, queries, res)
            out[name] = res["rows"][-1]
            torch.cuda.empty_cache()  # the graphs bang_unload dropped
    return out


def real_run(dev, name, out_dir):
    """`--real NAME` (not a phase of the default run): REAL_RUNS[name]'s
    corpus fabricated at its published shape, then scripts/get_real_data.py
    on it as in phase 21 (the same bars, K2 the only kernel). Writes
    <out_dir>/real_<name>.json: the stage seconds, each L's walls, QPS and
    recall@10 under both truthsets, K2's launches, the card."""
    from bang_tpu_torch.ops import pq_kernels as pk

    n, d, nq, integer, seed = REAL_RUNS[name]
    os.makedirs(out_dir, exist_ok=True)
    result = {"dataset": name, "n": n, "dim": d, "queries": nq, "gt_k": REAL_GT_K,
              "integer_values": integer, "seed": seed, "card": _smi()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        t0 = time.perf_counter()
        base, queries = write_corpus(tmp, name, n, d, nq, integer, seed, dev)
        result["fabricate_s"] = time.perf_counter() - t0
        log(f"real {name}: {n} x {d} f32, {nq} queries, top-{REAL_GT_K} ground truth "
            f"written in {result['fabricate_s']:.2f}s")
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_real(tmp, name, nq, dev)
        result["script_s"] = time.perf_counter() - t0
        result["launches"] = pk.launch_counts()
        result.update(res)
        log(f"real {name}: script {result['script_s']:.2f}s, launches "
            f"{result['launches']}")
        result["gt_dist_max_rel_err"] = check_real(name, tmp, base, queries, res)
    with open(os.path.join(out_dir, f"real_{name}.json"), "w") as f:
        json.dump(result, f, indent=1)
    if any((c > 0) != (k in ("frontier_lookup", "visited_filter"))
           for k, c in result["launches"].items()):
        raise AssertionError(f"real {name}: launches {result['launches']}, expected only "
                             f"frontier_lookup and visited_filter")


def counted(label, launched, fn, totals):
    """Run one search phase with every launch count zeroed just before and
    read just after; fail unless exactly the kernels named in `launched`
    ran, beside the visited filter, which every exact-mode step of a
    traversal launches (the phases that count steps check it once a step).
    Adds the counts to `totals`."""
    from bang_tpu_torch.ops import pq_kernels as pk

    pk.reset_launch_counts()
    out = fn()
    counts = pk.launch_counts()
    log(f"{label}: launches {counts}")
    if any((c > 0) != (name in launched) for name, c in counts.items()
           if name != "visited_filter"):
        raise AssertionError(f"{label}: launches {counts}, expected only {launched}")
    for name, c in counts.items():
        totals[name] += c
    return out


def _best(rows, what):
    best = max(rows, key=lambda row: row["recall"])
    if best["recall"] < RECALL_TARGET:
        raise AssertionError(f"{what}: best recall@10 {best['recall']:.2f} "
                             f"< {RECALL_TARGET}")
    return best


def search_phases(dev, totals, kern, builds):
    """Phases 4-21 on `dev`; adds the launch counts of 5-21 to `totals` (not
    those of the profiled calls after phases 5, 6, 7, 10 and 11, nor those
    of phase 14's K1 checks and phase 17's K2 checks, whose errors go into
    `kern`). Phase 17 runs after 14, on the bundle, once the processes
    `builds` have built its breadth bundles."""
    _start_profiler(dev)  # before the first capture (phase 5's bang_alloc)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        prefix = os.path.join(tmp, "synth1m")
        build_bundle(prefix, dev)

        fused = counted("search inmemory fused", {"frontier_lookup"},
                        lambda: run_search(prefix, dev, "inmemory", L_SWEEP), totals)
        best = _best(fused, "inmemory fused")
        profile_search(prefix, dev, "inmemory", PROFILE_L)
        scattered = counted("search inmemory scattered", {"pq_lookup"},
                            lambda: run_search(prefix, dev, "inmemory", (best["L"],),
                                               fused_frontier=False), totals)[0]
        # K1 and K2 sum the same bf16 entries in the same order
        same = (scattered["ids"] == best["ids"]).all(axis=1)
        if not same.all() or scattered["iters"] != best["iters"]:
            raise AssertionError(
                f"inmemory scattered differs from fused: ids on {int((~same).sum())} "
                f"queries, iterations {scattered['iters']} vs {best['iters']}")
        profile_search(prefix, dev, "inmemory", SCATTERED_PROFILE_L,
                       fused_frontier=False)

        exact = counted("search exactdistance fused", {"exact_frontier"},
                        lambda: run_search(prefix, dev, "exactdistance", EXACT_L_SWEEP),
                        totals)
        best_e = _best(exact, "exactdistance fused")
        profile_search(prefix, dev, "exactdistance", EXACT_PROFILE_L)
        exact_sc = counted("search exactdistance scattered", set(),
                           lambda: run_search(prefix, dev, "exactdistance",
                                              (best_e["L"],), fused_frontier=False),
                           totals)[0]
        same = (exact_sc["ids"] == best_e["ids"]).all(axis=1)
        if not same.all():
            raise AssertionError(f"exact scattered ids differ from fused on "
                                 f"{int((~same).sum())} queries")

        # at the best L and at the sweep's smallest, where the entry matters
        samp_e = counted("search exactdistance sampled", {"exact_frontier"},
                         lambda: run_search(prefix, dev, "exactdistance",
                                            sorted({EXACT_L_SWEEP[0], best_e["L"]}),
                                            entry_mode="sampled"), totals)
        samp = counted("search inmemory sampled", {"frontier_lookup"},
                       lambda: run_search(prefix, dev, "inmemory",
                                          sorted({L_SWEEP[0], best["L"]}),
                                          entry_mode="sampled"), totals)
        for medoid_rows, rows in ((exact, samp_e), (fused, samp)):
            for row in rows:
                m = next(r for r in medoid_rows if r["L"] == row["L"])
                log(f"entry at L={row['L']}: {row['search']} recall@10 "
                    f"{row['recall']:.2f} iters {row['iters']} | medoid recall@10 "
                    f"{m['recall']:.2f} iters {m['iters']}")
            if rows[-1]["recall"] < RECALL_TARGET:
                raise AssertionError(f"{rows[-1]['search']}: recall@10 "
                                     f"{rows[-1]['recall']:.2f} < {RECALL_TARGET}")
        best_b, base_rows = phase_base(prefix, dev, totals)
        t0 = time.perf_counter()
        counted("captured against eager", {"pq_lookup", "frontier_lookup",
                                           "exact_frontier"},
                lambda: phase_captured(prefix, dev), totals)
        log(f"phase 18 (captured against eager) {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        counted("captured build and streaming", set(),
                lambda: phase_captured_loops(dev), totals)
        log(f"phase 19 (captured loops) {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_stats(prefix, dev, totals)
        log(f"phase 22 (stats) {time.perf_counter() - t0:.1f}s")
        phase_bloom(prefix, dev, totals)
        phase_warmup_serving(prefix, dev, totals)
        best_s = phase_sharded(prefix, dev, totals, kern, base_rows)
        t0 = time.perf_counter()
        bench_rows = phase_bench(prefix, dev, totals, kern, builds)
        log(f"phase 17 (bench) {time.perf_counter() - t0:.1f}s")
        phase_layouts(prefix, dev, totals)
    phase_streaming(dev, totals)
    best_big = phase_bigbuild(dev, totals)
    best_scale = phase_scale(dev, totals)
    t0 = time.perf_counter()
    real = phase_real(dev, totals)
    log(f"phase 21 (real corpus) {time.perf_counter() - t0:.1f}s")
    log(f"ok: inmemory best L={best['L']} recall@10 {best['recall']:.2f}, "
        f"scattered ids and iterations identical; exactdistance best "
        f"L={best_e['L']} recall@10 {best_e['recall']:.2f}, scattered ids identical; "
        f"base best L={best_b['L']} recall@10 {best_b['recall']:.2f}, pipelined ids "
        f"identical to serial; bloom, warm-up, serving and streaming checked; sharded "
        f"best L={best_s['L']} recall@10 {best_s['recall']:.2f}; sharded build best "
        f"L={best_big['L']} recall@10 {best_big['recall']:.2f}; scale base (mmap ids "
        f"identical to RAM) best L={best_scale['L']} recall@10 "
        f"{best_scale['recall']:.2f}; nbr_codes layout, pq_impl, ranked merge and "
        f"layout probes checked; bench rows " + ", ".join(
            f"{k} L={r['L']} recall@10 {r['recall']:.2f}" for k, r in bench_rows.items())
        + "; real corpora " + ", ".join(
            f"{k} L={r['L']} recall@10 {r['best']['recall']:.2f} (zero distances "
            f"{r['best']['recall_zero_dists']:.2f})" for k, r in real.items()))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one CUDA card "
                                 "(phases 1-21; see the module docstring).")
    ap.add_argument("--scale", type=int, default=None, metavar="N",
                    help="instead: build_100m at N points and the scale run "
                         "(scale_run), results in <out>/scale_<N>*.json")
    ap.add_argument("--real", default=None, choices=sorted(REAL_RUNS),
                    help="instead: the real-corpus pipeline on a corpus fabricated "
                         "at its published shape (real_run), results in "
                         "<out>/real_<NAME>.json")
    ap.add_argument("--out", default=os.path.join("bench_data", "scale"),
                    help="the scale and real runs' output directory")
    args = ap.parse_args(argv)
    smi = phase_device()
    dev = torch.device("cuda")
    import bang_tpu_torch  # noqa: F401  (TF32 off)

    phase_build()
    if args.scale:
        scale_run(dev, args.scale, args.out)
        log(f"on {smi}")
        return
    if args.real:
        real_run(dev, args.real, args.out)
        log(f"on {smi}")
        return
    kern = phase_kernels(dev)
    phase_visited(dev, kern)
    t0 = time.perf_counter()
    phase_probes(dev, kern)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    probe_scripts(totals)
    log(f"probes {time.perf_counter() - t0:.1f}s")
    builds = start_breadth_builds(dev)
    try:
        search_phases(dev, totals, kern, builds)
    finally:
        stop_builds(builds)
    log(f"on {smi}")
    log(f"total {time.perf_counter() - _T0:.1f}s")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "also_replaces": also, "launches": totals[name],
         **{k: kern[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
         **{k: v for k, v in kern[name].items() if k == "other_shapes"}}
        for name, (src, rep, also) in KERNEL_SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
