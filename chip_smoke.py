#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jefferson_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py

Phases, one line each or more; any failure exits non-zero without a result
line:
  1. env     torch/CUDA versions and the card (nvidia-smi name, power limit);
             fails when torch.cuda.is_available() is false.  The oracle
             renders of the error budget and the paths start here, in worker
             processes, and are collected in phases 5 and 6; g++ builds the
             host library (native/native.cpp) before they start, as they
             plan through it.
  2. build   nvcc builds csrc/fused_step_onehot.cu (rows 1-4 and 8) and
             csrc/fused_step_gather.cu (rows 5-7) for fpb 128 / pad 1024
             (MAIN_GEOMETRY, -DJT_FPB=128 -DJT_PAD=1024), csrc/assoc_probe.cu
             (rows 9-11) and csrc/dma_blend.cu (row 12) for sm_90a, all at
             once.  After the live path (phase 5) the two render-step
             sources build for each geometry of phase 13 in a process of
             their own, one nvcc a library, all at once, while phases 6-10
             run; phase serve waits for them to end.
  3. plan    make_plan with the host library against its plain NumPy forms
             (bench.plain_host), every field bit-equal, on every source of the
             six scenes' three position sets and on the five single-source
             trajectories, each way timed in turns.
  4. kernel  every CUDA step against its plain-PyTorch twin, max|diff| <= 5e-7:
             the batched one-hot step (row 1) at the bench shape (256 sources
             x 64 blocks), compact and per-row distance, with the carried
             overlap-save history bit-equal to the stream's tail; the
             single-stream steps at B = 2048 blocks, compact and per-row
             distance: one-hot (row 3), grouped one-hot with 4 groups of 512
             blocks and 256-block tiles (row 4), and the gather form (row 5)
             with and without the crossfade; row 5's two forms bit-equal on a
             crossfade-free chunk.  The scene steps at the scene path's
             shapes, compact and per-row distance: the grouped batched
             one-hot step (row 2) at 16 x 256 with the group plan of
             bench.scene_mover_positions, the batched gather step (row 6) at
             16 x 256 in both forms, the apply-only step (row 7) at 16 x 512,
             segments of 512, in both forms; rows 6 and 7 each bit-equal
             across their forms on a crossfade-free chunk.  Row 8 (the
             full-table blend-apply-tail step) at the live stream's 1 row and
             render_scan's 12,556 rows, brackets over all 710 filters, the
             crossfade on all rows but every 7th, with and without duplicate
             brackets; its forward form (launch A at nb = 1 and 12,556, one
             stream) with the XD planes against _forward_reference (relative
             to their peak, 1e-6).  Row 8's two forms on the same operands at
             1, 2, 7 and SMALL_ROWS rows, random and duplicate brackets, ids
             outside the table: the cluster form bit-equal to launch B, with
             the crossfade and with the new brackets on both sides at xf = 0
             (a held block's use), which equals any old brackets at xf = 0;
             each within 5e-7 of its twin.  Launch B's split form (a cluster
             of four CTAs per tile) against its one-CTA form on the same operands,
             torch.equal, and within 5e-7 of the twin: rows 2 and 6 (both
             forms) at 1 x 8, 4 x 66 (segment and group ends inside tiles)
             and 16 x 256, compact and per-row distance, row 2 also with ids
             outside a group's table; rows 3-5 at 2048, row 7 at 16 x 512,
             row 8 at 12,556 rows (random and duplicate brackets).  Launch
             A's forms on the same operands, torch.equal in both XD planes:
             the product form (and the few-block form up to FEW_NB blocks)
             against the tile form, at the main path's shapes (256 x 64
             with one triple, 16 x 256 per row and with 8 triples, 1 x
             2048, 1 x 12,556, the live block's 1 x 1), ragged counts (1 x
             2-9, 33, 65; 4 x 66; 3 x 9) and 1-8 triples with selectors
             outside 1..n_dist-1 (4 x 66, 2 x 3), the product form within
             1e-6 of the twin's peak.  Row 1's staged form of launch B
             torch.equal to its one-CTA form at 256 x 64 (compact and per-row
             distance), 3 x 9, 4 x 66, 1 x 1, 7 x 40, with ids outside the
             table and with random ids over 700 rows, each within 5e-7 of
             the twin.  Row 12's dedup form torch.equal to its
             double-buffered form and to the twin at 8,448 x 2,176, at the
             render path's c = 2,052 (8,448, 4,096, 2,048 rows) and ragged
             row counts, and with ids outside the table; blend_rows (rows
             5-7's pre-blend) torch.equal to blend_cat on the render path's
             table.
  5. path    each main path with the launch counts set to 0 before and read
             after; rows 2-8 on the form their wrappers pick (the split form
             above row 8's cluster form), the scene path's rows 6 and 2
             counted on it.  The batched path: four bench steps (256 x 64, history
             carried) through batched_chunk_fn_fused, the first against
             render_oracle, and BatchRenderer(device="cuda").render of 16
             moving sources x 512 blocks, every source against render_oracle.
             The single-source path: Renderer(device="cuda"), chunks of 2048,
             on the reference's sweep scenario (3, 5) (12,556 blocks) with and
             without the sparse crossfade side-pass, the sweep gate's mover
             (12,556 blocks), a circular orbit (0.4 s, 5 degrees) and a
             rising helix (12,556 blocks each).  The scene path:
             BatchRenderer(device="cuda") on 16 sources x 12,544 blocks (the
             JAX package's scene gate) of six scenes, each on one arm of the
             JAX dispatch (rows 2, 6 and 7, every form).  The live path (row
             8): render_scan(device="cuda") on the sweep and the mover (12,556
             blocks, one launch each), and StreamingSpatializer(device="cuda")
             driven by AudioPlayout.run_offline: one source along the helix
             for 3,445 blocks (10 s), moved every block; the crossfade-every-
             block worst case (200 blocks of 3-degree steps at 10 degrees,
             tests/test_live_deadline_strict.py's loop); eight sources on one
             shared table in one callback for 1,000 blocks; one source on the
             sweep (a 5-degree move every 172 blocks: most blocks hold) for
             3,445 blocks; row 8 counted once per block and source (plus two
             per source for prime) and once per scan, every live block on
             the cluster form, the scans on launch B; row 1 counted by form
             (the bench steps on the staged form from STAGED_FROM rows), row 12
             under rows 5-7's pre-blend on every gather-form chunk (none under
             row 2).  Each render and every live source against
             render_oracle: max|diff| <= 1e-6, RMS < 1e-4, the margin against
             the sweep's 2e-7 beside the JAX package's; each render takes the
             JAX dispatch's arm on every chunk; every kernel launched; each
             live run's BlockStats against the 2.902 ms block deadline;
             launch A counted by form on every path (one launch a launch of
             rows 1-6 and of row 8's forward form, none on the tile form,
             every live block on the few-block form).
  6. probes  the probe scripts (jefferson_tpu_torch.scripts), the launch
             counts set to 0 just before: the association probe's stages
             A-D, the blend shootout and the error budget on the worst sweep
             scenario (its oracle from the worker pool); their answers on
             lines of their own.  Each kernel call is held to its twin on the
             same operands through the numbers the scripts return: the
             complex product (row 9) elementwise within 2^-22 of its plane's
             two |products| (|xr gr| + |xi gi| for qr; one FMA contraction),
             the tail matmul (row 10) at K = 513 and 512 and its K-chunk tree
             (row 11) at 2, 4 and 8 chunks within 2e-6 of the output peak
             (fp32 sums in other orders), the row-gather blend (row 12, in
             the dedup form) at 8,448 rows bit-equal to its twin and to the
             torch xla16 gathers; each budget configuration within 1e-6 of
             render_oracle, the apply-only configuration on row 7 and its
             pre-blend alone, the
             unfused chain and its two stage swaps (the tail summed by
             128-bin blocks; the forward on the CPU) on no kernel.  Row 12 runs
             there under the pre-blend of the budget's gather configurations.
  7. cli     the file-to-file CLI (jefferson_tpu_torch.cli.main.main, in this
             process, on the card) in a temporary directory, the launch
             counts set to 0 just before: a seeded 30-s mono input (10,336
             blocks: five 2048-block chunks and a ragged one), a 48 kHz copy
             of it, a seeded 2-s IR and a compact KEMAR tree written from
             synthetic_database (bench.write_compact_tree: 710 filters), read
             back through --hrtf-dir by every render.  Renders, all --float:
             -t 0 on an orbit and held, -t 0 --backend fft, -t 1 in both
             backends, -t 2, -r with --reverb-mode reference on the device
             and on the host reverb, the 48 kHz input, an events: and a path:
             trajectory, a --scene of four sources, and -t 3/4/5 on the
             first 5 s.  Each engine render against render_oracle on the same
             database (from the worker pool): 1e-6, 2e-7 for -t 1 fft, 5e-6
             for TD against the gain-scaled oracle, RMS < 1e-4; the first 5 s
             of the -t 0/1/2 orbit renders through cli.check against the
             -t 3/4/5 renders (-t 5 scaled by the source gain), and those
             bit-equal to the workers' oracles; each -t 0 fft, -t 1 and -t 2
             render against the same CLI render with --device cpu within
             1e-6; the device reverb against the host reverb and
             reverb_oracle within 5e-5.  The -t 0 and --scene renders launch
             the CUDA steps; the others none.  Each render's launches by
             kernel, wall time and multiple of real time beside the card.
  8. sweep   the sweep gate (jefferson_tpu_torch.bench.sweep) at full scale,
             the launch counts set to 0 just before: the four reference
             scenarios (172 x 72) and the mover (12,556 blocks) on one
             Renderer(device="cuda"), scene_hold and scene_movers (16 x
             12,544) through BatchRenderer, each held to render_oracle (from
             the workers, shared with the path phase's) at 2e-7, its margin
             beside the JAX package's and the card's record, each under 1;
             then cli.main --selftest-full on the same input.
  9. surfaces  the CLI with --viz (four artifacts) and --profile-dir on the
             cli phase's input and tree (the trace names launch A, row 5's
             launch B and row 12; the CLI's host stages from its spans),
             --selftest, rt for 3 s (row 8 once a block and twice for the
             prime), counted in this process; the acceptance script
             (jefferson_tpu_torch.scripts.acceptance, its step 4 the graft
             dryrun in CPU ranks) and the examples (03 localizes and 06
             personalizes on the card; not 04 and 09, whose CPU ranks phase
             mesh replaces on the card) in processes of their own, started
             together.
 10. soak    scripts/soak_daemon.py --minutes 2 in a process of its own,
             beside phases 8-9: its RSS and the allocator's memory at the
             first and last intervals, its errors exactly the deliberate.
 11. serve   once the worker pool is idle (its last jobs, the diff phase's
             CPU runs, would take cores from the live sessions), python -m
             jefferson_tpu_torch.serve in a process of its own: a
             12,556-block render, cold and warm, and a 16-source x 12,544-
             block scene, each within 1e-6 of render_oracle; four paced
             10-s sessions moved every 100 ms, alone (each within the strict
             live gate: median < 2.902 ms, p90 < 5.804 ms) and beside
             back-to-back renders, moved until each has played its blocks,
             their BlockStats; viz.live.watch on one; the daemon's launches
             by kernel from stats; shutdown, the daemon out within 15 s.
             Then the daemon on a mesh (serve --devices 2 --backend gloo: two
             ranks on cuda:0) serves the same render (its blk mesh takes the
             unfused arms: torch.equal to the unsharded unfused card render,
             within 5e-7 of the meshless daemon's) and a 4-source scene (the
             ranks' partial mixes summed: torch.equal to the unsharded
             sources summed in that order, within 1e-7 of the meshless
             daemon's mix), each rank's wall and collectives printed;
             shutdown ends every rank with 0.
 12. diff    the differentiable path (jefferson_tpu_torch.diff) on the card,
             the launch counts set to 0 just before (it runs plain PyTorch
             ops on autograd and launches none of the kernels, as the JAX
             module reaches no Pallas kernel): DifferentiableRenderer.localize
             on example 03's case (12 blocks hidden at 62, 18, 1.3 m, 400
             steps, lr 0.1) and on a moving source (512 blocks, 1.49 s, at
             (77, 6, 1.15 m) then (293, -8, 0.85 m), off the grids,
             segment_blocks 64, 200 steps), and fit_database on the full
             710 x 2 x 513 table from 24 measured directions of a listener
             (400 steps).  Each under the JAX tests' gates
             (tests/test_diff.py, tests/test_personalize.py; the moving
             source per 64-block segment), run three times (first, warm,
             under torch.profiler): the first run's wall, each stage's wall
             time in the warm run (per step for the descents and the fit),
             the card's idle share (the profiled run's device time against
             the warm run's wall), max_memory_allocated, the spread over the
             runs, and for the 12-block case and the fit the distance to the
             port's own CPU run (in a worker process): positions within 0.5
             degrees and 0.01 m, fitted spectra within 1e-2 and the table
             error within 1e-4 of it.
 13. geometry every other block and transform size, GEOMETRIES: fpb 16,
             4, 64, 256, 512 and 1024 over the 512-tap set (pad 1024; 2048
             at fpb 1024), fpb 2048 (pad 4096), fpb 64 over a 256-tap set
             (pad 512), fpb 128 over a 2,048-tap set (pad 4096) and the
             histories of partial blocks fpb 100 and 441 (pad 1024).  Each
             geometry's two libraries (their build seconds, and
             each library's own report of its forms against
             fused_step.geometry_forms); GEO_SAMPLES = 1,607,168 samples of
             the noise (the 12,556-block render's length; 2 s at f16 and
             f4, GEO_SHORT) through Renderer
             on the sweep, an orbit, the helix and a source at a new random
             position every block (the dedup+fused, one-hot and gather arms;
             chunks of 256 under 4,096 blocks), each held to render_oracle at
             1e-6 with the JAX dispatch's arm (GEO_ARMS, pinned on the CPU by
             tests/test_torch_geometry.py) and counted by kernel and form;
             render_scan on the sweep; at f64, f256 and f64t256 the 16-source
             scene_hold and scene_movers (chunks of 256), two sources held to
             the oracle and every source to the unfused card render at 5e-7;
             the live path (StreamingSpatializer under run_offline, 10 s of
             the helix, 2 s at f16 and 0.5 s at f4, then 200 held blocks)
             held to the oracle and, from fpb 32 up, gated median < the
             block's deadline, p90 < twice it (below, timed against it);
             every kernel
             form the geometry's library has against its twin (rows 1-8 and
             launch A; rows 7 and 8's apply-only forms at a history of
             partial blocks), and each kernel timed at one shape (events,
             device time alone, twin, bound; launch A also its issue
             floor, bench.forward_issue_ms); where launch A has its ring
             form (f16, f4, f128t2048), the ring form torch.equal to the
             planes form also at 16 x 64 and 1 x 2,048, and where the steps
             take it (f16, f4) both forms' device time alone at RING_TIMED
             (16 x 256, 16 x 64, 1 x 2,048, 1 x 1), the planes form's two
             launches apart, printed beside the bound and the issue floor;
             at SPLIT_TIMED (f2048, f128t2048, f441, f1024, f512, f256)
             rows 5-8's split form in the layout the wrappers take,
             torch.equal to launch B and timed beside it
             and the twin, and, where launch B takes a span of counts
             (fused_step.LAUNCH_B_SPANS), both forms' device time alone at
             the span's ends (scripts/split_layouts.py; the script reads
             the whole crossover); where a geometry has the split form,
             the layout each library takes for blended and pre-blended rows
             with its threads, shared memory, CTAs an SM and
             cudaOccupancyMaxActiveClusters (the SMs its clusters cover,
             fused_step.split_occupancy); at LIBRARY_TIMED (f512, f1024,
             f2048, f128t2048) rows 5-8's tail product alone as one
             torch.matmul, fp32, TF32 off (the library yardstick,
             scripts/tail_times.tail_product_ms), device time alone beside
             each row's reading; each geometry's launches by kernel
             and, of rows 2-8, those in the split form; then Renderer and
             StreamingSpatializer at fpb 2^24 raise before any launch,
             naming the resource no form supplies (launch B's t-tiles past
             the grid's y).
 14. mesh    the mesh paths (jefferson_tpu_torch.parallel) in ranks of their
             own, all on cuda:0 over gloo (requested explicitly: NCCL refuses
             two ranks on one card), the CUDA libraries deleted first so that
             the 4 ranks build them at one moment at their first load.  The
             16 x 12,544 scene sets (scene_hold, scene_movers, wide; chunks of
             256) through BatchRenderer(mesh=make_mesh(2)) and make_mesh(4),
             each with mix=False and mix=True: every rank's result the same,
             each source within 1e-7 of rank 0's unsharded card render (and
             whether torch.equal), the mix within 1e-6 of the unsharded mix,
             each source within 1e-6 of render_oracle (the workers'), the arms
             per shard, one collective a chunk, launches by kernel per rank; a
             12,556-block orbit through Renderer(mesh=make_mesh(2, ("blk",)))
             within 1e-7 of the unsharded unfused render and 1e-6 of the
             oracle; a one-rank NCCL world, BatchRenderer(mesh=make_mesh(1))
             torch.equal to the meshless render; then
             graft.dryrun_multichip(4, device="cuda", backend="gloo"), stages
             (a)-(f) ((e) on --device cpu).  Each render's wall per rank
             beside the unsharded render's, beside the card.
 15. bench   the bench step (blocks/s), and again with row 1's launch B in
             each form, STEP_PAIRS pairs in turns, beside each form's
             quartile spread; each step's kernel and twin times in
             turns (twin, forms, forms reversed, twin) beside its bound (row 8
             at both its shapes), rows 1-8 in each form of launch B with
             their device time alone, launch A and launch B apart
             (torch.profiler: at small sizes a call's events time the host's
             launch path), and queued behind a held stream as phase geometry
             reads its rows; row 8's three forms at 1 to 1,024 rows (the
             crossover that sets SMALL_ROWS); launch B's two forms at 8-16,384
             rows (the crossover that sets fused_step.SPLIT_FROM and row 8's
             MANY_ROWS_FORM); rows 9-12 with their device time alone (queued
             behind a held stream), beside one PyTorch call of the same
             function (its events and its device time alone), row 9's host path split into Python, ctypes and
             the entry beside torch.mul's, and row 9's events against
             torch.mul's; launch A's forms at the main path's shapes,
             device time alone and events in turns (tile, picked, picked,
             tile) beside the bound, and every form at 1 source x 1-32
             blocks (the crossover that sets FEW_NB); row 1's launch B in both
             forms at 1,024-32,768 rows (the crossover that sets STAGED_FROM);
             row 12's two forms at 16-8,448 rows and c = 2,052 and 2,176,
             device time alone beside the bound and the table bytes each
             reads through L2 (whether the dedup form, the wrappers' only
             pick, takes less at every count), and
             blend_rows against blend_cat; the scene renders that pre-blend,
             device busy with the pre-blend through row 12 and through
             blend_cat, in turns; the sparse side-pass at a
             scene_hold chunk's shape (device time, kernels per call, bound);
             each render's wall time (the scenes' host planning apart) with
             the output fetched synchronously and pipelined (pipeline_fetch),
             in turns, the outputs torch.equal and the launches the same, the
             scenes also with the host library's NumPy forms (planning_s each
             way, in turns), render_scan's, and the device time by kernel of
             four renders (scene_hold and scene_movers with each fetch) and
             of 200 live blocks, moving and held; a new live position's host
             set-up with the host library and with its NumPy forms, in turns;
             the unfused chain's warm render with each tail; beside the card.
Then a {"kernels": [...]} line (rows 1-12, and launch A at the scene step's
16 x 256; launches summed over phases 5-11 and 14, the daemon's and the
ranks' from their own counts; rows 1-8's device time queued behind a held
stream; beside them each kernel's launches by geometry, phase 13's, those
of rows 2-8 in the split form, and its times there), the nvidia-smi line,
and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

KERNEL_TOL = 5e-7    # CUDA step vs twin: fp32 DFT sums in another order
# row 8 vs its twin on standard-normal planes in phase geometry: the JAX
# package's row-8 gate (tests/test_pallas.py:56); 2,049 bins at pad 4096
# read 5.5e-7 there (PERF.md, PR 16)
ROW8_TOL = 1e-5
ORACLE_TOL = 1e-6    # end to end, tests/test_engine_parity.py
ORACLE_RMS = 1e-4    # bench.py's parity budget
SWEEP_EPS = 2e-7     # the reference sweep gate's eps (jefferson_tpu/bench/sweep.py)
RENDER_S, RENDER_B = 16, 512
STREAM_B = 2048      # rows of a single-stream step: the Renderer's chunk
GROUP_TB, GROUP_TILES = 256, 2   # row 4: 4 groups of 512 blocks at B = 2048
SIGNAL_SAMPLES = 131072          # the sweep CLI's default noise input
SCENE_S, SCENE_B = 16, 12544     # the JAX scene gate: 16 sources x 49 chunks of 256
ORACLE_WORKERS = 6
SCAN_B = 12556                   # render_scan's rows: the reference sweep
LIVE_BLOCKS = 3445               # 10 s of 128-sample blocks at 44.1 kHz
WORST_BLOCKS = 200               # tests/test_live_deadline_strict.py
CHOIR_S, CHOIR_B = 8, 1000       # sources sharing one table in one callback
FWD_REL = 1e-6                   # launch A vs its twin, relative to the XD peak
SPATIALIZER = "fused_spatializer_apply"
FORM_ROWS = (1, 2, 7)            # row 8's forms held bit-equal here, and at SMALL_ROWS
CROSSOVER_ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
SIDE_S, SIDE_NB, SIDE_CF = 16, 256, 32  # the side-pass at a scene_hold chunk: its bucket
# the mesh phase: ranks share cuda:0 over gloo, asked for by name (NCCL
# refuses two ranks on one card); one rank runs the NCCL world
MESH_RANKS, MESH_BACKEND, MESH_SIZES, MESH_BLK = 4, "gloo", (2, 4), 2
MESH_SCENES = ("scene_hold", "scene_movers", "wide")
MESH_ROW_TOL, MESH_MIX_TOL = 1e-7, 1e-6  # per source (tests/test_batch_parallel.py:45), mixdown
MESH_TIMEOUT = 600.0
MESH_LIBS = ("fused_step_onehot", "fused_step_gather", "dma_blend")
MAIN_GEOMETRY = (128, 1024)   # (fpb, pad) of every phase but geometry: the libraries' build
MESH_EXAMPLES = ("04_multichip.py", "09_multihost.py")

PROD_ULP = 2.0**-22  # row 9 vs twin, of the plane's two |products|: one FMA contraction
MM_REL = 2e-6        # rows 10-11 vs twin, of the output peak: fp32 sums in other orders
BLEND_ROWS, BLEND_TB = 8448, 256  # row 12: 256 sources x 33 rows, the TPU tile

# launch A's bit-equality cases (sources, blocks, n_dist or None for per-row
# distance): the main path's shapes (the bench step, the scene steps, rows
# 3-5's chunk, render_scan's rows, the live block), ragged counts, and
# selectors with 1-8 triples, some outside 1..n_dist-1
FWD_MAIN = ((256, 64, 1), (16, 256, None), (16, 256, 8), (1, STREAM_B, None),
            (1, SCAN_B, None), (1, 1, None))
FWD_CASES = (FWD_MAIN + tuple((1, nb, None) for nb in (*range(2, 10), 33, 65))
             + ((4, 66, None), (3, 9, None))
             + tuple((s_, nb, n) for n in range(1, 9) for s_, nb in ((4, 66), (2, 3))))
FWD_NB = (1, 2, 4, 6, 8, 9, 12, 16, 32)   # launch A's forms at 1 source: sets FEW_NB
LAUNCH_A = "forward_distance"

GATHER = "jefferson_tpu_torch/csrc/fused_step_gather.cu"
ONEHOT = "jefferson_tpu_torch/csrc/fused_step_onehot.cu"
ASSOC = "jefferson_tpu_torch/csrc/assoc_probe.cu"
DMA = "jefferson_tpu_torch/csrc/dma_blend.cu"
# kernel -> (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "fused_step_onehot_xfade": (ONEHOT, "jefferson_tpu/pallas/fused_step.py:840"),
    "fused_step_onehot_xfade/grouped": (ONEHOT, "jefferson_tpu/pallas/fused_step.py:840"),
    "fused_step_stream_onehot_xfade": (ONEHOT, "jefferson_tpu/pallas/fused_step.py:582"),
    "fused_step_stream_onehot_grouped_xfade": (ONEHOT, "jefferson_tpu/pallas/fused_step.py:687"),
    "fused_step_stream_xfade": (GATHER, "jefferson_tpu/pallas/fused_step.py:1035"),
    "fused_step_stream_xfade/no_xfade": (GATHER, "jefferson_tpu/pallas/fused_step.py:1035"),
    "fused_step_xfade": (GATHER, "jefferson_tpu/pallas/fused_step.py:1140"),
    "fused_step_xfade/no_xfade": (GATHER, "jefferson_tpu/pallas/fused_step.py:1140"),
    "fused_apply_xfade": (GATHER, "jefferson_tpu/pallas/fused_apply.py:207"),
    "fused_apply_xfade/no_xfade": (GATHER, "jefferson_tpu/pallas/fused_apply.py:207"),
    SPATIALIZER: (ONEHOT, "jefferson_tpu/pallas/fused_spatializer.py:126"),
    "prod": (ASSOC, "scripts/apply_assoc_probe.py:69"),
    "mm": (ASSOC, "scripts/apply_assoc_probe.py:97"),
    "mm_tree": (ASSOC, "scripts/apply_assoc_probe.py:145"),
    "dma_blend": (DMA, "scripts/bench_blend_variants.py:98"),
    # launch A, run inside rows 1-6 and row 8's forward form: the TPU
    # kernels' shared in-kernel forward (_forward_planes)
    LAUNCH_A: ("jefferson_tpu_torch/csrc/fused_forward.cuh",
               "jefferson_tpu/pallas/fused_step.py:273"),
}
PROBES = ("prod", "mm", "mm_tree", "dma_blend")
# single-stream form (bench.stream_step) -> kernel name
FORMS = {
    "onehot": "fused_step_stream_onehot_xfade",
    "grouped": "fused_step_stream_onehot_grouped_xfade",
    "gather": "fused_step_stream_xfade",
    "gather_noxf": "fused_step_stream_xfade/no_xfade",
}
# scene step form (bench.scene_step) -> (kernel name, sources, blocks)
SCENE_FORMS = {
    "grouped": ("fused_step_onehot_xfade/grouped", SCENE_S, 256),
    "gather": ("fused_step_xfade", SCENE_S, 256),
    "gather_noxf": ("fused_step_xfade/no_xfade", SCENE_S, 256),
    "apply": ("fused_apply_xfade", SCENE_S, 512),
    "apply_noxf": ("fused_apply_xfade/no_xfade", SCENE_S, 512),
}
# the cli phase: its input, the oracle renders' cut, and its gates
CLI_SECONDS, CLI_CUT, CLI_IR_SECONDS = 30, 5.0, 2
FFT_BASIC_EPS = 2e-7  # -t 1 in the fft backend against the oracle (PARITY.md row 12)
TD_EPS = 5e-6         # -t 2 against the gain-scaled CPU oracle (tests/test_engine_parity.py)
CARD_CPU_TOL = 1e-6   # a render on the card against the same CLI render with --device cpu
REVERB_TOL = 5e-5     # the device reverb against the host reverb and reverb_oracle
CLI_ORBIT = "orbit:period=4"
CLI_STATIC = "static:azi=30,ele=10,r=1.5"
CLI_PATH = "path:-2,0.5,-1:2,-0.3,0.5:20"
CLI_EVENTS = [[0.0, 0, 0, 0.5], [2.5, 40, 10, 1.0], [7.0, 300, -20, 2.0],
              [12.0, 120, 50, 0.7], [20.0, 200, 0, 1.2]]

# the JAX package's full-scale margins (ROADMAP.md, the gate-margin ladder)
JAX_MARGIN = {"sweep": 0.596, "sweep_no_sparse": 0.596, "mover": 0.745,
              "scene_hold": 0.745, "scene_movers": 0.298, "render_scan sweep": 0.596,
              "render_scan mover": 0.745}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> int:
    print(f"[{phase}] FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def diff(got, want):
    """(max|diff|, rms) of a render against its oracle render."""
    import numpy as np

    d = np.abs(np.asarray(got, np.float64) - want)
    return float(d.max()), float(np.sqrt(np.mean(d**2)))


def oracle_diff(got, signal, positions, db):
    """(max|diff|, rms) of a rendered (n, 2) source against render_oracle."""
    from jefferson_tpu_torch.oracle.reference import render_oracle

    return diff(got, render_oracle(signal, db, [tuple(p) for p in positions], db.config))


def renders(bench):
    """The single-source path's scenarios: name -> (positions, Renderer
    options, the arm the JAX dispatch takes on every chunk)."""
    from jefferson_tpu_torch.trajectory.trajectory import CircularOrbit

    sweep = bench.sweep_positions(3.0, 5.0)
    n = len(sweep)
    return {
        "sweep": (sweep, {}, ("dedup_fused", False, 16)),
        "sweep_no_sparse": (sweep, {"sparse_xfade": False}, ("dedup_fused", True, None)),
        "mover": (bench.mover_positions(n), {}, ("onehot_grouped", True, None)),
        # the orbit revisits its 360 positions every 0.4 s, so the dedup
        # takes it; the helix's positions do not repeat
        "orbit": (CircularOrbit(period_s=0.4, ele=5, r=1.0).sample(n), {},
                  ("dedup_fused", True, None)),
        "helix": (bench.helix_positions(n), {}, ("onehot", True, None)),
    }


def scene_positions(bench):
    """The scene path's position sets (S, B, 3) and the sources each is
    held to the oracle on: every source of the JAX package's two scene
    gates, four of the wide scene."""
    return {
        "scene_hold": (bench.scene_hold_positions(SCENE_S, SCENE_B), range(SCENE_S)),
        "scene_movers": (bench.scene_mover_positions(SCENE_S, SCENE_B), range(SCENE_S)),
        "wide": (bench.wide_positions(SCENE_S, SCENE_B), (0, 5, 10, 15)),
    }


def scenes():
    """The scene path: name -> (position set, chunk_blocks, BatchRenderer
    options, the arm the JAX dispatch takes on every chunk, the kernel it
    launches)."""
    return {
        "scene_hold": ("scene_hold", 256, {}, ("dedup_fused", False, 32),
                       "fused_step_xfade/no_xfade"),
        "scene_hold_no_sparse": ("scene_hold", 256, {"sparse_xfade": False},
                                 ("dedup_fused", True, None), "fused_step_xfade"),
        "scene_movers": ("scene_movers", 256, {}, ("onehot_grouped", True, None),
                         "fused_step_onehot_xfade/grouped"),
        "wide": ("wide", 256, {}, ("gather_fused", True, None), "fused_step_xfade"),
        "scene_hold_512": ("scene_hold", 512, {}, ("dedup_fused", False, 64),
                           "fused_apply_xfade/no_xfade"),
        "scene_movers_512": ("scene_movers", 512, {}, ("dedup_fused", True, None),
                             "fused_apply_xfade"),
    }


_worker_db = None


def _oracle_init():
    global _worker_db
    from jefferson_tpu_torch.hrtf.kemar import synthetic_database

    _worker_db = synthetic_database()


def _oracle_job(signal, positions):
    from jefferson_tpu_torch.oracle.reference import render_oracle

    return render_oracle(signal, _worker_db, [tuple(p) for p in positions], _worker_db.config,
                         initial_old=(0.0, 0.0))


_cli_dbs = {}


def _cli_oracle_job(tree, signal, positions, ptype, td_gain=1.0):
    """render_oracle on the database in ``tree`` (loaded once a worker)."""
    from jefferson_tpu_torch.config import ProcessType
    from jefferson_tpu_torch.hrtf.kemar import load_database
    from jefferson_tpu_torch.oracle.reference import render_oracle

    if tree not in _cli_dbs:
        _cli_dbs[tree] = load_database(tree)
    db = _cli_dbs[tree]
    return render_oracle(signal, db, [tuple(p) for p in positions], db.config,
                         ProcessType(ptype), td_gain=td_gain)


def cli_inputs(pool, tmp, device):
    """The cli phase's inputs, written under ``tmp``, its reverbs (the
    device one on the card), and every render's oracle started in the
    workers.  Returns (renders, scene oracle, reverbs, files): renders maps
    a name to (CLI arguments, the oracle's future, its gate, whether the
    render is also run with --device cpu)."""
    import json
    from pathlib import Path

    import numpy as np

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.cli.main import parse_trajectory
    from jefferson_tpu_torch.config import DEFAULT_CONFIG as cfg
    from jefferson_tpu_torch.config import ProcessType as P
    from jefferson_tpu_torch.hrtf.kemar import synthetic_database
    from jefferson_tpu_torch.io.resample import resample
    from jefferson_tpu_torch.io.wavio import read_wav_mono, write_wav
    from jefferson_tpu_torch.reverb.convolution import reverb_oracle, reverb_reference

    tmp = Path(tmp)
    sr = cfg.sample_rate
    rng = np.random.default_rng(21)
    t = np.arange(CLI_SECONDS * sr) / sr
    sig = (0.1 * rng.standard_normal(len(t)) + 0.2 * np.sin(2 * np.pi * 330 * t)
           * np.sin(2 * np.pi * 0.25 * t)).astype(np.float32)
    second = (0.15 * rng.standard_normal(20 * sr)).astype(np.float32)
    ir_t = np.arange(CLI_IR_SECONDS * sr)
    ir = (rng.standard_normal(len(ir_t)) * np.exp(-ir_t / (0.4 * sr)) * 0.05).astype(np.float32)
    ir[0] = 1.0
    files = {"in": tmp / "in.wav", "in48": tmp / "in48.wav", "in2": tmp / "in2.wav",
             "ir": tmp / "ir.wav", "events": tmp / "events.json", "scene": tmp / "scene.json",
             "tree": tmp / "kemar"}
    for name, x, rate in (("in", sig, sr), ("in48", resample(sig, sr, 48000), 48000),
                          ("in2", second, sr), ("ir", ir, sr)):
        write_wav(files[name], x, rate, bits=32, float_format=True)
    files["events"].write_text(json.dumps(CLI_EVENTS))
    bench.write_compact_tree(synthetic_database(cfg), files["tree"])
    tree = str(files["tree"])
    events = f"events:{files['events']}"

    # the oracles' inputs, read back as the CLI reads them
    dry = read_wav_mono(files["in"])[0]
    ir_in = read_wav_mono(files["ir"])[0]
    wet_device = reverb_reference(dry, ir_in, cfg, backend="device", device=device)
    wet_host = reverb_reference(dry, ir_in, cfg, backend="host")
    reverbs = {"device": wet_device, "host": wet_host, "oracle": reverb_oracle(dry, ir_in),
               "dry": dry, "ir": ir_in}
    signals = {"in": dry, "in48": resample(read_wav_mono(files["in48"])[0], 48000, sr),
               "wet_device": wet_device, "wet_host": wet_host}

    def oracle(signal, spec, ptype, td_gain=1.0):
        x = signals[signal]
        pos = parse_trajectory(spec).sample(int(np.ceil(len(x) / cfg.frames_per_buffer)), cfg)
        return pool.submit(_cli_oracle_job, tree, x, pos, int(ptype), td_gain)

    orbit_fd = oracle("in", CLI_ORBIT, P.CPU_FD_COMPLEX)
    orbit_basic = oracle("in", CLI_ORBIT, P.CPU_FD_BASIC)
    reverb = ["-r", str(files["ir"]), "--reverb-mode", "reference", "--reverb-backend"]
    renders = {
        "t0_orbit": (["-t", "0", "--trajectory", CLI_ORBIT], orbit_fd, ORACLE_TOL, False),
        "t0_static": (["-t", "0", "--trajectory", CLI_STATIC],
                      oracle("in", CLI_STATIC, P.CPU_FD_COMPLEX), ORACLE_TOL, False),
        "t0_fft": (["-t", "0", "--backend", "fft", "--trajectory", CLI_ORBIT], orbit_fd,
                   ORACLE_TOL, True),
        "t1": (["-t", "1", "--trajectory", CLI_ORBIT], orbit_basic, ORACLE_TOL, True),
        "t1_fft": (["-t", "1", "--backend", "fft", "--trajectory", CLI_ORBIT], orbit_basic,
                   FFT_BASIC_EPS, True),
        "t2": (["-t", "2", "--trajectory", CLI_ORBIT],
               oracle("in", CLI_ORBIT, P.CPU_TD, cfg.source_gain), TD_EPS, True),
        "reverb_device": ([*reverb, "device", "--trajectory", CLI_ORBIT],
                          oracle("wet_device", CLI_ORBIT, P.CPU_FD_COMPLEX), ORACLE_TOL, False),
        "reverb_host": ([*reverb, "host", "--trajectory", CLI_ORBIT],
                        oracle("wet_host", CLI_ORBIT, P.CPU_FD_COMPLEX), ORACLE_TOL, False),
        "in48": (["-i", str(files["in48"]), "--trajectory", CLI_ORBIT],
                 oracle("in48", CLI_ORBIT, P.CPU_FD_COMPLEX), ORACLE_TOL, False),
        "events": (["--trajectory", events], oracle("in", events, P.CPU_FD_COMPLEX),
                   ORACLE_TOL, False),
        "path": (["--trajectory", CLI_PATH], oracle("in", CLI_PATH, P.CPU_FD_COMPLEX),
                 ORACLE_TOL, False),
    }
    # the scene: four sources, each scaled by its gain and rendered to the
    # longest source's blocks, the mix against the sum of their oracles
    scene = [(files["in"], CLI_ORBIT, 0.5), (files["in48"], CLI_STATIC, 0.4),
             (files["in2"], CLI_PATH, 0.3), (files["in"], events, 0.25)]
    files["scene"].write_text(json.dumps({"sources": [
        {"input": str(f), "trajectory": spec, "gain": g} for f, spec, g in scene]}))
    sigs = []
    for f, _, g in scene:
        x, rate = read_wav_mono(f)
        sigs.append((resample(x, rate, sr) if rate != sr else x) * np.float32(g))
    nb = max(int(np.ceil(len(x) / cfg.frames_per_buffer)) for x in sigs)
    scene_oracles = [pool.submit(_cli_oracle_job, tree, x, parse_trajectory(spec).sample(nb, cfg),
                                 int(P.CPU_FD_COMPLEX))
                     for x, (_, spec, _) in zip(sigs, scene)]
    return renders, (scene_oracles, nb), reverbs, files


def cli_phase(bench, inputs, cfg, fwd_forms) -> dict | None:
    """The cli phase (module docstring, phase 7): every render through
    cli.main.main on the card, counted, held to its oracle; the launches
    by kernel, or None on a failure."""
    import numpy as np

    from jefferson_tpu_torch.cli.check import main as check_main
    from jefferson_tpu_torch.cli.main import main as cli_main
    from jefferson_tpu_torch.io.wavio import read_wav, write_wav
    from jefferson_tpu_torch.kernels import fused_step

    renders, (scene_oracles, scene_nb), reverbs, files = inputs
    tmp = files["in"].parent
    fpb, sr = cfg.frames_per_buffer, cfg.sample_rate
    common = ["--hrtf-dir", str(files["tree"]), "--float", "--quiet"]
    total: dict[str, int] = {}
    fused_step.reset_launches()

    def render(name, args, device="cuda"):
        """One CLI render -> (output, wall seconds, launches by kernel)."""
        out = tmp / f"{name}_{device}.wav"
        before = dict(fused_step.launches)
        t0 = time.perf_counter()
        rc = cli_main(["-i", str(files["in"]), *args, "-o", str(out), "--device", device,
                       *common])
        wall = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in fused_step.launches.items() if v != before[k]}
        if rc != 0:
            raise RuntimeError(f"{name}: the CLI returned {rc}")
        return read_wav(out)[0], wall, launched

    # the reverbs against each other and the oracle, each timed again warm,
    # in turns (device, host, host, device), the device's output the same
    # as the one the oracle took
    from jefferson_tpu_torch.reverb.convolution import reverb_reference

    wet_dev, wet_host = reverbs["device"], reverbs["host"]
    walls = {"device": [], "host": []}
    same = True
    for backend in ("device", "host", "host", "device"):
        t0 = time.perf_counter()
        wet = reverb_reference(reverbs["dry"], reverbs["ir"], cfg, backend=backend,
                               device="cuda")
        walls[backend].append(time.perf_counter() - t0)
        same = same and np.array_equal(wet, reverbs[backend])
    d_dh = float(np.abs(wet_dev - wet_host).max())
    d_do = float(np.abs(wet_dev - reverbs["oracle"]).max())
    d_ho = float(np.abs(wet_host - reverbs["oracle"]).max())
    say("cli", f"reverb_reference of {len(reverbs['dry'])} samples with a {CLI_IR_SECONDS}-s IR "
               f"({len(reverbs['ir'])} taps): device (the card) "
               f"{'/'.join(f'{w:.4f}' for w in walls['device'])} s, host "
               f"{'/'.join(f'{w:.4f}' for w in walls['host'])} s (in turns); each the same "
               f"output again: {same}; max|device - host| {d_dh:.3e}, |device - reverb_oracle| "
               f"{d_do:.3e}, |host - reverb_oracle| {d_ho:.3e} (limit {REVERB_TOL:.0e})  "
               f"[{bench.card()}]")
    if max(d_dh, d_do, d_ho) > REVERB_TOL or not same:
        fail("cli", "the device reverb disagrees with the host reverb or reverb_oracle")
        return None

    outs = {}
    for name, (args, oracle, gate, on_cpu) in renders.items():
        got, wall, launched = render(name, args)
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        want = oracle.result()
        if got.shape != want.shape or not np.isfinite(got).all():
            fail("cli", f"{name}: output {got.shape}, the oracle's {want.shape}")
            return None
        d_max, d_rms = diff(got, want)
        audio_s = len(got) / sr
        line = (f"{name} ({' '.join(args)}): {len(got) // fpb} blocks ({audio_s:.2f} s) in "
                f"{wall:.3f} s = {audio_s / wall:.1f}x real time, launches {launched}; vs "
                f"render_oracle max|diff| {d_max:.3e} (limit {gate:.0e}), rms {d_rms:.3e}")
        d_cpu = 0.0
        if on_cpu:
            cpu, cpu_wall, _ = render(name, args, device="cpu")
            d_cpu = float(np.abs(got - cpu).max())
            line += (f"; vs --device cpu ({cpu_wall:.3f} s) max|diff| {d_cpu:.3e} at block "
                     f"{int(np.abs(got - cpu).argmax()) // 2 // fpb} (limit {CARD_CPU_TOL:.0e})")
        say("cli", f"{line}  [{bench.card()}]")
        if not d_cpu <= CARD_CPU_TOL:
            # which side moved: each render again, and each against the oracle
            again, _, _ = render(name + "_again", args)
            cpu_again, _, _ = render(name + "_again", args, device="cpu")
            bad = np.abs(got - cpu) > CARD_CPU_TOL
            at = np.unravel_index(int(np.nan_to_num(np.abs(got - cpu), nan=np.inf).argmax()),
                                  got.shape)
            fail("cli", f"{name}: at sample {at[0]} channel {at[1]} the card gives "
                        f"{got[at]!r}, the CPU {cpu[at]!r}, the oracle {want[at]!r}")
            fail("cli", f"{name}: the card's render disagrees with the CPU's: max|diff| "
                        f"{d_cpu:.3e} (limit {CARD_CPU_TOL:.0e}) on {int(bad.sum())} samples in "
                        f"blocks {np.unique(np.nonzero(bad)[0] // fpb)[:8].tolist()}; finite "
                        f"card {bool(np.isfinite(got).all())} CPU {bool(np.isfinite(cpu).all())}; "
                        f"vs the oracle card {diff(got, want)[0]:.3e} CPU {diff(cpu, want)[0]:.3e}; "
                        f"rendered again, card vs card {float(np.abs(again - got).max()):.3e}, "
                        f"CPU vs CPU {float(np.abs(cpu_again - cpu).max()):.3e}")
            return None
        if not (d_max <= gate and d_rms < ORACLE_RMS):
            fail("cli", f"{name}: the render disagrees with the oracle")
            return None
        engine = not name.startswith(("t0_fft", "t1", "t2"))
        if bool(launched) != engine or (engine and not set(launched) - {"dma_blend"}):
            fail("cli", f"{name}: launched {launched}, want CUDA steps only on -t 0 matmul")
            return None
        outs[name] = (got, want)

    # the oracles through the CLI on the first CLI_CUT seconds, bit-equal to
    # the workers', and the engine renders' heads through cli.check
    cut = int(np.ceil(CLI_CUT / cfg.block_duration))
    for ptype, name, scale in (("3", "t0_orbit", 1.0), ("4", "t1", 1.0),
                               ("5", "t2", cfg.source_gain)):
        got, wall, launched = render(f"t{ptype}", ["-t", ptype, "--trajectory", CLI_ORBIT,
                                                   "--blocks", str(cut)])
        engine, want = outs[name]
        # -t 5 is the CPU TD oracle (gain 1); the worker's carries the source gain
        scaled = got if scale == 1.0 else got * np.float32(scale)
        same = np.array_equal(scaled, want[: cut * fpb])
        head, ref = tmp / f"{name}_head.wav", tmp / f"t{ptype}_ref.wav"
        write_wav(head, engine[: cut * fpb], sr, bits=32, float_format=True)
        write_wav(ref, scaled, sr, bits=32, float_format=True)
        gate = TD_EPS if ptype == "5" else ORACLE_TOL
        rc = check_main([str(head), str(ref), "--eps", str(gate)])
        say("cli", f"-t {ptype}, {cut} blocks in {wall:.3f} s = {cut * fpb / sr / wall:.1f}x "
                   f"real time, launches {launched}: the worker's oracle "
                   f"{'x source gain ' if scale != 1.0 else ''}bit-equal: {same}; cli.check of "
                   f"{name}'s first {cut} blocks against it at {gate:.0e}: rc {rc}  "
                   f"[{bench.card()}]")
        if launched or not same or rc != 0:
            fail("cli", f"-t {ptype}: the oracle render or its check failed")
            return None

    # the scene
    out = tmp / "scene.wav"
    before = dict(fused_step.launches)
    t0 = time.perf_counter()
    rc = cli_main(["--scene", str(files["scene"]), "-o", str(out), "--device", "cuda", *common])
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in fused_step.launches.items() if v != before[k]}
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v
    got = read_wav(out)[0]
    want = np.sum([o.result().astype(np.float64) for o in scene_oracles], axis=0)
    ok = rc == 0 and got.shape == want.shape and np.isfinite(got).all()
    d_max, d_rms = diff(got, want) if ok else (float("inf"), float("inf"))
    audio_s = scene_nb * fpb / sr
    say("cli", f"--scene of 4 sources, {scene_nb} blocks ({audio_s:.2f} s) in {wall:.3f} s = "
               f"{audio_s / wall:.1f}x real time, launches {launched}; the mix vs the sum of "
               f"the sources' render_oracle: max|diff| {d_max:.3e} (limit {ORACLE_TOL:.0e}), "
               f"rms {d_rms:.3e}  [{bench.card()}]")
    if not (ok and d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
        fail("cli", "the scene disagrees with its oracles")
        return None
    if not set(launched) - {"dma_blend"}:
        fail("cli", f"the scene launched {launched}, want the CUDA steps")
        return None
    fwd_forms["cli"] = dict(fused_step.forward_launches)
    if fault := launch_a_fault("the cli phase", total, fwd_forms["cli"]):
        fail("cli", fault)
        return None
    say("cli", f"cli launches: {total}, launch A by form {fwd_forms['cli']}")
    return total


def live_runs(bench, noise, fpb):
    """The live path's runs: name -> (positions (S, B, 3), signals (S, n)),
    each source's playback buffer wrapping as the reference's playhead."""
    import numpy as np

    worst = np.stack([(np.arange(WORST_BLOCKS) * 3.0) % 360.0, np.full(WORST_BLOCKS, 10.0),
                      np.ones(WORST_BLOCKS)], axis=1)
    return {
        "helix": (bench.helix_positions(LIVE_BLOCKS)[None], noise[None]),
        "worst": (worst[None], noise[None]),
        "choir": (bench.scene_mover_positions(CHOIR_S, CHOIR_B),
                  bench.scene_signals(noise, CHOIR_S, CHOIR_B, fpb)),
        "hold": (bench.sweep_positions(3.0, 0.0)[:LIVE_BLOCKS][None], noise[None]),
    }


def drive_live(db, device, positions, signals):
    """One StreamingSpatializer(device) per source, moved to its position
    before every block, all mixed in one AudioPlayout callback run on the
    fake device -> (BlockStats, per-source outputs (S, B*fpb, 2), the
    spatializers)."""
    import numpy as np

    from jefferson_tpu_torch.engine.stream import StreamingSpatializer
    from jefferson_tpu_torch.rt.playout import AudioPlayout

    spats, sources, records = [], [], []
    for pos, sig in zip(positions, signals):
        sp = StreamingSpatializer(db, device=device)
        sp.buf = sig
        rec = []

        def source(sp=sp, pos=pos, rec=rec):
            azi, ele, r = pos[len(rec)]
            sp.set_position(azi=azi, ele=ele, r=r)
            rec.append(sp.process_next())
            return rec[-1]

        source.prime = sp.prime
        spats.append(sp)
        sources.append(source)
        records.append(rec)
    stats = AudioPlayout(sources, db.config).run_offline(positions.shape[1])
    return stats, np.stack([np.concatenate(rec) for rec in records]), spats


def plan_phase(bench, cfg, scenarios, sets) -> bool:
    """make_plan with the host library against make_plan with its plain
    NumPy forms (bench.plain_host), every field bit-equal, on every source of
    the six scenes' three position sets and on the five single-source
    trajectories; each way timed in turns (library, NumPy, NumPy, library)
    on the host clock."""
    import dataclasses

    import numpy as np

    from jefferson_tpu_torch.engine.plan import make_plan

    def plans(sources):
        t0 = time.perf_counter()
        return [make_plan(p, cfg) for p in sources], (time.perf_counter() - t0) * 1e3

    users = {pset: [n for n, (ps, *_) in scenes().items() if ps == pset] for pset in sets}
    cases = {f"{pset} (scenes {', '.join(users[pset])})": pos for pset, (pos, _) in sets.items()}
    cases.update({f"{name} (Renderer)": pos[None] for name, (pos, _, _) in scenarios.items()})
    for name, sources in cases.items():
        got, lib_a = plans(sources)
        with bench.plain_host():
            want, np_a = plans(sources)
            _, np_b = plans(sources)
        _, lib_b = plans(sources)
        bad = sorted({f.name for g, w in zip(got, want) for f in dataclasses.fields(g)
                      if not (np.asarray(getattr(g, f.name)).dtype
                              == np.asarray(getattr(w, f.name)).dtype
                              and np.array_equal(getattr(g, f.name), getattr(w, f.name)))})
        say("plan", f"make_plan {name}: {len(sources)} source(s) x {sources.shape[1]} blocks, "
                    f"host library against the NumPy forms bit-equal in every field: {not bad}; "
                    f"{lib_a:.1f}/{lib_b:.1f} ms against {np_a:.1f}/{np_b:.1f} ms (host clock, "
                    f"in turns)  [{bench.card()}]")
        if bad:
            fail("plan", f"make_plan {name}: the host library differs from NumPy in {bad}")
            return False
    return True


def fetch_renders(bench, db, device, scenarios, sets, scene_sigs, signal, scene_walls):
    """Every render of the single-source and scene paths with the fetch
    synchronous and pipelined, in turns, the outputs torch.equal and the
    launches and dispatch the same; the scenes also with the host
    library's plain NumPy forms (planning_s each way, in turns: library,
    NumPy, NumPy, library; the fetch synchronous, pipelined, synchronous,
    pipelined).  Walls, planning_s and chunks_s beside the card; render
    profiles.  False on a disagreement."""
    import contextlib

    import torch

    from jefferson_tpu_torch.engine.batch import BatchRenderer
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.kernels import fused_step

    def same(a, b):
        return torch.equal(torch.from_numpy(a), torch.from_numpy(b))

    for name, (pos, opts, _) in scenarios.items():
        rs = {p: Renderer(db, device=device, pipeline_fetch=p, **opts) for p in (False, True)}
        walls, outs, launched = {False: [], True: []}, {}, {}
        for p in (False, True, True, False):
            fused_step.reset_launches()
            t0 = time.perf_counter()
            outs[p] = rs[p].render(signal, pos)
            walls[p].append(time.perf_counter() - t0)
            launched[p] = dict(fused_step.launches)
        if not (same(outs[True], outs[False]) and rs[True].dispatch == rs[False].dispatch
                and launched[True] == launched[False]):
            fail("bench", f"Renderer {name}: the pipelined fetch differs from the synchronous one")
            return False
        wall = walls[False][0]
        say("bench", f"Renderer {name}: {wall:.3f} s wall for {len(pos)} blocks "
                     f"({len(pos) / wall:,.0f} blocks/s, host planning and transfers included); "
                     f"fetch synchronous {walls[False][0]:.3f}/{walls[False][1]:.3f} s, "
                     f"pipelined {walls[True][0]:.3f}/{walls[True][1]:.3f} s (in turns), "
                     f"outputs torch.equal  [{bench.card()}]")
        if name in ("sweep", "mover"):
            profile(bench, f"Renderer {name}", lambda: rs[False].render(signal, pos), wall)
    for name, (pset, cb, opts, _, _) in scenes().items():
        pos, _ = sets[pset]
        rs = {p: BatchRenderer(db, device=device, chunk_blocks=cb, pipeline_fetch=p, **opts)
              for p in (False, True)}
        runs, first, launched = [], None, []
        for plain, p in ((False, False), (True, True), (True, False), (False, True)):
            fused_step.reset_launches()
            with bench.plain_host() if plain else contextlib.nullcontext():
                t0 = time.perf_counter()
                out = rs[p].render(scene_sigs, pos)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            runs.append((wall, rs[p].timings["planning_s"], rs[p].timings["chunks_s"]))
            launched.append((dict(fused_step.launches), rs[p].dispatch))
            if first is None:
                first = out
            elif not same(out, first):
                fail("bench", f"BatchRenderer {name}: the {'pipelined' if p else 'sync'} fetch"
                              f"{' with the NumPy forms' if plain else ''} differs from the "
                              f"synchronous render")
                return False
            del out
        if any(x != launched[0] for x in launched):
            fail("bench", f"BatchRenderer {name}: launches or dispatch differ between the fetches")
            return False
        del first
        (w1, p1, c1), (w2, p2, c2), (w3, p3, c3), (w4, p4, c4) = runs
        blocks = SCENE_S * SCENE_B
        say("bench", f"BatchRenderer {name}: {w1:.3f} s wall for {SCENE_S}x{SCENE_B} blocks "
                     f"({blocks / w1:,.0f} blocks/s): host planning {p1:.3f} s, chunk loop "
                     f"{c1:.3f} s (operands, launches, output copies and assembly); first run "
                     f"{scene_walls[name][0]:.3f} s; planning_s host library {p1:.3f}/{p4:.3f} s "
                     f"against the NumPy forms {p2:.3f}/{p3:.3f} s (in turns); fetch "
                     f"synchronous wall {w1:.3f} s, chunks_s {c1:.3f}/{c3:.3f} s, pipelined "
                     f"wall {w4:.3f} s, chunks_s {c2:.3f}/{c4:.3f} s; the four outputs "
                     f"torch.equal  [{bench.card()}]")
        if name in ("scene_hold", "scene_movers"):
            for p in (False, True):
                profile(bench, f"BatchRenderer {name} ({'pipelined' if p else 'synchronous'} "
                               f"fetch)", lambda: rs[p].render(scene_sigs, pos), w4 if p else w1)
    return True


def launch_a_fault(where: str, launched: dict, forms: dict) -> str | None:
    """Launch A's launches on a counted path against its steps': one a
    launch of rows 1-6 and of row 8's forward form (every row-8 launch of
    the live and scan paths), none on the tile form or the planes form (the
    forms kept to hold the others against); the fault, or None."""
    from jefferson_tpu_torch.kernels import fused_step as fs

    want = sum(v for k, v in launched.items()
               if not k.startswith("fused_apply") and k not in PROBES)
    if sum(forms.values()) != want or forms[fs.FWD_TILE] or forms[fs.FWD_PLANES] or not want:
        return (f"{where}: launch A by form {forms}, want {want} launches off the tile and "
                f"planes forms")
    return None


def nbytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` (each read or written once)."""
    import torch

    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def row8_forms(bench, db, device, geo, errs) -> bool:
    """Row 8's two forms on the same operands: the cluster form bit-equal
    to launch B with the crossfade and with the new brackets on both sides
    at xf = 0 (the held block's use), which equals any old brackets at
    xf = 0; each within KERNEL_TOL of its twin; fills ``errs`` -> False on
    a failure."""
    import torch

    from jefferson_tpu_torch.kernels import fused_spatializer as fsp
    from jefferson_tpu_torch.kernels import fused_step

    kw = dict(bins=geo["bins"], fpb=geo["fpb"])
    forms = (fsp.CLUSTER, fsp.LAUNCH_B)
    for rows in (*FORM_ROWS, fsp.SMALL_ROWS):
        for dup in (False, True):
            table, fwd, br, xf = bench.spatializer_step(db, rows, device, duplicate=dup,
                                                        seed=rows)
            if rows > 1:  # ids outside the table on both sides
                br = tuple(t.clone() for t in br)
                br[0][0, 1], br[2][rows - 1, 3], br[2][rows // 2, 0] = db.num_hrtf, -1, 9000
            xd = fused_step._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
            off = torch.zeros_like(xf)
            held_br = (br[2], br[3], br[2], br[3])
            # the wrapper's private seam names the form; fused_apply picks it by rows
            form = lambda f, brackets, mask: fsp._cuda(device, rows, table, brackets, mask, *xd,
                                                       None, form=f, **geo)
            two = {f: form(f, br, xf) for f in forms}
            held = {f: form(f, held_br, off) for f in forms}
            old_xf0 = form(fsp.CLUSTER, br, off)
            torch.cuda.synchronize()
            err = max(float((two[fsp.CLUSTER] - fsp.fused_apply_reference(
                          table, *xd, *br, xf, **kw)).abs().max()),
                      float((held[fsp.CLUSTER] - fsp.fused_apply_reference(
                          table, *xd, *held_br, off, **kw)).abs().max()))
            same = torch.equal(two[fsp.CLUSTER], two[fsp.LAUNCH_B])
            same_h = torch.equal(held[fsp.CLUSTER], held[fsp.LAUNCH_B])
            held_ok = torch.equal(held[fsp.CLUSTER], old_xf0)
            say("kernel", f"row 8 forms, {rows} row(s), {'duplicate' if dup else 'random'} "
                          f"brackets{', ids outside the table' if rows > 1 else ''}: cluster = "
                          f"launch B bit for bit: crossfade {same}, held block {same_h}; any old "
                          f"brackets at xf = 0 the same bits: {held_ok}; max|cluster - twin| "
                          f"{err:.3e} (limit {KERNEL_TOL:.0e})")
            if not (same and same_h and held_ok and err <= KERNEL_TOL):
                fail("kernel", f"row 8's forms disagree at {rows} rows")
                return False
            errs[SPATIALIZER] = max(errs[SPATIALIZER], err)
    return True


def split_cases(bench, db, device):
    """Launch B's split form's cases: (what, kernel, wrapper, args, kwargs)
    of rows 2 and 6 at 8, 264 (4 x 66: segment and group ends inside
    32-row tiles) and 16 x 256 rows, compact and per-row distance, row 2
    also on ids outside a group's table; rows 3-5 at STREAM_B and row 7 at
    16 x 512."""
    from jefferson_tpu_torch.kernels import fused_step

    cases = []
    for s_, nb_ in ((1, 8), (4, 66), (SCENE_S, 256)):
        for form in ("grouped", "gather", "gather_noxf"):
            name = SCENE_FORMS[form][0]
            for variant in ({"radius_step": 0.01}, {"unit_radius": True}):
                groups = {"group_sources": 1} if form == "grouped" and s_ < SCENE_S else {}
                fn, args, kw = bench.scene_step(db, form, s_, nb_, device, xf_every=7,
                                                **variant, **groups)
                dist = "compact" if "n_dist" in kw else "per-row"
                cases.append((f"{s_}x{nb_}, {dist} distance", name, fn, args, kw))
                if form == "grouped" and s_ == 4:
                    args = list(args)
                    u = args[4].shape[0] // 4  # four groups of one source
                    args[5], args[7] = args[5].clone(), args[7].clone()
                    args[5][3, 1], args[5][65, 2], args[5][100, 0] = u, u, -4
                    args[7][-1, 2], args[7][0, 3] = 3 * u, -1
                    cases.append((f"{s_}x{nb_}, {dist} distance, ids outside a group's table",
                                  name, fn, tuple(args), kw))
    for form, name in FORMS.items():
        fn, args, kw = bench.stream_step(db, form, STREAM_B, device, tb=GROUP_TB,
                                         group_tiles=GROUP_TILES, xf_every=7)
        cases.append((f"1x{STREAM_B}", name, fn, args, kw))
    for form in ("apply", "apply_noxf"):
        name, s_, nb_ = SCENE_FORMS[form]
        fn, args, kw = bench.scene_step(db, form, s_, nb_, device, xf_every=7)
        cases.append((f"{s_}x{nb_}", name, fn, args, kw))
    assert {c[1] for c in cases} == set(fused_step.split_launches)
    return cases


def split_forms(bench, db, device, geo, errs) -> bool:
    """Launch B's split form against its one-CTA form on the same operands,
    through the wrappers' private seams: bit-equal (torch.equal) and within
    KERNEL_TOL of the twin, at split_cases' shapes and row 8's 12,556 rows
    (random and duplicate brackets, ids outside the table); fills ``errs``
    -> False on a failure."""
    import torch

    from jefferson_tpu_torch.kernels import fused_spatializer as fsp
    from jefferson_tpu_torch.kernels import fused_step

    twin = lambda fn: getattr(sys.modules[fn.__module__], fn.__name__ + "_reference")
    forms = (fused_step.LAUNCH_B, fused_step.SPLIT)
    for what, name, fn, args, kw in split_cases(bench, db, device):
        ys = {f: fused_step._cuda(fn, *args, form=f, **kw) for f in forms}
        torch.cuda.synchronize()
        same = torch.equal(ys[fused_step.SPLIT], ys[fused_step.LAUNCH_B])
        err = float((ys[fused_step.SPLIT] - twin(fn)(*args, **kw)).abs().max())
        say("kernel", f"{name} split form, {what}: bit-equal to launch B {same}; max|split - "
                      f"twin| {err:.3e} (limit {KERNEL_TOL:.0e})")
        if not (same and err <= KERNEL_TOL):
            fail("kernel", f"{name}: the split form disagrees at {what}")
            return False
        errs[name] = max(errs[name], err)
    kw8 = dict(bins=geo["bins"], fpb=geo["fpb"])
    for dup in (False, True):
        table, fwd, br, xf = bench.spatializer_step(db, SCAN_B, device, duplicate=dup, seed=5)
        br = tuple(t.clone() for t in br)
        br[0][0, 1], br[2][SCAN_B - 1, 3], br[2][SCAN_B // 2, 0] = db.num_hrtf, -1, 9000
        xd = fused_step._forward_reference(fwd[0][None], SCAN_B, *fwd[1:], None, None, **geo)
        ys = {f: fsp._cuda(device, SCAN_B, table, br, xf, *xd, None, form=f, **geo)
              for f in forms}
        torch.cuda.synchronize()
        same = torch.equal(ys[fsp.SPLIT], ys[fsp.LAUNCH_B])
        err = float((ys[fsp.SPLIT] - fsp.fused_apply_reference(table, *xd, *br, xf, **kw8))
                    .abs().max())
        say("kernel", f"{SPATIALIZER} split form, {SCAN_B} rows, "
                      f"{'duplicate' if dup else 'random'} brackets, ids outside the table: "
                      f"bit-equal to launch B {same}; max|split - twin| {err:.3e} "
                      f"(limit {KERNEL_TOL:.0e})")
        if not (same and err <= KERNEL_TOL):
            fail("kernel", f"{SPATIALIZER}: the split form disagrees at {SCAN_B} rows")
            return False
        errs[SPATIALIZER] = max(errs[SPATIALIZER], err)
    return True


def forward_forms(bench, device, geo, errs) -> bool:
    """Launch A's forms on the same operands at FWD_CASES: the product form
    (and the few-block form up to FEW_NB blocks) bit-equal (torch.equal)
    to the tile form in both XD planes, and within FWD_REL of the twin's
    peak; fills ``errs`` -> False on a failure."""
    import torch

    from jefferson_tpu_torch.kernels import fused_step as fs

    for s_, nb, n_dist in FWD_CASES:
        ops = bench.forward_operands(s_, nb, device, seed=s_ * 1000 + nb, n_dist=n_dist)
        forms = [fs.FWD_TILE, fs.FWD_PRODUCT] + ([fs.FWD_FEW] if nb <= fs.FEW_NB else [])
        xd = {f: fs._forward_cuda(*ops, form=f, **geo) for f in forms}
        want = fs._forward_reference(*ops, **geo)
        torch.cuda.synchronize()
        same = {f: all(torch.equal(a, b) for a, b in zip(xd[f], xd[fs.FWD_TILE]))
                for f in forms[1:]}
        peak = max(float(a.abs().max()) for a in want)
        err = max(float((a - b).abs().max()) for a, b in zip(xd[fs.FWD_PRODUCT], want))
        finite = all(bool(torch.isfinite(a).all()) for a in xd[fs.FWD_PRODUCT])
        dist = ("per-row distance" if n_dist is None
                else f"{n_dist} triples, selectors -2..{n_dist + 1}")
        say("kernel", f"launch A, {s_}x{nb}, {dist}: "
                      f"bit-equal to the tile form: {same}; max|XD - twin| {err:.3e} of peak "
                      f"{peak:.2f} (limit {FWD_REL:.0e} x peak); picked "
                      f"{fs.forward_form(nb)}")
        if not (all(same.values()) and err <= FWD_REL * peak and finite):
            fail("kernel", f"launch A's forms disagree at {s_}x{nb}, n_dist {n_dist}")
            return False
        errs[LAUNCH_A] = max(errs[LAUNCH_A], err)
    return True


def forward_bench(bench, device, geo, times, bounds, held_ms) -> None:
    """Launch A's forms at FWD_MAIN, device time alone (queued behind a held
    stream) and CUDA events, in turns (tile, picked, picked, tile), beside
    the bound; then every form at 1 source x FWD_NB blocks (the crossover
    that sets FEW_NB).  The scene step's 16 x 256 per-row shape fills
    ``times``, ``bounds`` and ``held_ms`` for the kernels line."""
    from jefferson_tpu_torch.kernels import fused_step as fs

    alone = queued_device_ms
    for s_, nb, n_dist in FWD_MAIN:
        ops = bench.forward_operands(s_, nb, device, seed=7, n_dist=n_dist)
        picked = fs.forward_form(nb)
        call = lambda f: lambda: fs._forward_cuda(*ops, form=f, **geo)
        order = (fs.FWD_TILE, picked, picked, fs.FWD_TILE)
        ev = {}
        for f in order:
            ev.setdefault(f, []).append(bench.time_ms(call(f)))
        dev = {f: alone(call(f)) for f in (picked, fs.FWD_TILE)}
        plain = bench.time_ms(lambda: fs._forward_reference(*ops, **geo))
        bound = bench.bound_ms(bench.forward_flops(s_, nb),
                               bench.forward_bytes(s_, nb, n_dist=n_dist))
        dist = "per-row distance" if n_dist is None else f"{n_dist} triple(s)"
        say("bench", f"launch A {s_}x{nb}, {dist}: "
                     f"{picked} (main path) {dev[picked]:.4f} ms device time alone (events "
                     f"{ev[picked][0]:.4f}/{ev[picked][1]:.4f}), tile form {dev[fs.FWD_TILE]:.4f} "
                     f"(events {ev[fs.FWD_TILE][0]:.4f}/{ev[fs.FWD_TILE][1]:.4f}); twin "
                     f"{plain:.4f} "
                     f"ms; bound {bound[0]:.5f} ms ({bound[1]})  [{bench.card()}]")
        if (s_, nb, n_dist) == (SCENE_S, 256, None):
            times[LAUNCH_A] = (sum(ev[picked]) / 2, plain)
            bounds[LAUNCH_A] = bound
            held_ms[LAUNCH_A] = dev[picked]
    took = {}
    for nb in FWD_NB:
        ops = bench.forward_operands(1, nb, device, seed=nb)
        forms = [fs.FWD_TILE, fs.FWD_PRODUCT] + ([fs.FWD_FEW] if nb <= fs.FEW_NB else [])
        took[nb] = {f: alone(lambda: fs._forward_cuda(*ops, form=f, **geo)) for f in forms}
    few_to = max((nb for nb, t in took.items()
                  if fs.FWD_FEW in t and t[fs.FWD_FEW] < t[fs.FWD_PRODUCT]), default=0)
    say("bench", "launch A at 1 source, device time alone (queued behind a held stream; tile "
                 "/ product / few) at "
                 + ", ".join(f"{nb}: " + " / ".join(f"{t[f]:.4f}" for f in t)
                             for nb, t in took.items())
                 + f" ms; the few-block form takes less than the product form up to {few_to} "
                   f"blocks (FEW_NB = {fs.FEW_NB})  [{bench.card()}]")


# row 1's bit-equality cases (sources, blocks, radius step): the bench
# shape, compact and per-row distance, and ragged counts
ROW1_CASES = ((256, 64, 0.0), (256, 64, 0.01), (3, 9, 0.0), (4, 66, 0.0), (4, 66, 0.01),
              (1, 1, 0.0), (7, 40, 0.01))


def row1_forms(bench, db, device, errs) -> bool:
    """Row 1's two forms of launch B on the same operands: the staged form
    torch.equal to launch B at ROW1_CASES (the bench shape with compact and
    per-row distance, ragged counts whose tiles cross a source end), with
    ids outside the table, and with random ids over a 700-row table (more
    distinct rows a tile than the form stages); each within 5e-7 of the
    twin."""
    import numpy as np
    import torch

    from jefferson_tpu_torch.kernels import fused_step as fs

    def cases():
        for s_, nb, rs in ROW1_CASES:
            wl = bench.build_workload(db, s_, nb, device, radius_step=rs)
            yield f"{s_}x{nb}, {'per-row' if rs else 'compact'} distance", bench.step_operands(wl)
        args, kw = bench.step_operands(bench.build_workload(db, 4, 16, device))
        args = list(args)
        u = args[4].shape[0]
        args[5] = args[5].clone()
        args[5][3, 1], args[5][17, 0], args[5][40, 2] = u + 2, -4, u
        yield "4x16, ids outside the table", (args, kw)
        args, kw = bench.step_operands(bench.build_workload(db, 4, 66, device))
        args = list(args)
        rng = np.random.default_rng(3)
        put = lambda a: torch.from_numpy(a).to(device)
        args[4] = put(rng.standard_normal((700, args[4].shape[1])).astype(np.float32))
        args[5] = put(rng.integers(-3, 703, args[5].shape).astype(np.int32))
        args[7] = put(rng.integers(0, 700, args[7].shape).astype(np.int32))
        yield "4x66, random ids over 700 rows (and outside)", (args, kw)

    name = "fused_step_onehot_xfade"
    for what, (args, kw) in cases():
        one = fs._cuda(fs.fused_step_onehot_xfade, *args, form=fs.LAUNCH_B, **kw)
        staged = fs._cuda(fs.fused_step_onehot_xfade, *args, form=fs.STAGED, **kw)
        torch.cuda.synchronize()
        err = float((staged - fs.fused_step_onehot_xfade_reference(*args, **kw)).abs().max())
        equal = torch.equal(one, staged)
        say("kernel", f"row 1's staged form, {what}: torch.equal to launch B {equal}; "
                      f"max|staged - twin| = {err:.3e} (limit {KERNEL_TOL:.0e})")
        if not (equal and err <= KERNEL_TOL and bool(torch.isfinite(staged).all())):
            fail("kernel", f"row 1's staged form, {what}: not launch B's bits")
            return False
        errs[name] = max(errs[name], err)
    return True


# row 12's bit-equality cases: (rows, width) at the probe's 8,448 x 2,176,
# the render path's c = 2,052, and ragged row counts
BLEND_CASES = ((BLEND_ROWS, 2176), (BLEND_ROWS, 2052), (4096, 2052), (2048, 2052),
               (8447, 2176), (264, 2052), (33, 2176), (12, 2052), (1, 2052))


def blend_forms(bench, db, device, errs) -> bool:
    """Row 12's two forms on the same operands: the dedup form torch.equal
    to the double-buffered form and to the twin at BLEND_CASES (the
    shootout's ids) and with random ids over the whole table, some outside
    it; ``blend_rows`` (rows 5-7's pre-blend) torch.equal to ``blend_cat``
    on the render path's combined table."""
    import numpy as np
    import torch

    from jefferson_tpu_torch.convert import spectra_from_numpy
    from jefferson_tpu_torch.engine.renderer import cat_table
    from jefferson_tpu_torch.kernels import dma_blend
    from jefferson_tpu_torch.kernels import fused_step as fs
    from jefferson_tpu_torch.scripts import bench_blend_variants as bbv

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    table, table_pad = bbv.tables()
    idx, w = bbv.workload(BLEND_ROWS)
    rng = np.random.default_rng(5)
    cases = [(f"{r}x{c}", (table_pad if c == 2176 else table), idx[:r], w[:r])
             for r, c in BLEND_CASES]
    for c in (2176, 2052):
        ids = rng.integers(0, 710, (264, 4)).astype(np.int32)
        ids[3, 1], ids[5, 0], ids[17, 3] = 712, -4, 710
        cases.append((f"264x{c}, random ids, some outside",
                      rng.standard_normal((710, c)).astype(np.float32), ids,
                      rng.random((264, 4)).astype(np.float32)))
    for what, tab, ids, ws in cases:
        flat, i_d, w_d, c = put(tab.reshape(-1)), put(ids), put(ws), tab.shape[1]
        double = dma_blend._cuda(flat, i_d, w_d, c, form=fs.DOUBLE)
        dedup = dma_blend._cuda(flat, i_d, w_d, c, form=fs.DEDUP)
        torch.cuda.synchronize()
        twin = dma_blend.dma_blend_reference(flat, i_d, w_d, c)
        ok = torch.equal(dedup, double) and torch.equal(dedup, twin)
        say("kernel", f"dma_blend (row 12), {what}: the dedup form torch.equal to the "
                      f"double-buffered form and to the twin: {ok}")
        if not ok:
            fail("kernel", f"dma_blend, {what}: the dedup form is not the double form's bits")
            return False
    cat = cat_table(spectra_from_numpy(db.spectra, device))
    for r in (1, 16, 2048, 4096):
        ids, ws = put(idx[:r]), put(w[:r])
        got, want = dma_blend.blend_rows(cat, ids, ws), fs.blend_cat(cat, ids, ws)
        ok = torch.equal(got, want)
        say("kernel", f"blend_rows ({r} x {cat.shape[1]}, the render path's table): torch.equal "
                      f"to blend_cat: {ok}")
        if not ok:
            fail("kernel", "blend_rows is not blend_cat's bits")
            return False
    return True


ROW1_CROSS = (16, 64, 128, 192, 256, 512)   # sources of 64 blocks: 1,024 to 32,768 rows


def launch_a_call(args, kw, rows: int, geo):
    """Launch A alone, in the form the step takes, on the operands of a step
    of rows 1-6 (its wrapper's leading stream or streams and distance)."""
    from jefferson_tpu_torch.kernels import fused_step as fs

    streams = args[0] if args[0].dim() == 2 else args[0][None]
    nb = rows // streams.shape[0]
    fwd = (streams, nb, *args[1:4], kw.get("dsel"), kw.get("n_dist"))
    form = fs.forward_form(nb, geo["fpb"], geo["pad_len"], streams.shape[0])
    return lambda: fs._forward_cuda(*fwd, form=form, **geo)


def row1_crossover(bench, db, device) -> None:
    """Row 1's launch B in its two forms, device time alone (queued behind a
    held stream: the step less launch A alone), at ROW1_CROSS sources of 64
    blocks, in turns: the crossover that sets fused_step.STAGED_FROM."""
    from jefferson_tpu_torch.kernels import fused_step as fs

    geo = dict(pad_len=1024, bins=513, fpb=128)
    took = {}
    for s_ in ROW1_CROSS:
        args, kw = bench.step_operands(bench.build_workload(db, s_, bench.BLOCKS, device))
        if s_ == bench.SOURCES:
            # launch B's own least time at the bench shape: the step's
            # operations but launch A's; its XD planes, table and brackets
            # read, its output written
            rows = s_ * bench.BLOCKS
            flops = (bench.step_flops("fused_step_onehot_xfade", s_, bench.BLOCKS)
                     - bench.forward_flops(s_, bench.BLOCKS))
            moved = rows * 513 * 8 + rows * 256 * 4 + nbytes(*args[4:])
            b_ms, b_by = bench.bound_ms(flops, moved)
            say("bench", f"row 1's launch B alone at {s_}x{bench.BLOCKS}: bound {b_ms:.4f} ms "
                         f"({b_by}: {flops / 1e9:.2f} GFLOP at 67 TFLOP/s)  [{bench.card()}]")
        t = {}
        a_ms = queued_device_ms(launch_a_call(args, kw, s_ * bench.BLOCKS, geo))
        for form in (fs.LAUNCH_B, fs.STAGED, fs.STAGED, fs.LAUNCH_B):
            whole = queued_device_ms(
                lambda: fs._cuda(fs.fused_step_onehot_xfade, *args, form=form, **kw))
            t.setdefault(form, []).append(whole - a_ms)
        took[s_ * bench.BLOCKS] = {f: sum(v) / 2 for f, v in t.items()}
    staged_from = None
    for rows in sorted(took, reverse=True):
        if took[rows][fs.STAGED] >= took[rows][fs.LAUNCH_B]:
            break
        staged_from = rows
    say("bench", "row 1's launch B alone (one-CTA form / staged form), device time queued "
                 "behind a held stream less launch A's, at "
                 + ", ".join(f"{r} rows: {t[fs.LAUNCH_B]:.4f} / {t[fs.STAGED]:.4f}"
                             for r, t in took.items())
                 + f" ms; the staged form takes less from {staged_from} of these rows on "
                   f"(STAGED_FROM = {fs.STAGED_FROM})  [{bench.card()}]")


STEP_PAIRS = 12


def step_forms(bench, wl) -> None:
    """The bench step with row 1's launch B in each form, STEP_PAIRS pairs in
    turns (one-CTA, staged, then staged, one-CTA, ...), each a
    bench.time_steps_ms: the step's gain from the staged form beside the
    spread of each form's own step time in this run."""
    import numpy as np

    from jefferson_tpu_torch.kernels import fused_step as fs

    t = {fs.LAUNCH_B: [], fs.STAGED: []}
    for i in range(STEP_PAIRS):
        for form in (fs.LAUNCH_B, fs.STAGED)[:: 1 if i % 2 == 0 else -1]:
            t[form].append(fs._cuda(bench.time_steps_ms, wl, form=form))
    one, staged = np.array(t[fs.LAUNCH_B]), np.array(t[fs.STAGED])
    gain, wins = one - staged, int((one > staged).sum())
    q = lambda a: np.percentile(a, [25, 50, 75])
    span = lambda a: ("median {1:.4f}, quartiles {0:.4f}-{2:.4f}".format(*q(a))
                      + f", min {a.min():.4f}, max {a.max():.4f}")
    # a gain stands when the staged step wins nine pairs in ten and the
    # medians differ by more than the one-CTA step's own quartile spread
    spread = q(one)[2] - q(one)[0]
    stands = wins >= 0.9 * STEP_PAIRS and np.median(one) - np.median(staged) > spread
    say("bench", f"{bench.SOURCES}x{bench.BLOCKS} step by row 1's form, {STEP_PAIRS} pairs in "
                 f"turns: one-CTA {span(one)} ms; staged {span(staged)} ms; one-CTA - staged "
                 f"a pair {span(gain)} ms; the staged step faster in {wins} of {STEP_PAIRS}: "
                 f"the gain {'stands' if stands else 'is unresolved'}  [{bench.card()}]")


def dedup_l2_bytes(idx, c: int) -> int:
    """Table bytes the dedup form reads through L2: each tile reads each
    distinct id it names once (the double-buffered form reads a row for
    every (row, bracket))."""
    import numpy as np

    from jefferson_tpu_torch.kernels.dma_blend import DEDUP_ROWS

    tiles = range(0, len(idx), DEDUP_ROWS)
    return sum(len(np.unique(idx[r0:r0 + DEDUP_ROWS])) for r0 in tiles) * c * 4


def blend_bench(bench, device, held_ms) -> None:
    """Row 12's two forms, device time alone (queued behind a held stream)
    in turns (double, dedup, dedup, double), beside the bound and the table
    bytes each reads through L2, at
    the probe's 8,448 x 2,176 and the render path's widths and rows; then
    blend_rows against blend_cat (events: the host path included) at the
    render shapes: whether the dedup form, which the wrappers take at every
    row count, takes less device time at every count measured.  The dedup
    form's device time at the probe's 8,448 x 2,176 fills ``held_ms``."""
    import numpy as np
    import torch

    from jefferson_tpu_torch.kernels import dma_blend
    from jefferson_tpu_torch.kernels import fused_step as fs
    from jefferson_tpu_torch.scripts import bench_blend_variants as bbv

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    table, table_pad = bbv.tables()
    idx_all, w_all = bbv.workload(BLEND_ROWS)
    took = {}
    for r, c in ((BLEND_ROWS, 2176), (BLEND_ROWS, 2052), (4096, 2052), (2048, 2052),
                 (264, 2052), (16, 2052)):
        tab = table_pad if c == 2176 else table
        flat, idx, w = put(tab.reshape(-1)), put(idx_all[:r]), put(w_all[:r])
        t = {}
        for form in (fs.DOUBLE, fs.DEDUP, fs.DEDUP, fs.DOUBLE):
            t.setdefault(form, []).append(
                queued_device_ms(lambda: dma_blend._cuda(flat, idx, w, c, form=form)))
        t = {f: sum(v) / 2 for f, v in t.items()}
        took[(r, c)] = t
        if (r, c) == (BLEND_ROWS, 2176):
            held_ms["dma_blend"] = t[fs.DEDUP]
        bound = bench.bound_ms(*bbv.work(idx_all[:r], c))
        l2 = {fs.DOUBLE: idx_all[:r].size * c * 4, fs.DEDUP: dedup_l2_bytes(idx_all[:r], c)}
        widths = sorted({w for _, w in dma_blend.dedup_slices(c)}, reverse=True)
        say("bench", f"dma_blend (row 12) {r}x{c} (dedup slices of {widths} floats), "
                     f"device time alone: double-buffered "
                     f"{t[fs.DOUBLE]:.4f} ms, dedup {t[fs.DEDUP]:.4f} ms; bound {bound[0]:.4f} "
                     f"ms ({bound[1]}: output and named rows at 3.35 TB/s); table bytes through "
                     f"L2 {l2[fs.DOUBLE] / 1e6:.1f} MB / {l2[fs.DEDUP] / 1e6:.1f} MB  "
                     f"[{bench.card()}]")
    slower = [f"{r}x{c}" for (r, c), t in took.items() if t[fs.DEDUP] >= t[fs.DOUBLE]]
    say("bench", f"dma_blend: the dedup form (the wrappers' form at every row count) takes "
                 f"less device time than the double-buffered form at "
                 f"{'every shape measured' if not slower else 'all but ' + ', '.join(slower)}  "
                 f"[{bench.card()}]")
    cat = put(table)   # a combined table as cat_table lays it out, (710, 2,052)
    for r in (2048, 4096, 33):
        idx, w = put(idx_all[:r]), put(w_all[:r])
        rows_ms = bench.time_ms(lambda: dma_blend.blend_rows(cat, idx, w))
        cat_ms = bench.time_ms(lambda: fs.blend_cat(cat, idx, w))
        alone = {n: queued_device_ms(f)
                 for n, f in (("rows", lambda: dma_blend.blend_rows(cat, idx, w)),
                              ("cat", lambda: fs.blend_cat(cat, idx, w)))}
        say("bench", f"blend_rows {r}x{cat.shape[1]}: {rows_ms:.4f} ms (device time alone "
                     f"{alone['rows']:.4f}), blend_cat {cat_ms:.4f} ms (device time alone "
                     f"{alone['cat']:.4f})  [{bench.card()}]")


def blend_wiring(bench, db, device, sets, scene_sigs) -> None:
    """The scene renders that pre-blend (rows 6 and 7; scene_movers runs row
    2, which blends in its own launch) under torch.profiler, with rows 5-7's
    pre-blend through blend_rows (row 12) and, for the comparison, through
    blend_cat's torch gathers, in turns: device busy time each, and the
    largest kernels of the blend_cat run."""
    from jefferson_tpu_torch.engine import batch, renderer
    from jefferson_tpu_torch.engine.batch import BatchRenderer
    from jefferson_tpu_torch.kernels import fused_step as fs

    wired = renderer.blend_rows

    def use(fn):
        renderer.blend_rows = batch.blend_rows = fn

    try:
        for name in ("scene_hold", "scene_movers", "wide", "scene_movers_512"):
            pset, cb, opts, _, _ = scenes()[name]
            pos, _ = sets[pset]
            r = BatchRenderer(db, device=device, chunk_blocks=cb, **opts)
            busy, prof = {}, {}
            for label, fn in (("blend_rows", wired), ("blend_cat", fs.blend_cat),
                              ("blend_cat", fs.blend_cat), ("blend_rows", wired)):
                use(fn)
                rows = bench.device_profile(lambda: r.render(scene_sigs, pos))
                busy.setdefault(label, []).append(sum(row[1] for row in rows))
                prof[label] = rows
            blend_ms = sum(ms for k, ms, _ in prof["blend_rows"] if "dma_blend" in k)
            say("bench", f"BatchRenderer {name} ({SCENE_S}x{SCENE_B}, chunks of {cb}) device busy: "
                         f"pre-blend by blend_rows (row 12) {min(busy['blend_rows']):.3f} ms "
                         f"(dma_blend {blend_ms:.3f} ms), by blend_cat "
                         f"{min(busy['blend_cat']):.3f} ms; blend_cat run's largest kernels: "
                         + "; ".join(f"{ms:.3f} ms x{n:g} {k[:60]}"
                                     for k, ms, n in prof["blend_cat"][:6])
                         + f"  [{bench.card()}]")
    finally:
        use(wired)


def probe_scripts(device, errs, db, noise, budget_pos, budget_oracle):
    """The probe scripts on the card, counted: the association probe, the
    blend shootout and the error budget, each kernel held to its twin
    through the numbers the scripts return; fills ``errs`` -> the launch
    counts, or None on a failure."""
    from jefferson_tpu_torch.kernels import fused_step
    from jefferson_tpu_torch.scripts import apply_assoc_probe, bench_blend_variants, error_budget

    assoc = apply_assoc_probe.run(device)
    say("probes", f"association probe: {json.dumps(assoc)}")
    blend = bench_blend_variants.run(device, BLEND_ROWS, BLEND_TB)
    say("probes", f"blend shootout: {json.dumps(blend)}")
    t0 = time.perf_counter()
    want = budget_oracle.result()
    waited = time.perf_counter() - t0
    budget = error_budget.run(db, noise, budget_pos, want, device)
    say("probes", f"error budget ({len(budget_pos)} blocks, oracle waited {waited:.1f} s): "
                  f"{json.dumps(budget)}")
    launches = dict(fused_step.launches)
    say("probes", f"probe launches: { {k: v for k, v in launches.items() if v} }")

    problems = []
    twins = assoc["twins"]
    errs["prod"] = twins["prod"]["max_abs"]
    say("probes", f"prod (row 9): max|kernel - twin| = {errs['prod']:.3e}, worst "
                  f"{twins['prod']['of_scale']:.3e} of its plane's |product| + |product| "
                  f"(limit 2^-22 = {PROD_ULP:.3e})")
    if not twins["prod"]["of_scale"] <= PROD_ULP:
        problems.append("prod: kernel disagrees with its twin")
    for name in ("mm", "mm_tree"):
        for t in twins[name]:
            errs[name] = max(errs[name], t["max_abs"])
            say("probes", f"{name} (row {10 if name == 'mm' else 11}), K={t['k']}"
                          f"{', chunks %d' % t['chunks'] if 'chunks' in t else ''}: max|kernel - "
                          f"twin| = {t['max_abs']:.3e} of peak {t['peak']:.3f} (limit "
                          f"{MM_REL:.0e} x peak)")
            if not (t["max_abs"] <= MM_REL * t["peak"] and t["finite"]):
                problems.append(f"{name} at K={t['k']}: kernel disagrees with its twin")
    errs["dma_blend"] = blend["kernel_vs_twin"]["max_abs"]
    say("probes", f"dma_blend (row 12), {BLEND_ROWS} rows, tb {BLEND_TB}: bit-equal to its twin "
                  f"{blend['kernel_vs_twin']['bit_identical']}, every variant bit-equal to xla16 "
                  f"{all(v['bit_identical_to_xla16'] for v in blend['variants'].values())}")
    if not blend["kernel_vs_twin"]["bit_identical"]:
        problems.append("dma_blend: kernel is not its twin bit for bit")
    if not all(launches[name] for name in PROBES):
        problems.append(f"a probe kernel was not launched: {launches}")
    if not all(v["bit_identical_to_xla16"] for v in blend["variants"].values()):
        problems.append("a blend variant differs from xla16")
    configs = ("unfused", *error_budget.SWAPS, "apply_kernel", "fused", "fused/sidepass_blocked")
    for name in configs:
        if not budget[name]["max_abs"] <= ORACLE_TOL:
            problems.append(f"error budget {name}: {budget[name]['max_abs']:.3e} from the oracle "
                            f"(limit {ORACLE_TOL:.0e})")
    # the apply-only configuration runs row 7 on rows pre-blended by row 12
    row7 = {"fused_apply_xfade", "fused_apply_xfade/no_xfade"}
    unfused = {name: budget[name]["launches"] for name in ("unfused", *error_budget.SWAPS)}
    applied = set(budget["apply_kernel"]["launches"])
    if any(unfused.values()) or not applied & row7 or applied - row7 - {"dma_blend"}:
        problems.append(f"error budget launches: unfused {unfused}, apply_kernel "
                        f"{budget['apply_kernel']['launches']} (want row 7 and its pre-blend, "
                        f"row 12, only)")
    say("probes", "error budget margins: " + ", ".join(
        f"{name} {budget[name]['margin']} (block {budget[name]['block']})" for name in configs))
    say("probes", "unfused render of the budget's scenario, warm: " + ", ".join(
        f"{name} {budget[name]['render_ms']:.3f} ms" for name in configs
        if "render_ms" in budget[name]))
    if problems:
        fail("probes", "; ".join(problems))
        return None
    return launches


def probe_timed(device):
    """Rows 9-12 at the probe scripts' shapes, for the timings: {kernel:
    (wrapper, args, kwargs, fp32 operations, least bytes or None to count
    the operands, one PyTorch call of the same function)}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from jefferson_tpu_torch.kernels import assoc_probe, dma_blend
    from jefferson_tpu_torch.scripts import apply_assoc_probe, bench_blend_variants

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    xr, xi, gr, gi, icr, ici = map(put, apply_assoc_probe.inputs())
    qr, qi = assoc_probe.prod_reference(xr, xi, gr, gi)
    k5 = apply_assoc_probe.BINS - 1  # stage D's K = 512
    qr5, qi5 = qr[:, :k5].contiguous(), qi[:, :k5].contiguous()
    icr5, ici5 = icr[:k5], ici[:k5]
    xc, gc = torch.complex(xr, xi), torch.complex(gr, gi)
    q_cat, b_cat = torch.cat([qr, qi], 1), torch.cat([icr, ici], 0)
    q5_cat, b5_cat = torch.cat([qr5, qi5], 1), torch.cat([icr5, ici5], 0)
    m, k, n = qr.shape[0], qr.shape[1], icr.shape[1]

    _, table_pad = bench_blend_variants.tables()
    c_pad = table_pad.shape[1]
    idx_np, w_np = bench_blend_variants.workload(BLEND_ROWS)
    table_flat, idx, w = put(table_pad.reshape(-1)), put(idx_np), put(w_np)
    table2d, idx_long = table_flat.view(-1, c_pad), idx.long()
    return {
        "prod": (assoc_probe.prod, (xr, xi, gr, gi), {}, 6.0 * xr.numel(), None,
                 lambda: torch.mul(xc, gc)),
        "mm": (assoc_probe.mm, (qr, qi, icr, ici), {}, 4.0 * m * k * n + m * n, None,
               lambda: torch.matmul(q_cat, b_cat)),
        "mm_tree": (assoc_probe.mm_tree, (qr5, qi5, icr5, ici5), {"chunks": 8},
                    4.0 * m * k5 * n + 15.0 * m * n, None, lambda: torch.matmul(q5_cat, b5_cat)),
        "dma_blend": (dma_blend.dma_blend, (table_flat, idx, w, c_pad), {"tb": BLEND_TB},
                      *bench_blend_variants.work(idx_np, c_pad),
                      lambda: F.embedding_bag(idx_long, table2d, per_sample_weights=w,
                                              mode="sum")),
    }


# ---- the surfaces of ROADMAP item 8: the sweep gate, the daemon, the rest -----

# the sweep gate's margins beside the JAX package's (ROADMAP.md, the
# gate-margin ladder) and the card's record (PRs 6-10: the fused path's
# azi3_ele0 and the scene gates)
SWEEP_JAX = {"azi0_ele0": 0.596, "azi3_ele0": 0.745, "azi0_ele5": 0.447, "azi3_ele5": 0.596,
             "mover": 0.745, "scene_hold": 0.745, "scene_movers": 0.298}
SWEEP_CARD = {"azi3_ele0": 0.5215, "scene_hold": 0.596, "scene_movers": 0.186}
LIVE_MEDIAN_MS, LIVE_P90_MS = 2.902, 5.804  # the strict live gate (tests/test_live_deadline_strict.py)
SERVE_SESSIONS, SERVE_SECONDS, SERVE_MOVE_S = 4, 10.0, 0.1
SERVE_ORBIT = "orbit:period=4,ele=10,r=1.5"
SERVE_SCENE_GAIN = 0.25
SERVE_SCENE = [f"orbit:period={1 + 0.25 * i},ele={-30 + 10 * (i % 8)},r={0.6 + 0.1 * (i % 5)},"
               f"start={22.5 * i}" for i in range(SCENE_S)]
SOAK_MINUTES, SOAK_REPORT_S = 2, 30
DAEMON_EXIT_S = 15
# the meshed daemon (serve --devices MESH_SERVE_RANKS, gloo ranks on cuda:0):
# the phase's render, and a scene of the first MESH_SCENE_S sources
MESH_SERVE_RANKS = 2
MESH_SERVE_CHUNK = 2048          # the daemon's default --chunk-blocks
MESH_SCENE_S, MESH_SCENE_B = 4, 2048
MESH_SERVE_UP_S = 300
# a mix summed in another order (the ranks' partials): a few float32 ulps
MIX_ORDER_TOL = 1e-7
EXAMPLE_TIMEOUT_S = 300

# the diff phase: example 03's localize case, a moving source at full width
# and length, and fit_database on the full table (tests/test_personalize.py)
LOC_B, LOC_TRUE, LOC_INIT, LOC_STEPS, LOC_LR = 12, (62.0, 18.0, 1.3), (0.0, 0.0, 1.0), 400, 0.1
MOVE_B, MOVE_SEG, MOVE_STEPS = 512, 64, 200
MOVE_DIRS = ((77.0, 6.0, 1.15), (293.0, -8.0, 0.85))  # off the grids
FIT_STEPS = 400
LOC_CPU_DEG, LOC_CPU_M = 0.5, 0.01  # the 12-block fit, card against the port's CPU run
# fit_database, card against the port's CPU run: tests/test_torch_personalize.py's
# FIT_TOL and ERR_REL (Adam walks noise-level entries apart on any two devices)
FIT_CPU_TOL, FIT_ERR_REL = 1e-2, 1e-4


class OraclePool:
    """render_oracle renders from old = (0, 0) in the worker pool, one
    future per (signal, positions): a render asked for twice (the sweep gate
    and the path phase share five scenarios) is made once.  Calling it
    returns the render, so it serves as the sweep gates' ``oracle``."""

    def __init__(self, pool):
        self.pool, self.futures = pool, {}

    def submit(self, signal, positions):
        import hashlib

        import numpy as np

        signal = np.ascontiguousarray(signal, np.float32)
        positions = np.ascontiguousarray(positions, np.float64)
        # the positions whole; the signal by its length and every 1021st sample
        key = (len(signal), hashlib.blake2b(signal[::1021].tobytes() + positions.tobytes())
               .hexdigest())
        if key not in self.futures:
            self.futures[key] = self.pool.submit(_oracle_job, signal, positions)
        return self.futures[key]

    def __call__(self, signal, positions):
        return self.submit(signal, positions).result()


def serve_inputs(noise, cfg):
    """The serve phase's render and scene positions, as the daemon samples
    the request's trajectories."""
    from jefferson_tpu_torch.cli.main import parse_trajectory

    return (parse_trajectory(SERVE_ORBIT).sample(SCAN_B, cfg),
            [parse_trajectory(spec).sample(SCENE_B, cfg) for spec in SERVE_SCENE])


def soak_start(tmp):
    """The daemon soak (scripts/soak_daemon.py) for SOAK_MINUTES in a
    process of its own on the card, beside the sweep and surfaces phases."""
    import subprocess
    from pathlib import Path

    log = open(Path(tmp) / "soak.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jefferson_tpu_torch.scripts.soak_daemon", "--minutes",
         str(SOAK_MINUTES), "--report-every", str(SOAK_REPORT_S)],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=log, text=True)
    return proc, log, time.perf_counter()


def soak_finish(soak) -> bool:
    proc, log, t0 = soak
    try:
        out, _ = proc.communicate(timeout=SOAK_MINUTES * 60 + 300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        log.close()
    lines = out.strip().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    iv = res.get("intervals") or [{}]
    say("soak", f"scripts/soak_daemon.py --minutes {SOAK_MINUTES} on the card: rc "
                f"{proc.returncode}, ok {res.get('ok')}, {time.perf_counter() - t0:.1f} s wall, "
                f"{res.get('iterations')} iterations ({res.get('render')} renders, "
                f"{res.get('scene')} scenes, {res.get('stream')} sessions, {res.get('move')} "
                f"moves), daemon errors {res.get('daemon_errors')} of "
                f"{res.get('expected_errors')} expected; first interval {iv[0]}, last {iv[-1]}, "
                f"RSS start/peak/end {res.get('rss_start_mib')}/{res.get('rss_peak_mib')}/"
                f"{res.get('rss_end_mib')} MiB; failures {res.get('failures')}")
    if proc.returncode != 0 or not res.get("ok"):
        fail("soak", "the daemon soak failed")
        return False
    return True


def sweep_phase(db, device, noise, oracles, tmp, fwd_forms) -> dict | None:
    """The sweep gate (bench/sweep.py) at full scale on the card, counted:
    the four reference scenarios (172 x 72) and the mover on one Renderer,
    the two scene gates at 16 x 12,544 through BatchRenderer, each held to
    the oracle at 2e-7; then the CLI's --selftest-full.  The launches by
    kernel, or None on a failure."""
    from pathlib import Path

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.bench import sweep
    from jefferson_tpu_torch.cli.main import main as cli_main
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.io.wavio import write_wav
    from jefferson_tpu_torch.kernels import fused_step

    fused_step.reset_launches()
    t0 = time.perf_counter()
    renderer = Renderer(db, device=device)
    reports = sweep.run_benchmark_sweep(noise, db, renderer=renderer, oracle=oracles)
    names = [f"azi{int(a)}_ele{int(e)}" for a, e in sweep.SCENARIOS]
    reports.append(sweep.run_mover_gate(noise, db, renderer=renderer, oracle=oracles))
    names.append("mover")
    for scenario in ("hold", "movers"):
        reports.append(sweep.run_scene_gate(noise, db, scenario=scenario, device=device,
                                            oracle=oracles))
        names.append(f"scene_{scenario}")
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in fused_step.launches.items() if v}
    fwd_forms["sweep"] = dict(fused_step.forward_launches)
    for name, rep in zip(names, reports):
        margin = rep.max_abs_diff / SWEEP_EPS
        say("sweep", f"{name}: {rep}; margin {margin:.4f} (JAX package {SWEEP_JAX[name]}, the "
                     f"card's record {SWEEP_CARD.get(name, 'none')})")
        if not (rep.ok and margin < 1):
            fail("sweep", f"{name}: margin {margin:.4f}, the gate fails")
            return None
    worst = max(r.max_abs_diff for r in reports) / SWEEP_EPS
    say("sweep", f"7 scenarios in {wall:.1f} s (oracles from the workers), worst margin "
                 f"{worst:.4f} (MARGIN_WARN {sweep.MARGIN_WARN}), launches {launched}, launch A "
                 f"by form { {k: v for k, v in fwd_forms['sweep'].items() if v} }  "
                 f"[{bench.card()}]")
    if fault := launch_a_fault("the sweep", launched, fwd_forms["sweep"]):
        fail("sweep", fault)
        return None
    # the reference scenarios take row 5 without the crossfade (and the
    # side-pass), the mover row 4, scene_hold row 6 without it, scene_movers
    # row 2, and rows 5-6 their pre-blend from row 12
    for kernel in (fused_step.NO_XFADE, "fused_step_stream_onehot_grouped_xfade",
                   "fused_step_xfade/no_xfade", fused_step.GROUPED, "dma_blend"):
        if not launched.get(kernel):
            fail("sweep", f"the sweep did not launch {kernel}: {launched}")
            return None

    # the CLI's --selftest-full on the same input, its oracles from the workers
    src = Path(tmp) / "sweep_in.wav"
    write_wav(src, noise, 44100, bits=32, float_format=True)
    before = dict(fused_step.launches)
    own_oracle = sweep._oracle
    sweep._oracle = lambda signal, positions, db_, config: oracles(signal, positions)
    try:
        t0 = time.perf_counter()
        rc = cli_main(["-i", str(src), "-o", str(Path(tmp) / "selftest_full.wav"), "--blocks",
                       "64", "--selftest-full", "--float"])
        wall = time.perf_counter() - t0
    except SystemExit as e:
        fail("sweep", f"--selftest-full: {e}")
        return None
    finally:
        sweep._oracle = own_oracle
    cli = {k: v - before[k] for k, v in fused_step.launches.items() if v != before[k]}
    say("sweep", f"cli.main --selftest-full (4 x 12,556 blocks and the mover on the card, then "
                 f"a 64-block render): rc {rc} in {wall:.1f} s, launches {cli}")
    if rc != 0:
        fail("sweep", "--selftest-full did not pass")
        return None
    for k, v in cli.items():
        launched[k] = launched.get(k, 0) + v
    fwd_forms["sweep"] = dict(fused_step.forward_launches)
    return launched


def serve_phase(cfg, noise, oracles, serve_pos, tmp) -> dict | None:
    """The render daemon (python -m jefferson_tpu_torch.serve) in a process
    of its own on the card: a 12,556-block render twice (cold, warm) and a
    16-source scene held to the oracle; four paced 10-s sessions moved every
    100 ms, alone (the strict live gate) and beside back-to-back renders;
    viz.live.watch on one; stats and shutdown.  The daemon's launches by
    kernel (its own counts, from stats), or None on a failure."""
    import subprocess
    import threading
    from pathlib import Path

    import numpy as np

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.io.wavio import read_wav, write_wav
    from jefferson_tpu_torch.scripts.live_sessions import SESSION_GRACE_S, wait_played
    from jefferson_tpu_torch.serve import request
    from jefferson_tpu_torch.viz.live import watch

    tmp = Path(tmp) / "serve"
    tmp.mkdir()
    sock, src = tmp / "jt.sock", tmp / "in.wav"
    write_wav(src, noise, cfg.sample_rate, bits=32, float_format=True)
    render_pos, scene_pos = serve_pos
    render_oracle = oracles.submit(noise, render_pos)
    gained = noise * np.float32(SERVE_SCENE_GAIN)  # as render_scene_spec scales a source
    scene_oracles = [oracles.submit(gained, pos) for pos in scene_pos]
    render_req = {"cmd": "render", "input": str(src), "output": str(tmp / "render.wav"),
                  "trajectory": SERVE_ORBIT, "blocks": SCAN_B, "float": True, "bits": 32}
    log = open(tmp / "daemon.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "jefferson_tpu_torch.serve", "--socket",
                             str(sock)], cwd=Path(__file__).resolve().parent, stdout=log,
                            stderr=subprocess.STDOUT)

    def counts():
        return request(sock, {"cmd": "stats"})["launches"]

    def since(before):
        now = counts()
        return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}

    try:
        while proc.poll() is None and time.perf_counter() - t0 < 300:
            try:
                if request(sock, {"cmd": "ping"}).get("pong"):
                    break
            except OSError:
                time.sleep(0.05)
        else:
            fail("serve", f"the daemon did not come up (rc {proc.poll()}): "
                          f"{(tmp / 'daemon.log').read_text()[-2000:]}")
            return None
        rss = [rss_mib(proc.pid)]
        say("serve", f"daemon up in {time.perf_counter() - t0:.2f} s (a process on the card: "
                     f"torch import, the libraries built by build_all, the table uploaded, one "
                     f"live step and one render primed), warm-up launches {counts()}, RSS "
                     f"{rss[0]:.0f} MiB")

        # the render, cold then warm (the same request twice)
        before = counts()
        walls = []
        for _ in range(2):
            t1 = time.perf_counter()
            resp = request(sock, render_req)
            walls.append((time.perf_counter() - t1, resp.get("seconds")))
            if not resp.get("ok"):
                fail("serve", f"render: {resp}")
                return None
        render_launches = since(before)
        got = read_wav(tmp / "render.wav")[0]
        want = render_oracle.result()
        d_max, d_rms = diff(got, want) if got.shape == want.shape else (float("inf"),) * 2
        say("serve", f"render {SERVE_ORBIT}, {SCAN_B} blocks: cold {walls[0][0]:.3f} s at the "
                     f"client ({walls[0][1]} s in the daemon), warm {walls[1][0]:.3f} s "
                     f"({walls[1][1]} s); vs render_oracle max|diff| {d_max:.3e} (limit "
                     f"{ORACLE_TOL:.0e}), rms {d_rms:.3e}; launches (both) {render_launches}  "
                     f"[{bench.card()}]")
        if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
            fail("serve", "the daemon's render disagrees with the oracle")
            return None

        # the scene
        scene = {"sources": [{"input": str(src), "trajectory": spec, "gain": SERVE_SCENE_GAIN}
                             for spec in SERVE_SCENE]}
        before = counts()
        t1 = time.perf_counter()
        resp = request(sock, {"cmd": "scene", "scene": scene, "output": str(tmp / "scene.wav"),
                              "blocks": SCENE_B, "float": True, "bits": 32})
        wall = time.perf_counter() - t1
        scene_launches = since(before)
        if not resp.get("ok"):
            fail("serve", f"scene: {resp}")
            return None
        got = read_wav(tmp / "scene.wav")[0]
        want = np.sum([o.result().astype(np.float64) for o in scene_oracles], axis=0)
        d_max, d_rms = diff(got, want) if got.shape == want.shape else (float("inf"),) * 2
        say("serve", f"scene of {SCENE_S} orbits x {SCENE_B} blocks (gain {SERVE_SCENE_GAIN}): "
                     f"{wall:.3f} s at the client ({resp.get('seconds')} s in the daemon); the "
                     f"mix vs the sum of the sources' render_oracle max|diff| {d_max:.3e} (limit "
                     f"{ORACLE_TOL:.0e}), rms {d_rms:.3e}; launches {scene_launches}  "
                     f"[{bench.card()}]")
        if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
            fail("serve", "the daemon's scene disagrees with its oracles")
            return None

        # four paced sessions, alone and beside back-to-back renders
        live = {}
        for label in ("alone", "beside renders"):
            before = counts()
            sids = []
            for i in range(SERVE_SESSIONS):
                resp = request(sock, {"cmd": "stream_start", "input": str(src),
                                      "output": str(tmp / f"live{i}.wav"),
                                      "seconds": SERVE_SECONDS, "paced": True})
                if not resp.get("ok"):
                    fail("serve", f"stream_start: {resp}")
                    return None
                sids.append(resp["session"])
            stop, renders, bad = threading.Event(), [0], []

            def render_loop():
                while not stop.is_set():
                    r = request(sock, render_req)
                    renders[0] += 1
                    if not r.get("ok"):
                        bad.append(r)

            watched = {}

            def watcher():
                watched["status"] = watch(sock, tmp / "live.svg", session=sids[0],
                                          interval_s=0.05)

            bg = threading.Thread(target=render_loop if label != "alone" else watcher)
            bg.start()
            moves, k, t1 = 0, 0, time.perf_counter()
            while time.perf_counter() - t1 < SERVE_SECONDS + 0.5:
                for sid in sids:
                    m = request(sock, {"cmd": "move", "session": sid, "azi": (7 * k) % 360,
                                       "ele": 10, "r": 1.0})
                    moves += bool(m.get("ok"))
                k += 1
                time.sleep(SERVE_MOVE_S)
            # then until each has played its blocks (scripts/live_sessions.py)
            wait_played(sock, sids, time.time() + SESSION_GRACE_S)
            stop.set()
            bg.join(timeout=600)
            stats = [request(sock, {"cmd": "stream_stop", "session": sid}) for sid in sids]
            launched = since(before)
            live[label] = stats
            for sid, st in zip(sids, stats):
                say("serve", f"session {sid} {label}: {st.get('blocks')} blocks, avg "
                             f"{st.get('avg_ms')} / median {st.get('median_ms')} / p90 "
                             f"{st.get('p90_ms')} / p99 {st.get('p99_ms')} / max "
                             f"{st.get('max_ms')} ms, {st.get('misses')} misses of "
                             f"{st.get('budget_ms')} ms, {st.get('crossfades')} crossfades  "
                             f"[{bench.card()}]")
            blocks = sum(st.get("blocks", 0) for st in stats)
            say("serve", f"{SERVE_SESSIONS} sessions {label}: {moves} moves, {renders[0]} "
                         f"renders beside them; launches {launched} ({blocks} blocks + 2 a prime "
                         f"= {blocks + 2 * SERVE_SESSIONS} row-8 launches expected)")
            if bad or not all(st.get("ok") for st in stats):
                fail("serve", f"{label}: {bad or stats}")
                return None
            # the primes run outside the sessions' turns, so two may race an
            # increment of the count: between the blocks and every prime
            if label == "alone" and not (blocks <= launched.get(SPATIALIZER, 0)
                                         <= blocks + 2 * SERVE_SESSIONS):
                fail("serve", f"{label}: row 8 launched {launched.get(SPATIALIZER)} times, want "
                              f"{blocks + 2 * SERVE_SESSIONS}")
                return None
            if label == "alone":
                svg = tmp / "live.svg"
                status = watched.get("status", {})
                say("serve", f"viz.live.watch on {sids[0]}: ended at block "
                             f"{status.get('blocks')}/{status.get('total_blocks')}, "
                             f"{svg.name} {svg.stat().st_size if svg.exists() else 0} bytes")
                if not (status.get("ok") and svg.exists() and "listener" in svg.read_text()):
                    fail("serve", "viz.live.watch wrote no scene")
                    return None
                late = [st for st in stats if not (st["median_ms"] < LIVE_MEDIAN_MS
                                                   and st["p90_ms"] < LIVE_P90_MS)]
                if late:
                    fail("serve", f"sessions alone miss the strict live gate (median < "
                                  f"{LIVE_MEDIAN_MS}, p90 < {LIVE_P90_MS} ms): {late}")
                    return None

        # the meshed daemon's scene, on this meshless daemon first
        scene4_req = {"cmd": "scene", "scene": {"sources": scene["sources"][:MESH_SCENE_S]},
                      "blocks": MESH_SCENE_B, "float": True, "bits": 32}
        resp = request(sock, {**scene4_req, "output": str(tmp / "scene4.wav")})
        if not resp.get("ok"):
            fail("serve", f"scene of {MESH_SCENE_S}: {resp}")
            return None
        st = request(sock, {"cmd": "stats"})
        rss.append(rss_mib(proc.pid))
        t1 = time.perf_counter()
        down = request(sock, {"cmd": "shutdown"})
        rc = proc.wait(timeout=DAEMON_EXIT_S)
        exit_s = time.perf_counter() - t1
        say("serve", f"stats {st}; the daemon's RSS {rss[0]:.0f} MiB up, {rss[1]:.0f} MiB "
                     f"after the phase; shutdown {down}; the daemon exited rc {rc} in "
                     f"{exit_s:.2f} s (limit {DAEMON_EXIT_S} s)")
        if rc != 0 or not down.get("ok"):
            fail("serve", "the daemon did not shut down cleanly")
            return None
        meshed = meshed_serve(cfg, tmp, render_req, scene4_req)
        if meshed is None:
            return None
        return {k: st["launches"].get(k, 0) + meshed.get(k, 0)
                for k in {*st["launches"], *meshed}}
    except subprocess.TimeoutExpired:
        fail("serve", f"the daemon did not exit within {DAEMON_EXIT_S} s")
        return None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def meshed_serve(cfg, tmp, render_req, scene_req) -> dict | None:
    """The daemon on a mesh: ``serve --devices 2 --backend gloo`` (two ranks
    on cuda:0; NCCL refuses two ranks on one card) serves phase serve's
    render and a 4-source scene.  The render's blk mesh takes the unfused
    arms, as in the JAX package: it is held torch.equal to the unsharded
    unfused Renderer on the card and to the meshless daemon's fused render
    within KERNEL_TOL.  The scene's mix is each rank's partial mix summed:
    held torch.equal to the unsharded sources' render summed in that order,
    and to the meshless daemon's mix within MIX_ORDER_TOL.  Each rank's wall
    and collectives from the replies; stats; shutdown ending every rank
    with 0.  The launches of both ranks by kernel, or None on a failure."""
    import contextlib
    import os
    import signal
    import subprocess
    from pathlib import Path

    import numpy as np
    import torch

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.cli.main import parse_trajectory, scene_inputs
    from jefferson_tpu_torch.engine.batch import BatchRenderer
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.hrtf.kemar import synthetic_database
    from jefferson_tpu_torch.io.resample import read_wav_mono_at
    from jefferson_tpu_torch.io.wavio import read_wav
    from jefferson_tpu_torch.serve import request

    sock = Path(tmp) / "mesh.sock"
    log = open(Path(tmp) / "meshed.log", "w")
    t0 = time.perf_counter()
    # a session of its own: the launcher and the ranks it spawns end together
    proc = subprocess.Popen([sys.executable, "-m", "jefferson_tpu_torch.serve", "--socket",
                             str(sock), "--devices", str(MESH_SERVE_RANKS), "--backend", "gloo"],
                            cwd=Path(__file__).resolve().parent, stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        while proc.poll() is None and time.perf_counter() - t0 < MESH_SERVE_UP_S:
            try:
                if request(sock, {"cmd": "ping"}).get("pong"):
                    break
            except OSError:
                time.sleep(0.1)
        else:
            fail("serve", f"the meshed daemon did not come up (rc {proc.poll()}): "
                          f"{(Path(tmp) / 'meshed.log').read_text()[-2000:]}")
            return None
        say("serve", f"meshed daemon up in {time.perf_counter() - t0:.2f} s: "
                     f"{MESH_SERVE_RANKS} gloo ranks on cuda:0 (NCCL refuses two ranks on one "
                     f"card; NCCL across cards is not measured here)")
        got, launched = {}, {}
        for name, req in (("render", render_req), ("scene", scene_req)):
            out = Path(tmp) / f"{name}.mesh.wav"
            t1 = time.perf_counter()
            resp = request(sock, {**req, "output": str(out)})
            wall = time.perf_counter() - t1
            if not resp.get("ok"):
                fail("serve", f"meshed {name}: {resp}")
                return None
            got[name] = read_wav(out)[0]
            steps = {rec["step"]: rec["ranks"] for rec in resp["ranks"]}
            for r in steps["render"]:
                for k, v in r["launches"].items():
                    launched[k] = launched.get(k, 0) + v
                launched[LAUNCH_A] = launched.get(LAUNCH_A, 0) + r["forward"]
            say("serve", f"meshed {name}: {wall:.3f} s at the client; by rank: " + "; ".join(
                f"rank {r['rank']} read {i['wall_s']:.3f} s, render {r['wall_s']:.3f} s, "
                f"collectives {r['collectives']}, launches {r['launches']}"
                for i, r in zip(steps["read its inputs"], steps["render"]))
                + f"  [{bench.card()}]")
        st = request(sock, {"cmd": "stats"})
        down = request(sock, {"cmd": "shutdown"})
        rc = proc.wait(timeout=120)
        say("serve", f"meshed stats: world {st.get('world')}, rank 0's collectives "
                     f"{st.get('collectives')}, launches {st.get('launches')}; shutdown "
                     f"{down.get('ok')}; every rank exited, the launcher rc {rc}")
        if rc != 0 or not down.get("ok") or st.get("world") != MESH_SERVE_RANKS:
            fail("serve", "the meshed daemon did not shut down cleanly")
            return None
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)   # any rank a failure left behind
        proc.wait()
        log.close()

    # the references: the unsharded renders on the card in this process
    db = synthetic_database()
    device = torch.device("cuda", 0)
    sig = read_wav_mono_at(render_req["input"], cfg.sample_rate)
    pos = parse_trajectory(render_req["trajectory"]).sample(render_req["blocks"], cfg)
    unfused = Renderer(db, device=device, fused=False, chunk_blocks=MESH_SERVE_CHUNK).render(
        sig, pos)
    meshless = read_wav(Path(tmp) / "render.wav")[0]
    d_fused = float(np.abs(got["render"] - meshless).max())
    same = np.array_equal(got["render"], unfused)
    say("serve", f"meshed render torch.equal to the unsharded unfused card render: {same}; vs "
                 f"the meshless daemon's (fused) render max|diff| {d_fused:.3e} (limit "
                 f"{KERNEL_TOL:.0e})")
    feds, spos, _ = scene_inputs(scene_req["scene"], cfg, num_blocks=scene_req["blocks"])
    each = BatchRenderer(db, device=device).render(feds, spos)
    # a rank's two sources summed on the card (torch.sum over two is one
    # add), then the two ranks' partials (gloo, on the host)
    parts = [each[2 * r] + each[2 * r + 1] for r in range(MESH_SERVE_RANKS)]
    want_mix = parts[0] + parts[1]
    meshless_mix = read_wav(Path(tmp) / "scene4.wav")[0]
    same_mix = np.array_equal(got["scene"], want_mix)
    d_mix = float(np.abs(got["scene"] - meshless_mix).max())
    say("serve", f"meshed scene ({MESH_SCENE_S} sources x {MESH_SCENE_B} blocks, "
                 f"{MESH_SERVE_RANKS} ranks): torch.equal to the unsharded sources summed a "
                 f"rank's partial at a time: {same_mix}; vs the meshless daemon's one-pass mix "
                 f"max|diff| {d_mix:.3e} (limit {MIX_ORDER_TOL:.0e})")
    if not (same and d_fused <= KERNEL_TOL and same_mix and d_mix <= MIX_ORDER_TOL):
        fail("serve", "the meshed daemon's replies disagree with the unsharded renders")
        return None
    return launched


def surfaces_phase(cfg, files, tmp, fwd_forms) -> dict | None:
    """The CLI's --viz and --profile-dir (the trace names launch A and rows
    5 and 12; the CLI's stages timed apart), --selftest, rt for 3 s on the
    card (these in this process, counted), the acceptance script and the
    examples but 04 and 09 (processes of their own, at once).  The launches by
    kernel, or None on a failure."""
    import re
    import subprocess
    from pathlib import Path

    import numpy as np

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.cli.main import main as cli_main
    from jefferson_tpu_torch.kernels import fused_step
    from jefferson_tpu_torch.rt.__main__ import main as rt_main

    root = Path(__file__).resolve().parent
    tmp = Path(tmp) / "surfaces"
    tmp.mkdir()
    fused_step.reset_launches()
    # the examples and the acceptance script first: processes of their own
    # (04 and 09 spawn CPU ranks; phase mesh drives their paths on the card)
    procs = {}
    for ex in sorted((root / "jefferson_tpu_torch" / "examples").glob("*.py")):
        if ex.name in MESH_EXAMPLES:
            continue
        cwd = tmp / ex.stem
        cwd.mkdir()
        procs[ex.name] = (subprocess.Popen([sys.executable, str(ex)], cwd=cwd,
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), time.perf_counter())
    procs["acceptance"] = (subprocess.Popen(
        [sys.executable, "-m", "jefferson_tpu_torch.scripts.acceptance", str(tmp / "accept"),
         "--pytest-args", "tests/test_torch_build.py --noconftest -q -p no:cacheprovider"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        time.perf_counter())

    # the CLI with --viz and --profile-dir on the cli phase's input and tree
    out, prof = tmp / "viz.wav", tmp / "prof"
    t0 = time.perf_counter()
    rc = cli_main(["-i", str(files["in"]), "-o", str(out), "--trajectory", CLI_ORBIT,
                   "--hrtf-dir", str(files["tree"]), "--float", "--quiet", "--viz",
                   "--profile-dir", str(prof)])
    wall = time.perf_counter() - t0
    viz_launches = {k: v for k, v in fused_step.launches.items() if v}
    artifacts = [f"viz.wav{s}" for s in (".scene.svg", ".wave.svg", ".html", ".3d.html")]
    sizes = {a: (tmp / a).stat().st_size if (tmp / a).exists() else 0 for a in artifacts}
    traces = list(prof.glob("trace.*.json"))
    events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    spans: dict[str, float] = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans[e["name"]] = spans.get(e["name"], 0.0) + e.get("dur", 0) / 1e3
    # a kernel event's name is its demangled signature; its identifiers
    idents = {w for k in kernels for w in re.findall(r"[A-Za-z_]\w*", k)}
    named = {what: sorted(w for w in idents if w.startswith(sym))
             for what, sym in (("launch A", "forward_distance"),
                               ("row 5's launch B", "split_tail_xfade"),
                               ("row 12", "dma_blend"))}
    say("surfaces", f"cli.main --viz --profile-dir, -t 0 {CLI_ORBIT} on the cli phase's 30-s "
                    f"input and compact tree: rc {rc} in {wall:.3f} s, launches {viz_launches}; "
                    f"artifacts {sizes}; trace {traces[0].name if traces else None} with "
                    f"{len(kernels)} kernel names, by row {named}")
    say("surfaces", "the CLI's host stages from the trace (ms): "
                    + ", ".join(f"{k} {v:.1f}" for k, v in sorted(spans.items(),
                                                                 key=lambda kv: -kv[1])
                                if k.startswith(("cli.", "renderer."))) + f"  [{bench.card()}]")
    if rc != 0 or not all(sizes.values()) or not all(named.values()):
        fail("surfaces", "the CLI's --viz or --profile-dir wrote too little")
        return None
    if not viz_launches.get("fused_step_stream_xfade") or not viz_launches.get("dma_blend"):
        fail("surfaces", f"the traced render launched {viz_launches}, want rows 5 and 12")
        return None

    # --selftest (scaled) and rt for 3 s on the card, counted
    t0 = time.perf_counter()
    rc = cli_main(["-i", str(files["in"]), "-o", str(tmp / "selftest.wav"), "--blocks", "64",
                   "--selftest", "--float"])
    say("surfaces", f"cli.main --selftest (8 x 12 blocks, 4 scenarios, then a 64-block render): "
                    f"rc {rc} in {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        fail("surfaces", "--selftest did not pass")
        return None
    before = dict(fused_step.launches)
    t0 = time.perf_counter()
    rc = rt_main(["-i", str(files["in"]), "-o", str(tmp / "rt.wav"), "--seconds", "3"])
    rt_wall = time.perf_counter() - t0
    rt_launches = {k: v - before[k] for k, v in fused_step.launches.items() if v != before[k]}
    from jefferson_tpu_torch.io.wavio import read_wav

    y = read_wav(tmp / "rt.wav")[0]
    n = int(np.ceil(3.0 / cfg.block_duration))
    say("surfaces", f"rt --seconds 3 on the card (unpaced): rc {rc} in {rt_wall:.2f} s, "
                    f"launches {rt_launches}, output {y.shape}")
    if rc != 0 or y.shape != (n * cfg.frames_per_buffer, 2) or not np.isfinite(y).all() \
            or rt_launches.get(SPATIALIZER) != n + 2:
        fail("surfaces", f"rt: want {n} blocks and {n + 2} row-8 launches")
        return None

    # the processes started first
    failed = []
    for name, (p, t0) in procs.items():
        try:
            text, _ = p.communicate(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        tail = text.strip().splitlines()[-2:]
        say("surfaces", f"{name}: rc {p.returncode} in {time.perf_counter() - t0:.1f} s "
                        f"(started together): {' | '.join(tail)}")
        if p.returncode != 0:
            failed.append(name)
            print(text[-3000:], file=sys.stderr)
    if failed:
        fail("surfaces", f"{failed} failed")
        return None
    fwd_forms["surfaces"] = dict(fused_step.forward_launches)
    launched = {k: v for k, v in fused_step.launches.items() if v}
    if fault := launch_a_fault("the surfaces", launched, fwd_forms["surfaces"]):
        fail("surfaces", fault)
        return None
    return launched


def probe_signal(seed: int, n: int):
    """tests/test_diff.py's band-limited probe (white noise has a delta
    autocorrelation, which makes the waveform loss blind to the distance
    delay), 0.3 peak."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sig = np.convolve(rng.standard_normal(n), np.hanning(16), mode="same")
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def diff_cases() -> dict:
    """The diff phase's localize cases: name -> (signal, hidden positions,
    initial positions, localize's keyword arguments)."""
    import numpy as np

    tile = lambda p, n: np.tile(p, (n, 1)).astype(np.float32)
    half = MOVE_B // 2
    return {
        "example 03": (probe_signal(0, 9000), tile(LOC_TRUE, LOC_B), tile(LOC_INIT, LOC_B),
                       dict(steps=LOC_STEPS, lr=LOC_LR)),
        "moving source": (probe_signal(1, MOVE_B * 128),
                          np.concatenate([tile(MOVE_DIRS[0], half),
                                          tile(MOVE_DIRS[1], MOVE_B - half)]),
                          tile((0.0, 0.0, 1.0), MOVE_B),
                          dict(steps=MOVE_STEPS, lr=LOC_LR, segment_blocks=MOVE_SEG)),
    }


def fit_case(db):
    """tests/test_personalize.py's listener (``db`` seen through a smooth
    spectral tilt) and 24 of its directions, measured."""
    import numpy as np

    from jefferson_tpu_torch.hrtf.kemar import NUM_HRTF, HRTFDatabase, grid_position

    cfg = db.config
    k = np.arange(cfg.num_bins) / cfg.num_bins
    eq = (1.0 + 0.5 * np.sin(2 * np.pi * k))[None, None, :]
    hrirs = np.fft.irfft(db.spectra * eq, n=cfg.pad_len, axis=-1)
    truth = HRTFDatabase.from_hrirs(hrirs[:, :, : cfg.hrtf_len].astype(np.float32), cfg,
                                    source="tilted")
    picks = np.random.default_rng(5).choice(NUM_HRTF, size=24, replace=False)
    meas = [(grid_position(int(i))[1], grid_position(int(i))[0],
             truth.hrirs[i, :, : cfg.hrtf_len]) for i in picks]
    return truth, picks, meas


def _diff_cpu_job(kind: str):
    """The port's own CPU run of the diff phase's 12-block localize or its
    fit, on one thread in a worker: (result, seconds)."""
    import torch

    from jefferson_tpu_torch.diff.personalize import fit_database
    from jefferson_tpu_torch.diff.render import DifferentiableRenderer

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if kind == "localize":
        sig, true, init, kw = diff_cases()["example 03"]
        r = DifferentiableRenderer(_worker_db, device="cpu")
        out = r.localize(sig, r.render(sig, true), init, **kw)[0]
    else:
        fitted, hist = fit_database(fit_case(_worker_db)[2], _worker_db, steps=FIT_STEPS,
                                    device="cpu")
        out = (fitted.spectra, hist)
    return out, time.perf_counter() - t0


def three_runs(device, fn):
    """``fn()`` three times on the card: first (cold), again (warm; its peak
    memory, beside what was allocated when it started), and under
    torch.profiler with the CUDA activity alone, the device's busy time
    summed from the raw kernel and copy records (key_averages builds an
    event tree, slow over this path's 10^5 launches).  Returns ([three results],
    [first s, warm s], (warm peak MiB, MiB allocated at its start), busy ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device) / 2**20
        t0 = time.perf_counter()
        out.append(fn())
        walls.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated(device) / 2**20, start)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out.append(fn())
        torch.cuda.synchronize(device)
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    return out, walls, peak, busy


def diff_phase(bench, db, device, cpu_runs) -> bool:
    """The differentiable path on the card (module docstring, phase 12):
    localize on two cases and fit_database, each under the JAX tests'
    gates, run three times (``three_runs``): the stage times of the warm
    run, the idle share against its wall, its peak memory, the spread
    between the runs and, where ``cpu_runs`` has it, the distance to the
    port's CPU run."""
    import numpy as np

    from jefferson_tpu_torch.diff.personalize import fit_database
    from jefferson_tpu_torch.diff.render import DifferentiableRenderer
    from jefferson_tpu_torch.kernels import fused_step

    card = bench.card()
    t_phase = time.perf_counter()
    fused_step.reset_launches()
    r = DifferentiableRenderer(db, device=device)
    for name, (sig, true, init, kw) in diff_cases().items():
        b = len(true)
        target = r.render(sig, true)
        out, walls, peak, busy = three_runs(
            device, lambda: (r.localize(sig, target, init, **kw), dict(r.timings)))
        (fitted, hist), t = out[1]
        spread = max(float(np.abs(o[0][0] - fitted).max()) for o in out)
        d_azi = np.abs((fitted[:, 0] - true[:, 0] + 180.0) % 360.0 - 180.0)
        d_ele, d_r = np.abs(fitted[:, 1] - true[:, 1]), np.abs(fitted[:, 2] - true[:, 2])
        say("diff", f"localize, {name}: {b} blocks, {kw}: first run {walls[0]:.3f} s, warm "
                    f"{walls[1]:.3f} s: coarse grid {t['grid_candidates']} candidates "
                    f"{t['grid_s']:.3f} s, descent {t['descent_steps']} steps "
                    f"{t['descent_s']:.3f} s ({1e3 * t['descent_s'] / t['descent_steps']:.3f} "
                    f"ms a step), fine grid {t['fine_grid_candidates']} candidates "
                    f"{t['fine_grid_s']:.3f} s, polish {t['polish_steps']} steps "
                    f"{t['polish_s']:.3f} s ({1e3 * t['polish_s'] / t['polish_steps']:.3f} ms a "
                    f"step); device busy {busy:.1f} ms under torch.profiler (idle share "
                    f"{1 - busy / (walls[1] * 1e3):.3f} of the warm wall); max_memory_allocated "
                    f"{peak[0]:.1f} MiB ({peak[1]:.1f} allocated at the start); spread over "
                    f"the three runs {spread:.3g}  [{card}]")
        say("diff", f"localize, {name}: mean |error| azi {d_azi.mean():.4f} ele "
                    f"{d_ele.mean():.4f} degrees, r {d_r.mean():.5f} m; fitted mean "
                    f"{fitted.mean(axis=0).round(4).tolist()}; loss {hist[0]:.6g} -> "
                    f"{hist[-1]:.6g} ({len(hist)} entries)")
        if name == "example 03":
            ok = (hist[-1] < 0.25 * hist[0] and d_azi.mean() < 5.0 and d_ele.mean() < 5.0
                  and d_r.mean() < 0.1)
            cpu, cpu_s = cpu_runs["localize"].result()
            dist = np.abs(fitted - cpu).max(axis=0)
            say("diff", f"localize, {name}: the port's CPU run ({cpu_s:.1f} s on one thread) "
                        f"is {dist.tolist()} (azi, ele, r) away, max over blocks")
            if dist[:2].max() >= LOC_CPU_DEG or dist[2] >= LOC_CPU_M:
                fail("diff", f"localize, {name}: the card is {dist.tolist()} from the CPU run, "
                             f"want < {LOC_CPU_DEG} degrees and {LOC_CPU_M} m")
                return False
        else:
            segs = [float(d_azi[s0:s0 + MOVE_SEG].mean()) for s0 in range(0, b, MOVE_SEG)]
            say("diff", f"localize, {name}: mean |azi error| per {MOVE_SEG}-block segment "
                        f"{[round(e, 4) for e in segs]} degrees")
            ok = max(segs) < 10.0
        if not ok or not np.isfinite(fitted).all():
            fail("diff", f"localize, {name}: outside the JAX test's gates")
            return False

    truth, picks, meas = fit_case(db)
    err = lambda spectra: float(np.mean(np.abs(spectra - truth.spectra) ** 2))
    t0 = time.perf_counter()
    fit_database(meas, db, steps=0, device=device)
    wall0 = time.perf_counter() - t0
    out, walls, peak, busy = three_runs(
        device, lambda: fit_database(meas, db, steps=FIT_STEPS, device=device))
    fitted, hist = out[1]
    spread = max(float(np.abs(o[0].spectra - fitted.spectra).max()) for o in out)
    e0, e1 = err(db.spectra), err(fitted.spectra)
    near = max(float(np.abs(fitted.spectra[i] - truth.spectra[i]).max()
                     / np.abs(db.spectra[i] - truth.spectra[i]).max()) for i in picks[:5])
    say("diff", f"fit_database, {len(meas)} measurements, {FIT_STEPS} steps on the "
                f"{'x'.join(map(str, db.spectra.shape))} table: first run {walls[0]:.3f} s, "
                f"warm {walls[1]:.3f} s, {1e3 * (walls[1] - wall0) / FIT_STEPS:.3f} ms a step "
                f"(set-up and rebuild {wall0:.3f} s, a 0-step call); device busy {busy:.1f} ms "
                f"under torch.profiler (idle share {1 - busy / (walls[1] * 1e3):.3f}); "
                f"max_memory_allocated {peak[0]:.1f} MiB ({peak[1]:.1f} allocated at the "
                f"start); spread over the three runs "
                f"{spread:.3g}  [{card}]")
    cpu, cpu_s = cpu_runs["fit"].result()
    d_cpu = float(np.abs(fitted.spectra - cpu[0]).max())
    e_cpu = abs(e1 - err(cpu[0]))
    say("diff", f"fit_database: loss {hist[0]:.6g} -> {hist[-1]:.6g}; table error {e0:.6g} "
                f"-> {e1:.6g}; measured directions at {near:.4f} of their start; the port's "
                f"CPU run ({cpu_s:.1f} s on one thread): spectra {d_cpu:.3g} away (peak "
                f"{float(np.abs(cpu[0]).max()):.3g}), table error {e_cpu / e1:.3g} of it away, "
                f"loss {cpu[1][-1]:.6g}")
    if not (hist[-1] < 0.1 * hist[0] and e1 < 0.3 * e0 and near < 0.15):
        fail("diff", "fit_database: outside tests/test_personalize.py's gates")
        return False
    if d_cpu > FIT_CPU_TOL or e_cpu > FIT_ERR_REL * e1:
        fail("diff", f"fit_database: the card is {d_cpu:.3g} from the CPU run (want <= "
                     f"{FIT_CPU_TOL}), its table error {e_cpu / e1:.3g} of it (want <= "
                     f"{FIT_ERR_REL})")
        return False
    launched = {k: v for k, v in fused_step.launches.items() if v}
    say("diff", f"kernel launches in the phase: {launched or 'none'}; the phase "
                f"{time.perf_counter() - t_phase:.1f} s")
    if launched:
        fail("diff", "the differentiable path launched a kernel of the render path")
        return False
    return True


def rss_mib(pid: int) -> float:
    """A process's resident set, MiB (/proc/<pid>/status)."""
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")




def host_cpu() -> str:
    """The host's CPU model and core count (the CPU twins' results and the
    host path's times depend on it)."""
    import os
    import platform
    from pathlib import Path

    info = Path("/proc/cpuinfo")
    fields = {}
    for ln in info.read_text().splitlines() if info.exists() else []:
        if not ln.strip():
            break  # the first processor's block
        key, _, value = ln.partition(":")
        fields[key.strip()] = value.strip()
    model = fields.get("model name") or (
        f"{fields.get('vendor_id', platform.machine())} family {fields.get('cpu family', '?')} "
        f"model {fields.get('model', '?')}")
    return f"{model} x {os.cpu_count()}"


def main() -> int:
    import torch

    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}; host {host_cpu()}, torch's CPU kernels "
               f"{torch.backends.cpu.get_cpu_capability()}, MKL {torch.backends.mkl.is_available()}")
    if not torch.cuda.is_available():
        return fail("env", "torch.cuda.is_available() is false: no CUDA device")

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from jefferson_tpu_torch import native
    from jefferson_tpu_torch.kernels import build

    # the host library first: the oracle workers plan through it
    t0 = time.perf_counter()
    try:
        native.library()
    except RuntimeError as e:
        return fail("build", str(e))
    host = (build.library_path("native", native.TOOLCHAIN), time.perf_counter() - t0)

    pool = ProcessPoolExecutor(ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_oracle_init)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
            return run(pool, host, tmp)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run(pool, host, tmp) -> int:
    from concurrent.futures import wait

    import numpy as np
    import torch

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.config import DEFAULT_CONFIG
    from jefferson_tpu_torch.engine.batch import BatchRenderer
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.engine import stream as stream_mod
    from jefferson_tpu_torch.engine.stream import StreamingSpatializer, render_scan
    from jefferson_tpu_torch.hrtf.kemar import synthetic_database
    from jefferson_tpu_torch.kernels import build, dma_blend, fused_spatializer, fused_step
    from jefferson_tpu_torch.scripts import error_budget

    smi = bench.card()
    say("env", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    S, NB = bench.SOURCES, bench.BLOCKS
    device = torch.device("cuda", 0)
    cfg = DEFAULT_CONFIG
    fpb = cfg.frames_per_buffer
    db = synthetic_database(cfg)

    # the oracle renders of the single-source and live paths, then the
    # scene path's, one per (position set, source), run in the workers
    # while the card works
    noise = (np.random.default_rng(0).standard_normal(SIGNAL_SAMPLES) * 0.2).astype(np.float32)
    budget_pos = error_budget.scenario(config=cfg)
    oracle_pool = OraclePool(pool)
    budget_oracle = oracle_pool.submit(noise, budget_pos)
    scenarios = renders(bench)
    single_oracles = {name: oracle_pool.submit(noise, scenarios[name][0])
                      for name in ("sweep", "mover", "orbit", "helix")}
    oracle_of = lambda name: single_oracles["sweep" if name.startswith("sweep") else name]
    live = live_runs(bench, noise, fpb)
    live_oracles = {name: [pool.submit(_oracle_job, sigs[i], pos[i]) for i in range(len(pos))]
                    for name, (pos, sigs) in live.items()}
    scene_sigs = bench.scene_signals(noise, SCENE_S, SCENE_B, fpb)
    sets = scene_positions(bench)
    oracles = {name: {i: oracle_pool.submit(scene_sigs[i], pos[i]) for i in srcs}
               for name, (pos, srcs) in sets.items()}
    # the cli phase's inputs and its oracles (the device reverb on the card)
    cli_in = cli_inputs(pool, tmp, device)
    # the sweep gate's three other reference scenarios (its other four share
    # the path phase's renders), then the serve phase's render and scene
    from jefferson_tpu_torch.bench import sweep

    for azi, ele in sweep.SCENARIOS:
        oracle_pool.submit(noise, sweep.sweep_scenario(azi, ele, config=cfg))
    serve_pos = serve_inputs(noise, cfg)
    oracle_pool.submit(noise, serve_pos[0])
    for pos in serve_pos[1]:
        oracle_pool.submit(noise * np.float32(SERVE_SCENE_GAIN), pos)
    # the diff phase's CPU runs, one thread each
    diff_cpu = {kind: pool.submit(_diff_cpu_job, kind) for kind in ("localize", "fit")}
    # the geometry phase's renders, scenes and live sessions
    geo_oracles = geometry_oracles(
        bench, pool, noise, lambda c: bench.scene_signals(noise, SCENE_S, GEO_SAMPLES //
                                                          c.frames_per_buffer,
                                                          c.frames_per_buffer))

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all(["fused_step_onehot", "fused_step_gather", "assoc_probe", "dma_blend"],
                           geometries=[MAIN_GEOMETRY])
    say("build", f"{', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
        say("build", f"{lib.name} ptxas: {' | '.join(ptxas)}")
    say("build", f"host library {host[0].name} (g++, native/native.cpp) in {host[1]:.1f} s, "
                 f"before the oracle workers start: "
                 f"{host[0].with_suffix('.log').read_text().splitlines()[0]}")

    # ---- the host planner against its NumPy forms --------------------------
    if not plan_phase(bench, cfg, scenarios, sets):
        return 1

    # ---- kernels against their twins ----------------------------------------
    errs = {name: 0.0 for name in KERNELS}
    twin = lambda fn: getattr(sys.modules[fn.__module__], fn.__name__ + "_reference")
    for what, radius_step in (("compact distance", 0.0), ("per-row distance", 0.01)):
        wl = bench.build_workload(db, S, NB, device, radius_step=radius_step)
        if (wl.n_dist is None) != (radius_step > 0):
            return fail("kernel", f"{what}: the workload took the other distance form")
        args, kw = bench.step_operands(wl, cfg)
        got = fused_step.fused_step_onehot_xfade(*args, **kw)
        torch.cuda.synchronize()
        want = fused_step.fused_step_onehot_xfade_reference(*args, **kw)
        err = float((got - want).abs().max())
        _, hists = bench.run_step(wl)
        streams = torch.cat([wl.hists, wl.feds], dim=1)
        hist_ok = torch.equal(hists, streams[:, NB * fpb :])
        say("kernel", f"row 1, {what}, {S}x{NB}, U={wl.u_pad}: max|kernel - twin| = {err:.3e} "
                      f"(limit {KERNEL_TOL:.0e}); history bit-equal: {hist_ok}")
        if not (err <= KERNEL_TOL and hist_ok and bool(torch.isfinite(got).all())):
            return fail("kernel", f"row 1, {what}: kernel disagrees with its twin")
        errs["fused_step_onehot_xfade"] = max(errs["fused_step_onehot_xfade"], err)

    for form, name in FORMS.items():
        # the grouped form's default trajectory (the mover) has per-row
        # distance; the orbit gives it the compact form
        variants = [{}, {"radius_step": 0.01}] + ([{"trajectory": "orbit"}]
                                                  if form == "grouped" else [])
        for variant in variants:
            fn, args, kw = bench.stream_step(db, form, STREAM_B, device, tb=GROUP_TB,
                                             group_tiles=GROUP_TILES, xf_every=7, **variant)
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            want = twin(fn)(*args, **kw)
            err = float((got - want).abs().max())
            dist = "compact" if "n_dist" in kw else "per-row"
            extra = f", {STREAM_B // (GROUP_TB * GROUP_TILES)} groups of U={kw['u_pad']}" \
                if form == "grouped" else ""
            say("kernel", f"{name}, B={STREAM_B}, {dist} distance{extra}: max|kernel - twin| = "
                          f"{err:.3e} (limit {KERNEL_TOL:.0e})")
            if not (err <= KERNEL_TOL and got.shape == (STREAM_B, 2 * fpb)
                    and bool(torch.isfinite(got).all())):
                return fail("kernel", f"{name}: kernel disagrees with its twin")
            errs[name] = max(errs[name], err)

    fn, args, kw = bench.stream_step(db, "gather", STREAM_B, device, trajectory="hold", seed=4)
    _, args_n, kw_n = bench.stream_step(db, "gather_noxf", STREAM_B, device, trajectory="hold",
                                        seed=4)
    y_xf, y_noxf = fn(*args, **kw), fn(*args_n, **kw_n)
    bit_equal = bool(not args[-1].any()) and torch.equal(y_xf, y_noxf)
    say("kernel", f"row 5 on a crossfade-free chunk of {STREAM_B}: with_xfade=False bit-equal "
                  f"to with_xfade=True: {bit_equal}")
    if not bit_equal:
        return fail("kernel", "row 5's two forms differ on a crossfade-free chunk")

    for form, (name, s_, nb_) in SCENE_FORMS.items():
        # rows 2 and 6 take compact distance at |coordinates| = 1 and per-row
        # distance at the scenes' radii; row 7 takes its planes per row
        variants = [{}] if form.startswith("apply") else [{}, {"unit_radius": True}]
        for variant in variants:
            fn, args, kw = bench.scene_step(db, form, s_, nb_, device, xf_every=7, **variant)
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            want = twin(fn)(*args, **kw)
            err = float((got - want).abs().max())
            dist = "compact" if "n_dist" in kw else "per-row"
            extra = (f", groups of {kw['group_tiles'] * kw['tb'] // nb_} sources, tiles of "
                     f"{kw['tb']} rows, U={args[4].shape[0] * kw['tb'] * kw['group_tiles'] // (s_ * nb_)}"
                     if form == "grouped" else "")
            say("kernel", f"{name}, {s_}x{nb_}, {dist} distance{extra}: max|kernel - twin| = "
                          f"{err:.3e} (limit {KERNEL_TOL:.0e})")
            if not (err <= KERNEL_TOL and got.shape == (s_ * nb_, 2 * fpb)
                    and bool(torch.isfinite(got).all())):
                return fail("kernel", f"{name}: kernel disagrees with its twin")
            errs[name] = max(errs[name], err)
    for form, row in (("gather", 6), ("apply", 7)):
        _, s_, nb_ = SCENE_FORMS[form]
        fn, args, kw = bench.scene_step(db, form, s_, nb_, device, trajectory="still", seed=3)
        _, args_n, kw_n = bench.scene_step(db, form + "_noxf", s_, nb_, device,
                                           trajectory="still", seed=3)
        xf = args[6] if form == "gather" else args[4]
        bit_equal = bool(not xf.any()) and torch.equal(fn(*args, **kw), fn(*args_n, **kw_n))
        say("kernel", f"row {row} on a crossfade-free chunk of {s_}x{nb_}: with_xfade=False "
                      f"bit-equal to with_xfade=True: {bit_equal}")
        if not bit_equal:
            return fail("kernel", f"row {row}'s two forms differ on a crossfade-free chunk")

    # row 8 at the live stream's shape and render_scan's, the apply-only and
    # the forward form (launch A over one stream, then row 8)
    geo = dict(pad_len=cfg.pad_len, bins=cfg.num_bins, fpb=fpb)
    for rows in (1, SCAN_B):
        for dup in (False, True):
            table, fwd, br, xf = bench.spatializer_step(db, rows, device, duplicate=dup)
            scratch = tuple(torch.empty((rows, cfg.num_bins), device=device) for _ in range(2))
            got_f = fused_spatializer.fused_forward_apply(table, *fwd, *br, xf, scratch=scratch,
                                                          **geo)
            xd = fused_step._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
            got = fused_spatializer.fused_apply(table, *xd, *br, xf, bins=cfg.num_bins, fpb=fpb)
            torch.cuda.synchronize()
            want = fused_spatializer.fused_apply_reference(table, *xd, *br, xf, bins=cfg.num_bins,
                                                           fpb=fpb)
            want_f = fused_spatializer.fused_forward_apply_reference(table, *fwd, *br, xf, **geo)
            err = float((got - want).abs().max())
            err_f = float((got_f - want_f).abs().max())
            peak = max(float(a.abs().max()) for a in xd)
            fwd_rel = max(float((a - b).abs().max()) for a, b in zip(scratch, xd)) / peak
            finite = all(bool(torch.isfinite(y).all()) for y in (got, got_f))
            say("kernel", f"{SPATIALIZER}, {rows} row(s), {'duplicate' if dup else 'random'} "
                          f"brackets over {db.num_hrtf} filters: max|kernel - twin| = {err:.3e}, "
                          f"forward form {err_f:.3e} (limit {KERNEL_TOL:.0e}); launch A at "
                          f"nb = {rows}: max|XD - twin| / peak {peak:.2f} = {fwd_rel:.3e} "
                          f"(limit {FWD_REL:.0e})")
            if not (max(err, err_f) <= KERNEL_TOL and fwd_rel <= FWD_REL and finite
                    and got.shape == got_f.shape == (rows, 2 * fpb)):
                return fail("kernel", f"{SPATIALIZER}: kernel disagrees with its twin")
            errs[SPATIALIZER] = max(errs[SPATIALIZER], err, err_f)
    if not row8_forms(bench, db, device, geo, errs):
        return 1
    if not split_forms(bench, db, device, geo, errs):
        return 1
    if not forward_forms(bench, device, geo, errs):
        return 1
    if not row1_forms(bench, db, device, errs):
        return 1
    if not blend_forms(bench, db, device, errs):
        return 1

    # ---- the batched main path, counted ------------------------------------
    wl = bench.build_workload(db, S, NB, device)
    signals, positions = bench.moving_scene(RENDER_S, RENDER_B, cfg)
    renderer = BatchRenderer(db, device=device)
    fused_step.reset_launches()
    t0 = time.perf_counter()
    first, h = bench.run_step(wl)
    for _ in range(3):
        out, h = bench.run_step(wl, h)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rendered = renderer.render(signals, positions)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    batched = dict(fused_step.launches)
    fwd_forms = {"batched": dict(fused_step.forward_launches)}
    row1_by_form = dict(fused_step.row1_forms)

    row1 = batched["fused_step_onehot_xfade"]
    if row1 < 4 + RENDER_B // 256 or sum(batched.values()) != row1:
        return fail("path", f"the batched path launched {batched}")
    # the four bench steps (S x NB rows) and the render's chunks (RENDER_S x
    # 256 rows) each on the form pick_form names at their rows
    want_staged = 4 * (S * NB >= fused_step.STAGED_FROM) + (row1 - 4) * (
        RENDER_S * 256 >= fused_step.STAGED_FROM)
    say("path", f"row 1 by form on the batched path: {row1_by_form} (STAGED_FROM = "
                f"{fused_step.STAGED_FROM} rows)")
    if row1_by_form != {fused_step.LAUNCH_B: row1 - want_staged, fused_step.STAGED: want_staged}:
        return fail("path", f"row 1 by form {row1_by_form}, want {want_staged} staged launches")
    if fault := launch_a_fault("the batched path", batched, fwd_forms["batched"]):
        return fail("path", fault)
    finite = bool(torch.isfinite(first).all()) and bool(torch.isfinite(out).all())
    if first.shape != (S, NB, fpb, 2) or not finite:
        return fail("path", f"bench step output {tuple(first.shape)} not finite / not (S, nb, fpb, 2)")
    step_max, step_rms = oracle_diff(
        first[0].cpu().numpy().reshape(NB * fpb, 2), wl.feds[0].cpu().numpy(),
        bench.orbit(0, NB, cfg), db,
    )
    say("path", f"4 bench steps {S}x{NB} in {step_s * 1e3:.1f} ms (host clock); step 1 source 0 vs "
                f"render_oracle: max|diff| {step_max:.3e}, rms {step_rms:.3e}")
    if rendered.shape != (RENDER_S, RENDER_B * fpb, 2) or not np.isfinite(rendered).all():
        return fail("path", f"render output {rendered.shape} not finite / not (S, B*fpb, 2)")
    diffs = [oracle_diff(rendered[i], signals[i], positions[i], db) for i in range(RENDER_S)]
    r_max, r_rms = max(d[0] for d in diffs), max(d[1] for d in diffs)
    say("path", f"BatchRenderer {RENDER_S} sources x {RENDER_B} blocks in {render_s:.2f} s "
                f"(host planning included); vs render_oracle (every source): max|diff| "
                f"{r_max:.3e} (limit {ORACLE_TOL:.0e}), rms {r_rms:.3e} (limit {ORACLE_RMS:.0e}); "
                f"{row1} kernel launches on the path")
    if not (max(step_max, r_max) <= ORACLE_TOL and max(step_rms, r_rms) < ORACLE_RMS):
        return fail("path", "the port disagrees with the oracle")

    # ---- the single-source main path, counted ------------------------------
    signal = noise
    outs, walls, logs = {}, {}, {}
    fused_step.reset_launches()
    for name, (pos, opts, _) in scenarios.items():
        r = Renderer(db, device=device, **opts)
        t0 = time.perf_counter()
        outs[name] = r.render(signal, pos)
        walls[name] = time.perf_counter() - t0
        logs[name] = r.dispatch
    single = dict(fused_step.launches)
    fwd_forms["single"] = dict(fused_step.forward_launches)
    if fault := launch_a_fault("the single-source path", single, fwd_forms["single"]):
        return fail("path", fault)

    def margin_line(name, d_max, d_rms):
        jax = JAX_MARGIN.get(name)
        return (f"vs render_oracle max|diff| {d_max:.3e} (limit {ORACLE_TOL:.0e}), rms {d_rms:.3e} "
                f"(limit {ORACLE_RMS:.0e}); margin against {SWEEP_EPS:.0e} {d_max / SWEEP_EPS:.3f} "
                f"(JAX package: {'none recorded' if jax is None else jax})")

    for name, (pos, _, arm) in scenarios.items():
        got, log = outs[name], logs[name]
        if got.shape != (len(pos) * fpb, 2) or not np.isfinite(got).all():
            return fail("path", f"{name}: output {got.shape} not finite / not (B*fpb, 2)")
        d_max, d_rms = diff(got, oracle_of(name).result())
        say("path", f"Renderer {name}, {len(pos)} blocks, {len(log)} chunks as {sorted(set(log))} "
                    f"in {walls[name]:.2f} s (host planning included): "
                    f"{margin_line(name, d_max, d_rms)}")
        if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
            return fail("path", f"{name}: the port disagrees with the oracle")
        if set(log) != {arm}:
            return fail("path", f"{name}: dispatch {sorted(set(log))}, the JAX dispatch takes {arm}")
    say("path", f"single-source launches: {single}, on the split form "
                f"{ {k: v for k, v in fused_step.split_launches.items() if v} }")
    if (single["fused_step_onehot_xfade"]
            or not all(single[FORMS[f]] for f in FORMS)):
        return fail("path", f"the single-source path did not launch every step: {single}")
    # rows 5's pre-blend (blend_rows) goes through row 12 on every gather-form chunk
    gather_chunks = sum(1 for log in logs.values() for arm, _, _ in log
                        if arm in ("dedup_fused", "gather_fused"))
    say("path", f"row 12 (dma_blend) under row 5's pre-blend: {single['dma_blend']} launches on "
                f"{gather_chunks} gather-form chunks, by form "
                f"{ {k: v for k, v in fused_step.blend_forms.items() if v} }")
    if single["dma_blend"] < gather_chunks or not gather_chunks:
        return fail("path", f"row 5's pre-blend launched dma_blend {single['dma_blend']} times "
                            f"on {gather_chunks} gather-form chunks")
    if not any(sparse for _, _, sparse in logs["sweep"]):
        return fail("path", "the sparse side-pass did not run")
    del outs

    # ---- the scene path, counted -------------------------------------------
    scene_log, scene_walls = {}, {}
    fused_step.reset_launches()
    for name, (pset, cb, opts, arm, kernel) in scenes().items():
        pos, srcs = sets[pset]
        r = BatchRenderer(db, device=device, chunk_blocks=cb, **opts)
        before = dict(fused_step.launches)
        split_before = dict(fused_step.split_launches)
        t0 = time.perf_counter()
        got = r.render(scene_sigs, pos)
        torch.cuda.synchronize()
        scene_walls[name] = (time.perf_counter() - t0, r.timings)
        launched = {k: v - before[k] for k, v in fused_step.launches.items() if v != before[k]}
        split = fused_step.split_launches[kernel] - split_before[kernel]
        form = fused_step.pick_form(kernel, SCENE_S * cb)
        scene_log[name] = r.dispatch
        if got.shape != (SCENE_S, SCENE_B * fpb, 2) or not np.isfinite(got).all():
            return fail("path", f"{name}: output {got.shape} not finite / not (S, B*fpb, 2)")
        d = [diff(got[i], oracles[pset][i].result()) for i in srcs]
        d_max, d_rms = max(x[0] for x in d), max(x[1] for x in d)
        which = "every source" if len(srcs) == SCENE_S else f"sources {', '.join(map(str, srcs))}"
        say("path", f"BatchRenderer {name}, {SCENE_S}x{SCENE_B}, chunks of {cb}: {len(r.dispatch)} "
                    f"chunks as {sorted(set(r.dispatch))}, launches {launched}, {split} on "
                    f"the split form, in "
                    f"{scene_walls[name][0]:.2f} s; {which} {margin_line(name, d_max, d_rms)}")
        if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
            return fail("path", f"{name}: the port disagrees with the oracle")
        if set(r.dispatch) != {arm}:
            return fail("path", f"{name}: dispatch {sorted(set(r.dispatch))}, the JAX dispatch "
                                f"takes {arm}")
        blends = launched.pop("dma_blend", 0)
        if launched != {kernel: len(r.dispatch)}:
            return fail("path", f"{name}: launched {launched}, want {kernel} once per chunk")
        # rows 6 and 7 take their filter rows from blend_rows (row 12), row 2
        # blends in its own launch B
        if (blends < len(r.dispatch)) if kernel != fused_step.GROUPED else blends:
            return fail("path", f"{name}: {blends} dma_blend launches on {len(r.dispatch)} "
                                f"chunks of {kernel}")
        if split != (len(r.dispatch) if form == fused_step.SPLIT else 0):
            return fail("path", f"{name}: {split} of {len(r.dispatch)} launches on the split "
                                f"form, want every launch on {form}")
        del got
    scene_launches = dict(fused_step.launches)
    fwd_forms["scene"] = dict(fused_step.forward_launches)
    if fault := launch_a_fault("the scene path", scene_launches, fwd_forms["scene"]):
        return fail("path", fault)
    say("path", f"scene launches: {scene_launches}, on the split form "
                f"{ {k: v for k, v in fused_step.split_launches.items() if v} }, row 12 by form "
                f"{ {k: v for k, v in fused_step.blend_forms.items() if v} }")
    for kernel in ("fused_step_xfade", "fused_step_xfade/no_xfade", fused_step.GROUPED):
        if fused_step.split_launches[kernel] != scene_launches[kernel] or not scene_launches[kernel]:
            return fail("path", f"{kernel}: the scene path did not run it on the split form")

    # ---- the live path, counted ---------------------------------------------
    fused_step.reset_launches()
    scan_walls = {}
    for name in ("sweep", "mover"):
        pos = scenarios[name][0]
        t0 = time.perf_counter()
        got = render_scan(signal, db, pos, cfg, device=device)
        scan_walls[name] = time.perf_counter() - t0
        if got.shape != (len(pos) * fpb, 2) or not np.isfinite(got).all():
            return fail("path", f"render_scan {name}: output {got.shape} not finite / not (B*fpb, 2)")
        d_max, d_rms = diff(got, oracle_of(name).result())
        say("path", f"render_scan {name}, {len(pos)} blocks in {scan_walls[name]:.3f} s (host "
                    f"planning included): {margin_line('render_scan ' + name, d_max, d_rms)}")
        if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
            return fail("path", f"render_scan {name}: the port disagrees with the oracle")
    scan_launches = {k: v for k, v in fused_step.launches.items() if v}
    scan_forms = {k: v for k, v in fused_step.spatializer_forms.items() if v}
    fwd_forms["scan"] = dict(fused_step.forward_launches)
    if fault := launch_a_fault("render_scan", scan_launches, fwd_forms["scan"]):
        return fail("path", fault)
    scan_form = fused_spatializer.MANY_ROWS_FORM
    if scan_launches != {SPATIALIZER: 2} or scan_forms != {scan_form: 2}:
        return fail("path", f"render_scan launched {scan_launches} as {scan_forms}, want "
                            f"{SPATIALIZER} once per scan on {scan_form}")
    live_launches = 0
    for name, (pos, sigs) in live.items():
        fused_step.reset_launches()
        stats, got, spats = drive_live(db, device, pos, sigs)
        launched = {k: v for k, v in fused_step.launches.items() if v}
        forms = dict(fused_step.spatializer_forms)
        fwd_forms[f"live {name}"] = fwd = dict(fused_step.forward_launches)
        if fwd[fused_step.FWD_FEW] != sum(fwd.values()):
            return fail("path", f"live {name}: launch A by form {fwd}, want every block on the "
                                f"few-block form")
        if fault := launch_a_fault(f"live {name}", launched, fwd):
            return fail("path", fault)
        n_src, n_blk = pos.shape[:2]
        crossfades = sum(sp.crossfades for sp in spats)
        live_launches += forms["cluster"]
        d = [diff(got[i], live_oracles[name][i].result()) for i in range(n_src)]
        d_max, d_rms = max(x[0] for x in d), max(x[1] for x in d)
        ms = np.asarray(stats.compute_ms)
        shared = all(sp._table is spats[0]._table for sp in spats)
        say("path", f"live {name}: {n_src} source(s) x {n_blk} blocks, "
                    f"{crossfades} crossfades, one shared table: {shared}, "
                    f"launches {launched} (prime: 2 per source), row 8 by form "
                    f"{ {k: v for k, v in forms.items() if v} }, launch A by form "
                    f"{ {k: v for k, v in fwd.items() if v} }; every source vs render_oracle "
                    f"max|diff| {d_max:.3e} (limit {ORACLE_TOL:.0e}), rms {d_rms:.3e}; "
                    f"{stats.summary()}; median {np.median(ms):.4f} ms, p90 "
                    f"{np.percentile(ms, 90):.4f} ms  [{bench.card()}]")
        if got.shape != (n_src, n_blk * fpb, 2) or not np.isfinite(got).all():
            return fail("path", f"live {name}: output {got.shape} not finite")
        if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
            return fail("path", f"live {name}: the port disagrees with the oracle")
        if launched != {SPATIALIZER: n_src * n_blk + 2 * n_src} or not shared:
            return fail("path", f"live {name}: launched {launched}, want {SPATIALIZER} once per "
                                f"block and source and twice per prime, on one shared table")
        if forms != {"cluster": n_src * n_blk + 2 * n_src, "launch_b": 0, "split": 0}:
            return fail("path", f"live {name}: row 8 by form {forms}, want every live block "
                                f"on the cluster form")

    # the geometry phase's libraries, in a process of their own from here on
    # (after the live path's gates, which its compilers would load)
    geo_build = geometry_build_start()

    # ---- the probes: the scripts, counted, each kernel against its twin ----
    fused_step.reset_launches()
    probe_launches = probe_scripts(device, errs, db, noise, budget_pos, budget_oracle)
    if probe_launches is None:
        return 1

    # ---- the file-to-file CLI, counted ---------------------------------------
    cli_launches = cli_phase(bench, cli_in, cfg, fwd_forms)
    if cli_launches is None:
        return 1

    # ---- the sweep gate and the other surfaces, the daemon's soak beside
    # them, then the daemon, each counted ------------------------------------
    soak = soak_start(tmp)
    try:
        sweep_launches = sweep_phase(db, device, noise, oracle_pool, tmp, fwd_forms)
        if sweep_launches is None:
            return 1
        surface_launches = surfaces_phase(cfg, cli_in[3], tmp, fwd_forms)
        if surface_launches is None or not soak_finish(soak):
            return 1
    finally:
        if soak[0].poll() is None:
            soak[0].kill()
            soak[0].communicate()
    # the serve phase holds the daemon's sessions to the live gate on the
    # host's clock: the workers (the serve oracles, the diff phase's CPU
    # runs) and the geometry phase's compilers finish first, so that no core
    # is theirs while it measures
    t0 = time.perf_counter()
    wait([*oracle_pool.futures.values(), *diff_cpu.values(), *geo_oracles.values()])
    built = geometry_build_finish(geo_build)
    say("serve", f"waited {time.perf_counter() - t0:.1f} s for the worker pool to go idle and "
                 f"the geometry builds to end ({built:.1f} s of it for the builds)")
    serve_launches = serve_phase(cfg, noise, oracle_pool, serve_pos, tmp)
    if serve_launches is None:
        return 1

    # ---- the differentiable path, beside the port's CPU runs ---------------
    if not diff_phase(bench, db, device, diff_cpu):
        return 1

    # ---- every other block and transform size through the kernels ---------
    by_geometry = geometry_phase(bench, device, noise, geo_oracles, geo_build)
    if not isinstance(by_geometry, dict):   # None, or the code of a failed check
        return 1

    # ---- the mesh paths, in ranks of their own ------------------------------
    mesh_launches = mesh_phase(bench, tmp, sets, oracles, single_oracles["orbit"].result())
    if mesh_launches is None:
        return 1

    # ---- timings -----------------------------------------------------------
    step_ms = bench.time_steps_ms(wl)
    bps = S * NB / (step_ms * 1e-3)
    say("bench", f"{S}x{NB} step {step_ms:.4f} ms = {bps:,.0f} blocks/s  [{bench.card()}]")
    step_forms(bench, wl)
    # kernel -> (wrapper, args, kwargs, sources, blocks): the main path's shapes
    ops = {"fused_step_onehot_xfade": (fused_step.fused_step_onehot_xfade,
                                       *bench.step_operands(wl, cfg), S, NB)}
    for form, name in FORMS.items():
        fn, args, kw = bench.stream_step(db, form, STREAM_B, device, tb=GROUP_TB,
                                         group_tiles=GROUP_TILES)
        ops[name] = (fn, args, kw, 1, STREAM_B)
    for form, (name, s_, nb_) in SCENE_FORMS.items():
        ops[name] = (*bench.scene_step(db, form, s_, nb_, device), s_, nb_)
    # row 8 on the caller's XD planes: render_scan's shape (launch B), then
    # the live shape (the cluster form), which stands in the kernels line
    kw8 = dict(bins=cfg.num_bins, fpb=fpb)
    for rows in (SCAN_B, 1):
        table, fwd, br, xf = bench.spatializer_step(db, rows, device)
        xd = fused_step._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
        at = "" if rows == 1 else f" at {SCAN_B} rows"
        ops[SPATIALIZER + at] = (fused_spatializer.fused_apply, (table, *xd, *br, xf), kw8, 1,
                                 rows)
    times, bounds, forms_of, held_ms = {}, {}, {}, {}
    for name, (fn, args, kw, s_, nb_) in ops.items():
        # the main path's form first, then the other: events in turns (twin,
        # forms, forms reversed, twin), then each form's device time alone
        calls = form_calls(name, fn, args, kw, s_ * nb_, device, geo)
        p = lambda: twin(fn)(*args, **kw)
        plain_a = bench.time_ms(p)
        ev = {f: [bench.time_ms(c)] for f, c in calls.items()}
        for f, c in reversed(calls.items()):
            ev[f].append(bench.time_ms(c))
        plain_b = bench.time_ms(p)
        forms_of[name] = picked = next(iter(calls))
        times[name] = (sum(ev[picked]) / 2, (plain_a + plain_b) / 2)
        moved = nbytes(*args, *kw.values(), calls[picked]())
        if name.startswith(SPATIALIZER):
            # of the full table, the function reads the rows its brackets name
            table = args[0]
            ids = torch.cat([a for a in args if a.dtype == torch.int32]).unique()
            moved += (ids.numel() - table.shape[0]) * table.shape[1] * table.element_size()
        bounds[name] = bench.bound_ms(bench.step_flops(name.split(" at ")[0], s_, nb_), moved)
        for f, c in calls.items():
            a_ms, b_ms = launches_apart(bench.device_profile(c, calls=20))
            # the same calls queued behind a held stream, as phase geometry
            # reads its rows
            held = queued_device_ms(c)
            if f == picked:
                held_ms[name] = held
            say("bench", f"{name} ({s_}x{nb_}), {f}{' (main path)' if f == picked else ''}: "
                         f"kernel {ev[f][0]:.4f}/{ev[f][1]:.4f} ms (device time alone "
                         f"{a_ms + b_ms:.4f} ms: launch A {a_ms:.4f}, launch B {b_ms:.4f}; "
                         f"torch.profiler; {held:.4f} ms queued behind a held stream), twin "
                         f"{plain_a:.4f}/{plain_b:.4f} ms, bound {bounds[name][0]:.6f} ms "
                         f"({bounds[name][1]})  [{bench.card()}]")
    row8_crossover(bench, db, device, geo)
    split_crossover(bench, db, device)
    row1_crossover(bench, db, device)
    forward_bench(bench, device, geo, times, bounds, held_ms)
    for name, (fn, args, kw, flops, moved, lib) in probe_timed(device).items():
        k = lambda: fn(*args, **kw)
        p = lambda: twin(fn)(*args, **kw)
        plain_a, kernel_a, kernel_b, plain_b = (bench.time_ms(f) for f in (p, k, k, p))
        lib_ms = bench.time_ms(lib)
        lib_alone = queued_device_ms(lib)
        times[name] = ((kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2, lib_ms)
        if moved is None:
            out = k()
            moved = nbytes(*args, *(out if isinstance(out, tuple) else (out,)))
        bounds[name] = bench.bound_ms(flops, moved)
        # the call alone on the device (queued behind a held stream, as every
        # other row is read): at these sizes a call's events time the host's
        # launch path, and torch.profiler late in the smoke reads near 0
        held_ms[name] = device_ms = queued_device_ms(k)
        say("bench", f"{name} ({', '.join('x'.join(map(str, a.shape)) for a in args[:2])}): kernel "
                     f"{kernel_a:.4f}/{kernel_b:.4f} ms (device time alone {device_ms:.4f} ms, "
                     f"queued behind a held stream), twin {plain_a:.4f}/{plain_b:.4f} ms, library "
                     f"{lib_ms:.4f} ms (device time alone {lib_alone:.4f} ms), bound "
                     f"{bounds[name][0]:.5f} ms ({bounds[name][1]})  [{bench.card()}]")
        if name == "prod":
            prod_host_path(bench, device, args, lib)
            card_ms = (kernel_a + kernel_b) / 2
            say("bench", f"prod (row 9) card ms {card_ms:.4f} against torch.mul's {lib_ms:.4f} "
                         f"in this run: at or under it {card_ms <= lib_ms}  [{bench.card()}]")
    if not fetch_renders(bench, db, device, scenarios, sets, scene_sigs, signal, scene_walls):
        return 1
    pos = scenarios["sweep"][0]
    t0 = time.perf_counter()
    render_scan(signal, db, pos, cfg, device=device)
    wall = time.perf_counter() - t0
    say("bench", f"render_scan sweep: {wall:.3f} s wall for {len(pos)} blocks "
                 f"({len(pos) / wall:,.0f} blocks/s, host planning and transfers included); "
                 f"first run {scan_walls['sweep']:.3f} s  [{bench.card()}]")
    profile(bench, "render_scan sweep", lambda: render_scan(signal, db, pos, cfg, device=device),
            wall)
    sp = StreamingSpatializer(db, device=device)
    sp.prime()
    blk = noise[:fpb]

    def live_blocks():
        for i in range(WORST_BLOCKS):
            sp.set_position(azi=(i * 3) % 360, ele=10, r=1.0)
            sp.process_block(blk)

    live_blocks()  # every position set up once: the memos hit from here on
    t0 = time.perf_counter()
    live_blocks()
    wall = time.perf_counter() - t0
    say("bench", f"{WORST_BLOCKS} live blocks, a 3-degree move every block, positions set up: "
                 f"{wall * 1e3:.1f} ms wall ({wall * 1e3 / WORST_BLOCKS:.4f} ms per block)  "
                 f"[{bench.card()}]")
    profile(bench, f"{WORST_BLOCKS} live blocks", live_blocks, wall)

    def held_blocks():  # one move onto the position, then held blocks
        sp.set_position(azi=40, ele=10, r=1.0)
        for _ in range(WORST_BLOCKS):
            sp.process_block(blk)

    held_blocks()
    t0 = time.perf_counter()
    held_blocks()
    wall = time.perf_counter() - t0
    say("bench", f"{WORST_BLOCKS} live blocks held at one position (the no-crossfade step; the "
                 f"first crossfades onto it), memos hit: {wall * 1e3:.1f} ms wall "
                 f"({wall * 1e3 / WORST_BLOCKS:.4f} ms per block)  [{bench.card()}]")
    profile(bench, f"{WORST_BLOCKS} held live blocks", held_blocks, wall)

    def new_positions():  # a new position each time: both memos miss
        sp._interp_cache.clear()
        sp._dist_cache.clear()
        t0 = time.perf_counter()
        for i in range(WORST_BLOCKS):
            sp.set_position(azi=i, ele=20, r=1.0 + 0.001 * i)
            sp._interp(sp.ele, sp.azi)
            sp._distance_current()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / WORST_BLOCKS

    def host_calls():  # the set-up's two host-library calls alone, no upload
        t0 = time.perf_counter()
        for i in range(WORST_BLOCKS):
            stream_mod.interpolation_calculations(np.float32(20.0), np.float32(i))
            stream_mod.distance_phase_split(cfg.fsvs, np.float32([1.0 + 0.001 * i]),
                                            cfg.num_bins)
        return (time.perf_counter() - t0) * 1e3 / WORST_BLOCKS

    lib_a, lib_calls_a = new_positions(), host_calls()
    with bench.plain_host():
        np_a, np_calls_a = new_positions(), host_calls()
        np_b, np_calls_b = new_positions(), host_calls()
    lib_b, lib_calls_b = new_positions(), host_calls()
    say("bench", f"host set-up of a new live position (interpolation, distance split and their "
                 f"uploads): {lib_a:.4f}/{lib_b:.4f} ms with the host library (its two calls "
                 f"alone {lib_calls_a:.4f}/{lib_calls_b:.4f} ms), {np_a:.4f}/{np_b:.4f} ms with "
                 f"its NumPy forms (the calls alone {np_calls_a:.4f}/{np_calls_b:.4f} ms), in "
                 f"turns  [{bench.card()}]")

    blend_bench(bench, device, held_ms)
    blend_wiring(bench, db, device, sets, scene_sigs)

    sparse_calls = sum(1 for log in (logs["sweep"], scene_log["scene_hold"],
                                     scene_log["scene_hold_512"])
                       for _, _, bucket in log if bucket is not None)
    sidepass_bench(bench, db, device, cfg, sparse_calls)

    launches = {**single, **{k: v for k, v in scene_launches.items() if v},
                "fused_step_onehot_xfade": row1, SPATIALIZER: 2 + live_launches,
                **{name: probe_launches[name] for name in PROBES},
                LAUNCH_A: sum(sum(f.values()) for f in fwd_forms.values())}
    # row 12 runs on the render paths (rows 5-7's pre-blend) and in the probes
    launches["dma_blend"] += single["dma_blend"] + scene_launches["dma_blend"]
    # and the cli, sweep, surfaces and serve phases' renders (launch A's
    # through fwd_forms, but for the daemon's, which counts its own)
    for counted in (cli_launches, sweep_launches, surface_launches, serve_launches,
                    mesh_launches):
        for name, n in counted.items():
            launches[name] += n
    say("path", f"launch A on the counted paths by form: {fwd_forms}")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": times[name][0],
        # rows 1-8: the main path's form queued behind a held stream (launch
        # A at 16 x 256 and row 12 at the probe's shape too)
        "device_ms": held_ms.get(name),
        "plain_ms": times[name][1],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        # launch B's form on the main path (rows 1-8), launch A's at 16 x 256,
        # row 12's at the probe's rows; rows 9-11 have one
        "form": forms_of.get(name, fused_step.forward_form(256) if name == LAUNCH_A
                             else fused_step.DEDUP if name == "dma_blend"
                             else None),
        # no single PyTorch call computes a fused step (rows 1-8)
        "library_ms": times[name][2] if name in PROBES else None,
        # phase geometry: the launches of each geometry's renders, scans,
        # scenes and live blocks (f128: the counted paths above), and where
        # the kernel was timed there, its shape, form, times, bound and
        # max|kernel - twin| over its forms
        "launches_by_geometry": {"f128": launches[name],
                                 **{g: r["launches"].get(name, 0) for g, r in by_geometry.items()}},
        # rows 2-8: the launches of those that took launch B's split form
        "split_launches_by_geometry": {g: r["split_launches"][name]
                                       for g, r in by_geometry.items()
                                       if name in r["split_launches"]},
        "geometry": {g: {**r["times"][name], "max_abs_err": r["errs"].get(name)}
                     for g, r in by_geometry.items() if name in r["times"]},
    } for name, (source, replaces) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def form_calls(name, fn, args, kw, rows: int, device, geo) -> dict:
    """The step ``name`` on its operands in each form it has on the card,
    the one its wrapper picks at ``rows`` rows first: {form: call}."""
    from jefferson_tpu_torch.kernels import fused_spatializer as fsp
    from jefferson_tpu_torch.kernels import fused_step

    if name == SPATIALIZER:  # the live shape: the cluster form only
        return {fsp.pick_form(rows): lambda: fn(*args, **kw)}
    if name.startswith(SPATIALIZER):
        table, xdr, xdi, *br, xf = args
        call = lambda f: lambda: fsp._cuda(device, rows, table, tuple(br), xf, xdr, xdi, None,
                                           form=f, **geo)
        picked = fsp.pick_form(rows)
    else:  # rows 2-7: launch B and the split form; row 1: launch B and the staged form
        call = lambda f: lambda: fused_step._cuda(fn, *args, form=f, **kw)
        picked = fused_step.pick_form(name, rows)
    second = fused_step.SPLIT if name in fused_step.split_launches else fused_step.STAGED
    other = second if picked == fused_step.LAUNCH_B else fused_step.LAUNCH_B
    return {picked: call(picked), other: call(other)}


def launches_apart(rows) -> tuple[float, float]:
    """(launch A, launch B) ms of a step's device_profile rows."""
    a = sum(ms for kernel, ms, _ in rows if "forward_distance" in kernel)
    return a, sum(ms for _, ms, _ in rows) - a


CROSS_ROWS = (8, 64, 512, 4096, 16384)    # rows 2-7's crossover, and row 8's above 512
CROSS_ROWS_8 = (1024, 4096, SCAN_B, 16384)


def split_crossover(bench, db, device) -> None:
    """Launch B's two forms on the same operands, device time alone, at
    CROSS_ROWS rows for each step of rows 2-7 and CROSS_ROWS_8 for row 8:
    the crossover that sets fused_step.SPLIT_FROM and row 8's
    MANY_ROWS_FORM."""
    from jefferson_tpu_torch.kernels import fused_spatializer as fsp
    from jefferson_tpu_torch.kernels import fused_step

    geo = dict(pad_len=1024, bins=513, fpb=128)
    scene_of = {name: form for form, (name, _, _) in SCENE_FORMS.items()}
    stream_of = {name: form for form, name in FORMS.items()}
    forms = (fused_step.LAUNCH_B, fused_step.SPLIT)
    # behind a held stream, as phase geometry reads its rows (torch.profiler,
    # late in this process, drops most of its device events)
    alone = lambda call: queued_device_ms(call, reps=5)
    for name in [*fused_step.split_launches, SPATIALIZER]:
        took = {}
        for rows in (CROSS_ROWS_8 if name == SPATIALIZER else CROSS_ROWS):
            if name == SPATIALIZER:
                table, fwd, br, xf = bench.spatializer_step(db, rows, device)
                xd = fused_step._forward_reference(fwd[0][None], rows, *fwd[1:], None, None,
                                                   **geo)
                call = lambda f: fsp._cuda(device, rows, table, br, xf, *xd, None, form=f, **geo)
            else:
                if name in scene_of:
                    s_ = max(1, rows // 256)
                    form = scene_of[name]
                    groups = {"group_sources": 1 if s_ < 4 else 4} if form == "grouped" else {}
                    fn, args, kw = bench.scene_step(db, form, s_, rows // s_, device, **groups)
                else:
                    tb = min(GROUP_TB, rows)
                    gt = GROUP_TILES if rows >= GROUP_TB * GROUP_TILES else 1
                    fn, args, kw = bench.stream_step(db, stream_of[name], rows, device, tb=tb,
                                                     group_tiles=gt)
                call = lambda f: fused_step._cuda(fn, *args, form=f, **kw)
            took[rows] = {f: alone(lambda: call(f)) for f in forms}
        split_from = None
        for rows in sorted(took, reverse=True):
            if took[rows][fused_step.SPLIT] >= took[rows][fused_step.LAUNCH_B]:
                break
            split_from = rows
        picked = (f"SPLIT_FROM = {fused_step.SPLIT_FROM}" if name != SPATIALIZER
                  else f"MANY_ROWS_FORM = {fsp.MANY_ROWS_FORM!r}")
        say("bench", f"{name} crossover, device time alone (launch B / split form) at "
                     + ", ".join(f"{r}: {t[fused_step.LAUNCH_B]:.4f} / {t[fused_step.SPLIT]:.4f}"
                                 for r, t in took.items())
                     + f" ms; the split form takes less from {split_from} of these rows on "
                       f"({picked})  [{bench.card()}]")


def row8_crossover(bench, db, device, geo) -> None:
    """Row 8's three forms on the same operands at CROSSOVER_ROWS rows: CUDA
    events per call and device time alone; where the cluster form stops
    taking less than MANY_ROWS_FORM sets SMALL_ROWS."""
    from jefferson_tpu_torch.kernels import fused_spatializer as fsp
    from jefferson_tpu_torch.kernels import fused_step

    last_cluster = 0
    for rows in CROSSOVER_ROWS:
        table, fwd, br, xf = bench.spatializer_step(db, rows, device)
        xd = fused_step._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
        got = {}
        for form in (fsp.CLUSTER, fsp.LAUNCH_B, fsp.SPLIT):
            # the wrapper's private seam names the form; fused_apply picks it by rows
            call = lambda: fsp._cuda(device, rows, table, br, xf, *xd, None, form=form, **geo)
            got[form] = (bench.time_ms(call),
                         queued_device_ms(call, reps=5))
        if got[fsp.CLUSTER][1] < got[fsp.MANY_ROWS_FORM][1]:
            last_cluster = rows
        say("bench", f"row 8 forms at {rows} rows: " + ", ".join(
            f"{form} {ev:.4f} ms (device time alone {alone:.4f})"
            for form, (ev, alone) in got.items()) + f"  [{bench.card()}]")
    say("bench", f"row 8: the cluster form takes less device time than {fsp.MANY_ROWS_FORM} up "
                 f"to {last_cluster} rows of {CROSSOVER_ROWS}; SMALL_ROWS = {fsp.SMALL_ROWS}")


def prod_host_path(bench, device, args, lib_call) -> None:
    """Row 9's call on the host clock, per call, 200 calls queued without a
    sync: the wrapper; its ctypes entry alone on preallocated outputs; the
    same ctypes call with nothing to launch (n = 0: the argument
    conversions and the call); and ``lib_call``, one torch.mul of the same
    function.  Split: Python = wrapper - entry, ctypes = the empty call,
    the entry's launch path = entry - empty call."""
    import torch

    from jefferson_tpu_torch.kernels import assoc_probe

    out = [torch.empty_like(args[0]) for _ in range(2)]
    stream = torch.cuda.current_stream(device).cuda_stream
    lib, ptrs = assoc_probe._lib(), [t.data_ptr() for t in (*args, *out)]
    calls = {
        "wrapper": lambda: assoc_probe.prod(*args),
        "entry": lambda: lib.jt_prod(device.index, stream, *ptrs, args[0].numel()),
        "empty": lambda: lib.jt_prod(device.index, stream, *ptrs, 0),
        "torch.mul": lib_call,
    }
    host = {}
    for what in (*calls, *reversed(calls)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            calls[what]()
        host.setdefault(what, []).append((time.perf_counter() - t0) * 1e3 / 200)
        torch.cuda.synchronize()
    h = {what: min(t) for what, t in host.items()}
    say("bench", f"prod (row 9) host path per call, 200 calls queued: wrapper {h['wrapper']:.4f} "
                 f"ms = Python {h['wrapper'] - h['entry']:.4f} + ctypes {h['empty']:.4f} + the "
                 f"entry's launch path {h['entry'] - h['empty']:.4f}; torch.mul "
                 f"{h['torch.mul']:.4f} ms  [{bench.card()}]")


def sidepass_bench(bench, db, device, cfg, calls: int) -> None:
    """The sparse side-pass (engine/renderer._sparse_xfade_fix, plain torch)
    at a scene_hold chunk's shape: SIDE_S x SIDE_NB rows, SIDE_CF
    crossfading rows; its device time, kernels per call and bound, and its
    calls on the counted main path."""
    import numpy as np
    import torch

    from jefferson_tpu_torch.convert import spectra_from_numpy
    from jefferson_tpu_torch.engine.renderer import _sparse_xfade_fix, blend_cat, cat_table
    from jefferson_tpu_torch.ops.filters import distance_phase_split

    rng = np.random.default_rng(8)
    fpb, bins, q = cfg.frames_per_buffer, cfg.num_bins, cfg.pad_len // cfg.frames_per_buffer
    rows, ncf = SIDE_S * SIDE_NB, SIDE_CF
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    y = put((rng.standard_normal((rows, 2 * fpb)) * 0.1).astype(np.float32))
    subs = put((rng.standard_normal((SIDE_S * (SIDE_NB + q - 1), fpb)) * 0.2).astype(np.float32))
    cf = np.sort(rng.choice(rows, ncf, replace=False))
    xfade = np.zeros(rows, bool)
    xfade[cf] = True
    radii = rng.uniform(0.3, 2.0, rows).astype(np.float32) / np.float32(cfg.distance_scale)
    dist = [put(a) for a in distance_phase_split(cfg.fsvs, radii, bins)]
    g_old = blend_cat(cat_table(spectra_from_numpy(db.spectra, device)),
                      put(rng.integers(0, db.num_hrtf, (ncf, 4)).astype(np.int32)),
                      put(rng.random((ncf, 4)).astype(np.float32)))
    cf_t, xf_t = put(cf), put(xfade)
    call = lambda: _sparse_xfade_fix(y, subs, cf_t, g_old, xf_t, *dist, config=cfg,
                                     nb_seg=SIDE_NB)
    ev = bench.time_ms(call)
    prof = bench.device_profile(call, calls=10)
    alone, kernels = sum(row[1] for row in prof), sum(row[2] for row in prof)
    # the work of its ncf rows: sub-block DFTs, twiddle sum, distance ramp and
    # multiply, two ears' filter multiply and 513 x 128 tail, crossfade; it
    # reads their sub-blocks, old filters, ramps and new-side outputs and
    # writes their outputs
    flops = ncf * (q * fpb * bins * 4 + (q - 1) * bins * 8 + bins * 14
                   + 2 * (bins * 6 + bins * fpb * 4) + 2 * fpb * 3)
    moved = 4 * ncf * (q * fpb + 4 * bins + 3 + 2 * 2 * fpb) + ncf * (8 + 1)
    bound = bench.bound_ms(flops, moved)
    say("bench", f"sparse side-pass at {SIDE_S}x{SIDE_NB} rows, {ncf} crossfading: {ev:.4f} ms "
                 f"per call (device time alone {alone:.4f} ms), {kernels:g} kernels per call, "
                 f"bound {bound[0]:.5f} ms ({bound[1]}); {calls} calls on the counted path "
                 f"(sweep, scene_hold, scene_hold_512) = {calls * kernels:g} launches  "
                 f"[{bench.card()}]")


def profile(bench, what: str, fn, wall: float) -> None:
    """One call of ``fn`` under torch.profiler: device busy time against the
    wall time of an unprofiled call, and the largest kernels."""
    rows = bench.device_profile(fn)
    busy = sum(row[1] for row in rows)
    say("bench", f"{what} under torch.profiler: device busy {busy:.3f} ms of {wall * 1e3:.1f} ms "
                 f"wall (idle share {1 - busy / (wall * 1e3):.3f}); by kernel:")
    for kernel, ms, calls in rows[:12]:
        say("bench", f"  {ms:9.4f} ms  x{calls:g}  {kernel[:100]}")


def mesh_rank(out: str) -> int:
    """One rank of the mesh phase (``python chip_smoke.py --mesh-rank DIR``):
    DIR/spec.json names the world; the rank's records go to DIR/rank<r>.json.
    Rank 0 renders the unsharded references and holds every sharded render
    to them and to the oracles the phase saved in DIR/.."""
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.engine.batch import BatchRenderer
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.hrtf.kemar import synthetic_database
    from jefferson_tpu_torch.kernels import build
    from jefferson_tpu_torch.parallel import mesh as pm
    from jefferson_tpu_torch.parallel.record import digest, recorded

    out = Path(out)
    spec = json.loads((out / "spec.json").read_text())
    device = pm.ensure_world(spec["ranks"], device="cuda", backend=spec["backend"])
    rank = dist.get_rank()
    records = []
    # every rank loads the libraries at one moment: each that finds one
    # missing compiles it (its compilers at once), and all replace it atomically
    dist.barrier()
    t0 = time.perf_counter()
    libs = build.libraries(MESH_LIBS, [MAIN_GEOMETRY])
    missing = [name for name, geo in libs if not build.library_path(name, geometry=geo).exists()]
    build.build_all(MESH_LIBS, geometries=[MAIN_GEOMETRY])
    for name, geo in libs:
        build.load(name, geometry=geo)
    records.append({"render": "load", "rank": rank, "missing": missing,
                    "wall_s": time.perf_counter() - t0})
    db = synthetic_database()
    fpb = db.config.frames_per_buffer
    noise = (np.random.default_rng(0).standard_normal(SIGNAL_SAMPLES) * 0.2).astype(np.float32)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    def sharded(what, make, mesh, args, want, tol, oracle=None, srcs=()):
        """``make(mesh)`` renders ``args`` on the mesh's ranks, counted and
        timed from a start they share; rank 0 holds it to ``want`` and the
        oracle."""
        dist.barrier()  # every rank of the world, so no rank's wall holds another's work
        if mesh.get_coordinate() is None:
            return
        r = make(mesh)
        got, rec = recorded(lambda: r.render(*args), device)
        rec.update({"render": what, "mesh": mesh.size(),
                    "arms": sorted({tuple(a) for a in r.dispatch}), "chunks": len(r.dispatch),
                    "sha": digest(got), "finite": bool(np.isfinite(got).all())})
        if rank == 0:
            rec["max_abs"] = float(np.abs(got - want).max())
            rec["equal"] = bool(np.array_equal(got, want))
            rec["tol"] = tol
            if oracle is not None:
                d = [diff(got[i] if got.ndim == 3 else got, oracle[k]) for k, i in enumerate(srcs)]
                rec["oracle"] = [max(x[0] for x in d), max(x[1] for x in d)]
        records.append(rec)

    def reference(what, fn):
        got, wall = timed(fn)
        records.append({"render": what, "mesh": 0, "rank": rank, "wall_s": wall})
        return got

    def warm(names, orbit=None):
        """One chunk of each render unsharded on every rank first, so that
        no timed render pays a process's first use of its arms."""
        for name in names:
            pset, cb, opts, _, _ = scenes()[name]
            BatchRenderer(db, device=device, chunk_blocks=cb, **opts).render(
                scene_sigs[:, : cb * fpb], sets[pset][0][:, :cb])
        if orbit is not None:
            Renderer(db, device=device, chunk_blocks=STREAM_B, fused=False).render(
                noise, orbit[:STREAM_B])
        torch.cuda.synchronize()

    scene_sigs = bench.scene_signals(noise, SCENE_S, SCENE_B, fpb)
    sets = scene_positions(bench)
    if spec["mode"] == "scenes":
        meshes = [pm.make_mesh(n, device="cuda") for n in MESH_SIZES]
        mesh_blk = pm.make_mesh(MESH_BLK, ("blk",), device="cuda")
        orbit = renders(bench)["orbit"][0]
        warm(MESH_SCENES, orbit)
        for name in MESH_SCENES:
            pset, cb, opts, _, _ = scenes()[name]
            pos, srcs = sets[pset]
            make = lambda mix: (lambda m=None: BatchRenderer(db, device=device, chunk_blocks=cb,
                                                             mix=mix, mesh=m, **opts))
            want = want_mix = oracle = None
            if rank == 0:
                want = reference(f"{name}", lambda: make(False)().render(scene_sigs, pos))
                want_mix = reference(f"{name} mix", lambda: make(True)().render(scene_sigs, pos))
                oracle = np.load(out.parent / f"oracle_{pset}.npy", mmap_mode="r")
            for mesh in meshes:
                sharded(name, make(False), mesh, (scene_sigs, pos), want, MESH_ROW_TOL, oracle,
                        srcs)
                sharded(f"{name} mix", make(True), mesh, (scene_sigs, pos), want_mix,
                        MESH_MIX_TOL)
            del want, want_mix
        unfused = lambda m=None: Renderer(db, device=device, chunk_blocks=STREAM_B, fused=False,
                                          mesh=m)
        want = None
        if rank == 0:
            want = reference("orbit", lambda: unfused().render(noise, orbit))
        sharded("orbit", unfused, mesh_blk, (noise, orbit), want, MESH_ROW_TOL,
                np.load(out.parent / "oracle_orbit.npy", mmap_mode="r")[None], (0,))
    else:  # a one-rank NCCL world: the mesh of one equals no mesh, bit for bit
        pset, cb, opts, _, _ = scenes()["scene_hold"]
        pos, _ = sets[pset]
        mesh = pm.make_mesh(1, device="cuda")
        warm(["scene_hold"])
        for mix in (False, True):
            make = lambda m=None: BatchRenderer(db, device=device, chunk_blocks=cb, mix=mix,
                                                mesh=m, **opts)
            want = reference(f"scene_hold{' mix' if mix else ''}",
                             lambda: make().render(scene_sigs, pos))
            sharded(f"scene_hold{' mix' if mix else ''}", make, mesh, (scene_sigs, pos), want, 0.0)
    (out / f"rank{rank}.json").write_text(json.dumps(records))
    dist.destroy_process_group()
    return 0


def mesh_phase(bench, tmp, sets, oracles, orbit_oracle) -> dict | None:
    """Phase 14: the mesh paths in spawned ranks; their launches summed over
    the ranks, or None on a failure."""
    import contextlib
    import io
    import os
    from pathlib import Path

    import numpy as np

    from jefferson_tpu_torch import graft
    from jefferson_tpu_torch.kernels import build, fused_step
    from jefferson_tpu_torch.parallel import mesh as pm

    card = bench.card()
    work = Path(tmp) / "mesh"
    work.mkdir()
    for pset, (_, srcs) in sets.items():
        np.save(work / f"oracle_{pset}.npy", np.stack([oracles[pset][i].result() for i in srcs]))
    np.save(work / "oracle_orbit.npy", orbit_oracle)
    # the ranks build them, all at their first load
    for name, geo in build.libraries(MESH_LIBS, [MAIN_GEOMETRY]):
        build.library_path(name, geometry=geo).unlink()
    launches = dict.fromkeys(fused_step.launches, 0)
    launches[LAUNCH_A] = 0
    for mode, ranks, backend in (("scenes", MESH_RANKS, MESH_BACKEND), ("nccl", 1, "nccl")):
        say("mesh", f"{mode}: {ranks} rank(s) on cuda:0, backend {backend} (requested "
                    f"explicitly), torch.distributed")
        d = work / mode
        d.mkdir()
        (d / "spec.json").write_text(json.dumps({"mode": mode, "ranks": ranks,
                                                 "backend": backend}))
        port = pm.free_port()
        t0 = time.perf_counter()
        failed, outs = pm.spawn(
            [[sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(d)]] * ranks,
            [pm.rank_env(os.environ, r, ranks, port) for r in range(ranks)], MESH_TIMEOUT)
        if failed:
            for r, text in enumerate(outs):
                print(f"--- mesh rank {r} ---\n{text[-4000:]}", file=sys.stderr)
            return fail("mesh", f"{mode}: ranks failed: {failed}")
        say("mesh", f"{mode}: the ranks ran in {time.perf_counter() - t0:.1f} s")
        recs = [rec for r in range(ranks) for rec in json.loads((d / f"rank{r}.json").read_text())]
        for rec in recs:
            if rec["render"] == "load":
                say("mesh", f"rank {rec['rank']}: {len(rec['missing'])} of {len(MESH_LIBS)} "
                            f"libraries missing at its first load ({', '.join(rec['missing'])}), "
                            f"loaded in {rec['wall_s']:.1f} s")
        refs = {rec["render"]: rec["wall_s"] for rec in recs if rec.get("mesh") == 0}
        runs = {}
        for rec in recs:
            if rec.get("mesh"):
                runs.setdefault((rec["render"], rec["mesh"]), []).append(rec)
        for (what, n), group in runs.items():
            group.sort(key=lambda rec: rec["rank"])
            head = group[0]
            per_rank = "; ".join(
                f"rank {rec['rank']} {rec['wall_s']:.3f} s, launches {rec['launches']}, launch A "
                f"{rec['forward']}, collectives {rec['collectives']}" for rec in group)
            check = (f"vs unsharded max|diff| {head['max_abs']:.3e} (limit {head['tol']:.0e}), "
                     f"torch.equal: {head['equal']}")
            if "oracle" in head:
                check += f"; vs render_oracle max|diff| {head['oracle'][0]:.3e}, rms " \
                         f"{head['oracle'][1]:.3e}"
            say("mesh", f"{what} on {n} rank(s): arms {head['arms']} per shard, {head['chunks']} "
                        f"chunks; {check}; walls: {per_rank}; unsharded {refs[what]:.3f} s  "
                        f"[{card}]")
            mix = what.endswith("mix")
            want_counts = {"mix_all_reduce": head["chunks"] if mix else 0,
                           "gather_rows": 0 if mix else head["chunks"]}
            if len({rec["sha"] for rec in group}) != 1 or not head["finite"]:
                return fail("mesh", f"{what} on {n}: the ranks' results differ or are not finite")
            if not head["max_abs"] <= head["tol"] or (mode == "nccl" and not head["equal"]):
                return fail("mesh", f"{what} on {n}: the sharded render disagrees with the "
                                    f"unsharded one")
            if "oracle" in head and not (head["oracle"][0] <= ORACLE_TOL
                                         and head["oracle"][1] < ORACLE_RMS):
                return fail("mesh", f"{what} on {n}: the port disagrees with the oracle")
            if any(rec["collectives"] != want_counts for rec in group):
                return fail("mesh", f"{what} on {n}: collectives, want {want_counts} on each rank")
            unfused = all(arm in ("dedup", "plain") for arm, _, _ in head["arms"])
            for rec in group:
                steps = sum(v for k, v in rec["launches"].items() if k != "dma_blend")
                if steps != (0 if unfused else rec["chunks"]):
                    return fail("mesh", f"{what} on {n}: rank {rec['rank']} launched "
                                        f"{rec['launches']}, want a step a chunk")
                for k, v in rec["launches"].items():
                    launches[k] += v
                launches[LAUNCH_A] += rec["forward"]
    left = sorted(p.name for p in build.BUILD_DIR.glob("*.tmp*"))
    built = [build.library_path(name, geometry=geo).exists()
             for name, geo in build.libraries(MESH_LIBS, [MAIN_GEOMETRY])]
    say("mesh", f"the ranks' builds: libraries {dict(zip(MESH_LIBS, built))}, temporaries left "
                f"{left}")
    if not all(built) or left:
        return fail("mesh", "the ranks' concurrent builds left no library or a temporary")
    t0 = time.perf_counter()
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            graft.dryrun_multichip(MESH_RANKS, device="cuda", backend=MESH_BACKEND,
                                   timeout=MESH_TIMEOUT)
    except RuntimeError as e:
        print(text.getvalue(), file=sys.stderr)
        return fail("mesh", f"graft.dryrun_multichip: {e}")
    for line in text.getvalue().splitlines():
        if line.strip():
            say("mesh", line)
    say("mesh", f"graft.dryrun_multichip({MESH_RANKS}, device='cuda', backend="
                f"'{MESH_BACKEND}') in {time.perf_counter() - t0:.1f} s")
    return launches


# ---- phase 13: the geometry phase ------------------------------------------

GEO_SAMPLES = 1607168            # the 12,556-block render at fpb 128
# name: (fpb, HRIR taps): callbacks of 64-1024 samples over the 512-tap set,
# 64-sample blocks over a 256-tap set, and 10 ms blocks (441: a history of
# partial blocks) beside 100; low-latency blocks of 16 and 4 samples (Q 64
# and 256 at pad 1024: launch A's ring form), offline blocks of 2,048
# (pad 4096) and a 2,048-tap SOFA set at the default block (pad 4096, Q 32)
GEOMETRIES = {
    "f64": (64, 512), "f256": (256, 512), "f512": (512, 512), "f1024": (1024, 512),
    "f64t256": (64, 256), "f100": (100, 512), "f441": (441, 512),
    "f16": (16, 512), "f4": (4, 512), "f2048": (2048, 512), "f128t2048": (128, 2048),
}
# the geometries whose renders take a 2-s input (f4: 22,050 blocks) and
# whose live session plays GEO_LIVE_SHORT_S seconds, not GEO_LIVE_S: their
# blocks are many
GEO_SHORT = {"f16": 88200, "f4": 88200}
GEO_LIVE_SHORT_S = {"f16": 2.0, "f4": 0.5}
# the live gate holds from fpb 32 up; below it the host path alone (0.17-
# 0.40 ms a block, PERF.md section 7) exceeds the block (0.363 ms at fpb 16,
# 0.091 at 4): those blocks are timed against their deadline, not gated
GEO_LIVE_GATE_FPB = 32
GEO_SCENES = ("f64", "f256", "f64t256")   # the scene renders, 16 sources
GEO_SCENE_SRCS = (0, 7)                   # the scene sources held to the oracle
GEO_SCENE_TOL = 5e-7                      # each scene source against the unfused card render
GEO_LIVE_S = 10.0                         # seconds of the live helix
GEO_HELD = 200                            # then held blocks
# the one geometry left that the card refuses, and its resource: launch B's
# t-tiles (fpb / 128) past the 65,535 CTAs a grid's y holds
GEO_EDGES = ((1 << 24, 512),)
# the arms the JAX dispatch takes on every chunk of each render (the CPU
# test tests/test_torch_geometry.py pins the port's and the JAX package's
# full-size dispatch to these): the sweep, the orbit, the helix and a
# source at a new random position every block
_DEDUP = ("dedup_fused", True, None)
_GATHER = ("gather_fused", True, None)
_ONEHOT = ("onehot", True, None)
GEO_ARMS = {
    "f64": {"sweep": ("dedup_fused", False, 8), "orbit": _DEDUP, "helix": _ONEHOT,
            "wide": _GATHER},
    "f256": {"sweep": ("dedup_fused", False, 32), "orbit": _DEDUP, "helix": _ONEHOT,
             "wide": _GATHER},
    "f512": {"sweep": ("dedup_fused", False, 8), "orbit": _ONEHOT, "helix": _ONEHOT,
             "wide": _GATHER},
    "f1024": {"sweep": ("dedup_fused", False, 16), "orbit": _ONEHOT, "helix": _ONEHOT,
              "wide": _GATHER},
    "f64t256": {"sweep": ("dedup_fused", False, 8), "orbit": _DEDUP, "helix": _ONEHOT,
                "wide": _GATHER},
    "f100": {"sweep": _DEDUP, "orbit": _DEDUP, "helix": _GATHER, "wide": _GATHER},
    "f441": {"sweep": _DEDUP, "orbit": _DEDUP, "helix": _GATHER, "wide": _GATHER},
    "f16": {"sweep": ("dedup_fused", False, 8), "orbit": _DEDUP, "helix": _DEDUP,
            "wide": _GATHER},
    "f4": {"sweep": ("dedup_fused", False, 8), "orbit": ("dedup_fused", False, 256),
           "helix": ("dedup_fused", False, 256), "wide": _GATHER},
    "f2048": {"sweep": ("dedup_fused", False, 32), "orbit": _ONEHOT, "helix": _ONEHOT,
              "wide": _GATHER},
    "f128t2048": {"sweep": ("dedup_fused", False, 16), "orbit": _DEDUP, "helix": _ONEHOT,
                  "wide": _GATHER},
}
GEO_SCENE_ARMS = {
    "f64": {"scene_hold": ("dedup_fused", False, 16),
            "scene_movers": ("onehot_grouped", True, None)},
    "f256": {"scene_hold": ("dedup_fused", False, 64),
             "scene_movers": ("onehot_grouped", True, None)},
    "f64t256": {"scene_hold": ("dedup_fused", False, 16),
                "scene_movers": ("onehot_grouped", True, None)},
}


def geometry_config(name: str):
    from jefferson_tpu_torch.config import EngineConfig

    fpb, taps = GEOMETRIES[name]
    return EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)


def geometry_name(cfg) -> str:
    return next(k for k, v in GEOMETRIES.items() if v == (cfg.frames_per_buffer, cfg.hrtf_len))


def geometry_samples(cfg) -> int:
    """The samples of a geometry's renders: GEO_SAMPLES, or its short input."""
    return GEO_SHORT.get(geometry_name(cfg), GEO_SAMPLES)


def geometry_renders(bench, cfg) -> dict:
    """A geometry's single-source renders of GEO_SAMPLES samples: name ->
    (positions, chunk_blocks).  A render of fewer than 4,096 blocks takes
    chunks of 256 (the default 2,048 would leave it one untiled chunk)."""
    from jefferson_tpu_torch.trajectory.trajectory import AzimuthSweep, CircularOrbit

    fpb = cfg.frames_per_buffer
    n = geometry_samples(cfg) // fpb
    cb = 2048 if n > 4096 else 256
    # the reference sweep's cadence: a 5-degree step every 22,016 samples
    sweep = AzimuthSweep(start_azi=3.0, ele=5.0, r=0.5, blocks_per_step=round(22016 / fpb),
                         num_steps=72)
    return {
        "sweep": (sweep.sample(n, cfg), cb),
        "orbit": (CircularOrbit(period_s=0.4, ele=5, r=1.0).sample(n, cfg), cb),
        "helix": (bench.helix_positions(n, cfg=cfg), cb),
        "wide": (bench.wide_positions(1, n)[0], cb),
    }


def geometry_scenes(bench, cfg) -> dict:
    """A geometry's 16-source scenes of GEO_SAMPLES samples a source."""
    fpb = cfg.frames_per_buffer
    n = GEO_SAMPLES // fpb
    return {"scene_hold": bench.scene_hold_positions(SCENE_S, n, round(22016 / fpb)),
            "scene_movers": bench.scene_mover_positions(SCENE_S, n)}


def geometry_live(bench, cfg):
    """The live session's positions: GEO_LIVE_S seconds of the helix (or the
    geometry's GEO_LIVE_SHORT_S), then GEO_HELD blocks held at its last
    position."""
    import numpy as np

    seconds = GEO_LIVE_SHORT_S.get(geometry_name(cfg), GEO_LIVE_S)
    n = round(seconds * cfg.sample_rate / cfg.frames_per_buffer)
    helix = bench.helix_positions(n, cfg=cfg)
    return np.concatenate([helix, np.repeat(helix[-1:], GEO_HELD, axis=0)])


_geo_dbs = {}


def _geo_db(fpb: int, taps: int):
    from jefferson_tpu_torch.config import EngineConfig
    from jefferson_tpu_torch.hrtf.kemar import synthetic_database

    if (fpb, taps) not in _geo_dbs:
        _geo_dbs[fpb, taps] = synthetic_database(EngineConfig(frames_per_buffer=fpb,
                                                              hrtf_len=taps))
    return _geo_dbs[fpb, taps]


def _geo_oracle_job(fpb, taps, signal, positions):
    """render_oracle from old = (0, 0) on the synthetic database of (fpb,
    taps), made once a worker."""
    from jefferson_tpu_torch.oracle.reference import render_oracle

    db = _geo_db(fpb, taps)
    return render_oracle(signal, db, [tuple(p) for p in positions], db.config,
                         initial_old=(0.0, 0.0))


def geometry_oracles(bench, pool, noise, scene_sigs_of) -> dict:
    """Every oracle render of the geometry phase, submitted to the worker
    pool: {(geometry, what): future}, ``what`` a render's name, a scene's
    (name, source) or "live"."""
    futures = {}
    for name, (fpb, taps) in GEOMETRIES.items():
        cfg = geometry_config(name)
        for what, (pos, _) in geometry_renders(bench, cfg).items():
            futures[name, what] = pool.submit(_geo_oracle_job, fpb, taps, noise, pos)
        futures[name, "live"] = pool.submit(_geo_oracle_job, fpb, taps, noise,
                                            geometry_live(bench, cfg))
        if name in GEO_SCENES:
            sigs = scene_sigs_of(cfg)
            for scene, pos in geometry_scenes(bench, cfg).items():
                for i in GEO_SCENE_SRCS:
                    futures[name, (scene, i)] = pool.submit(_geo_oracle_job, fpb, taps, sigs[i],
                                                            pos[i])
    return futures


def geometry_build_start() -> dict:
    """Start the geometry phase's builds in a process of their own (one nvcc
    a library, all at once), so they run while the 128/1024 phases do:
    {"proc", "t0": its start, "out": None until geometry_build_finish}."""
    import subprocess
    from pathlib import Path

    geos = [(c.frames_per_buffer, c.pad_len) for c in map(geometry_config, GEOMETRIES)]
    code = ("from jefferson_tpu_torch.kernels import build; "
            f"build.build_all(build.GEOMETRIC, geometries={geos!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=Path(__file__).resolve().parent)
    return {"proc": proc, "t0": time.perf_counter(), "out": None}


def geometry_build_finish(build: dict) -> float:
    """Wait for geometry_build_start's process and keep its output (once;
    again returns at once) -> the seconds waited."""
    t0 = time.perf_counter()
    if build["out"] is None:
        build["out"], _ = build["proc"].communicate()
        build["done"] = time.perf_counter()
    return time.perf_counter() - t0


def _counts():
    """Every launch count of the kernels and their forms, nonzero only."""
    from jefferson_tpu_torch.kernels import fused_step as fs

    out = {}
    for what, counts in (("kernel", fs.launches), ("split", fs.split_launches),
                         ("row 1", fs.row1_forms), ("row 8", fs.spatializer_forms),
                         ("launch A", fs.forward_launches), ("row 12", fs.blend_forms)):
        nz = {k: v for k, v in counts.items() if v}
        if nz:
            out[what] = nz
    return out


# the geometries whose split form phase geometry also times beside launch B
# at rows 5-8's main shapes, with the crossover counts that set a pick there
# (and, where launch B's tile fits a block below T_TILE columns, every
# kernel of rows 2-8)
SPLIT_TIMED = ("f2048", "f128t2048", "f441", "f1024", "f512", "f256")
SPLIT_ROWS = ("fused_step_stream_xfade", "fused_step_xfade", "fused_apply_xfade", SPATIALIZER)
# the split form's libraries, kinds of row and sides whose occupancy phase
# geometry prints (fused_step.split_occupancy)
SPLIT_OCCUPANCY = (("fused_step_onehot", "blended", 2), ("fused_step_gather", "pre-blended", 2),
                   ("fused_step_gather", "pre-blended", 1))
# the geometries at which phase geometry also times rows 5-8's tail product
# alone as one torch.matmul (scripts/tail_times.tail_product_ms), the
# library yardstick of launch B
LIBRARY_TIMED = ("f512", "f1024", "f2048", "f128t2048")


def split_cross(fpb, pad, kernel) -> tuple:
    """The counts that set ``kernel``'s pick at (fpb, pad): the ends of its
    kind's span in fused_step.LAUNCH_B_SPANS, or none."""
    from jefferson_tpu_torch.kernels import fused_step as fs

    kind = ("row 8" if kernel == SPATIALIZER else "blended" if kernel in fs.BLENDED
            else "pre-blended" if kernel in fs.PRE_BLENDED else None)
    span = fs.LAUNCH_B_SPANS.get((fpb, pad), {}).get(kind)
    return tuple(sorted(set(span))) if span else ()


def split_timing(name, db, forms) -> dict | None:
    """Rows 5-8's split form at geometry ``name`` (a history of partial
    blocks: rows 7 and 8), and every kernel of rows 2-8 where launch B's
    tile fits a block below 128 columns, in the layout the wrappers take,
    torch.equal to launch B and timed beside it, the twin and the bound,
    with both forms at the counts that set its pick
    (split_layouts.measure) -> its numbers, or None on a failure."""
    from jefferson_tpu_torch.kernels import fused_step as fs
    from jefferson_tpu_torch.scripts import split_layouts

    got = {"kernels": {}}
    for k in SPLIT_ROWS if forms.tile_cols == fs.T_TILE else split_layouts.MAIN_ROWS:
        if forms.q or k in ("fused_apply_xfade", SPATIALIZER):
            cross = split_cross(forms.fpb, forms.pad, k)
            got["kernels"].update(split_layouts.measure(name, kernels=[k], cross=cross,
                                                        db=db)["kernels"])
    bad = [k for k, v in got["kernels"].items() if not v["equal"]]
    if bad:
        fail("geometry", f"{name}: the split form of {bad} is not launch B's bits")
        return None
    return got


def queued_device_ms(call, reps: int = 10) -> float:
    """Device ms per call of ``call()`` with no host time in it: the stream
    is held by a spin kernel while ``reps`` calls queue behind it, then
    CUDA events time them running back to back (torch.profiler, late in
    this process, drops most of its device events)."""
    import torch

    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # about 25 ms of spinning: far longer than the host takes to queue ten
    # calls (well under 1 ms), and short enough to read hundreds of shapes
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def geometry_kernels(bench, db, device, name, forms, errs, times) -> bool:
    """Every kernel form the geometry's library has, against its twin on
    the card (KERNEL_TOL, row 8 ROW8_TOL; launch A at FWD_REL of the XD peak),
    the forms of a step torch.equal to each other, at the render
    shapes; then each kernel timed at one shape (events, device time alone,
    twin) beside its bound.  ``errs``/``times``: kernel -> value, filled."""
    import torch

    from jefferson_tpu_torch.engine import stream as stream_mod
    from jefferson_tpu_torch.kernels import fused_apply as fa
    from jefferson_tpu_torch.kernels import fused_spatializer as fsp
    from jefferson_tpu_torch.kernels import fused_step as fs

    cfg = db.config
    fpb, bins, pad = cfg.frames_per_buffer, cfg.num_bins, cfg.pad_len
    geo = dict(pad_len=pad, bins=bins, fpb=fpb)
    q = forms.q
    twin = lambda fn: getattr(sys.modules[fn.__module__], fn.__name__ + "_reference")
    tail_forms = [fs.LAUNCH_B] + ([fs.SPLIT] if forms.split else [])
    # kernel -> (call of the picked form, twin call, flops, bytes or None for
    # its operands' and output's, its shape, its (args, kwargs), launch A
    # alone on its operands or None)
    timed = {}

    def hold(kernel, what, got_by_form, want, rows):
        errs_k = {f: float((g - want).abs().max()) for f, g in got_by_form.items()}
        finite = all(bool(torch.isfinite(g).all()) for g in got_by_form.values())
        # the forms on the same XD planes (not row 8's forward form: its own)
        same = [torch.equal(g, next(iter(got_by_form.values())))
                for f, g in got_by_form.items() if not f.startswith("forward")]
        tol = ROW8_TOL if kernel == SPATIALIZER else KERNEL_TOL
        say("geometry", f"{name} {kernel} {what}: max|kernel - twin| by form "
                        f"{ {f: f'{e:.3e}' for f, e in errs_k.items()} } (limit {tol:.0e}); "
                        f"the forms on one XD torch.equal: {all(same)}")
        errs[kernel] = max(errs.get(kernel, 0.0), *errs_k.values())
        ok = finite and all(same) and max(errs_k.values()) <= tol
        ok = ok and all(g.shape == (rows, 2 * fpb) for g in got_by_form.values())
        if not ok:
            fail("geometry", f"{name} {kernel} {what}: a form disagrees with its twin")
        return ok

    def step(fn, args, kw, kernel, what, rows, names):
        got = {f: fs._cuda(fn, *args, form=f, **kw) for f in names}
        torch.cuda.synchronize()
        return hold(kernel, what, got, twin(fn)(*args, **kw), rows)

    if q:
        # launch A: every form the library has, at the scene step's shape
        # (per-row distance, and 8 triples) and the live block's
        fwd_forms = ([fs.FWD_TILE] if forms.tile else []) + (
            [fs.FWD_PRODUCT] if forms.product else []) + [fs.FWD_PLANES] + (
            [fs.FWD_RING] if forms.ring else [])
        shapes = ((16, 256, None), (16, 256, 8), (1, 1, None)) + (
            ((16, 64, None), (1, 2048, None)) if forms.ring else ())
        for s_, nb, nd in shapes:
            ops = bench.forward_operands(s_, nb, device, n_dist=nd, config=cfg)
            names = fwd_forms + ([fs.FWD_FEW] if nb <= forms.few_nb else [])
            got = {f: fs._forward_cuda(*ops, form=f, **geo) for f in names}
            torch.cuda.synchronize()
            want = fs._forward_reference(*ops, **geo)
            peak = max(float(w.abs().max()) for w in want)
            rel = {f: max(float((g - w).abs().max()) for g, w in zip(xd, want)) / peak
                   for f, xd in got.items()}
            same = all(all(torch.equal(a, b) for a, b in zip(xd, got[fs.FWD_PLANES]))
                       for xd in got.values())
            picked = fs.forward_form(nb, fpb, pad, s_)
            say("geometry", f"{name} launch A {s_}x{nb} ({'per-row' if nd is None else nd} "
                            f"distance): max|XD - twin| / peak by form "
                            f"{ {f: f'{r:.3e}' for f, r in rel.items()} } (limit {FWD_REL:.0e}), "
                            f"the forms torch.equal: {same}; the steps take {picked}")
            errs[LAUNCH_A] = max(errs.get(LAUNCH_A, 0.0), *rel.values())
            if max(rel.values()) > FWD_REL or picked not in got or not same:
                return not fail("geometry", f"{name} launch A {s_}x{nb}: a form disagrees")
            if (s_, nb, nd) == (16, 256, None):
                timed[LAUNCH_A] = (
                    lambda ops=ops, f=picked: fs._forward_cuda(*ops, form=f, **geo),
                    lambda ops=ops: fs._forward_reference(*ops, **geo),
                    bench.forward_flops(s_, nb, fpb, bins, q),
                    bench.forward_bytes(s_, nb, fpb, bins, q), f"{s_}x{nb}, {picked}", None, None)
        # row 1 at 16 sources x 64 blocks (compact distance), launch B
        wl = bench.build_workload(db, SCENE_S, 64, device)
        args, kw = bench.step_operands(wl, cfg)
        fn = fs.fused_step_onehot_xfade
        names = [fs.LAUNCH_B] + ([fs.STAGED] if forms.staged else [])
        if not step(fn, args, kw, "fused_step_onehot_xfade", f"{SCENE_S}x64", SCENE_S * 64, names):
            return False
        timed["fused_step_onehot_xfade"] = (
            lambda fn=fn, a=args, k=kw: fn(*a, **k),
            lambda fn=fn, a=args, k=kw: twin(fn)(*a, **k),
            bench.step_flops("fused_step_onehot_xfade", SCENE_S, 64, fpb, bins, q), None,
            f"{SCENE_S}x64, {fs.pick_form(fs.ROW1, SCENE_S * 64, fpb, pad)}", (args, kw),
            launch_a_call(args, kw, SCENE_S * 64, geo))
        # rows 3-5 at the Renderer's chunk of 2,048 blocks
        for form, kernel in FORMS.items():
            fn, args, kw = bench.stream_step(db, form, STREAM_B, device, tb=GROUP_TB,
                                             group_tiles=GROUP_TILES, xf_every=7)
            if not step(fn, args, kw, kernel, f"B={STREAM_B}", STREAM_B, tail_forms):
                return False
            if form == "gather":
                timed[kernel] = (lambda fn=fn, a=args, k=kw: fn(*a, **k),
                                 lambda fn=fn, a=args, k=kw: twin(fn)(*a, **k),
                                 bench.step_flops(kernel, 1, STREAM_B, fpb, bins, q), None,
                                 f"1x{STREAM_B}, {fs.pick_form(kernel, STREAM_B, fpb, pad)}",
                                 (args, kw), launch_a_call(args, kw, STREAM_B, geo))
    # rows 2, 6 and 7 at the scene path's shapes (row 7 alone at a history
    # of partial blocks)
    for form, (kernel, s_, nb) in SCENE_FORMS.items():
        if not q and not form.startswith("apply"):
            continue
        fn, args, kw = bench.scene_step(db, form, s_, nb, device, xf_every=7)
        if not step(fn, args, kw, kernel, f"{s_}x{nb}", s_ * nb, tail_forms):
            return False
        if form in ("gather", "apply"):
            timed[kernel] = (lambda fn=fn, a=args, k=kw: fn(*a, **k),
                             lambda fn=fn, a=args, k=kw: twin(fn)(*a, **k),
                             bench.step_flops(kernel, s_, nb, fpb, bins, max(q, 1)), None,
                             f"{s_}x{nb}, {fs.pick_form(kernel, s_ * nb, fpb, pad)}", (args, kw),
                             launch_a_call(args, kw, s_ * nb, geo) if form == "gather" else None)
    # row 8: its apply-only entry at the live block's row and 4,096 rows, in
    # every form the library has, and its forward form (whole blocks)
    row8_forms = tail_forms + ([fsp.CLUSTER] if forms.cluster else [])
    for rows in (1, 4096):
        table, fwd, br, xf = bench.spatializer_step(db, rows, device)
        if q:
            xd = fs._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
        else:
            xd = stream_mod._window_xd(fwd[0].unfold(0, pad, fpb), *fwd[1:], cfg)
        got = {f: fsp._cuda(device, rows, table, br, xf, *xd, None, form=f, **geo)
               for f in row8_forms}
        if q:
            got["forward, " + fsp.pick_form(rows, fpb, pad)] = fsp.fused_forward_apply(
                table, *fwd, *br, xf, **geo)
        torch.cuda.synchronize()
        want = fsp.fused_apply_reference(table, *xd, *br, xf, bins=bins, fpb=fpb)
        if not hold(SPATIALIZER, f"{rows} row(s)", got, want, rows):
            return False
        if rows == 4096:
            timed[SPATIALIZER] = (
                lambda a=(table, *xd, *br, xf): fsp.fused_apply(*a, bins=bins, fpb=fpb),
                lambda a=(table, *xd, *br, xf): fsp.fused_apply_reference(*a, bins=bins, fpb=fpb),
                bench.step_flops(SPATIALIZER, 1, rows, fpb, bins), None,
                f"1x{rows}, {fsp.pick_form(rows, fpb, pad)}", ((table, *xd, *br, xf), {}), None)
    ring_vs_planes = (ring_times(bench, device, cfg, name)
                      if fs.forward_form(256, fpb, pad, 16) == fs.FWD_RING else None)
    # each kernel at its shape: events, device time alone (rows 1, 5 and 6
    # also launch A's alone, so launch B's apart), twin, bound
    for kernel, (call, plain, flops, moved, shape, ops, fwd) in timed.items():
        ms = bench.time_ms(call, reps=10, rounds=5)
        plain_ms = bench.time_ms(plain, reps=2, rounds=3, warmup=1)
        alone = queued_device_ms(call)
        apart = {}
        if fwd is not None:
            a_ms = queued_device_ms(fwd)
            apart = {"launch_a_ms": a_ms, "launch_b_ms": alone - a_ms}
        if moved is None:
            args, kw = ops
            moved = nbytes(*args, *kw.values(), call())
            if kernel == SPATIALIZER:  # of the full table, the rows its brackets name
                table = args[0]
                ids = torch.cat([a for a in args if a.dtype == torch.int32]).unique()
                moved += (ids.numel() - table.shape[0]) * table.shape[1] * table.element_size()
        bound, by = bench.bound_ms(flops, moved)
        times[kernel] = {"shape": shape, "ms": ms, "device_ms": alone, **apart,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        parts = (f"; launch A {apart['launch_a_ms']:.4f}, launch B {apart['launch_b_ms']:.4f}"
                 if apart else "")
        if name in LIBRARY_TIMED and kernel in SPLIT_ROWS:
            from jefferson_tpu_torch.scripts import tail_times

            s_, nb = shape.split(",")[0].split("x")
            rows = int(s_) * int(nb)
            lib_ms = tail_times.tail_product_ms(rows, 2, bins, fpb, device, queued_device_ms)
            times[kernel]["library_ms"] = lib_ms
            parts += (f"; the tail product alone (no q build, blend or epilogue) as one "
                      f"torch.matmul, fp32, TF32 off, {4 * rows}x{2 * bins} by {2 * bins}x{fpb}: "
                      f"{lib_ms:.4f} ms alone")
        say("geometry", f"{name} {kernel} ({shape}): kernel {ms:.4f} ms (device time alone "
                        f"{alone:.4f} ms, queued behind a held stream{parts}), twin "
                        f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by})  [{bench.card()}]")
    if q and LAUNCH_A in times:
        say("geometry", f"{name} {LAUNCH_A} (16x256): issue floor "
                        f"{bench.forward_issue_ms(16, 256, bins, q):.4f} ms (the twiddle sums' "
                        f"8 (Q - 1) unfused operations an output and bin, one instruction each), "
                        f"bound {times[LAUNCH_A]['bound_ms']:.4f} ms  [{bench.card()}]")
        if ring_vs_planes:
            times[LAUNCH_A]["ring_vs_planes"] = ring_vs_planes
    return True


# launch A's shapes where its ring form is timed beside the planes form:
# the scene step's, row 1's, row 5's and the live block
RING_TIMED = ((16, 256), (16, 64), (1, 2048), (1, 1))


def ring_times(bench, device, cfg, name) -> dict:
    """Launch A's ring form and planes form, device time alone (queued
    behind a held stream) in turns (planes, ring, ring, planes), and the
    planes form's two launches apart (its sub-block DFTs; its twiddle sums
    from them), at RING_TIMED, printed beside the table's bound and the
    issue floor -> {shape: the readings, ms}."""
    import torch

    from jefferson_tpu_torch.kernels import fused_step as fs

    fpb, pad, bins = cfg.frames_per_buffer, cfg.pad_len, cfg.num_bins
    q = pad // fpb
    geo = dict(pad_len=pad, bins=bins, fpb=fpb)
    out = {}
    for s_, nb in RING_TIMED:
        ops = bench.forward_operands(s_, nb, device, seed=7, config=cfg)
        scratch = tuple(torch.empty((s_ * (nb + q - 1), bins), device=device) for _ in range(2))
        calls = {
            "planes": lambda: fs._forward_cuda(*ops, form=fs.FWD_PLANES, **geo),
            "ring": lambda: fs._forward_cuda(*ops, form=fs.FWD_RING, **geo),
            "planes_dft": lambda: fs._forward_cuda(*ops, form=fs.FWD_PLANES, part=fs.PLANES_DFT,
                                                   scratch=scratch, **geo),
            "planes_sum": lambda: fs._forward_cuda(*ops, form=fs.FWD_PLANES, part=fs.PLANES_SUM,
                                                   scratch=scratch, **geo),
        }
        got = {}
        for form in ("planes", "ring", "ring", "planes", "planes_dft", "planes_sum"):
            got.setdefault(form, []).append(queued_device_ms(calls[form]))
        bound = bench.bound_ms(bench.forward_flops(s_, nb, fpb, bins, q),
                               bench.forward_bytes(s_, nb, fpb, bins, q))
        floor = bench.forward_issue_ms(s_, nb, bins, q)
        out[f"{s_}x{nb}"] = {f"{f}_ms": v for f, v in got.items()}
        say("geometry", f"{name} launch A {s_}x{nb}, device time alone: ring form "
                        f"{got['ring'][0]:.4f}/{got['ring'][1]:.4f} ms, planes form "
                        f"{got['planes'][0]:.4f}/{got['planes'][1]:.4f} (its sub-block DFTs "
                        f"{got['planes_dft'][0]:.4f}, its twiddle sums {got['planes_sum'][0]:.4f}); "
                        f"bound {bound[0]:.4f} ms ({bound[1]}, fp32 operations at the FMA rate), "
                        f"issue floor {floor:.4f} ms (the twiddle sums' 8 (Q - 1) unfused "
                        f"operations an output and bin, one instruction each)  [{bench.card()}]")
    return out


def geometry_phase(bench, device, noise, oracles, build_proc) -> dict | None:
    """Phase 13 (module docstring): every named geometry through the card's
    kernels -> {geometry: {"launches": kernel -> count, "errs": ..., "times":
    ...}}, or None on a failure."""
    import numpy as np
    import torch

    from jefferson_tpu_torch.engine.batch import BatchRenderer
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.engine.stream import SCAN_CHUNK, StreamingSpatializer, render_scan
    from jefferson_tpu_torch.kernels import build
    from jefferson_tpu_torch.kernels import fused_spatializer as fsp
    from jefferson_tpu_torch.kernels import fused_step as fs

    t_phase = time.perf_counter()
    waited = geometry_build_finish(build_proc)
    proc = build_proc["proc"]
    if proc.returncode:
        print(build_proc["out"], file=sys.stderr)
        return fail("geometry", f"the geometry builds exited {proc.returncode}")
    say("geometry", f"built {len(GEOMETRIES) * len(build.GEOMETRIC)} libraries (one nvcc each, "
                    f"all at once, started after the live path) in "
                    f"{build_proc['done'] - build_proc['t0']:.1f} s; the phase waited "
                    f"{waited:.1f} s for them")
    results = {}
    card = bench.card()
    for name, (fpb, taps) in GEOMETRIES.items():
        t_geo = time.perf_counter()
        db = _geo_db(fpb, taps)
        cfg = db.config
        pad = cfg.pad_len
        forms = fs.geometry_forms(fpb, pad)
        for lib in build.GEOMETRIC:
            path = build.library_path(lib, geometry=(fpb, pad))
            own = fs.library_geometry(lib, fpb, pad)
            say("geometry", f"{name}: fpb {fpb}, {taps} taps, pad {pad}, {cfg.num_bins} bins, "
                            f"history {cfg.history_len}, Q {forms.q or 'n/a'}: {path.name} built "
                            f"{path.exists()}, its forms {own}")
            if own != forms:
                return fail("geometry", f"{name}: {lib} reports {own}, geometry_forms says "
                                        f"{forms}")
        if forms.split:
            for lib, kind, sides in SPLIT_OCCUPANCY:
                occ = fs.split_occupancy(lib, fpb, pad, sides)
                say("geometry", f"{name} split form, {kind} rows, {sides} side(s): the "
                                f"{occ['layout']} layout, {occ['threads']} threads and "
                                f"{occ['smem']} bytes of shared memory a CTA, "
                                f"{occ['ctas_per_sm']} CTA(s) an SM; "
                                f"cudaOccupancyMaxActiveClusters {occ['clusters']} clusters of "
                                f"{occ['ranks']} on {occ['sms']} of the card's "
                                f"{torch.cuda.get_device_properties(device).multi_processor_count}"
                                f" SMs  [{card}]")
        launched, split_launched = {}, {}

        def count_split(by_form):
            """The launches of rows 2-8 that took the split form."""
            for k, v in [*by_form.get("split", {}).items(),
                         (SPATIALIZER, by_form.get("row 8", {}).get("split", 0))]:
                if v:
                    split_launched[k] = split_launched.get(k, 0) + v

        # ---- renders ----
        for what, (pos, cb) in geometry_renders(bench, cfg).items():
            r = Renderer(db, device=device, chunk_blocks=cb)
            fs.reset_launches()
            t0 = time.perf_counter()
            got = r.render(noise, pos)
            wall = time.perf_counter() - t0
            by_form = _counts()
            count_split(by_form)
            for k, v in by_form.get("kernel", {}).items():
                launched[k] = launched.get(k, 0) + v
            launched[LAUNCH_A] = launched.get(LAUNCH_A, 0) + sum(
                by_form.get("launch A", {}).values())
            arm = GEO_ARMS[name][what]
            d_max, d_rms = diff(got, oracles[name, what].result())
            say("geometry", f"{name} Renderer {what}, {len(pos)} blocks in chunks of {cb}: "
                            f"{len(r.dispatch)} chunks as {sorted(set(r.dispatch))} (the JAX "
                            f"dispatch: {arm}) in {wall:.2f} s wall; launches {by_form}; vs "
                            f"render_oracle max|diff| {d_max:.3e} (limit {ORACLE_TOL:.0e}), rms "
                            f"{d_rms:.3e}")
            if got.shape != (len(pos) * fpb, 2) or not np.isfinite(got).all():
                return fail("geometry", f"{name} {what}: output {got.shape} not finite")
            if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
                return fail("geometry", f"{name} {what}: the port disagrees with the oracle")
            if set(r.dispatch) != {arm}:
                return fail("geometry", f"{name} {what}: dispatch {sorted(set(r.dispatch))}, the "
                                        f"JAX dispatch takes {arm}")
            steps = sum(v for k, v in by_form.get("kernel", {}).items() if k != "dma_blend")
            if steps != len(r.dispatch):
                return fail("geometry", f"{name} {what}: {steps} step launches on "
                                        f"{len(r.dispatch)} chunks")
            if forms.q and (fault := launch_a_fault(f"{name} {what}", by_form["kernel"],
                                                    dict(fs.forward_launches))):
                return fail("geometry", fault)
            if not forms.q and fs.forward_launches != dict.fromkeys(fs.forward_launches, 0):
                return fail("geometry", f"{name} {what}: launch A ran at a history of partial "
                                        f"blocks")
            del got
        # ---- render_scan on the sweep ----
        pos = geometry_renders(bench, cfg)["sweep"][0]
        fs.reset_launches()
        t0 = time.perf_counter()
        got = render_scan(noise, db, pos, cfg, device=device)
        wall = time.perf_counter() - t0
        by_form = _counts()
        count_split(by_form)
        chunks = -(-len(pos) // SCAN_CHUNK)
        d_max, d_rms = diff(got, oracles[name, "sweep"].result())
        say("geometry", f"{name} render_scan sweep, {len(pos)} blocks in {wall:.3f} s wall: "
                        f"launches {by_form}; vs render_oracle max|diff| {d_max:.3e}, rms "
                        f"{d_rms:.3e}")
        # each chunk's form by its rows (a last short chunk may take another)
        want_forms = {}
        for start in range(0, len(pos), SCAN_CHUNK):
            f = fsp.pick_form(min(SCAN_CHUNK, len(pos) - start), fpb, pad)
            want_forms[f] = want_forms.get(f, 0) + 1
        if (by_form.get("kernel") != {SPATIALIZER: chunks}
                or by_form.get("row 8") != want_forms
                or sum(by_form.get("launch A", {}).values()) != (chunks if forms.q else 0)):
            return fail("geometry", f"{name} render_scan launched {by_form}, want row 8 once a "
                                    f"chunk, by form {want_forms}")
        if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
            return fail("geometry", f"{name} render_scan: the port disagrees with the oracle")
        launched[SPATIALIZER] = launched.get(SPATIALIZER, 0) + chunks
        launched[LAUNCH_A] = launched.get(LAUNCH_A, 0) + (chunks if forms.q else 0)
        # ---- the 16-source scenes ----
        if name in GEO_SCENES:
            sigs = bench.scene_signals(noise, SCENE_S, geometry_samples(cfg) // fpb, fpb)
            for scene, pos in geometry_scenes(bench, cfg).items():
                r = BatchRenderer(db, device=device, chunk_blocks=256)
                fs.reset_launches()
                t0 = time.perf_counter()
                got = r.render(sigs, pos)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                by_form = _counts()
                count_split(by_form)
                for k, v in by_form.get("kernel", {}).items():
                    launched[k] = launched.get(k, 0) + v
                launched[LAUNCH_A] = launched.get(LAUNCH_A, 0) + sum(
                    by_form.get("launch A", {}).values())
                t0 = time.perf_counter()
                plain = BatchRenderer(db, device=device, chunk_blocks=256, fused=False).render(
                    sigs, pos)
                wall_plain = time.perf_counter() - t0
                d = [diff(got[i], oracles[name, (scene, i)].result()) for i in GEO_SCENE_SRCS]
                d_max, d_rms = max(x[0] for x in d), max(x[1] for x in d)
                d_plain = float(np.abs(got - plain).max())
                arm = GEO_SCENE_ARMS[name][scene]
                say("geometry", f"{name} BatchRenderer {scene}, {SCENE_S}x{pos.shape[1]}, chunks "
                                f"of 256: {len(r.dispatch)} chunks as {sorted(set(r.dispatch))} "
                                f"(the JAX dispatch: {arm}) in {wall:.2f} s wall; launches "
                                f"{by_form}; sources {GEO_SCENE_SRCS} vs render_oracle max|diff| "
                                f"{d_max:.3e}, rms {d_rms:.3e}; every source vs the unfused card "
                                f"render ({wall_plain:.2f} s) max|diff| {d_plain:.3e} (limit "
                                f"{GEO_SCENE_TOL:.0e})")
                if got.shape != (SCENE_S, pos.shape[1] * fpb, 2) or not np.isfinite(got).all():
                    return fail("geometry", f"{name} {scene}: output {got.shape} not finite")
                if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS and d_plain <= GEO_SCENE_TOL):
                    return fail("geometry", f"{name} {scene}: the port disagrees with the oracle "
                                            f"or the unfused render")
                if set(r.dispatch) != {arm}:
                    return fail("geometry", f"{name} {scene}: dispatch {sorted(set(r.dispatch))}"
                                            f", the JAX dispatch takes {arm}")
                if fault := launch_a_fault(f"{name} {scene}", by_form["kernel"],
                                           dict(fs.forward_launches)):
                    return fail("geometry", fault)
                del got, plain
        # ---- the live path ----
        pos = geometry_live(bench, cfg)
        fs.reset_launches()
        stats, got, spats = drive_live(db, device, pos[None], noise[None])
        by_form = _counts()
        count_split(by_form)
        ms = np.asarray(stats.compute_ms)
        helix = ms[: len(pos) - GEO_HELD]
        deadline = 1e3 * cfg.block_duration
        d_max, d_rms = diff(got[0], oracles[name, "live"].result())
        med, p90 = float(np.median(helix)), float(np.percentile(helix, 90))
        gated = fpb >= GEO_LIVE_GATE_FPB
        say("geometry", f"{name} live: {len(pos) - GEO_HELD} helix blocks then {GEO_HELD} held, "
                        f"{spats[0].crossfades} crossfades; launches {by_form}; vs render_oracle "
                        f"max|diff| {d_max:.3e}, rms {d_rms:.3e}; {stats.summary()}; the helix "
                        f"median {med:.4f} ms, p90 {p90:.4f} ms against the {deadline:.3f} ms "
                        f"deadline ({'gated' if gated else 'timed, not gated: below fpb 32'}, "
                        f"median met: {med < deadline}, p90 within twice: {p90 < 2 * deadline}); "
                        f"held blocks median {float(np.median(ms[-GEO_HELD:])):.4f} ms  [{card}]")
        n_live = len(pos) + 2
        if by_form.get("kernel") != {SPATIALIZER: n_live}:
            return fail("geometry", f"{name} live: launched {by_form}, want row 8 once a block")
        if not (d_max <= ORACLE_TOL and d_rms < ORACLE_RMS):
            return fail("geometry", f"{name} live: the port disagrees with the oracle")
        if gated and not (med < deadline and p90 < 2 * deadline):
            return fail("geometry", f"{name} live: median {med:.4f} ms / p90 {p90:.4f} ms past "
                                    f"the {deadline:.3f} ms deadline")
        live = {"median_ms": med, "p90_ms": p90, "deadline_ms": deadline, "gated": gated}
        launched[SPATIALIZER] = launched.get(SPATIALIZER, 0) + n_live
        launched[LAUNCH_A] = launched.get(LAUNCH_A, 0) + sum(by_form.get("launch A", {}).values())
        # ---- every form against its twin, and the timings ----
        errs, times = {}, {}
        if not geometry_kernels(bench, db, device, name, forms, errs, times):
            return None
        if ((name in SPLIT_TIMED or forms.tile_cols < fs.T_TILE)
                and split_timing(name, db, forms) is None):
            return None
        results[name] = {"launches": launched, "split_launches": split_launched, "errs": errs,
                         "times": times, "live": live}
        say("geometry", f"{name}: launches on its renders, scans, scenes and live blocks "
                        f"{launched}, of them in launch B's split form {split_launched}; "
                        f"{time.perf_counter() - t_geo:.1f} s")
    # ---- the geometry the card refuses: a resource, before any launch ----
    import dataclasses

    from jefferson_tpu_torch.config import EngineConfig

    for fpb, taps in GEO_EDGES:
        cfg = EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
        db = dataclasses.replace(_geo_db(128, 512), config=cfg)   # nothing is built from it
        fs.reset_launches()
        for what, make in (("Renderer", lambda: Renderer(db, device=device)),
                           ("StreamingSpatializer",
                            lambda: StreamingSpatializer(db, device=device))):
            try:
                make()
            except ValueError as e:
                raised = str(e)
            else:
                raised = None
            ok = (raised is not None and "CTAs a grid's y holds" in raised and not _counts())
            say("geometry", f"{what} at fpb {fpb}, pad {cfg.pad_len} on the card: raised before "
                            f"any launch: {ok} ({raised})")
            if not ok:
                return fail("geometry", f"{what} at fpb {fpb}, pad {cfg.pad_len} did not raise")
    say("geometry", f"the phase in {time.perf_counter() - t_phase:.1f} s")
    return results


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2]))
    sys.exit(main())
