#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpu_ecs_madrona_tpu_torch).

Drives the port's main paths on one CUDA card — the collisions example at
8192 worlds x 100 cubes, simple_jobs at 1024 worlds x 100 and x 2,048 objects,
fantasy_vs at 16384 worlds x 50 dragons + 200 knights, rigid_bench
(rigid-body physics) at 8192 worlds x 64 bodies (also with the broadphase
in the fused kernel, and the settled pile with its options; at 32 bodies
in the dense contact mode, and at 200, 255 and 1,023 with the sap broadphase; chains of
boxes in 4,096 joint rows; and a pile of
convex hulls imported from an .obj file, at 64 bodies and at the settled
pile's options, also of a 24-sided prism past PhysicsLoader()'s default
caps) and simple_taskgraph
(physics and the batch renderer) at 1024 worlds x 100 spheres, and x 1,000,
with 64 x 64 RGB and depth — through every kernel they run, and holds every kernel
against its plain PyTorch version; and trains the PPO learner on
fantasy_vs at 16384 worlds (the RL training path, which runs no kernel),
also across ranks (one NCCL rank, and two gloo processes sharing the card
beside collisions split over them), and runs the profiler and the
autotuner.
Run from the root of a checkout:

    python3 chip_smoke.py            # the smoke test
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown

Each phase prints one JSON line; the last line is
{"ok": true, "device": {...}}.  Any failed check, build or launch raises
and exits non-zero before that line.  There is no CPU fallback: without a
CUDA device, or run outside a checkout, it exits non-zero.

Phases:
  device   card name, count, nvidia-smi name and power limit
  build    nvcc of every csrc/*.cu (in parallel), ptxas register and
           shared-memory lines
  parity   collision kernels vs their plain versions at the main path's
           shapes (W=8192, n=108 rows, 100 live) and collision_pushes at
           n=1500, W=16 (the tiled path), a dense cluster (64 x 64 rows,
           every live pair overlapping) through both, and collision_pushes
           on the main state offset by 1e4; fused_collisions_step: lo/hi
           atol 1e-5, delta atol 1e-4 against the plain push on the
           kernel's own lo/hi; collision_pushes: delta atol 1e-4
  parity_simple_jobs   fused_simple_jobs_step vs its plain version: the
           main shapes (1024 x 100, K=1600, D=32, the executor's initial
           state), a dense cluster with D=4 (dropped > 0), K=128 with more
           pairs (slots cut), coincident bodies in one corner, n0=37, a
           touching grid (AABBs meeting on closed slabs), a dense
           cluster with D=32 (every row past the cap, K cut) and 8 worlds
           of 2,048 bodies, K = 32,768 (the rounds layout); ab, counts,
           dropped, lo and hi exact, normals atol 1e-5, translation atol
           1e-4, all finite, a repeated launch bit-identical
  golden   the reference binary's collisions trajectory
           (tests/goldens/job_collisions.bin, 1 world x 100 cubes, 120
           ticks) on the card, both modes: <= 1e-3 at t=3, <= 0.02 over
           the horizon
  golden_fvs   the reference binary's fantasy_vs run
           (tests/goldens/fvs_job_5d9k120t.bin, 2 worlds, 120 ticks)
           replayed in scripted mode on the card: masks and arrows exact,
           hp and mana atol 1e-3, action atol 1e-4, positions atol 1e-5,
           at least one death
  parity_learner   one PPO train step of the CPU tests' scripted RL
           world (tests/test_torch_rl_cases.py: 8 worlds x (3 + 6), 2
           epochs, 4 minibatches, observation normalisation, done every
           third tick) on the card and on the CPU from the same numpy
           parameters and draws: the largest differences of the loss
           (rtol 2e-4), mean reward (1e-6), parameters (atol lr / 4, the
           update as a whole 5e-3), Adam moments (2e-2 of each leaf's
           largest entry), step count and observation statistics (1e-5;
           the count exact): LEARNER_TOL, whose comment says why
  parity_reset   the reset tests' worlds (start heights from a table, and
           from each world's generator stream), 40 steps of 1024 worlds on
           the card and on the CPU: positions, masks and ticks equal, at
           least 3 resets a world
  bindings   exported_tensor(...).to_torch() on the card is the column
           (its data_ptr); an injected z round-trips through set_exported
           and a collisions step (8192 worlds); to_numpy copies
  parity_sap   the sap broadphase node (rigid_bench at 8192 x 201 rows,
           "auto" above 192, after 3 steps on the card, its AABBs made on
           the card; and that state with its bodies on an unrotated grid of
           boxes, ties in the globals' top-k and in the sort) on the card
           against the same node on the CPU: candidate rows, handles, masks
           and overflow exact; the node's device ms
  parity_dense   one dense-mode step (rigid_bench at 256 x 33 rows, "auto"
           at 48 or fewer, after 90 steps on the card) on the card against
           the same step on the CPU: poses atol 1e-4, velocities 1e-3, the
           step repeated on the card bit-identical, no kernel launched
  parity_substep   the fused substep kernel vs its plain version: the
           main path's shapes (8192 x 65 rows) after 3 steps at K=256 (the
           chunked TPU route) and K=128 (the unchunked one), the initial
           uniform spawn, tables without restitution, a golden scene, the
           sap state of parity_sap (8192 x 201 rows, K=800, sap's order);
           and the single-substep kernel vs its plain version on the first
           substep of the K=256 state, and its node launch (the integrate,
           the joint solve and the writeback too) on the joint world of
           tests/test_torch_joint_scenes.py (256 worlds, live Fixed and
           Hinge joints) and on simple_taskgraph's state with its random
           joints (16 worlds: several on a body, a null handle, a handle
           into another archetype); rigid_bench's boxes with the table padded
           to 9 and 32 verts a hull and with the box's 12 and 20 live verts
           (the wide-box build: the fused kernel with and without contact
           refresh at the K=256 state, kernel 5's node on the joint world
           after 30 steps, its free box tilted into the plane), bit for bit
           the plain version, the padded ones also the box table's launch;
           poses and stashes atol 1e-4, velocities atol
           1e-3, all finite, a repeated launch and a repeated plain run
           bit-identical (both are also held at the simple_taskgraph main
           state, in the timing phase); and the fused kernel past one block's
           shared memory (its windowed layout, WINDOW_CASES: rigid_bench at
           8192 x 239, 255 and 511 bodies after 3 steps, contact refresh at
           200 and 255 bodies, the imported-prism pile at 255 bodies; all
           but 511 dropped close together, so that a world's valid slots pass
           the window, which is checked) on every world, bit for bit its
           plain version on the first 128 (max_abs_err 0), with each case's
           window and valid slots; and past the body-row ceilings, with the
           bodies in a global scratch, at 8 worlds, twice and bit for bit
           the plain version (BODY_CASES): the windowed twin at 969 and
           1,023 bodies of rigid_bench ("win+bodies"), with contact refresh
           at 895, the imported-prism pile at 371 and 512 ("win+bodies+
           hull"); kernel 5 at 816 rows (rigid_bench's first substep, its
           JAX contract) and its node launch at 1,068 rows (simple_taskgraph
           at 1,064 objects) with random live joints in its 64 joint rows
  parity_hull   the substep kernels' general-hull paths (the imported
           hexagonal prism of tests/test_torch_hull_scenes.py) vs their plain
           versions at 8192 x 65 rows: every fused specialisation (K = 256
           and 128; refresh, sleep with mixed active flags, refresh and
           sleep, the broadphase without and with refresh, persistence
           without and with sleep, its branches also flipped) at the hull
           pile's spawn, after 3 steps and on prisms stacked face on face
           (after 0 and 2 steps; the persistent ones after 30); kernel 5
           without FULL on the pile's first substep and at its spawn, and its
           node launch on the joint world with the prism for its boxes;
           parity_substep's gates, each case's candidates and touching pairs
           by kind (the SAT's face and edge outcomes, sphere-hull and
           hull-plane must all be reached); the same for the 24-sided prism
           (tests/test_torch_hull_scenes.py's large hull: 48 verts, 24-vertex
           caps, 72 full edges) at 128 x 65 rows (its plain version's SAT
           tensors grow with the edge pairs), "none" after 3 steps, stacked,
           the settled options after 30 steps, kernel 5 without FULL; every
           general-hull case bit for bit its plain version (max_abs_err 0)
  golden_physics   the reference binary's 1-substep physics goldens
           (cubes_fall, cube_pair, cube_stack, cube_bounce) and the
           free-fall check on the card, kernel and pairs modes, with
           tests/test_reference_golden.py's gates
  joints_cube_chain   the reference binary's joint golden (cube_chain_ss4,
           tests/goldens) in the kernel mode: kernel 5's node launch on the
           card and its plain version on the CPU, 4 launches a tick on the
           card; both miss the golden's early gate (0.02 over 10 ticks) by
           the same amount as JAX's kernel mode (~0.048, equal within
           1e-5), horizon <= 1.5, final z < 2, finite
  entity64   64-bit entity handles (GEM_TPU_ENTITY_64=1, read at import: a
           process of its own, this script with --entity64-child): the
           handle dtype int64 with a 32/31 split; one slot churned 2,100
           times (past the int32 default's 2^11 generations) keeps a
           handle of its first cycle dead; cube_chain_ss4 in the kernel
           mode (kernel 5 with a live joint, its handles looked up in the
           launch) tick by tick, each tick's node launch bit for bit its
           plain version on the card, 4 launches a tick, and the whole
           trajectory bit for bit joints_cube_chain's card run under int32
           handles (a handle of generation 0 has one value at either width)
  main_fused     collisions fused=True (kernel 1), 3 warm-up steps then
           windows of 200 steps; launches = steps, finite positions, empty
           temporary tables; env-steps/s
  main_unfused   collisions fused=False, use_kernel=True (kernel 2), 50
           steps
  main_simple_jobs   simple_jobs fused=True (kernel 4), 1024 x 100, 3
           warm-up steps then 5 windows of 200; launches = steps, finite
           positions, counters 0 (the node's one launch writes them)
  main_simple_jobs_unfused   fused=False, rank compaction, 50 steps; no
           kernel launch
  main_simple_jobs_large   simple_jobs at 1024 worlds x 2,048 objects, K =
           32,768 (the config's 16 slots an object), D = 32, fused=None:
           kernel 4's rounds layout, one launch a step; at the executor's
           initial state the launch against its plain version on 8 worlds
           (integers, lo and hi exact, translation atol 1e-4, normals 1e-5)
           and a repeat bit-identical on every world; after 3 steps the
           same with the normals within 1e-5 and the translation within
           SJL_F64_ATOL of the push in float64 (both sums' distances
           reported); 3 windows of 10 steps (launches = steps,
           counters 0, finite positions); the launch's ms beside its bound
           and its plain version's (8 worlds); the rank path (fused=False)
           at 256 worlds, its step
  main_fantasy_vs   16384 worlds x 50 dragons + 200 knights, cleanup on, 3
           warm-up steps then 5 windows of 50; live counts never rise,
           overflow counters 0, finite positions
  main_ppo_fantasy_vs   PPOLearner on fantasy_vs at 16384 worlds x (50 +
           200), cleanup on (obs 1250, actions 600), hidden 128, rollout 16,
           2 epochs, 2 minibatches, observation normalisation: one untimed
           train step, 5 timed (each ended by a synchronise), 2 with the
           rollout and the update timed apart (CUDA events), one under
           torch.cuda.set_sync_debug_mode("error"); train steps/s, training
           env-steps/s (W x 16 / s), peak memory; no kernel launched, loss
           and reward finite, the parameters changed, norm count 1e-4 +
           steps x 16 x W (float32)
  main_rigid     rigid_bench defaults, 8192 x 64, K=256, the fused
           substep kernel: 3 warm-up steps then 5 windows of 50; launches =
           steps, finite positions, empty temporaries after each window;
           overflow counters, env-steps/s
  main_rigid_k128    the same at max_candidates=128
  main_rigid_pairs   contact_mode="pairs", one window of 10 steps; no
           kernel launch
  main_rigid_dense   rigid_bench at 8192 x 32 bodies + the plane,
           contact_mode and broadphase "auto" (the dense contact mode, the
           dense broadphase): 3 warm-up steps then 3 windows of 5; no
           kernel launch, finite positions, empty temporaries; env-steps/s,
           the peak of allocated device memory and the node's world block
  main_rigid_sap   rigid_bench at 8192 x 200 bodies + the plane,
           contact_mode="pallas", broadphase "auto" (sap), K=800: 3
           warm-up steps then 5 windows of 20; launches = steps, all of
           specialisation "none"; overflow counters and the last step's
           window saturation (recounted); env-steps/s, peak memory
  main_rigid_sap_large   rigid_bench at 8192 x 255 bodies + the plane
           (K = 1020), contact_mode and broadphase_mode "auto" (checked to
           resolve to the fused kernel and sap): 3 warm-up steps then 5
           windows of 20; launches = steps, all of the windowed
           specialisation "win"; overflow counters, the last step's window
           saturation, env-steps/s, peak memory, the window and the shared
           and global bytes a world takes, and the kernel at the state the
           windows leave bit for bit its plain version on 128 worlds
  main_rigid_sap_xlarge   rigid_bench at 8192 x 1,023 bodies + the plane
           (K = 4,092), contact_mode and broadphase_mode "auto" (checked to
           resolve to the fused kernel and sap): 3 warm-up steps then 3
           windows of 5; launches = steps, all of "win+bodies" (the windowed
           twin with the bodies in a global scratch); env-steps/s, peak
           memory, the two scratches' size reckoned before the run, the
           launch at the state the windows leave bit for bit its plain
           version on 8 worlds, its ms (CUDA events) beside its bound and
           its plain version's (8 worlds) and CTAs an SM; cut to 4,096
           worlds only if the card's memory does not hold it (printed as
           "reduced")
  main_rigid_fused_bp   the main_rigid pile with broadphase_mode="fused"
           (kernel 8: the broadphase inside the fused kernel), K = 256:
           launches = steps, all of the "bp" specialisation, and no other
           kernel; printed beside main_rigid's median
  main_rigid_settled   the JAX bench_physics.py BENCH_PHYS_SETTLE=1 pile
           (rigid_bench SETTLED_PILE: boxes on a grid, the broadphase in the
           kernel, refresh, persistent manifolds, sleep 0.02; kernel 9), 400
           untimed steps, then 5 windows of 50: launches = steps of the
           "refresh+sleep+bp+persist" specialisation, of the world flags
           kernel and of the asleep worlds' kernel; then 10 more steps with
           each step's share of stable worlds, of asleep worlds, and the
           worlds rebuilding their cache (both shares must reach > 0)
  main_rigid_settled_nopersist   the same without persistence and sleep
           (bench_physics.py:43-47's A/B): "refresh+bp" launches
  main_rigid_hulls   rigid_bench at main_rigid's width (8192 x 64, K = 256,
           prisms and spheres, uniform spawn) with object 0 the prism
           imported from an .obj file: launches = steps, all of the "hull"
           specialisation, no other kernel; finite positions, empty
           temporaries, env-steps/s; the fused node's device ms, host ms and
           device ops
  main_rigid_hulls_settled   the settled pile's options with prisms for
           boxes (grid spawn, the broadphase in the kernel, refresh,
           persistence, sleep), 400 untimed steps, then 5 windows of 50:
           launches of "refresh+sleep+bp+persist+hull", the world flags and
           the asleep worlds' kernel = steps; stable worlds seen; and, right
           after the 400 steps and for 10 more (untimed), each step's motion
           against the sleep threshold ("motion_after_settle"): the share
           of worlds whose largest dynamic |v|^2 + |w|^2 passes
           sleep_threshold^2 (the sleep classifier's test), quantiles of the
           worlds' largest |v|^2 and |w|^2, the bodies above the threshold
           by pose (a prism on a cap, on a side, tilted) and the quiet-step
           counters (no world falls asleep: the prisms keep rocking, as in
           the JAX package, tests/test_torch_hull_sleep.py)
  main_rigid_hulls_large   main_rigid_hulls with the 24-sided prism for object
           0 (tables past PhysicsLoader()'s defaults): launches = steps, all
           of the "hull" specialisation, finite positions, env-steps/s
  parity_substep_options   each option's kernel specialisation vs its
           plain version at 8192 x 65: refresh over given rows at K = 256
           and 128, sleep with mixed active flags, the broadphase at K = 256
           without and with refresh, persistence at the settled state as it
           is and with its stable and active flags flipped so that every
           branch runs (the worlds by branch are printed); integers exact,
           poses, stashes, AABBs and the cache atol 1e-4 (the cache's ok
           flag free where its depth is within 1e-5 of 0), velocities 1e-3,
           a repeated launch bit-identical; kernel 9's launch as the fused
           node makes it (the cache and the anchors in place, the
           per-object constants from the kernel's table, velocities kept)
           on both states bit for bit against the plain version's in-place
           path, a repeat into the same cache bit-identical and the kept
           caches untouched; the world flags kernel equal to its plain
           version on the settled pile as it is, disturbed, forced and with
           invalid caches
  parity_render   the render kernel's rays mode vs its plain version on
           the scenes of tests/test_torch_render_scenes.py (CARD_SCENES:
           8 x 4 pixel tiles; inside_wrapping's tile over rows 4-7 spans
           both of its back-to-back views, so its cone wraps) and at the
           main state (1024 worlds after 3 steps): hit exact, depth and
           float rgb atol 1e-5, a repeated launch bit-identical; its views
           mode (the render node's one launch) at the main state and on
           VIEW_CASES (two views with dead ones, 24 x 40 and 18 x 30
           images, a triangle-mesh scene, the imported prism's importer
           SourceMesh as a render mesh) bit for bit against the node's
           route before it on the card (camera_rays, pack, the rays mode,
           the RGBA8/depth epilogue; depth compared as int32 bits), a
           repeat bit-identical,
           and against its plain version (alpha exact, depth atol 1e-5
           where both hit, RGBA8 within 1); and the kernel route against
           the "xla" route at 64 worlds: hit masks differ on at most 1
           pixel in 1e5 (the count is printed), depth rtol 1e-4 / atol
           1e-3 and RGBA8 within 1 where both hit
           (tests/test_render_pallas.py's tolerances); and past one block's
           shared memory (4,096 instance rows a world, staged in blocks of
           512: tests/test_torch_render_scenes.py's large scene, a quarter
           of its rows triangle meshes, the imported prism's SourceMesh
           among them) both modes bit for bit their plain versions
  main_simple_taskgraph   simple_taskgraph at 1024 worlds x 100 spheres + 1
           agent camera, 4 substeps, 64 x 64 RGB and depth, renderer
           "auto" (the render node one views-mode launch): 3 warm-up steps
           then 5 windows of 50; launches =
           {substep: 4 x steps, render: steps} and no other, finite
           positions, finite depth on every hit and alpha 255 exactly where
           the depth is finite, overflow counters; env-steps/s
  main_simple_taskgraph_large   simple_taskgraph at 1024 worlds x 1,000
           spheres (1,004 rows, K = 10,000, 64 joint rows), 64 x 64 RGB and
           depth, "auto": four kernel-5 launches a step with the bodies in a
           global scratch (counted in body_launches) and kernel 10's views
           mode at 1,004 instances (below its blocked threshold); 3 steps,
           a timed one (worlds cut to 256, printed as "reduced", if it
           passes 150 ms), then 3 windows of 10; launches = {substep: 4 x
           steps, render: steps}; env-steps/s, the device ms of a step (3
           steps, CUDA events), peak memory, the step's four node launches
           on 4 worlds bit for bit their plain version (each the last's
           pose and velocities in), the node launch's ms beside its bound
           and its plain version's, and CTAs an SM
  main_joint_rows_large   the chains' world of tests/test_torch_joint_scenes.py
           at 1024 worlds x 68 chains of 16 boxes (1,089 rows, K = 2,048),
           4,096 joint rows of which 1,020 live (alternating Fixed and
           Hinge), kernel mode: four kernel-5 launches a step with the joint
           rows in the body scratch (joint_scratch_launches); 3 steps, the
           step's four node launches on 4 worlds bit for bit their plain
           version, 3 windows of 10 (launches = {substep: 4 x steps});
           env-steps/s, a step's device ms, peak memory, the node launch's
           ms beside its bound and its plain version's
  main_render_large   the render node of a BatchRenderer with backend
           "auto" (checked to resolve to the kernel) on 256 worlds of 4,096
           instance rows (the large scene's instances, one 64 x 64 view a
           world about its camera: pixels x instances 2^24, past JAX's 2^19
           threshold for its kernel), 5 runs: launches = 5 of the render
           kernel and no other, RGBA8 and depth bit for bit the plain
           version on 8 of the worlds, alpha 255 exactly where the depth is
           finite; the blocks a CTA stages
  main_ppo_fantasy_vs_ranks   the learner across ranks over a one-rank
           NCCL group (parallel/mesh.py) at main_ppo_fantasy_vs's
           configuration: its first train step from seed 0 against the
           learner without a process group (its collectives do nothing)
           from the same seed and world state within
           LEARNER_TOL; 5 timed train steps (train steps/s and training
           env-steps/s beside main_ppo_fantasy_vs's), one under the
           sync-debug mode "error", no kernel launched, peak memory
  parity_ranks_shared_card   two processes on the one card over gloo
           (NCCL refuses two ranks on one device; gloo's collectives on CUDA
           tensors go through the host): one PPO train step of 2 x 2048
           worlds of main_ppo_fantasy_vs's configuration from seed 0 against
           one process at 4096 worlds on the card, within LEARNER_TOL, the
           ranks' parameters bit-identical
  sharded_collisions   the same two processes: each rank's 4096 of the
           main path's 8192 x 100 collisions worlds (shard_state of the
           global initial state) stepped 10 times with kernel 1: every state
           leaf bit for bit the matching rows of one process, kernel 1's
           launches = steps in each rank, the cross-rank checksum equal
  profiler   tooling/profiler.py on collisions fused (8192 x 100) and
           simple_taskgraph (1024 x 100, 64 x 64): profile_nodes (5 runs a
           node, CUDA events behind a device sleep) and trace_step (3 steps)
           -> node_timeline: the executor's state bit for bit as before,
           every node segment inside its step span, node totals within the
           steps'; the SVG under build/profile/
  autotune   tooling/autotuner.py: tune_collisions at 8192 x 100 (200
           ticks) and tune_physics_substep at rigid_bench 1024 x 64
           ("dense", "pairs", "pallas"; 5 ticks), each candidate, the fixed
           rule and the winner's recheck in a fresh process: each
           candidate's env-steps/s and the validated flag; the artifact under
           build/autotune/; with GEM_TPU_EXEC_CONFIG_FILE at a validated
           "cuda" entry {"fused": false, "use_kernel": true} (the tuner's
           unfused candidate) the default CollisionsConfig(fused=None)
           launches kernel 2 and never kernel 1, with {"fused": true}
           kernel 1; the repository's gem_tune.json gives
           None for every kind and is left unwritten
  timing   CUDA-event time of each kernel wrapper (200 calls) and of its
           plain version at the main paths' shapes (kernel 3: the tiled
           case, n=1500, W=16, 128- and 1024-wide j tiles; the collision
           kernels' launch shapes with their CTAs an SM, and the device ops
           of a collision_pushes call, the nodes of a CUDA graph that
           captures it, which must be 1; kernel 4 at the main_simple_jobs
           state, with its registers and spills (the build's ptxas line),
           its launch shape and CTAs an SM, and the fused_step node's
           device ms, host ms and device operations, which must be 1; the substep
           kernel: 20 calls at both K from the main_rigid states and at
           the main_rigid_sap state (n = 201, K = 800), with
           what its operation count is counted from: the pairs by kind,
           and the live contact points the plain version finds in each
           substep of the same call), beside the
           bound: max(bytes / 3.35 TB/s, fp32 ops / 67 TFLOP/s), the H100
           SXM peaks; no single PyTorch call computes any of these
           functions, so there is no library yardstick.  The render kernel
           (200 calls) from the main_simple_taskgraph state, in its rays
           mode on the inputs the node's route before its views mode gave
           it (row 10 at equal work) and in its views mode as the node
           launches it (the kernels line's ms), each with its CTAs an SM
           and CTAs an image: the bound counts the (pixel, live instance)
           pairs whose bounding sphere the pixel's own ray meets, times the
           instance's test, and a per-pixel cost (the views mode's ray
           too), and the bytes of each mode's inputs and outputs; the
           instances the tile cull keeps per 8 x 4 and per 16 x 8 tile;
           the render node's device ms, host ms and device operations (a
           captured CUDA graph's nodes, at most 3); and the device time of
           a simple_taskgraph step's physics nodes and of its render
           nodes.  The single-substep kernel (200 calls) at the
           first substep of that state, its bound counted as the fused
           kernel's for one substep without the integrate; and its node
           launch there (200 calls; the kernels line's ms), held against
           its plain version, its bound counted from the launch's bytes
           (the joints' rows and the live joints' fields too) and
           operations (the integrate and the joints' apply a body, each
           live joint's terms), with the substep node's device ms, host ms
           and device operations.  Kernels 8 and 9
           (20 calls each) at the main_rigid_fused_bp and main_rigid_settled
           states (kernel 8 with refresh also at the settled A/B's), their
           operations counted over the awake worlds (options_work: contact
           tests only where contacts are made afresh, refreshes and cache
           builds by slot, the broadphase of the rebuilding worlds), each
           with its valid slots by contact kind.  Kernel 9 is timed as the
           fused node launches it (world_flags, then fused_substep: the
           asleep worlds' kernel and the persistent kernel, the cache in
           place) and by part, its bytes counted by each world's branch
           (persist_bound; the bound with the cache in and out beside it);
           and the settled pile's whole fused node: its device ms and the
           device operations it queues (a captured CUDA graph's nodes).
           The windowed fused kernel at main_rigid_sap_large's state, and
           the blocked render kernel at main_render_large's (its plain
           version at 8 of the 256 worlds; the rays mode on the same views'
           rays), each beside its bound.
           The general-hull specialisations at the hull piles' states (20
           calls, beside their plain versions; the operations counted from
           the .cu per prism pair, contact_ops), kernel 5's node launch on
           the joint world with prisms, and the "hull" launch at
           main_rigid_hulls_large's state (its plain version at 128 of the
           worlds, its work counted over all of them in blocks of worlds).
           substep_occupancy: each fused specialisation's [threads a CTA,
           CTAs an SM] at 65 rows and
           K = 256 and 128, and the single-substep kernel's at 104 rows, K =
           1000, without and with its integrate and 64 joint rows
           (cudaOccupancyMaxActiveBlocksPerMultiprocessor, through
           ops.substep_kernel.occupancy); the build phase's ptxas lines give
           each kernel's registers, stack frame and spills
"""

import json
import os
import struct
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NUM_WORLDS = 8192        # collisions
SJ_WORLDS, SJ_OBJECTS, SJ_K, SJ_D = 1024, 100, 1600, 32   # simple_jobs
# main_simple_jobs_large: simple_jobs past kernel 4's one-block layout, the
# config's 16 slots an object
SJL_WORLDS, SJL_OBJECTS, SJL_K, SJL_D = 1024, 2048, 32768, 32
FVS_WORLDS = 16384       # fantasy_vs
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12      # H100 SXM fp32, outside the tensor cores


_START = time.perf_counter()


def emit(obj):
    """Prints obj as a JSON line; a phase's line with at_s, the script's
    seconds when it ended (where a run's time goes)."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(a, b):
    return float((a - b).abs().max())


def cuda_ms(torch, fn, iters, warmup=3):
    """Device ms per call of fn.  The calls are queued behind a ~0.1 s
    device sleep, so the host has enqueued them before the first runs:
    the events time the device's work back to back, not the host's
    enqueue (which is the longer of the two for a call whose wrapper
    costs more than its kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pair_counts(torch, lo, hi, mask):
    """(live ordered pairs, overlapping live ordered pairs) of this data:
    the pairs the kernels test, and the pairs they push."""
    live = mask.sum(dim=1).double()
    live_pairs = float((live * (live - 1)).sum())
    not_eye = ~torch.eye(mask.shape[1], dtype=torch.bool, device=mask.device)
    overlaps = 0.0
    step = max(1, (1 << 24) // (mask.shape[1] ** 2))  # bounded temporaries
    for w0 in range(0, mask.shape[0], step):
        sl = slice(w0, w0 + step)
        ok = ((lo[sl, :, None] <= hi[sl, None]) & (lo[sl, None] <= hi[sl, :, None])).all(-1)
        overlaps += float((ok & mask[sl, :, None] & mask[sl, None, :] & not_eye).sum())
    return live_pairs, overlaps


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rates(steps, windows_s, worlds=NUM_WORLDS):
    r = sorted(steps * worlds / s for s in windows_s)
    return {"median": r[len(r) // 2], "min": r[0], "max": r[-1],
            "window_s": windows_s, "steps_per_window": steps}


def windows(sim, steps, count):
    """Wall seconds of ``count`` windows of ``steps`` steps, each ended by
    a device synchronise."""
    out = []
    for _ in range(count):
        t0 = time.perf_counter()
        sim.run(steps)
        sim.block_until_ready()
        out.append(time.perf_counter() - t0)
    return out


def load_job_golden():
    path = os.path.join(HERE, "tests", "goldens", "job_collisions.bin")
    with open(path, "rb") as f:
        d = f.read()
    check(d[:4] == b"GLDJ", "golden magic")
    T1, n, _, _ = struct.unpack("<4i", d[4:20])
    off = 24 + n * 16
    import numpy as np
    rot0 = np.frombuffer(d[24:off], np.float32).reshape(n, 4).copy()
    rec = n * 12 + 4
    pos = np.stack([np.frombuffer(d[off + t * rec: off + t * rec + n * 12],
                                  np.float32).reshape(n, 3) for t in range(T1)])
    return pos, rot0


# -- the fantasy_vs golden: the binary's dump and its splitmix64 draws ------

_M64 = (1 << 64) - 1
# the constants fvs_job_5d9k120t.bin was generated with
FVS_GOLDEN_CONSTANTS = {"ARROW_DAMAGE": 350.0, "CAST_DAMAGE": 60.0, "CAST_RADIUS": 8.0,
                        "CAST_COST": 5.0}


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _fvs_key(domain, tick, idx, ch):
    return _splitmix64(((domain << 56) | (tick << 32) | (idx << 8) | ch) & _M64)


def _fvs_u01(np, domain, tick, idx, ch):
    return np.float32(_fvs_key(domain, tick, idx, ch) >> 40) / np.float32(16777216.0)


def load_fvs_golden(np):
    """(per-tick records, dragons, knights) of tests/goldens/fvs_job_5d9k120t.bin."""
    with open(os.path.join(HERE, "tests", "goldens", "fvs_job_5d9k120t.bin"), "rb") as f:
        d = f.read()
    check(d[:4] == b"FVSG", "fvs golden magic")
    tp1, nd, nk, _ = (int(v) for v in np.frombuffer(d[4:20], np.int32))
    fields = (("d_alive", nd, np.int32), ("d_hp", nd, np.float32), ("d_mp", nd, np.float32),
              ("d_act", nd, np.float32), ("d_pos", nd * 3, np.float32),
              ("k_alive", nk, np.int32), ("k_hp", nk, np.float32),
              ("k_arrows", nk, np.int32), ("k_act", nk, np.float32),
              ("k_pos", nk * 3, np.float32), ("k_target", nk, np.int32))
    off, out = 20, []
    for _ in range(tp1):
        rec = {}
        for key, n, dt in fields:
            rec[key] = np.frombuffer(d[off:off + 4 * n], dt).copy()
            off += 4 * n
        rec["d_pos"] = rec["d_pos"].reshape(nd, 3)
        rec["k_pos"] = rec["k_pos"].reshape(nk, 3)
        out.append(rec)
    check(off == len(d), "fvs golden length")
    return out, nd, nk


def fvs_golden_script(np, dump, nd, nk, lo, hi):
    """The binary's decisions (domains of fvs_main.cpp) as script tables."""
    T = len(dump) - 1
    lo, hi = np.array(lo, np.float32), np.array(hi, np.float32)
    span = hi - lo

    def posdraw(domain, tick, idx):
        return np.array([lo[c] + span[c] * _fvs_u01(np, domain, tick, idx, c)
                         for c in range(3)], np.float32)

    def act_tab(domain, n):
        tab = np.zeros((T, n, 4), np.float32)
        for t in range(T):
            for i in range(n):
                tab[t, i, 0] = _fvs_u01(np, domain, t, i, 0)
                for c in range(3):
                    tab[t, i, 1 + c] = (np.float32(2.0) * _fvs_u01(np, domain, t, i, 1 + c)
                                        - np.float32(1.0))
        return tab

    return {
        "d_pos": np.stack([posdraw(0, 0, i) for i in range(nd)]),
        "d_mana": np.array([np.float32(50.0) * _fvs_u01(np, 0, 0, i, 3) for i in range(nd)],
                           np.float32),
        "k_pos": np.stack([posdraw(1, 0, i) for i in range(nk)]),
        "k_arrows": np.array([20 + _fvs_key(1, 0, i, 3) % 21 for i in range(nk)], np.int32),
        "d_act": act_tab(2, nd), "k_act": act_tab(3, nk),
        "cast_target": np.stack([np.stack([posdraw(4, t, i) for i in range(nd)])
                                 for t in range(T)]),
        "archer_target": np.stack([dump[t + 1]["k_target"] for t in range(T)]),
    }


def golden_fvs(torch, fvs):
    """Replay fvs_job_5d9k120t.bin on the card; returns the phase's line."""
    import numpy as np
    dump, nd, nk = load_fvs_golden(np)
    saved = {k: getattr(fvs, k) for k in FVS_GOLDEN_CONSTANTS}
    for k, v in FVS_GOLDEN_CONSTANTS.items():
        setattr(fvs, k, v)
    try:
        cfg = fvs.FantasyVsConfig(num_worlds=2, num_dragons=nd, num_knights=nk, seed=0,
                                  scripted=True, replicate_clamp_bug=True)
        sim = fvs.make_executor(cfg, init_data=fvs_golden_script(
            np, dump, nd, nk, fvs.BOUNDS_LO, fvs.BOUNDS_HI), device="cuda")
        mgr = sim.mgr
        errs = {"hp": 0.0, "mp": 0.0, "act": 0.0, "pos": 0.0}
        deaths = 0
        for t in range(len(dump) - 1):
            sim.step()
            ref = dump[t + 1]
            live = {fvs.Dragon: ref["d_alive"] > 0, fvs.Knight: ref["k_alive"] > 0}
            deaths = int((~live[fvs.Dragon]).sum() + (~live[fvs.Knight]).sum())
            for arch, p in ((fvs.Dragon, "d"), (fvs.Knight, "k")):
                m = live[arch]
                got_mask = mgr.row_mask(sim.state, arch).cpu().numpy()
                check((got_mask == m[None]).all(), f"t={t} {arch.name} alive mask")

                def col(comp, field=None):
                    v = mgr.column(sim.state, arch, comp)
                    return (v if field is None else v[field]).cpu().numpy()[:, m]

                if arch is fvs.Knight:
                    check((col(fvs.Quiver, "arrows") == ref["k_arrows"][m][None]).all(),
                          f"t={t} arrows")
                else:
                    errs["mp"] = max(errs["mp"], float(np.abs(
                        col(fvs.Mana, "mp") - ref["d_mp"][m][None]).max(initial=0.0)))
                errs["hp"] = max(errs["hp"], float(np.abs(
                    col(fvs.Health, "hp") - ref[f"{p}_hp"][m][None]).max(initial=0.0)))
                errs["act"] = max(errs["act"], float(np.abs(
                    col(fvs.Action, "remaining") - ref[f"{p}_act"][m][None]).max(initial=0.0)))
                errs["pos"] = max(errs["pos"], float(np.abs(
                    col(fvs.Position) - ref[f"{p}_pos"][m][None]).max(initial=0.0)))
    finally:
        for k, v in saved.items():
            setattr(fvs, k, v)
    check(errs["hp"] <= 1e-3 and errs["mp"] <= 1e-3, f"fvs golden hp/mana {errs}")
    check(errs["act"] <= 1e-4 and errs["pos"] <= 1e-5, f"fvs golden action/pos {errs}")
    check(deaths > 0, "fvs golden: no entity died")
    return {"phase": "golden_fvs", "ticks": len(dump) - 1, "worlds": 2, "max_err": errs,
            "dead_at_end": deaths,
            "atol": {"hp": 1e-3, "mp": 1e-3, "act": 1e-4, "pos": 1e-5}}


# -- kernel 4 against its plain version --------------------------------------


def parity_simple_jobs(torch, sj, sk, dev):
    """fused_simple_jobs_step vs its plain version on its cases (the last,
    n0 = 2,048, in the rounds layout); returns (the phase's line, the
    largest float error)."""
    bounds = (sj.BOUNDS_LO, sj.BOUNDS_HI)
    g = torch.Generator(device=dev).manual_seed(1)

    def bodies(W, n0, half):
        pos = (torch.rand((W, n0, 3), generator=g, device=dev) * 2.0 - 1.0) * half
        pos[..., 2] += 5.0
        q = torch.randn((W, n0, 4), generator=g, device=dev)
        return pos, q / q.norm(dim=-1, keepdim=True)

    def numpy_case(arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_simple_jobs_cases as sj_cases
    init = sj.make_executor(sj.SimpleJobsConfig(num_worlds=SJ_WORLDS, num_objects=SJ_OBJECTS,
                                                max_pairs=SJ_K, degree_cap=SJ_D, fused=True),
                            device="cuda").state["user"]
    corner = torch.tensor([[[-99.0, -99.0, -5.0], [-88.0, -77.0, -9.0], [-9.5, -9.5, 0.5]]],
                          device=dev).expand(4, 3, 3).contiguous()
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(4, 3, 4).contiguous()
    cases = {
        "main": (init["translation"], init["rotation"], SJ_K, SJ_D),
        "degree_cap": (*bodies(64, 100, 2.5), 1600, 4),
        "k_truncation": (*bodies(64, 100, 4.0), 128, 32),
        "coincident_corner": (corner, ident, 64, 8),
        "n0_37": (*bodies(64, 37, 4.0), 256, 8),
        # AABBs meeting on closed slabs (the filter's outward rounding and
        # the float32 re-test), and every body past the degree cap, K cut
        "touching_grid": (*numpy_case(sj_cases.touching_grid(4, 5, 5, 4)), SJ_K, SJ_D),
        "dense_cluster": (*numpy_case(sj_cases.dense_cluster(4, 64, SJ_OBJECTS)), SJ_K, SJ_D),
        # past the one-block layout: the rounds layout at 2,048 bodies over
        # the example's bounds (dense: rows past D, slots past K)
        "n0_2048_rounds": (*bodies(8, SJL_OBJECTS, 10.0), SJL_K, SJL_D),
    }
    out, worst = {}, 0.0
    names = ("translation", "lo", "hi", "ab", "normals", "counts", "dropped")
    atol = {"translation": 1e-4, "normals": 1e-5}
    for case, (pos, rot, K, D) in cases.items():
        kw = dict(n0=pos.shape[1], K=K, degree_cap=D, bounds=bounds)
        got = sk.fused_simple_jobs_step(pos, rot, **kw)
        again = sk.fused_simple_jobs_step(pos, rot, **kw)
        want = sk.fused_simple_jobs_step_plain(pos, rot, **kw)
        torch.cuda.synchronize()
        res = {"W": pos.shape[0], "n0": pos.shape[1], "K": K, "D": D,
               "pairs_kept": int(torch.clamp(want[5], max=K).sum()),
               "counts_over_K": int((want[5] > K).sum()), "dropped": int(want[6].sum())}
        if case == "touching_grid":
            touching_world0 = int(want[5][0])
        for name, a, a2, b in zip(names, got, again, want):
            check(bool(torch.equal(a.view(torch.int32), a2.view(torch.int32))),
                  f"simple_jobs {case} {name}: a repeated launch differs")
            if name in atol:
                e = max_err(a, b)
                res[name] = e
                worst = max(worst, e)
                check(e <= atol[name], f"simple_jobs {case} {name} err {e}")
                check(bool(torch.isfinite(a).all()), f"simple_jobs {case} {name} finite")
            else:
                check(bool(torch.equal(a, b)), f"simple_jobs {case} {name} not exact")
        out[case] = res
    check(out["degree_cap"]["dropped"] > 0, "degree-cap case dropped no pair")
    check(out["k_truncation"]["counts_over_K"] > 0, "K-truncation case cut no slot")
    check(out["coincident_corner"]["pairs_kept"] > 0, "coincident case kept no pair")
    check(out["dense_cluster"]["dropped"] > 0 and out["dense_cluster"]["counts_over_K"] > 0,
          "dense-cluster case dropped no pair or cut no slot")
    check(sk.rounds(SJL_OBJECTS) and out["n0_2048_rounds"]["dropped"] > 0,
          "n0 = 2048: not the rounds layout, or no pair dropped")
    tg = cases["touching_grid"][0]
    d = (tg[0, :, None] - tg[0, None]).abs().amax(-1)
    check(touching_world0 == int(((d <= 2.0) & (d > 0)).sum()),
          "touching grid: world 0 lost a tie")
    return {"phase": "parity_simple_jobs", "cases": out, "ints": "exact",
            "lo_hi": "exact", "repeat": "bit-identical", "atol": atol}, worst


# -- rigid-body physics: the fused substep kernel ------------------------------

RB_WORLDS, RB_BODIES = 8192, 64      # rigid_bench defaults
# fp32 operations of the fused substep kernel (each add, sub, mul, div,
# sqrt, min, max and abs; compares and selects not counted), counted from
# csrc/substep_kernels.cu.  The data decides how many of each the call
# needs, so substep_work counts them from the plain version's contacts in
# every substep of the timed call:
#   - each valid candidate slot, its contact test by kind (the box-box SAT
#     over 15 axes; a box against the plane tests its 8 corners);
#   - each touching box pair, the incident-face clip when it keeps two or
#     more live points, else the cheaper edge-edge point;
#   - each pair with a live point (ok and depth > 0), the passes' per-pair
#     work (two world inertia tensors a pass, the drift and friction
#     direction, the velocity deltas), and 15 sums a dynamic side; a pair
#     without a live point needs no pass work;
#   - each live point, both passes' work at it (36 more for the
#     restitution channels when some material bounces);
#   - each pair (i <= j) of a pair's live points, one entry of the velocity
#     pass's system and its share of the closed-form solve;
#   - each dynamic body, the integrate, pose update and velocity recovery.
OPS_TEST = {"box-box": 420, "box-plane": 360, "sphere-box": 100, "sphere-plane": 50,
            "sphere-sphere": 25, "other": 0}
OPS_CLIP_FACE, OPS_CLIP_EDGE = 760, 220
OPS_PAIR, OPS_SIDE_SUM = 385, 15
OPS_POINT, OPS_POINT_BOUNCE = 450, 36
OPS_POINT_PAIR = 24
OPS_BODY = 300
# bytes a call moves: per body row 105 in (pose, velocity, mass, inertia,
# friction, object id, external force and torque, dyn flag) and 132 out
# (pose, velocity and the six stashes); per candidate slot its flag (1) and,
# where the flag is set, its rows (8); per world 20 (h, gravity,
# restitution threshold)
BYTES_BODY, BYTES_WORLD = 237, 20
BYTES_SLOT_FLAG, BYTES_SLOT_ROWS = 1, 8
# the single-substep kernel: per body row 109 in (post-integrate pose and
# velocity, the substep start, mass, inertia, friction, object id, dyn flag)
# and 52 out (pose, velocity); per world 8 (h, restitution threshold); of a
# body's 300 operations it does the pose update and velocity recovery, 100
BYTES_BODY1, BYTES_WORLD1 = 161, 8
OPS_BODY_SOLVE = 100
# the single-substep kernel's node launch (SubstepKernel.step), counted from
# the .cu: per body row 85 in (pose, velocity, object id, response type, row
# mask, external force and torque) and 132 out (pose, velocity and the six
# stashes), per world 20 (h, gravity, restitution threshold); per joint row
# its mask, and per live joint its fields (96 B) and its two handles' entity
# records (24 B).  Of a dynamic body's operations: the integrate (191), the
# pose update and velocity recovery (100), the joint sums' apply (58); a
# live joint's terms and sums (Fixed 725, Hinge 776).
BYTES_BODY_NODE, BYTES_WORLD_NODE = 217, 20
BYTES_JOINT_ROW, BYTES_JOINT_LIVE = 1, 120
OPS_BODY_NODE = 191 + 100 + 58
OPS_JOINT = {0: 725, 1: 776}
SUBSTEP_POSE_KEYS = ("pos", "rot", "prev_pos", "prev_rot", "ps_pos", "ps_rot")


# The general-hull paths' operations (tables that are not all boxes),
# counted from the .cu for a pair of the tables' hulls with nv verts, nf
# faces, ns SAT axes, ne edge directions, nfe full edges and FV corner slots
# a face: a quaternion rotation 30, a world vertex 33 (rotation and
# offset), a dot product 5.  A candidate's test a substep: hull-plane 50 a
# vertex (the vertex, its depth, the deepest-4 insert); sphere-hull 43 a
# face and 10; the SAT both sides' vertices and edge directions, each SAT
# axis's rotation and support (7 a vertex of both sides, 3 more), each
# edge pair's cross axis (20) and support (the first pass only: the second,
# to the first axis within the margin, ends early), the three winning axes
# and the decision (110).  A touching face pair's clip: both faces chosen
# (36 a face of both hulls), both faces' side planes (36 a corner), each
# incident edge clipped (two vertices, 18 a side plane, 51) and each
# reference corner tested and projected (33, 6 a side plane, 31).  An edge
# pair's point: both supporting edges (78 a full edge of each side) and the
# closest point (60).
OPS_QROT, OPS_VERT, OPS_DOT = 30, 33, 5


def contact_ops(tables):
    """(a candidate's test a substep by kind, a face clip, an edge point)
    for ``tables``: the box paths' constants for all-box tables, else the
    general-hull paths' counted for the tables' first hull."""
    if tables.all_box:
        return OPS_TEST, OPS_CLIP_FACE, OPS_CLIP_EDGE
    om = tables.om
    h = int(list(om["prim_type"]).index(1))             # PRIM_HULL
    nv, nf, ns, ne, nfe = (int(om[k][h]) for k in ("num_verts", "num_faces", "num_sat_axes",
                                                   "num_edges", "num_full_edges"))
    FV = tables.FVm
    pen = 2 * nv * (OPS_DOT + 2) + 3
    sat = (2 * nv * OPS_VERT + 2 * ne * OPS_QROT + 2 * ns * (OPS_QROT + pen)
           + ne * ne * (20 + pen) + 110)
    clip = (2 * nf * (OPS_QROT + OPS_DOT + 1) + 2 * FV * (OPS_QROT + OPS_DOT + 1)
            + FV * (2 * OPS_VERT + 18 * FV + 51) + FV * (OPS_VERT + 6 * FV + 31))
    edge = 2 * nfe * (2 * OPS_VERT + 2 * OPS_DOT + 2) + 60
    test = {"box-box": sat, "box-plane": 50 * nv, "sphere-box": 43 * nf + 10,
            "sphere-plane": OPS_TEST["sphere-plane"],
            "sphere-sphere": OPS_TEST["sphere-sphere"], "other": 0}
    return test, clip, edge


def fused_inputs(sim, rb, phys):
    """The fused substep kernel's inputs for a rigid_bench executor's next
    step (its own object manager: the box or the imported prism)."""
    return phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body,
                                                               sim.world_cls.objmgr)


def kind_masks(torch, kw, tables):
    """Valid candidate slots [W, K] by contact kind (the kernel's branch)."""
    prim = torch.as_tensor(tables.om["prim_type"], device=kw["obj"].device)
    ri, rj, valid = kw["rows_i"].long(), kw["rows_j"].long(), kw["kvalid"]
    pa = prim[torch.gather(kw["obj"], 1, ri).long()]
    pb = prim[torch.gather(kw["obj"], 1, rj).long()]
    lo, hi = torch.minimum(pa, pb), torch.maximum(pa, pb)   # 0 sphere, 1 hull, 2 plane
    kinds = {"sphere-sphere": (lo == 0) & (hi == 0), "sphere-box": (lo == 0) & (hi == 1),
             "sphere-plane": (lo == 0) & (hi == 2), "box-box": (lo == 1) & (hi == 1),
             "box-plane": (lo == 1) & (hi == 2)}
    kinds = {k: v & valid for k, v in kinds.items()}
    kinds["other"] = valid & ~torch.stack(list(kinds.values())).any(0)
    return kinds


def pair_kinds(torch, kw, tables):
    """Valid candidate pairs by contact kind."""
    return {k: int(v.sum()) for k, v in kind_masks(torch, kw, tables).items()}


def substep_work(torch, sk, kern, kw):
    """The fp32 operations this call's data needs of the kernel, and what
    they were counted from: the candidates by kind, and summed over the
    substeps of a plain-version run on the same inputs, the pairs with a
    live point, their dynamic sides and live points, the pairs of live
    points within a pair, and the touching box pairs by clip path.  For the
    single-substep kernel (kern a SubstepKernel): its one substep, the
    bodies without the integrate."""
    kinds = kind_masks(torch, kw, kern.tables)
    ri, rj = kw["rows_i"].long(), kw["rows_j"].long()
    dyn = kw["dyn"] if "dyn" in kw else node_dyn(kw)
    dyn_sides = torch.gather(dyn, 1, ri).int() + torch.gather(dyn, 1, rj).int()
    n = dict.fromkeys(("pairs", "dyn_sides", "points", "point_pairs", "face_clips",
                       "edge_points"), 0)

    def observe(c):
        live = c["ok"][:, None, :] & (c["depth"] > 0) & kw["kvalid"][:, None, :]
        pts = live.sum(1)                                           # [W, K]
        touching = pts > 0
        boxes = kinds["box-box"] & c["ok"]
        n["pairs"] += int(touching.sum())
        n["dyn_sides"] += int(dyn_sides[touching].sum())
        n["points"] += int(pts.sum())
        n["point_pairs"] += int((pts * (pts + 1) // 2).sum())
        n["face_clips"] += int((boxes & (pts >= 2)).sum())
        n["edge_points"] += int((boxes & (pts < 2)).sum())

    single = isinstance(kern, sk.SubstepKernel)
    if single and "joints" in kw:
        kern.step_plain(**kw, observe=observe)
    elif single:
        sk.substep_plain(**kw, tables=kern.tables, relaxation=kern.relaxation,
                         speculative=kern.speculative, observe=observe)
    else:
        sk.fused_substep_plain(**kw, tables=kern.tables, num_substeps=kern.num_substeps,
                               relaxation=kern.relaxation, speculative=kern.speculative,
                               observe=observe)
    counts = {k: int(v.sum()) for k, v in kinds.items()}
    S = 1 if single else kern.num_substeps
    per_point = OPS_POINT + (OPS_POINT_BOUNCE if kern.tables.any_restitution else 0)
    per_body = OPS_BODY_NODE if "joints" in kw else OPS_BODY_SOLVE if single else OPS_BODY
    test, clip_face, clip_edge = contact_ops(kern.tables)
    ops = (S * sum(c * test[k] for k, c in counts.items())
           + n["face_clips"] * clip_face + n["edge_points"] * clip_edge
           + n["pairs"] * OPS_PAIR + n["dyn_sides"] * OPS_SIDE_SUM
           + n["points"] * per_point + n["point_pairs"] * OPS_POINT_PAIR
           + S * int(dyn.sum()) * per_body)
    if "joints" in kw:
        live = live_joints(kw)
        n["live_joints"] = int(live.sum())
        ops += sum(OPS_JOINT[t] * int((live & (kw["joints"]["joint_type"] == t)).sum())
                   for t in OPS_JOINT)
    return ops, counts, n


def node_dyn(kw):
    """The dynamic rows of the node launch's inputs (response type 0)."""
    return (kw["resp"] == 0) & kw["mask"]


def live_joints(kw):
    """The node launch's live joints [W, J]: masked in, both handles live
    in the body archetype."""
    from gpu_ecs_madrona_tpu_torch.core.state import entity_rows
    rows = [entity_rows(kw["eid"], kw["joints"][e], kw["arch_index"]) for e in ("e1", "e2")]
    return kw["jmask"] & (rows[0] >= 0) & (rows[1] >= 0)


def substep_bound(kw, ops, single=False):
    W, n = kw["obj"].shape
    K = kw["rows_i"].shape[1]
    # every slot's flag, and the rows of the valid slots only
    slots = W * K * BYTES_SLOT_FLAG + int(kw["kvalid"].sum()) * BYTES_SLOT_ROWS
    if "joints" in kw:
        J = kw["jmask"].shape[1]
        return bound(W * (n * BYTES_BODY_NODE + BYTES_WORLD_NODE + J * BYTES_JOINT_ROW) + slots
                     + int(live_joints(kw).sum()) * BYTES_JOINT_LIVE, ops)
    if single:
        return bound(W * (n * BYTES_BODY1 + BYTES_WORLD1) + slots, ops)
    return bound(W * (n * BYTES_BODY + BYTES_WORLD) + slots, ops)


def substep1_case(torch, sk, kern, kw, exact=False):
    """Single-substep kernel (twice) vs plain (twice) on one input: max
    errors (0 with ``exact``), or raises."""
    got, again = kern(**kw), kern(**kw)
    want, want2 = (sk.substep_plain(**kw, tables=kern.tables, relaxation=kern.relaxation,
                                    speculative=kern.speculative) for _ in range(2))
    torch.cuda.synchronize()
    errs = {}
    for k, g, a in zip(sk.SUBSTEP_KEYS, got, again):
        check(bool(torch.isfinite(g).all()), f"substep1 {k} finite")
        check(torch.equal(g, a), f"substep1 {k}: a repeated launch differs")
        check(torch.equal(want[k], want2[k]), f"substep1 {k}: the plain version does not repeat")
        errs[k] = max_err(g, want[k])
        tol = 0.0 if exact else 1e-4 if k in SUBSTEP_POSE_KEYS else 1e-3
        check(errs[k] <= tol, f"substep1 {k} err {errs[k]}")
    return errs


def node_case(torch, sk, kern, kw, exact=False):
    """Kernel 5's node launch (twice) vs its plain version (twice) on one
    input: max errors (0 with ``exact``), or raises."""
    got, again = kern.step(**kw), kern.step(**kw)
    want, want2 = kern.step_plain(**kw), kern.step_plain(**kw)
    torch.cuda.synchronize()
    errs = {}
    for k in sk.NODE_KEYS:
        check(bool(torch.isfinite(got[k]).all()), f"substep node {k} finite")
        check(torch.equal(got[k], again[k]), f"substep node {k}: a repeated launch differs")
        check(torch.equal(want[k], want2[k]),
              f"substep node {k}: the plain version does not repeat")
        errs[k] = max_err(got[k], want[k])
        tol = 0.0 if exact else 1e-4 if k in SUBSTEP_POSE_KEYS else 1e-3
        check(errs[k] <= tol, f"substep node {k} err {errs[k]}")
    return errs


def substep_case(torch, sk, kern, kw):
    """Kernel (twice) vs plain (twice) on one input: max errors, or raises."""
    got, again = kern(**kw), kern(**kw)
    want, want2 = (sk.fused_substep_plain(**kw, tables=kern.tables,
                                          num_substeps=kern.num_substeps,
                                          relaxation=kern.relaxation,
                                          speculative=kern.speculative) for _ in range(2))
    torch.cuda.synchronize()
    errs = {}
    for k in sk.OUT_KEYS:
        check(bool(torch.isfinite(got[k]).all()), f"substep {k} finite")
        check(torch.equal(got[k], again[k]), f"substep {k}: a repeated launch differs")
        check(torch.equal(want[k], want2[k]), f"substep {k}: the plain version does not repeat")
        errs[k] = max_err(got[k], want[k])
        check(errs[k] <= (1e-4 if k in SUBSTEP_POSE_KEYS else 1e-3), f"substep {k} err {errs[k]}")
    return errs


def window_case(torch, sk, kern, kw, plain_worlds=None):
    """The fused kernel at a shape past one block's shared memory (its
    windowed layout, or past its body ceiling the bodies in a global
    scratch too), twice on every world, against its plain version on the
    first ``plain_worlds`` (WINDOW_PARITY_WORLDS) worlds, bit for bit: its
    line (the window, the valid slots, the specialisation launched, the
    errors), or raises."""
    plain_worlds = plain_worlds or WINDOW_PARITY_WORLDS
    W, n = kw["obj"].shape
    K = kw["rows_i"].shape[1]
    refresh = kern.contact_refresh
    check(sk.windowed(kern.tables, n, K, cache=refresh), f"n={n}, K={K} is not windowed")
    bodies = sk.fused_bodies(kern.tables, n, K, cache=refresh)
    sk.FusedSubstepKernel.launches_by_options.clear()
    got, again = kern(**kw), kern(**kw)
    launched = dict(sk.FusedSubstepKernel.launches_by_options)
    window = sk.fused_layout_window(kern.tables, n, K, refresh)
    valid = kw["kvalid"].sum(1)
    check(int(valid.max()) > window,
          f"windowed n={n} K={K}: no world's valid slots ({int(valid.max())}) pass the "
          f"window ({window})")
    want = kern.plain(**next(world_chunks(kw, plain_worlds)))
    torch.cuda.synchronize()
    errs = {}
    for k in sk.OUT_KEYS:
        check(bool(torch.isfinite(got[k]).all()), f"windowed {k} finite")
        check(torch.equal(got[k], again[k]), f"windowed {k}: a repeated launch differs")
        errs[k] = max_err(got[k][:plain_worlds], want[k])
        check(errs[k] == 0.0, f"windowed n={n} K={K} {k}: {errs[k]} from the plain version")
    (name, count), = launched.items()
    check(count == 2 and "win" in name and ("bodies" in name) == bodies,
          f"windowed launches {launched}")
    return {"W": W, "n": n, "K": K, "specialisation": name, "window": window,
            "valid_slots_a_world": {"mean": float(valid.double().mean()),
                                    "max": int(valid.max()),
                                    "worlds_past_the_window": int((valid > window).sum())},
            "plain_worlds": plain_worlds, "max_err": errs}


def parity_window(torch, rb, phys, sk):
    """parity_substep's windowed shapes (WINDOW_CASES): rigid_bench at 8192
    worlds x 239, 255 and 511 bodies after 3 steps, contact refresh at 200
    and 255 bodies, the imported-prism pile at 255 bodies (all but 511
    spawned in WINDOW_SPAWN); each window_case.  Returns ({case: line}, the
    worst error)."""
    hs = hull_scenes()
    cases, states = {}, {}
    for name, (bodies, refresh, prisms, crowd) in WINDOW_CASES.items():
        spawn = WINDOW_SPAWN if crowd else {}
        key = (bodies, prisms, crowd)
        if key in states:
            sim = states[key]
        elif prisms:
            sim = hull_sim(rb, hs, steps=3, num_bodies=bodies, **spawn)
        else:
            sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=RB_WORLDS, num_bodies=bodies,
                                                       contact_mode="pallas", **spawn),
                                   device="cuda")
            sim.run(3)
        states = {key: sim}
        kern = sk.FusedSubstepKernel(sim.world_cls.objmgr, 4, relaxation=0.7,
                                     contact_refresh=refresh)
        cases[name] = window_case(torch, sk, kern, fused_inputs(sim, rb, phys))
    del states
    return cases, max(max(c["max_err"].values()) for c in cases.values())


# parity_substep's all-box tables wider than a box's 8 verts a hull: padded
# to 9 and 32 verts (bit for bit the box table), and the first box with 12
# and 20 live verts (its corners and edge midpoints: more live hull-plane
# candidates than 8 and than pairs.py's 12)
WIDE_BOX_TABLES = (9, 32, "12 live", "20 live")


def wide_box_table(om, table):
    hs = hull_scenes()
    if isinstance(table, int):
        return hs.padded_verts(om, table)
    return hs.live_vert_box(om, int(table.split()[0]))


def box_plane_slots(torch, tables, kw):
    """Valid candidate slots of kw that pair the first box with a plane."""
    import numpy as np
    o = int(np.flatnonzero(tables.om["prim_type"] == 1)[0])
    obj = kw["obj"].long()
    oi = torch.gather(obj, 1, kw["rows_i"].long())
    oj = torch.gather(obj, 1, kw["rows_j"].long())
    plane = torch.as_tensor(tables.om["prim_type"] == 2, device=obj.device)
    return int((kw["kvalid"].bool() & (((oi == o) & plane[oj]) | ((oj == o) & plane[oi])))
               .sum())


def wide_box_cases(torch, rb, sk, phys, joint_scenes, kw):
    """The wide all-box tables (WIDE_BOX_TABLES): the fused kernel without
    and with contact refresh at the K = 256 state ``kw``, and kernel 5's
    node on the joint world after 30 steps (its free box on the plane,
    tilted 40 degrees about x and sunk to z = 0.25, so that edge midpoints
    are among its deepest 4 and below the plane), each launched twice, bit
    for bit their plain versions; the padded tables also bit for bit the
    box table's launch, the live ones not (their extra verts count).  The
    first box meets the plane in valid slots of both inputs.  Returns {case:
    line}; "wide_box_vm32_K256" also holds the launch's ms beside the box
    table's (20 calls each)."""
    import copy
    import math
    cases = {}
    om = rb.RigidBenchWorld.objmgr
    check(box_plane_slots(torch, sk.pk.ObjTables(om), kw) > 0, "wide box: no box-plane slot")
    jsim = joint_scenes.joint_world("pallas", num_worlds=256, device="cuda")
    jsim.run(30)
    kern5 = phys.RigidBodyPhysicsSystem.substep_kernel(jsim)
    jkw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(jsim, None, None, node=True)
    del jsim
    jkw["pos"], jkw["rot"] = jkw["pos"].clone(), jkw["rot"].clone()
    jkw["pos"][:, 5, 2] = 0.25
    jkw["rot"][:, 5] = torch.tensor([math.cos(math.radians(20)), math.sin(math.radians(20)),
                                     0.0, 0.0])
    check(box_plane_slots(torch, kern5.tables, jkw) == 256,
          "wide box node: the free box does not meet the plane in every world")
    own5 = kern5.step(**jkw)
    for table in WIDE_BOX_TABLES:
        tag = f"vm{table}" if isinstance(table, int) else table.replace(" ", "_")
        padded = isinstance(table, int)
        wide_om = wide_box_table(om, table)
        for refresh in (False, True):
            box = sk.FusedSubstepKernel(om, 4, relaxation=0.7, contact_refresh=refresh)
            wide = sk.FusedSubstepKernel(wide_om, 4, relaxation=0.7, contact_refresh=refresh)
            check(sk.wide_box(wide.tables), f"wide box {table}: not a wide all-box table")
            got, again, own = wide(**kw), wide(**kw), box(**kw)
            want = wide.plain(**kw)
            torch.cuda.synchronize()
            errs = {}
            for k in sk.OUT_KEYS:
                check(torch.equal(got[k], again[k]), f"wide box {table} {k}: a repeat differs")
                check(torch.equal(got[k], own[k]) or not padded,
                      f"wide box {table} {k}: differs from the box table's launch")
                errs[k] = max_err(got[k], want[k])
                check(errs[k] == 0.0, f"wide box {table} {k}: {errs[k]} from the plain version")
            name = f"wide_box_{tag}_K256" + ("_refresh" if refresh else "")
            cases[name] = {"W": kw["obj"].shape[0], "K": kw["rows_i"].shape[1],
                           "Vm": wide.tables.Vm, "max_err": errs,
                           "equals_box_table": all(torch.equal(got[k], own[k])
                                                   for k in sk.OUT_KEYS)}
            if table == 32 and not refresh:
                cases[name].update(ms=cuda_ms(torch, lambda: wide(**kw), 20),
                                   box_table_ms=cuda_ms(torch, lambda: box(**kw), 20))
        wide5 = copy.copy(kern5)
        wide5.tables = sk.pk.ObjTables(wide_box_table(kern5.tables.om, table))
        errs = node_case(torch, sk, wide5, jkw, exact=True)
        got = wide5.step(**jkw)
        torch.cuda.synchronize()
        same = all(torch.equal(got[k], own5[k]) for k in sk.NODE_KEYS)
        check(same == padded, f"wide box node {table}: the box table's launch "
              + ("differs" if padded else "is the same: the live verts went unread"))
        cases[f"wide_box_{tag}_substep_node_joint_world"] = {
            "kernel": "substep", "Vm": wide5.tables.Vm, "max_err": errs,
            "equals_box_table": same}
    return cases


def parity_substep(torch, rb, phys, sk, sap_sim):
    """fused_substep vs its plain version: the main path's shapes after 3
    steps at K = 256 and 128, the initial uniform spawn, tables without
    restitution, a golden scene, and the sap broadphase's candidates and
    order at 8192 x 201 rows, K = 800 (``sap_sim``, parity_sap's executor);
    the single-substep kernel on the first substep of the K = 256 state,
    and its node launch on a joint world and on simple_taskgraph's state
    with random joints.  Returns (the phase's line, the worst error of each
    kernel)."""
    import numpy as np
    cases, worst = {}, 0.0
    for K in (256, 128):
        sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=RB_WORLDS, contact_mode="pallas",
                                                   max_candidates=K), device="cuda")
        if K == 256:
            spawn = fused_inputs(sim, rb, phys)
        sim.run(3)
        kw = fused_inputs(sim, rb, phys)
        kw256 = kw if K == 256 else kw256
        kern = sk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
        errs = substep_case(torch, sk, kern, kw)
        cases[f"main_K{K}"] = {"W": RB_WORLDS, "n": RB_BODIES + 1, "K": K,
                               "pairs": pair_kinds(torch, kw, kern.tables), "max_err": errs}
        if K == 256:
            single = sk.SubstepKernel(rb.RigidBenchWorld.objmgr, relaxation=0.7)
            kw1 = phys.RigidBodyPhysicsSystem.substep_kernel_inputs(kw)
            cases["single_substep_main_K256"] = {
                "kernel": "substep", "max_err": substep1_case(torch, sk, single, kw1)}
        del sim
    kern = sk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
    cases["initial_spawn"] = {"pairs": pair_kinds(torch, spawn, kern.tables),
                              "max_err": substep_case(torch, sk, kern, spawn)}
    om = dict(rb.RigidBenchWorld.objmgr)
    om["restitution"] = np.zeros_like(om["restitution"])
    quiet = sk.FusedSubstepKernel(om, 4, relaxation=0.7)
    check(not quiet.tables.any_restitution, "zero-restitution tables")
    cases["no_restitution"] = {"max_err": substep_case(torch, sk, quiet, kw)}
    gold = golden_sim(torch, phys, "cube_stack_ss1", "pallas")[0]
    gkw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(gold, gold.world_cls.Body,
                                                              gold.world_cls.objmgr)
    gkern = sk.FusedSubstepKernel(gold.world_cls.objmgr, 1)
    cases["golden_cube_stack_ss1"] = {"pairs": int(gkw["kvalid"].sum()),
                                      "max_err": substep_case(torch, sk, gkern, gkw)}
    # kernel 7 on the sap broadphase's candidates, in its order
    skw = fused_inputs(sap_sim, rb, phys)
    check(skw["rows_i"].shape[1] == SAP_K, f"sap K {skw['rows_i'].shape}")
    cases["sap_n201_K800"] = {"W": RB_WORLDS, "n": SAP_BODIES + 1, "K": SAP_K,
                              "pairs": pair_kinds(torch, skw, kern.tables),
                              "max_err": substep_case(torch, sk, kern, skw)}
    del skw
    # kernel 5's node launch on a world with live Fixed and Hinge joints
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_joint_scenes as joint_scenes
    jsim = joint_scenes.joint_world("pallas", num_worlds=256, device="cuda")
    jsim.run(5)
    jkw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(jsim, None, None, node=True)
    live = int(live_joints(jkw).sum())
    check(live == 2 * 256, f"joint world: {live} live joints, not two a world")
    cases["substep_node_joint_world"] = {
        "kernel": "substep", "W": 256, "live_joints": live,
        "max_err": node_case(torch, sk, phys.RigidBodyPhysicsSystem.substep_kernel(jsim), jkw)}
    # all-box tables past a box's 8 verts a hull, through the fused kernel
    # and kernel 5's node
    cases.update(wide_box_cases(torch, rb, sk, phys, joint_scenes, kw256))
    del kw256
    # and on simple_taskgraph's state with random live joints (several on
    # one body and side, a null handle, a handle into another archetype)
    from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
    rsim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=16, num_objects=STG_OBJECTS,
                                                       seed=3), device="cuda")
    rsim.run(3)
    rkw = joint_scenes.random_joints(rsim, phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(
        rsim, stg.Sphere, None, node=True), num_spheres=STG_OBJECTS)
    live = int(live_joints(rkw).sum())
    check(live > 0, "random joints: none live")
    cases["substep_node_random_joints"] = {
        "kernel": "substep", "W": 16, "live_joints": live,
        "max_err": node_case(torch, sk, phys.RigidBodyPhysicsSystem.substep_kernel(rsim), rkw)}
    # kernel 7 past one block's shared memory, bit for bit; and kernels 5
    # and 7 past their body ceilings (the bodies in a global scratch)
    windowed, worst_window = parity_window(torch, rb, phys, sk)
    cases.update({f"windowed_{k}": v for k, v in windowed.items()})
    bodies, _ = parity_bodies(torch, rb, phys, sk)
    cases.update(bodies)
    worst_window = max([worst_window] + [max(c["max_err"].values()) for c in bodies.values()
                                         if "kernel" not in c])
    for c in cases.values():
        if "kernel" not in c:
            worst = max(worst, max(c["max_err"].values()))
    worst1 = max(max(c["max_err"].values()) for c in cases.values() if "kernel" in c)
    return {"phase": "parity_substep", "cases": cases, "repeat": "bit-identical (kernel and plain)",
            "atol": {"pose_and_stashes": 1e-4, "velocities": 1e-3, "windowed": 0.0,
                     "bodies_in_scratch": 0.0}}, worst, worst1, worst_window


def load_physics_golden(np, name):
    with open(os.path.join(HERE, "tests", "goldens", name + ".bin"), "rb") as f:
        d = f.read()
    check(d[:4] == b"GLD1", "physics golden magic")
    T1, W, K, ss = struct.unpack("<4i", d[4:20])
    dt = struct.unpack("<f", d[20:24])[0]
    return np.frombuffer(d[24:], np.float32).reshape(T1, W, K, 13).copy(), W, K, ss, dt


def golden_sim(torch, phys, name, mode, joint=False, device="cuda"):
    """The golden's scene (plane row 0, its cubes after) on ``device``, from
    its tick 0, with ``joint`` cube_chain's Fixed joint between its two
    cubes (the reference's setupFixed(a, b, id, id, (0, 0, -0.6), (0, 0,
    0.6), 0), as tests/test_torch_physics_golden.py builds it); returns
    (executor, golden, K)."""
    import numpy as np
    from gpu_ecs_madrona_tpu_torch.core import base
    from gpu_ecs_madrona_tpu_torch.core.component import Archetype
    from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
    from gpu_ecs_madrona_tpu_torch.physics import components as pc
    golden, W, K, ss, dt = load_physics_golden(np, name)
    loader = phys.assets.PhysicsLoader()
    loader.load_objects([phys.assets.make_plane(mu_s=0.5, mu_d=0.5),
                         phys.assets.make_box((0.5, 0.5, 0.5), inv_mass=1.0, mu_s=0.5,
                                              mu_d=0.5)])
    mgr = loader.get_object_manager()
    init0 = golden[0]

    class World:
        Body = Archetype("GoldenBody", phys.BODY_COMPONENTS)
        objmgr = mgr

        @classmethod
        def register_types(cls, r):
            phys.RigidBodyPhysicsSystem.register_types(r, max_candidates=64, max_contacts=64,
                                                       max_joints=4 if joint else 0)
            r.register_archetype(cls.Body, capacity=K + 1)
            r.export_column(cls.Body, base.Position, 0)
            r.export_column(cls.Body, base.Rotation, 1)
            r.export_column(cls.Body, pc.Velocity, 2)

        @classmethod
        def init(cls, ctx, init_data=None):
            dev = ctx.device
            phys.RigidBodyPhysicsSystem.init(ctx, delta_t=dt, num_substeps=ss)
            pos = np.zeros((W, K + 1, 3), np.float32)
            rot = np.zeros((W, K + 1, 4), np.float32)
            rot[..., 0] = 1.0
            vel = np.zeros((W, K + 1, 3), np.float32)
            omega = np.zeros((W, K + 1, 3), np.float32)
            pos[:, 1:], rot[:, 1:] = init0[..., 0:3], init0[..., 3:7]
            vel[:, 1:], omega[:, 1:] = init0[..., 7:10], init0[..., 10:13]
            oid = np.ones((W, K + 1), np.int32)
            oid[:, 0] = 0
            resp = np.full((W, K + 1), pc.RESPONSE_DYNAMIC, np.int32)
            resp[:, 0] = pc.RESPONSE_STATIC

            def t(a):
                return torch.from_numpy(a).to(dev)
            ents = ctx.make_entities(cls.Body, counts=K + 1, max_new=K + 1, values={
                base.Position: t(pos), base.Rotation: t(rot),
                base.Scale: torch.ones((W, K + 1, 3), device=dev), base.ObjectID: t(oid),
                pc.Velocity: {"linear": t(vel), "angular": t(omega)},
                pc.ResponseType: t(resp)})
            if joint:
                def vec(x):
                    return torch.tensor(x, device=dev).expand(W, 1, len(x))
                ident = vec([1.0, 0.0, 0.0, 0.0])
                phys.make_fixed_joint(ctx, ents[:, 1:2], ents[:, 2:3], ident, ident,
                                      vec([0.0, 0.0, -0.6]), vec([0.0, 0.0, 0.6]),
                                      torch.zeros((W, 1), device=dev))

        @classmethod
        def setup_tasks(cls, builder):
            bp = phys.RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], cls.Body, mgr)
            sub = phys.RigidBodyPhysicsSystem.setup_substep_tasks(builder, [bp], ss, cls.Body,
                                                                  mgr, contact_mode=mode)
            phys.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [sub])

    sim = TaskGraphExecutor(World, ExecutorConfig(num_worlds=W, max_entities_per_world=K + 8,
                                                  seed=0, device=device))
    return sim, golden, K


def joints_cube_chain(torch, phys, sk):
    """The reference's joint golden, cube_chain_ss4, in the kernel mode:
    kernel 5's node launch on the card and its plain version on the CPU,
    tick by tick from the golden's tick 0.  Both solve the joint after the
    velocity pass, as the JAX package's kernel mode does, and both miss the
    golden's early gate (0.02 over the first 10 ticks) by the same ~0.048
    as JAX (tests/test_torch_joint_golden.py holds the CPU route to JAX's
    trajectory, atol 1e-5); the golden's other gates hold.  Returns (the
    phase's line, the card's trajectory [ticks + 1, W, K, 3])."""
    import numpy as np
    err, final, chains = {}, {}, {}
    for dev in ("cuda", "cpu"):
        sk.SubstepKernel.launches = 0
        sim, golden, K = golden_sim(torch, phys, "cube_chain_ss4", "pallas", joint=True,
                                    device=dev)
        T = golden.shape[0] - 1
        mine = np.zeros(golden.shape[:-1] + (3,), np.float32)
        mine[0] = golden[0, ..., 0:3]
        for t in range(1, T + 1):
            sim.step()
            mine[t] = sim.get_exported(0)[0][:, 1:].cpu().numpy()
        check(sk.SubstepKernel.launches == (4 * T if dev == "cuda" else 0),
              f"cube_chain_ss4 {dev} launches {sk.SubstepKernel.launches}")
        check(bool(np.isfinite(mine).all()), f"cube_chain_ss4 {dev} finite")
        err[dev] = np.abs(mine - golden[..., 0:3]).max(axis=(1, 2, 3))
        final[dev] = mine[-1]
        chains[dev] = mine
    res = {dev: {"early_gate_max": float(e[:10].max()), "horizon": float(e.max()),
                 "final_z_max": float(final[dev][..., 2].max())} for dev, e in err.items()}
    early = [res[d]["early_gate_max"] for d in ("cuda", "cpu")]
    check(min(early) > 0.02, f"cube_chain_ss4: the known early-gate miss {early}")
    check(abs(early[0] - early[1]) <= 1e-5, f"cube_chain_ss4: the card's miss {early}")
    check(max(r["horizon"] for r in res.values()) <= 1.5, "cube_chain_ss4 horizon")
    check(max(r["final_z_max"] for r in res.values()) < 2.0, "cube_chain_ss4 final z")
    ticks = int(len(err["cuda"]) - 1)
    return {"phase": "joints_cube_chain", "ticks": ticks, "launches": 4 * ticks, **res,
            "early_gate_card_minus_cpu": early[0] - early[1],
            "gates": {"early_gate_miss": "> 0.02 on both, equal within 1e-5",
                      "horizon": 1.5, "final_z": 2.0}}, chains["cuda"]


def golden_physics(torch, phys, sk):
    """The four 1-substep physics goldens and the free-fall check on the
    card, both contact modes, with tests/test_reference_golden.py's gates."""
    import numpy as np
    out = {}
    for mode in ("pallas", "pairs"):
        for name in ("cubes_fall_ss1", "cube_pair_ss1", "cube_stack_ss1", "cube_bounce_ss1"):
            sk.FusedSubstepKernel.launches = 0
            sim, golden, K = golden_sim(torch, phys, name, mode)
            T = golden.shape[0] - 1
            mine = np.zeros_like(golden)
            mine[0] = golden[0]
            for t in range(1, T + 1):
                sim.step()
                vel = sim.get_exported(2)[0]
                mine[t] = np.concatenate([sim.get_exported(0)[0][:, 1:].cpu().numpy(),
                                          sim.get_exported(1)[0][:, 1:].cpu().numpy(),
                                          vel["linear"][:, 1:].cpu().numpy(),
                                          vel["angular"][:, 1:].cpu().numpy()], axis=-1)
            check(sk.FusedSubstepKernel.launches == (T if mode == "pallas" else 0),
                  f"golden {name} {mode} launches {sk.FusedSubstepKernel.launches}")
            perr = np.abs(mine[..., 0:3] - golden[..., 0:3]).max(axis=(1, 2, 3))
            zmin = golden[..., 2].min(axis=(1, 2))
            fc = int(np.argmax(zmin < 0.52)) if (zmin < 0.52).any() else T + 1
            res = {"ticks": T, "free_flight": float(perr[:fc].max()) if fc > 1 else None,
                   "early_contact": float(perr[:min(fc + 10, T)].max()),
                   "horizon": float(perr.max())}
            check(fc <= 1 or res["free_flight"] <= 1e-5, f"golden {name} {mode} free flight")
            check(res["early_contact"] <= 0.06, f"golden {name} {mode} early contact")
            check(res["horizon"] <= (2.5 if name.startswith("cube_stack") else 1.2),
                  f"golden {name} {mode} horizon")
            check(bool(np.isfinite(mine).all()), f"golden {name} {mode} finite")
            if name.startswith("cube_bounce"):
                res["bounce_peak"] = float(np.abs(golden[fc:, ..., 2].max(axis=0)
                                                  - mine[fc:, ..., 2].max(axis=0)).max())
                check(res["bounce_peak"] <= 0.08, f"golden {name} {mode} bounce peak")
            if name.startswith("cubes_fall"):
                m_final, g_final = mine[-1, ..., 2], golden[-1, ..., 2]
                check(bool((m_final > 0.3).all() and (m_final < 4.0).all()),
                      f"golden {name} {mode} rest")
                res["rest"] = float(np.abs(np.sort(m_final, axis=None)
                                           - np.sort(g_final, axis=None)).max())
                check(res["rest"] <= 0.6, f"golden {name} {mode} rest state")
                res["free_fall_all_channels"] = float(np.abs(mine[:fc - 1]
                                                             - golden[:fc - 1]).max())
                check(fc >= 15 and res["free_fall_all_channels"] <= 1e-5,
                      f"golden free fall {mode}")
            out[f"{name}_{mode}"] = res
    return {"phase": "golden_physics", "cases": out,
            "gates": {"free_flight": 1e-5, "early_contact": 0.06, "horizon": "1.2 (stack 2.5)",
                      "bounce_peak": 0.08, "rest": 0.6}}


def main_rigid(torch, rb, phys, cfg, steps, count, card, reset_counts, read_counts,
               specialisation="none", settle=3, also=(), bodies=RB_BODIES, make=None,
               probe=None, worlds=RB_WORLDS):
    """rigid_bench at ``worlds`` (8192) x ``bodies`` (64) in configuration ``cfg``
    (RigidBenchConfig keywords): ``settle`` untimed steps, then ``count``
    windows of ``steps`` steps; launches = steps, all of the kernel
    specialisation ``specialisation`` (kernel mode) or 0, launches = steps
    of the kernels named in ``also`` (the world flags and the asleep
    worlds' kernel), no other kernel launched, finite positions, empty
    temporaries; the peak of allocated device memory over the windows.
    ``make(config, device)``: the executor's maker (default
    rb.make_executor; the hull pile's tests/test_torch_hull_scenes.py
    hull_pile).  ``probe(sim)``, called after the settle steps (its steps
    untimed and not counted), goes into the line as "probe".  The kernel
    runs where the executor's graph holds the fused node."""
    make = make or rb.make_executor
    sim = make(rb.RigidBenchConfig(num_worlds=worlds, num_bodies=bodies, **cfg),
               device="cuda")
    sim.run(settle)
    probed = probe(sim) if probe else None
    sim.block_until_ready()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wins = []
    for _ in range(count):
        wins += windows(sim, steps, 1)
        for arch in (phys.CandidateTemporary, phys.CandidateRowsTemporary,
                     phys.ContactTemporary, phys.CollisionEventTemporary):
            check(int(sim.mgr.num_rows(sim.state, arch).sum()) == 0,
                  f"{arch.name} not empty after a step")
    launches = read_counts()
    by_options = dict(phys.subk.FusedSubstepKernel.launches_by_options)
    kernel_mode = phys.FUSED_NODE in sim.graph.node_names
    want = {name: 0 for name in launches}
    want["fused_substep"] = steps * count if kernel_mode else 0
    want.update({name: steps * count for name in also})
    check(launches == want, f"rigid_bench {cfg} launches {launches}")
    check(by_options == ({specialisation: steps * count} if kernel_mode else {}),
          f"rigid_bench {cfg} launches by specialisation {by_options}")
    pos, mask = sim.get_exported(0)
    check(bool(torch.isfinite(pos[mask]).all()), f"finite positions (rigid_bench {cfg})")
    overflow = {k: int(v.sum()) for k, v in sim.overflow_counters().items()}
    return sim, {"worlds": worlds, "bodies": bodies, "config": cfg,
                 "settle_steps": settle, "launches": launches,
                 "launches_by_specialisation": by_options, "overflow_sum": overflow,
                 "env_steps_per_s": rates(steps, wins, worlds),
                 "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "card": card, **({"probe": probed} if probe else {})}


# -- the sap broadphase and the dense contact mode -----------------------------

SAP_BODIES, SAP_K = 200, 800      # 201 rows: "auto" takes sap; K = 4 x bodies
DENSE_BODIES = 32                 # 33 rows: "auto" takes the dense contact mode
DENSE_PARITY_WORLDS = 256
# kernel 7 past one block's shared memory (the windowed layout): the
# main_rigid_sap_large pile (256 rows, K = 1020; "auto" takes the kernel and
# sap) and parity_substep's windowed shapes, (bodies, contact refresh,
# imported prisms, spawned in WINDOW_SPAWN), each held bit for bit to its
# plain version on its first WINDOW_PARITY_WORLDS worlds.  WINDOW_SPAWN drops
# the bodies closer together than rigid_bench's default (8, 12), so that a
# world's valid slots pass the window and the global scratch runs (at 511
# bodies the default spawn already passes it)
LARGE_SAP_BODIES, LARGE_SAP_K = 255, 1020
WINDOW_PARITY_WORLDS = 128
WINDOW_SPAWN = dict(spawn_xy=6.0, spawn_h=9.0)
WINDOW_CASES = {"n240": (239, False, False, True), "n256": (255, False, False, True),
                "n256_refresh": (255, True, False, True), "n512": (511, False, False, False),
                "n201_refresh": (200, True, False, True),
                "n256_prisms": (255, False, True, True)}


def node_fn(sim, name):
    return next(nd for nd in sim.graph.nodes if nd.name == name).run


def parity_sap(torch, rb, phys):
    """The sap node on the card against the same node on the CPU from one
    state: rigid_bench at 8192 worlds x 201 rows after 3 steps on the card
    (its AABBs made on the card), and that state with its bodies on an
    unrotated grid of boxes (ties in the globals' top-k and in the sort);
    rows, handles, masks and overflow exact.  Returns (the phase's line,
    the card's executor after its 3 steps)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_sap_cases as sap_cases
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy
    cfg = rb.RigidBenchConfig(num_worlds=RB_WORLDS, num_bodies=SAP_BODIES, contact_mode="pallas")
    gpu = rb.make_executor(cfg, device="cuda")
    check(node_fn(gpu, "bp_find_overlaps").__name__ == "find_overlaps_sap",
          "auto above 192 rows takes sap")
    gpu.run(3)
    cpu = rb.make_executor(cfg, device="cpu")
    cases = {}
    after = sap_cases.aabb_state(gpu)
    for name, state in (("after_3_steps", after),
                        ("tie_grid", sap_cases.aabb_state(
                            gpu, sap_cases.set_grid(state_to_numpy(gpu.state))))):
        t0 = time.perf_counter()
        a = sap_cases.sap_outputs(cpu, state)
        cpu_s = time.perf_counter() - t0
        b = sap_cases.sap_outputs(gpu, state)
        diff = sap_cases.differing(a, b)
        cases[name] = {"candidates": int(a["rows"]["mask"].sum()),
                       "overflow_sum": int(a["overflow"].sum()), "differing": diff,
                       "cpu_node_s": cpu_s}
        check(diff == 0, f"sap on the card vs the CPU ({name}): {diff} entries differ")
        check(cases[name]["candidates"] > RB_WORLDS, f"sap {name}: few candidates")
    del cpu
    # the node's device time at the state after 3 steps
    ctx_state = gpu.state
    find = node_fn(gpu, "bp_find_overlaps")
    update = node_fn(gpu, "bp_update_aabbs")
    ms = cuda_ms(torch, lambda: find(Context(gpu.mgr, ctx_state)), 20)
    ms_update = cuda_ms(torch, lambda: update(Context(gpu.mgr, ctx_state)), 20)
    return {"phase": "parity_sap", "W": RB_WORLDS, "n": SAP_BODIES + 1, "K": SAP_K,
            "window": min(64, SAP_BODIES), "cases": cases, "ints": "exact",
            "sap_node_ms": ms, "update_aabbs_ms": ms_update}, gpu


def sap_saturation(torch, rb, sim, S=64, G=4):
    """The sap broadphase's window saturation on sim's current AABB columns
    (the last step's), recounted here from its definition: the live
    non-global rows sorted by lower x whose first row past the window of S
    still starts before their x interval ends; summed over the worlds."""
    from gpu_ecs_madrona_tpu_torch.physics.components import CollisionAABB
    box = sim.mgr.column(sim.state, rb.Body, CollisionAABB)
    mask = sim.mgr.row_mask(sim.state, rb.Body)
    lo, hi = box["lo"][..., 0], box["hi"][..., 0]
    m = lo.shape[1] - S - 1
    if m <= 0:
        return 0
    extent = torch.where(mask, hi - lo, -float("inf"))
    grow = torch.sort(extent, dim=1, descending=True, stable=True).indices[:, :G]
    live = mask & ~torch.zeros_like(mask).scatter_(1, grow, True)
    order = torch.sort(torch.where(live, lo, float("inf")), dim=1, stable=True).indices
    lo_s, hi_s = torch.gather(lo, 1, order), torch.gather(hi, 1, order)
    live_s = torch.gather(live, 1, order)
    sat = live_s[:, :m] & live_s[:, S + 1:] & (lo_s[:, S + 1:] <= hi_s[:, :m])
    return int(sat.sum())


def parity_dense(torch, rb, phys, subk):
    """One dense-mode step on the card against the same step on the CPU
    from one state: rigid_bench at 256 worlds x 33 rows ("auto" takes the
    dense contact mode) after 90 steps on the card (the pile has landed);
    poses atol 1e-4, velocities 1e-3, the step repeated on the card from
    that state bit-identical, no kernel launched."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_sap_cases as sap_cases
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
    cfg = rb.RigidBenchConfig(num_worlds=DENSE_PARITY_WORLDS, num_bodies=DENSE_BODIES,
                              contact_mode="auto")
    gpu = rb.make_executor(cfg, device="cuda")
    check(phys.FUSED_NODE not in gpu.graph.node_names
          and hasattr(node_fn(gpu, "physics_substep_0"), "world_block"),
          "auto at 33 rows takes the dense contact mode")
    gpu.run(90)
    start = state_to_numpy(gpu.state)
    # the contacts of the compared step's last substep (on a copy)
    ctx = Context(gpu.mgr, gpu.state)
    for nd in gpu.graph.nodes:
        if nd.name.startswith("clear_"):
            break
        nd.run(ctx)
    contacts = int(ctx.row_mask(phys.ContactTemporary).sum())
    cpu = rb.make_executor(cfg, device="cpu")
    cpu.state = state_from_numpy(start, "cpu")
    launches = subk.FusedSubstepKernel.launches + subk.SubstepKernel.launches
    gpu.step()
    first = state_to_numpy(gpu.state)
    gpu.state = state_from_numpy(start, "cuda")
    gpu.step()
    again = state_to_numpy(gpu.state)
    check(subk.FusedSubstepKernel.launches + subk.SubstepKernel.launches == launches,
          "a dense step launches no kernel")
    t0 = time.perf_counter()
    cpu.step()
    cpu_s = time.perf_counter() - t0
    want = state_to_numpy(cpu.state)["arch"][rb.Body.name]["comps"]
    got = first["arch"][rb.Body.name]["comps"]
    errs = {}
    for comp, tol in (("Position", 1e-4), ("Rotation", 1e-4), ("Velocity", 1e-3)):
        for f in want[comp]:
            errs[f"{comp}.{f}"] = float(abs(got[comp][f] - want[comp][f]).max())
            check(errs[f"{comp}.{f}"] <= tol, f"dense step {comp}.{f} vs the CPU {errs}")
    same = all(bool((x == y).all()) for x, y in zip(sap_cases.leaves(first),
                                                      sap_cases.leaves(again)))
    check(same, "a repeated dense step on the card differs")
    return {"phase": "parity_dense", "W": DENSE_PARITY_WORLDS, "n": DENSE_BODIES + 1,
            "settle_steps": 90, "contacts_last_substep": contacts, "max_err": errs,
            "atol": {"poses": 1e-4, "velocities": 1e-3}, "repeat": "bit-identical",
            "cpu_step_s": cpu_s}


# -- the fused kernel's options: TPU kernels 8 and 9 --------------------------

# fp32 operations of the options (counted from csrc/substep_kernels.cu as
# above): a slot's cached manifold moved with its bodies (two rotations and
# a divergence a point, the normal rotated) 354, its manifold put in body
# frames 294; the broadphase's AABB of a body 115, a pair's overlap test 6
OPS_REFRESH, OPS_CACHE = 354, 294
OPS_BP_BODY, OPS_BP_PAIR = 115, 6
# bytes a call moves with the in-kernel broadphase: per body row 118 in (the
# fused kernel's 105, scale, live flag) and 156 out (its 132 and the AABB);
# per slot 9 out (rows, flag); per world 32 (its 20, dtv, count, dropped).
# With persistent manifolds also the AABB columns in (24 a row), the cache
# in and out (2 x 36 x 4 a slot) and the stable and active flags
BYTES_BODY_BP, BYTES_SLOT_BP, BYTES_WORLD_BP = 274, 9, 32
BYTES_BODY_P, BYTES_SLOT_P, BYTES_WORLD_P = 298, 297, 34
INT_KEYS = ("rows_i", "rows_j", "kvalid", "bp_count", "bp_dropped")
SURFACE_KEYS = ("aabb_lo", "aabb_hi", "mcache")


def branches(torch, kw):
    """Worlds by the kernel's branch: asleep (passthrough), awake and
    keeping their cache, awake and rebuilding (or without a cache)."""
    W = kw["im"].shape[0]
    awake = kw["active"] if kw.get("active") is not None else \
        torch.ones(W, dtype=torch.bool, device=kw["im"].device)
    stable = kw["stable"] if kw.get("stable") is not None else torch.zeros_like(awake)
    return {"asleep": int((~awake).sum()), "awake_stable": int((awake & stable).sum()),
            "awake_rebuilding": int((awake & ~stable).sum()),
            "asleep_stable": int((~awake & stable).sum())}


def option_case(torch, sk, kern, kw):
    """An option's kernel (twice) vs its plain version on one input: max
    errors (integer keys: the count of differing entries), or raises.  The
    cache's ok flag is a compare of a depth with 0: where the slot's
    deepest cached depth is within 1e-5 of 0 in either version (a rounding
    tie) either flag is accepted."""
    got, again = kern(**kw), kern(**kw)
    want = kern.plain(**kw)
    torch.cuda.synchronize()
    errs = {}
    for k, w in want.items():
        g = got[k]
        check(torch.equal(g, again[k]), f"option {k}: a repeated launch differs")
        if k in INT_KEYS:
            errs[k] = int((g != w).sum())
            check(errs[k] == 0, f"option {k}: {errs[k]} entries differ")
            continue
        check(bool(torch.isfinite(g).all()), f"option {k} finite")
        if k == "mcache":
            tie = torch.minimum(g[:, sk.MC_DEPTH0].abs(), w[:, sk.MC_DEPTH0].abs()) < 1e-5
            g = g.clone()
            g[:, sk.MC_OK] = torch.where(tie, w[:, sk.MC_OK], g[:, sk.MC_OK])
        errs[k] = max_err(g, w)
        tol = 1e-4 if k in SUBSTEP_POSE_KEYS or k in SURFACE_KEYS else 1e-3
        check(errs[k] <= tol, f"option {k} err {errs[k]}")
    return errs, got


def flip_branches(torch, kw):
    """The persistent kernel's inputs with the stable flags of odd worlds
    and the active flags of worlds 2 and 3 mod 4 flipped, so that a state
    where every world is in one branch runs them all."""
    worlds = torch.arange(kw["im"].shape[0], device=kw["im"].device)
    return dict(kw, stable=kw["stable"] ^ (worlds % 2 == 1),
                active=kw["active"] ^ (worlds % 4 >= 2))


def parity_substep_options(torch, rb, phys, sk, rows256, rows128, bp_sim, settled):
    """Each option's kernel specialisation vs its plain version at the main
    shapes (8192 x 65): refresh over given rows at K = 256 and 128, sleep
    with mixed active flags, the broadphase at K = 256 without and with
    refresh, and persistence from the settled pile as it is and with its
    stable and active flags flipped so that every branch runs.  Returns
    (the phase's line, the worst float error of kernel 8's and of kernel
    9's variants)."""
    om = rb.RigidBenchWorld.objmgr

    def kernel(**opts):
        return sk.FusedSubstepKernel(om, 4, relaxation=0.7, **opts)

    kw256, kw128 = fused_inputs(rows256, rb, phys), fused_inputs(rows128, rb, phys)
    kwb, kws = fused_inputs(bp_sim, rb, phys), fused_inputs(settled, rb, phys)
    flipped = flip_branches(torch, kws)
    worlds = torch.arange(RB_WORLDS, device=kw256["im"].device)
    variants = {
        "refresh_rows_K256": (kernel(contact_refresh=True), kw256),
        "refresh_rows_K128": (kernel(contact_refresh=True), kw128),
        "sleep_rows_K256": (kernel(), dict(kw256, active=worlds % 3 != 1)),
        "bp_K256": (phys.RigidBodyPhysicsSystem.fused_kernel(bp_sim), kwb),
        "bp_refresh_K256": (kernel(contact_refresh=True, bp_degree=12, bp_capacity=256), kwb),
        "persist_settled": (phys.RigidBodyPhysicsSystem.fused_kernel(settled), kws),
        "persist_settled_flipped": (phys.RigidBodyPhysicsSystem.fused_kernel(settled), flipped),
    }
    cases, worst8, worst9 = {}, 0.0, 0.0
    for name, (kern, kw) in variants.items():
        errs, out = option_case(torch, sk, kern, kw)
        floats = max(v for k, v in errs.items() if k not in INT_KEYS)
        if name.startswith("bp"):
            worst8 = max(worst8, floats)
        if name.startswith("persist"):
            worst9 = max(worst9, floats)
        cases[name] = {"K": int(out["rows_i"].shape[1]) if "rows_i" in out
                       else int(kw["rows_i"].shape[1]),
                       "branches": branches(torch, kw), "max_err": errs}
        if "bp_count" in out:
            cases[name]["candidates"] = int(out["bp_count"].sum())
            cases[name]["dropped"] = int(out["bp_dropped"].sum())
    check(all(v > 0 for v in cases["persist_settled_flipped"]["branches"].values()),
          "the flipped settled case runs every branch")
    # kernel 9's launch as the node makes it, in place, and its world flags
    fkw = flag_inputs(settled, rb, phys)
    anchors0 = tuple(fkw[k] for k in ANCHOR_KEYS)
    pkern = phys.RigidBodyPhysicsSystem.fused_kernel(settled)
    for name, kw in (("persist_settled_in_place", kws),
                     ("persist_settled_flipped_in_place", flipped)):
        errs = in_place_case(torch, sk, pkern, kw, anchors0)
        worst9 = max(worst9, max(errs.values()))
        cases[name] = {"branches": branches(torch, kw), "max_err": errs}
    flags = parity_world_flags(torch, sk, fkw)
    return {"phase": "parity_substep_options", "W": RB_WORLDS, "n": RB_BODIES + 1,
            "cases": cases, "world_flags": flags, "ints": "exact", "repeat": "bit-identical",
            "in_place": "bit for bit", "world_flags_equal": "exact",
            "atol": {"pose_stashes_aabb_cache": 1e-4, "velocities": 1e-3}}, worst8, worst9


STATIC_KEYS = ("im", "ii", "mu_s", "mu_d")
ANCHOR_KEYS = ("apos", "arot", "valid")


def flag_inputs(sim, rb, phys):
    """world_flags' arguments for a rigid_bench executor's next step."""
    return phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body, None, flags=True)


def flag_cases(torch, fkw):
    """The settled pile's world-flag inputs as they are, disturbed (every
    fifth world's bodies given a velocity), with an external force on one
    body of every seventh world, and with every eleventh world's cache not
    valid."""
    W = fkw["pos"].shape[0]
    worlds = torch.arange(W, device=fkw["pos"].device)
    v = fkw["v"].clone()
    v[worlds % 5 == 0] += torch.linspace(0.0, 0.05, v.shape[1], device=v.device)[:, None]
    ext_f = fkw["ext_f"].clone()
    ext_f[worlds % 7 == 0, 5, 2] = 1.0
    valid = torch.where(worlds % 11 == 0, 0, fkw["valid"]).to(torch.int32)
    return {"settled": fkw, "disturbed": dict(fkw, v=v), "forced": dict(fkw, ext_f=ext_f),
            "invalid": dict(fkw, valid=valid)}


def parity_world_flags(torch, subk, fkw):
    """The world flags kernel vs its plain version on flag_cases: every
    flag equal.  Returns the cases' counts of differing entries and of
    stable, asleep and quiet worlds."""
    cases = {}
    for name, kw in flag_cases(torch, fkw).items():
        got, want = subk.world_flags(**kw), subk.world_flags_plain(**kw)
        differ = {k: int((got[k] != want[k]).sum()) for k in want}
        check(set(got) == set(want) and not any(differ.values()),
              f"world flags {name}: {differ}")
        cases[name] = {"differing": differ, "stable": int(want["stable"].sum()),
                       "asleep": int(want["asleep"].sum()),
                       "quiet": int((want["quiet_steps"] > 0).sum())}
    return cases


def in_place_case(torch, sk, kern, kw, anchors0):
    """Kernel 9's launch as the fused node makes it (the per-object
    constants from the kernel's table, the cache and the anchors updated
    in place, non-dynamic rows' velocities kept) vs the plain version's
    in-place path: every output, the cache and the anchors bit for bit
    (integers equal, floats 0.0 apart); a repeat into the same cache
    bit-identical, the kept and asleep worlds' caches unchanged.  Returns
    the errors, or raises."""
    kw = {k: x for k, x in kw.items() if k not in STATIC_KEYS}

    def call(fn):
        mc, anchors = kw["mcache"].clone(), tuple(t.clone() for t in anchors0)
        return fn(**kw, mcache_out=mc, anchors=anchors, keep_velocity=True), mc, anchors

    got, mc, anchors = call(kern)
    first = {k: x.clone() for k, x in got.items()}
    want, _, anchors_p = call(kern.plain)
    again = kern(**kw, mcache_out=mc, anchors=anchors, keep_velocity=True)
    torch.cuda.synchronize()
    errs = {}
    for k, w in want.items():
        check(torch.equal(first[k], again[k]), f"in place {k}: a repeated launch differs")
        errs[k] = int((first[k] != w).sum()) if k in INT_KEYS else max_err(first[k], w)
        check(errs[k] == 0, f"in place {k}: {errs[k]} apart from the plain version")
    for name, a, b in zip(ANCHOR_KEYS, anchors, anchors_p):
        errs[name] = max_err(a.float(), b.float())
        check(errs[name] == 0, f"in place {name}: {errs[name]} apart")
    keep = kw["stable"] | ~kw["active"]
    check(torch.equal(mc[keep], kw["mcache"][keep]), "in place: a kept cache was written")
    return errs


def settled_trace(torch, rb, phys, sim, steps):
    """``steps`` more steps of the settled pile, one at a time, with each
    step's share of stable worlds, share of asleep worlds, and worlds
    rebuilding their cache (from the step's own kernel inputs)."""
    rows = []
    for _ in range(steps):
        kw = fused_inputs(sim, rb, phys)
        rows.append(torch.stack([kw["stable"].float().mean(), (~kw["active"]).float().mean(),
                                 (kw["active"] & ~kw["stable"]).float().sum()]))
        sim.step()
    t = torch.stack(rows).cpu()
    return {"stable_share": t[:, 0].tolist(), "asleep_share": t[:, 1].tolist(),
            "rebuilds": [int(x) for x in t[:, 2].tolist()]}


def options_work(torch, kern, kw, out):
    """The fp32 operations this call's data needs of a kernel with options,
    and what they were counted from: substep_work's terms over the awake
    worlds' valid slots (asleep worlds only copy), the contact tests and
    clips only where the contacts were made afresh (every substep without
    refresh; substep 0 with it; substep 0 of the rebuilding worlds with
    persistence), a refresh of each valid slot where they were not (and at
    substep 0 with persistence), the cache build, and the broadphase of the
    rebuilding worlds: each live body's AABB and each pair of live rows."""
    W = kw["im"].shape[0]
    dev = kw["im"].device
    awake = kw["active"] if kw.get("active") is not None else \
        torch.ones(W, dtype=torch.bool, device=dev)
    persist, refresh = kern.persist_margin > 0, kern.contact_refresh
    rebuild = awake & ~kw["stable"] if persist else awake
    rows = kw if "rows_i" in kw else out
    kw2 = dict(kw, rows_i=rows["rows_i"], rows_j=rows["rows_j"], kvalid=rows["kvalid"])
    kinds = kind_masks(torch, kw2, kern.tables)
    slots = kw2["kvalid"] & awake[:, None]
    ri, rj = kw2["rows_i"].long(), kw2["rows_j"].long()
    dyn_sides = torch.gather(kw["dyn"], 1, ri).int() + torch.gather(kw["dyn"], 1, rj).int()
    S = kern.num_substeps
    n = dict.fromkeys(("tests", "refreshes", "caches", "pairs", "dyn_sides", "points",
                       "point_pairs", "face_clips", "edge_points"), 0)
    step = [0]
    test, clip_face, clip_edge = contact_ops(kern.tables)

    def observe(c):
        s = step[0]
        step[0] += 1
        if persist:
            fresh = rebuild if s == 0 else torch.zeros_like(awake)
            refreshed = slots
            built = slots & rebuild[:, None] if s == 0 else None
        elif refresh and S > 1:
            fresh = awake if s == 0 else torch.zeros_like(awake)
            refreshed = slots & (s > 0)
            built = slots if s == 0 else None
        else:
            fresh, refreshed, built = awake, slots & False, None
        fresh_slots = slots & fresh[:, None]
        n["tests"] += sum(int((m & fresh_slots).sum()) * test[k] for k, m in kinds.items())
        n["refreshes"] += int(refreshed.sum())
        n["caches"] += 0 if built is None else int(built.sum())
        live = c["ok"][:, None, :] & (c["depth"] > 0) & slots[:, None, :]
        pts = live.sum(1)
        touching = pts > 0
        boxes = kinds["box-box"] & c["ok"] & fresh_slots
        n["pairs"] += int(touching.sum())
        n["dyn_sides"] += int(dyn_sides[touching].sum())
        n["points"] += int(pts.sum())
        n["point_pairs"] += int((pts * (pts + 1) // 2).sum())
        n["face_clips"] += int((boxes & (pts >= 2)).sum())
        n["edge_points"] += int((boxes & (pts < 2)).sum())

    kern.plain(observe=observe, **kw)
    per_point = OPS_POINT + (OPS_POINT_BOUNCE if kern.tables.any_restitution else 0)
    bodies = int((kw["dyn"] & awake[:, None]).sum())
    ops = (n["tests"] + n["face_clips"] * clip_face + n["edge_points"] * clip_edge
           + n["pairs"] * OPS_PAIR + n["dyn_sides"] * OPS_SIDE_SUM + n["points"] * per_point
           + n["point_pairs"] * OPS_POINT_PAIR + S * bodies * OPS_BODY
           + n["refreshes"] * OPS_REFRESH + n["caches"] * OPS_CACHE)
    if kern.bp_degree:
        live = kw["live"].sum(1).double()[rebuild]
        n["bp_bodies"] = int(live.sum())
        n["bp_pairs"] = int((live * (live - 1) / 2).sum())
        ops += n["bp_bodies"] * OPS_BP_BODY + n["bp_pairs"] * OPS_BP_PAIR
    return ops, n


def options_bound(kw, kern, out, ops):
    W, n = kw["im"].shape
    K = (kw if "rows_i" in kw else out)["rows_i"].shape[1]
    if kern.persist_margin > 0:
        return bound(W * (n * BYTES_BODY_P + K * BYTES_SLOT_P + BYTES_WORLD_P), ops)
    if kern.bp_degree:
        return bound(W * (n * BYTES_BODY_BP + K * BYTES_SLOT_BP + BYTES_WORLD_BP), ops)
    return substep_bound(kw, ops)


# bytes of kernel 9's launch (the world flags, the asleep worlds' kernel and
# the persistent kernel over the awake ones, as the fused node makes it: the
# per-object constants from the kernel's table, the cache in place), by a
# world's branch.  Every world: the flags' inputs, per body 121 (pose,
# velocity, external force and torque, dyn, object id, scale, the anchors),
# per world 22 (delta_t, quiet steps, valid in; quiet steps, asleep, active,
# stable out).  Asleep: per body the AABB columns in and out (48) and the
# 10 outputs (132), per slot the cached rows in (12) and out (9), per world
# the count, drops and its list entry (12).  Kept (stable, awake): per body
# the same 180, per slot its whole cache in (144) and the rows out (9), per
# world h, gravity, restitution threshold, dtv, count, drops, list (36).
# Rebuilding: per body the live flag (1), the AABB out (24), the outputs
# (132) and the anchors out (28), per slot the rows out (9) and the cache
# out (144), per world 36 and valid (4).
BYTES_P_BODY = {"asleep": 301, "kept": 301, "rebuilt": 306}
BYTES_P_SLOT = {"asleep": 21, "kept": 153, "rebuilt": 153}
BYTES_P_WORLD = {"asleep": 34, "kept": 58, "rebuilt": 62}
# the world flags kernel alone: per body 121 in, per world 22
BYTES_FLAGS_BODY, BYTES_FLAGS_WORLD = 121, 22
# the asleep worlds' kernel alone (an asleep world): per body the pose and
# velocity in (52), the AABB in and out (48), the outputs (132); per slot
# 21; per world active in, count, drops and its list entry out (13)
BYTES_SURF_BODY, BYTES_SURF_SLOT, BYTES_SURF_WORLD = 232, 21, 13


def persist_bound(torch, kw, K, ops):
    """Kernel 9's launch bound at inputs kw: bytes by each world's branch."""
    n = kw["dyn"].shape[1]
    awake, stable = kw["active"], kw["stable"]
    worlds = {"asleep": int((~awake).sum()), "kept": int((awake & stable).sum()),
              "rebuilt": int((awake & ~stable).sum())}
    nbytes = sum(c * (n * BYTES_P_BODY[b] + K * BYTES_P_SLOT[b] + BYTES_P_WORLD[b])
                 for b, c in worlds.items())
    return bound(nbytes, ops) + (nbytes,)


def persist_timing(torch, sk, kern, kw, fkw):
    """Kernel 9's launch as the fused node makes it (world_flags, then
    fused_substep: the asleep worlds' kernel and the persistent kernel,
    the cache and the anchors in place on scratch copies, so that repeated
    calls do the same work) and its parts, 20 calls each, beside their
    plain versions (3) and bounds; and the same call with the cache in and
    out (the bound before the cache stayed in place)."""
    kwt = {k: x for k, x in kw.items() if k not in STATIC_KEYS}
    mc, anchors = kw["mcache"].clone(), tuple(fkw[k].clone() for k in ANCHOR_KEYS)
    mc_p, anchors_p = kw["mcache"].clone(), tuple(fkw[k].clone() for k in ANCHOR_KEYS)
    opts = dict(mcache_out=mc, anchors=anchors, keep_velocity=True)
    popts = dict(mcache_out=mc_p, anchors=anchors_p, keep_velocity=True)
    out = kern(**kwt, **opts)
    ops, work = options_work(torch, kern, kw, out)
    K = out["rows_i"].shape[1]
    b_ms, b_by, nbytes = persist_bound(torch, kw, K, ops)
    W, n = kw["dyn"].shape
    f_ms, f_by = bound(W * (n * BYTES_FLAGS_BODY + BYTES_FLAGS_WORLD), 0)
    asleep = int((~kw["active"]).sum())
    s_ms, s_by = bound(asleep * (n * BYTES_SURF_BODY + K * BYTES_SURF_SLOT)
                       + W * BYTES_SURF_WORLD, 0)
    surf = (kw["pos"], kw["rot"], kw["v"], kw["w"], kw["active"], kw["mcache"], kw["aabb_lo"],
            kw["aabb_hi"])
    return {
        "ms": cuda_ms(torch, lambda: (sk.world_flags(**fkw), kern(**kwt, **opts)), 20),
        "plain_ms": cuda_ms(torch, lambda: (sk.world_flags_plain(**fkw),
                                            kern.plain(**kwt, **popts)), 3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops, "work": work,
        "bound_ms_cache_in_and_out": options_bound(kw, kern, out, ops)[0],
        "parts": {
            "world_flags": {"ms": cuda_ms(torch, lambda: sk.world_flags(**fkw), 20),
                            "plain_ms": cuda_ms(torch, lambda: sk.world_flags_plain(**fkw), 3,
                                                warmup=1),
                            "bound_ms": f_ms, "bound_by": f_by},
            "asleep_surface": {"ms": cuda_ms(torch, lambda: sk.asleep_surface(*surf), 20),
                               "plain_ms": cuda_ms(torch, lambda: sk.asleep_surface_plain(*surf),
                                                   3, warmup=1),
                               "bound_ms": s_ms, "bound_by": s_by},
            "fused_substep": {"ms": cuda_ms(torch, lambda: kern(**kwt, **opts), 20)}},
        "branches": branches(torch, kw)}


def graph_nodes(torch, fn):
    """The device operations one call of fn queues: the nodes of a CUDA
    graph that captures the call (cuGraphGetNodes).  It opens no
    torch.profiler session, which would disturb node_time's counts."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    check(rc == 0, f"cuGraphGetNodes failed with {rc}")
    return count.value


def node_time(torch, sim, name):
    """Device ms of one run of executor sim's node ``name`` on the state the
    step's nodes before it make of sim's (20 runs, as cuda_ms times), the
    host ms a run takes to queue its work (20 runs, no sync between), the
    device operations one run queues (the nodes of a CUDA graph capturing
    it, graph_nodes), and, after that count, the same run's device
    operations by name (torch.profiler: informational only, since an
    earlier profiler session in the process can make a later one miss
    events)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from gpu_ecs_madrona_tpu_torch.core.context import Context
    ctx = Context(sim.mgr, sim.state)
    for node in sim.graph.nodes:           # the step's nodes before it, once
        if node.name == name:
            break
        node.run(ctx)
    state = ctx.state

    def run():
        node.run(Context(sim.mgr, state))

    ms = cuda_ms(torch, run, 20)
    t0 = time.perf_counter()
    for _ in range(20):
        run()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    device_ops = graph_nodes(torch, run)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)
                and e.self_device_time_total > 0):
            ops[e.key[:60]] = ops.get(e.key[:60], 0) + e.count
    return {"device_ms": ms, "host_ms": host_ms, "device_ops": device_ops,
            "by_name": ops}


def option_timing(torch, kern, kw):
    """CUDA-event time of a kernel with options (20 calls) and of its plain
    version (3) on inputs ``kw``, beside the bound; the valid slots by
    contact kind (the given rows, or the broadphase's)."""
    out = kern(**kw)
    ops, work = options_work(torch, kern, kw, out)
    b_ms, b_by = options_bound(kw, kern, out, ops)
    rows = kw if "rows_i" in kw else out
    slots = pair_kinds(torch, dict(kw, rows_i=rows["rows_i"], rows_j=rows["rows_j"],
                                   kvalid=rows["kvalid"]), kern.tables)
    return {"ms": cuda_ms(torch, lambda: kern(**kw), 20),
            "plain_ms": cuda_ms(torch, lambda: kern.plain(**kw), 3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "work": work,
            "branches": branches(torch, kw), "slots_by_kind": slots}


# -- imported convex hulls: the general-hull paths ---------------------------

HULL_SETTLE_STACKED = 30          # steps of the stacked prisms before the persist case
# the 24-sided prism's parity worlds: its plain version's SAT holds [W, 169
# edge pairs, 48 verts, K] tensors
LARGE_PARITY_WORLDS = 128
LARGE_STEPS, LARGE_WINDOWS = 10, 3  # main_rigid_hulls_large's windows
MOTION_STEPS = 10                 # steps of motion_after_settle


def world_chunks(kw, size):
    """kw (a kernel's inputs) cut into blocks of ``size`` worlds: every
    tensor whose first axis is the worlds' sliced, the rest as it is."""
    W = kw["obj"].shape[0]
    for a in range(0, W, size):
        yield {k: v[a:a + size] if hasattr(v, "shape") and v.dim() and v.shape[0] == W else v
               for k, v in kw.items()}


def motion_line(torch, rb, sim, thr):
    """The settled hull pile's motion against the sleep threshold ``thr``:
    the share of worlds whose largest dynamic |v|^2 + |w|^2 passes thr^2
    (the sleep classifier's moving test), quantiles (0.5, 0.9, 1.0) of the
    worlds' largest |v|^2 and |w|^2, the dynamic bodies above the
    threshold by pose (the prism's axis within 0.01 of vertical: on a cap;
    of horizontal: on a side; else tilted), the asleep share and the worlds
    by quiet-step counter (0, between, at sleep_frames)."""
    from gpu_ecs_madrona_tpu_torch.core import base
    from gpu_ecs_madrona_tpu_torch.physics import components as comp
    vel = sim.mgr.column(sim.state, rb.Body, comp.Velocity)
    rot = sim.mgr.column(sim.state, rb.Body, base.Rotation)
    dyn = ((sim.mgr.column(sim.state, rb.Body, comp.ResponseType) == comp.RESPONSE_DYNAMIC)
           & sim.mgr.row_mask(sim.state, rb.Body))
    v2 = torch.where(dyn, (vel["linear"] ** 2).sum(-1), 0.0)
    w2 = torch.where(dyn, (vel["angular"] ** 2).sum(-1), 0.0)
    above = dyn & (v2 + w2 > thr * thr)
    up = (1.0 - 2.0 * (rot[..., 1] ** 2 + rot[..., 2] ** 2)).abs()
    q = torch.tensor([0.5, 0.9, 1.0], device=v2.device)
    sleep = sim.state["singleton"]["SleepState"]
    quiet = sleep["quiet_steps"]
    frames = sim.world_cls.config.sleep_frames
    return {"moving_world_share": float(above.any(1).float().mean()),
            "world_max_v2_q50_q90_max": torch.quantile(v2.max(1).values, q).tolist(),
            "world_max_w2_q50_q90_max": torch.quantile(w2.max(1).values, q).tolist(),
            "bodies_above": int(above.sum()), "bodies": int(dyn.sum()),
            "above_on_cap": int((above & (up > 0.99)).sum()),
            "above_on_side": int((above & (up < 0.01)).sum()),
            "above_tilted": int((above & (up >= 0.01) & (up <= 0.99)).sum()),
            "asleep_share": float((sleep["asleep"] != 0).float().mean()),
            "quiet_steps_0_mid_full": [int((quiet == 0).sum()),
                                       int(((quiet > 0) & (quiet < frames)).sum()),
                                       int((quiet >= frames).sum())]}


def settle_motion(torch, rb, phys, steps):
    """main_rigid's ``probe``: motion_line of the settled hull pile after its
    settle steps and after each of ``steps`` more."""
    def probe(sim):
        thr = sim.world_cls.config.sleep_threshold
        out = [motion_line(torch, rb, sim, thr)]
        for _ in range(steps):
            sim.step()
            out.append(motion_line(torch, rb, sim, thr))
        return out
    return probe


def hull_scenes():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_hull_scenes as hs
    return hs


def hull_sim(rb, hs, steps=0, stacked=False, large=False, **cfg):
    """The hull pile (tests/test_torch_hull_scenes.py, 8192 x 65 rows) in
    configuration HULL_PILE + ``cfg`` on the card, its prisms stacked face on
    face with ``stacked``, the 24-sided prism with ``large``, after
    ``steps`` steps."""
    sim = hs.hull_pile(rb.RigidBenchConfig(**dict(hs.HULL_PILE, **cfg)), device="cuda",
                       large=large)
    if stacked:
        hs.stack_prisms(sim)
    sim.run(steps)
    return sim


def touching_kinds(torch, kern, kw, rows):
    """The plain version's contacts on ``kw`` summed over its substeps, by
    contact kind of the general paths: the valid pairs with ok and a live
    point, the hull pairs on a face axis (more than one point) and on an
    edge axis (one); ``rows`` the candidate rows (kw's, or the kernel's
    broadphase's)."""
    kinds = kind_masks(torch, dict(kw, rows_i=rows["rows_i"], rows_j=rows["rows_j"],
                                   kvalid=rows["kvalid"]), kern.tables)
    names = {"box-box": "hull-hull", "box-plane": "hull-plane", "sphere-box": "sphere-hull",
             "sphere-plane": "sphere-plane", "sphere-sphere": "sphere-sphere"}
    n = {v: 0 for v in names.values()}
    n.update(hull_hull_face=0, hull_hull_edge=0)

    def observe(c):
        pts = (c["ok"][:, None, :] & (c["depth"] > 0)).sum(1)
        for k, name in names.items():
            n[name] += int((kinds[k] & (pts > 0)).sum())
        n["hull_hull_face"] += int((kinds["box-box"] & (pts > 1)).sum())
        n["hull_hull_edge"] += int((kinds["box-box"] & (pts == 1)).sum())

    kern.plain(observe=observe, **kw)
    return n


def parity_hull(torch, rb, phys, sk):
    """The general-hull paths of the substep kernels against their plain
    versions on the hull pile (8192 x 65 rows, the imported prism and
    spheres): every fused specialisation (K = 256 and 128; refresh, sleep
    with mixed active flags, refresh and sleep, the broadphase without and
    with refresh, persistence without and with sleep, as it is and with its
    branches flipped) at the pile's initial spawn, after 3 steps, and on
    stacked prisms resting face on face; kernel 5 without FULL on the first
    substep of the pile after 3 steps and at its spawn, and its node launch
    on the joint world with its boxes swapped for the prism.  parity_substep's
    gates; each case prints its candidates and touching pairs by contact kind.
    Returns (the phase's line, the worst error, kernel 5's worst error)."""
    hs = hull_scenes()
    cases, worst, worst5 = {}, 0.0, 0.0

    def case(name, kern, kw, option=False):
        nonlocal worst
        sk.FusedSubstepKernel.launches_by_options.clear()
        if option:
            errs, out = option_case(torch, sk, kern, kw)
        else:
            errs, out = substep_case(torch, sk, kern, kw), kw
        (launched, _), = sk.FusedSubstepKernel.launches_by_options.items()
        rows = kw if "rows_i" in kw and kw["rows_i"] is not None else out
        worst = max(worst, max(v for k, v in errs.items() if k not in INT_KEYS))
        cases[name] = {"specialisation": launched,
                       "K": int(rows["rows_i"].shape[1]),
                       "candidates": pair_kinds(torch, dict(kw, rows_i=rows["rows_i"],
                                                            rows_j=rows["rows_j"],
                                                            kvalid=rows["kvalid"]),
                                                kern.tables),
                       "touching_over_substeps": touching_kinds(torch, kern, kw, rows),
                       "branches": branches(torch, kw), "max_err": errs}

    sim = hull_sim(rb, hs)
    om = sim.world_cls.objmgr
    check(not phys.subk.pk.ObjTables(om).all_box, "the hull pile's tables are general")

    def kernel(**opts):
        return sk.FusedSubstepKernel(om, 4, relaxation=0.7, **opts)

    spawn = fused_inputs(sim, rb, phys)
    sim.run(3)
    kw256 = fused_inputs(sim, rb, phys)
    worlds = torch.arange(RB_WORLDS, device=kw256["im"].device)
    case("initial_spawn", kernel(), spawn)
    case("main_K256", kernel(), kw256)
    # kernel 5 without FULL: the first substep of both states
    single = sk.SubstepKernel(om, relaxation=0.7)
    for name, kw in (("single_substep_K256", kw256), ("single_substep_spawn", spawn)):
        errs = substep1_case(torch, sk, single, phys.RigidBodyPhysicsSystem.substep_kernel_inputs(kw))
        worst5 = max(worst5, max(errs.values()))
        cases[name] = {"kernel": "substep", "max_err": errs}
    del spawn
    case("refresh_K256", kernel(contact_refresh=True), kw256, option=True)
    case("sleep_K256", kernel(), dict(kw256, active=worlds % 3 != 1), option=True)
    case("refresh_sleep_K256", kernel(contact_refresh=True),
         dict(kw256, active=worlds % 3 != 1), option=True)
    del sim
    s128 = hull_sim(rb, hs, 3, max_candidates=128)
    case("main_K128", kernel(), fused_inputs(s128, rb, phys))
    case("refresh_K128", kernel(contact_refresh=True), fused_inputs(s128, rb, phys),
         option=True)
    del s128
    bsim = hull_sim(rb, hs, 3, broadphase_mode="fused")
    kwb = fused_inputs(bsim, rb, phys)
    case("bp_K256", phys.RigidBodyPhysicsSystem.fused_kernel(bsim), kwb, option=True)
    case("bp_refresh_K256", kernel(contact_refresh=True, bp_degree=12, bp_capacity=256), kwb,
         option=True)
    del bsim, kwb
    # stacked prisms, face on face at rest: the pile's "none", and the
    # settled pile's options after HULL_SETTLE_STACKED steps
    ssim = hull_sim(rb, hs, 0, stacked=True, body_mix="boxes")
    case("stacked_face_on_face", kernel(), fused_inputs(ssim, rb, phys))
    ssim.run(2)
    case("stacked_face_on_face_2_steps", kernel(), fused_inputs(ssim, rb, phys))
    del ssim
    psim = hull_sim(rb, hs, 0, stacked=True, **{k: v for k, v in hs.HULL_SETTLED.items()
                                                  if k not in hs.HULL_PILE})
    psim.run(HULL_SETTLE_STACKED)
    kwp = fused_inputs(psim, rb, phys)
    pkern = phys.RigidBodyPhysicsSystem.fused_kernel(psim)
    case("persist_sleep_stacked", pkern, kwp, option=True)
    case("persist_sleep_stacked_flipped", pkern, flip_branches(torch, kwp), option=True)
    nosleep = kernel(contact_refresh=True, bp_degree=12, bp_capacity=256, persist_margin=0.05)
    case("persist_stacked", nosleep, dict(kwp, active=None), option=True)
    case("persist_stacked_flipped", nosleep,
         dict(flip_branches(torch, kwp), active=None), option=True)
    check(all(v > 0 for v in cases["persist_sleep_stacked_flipped"]["branches"].values()),
          "the flipped stacked case runs every branch")
    del psim, kwp
    # the 24-sided prism (tables past PhysicsLoader()'s defaults), at 128
    # worlds of 65 rows
    lsim = hull_sim(rb, hs, 3, large=True, num_worlds=LARGE_PARITY_WORLDS)
    lom = lsim.world_cls.objmgr

    def lkernel(**opts):
        return sk.FusedSubstepKernel(lom, 4, relaxation=0.7, **opts)

    lkw = fused_inputs(lsim, rb, phys)
    case("large_main_K256", lkernel(), lkw)
    errs = substep1_case(torch, sk, sk.SubstepKernel(lom, relaxation=0.7),
                         phys.RigidBodyPhysicsSystem.substep_kernel_inputs(lkw))
    worst5 = max(worst5, max(errs.values()))
    cases["large_single_substep_K256"] = {"kernel": "substep", "max_err": errs}
    del lsim, lkw
    lsim = hull_sim(rb, hs, 0, stacked=True, large=True, num_worlds=LARGE_PARITY_WORLDS,
                    body_mix="boxes")
    case("large_stacked_face_on_face", lkernel(), fused_inputs(lsim, rb, phys))
    lsim = hull_sim(rb, hs, 0, stacked=True, large=True, num_worlds=LARGE_PARITY_WORLDS,
                    **{k: v for k, v in hs.HULL_SETTLED.items() if k not in hs.HULL_PILE})
    lsim.run(HULL_SETTLE_STACKED)
    lkw = fused_inputs(lsim, rb, phys)
    case("large_persist_sleep_stacked_flipped", phys.RigidBodyPhysicsSystem.fused_kernel(lsim),
         flip_branches(torch, lkw), option=True)
    del lsim, lkw
    # kernel 5's node launch: the joint world with the prism for its boxes
    jsim = hs_joint_world(hs)
    jkw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(jsim, None, None, node=True)
    jkern = phys.RigidBodyPhysicsSystem.substep_kernel(jsim)
    check(not jkern.tables.all_box, "the joint world's prism tables are general")
    errs = node_case(torch, sk, jkern, jkw)
    worst5 = max(worst5, max(errs.values()))
    cases["substep_node_joint_world_prisms"] = {"kernel": "substep", "W": 256,
                                                "live_joints": int(live_joints(jkw).sum()),
                                                "max_err": errs}
    names = {c["specialisation"] for c in cases.values() if "specialisation" in c}
    want = {sk.option_name(code | sk.OPT_HULL) for code in sk.SPECIALISATION_CODES}
    check(names == want, f"parity_hull launched {sorted(names)}, not every specialisation")
    # the general paths all reached: the SAT's face and edge outcomes,
    # sphere-hull and hull-plane; face pairs on the stacked prisms
    reached = {k: sum(c["touching_over_substeps"][k] for c in cases.values()
                      if "touching_over_substeps" in c)
               for k in ("hull_hull_face", "hull_hull_edge", "sphere-hull", "hull-plane")}
    check(all(reached.values()), f"parity_hull: a general path not reached {reached}")
    check(cases["stacked_face_on_face"]["touching_over_substeps"]["hull_hull_face"] > 0,
          "stacked prisms: no face pair")
    check(cases["large_stacked_face_on_face"]["touching_over_substeps"]["hull_hull_face"] > 0,
          "stacked 24-sided prisms: no face pair")
    # the general-hull paths bit for bit their plain versions
    check(worst == 0.0 and worst5 == 0.0,
          f"parity_hull: a general-hull case differs from its plain version ({worst}, {worst5})")
    return {"phase": "parity_hull", "W": RB_WORLDS, "n": RB_BODIES + 1, "cases": cases,
            "touching_over_all_cases": reached, "ints": "exact", "repeat": "bit-identical (kernel and plain)",
            "atol": {"pose_stashes_aabb_cache": 1e-4, "velocities": 1e-3}}, worst, worst5


def hs_joint_world(hs):
    """The joint world of tests/test_torch_joint_scenes.py with the imported
    prism for its boxes, 256 worlds on the card after 5 steps."""
    import test_torch_joint_scenes as joint_scenes
    jsim = joint_scenes.joint_world("pallas", num_worlds=256, device="cuda",
                                    body=hs.prism_object())
    jsim.run(5)
    return jsim


# -- the batch renderer: the render kernel ------------------------------------

# bench_render.py:19-22's defaults, with the reference's 100 objects
STG_WORLDS, STG_OBJECTS, STG_RES = 1024, 100, 64
RENDER_INPUTS = ("ro", "rd", "pos", "rot", "scale", "obj", "mask")
# fp32 operations of the render kernel (each add, sub, mul, div, sqrt, min,
# max and abs; compares and selects not counted), counted from
# csrc/render_kernels.cu: a ray against an instance by its test, and a
# pixel's ray, shading and store
OPS_RENDER = {"sphere": 25, "plane": 45, "hull": 75, "hull_face": 14, "mesh": 115,
              "mesh_tri": 47}
OPS_PIXEL = 30
# the views mode's ray a pixel (camera_ray: the pixel's NDC, the rotation,
# the norm and the division)
OPS_RAY = 50
# bytes a call moves: each ray read (6 floats), each instance read (12),
# each output written (5)
BYTES_RAY, BYTES_INST, BYTES_OUT = 24, 48, 20
# the views mode: each view read (eye 12, rot 16, tan_fov 4, mask 1), each
# instance (pos 12, rot 16, scale 12, obj 4, mask 1), each pixel written
# (RGBA8 4, depth 4)
BYTES_VIEW, BYTES_INST_VIEWS, BYTES_PIXEL = 33, 45, 8
# the kernel's widening of each bounding sphere (csrc/render_kernels.cu
# kCullRel, kCullAbs)
CULL_REL, CULL_ABS = 1e-3, 1e-3


def render_case(torch, rkm, k, rays, inst, img_w):
    """Kernel (twice) against plain on one input: its line, or raises."""
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient)
    got, again = rkm.render(rays, inst, img_w=img_w, **kw), rkm.render(rays, inst, img_w=img_w, **kw)
    want = rkm.render_plain(rays, inst, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "render output finite")
    check(torch.equal(got[:, rkm.O_HIT], want[:, rkm.O_HIT]), "render hit mask vs plain")
    check(torch.equal(got, again), "render: a repeated launch differs")
    err = max_err(got, want)
    check(err <= 1e-5, f"render vs plain err {err}")
    return {"W": rays.shape[0], "P": rays.shape[2], "N": inst.shape[2], "img_w": img_w,
            "hits": int(want[:, rkm.O_HIT].sum()), "max_err": err}


def stg_sim(stg, worlds, backend="auto"):
    """A simple_taskgraph executor on the card after 3 steps."""
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(
        num_worlds=worlds, num_objects=STG_OBJECTS, render=True, render_width=STG_RES,
        render_height=STG_RES, render_backend=backend), device="cuda")
    sim.run(3)
    return sim


def views_case(torch, rkm, scenes, k, views, inst, V, H, Wpx):
    """The kernel's views mode (twice) against the node's route before it
    on the card (camera_rays, pack, the rays-mode kernel, the epilogue), bit
    for bit, and against its plain version (alpha exact, depth atol 1e-5
    where both hit, RGBA8 within 1): its line, or raises."""
    kw = dict(height=H, width=Wpx, max_views=V)
    got, again = k.render_views(views, *inst, **kw), k.render_views(views, *inst, **kw)
    want = scenes.node_route(k, views, inst, V, H, Wpx)
    plain = rkm.render_views_plain(views, *inst, tables=k.tables, light=k.light,
                                   ambient=k.ambient, **kw)
    torch.cuda.synchronize()
    for other, what in ((want, "the old route"), (again, "a repeated launch")):
        check(torch.equal(got[0], other[0]), f"render_views RGBA8 vs {what}")
        check(torch.equal(got[1].view(torch.int32), other[1].view(torch.int32)),
              f"render_views depth bits vs {what}")
    hit = torch.isfinite(got[1])
    check(torch.equal(got[0][..., 3] == 255, hit), "render_views alpha 255 exactly on hits")
    check(torch.equal(got[0][..., 3], plain[0][..., 3]), "render_views alpha vs plain")
    both = hit & torch.isfinite(plain[1])
    err = max_err(got[1][both], plain[1][both])
    rgb_d = int((got[0].int() - plain[0].int()).abs().max())
    check(err <= 1e-5 and rgb_d <= 1, f"render_views vs plain: depth {err}, rgba8 {rgb_d}")
    dead = ~views["mask"][:, :V]
    check(bool((got[0][dead] == 0).all()) and bool(torch.isinf(got[1][dead]).all()),
          "render_views: a dead view is black with depth inf")
    return {"W": int(got[1].shape[0]), "V": V, "H": H, "Wpx": Wpx, "N": int(inst[0].shape[1]),
            "dead_views": int(dead.sum()), "hits": int(hit.sum()),
            "vs_old_route": "bit-identical", "depth_max_err_vs_plain": err,
            "rgba8_max_diff_vs_plain": rgb_d}, err


def parity_render(torch, rkm, stg, dev, xla_worlds=64):
    """The render kernel's rays mode against its plain version (the scenes,
    the main state); its views mode against the node's route before it and
    against its plain version (the main state, two views with dead ones,
    24 x 40 and 18 x 30 images, a triangle-mesh scene); and the kernel
    route against the "xla" route at 64 worlds.  Returns (the phase's line,
    the worst kernel-vs-plain error)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_render_scenes as scenes
    cases = {}
    for name, make in scenes.CARD_SCENES.items():
        sc = make()
        k = rkm.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                             mesh_tables=sc["mesh_tables"])
        rays, inst = k.pack(*(torch.from_numpy(sc[key]).to(dev) for key in RENDER_INPUTS))
        cases[name] = render_case(torch, rkm, k, rays, inst, sc["img_w"])
    sim = stg_sim(stg, STG_WORLDS)
    rend = sim.world_cls.renderer()
    render_in = sim.state["user"]["render"]
    rays, inst = rend.kernel_inputs(render_in, [stg.Sphere])
    cases["main_state"] = render_case(torch, rkm, rend._kernel, rays, inst, STG_RES)
    worst = max(c["max_err"] for c in cases.values())
    views = {}
    views["main_state"], err = views_case(
        torch, rkm, scenes, rend._kernel, render_in["__views__"],
        rend.instances(render_in, [stg.Sphere]), 1, STG_RES, STG_RES)
    worst = max(worst, err)
    for name in scenes.VIEW_CASES:
        views[name], err = views_case(torch, rkm, scenes, *scenes.view_case(name, dev))
        worst = max(worst, err)
    # past one block's shared memory: 4,096 instance rows a world (meshes
    # among them), staged in blocks, bit for bit the plain versions
    blocked = blocked_render_cases(torch, rkm, scenes, dev)
    del sim, rays, inst
    # the kernel route against the batched "xla" route, same physics
    a, b = stg_sim(stg, xla_worlds), stg_sim(stg, xla_worlds, backend="xla")
    check(torch.equal(a.get_exported(2)[0], b.get_exported(2)[0]), "xla run: same physics")
    da, db = a.depth_observations(), b.depth_observations()
    ha, hb = torch.isfinite(da), torch.isfinite(db)
    both = ha & hb
    diff = int((ha != hb).sum())
    rgb_d = int((a.rgb_observations().int() - b.rgb_observations().int()).abs()[both].max())
    depth_ok = bool(torch.allclose(da[both], db[both], rtol=1e-4, atol=1e-3))
    check(diff <= ha.numel() * 1e-5, f"kernel vs xla: {diff} hit pixels differ")
    check(depth_ok and rgb_d <= 1, f"kernel vs xla: depth {depth_ok}, rgb {rgb_d}")
    return {"phase": "parity_render", "cases": cases, "views_mode": views, "blocked": blocked,
            "kernel_vs_xla": {"worlds": xla_worlds, "pixels": ha.numel(), "hits": int(ha.sum()),
                                        "hit_pixels_differing": diff,
                                        "depth_max_err": max_err(da[both], db[both]),
                                        "rgba8_max_diff": rgb_d},
            "repeat": "bit-identical",
            "atol": {"kernel_vs_plain": 1e-5, "hit": "exact",
                     "views_vs_old_route": "bit-identical (RGBA8, depth bits)",
                     "views_vs_plain": "alpha exact, depth 1e-5 where both hit, rgba8 1",
                     "kernel_vs_xla": "hit 1 in 1e5, depth rtol 1e-4 atol 1e-3, rgba8 1"}}, worst


RENDER_LARGE_WORLDS, RENDER_LARGE_PARITY = 256, 8   # main_render_large
RENDER_LARGE_STEPS = 5


def blocked_render_cases(torch, rkm, scenes, dev, W=8, res=32):
    """The render kernel at 4,096 instance rows a world (tests/
    test_torch_render_scenes.py's large scene, staged in blocks: hulls,
    spheres, the plane and triangle meshes, a SourceMesh's among them), both
    modes, bit for bit the plain versions (rays: rgb, hit, depth; views:
    RGBA8 and depth bits); a repeat bit-identical.  Returns {case: line}."""
    out = {}
    sc = scenes.large_scene(W=W, res=res)
    k = rkm.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                         mesh_tables=sc["mesh_tables"])
    rays, inst = k.pack(*(torch.from_numpy(sc[key]).to(dev) for key in RENDER_INPUTS))
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient)
    got, again = (rkm.render(rays, inst, img_w=res, **kw) for _ in range(2))
    want = rkm.render_plain(rays, inst, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "blocked rays: a repeated launch differs")
    check(torch.equal(got, want), f"blocked rays vs plain: {max_err(got, want)}")
    obj = inst[:, rkm.I_OBJ]
    check(bool((obj == scenes.LARGE_PRISM).any() and (obj == scenes.LARGE_MESH_SPHERE).any()),
          "the large scene holds both render meshes")
    out["rays_4096"] = {"W": W, "P": rays.shape[2], "N": inst.shape[2],
                        "mesh_rows": int((obj >= scenes.LARGE_PRISM).sum()),
                        "blocks": rkm.stage_blocks(inst.shape[2]),
                        "hits": int(want[:, rkm.O_HIT].sum()), "max_err": max_err(got, want)}
    k, views, insts, V, H, Wpx = scenes.large_view_case(W=W, H=res, Wpx=res, device=dev)
    vkw = dict(height=H, width=Wpx, max_views=V)
    got, again = (k.render_views(views, *insts, **vkw) for _ in range(2))
    plain = rkm.render_views_plain(views, *insts, tables=k.tables, light=k.light,
                                   ambient=k.ambient, **vkw)
    torch.cuda.synchronize()
    for other, what in ((again, "a repeated launch"), (plain, "the plain version")):
        check(torch.equal(got[0], other[0]) and torch.equal(got[1].view(torch.int32),
                                                            other[1].view(torch.int32)),
              f"blocked views vs {what}")
    out["views_4096"] = {"W": W, "H": H, "Wpx": Wpx, "N": insts[0].shape[1],
                         "blocks": rkm.stage_blocks(insts[0].shape[1], views=True),
                         "hits": int(torch.isfinite(got[1]).sum()),
                         "max_err": max_err(got[1][torch.isfinite(got[1])],
                                            plain[1][torch.isfinite(got[1])])}
    return out


def main_render_large(torch, rkm, render_mod, card, reset_counts, read_counts):
    """The render node's route on RENDER_LARGE_WORLDS worlds of 4,096
    instance rows (tests/test_torch_render_scenes.py's large instances, one
    64 x 64 view a world about its camera): a BatchRenderer with backend
    "auto" (which must resolve to the kernel) and its render node, driven
    RENDER_LARGE_STEPS times; launches = those, of the render kernel only;
    RGBA8 and depth bit for bit the plain version on RENDER_LARGE_PARITY of
    the worlds; alpha 255 exactly where the depth is finite.  Returns (its
    line, the launch's inputs for the timing phase)."""
    from types import SimpleNamespace
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_render_scenes as scenes
    W, res = RENDER_LARGE_WORLDS, STG_RES
    from gpu_ecs_madrona_tpu_torch.utils import importer
    k0, views, inst, V, H, Wpx = scenes.large_view_case(W=W, H=res, Wpx=res, device="cuda")
    rend = render_mod.BatchRenderer(render_mod.RendererConfig(
        width=res, height=res, max_views=V, backend="auto"), scenes.large_object_manager(),
        scenes.LARGE_ALBEDO, render_meshes=scenes.large_render_meshes(importer))
    check(rend.route == "kernel", f"renderer auto takes {rend.route}")
    nodes = []
    rend.setup_tasks(SimpleNamespace(mgr=SimpleNamespace(device=torch.device("cuda")),
                                     add_node=lambda fn, deps, name: nodes.append(fn)),
                     [], [SimpleNamespace(name="LargeScene")])
    render_node = nodes[0]
    ctx = SimpleNamespace(data={"render": {"__views__": views, "LargeScene": dict(zip(
        ("pos", "rot", "scale", "obj_id", "mask"), inst))}})
    N = inst[0].shape[1]
    check(N * res * res >= 1 << 19, "main_render_large below JAX's kernel threshold")
    render_node(ctx)
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(RENDER_LARGE_STEPS):
        render_node(ctx)
    torch.cuda.synchronize()
    launches = read_counts()
    want = {name: 0 for name in launches}
    want["render"] = RENDER_LARGE_STEPS
    check(launches == want, f"main_render_large launches {launches}")
    rgb, depth = ctx.data["render_out"]["rgb"], ctx.data["render_out"]["depth"]
    hit = rgb[..., 3] == 255
    check(torch.equal(hit, torch.isfinite(depth)) and bool(hit.any()),
          "main_render_large: alpha 255 exactly where the depth is finite")
    P8 = RENDER_LARGE_PARITY
    kern = rend._kernel
    plain = rkm.render_views_plain({key: v[:P8] for key, v in views.items()},
                                   *(t[:P8] for t in inst), tables=kern.tables, light=kern.light,
                                   ambient=kern.ambient, height=H, width=Wpx, max_views=V)
    torch.cuda.synchronize()
    check(torch.equal(rgb[:P8], plain[0])
          and torch.equal(depth[:P8].view(torch.int32), plain[1].view(torch.int32)),
          "main_render_large vs the plain version")
    both = torch.isfinite(depth[:P8])
    line = {"phase": "main_render_large", "worlds": W, "views": V, "resolution": res,
            "instance_rows": N, "backend": "auto -> kernel (views mode, blocked)",
            "blocks_a_cta": rkm.stage_blocks(N, views=True), "block": rkm.BLOCK,
            "smem_bytes": rkm.smem_bytes(N, views=True),
            "single_stage_would_need_bytes": N * rkm.STAGE_VIEWS,
            "launches": launches, "hit_share": float(hit.double().mean()),
            "vs_plain": {"worlds": P8, "rgba8_and_depth": "bit-identical",
                         "max_err": max_err(depth[:P8][both], plain[1][both])},
            "card": card}
    return line, (kern, views, inst, V, H, Wpx), max_err(depth[:P8][both], plain[1][both])


def render_work(torch, rkm, tables, rays, inst):
    """The operations this call's data needs of the render kernel, and what
    they were counted from: the (pixel, live instance) pairs whose bounding
    sphere (the kernel's r_bound times the largest scale) the pixel's own
    ray meets, by the instance's test (planes: every pixel), and the rays."""
    W, _, P = rays.shape
    N = inst.shape[2]
    tab = tables.kernel_table(rays.device)
    pairs = dict.fromkeys(("sphere", "hull", "plane", "mesh"), 0)
    live_rays = 0
    step = max(1, (1 << 24) // (P * N))
    for w0 in range(0, W, step):
        r, i = rays[w0:w0 + step], inst[w0:w0 + step]
        ro = r[:, 0:3].transpose(1, 2)[:, :, None, :]                  # [w, P, 1, 3]
        rd = r[:, 3:6].transpose(1, 2)[:, :, None, :]
        real = (rd * rd).sum(-1) >= 0.5                                # [w, P, 1]
        row = tab[i[:, rkm.I_OBJ].long().clamp(0, tables.O - 1)]       # [w, N, S]
        rb = row[..., rkm.K_RBOUND] * i[:, rkm.I_SCALE:rkm.I_SCALE + 3].amax(1)
        oc = i[:, None, 0:3].transpose(2, 3) - ro                      # [w, P, N, 3]
        tca = (oc * rd).sum(-1)
        oc2 = (oc * oc).sum(-1)
        rr = (rb * rb)[:, None]
        meets = (oc2 - tca * tca <= rr) & ((tca >= 0) | (oc2 <= rr))
        mesh = (row[..., rkm.K_MESH] > 0.5) & (tables.T_used > 0)
        prim = row[..., rkm.K_PRIM]
        ok = real & (i[:, None, rkm.I_MASK] > 0.5)
        for kind, sel in (("mesh", mesh), ("sphere", ~mesh & (prim == 0)),
                          ("hull", ~mesh & (prim == 1)), ("plane", ~mesh & (prim == 2))):
            m = ok & sel[:, None]
            pairs[kind] += int((m if kind == "plane" else m & meets).sum())
        live_rays += int(real.sum())
    cost = {"sphere": OPS_RENDER["sphere"], "plane": OPS_RENDER["plane"],
            "hull": OPS_RENDER["hull"] + OPS_RENDER["hull_face"] * tables.F_used,
            "mesh": OPS_RENDER["mesh"] + OPS_RENDER["mesh_tri"] * tables.T_used}
    ops = sum(pairs[k] * cost[k] for k in pairs) + live_rays * OPS_PIXEL
    nbytes = W * (P * (BYTES_RAY + BYTES_OUT) + N * BYTES_INST)
    return ops, nbytes, pairs, live_rays


def render_survivors(torch, rkm, tables, rays, inst, img_w, tile_w, tile_h):
    """The instances the kernel's tile cull keeps per tile_w x tile_h tile
    (its formula, recomputed in PyTorch): mean and max over the tiles, and
    the live instances."""
    W, _, P = rays.shape
    rows = P // img_w
    check(rows * img_w == P and rows % tile_h == 0 and img_w % tile_w == 0,
          f"survivors: {tile_w} x {tile_h} tiles")
    r = rays.reshape(W, 6, rows // tile_h, tile_h, img_w // tile_w, tile_w)
    r = r.permute(0, 2, 4, 1, 3, 5).reshape(W, -1, 6, tile_w * tile_h)
    ro, rd = r[:, :, 0:3], r[:, :, 3:6]                                # [W, T, 3, px]
    real = ((rd * rd).sum(2) >= 0.5).float()
    ax = (rd * real[:, :, None]).sum(-1)                               # [W, T, 3]
    ax = ax / torch.sqrt(torch.clamp((ax * ax).sum(-1, keepdim=True), min=1e-9))
    ro_mean = (ro * real[:, :, None]).sum(-1) / torch.clamp(real.sum(-1), min=1.0)[..., None]
    cos_m = torch.where(real > 0, (rd * ax[..., None]).sum(2), 1.0).amin(-1).clamp(-1.0, 1.0)
    sin_m = torch.sqrt(torch.clamp(1.0 - cos_m * cos_m, min=0.0))[..., None]
    spread = torch.sqrt(torch.where(real > 0, ((ro - ro_mean[..., None]) ** 2).sum(2),
                                    0.0).amax(-1))
    row = tables.kernel_table(rays.device)[inst[:, rkm.I_OBJ].long().clamp(0, tables.O - 1)]
    rb = row[..., rkm.K_RBOUND] * inst[:, rkm.I_SCALE:rkm.I_SCALE + 3].amax(1)   # [W, N]
    r_eff = (rb[:, None] + spread[..., None]) * (1.0 + CULL_REL) + CULL_ABS      # [W, T, N]
    d = inst[:, None, 0:3] - ro_mean[..., None]                                  # [W, T, 3, N]
    dist = torch.sqrt(torch.clamp((d * d).sum(2), min=1e-9))
    cos_ad = (d * ax[..., None]).sum(2) / dist
    sin_b = (r_eff / dist).clamp(0.0, 1.0)
    cos_b = torch.sqrt(torch.clamp(1.0 - sin_b * sin_b, min=0.0))
    cos_m = cos_m[..., None]
    keep = ((cos_m <= -cos_b) | (cos_ad >= cos_m * cos_b - sin_m * sin_b) | (dist <= r_eff)
            | (row[..., rkm.K_PRIM] == 2)[:, None])
    live = inst[:, rkm.I_MASK] > 0.5
    n = (keep & live[:, None]).sum(-1).double()
    return {"mean": float(n.mean()), "max": int(n.max()), "tiles_per_world": n.shape[1],
            "live_instances_per_world": float(live.sum(1).double().mean())}


def main_simple_taskgraph(torch, stg, steps, count, card, reset_counts, read_counts):
    """simple_taskgraph at 1024 x 100 with 64 x 64 rendering: 3 warm-up
    steps, then ``count`` windows of ``steps`` steps; one launch each of
    the single-substep kernel a substep and of the render kernel a step and
    no other kernel, finite positions, finite depth on every hit and alpha
    255 exactly where the depth is finite."""
    sim = stg_sim(stg, STG_WORLDS)
    sim.block_until_ready()
    reset_counts()
    wins = windows(sim, steps, count)
    launches = read_counts()
    want = {name: 0 for name in launches}
    want["substep"] = 4 * steps * count
    want["render"] = steps * count
    check(launches == want, f"simple_taskgraph launches {launches}")
    pos, mask = sim.get_exported(2)
    check(bool(torch.isfinite(pos[mask]).all()), "finite positions (simple_taskgraph)")
    rgb, depth = sim.rgb_observations(), sim.depth_observations()
    check(tuple(rgb.shape) == (STG_WORLDS, 1, STG_RES, STG_RES, 4) and rgb.dtype == torch.uint8,
          "simple_taskgraph rgb shape")
    hit = rgb[..., 3] == 255
    check(bool(((rgb[..., 3] == 0) | hit).all()), "alpha is 0 or 255")
    check(torch.equal(hit, torch.isfinite(depth)), "alpha 255 exactly where depth is finite")
    check(bool(hit.any()) and bool((depth[hit] > 0).all()), "positive depth on the hits")
    overflow = {k: int(v.sum()) for k, v in sim.overflow_counters().items()}
    return sim, {"worlds": STG_WORLDS, "objects": STG_OBJECTS, "resolution": STG_RES,
                 "substeps": 4, "launches": launches, "hit_share": float(hit.double().mean()),
                 "overflow_sum": overflow,
                 "env_steps_per_s": rates(steps, wins, STG_WORLDS), "card": card}


def rl_cases():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_rl_cases
    return test_torch_rl_cases


def parity_learner(torch):
    """One PPO train step of the CPU tests' scripted RL world on the card
    and on the CPU, from the same parameters and draws (made once with
    numpy, moved to each device): the largest differences, gated at the
    CPU test's tolerances."""
    cases = rl_cases()
    cpu = cases.rl_train_step("cpu")
    card = cases.rl_train_step("cuda")
    diff = cases.rl_card_vs_cpu(card, cpu)
    over = cases.within(diff, cases.LEARNER_TOL)
    line = {"phase": "parity_learner", "worlds": cases.RL_WORLDS, "ppo": cases.RL_PPO,
            "loss": {"card": card[0], "cpu": cpu[0]},
            "mean_reward": {"card": card[1], "cpu": cpu[1]},
            "max_abs_err": diff, "tolerance": cases.LEARNER_TOL}
    check(not over, f"the learner on the card vs the CPU, over tolerance: {over}")
    check(cpu[1] > 0, "the learner case deals rewards")
    return line


def parity_reset(torch):
    """The reset tests' worlds (a table of start heights; start heights
    from each world's generator stream), 40 steps of 1024 worlds on the
    card and on the CPU: positions, masks and ticks equal."""
    cases = rl_cases()
    out = {}
    for name, world in (("table", cases.PORT_TABLE), ("random", cases.PORT_RANDOM)):
        cpu = cases.reset_run(world, "cpu", 40, num_worlds=1024)
        gpu = cases.reset_run(world, "cuda", 40, num_worlds=1024)
        differing = [int((a != b).sum()) for a, b in zip(gpu, cpu)]
        resets = int((cpu[2][1:] == 1).sum())
        out[name] = {"differing": dict(zip(("positions", "masks", "ticks"), differing)),
                     "resets": resets}
        check(sum(differing) == 0, f"reset world {name}: card vs CPU {differing}")
        check(resets >= 3 * 1024, f"reset world {name}: {resets} resets")
    return {"phase": "parity_reset", "worlds": 1024, "steps": 40, **out}


def bindings_phase(torch, col, bindings):
    """The Tensor hand-off on the card: to_torch is the column itself (its
    data_ptr), an injected action round-trips through set_exported and a
    step."""
    sim = col.make_executor(col.CollisionsConfig(num_worlds=NUM_WORLDS), device="cuda")
    t = bindings.exported_tensor(sim, 0)
    tt = t.to_torch()
    column = sim.mgr.column(sim.state, col.CubeObject, col.Translation)
    check(tt.device == column.device and tt.data_ptr() == column.data_ptr(), "to_torch shares the column")
    actions = tt.clone()
    actions[:, :, 2] = 5.0
    sim.set_exported(0, bindings.Tensor.from_torch(actions))
    sim.step()
    t2 = bindings.exported_tensor(sim, 0).sync()
    dz = float((t2.values[t2.mask][:, 2] - 5.0).abs().max())
    check(dz < 2.0, f"the injected z after a step ({dz})")
    host = t2.to_numpy()
    check(float(abs(host - t2.values.cpu().numpy()).max()) == 0.0, "to_numpy copies the column")
    return {"phase": "bindings", "worlds": NUM_WORLDS, "same_storage": True,
            "shape": list(t.shape), "dtype": str(t.dtype),
            "injected_z_max_abs_dev_after_step": dz}


def main_ppo_fantasy_vs(torch, fvs, learner_mod, smi, reset_counts, read_counts,
                        timed=5, by_part=2):
    """PPO on fantasy_vs at 16384 worlds x (50 + 200), cleanup on, the JAX
    learner's defaults with the options of __graft_entry__.dryrun_multichip
    (2 epochs, 2 minibatches, observation normalisation): one untimed train
    step, ``timed`` timed ones (each ended by a synchronise), ``by_part``
    with the rollout and the update timed apart (CUDA events), one under
    the sync-debug mode "error"."""
    import numpy as np
    cfg = fvs.FantasyVsConfig(num_worlds=FVS_WORLDS, num_dragons=50, num_knights=200,
                              cleanup=True)
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = fvs.make_rl_env(cfg, device="cuda")
    pcfg = learner_mod.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, epochs=2,
                                 num_minibatches=2, normalize_obs=True)
    learner = learner_mod.PPOLearner(pcfg, sim.graph.step, obs_fn, inject_fn, reward_fn,
                                     seed=0, device="cuda")
    start = {k: v.clone() for k, v in learner.params.items()}
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = sim.state
    t0 = time.perf_counter()
    state, loss, rew = learner.train_step(state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    step_s, losses, rewards = [], [float(loss)], [float(rew)]
    for _ in range(timed):
        t0 = time.perf_counter()
        state, loss, rew = learner.train_step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        rewards.append(float(rew))
    rollout_ms, update_ms = [], []
    for _ in range(by_part):
        eps, perms = learner.draws(FVS_WORLDS)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        state, traj, last_value = learner.rollout(state, learner.params, learner.norm, eps)
        ev[1].record()
        loss, rew = learner.learn(traj, last_value, perms)
        ev[2].record()
        del traj
        torch.cuda.synchronize()
        rollout_ms.append(ev[0].elapsed_time(ev[1]))
        update_ms.append(ev[1].elapsed_time(ev[2]))
        losses.append(float(loss))
        rewards.append(float(rew))
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        state, loss, rew = learner.train_step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sync_debug_s = time.perf_counter() - t0
    losses.append(float(loss))
    rewards.append(float(rew))
    steps = 1 + timed + by_part + 1
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    check(all(v == 0 for v in launches.values()), f"PPO on fantasy_vs launched {launches}")
    check(all(np.isfinite(losses)) and all(np.isfinite(rewards)), "finite loss and reward")
    check(any(not torch.equal(start[k], v) for k, v in learner.params.items()),
          "the parameters changed")
    want = np.float32(1e-4)
    for _ in range(steps):   # the learner's float32 running count
        want = np.float32(want + np.float32(pcfg.rollout_len * FVS_WORLDS))
    count = float(learner.norm["count"])
    check(count == float(want), f"norm count {count} != {float(want)}")
    check(all(bool(torch.isfinite(v).all()) for v in learner.params.values()),
          "finite parameters")
    med = sorted(step_s)[len(step_s) // 2]
    return {"phase": "main_ppo_fantasy_vs", "worlds": FVS_WORLDS, "dragons": 50,
            "knights": 200, "cleanup": True, "obs_dim": obs_dim, "act_dim": act_dim,
            "ppo": {k: getattr(pcfg, k) for k in ("hidden", "rollout_len", "epochs",
                                                  "num_minibatches", "normalize_obs")},
            "samples_per_step": pcfg.rollout_len * FVS_WORLDS, "train_steps": steps,
            "launches": launches, "first_step_s": first_s, "step_s": step_s,
            "train_steps_per_s": {"median": 1.0 / med, "min": 1.0 / max(step_s),
                                  "max": 1.0 / min(step_s)},
            "env_steps_per_s": {"median": FVS_WORLDS * pcfg.rollout_len / med,
                                "min": FVS_WORLDS * pcfg.rollout_len / max(step_s),
                                "max": FVS_WORLDS * pcfg.rollout_len / min(step_s)},
            "rollout_device_ms": rollout_ms, "update_device_ms": update_ms,
            "peak_allocated_gib": peak / 2 ** 30,
            "peak_over_start_gib": (peak - base_bytes) / 2 ** 30,
            "loss": losses, "mean_reward": rewards, "norm_count": count,
            "sync_debug_step_s": sync_debug_s, "card": smi}


def rank_cases():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_rank_cases
    return test_torch_rank_cases


def main_ppo_fantasy_vs_ranks(torch, fvs, learner_mod, mesh_mod, smi, reset_counts,
                              read_counts, unranked, timed=5):
    """The learner across ranks over a one-rank NCCL group at
    main_ppo_fantasy_vs's configuration: its first train step from seed 0
    held to the learner built without a mesh (one rank, no process group;
    same seed, same world state) within LEARNER_TOL; ``timed`` timed
    train steps beside main_ppo_fantasy_vs's
    (``unranked``, its line), one under the sync-debug mode "error"."""
    import numpy as np
    cases, ranks = rl_cases(), rank_cases()
    cfg = fvs.FantasyVsConfig(num_worlds=FVS_WORLDS, **ranks.FVS_MAIN)
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = fvs.make_rl_env(cfg, device="cuda")
    pcfg = learner_mod.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **ranks.PPO_MAIN)

    def learner(mesh=None):
        return learner_mod.PPOLearner(pcfg, sim.graph.step, obs_fn, inject_fn, reward_fn,
                                      seed=0, device="cuda", mesh=mesh)

    plain = learner()
    start = {k: v.cpu().numpy() for k, v in plain.params.items()}
    _, loss, rew = plain.train_step(sim.state)
    want = ranks.learner_result(loss, rew, plain)
    del plain
    mesh_mod.initialize_distributed(f"127.0.0.1:{ranks.free_port()}", 1, 0, device="cuda")
    try:
        backend = torch.distributed.get_backend()
        check(backend == "nccl", f"the one-rank group's backend is {backend}")
        mesh = mesh_mod.make_world_mesh("cuda:0")
        ranked = learner(mesh)
        state = mesh_mod.shard_state(sim.state, mesh)
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, loss, rew = ranked.train_step(state)
        got = ranks.learner_result(loss, rew, ranked)
        step_s, losses = [], [got["loss"]]
        for _ in range(timed):
            t0 = time.perf_counter()
            state, loss, rew = ranked.train_step(state)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, loss, rew = ranked.train_step(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        losses.append(float(loss))
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.distributed.destroy_process_group()
    diff = cases.learner_differences(got, want, start)
    diff["loss_rel"] = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    diff["mean_reward"] = abs(got["mean_reward"] - want["mean_reward"])
    over = cases.within(diff, cases.LEARNER_TOL)
    check(not over, f"the one-rank learner vs the learner without a mesh: {over}")
    check(all(v == 0 for v in launches.values()), f"PPO across ranks launched {launches}")
    check(all(np.isfinite(losses)), "finite losses")
    med = sorted(step_s)[len(step_s) // 2]
    steps_per_s = {"median": 1.0 / med, "min": 1.0 / max(step_s), "max": 1.0 / min(step_s)}
    env_per_s = {k: v * FVS_WORLDS * pcfg.rollout_len for k, v in steps_per_s.items()}
    return {"phase": "main_ppo_fantasy_vs_ranks", "backend": backend, "ranks": 1,
            "worlds": FVS_WORLDS, "dragons": 50, "knights": 200, "cleanup": True,
            "ppo": ranks.PPO_MAIN, "first_step_vs_unranked": diff,
            "tolerance": cases.LEARNER_TOL, "step_s": step_s,
            "train_steps_per_s": steps_per_s, "env_steps_per_s": env_per_s,
            "unranked": {k: unranked[k] for k in ("train_steps_per_s", "env_steps_per_s",
                                                   "peak_allocated_gib", "peak_over_start_gib")},
            "peak_allocated_gib": peak / 2 ** 30,
            "peak_over_start_gib": (peak - base_bytes) / 2 ** 30, "sync_debug_step": "clean",
            "launches": launches, "loss": losses, "card": smi}


SHARED_FVS_WORLDS, SHARED_COL_STEPS = 4096, 10


def shared_card_phases(torch, col, smi):
    """Two processes on the one card over gloo (NCCL refuses two ranks on one
    device; gloo's collectives on CUDA tensors go through the host, so these
    steps sync it): parity_ranks_shared_card, one PPO train step of 2 x 2048
    worlds of main_ppo_fantasy_vs's configuration from seed 0 against one
    process at 4096 worlds on the card, within LEARNER_TOL; and
    sharded_collisions, each rank's 4096 of the main path's 8192 x 100
    collisions worlds stepped 10 times with kernel 1, every leaf bit for
    bit the matching rows of one process, kernel 1's launches = steps a
    rank."""
    import numpy as np
    from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy
    from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
    cases, ranks = rl_cases(), rank_cases()
    work = os.path.join(HERE, "build", "shared_card")
    os.makedirs(work, exist_ok=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = ranks.run_ranks(work, "shared_card_worker", 2, os.path.join(work, "ranks"),
                          SHARED_FVS_WORLDS, NUM_WORLDS, SHARED_COL_STEPS, timeout=300)
    workers_s = time.perf_counter() - t0
    res = []
    for r in range(2):
        with np.load(os.path.join(work, f"ranks.{r}.npz")) as z:
            res.append(dict(z))
    got = [ranks.result_tree(x, "learner/") for x in res]
    want = ranks.fvs_train_step("cuda", SHARED_FVS_WORLDS)
    learners = []
    for g in got:
        for k, v in want["start"].items():
            check(np.array_equal(g["start"][k], v), f"the ranks start from other parameters {k}")
        diff = cases.learner_differences(g, want, want["start"])
        diff["loss_rel"] = abs(g["loss"] - want["loss"]) / abs(want["loss"])
        diff["mean_reward"] = abs(g["mean_reward"] - want["mean_reward"])
        learners.append(diff)
        over = cases.within(diff, cases.LEARNER_TOL)
        check(not over, f"2 ranks on one card vs one process: {over}")
    for k in got[0]["params"]:
        check(np.array_equal(got[0]["params"][k], got[1]["params"][k]),
              f"the ranks' parameters {k} differ")
    parity = {"phase": "parity_ranks_shared_card", "backend": "gloo", "ranks": 2,
              "worlds": SHARED_FVS_WORLDS, "per_rank": SHARED_FVS_WORLDS // 2,
              "ppo": ranks.PPO_MAIN, "max_abs_err": learners, "tolerance": cases.LEARNER_TOL,
              "loss": {"ranks": got[0]["loss"], "one": want["loss"]},
              "mean_reward": {"ranks": got[0]["mean_reward"], "one": want["mean_reward"]},
              "workers_s": workers_s, "host_syncs": "gloo on CUDA tensors", "card": smi}
    ck.fused_collisions_step.launches = 0
    one = col.make_executor(ranks.collisions_config("main", NUM_WORLDS, True), device="cuda")
    one.run(SHARED_COL_STEPS)
    one_launches = ck.fused_collisions_step.launches
    full = state_to_numpy(one.state)
    differing = [ranks.rank_state_rows(x, full) for x in res]
    sums = [float(x["checksum"][0]) for x in res]
    launches = [int(x["launches"]) for x in res]
    check(one_launches == SHARED_COL_STEPS, f"one process launched kernel 1 {one_launches}x")
    check(differing == [[], []], f"sharded collisions differ from one process: {differing}")
    check(launches == [SHARED_COL_STEPS] * 2, f"kernel 1 launches by rank {launches}")
    check(sums[0] == sums[1] > 0, f"cross-rank checksums {sums}")
    sharded = {"phase": "sharded_collisions", "backend": "gloo", "ranks": 2,
               "worlds": NUM_WORLDS, "objects": 100, "steps": SHARED_COL_STEPS,
               "kernel_1_launches_by_rank": launches, "differing_leaves": differing,
               "leaves_compared": sum(1 for k in res[0] if k.startswith("state/")),
               "checksum": sums, "worker_stdout": [o.strip() for o in out]}
    return parity, sharded


def profiler_phase(torch, col, stg, prof, smi):
    """tooling/profiler.py on the card: profile_nodes (5 runs a node) and
    trace_step (3 steps) -> node_timeline on collisions fused (8192 x 100)
    and simple_taskgraph (1024 x 100, 64 x 64): the executor's state bit
    for bit the same after profile_nodes and trace_step, the timeline's node
    segments inside their step spans and its node totals within the
    steps'; the SVG written under build/profile/."""
    import numpy as np
    from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        else:
            yield path, tree

    line = {"phase": "profiler", "card": smi}
    sims = {"collisions_fused": lambda: col.make_executor(
                col.CollisionsConfig(num_worlds=NUM_WORLDS, fused=True), device="cuda"),
            "simple_taskgraph": lambda: stg_sim(stg, STG_WORLDS)}
    for name, make in sims.items():
        sim = make()
        sim.run(3)
        torch.cuda.synchronize()
        before = dict(leaves(state_to_numpy(sim.state)))
        rows = prof.profile_nodes(sim, iters=5)
        d = os.path.join(HERE, "build", "profile", name)
        prof.trace_step(sim, d, steps=3)
        after = dict(leaves(state_to_numpy(sim.state)))
        changed = [k for k in before if not np.array_equal(before[k], after[k])]
        check(before.keys() == after.keys() and not changed,
              f"{name}: profiling changed the state at {changed}")
        tl = prof.node_timeline(d)
        check(len(tl["steps"]) == 3 and tl["nodes"], f"{name}: the timeline's steps")
        for step in tl["steps"]:
            for seg in step["segments"]:
                check(seg["start_us"] >= 0
                      and seg["start_us"] + seg["dur_us"] <= step["dur_us"] + 1e-3,
                      f"{name}: a segment outside its step {seg}")
        step_us = [s["dur_us"] for s in tl["steps"]]
        node_us = sum(r["total_us"] for r in tl["nodes"])
        check(node_us <= sum(step_us) + 0.1 * len(tl["nodes"]),
              f"{name}: node totals {node_us} over the steps' {sum(step_us)}")
        check(set(r["node"] for r in tl["nodes"]) <= set(sim.graph.node_names),
              f"{name}: unknown nodes in the timeline")
        svg = prof.render_timeline_svg(tl, os.path.join(d, "timeline.svg"))
        line[name] = {"worlds": sim.cfg.num_worlds, "profile_nodes": rows,
                      "timeline_step_us": step_us, "timeline_nodes": tl["nodes"],
                      "svg": os.path.relpath(svg, HERE), "state_unchanged": True}
        del sim
    return line


TUNE_PHYSICS_WORLDS, TUNE_PHYSICS_BODIES = 1024, 64


def autotune_phase(torch, col, tuner, smi, reset_counts, read_counts):
    """tooling/autotuner.py on the card: tune_collisions at 8192 x 100 and
    tune_physics_substep at rigid_bench 1024 x 64 ("dense", "pairs",
    "pallas"), each candidate in a fresh process; the artifact saved under
    build/autotune/.  With GEM_TPU_EXEC_CONFIG_FILE at a validated "cuda"
    entry {"fused": false, "use_kernel": true} (the tuner's unfused
    candidate), the default CollisionsConfig(fused=None) launches kernel 2
    and never kernel 1; with {"fused": true} kernel 1; the
    repository's gem_tune.json ("tpu" entries) gives None for every kind
    and is not written."""
    import hashlib
    work = os.path.join(HERE, "build", "autotune")
    os.makedirs(work, exist_ok=True)
    repo_tune = os.path.join(HERE, "gem_tune.json")
    digest = hashlib.sha256(open(repo_tune, "rb").read()).hexdigest()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    entries = [tuner.tune_collisions(NUM_WORLDS, 100, ticks=200, device="cuda", timeout=300),
               tuner.tune_physics_substep(TUNE_PHYSICS_WORLDS, TUNE_PHYSICS_BODIES, ticks=5,
                                          device="cuda", timeout=300)]
    sweep_s = time.perf_counter() - t0
    for e in entries:
        check(e["backend"] == "cuda" and not e["failed"], f"a tuner candidate failed: {e}")
    path = tuner.save(entries, os.path.join(work, "gem_tune.json"))
    consumer = {}
    old = os.environ.get(tuner.CONFIG_ENV)
    try:
        for fused in (False, True):
            p = os.path.join(work, f"consumer_fused_{fused}.json")
            if os.path.exists(p):
                os.remove(p)
            tuner.save([{"kind": "collisions",
                         "key": {"num_worlds": NUM_WORLDS, "num_objects": 100},
                         "config": {"fused": fused, "use_kernel": True}, "backend": "cuda",
                         "validated": True}], p)
            os.environ[tuner.CONFIG_ENV] = p
            reset_counts()
            sim = col.make_executor(col.CollisionsConfig(num_worlds=NUM_WORLDS), device="cuda")
            sim.run(3)
            torch.cuda.synchronize()
            c = read_counts()
            got = (c["fused_collisions_step"], c["collision_pushes"])
            check(got == ((3, 0) if fused else (0, 3)),
                  f"the consumer of {{'fused': {fused}}} launched kernels 1, 2: {got}")
            consumer[f"fused_{str(fused).lower()}"] = {"kernel_1": got[0], "kernel_2": got[1]}
            del sim
        os.environ[tuner.CONFIG_ENV] = repo_tune
        repo = {kind: tuner.lookup(kind, num_worlds=8192, num_objects=100, bodies=64)
                for kind in ("collisions", "physics_substep", "physics_capacity")}
        check(all(v is None for v in repo.values()), f"the repo's gem_tune.json gave {repo}")
    finally:
        if old is None:
            os.environ.pop(tuner.CONFIG_ENV, None)
        else:
            os.environ[tuner.CONFIG_ENV] = old
    check(hashlib.sha256(open(repo_tune, "rb").read()).hexdigest() == digest,
          "gem_tune.json was written")
    return {"phase": "autotune", "entries": entries, "artifact": os.path.relpath(path, HERE),
            "sweep_s": sweep_s, "consumer": consumer, "repo_gem_tune_lookup": repo,
            "card": smi}


# -- past the body-row ceilings: the bodies in a global scratch, and 64-bit
# entity handles ---------------------------------------------------------------

# parity_substep's bodies-in-scratch cases, each bit for bit its plain version
# on BODY_PARITY_WORLDS worlds: kernel 7's windowed twins past their body
# ceiling, (bodies, contact refresh, imported prisms), after 3 steps from
# rigid_bench's default spawn (the prisms' from WINDOW_SPAWN, so that their
# valid slots pass the window); kernel 5 past its window layout: its JAX contract
# (without the integrate and joints) on rigid_bench at 815 bodies + the plane,
# and its node launch on simple_taskgraph at 1,064 objects (1,068 rows, K =
# 10,640) with random live joints among its 64 joint rows
BODY_PARITY_WORLDS = 8
BODY_CASES = {"n970": (969, False, False), "n1024": (1023, False, False),
              "n896_refresh": (895, True, False), "n372_prisms": (371, False, True),
              "n513_prisms": (512, False, True)}
KERNEL5_BODY_ROWS = 815
KERNEL5_BODY_OBJECTS = 1064
# main_simple_taskgraph_large: simple_taskgraph at 1,000 objects (1,004 rows,
# K = 10,000, four kernel-5 launches a step with the bodies in the scratch);
# cut to STG_LARGE_CUT worlds if a step passes STG_LARGE_STEP_MS
STG_LARGE_WORLDS, STG_LARGE_OBJECTS = 1024, 1000
STG_LARGE_CUT, STG_LARGE_STEP_MS = 256, 150.0
STG_LARGE_STEPS, STG_LARGE_WINDOWS = 10, 3
# main_rigid_sap_xlarge: main_rigid_sap_large's config at 1,023 bodies (1,024
# rows, K = 4,092; the windowed twin with the bodies in the scratch, and sap);
# cut to XLARGE_CUT worlds only if the card's memory or the script's time
# forces it
XLARGE_BODIES, XLARGE_K = 1023, 4092
XLARGE_WORLDS, XLARGE_CUT = 8192, 4096
XLARGE_STEPS, XLARGE_WINDOWS = 5, 3
# the entity64 phase's churn: recycles of one slot, past the int32 default's
# 2^11 generations
ENTITY64_CHURN = 2100


def parity_bodies(torch, rb, phys, sk):
    """parity_substep's bodies-in-scratch cases (BODY_CASES and kernel 5's),
    each at BODY_PARITY_WORLDS worlds, twice and bit for bit its plain
    version.  Returns ({case: line}, the worst error)."""
    hs = hull_scenes()
    W = BODY_PARITY_WORLDS
    cases = {}
    for name, (bodies, refresh, prisms) in BODY_CASES.items():
        if prisms:
            sim = hull_sim(rb, hs, steps=3, num_worlds=W, num_bodies=bodies, **WINDOW_SPAWN)
        else:
            sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=W, num_bodies=bodies,
                                                       contact_mode="pallas"), device="cuda")
            sim.run(3)
        kern = sk.FusedSubstepKernel(sim.world_cls.objmgr, 4, relaxation=0.7,
                                     contact_refresh=refresh)
        line = window_case(torch, sk, kern, fused_inputs(sim, rb, phys), plain_worlds=W)
        check("bodies" in line["specialisation"], f"{name}: {line['specialisation']}")
        cases[f"bodies_{name}"] = line
        del sim
    # kernel 5, the JAX contract, past its window layout
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=W, num_bodies=KERNEL5_BODY_ROWS,
                                               contact_mode="pallas"), device="cuda")
    sim.run(3)
    kw1 = phys.RigidBodyPhysicsSystem.substep_kernel_inputs(fused_inputs(sim, rb, phys))
    n, K = KERNEL5_BODY_ROWS + 1, kw1["rows_i"].shape[1]
    single = sk.SubstepKernel(rb.RigidBenchWorld.objmgr, relaxation=0.7)
    check(sk.substep_bodies(single.tables, n, K), f"kernel 5 at n={n}, K={K}: not in the scratch")
    sk.SubstepKernel.body_launches = 0
    errs = substep1_case(torch, sk, single, kw1, exact=True)
    check(sk.SubstepKernel.body_launches == 2, "kernel 5 at 816 rows: launches in the scratch")
    cases["bodies_substep_n816"] = {
        "kernel": "substep", "W": W, "n": n, "K": K,
        "valid_slots_max": int(kw1["kvalid"].sum(1).max()), "max_err": errs}
    del sim, kw1
    # kernel 5's node launch with live joints past its window layout
    from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_joint_scenes as joint_scenes
    rsim = stg.make_executor(stg.SimpleTaskgraphConfig(
        num_worlds=W, num_objects=KERNEL5_BODY_OBJECTS, seed=3), device="cuda")
    rsim.run(3)
    rkw = joint_scenes.random_joints(rsim, phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(
        rsim, stg.Sphere, None, node=True), num_spheres=KERNEL5_BODY_OBJECTS)
    n, K, J = rkw["obj"].shape[1], rkw["rows_i"].shape[1], rkw["jmask"].shape[1]
    kern = phys.RigidBodyPhysicsSystem.substep_kernel(rsim)
    check(sk.substep_bodies(kern.tables, n, K, J), f"kernel 5 node at n={n}: not in the scratch")
    live = int(live_joints(rkw).sum())
    check(live > 0, "random joints: none live")
    sk.SubstepKernel.body_launches = 0
    errs = node_case(torch, sk, kern, rkw, exact=True)
    check(sk.SubstepKernel.body_launches == 2, "kernel 5 node: launches in the scratch")
    cases["bodies_substep_node_n1068_J64"] = {
        "kernel": "substep", "W": W, "n": n, "K": K, "J": J, "live_joints": live,
        "valid_slots_max": int(rkw["kvalid"].sum(1).max()), "max_err": errs}
    return cases, max(max(c["max_err"].values()) for c in cases.values())


def node_chain_case(torch, sk, kern, kw, launches=4):
    """``launches`` successive node launches of kernel 5 (a step's substep
    nodes: each reads the pose and velocities the last wrote) against as
    many of its plain version, bit for bit: the worst error of each."""
    got_kw, want_kw = dict(kw), dict(kw)
    errs = []
    for _ in range(launches):
        got, want = kern.step(**got_kw), kern.step_plain(**want_kw)
        torch.cuda.synchronize()
        err = max(max_err(got[k], want[k]) for k in sk.NODE_KEYS)
        check(err == 0.0, f"kernel 5 node chain: {err} from the plain version")
        errs.append(err)
        got_kw.update({k: got[k] for k in sk.SUBSTEP_KEYS})
        want_kw.update({k: want[k] for k in sk.SUBSTEP_KEYS})
    return errs


# main_simple_jobs_large: windows ended by a synchronise; the plain version
# (its [W, n0, n0, 3] push grid) on SJL_PLAIN_WORLDS worlds; the rank path
# (fused=False), the route the parent took there, at SJL_RANK_WORLDS worlds
# (its [W, n0, n0] int64 scatter index alone is 34 GB at 1,024 worlds)
SJL_STEPS, SJL_WINDOWS = 10, 3
SJL_PLAIN_WORLDS, SJL_RANK_WORLDS = 8, 256
# After 3 steps rows sum ~110-190 pushes to |sum| ~180, which the kernel
# adds one after another: its translation's distance from the push in
# float64 (push_f64) is gated at twice the largest reading of its sound runs
# (6.17e-4 on an H100; the plain version's, in PyTorch's order, 1.71e-4).
SJL_F64_ATOL = 1.25e-3
# main_joint_rows_large: the chains' world (tests/test_torch_joint_scenes.py)
# at JRL_CHAINS chains of 16 boxes (1,088 bodies + the plane, 1,020 live
# joints a world) in 4,096 joint rows, K = JRL_K
JRL_WORLDS, JRL_CHAINS, JRL_K = 1024, 68, 2048
JRL_STEPS, JRL_WINDOWS = 10, 3


def push_f64(torch, sk, pos, rot, bounds):
    """The fused step's translation evaluated in float64 (the plain
    version's formula: clamp, the overlap grid from the float32 AABBs, the
    centred push), the reference both float32 sums are measured against."""
    p = sk.clamp_to_bounds(pos, bounds)
    lo, hi = sk.aabb_plain(p, rot)
    ok = sk.overlap_grid(lo, hi)
    p64 = p.double()
    pc = p64 - p64.mean(dim=1, keepdim=True)
    diff = pc[:, None, :, :] - pc[:, :, None, :]
    d2 = (diff * diff).sum(-1)
    m = torch.where(ok & (d2 > 1e-12), torch.rsqrt(d2.clamp(min=1e-30)), 0.0)
    return p64 - 2.0 * (m[..., None] * diff).sum(dim=2)


def main_simple_jobs_large(torch, sj, sk, card, reset_counts, read_counts):
    """simple_jobs at 1,024 worlds x 2,048 objects, K = 32,768, D = 32,
    fused=None on the card: kernel 4's rounds layout, one launch a step.
    The launch at the executor's initial state against its plain version
    on SJL_PLAIN_WORLDS worlds (integers, lo and hi exact, translation atol
    1e-4, normals 1e-5; a repeat bit-identical on every world); windows of
    SJL_STEPS steps; the same comparison after 3 steps, the normals still
    within 1e-5 (per pair, from exact clamped positions: no sum order
    touches them) and the translation, which the kernel sums one partner
    after another and the plain version in PyTorch's order, gated against
    the push in float64 instead (SJL_F64_ATOL), both versions' distances
    from it reported; the launch's ms beside its bound (the bytes, and the
    unordered pair tests at 6 operations with 20 more an overlapping
    ordered pair);
    and the unfused rank path's step at SJL_RANK_WORLDS worlds.  Returns
    (its line, the launch's timing)."""
    cfg = dict(num_worlds=SJL_WORLDS, num_objects=SJL_OBJECTS, max_pairs=SJL_K,
               degree_cap=SJL_D)
    sim = sj.make_executor(sj.SimpleJobsConfig(**cfg), device="cuda")
    check(sim.graph.node_names == ["fused_step"] and sk.rounds(SJL_OBJECTS),
          f"simple_jobs large: fused=None built {sim.graph.node_names}")
    kw = dict(n0=SJL_OBJECTS, K=SJL_K, degree_cap=SJL_D, bounds=(sj.BOUNDS_LO, sj.BOUNDS_HI))
    P = SJL_PLAIN_WORLDS
    names = ("translation", "lo", "hi", "ab", "normals", "counts", "dropped")
    floats = ("translation", "normals")
    inf = float("inf")

    def against_plain(atol):
        """The launch at the state against its plain version on P worlds
        (integers, lo and hi exact; the floats and the kernel's translation
        from the push in float64 (push_f64, "translation_vs_f64") within
        ``atol``, where it names them), a repeat bit-identical on every
        world; the float errors, and the kernel's and the plain version's
        distances from push_f64."""
        user = sim.state["user"]
        pos, rot = user["translation"], user["rotation"]
        got, again = (sk.fused_simple_jobs_step(pos, rot, **kw) for _ in range(2))
        want = sk.fused_simple_jobs_step_plain(pos[:P].contiguous(), rot[:P].contiguous(), **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, a, a2, b in zip(names, got, again, want):
            check(bool(torch.equal(a.view(torch.int32), a2.view(torch.int32))),
                  f"simple_jobs large {name}: a repeated launch differs")
            check(bool(torch.isfinite(a).all()), f"simple_jobs large {name} finite")
            if name in floats:
                errs[name] = max_err(a[:P], b)
                check(errs[name] <= atol.get(name, inf),
                      f"simple_jobs large {name} err {errs[name]}")
            else:
                check(bool(torch.equal(a[:P], b)), f"simple_jobs large {name} not exact")
        check(int(got[6].min()) > 0, "simple_jobs large: a world dropped no pair")
        exact = push_f64(torch, sk, pos[:P], rot[:P], kw["bounds"])
        errs["translation_vs_f64"] = {"kernel": max_err(got[0][:P].double(), exact),
                                      "plain": max_err(want[0].double(), exact)}
        check(errs["translation_vs_f64"]["kernel"] <= atol.get("translation_vs_f64", inf),
              f"simple_jobs large translation {errs['translation_vs_f64']} from float64")
        return errs

    # at the executor's initial state (parity_simple_jobs' "main" case's
    # gate), and after 3 steps, where bodies pressed against the bounds
    # sum ~100-190 pushes a row to |sum| ~ 180
    errs = against_plain({"translation": 1e-4, "normals": 1e-5})
    sim.run(3)
    sim.block_until_ready()
    errs_stepped = against_plain({"normals": 1e-5, "translation_vs_f64": SJL_F64_ATOL})
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wins = windows(sim, SJL_STEPS, SJL_WINDOWS)
    launches = read_counts()
    steps = SJL_STEPS * SJL_WINDOWS
    expect = {name: 0 for name in launches}
    expect["fused_simple_jobs_step"] = steps
    check(launches == expect, f"simple_jobs large launches {launches}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    user = sim.state["user"]
    check(bool(torch.isfinite(user["translation"]).all()), "finite positions (simple_jobs large)")
    check(int(user["num_candidates"].abs().sum()) == 0
          and int(user["num_contacts"].abs().sum()) == 0, "simple_jobs large counters reset")
    # the launch at the state the windows left, beside its bound and plain version
    pos, rot = user["translation"], user["rotation"]
    ms = cuda_ms(torch, lambda: sk.fused_simple_jobs_step(pos, rot, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: sk.fused_simple_jobs_step_plain(
        pos[:P].contiguous(), rot[:P].contiguous(), **kw), 3, warmup=1)
    _, lo, hi, _, _, cnt, drp = sk.fused_simple_jobs_step(pos, rot, **kw)
    mask = torch.ones(pos.shape[:2], dtype=torch.bool, device=pos.device)
    live, over = pair_counts(torch, lo, hi, mask)
    W, n = mask.shape
    # the half-box filter tests each unordered pair once (chunk pairs ci <= cj)
    b_ms, b_by = bound(W * (n * 28 + n * 36 + SJL_K * 20 + 8),
                       W * n * 40 + live / 2 * 6 + over * 20)
    timing = {"ms": ms, "plain_ms": plain_ms, "plain_ms_is": f"{P} of the {W} worlds",
              "bound_ms": b_ms, "bound_by": b_by,
              "live_pairs": live, "overlapping_pairs": over,
              "shape": sk.occupancy(W, n, SJL_K),
              "max_abs_err": max(errs["translation"], errs["normals"])}
    del lo, hi
    # the unfused rank path at the same shape (fewer worlds), its step
    os.environ["GEM_SJ_COMPACT"] = "rank"
    rsim = sj.make_executor(sj.SimpleJobsConfig(
        fused=False, **dict(cfg, num_worlds=SJL_RANK_WORLDS)), device="cuda")
    rsim.run(1)
    rsim.block_until_ready()
    rwins = windows(rsim, 2, 2)
    del rsim
    torch.cuda.empty_cache()
    line = {"phase": "main_simple_jobs_large", "worlds": W, "objects": n, "max_pairs": SJL_K,
            "degree_cap": SJL_D, "launches": launches,
            "env_steps_per_s": rates(SJL_STEPS, wins, W),
            "pairs_a_world": {"counted": float(cnt.double().mean()),
                              "dropped": float(drp.double().mean()),
                              "overlapping_ordered": over / W},
            "kernel_vs_plain": {"worlds": P, "ints_lo_hi": "exact", "initial_state": errs,
                                "after_3_steps": errs_stepped},
            "launch": timing, "peak_allocated_gib": peak,
            "rank_path": {"worlds": SJL_RANK_WORLDS,
                          "env_steps_per_s": rates(2, rwins, SJL_RANK_WORLDS),
                          "step_s": min(rwins) / 2},
            "card": card}
    return line, timing


def main_joint_rows_large(torch, phys, sk, card, reset_counts, read_counts):
    """The chains' world (tests/test_torch_joint_scenes.py chain_world) at
    1,024 worlds x JRL_CHAINS chains of 16 boxes, 4,096 joint rows of which
    1,020 live (alternating Fixed and Hinge), kernel mode: four kernel-5
    launches a step, the joint rows in the body scratch.  The node chain on
    4 worlds bit for bit its plain version; windows of JRL_STEPS steps; the
    node launch's ms beside its bound and its plain version's.  Returns
    (its line, the launch's timing)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_joint_scenes as joint_scenes
    sim = joint_scenes.chain_world("pallas", num_worlds=JRL_WORLDS, device="cuda",
                                   num_chains=JRL_CHAINS, max_candidates=JRL_K)
    sim.run(3)
    sim.block_until_ready()
    RS = phys.RigidBodyPhysicsSystem
    kern = RS.substep_kernel(sim)
    kw = RS.next_step_kernel_inputs(sim, sim.world_cls.Body, None, node=True)
    n, K, J = kw["obj"].shape[1], kw["rows_i"].shape[1], kw["jmask"].shape[1]
    live = live_joints(kw).sum(1)
    check(J == 4096 and sk.substep_joints_in_scratch(kern.tables, n, K, J),
          f"joint rows: J={J} at n={n}, K={K} not in the body scratch")
    check(int(live.min()) >= 1000, f"joint rows: {int(live.min())} live joints in a world")
    kw4 = {k: v[:4].contiguous() if torch.is_tensor(v) and v.shape[:1] == (JRL_WORLDS,) else v
           for k, v in kw.items()}
    kw4["joints"] = {f: t[:4].contiguous() for f, t in kw["joints"].items()}
    kw4["eid"] = {f: t[:4].contiguous() for f, t in kw["eid"].items()}
    chain = node_chain_case(torch, sk, kern, kw4)
    del kw4
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sk.SubstepKernel.joint_scratch_launches = 0
    wins = windows(sim, JRL_STEPS, JRL_WINDOWS)
    launches = read_counts()
    steps = JRL_STEPS * JRL_WINDOWS
    expect = {name: 0 for name in launches}
    expect["substep"] = 4 * steps
    check(launches == expect, f"joint rows launches {launches}")
    check(sk.SubstepKernel.joint_scratch_launches == 4 * steps, "joint rows: layout")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pos, mask = sim.get_exported(0)
    check(bool(torch.isfinite(pos[mask]).all()), "finite positions (joint rows)")
    kw = RS.next_step_kernel_inputs(sim, sim.world_cls.Body, None, node=True)
    ops, _, work = substep_work(torch, sk, kern, kw)
    b_ms, b_by = substep_bound(kw, ops)
    timing = {"ms": cuda_ms(torch, lambda: kern.step(**kw), 20),
              "plain_ms": cuda_ms(torch, lambda: kern.step_plain(**kw), 2, warmup=1),
              "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "work": work,
              "W": JRL_WORLDS, "n": n, "K": K, "J": J,
              "live_joints_a_world": int(live.min()),
              "occupancy": sk.occupancy(n, K, single=True, joints=J),
              "smem_bytes": sk.substep_layout_smem_bytes(kern.tables, n, K, J),
              "body_scratch_bytes_a_world": 4 * sk.body_scratch_floats(n, kern.tables, J),
              "max_abs_err": max(chain)}
    step_dev = cuda_ms(torch, sim.step, 3, warmup=1)
    line = {"phase": "main_joint_rows_large", "worlds": JRL_WORLDS, "rows": n, "K": K,
            "joint_rows": J, "live_joints_a_world": int(live.min()), "substeps": 4,
            "launches": launches, "launches_with_joint_rows_in_scratch": 4 * steps,
            "env_steps_per_s": rates(JRL_STEPS, wins, JRL_WORLDS),
            "device_ms_a_step": step_dev, "peak_allocated_gib": peak,
            "node_chain_4_worlds_max_err": chain, "node_launch": timing, "card": card}
    return line, timing


def main_simple_taskgraph_large(torch, stg, phys, sk, card, reset_counts, read_counts):
    """simple_taskgraph at 1,024 worlds x 1,000 objects (1,004 rows, K =
    10,000, 64 joint rows) with 64 x 64 rendering, "auto": four kernel-5
    launches a step with the bodies in the global scratch and the render
    kernel's views mode; cut to STG_LARGE_CUT worlds where a step passes
    STG_LARGE_STEP_MS.  Returns (its line, the node launch's timing)."""
    worlds, reduced = STG_LARGE_WORLDS, None
    while True:
        sim = stg.make_executor(stg.SimpleTaskgraphConfig(
            num_worlds=worlds, num_objects=STG_LARGE_OBJECTS, render=True,
            render_width=STG_RES, render_height=STG_RES), device="cuda")
        sim.run(3)
        sim.block_until_ready()
        t0 = time.perf_counter()
        sim.step()
        sim.block_until_ready()
        step_ms = 1e3 * (time.perf_counter() - t0)
        if step_ms <= STG_LARGE_STEP_MS or worlds == STG_LARGE_CUT:
            break
        reduced = f"worlds {worlds} -> {STG_LARGE_CUT}"
        worlds = STG_LARGE_CUT
        del sim
    kw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, stg.Sphere, stg.OBJMGR,
                                                              node=True)
    kern = phys.RigidBodyPhysicsSystem.substep_kernel(sim)
    n, K, J = kw["obj"].shape[1], kw["rows_i"].shape[1], kw["jmask"].shape[1]
    check(sk.substep_bodies(kern.tables, n, K, J), f"simple_taskgraph n={n}: not in the scratch")
    # the step's four node launches on 4 worlds, bit for bit their plain version
    kw4 = {k: v[:4].contiguous() if torch.is_tensor(v) and v.shape[:1] == (worlds,) else v
           for k, v in kw.items()}
    kw4["joints"] = {f: t[:4].contiguous() for f, t in kw["joints"].items()}
    kw4["eid"] = {f: t[:4].contiguous() for f, t in kw["eid"].items()}
    chain = node_chain_case(torch, sk, kern, kw4)
    del kw4
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sk.SubstepKernel.body_launches = 0
    wins = windows(sim, STG_LARGE_STEPS, STG_LARGE_WINDOWS)
    launches = read_counts()
    steps = STG_LARGE_STEPS * STG_LARGE_WINDOWS
    want = {name: 0 for name in launches}
    want["substep"], want["render"] = 4 * steps, steps
    check(launches == want, f"simple_taskgraph large launches {launches}")
    check(sk.SubstepKernel.body_launches == 4 * steps, "simple_taskgraph large: layout")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pos, mask = sim.get_exported(2)
    check(bool(torch.isfinite(pos[mask]).all()), "finite positions (simple_taskgraph large)")
    rgb, depth = sim.rgb_observations(), sim.depth_observations()
    hit = rgb[..., 3] == 255
    check(torch.equal(hit, torch.isfinite(depth)), "alpha 255 exactly where depth is finite")
    ops, _, work = substep_work(torch, sk, kern, kw)
    b_ms, b_by = substep_bound(kw, ops)
    node_t = {"ms": cuda_ms(torch, lambda: kern.step(**kw), 20),
              "plain_ms": cuda_ms(torch, lambda: kern.step_plain(**kw), 2, warmup=1),
              "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "work": work,
              "W": worlds, "n": n, "K": K, "J": J,
              "valid_slots_max": int(kw["kvalid"].sum(1).max()),
              "occupancy": sk.occupancy(n, K, single=True, joints=J),
              "smem_bytes": sk.substep_body_smem_bytes(n, K, J),
              "body_scratch_bytes_a_world": 4 * sk.body_scratch_floats(n, kern.tables)}
    step_dev = cuda_ms(torch, sim.step, 3, warmup=1)
    line = {"phase": "main_simple_taskgraph_large", "worlds": worlds,
            "objects": STG_LARGE_OBJECTS, "rows": n, "K": K, "joint_rows": J,
            "resolution": STG_RES, "substeps": 4, "launches": launches,
            "launches_with_bodies_in_scratch": 4 * steps,
            "env_steps_per_s": rates(STG_LARGE_STEPS, wins, worlds),
            "device_ms_a_step": step_dev, "first_step_ms": step_ms,
            "peak_allocated_gib": peak, "node_chain_4_worlds_max_err": chain,
            "hit_share": float(hit.double().mean()), "node_launch": node_t, "card": card}
    if reduced:
        line["reduced"] = reduced
    return line, node_t


def main_rigid_sap_xlarge(torch, rb, phys, sk, card, reset_counts, read_counts):
    """rigid_bench at 8,192 worlds x 1,023 bodies + the plane (K = 4,092),
    4 substeps, contact and broadphase "auto" (checked to resolve to the
    fused kernel's windowed twin with the bodies in the scratch, and sap):
    main_rigid's windows, the kernel at the state they leave bit for bit
    its plain version on 8 worlds, its ms and bound, and CTAs an SM.  Cut
    to XLARGE_CUT worlds where the card's memory does not hold it.  Returns (its line, the kernel's timing)."""
    n = XLARGE_BODIES + 1
    tables = sk.pk.ObjTables(rb.RigidBenchWorld.objmgr)
    check(sk.fused_bodies(tables, n, XLARGE_K), "main_rigid_sap_xlarge: not in the scratch")
    window = sk.fused_layout_window(tables, n, XLARGE_K)
    # the memory reckoned before the run: the two scratches
    need = {"work_scratch_gib": XLARGE_WORLDS * 4 * sk.SCRATCH_CH * (XLARGE_K - window) / 2 ** 30,
            "body_scratch_gib": XLARGE_WORLDS * 4 * sk.body_scratch_floats(n, tables) / 2 ** 30}
    worlds, reduced = XLARGE_WORLDS, None
    try:
        sim, line = main_rigid(torch, rb, phys, dict(contact_mode="auto",
                                                     broadphase_mode="auto"),
                               XLARGE_STEPS, XLARGE_WINDOWS, card, reset_counts, read_counts,
                               bodies=XLARGE_BODIES, specialisation="win+bodies",
                               worlds=worlds)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        worlds, reduced = XLARGE_CUT, f"worlds {XLARGE_WORLDS} -> {XLARGE_CUT}: out of memory"
        sim, line = main_rigid(torch, rb, phys, dict(contact_mode="auto",
                                                     broadphase_mode="auto"),
                               XLARGE_STEPS, XLARGE_WINDOWS, card, reset_counts, read_counts,
                               bodies=XLARGE_BODIES, specialisation="win+bodies",
                               worlds=worlds)
    check(phys.FUSED_NODE in sim.graph.node_names
          and node_fn(sim, "bp_find_overlaps").__name__ == "find_overlaps_sap",
          "main_rigid_sap_xlarge: auto takes the fused kernel and sap")
    kw = fused_inputs(sim, rb, phys)
    kern = sk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
    parity = window_case(torch, sk, kern, kw, plain_worlds=BODY_PARITY_WORLDS)
    ops, kinds, work = 0, {}, {}
    for chunk in world_chunks(kw, 256):
        o, kd, wk = substep_work(torch, sk, kern, chunk)
        ops += o
        for d, src in ((kinds, kd), (work, wk)):
            for k, v in src.items():
                d[k] = d.get(k, 0) + v
    b_ms, b_by = substep_bound(kw, ops)
    kw8 = next(world_chunks(kw, BODY_PARITY_WORLDS))
    kern_t = {"ms": cuda_ms(torch, lambda: kern(**kw), 3, warmup=1),
              "plain_ms": cuda_ms(torch, lambda: kern.plain(**kw8), 2, warmup=1),
              "plain_ms_is": f"its plain version at {BODY_PARITY_WORLDS} of the {worlds} worlds",
              "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "pairs_by_kind": kinds,
              "work_over_substeps": work, "window": window,
              "occupancy": sk.occupancy(n, XLARGE_K, codes=(sk.OPT_WIN | sk.OPT_BODY,))}
    del kw, kw8
    line = {"phase": "main_rigid_sap_xlarge", **line, "K": XLARGE_K,
            "contact_mode": "auto -> fused kernel (windowed, bodies in the scratch)",
            "broadphase": "auto -> sap", "window": window,
            "smem_bytes_a_world": sk.body_window_smem_bytes(n, window, sk.block_threads(
                n, XLARGE_K)),
            "memory_reckoned": need,
            "window_saturation_last_step": sap_saturation(torch, rb, sim),
            "kernel_vs_plain_at_this_state": parity, "kernel": kern_t}
    if reduced:
        line["reduced"] = reduced
    del sim
    torch.cuda.empty_cache()
    return line, kern_t


def entity64_child(torch):
    """Run in a process with GEM_TPU_ENTITY_64=1 (read at import): the
    port's 64-bit handles on the card.  One slot churned ENTITY64_CHURN
    times keeps a handle of its first cycle dead; cube_chain_ss4 in the
    kernel mode (kernel 5 with a live joint) tick by tick, each tick's node
    launch bit for bit its plain version on the card, its trajectory saved
    for the parent (which holds it to the int32 run's).  Prints one JSON
    line."""
    import numpy as np
    from gpu_ecs_madrona_tpu_torch import physics as phys
    from gpu_ecs_madrona_tpu_torch.core import component as cm
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
    from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
    check(cm.Entity.dtype == torch.int64 and cm.ENTITY_ID_BITS == 32
          and cm.ENTITY_GEN_BITS == 31, "64-bit handles: dtype and split")
    Tag = cm.component("E64Tag", ((), torch.int32))
    Arch = cm.Archetype("E64Arch", [Tag])

    class ChurnWorld:
        @staticmethod
        def register_types(r):
            r.register_archetype(Arch, capacity=2)

        @staticmethod
        def init(ctx, init_data=None):
            pass

        @staticmethod
        def setup_tasks(builder):
            def churn(ctx):
                ents = ctx.make_entities(Arch, counts=1, max_new=1)
                ctx.destroy_entities(ents)
            builder.add_node(churn, name="churn")

    sim = TaskGraphExecutor(ChurnWorld, ExecutorConfig(num_worlds=2, max_entities_per_world=4,
                                                       seed=0, device="cuda"))
    ctx = Context(sim.mgr, sim.state)
    stale = ctx.make_entities(Arch, counts=1, max_new=1)
    ctx.destroy_entities(stale)
    sim.state = ctx.state
    sim.run(ENTITY64_CHURN)
    _, _, live = sim.mgr.lookup(sim.state, stale)
    gen = int(sim.state["eid"]["gen"][0, 0])
    check(stale.dtype == torch.int64 and not bool(live.any()) and gen == ENTITY64_CHURN + 1,
          f"64-bit handles: the stale handle after {ENTITY64_CHURN} recycles (gen {gen})")
    # cube_chain_ss4, kernel 5's node launch with its joint's handles
    sk.SubstepKernel.launches = 0
    gsim, golden, _ = golden_sim(torch, phys, "cube_chain_ss4", "pallas", joint=True)
    kern = phys.RigidBodyPhysicsSystem.substep_kernel(gsim)
    T = golden.shape[0] - 1
    mine = np.zeros(golden.shape[:-1] + (3,), np.float32)
    mine[0] = golden[0, ..., 0:3]
    worst, live_joints_seen = 0.0, 0
    handles = gsim.mgr.entity_column(gsim.state, gsim.world_cls.Body)
    for t in range(1, T + 1):
        kw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(gsim, None, None, node=True)
        live_joints_seen = max(live_joints_seen, int(live_joints(kw).sum()))
        launches = sk.SubstepKernel.launches
        worst = max(worst, max(node_case(torch, sk, kern, kw, exact=True).values()))
        sk.SubstepKernel.launches = launches
        gsim.step()
        mine[t] = gsim.get_exported(0)[0][:, 1:].cpu().numpy()
    check(live_joints_seen > 0, "64-bit handles: the chain's joint is not live")
    check(sk.SubstepKernel.launches == 4 * T, f"64-bit chain launches {sk.SubstepKernel.launches}")
    out = os.path.join(HERE, "build", "entity64_chain.npy")
    np.save(out, mine)
    emit({"handle_dtype": str(handles.dtype), "id_bits": cm.ENTITY_ID_BITS,
          "gen_bits": cm.ENTITY_GEN_BITS, "churn_recycles": ENTITY64_CHURN,
          "stale_handle_live": bool(live.any()), "slot_generation": gen,
          "chain_ticks": T, "chain_launches": sk.SubstepKernel.launches,
          "chain_live_joints": live_joints_seen, "node_vs_plain_max_err": worst,
          "trajectory": os.path.relpath(out, HERE)})


def entity64_phase(torch, chain32):
    """The entity64 child (entity64_child, GEM_TPU_ENTITY_64=1) in a process
    of its own, and its cube_chain_ss4 trajectory against ``chain32``, the
    same chain under int32 handles (joints_cube_chain's card run): bit for
    bit, since a handle of generation 0 has the same value at either
    width."""
    import numpy as np
    env = dict(os.environ, GEM_TPU_ENTITY_64="1")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--entity64-child"],
                       cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"entity64 child failed: {r.stderr[-3000:]}")
    child = json.loads(r.stdout.strip().splitlines()[-1])
    chain64 = np.load(os.path.join(HERE, child["trajectory"]))
    diff = float(np.abs(chain64 - chain32).max())
    check(chain64.shape == chain32.shape and diff == 0.0,
          f"64-bit cube chain parts from the int32 one by {diff}")
    return {"phase": "entity64", **child, "chain_vs_int32_max_abs_diff": diff}


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import gpu_ecs_madrona_tpu_torch as port
    except ModuleNotFoundError as e:
        # the script alone, outside a checkout: nothing to drive (the
        # expected failure of that run)
        if e.name != "gpu_ecs_madrona_tpu_torch":
            raise
        print(f"chip_smoke: no gpu_ecs_madrona_tpu_torch beside {HERE}: run it from the root "
              "of a checkout", file=sys.stderr)
        return 1
    check(os.path.dirname(os.path.abspath(port.__file__)).startswith(HERE),
          f"the port must come from this checkout, got {port.__file__}")
    if "--entity64-child" in argv:
        # the entity64 phase's process (GEM_TPU_ENTITY_64=1)
        torch.cuda.set_device(0)
        entity64_child(torch)
        return 0
    from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
    from gpu_ecs_madrona_tpu_torch.models import collisions as col
    from gpu_ecs_madrona_tpu_torch import physics as phys
    from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
    from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
    from gpu_ecs_madrona_tpu_torch.models import simple_jobs as sj
    from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
    from gpu_ecs_madrona_tpu_torch.ops import _build
    from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
    from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rkm
    from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk
    from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as subk
    from gpu_ecs_madrona_tpu_torch.render import renderer as render_mod
    from gpu_ecs_madrona_tpu_torch.utils import math as m
    from gpu_ecs_madrona_tpu_torch import bindings
    from gpu_ecs_madrona_tpu_torch.parallel import learner as learner_mod
    from gpu_ecs_madrona_tpu_torch.parallel import mesh as mesh_mod
    from gpu_ecs_madrona_tpu_torch.tooling import autotuner as tuner
    from gpu_ecs_madrona_tpu_torch.tooling import profiler as prof

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    wrappers = {"fused_collisions_step": ck.fused_collisions_step,
                "collision_pushes": ck.collision_pushes,
                "fused_simple_jobs_step": sk.fused_simple_jobs_step,
                "fused_substep": subk.FusedSubstepKernel,
                "substep": subk.SubstepKernel,
                "world_flags": subk.WorldFlags,
                "asleep_surface": subk.AsleepSurface,
                "render": rkm.RenderKernel}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        subk.FusedSubstepKernel.launches_by_options.clear()

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    # device ----------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # build -----------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if any(k in ln for k in ("Compiling entry", "registers", "spill"))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs), "dir": os.path.relpath(_build.BUILD_DIR, HERE),
          "ptxas": ptxas})

    # collision kernels vs plain at the main path's shapes --------------------
    sim = col.make_executor(col.CollisionsConfig(num_worlds=NUM_WORLDS), device="cuda")
    pos = sim.mgr.column(sim.state, col.CubeObject, col.Translation)
    rot = sim.mgr.column(sim.state, col.CubeObject, col.Rotation)
    mask = sim.mgr.row_mask(sim.state, col.CubeObject)
    check(tuple(pos.shape) == (NUM_WORLDS, 108, 3) and int(mask.sum(1).min()) == 100,
          "initial state shape")
    delta, klo, khi = ck.fused_collisions_step(pos, rot, mask)
    plo, phi = ck.aabb_plain(pos, rot)
    want = ck.pushes_plain(pos, klo, khi, mask, center=False)
    own = ck.fused_collisions_step_plain(pos, rot, mask)[0]
    torch.cuda.synchronize()
    err_fused = {"lo": max_err(klo, plo), "hi": max_err(khi, phi),
                 "delta": max_err(delta, want)}
    rows_own = int(((delta - own).abs().amax(-1) > 1e-4).sum())
    del want, own
    d108 = ck.collision_pushes(pos, plo, phi, mask)
    err_p108 = max_err(d108, ck.collision_pushes_plain(pos, plo, phi, mask))
    g = torch.Generator(device=dev).manual_seed(0)
    p1500 = torch.rand((16, 1500, 3), generator=g, device=dev) * 17.0 - 8.5
    m1500 = torch.rand((16, 1500), generator=g, device=dev) > 0.02
    d1500 = ck.collision_pushes(p1500, p1500 - 1.0, p1500 + 1.0, m1500)
    err_p1500 = max_err(d1500, ck.collision_pushes_plain(p1500, p1500 - 1.0, p1500 + 1.0,
                                                          m1500))
    # a dense cluster (every live pair overlaps), and collision_pushes on
    # the main state offset by 1e4 (where only the centring keeps it right)
    c_pos = torch.rand((64, 64, 3), generator=g, device=dev) * 0.6 - 0.3
    c_rot, c_mask = rot[:64, :64].contiguous(), mask[:64, :64].contiguous()
    cd, clo, chi = ck.fused_collisions_step(c_pos, c_rot, c_mask)
    c_live, c_over = pair_counts(torch, clo, chi, c_mask)
    check(c_live == c_over > 0, f"the cluster's live pairs all overlap ({c_over} of {c_live})")
    err_cluster = {"lo": max_err(clo, ck.aabb_plain(c_pos, c_rot)[0]),
                   "hi": max_err(chi, ck.aabb_plain(c_pos, c_rot)[1]),
                   "delta": max_err(cd, ck.pushes_plain(c_pos, clo, chi, c_mask, center=False)),
                   "pushes": max_err(ck.collision_pushes(c_pos, clo, chi, c_mask),
                                     ck.collision_pushes_plain(c_pos, clo, chi, c_mask))}
    o_pos, o_lo, o_hi = pos + 1e4, plo + 1e4, phi + 1e4
    d_off = ck.collision_pushes(o_pos, o_lo, o_hi, mask)
    err_offset = max_err(d_off, ck.collision_pushes_plain(o_pos, o_lo, o_hi, mask))
    del o_pos, o_lo, o_hi
    emit({"phase": "parity", "fused_collisions_step": err_fused,
          "fused_rows_differing_with_plain_own_aabb": rows_own,
          "collision_pushes_n108": err_p108, "collision_pushes_n1500_w16": err_p1500,
          "cluster_64x64": err_cluster, "collision_pushes_offset_1e4": err_offset,
          "atol": {"aabb": 1e-5, "delta": 1e-4}})
    check(err_fused["lo"] <= 1e-5 and err_fused["hi"] <= 1e-5, "fused lo/hi vs plain")
    check(err_fused["delta"] <= 1e-4, "fused delta vs plain")
    check(err_p108 <= 1e-4 and err_p1500 <= 1e-4, "collision_pushes vs plain")
    check(err_cluster["lo"] <= 1e-5 and err_cluster["hi"] <= 1e-5
          and err_cluster["delta"] <= 1e-4 and err_cluster["pushes"] <= 1e-4,
          f"the dense cluster vs plain {err_cluster}")
    check(err_offset <= 1e-4, f"collision_pushes at a 1e4 offset vs plain {err_offset}")
    check(bool(torch.isfinite(delta).all()) and bool(torch.isfinite(d1500).all())
          and bool(torch.isfinite(cd).all()) and bool(torch.isfinite(d_off).all()),
          "finite kernel outputs")

    # kernel 4 vs plain ---------------------------------------------------------
    line, err_sj = parity_simple_jobs(torch, sj, sk, dev)
    emit(line)

    # the reference binary's goldens, on the card ------------------------------
    g_pos, g_rot0 = load_job_golden()
    n_g = g_pos.shape[1]
    golden = {}
    for mode, kw in (("fused", dict(fused=True)),
                     ("pushes", dict(fused=False, use_kernel=True))):
        cfg = col.CollisionsConfig(num_worlds=1, num_objects=n_g, max_pairs=1600, **kw)

        class GoldenWorld(col.CollisionsWorld.with_config(cfg)):
            @classmethod
            def init(cls, ctx, init_data=None):
                ctx.data = {
                    "bounds_lo": torch.tensor([[-10.0, -10.0, 0.0]], device=dev),
                    "bounds_hi": torch.tensor([[10.0, 10.0, 10.0]], device=dev),
                    "push_delta": torch.zeros((1, n_g + 8, 3), device=dev),
                }
                inv_lo, inv_hi = m.aabb_invalid((1, n_g), device=dev)
                ctx.make_entities(col.CubeObject, counts=n_g, max_new=n_g, values={
                    col.Translation: torch.from_numpy(g_pos[0])[None].to(dev),
                    col.Rotation: torch.from_numpy(g_rot0)[None].to(dev),
                    col.PhysicsAABB: {"lo": inv_lo, "hi": inv_hi},
                })

        gsim = TaskGraphExecutor(GoldenWorld, ExecutorConfig(num_worlds=1, device="cuda"))
        errs = []
        for t in range(1, g_pos.shape[0]):
            gsim.step()
            mine = gsim.get_exported(0)[0][0, :n_g].cpu().numpy()
            errs.append(float(abs(mine - g_pos[t]).max()))
        golden[mode] = {"err_t3": max(errs[:3]), "max_err": max(errs), "ticks": len(errs)}
        check(golden[mode]["err_t3"] <= 1e-3 and golden[mode]["max_err"] <= 0.02,
              f"golden trajectory ({mode})")
    emit({"phase": "golden", **golden})
    emit(golden_fvs(torch, fvs))

    # the RL training path: the learner and the reset node on the card vs
    # the CPU, the Tensor hand-off on the card
    emit(parity_learner(torch))
    emit(parity_reset(torch))
    emit(bindings_phase(torch, col, bindings))

    # the sap node on the card vs the CPU, and a dense-mode step likewise
    line, sap_sim = parity_sap(torch, rb, phys)
    emit(line)
    emit(parity_dense(torch, rb, phys, subk))

    # the fused substep kernel vs plain, and the physics goldens on the card
    line, err_substep, err_substep1, err_window = parity_substep(torch, rb, phys, subk, sap_sim)
    del sap_sim
    wide_t = dict(line["cases"]["wide_box_vm32_K256"], max_err={
        name: max(c["max_err"].values()) for name, c in line["cases"].items()
        if name.startswith("wide_box")})
    emit(line)
    emit(golden_physics(torch, phys, subk))
    line, chain32 = joints_cube_chain(torch, phys, subk)
    emit(line)
    # 64-bit entity handles (a process of its own: the flag is read at import)
    emit(entity64_phase(torch, chain32))

    # the general-hull paths of the substep kernels vs plain, on the pile of
    # imported prisms
    line, err_hull, err_hull5 = parity_hull(torch, rb, phys, subk)
    emit(line)

    # the render kernel vs plain, and the kernel route vs the "xla" route
    line, err_render = parity_render(torch, rkm, stg, dev)
    emit(line)

    # collisions, fused=True (kernel 1) ----------------------------------------
    sim.run(3)
    sim.block_until_ready()
    reset_counts()
    fused_windows = windows(sim, 200, 5)
    fused_launches = read_counts()
    check(fused_launches == {"fused_collisions_step": 1000, "collision_pushes": 0,
                             "fused_simple_jobs_step": 0, "fused_substep": 0,
                             "substep": 0, "world_flags": 0, "asleep_surface": 0,
                             "render": 0},
          f"fused main path launches {fused_launches}")
    fpos, fmask = sim.get_exported(0)
    check(bool(torch.isfinite(fpos[fmask]).all()), "finite positions (fused)")
    for arch in (col.CollisionCandidate, col.Contact):
        check(int(sim.mgr.num_rows(sim.state, arch).sum()) == 0, f"{arch.name} empty")
    emit({"phase": "main_fused", "worlds": NUM_WORLDS, "objects": 100,
          "launches": fused_launches, "env_steps_per_s": rates(200, fused_windows),
          "card": smi})

    # collisions, fused=False with the collision_pushes kernel (kernel 2) -------
    usim = col.make_executor(col.CollisionsConfig(num_worlds=NUM_WORLDS, fused=False,
                                                  use_kernel=True), device="cuda")
    usim.run(3)
    usim.block_until_ready()
    reset_counts()
    uwindows = windows(usim, 50, 1)
    unfused_launches = read_counts()
    check(unfused_launches == {"fused_collisions_step": 0, "collision_pushes": 50,
                               "fused_simple_jobs_step": 0, "fused_substep": 0,
                               "substep": 0, "world_flags": 0, "asleep_surface": 0,
                               "render": 0},
          f"unfused main path launches {unfused_launches}")
    upos, umask = usim.get_exported(0)
    check(bool(torch.isfinite(upos[umask]).all()), "finite positions (unfused)")
    overflow = usim.overflow_counters()
    check(all(v.dtype == torch.int32 and int(v.min()) >= 0 for v in overflow.values()),
          "overflow counters int32 >= 0")
    emit({"phase": "main_unfused", "worlds": NUM_WORLDS, "objects": 100,
          "launches": unfused_launches, "env_steps_per_s": rates(50, uwindows),
          "overflow_max": {k: int(v.max()) for k, v in overflow.items()}, "card": smi})

    # simple_jobs, fused=True (kernel 4) ----------------------------------------
    sj_cfg = dict(num_worlds=SJ_WORLDS, num_objects=SJ_OBJECTS, max_pairs=SJ_K,
                  degree_cap=SJ_D)
    sjsim = sj.make_executor(sj.SimpleJobsConfig(fused=True, **sj_cfg), device="cuda")
    check(sjsim.graph.node_names == ["fused_step"], "simple_jobs fused graph")
    sjsim.run(3)
    sjsim.block_until_ready()
    reset_counts()
    sj_windows = windows(sjsim, 200, 5)
    sj_launches = read_counts()
    check(sj_launches == {"fused_collisions_step": 0, "collision_pushes": 0,
                          "fused_simple_jobs_step": 1000, "fused_substep": 0,
                          "substep": 0, "world_flags": 0, "asleep_surface": 0,
                          "render": 0},
          f"simple_jobs main path launches {sj_launches}")
    user = sjsim.state["user"]
    check(bool(torch.isfinite(user["translation"]).all()), "finite positions (simple_jobs)")
    check(int(user["num_candidates"].abs().sum()) == 0
          and int(user["num_contacts"].abs().sum()) == 0, "simple_jobs counters reset")
    emit({"phase": "main_simple_jobs", "worlds": SJ_WORLDS, "objects": SJ_OBJECTS,
          "max_pairs": SJ_K, "degree_cap": SJ_D, "launches": sj_launches,
          "pairs_in_buffers": int((user["contacts_ab"] != 0).any(-1).sum()),
          "env_steps_per_s": rates(200, sj_windows, SJ_WORLDS), "card": smi})

    # simple_jobs, fused=False, rank compaction ---------------------------------
    os.environ["GEM_SJ_COMPACT"] = "rank"
    sjusim = sj.make_executor(sj.SimpleJobsConfig(fused=False, **sj_cfg), device="cuda")
    sjusim.run(3)
    sjusim.block_until_ready()
    reset_counts()
    sju_windows = windows(sjusim, 50, 1)
    sju_launches = read_counts()
    check(all(v == 0 for v in sju_launches.values()),
          f"simple_jobs unfused launches {sju_launches}")
    check(bool(torch.isfinite(sjusim.state["user"]["translation"]).all()),
          "finite positions (simple_jobs unfused)")
    emit({"phase": "main_simple_jobs_unfused", "worlds": SJ_WORLDS, "objects": SJ_OBJECTS,
          "compaction": "rank", "launches": sju_launches,
          "env_steps_per_s": rates(50, sju_windows, SJ_WORLDS), "card": smi})
    # simple_jobs past kernel 4's one-block layout: 2,048 objects, fused=None
    line, sjl_t = main_simple_jobs_large(torch, sj, sk, smi, reset_counts, read_counts)
    sjl_launches = line["launches"]["fused_simple_jobs_step"]
    emit(line)

    # fantasy_vs, 16384 worlds, cleanup on --------------------------------------
    fcfg = fvs.FantasyVsConfig(num_worlds=FVS_WORLDS, num_dragons=50, num_knights=200,
                               cleanup=True)
    fsim = fvs.make_executor(fcfg, device="cuda")
    fsim.run(3)
    fsim.block_until_ready()

    def live_counts():
        return [fsim.mgr.num_rows(fsim.state, a).clone() for a in (fvs.Dragon, fvs.Knight)]

    before = live_counts()
    first = before
    reset_counts()
    fvs_windows = []
    for _ in range(5):
        fvs_windows += windows(fsim, 50, 1)
        now = live_counts()
        check(all(bool((n <= p).all()) for n, p in zip(now, before)),
              "fantasy_vs live counts rose")
        before = now
    fvs_launches = read_counts()
    check(all(v == 0 for v in fvs_launches.values()), f"fantasy_vs launches {fvs_launches}")
    check(all(int(v.abs().sum()) == 0 for v in fsim.overflow_counters().values()),
          "fantasy_vs overflow counters")
    for arch in (fvs.Dragon, fvs.Knight):
        p = fsim.mgr.column(fsim.state, arch, fvs.Position)
        check(bool(torch.isfinite(p[fsim.mgr.row_mask(fsim.state, arch)]).all()),
              f"finite {arch.name} positions")
    emit({"phase": "main_fantasy_vs", "worlds": FVS_WORLDS, "dragons": 50, "knights": 200,
          "cleanup": True, "launches": fvs_launches,
          "destroyed_in_windows": {"Dragon": int((first[0] - before[0]).sum()),
                                   "Knight": int((first[1] - before[1]).sum())},
          "env_steps_per_s": rates(50, fvs_windows, FVS_WORLDS), "card": smi})

    # PPO on fantasy_vs, 16384 worlds (BASELINE configs 4-5) ---------------------
    ppo_line = main_ppo_fantasy_vs(torch, fvs, learner_mod, smi, reset_counts, read_counts)
    emit(ppo_line)

    # rigid_bench, 8192 x 64: the fused substep kernel at K = 256 and 128, and
    # the pairs path -------------------------------------------------------------
    counts = (reset_counts, read_counts)
    rsim, line = main_rigid(torch, rb, phys, dict(contact_mode="pallas", max_candidates=256),
                            50, 5, smi, *counts)
    rig_launches = line["launches"]["fused_substep"]
    rig_rate = line["env_steps_per_s"]["median"]
    emit({"phase": "main_rigid", **line})
    r128, line = main_rigid(torch, rb, phys, dict(contact_mode="pallas", max_candidates=128),
                            50, 5, smi, *counts)
    emit({"phase": "main_rigid_k128", **line})
    rpairs, line = main_rigid(torch, rb, phys, dict(contact_mode="pairs", max_candidates=256),
                              10, 1, smi, *counts)
    emit({"phase": "main_rigid_pairs", **line})

    # rigid_bench's small worlds (33 rows: "auto" takes the dense contact
    # mode and the dense broadphase) and its large ones (201 rows: "auto"
    # takes sap, kernel 7 at K = 800)
    dsim, line = main_rigid(torch, rb, phys, dict(contact_mode="auto"), 5, 3, smi, *counts,
                            bodies=DENSE_BODIES)
    check(phys.FUSED_NODE not in dsim.graph.node_names, "main_rigid_dense takes the dense mode")
    emit({"phase": "main_rigid_dense", **line,
          "world_block": node_fn(dsim, "physics_substep_0").world_block,
          "dense_block_pairs": phys.DENSE_BLOCK_PAIRS,
          "broadphase": node_fn(dsim, "bp_find_overlaps").__name__})
    del dsim
    ssap, line = main_rigid(torch, rb, phys, dict(contact_mode="pallas"), 20, 5, smi, *counts,
                            bodies=SAP_BODIES)
    sap_launches = line["launches"]["fused_substep"]
    check(node_fn(ssap, "bp_find_overlaps").__name__ == "find_overlaps_sap",
          "main_rigid_sap takes sap")
    emit({"phase": "main_rigid_sap", **line, "K": SAP_K,
          "kernel_smem_bytes": subk.smem_bytes(SAP_BODIES + 1, SAP_K),
          "window_saturation_last_step": sap_saturation(torch, rb, ssap)})
    # past one block's shared memory: 255 bodies under "auto" (the fused
    # kernel's windowed layout, sap)
    slarge, line = main_rigid(torch, rb, phys, dict(contact_mode="auto", broadphase_mode="auto"),
                              20, 5, smi, *counts, bodies=LARGE_SAP_BODIES, specialisation="win")
    sap_large_launches = line["launches"]["fused_substep"]
    check(phys.FUSED_NODE in slarge.graph.node_names
          and node_fn(slarge, "bp_find_overlaps").__name__ == "find_overlaps_sap",
          "main_rigid_sap_large: auto takes the fused kernel and sap")
    n_large = LARGE_SAP_BODIES + 1
    win = subk.fused_window(n_large, LARGE_SAP_K)
    check(subk.windowed(subk.pk.ObjTables(rb.RigidBenchWorld.objmgr), n_large, LARGE_SAP_K),
          "main_rigid_sap_large takes the windowed layout")
    large_parity = window_case(torch, subk, subk.FusedSubstepKernel(
        rb.RigidBenchWorld.objmgr, 4, relaxation=0.7), fused_inputs(slarge, rb, phys))
    emit({"phase": "main_rigid_sap_large", **line, "K": LARGE_SAP_K,
          "contact_mode": "auto -> fused kernel (windowed)", "broadphase": "auto -> sap",
          "window": win,
          "smem_bytes_a_world": subk.fused_window_smem_bytes(
              n_large, win, subk.block_threads(n_large, LARGE_SAP_K)),
          "scratch_bytes_a_world": 4 * subk.SCRATCH_CH * (LARGE_SAP_K - win),
          "slot_layout_would_need_bytes": subk.smem_bytes(n_large, LARGE_SAP_K),
          "window_saturation_last_step": sap_saturation(torch, rb, slarge),
          "kernel_vs_plain_at_this_state": large_parity})
    # past the windowed layout's body ceiling: 1,023 bodies under "auto" (the
    # windowed twin with the bodies in a global scratch, sap)
    line, xlarge_t = main_rigid_sap_xlarge(torch, rb, phys, subk, smi, *counts)
    xlarge_launches = line["launches"]["fused_substep"]
    emit(line)

    # the fused kernel's options: the broadphase in the kernel (kernel 8) on
    # the default pile, and the settled pile with persistent manifolds and
    # sleep (kernel 9) and without (its A/B) -----------------------------------
    bsim, line = main_rigid(torch, rb, phys, dict(contact_mode="pallas", max_candidates=256,
                                                  broadphase_mode="fused"),
                            50, 5, smi, *counts, specialisation="bp")
    bp_launches = line["launches"]["fused_substep"]
    emit({"phase": "main_rigid_fused_bp", **line,
          "main_rigid_env_steps_per_s_median": rig_rate})
    settled_cfg = dict(rb.SETTLED_PILE, max_candidates=256)
    settled_sim, line = main_rigid(torch, rb, phys, settled_cfg, 50, 5, smi, *counts,
                                   specialisation="refresh+sleep+bp+persist",
                                   settle=rb.SETTLE_STEPS, also=("world_flags", "asleep_surface"))
    persist_launches = line["launches"]["fused_substep"]
    flags_launches = line["launches"]["world_flags"]
    surface_launches = line["launches"]["asleep_surface"]
    trace = settled_trace(torch, rb, phys, settled_sim, 10)
    check(max(trace["stable_share"]) > 0 and max(trace["asleep_share"]) > 0,
          f"settled pile: no stable or no asleep world {trace}")
    emit({"phase": "main_rigid_settled", **line, "per_step_after_windows": trace})
    nsim, line = main_rigid(torch, rb, phys, dict(settled_cfg, manifold_persist=False,
                                                  sleep_threshold=0.0),
                            50, 5, smi, *counts, specialisation="refresh+bp",
                            settle=rb.SETTLE_STEPS)
    emit({"phase": "main_rigid_settled_nopersist", **line})

    # the pile of imported prisms (tests/test_torch_hull_scenes.py): rigid_bench
    # at main_rigid's width with the general-hull specialisation, and at the
    # settled pile's options
    hs = hull_scenes()
    hsim, line = main_rigid(torch, rb, phys, dict(contact_mode="pallas"), 50, 5, smi, *counts,
                            specialisation="hull", make=hs.hull_pile)
    hull_launches = line["launches"]["fused_substep"]
    hull_node = node_time(torch, hsim, phys.FUSED_NODE)
    check(hull_node["device_ops"] <= 15,
          f"the hull pile's fused node queues {hull_node['device_ops']} device ops")
    emit({"phase": "main_rigid_hulls", **line, "objects": "imported prism, sphere 0.5, plane",
          "fused_node": {k: hull_node[k] for k in ("device_ms", "host_ms", "device_ops")},
          "main_rigid_env_steps_per_s_median": rig_rate})
    hsettled_cfg = {k: v for k, v in hs.HULL_SETTLED.items()
                    if k not in ("num_worlds", "num_bodies")}
    hset_sim, line = main_rigid(torch, rb, phys, hsettled_cfg, 50, 5, smi, *counts,
                                specialisation="refresh+sleep+bp+persist+hull",
                                settle=rb.SETTLE_STEPS, also=("world_flags", "asleep_surface"),
                                make=hs.hull_pile,
                                probe=settle_motion(torch, rb, phys, MOTION_STEPS))
    line["motion_after_settle"] = line.pop("probe")
    hull_persist_launches = line["launches"]["fused_substep"]
    hset_node = node_time(torch, hset_sim, phys.FUSED_NODE)
    # the prisms keep moving above the sleep threshold (no world falls asleep
    # in 650 steps, PERF.md's findings): the cache is kept where stable
    trace = settled_trace(torch, rb, phys, hset_sim, 10)
    check(max(trace["stable_share"]) > 0, f"settled hull pile: no stable world {trace}")
    emit({"phase": "main_rigid_hulls_settled", **line, "per_step_after_windows": trace,
          "fused_node": {k: hset_node[k] for k in ("device_ms", "host_ms", "device_ops")}})
    # the 24-sided prism for object 0: tables past PhysicsLoader()'s defaults
    lsim, line = main_rigid(torch, rb, phys, dict(contact_mode="pallas"), LARGE_STEPS,
                            LARGE_WINDOWS, smi, *counts, specialisation="hull",
                            make=lambda cfg, device: hs.hull_pile(cfg, device, large=True))
    large_launches = line["launches"]["fused_substep"]
    emit({"phase": "main_rigid_hulls_large", **line,
          "objects": "imported 24-sided prism, sphere 0.5, plane",
          "hull_dims": list(phys.subk.pk.ObjTables(lsim.world_cls.objmgr).hull_dims())})
    line, err_bp, err_persist = parity_substep_options(torch, rb, phys, subk, rsim, r128, bsim,
                                                       settled_sim)
    err_flags = max(max(c["differing"].values()) for c in line["world_flags"].values())
    emit(line)

    # simple_taskgraph, 1024 x 100, 64 x 64 RGB and depth -------------------------
    ssim, line = main_simple_taskgraph(torch, stg, 50, 5, smi, *counts)
    stg_launches = line["launches"]
    emit({"phase": "main_simple_taskgraph", **line})
    # the render node on scenes past one block's shared memory (4,096
    # instance rows a world)
    line, render_large_in, err_render_large = main_render_large(torch, rkm, render_mod, smi,
                                                                *counts)
    render_large_launches = line["launches"]["render"]
    emit(line)
    # simple_taskgraph past kernel 5's window layout: 1,000 objects
    line, stg_large_t = main_simple_taskgraph_large(torch, stg, phys, subk, smi, *counts)
    stg_large_launches = line["launches"]["substep"]
    emit(line)
    # kernel 5 with 4,096 joint rows (past what fits beside its window)
    line, jrl_t = main_joint_rows_large(torch, phys, subk, smi, *counts)
    jrl_launches = line["launches"]["substep"]
    emit(line)

    # kernel times at the main paths' shapes ------------------------------------
    fpos = sim.mgr.column(sim.state, col.CubeObject, col.Translation)
    frot = sim.mgr.column(sim.state, col.CubeObject, col.Rotation)
    W, n = fmask.shape
    f_ms = cuda_ms(torch, lambda: ck.fused_collisions_step(fpos, frot, fmask), 200)
    f_plain = cuda_ms(torch, lambda: ck.fused_collisions_step_plain(fpos, frot, fmask), 10)
    flo, fhi = ck.aabb_plain(fpos, frot)
    live, over = pair_counts(torch, flo, fhi, fmask)
    f_bound, f_by = bound(W * n * (12 + 16 + 1 + 36), W * n * 69 + live * 6 + over * 16)

    uaabb = usim.mgr.column(usim.state, col.CubeObject, col.PhysicsAABB)
    ulo, uhi = uaabb["lo"], uaabb["hi"]
    upos = usim.mgr.column(usim.state, col.CubeObject, col.Translation)
    p_ms = cuda_ms(torch, lambda: ck.collision_pushes(upos, ulo, uhi, umask), 200)
    p_plain = cuda_ms(torch, lambda: ck.collision_pushes_plain(upos, ulo, uhi, umask), 10)
    ulive, uover = pair_counts(torch, ulo, uhi, umask)
    p_bound, p_by = bound(W * n * (36 + 1 + 12), W * n * 9 + ulive * 6 + uover * 16)

    # kernel 3: the tiled case, the parity phase's n=1500 data
    t_lo, t_hi = p1500 - 1.0, p1500 + 1.0
    tiled = {}
    for tile in (0, 1024):
        tiled[tile or 128] = cuda_ms(
            torch, lambda: ck.collision_pushes(p1500, t_lo, t_hi, m1500, force_tile=tile), 200)
    t_plain = cuda_ms(torch, lambda: ck.collision_pushes_plain(p1500, t_lo, t_hi, m1500), 10)
    tlive, tover = pair_counts(torch, t_lo, t_hi, m1500)
    tW, tn = m1500.shape
    t_bound, t_by = bound(tW * tn * (36 + 1 + 12), tW * tn * 9 + tlive * 6 + tover * 16)
    # the collision kernels' launch shapes (CTAs an SM from the occupancy
    # API) and the device ops of one collision_pushes call
    col_occupancy = {"fused_8192x108": ck.occupancy(W, n, "fused"),
                     "pushes_8192x108": ck.occupancy(W, n, "pushes"),
                     "pushes_16x1500": ck.occupancy(tW, tn, "pushes"),
                     "pushes_16x1500_tile1024": ck.occupancy(tW, tn, "pushes", 1024)}
    p_ops = graph_nodes(torch, lambda: ck.collision_pushes(upos, ulo, uhi, umask))
    check(p_ops == 1, f"a collision_pushes call queues {p_ops} device ops")

    # kernel 4 at the simple_jobs main path's shapes and state
    spos, srot = user["translation"], user["rotation"]
    skw = dict(n0=SJ_OBJECTS, K=SJ_K, degree_cap=SJ_D, bounds=(sj.BOUNDS_LO, sj.BOUNDS_HI))
    s_ms = cuda_ms(torch, lambda: sk.fused_simple_jobs_step(spos, srot, **skw), 200)
    s_plain = cuda_ms(torch, lambda: sk.fused_simple_jobs_step_plain(spos, srot, **skw), 10)
    _, slo, shi, _, _, _, _ = sk.fused_simple_jobs_step(spos, srot, **skw)
    smask = torch.ones(spos.shape[:2], dtype=torch.bool, device=dev)
    slive, sover = pair_counts(torch, slo, shi, smask)
    sW, sn = smask.shape
    s_bound, s_by = bound(sW * (sn * 28 + sn * 36 + SJ_K * 20 + 8),
                          sW * sn * 40 + slive / 2 * 6 + sover * 20)
    s_ptxas = [ln for ln in logs["simple_jobs_kernels"].splitlines()
               if any(k in ln for k in ("registers", "spill"))]
    s_shape = sk.occupancy(sW, sn, SJ_K)
    s_node = node_time(torch, sjsim, "fused_step")
    check(s_node["device_ops"] == 1,
          f"the simple_jobs node queues {s_node['device_ops']} device ops")

    # the fused substep kernel at both capacities, from the main_rigid states
    sub_t = {}
    for K, s_ in ((256, rsim), (128, r128), (SAP_K, ssap), (LARGE_SAP_K, slarge)):
        kw = fused_inputs(s_, rb, phys)
        kern = subk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
        ops, kinds, work = substep_work(torch, subk, kern, kw)
        b_ms, b_by = substep_bound(kw, ops)
        rows = kw["kvalid"].sum(1)
        bodies = kw["dyn"].sum(1).double() + 1.0       # the pile and its plane
        sub_t[K] = {"ms": cuda_ms(torch, lambda: kern(**kw), 20),
                    "plain_ms": cuda_ms(torch, lambda: subk.fused_substep_plain(
                        **kw, tables=kern.tables, num_substeps=4, relaxation=0.7), 3, warmup=1),
                    "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
                    "live_pairs": float((bodies * (bodies - 1) / 2).sum()),
                    "overlapping_pairs": sum(kinds.values()), "pairs_by_kind": kinds,
                    "work_over_substeps": work,
                    "pairs_per_world_max": int(rows.max())}

    # the general-hull specialisations at the hull piles' states
    hkw = fused_inputs(hsim, rb, phys)
    hkern = phys.RigidBodyPhysicsSystem.fused_kernel(hsim)
    h_ops, h_kinds, h_work = substep_work(torch, subk, hkern, hkw)
    hb_ms, hb_by = substep_bound(hkw, h_ops)
    hull_t = {"ms": cuda_ms(torch, lambda: hkern(**hkw), 20),
              "plain_ms": cuda_ms(torch, lambda: hkern.plain(**hkw), 3, warmup=1),
              "bound_ms": hb_ms, "bound_by": hb_by, "ops": h_ops, "pairs_by_kind": h_kinds,
              "work_over_substeps": h_work, "ops_by_kind": contact_ops(hkern.tables),
              "pairs_per_world_max": int(hkw["kvalid"].sum(1).max())}
    del hkw
    hkern_p, hkw_p = phys.RigidBodyPhysicsSystem.fused_kernel(hset_sim), fused_inputs(hset_sim,
                                                                                       rb, phys)
    hull_persist_t = persist_timing(torch, subk, hkern_p, hkw_p, flag_inputs(hset_sim, rb, phys))
    hull_persist_t["every_branch"] = {k: v for k, v in persist_timing(
        torch, subk, hkern_p, flip_branches(torch, hkw_p),
        flag_inputs(hset_sim, rb, phys)).items() if k in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by", "branches")}
    # kernel 5's node launch on the joint world with the prism for its boxes
    jsim = hs_joint_world(hs)
    jkw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(jsim, None, None, node=True)
    jkern = phys.RigidBodyPhysicsSystem.substep_kernel(jsim)
    j_ops, _, j_work = substep_work(torch, subk, jkern, jkw)
    jb_ms, jb_by = substep_bound(jkw, j_ops)
    hull5_t = {"ms": cuda_ms(torch, lambda: jkern.step(**jkw), 200),
               "plain_ms": cuda_ms(torch, lambda: jkern.step_plain(**jkw), 3, warmup=1),
               "bound_ms": jb_ms, "bound_by": jb_by, "ops": j_ops, "work": j_work,
               "W": jkw["obj"].shape[0], "n": jkw["obj"].shape[1]}
    del jsim, jkw
    # the "hull" launch at main_rigid_hulls_large's state: its plain version
    # at LARGE_PARITY_WORLDS of the worlds, its work counted over all of them
    # in blocks of 256 worlds
    lkw = fused_inputs(lsim, rb, phys)
    lkern = phys.RigidBodyPhysicsSystem.fused_kernel(lsim)
    l_ops, l_kinds, l_work = 0, {}, {}
    for chunk in world_chunks(lkw, 256):
        o, kd, wk = substep_work(torch, subk, lkern, chunk)
        l_ops += o
        for d, src in ((l_kinds, kd), (l_work, wk)):
            for k, v in src.items():
                d[k] = d.get(k, 0) + v
    lb_ms, lb_by = substep_bound(lkw, l_ops)
    lkw_part = next(world_chunks(lkw, LARGE_PARITY_WORLDS))
    large_t = {"ms": cuda_ms(torch, lambda: lkern(**lkw), 5),
               "plain_ms": cuda_ms(torch, lambda: lkern.plain(**lkw_part), 2, warmup=1),
               "plain_ms_is": f"its plain version at {LARGE_PARITY_WORLDS} of the "
                              f"{RB_WORLDS} worlds",
               "bound_ms": lb_ms, "bound_by": lb_by, "ops": l_ops, "pairs_by_kind": l_kinds,
               "work_over_substeps": l_work, "ops_by_kind": contact_ops(lkern.tables),
               "pairs_per_world_max": int(lkw["kvalid"].sum(1).max()),
               "occupancy": subk.occupancy(RB_BODIES + 1, 256, codes=(0,),
                                           hull=lkern.tables)}
    del lkw, lkw_part, lsim
    prism_tables = hkern.tables

    # the fused kernel's launch shape by specialisation at the main shapes,
    # and the single-substep kernel's at simple_taskgraph's: [threads a CTA,
    # CTAs an SM]
    occupancy = {"fused_n65_K256": subk.occupancy(RB_BODIES + 1, 256),
                 "fused_n65_K128": subk.occupancy(RB_BODIES + 1, 128),
                 "fused_n201_K800": subk.occupancy(SAP_BODIES + 1, SAP_K, codes=(0,)),
                 "substep_n104_K1000": subk.occupancy(104, 1000, single=True),
                 "substep_node_n104_K1000_J64": subk.occupancy(104, 1000, single=True,
                                                               joints=64),
                 "fused_hull_n65_K256": subk.occupancy(RB_BODIES + 1, 256, hull=prism_tables),
                 "fused_hull_n65_K128": subk.occupancy(RB_BODIES + 1, 128, hull=prism_tables),
                 "substep_hull_n104_K1000": subk.occupancy(104, 1000, single=True,
                                                           hull=prism_tables),
                 "substep_node_hull_n104_K1000_J64": subk.occupancy(
                     104, 1000, single=True, joints=64, hull=prism_tables)}

    # kernels 8 and 9 at their main paths' states (and kernel 8 with refresh
    # at the settled pile without persistence)
    def executor_case(sim):
        return phys.RigidBodyPhysicsSystem.fused_kernel(sim), fused_inputs(sim, rb, phys)

    kern_p, kw_p = executor_case(settled_sim)
    fkw_p = flag_inputs(settled_sim, rb, phys)
    opt_t = {"bp": option_timing(torch, *executor_case(bsim)),
             "bp_refresh_settled_nopersist": option_timing(torch, *executor_case(nsim)),
             "persist_settled": persist_timing(torch, subk, kern_p, kw_p, fkw_p),
             "persist_settled_flipped": persist_timing(torch, subk, kern_p,
                                                       flip_branches(torch, kw_p), fkw_p),
             "fused_node_settled": node_time(torch, settled_sim, phys.FUSED_NODE)}

    # the single-substep kernel at the simple_taskgraph main path's state:
    # its first substep, with its parity there
    kw1 = phys.RigidBodyPhysicsSystem.substep_kernel_inputs(
        phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(ssim, stg.Sphere, stg.OBJMGR))
    kern1 = subk.SubstepKernel(stg.OBJMGR, relaxation=0.7)
    err_stg1 = substep1_case(torch, subk, kern1, kw1)
    err_substep1 = max(err_substep1, max(err_stg1.values()))
    ops1, kinds1, work1 = substep_work(torch, subk, kern1, kw1)
    b1_ms, b1_by = substep_bound(kw1, ops1, single=True)
    sub1_t = {"ms": cuda_ms(torch, lambda: kern1(**kw1), 200),
              "plain_ms": cuda_ms(torch, lambda: subk.substep_plain(
                  **kw1, tables=kern1.tables, relaxation=0.7), 3, warmup=1),
              "bound_ms": b1_ms, "bound_by": b1_by, "ops": ops1, "pairs_by_kind": kinds1,
              "work": work1, "max_err_vs_plain": err_stg1,
              "W": kw1["im"].shape[0], "n": kw1["im"].shape[1], "K": kw1["rows_i"].shape[1],
              "pairs_per_world_max": int(kw1["kvalid"].sum(1).max())}
    # and kernel 5's node launch there (the integrate, the joints and the
    # writeback too), with the substep node that makes it
    kwn = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(ssim, stg.Sphere, stg.OBJMGR,
                                                              node=True)
    kernn = phys.RigidBodyPhysicsSystem.substep_kernel(ssim)
    err_node = node_case(torch, subk, kernn, kwn)
    err_substep1 = max(err_substep1, max(err_node.values()))
    opsn, _, workn = substep_work(torch, subk, kernn, kwn)
    bn_ms, bn_by = substep_bound(kwn, opsn)
    node_t = {"ms": cuda_ms(torch, lambda: kernn.step(**kwn), 200),
              "plain_ms": cuda_ms(torch, lambda: kernn.step_plain(**kwn), 3, warmup=1),
              "bound_ms": bn_ms, "bound_by": bn_by, "ops": opsn, "work": workn,
              "max_err_vs_plain": err_node, "J": kwn["jmask"].shape[1],
              "substep_node": node_time(torch, ssim, "physics_substep_0")}
    check(1 <= node_t["substep_node"]["device_ops"] <= 12,
          f"the substep node queues {node_t['substep_node']['device_ops']} device ops")

    # the render kernel at the simple_taskgraph main path's state: its rays
    # mode at the inputs the node's route before it gave the kernel (row
    # 10 at equal work), its views mode as the node launches it
    rend = ssim.world_cls.renderer()
    rk_ = rend._kernel
    render_in = ssim.state["user"]["render"]
    rrays, rinst = rend.kernel_inputs(render_in, [stg.Sphere])
    rviews, rinsts = render_in["__views__"], rend.instances(render_in, [stg.Sphere])
    rkw = dict(tables=rk_.tables, light=rk_.light, ambient=rk_.ambient)
    vkw = dict(height=STG_RES, width=STG_RES, max_views=1)
    r_ops, r_bytes, r_pairs, r_rays = render_work(torch, rkm, rk_.tables, rrays, rinst)
    r_bound, r_by = bound(r_bytes, r_ops)
    v_ops = r_ops + r_rays * OPS_RAY
    v_bytes = STG_WORLDS * (BYTES_VIEW + rinst.shape[2] * BYTES_INST_VIEWS
                            + STG_RES * STG_RES * BYTES_PIXEL)
    v_bound, v_by = bound(v_bytes, v_ops)
    rays_t = {"ms": cuda_ms(torch, lambda: rkm.render(rrays, rinst, img_w=STG_RES, **rkw), 200),
              "plain_ms": cuda_ms(torch, lambda: rkm.render_plain(rrays, rinst, **rkw), 3,
                                  warmup=1),
              "bound_ms": r_bound, "bound_by": r_by, "ops": r_ops, "bytes": r_bytes,
              "ctas_per_sm": rkm.occupancy(rinst.shape[2]),
              "splits": rkm.launch_splits(STG_WORLDS, rkm.tile_shape(rrays.shape[2], STG_RES)[3])}
    views_t = {"ms": cuda_ms(torch, lambda: rk_.render_views(rviews, *rinsts, **vkw), 200),
               "plain_ms": cuda_ms(torch, lambda: rkm.render_views_plain(
                   rviews, *rinsts, **rkw, **vkw), 3, warmup=1),
               "bound_ms": v_bound, "bound_by": v_by, "ops": v_ops, "bytes": v_bytes,
               "ctas_per_sm": rkm.occupancy(rinst.shape[2], views=True),
               "splits": rkm.launch_splits(STG_WORLDS, rkm.tile_shape(STG_RES ** 2, STG_RES)[3])}
    render_t = {"rays_mode": rays_t, "views_mode": views_t,
                "pairs_meeting_bounds": r_pairs, "live_rays": r_rays,
                "survivors_per_tile": {
                    f"{tw}x{th}": render_survivors(torch, rkm, rk_.tables, rrays, rinst,
                                                   STG_RES, tw, th)
                    for tw, th in ((rkm.TILE_W, rkm.TILE_H), (16, 8))},
                "render_node": node_time(torch, ssim, "batch_render"),
                "W": rrays.shape[0], "P": rrays.shape[2], "N": rinst.shape[2]}
    check(1 <= render_t["render_node"]["device_ops"] <= 3,
          f"the render node queues {render_t['render_node']['device_ops']} device ops")
    # the render kernel past one block's shared memory: main_render_large's
    # launch (views mode, 4,096 instance rows staged in blocks), and the
    # rays mode on the rays of the same views
    lk, lviews, linst, lV, lH, lWpx = render_large_in
    lW, lN, lP = linst[0].shape[0], linst[0].shape[1], lV * lH * lWpx
    lrkw = dict(tables=lk.tables, light=lk.light, ambient=lk.ambient)
    lvkw = dict(height=lH, width=lWpx, max_views=lV)
    lro, ld = rkm.camera_rays(lviews, lV, lH, lWpx)
    lrays, lpacked = lk.pack(lro.reshape(lW, -1, 3), ld.reshape(lW, -1, 3), *linst)
    l_ops, l_bytes, l_pairs, l_rays = render_work(torch, rkm, lk.tables, lrays, lpacked)
    lv_ops = l_ops + l_rays * OPS_RAY
    lv_bytes = lW * (BYTES_VIEW + lN * BYTES_INST_VIEWS + lP * BYTES_PIXEL)
    lv_bound, lv_by = bound(lv_bytes, lv_ops)
    lr_bound, lr_by = bound(l_bytes, l_ops)
    P8 = RENDER_LARGE_PARITY
    lviews8, linst8 = {key: v[:P8] for key, v in lviews.items()}, tuple(t[:P8] for t in linst)
    render_large_t = {
        "ms": cuda_ms(torch, lambda: rkm.render_views(lviews, *linst, **lrkw, **lvkw), 20),
        "plain_ms": cuda_ms(torch, lambda: rkm.render_views_plain(lviews8, *linst8, **lrkw,
                                                                  **lvkw), 2, warmup=1),
        "plain_ms_is": f"its plain version at {P8} of the {lW} worlds",
        "bound_ms": lv_bound, "bound_by": lv_by, "ops": lv_ops, "bytes": lv_bytes,
        "pairs_meeting_bounds": l_pairs, "live_rays": l_rays,
        "ctas_per_sm": rkm.occupancy(lN, views=True), "blocks_a_cta": rkm.stage_blocks(
            lN, views=True),
        "splits": rkm.launch_splits(lW * lV, -(-lWpx // rkm.TILE_W) * -(-lH // rkm.TILE_H)),
        "rays_mode": {"ms": cuda_ms(torch, lambda: rkm.render(lrays, lpacked, img_w=lWpx,
                                                               **lrkw), 20),
                      "bound_ms": lr_bound, "bound_by": lr_by,
                      "ctas_per_sm": rkm.occupancy(lN), "blocks_a_cta": rkm.stage_blocks(lN)},
        "W": lW, "P": lP, "N": lN}
    del lrays, lpacked
    # a simple_taskgraph step by node group, device ms: the physics (clamp,
    # broadphase, substeps, cleanup) and the rendering (pack, render)
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    groups = {"physics": [], "render": []}
    for node in ssim.graph.nodes:
        groups["render" if node.name in ("render_pack", "batch_render") else "physics"].append(node)

    def run_group(nodes):
        ctx = Context(ssim.mgr, ssim.state)
        for node in nodes:
            node.run(ctx)

    render_t["step_by_node_group_ms"] = {
        name: cuda_ms(torch, lambda nodes=nodes: run_group(nodes), 20)
        for name, nodes in groups.items()}

    emit({"phase": "timing", "fused_collisions_step": {
              "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
              "live_pairs": live, "overlapping_pairs": over},
          "collision_pushes": {
              "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
              "live_pairs": ulive, "overlapping_pairs": uover, "device_ops": p_ops},
          "collision_occupancy": col_occupancy,
          "collision_pushes_tiled_n1500_w16": {
              "ms_by_tile_j": tiled, "plain_ms": t_plain, "bound_ms": t_bound,
              "bound_by": t_by, "live_pairs": tlive, "overlapping_pairs": tover},
          "fused_simple_jobs_step": {
              "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
              "live_pairs": slive, "overlapping_pairs": sover, "ptxas": s_ptxas,
              "shape": s_shape, "fused_step_node": s_node},
          "fused_substep_K256": sub_t[256], "fused_substep_K128": sub_t[128],
          "fused_substep_sap_n201_K800": sub_t[SAP_K],
          "substep_occupancy": occupancy,
          "fused_substep_options": opt_t,
          "substep": sub1_t, "substep_node": node_t, "render": render_t,
          "fused_substep_hull": hull_t, "fused_substep_persist_hull": hull_persist_t,
          "substep_node_hull_joint_world": hull5_t, "fused_substep_hull_large": large_t,
          "fused_substep_windowed_n256_K1020": sub_t[LARGE_SAP_K],
          "render_blocked_4096": render_large_t,
          "library_ms": "none: no single PyTorch call computes any of these functions",
          "card": smi})

    # across ranks, and the tooling ---------------------------------------------
    emit(main_ppo_fantasy_vs_ranks(torch, fvs, learner_mod, mesh_mod, smi, reset_counts,
                                   read_counts, ppo_line))
    for line in shared_card_phases(torch, col, smi):
        emit(line)
    emit(profiler_phase(torch, col, stg, prof, smi))
    emit(autotune_phase(torch, col, tuner, smi, reset_counts, read_counts))

    if "--profile" in argv:
        profile(torch, {"fused": sim, "unfused_pushes": usim, "simple_jobs_fused": sjsim,
                        "rigid_fused_k256": rsim, "rigid_fused_k128": r128,
                        "rigid_pairs": rpairs, "rigid_sap": ssap, "rigid_sap_large": slarge,
                        "rigid_fused_bp": bsim,
                        "rigid_settled": settled_sim, "rigid_settled_nopersist": nsim,
                        "simple_jobs_rank": sjusim, "fantasy_vs": fsim,
                        "simple_taskgraph": ssim})

    csrc = "gpu_ecs_madrona_tpu_torch/csrc/"
    emit({"kernels": [
        {"name": "fused_collisions_step", "route": "cuda",
         "source": csrc + "collision_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/collision_kernel.py:330",
         "launches": fused_launches["fused_collisions_step"], "launches_per_step": 1,
         "max_abs_err": max(err_fused.values()), "ms": f_ms, "plain_ms": f_plain,
         "bound_ms": f_bound, "bound_by": f_by, "library_ms": None},
        {"name": "collision_pushes", "route": "cuda", "source": csrc + "collision_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/collision_kernel.py:212 (tiled :195)",
         "launches": unfused_launches["collision_pushes"], "launches_per_step": 1,
         "max_abs_err": max(err_p108, err_p1500), "ms": p_ms, "plain_ms": p_plain,
         "bound_ms": p_bound, "bound_by": p_by, "library_ms": None},
        {"name": "fused_simple_jobs_step", "route": "cuda",
         "source": csrc + "simple_jobs_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/simple_jobs_kernel.py:276",
         "launches": sj_launches["fused_simple_jobs_step"], "launches_per_step": 1,
         "max_abs_err": err_sj, "ms": s_ms, "plain_ms": s_plain,
         "bound_ms": s_bound, "bound_by": s_by, "library_ms": None,
         "design": "a CTA a world: a producer warp's bulk zero stores beside the chain, "
                   "a half-box bit grid re-tested in float32, shuffle scans, slots staged "
                   "and written as 16-byte stores; the node's one launch",
         "fused_step_node": {k: s_node[k] for k in ("device_ms", "host_ms", "device_ops")}},
        {"name": "fused_simple_jobs_step_rounds", "route": "cuda",
         "source": csrc + "simple_jobs_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/simple_jobs_kernel.py:276 (past 1,024 bodies)",
         "specialisation": "fused_simple_jobs_rounds_kernel", "launches": sjl_launches,
         "launches_per_step": 1, "max_abs_err": sjl_t["max_abs_err"], "ms": sjl_t["ms"],
         "plain_ms": sjl_t["plain_ms"], "plain_ms_is": sjl_t["plain_ms_is"],
         "bound_ms": sjl_t["bound_ms"], "bound_by": sjl_t["bound_by"], "library_ms": None,
         "ms_is": "main_simple_jobs_large's launch (1024 x 2048, K = 32768, D = 32)",
         "shape": sjl_t["shape"]},
        {"name": "fused_substep", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1257 (chunked :1241)",
         "launches": rig_launches, "launches_per_step": 1, "max_abs_err": err_substep,
         "ms": sub_t[256]["ms"], "plain_ms": sub_t[256]["plain_ms"],
         "bound_ms": sub_t[256]["bound_ms"], "bound_by": sub_t[256]["bound_by"],
         "library_ms": None,
         "K128": {k: sub_t[128][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "sap_n201_K800": {"launches": sap_launches,
                           **{k: sub_t[SAP_K][k] for k in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by")}},
         "bodies_in_scratch": {
             "launches": xlarge_launches, "specialisation": "win+bodies",
             **{k: xlarge_t[k] for k in ("ms", "plain_ms", "plain_ms_is", "bound_ms",
                                         "bound_by")},
             "ms_is": "main_rigid_sap_xlarge's state (1,024 rows, K = 4,092, sap)"},
         "wide_box_tables": {
             "source": csrc + "substep_wide_box_kernels.cu",
             "max_abs_err": max(wide_t["max_err"].values()), "ms": wide_t["ms"],
             "box_table_ms": wide_t["box_table_ms"],
             "ms_is": "parity_substep's K = 256 state (8192 x 65) with the box table padded "
                      "to 32 verts a hull, beside the same launch on the box table",
             "max_abs_err_is": "over every wide_box case: 9 and 32 verts padded, 12 and 20 "
                               "live, the fused kernel and kernel 5's node"}},
        {"name": "fused_substep_bp", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1278",
         "launches": bp_launches, "launches_per_step": 1, "max_abs_err": err_bp,
         "ms": opt_t["bp"]["ms"], "plain_ms": opt_t["bp"]["plain_ms"],
         "bound_ms": opt_t["bp"]["bound_ms"], "bound_by": opt_t["bp"]["bound_by"],
         "library_ms": None,
         "with_refresh_settled": {k: opt_t["bp_refresh_settled_nopersist"][k]
                                  for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "fused_substep_persist", "route": "cuda",
         "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1214",
         "launches": persist_launches, "launches_per_step": 1, "max_abs_err": err_persist,
         "ms": opt_t["persist_settled"]["ms"], "plain_ms": opt_t["persist_settled"]["plain_ms"],
         "bound_ms": opt_t["persist_settled"]["bound_ms"],
         "bound_by": opt_t["persist_settled"]["bound_by"], "library_ms": None,
         "ms_is": "the launch: world_flags, asleep_surface, fused_substep",
         "bound_ms_cache_in_and_out": opt_t["persist_settled"]["bound_ms_cache_in_and_out"],
         "every_branch": {k: opt_t["persist_settled_flipped"][k]
                          for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "fused_node_settled": {k: opt_t["fused_node_settled"][k]
                                for k in ("device_ms", "device_ops")}},
        {"name": "world_flags", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1214 (its launch's glue, "
                     "gpu_ecs_madrona_tpu/physics/__init__.py:1103-1166)",
         "launches": flags_launches, "launches_per_step": 1, "max_abs_err": err_flags,
         **{k: opt_t["persist_settled"]["parts"]["world_flags"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None},
        {"name": "asleep_surface", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1214 (its asleep worlds)",
         "launches": surface_launches, "launches_per_step": 1, "max_abs_err": err_persist,
         **{k: opt_t["persist_settled"]["parts"]["asleep_surface"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None},
        {"name": "substep", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1165",
         "launches": stg_launches["substep"], "launches_per_step": 4,
         "max_abs_err": err_substep1, "ms": node_t["ms"], "plain_ms": node_t["plain_ms"],
         "bound_ms": node_t["bound_ms"], "bound_by": node_t["bound_by"], "library_ms": None,
         "ms_is": "the node launch: integrate, steps 2-9, joints, writeback",
         "equal_work": {k: sub1_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "substep_node": {k: node_t["substep_node"][k]
                          for k in ("device_ms", "host_ms", "device_ops")},
         "bodies_in_scratch": {
             "launches": stg_large_launches,
             **{k: stg_large_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             "ms_is": "the node launch at main_simple_taskgraph_large's state (1,004 rows, "
                      "K = 10,000, 64 joint rows)"},
         "joint_rows_in_scratch": {
             "launches": jrl_launches,
             **{k: jrl_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
             "ms_is": "the node launch at main_joint_rows_large's state (1,089 rows, K = 2,048, "
                      "4,096 joint rows, 1,020 live)"}},
        {"name": "fused_substep_hull", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1257 (chunked :1241) on "
                     "general hulls (its pk.pair_contacts: gpu_ecs_madrona_tpu/physics/"
                     "pairs.py:855-1104)",
         "specialisation": "hull", "launches": hull_launches, "launches_per_step": 1,
         "max_abs_err": err_hull, "ms": hull_t["ms"], "plain_ms": hull_t["plain_ms"],
         "bound_ms": hull_t["bound_ms"], "bound_by": hull_t["bound_by"], "library_ms": None,
         "ms_is": "the main_rigid_hulls state (8192 x 65, K = 256)",
         "fused_node": {k: hull_node[k] for k in ("device_ms", "device_ops")}},
        {"name": "fused_substep_persist_hull", "route": "cuda",
         "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1214 on general hulls",
         "specialisation": "refresh+sleep+bp+persist+hull",
         "launches": hull_persist_launches, "launches_per_step": 1, "max_abs_err": err_hull,
         "ms": hull_persist_t["ms"], "plain_ms": hull_persist_t["plain_ms"],
         "bound_ms": hull_persist_t["bound_ms"], "bound_by": hull_persist_t["bound_by"],
         "library_ms": None,
         "ms_is": "the launch (world_flags, asleep_surface, fused_substep) at the settled "
                  "hull pile",
         "every_branch": hull_persist_t["every_branch"],
         "fused_node": {k: hset_node[k] for k in ("device_ms", "device_ops")}},
        {"name": "substep_hull", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1165 on general hulls",
         "specialisation": "hull (FULL: the node launch)", "launches": 0,
         "launches_is": "no main path runs a joint world of hulls; parity_hull launches it",
         "launches_per_step": 4, "max_abs_err": err_hull5, "ms": hull5_t["ms"],
         "plain_ms": hull5_t["plain_ms"], "bound_ms": hull5_t["bound_ms"],
         "bound_by": hull5_t["bound_by"], "library_ms": None,
         "ms_is": "the node launch on the joint world with prisms (256 worlds)"},
        {"name": "fused_substep_hull_large", "route": "cuda",
         "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1257 (chunked :1241) on "
                     "general hulls past PhysicsLoader()'s defaults",
         "specialisation": "hull", "launches": large_launches, "launches_per_step": 1,
         "max_abs_err": err_hull, "ms": large_t["ms"], "plain_ms": large_t["plain_ms"],
         "plain_ms_is": large_t["plain_ms_is"], "bound_ms": large_t["bound_ms"],
         "bound_by": large_t["bound_by"], "library_ms": None,
         "ms_is": "the main_rigid_hulls_large state (8192 x 65, K = 256, the 24-sided prism)"},
        {"name": "fused_substep_windowed", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1241 (the K-slab chunked "
                     "kernel) past one block's shared memory",
         "specialisation": "win", "launches": sap_large_launches, "launches_per_step": 1,
         "max_abs_err": err_window, "ms": sub_t[LARGE_SAP_K]["ms"],
         "plain_ms": sub_t[LARGE_SAP_K]["plain_ms"], "bound_ms": sub_t[LARGE_SAP_K]["bound_ms"],
         "bound_by": sub_t[LARGE_SAP_K]["bound_by"], "library_ms": None,
         "ms_is": "the main_rigid_sap_large state (8192 x 256 rows, K = 1020, sap, after 103 "
                  "steps)"},
        {"name": "render_blocked", "route": "cuda", "source": csrc + "render_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/render_kernel.py:501 (its loop over a world "
                     "tile's instances, :448-454) past one block's shared memory",
         "specialisation": "views mode, blocked", "launches": render_large_launches,
         "launches_per_step": 1, "max_abs_err": max(err_render_large, err_render),
         "ms": render_large_t["ms"], "plain_ms": render_large_t["plain_ms"],
         "plain_ms_is": render_large_t["plain_ms_is"], "bound_ms": render_large_t["bound_ms"],
         "bound_by": render_large_t["bound_by"], "library_ms": None,
         "ms_is": "main_render_large's launch (256 worlds x 4,096 instance rows, 64 x 64)",
         "rays_mode": render_large_t["rays_mode"]},
        {"name": "render", "route": "cuda", "source": csrc + "render_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/render_kernel.py:501",
         "launches": stg_launches["render"], "launches_per_step": 1,
         "max_abs_err": err_render, "ms": views_t["ms"], "plain_ms": views_t["plain_ms"],
         "bound_ms": views_t["bound_ms"], "bound_by": views_t["bound_by"],
         "library_ms": None,
         "ms_is": "the views mode: the render node's one launch (rays, trace, RGBA8/depth)",
         "rays_mode": {k: rays_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "render_node": {k: render_t["render_node"][k]
                         for k in ("device_ms", "host_ms", "device_ops")}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def profile(torch, sims):
    """torch.profiler over 20 steps of each main path: device time by
    kernel, and the device's busy share of the profiled wall time (which
    includes the profiler's own host overhead)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for name, s in sims.items():
        s.run(3)
        s.block_until_ready()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()  # after the profiler has started
            s.run(20)
            s.block_until_ready()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
        emit({"phase": f"profile_{name}", "steps": 20, "wall_us": wall_us,
              "device_busy_us": busy,
              "device_busy_share": busy / wall_us if busy else "not measured",
              "top": [{"name": e.key[:80], "us": e.self_device_time_total,
                       "calls": e.count} for e in top]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
