"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero before the last line):

1. device: requires CUDA, prints the card's name and power limit, and
   checks that float32 matmuls run in full float32 (no TF32);
2. build: compiles the three kernels with nvcc from ``ceres_tpu_torch/csrc``,
   one nvcc each, all at the same time: the sorted segment sum (K1), the
   unsorted segment sum (K3) and the fused pair-outer segment sum (K4), and
   beside them the binding of the CUDA graphs' conditional nodes
   (``graph_conditional.cu``);
3. kernel: each kernel against its plain PyTorch version on the card, at the
   shapes the solves below give it (f32 and f64) and at edge cases (K1:
   short segments, long ones and a mix; K3: its compile-time widths 9 and 81
   and run-time widths, every check launched twice and the two results held
   to the same bits; K4: K = 3, 9 x 9 through the compile-time form, other
   shapes through the run-time form), with its time, the plain
   version's, the one PyTorch call that computes the same function where
   there is one (``index_add_``), and its bound: the bytes it must move
   (inputs once, outputs once) over the card's 3.35 TB/s, or its operations
   over 67 TFLOP/s of plain float32 if that is more (CUDA events after a
   warm-up). ``ms`` is a call as the solve makes it, host enqueue included;
   ``device_ms`` is the same call replayed from a CUDA graph, which leaves
   the host out (20 calls a replay: what the last call left in the 50 MB
   L2 serves the next); ``cold_device_ms`` one call a replay, each after a
   write of L2_SCRUB_BYTES outside its events, the median of 30 (L2 cold,
   as the bound's bytes assume). K3's ``kernel_time`` lines also carry the
   times of its two kernels on their own (the gather, the sum of the
   pieces), the number of pieces and the bytes of its scratch. K4's ``kernel_time`` line also
   carries ``floor_ms``, a number modelled from the pair lists and not
   measured (so it stays out of the ``kernels`` line): the 32-byte sectors
   its row gathers touch, less those an L2 window of 25 MB of gathered
   traffic would still hold, plus lists and output, over the same memory
   rate;
4. solve, flagship: ``ceres_tpu_torch.fused_solve`` on the 16 cameras /
   22106 points / 83718 observations instance (seed 16, as bench.py builds
   it), ITERATIVE_SCHUR + SCHUR_JACOBI, in float32 and in float64, each after
   a warm-up solve and timed REPEATS times on fresh problems (every repeat
   must reach the same final cost). Both final costs must lie within 1e-3
   relative of the JAX reference's 202425.46 (BENCH_r05.json) and K1 must
   have been launched;
5. solve, large: the 464 cameras / 200 000 points / 1 200 000 observations
   instance (seed 7), DENSE_SCHUR (Cholesky of the 4176 x 4176 reduced
   camera system), in float32 and in float64, each after a 2-iteration
   warm-up solve and timed LARGE_REPEATS times on fresh problems (no kernel
   on this path adds with atomics, so every repeat must reach the same final
   cost to the bit). Both final costs must lie within 1e-3 relative of the
   JAX reference's 3587827.37 (BENCH_r05.json), and K1, K3 and K4 must each
   have been launched during the first timed solve;
5a. captured loop (``captured_loop``, right after phase 5): the fused
   loop as CUDA graphs (``utils/cuda_graph.py``). For the flagship and the
   large case in float32 and float64, the 500-pose graph (CGNR, float64),
   the flagship under CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL (float32 and
   float64) and the 500-pose graph under CGNR + SUBSET with its odometry
   edges as the subset (float64; JAX's record count and cost within 1e-9),
   on one problem each: the loop run eagerly (``profile_solve.eager_loop``:
   every ``run_if`` reads its predicate), ``ctt.solve`` (captured: the
   capture is its set-up), a repeat solve from the same start, the eager
   loop again. Every run must give the same final cost to the bit, the same
   records and LM and CG counts; the repeat at most CAPTURED_MAX_HOST_READS
   host reads (the eager count printed beside it), all its kernel launches
   credited from the graphs' replays and equal to the eager loop's, K1
   (flagship, its clusters, SUBSET's J'J cells) and K1, K3 and K4 (large)
   among them; each captured solve
   within COST_RTOL of the JAX reference. Printed: capture seconds, seconds
   per LM and CG iteration (eager and captured), host reads by site, peak
   device memory of the eager run and of the capturing solve, the bytes the
   graphs' pools keep (each program keeps one set of graphs, with their
   pools, for each option set it was solved with) and the memory reserved
   after the capture. Then ``loss_swap``: a small robust BAL solved, its
   ``LossFunctionWrapper`` reset to TrivialLoss and solved again, which
   must capture anew and equal a fresh problem's solve to the bit;
5b. sharded (``sharded``, right after phase 5a): a solve with
   ``options.mesh`` (``ceres_tpu_torch/parallel/``), the ranks started by
   ``parallel.launch.spawn_ranks`` (spawn, a ``file://`` rendezvous). (a)
   Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one card),
   ``fused_solve`` eagerly (gloo's collectives go through the host, so
   nothing is captured: every line ``captured: false``): the large case in
   float64 twice (the same bits both times, the same LM iterations as
   phase 5's float64 solve, the final cost within SHARDED_F64_RTOL), in
   float32 (within COST_RTOL of phase 5's float64), and the flagship in
   float64 (ITERATIVE_SCHUR on the explicit S at nf = 144; phase 4's
   float64 iterations, SHARDED_F64_RTOL). (b) One rank over NCCL, whose
   collectives the CUDA graphs hold (SHARDED_NCCL_RUNS): the flagship in
   float32 and the large case in float64 through ``fused_solve``, and the
   flagship in float64 with progress output through ``ctt.solve`` (the
   host loop's fused iteration), each SHARDED_NCCL_KINDS ways on one
   problem from one start: eager (``profile_solve.eager_loop`` /
   ``eager_host_loop``), captured (the first solve, which captures),
   again, and eager again. Every run the same bits (costs, records, x),
   K1 / K3 / K4 launches and all-reduce and broadcast calls and bytes;
   the fused cases phase 4's and 5's one-process results to the bit, the
   host loop the same rank's one-process ``ctt.solve``; the repeat at most
   CAPTURED_MAX_HOST_READS host reads (fused) or one an LM iteration plus
   HOST_LOOP_SETUP_READS (host loop). Per rank and solve: its K1 / K3 / K4
   launches (each non-zero where the one-process solve launches it),
   set-up seconds, seconds per LM iteration (by run, beside the
   one-process solve's), host reads by run and site, capture seconds, the
   graphs' pool bytes beside the eager peak, and the calls, bytes and
   seconds of its all-reduces (``MeshComm.timed``: the card is
   synchronized around each eager collective, so its seconds are the
   collective's own and the LM iterations include those waits; a captured
   collective adds no seconds). (c) On the same NCCL rank, the sparse
   solvers through ``ctt.solve`` (SHARDED_NCCL_RUNS' host-factor cases):
   the 2500-pose graph of phase 21 under SPARSE_NORMAL_CHOLESKY, static
   (each rank's J'J cells placed in the whole program's layout, one
   all-reduce inside the prep region, rank 0's solution broadcast inside
   the finish) and with ``dynamic_sparsity`` (the rows gathered inside the
   prep), and phase 22's sequential bundle adjustment under SPARSE_SCHUR
   (the eliminator's cells all-reduced the same way), float64, each the
   four ways of (b): the same bits, launches and collectives in every run,
   the same rank's one-process captured ``ctt.solve``'s bits and K1 / K3 /
   K4 launches (one rank sums nothing), the repeat at most
   SPARSE_MAX_READS_PER_LM_ITERATION host reads an LM iteration plus
   HOST_LOOP_SETUP_READS;
6. solve, robust large: the large instance again with ``HuberLoss(1.0)``
   (the Jacobians and residuals the kernels reduce are the loss-corrected
   ones), DENSE_SCHUR, float32 and float64, a 2-iteration warm-up and two
   timed solves each: equal final costs to the bit, a usable termination,
   both within 1e-3 relative of the JAX package's float64 cost on the same
   instance, the float32 cost within 1e-3 relative of the float64 one, and
   K1, K3 and K4 each launched;
7. solve, robust flagship: the flagship instance with ``HuberLoss(1.0)``,
   ITERATIVE_SCHUR + SCHUR_JACOBI at ``bal.default_options()``, float64,
   within 1e-3 relative of the JAX package's float64 final cost on the same
   instance, K1 launched;
8. solve, pose graph: ``pose_graph.synthesize_sphere(2500, seed=0)`` (4998
   blocks of tangent size 3 on the Eigen-quaternion manifold and in R^3, the
   first pose constant, 2598 constraints), ``ctt.solve`` with
   ``pose_graph.default_options()`` (CGNR + block Jacobi, 200 iterations),
   float64: CONVERGENCE within 1e-3 relative of the JAX package's final
   cost. Its reductions are below the kernels' sizes (2598 rows into 4998
   groups: ``index_add_``), which the phase checks and prints;
9. solve, dense: a small robust BAL (8 / 500 / 2000, seed 42, Huber) with
   DENSE_QR and with DENSE_NORMAL_CHOLESKY, each solved twice: the two
   solves' final costs and x equal to the bit (its point plan takes up to 4
   rows a group, a gather plan on the card since ``index_add_``'s atomics
   gave other last bits run to run), the two solvers within 1e-6 relative
   of each other;
10. solve, large iterative (``large_iterative``): the large instance at
   ``bal.default_options(iterative=True)``: ITERATIVE_SCHUR + SCHUR_JACOBI,
   eta 0.1, at most 50 LM iterations. nf = 4176 > 2048, so no S is
   assembled: every CG iteration runs the implicit S x (K1 on the point
   side, K3 on the camera side) and every LM iteration the implicit
   SCHUR_JACOBI blocks (K3 at d = 81). float32 and float64, a 2-iteration
   warm-up and two timed solves each, equal to the bit (cost, LM and CG
   iterations), a usable termination, within 1e-3 relative of 3587827.37,
   float32 within 1e-5 of float64; K1 and K3 launched, K4 never. Its
   ``plan`` line shows the Schur structure's plan kinds.
   ``seconds_per_cg_iteration`` is the CG loops' seconds (``_CGClock``)
   over their iterations, clocked on the same loop run eagerly; ``captured_loop_seconds_per_cg_iteration`` is the captured
   loop's seconds over its CG iterations;
11. solve, flagship preconditioners (``flagship_preconditioners``): the
   flagship instance at ``bal.default_options(iterative=True)``, float64,
   once each with IDENTITY, JACOBI,
   SCHUR_POWER_SERIES_EXPANSION (which runs the implicit S x at the
   flagship's shapes even though S is assembled), SCHUR_JACOBI with the
   power-series initialization, and SCHUR_JACOBI in float32 with
   mixed-precision refinement (3 steps), each within 1e-3 relative of the
   JAX package's final cost for the same options;
12. solve, pose graph twice (``pose_graph_repeat``):
   ``pose_graph.synthesize_sphere(500, seed=0)`` through ``ctt.solve`` twice
   in one process: every plan ``scatter`` (``index_add_``, which adds with
   atomics on the card), and the two solves' final costs and LM and CG
   iteration counts equal to the bit, the cost within 1e-3 of the JAX
   package's.
13. solve, host loop, large (``host_loop_large``): the large instance at
   ``bal.default_options(iterative=False)`` (DENSE_SCHUR) through
   ``ctt.solve`` with ``minimizer_progress_to_stdout`` (the setting of
   ``examples/bundle_adjuster.py``) and an iteration callback that keeps
   each record, which send it to the host-loop minimizer and its fused
   iteration (step, candidate and a speculative evaluation, one host read),
   captured as CUDA graphs (``host_loop_graphs``; a fresh problem's solve
   captures them: ``capture_seconds_all``).
   float32 and float64, a 2-iteration warm-up and LARGE_REPEATS timed
   solves, equal to the bit; a usable termination within 1e-3 relative of
   3587827.37; K1, K3 and K4 launched; the progress text one header and one
   line per record (captured, not printed); and the records of a
   ``ctt.solve`` of the same instance without those options (the traced
   fused loop) in the same process: the same record count, success pattern
   and linear iterations, costs within HOST_LOOP_COST_RTOL (whether the
   costs are equal to the bit is printed: the two loops scale the Jacobian
   differently, so they are not expected to be);
13a. host loop, progress output (``host_loop_progress``): the flagship
   instance at phase 4's options through ``ctt.solve`` with
   ``minimizer_progress_to_stdout`` (its text kept out of the phase
   lines), float32 and float64, on one problem: the host loop's regions run
   eagerly (``profile_solve.eager_host_loop``), ``ctt.solve`` (which
   captures them), a repeat and the eager run again
   (``_eager_captured_repeat``): the four runs equal to the bit (records
   but their times, final cost, x) with equal K1 / K3 / K4 launches; the repeat reads the host nowhere inside a graph,
   at most once per LM iteration plus HOST_LOOP_SETUP_READS, and within
   1e-3 of REFERENCE_FINAL_COST. Printed: seconds and host reads per LM
   iteration of each run, reads by site, capture seconds, the graphs and
   their pools' bytes beside the eager peak, and the bytes and device
   milliseconds of the accept copy (the fused candidate into the current
   buffers, timed over 50 replays);
14. solve, host loop, flagship (``flagship_host_loop``), float64, at
   ``bal.default_options(iterative=True)``: (a) every point's z bounded to
   [-1, 1] with the start clipped into the box (the step-by-step branch,
   the projected line search and the clamp), (b) ``use_nonmonotonic_steps``
   with an ``EvaluationCallback`` that counts its calls and a time budget of
   1e5 s. Each eager, captured, again and eager as in 13a (the same bits,
   launches and callback calls; seconds and reads of each printed), the
   captured solve against the JAX package's float64 result for the same
   problem and options: the same record count, the cost within 1e-6
   relative, (a) the final state inside the box with active bounds, (b) the
   same number of evaluation-callback calls; (a)'s line search runs its
   direction and each trial from regions (``bounded_line``,
   ``bounded_trial``), its Jacobi scaling too;
15. solve, DOGLEG, large (``dogleg_large_traditional`` in float32 and
   float64, ``dogleg_large_subspace`` in float64): the large instance at
   DENSE_SCHUR through ``ctt.solve`` with ``trust_region_strategy_type``
   DOGLEG (the host loop's step-by-step branch, its Gauss-Newton solve a
   CUDA graph), a 2-iteration warm-up on a problem of its own, then eager,
   captured, again and eager on one problem as in 13a (host reads
   counted by ``torch.cuda.set_sync_debug_mode``). float64 against the JAX
   package's float64 record count and cost (1e-9), float32 within 1e-6 of
   float64; K1, K3 and K4 launched; the Gauss-Newton retries at a larger
   mu reported; the step choice runs from regions too
   (``host_loop_graphs.DoglegRegions``: traditional, subspace model,
   subspace step);
16. solve, inner iterations, large (``inner_iterations_large``): the same
   with LM and ``use_inner_iterations`` (the LM step and each set step of
   the inner passes captured, ``host_loop_graphs.InnerRegions``), float32
   and float64: the independent sets, their plan kinds (gather plans),
   the inner steps, a pass's seconds in each run, the sets' construction
   once per program (its seconds; a second one fails the phase), the
   launches of the inner passes apart from the LM step's (both K1 and K3
   launched inside them, credited at each replay), and each run's inner
   passes reading the host once each, at one site of inner_iterations.py;
   float64 against JAX's records, cost and inner steps, its repeat's reads
   an LM iteration beside the 11.3 of the set steps run op by op, float32
   within 1e-5 of float64 (ten function tolerances: the f32 end is set by
   rounding noise, INNER_F32_RTOL); then ``inner_iterations_flagship``, the flagship with
   inner iterations at ``bal.default_options(iterative=True)`` the same
   way, float64 against FLAGSHIP_INNER_REFERENCE (records, inner steps,
   cost within 1e-9), float32 within 1e-6 of float64;
17. solve, flagship line search (``flagship_line_search``): the flagship
   through ``ctt.solve`` with the LINE_SEARCH minimizer (L-BFGS, Wolfe,
   100 iterations), float64, on one problem from one start: its regions
   (``host_loop_graphs.LineSearchGraphs``: the start's cost and gradient,
   phi) run eagerly, captured, again and eagerly, every record, the final
   cost and x equal to the bit and the same K1 / K3 launches, K1 launched
   (the gradient's gather sums its rows through it); the repeat reads the
   host at most 3.08 times an iteration and nowhere inside a graph;
   seconds and host reads an iteration of each run, the capture's seconds,
   the graphs' pool bytes beside the eager peak; one more captured solve
   split into its evaluations, directions and reads (host seconds, and
   the device seconds of the phi replays and the directions from CUDA
   events); against JAX: the record count and termination, and the final
   cost and the costs of records 25, 50 and 75 each within 1e-6 relative,
   or within ten times the reference's own change under a one-ulp change
   of the start where that is larger (1.1e-5 at record 100); the captured
   gradient at the start equal to the eager one to the bit; float32
   reported;
18. solve, gradient problem (``gradient_problem``): ``examples/
   rosenbrock.py``'s problem through ``ctt.solve_gradient_problem`` per
   direction type, eager, captured, again and eager on one problem (the
   same records and x to the bit; seconds and host reads an iteration),
   against JAX: the termination, and x within 1e-8 with the record count
   where the reference's trajectory is steady (L-BFGS, BFGS), within ten
   times its one-ulp spread where it is not (nonlinear CG, steepest
   descent);
19. solve, gradient checks (``check_gradients``): the flagship with
   ``check_gradients`` for 3 iterations (usable), and a residual whose
   hand-written Jacobian is wrong: FAILURE with the JAX package's message;
20. solve, large, CLUSTER_JACOBI (``large_iterative_cluster_jacobi``, after
   the inner iterations): the large instance under ITERATIVE_SCHUR with
   CLUSTER_JACOBI on the implicit S, float32: the loop run eagerly (the
   preconditioner's build seconds, synchronized: the cluster blocks from
   probes S e_i in chunks of columns, ``linear/schur.PROBE_CHUNK_BYTES``;
   its peak memory), then ``ctt.solve`` (captured, the probes inside the
   iteration graph: capture seconds, graph pool bytes, seconds per LM
   iteration) and a repeat (host reads): the three the same final cost to
   the bit and the same launches, the cost within 1e-3 of the JAX
   package's float64 cost at the large phase's options
   (LARGE_F64_FINAL_COST);
21. solve, pose graph, SPARSE_NORMAL_CHOLESKY
   (``pose_graph_sparse_cholesky``): the 2500-pose sphere through
   ``ctt.solve`` (the host loop's sparse step: J'J cells reduced on the card,
   factored on the host by the native core, AMD), float64, run eagerly,
   captured (the evaluations, the candidate and the step's prep and finish
   as CUDA graphs around the host factor), again and eagerly
   (``_eager_captured_repeat``): every run the same bits and launches,
   JAX's record count and cost within 1e-9, the captured repeat at most
   SPARSE_MAX_READS_PER_LM_ITERATION host reads an LM iteration plus
   HOST_LOOP_SETUP_READS, the CGNR phase's seconds beside it; then the
   same graph under DOGLEG (``pose_graph_sparse_cholesky_dogleg``: its
   Gauss-Newton solve as two regions around the host factor,
   ``dogleg.SparseGaussNewton``), the same four runs and checks, held to
   JAX's record count and cost within 1e-9
   (POSE_GRAPH_SPARSE_DOGLEG_REFERENCE); then under DOGLEG with
   ``use_mixed_precision_solves`` (``pose_graph_sparse_cholesky_dogleg_mixed``:
   the f32 system's cells read once a point, the host's f32 solve refined
   from the ``dogleg_sparse_refine`` region's f64 residual), the same four
   runs, JAX's record count and cost within 1e-9
   (POSE_GRAPH_SPARSE_DOGLEG_MIXED_REFERENCE), at most
   SPARSE_MAX_READS_PER_LM_ITERATION + the refinement steps host reads an
   LM iteration plus HOST_LOOP_SETUP_READS, its three regions captured;
22. solve, sequential bundle adjustment, SPARSE_SCHUR
   (``sequential_ba_sparse_schur``): ``sequential_instance`` (1723 cameras,
   156 502 points, 678 718 observations, the shape of BAL's Ladybug
   problem-1723-156502; nf = 15 507), the host loop's SPARSE_SCHUR step (the
   reduced cells on the card: K1, K3, K4; the banded S factored on the
   host), float32 and float64, each eager, captured, again and eager as
   phase 21: float64 against JAX's record count and cost (1e-9), float32
   within 1e-5 of float64, K1, K3 and K4 each launched, as many times in
   every run, the same read bound;
23. solve, flagship clusters (``flagship_cluster_jacobi``,
   ``flagship_cluster_tridiagonal``): the flagship under ITERATIVE_SCHUR
   with each cluster preconditioner (the fused loop; the clusters by
   canonical views and their chains by the linear forest, in the native
   core), float32 and float64, captured: float64 against JAX's LM and CG
   counts and cost (1e-9), float32 within 1e-5 of float64; capture
   seconds, graph pool bytes, seconds per LM iteration and a repeat's host
   reads;
24. covariance, large (``covariance_large``, float64 and float32, after the
   cluster phase on the same instance): ``ctt.Covariance().compute`` at the
   instance's own values (no solve), camera 0 and the last point constant
   (the 7-dof gauge; the point ids stay sorted), every camera's diagonal
   block and 4 cross pairs by the Schur marginals (S assembled on the card
   by K1, K3 and K4, its SPD gate, inverse and S S^-1 - I check in float64
   on the host): 4 named blocks (diagonal, largest entry, norm, sum) and
   trace(S^-1) against JAX f64 (COVARIANCE_RTOL), the seconds of the
   Jacobian, the S assembly and the inverse, the plan kinds, and K1, K3 and
   K4 each launched;
25. covariance, pose graph, matrix-free
   (``covariance_pose_graph_matrix_free``): the 2500-pose sphere (15 000
   tangent coordinates, no Schur structure): 9 columns of inverse(J'J) by
   batched Jacobi-preconditioned CG (8 columns at a time, each stopping on
   its own test), captured once per ``compute`` and replayed per chunk; the
   quaternion blocks of poses 1, 1250 and 2499 in ambient space against JAX
   (1e-5) and each column's CG iterations against JAX's (20%); the same
   computation on a 700-pose sphere (COVARIANCE_TWIN_POSES: the eager
   twin's depth, cut so that the script stays within its time) with the CG
   run eagerly and captured, equal to the bit (columns and counts); host
   reads per chunk and seconds per CG iteration of each;
26. numeric differentiation (``numeric_diff_flagship``): the flagship with
   its Snavely residual under ``ctt.numeric_diff``, CENTRAL to convergence
   and RIDDERS for 3 iterations, float64: JAX's records and CG iterations,
   costs within NUMERIC_DIFF_RTOL;
27. denoising (``denoising_foe``, float64 and float32): a 481 x 321 image
   with noise 20 and a Field of Experts of 24 5 x 5 filters, written as
   .pgm and .foe and loaded by ``models/denoising.py``, CGNR + JACOBI for
   10 iterations: float64 against JAX's records (1e-10), float32 against
   float64; K1 launches per CG iteration, and one LM iteration under
   torch.profiler: device operations per CG iteration and the idle share;
28. libmv (``libmv_{fixed,refined}_intrinsics``, float64): a 300-frame,
   2000-track shot (100 000 markers in frame order) written as a libmv .bin
   and loaded, ITERATIVE_SCHUR + SCHUR_JACOBI: JAX's records and CG
   iterations, costs within LIBMV_RTOL; the plan kinds; K3 launched; and
   the refined shot with the gauge fixed (``libmv_refined_gauge_fixed``,
   camera 0 and the last point constant) against JAX within ten times the
   reference's own one-ulp spread (LIBMV_GAUGE_FIXED_SPREAD);
29. NIST (``nist``): ``nist.run_suite`` over Misra1a, Thurber and BoxBOD
   written as .dat files, float64: final costs (1e-10) and LREs (1e-6)
   against JAX's, the record counts printed beside JAX's;
30. TinySolver (``tiny_solver_batch``): 65 536 problems (Rosenbrock and an
   exponential fit) in one ``ctt.tiny_solve`` on the card (captured at its
   first call, replayed at the repeat): every lane's iterations and status
   (exact lane-weighted sums) and the sums of x and x^2 (1e-10) against
   JAX's ``vmap(tiny_solve)``, the repeat and the same solve run eagerly
   equal to the bit; the first call's capture seconds, the repeat's seconds
   and host reads;
31. the C API (``c_api``): the curve fit y = exp(m x + c) through
   ``ceres_problem_add_residual_block`` with a numpy callback and a Cauchy
   stock loss, then ``ceres_solve`` on the card: the caller's arrays written
   back, m and the final cost within 1e-10 of JAX's, the report printed;
32. interpolation (``interpolation``): examples/bicubic_interpolation.py's
   translation recovery on a 512 x 512 grid with 65 536 samples: JAX's
   records (1e-10) and the shift (1e-9);
33. the example programs (``examples``): each of the 26 programs of
   ``ceres_tpu_torch/examples/`` once through its ``main`` with ``--device
   cuda`` at the reference's defaults (EXAMPLES; the cuts of EXAMPLE_CUTS
   are printed), their inputs written by the writers above (the NIST
   models, the libmv shot, the denoising image and experts, and a 2-D pose
   graph the size of Manhattan M3500 by ``write_g2o_2d``): per program its
   seconds, solves, records, final costs, relative error against the JAX
   package's f64 results (EXAMPLES_REFERENCE, held by ``held_to_example``)
   and K1 / K3 / K4 launches; bundle_adjuster, simple_bundle_adjuster,
   libmv_bundle_adjuster and denoising must launch the kernels of
   EXAMPLE_KERNELS.

Every sparse phase (21, 22, and 5b's host-factor cases) also prints, per run, the host's seconds of
numeric factorization and solve and their share of the run, the bytes
copied to the host per iteration, and the host reads, seconds and host
reads per LM iteration; the first run's symbolic analysis seconds and the
nnz of the factored matrix and of L; the capture's seconds, the graphs'
names and pool bytes beside the eager peak. The native core is compiled
with g++ at its first use (``ceres_tpu_torch/utils/native.py``).

``solve_seconds`` is the LM loop on the device (the graphs' replays where
the loop is captured: ``fused_lm.captured_loop_eligible``); the host set-up
of each fresh problem, the capture included, is reported as
``setup_seconds``. Launch counters are set to zero just before a timed
solve and read just after it; a launch captured into a graph counts once
per replay that ran it (the counts are read with the loop's results); the
eager warm-up a capture needs counts nowhere. K1's and K3's are also
reported by the width d of what they reduce (``launches_by_width``).

A ``plan`` line of case ``every_program`` lists every site that built a
reduce or gather plan on the card in this run, the sharded phase's ranks
included (the file:line outside ``ops/reduce.py`` that asked for the plan):
its plan kinds, how many of each and the most rows any group took; the run
fails where a card plan is ``scatter`` with more than two rows in a group
(``index_add_``'s atomics would give other last bits run to run;
``ops/reduce.reduce_plan_kind``).

Before the last line: an ``elapsed`` line (the script's seconds), one
``{"kernels": [...]}`` line (per kernel: its times at the large case's
float32 shape, its launches in the large float32 solve, its launches by
width there and in the large iterative float32 solve, and under
``launches_by_path`` its launches in the first timed solve of every path
above) and the card's name and power limit. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
import io
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch import dogleg, fused_lm, host_loop_graphs, inner_iterations
from ceres_tpu_torch.linear import schur as schur_mod
from ceres_tpu_torch.linear import sparse_cholesky
from ceres_tpu_torch.linear.schur_explicit import build_explicit_plan
from ceres_tpu_torch.models import bal, denoising, libmv, nist, pose_graph
from ceres_tpu_torch.ops import cuda_build
from ceres_tpu_torch.ops import outer_segment_sum as osum
from ceres_tpu_torch.ops import reduce as reduce_mod
from ceres_tpu_torch.ops import segment_sum as ss
from ceres_tpu_torch.ops import unsorted_segment_sum as us
from ceres_tpu_torch.tools.profile_solve import (
    _device_profile,
    _host_reads,
    eager_gradient_problem,
    eager_host_loop,
    eager_loop,
)
from ceres_tpu_torch.utils import cuda_graph

NUM_CAMERAS, NUM_POINTS, NUM_OBS, SEED = 16, 22106, 83718, 16
LARGE = dict(num_cameras=464, num_points=200_000, num_observations=1_200_000, seed=7)
PERTURB, NOISE = 0.7, 2.0
REFERENCE_FINAL_COST = 202425.46  # ceres_tpu fused_solve, f32 (BENCH_r05.json)
LARGE_REFERENCE_FINAL_COST = 3587827.37  # the same, large case
COST_RTOL = 1e-3
# ceres_tpu.fused_lm.fused_solve on the flagship instance with
# HuberLoss(1.0) and bal.default_options(iterative=True), float64, JAX on
# the CPU: CONVERGENCE after 39 iterations.
ROBUST_FLAGSHIP_REFERENCE_FINAL_COST = 114544.60539235643
# ceres_tpu.solve on pose_graph.synthesize_sphere(2500, seed=0) with
# pose_graph.default_options(), float64, JAX on the CPU: CONVERGENCE after
# 96 LM iterations and 44 687 CG iterations, from 10.250683705811847.
POSE_GRAPH_POSES, POSE_GRAPH_SEED = 2500, 0
POSE_GRAPH_JAX_ITERATIONS = (95, 44687)  # the JAX package's LM / CG iterations there
POSE_GRAPH_REFERENCE_FINAL_COST = 0.377419867537356
# The same for synthesize_sphere(500, seed=0) (518 constraints, every plan
# ``scatter``): CONVERGENCE after 15 LM and 3837 CG iterations.
POSE_GRAPH_REPEAT_POSES = 500
POSE_GRAPH_REPEAT_REFERENCE_FINAL_COST = 0.058063696871759066
# ceres_tpu.fused_lm.fused_solve on the large instance with HuberLoss(1.0)
# and the large phase's options, float64, JAX on the CPU: CONVERGENCE after
# 25 LM iterations (without the loss: 4 LM iterations, 3587827.41019063);
# ``python tests/test_torch_references.py large`` computes it.
ROBUST_LARGE_REFERENCE_FINAL_COST = 1938982.64885512
SMALL_ROBUST = dict(num_cameras=8, num_points=500, num_observations=2000, seed=42)
# The host loop's records against the traced loop's (host_loop_large).
HOST_LOOP_COST_RTOL = {"float32": 1e-6, "float64": 1e-12}
# ceres_tpu.solve on the flagship instance at bal.default_options(
# iterative=True), float64, JAX on the CPU (host loop): (records, final
# cost[, evaluation-callback calls]). Bounded: every point's z in [-1, 1],
# the start clipped into the box (CONVERGENCE, 5645 bounds active at the
# end); non-monotonic: with use_nonmonotonic_steps, an EvaluationCallback
# and max_solver_time_in_seconds=1e5 (CONVERGENCE; no step raised the cost);
# ``python tests/test_torch_references.py flagship_host_loop`` computes them.
FLAGSHIP_BOUNDED_REFERENCE = (34, 4739293.539734491)
FLAGSHIP_NONMONOTONIC_REFERENCE = (4, 202425.5312170272, 8)
FLAGSHIP_HOST_LOOP_RTOL = 1e-6
# The large iterative solve's float32 cost against its float64 one.
LARGE_ITERATIVE_F32_RTOL = 1e-5
# ceres_tpu.fused_lm.fused_solve on the flagship instance at
# bal.default_options(iterative=True) (function tolerance 1e-6), float64,
# with the changes named, JAX on the CPU: (changes, final cost); all
# CONVERGENCE, in 6 / 4 / 4 / 4 / 4 LM and 92 / 12 / 8 / 4 / 77 CG
# iterations. The last runs in float32 as named (the same options with
# float64 evaluation end at 202425.45070322294).
FLAGSHIP_PRECONDITIONERS = {
    "IDENTITY": (dict(preconditioner_type=ctt.PreconditionerType.IDENTITY),
                 202425.45296992327),
    "JACOBI": (dict(preconditioner_type=ctt.PreconditionerType.JACOBI), 202425.4507877496),
    "SCHUR_POWER_SERIES_EXPANSION": (
        dict(preconditioner_type=ctt.PreconditionerType.SCHUR_POWER_SERIES_EXPANSION),
        202425.45068803162,
    ),
    "SCHUR_JACOBI, use_spse_initialization": (dict(use_spse_initialization=True),
                                              202425.45070201234),
    "SCHUR_JACOBI, float32, use_mixed_precision_solves": (
        dict(evaluation_dtype="float32", use_mixed_precision_solves=True,
             max_num_refinement_iterations=3),
        202425.44741709408,
    ),
}
DENSE_RTOL = 1e-6
# ceres_tpu.solve of the large instance at the large phase's options
# (DENSE_SCHUR, 50 iterations), float64, JAX on the CPU: (records, final
# cost); CONVERGENCE, no inner iterations. ``python
# tests/test_torch_references.py large_dogleg large_inner`` computes them.
LARGE_DOGLEG_REFERENCE = {
    "TRADITIONAL_DOGLEG": (6, 3587828.136066581),
    "SUBSPACE_DOGLEG": (5, 3587828.2958576186),
}
# The same with use_inner_iterations (LM): (records, final cost, inner
# iteration steps); in float32 JAX ends at 3587824.5405506883 in 3 records,
# 9.1e-7 from its float64 cost.
LARGE_INNER_REFERENCE = (3, 3587827.7881201766, 2)
# The large f64 solve's captured repeat read the host 11.3 times an LM
# iteration while the inner set steps ran op by op (PERF.md §5): of its 34
# reads, 12 were the set steps' torch.linalg.solve waiting for its LU's
# status and 6 the sets' and plans' construction, made again in every solve.
INNER_LARGE_F64_READS_OP_BY_OP = 11.3
# ceres_tpu.solve of the flagship instance at bal.default_options(
# iterative=True) (50 iterations) with use_inner_iterations, float64, JAX on
# the CPU: (records, final cost, inner iteration steps); CONVERGENCE after 8
# CG iterations. ``python tests/test_torch_references.py flagship_inner``.
FLAGSHIP_INNER_REFERENCE = (4, 202425.46404757453, 2)
MINIMIZER_F64_RTOL = 1e-9  # the port's f64 against JAX f64
MINIMIZER_F32_RTOL = 1e-6  # the port's f32 against its own f64 (DOGLEG)
# With inner iterations in f32 the end is set by f32 noise: each inner
# pass keeps, block by block, the steps whose f32 cost came out lower, so
# the point it returns sits in a dip of the rounding, and the next LM
# steps of any length raise the cost by about 1e-6 of it, the function
# tolerance. Whether a solve stops there or goes on depends on that noise
# (JAX f32 stops, 9.1e-7 from its f64; the port's f32 goes on and ends
# lower, PERF.md §6): held to ten function tolerances.
INNER_F32_RTOL = 1e-5
# ceres_tpu.solve of the flagship instance at bal.default_options(
# iterative=True) with the LINE_SEARCH minimizer (L-BFGS, Wolfe, 100
# iterations), float64, JAX on the CPU: 101 records, NO_CONVERGENCE, 105
# line-search evaluations; the costs of records 25, 50, 75 and 100; and how
# far the reference's own costs move when one coordinate of the start moves
# one ulp either way (the larger relative change of the two, for the final
# cost and those records). ``python tests/test_torch_references.py
# flagship_line_search``.
FLAGSHIP_LINE_SEARCH_REFERENCE = dict(
    records=101, termination="NO_CONVERGENCE", evaluations=105,
    final_cost=7484664.97285633, checked_records=(25, 50, 75, 100),
    checked_costs=(38771243.462369174, 9673571.268538622, 8581058.010247126,
                   7484664.97285633),
    spread=(1.0986929732932618e-06, 1.6910757406211712e-14, 3.628987904573444e-12,
            2.8534593057405817e-09, 1.0986929732932618e-06),
)
# A cost is held to 1e-6 relative, or to ten times the reference's own
# one-ulp spread where that is larger (the final cost: 1.1e-5).
LINE_SEARCH_COST_RTOL = 1e-6
# ceres_tpu.solve_gradient_problem of examples/rosenbrock.py's problem
# (max_num_iterations=200) per direction type, JAX on the CPU: (records,
# termination, final x, the largest change of x when the start moves one
# ulp either way); ``python tests/test_torch_references.py rosenbrock``.
ROSENBROCK_REFERENCE = {
    "LBFGS": (39, "CONVERGENCE", (1.0000000006592433, 1.0000000012066341), 2.220446049250313e-16),
    "BFGS": (39, "CONVERGENCE", (0.9999999999998593, 0.9999999999996787), 0.0),
    "NONLINEAR_CONJUGATE_GRADIENT": (109, "CONVERGENCE", (1.0000045216437425, 1.0000090715450483),
                                     2.3024588142295244e-05),
    "STEEPEST_DESCENT": (201, "NO_CONVERGENCE", (0.5039254785402206, 0.24947119985608857),
                         1.713376922271581e-05),
}
ROSENBROCK_X_ATOL = 1e-8  # or ten times the reference's one-ulp spread of x
# The message of a solve with check_gradients of r = x^2 - 2 at x = 1.5
# whose hand-written Jacobian is 3x, from ceres_tpu.solve (``python
# tests/test_torch_references.py check_gradients``).
WRONG_JACOBIAN_MESSAGE = (
    "Gradient check failed: family fn instance 0 arg 0: relative error 3.333333e-01"
)
# The sequential bundle adjustment of the SPARSE_SCHUR phase
# (sequential_instance): 678 718 observations.
SEQUENTIAL = dict(num_cameras=1723, num_points=156502, fifth=52710, seed=11)
# ceres_tpu.solve, float64, JAX on the CPU (``python
# tests/test_torch_references.py sparse_pose_graph sparse_sequential
# sparse_flagship_clusters``): the 2500-pose graph at
# pose_graph.default_options() with SPARSE_NORMAL_CHOLESKY (AMD): (records,
# final cost); the sequential bundle adjustment at bal.default_options(
# iterative=False) with SPARSE_SCHUR (AMD): (records, final cost); the
# flagship at bal.default_options(iterative=True) with each cluster
# preconditioner: (records, CG iterations, final cost).
POSE_GRAPH_SPARSE_REFERENCE = (15, 0.3774149708801168)
# the same graph and options under DOGLEG (traditional): (records, final
# cost) (``tests/test_torch_references.py sparse_pose_graph_dogleg``)
POSE_GRAPH_SPARSE_DOGLEG_REFERENCE = (4, 0.3774152347290844)
# and with use_mixed_precision_solves (its f32 solves refined once in f64)
# (``tests/test_torch_references.py sparse_pose_graph_dogleg_mixed``)
POSE_GRAPH_SPARSE_DOGLEG_MIXED_REFERENCE = (4, 0.3774152347290854)
SEQUENTIAL_SPARSE_SCHUR_REFERENCE = (10, 10.92539723105676)
FLAGSHIP_CLUSTER_REFERENCE = {
    "CLUSTER_JACOBI": (4, 9, 202425.49037236028),
    "CLUSTER_TRIDIAGONAL": (4, 7, 202425.46639867526),
}
SPARSE_F32_RTOL = 1e-5  # the sparse and cluster phases' float32 against float64
# ceres_tpu.fused_solve of the large instance at the large phase's options,
# float64, JAX on the CPU (the large ITERATIVE_SCHUR + CLUSTER_JACOBI phase
# is held to it: its own JAX f64 reference would probe the implicit S at
# every column at once, about 80 GB).
LARGE_F64_FINAL_COST = 3587827.41019063
# Slice 10's references: JAX f64 on the CPU (``JAX_PLATFORMS=cpu
# PYTHONPATH=. python tests/test_torch_references.py covariance
# covariance_matrix_free numeric_diff denoising libmv nist tiny c_api
# interpolation``). Covariance blocks are held through their fingerprints
# (diagonal, largest |entry|, norm, sum; tests/test_torch_references.py
# block_fingerprint), relative to the block's largest |entry|.
COVARIANCE_LARGE_REFERENCE = dict(
    # trace(S^-1): the variable cameras' diagonal blocks
    trace=71.13133694662783,
    blocks={
        '1,1': dict(diag=[1.1237842281619177e-07, 1.1114478361772948e-07, 5.0965646005222846e-08,
            7.046182844902925e-07, 7.603527986102352e-07, 9.165347822987824e-05,
            0.15285200062451074, 2.7857007905015785e-05, 0.00014544201562679965],
             max_abs=0.15285200062451074, norm=0.15293844167835127, sum=0.14952185652459368),
        'mid,mid': dict(diag=[9.862964693565306e-08, 9.502426979283881e-08, 7.233738545943246e-08,
            6.81615243590569e-07, 0.0001766271165731128, 0.000800165311700539,
            0.1495189916146414, 2.340316404168435e-05, 0.00010984126676754425],
             max_abs=0.1495189916146414, norm=0.14959605568572115, sum=0.14570501169079692),
        '1,2': dict(diag=[5.4237299977290915e-08, 5.380884780760054e-08, 2.431557658266616e-08,
            3.5960032226146533e-07, 3.393538324933649e-07, 4.024969504498982e-06,
            0.0009840698217369816, 9.684400840938213e-08, 3.870198592996422e-07],
             max_abs=0.0009840698217369816, norm=0.0009845867779955842, sum=0.0009564160208623732),
        '1,last': dict(diag=[5.381398968899915e-08, 5.343357071885722e-08, 2.4387013135684785e-08,
            3.133868175782027e-07, 3.4137879331136e-07, 3.903904200711328e-06,
            0.0008567368638650761, 9.875650399656817e-08, 3.7702755166294854e-07],
             max_abs=0.0008567368638650761, norm=0.000857121121359604, sum=0.0008310552282762093),
    },
)
# float32: S assembled and the Jacobian evaluated in f32, inverted in f64;
# measured on an NVIDIA H100 80GB HBM3 (700 W): 1.2e-4 (block "mid,mid"),
# 7.2e-5 (trace).
COVARIANCE_RTOL = {"float64": 1e-8, "float32": 1e-3}
COVARIANCE_MATRIX_FREE_REFERENCE = dict(
    # each column's CG iterations (poses 1, 1250, 2499: 3 quaternion
    # coordinates each); JAX's batched loop gives the same numbers
    cg_iterations=[4553, 5103, 5057, 5697, 5698, 5676, 5906, 5981, 5947],
    blocks=[
        dict(diag=[0.24021092546830464, 0.23835945267899977, 0.23847025348408682,
                   3.3919393178877895e-06], max_abs=0.24021092546830464,
             norm=0.413988961019973, sum=0.7169753058511957),
        dict(diag=[11.97711667206777, 11.967937128714082, 4.24738857608672e-05,
                   11.944589084744964], max_abs=11.97711667206777,
             norm=20.720933673696155, sum=35.929126753752044),
        dict(diag=[29.701732452246777, 29.701699988694912, 29.648540475078136,
                   2.1539028649402655e-28], max_abs=29.701732452246777,
             norm=51.41420034152782, sum=89.0393026039456),
        dict(diag=[-0.00913797054136639, -0.008028816175134812, -0.008336609815372072,
                   8.474377441668475e-20], max_abs=0.00913797054136639,
             norm=0.014838603495624431, sum=-0.028365097638858125),
    ],
)
# CG stops at a relative residual of 1e-10: blocks within 1e-5 of their
# largest entry. Its iteration counts at that stop are set by rounding:
# JAX's own counts move by up to 3.1% when its preconditioner changes by one
# ulp, and the port's take 0.3% to 15.5% more than JAX's on the card and on
# a CPU, its single-vector CG (the solver's) too, with J'J v and diag(J'J)
# equal to JAX's within 1.1e-16 and 3.4e-16 (PERF.md §7): held to 20%.
COVARIANCE_MATRIX_FREE_RTOL = 1e-5
CG_ITERATIONS_RTOL = 0.2
# (records as (cost, CG iterations), final cost, termination) per method.
NUMERIC_DIFF_REFERENCE = {
    "CENTRAL": ([(71972086.5122163, 0), (418542.3043438898, 2), (202459.27422362135, 3),
                 (202425.53121703022, 3)], 202425.53121703022, "CONVERGENCE"),
    "RIDDERS": ([(71972086.5122163, 0), (418542.30436535086, 2), (202459.27422364065, 3),
                 (202425.53121702716, 3)], 202425.53121702716, "NO_CONVERGENCE"),
}
# A finite difference turns last-bit differences of the residual into 1e-10
# of the Jacobian, which moves a record's cost to first order far from the
# minimum (tests/test_torch_references.py test_numeric_diff_references_match_jax).
NUMERIC_DIFF_RTOL = 1e-8
DENOISING_ITERATIONS = 10
DENOISING_REFERENCE = ([(1529663.2039871612, 0), (69837.61987418967, 4),
                        (54651.90377200466, 22), (54554.79205763459, 22),
                        (54553.65283817153, 20)], 54553.65283817153, "CONVERGENCE")
DENOISING_RTOL = 1e-10
DENOISING_F32_RTOL = 1e-6  # measured on an NVIDIA H100 80GB HBM3 (700 W): 7.2e-8
# {refine_intrinsics: (records, final cost, termination)}
LIBMV_REFERENCE = {
    False: ([(5458768.288521015, 0), (9597.541373166938, 2), (8676.294153733601, 8),
             (8667.858754684534, 18), (8666.363787358008, 21), (8666.2965433788, 32)],
            8666.2965433788, "CONVERGENCE"),
    True: ([(5458768.288521015, 0), (17446.884252256095, 2), (8846.404620681027, 3),
            (8706.542806642192, 15), (8673.644588642112, 49), (8668.332539074367, 21),
            (8666.745861525666, 45), (8666.106507098577, 83), (8665.842839123772, 71),
            (8665.778385664038, 83), (8665.757849056496, 83)],
           8665.757849056496, "CONVERGENCE"),
}
# Refined intrinsics couple every camera, and no block fixes BA's 7-dof
# gauge: CG on that S takes other iterations on the card from record 4 on
# (82 and 70 against JAX's 83), and the records part by up to 6.8e-7, the
# final cost by 2.1e-7 (an NVIDIA H100 80GB HBM3). Fixed: records to 1e-10 with
# JAX's CG iterations; refined: the record count, every record within
# 1e-5, the final cost within 1e-6, the CG iterations printed.
LIBMV_RTOL = {False: 1e-10, True: 1e-5}
LIBMV_REFINED_FINAL_RTOL = 1e-6
# The refined shot with the gauge fixed (camera 0 and the last point
# constant, libmv_problem's "gauge_fixed"): JAX f64 on a CPU, and how far
# JAX's own records and final cost move when the first point's first
# coordinate moves one ulp either way (the largest relative change of a
# record, of the final cost; 12 records instead of 13 one way): the phase
# holds the common records and the final cost to ten times that spread and
# prints the record count beside JAX's (ROADMAP "Facts about the
# reference": the refined records are rounding's in the reference itself).
LIBMV_GAUGE_FIXED_REFERENCE = (
    [(5458768.288521015, 0), (15651.589538156642, 2), (8830.999283081306, 3),
     (8719.161384419886, 9), (8682.346337674573, 78), (8669.025216164915, 86),
     (8667.771964451998, 42), (8667.148531508117, 79), (8666.390244454302, 87),
     (8666.273530994862, 87), (8666.21949200578, 43), (8666.183257075645, 91),
     (8666.152323471628, 39)],
    8666.152323471628, "CONVERGENCE")
LIBMV_GAUGE_FIXED_SPREAD = (6.350813417665724e-06, 9.737033844950498e-08)
# run_suite: (name, start, LRE, final cost, records, termination). With
# tolerances of 1e-18 the stop comes after the cost has settled, on a step
# that rounding decides (tests/test_torch_nist.py): the records and the
# termination are printed beside JAX's, not held to them (Misra1a from its
# first start ran to the 10 000-iteration limit on an H100, 28 records in
# JAX, at the same cost).
NIST_REFERENCE = [
    ("BoxBOD", 0, 0.0, 7859.4047730814655, 15, "CONVERGENCE"),
    ("BoxBOD", 1, 0.9258268878109133, 493.67467314324796, 14, "CONVERGENCE"),
    ("Misra1a", 0, 1.7675638597623289, 0.04044879168105487, 28, "CONVERGENCE"),
    ("Misra1a", 1, 1.767563859762364, 0.04044879168105487, 17, "CONVERGENCE"),
    ("Thurber", 0, 1.5042457639772786, 1366.5200713967206, 20, "CONVERGENCE"),
    ("Thurber", 1, 1.5042457639773126, 1366.5200713967206, 22, "CONVERGENCE"),
]
NIST_COST_RTOL = 1e-10
NIST_LRE_ATOL = 1e-6
TINY_REFERENCE = dict(
    iterations=732965, iterations_by_lane=16544010963, status_counts=[0, 0, 65536, 0],
    status_by_lane=4294901760,
    x_sum=[98303.99951609717, -9830.400713237748, 16384.000414002167, 0.0],
    x_sq_sum=[163839.99830018717, 88145.92076739388, 8192.000414002292, 65536.0],
)
TINY_X_RTOL = 1e-10
# (m, c, final cost, records, report printed)
C_API_REFERENCE = (0.30676830615215217, 0.07393656582433863, 1.0373197100969567, 13, True)
C_API_RTOL = 1e-10
# (records, final cost, shift, termination)
INTERPOLATION_REFERENCE = (
    [(13093619596.713406, 0), (265413.96492089354, 1), (3.305008165370112, 1),
     (3.3044264145533058, 1)], 3.3044264145533058, [1.2999999617040858, -0.7000000002714833],
    "CONVERGENCE")
INTERPOLATION_RTOL = 1e-10
INTERPOLATION_SHIFT_ATOL = 1e-9
# The example programs (ceres_tpu_torch/examples/), each run once through its
# main at the reference's defaults but where EXAMPLE_CUTS says; inputs are
# written by the writers above at the phases' sizes ({dir}: a temporary
# directory). Held to the JAX package's f64 results (EXAMPLES_REFERENCE, from
# ``tests/test_torch_references.py examples``) with the tolerances of the CPU
# parity tests (tests/test_torch_examples.py imports them from here): the
# records and the final cost within EXAMPLE_COST_RTOL; CGNR's final cost
# within EXAMPLE_CGNR_RTOL (tests/test_torch_pose_graph.py's measure); a line
# search's first EXAMPLE_LINE_SEARCH_RECORDS records and final cost within
# EXAMPLE_LINE_SEARCH_RTOL, its record count not held (the reference's own
# trajectory moves under a one-ulp change); NIST by its LREs
# (EXAMPLE_NIST_LRE_ATOL) and costs, its records not held (ROADMAP Queue 3
# item 14). Costs below EXAMPLE_COST_ATOL are rounding's (residuals of 1e-11
# to 1e-13 at a minimum of zero).
EXAMPLES = [
    ("helloworld", []),
    ("helloworld_analytic_diff", []),
    ("helloworld_numeric_diff", []),
    ("rosenbrock", []),
    ("rosenbrock_analytic_diff", []),
    ("rosenbrock_numeric_diff", []),
    ("powell", []),
    ("curve_fitting", []),
    ("robust_curve_fitting", []),
    ("circle_fit", []),
    ("sampled_function", []),
    ("bicubic_interpolation", []),
    ("bicubic_interpolation_analytic", []),
    ("robot_pose_mle", []),
    ("ellipse_approximation", []),
    ("iteration_callback_example", []),
    ("evaluation_callback_example", []),
    ("more_garbow_hillstrom", []),
    ("libmv_homography", []),
    ("bundle_adjuster", []),
    ("simple_bundle_adjuster", []),
    ("pose_graph_2d", ["--input", "{dir}/m3500.g2o"]),
    ("pose_graph_3d", []),
    ("nist", ["--nist_data_dir", "{dir}", "--num_iterations", "200"]),
    ("libmv_bundle_adjuster", ["--input", "{dir}/shot.bin"]),
    ("denoising", ["--input", "{dir}/noisy.pgm", "--foe_file", "{dir}/model.foe",
                   "--num_iterations", "2"]),
]
EXAMPLE_CUTS = {
    "nist": "--num_iterations 200 (default 10 000): Misra1a from its first start runs to "
            "the limit on the card, where JAX stops after 28 records at the same cost and "
            "LRE (ROADMAP Queue 3 item 14); the nist phase runs the same models",
    "denoising": "--num_iterations 2 (default 100): 2.4-2.8 s an LM iteration on the card "
                 "(PERF.md section 5, PR 10); the denoising_foe phase runs 10 iterations of "
                 "the same model in float64 and float32",
}
EXAMPLE_COST_RTOL = 1e-9
EXAMPLE_CGNR_RTOL = 1e-6
EXAMPLE_LINE_SEARCH_RTOL = 1e-6
EXAMPLE_LINE_SEARCH_RECORDS = 10
EXAMPLE_NIST_LRE_ATOL = 1e-6
EXAMPLE_COST_ATOL = 1e-20
# programs whose solves must launch the port's kernels on the card
EXAMPLE_KERNELS = {
    "bundle_adjuster": ("sorted_segment_sum",),
    "simple_bundle_adjuster": ("sorted_segment_sum",),
    "libmv_bundle_adjuster": ("sorted_segment_sum", "unsorted_segment_sum"),
    "denoising": ("sorted_segment_sum",),
}
EXAMPLES_REFERENCE = {  # tests/test_torch_references.py examples (JAX f64, a CPU)
    "helloworld": [
        [3, 1.3885184769629575e-16, "CONVERGENCE", "records", []]],
    "helloworld_analytic_diff": [
        [3, 5.012552151786674e-16, "CONVERGENCE", "records", []]],
    "helloworld_numeric_diff": [
        [3, 5.012464411841187e-16, "CONVERGENCE", "records", []]],
    "rosenbrock": [
        [39, 1.6857005583872668e-18, "CONVERGENCE", "line_search",
         [24.199999999999992, 4.280493213706965, 4.128693836242194, 4.120150212898577,
         4.115862962201498, 4.081447900264375, 4.018355819059072, 3.8943582627498237,
         3.744944516735803, 3.37353877267042]]],
    "rosenbrock_analytic_diff": [
        [39, 1.6857005583872668e-18, "CONVERGENCE", "line_search",
         [24.199999999999992, 4.280493213706968, 4.128693836242194, 4.120150212898577,
         4.115862962201498, 4.081447900264375, 4.018355819059072, 3.8943582627498206,
         3.7449445167358006, 3.37353877267042]]],
    "rosenbrock_numeric_diff": [
        [39, 1.4603201044666013e-18, "CONVERGENCE", "line_search",
         [24.199999999999992, 4.280493213785431, 4.128693836237959, 4.120150212889778,
         4.115862962190155, 4.081447900268854, 4.018355819378553, 3.8943582626817825,
         3.7449445170655795, 3.373538769647366]]],
    "powell": [
        [15, 1.1200286980751753e-15, "CONVERGENCE", "records", []]],
    "curve_fitting": [
        [14, 1.0567513278335596, "CONVERGENCE", "records", []]],
    "robust_curve_fitting": [
        [13, 0.7160031440700868, "CONVERGENCE", "records", []]],
    "circle_fit": [
        [3, 1570.7317883842575, "CONVERGENCE", "records", []]],
    "sampled_function": [
        [15, 1.041892696315879e-15, "CONVERGENCE", "records", []]],
    "bicubic_interpolation": [
        [5, 0.0014082967151700493, "CONVERGENCE", "records", []]],
    "bicubic_interpolation_analytic": [
        [5, 0.0014082967151700493, "CONVERGENCE", "records", []]],
    "robot_pose_mle": [
        [3, 25.05778668362445, "CONVERGENCE", "records", []]],
    "ellipse_approximation": [
        [26, 0.009768027754775269, "CONVERGENCE", "records", []],
        [1, 0.009768027754775269, "CONVERGENCE", "records", []]],
    "iteration_callback_example": [
        [16, 1.0921546617737612, "USER_SUCCESS", "records", []]],
    "evaluation_callback_example": [
        [14, 0.9417445359300156, "CONVERGENCE", "records", []]],
    "more_garbow_hillstrom": [
        [14, 6.152072488862449e-22, "CONVERGENCE", "records", []],
        [6, 2.7941320569853584e-19, "CONVERGENCE", "records", []],
        [20, 1.0048455076315238e-08, "CONVERGENCE", "records", []],
        [15, 24.492137881966382, "CONVERGENCE", "records", []],
        [3, 5.639663848095504e-09, "CONVERGENCE", "records", []],
        [13, 4.96852588639305e-19, "CONVERGENCE", "records", []],
        [65, 2.470186544558896e-26, "CONVERGENCE", "records", []],
        [36, 8.679148938457943e-19, "CONVERGENCE", "records", []],
        [6, 3.938480418470388, "CONVERGENCE", "records", []]],
    "libmv_homography": [
        [2, 1.5565726295319423e-23, "USER_SUCCESS", "records", []]],
    "bundle_adjuster": [
        [4, 50625.0039850676, "CONVERGENCE", "records", []]],
    "simple_bundle_adjuster": [
        [3, 4991.291512136715, "CONVERGENCE", "records", []]],
    "pose_graph_2d": [
        [13, 2917.532466485134, "CONVERGENCE", "cgnr", []]],
    "pose_graph_3d": [
        [11, 0.012604659229333796, "CONVERGENCE", "cgnr", []]],
    "nist": [
        ["BoxBOD", 0, 0.0, 7859.4047730814655],
        ["BoxBOD", 1, 0.9258268878109133, 493.67467314324796],
        ["Misra1a", 0, 1.7675638597623289, 0.04044879168105487],
        ["Misra1a", 1, 1.767563859762364, 0.04044879168105487],
        ["Thurber", 0, 1.5042457639772786, 1366.5200713967206],
        ["Thurber", 1, 1.5042457639773126, 1366.5200713967206]],
    "libmv_bundle_adjuster": [
        [6, 8666.296543378807, "CONVERGENCE", "records", []]],
    "denoising": [
        [3, 54651.90377200466, "NO_CONVERGENCE", "cgnr", []]],
}
# Timed flagship solves per dtype (each on a fresh problem); the first is
# the run whose K1 launches are counted.
REPEATS = 3
LARGE_REPEATS = 2  # the same for the large case
# Summation-order tolerance of a kernel against its plain version, relative
# to the sum of |contributions| in each segment (a reordered sum of n terms
# moves by at most ~n * eps of that).
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# The card's published peaks: device memory rate and plain (non tensor
# core) float32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SECTOR_BYTES = 32  # what a memory access moves at the least
# Gathered traffic an L2 of 50 MB is taken to still hold when a row is
# wanted again (half of it: lists, output and the other slab share it).
L2_WINDOW_BYTES = 25e6
L2_SCRUB_BYTES = 100 * 2**20  # written between the L2-cold timings' replays
KERNELS = {
    "sorted_segment_sum": (ss, "ceres_tpu/ops/pallas_segment.py:389"),
    "unsorted_segment_sum": (us, "ceres_tpu/ops/pallas_segment.py:224"),
    "outer_segment_sum": (osum, "ceres_tpu/ops/pallas_segment.py:504"),
}


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def check_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the port compares in full f32")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmul precision is not 'highest'")
    phase(
        "device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        numpy=np.__version__,
        allow_tf32=False, float32_matmul_precision="highest",
    )
    return smi


def build_kernels() -> None:
    """The three kernels and the captured loop's conditional-node binding
    (``csrc/graph_conditional.cu``), one nvcc each, all at the same time."""
    t0 = time.perf_counter()
    cuda_build.build_in_parallel(
        [mod.build_kernel for mod, _ in KERNELS.values()] + [cuda_graph.build_library])
    for name in (*KERNELS, "graph_conditional"):
        phase(
            "build", kernel=name, seconds=time.perf_counter() - t0,
            nvcc_seconds=cuda_build.build_seconds[name],
        )


def flagship_instance():
    return bal.synthesize_bal(
        num_cameras=NUM_CAMERAS, num_points=NUM_POINTS,
        num_observations=NUM_OBS, noise=NOISE, perturb=PERTURB, seed=SEED,
    )


def large_instance():
    return bal.synthesize_bal(noise=NOISE, perturb=PERTURB, **LARGE)


def sequential_instance(num_cameras=SEQUENTIAL["num_cameras"],
                        num_points=SEQUENTIAL["num_points"], fifth=SEQUENTIAL["fifth"],
                        seed=SEQUENTIAL["seed"]) -> bal.BALProblem:
    """A bundle adjustment with the visibility of BAL's problem-1723-156502
    (Ladybug, a sequential video): point p is seen by the 4 consecutive
    cameras from c0 = p (C - 5) // P, the first ``fifth`` points by a fifth,
    so S is banded (tests/test_sparse_schur.py:142-175's pattern). Camera
    intrinsics (focal 1, the rest 0.02 N(0, 1)), the points' perturbation
    (0.02) and the pixel noise (0.005) are drawn as that test draws them.
    The geometry is not the test's: there every camera sits within 0.02 of
    one pose, so at this size a point's depth is barely observable (JAX f64
    crawls for 50 iterations without converging, and the port's CPU records
    part from JAX's after 11), and a straight path long enough to give the
    4 views a baseline puts world coordinates of several hundred units
    beside a pixel noise of 0.005, which float32 cannot resolve (2e-4 to
    2e-3 from float64, in both packages, measured on the CPU). So the cameras
    stand on a ring of radius 12 facing the cloud, as bal.synthesize_bal
    places them, in golden-angle order: consecutive cameras, which share
    points, are far apart on the ring. The points are a normal cloud of
    scale 2 at the ring's center. Plain numpy, so that the JAX reference
    (tests/test_torch_references.py sparse_sequential) gets the same float64
    arrays."""
    rng = np.random.default_rng(seed)
    cams = 0.02 * rng.standard_normal((num_cameras, 9))
    cams[:, 6] = 1.0  # focal
    pts = 2.0 * rng.standard_normal((num_points, 3))
    for c in range(num_cameras):  # the pose of synthesize_bal's ring cameras
        angle = c * np.pi * (3.0 - np.sqrt(5.0))
        pos = np.array([12.0 * np.cos(angle), 12.0 * np.sin(angle), 6.0])
        z = pos / np.linalg.norm(pos)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        cams[c, :3] = bal._rotation_matrix_to_angle_axis_np(R)
        cams[c, 3:6] += -R @ pos
    p = np.arange(num_points, dtype=np.int64)
    views = np.where(p < fifth, 5, 4)
    obs_pt = np.repeat(p, views)
    obs_cam = (np.repeat(p * (num_cameras - 5) // num_points, views)
               + np.arange(obs_pt.shape[0]) - np.repeat(np.cumsum(views) - views, views))
    uv = bal._project_np(cams[obs_cam], pts[obs_pt])
    return bal.BALProblem(
        cameras=cams, points=pts + 0.02 * rng.standard_normal(pts.shape),
        camera_index=obs_cam, point_index=obs_pt,
        observations=uv + 0.005 * rng.standard_normal(uv.shape),
    )


# ---- slice 10's inputs: plain numpy, written to files in the formats the
# models parse, so that the JAX reference (tests/test_torch_references.py)
# loads the same bytes.

# Three NIST StRD models of different difficulty: (x, the two starts, the
# parameters written as certified, the noise of y). x, the starts and the
# certified values are NIST's (Misra1a and BoxBOD exactly, Thurber's x
# spread evenly over its range); y is the model at the certified values
# plus noise of about NIST's residual spread, rounded to 5 decimals.
NIST_MODELS = {
    "Misra1a": (np.array([77.6, 114.9, 141.1, 190.8, 239.9, 289.0, 332.8, 378.4, 434.8,
                          477.3, 536.8, 593.1, 689.1, 760.0]),
                [[500.0, 1e-4], [250.0, 5e-4]], [2.3894212918e02, 5.5015643181e-04], 0.1),
    "Thurber": (np.linspace(-3.067, 2.2, 37),
                [[1000.0, 1000.0, 400.0, 40.0, 0.7, 0.3, 0.03],
                 [1300.0, 1500.0, 500.0, 75.0, 1.0, 0.4, 0.05]],
                [1.2881396800e03, 1.4910792535e03, 5.8323836877e02, 7.5416644291e01,
                 9.6629502864e-01, 3.9797285797e-01, 4.9727297349e-02], 13.0),
    "BoxBOD": (np.array([1.0, 2.0, 3.0, 5.0, 7.0, 10.0]),
               [[1.0, 1.0], [100.0, 0.75]], [2.1380940889e02, 5.4723748542e-01], 17.0),
}


def write_nist_files(directory, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    for name, (x, starts, certified, sigma) in NIST_MODELS.items():
        clean = nist.MODELS[name](torch.tensor(certified), torch.from_numpy(x)).numpy()
        y = np.round(clean + sigma * rng.standard_normal(x.shape[0]), 5)
        nist.write_nist_file(f"{directory}/{name}.dat", name, np.asarray(starts),
                             np.asarray(certified), x, y)


LIBMV = dict(frames=300, tracks=2000, window=50, seed=5)


def _rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    cy, sy, cp, sp, cr, sr = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    Ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    Rz = np.array([[cr, -sr, 0.0], [sr, cr, 0.0], [0.0, 0.0, 1.0]])
    return Rz @ Rx @ Ry


def _opencv_project(intr, R, t, X):
    x = X @ R.T + t
    xn, yn = x[:, 0] / x[:, 2], x[:, 1] / x[:, 2]
    f, cx, cy, k1, k2, k3, p1, p2 = intr
    r2 = xn * xn + yn * yn
    rc = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * rc + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * rc + 2.0 * p2 * xn * yn + p1 * (r2 + 2.0 * yn * yn)
    return np.stack([f * xd + cx, f * yd + cy], axis=1)


def write_libmv_shot(path, frames=LIBMV["frames"], tracks=LIBMV["tracks"],
                     window=LIBMV["window"], seed=LIBMV["seed"]) -> int:
    """A libmv problem the size of a Blender camera-solve shot: a 1920 x
    1080 camera with OpenCV radial and tangential terms dollies 8 units
    past a field of points 8 to 20 units deep, panning; each track is seen
    in ``window`` consecutive frames, so tracks x window markers, in frame
    order (the point ids of the markers are not sorted). The file
    holds the start: every pose and point perturbed, the markers the true
    projections plus 0.3 px of noise. Returns the number of markers."""
    rng = np.random.default_rng(seed)
    intr = np.array([1500.0, 960.0, 540.0, -0.08, 0.02, -0.005, 0.0005, -0.0003])
    s = np.linspace(0.0, 1.0, frames)
    centers = np.stack([8.0 * s - 4.0, 0.3 * np.sin(6.0 * s), 0.2 * s], axis=1)
    Rs = [_rotation(0.15 * np.sin(3.0 * a), 0.05 * np.cos(2.0 * a), 0.02 * np.sin(5.0 * a))
          for a in s]
    ts = [-R @ c for R, c in zip(Rs, centers)]
    X = np.stack([rng.uniform(-8.0, 8.0, tracks), rng.uniform(-3.0, 3.0, tracks),
                  rng.uniform(8.0, 20.0, tracks)], axis=1)
    first = rng.integers(0, frames - window + 1, tracks)
    m_img, m_trk, m_xy = [], [], []
    for f in range(frames):
        seen = np.nonzero((first <= f) & (f < first + window))[0]
        m_img.append(np.full(seen.shape[0], f))
        m_trk.append(seen)
        m_xy.append(_opencv_project(intr, Rs[f], ts[f], X[seen]))
    m_xy = np.concatenate(m_xy)
    m_xy = m_xy + 0.3 * rng.standard_normal(m_xy.shape)
    R0 = [_rotation(*(0.002 * rng.standard_normal(3))) @ R for R in Rs]
    t0 = [t + 0.02 * rng.standard_normal(3) for t in ts]
    libmv.write_libmv_file(
        path, intr, np.arange(frames), R0, t0, np.arange(tracks),
        X + 0.05 * rng.standard_normal(X.shape), np.concatenate(m_img),
        np.concatenate(m_trk), m_xy,
    )
    return m_xy.shape[0]


def libmv_problem(model, shot, variant):
    """The libmv problem of a loaded shot through ``model`` (either
    package's models.libmv): the intrinsics fixed (False), refined (True),
    or refined with BA's 7-dof gauge fixed ("gauge_fixed": camera 0 and the
    last point constant, as the covariance phase fixes it)."""
    problem, _, cams, pts = model.build_problem(shot, refine_intrinsics=variant is not False)
    if variant == "gauge_fixed":
        problem.set_parameter_block_constant(int(cams[0]))
        problem.set_parameter_block_constant(int(pts[-1]))
    return problem


DENOISING = dict(height=321, width=481, experts=24, size=5, sigma=20.0, seed=3)


def write_denoising_inputs(directory, height=DENOISING["height"], width=DENOISING["width"],
                           experts=DENOISING["experts"], size=DENOISING["size"],
                           sigma=DENOISING["sigma"], seed=DENOISING["seed"]):
    """A smooth synthetic image (height x width, the size of a BSDS500
    image) with Gaussian noise of ``sigma``, written as ``noisy.pgm``, and a
    Fields of Experts of ``experts`` zero-mean size x size filters of norm
    0.1 and weights in [0.5, 2], written as ``model.foe``. Returns the two
    paths."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    clean = (128.0 + 60.0 * np.sin(2.0 * np.pi * xx / width * 1.5) * np.cos(2.0 * np.pi * yy / height)
             + 40.0 * np.tanh((xx - 0.6 * width) / 20.0) * (yy > 0.4 * height))
    noisy = clean + sigma * rng.standard_normal(clean.shape)
    filters = rng.standard_normal((experts, size * size))
    filters -= filters.mean(axis=1, keepdims=True)
    filters *= 0.1 / np.linalg.norm(filters, axis=1, keepdims=True)
    foe = denoising.FieldsOfExperts(size=size, alphas=rng.uniform(0.5, 2.0, experts),
                                    filters=filters)
    paths = f"{directory}/noisy.pgm", f"{directory}/model.foe"
    denoising.write_pgm(paths[0], noisy)
    denoising.write_foe_file(paths[1], foe)
    return paths


# A 2-D pose graph the size of the Manhattan M3500 dataset (Olson, Leonard
# and Teller 2006): 3 500 poses and 5 453 edges, odometry plus loop closures.
M3500 = dict(poses=3500, edges=5453, seed=6)
G2O_2D_INFORMATION = (400.0, 400.0, 10000.0)  # x, y (1 / m^2), yaw (1 / rad^2)


def write_g2o_2d(path, poses=M3500["poses"], edges=M3500["edges"], seed=M3500["seed"]):
    """A Manhattan-world SE2 pose graph written as g2o VERTEX_SE2 / EDGE_SE2
    lines (what ``pose_graph.read_g2o_2d`` parses): a robot steps 1 m at a
    time on a grid about sqrt(poses) / 3 m wide (20 m at M3500's size),
    turning by +-90 degrees at random and at the walls; ``poses - 1``
    odometry edges join consecutive poses, and the other ``edges - poses +
    1`` edges close loops between poses at the same grid point. Each edge
    is the true relative pose plus Gaussian noise of the information
    G2O_2D_INFORMATION (0.05 m, 0.01 rad); the vertices hold the
    dead-reckoned start (the noisy odometry composed), as M3500's file does.
    Returns the number of loop closures."""
    rng = np.random.default_rng(seed)
    half = max(2, int(round(np.sqrt(poses) / 6.0)))
    truth = np.zeros((poses, 3))
    for i in range(1, poses):
        x, y, yaw = truth[i - 1]
        if rng.random() < 0.2:
            yaw += rng.choice([-0.5, 0.5]) * np.pi
        for _ in range(4):  # turn away from a wall
            nx, ny = np.rint([x + np.cos(yaw), y + np.sin(yaw)])
            if max(abs(nx), abs(ny)) <= half:
                break
            yaw += 0.5 * np.pi
        truth[i] = nx, ny, np.arctan2(np.sin(yaw), np.cos(yaw))
    cells = {}
    for i, (x, y, _) in enumerate(truth):
        cells.setdefault((int(x), int(y)), []).append(i)
    pairs = np.array([(a, b) for ids in cells.values() for k, b in enumerate(ids)
                      for a in ids[:k] if b - a > 1])
    loops = pairs[np.sort(rng.choice(len(pairs), edges - poses + 1, replace=False))]
    ab = np.concatenate([np.stack([np.arange(poses - 1), np.arange(1, poses)], axis=1), loops])

    def relative(a, b):
        c, s = np.cos(truth[a, 2]), np.sin(truth[a, 2])
        d = truth[b, :2] - truth[a, :2]
        dyaw = truth[b, 2] - truth[a, 2]
        return np.stack([c * d[:, 0] + s * d[:, 1], c * d[:, 1] - s * d[:, 0],
                         np.arctan2(np.sin(dyaw), np.cos(dyaw))], axis=1)

    sigmas = 1.0 / np.sqrt(G2O_2D_INFORMATION)
    meas = relative(ab[:, 0], ab[:, 1]) + sigmas * rng.standard_normal((len(ab), 3))
    start = np.zeros((poses, 3))
    for i in range(1, poses):  # dead reckoning along the odometry edges
        x, y, yaw = start[i - 1]
        dx, dy, dyaw = meas[i - 1]
        c, s = np.cos(yaw), np.sin(yaw)
        start[i] = (x + c * dx - s * dy, y + s * dx + c * dy,
                    np.arctan2(np.sin(yaw + dyaw), np.cos(yaw + dyaw)))
    info = " ".join(repr(v) for v in (G2O_2D_INFORMATION[0], 0.0, 0.0, G2O_2D_INFORMATION[1],
                                      0.0, G2O_2D_INFORMATION[2]))
    with open(path, "w") as out:
        for i, (x, y, yaw) in enumerate(start):
            out.write(f"VERTEX_SE2 {i} {float(x)!r} {float(y)!r} {float(yaw)!r}\n")
        for (a, b), m in zip(ab, meas):
            out.write(f"EDGE_SE2 {a} {b} {float(m[0])!r} {float(m[1])!r} {float(m[2])!r} {info}\n")
    return len(loops)


TINY = dict(problems=65_536, seed=9)
TINY_SAMPLES = np.linspace(0.0, 1.0, 20)


def tiny_batch(problems=TINY["problems"], seed=TINY["seed"]):
    """Starts (problems, 4) and samples of one batched tiny_solve: the first
    half 2-D Rosenbrock from (-1.2, 1) + N(0, 0.5), the second half the
    exponential fit a exp(b t) + c to 20 exact samples of (2, -1.3, 0.5),
    from (2, -1.3, 0.5) + N(0, 0.3). Both have a zero residual at the
    solution, so each lane stops on the cost threshold, not on a test that
    rounding decides. The last coordinate picks the problem (+1 Rosenbrock,
    -1 the fit); no residual depends on it, nor on the third coordinate in
    a Rosenbrock lane, so their steps are 0. Returns (x0, the fit's y)."""
    rng = np.random.default_rng(seed)
    half = problems // 2
    x0 = np.zeros((problems, 4))
    x0[:half, :2] = np.array([-1.2, 1.0]) + 0.5 * rng.standard_normal((half, 2))
    x0[:half, 3] = 1.0
    x0[half:, :3] = np.array([2.0, -1.3, 0.5]) + 0.3 * rng.standard_normal((problems - half, 3))
    x0[half:, 3] = -1.0
    y = 2.0 * np.exp(-1.3 * TINY_SAMPLES) + 0.5
    return x0, y


def tiny_residual(y, device="cpu"):
    """The torch residual of tiny_batch's lanes (20 values), its samples on
    ``device`` (a CUDA graph captures no copy from the host)."""
    t = torch.from_numpy(TINY_SAMPLES).to(device)
    yt = torch.from_numpy(y).to(device)

    def fn(x):
        tt, yy = t.to(x.dtype), yt.to(x.dtype)
        rosen = torch.cat([10.0 * (x[1:2] - x[0:1] * x[0:1]), 1.0 - x[0:1], torch.zeros_like(yy[2:])])
        fit = x[0:1] * torch.exp(x[1:2] * tt) + x[2:3] - yy
        return torch.where(x[3:4] > 0, rosen, fit)

    return fn


CURVE = dict(points=67, seed=4)


def curve_data(points=CURVE["points"], seed=CURVE["seed"]):
    """(x, y) of the C API's curve fit y = exp(m x + c): m = 0.3, c = 0.1,
    noise 0.2, rounded to 5 decimals."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 5.0, points)
    return x, np.round(np.exp(0.3 * x + 0.1) + 0.2 * rng.standard_normal(points), 5)


def curve_cost(data, params, residuals, jacobians):
    """A ``ceres_cost_function_t`` in numpy: r = y - exp(m x + c)."""
    x, y = data
    e = np.exp(params[0][0] * x + params[1][0])
    residuals[0] = y - e
    if jacobians is not None:
        if jacobians[0] is not None:
            jacobians[0][0, 0] = -x * e
        if jacobians[1] is not None:
            jacobians[1][0, 0] = -e
    return 1


def curve_fit_c_api(capi, points=CURVE["points"], **solve_kw):
    """The curve fit through a C API module (the JAX package's or the
    port's): one residual block per point with a Cauchy(0.5) stock loss,
    ``ceres_solve`` with its progress and report captured. Returns (m, c,
    summary, the captured text)."""
    xs, ys = curve_data(points)
    m, c = np.zeros(1), np.zeros(1)
    problem = capi.ceres_create_problem()
    loss = capi.ceres_create_cauchy_loss_function_data(0.5)
    for x, y in zip(xs, ys):
        capi.ceres_problem_add_residual_block(
            problem, curve_cost, (float(x), float(y)), capi.ceres_stock_loss_function, loss,
            1, 2, [1, 1], [m, c])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        summary = capi.ceres_solve(problem, **solve_kw)
    capi.ceres_free_problem(problem)
    return m, c, summary, text.getvalue()


INTERPOLATION = dict(grid=512, samples=65_536, seed=5, shift=(1.3, -0.7))


def interpolation_instance(grid=INTERPOLATION["grid"], samples=INTERPOLATION["samples"],
                           seed=INTERPOLATION["seed"]):
    """examples/bicubic_interpolation.py's problem on a grid x grid grid
    of f(r, c) = r^2 - c r + c^2 (rows and columns from -2) with
    ``samples`` noisy samples of f at points shifted by INTERPOLATION's
    shift: (grid values, sample points, sample values)."""
    rows, cols = np.meshgrid(np.arange(-2.0, grid - 2.0), np.arange(-2.0, grid - 2.0),
                             indexing="ij")
    rng = np.random.default_rng(seed)
    shift = np.asarray(INTERPOLATION["shift"])
    pts = rng.uniform(1.0, grid - 12.0, (samples, 2))
    r, c = pts[:, 0] + shift[0], pts[:, 1] + shift[1]
    values = r * r - c * r + c * c + 0.01 * rng.standard_normal(samples)
    return rows * rows - cols * rows + cols * cols, pts, values


def _time_ms(fn, reps: int = 200) -> float:
    for _ in range(max(2, reps // 20)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device time of one call with the host's enqueue cost left out:
    ``launches`` calls are captured into one CUDA graph and the graph is
    replayed. Where this is far below ``_time_ms``, the wrapper's host work
    and not the kernel sets the time a caller sees."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def _cold_device_ms(fn, replays: int = 30) -> float:
    """Device time of one call that finds L2 cold: ``fn`` captured alone
    into a CUDA graph, each replay between two events of its own, each
    after a write of L2_SCRUB_BYTES outside the events (twice the card's
    L2, so nothing the last replay left there stays). The median over
    ``replays``; the write also keeps the host's enqueue ahead of the
    card, so the events hold the graph's own work."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    scrub = torch.empty((L2_SCRUB_BYTES // 4,), dtype=torch.float32, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(replays)]
    graph.replay()
    for i, (start, end) in enumerate(events):
        scrub.fill_(float(i))
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def _bound(num_bytes: float, flops: float):
    """(least ms the card could take, what sets it)."""
    by_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _within(out, ref, scale, dtype, label) -> float:
    """Hold a kernel's output to its plain version's; returns max |error|."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"kernel {label}: bad shape or non-finite output")
    err = (out - ref).abs()
    if (err > KERNEL_RTOL[dtype] * scale).any():
        raise RuntimeError(
            f"kernel {label}: max error {err.max().item():.3e} above "
            f"rtol {KERNEL_RTOL[dtype]:g} x sum|contrib|"
        )
    return err.max().item() if err.numel() else 0.0


def _record(name: str, max_err: float, **times) -> dict:
    mod, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda",
        "source": f"ceres_tpu_torch/csrc/{mod._SOURCE}",
        "replaces": replaces, "max_abs_err": max_err, **times,
    }


def write_example_inputs(directory) -> None:
    """The inputs of EXAMPLES' programs at the phases' sizes."""
    write_g2o_2d(f"{directory}/m3500.g2o")
    write_nist_files(directory)
    write_libmv_shot(f"{directory}/shot.bin")
    write_denoising_inputs(directory)


def example_argv(argv, directory) -> list:
    return [a.replace("{dir}", str(directory)) for a in argv]


@contextlib.contextmanager
def recording_solves(package, nist_module):
    """Record what a program's solves return: every summary of
    ``package.solve`` and ``package.solve_gradient_problem`` (the names the
    programs call) with whether it came from a line search, and every result
    list of ``nist_module.run_suite``. The functions are put back on exit."""
    summaries, suites = [], []
    saved = [(package, n, getattr(package, n)) for n in ("solve", "solve_gradient_problem")]
    saved.append((nist_module, "run_suite", nist_module.run_suite))

    def keeping(name, fn):
        def kept(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name == "run_suite":
                suites.append(out)
            else:
                gradient = name == "solve_gradient_problem"
                summaries.append((out, gradient or out.minimizer_type.name == "LINE_SEARCH"))
            return out

        return kept

    for owner, name, fn in saved:
        setattr(owner, name, keeping(name, fn))
    try:
        yield summaries, suites
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def example_result(summaries, suites) -> list:
    """What the examples phase holds a program to: per solve, [records,
    final cost, termination, how it is held ("line_search", "cgnr" or
    "records"), the costs of a line search's first
    EXAMPLE_LINE_SEARCH_RECORDS records]; for NIST, per problem and start,
    [name, start, LRE, final cost]."""
    if suites:
        return [[r["name"], r["start"], r["lre"], r["final_cost"]] for rs in suites for r in rs]
    out = []
    for s, line_search in summaries:
        cgnr = getattr(s.linear_solver_type_used, "name", "") == "CGNR"
        kind = "line_search" if line_search else "cgnr" if cgnr else "records"
        costs = [r.cost for r in s.iterations[:EXAMPLE_LINE_SEARCH_RECORDS]] if line_search else []
        out.append([len(s.iterations), s.final_cost, s.termination_type.name, kind, costs])
    return out


def _cost_err(a: float, b: float, rtol: float) -> tuple:
    """(relative difference, whether it is within rtol or EXAMPLE_COST_ATOL)."""
    return abs(a - b) / max(abs(b), 1e-300), abs(a - b) <= rtol * abs(b) + EXAMPLE_COST_ATOL


def held_to_example(name: str, got, ref) -> float:
    """The checks of EXAMPLES' comment, of a program's example_result
    against the reference's; returns the largest relative difference of the
    costs compared, raises where a check fails."""
    if len(got) != len(ref):
        raise RuntimeError(f"example {name}: {len(got)} solves against {len(ref)}")
    worst = 0.0
    for g, r in zip(got, ref):
        if name == "nist":
            rel, ok = _cost_err(g[3], r[3], EXAMPLE_COST_RTOL)
            ok = ok and g[:2] == r[:2] and abs(g[2] - r[2]) <= EXAMPLE_NIST_LRE_ATOL
            worst = max(worst, rel)
        else:
            rtol = dict(line_search=EXAMPLE_LINE_SEARCH_RTOL, cgnr=EXAMPLE_CGNR_RTOL,
                        records=EXAMPLE_COST_RTOL)[r[3]]
            checks = [_cost_err(a, b, rtol) for a, b in zip([g[1], *g[4]], [r[1], *r[4]])]
            worst = max([worst] + [c[0] for c in checks])
            ok = (all(c[1] for c in checks) and g[2:4] == r[2:4]
                  and len(g[4]) == len(r[4]) and (r[3] == "line_search" or g[0] == r[0]))
        if not ok:
            raise RuntimeError(f"example {name}: {g} against {r}")
    return worst


# ---- K1 ---------------------------------------------------------------------


def _compare_sorted(row_ptr, G, contrib, label) -> float:
    out = ss.segment_sum_sorted(contrib, row_ptr, G)
    ref = ss.segment_sum_sorted_plain(contrib, row_ptr, G)
    scale = ss.segment_sum_sorted_plain(contrib.abs(), row_ptr, G)
    return _within(out, ref, scale, contrib.dtype, label)


def _time_sorted(row_ptr, G, c, reps) -> dict:
    """K1's times at one shape: as called, the plain version, index_add_,
    the bound, and kernel and index_add_ from a CUDA graph."""
    B, d = c.shape
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    seg = torch.repeat_interleave(torch.arange(G + 1, device=c.device), counts)

    def library():
        torch.zeros((G + 1, d), dtype=c.dtype, device=c.device).index_add_(0, seg, c)

    e = c.element_size()
    bound_ms, bound_by = _bound(B * d * e + (G + 2) * 4 + (G + 1) * d * e, B * d)
    return dict(
        ms=_time_ms(lambda: ss.segment_sum_sorted(c, row_ptr, G), reps),
        plain_ms=_time_ms(lambda: ss.segment_sum_sorted_plain(c, row_ptr, G), reps),
        library_ms=_time_ms(library, reps), bound_ms=bound_ms, bound_by=bound_by,
        device_ms=_device_ms(lambda: ss.segment_sum_sorted(c, row_ptr, G)),
        cold_device_ms=_cold_device_ms(lambda: ss.segment_sum_sorted(c, row_ptr, G)),
        library_device_ms=_device_ms(library),
    )


def check_sorted(device, flagship_plan, large_plan) -> dict:
    """K1 vs plain at the point-side plans of both cases and at edge cases."""
    rng = np.random.default_rng(0)
    max_err, checks, record, shapes = 0.0, 0, None, []
    for case, plan, reps in (("flagship", flagship_plan, 200), ("large", large_plan, 50)):
        if plan.kind != "sorted":
            raise RuntimeError(f"{case} point plan is {plan.kind!r}, not 'sorted'")
        G = plan.num_groups
        B = int(plan.row_ptr[-1])
        for dtype in (torch.float32, torch.float64):
            for d in (3, 9):
                c = torch.tensor(rng.standard_normal((B, d)), dtype=dtype, device=device)
                err = _compare_sorted(plan.row_ptr, G, c, f"K1 {case} d={d} {dtype}")
                max_err, checks = max(max_err, err), checks + 1
                if dtype == torch.float32:
                    times = _time_sorted(plan.row_ptr, G, c, reps)
                    phase("kernel_time", kernel="sorted_segment_sum", case=case, B=B, G=G,
                          d=d, dtype="float32", **times)
                    shapes.append(dict(case=case, d=d, **times))
                    if case == "large" and d == 9:
                        record = times
    edge = {
        "B not a tile multiple, d=1": (np.sort(rng.integers(0, 5000, 83717)), 5000, 1),
        "empty segments, d=24": (np.sort(rng.integers(0, 40000, 7001)), 40000, 24),
        "segment of 6000 rows, d=81": (
            np.concatenate([np.full(6000, 7), np.sort(rng.integers(8, 900, 3000))]), 900, 81,
        ),
        "ids >= G to the dummy row, d=9": (np.sort(rng.integers(0, 1300, 20000)), 1000, 9),
        "G+1 = 289, d=3": (np.sort(rng.integers(0, 288, 9000)), 288, 3),
        # short segments, long ones, and a mix
        "short segments (4 rows each), d=3": (np.repeat(np.arange(30000), 4), 30000, 3),
        "long segments (3 of 7000 rows), d=9": (np.repeat(np.arange(3), 7000), 600, 9),
        "short segments and five of 800 rows, d=5": (
            np.sort(np.concatenate([np.repeat(np.arange(5), 800), rng.integers(5, 9000, 30000)])),
            9000, 5,
        ),
    }
    for label, (seg, g, d) in edge.items():
        row_ptr = torch.from_numpy(ss.build_row_ptr(seg, g)).to(device)
        for dtype in (torch.float32, torch.float64):
            c = torch.tensor(rng.standard_normal((seg.size, d)), dtype=dtype, device=device)
            err = _compare_sorted(row_ptr, g, c, f"K1 {label} {dtype}")
            max_err, checks = max(max_err, err), checks + 1
    phase("kernel", kernel="sorted_segment_sum", checks=checks, max_abs_err=max_err)
    return _record("sorted_segment_sum", max_err, timed_shapes=shapes, **record)


# ---- K3 ---------------------------------------------------------------------


def _compare_unsorted(plan, contrib, label) -> float:
    """K3 against its plain version, and against itself: the design promises
    the same bits on every launch."""
    out = us.segment_sum_unsorted(contrib, plan)
    ref = us.segment_sum_unsorted_plain(contrib, plan)
    scale = us.segment_sum_unsorted_plain(contrib.abs(), plan)
    err = _within(out, ref, scale, contrib.dtype, label)
    if not torch.equal(out, us.segment_sum_unsorted(contrib, plan)):
        raise RuntimeError(f"kernel {label}: two launches gave different bits")
    return err


def check_unsorted(device, camera_plan) -> dict:
    """K3 vs plain at the large case's camera-side plan (d = 81: F'F and
    self-pair cells; d = 9: gradient, column norms, rmatvec) and at edge
    cases."""
    if camera_plan.kind != "unsorted":
        raise RuntimeError(f"large camera plan is {camera_plan.kind!r}, not 'unsorted'")
    rng = np.random.default_rng(1)
    plan, G = camera_plan.unsorted, camera_plan.num_groups
    B = plan.num_rows
    seg64 = plan.segment_ids()
    max_err, checks, record = 0.0, 0, None
    for dtype in (torch.float32, torch.float64):
        for d in (81, 9):
            c = torch.tensor(rng.standard_normal((B, d)), dtype=dtype, device=device)
            err = _compare_unsorted(plan, c, f"K3 large d={d} {dtype}")
            max_err, checks = max(max_err, err), checks + 1

            def library():
                torch.zeros((G + 1, d), dtype=dtype, device=device).index_add_(0, seg64, c)

            e = c.element_size()
            bound_ms, by = _bound(B * d * e + B * 4 + (G + 1) * d * e, B * d)
            times = dict(
                ms=_time_ms(lambda: us.segment_sum_unsorted(c, plan), 30),
                plain_ms=_time_ms(lambda: us.segment_sum_unsorted_plain(c, plan), 30),
                library_ms=_time_ms(library, 30), bound_ms=bound_ms, bound_by=by,
                device_ms=_device_ms(lambda: us.segment_sum_unsorted(c, plan)),
                cold_device_ms=_cold_device_ms(lambda: us.segment_sum_unsorted(c, plan)),
                library_device_ms=_device_ms(library),
            )
            # The two kernels of the pair on their own, from a CUDA graph.
            partial = torch.empty((plan.num_pieces, d), dtype=dtype, device=device)
            out = torch.empty((G + 1, d), dtype=dtype, device=device)
            parts = dict(
                gather_device_ms=_device_ms(lambda: us._launch(c, plan, partial, out, 1)),
                sum_pieces_device_ms=_device_ms(lambda: us._launch(c, plan, partial, out, 2)),
                pieces=plan.num_pieces, scratch_bytes=partial.numel() * e,
            )
            phase("kernel_time", kernel="unsorted_segment_sum", case="large", B=B, G=G,
                  d=d, dtype=str(dtype).split(".")[1], **times, **parts)
            if dtype == torch.float32 and d == 81:
                record = times
            del c, partial, out
    # (ids, G, d); d = 9 and 81 take the compile-time form, the others the
    # run-time form (d = 40 and 100: more than one column group).
    edge = {
        "all rows in one group, d=9": (np.full(50000, 3), 464, 9),
        "ids >= G and < 0 to the dummy row, d=9": (rng.integers(-5, 700, 30000), 600, 9),
        "G+1 = 289, d=81": (rng.integers(0, 288, 20000), 288, 81),
        "G+1 = 4096, d=81": (rng.integers(0, 4095, 100000), 4095, 81),
        "65 535 groups, most of them empty, d=3": (rng.integers(0, 65535, 60000), 65535, 3),
        "B = 100003, d=1": (rng.integers(0, 464, 100003), 464, 1),
        "B = 7, d=40": (rng.integers(0, 464, 7), 464, 40),
        "B = 70001, d=100": (rng.integers(0, 464, 70001), 464, 100),
    }
    for label, (seg, g, d) in edge.items():
        plan_e = us.build_unsorted_plan(seg, g, device)
        for dtype in (torch.float32, torch.float64):
            c = torch.tensor(rng.standard_normal((seg.size, d)), dtype=dtype, device=device)
            max_err = max(max_err, _compare_unsorted(plan_e, c, f"K3 {label} {dtype}"))
            checks += 1
    phase("kernel", kernel="unsorted_segment_sum", checks=checks, max_abs_err=max_err)
    return _record("unsorted_segment_sum", max_err, **record)


# ---- K4 ---------------------------------------------------------------------


def _compare_outer(W, Y, a, b, row_ptr, G, K, T1, T2, label) -> float:
    out = osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2)
    ref = osum.outer_segment_sum_plain(W, Y, a, b, row_ptr, G, K, T1, T2)
    scale = osum.outer_segment_sum_plain(W.abs(), Y.abs(), a, b, row_ptr, G, K, T1, T2)
    return _within(out, ref, scale, W.dtype, label)


def _gathered_floor_bytes(a, b, row_bytes: int):
    """(bytes of the sectors K4's row gathers touch, the same less the rows
    an L2 window still holds). A pair gathers row ``a[p]`` of one slab and
    ``b[p]`` of the other, in the order of the list; a row wanted again
    within L2_WINDOW_BYTES of gathered traffic counts as served by L2."""
    pairs = a.shape[0]
    position = torch.arange(pairs, device=a.device)

    def sectors(rows):
        first = rows * row_bytes
        return (first + row_bytes - 1) // SECTOR_BYTES - first // SECTOR_BYTES + 1

    touched = [sectors(idx.long()) for idx in (a, b)]
    total = sum(int(t.sum()) for t in touched) * SECTOR_BYTES
    window_pairs = L2_WINDOW_BYTES / (total / max(pairs, 1))
    missed = 0
    for idx, sec in zip((a, b), touched):
        order = torch.argsort(idx.long() * pairs + position)  # by row, then position
        rows, pos = idx[order], position[order]
        again = (rows[1:] == rows[:-1]) & ((pos[1:] - pos[:-1]) <= window_pairs)
        miss = torch.ones(pairs, dtype=torch.bool, device=a.device)
        miss[1:] = ~again
        missed += int(sec[order][miss].sum())
    return total, missed * SECTOR_BYTES


def check_outer(device, group, num_slots: int) -> dict:
    """K4 vs plain at the large case's strict-lower pair group (the plan's
    own pair lists and row pointer, random slabs) and at edge cases."""
    if group.self_pairs or group.plan.kind != "sorted":
        raise RuntimeError("the large case's strict-lower pair group is not 'sorted'")
    rng = np.random.default_rng(2)
    K, T1, T2, G = 3, group.T1, group.T2, group.num_cells
    a, b, row_ptr = group.a_idx, group.b_idx, group.plan.row_ptr
    if a.dtype != torch.int32 or (K, T1, T2) not in osum.TILED_SHAPES:
        raise RuntimeError("the large case's pair group is not int32 lists at K=3, 9 x 9")
    Pp = a.shape[0]
    max_err, checks, record = 0.0, 0, None
    forms = {"compile_time": 0, "run_time": 0}
    for dtype in (torch.float32, torch.float64):
        W = torch.tensor(rng.standard_normal((num_slots + 1, K * T1)), dtype=dtype, device=device)
        Y = torch.tensor(rng.standard_normal((num_slots + 1, K * T2)), dtype=dtype, device=device)
        W[num_slots] = 0.0
        Y[num_slots] = 0.0
        err = _compare_outer(W, Y, a, b, row_ptr, G, K, T1, T2, f"K4 large {dtype}")
        max_err, checks = max(max_err, err), checks + 1
        forms["compile_time"] += 1
        e = W.element_size()
        other_bytes = 2 * Pp * 4 + (G + 2) * 4 + (G + 1) * T1 * T2 * e
        bound_ms, by = _bound(
            (W.numel() + Y.numel()) * e + other_bytes, 2.0 * Pp * K * T1 * T2,
        )
        gathered, missed = _gathered_floor_bytes(a, b, K * T1 * e)
        times = dict(
            ms=_time_ms(lambda: osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2), 20),
            plain_ms=_time_ms(
                lambda: osum.outer_segment_sum_plain(W, Y, a, b, row_ptr, G, K, T1, T2), 10
            ),
            library_ms=None, bound_ms=bound_ms, bound_by=by,
            device_ms=_device_ms(
                lambda: osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2), 5
            ),
            cold_device_ms=_cold_device_ms(
                lambda: osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2)
            ),
        )
        # Modelled from the pair lists, not measured: in this line only.
        modelled = dict(
            floor_ms=(missed + other_bytes) / PEAK_BYTES_PER_S * 1e3,
            gathered_bytes=gathered, gathered_bytes_missing_l2=missed,
        )
        phase("kernel_time", kernel="outer_segment_sum", case="large", pairs=Pp, cells=G,
              slots=num_slots, K=K, T1=T1, T2=T2, dtype=str(dtype).split(".")[1],
              **times, **modelled)
        if dtype == torch.float32:
            record = times
        del W, Y
    # Edge cases: (pairs' cell ids, cells, slots, K, T1, T2).
    long_cell = np.concatenate([np.full(5000, 2), np.sort(rng.integers(3, 50, 800))])
    edge = {
        "empty cells": (np.sort(rng.integers(0, 4000, 3000)) // 2 * 2, 4000, 900, 3, 9, 9),
        "one cell with 5000 pairs": (long_cell, 50, 3000, 3, 9, 9),
        "T1 != T2 (9 x 6)": (np.sort(rng.integers(0, 700, 20000)), 700, 5000, 3, 9, 6),
        "K=2, 12 x 12 (two passes of 128)": (np.sort(rng.integers(0, 300, 4000)), 300, 800, 2, 12, 12),
        "cells of 1 to 60 pairs (every staging tail)": (
            np.repeat(np.arange(600), np.arange(600) % 60 + 1), 600, 4000, 3, 9, 9,
        ),
        "no pairs": (np.zeros(0, np.int64), 10, 20, 3, 9, 9),
    }
    for label, (cells, g, n, k, t1, t2) in edge.items():
        rp = torch.from_numpy(ss.build_row_ptr(cells, g)).to(device)
        # about one pair row in eight is the pad row n (a zero row)
        ai = torch.from_numpy(osum.pair_rows_int32(
            np.where(rng.random(cells.size) < 0.125, n, rng.integers(0, n, cells.size))
        )).to(device)
        bi = torch.from_numpy(osum.pair_rows_int32(rng.integers(0, n + 1, cells.size))).to(device)
        form = "compile_time" if (k, t1, t2) in osum.TILED_SHAPES else "run_time"
        for dtype in (torch.float32, torch.float64):
            W = torch.tensor(rng.standard_normal((n + 1, k * t1)), dtype=dtype, device=device)
            Y = torch.tensor(rng.standard_normal((n + 1, k * t2)), dtype=dtype, device=device)
            W[n] = 0.0
            Y[n] = 0.0
            err = _compare_outer(W, Y, ai, bi, rp, g, k, t1, t2, f"K4 {label} {dtype}")
            max_err, checks = max(max_err, err), checks + 1
            forms[form] += 1
    if not all(forms.values()):
        raise RuntimeError(f"K4 checks do not reach both forms: {forms}")
    phase("kernel", kernel="outer_segment_sum", checks=checks, max_abs_err=max_err,
          checks_by_form=forms)
    return _record("outer_segment_sum", max_err, **record)


def check_kernels(device) -> list:
    """Every kernel against its plain version, on the plans the two cases
    build on this device. Returns the kernel records."""
    flagship = bal.build_problem(flagship_instance())[0].program(device)
    large = bal.build_problem(large_instance())[0].program(device)
    cam_plan, point_plan = large.families[0].reduce_plans
    records = [
        check_sorted(device, flagship.families[0].reduce_plans[1], point_plan),
        check_unsorted(device, cam_plan),
    ]
    structure = schur_mod.build_schur_structure(large)
    plan = build_explicit_plan(large, structure)
    kinds = {
        "ftf": [(s.perm is None, s.plan.kind) for s in plan.ftf],
        "corr": [(g.self_pairs, g.natural, g.plan.kind, g.num_cells, int(g.a_idx.shape[0]))
                 for g in plan.corr],
    }
    phase("plan", case="large", nf=plan.nf, **kinds)
    group = next(g for g in plan.corr if not g.self_pairs)
    records.append(check_outer(device, group, large.families[0].batch))
    return records


# ---- solves -----------------------------------------------------------------

SHARDED_RANKS = 2
SHARDED_F64_RTOL = 1e-8
# (a): two ranks on one card over gloo (eager: gloo's collectives go through
# the host); (b): one rank over NCCL, captured. A rank's first solve also
# pays the process's first use of the card (2.5 s an LM iteration against
# 0.23 at the large case, on an NVIDIA H100 80GB HBM3 at 700 W): its repeat
# is the one to read.
SHARDED_GLOO_RUNS = [("large", "float64"), ("large", "float64"), ("large", "float32"),
                     ("flagship", "float64")]
# (case, dtype, loop): each run four ways on one problem (SHARDED_NCCL_KINDS);
# the host-factor cases (SHARDED_SPARSE_CASES) through the host loop too
SHARDED_NCCL_RUNS = [("flagship", "float32", "fused"), ("large", "float64", "fused"),
                     ("flagship", "float64", "host_loop"),
                     ("pose_graph_sparse_normal", "float64", "host_loop"),
                     ("pose_graph_sparse_normal_dynamic", "float64", "host_loop"),
                     ("sequential_sparse_schur", "float64", "host_loop")]
SHARDED_SPARSE_CASES = ("pose_graph_sparse_normal", "pose_graph_sparse_normal_dynamic",
                        "sequential_sparse_schur")
SHARDED_NCCL_KINDS = ("eager", "captured", "repeat", "eager_again")
SHARDED_TIMEOUT = 480.0  # one spawn: imports, set-up and every solve of every rank


class PlanLog:
    """Every reduce and gather plan built on the card while installed (a
    ``with`` block, or ``install`` / ``uninstall``), through
    ``ops/reduce._build_plan``: ``sites`` maps the file:line in the
    package that asked for the plan to its plan kinds, how many of each and the
    most rows any group took (``reduce.max_group_rows``), and separately
    the most rows of a ``scatter`` plan's group."""

    def __init__(self):
        self.sites: dict = {}
        self._real = None

    def install(self) -> "PlanLog":
        real = self._real = reduce_mod._build_plan
        package = os.path.dirname(ctt.__file__)

        def logged(kind, seg, G, device):
            if device.type == "cuda":
                frame = sys._getframe(1)
                while frame.f_code.co_filename == reduce_mod.__file__:
                    frame = frame.f_back
                site = f"{os.path.relpath(frame.f_code.co_filename, package)}:{frame.f_lineno}"
                self.add(site, kind, reduce_mod.max_group_rows(seg, G))
            return real(kind, seg, G, device)

        reduce_mod._build_plan = logged
        return self

    def uninstall(self) -> None:
        reduce_mod._build_plan = self._real

    __enter__ = install

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def add(self, site: str, kind: str, rows: int, count: int = 1) -> None:
        entry = self.sites.setdefault(site, {"kinds": {}, "largest_group": 0,
                                             "scatter_largest_group": 0})
        entry["kinds"][kind] = entry["kinds"].get(kind, 0) + count
        entry["largest_group"] = max(entry["largest_group"], rows)
        if kind == "scatter":
            entry["scatter_largest_group"] = max(entry["scatter_largest_group"], rows)

    def merge(self, sites: dict) -> None:
        """Another process's ``sites`` (a sharded phase's rank)."""
        for site, entry in sites.items():
            for kind, count in entry["kinds"].items():
                rows = entry["scatter_largest_group" if kind == "scatter" else "largest_group"]
                self.add(site, kind, rows, count)

    def check(self) -> None:
        """The ``plan`` line; raises where a card plan is ``scatter`` with
        more than two rows in a group."""
        phase("plan", case="every_program", sites=self.sites)
        bad = {s: e for s, e in self.sites.items() if e["scatter_largest_group"] > 2}
        if bad:
            raise RuntimeError(f"index_add_ over more than two rows a group on the card: {bad}")


def _reset_launches() -> None:
    for mod, _ in KERNELS.values():
        mod.launches = 0
    for mod in (ss, us):
        mod.launches_by_width.clear()


def _launches() -> dict:
    return {name: mod.launches for name, (mod, _) in KERNELS.items()}


def _launches_by_width() -> dict:
    """K1's and K3's launches by the width d of the contributions."""
    return {
        name: {f"d={d}": n for d, n in sorted(KERNELS[name][0].launches_by_width.items())}
        for name in ("sorted_segment_sum", "unsorted_segment_sum")
    }


def _options(dtype: str, iterative: bool, max_iters: int = 50):
    opts = bal.default_options(iterative=iterative)
    opts.max_num_iterations = max_iters
    if iterative:
        opts.function_tolerance = 1e-9
    opts.evaluation_dtype = dtype
    return opts


def _checked(problem, summary, reference: float, label: str) -> float:
    """The repo's own check of a solve: a finite solution of the expected
    shape whose cost agrees with the JAX package's. Returns the relative
    cost difference."""
    x = problem.state()
    rel = abs(summary.final_cost - reference) / reference
    if x.shape != (summary.num_parameters,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: bad or non-finite solution")
    if not np.isfinite(summary.final_cost) or rel > COST_RTOL:
        raise RuntimeError(
            f"{label}: final cost {summary.final_cost} not within "
            f"{COST_RTOL} of {reference}"
        )
    return rel


def solve_flagship(device, dtype: str):
    """Warm-up solve, then REPEATS timed solves; returns the launches made
    by the first of them and its summary."""
    inst = flagship_instance()
    warm, _, _ = bal.build_problem(inst)
    ctt.fused_solve(_options(dtype, True, max_iters=2), warm, device=device)
    runs = []
    for i in range(REPEATS):
        problem, _, _ = bal.build_problem(inst)
        if i == 0:
            _reset_launches()
        runs.append(ctt.fused_solve(_options(dtype, True), problem, device=device))
        if i == 0:
            launches, by_width, first_problem = _launches(), _launches_by_width(), problem
        if runs[-1].final_cost != runs[0].final_cost:
            raise RuntimeError(f"{dtype} solve is not repeatable on the card")
    summary = runs[0]
    times = [s.minimizer_time_in_seconds for s in runs]
    rel = _checked(first_problem, summary, REFERENCE_FINAL_COST, f"flagship {dtype}")
    phase(
        "solve", case="flagship", dtype=dtype, initial_cost=summary.initial_cost,
        final_cost=summary.final_cost, reference_final_cost=REFERENCE_FINAL_COST,
        rel_err=rel, lm_iterations=summary.num_iterations,
        successful_steps=summary.num_successful_steps,
        cg_iterations=summary.num_linear_solver_iterations,
        termination=str(summary.termination_type), solve_seconds=times[0],
        seconds_per_lm_iteration=times[0] / max(summary.num_iterations, 1),
        solve_seconds_all=times, solve_seconds_median=float(np.median(times)),
        setup_seconds_all=[s.preprocessor_time_in_seconds for s in runs],
        launches=launches, launches_by_width=by_width,
    )
    if launches["sorted_segment_sum"] == 0:
        raise RuntimeError(f"flagship {dtype}: K1 was never launched")
    return launches, summary


def solve_large(device, dtype: str, inst):
    """A 2-iteration warm-up solve on a fresh problem, then LARGE_REPEATS
    timed solves; returns the launches made by the first of them (also by
    width) and its summary."""
    warm, _, _ = bal.build_problem(inst)
    ctt.fused_solve(_options(dtype, False, max_iters=2), warm, device=device)
    del warm
    runs = []
    for i in range(LARGE_REPEATS):
        problem, _, _ = bal.build_problem(inst)
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
        runs.append(ctt.fused_solve(_options(dtype, False), problem, device=device))
        if i == 0:
            launches, by_width = _launches(), _launches_by_width()
            peak = torch.cuda.max_memory_allocated()
            rel = _checked(problem, runs[0], LARGE_REFERENCE_FINAL_COST, f"large {dtype}")
        if runs[-1].final_cost != runs[0].final_cost:
            raise RuntimeError(f"large {dtype} solve is not repeatable on the card")
        del problem
    summary = runs[0]
    seconds = summary.minimizer_time_in_seconds
    phase(
        "solve", case="large", dtype=dtype, initial_cost=summary.initial_cost,
        final_cost=summary.final_cost,
        reference_final_cost=LARGE_REFERENCE_FINAL_COST, rel_err=rel,
        lm_iterations=summary.num_iterations,
        successful_steps=summary.num_successful_steps,
        termination=str(summary.termination_type), solve_seconds=seconds,
        seconds_per_lm_iteration=seconds / max(summary.num_iterations, 1),
        solve_seconds_all=[s.minimizer_time_in_seconds for s in runs],
        setup_seconds=summary.preprocessor_time_in_seconds,
        setup_seconds_all=[s.preprocessor_time_in_seconds for s in runs],
        launches=launches, launches_by_width=by_width, peak_device_bytes=peak,
    )
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"large {dtype}: {name} was never launched")
    return launches, by_width, summary


# captured_loop: the cases, and the most host reads a repeat solve of a
# captured program may make (the start's upload, the one read of the
# loop's results, the solution's download).
CAPTURED_LOOP_CASES = [("flagship", "float32"), ("flagship", "float64"),
                       ("large", "float32"), ("large", "float64"),
                       ("pose_graph_repeat", "float64"),
                       ("flagship_cluster_jacobi", "float32"),
                       ("flagship_cluster_jacobi", "float64"),
                       ("flagship_cluster_tridiagonal", "float32"),
                       ("flagship_cluster_tridiagonal", "float64"),
                       ("pose_graph_subset", "float64")]
# The 500-pose graph under CGNR + SUBSET, its odometry edges as the subset:
# JAX f64 on the CPU (tests/test_torch_references.py pose_graph_subset):
# records, CG iterations, final cost.
POSE_GRAPH_SUBSET_REFERENCE = (9, 77, 0.0580636689398613)
CAPTURED_MAX_HOST_READS = 3


def _records_key(summary) -> list:
    """Every IterationSummary record of a solve, to the bit."""
    return [repr(dataclasses.astuple(r)) for r in summary.iterations]


def _graph_launches(problem, device) -> int:
    """Kernel launches credited so far from the replays of the graphs of
    ``problem``'s fused loops."""
    return sum(lp.graph_launches for lp in fused_lm.device_loops(problem.program(device)))


def _graph_pool_bytes(problem, device) -> int:
    """Device bytes held by the memory pools of the graphs of ``problem``'s
    fused loops (reserved for as long as the program keeps them)."""
    return cuda_graph.pool_bytes([g for lp in fused_lm.device_loops(problem.program(device))
                                  for g in lp.graphs or ()])


def captured_loss_swap(device) -> None:
    """Solve, ``LossFunctionWrapper.reset(TrivialLoss())``, solve again: the
    second solve must be captured anew and equal a fresh problem's solve
    under the new loss to the bit, records included."""
    inst = bal.synthesize_bal(num_cameras=4, num_points=1100, num_observations=4400, seed=42)
    wrapper = ctt.LossFunctionWrapper(ctt.HuberLoss(1.0))
    problem = bal.build_problem(inst, loss=wrapper)[0]
    opts = bal.default_options(iterative=True)
    start = problem.state().copy()
    first = ctt.solve(opts, problem, device=device)
    wrapper.reset(ctt.TrivialLoss())
    problem.write_back(start)
    swapped = ctt.solve(opts, problem, device=device)
    fresh = bal.build_problem(inst, loss=ctt.LossFunctionWrapper(ctt.TrivialLoss()))[0]
    expected = ctt.solve(opts, fresh, device=device)
    ok = (first.captured_loop and swapped.captured_loop and expected.captured_loop
          and swapped.graph_capture_time_in_seconds > 0.0
          and swapped.final_cost == expected.final_cost != first.final_cost
          and _records_key(swapped) == _records_key(expected))
    phase("captured_loop", case="loss_swap", dtype="float64", huber_final_cost=first.final_cost,
          swapped_final_cost=swapped.final_cost, fresh_final_cost=expected.final_cost,
          recaptured=swapped.graph_capture_time_in_seconds > 0.0, ok=ok)
    if not ok:
        raise RuntimeError("captured_loop loss_swap: the solve after reset() is not a fresh "
                           "problem's solve under the new loss")


def _captured_case(case: str, dtype: str, device, inst):
    """(problem, options, JAX reference cost) of a captured_loop case."""
    if case.startswith("pose_graph"):
        graph = pose_graph.synthesize_sphere(POSE_GRAPH_REPEAT_POSES, seed=POSE_GRAPH_SEED)
        problem = pose_graph.build_problem_3d(*graph[:3])[0]
        opts = pose_graph.default_options()
        if case == "pose_graph_repeat":
            return problem, opts, POSE_GRAPH_REPEAT_REFERENCE_FINAL_COST
        opts.preconditioner_type = ctt.PreconditionerType.SUBSET
        opts.residual_blocks_for_subset_preconditioner = list(range(POSE_GRAPH_REPEAT_POSES - 1))
        return problem, opts, POSE_GRAPH_SUBSET_REFERENCE[2]
    if case.startswith("flagship_cluster"):
        pt = case[len("flagship_"):].upper()
        return (bal.build_problem(flagship_instance())[0], _cluster_options(pt, dtype),
                FLAGSHIP_CLUSTER_REFERENCE[pt][2])
    if case == "flagship":
        return (bal.build_problem(flagship_instance())[0], _options(dtype, True),
                REFERENCE_FINAL_COST)
    return bal.build_problem(inst)[0], _options(dtype, False), LARGE_REFERENCE_FINAL_COST


def solve_captured_loop(device, inst, smi) -> dict:
    """``captured_loop``: for each case of CAPTURED_LOOP_CASES, on one
    problem, the loop run eagerly, then ``ctt.solve`` (which captures the
    program's graphs: set-up), its repeat from the same start (host reads
    counted, launches read), and the eager loop again: every run the same
    final cost to the bit, the same records and LM and CG counts; the repeat
    at most CAPTURED_MAX_HOST_READS host reads, all its kernel launches
    from the graphs and as many as the eager loop's, and the kernels of the
    path launched; the JAX reference held as in the phases above. Returns
    the repeat solves' launches by case."""
    paths = {}
    for case, dtype in CAPTURED_LOOP_CASES:
        label = f"captured_loop {case} {dtype}"
        problem, opts, reference = _captured_case(case, dtype, device, inst)
        x_start = problem.state().copy()
        runs, seconds, launches, reads = [], [], [], []
        for kind in ("eager", "captured", "captured", "eager"):
            problem.write_back(x_start)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            if len(runs) == 2:
                graph_launches = -_graph_launches(problem, device)
            if kind == "eager":
                (summary, loop_seconds), site = _host_reads(
                    lambda: eager_loop(problem, opts, device))
            else:
                summary, site = _host_reads(lambda: ctt.solve(opts, problem, device=device))
                loop_seconds = summary.minimizer_time_in_seconds
                if not summary.captured_loop:
                    raise RuntimeError(f"{label}: the solve was not captured")
                _checked(problem, summary, reference, label)
            runs.append(summary)
            seconds.append(loop_seconds)
            launches.append(_launches())
            reads.append(site)
            if len(runs) == 1:
                eager_peak = torch.cuda.max_memory_allocated()
            if len(runs) == 2:
                capture = dict(seconds=summary.graph_capture_time_in_seconds,
                               setup_seconds=summary.preprocessor_time_in_seconds,
                               peak_device_bytes=torch.cuda.max_memory_allocated(),
                               pool_bytes=_graph_pool_bytes(problem, device),
                               reserved_bytes=torch.cuda.memory_reserved())
            if len(runs) == 3:
                graph_launches += _graph_launches(problem, device)
        keys = [(s.final_cost, len(s.iterations) - 1, s.num_linear_solver_iterations,
                 _records_key(s)) for s in runs]
        repeat = runs[2]
        lm, cg = len(repeat.iterations) - 1, repeat.num_linear_solver_iterations
        phase(
            "captured_loop", case=case, dtype=dtype, nvidia_smi=smi,
            final_cost=repeat.final_cost, reference_final_cost=reference,
            lm_iterations=lm, cg_iterations=cg, termination=str(repeat.termination_type),
            capture_seconds=capture["seconds"], first_setup_seconds=capture["setup_seconds"],
            loop_seconds={"eager": [seconds[0], seconds[3]], "captured": seconds[1:3]},
            seconds_per_lm_iteration={"eager": [t / max(lm, 1) for t in (seconds[0], seconds[3])],
                                      "captured": [t / max(lm, 1) for t in seconds[1:3]]},
            seconds_per_cg_iteration={"eager": [t / max(cg, 1) for t in (seconds[0], seconds[3])],
                                      "captured": [t / max(cg, 1) for t in seconds[1:3]]},
            host_reads={"captured_repeat": sum(reads[2].values()),
                        "eager": sum(reads[3].values())},
            host_reads_by_site={"captured_repeat": dict(reads[2]),
                                "eager": dict(reads[3].most_common(4))},
            launches={"captured_repeat": launches[2], "eager": launches[3]},
            graph_launches_of_the_repeat=graph_launches,
            peak_device_bytes={"eager": eager_peak,
                               "first_solve_with_capture": capture["peak_device_bytes"]},
            graph_pool_bytes=capture["pool_bytes"],
            reserved_device_bytes_after_capture=capture["reserved_bytes"],
            equal_to_the_bit=all(k == keys[0] for k in keys),
        )
        if any(k != keys[0] for k in keys):
            raise RuntimeError(f"{label}: eager and captured runs differ: "
                               f"{[k[:3] for k in keys]}")
        if sum(reads[2].values()) > CAPTURED_MAX_HOST_READS:
            raise RuntimeError(f"{label}: the repeat solve read the host "
                               f"{sum(reads[2].values())} times: {dict(reads[2])}")
        if launches[2] != launches[3] or graph_launches != sum(launches[2].values()):
            raise RuntimeError(f"{label}: captured launches {launches[2]} (from the graphs "
                               f"{graph_launches}), eager {launches[3]}")
        if case == "pose_graph_subset":
            records, _, cost = POSE_GRAPH_SUBSET_REFERENCE
            _held_to_jax(repeat, records, cost, f"{label} against JAX")
        needed = {"large": tuple(KERNELS), "pose_graph_repeat": ()}.get(
            case, ("sorted_segment_sum",))
        if any(launches[2][name] == 0 for name in needed):
            raise RuntimeError(f"{label}: launches {launches[2]}, needed {needed}")
        paths[f"captured_loop_{case}_{dtype}"] = launches[2]
        del problem
    captured_loss_swap(device)
    return paths


def _sharded_fields(s) -> dict:
    """A sharded solve's numbers: its summary's, and its collectives."""
    iters = max(s.num_iterations, 1)
    reduce = s.collectives["all_reduce"]
    return dict(
        rank=torch.distributed.get_rank(), ranks=s.num_devices, captured=s.captured_loop,
        initial_cost=s.initial_cost, final_cost=s.final_cost, lm_iterations=s.num_iterations,
        termination=str(s.termination_type), setup_seconds=s.preprocessor_time_in_seconds,
        solve_seconds=s.minimizer_time_in_seconds,
        seconds_per_lm_iteration=s.minimizer_time_in_seconds / iters,
        all_reduce_calls=reduce["calls"], all_reduce_bytes=reduce["bytes"],
        all_reduce_bytes_per_lm_iteration=reduce["bytes"] / iters,
        all_reduce_seconds=reduce["seconds"], broadcasts=s.collectives["broadcast"]["calls"],
        broadcast_bytes=s.collectives["broadcast"]["bytes"],
    )


def _sharded_problem(case: str, dtype: str, mesh, loop: str = "fused"):
    if case in SHARDED_SPARSE_CASES:
        problem, opts = _sparse_problem(case, dtype)
    else:
        problem, _, _ = bal.build_problem(large_instance() if case == "large"
                                          else flagship_instance())
        opts = _options(dtype, case == "flagship")
        opts.minimizer_progress_to_stdout = loop == "host_loop"
    opts.mesh = mesh
    return problem, opts


def _sparse_problem(case: str, dtype: str):
    """(problem, options) of a host-factor case: phase 21's 2500-pose graph
    under SPARSE_NORMAL_CHOLESKY (``dynamic_sparsity`` for the dynamic
    case), or phase 22's sequential bundle adjustment under SPARSE_SCHUR."""
    if case == "sequential_sparse_schur":
        return bal.build_problem(sequential_instance())[0], _sequential_options(dtype)
    graph = pose_graph.synthesize_sphere(POSE_GRAPH_POSES, seed=POSE_GRAPH_SEED)[:3]
    opts = pose_graph.default_options()
    opts.linear_solver_type = ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY
    opts.dynamic_sparsity = case.endswith("dynamic")
    return pose_graph.build_problem_3d(*graph)[0], opts


def _sharded_solve(case: str, dtype: str, mesh, device) -> dict:
    """One sharded ``fused_solve`` of ``case`` on this rank: its summary's
    numbers, its kernel launches and its collectives."""
    problem, opts = _sharded_problem(case, dtype, mesh)
    _reset_launches()
    s = ctt.fused_solve(opts, problem, device=device)
    return dict(case=case, dtype=dtype, **_sharded_fields(s), launches=_launches())


def _mesh_setup():
    """(cuda:0, a mesh over the world) for a rank of the sharded phase."""
    from ceres_tpu_torch.parallel import make_mesh, sharding

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    sharding.MeshComm.timed = True
    return device, make_mesh(torch.distributed.get_world_size(), device_type="cuda")


def sharded_rank(rank: int, world: int, runs) -> list:
    """A gloo rank of the sharded phase: every (case, dtype) of ``runs`` on
    a mesh over the world, on cuda:0 (every rank: one card)."""
    del rank, world
    device, mesh = _mesh_setup()
    with PlanLog() as plans:
        return [_sharded_solve(case, dtype, mesh, device) for case, dtype in runs], plans.sites


def _sharded_graphs(program, loop: str) -> list:
    """The captured graphs kept on a sharded program."""
    if loop == "fused":
        return [g for lp in fused_lm.device_loops(program) for g in lp.graphs or ()]
    return [g for graphs in host_loop_graphs.host_loop_graph_sets(program) if graphs.captured
            for g in graphs._graph_list()]


def _eager_loop_x(program) -> np.ndarray:
    """The final x of ``program``'s eager fused loop (``eager_loop`` writes
    nothing back)."""
    lp = next(lp for lp in fused_lm.device_loops(program) if not lp.captured)
    return lp.state.x.to(torch.float64).cpu().numpy()


def _nccl_run(problem, opts, loop: str, kind: str, device) -> dict:
    """One of SHARDED_NCCL_KINDS: the loop run eagerly
    (``profile_solve.eager_loop`` / ``eager_host_loop``) or the entry point
    (``fused_solve`` / ``solve``, captured), its host reads counted."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        if kind.startswith("eager"):
            run = ((lambda: eager_loop(problem, opts, device, revert_on_tolerance=False))
                   if loop == "fused" else (lambda: eager_host_loop(problem, opts, device)))
            (s, _), reads = _host_reads(run)
        else:
            entry = ctt.fused_solve if loop == "fused" else ctt.solve
            s, reads = _host_reads(lambda: entry(opts, problem, device=device))
    x = problem.state().copy()
    if loop == "fused" and kind.startswith("eager"):
        x = _eager_loop_x(problem.sharded_program(device, opts.mesh))
    return dict(_sharded_fields(s), launches=_launches(), host_reads=sum(reads.values()),
                host_reads_by_site=dict(reads.most_common(6)),
                capture_seconds=s.graph_capture_time_in_seconds,
                peak_device_bytes=torch.cuda.max_memory_allocated(),
                records=_host_loop_records_key(s), progress_lines=len(text.getvalue().splitlines()),
                x=x)


def nccl_rank(rank: int, world: int, runs) -> list:
    """The NCCL rank of the sharded phase: every (case, dtype, loop) of
    ``runs`` SHARDED_NCCL_KINDS ways on one problem from one start; the
    host loop's cases also through ``ctt.solve`` without the mesh (the
    one-process bits they are held to). Returns per case its runs (a
    host-factor case's clocked by ``_sparse_host_clock``), the graphs' pool
    bytes and the one-process host loop's records, x and launches; and the
    rank's ``PlanLog`` sites."""
    del rank, world
    device, mesh = _mesh_setup()
    with PlanLog() as plans:
        return _nccl_cases(runs, device, mesh), plans.sites


def _nccl_cases(runs, device, mesh) -> list:
    out = []
    for case, dtype, loop in runs:
        problem, opts = _sharded_problem(case, dtype, mesh, loop)
        start = problem.state().copy()
        done, clocked = [], []
        for kind in SHARDED_NCCL_KINDS:
            problem.write_back(start)
            with (_sparse_host_clock() if case in SHARDED_SPARSE_CASES
                  else contextlib.nullcontext()) as clock:
                done.append(dict(kind=kind, **_nccl_run(problem, opts, loop, kind, device)))
            clocked.append(dict(clock=clock, seconds=done[-1]["solve_seconds"],
                                summary=types.SimpleNamespace(
                                    num_iterations=done[-1]["lm_iterations"])))
        program = problem.sharded_program(device, mesh)
        result = dict(case=case, dtype=dtype, loop=loop, runs=done,
                      graph_pool_bytes=cuda_graph.pool_bytes(_sharded_graphs(program, loop)))
        if case in SHARDED_SPARSE_CASES:
            result["host_factor"] = _sparse_fields(clocked)
        x0 = done[0]["x"]
        for run in done:
            run["x_equal"] = bool(np.array_equal(run.pop("x"), x0))
        if loop == "host_loop":
            problem.write_back(start)
            opts.mesh = None
            _reset_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                one = ctt.solve(opts, problem, device=device)
            result["one_process"] = dict(final_cost=one.final_cost, captured=one.captured_loop,
                                         records=_host_loop_records_key(one),
                                         x_equal=bool(np.array_equal(problem.state(), x0)),
                                         launches=_launches())
        out.append(result)
        del problem, program
    return out


def _held(label: str, got: dict, ref, rtol: float) -> float:
    """A sharded solve against the one-process one: the same LM iterations,
    the final cost within ``rtol``; returns the relative difference."""
    rel = abs(got["final_cost"] - ref.final_cost) / ref.final_cost
    if got["lm_iterations"] != ref.num_iterations or not rel <= rtol:
        raise RuntimeError(
            f"{label}: {got['lm_iterations']} iterations, final cost {got['final_cost']} "
            f"against {ref.num_iterations}, {ref.final_cost} (rtol {rtol})")
    return rel


def _check_nccl(result: dict, single: dict, paths: dict, smi: str) -> dict:
    """The NCCL rank's runs of one case: the same bits four ways (final and
    initial cost, records, x), the one-process result's bits, equal K1 / K3
    / K4 launches and all-reduce calls and bytes, the captured runs
    captured and the eager ones not, the repeat's host reads within the
    one-process bound. Prints the phase line; returns the repeat's
    launches."""
    case, dtype, loop, runs = result["case"], result["dtype"], result["loop"], result["runs"]
    label = f"sharded {case} {dtype} nccl {loop}"
    first = runs[0]
    keys = ("initial_cost", "final_cost", "lm_iterations", "termination", "records",
            "launches", "all_reduce_calls", "all_reduce_bytes", "broadcasts", "broadcast_bytes")
    for run in runs:
        if any(run[k] != first[k] for k in keys) or not run["x_equal"]:
            raise RuntimeError(f"{label}: the {run['kind']} run differs from the eager one: "
                               f"{ {k: (run[k], first[k]) for k in keys if run[k] != first[k]} }")
        if run["captured"] != (run["kind"] in ("captured", "repeat")):
            raise RuntimeError(f"{label}: the {run['kind']} run captured={run['captured']}")
    repeat = runs[2]
    lm = repeat["lm_iterations"]
    sparse = case in SHARDED_SPARSE_CASES
    bound = (CAPTURED_MAX_HOST_READS if loop == "fused"
             else (SPARSE_MAX_READS_PER_LM_ITERATION if sparse else 1) * lm
             + HOST_LOOP_SETUP_READS)
    if repeat["host_reads"] > bound or repeat["capture_seconds"] != 0.0:
        raise RuntimeError(f"{label}: the repeat read the host {repeat['host_reads']} times "
                           f"(bound {bound}): {repeat['host_reads_by_site']}")
    if loop == "fused":
        one = single[case, dtype]
        rel = _held(label, repeat, one, 0.0)
        if repeat["initial_cost"] != one.initial_cost:
            raise RuntimeError(f"{label}: initial cost {repeat['initial_cost']}")
        one_seconds = one.minimizer_time_in_seconds / max(one.num_iterations, 1)
        one_cost = one.final_cost
        for name, n in paths[f"{case}_{dtype}"].items():
            if n and not repeat["launches"][name]:
                raise RuntimeError(f"{label}: {name} never launched")
    else:
        one = result["one_process"]
        if not (one["captured"] and one["final_cost"] == repeat["final_cost"]
                and one["records"] == repeat["records"] and one["x_equal"]):
            raise RuntimeError(f"{label}: {repeat['final_cost']} against the one-process "
                               f"{one['final_cost']}")
        rel, one_seconds, one_cost = 0.0, None, one["final_cost"]
        if sparse and one["launches"] != repeat["launches"]:
            raise RuntimeError(f"{label}: launches {repeat['launches']}, one process "
                               f"{one['launches']}")
        if not sparse and repeat["progress_lines"] != 1 + len(repeat["records"]):
            raise RuntimeError(f"{label}: {repeat['progress_lines']} progress lines")
    if (repeat["launches"]["sorted_segment_sum"] == 0 and not sparse) or (
            repeat["all_reduce_calls"] == 0):
        raise RuntimeError(f"{label}: K1 or the all-reduces never ran: {repeat}")
    fields = {k: v for k, v in repeat.items() if k not in ("records", "x_equal", "kind")}
    fields.update(result.get("host_factor", {}))
    phase("sharded", backend="nccl", case=case, dtype=dtype, loop=loop, nvidia_smi=smi,
          runs=list(SHARDED_NCCL_KINDS), rel_err_vs_one_process=rel,
          one_process_final_cost=one_cost,
          one_process_seconds_per_lm_iteration=one_seconds,
          seconds_per_lm_iteration_by_run={r["kind"]: r["seconds_per_lm_iteration"]
                                           for r in runs},
          host_reads_by_run={r["kind"]: r["host_reads"] for r in runs},
          eager_host_reads_by_site=runs[0]["host_reads_by_site"],
          capture_seconds_first=runs[1]["capture_seconds"],
          peak_device_bytes={"eager": runs[0]["peak_device_bytes"],
                             "captured_first": runs[1]["peak_device_bytes"]},
          graph_pool_bytes=result["graph_pool_bytes"], equal_to_the_bit=True,
          **{k: v for k, v in fields.items() if k != "peak_device_bytes"})
    return repeat["launches"]


def solve_sharded(single: dict, paths: dict, smi: str, plans: PlanLog = None) -> dict:
    """Phase 5b: the sharded runs, held to the one-process summaries of
    phases 4 and 5 (``single[case, dtype]``) and to their launches
    (``paths``); the ranks' plans merged into ``plans``; returns each
    rank's launches by path."""
    from ceres_tpu_torch.parallel.launch import spawn_ranks

    torch.cuda.empty_cache()  # leave the card to the ranks
    t0 = time.perf_counter()
    gloo = spawn_ranks(sharded_rank, SHARDED_RANKS, (SHARDED_GLOO_RUNS,), backend="gloo",
                       timeout=SHARDED_TIMEOUT)
    t1 = time.perf_counter()
    nccl, nccl_plans = spawn_ranks(nccl_rank, 1, (SHARDED_NCCL_RUNS,), backend="nccl",
                                   timeout=SHARDED_TIMEOUT)[0]
    t2 = time.perf_counter()
    if plans is not None:
        for sites in [nccl_plans] + [r[1] for r in gloo]:
            plans.merge(sites)
    gloo = [r[0] for r in gloo]
    out = {}
    for i, (case, dtype) in enumerate(SHARDED_GLOO_RUNS):
        got = [r[i] for r in gloo]
        label = f"sharded {case} {dtype} gloo run {i}"
        keys = ("initial_cost", "final_cost", "lm_iterations", "termination")
        if any(tuple(g[k] for k in keys) != tuple(got[0][k] for k in keys) for g in got):
            raise RuntimeError(f"{label}: the ranks disagree: {got}")
        one = single[case, dtype]
        if dtype == "float64":
            rel = _held(label, got[0], one, SHARDED_F64_RTOL)
        else:
            ref = single[case, "float64"].final_cost
            rel = abs(got[0]["final_cost"] - ref) / ref
            if not rel <= COST_RTOL:
                raise RuntimeError(f"{label}: {got[0]['final_cost']} against float64 {ref}")
        for g in got:
            if g["captured"]:
                raise RuntimeError(f"{label}: a gloo mesh was captured")
            for name, n in paths[f"{case}_{dtype}"].items():
                if n and not g["launches"][name]:
                    raise RuntimeError(f"{label}, rank {g['rank']}: {name} never launched")
            out[f"sharded_{case}_{dtype}_gloo_{len(gloo)}rank_run{i}_rank{g['rank']}"] = (
                g["launches"])
            phase("sharded", backend="gloo", run=i, rel_err_vs_one_process=rel,
                  one_process_final_cost=one.final_cost, **g)
    for result in nccl:
        tag = f"sharded_{result['case']}_{result['dtype']}_nccl_1rank_{result['loop']}"
        out[tag] = _check_nccl(result, single, paths, smi)
    large64 = [r[0]["final_cost"] == r[1]["final_cost"] for r in gloo]
    phase("sharded_summary", nvidia_smi=smi, gloo_seconds=t1 - t0, nccl_seconds=t2 - t1,
          large_float64_repeats_equal_bits=all(large64))
    if not all(large64):
        raise RuntimeError("sharded large float64: the two repeats differ")
    return out


def _usable(summary, label: str) -> None:
    if not summary.is_solution_usable():
        raise RuntimeError(f"{label}: {summary.termination_type} ({summary.message})")


def _plan_kinds(program) -> list:
    return [[p.kind for p in fam.reduce_plans] for fam in program.families]


def solve_robust_large(device, dtype: str, inst):
    """The large case with HuberLoss(1.0): a 2-iteration warm-up, then two
    timed solves on fresh problems, equal to the bit. Returns (summary,
    launches of the first timed solve)."""
    loss = ctt.HuberLoss(1.0)
    warm, _, _ = bal.build_problem(inst, loss=loss)
    ctt.fused_solve(_options(dtype, False, max_iters=2), warm, device=device)
    del warm
    runs = []
    for i in range(LARGE_REPEATS):
        problem, _, _ = bal.build_problem(inst, loss=loss)
        if i == 0:
            _reset_launches()
        runs.append(ctt.fused_solve(_options(dtype, False), problem, device=device))
        if i == 0:
            launches, by_width = _launches(), _launches_by_width()
            kinds = _plan_kinds(problem.program(device))
            rel = _checked(problem, runs[0], ROBUST_LARGE_REFERENCE_FINAL_COST,
                           f"robust large {dtype}")
        if runs[-1].final_cost != runs[0].final_cost:
            raise RuntimeError(f"robust large {dtype} solve is not repeatable on the card")
        del problem
    summary = runs[0]
    _usable(summary, f"robust large {dtype}")
    seconds = summary.minimizer_time_in_seconds
    phase(
        "solve", case="robust_large", loss="HuberLoss(1.0)", dtype=dtype,
        initial_cost=summary.initial_cost, final_cost=summary.final_cost,
        reference_final_cost=ROBUST_LARGE_REFERENCE_FINAL_COST, rel_err=rel,
        lm_iterations=summary.num_iterations,
        successful_steps=summary.num_successful_steps,
        termination=str(summary.termination_type), solve_seconds=seconds,
        seconds_per_lm_iteration=seconds / max(summary.num_iterations, 1),
        solve_seconds_all=[s.minimizer_time_in_seconds for s in runs],
        setup_seconds_all=[s.preprocessor_time_in_seconds for s in runs],
        plan_kinds=kinds, launches=launches, launches_by_width=by_width,
    )
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"robust large {dtype}: {name} was never launched")
    return summary, launches


def solve_robust_flagship(device) -> dict:
    """The flagship instance with HuberLoss(1.0), float64, at the model's
    default options, against the JAX package's final cost."""
    inst = flagship_instance()
    loss = ctt.HuberLoss(1.0)
    warm, _, _ = bal.build_problem(inst, loss=loss)
    opts = bal.default_options(iterative=True)
    opts.max_num_iterations = 2
    ctt.fused_solve(opts, warm, device=device)
    problem, _, _ = bal.build_problem(inst, loss=loss)
    _reset_launches()
    summary = ctt.fused_solve(bal.default_options(iterative=True), problem, device=device)
    launches, by_width = _launches(), _launches_by_width()
    rel = _checked(problem, summary, ROBUST_FLAGSHIP_REFERENCE_FINAL_COST, "robust flagship")
    _usable(summary, "robust flagship")
    phase(
        "solve", case="robust_flagship", loss="HuberLoss(1.0)", dtype="float64",
        initial_cost=summary.initial_cost, final_cost=summary.final_cost,
        reference_final_cost=ROBUST_FLAGSHIP_REFERENCE_FINAL_COST, rel_err=rel,
        lm_iterations=summary.num_iterations,
        cg_iterations=summary.num_linear_solver_iterations,
        termination=str(summary.termination_type),
        solve_seconds=summary.minimizer_time_in_seconds,
        setup_seconds=summary.preprocessor_time_in_seconds,
        plan_kinds=_plan_kinds(problem.program(device)),
        launches=launches, launches_by_width=by_width,
    )
    if launches["sorted_segment_sum"] == 0:
        raise RuntimeError("robust flagship: K1 was never launched")
    return launches


def solve_pose_graph(device):
    """The 2500-pose sphere through ``ctt.solve`` with CGNR + block Jacobi,
    float64, against the JAX package's final cost. Returns (launches, the
    loop's seconds)."""
    t0 = time.perf_counter()
    positions, quats, constraints, _ = pose_graph.synthesize_sphere(
        POSE_GRAPH_POSES, seed=POSE_GRAPH_SEED
    )
    problem, _, _ = pose_graph.build_problem_3d(positions, quats, constraints)
    build_seconds = time.perf_counter() - t0
    opts = pose_graph.default_options()
    warm_opts = pose_graph.default_options()
    warm_opts.max_num_iterations = 1
    warm, _, _ = pose_graph.build_problem_3d(positions, quats, constraints)
    ctt.solve(warm_opts, warm, device=device)
    _reset_launches()
    summary = ctt.solve(opts, problem, device=device)
    launches = _launches()
    program = problem.program(device)
    kinds = _plan_kinds(program)
    rel = _checked(problem, summary, POSE_GRAPH_REFERENCE_FINAL_COST, "pose graph")
    phase(
        "solve", case="pose_graph_3d", poses=POSE_GRAPH_POSES, dtype="float64",
        constraints=len(constraints), num_tangent=program.num_tangent,
        tangent_groups={str(T): int(t.shape[0]) for T, t in program.bd_groups.items()},
        initial_cost=summary.initial_cost, final_cost=summary.final_cost,
        reference_final_cost=POSE_GRAPH_REFERENCE_FINAL_COST, rel_err=rel,
        lm_iterations=len(summary.iterations) - 1,
        cg_iterations=summary.num_linear_solver_iterations,
        jax_lm_cg_iterations=POSE_GRAPH_JAX_ITERATIONS, captured=summary.captured_loop,
        termination=str(summary.termination_type), message=summary.message,
        build_seconds=build_seconds,
        setup_seconds=summary.preprocessor_time_in_seconds,
        solve_seconds=summary.minimizer_time_in_seconds,
        seconds_per_cg_iteration=summary.minimizer_time_in_seconds
        / max(summary.num_linear_solver_iterations, 1),
        plan_kinds=kinds, launches=launches,
    )
    if summary.termination_type != ctt.TerminationType.CONVERGENCE:
        raise RuntimeError(f"pose graph: {summary.termination_type} ({summary.message})")
    # 2598 rows into 4998 groups: below SORTED_MIN_ROWS and above
    # UNSORTED_MAX_GROUPS, so every reduction is an index_add_ and no
    # kernel is on this path.
    if any(k != "scatter" for fam in kinds for k in fam) or any(launches.values()):
        raise RuntimeError(f"pose graph: plan kinds {kinds}, launches {launches}")
    return launches, summary.minimizer_time_in_seconds


def _iterative_options(dtype: str, max_iters: int = 50):
    opts = bal.default_options(iterative=True)
    opts.max_num_iterations = max_iters
    opts.evaluation_dtype = dtype
    return opts


def _schur_plans(program) -> dict:
    """The Schur structure's plan kinds (point side per family; camera side
    per family and argument) and whether S is assembled."""
    ss_ = program.schur_structure
    return dict(
        nf=int(ss_.f_idx.shape[0]), explicit_s=ss_.explicit is not None,
        e_plan=[None if p is None else p.kind for p in ss_.e_plan],
        f_plan=[[None if p is None else p.kind for p in fam] for fam in ss_.f_plan],
    )


class _CGClock:
    """Device-inclusive seconds spent in the Schur solver's CG loops of an
    eagerly run loop: the CG call is bracketed by ``torch.cuda.synchronize()``
    (two per linear solve, which the loop's own host reads make nearly
    free)."""

    def __init__(self):
        self.seconds = 0.0
        self._cg = schur_mod.conjugate_gradients

    def __enter__(self):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._cg(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

        schur_mod.conjugate_gradients = timed
        return self

    def __exit__(self, *exc):
        schur_mod.conjugate_gradients = self._cg


def solve_large_iterative(device, dtype: str, inst):
    """The large case with ITERATIVE_SCHUR on the implicit S: a 2-iteration
    warm-up, then two timed solves on fresh problems (captured), equal to
    the bit, and on the first problem the same loop run eagerly with its CG
    loops clocked. Returns (summary, launches and launches by width of the
    first)."""
    warm, _, _ = bal.build_problem(inst)
    ctt.fused_solve(_iterative_options(dtype, 2), warm, device=device)
    del warm
    runs = []
    for i in range(LARGE_REPEATS):
        problem, _, _ = bal.build_problem(inst)
        x_start = problem.state().copy()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
        runs.append(ctt.fused_solve(_iterative_options(dtype), problem, device=device))
        if i == 0:
            launches, by_width = _launches(), _launches_by_width()
            peak = torch.cuda.max_memory_allocated()
            rel = _checked(problem, runs[0], LARGE_REFERENCE_FINAL_COST,
                           f"large iterative {dtype}")
            plans = _schur_plans(problem.program(device))
            problem.write_back(x_start)
            with _CGClock() as cg_clock:
                eager, _ = eager_loop(problem, _iterative_options(dtype), device,
                                       revert_on_tolerance=False)
        first, last = runs[0], runs[-1]
        if (last.final_cost, last.num_iterations, last.num_linear_solver_iterations) != (
            first.final_cost, first.num_iterations, first.num_linear_solver_iterations
        ):
            raise RuntimeError(f"large iterative {dtype} solve is not repeatable on the card")
        del problem
    summary = runs[0]
    _usable(summary, f"large iterative {dtype}")
    phase("plan", case="large_iterative", dtype=dtype, **plans)
    if plans["explicit_s"] or plans["f_plan"][0][0] != "unsorted" or plans["e_plan"][0] != "sorted":
        raise RuntimeError(f"large iterative {dtype}: not the implicit S on K1 and K3: {plans}")
    seconds = summary.minimizer_time_in_seconds
    cg = summary.num_linear_solver_iterations
    phase(
        "solve", case="large_iterative", dtype=dtype, initial_cost=summary.initial_cost,
        final_cost=summary.final_cost, reference_final_cost=LARGE_REFERENCE_FINAL_COST,
        rel_err=rel, lm_iterations=summary.num_iterations,
        successful_steps=summary.num_successful_steps, cg_iterations=cg,
        termination=str(summary.termination_type), solve_seconds=seconds,
        seconds_per_lm_iteration=seconds / max(summary.num_iterations, 1),
        cg_seconds=cg_clock.seconds,
        seconds_per_cg_iteration=cg_clock.seconds / max(eager.num_linear_solver_iterations, 1),
        captured_loop_seconds_per_cg_iteration=seconds / max(cg, 1),
        eager_final_cost_equal_to_the_bit=eager.final_cost == summary.final_cost,
        solve_seconds_all=[s.minimizer_time_in_seconds for s in runs],
        setup_seconds=summary.preprocessor_time_in_seconds,
        setup_seconds_all=[s.preprocessor_time_in_seconds for s in runs],
        launches=launches, launches_by_width=by_width, peak_device_bytes=peak,
    )
    if (launches["sorted_segment_sum"] == 0 or launches["unsorted_segment_sum"] == 0
            or launches["outer_segment_sum"] != 0):
        raise RuntimeError(f"large iterative {dtype}: launches {launches} (K1, K3 > 0, K4 = 0)")
    return summary, launches, by_width


def solve_flagship_preconditioners(device) -> dict:
    """The flagship instance once with each preconditioner and option of
    FLAGSHIP_PRECONDITIONERS, against the JAX package's final cost for the
    same options. Returns the launches of each solve."""
    inst = flagship_instance()
    paths = {}
    for name, (changes, reference) in FLAGSHIP_PRECONDITIONERS.items():
        opts = bal.default_options(iterative=True)
        for field, value in changes.items():
            setattr(opts, field, value)
        problem, _, _ = bal.build_problem(inst)
        _reset_launches()
        summary = ctt.fused_solve(opts, problem, device=device)
        launches, by_width = _launches(), _launches_by_width()
        rel = _checked(problem, summary, reference, f"flagship {name}")
        _usable(summary, f"flagship {name}")
        phase(
            "solve", case="flagship_preconditioners", variant=name,
            dtype=opts.evaluation_dtype or "float64", initial_cost=summary.initial_cost,
            final_cost=summary.final_cost, reference_final_cost=reference, rel_err=rel,
            lm_iterations=summary.num_iterations,
            cg_iterations=summary.num_linear_solver_iterations,
            termination=str(summary.termination_type),
            solve_seconds=summary.minimizer_time_in_seconds,
            setup_seconds=summary.preprocessor_time_in_seconds,
            launches=launches, launches_by_width=by_width,
        )
        if launches["sorted_segment_sum"] == 0:
            raise RuntimeError(f"flagship {name}: K1 was never launched")
        paths[f"flagship_{name}"] = launches
    return paths


def solve_pose_graph_twice(device) -> dict:
    """A pose graph whose every plan is ``scatter`` (``index_add_``, atomics
    on the card), solved twice in one process: the same final cost and LM
    and CG iteration counts to the bit, and the JAX package's cost."""
    positions, quats, constraints, _ = pose_graph.synthesize_sphere(
        POSE_GRAPH_REPEAT_POSES, seed=POSE_GRAPH_SEED
    )
    runs = []
    for _ in range(2):
        problem, _, _ = pose_graph.build_problem_3d(positions, quats, constraints)
        _reset_launches()
        summary = ctt.solve(pose_graph.default_options(), problem, device=device)
        launches = _launches()
        rel = _checked(problem, summary, POSE_GRAPH_REPEAT_REFERENCE_FINAL_COST,
                       "pose graph repeat")
        _usable(summary, "pose graph repeat")
        runs.append(summary)
    kinds = _plan_kinds(problem.program(device))
    keys = [(s.final_cost, len(s.iterations) - 1, s.num_linear_solver_iterations) for s in runs]
    phase(
        "solve", case="pose_graph_repeat", poses=POSE_GRAPH_REPEAT_POSES, dtype="float64",
        constraints=len(constraints), final_costs=[k[0] for k in keys],
        reference_final_cost=POSE_GRAPH_REPEAT_REFERENCE_FINAL_COST, rel_err=rel,
        lm_iterations=[k[1] for k in keys], cg_iterations=[k[2] for k in keys],
        termination=str(runs[0].termination_type),
        solve_seconds=[s.minimizer_time_in_seconds for s in runs],
        equal_to_the_bit=keys[0] == keys[1], plan_kinds=kinds, launches=launches,
    )
    if any(k != "scatter" for fam in kinds for k in fam) or any(launches.values()):
        raise RuntimeError(f"pose graph repeat: plan kinds {kinds}, launches {launches}")
    if keys[0] != keys[1]:
        raise RuntimeError(f"pose graph repeat: two solves differ: {keys}")
    return launches


def solve_dense(device) -> None:
    """A small robust BAL with both dense solvers, each solved twice: the
    two solves the same final cost and x to the bit (its point plan adds up
    to 4 rows a group in one fixed order on the card), the solvers one
    against the other."""
    inst = bal.synthesize_bal(**SMALL_ROBUST)
    costs = {}
    for solver in (ctt.LinearSolverType.DENSE_QR, ctt.LinearSolverType.DENSE_NORMAL_CHOLESKY):
        runs = []
        for _ in range(2):
            problem, _, _ = bal.build_problem(inst, loss=ctt.HuberLoss(1.0))
            opts = ctt.SolverOptions(linear_solver_type=solver)
            summary = ctt.solve(opts, problem, device=device)
            _usable(summary, f"dense {solver}")
            x = problem.state()
            if not np.all(np.isfinite(x)) or not summary.final_cost < 0.1 * summary.initial_cost:
                raise RuntimeError(f"dense {solver}: no progress or non-finite solution")
            runs.append((summary, x))
        (summary, x), (again, x_again) = runs
        costs[solver] = summary.final_cost
        phase(
            "solve", case="small_robust_dense", linear_solver=str(solver), dtype="float64",
            initial_cost=summary.initial_cost, final_costs=[summary.final_cost, again.final_cost],
            lm_iterations=len(summary.iterations) - 1,
            termination=str(summary.termination_type),
            solve_seconds=[summary.minimizer_time_in_seconds, again.minimizer_time_in_seconds],
            point_plan_kind=problem.program(device).families[0].reduce_plans[1].kind,
        )
        if again.final_cost != summary.final_cost or not np.array_equal(x, x_again):
            raise RuntimeError(f"dense {solver}: two solves differ: {summary.final_cost!r} "
                               f"and {again.final_cost!r}")
    qr, chol = costs.values()
    if abs(qr - chol) > DENSE_RTOL * chol:
        raise RuntimeError(f"DENSE_QR {qr} and DENSE_NORMAL_CHOLESKY {chol} disagree")


# ---- the host-loop minimizer --------------------------------------------------


def _host_loop_options(dtype: str, records: list, max_iters: int = 50):
    """The large phase's options with the flagship example's progress output
    and an iteration callback that keeps each record: the host loop."""
    opts = _options(dtype, False, max_iters)
    opts.minimizer_progress_to_stdout = True

    def keep(it):
        records.append(it)
        return ctt.CallbackReturnType.SOLVER_CONTINUE

    opts.callbacks = [keep]
    return opts


def _record_key(summary):
    return [(r.step_is_successful, r.step_is_valid, r.linear_solver_iterations)
            for r in summary.iterations]


def solve_host_loop_large(device, dtype: str, inst, smi: str):
    """The large case through ctt.solve on the host loop (progress output
    and a callback): a 2-iteration warm-up, LARGE_REPEATS timed solves equal
    to the bit, then the traced fused loop on the same instance and options
    without those two, held record by record. Returns the launches of the
    first timed solve."""
    warm, _, _ = bal.build_problem(inst)
    with contextlib.redirect_stdout(io.StringIO()):
        ctt.solve(_host_loop_options(dtype, [], max_iters=2), warm, device=device)
    del warm
    runs = []
    for i in range(LARGE_REPEATS):
        problem, _, _ = bal.build_problem(inst)
        kept, text = [], io.StringIO()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
        with contextlib.redirect_stdout(text):
            runs.append(ctt.solve(_host_loop_options(dtype, kept), problem, device=device))
        if i == 0:
            launches, by_width = _launches(), _launches_by_width()
            peak = torch.cuda.max_memory_allocated()
            rel = _checked(problem, runs[0], LARGE_REFERENCE_FINAL_COST, f"host loop large {dtype}")
            progress, callback_records = text.getvalue().splitlines(), len(kept)
        if runs[-1].final_cost != runs[0].final_cost or _record_key(runs[-1]) != _record_key(runs[0]):
            raise RuntimeError(f"host loop large {dtype} solve is not repeatable on the card")
        del problem
    host = runs[0]
    _usable(host, f"host loop large {dtype}")
    problem, _, _ = bal.build_problem(inst)
    traced = ctt.solve(_options(dtype, False), problem, device=device)
    del problem
    costs = [(a.cost, b.cost) for a, b in zip(host.iterations, traced.iterations)]
    max_rel = max(abs(a - b) / abs(b) for a, b in costs)
    agree = (
        len(host.iterations) == len(traced.iterations)
        and _record_key(host) == _record_key(traced)
        and max_rel <= HOST_LOOP_COST_RTOL[dtype]
    )
    seconds, traced_seconds = host.minimizer_time_in_seconds, traced.minimizer_time_in_seconds
    phase(
        "solve", case="host_loop_large", dtype=dtype, initial_cost=host.initial_cost,
        final_cost=host.final_cost, reference_final_cost=LARGE_REFERENCE_FINAL_COST,
        rel_err=rel, lm_iterations=host.num_iterations, records=len(host.iterations),
        successful_steps=host.num_successful_steps,
        rejected_steps=host.num_unsuccessful_steps,
        linear_solver_iterations=host.num_linear_solver_iterations,
        termination=str(host.termination_type), message=host.message,
        solve_seconds=seconds, seconds_per_lm_iteration=seconds / max(host.num_iterations, 1),
        solve_seconds_all=[s.minimizer_time_in_seconds for s in runs],
        traced_solve_seconds=traced_seconds,
        traced_seconds_per_lm_iteration=traced_seconds / max(traced.num_iterations, 1),
        traced_lm_iterations=traced.num_iterations, traced_final_cost=traced.final_cost,
        records_agree=agree, record_costs_max_rel_diff=max_rel,
        record_costs_equal_to_the_bit=all(a == b for a, b in costs),
        summary_times=dict(
            residual_evaluation=[host.residual_evaluation_time_in_seconds,
                                 host.num_residual_evaluations],
            jacobian_evaluation=[host.jacobian_evaluation_time_in_seconds,
                                 host.num_jacobian_evaluations],
            linear_solver=[host.linear_solver_time_in_seconds, host.num_linear_solves],
        ),
        progress_lines=len(progress), callback_records=callback_records,
        setup_seconds=host.preprocessor_time_in_seconds,
        setup_seconds_all=[s.preprocessor_time_in_seconds for s in runs],
        capture_seconds_all=[s.graph_capture_time_in_seconds for s in runs],
        launches=launches, launches_by_width=by_width, peak_device_bytes=peak, card=smi,
    )
    if not all(s.captured_loop for s in runs):
        raise RuntimeError(f"host loop large {dtype}: the host loop was not captured")
    if not agree:
        raise RuntimeError(f"host loop large {dtype}: records differ from the traced loop's")
    if not progress[0].startswith("iter ") or len(progress) != 1 + len(host.iterations):
        raise RuntimeError(f"host loop large {dtype}: {len(progress)} progress lines")
    if callback_records != len(host.iterations) - 1:
        raise RuntimeError(f"host loop large {dtype}: the callback saw {callback_records} records")
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"host loop large {dtype}: {name} was never launched")
    return launches


# A captured host-loop repeat solve's host reads besides its one per LM
# iteration on the fused iteration: the start's upload, iteration 0's read,
# the graphs' launch counts and the solution's download.
HOST_LOOP_SETUP_READS = 4


def _host_loop_records_key(summary) -> list:
    """Every IterationSummary record of a host-loop solve but its three
    times, to the bit."""
    return [repr(dataclasses.astuple(r)[:-3]) for r in summary.iterations]


def _host_loop_graph_sets(problem, device) -> list:
    """The captured ``HostLoopGraphs`` and ``LineSearchGraphs`` kept on
    ``problem``'s program."""
    program = problem.program(device)
    return [g for g in (host_loop_graphs.host_loop_graph_sets(program)
                        + host_loop_graphs.line_search_graph_sets(program)) if g.captured]


def _accept_copy(graphs) -> tuple:
    """(bytes, ms) of one replay of the fused iteration's accept copy
    (candidate x, residuals, Jacobian blocks and gradient into the current
    buffers; each read and written once), from CUDA events over 50
    replays."""
    graph = graphs.graphs["accept"]
    moved = 2 * sum(t.numel() * t.element_size() for t in graphs._bufs["fused_candidate"])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(50):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return moved, start.elapsed_time(end) / 50


HOST_LOOP_RUNS = ("eager", "captured", "repeat", "eager_again")


def _eager_captured_repeat(label: str, problem, opts, device, clock=None) -> list:
    """The host loop's runs on one problem from one start (HOST_LOOP_RUNS):
    its regions run eagerly (``profile_solve.eager_host_loop``),
    ``ctt.solve`` (which captures them: its
    ``graph_capture_time_in_seconds``), a repeat (replays only) and the
    eager run again. Per run: {summary, seconds, reads, launches, x, calls
    (an evaluation callback's), peak, and with ``clock`` (a context manager,
    such as ``_sparse_host_clock``) what it yielded around the run}. Raises
    unless every run gives the first's bits (records but their times, final
    cost, x, the callback's calls) and K1 / K3 / K4 launches, the repeat
    reads the host nowhere inside a graph (no CG predicate) and at most once
    more than the eager run again (its launch counts), and the repeat
    captures nothing."""
    start = problem.state().copy()
    runs = []
    for kind in HOST_LOOP_RUNS:
        problem.write_back(start)
        callback = opts.evaluation_callback
        if callback is not None:
            callback.calls = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as text, \
                (clock or contextlib.nullcontext)() as clocked:
            if kind.startswith("eager"):
                (summary, seconds), reads = _host_reads(
                    lambda: eager_host_loop(problem, opts, device))
            else:
                summary, reads = _host_reads(lambda: ctt.solve(opts, problem, device=device))
                seconds = summary.minimizer_time_in_seconds
        runs.append(dict(summary=summary, seconds=seconds, reads=reads, launches=_launches(),
                         x=problem.state().copy(), text=text.getvalue(),
                         calls=None if callback is None else callback.calls,
                         peak=torch.cuda.max_memory_allocated(), clock=clocked))
    eager, repeat = runs[0], runs[2]
    for kind, run in zip(HOST_LOOP_RUNS[1:], runs[1:]):
        same = (_host_loop_records_key(run["summary"]) == _host_loop_records_key(eager["summary"])
                and run["summary"].final_cost == eager["summary"].final_cost
                and np.array_equal(run["x"], eager["x"]) and run["calls"] == eager["calls"])
        if not (same and run["summary"].captured_loop == (kind != "eager_again")):
            raise RuntimeError(f"{label}: the {kind} run differs from the eager one "
                               f"({run['summary'].final_cost} against "
                               f"{eager['summary'].final_cost})")
        if run["launches"] != eager["launches"]:
            raise RuntimeError(f"{label}: {kind} launches {run['launches']}, eager "
                               f"{eager['launches']}")
    reads, eager_reads = repeat["reads"], sum(runs[3]["reads"].values())
    if (any(site.startswith("cuda_graph.py") for site in reads)
            or sum(reads.values()) > eager_reads + 1
            or repeat["summary"].graph_capture_time_in_seconds != 0.0):
        raise RuntimeError(f"{label}: the repeat read the host {dict(reads)} (eager "
                           f"{eager_reads}) or captured again")
    return runs


def _host_loop_fields(runs, problem, device) -> dict:
    """The phase fields of _eager_captured_repeat's runs: seconds and host
    reads per LM iteration (eager, captured, repeat), reads by site, the
    capture's seconds, the graphs' pool bytes beside the eager peak."""
    lm = max(runs[2]["summary"].num_iterations, 1)  # loop trips: a stop may add no record
    graphs = _host_loop_graph_sets(problem, device)
    return dict(
        lm_iterations=runs[2]["summary"].num_iterations,
        seconds={k: r["seconds"] for k, r in zip(HOST_LOOP_RUNS, runs)},
        seconds_per_lm_iteration={k: r["seconds"] / lm for k, r in zip(HOST_LOOP_RUNS, runs)},
        host_reads={k: sum(r["reads"].values()) for k, r in zip(HOST_LOOP_RUNS, runs)},
        host_reads_per_lm_iteration={k: sum(r["reads"].values()) / lm
                                     for k, r in zip(HOST_LOOP_RUNS, runs)},
        host_reads_by_site={"eager": dict(runs[0]["reads"].most_common(6)),
                            "repeat": dict(runs[2]["reads"])},
        capture_seconds=runs[1]["summary"].graph_capture_time_in_seconds,
        graphs=sorted(name for g in graphs for name in g.graphs)
        + sorted(name for g in graphs for r in getattr(g, "_inner", {}).values()
                 for name in r.graphs),
        graph_pool_bytes=sum(g.pool_bytes() for g in graphs),
        peak_device_bytes={"eager": runs[0]["peak"], "captured": runs[1]["peak"]},
        launches=runs[2]["launches"],
    )


def solve_host_loop_progress(device, smi: str) -> dict:
    """``host_loop_progress``: the flagship instance through ``ctt.solve``
    with ``minimizer_progress_to_stdout`` (its text kept out of the phase
    lines), float32 and float64, at phase 4's options: the host loop's fused
    iteration. Eager, captured, again and eager (``_eager_captured_repeat``),
    each held to REFERENCE_FINAL_COST; the repeat at most one host read per
    LM iteration plus HOST_LOOP_SETUP_READS. Returns the repeat's launches
    by dtype."""
    paths = {}
    for dtype in ("float32", "float64"):
        label = f"host_loop_progress {dtype}"
        problem, _, _ = bal.build_problem(flagship_instance())
        opts = _options(dtype, True)
        opts.minimizer_progress_to_stdout = True
        runs = _eager_captured_repeat(label, problem, opts, device)
        rel = _checked(problem, runs[2]["summary"], REFERENCE_FINAL_COST, label)
        fields = _host_loop_fields(runs, problem, device)
        graphs = _host_loop_graph_sets(problem, device)
        accept_bytes, accept_ms = _accept_copy(graphs[0])
        repeat = runs[2]["summary"]
        phase("host_loop", case="host_loop_progress", dtype=dtype, nvidia_smi=smi,
              final_cost=repeat.final_cost, reference_final_cost=REFERENCE_FINAL_COST,
              rel_err=rel, cg_iterations=repeat.num_linear_solver_iterations,
              termination=str(repeat.termination_type),
              progress_lines=len(runs[2]["text"].splitlines()),
              accept_copy_bytes=accept_bytes, accept_copy_ms=accept_ms, **fields)
        if fields["host_reads"]["repeat"] > fields["lm_iterations"] + HOST_LOOP_SETUP_READS:
            raise RuntimeError(f"{label}: the repeat read the host {fields['host_reads']} "
                               f"times in {fields['lm_iterations']} LM iterations")
        if len(runs[2]["text"].splitlines()) != 1 + len(repeat.iterations):
            raise RuntimeError(f"{label}: {len(runs[2]['text'].splitlines())} progress lines")
        if fields["launches"]["sorted_segment_sum"] == 0:
            raise RuntimeError(f"{label}: K1 was never launched")
        paths[f"host_loop_progress_{dtype}"] = fields["launches"]
        del problem
    return paths


class _CountingCallback(ctt.EvaluationCallback):
    def __init__(self):
        self.calls = 0

    def prepare_for_evaluation(self, new_evaluation_point, evaluate_jacobians):
        self.calls += 1


def solve_flagship_host_loop(device, smi: str) -> dict:
    """The flagship instance through the host loop's step-by-step branch,
    float64: bounded (the projected line search) and non-monotonic (with an
    EvaluationCallback and a time budget), each run eagerly, captured,
    again and eagerly (``_eager_captured_repeat``) and the captured solve held
    to the JAX package's float64 result. Returns the captured solve's
    launches of each."""
    paths = {}
    boxed = flagship_instance()
    boxed.points[:, 2] = np.clip(boxed.points[:, 2], -1.0, 1.0)
    problem, _, pts = bal.build_problem(boxed)
    for pid in pts:
        problem.set_parameter_lower_bound(int(pid), 2, -1.0)
        problem.set_parameter_upper_bound(int(pid), 2, 1.0)
    counter = _CountingCallback()
    nonmono, _, _ = bal.build_problem(flagship_instance())
    opts_n = bal.default_options(iterative=True)
    opts_n.use_nonmonotonic_steps = True
    opts_n.evaluation_callback = counter
    opts_n.max_solver_time_in_seconds = 1e5
    for name, prob, opts, (records, reference) in (
        ("bounded", problem, bal.default_options(iterative=True), FLAGSHIP_BOUNDED_REFERENCE),
        ("nonmonotonic", nonmono, opts_n, FLAGSHIP_NONMONOTONIC_REFERENCE[:2]),
    ):
        label = f"flagship host loop {name}"
        runs = _eager_captured_repeat(label, prob, opts, device)
        summary = runs[1]["summary"]
        launches = runs[1]["launches"]
        _usable(summary, label)
        rel = abs(summary.final_cost - reference) / reference
        extra = {}
        if name == "bounded":
            z = prob.state()[-3 * len(pts) + 2::3]
            extra = dict(inside_the_box=bool(np.all(np.abs(z) <= 1.0)),
                         active_bounds=int(np.sum(np.abs(z) == 1.0)))
        else:
            extra = dict(evaluation_callback_calls=runs[1]["calls"],
                         reference_evaluation_callback_calls=FLAGSHIP_NONMONOTONIC_REFERENCE[2],
                         nonmonotonic_steps=sum(r.step_is_nonmonotonic for r in summary.iterations))
        phase(
            "solve", case="flagship_host_loop", variant=name, dtype="float64",
            initial_cost=summary.initial_cost, final_cost=summary.final_cost,
            reference_final_cost=reference, rel_err=rel, records=len(summary.iterations),
            reference_records=records,
            cg_iterations=summary.num_linear_solver_iterations,
            termination=str(summary.termination_type), message=summary.message,
            setup_seconds=summary.preprocessor_time_in_seconds,
            launches_by_width=_launches_by_width(), card=smi,
            **_host_loop_fields(runs, prob, device), **extra,
        )
        if len(summary.iterations) != records or not rel <= FLAGSHIP_HOST_LOOP_RTOL:
            raise RuntimeError(f"{label}: records {len(summary.iterations)} "
                               f"(JAX {records}), cost {summary.final_cost} (JAX {reference})")
        if name == "bounded" and not (extra["inside_the_box"] and extra["active_bounds"] > 0):
            raise RuntimeError(f"flagship host loop bounded: {extra}")
        if name == "nonmonotonic" and runs[1]["calls"] != FLAGSHIP_NONMONOTONIC_REFERENCE[2]:
            raise RuntimeError(f"flagship host loop nonmonotonic: {runs[1]['calls']} "
                               "callback calls")
        if launches["sorted_segment_sum"] == 0:
            raise RuntimeError(f"{label}: K1 was never launched")
        paths[f"flagship_host_loop_{name}"] = launches
    return paths


# ---- the other minimizers ---------------------------------------------------


@contextlib.contextmanager
def _instances(cls):
    """Every instance of ``cls`` made in the block, and the seconds each
    took to make (``made_seconds``)."""
    made = []
    init = cls.__init__

    def spy(self, *args, **kw):
        t0 = time.perf_counter()
        init(self, *args, **kw)
        self.made_seconds = time.perf_counter() - t0
        made.append(self)

    cls.__init__ = spy
    try:
        yield made
    finally:
        cls.__init__ = init


@contextlib.contextmanager
def _timed_calls(module, name: str):
    """The seconds of each call of ``module.name`` made in the block."""
    seconds = []
    real = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _inner_launches():
    """The kernel launches made inside the inner passes, apart from the LM
    step's."""
    counts = collections.Counter()
    real = inner_iterations.CoordinateDescentMinimizer.minimize

    def counted(self, x):
        before = _launches()
        out = real(self, x)
        counts.update({k: v - before[k] for k, v in _launches().items()})
        return out

    inner_iterations.CoordinateDescentMinimizer.minimize = counted
    try:
        yield counts
    finally:
        inner_iterations.CoordinateDescentMinimizer.minimize = real


def _reads(run, prepare):
    """(summary, host reads by site) of run() on a problem whose set-up
    ``prepare()`` (a 0-iteration solve) did beforehand."""
    prepare()
    return _host_reads(run)


def _inner_pass_reads(reads) -> dict:
    """The host reads of ``reads`` (by site) made inside an inner pass:
    in ``CoordinateDescentMinimizer.minimize`` or ``_set_step`` (not in
    the sets' and plans' construction, a program's set-up)."""
    spans = []
    for fn in (inner_iterations.CoordinateDescentMinimizer.minimize,
               inner_iterations.CoordinateDescentMinimizer._set_step):
        lines, first = inspect.getsourcelines(fn)
        spans.append((first, first + len(lines)))
    out = {}
    for site, n in reads.items():
        name, _, line = site.rpartition(":")
        if name == "inner_iterations.py" and any(a <= int(line) < b for a, b in spans):
            out[site] = n
    return out


def _large_options(dtype: str, max_iters: int = 50):
    return _options(dtype, False, max_iters)


def _flagship_minimizer_options(dtype: str, max_iters: int = 50):
    """bal.default_options(iterative=True) (ITERATIVE_SCHUR + SCHUR_JACOBI),
    as tests/test_torch_references.py's flagship_inner_references sets it."""
    opts = bal.default_options(iterative=True)
    opts.max_num_iterations = max_iters
    opts.evaluation_dtype = dtype
    return opts


def solve_large_minimizer(device, label: str, dtype: str, inst, changes: dict, smi: str,
                          base_options=_large_options, reference=LARGE_REFERENCE_FINAL_COST,
                          kernels=("sorted_segment_sum", "unsorted_segment_sum",
                                   "outer_segment_sum")):
    """The large case (or ``inst``) through ctt.solve (DENSE_SCHUR, or
    ``base_options``) with the minimizer options ``changes``: a 2-iteration
    warm-up on a problem of its own, then on one problem its regions run
    eagerly, captured, again and eagerly (``_eager_captured_repeat``: the
    same bits and launches), each of ``kernels`` launched. With inner
    iterations: a captured pass reads
    the host once (its cost) and nowhere else in inner_iterations.py, and
    its launches (credited at each replay) are the eager pass's. Returns
    (the captured solve's summary, its launches, extra fields)."""

    def options(max_iters=50):
        opts = base_options(dtype, max_iters)
        for k, v in changes.items():
            setattr(opts, k, v)
        return opts

    warm, _, _ = bal.build_problem(inst)
    ctt.solve(options(2), warm, device=device)
    del warm
    problem, _, _ = bal.build_problem(inst)
    with _instances(dogleg.DoglegStrategy) as strategies, _instances(
        inner_iterations.CoordinateDescentMinimizer
    ) as inner, _inner_launches() as inner_counts, _timed_calls(
        inner_iterations, "compute_independent_sets"
    ) as coloring, _timed_calls(inner_iterations, "_build_structure") as structures:
        runs = _eager_captured_repeat(f"{label} {dtype}", problem, options(), device)
    summary, launches = runs[1]["summary"], runs[1]["launches"]
    # every run's inner passes launch alike
    inner_only = {k: inner_counts[k] // len(runs) for k in launches}
    _checked(problem, summary, reference, f"{label} {dtype}")
    _usable(summary, f"{label} {dtype}")
    extra = {}
    if strategies:
        extra["mu_retries"] = strategies[0].mu_retries
    if inner:
        cd = inner[0]
        passes = [r["summary"].num_inner_iteration_steps for r in runs]
        pass_reads = {k: _inner_pass_reads(r["reads"]) for k, r in zip(HOST_LOOP_RUNS, runs)}
        regions = [r for g in _host_loop_graph_sets(problem, device) for r in g._inner.values()]
        extra.update(
            sets=[len(s) for s in cd.sets], plans=cd.plan_kinds(),
            inner_iteration_steps=summary.num_inner_iteration_steps,
            inner_iteration_seconds=summary.inner_iteration_time_in_seconds,
            inner_pass_seconds={k: r["summary"].inner_iteration_time_in_seconds / max(n, 1)
                                for k, r, n in zip(HOST_LOOP_RUNS, runs, passes)},
            inner_pass_reads_by_site=pass_reads,
            # the sets and plans are made once per program: one build here
            inner_setup_seconds=structures,
            inner_minimizers_made=len(inner),
            coloring_seconds=coloring,
            inner_launches=inner_only,
            inner_graph_launches=sum(r.graph_launches for r in regions),
            inner_graphs=sorted(n for r in regions for n in r.graphs),
            lm_step_launches={k: launches[k] - inner_only[k] for k in launches},
        )
        for kind, reads in pass_reads.items():
            if len(reads) > 1 or sum(reads.values()) != passes[HOST_LOOP_RUNS.index(kind)]:
                raise RuntimeError(f"{label} {dtype}: the {kind} run's inner passes read the "
                                   f"host {reads} in {passes} passes")
        if len(structures) != 1 or len(coloring) > 1:
            raise RuntimeError(f"{label} {dtype}: the sets were made {len(structures)} times")
    phase(
        "solve", case=label, dtype=dtype, initial_cost=summary.initial_cost,
        final_cost=summary.final_cost, records=len(summary.iterations),
        successful_steps=summary.num_successful_steps,
        rejected_steps=summary.num_unsuccessful_steps,
        termination=str(summary.termination_type), message=summary.message,

        setup_seconds=summary.preprocessor_time_in_seconds,
        launches_by_width=_launches_by_width(), card=smi,
        **_host_loop_fields(runs, problem, device), **extra,
    )
    for name in kernels:
        if launches[name] == 0:
            raise RuntimeError(f"{label} {dtype}: {name} was never launched")
    if inner and not all(inner_only[k] for k in kernels if k != "outer_segment_sum"):
        raise RuntimeError(f"{label} {dtype}: the inner pass launched {inner_only}")
    return summary, launches, extra


def _held_to_jax(summary, records: int, reference: float, label: str) -> float:
    rel = abs(summary.final_cost - reference) / reference
    phase("compare", case=label, records=len(summary.iterations), reference_records=records,
          final_cost=summary.final_cost, reference_final_cost=reference, rel=rel)
    if len(summary.iterations) != records or not rel <= MINIMIZER_F64_RTOL:
        raise RuntimeError(f"{label}: {len(summary.iterations)} records (JAX {records}), "
                           f"cost {summary.final_cost} (JAX {reference})")
    return rel


def _held_to_f64(s32, s64, label: str, rtol: float = MINIMIZER_F32_RTOL) -> float:
    rel = abs(s32.final_cost - s64.final_cost) / s64.final_cost
    phase("compare", case=label, float32_vs_float64_rel=rel, rtol=rtol)
    if not rel <= rtol:
        raise RuntimeError(f"{label}: float32 {s32.final_cost} vs float64 {s64.final_cost}")
    return rel


def solve_dogleg_large(device, inst, smi: str) -> dict:
    """The large case under DOGLEG: traditional in f32 and f64, subspace in
    f64, each f64 solve against JAX f64, f32 against f64."""
    paths, out = {}, {}
    for kind, dtype in (("TRADITIONAL_DOGLEG", "float32"), ("TRADITIONAL_DOGLEG", "float64"),
                        ("SUBSPACE_DOGLEG", "float64")):
        changes = dict(trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG,
                       dogleg_type=ctt.DoglegType[kind])
        label = f"dogleg_large_{kind.split('_')[0].lower()}"
        out[kind, dtype], paths[f"{label}_{dtype}"], _ = solve_large_minimizer(
            device, label, dtype, inst, changes, smi)
        if dtype == "float64":
            _held_to_jax(out[kind, dtype], *LARGE_DOGLEG_REFERENCE[kind], f"{label} float64")
    _held_to_f64(out["TRADITIONAL_DOGLEG", "float32"], out["TRADITIONAL_DOGLEG", "float64"],
                 "dogleg_large_traditional")
    return paths


def solve_inner_iterations_large(device, inst, smi: str) -> dict:
    """The large case, LM at DENSE_SCHUR with inner iterations, f32 and f64
    (the f64 repeat's host reads per LM iteration beside those of the set
    steps run op by op)."""
    paths, out = {}, {}
    for dtype in ("float32", "float64"):
        out[dtype], paths[f"inner_iterations_large_{dtype}"], extra = solve_large_minimizer(
            device, "inner_iterations_large", dtype, inst, dict(use_inner_iterations=True), smi)
        paths[f"inner_iterations_large_{dtype}_inner_pass"] = extra["inner_launches"]
    phase("compare", case="inner_iterations_large", dtype="float64",
          op_by_op_repeat_reads_per_lm_iteration=INNER_LARGE_F64_READS_OP_BY_OP)
    records, reference, steps = LARGE_INNER_REFERENCE
    _held_to_jax(out["float64"], records, reference, "inner_iterations_large float64")
    if out["float64"].num_inner_iteration_steps != steps:
        raise RuntimeError(f"inner iterations large: {out['float64'].num_inner_iteration_steps} "
                           f"inner steps (JAX {steps})")
    _held_to_f64(out["float32"], out["float64"], "inner_iterations_large", INNER_F32_RTOL)
    return paths


def solve_inner_iterations_flagship(device, smi: str) -> dict:
    """The flagship with inner iterations (ITERATIVE_SCHUR + SCHUR_JACOBI),
    f64 and f32, each eager, captured, again and eager; f64 held to JAX
    f64's records, inner steps and final cost (FLAGSHIP_INNER_REFERENCE),
    f32 to f64 (MINIMIZER_F32_RTOL)."""
    paths, out = {}, {}
    for dtype in ("float64", "float32"):
        out[dtype], paths[f"inner_iterations_flagship_{dtype}"], extra = solve_large_minimizer(
            device, "inner_iterations_flagship", dtype, flagship_instance(),
            dict(use_inner_iterations=True), smi, base_options=_flagship_minimizer_options,
            reference=REFERENCE_FINAL_COST, kernels=("sorted_segment_sum",))
        paths[f"inner_iterations_flagship_{dtype}_inner_pass"] = extra["inner_launches"]
    records, reference, steps = FLAGSHIP_INNER_REFERENCE
    _held_to_jax(out["float64"], records, reference, "inner_iterations_flagship float64")
    if out["float64"].num_inner_iteration_steps != steps:
        raise RuntimeError(f"inner iterations flagship: "
                           f"{out['float64'].num_inner_iteration_steps} inner steps (JAX {steps})")
    _held_to_f64(out["float32"], out["float64"], "inner_iterations_flagship")
    return paths


def _line_search_options(dtype: str, max_iters: int = 100):
    opts = bal.default_options(iterative=True)
    opts.minimizer_type = ctt.MinimizerType.LINE_SEARCH
    opts.line_search_direction_type = ctt.LineSearchDirectionType.LBFGS
    opts.line_search_type = ctt.LineSearchType.WOLFE
    opts.max_num_iterations = max_iters
    opts.evaluation_dtype = dtype
    return opts


# The eager L-BFGS at the flagship reads the host 3.08 times an iteration
# (one read per evaluation of phi, per direction and per step, and the
# start's and the solution's); the captured regions may add none.
LINE_SEARCH_MAX_READS_PER_ITERATION = 3.08


def _captured_gradient_equals_eager(program, x) -> bool:
    """Whether the reverse-mode gradient at x from the program's captured
    ``start`` region (replayed twice) equals the eager region's to the
    bit."""
    eager = host_loop_graphs.line_search_graphs(program, False).cost_and_gradient(x)[1]
    captured = host_loop_graphs.line_search_graphs(program, True)
    grads = [captured.cost_and_gradient(x)[1] for _ in range(2)]
    return all(torch.equal(g, eager) for g in grads)


@contextlib.contextmanager
def _line_search_split():
    """Split the line-search iterations run in the with-body: host seconds
    to enqueue the directions (``_LBFGS.apply``) and the evaluations (the
    regions' ``line`` and ``phi``), host seconds blocked in the minimizer's
    reads (``_to_host``), and the device seconds of each phi replay and of
    each direction (CUDA events around them). Yields the totals' dict."""
    from ceres_tpu_torch import line_search

    totals = collections.Counter()
    events = {"phi": [], "direction": []}

    def wrapped(key, fn, device_key=None):
        def run(*args, **kw):
            if device_key:
                ends = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ends[0].record()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            totals[key] += time.perf_counter() - t0
            if device_key:
                ends[1].record()
                events[device_key].append(ends)
            return out

        return run

    saved = [(line_search._LBFGS, "apply"), (host_loop_graphs.LineSearchGraphs, "line"),
             (host_loop_graphs.LineSearchGraphs, "phi"), (line_search, "_to_host")]
    originals = [getattr(owner, name) for owner, name in saved]
    line_search._LBFGS.apply = wrapped("direction_host_s", originals[0], "direction")
    host_loop_graphs.LineSearchGraphs.line = wrapped("evaluation_host_s", originals[1])
    host_loop_graphs.LineSearchGraphs.phi = wrapped("evaluation_host_s", originals[2], "phi")
    line_search._to_host = wrapped("reads_host_s", originals[3])
    try:
        yield totals
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)
        torch.cuda.synchronize()
        for key, pairs in events.items():
            totals[f"{key}_device_s"] = sum(a.elapsed_time(b) for a, b in pairs) * 1e-3


def solve_flagship_line_search(device, smi: str) -> dict:
    """The flagship through ctt.solve with the LINE_SEARCH minimizer,
    float64, on one problem from one start: its regions run eagerly,
    captured, again and eagerly (``_eager_captured_repeat``: every record,
    the final cost and x to the bit, the same K1 / K3 launches, the repeat
    reading the host nowhere inside a graph), K1 launched; the repeat at
    most LINE_SEARCH_MAX_READS_PER_ITERATION host reads an iteration; the
    captured run against JAX f64; one more captured solve split into its
    evaluations, directions and reads; the captured start gradient equal to
    the eager one to the bit; float32 reported. Returns the captured
    solve's launches."""
    inst = flagship_instance()
    warm, _, _ = bal.build_problem(inst)
    ctt.solve(_line_search_options("float64", 2), warm, device=device)
    del warm
    label = "flagship line search float64"
    problem, _, _ = bal.build_problem(inst)
    start = problem.state().copy()
    runs = _eager_captured_repeat(label, problem, _line_search_options("float64"), device)
    fields = {k.replace("lm_iteration", "iteration"): v
              for k, v in _host_loop_fields(runs, problem, device).items()}
    problem.write_back(start)
    with _line_search_split() as split:
        timed = ctt.solve(_line_search_options("float64"), problem, device=device)
    if _host_loop_records_key(timed) != _host_loop_records_key(runs[0]["summary"]):
        raise RuntimeError(f"{label}: the split run differs from the eager one")
    iterations = max(timed.num_iterations, 1)
    split = {k: v / iterations for k, v in sorted(split.items())}
    split["iteration_s"] = timed.minimizer_time_in_seconds / iterations
    program = problem.program(device)
    gradient_equal = _captured_gradient_equals_eager(
        program, torch.from_numpy(start).to(device, program.eval_dtype))
    p32, _, _ = bal.build_problem(inst)
    s32 = ctt.solve(_line_search_options("float32"), p32, device=device)
    ref = FLAGSHIP_LINE_SEARCH_REFERENCE
    s = runs[1]["summary"]
    costs = [r.cost for r in s.iterations]
    n = max(s.num_iterations, 1)
    evals = sum(r.line_search_function_evaluations for r in s.iterations)
    got = [s.final_cost] + [costs[i] for i in ref["checked_records"] if i < len(costs)]
    want = [ref["final_cost"], *ref["checked_costs"]]
    rels = [abs(a - b) / b for a, b in zip(got, want)]
    tols = [max(LINE_SEARCH_COST_RTOL, 10 * sp) for sp in ref["spread"]]
    reads = fields["host_reads_per_iteration"]["repeat"]
    phase(
        "solve", case="flagship_line_search", dtype="float64", initial_cost=s.initial_cost,
        final_cost=s.final_cost, reference_final_cost=ref["final_cost"], records=len(s.iterations),
        reference_records=ref["records"], termination=str(s.termination_type),
        message=s.message, evaluations=evals, reference_evaluations=ref["evaluations"],
        evaluations_per_iteration=evals / n,
        checked_records=ref["checked_records"], rel_final_and_checked=rels,
        tolerances=tols, within_1e_6=[r <= LINE_SEARCH_COST_RTOL for r in rels],
        captured_gradient_equals_eager=gradient_equal,
        repeat_split_per_iteration=split,
        setup_seconds=s.preprocessor_time_in_seconds,
        float32=dict(final_cost=s32.final_cost, records=len(s32.iterations),
                     termination=str(s32.termination_type), captured=s32.captured_loop,
                     solve_seconds=s32.minimizer_time_in_seconds),
        launches_by_width=_launches_by_width(), card=smi, **fields,
    )
    if not gradient_equal:
        raise RuntimeError(f"{label}: the captured gradient differs from the eager one")
    if (len(s.iterations), s.termination_type.name) != (ref["records"], ref["termination"]):
        raise RuntimeError(f"{label}: {len(s.iterations)} records, "
                           f"{s.termination_type} (JAX {ref['records']}, {ref['termination']})")
    if not all(r <= t for r, t in zip(rels, tols)):
        raise RuntimeError(f"{label}: costs {got} vs JAX {want}")
    if reads > LINE_SEARCH_MAX_READS_PER_ITERATION:
        raise RuntimeError(f"{label}: the repeat read the host {reads} times an iteration")
    if runs[1]["launches"]["sorted_segment_sum"] == 0:
        raise RuntimeError(f"{label}: K1 was never launched")
    return runs[1]["launches"]


def _rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def gradient_problem_runs(label: str, problem, x0, opts, device) -> list:
    """``problem`` solved from ``x0`` four times (HOST_LOOP_RUNS): its
    regions eagerly (``profile_solve.eager_gradient_problem``),
    ``ctt.solve_gradient_problem`` (which captures them), again (replays
    only) and eagerly again. Per run {summary, x, reads, seconds}. Raises
    unless every run gives the first's records (less their times) and x to
    the bit, the captured runs are captured and the repeat captures nothing
    and reads the host no more than the eager run again."""
    runs = []
    for kind in HOST_LOOP_RUNS:
        x = np.array(x0, dtype=np.float64)
        solve = eager_gradient_problem if kind.startswith("eager") else ctt.solve_gradient_problem
        summary, reads = _host_reads(lambda: solve(opts, problem, x, device))
        runs.append(dict(summary=summary, x=x, reads=reads,
                         seconds=summary.minimizer_time_in_seconds))
    eager = runs[0]
    for kind, run in zip(HOST_LOOP_RUNS[1:], runs[1:]):
        same = (_host_loop_records_key(run["summary"]) == _host_loop_records_key(eager["summary"])
                and np.array_equal(run["x"], eager["x"]))
        if not (same and run["summary"].captured_loop == (kind in ("captured", "repeat"))):
            raise RuntimeError(f"{label}: the {kind} run differs from the eager one "
                               f"(x {run['x']} against {eager['x']})")
    repeat = runs[2]
    if (sum(repeat["reads"].values()) > sum(runs[3]["reads"].values())
            or repeat["summary"].graph_capture_time_in_seconds != 0.0):
        raise RuntimeError(f"{label}: the repeat read the host {dict(repeat['reads'])} or "
                           f"captured again")
    return runs


def solve_gradient_problems(device, smi: str) -> None:
    """examples/rosenbrock.py's problem per direction type, after a
    2-iteration warm-up (the first reverse-mode pass on the card takes
    seconds): ``gradient_problem_runs`` on one problem each (eager,
    captured, again, eager: the same bits), the captured run against JAX
    f64."""
    t0 = time.perf_counter()
    ctt.solve_gradient_problem(ctt.GradientProblemOptions(max_num_iterations=2),
                               ctt.GradientProblem(_rosenbrock, 2), np.array([-1.2, 1.0]),
                               device=device)
    phase("warm_up", case="gradient_problem", seconds=time.perf_counter() - t0)
    for direction, (records, termination, x_ref, spread) in ROSENBROCK_REFERENCE.items():
        opts = ctt.GradientProblemOptions(
            max_num_iterations=200,
            line_search_direction_type=ctt.LineSearchDirectionType[direction])
        runs = gradient_problem_runs(f"gradient problem {direction}",
                                     ctt.GradientProblem(_rosenbrock, 2), [-1.2, 1.0], opts,
                                     device)
        s, x = runs[1]["summary"], runs[1]["x"]
        n = max(s.num_iterations, 1)
        dx = float(np.max(np.abs(x - np.asarray(x_ref))))
        tol = max(ROSENBROCK_X_ATOL, 10 * spread)
        phase("solve", case="gradient_problem", direction=direction,
              records=len(s.iterations), reference_records=records,
              termination=str(s.termination_type), x=x.tolist(), reference_x=list(x_ref),
              max_abs_x_diff=dx, tolerance=tol,
              seconds={k: r["seconds"] for k, r in zip(HOST_LOOP_RUNS, runs)},
              seconds_per_iteration={k: r["seconds"] / n for k, r in zip(HOST_LOOP_RUNS, runs)},
              host_reads_per_iteration={k: sum(r["reads"].values()) / n
                                        for k, r in zip(HOST_LOOP_RUNS, runs)},
              capture_seconds=s.graph_capture_time_in_seconds, card=smi)
        steady = spread <= ROSENBROCK_X_ATOL
        if s.termination_type.name != termination or dx > tol or (
            steady and len(s.iterations) != records
        ):
            raise RuntimeError(f"gradient problem {direction}: {len(s.iterations)} records, "
                               f"{s.termination_type}, x {x} (JAX {records}, {x_ref})")


def solve_check_gradients(device, smi: str) -> dict:
    """The flagship with check_gradients for 3 iterations (passes), and a
    residual whose hand-written Jacobian is wrong (FAILURE, JAX's message).
    Returns the launches of the flagship solve."""
    opts = bal.default_options(iterative=True)
    opts.check_gradients = True
    opts.max_num_iterations = 3
    problem, _, _ = bal.build_problem(flagship_instance())
    _reset_launches()
    s = ctt.solve(opts, problem, device=device)
    launches = _launches()
    _usable(s, "check_gradients flagship")
    fn = ctt.cost_functions.analytic_cost(
        lambda x: x * x - 2.0, lambda x: (torch.stack([3.0 * x[0]]).reshape(1, 1),))
    wrong = ctt.Problem()
    wrong.add_residual_block(fn, None, [wrong.add_parameter_block(np.array([1.5]))])
    bad = ctt.solve(ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType.DENSE_QR,
                                      check_gradients=True), wrong, device=device)
    phase("solve", case="check_gradients", flagship_records=len(s.iterations),
          flagship_termination=str(s.termination_type), flagship_final_cost=s.final_cost,
          flagship_solve_seconds=s.minimizer_time_in_seconds,
          wrong_jacobian_termination=str(bad.termination_type),
          wrong_jacobian_message=bad.message, reference_message=WRONG_JACOBIAN_MESSAGE,
          launches=launches, card=smi)
    if bad.termination_type != ctt.TerminationType.FAILURE or bad.message != WRONG_JACOBIAN_MESSAGE:
        raise RuntimeError(f"check_gradients: {bad.termination_type} ({bad.message})")
    return launches


# ---- the host-driven sparse solvers and the cluster preconditioners ----------


@contextlib.contextmanager
def _sparse_host_clock():
    """The host's seconds in the sparse factor's symbolic analysis (the
    ``SparseCholesky`` construction: ordering and analysis), numeric
    factorization and solve, the bytes the sparse steps copy to the host
    (``host_loop_graphs.SparseRegions.read_flat``: the cells, diagonal and
    right-hand side of one prep) and the factors made."""
    seconds = collections.Counter()
    host_bytes = []
    made = []
    cls = sparse_cholesky.SparseCholesky
    real = {name: getattr(cls, name) for name in ("__init__", "factorize", "solve")}
    real_read = host_loop_graphs.SparseRegions.read_flat

    def timed(name):
        def call(self, *args, **kw):
            t0 = time.perf_counter()
            out = real[name](self, *args, **kw)
            seconds[name] += time.perf_counter() - t0
            if name == "__init__":
                made.append(self)
            return out
        return call

    def read(self, name):
        flat = self._bufs[name][0]
        host_bytes.append(flat.numel() * flat.element_size())
        return real_read(self, name)

    for name in real:
        setattr(cls, name, timed(name))
    host_loop_graphs.SparseRegions.read_flat = read
    try:
        yield dict(seconds=seconds, host_bytes=host_bytes, factors=made)
    finally:
        for name, fn in real.items():
            setattr(cls, name, fn)
        host_loop_graphs.SparseRegions.read_flat = real_read


def _sparse_fields(runs) -> dict:
    """The host factor's fields of _eager_captured_repeat's runs under
    ``_sparse_host_clock``: the symbolic analysis made in the first run
    (nnz of the matrix and of L), each run's numeric and solve seconds and
    their share of the run's seconds, bytes to the host an LM iteration."""
    factor = next((f for r in runs for f in r["clock"]["factors"]), None)
    s0 = runs[0]["clock"]["seconds"]
    out = dict(
        host_symbolic_seconds=s0["__init__"],
        factored_n=None if factor is None else factor.n,
        factored_nnz=None if factor is None else int(factor.Ap[-1]),
        nnz_L=None if factor is None else factor.nnz_L,
        host_numeric_seconds={}, host_solve_seconds={}, host_factor_share={},
        bytes_to_host_per_iteration={}, transfers={},
    )
    for kind, r in zip(HOST_LOOP_RUNS, runs):
        s, n = r["clock"]["seconds"], max(r["summary"].num_iterations, 1)
        out["host_numeric_seconds"][kind] = s["factorize"]
        out["host_solve_seconds"][kind] = s["solve"]
        out["host_factor_share"][kind] = (s["__init__"] + s["factorize"] + s["solve"]) / max(
            r["seconds"], 1e-12)
        out["bytes_to_host_per_iteration"][kind] = sum(r["clock"]["host_bytes"]) / n
        out["transfers"][kind] = len(r["clock"]["host_bytes"])
    return out


# A captured sparse repeat's host reads an LM iteration, at most: an
# accepted step reads the prep's flat buffer, uploads the host's solution,
# reads the model cost change, the candidate's scalars and the new point's
# gradient norms; HOST_LOOP_SETUP_READS more a solve.
SPARSE_MAX_READS_PER_LM_ITERATION = 5


def _sparse_phase(label: str, problem, opts, device, smi: str,
                  reads_per_lm_iteration: int = SPARSE_MAX_READS_PER_LM_ITERATION,
                  **fields) -> list:
    """A sparse solver's host loop on ``problem``: eager, captured, again
    and eager (``_eager_captured_repeat``, which raises unless every run
    gives the first's bits and launches; the host factor clocked), its
    phase line printed. Raises too where the captured repeat reads the host
    more than ``reads_per_lm_iteration`` times an LM iteration plus
    HOST_LOOP_SETUP_READS. Returns the runs."""
    runs = _eager_captured_repeat(label, problem, opts, device, clock=_sparse_host_clock)
    loop = _host_loop_fields(runs, problem, device)
    s = runs[2]["summary"]
    phase("solve", case=label, dtype=opts.evaluation_dtype or "float64",
          initial_cost=s.initial_cost, final_cost=s.final_cost, records=len(s.iterations),
          rejected_steps=s.num_unsuccessful_steps, termination=str(s.termination_type),
          message=s.message, card=smi, max_host_reads_per_lm_iteration=reads_per_lm_iteration,
          **fields, **loop, **_sparse_fields(runs))
    bound = reads_per_lm_iteration * loop["lm_iterations"] + HOST_LOOP_SETUP_READS
    if loop["host_reads"]["repeat"] > bound:
        raise RuntimeError(f"{label}: the captured repeat read the host "
                           f"{loop['host_reads']['repeat']} times (bound {bound})")
    return runs


def solve_pose_graph_sparse(device, smi: str, cgnr_seconds: float) -> dict:
    """The 2500-pose sphere through ctt.solve with SPARSE_NORMAL_CHOLESKY
    (AMD), float64, eager, captured, again and eager (``_sparse_phase``):
    the same bits every run, JAX's record count and final cost within
    1e-9. Its J'J cells reduce through ``index_add_`` (2598 rows into 4998
    blocks, at most two rows a cell: the atomics' order cannot change a
    bit), inside the captured ``sparse_normal_prep`` region."""
    graph = pose_graph.synthesize_sphere(POSE_GRAPH_POSES, seed=POSE_GRAPH_SEED)[:3]
    problem = pose_graph.build_problem_3d(*graph)[0]
    opts = pose_graph.default_options()
    opts.linear_solver_type = ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY
    records, reference = POSE_GRAPH_SPARSE_REFERENCE
    runs = _sparse_phase("pose_graph_sparse_cholesky", problem, opts, device, smi,
                         poses=POSE_GRAPH_POSES, reference_final_cost=reference,
                         reference_records=records, cgnr_solve_seconds=cgnr_seconds)
    plan = problem.program(device).solve_aux_cache["normal_assembly"][0]
    phase("plan", case="pose_graph_sparse_cholesky",
          cell_plan_kinds=sorted({s.plan.kind for s in plan.sites}))
    _held_to_jax(runs[2]["summary"], records, reference, "pose_graph_sparse_cholesky")
    return runs[2]["launches"]


def solve_pose_graph_sparse_dogleg(device, smi: str, mixed: bool = False) -> dict:
    """The 2500-pose sphere through ctt.solve with SPARSE_NORMAL_CHOLESKY
    under DOGLEG (traditional), float64, eager, captured, again and eager
    (``_sparse_phase``): its Gauss-Newton solve as regions around the host
    factor (``dogleg.SparseGaussNewton``: the Cauchy terms and J'J's cells
    read once a point, the step from the host's solution), the same bits
    every run, JAX's record count and final cost within 1e-9. With
    ``mixed``, under ``use_mixed_precision_solves``: the f32 system's cells,
    and each refinement's f64 residual from the ``dogleg_sparse_refine``
    region, one more read an LM iteration per refinement step."""
    graph = pose_graph.synthesize_sphere(POSE_GRAPH_POSES, seed=POSE_GRAPH_SEED)[:3]
    problem = pose_graph.build_problem_3d(*graph)[0]
    opts = pose_graph.default_options()
    opts.linear_solver_type = ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY
    opts.trust_region_strategy_type = ctt.TrustRegionStrategyType.DOGLEG
    opts.use_mixed_precision_solves = mixed
    refinements = max(opts.max_num_refinement_iterations, 1) if mixed else 0
    records, reference = (POSE_GRAPH_SPARSE_DOGLEG_MIXED_REFERENCE if mixed
                          else POSE_GRAPH_SPARSE_DOGLEG_REFERENCE)
    label = "pose_graph_sparse_cholesky_dogleg" + ("_mixed" if mixed else "")
    runs = _sparse_phase(label, problem, opts, device, smi,
                         SPARSE_MAX_READS_PER_LM_ITERATION + refinements, poses=POSE_GRAPH_POSES,
                         reference_final_cost=reference, reference_records=records,
                         refinement_iterations=refinements)
    graphs = {name for g in _host_loop_graph_sets(problem, device) for name in g.graphs}
    regions = {"dogleg_sparse_prep", "dogleg_sparse_finish"} | (
        {"dogleg_sparse_refine"} if mixed else set())
    if not regions <= graphs:
        raise RuntimeError(f"{label}: the Gauss-Newton regions were not captured: {graphs}")
    _held_to_jax(runs[2]["summary"], records, reference, label)
    return runs[2]["launches"]


def _sequential_options(dtype: str, max_iters: int = 50):
    opts = bal.default_options(iterative=False)
    opts.linear_solver_type = ctt.LinearSolverType.SPARSE_SCHUR
    opts.max_num_iterations = max_iters
    opts.evaluation_dtype = dtype
    return opts


def solve_sequential_sparse_schur(device, smi: str) -> dict:
    """The sequential bundle adjustment (sequential_instance) through ctt.solve
    with SPARSE_SCHUR (AMD) in the host loop, float32 and float64, each
    eager, captured, again and eager (``_sparse_phase``): the same bits
    every run, float64 against JAX's record count and cost (1e-9), float32
    within 1e-5 of float64, K1, K3 and K4 launched, each as many times in
    every run."""
    inst = sequential_instance()
    paths, out = {}, {}
    for dtype in ("float32", "float64"):
        problem = bal.build_problem(inst)[0]
        label = f"sequential_ba_sparse_schur_{dtype}"
        runs = _sparse_phase(label, problem, _sequential_options(dtype), device, smi,
                             cameras=inst.num_cameras, points=inst.num_points,
                             observations=inst.num_observations)
        ss_ = problem.program(device).schur_structure
        launches = runs[2]["launches"]
        phase("plan", case=label, nf=int(ss_.f_idx.shape[0]),
              s_cells_nnz=ss_.sparse_assembly.nnz, launches_by_width=_launches_by_width())
        _usable(runs[2]["summary"], label)
        if any(n == 0 for n in launches.values()):
            raise RuntimeError(f"{label}: launches {launches}")
        out[dtype], paths[label] = runs[2]["summary"], launches
        del problem, runs
    _held_to_jax(out["float64"], *SEQUENTIAL_SPARSE_SCHUR_REFERENCE, "sequential_ba_sparse_schur")
    _held_to_f64(out["float32"], out["float64"], "sequential_ba_sparse_schur",
                 SPARSE_F32_RTOL)
    return paths


def _cluster_options(pt: str, dtype: str):
    opts = bal.default_options(iterative=True)
    opts.preconditioner_type = ctt.PreconditionerType[pt]
    opts.evaluation_dtype = dtype
    return opts


def solve_flagship_clusters(device, smi: str) -> dict:
    """The flagship under ITERATIVE_SCHUR with CLUSTER_JACOBI and with
    CLUSTER_TRIDIAGONAL (ctt.solve, the fused loop captured; S assembled,
    nf = 144), float32 and float64: float64 against JAX's LM and CG counts
    and cost (1e-9), float32 within 1e-5 of float64; the clusters and
    chains, the capture's seconds and pool bytes, seconds per LM iteration
    and a repeat solve's host reads."""
    inst = flagship_instance()
    paths = {}
    for pt in ("CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"):
        out = {}
        for dtype in ("float32", "float64"):
            problem = bal.build_problem(inst)[0]
            start = problem.state().copy()
            _reset_launches()
            s = ctt.solve(_cluster_options(pt, dtype), problem, device=device)
            launches = _launches()
            pool = _graph_pool_bytes(problem, device)
            problem.write_back(start)
            repeat, reads = _host_reads(
                lambda: ctt.solve(_cluster_options(pt, dtype), problem, device=device))
            ss_ = problem.program(device).schur_structure
            _usable(s, f"flagship {pt} {dtype}")
            if not (s.captured_loop and repeat.final_cost == s.final_cost):
                raise RuntimeError(f"flagship {pt} {dtype}: not captured, or the repeat "
                                   f"differs ({repeat.final_cost} against {s.final_cost})")
            chains = None if ss_.chain_clusters is None else ss_.chain_clusters.cpu().numpy()
            C = int(ss_.cluster_groups.shape[0])
            phase(
                "solve", case=f"flagship_{pt.lower()}", dtype=dtype,
                initial_cost=s.initial_cost, final_cost=s.final_cost,
                lm_iterations=s.num_iterations, records=len(s.iterations),
                cg_iterations=s.num_linear_solver_iterations,
                termination=str(s.termination_type),
                solve_seconds=s.minimizer_time_in_seconds,
                setup_seconds=s.preprocessor_time_in_seconds,
                captured_loop=s.captured_loop,
                capture_seconds=s.graph_capture_time_in_seconds, graph_pool_bytes=pool,
                seconds_per_lm_iteration={
                    "first": s.minimizer_time_in_seconds / max(s.num_iterations, 1),
                    "repeat": repeat.minimizer_time_in_seconds / max(repeat.num_iterations, 1)},
                clusters=C, cluster_width=int(ss_.cluster_groups.shape[1]),
                chains=None if chains is None else [[int(c) for c in ch if c < C]
                                                    for ch in chains],
                host_reads_of_a_repeat=sum(reads.values()),
                host_reads_per_iteration=sum(reads.values()) / max(repeat.num_iterations, 1),
                launches=launches, card=smi,
            )
            out[dtype], paths[f"flagship_{pt.lower()}_{dtype}"] = s, launches
        records, cg, reference = FLAGSHIP_CLUSTER_REFERENCE[pt]
        s64 = out["float64"]
        _held_to_jax(s64, records, reference, f"flagship_{pt.lower()} float64")
        if s64.num_linear_solver_iterations != cg:
            raise RuntimeError(f"flagship {pt}: {s64.num_linear_solver_iterations} CG "
                               f"iterations (JAX {cg})")
        _held_to_f64(out["float32"], s64, f"flagship_{pt.lower()}", SPARSE_F32_RTOL)
    return paths


def solve_large_cluster_jacobi(device, inst, smi: str) -> dict:
    """The large instance under ITERATIVE_SCHUR + CLUSTER_JACOBI on the
    implicit S (nf = 4176), float32: the loop run eagerly, with the
    preconditioner's builds timed (synchronized) and the peak memory; then
    ``ctt.solve``, which captures the loop with its probes (capture seconds,
    pool bytes, seconds per LM iteration), and a repeat (host reads): the
    three the same final cost to the bit and the same launches, the cost
    within 1e-3 of the JAX f64 cost at the large phase's options; the
    probes' chunks at full width."""
    builds = []
    real = schur_mod.SchurOperator.clustered_preconditioner

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, *args, **kw)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return out

    opts = _cluster_options("CLUSTER_JACOBI", "float32")
    problem = bal.build_problem(inst)[0]
    start = problem.state().copy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    schur_mod.SchurOperator.clustered_preconditioner = timed
    try:
        eager, eager_seconds = eager_loop(problem, opts, device)
    finally:
        schur_mod.SchurOperator.clustered_preconditioner = real
    eager_launches, peak = _launches(), torch.cuda.max_memory_allocated()
    _reset_launches()
    s = ctt.solve(opts, problem, device=device)
    launches = _launches()
    pool = _graph_pool_bytes(problem, device)
    problem.write_back(start)
    repeat, reads = _host_reads(lambda: ctt.solve(opts, problem, device=device))
    rel = _checked(problem, s, LARGE_F64_FINAL_COST, "large iterative cluster jacobi float32")
    _usable(s, "large iterative cluster jacobi float32")
    ss_ = problem.program(device).schur_structure
    groups = ss_.cluster_groups
    probe_chunk = max(1, schur_mod.PROBE_CHUNK_BYTES // (inst.num_observations * 9 * 4))
    lm = max(s.num_iterations, 1)
    phase(
        "solve", case="large_iterative_cluster_jacobi", dtype="float32",
        initial_cost=s.initial_cost, final_cost=s.final_cost,
        reference_final_cost=LARGE_F64_FINAL_COST, rel_err=rel,
        lm_iterations=s.num_iterations, cg_iterations=s.num_linear_solver_iterations,
        termination=str(s.termination_type), solve_seconds=s.minimizer_time_in_seconds,
        setup_seconds=s.preprocessor_time_in_seconds, captured_loop=s.captured_loop,
        capture_seconds=s.graph_capture_time_in_seconds, graph_pool_bytes=pool,
        eager_peak_device_bytes=peak,
        loop_seconds={"eager": eager_seconds, "captured": s.minimizer_time_in_seconds,
                      "captured_repeat": repeat.minimizer_time_in_seconds},
        seconds_per_lm_iteration={"eager": eager_seconds / lm,
                                  "captured": s.minimizer_time_in_seconds / lm,
                                  "captured_repeat": repeat.minimizer_time_in_seconds / lm},
        explicit_s=ss_.explicit is not None, clusters=int(groups.shape[0]),
        cluster_width=int(groups.shape[1]), probe_columns=int(ss_.cluster_slots.shape[0]),
        probe_chunk_columns=probe_chunk, probe_chunk_bytes=schur_mod.PROBE_CHUNK_BYTES,
        preconditioner_build_seconds_eager=builds, launches=launches,
        eager_launches=eager_launches, host_reads_of_a_repeat=sum(reads.values()),
        host_reads_by_site=dict(reads), equal_to_the_bit=(
            eager.final_cost == s.final_cost == repeat.final_cost), card=smi,
    )
    if ss_.explicit is not None or not builds or not s.captured_loop:
        raise RuntimeError("large cluster jacobi: not the implicit S's probes, or not captured")
    if not eager.final_cost == s.final_cost == repeat.final_cost or launches != eager_launches:
        raise RuntimeError(f"large cluster jacobi: eager {eager.final_cost} {eager_launches}, "
                           f"captured {s.final_cost} {launches}, repeat {repeat.final_cost}")
    if sum(reads.values()) > CAPTURED_MAX_HOST_READS:
        raise RuntimeError(f"large cluster jacobi: a repeat read the host {dict(reads)}")
    return launches


# ---- slice 10: covariance, numeric differentiation, the models, TinySolver,
# the C API and interpolation ------------------------------------------------


def covariance_pairs(cams):
    """Every camera's diagonal block and 4 cross pairs, and the 4 named
    blocks the covariance phase checks."""
    C = len(cams)
    cross = [(1, 2), (1, C - 1), (C // 2, C // 2 + 1), (2, C - 1)]
    pairs = [(int(c), int(c)) for c in cams] + [(int(cams[a]), int(cams[b])) for a, b in cross]
    named = {"1,1": (1, 1), "mid,mid": (C // 2, C // 2), "1,2": (1, 2), "1,last": (1, C - 1)}
    return pairs, {k: (int(cams[a]), int(cams[b])) for k, (a, b) in named.items()}


def _fingerprint_err(block, ref: dict) -> float:
    """Largest difference of a block's diagonal, largest |entry|, norm and
    sum from the reference's (tests/test_torch_references.py
    block_fingerprint), relative to the reference's largest |entry|."""
    b = np.asarray(block, dtype=np.float64)
    got = np.concatenate([np.diag(b), [np.max(np.abs(b)), np.linalg.norm(b), np.sum(b)]])
    want = np.concatenate([ref["diag"], [ref["max_abs"], ref["norm"], ref["sum"]]])
    return float(np.max(np.abs(got - want)) / ref["max_abs"])


def solve_covariance_large(device, dtype: str, inst, smi: str) -> dict:
    """Covariance of the large instance at its own values (no solve): camera
    0 and the last point constant, which fixes the 7-dof gauge and leaves
    the point ids sorted; every camera's diagonal block and 4 cross pairs by
    the Schur marginals (S assembled on the card by K1, K3 and K4, inverted
    in f64 on the host), against JAX f64."""
    problem, cams, pts = bal.build_problem(inst)
    problem.set_parameter_block_constant(int(cams[0]))
    problem.set_parameter_block_constant(int(pts[-1]))
    pairs, named = covariance_pairs(cams)
    cov = ctt.Covariance()
    _reset_launches()
    t0 = time.perf_counter()
    if not cov.compute(pairs, problem, device=device, evaluation_dtype=dtype):
        raise RuntimeError(f"covariance large {dtype}: compute() refused")
    seconds = time.perf_counter() - t0
    launches, by_width = _launches(), _launches_by_width()
    if cov._schur_cov is None:
        raise RuntimeError(f"covariance large {dtype}: not the Schur-marginal path")
    trace = float(sum(np.trace(cov.get_covariance_block_in_tangent_space(int(c), int(c)))
                      for c in cams[1:]))
    ref = COVARIANCE_LARGE_REFERENCE
    errs = {k: _fingerprint_err(cov.get_covariance_block_in_tangent_space(*v), ref["blocks"][k])
            for k, v in named.items()}
    trace_rel = abs(trace - ref["trace"]) / ref["trace"]
    rtol = COVARIANCE_RTOL[dtype]
    phase("solve", case="covariance_large", dtype=dtype, nvidia_smi=smi,
          plan=_schur_plans(problem.program(device)), trace=trace, reference_trace=ref["trace"],
          trace_rel_err=trace_rel, block_rel_err=errs, rtol=rtol, seconds=seconds,
          **{k: v for k, v in cov.statistics.items()}, launches=launches,
          launches_by_width=by_width)
    if max(errs.values()) > rtol or trace_rel > rtol:
        raise RuntimeError(f"covariance large {dtype}: blocks {errs}, trace {trace_rel:.3e} "
                           f"above {rtol:g}")
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"covariance large {dtype}: {name} was never launched")
    return launches


def _matrix_free_covariance(problem, pairs, device, captured: bool):
    """``Covariance().compute`` of ``pairs`` with the batched CG captured
    (the card's path) or run eagerly: (the Covariance, seconds, host reads
    by site, launches)."""
    from ceres_tpu_torch import covariance

    real = covariance._captured
    covariance._captured = lambda dev: captured
    try:
        cov = ctt.Covariance()
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok, reads = _host_reads(lambda: cov.compute(pairs, problem, device=device))
        seconds = time.perf_counter() - t0
    finally:
        covariance._captured = real
    if not ok or cov._mf_Z is None:
        raise RuntimeError("covariance matrix-free: refused, or not the matrix-free path")
    return cov, seconds, reads, _launches()


def _sphere_quaternion_pairs(poses: int):
    """(the sphere of ``poses`` poses, the pairs of its quaternion blocks of
    poses 1, poses / 2 and poses - 1: three diagonal blocks and one
    cross block)."""
    problem, _, quat_id = pose_graph.build_problem_3d(
        *pose_graph.synthesize_sphere(poses, seed=POSE_GRAPH_SEED)[:3])
    q = [quat_id[v] for v in (1, poses // 2, poses - 1)]
    return problem, [(q[0], q[0]), (q[1], q[1]), (q[2], q[2]), (q[0], q[2])]


# The matrix-free covariance's eager twin runs on a sphere of this many
# poses, not the 2500-pose one, whose eager CG took 35 s (an NVIDIA H100
# 80GB HBM3 at 700 W), a twentieth of the script: the smallest round count
# whose tangent coordinates (4200) still take the matrix-free path (over
# covariance.DENSE_COVARIANCE_MAX_TANGENT, 4096); 4606 batched CG
# iterations there against 11 731.
COVARIANCE_TWIN_POSES = 700


def solve_covariance_matrix_free(device, smi: str) -> dict:
    """Covariance of the 2500-pose sphere at its own values: 15 000 tangent
    coordinates and no Schur structure, so the requested columns of
    inverse(J'J) are solved by CG, 8 at a time, captured once per compute()
    and replayed per chunk; the quaternion blocks of poses 1, 1250 and 2499
    in ambient space against JAX f64; the same computation on the
    COVARIANCE_TWIN_POSES sphere with the CG run eagerly and captured, equal
    to the bit; host reads per chunk and seconds per CG iteration of
    each."""
    # the twin eager first: the program's set-up is the eager computation's,
    # and its captured twin reads only what a compute() of a set-up program
    # reads
    twin_problem, twin_pairs = _sphere_quaternion_pairs(COVARIANCE_TWIN_POSES)
    eager, eager_seconds, eager_reads, _ = _matrix_free_covariance(
        twin_problem, twin_pairs, device, False)
    twin, twin_seconds, twin_reads, _ = _matrix_free_covariance(
        twin_problem, twin_pairs, device, True)
    problem, pairs = _sphere_quaternion_pairs(POSE_GRAPH_POSES)
    cov, seconds, reads, launches = _matrix_free_covariance(problem, pairs, device, True)
    ref = COVARIANCE_MATRIX_FREE_REFERENCE
    errs = [_fingerprint_err(cov.get_covariance_block(*pair), r)
            for pair, r in zip(pairs, ref["blocks"])]
    iterations = cov.statistics["cg_iterations"]
    moved = [abs(a - b) / b for a, b in zip(iterations, ref["cg_iterations"])]
    chunks = -(-len(iterations) // 8)

    def batch_iterations(its):
        # the batched loop runs as long as its longest column, chunk by chunk
        return sum(max(its[c * 8:(c + 1) * 8]) for c in range(-(-len(its) // 8)))

    twin_iterations = twin.statistics["cg_iterations"]
    equal = (np.array_equal(twin._mf_Z, eager._mf_Z)
             and twin_iterations == eager.statistics["cg_iterations"])
    twin_chunks = -(-len(twin_iterations) // 8)
    phase("solve", case="covariance_pose_graph_matrix_free", dtype="float64", nvidia_smi=smi,
          block_rel_err=errs, rtol=COVARIANCE_MATRIX_FREE_RTOL, cg_iterations=iterations,
          reference_cg_iterations=ref["cg_iterations"], cg_iterations_rel=moved,
          chunks=chunks, seconds=seconds, host_reads=sum(reads.values()),
          host_reads_by_site=dict(reads), cg_seconds=cov.statistics["cg_seconds"],
          seconds_per_cg_iteration=cov.statistics["cg_seconds"] / batch_iterations(iterations),
          twin=dict(poses=COVARIANCE_TWIN_POSES, cg_iterations=twin_iterations,
                    seconds={"captured": twin_seconds, "eager": eager_seconds},
                    host_reads_per_chunk={"captured": sum(twin_reads.values()) / twin_chunks,
                                          "eager": sum(eager_reads.values()) / twin_chunks},
                    host_reads_by_site={"captured": dict(twin_reads),
                                        "eager": dict(eager_reads.most_common(4))},
                    seconds_per_cg_iteration={
                        k: c.statistics["cg_seconds"] / batch_iterations(twin_iterations)
                        for k, c in (("captured", twin), ("eager", eager))}),
          captured_equal_to_eager_to_the_bit=equal,
          **{k: v for k, v in cov.statistics.items() if k not in ("cg_iterations", "cg_seconds")},
          launches=launches)
    if max(errs) > COVARIANCE_MATRIX_FREE_RTOL or max(moved) > CG_ITERATIONS_RTOL:
        raise RuntimeError(f"covariance matrix-free: blocks {errs}, CG iterations {iterations} "
                           f"against JAX {ref['cg_iterations']}")
    if not equal:
        raise RuntimeError(f"covariance matrix-free: captured and eager differ: CG iterations "
                           f"{twin_iterations} against {eager.statistics['cg_iterations']}")
    return launches


def numeric_bal(inst, method: str):
    """The BAL problem with the Snavely residual under numeric_diff."""
    p = ctt.Problem()
    cams = p.add_parameter_blocks(inst.cameras)
    pts = p.add_parameter_blocks(inst.points)
    order = np.argsort(inst.point_index, kind="stable")
    p.add_residual_blocks(
        ctt.numeric_diff(bal.snavely_reprojection_residual, method), None,
        [cams[inst.camera_index[order]], pts[inst.point_index[order]]],
        data=inst.observations[order])
    return p


def _records(summary) -> list:
    return [(r.cost, r.linear_solver_iterations) for r in summary.iterations]


def _held_to_records(summary, reference, rtol: float, label: str) -> float:
    """The same record count and CG iterations as the reference, every
    record's cost within rtol; returns the largest relative difference."""
    records, ref = _records(summary), reference[0]
    if len(records) != len(ref) or [r[1] for r in records] != [r[1] for r in ref]:
        raise RuntimeError(f"{label}: records {records} against JAX {ref}")
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(records, ref))
    if rel > rtol or summary.termination_type.name != reference[2]:
        raise RuntimeError(f"{label}: costs {rel:.3e} from JAX's (rtol {rtol:g}), "
                           f"{summary.termination_type.name} against {reference[2]}")
    return rel


def _held_to_costs(summary, reference, rtol: float, final_rtol: float, label: str) -> float:
    """The same record count as the reference, every record's cost within
    rtol and the final cost within final_rtol (the CG iterations may
    differ); returns the largest relative difference of the records."""
    records, ref = _records(summary), reference[0]
    if len(records) != len(ref) or summary.termination_type.name != reference[2]:
        raise RuntimeError(f"{label}: records {records} against JAX {ref}")
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(records, ref))
    final = abs(summary.final_cost - reference[1]) / reference[1]
    if rel > rtol or final > final_rtol:
        raise RuntimeError(f"{label}: costs {rel:.3e} (rtol {rtol:g}), final {final:.3e} "
                           f"(rtol {final_rtol:g}) from JAX's")
    return rel


def _held_to_spread(summary, reference, spread, label: str) -> float:
    """The records the reference and the summary share and the final cost
    within ten times the reference's own one-ulp spread (records, final),
    the same termination; the record count is printed, not held. Returns
    the largest relative difference of the shared records."""
    records, ref = _records(summary), reference[0]
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(records, ref))
    final = abs(summary.final_cost - reference[1]) / reference[1]
    if (rel > 10 * spread[0] or final > 10 * spread[1]
            or summary.termination_type.name != reference[2]):
        raise RuntimeError(f"{label}: records {rel:.3e}, final {final:.3e} from JAX's "
                           f"(ten times its own spread {spread}), {summary.termination_type.name}")
    return rel


def solve_numeric_diff_flagship(device, smi: str) -> dict:
    """The flagship at bal.default_options(iterative=True) with its residual
    under numeric_diff: CENTRAL to convergence and RIDDERS for 3 iterations,
    float64, record by record against JAX f64."""
    inst, paths = flagship_instance(), {}
    for method, iters in (("CENTRAL", 50), ("RIDDERS", 3)):
        opts = bal.default_options(iterative=True)
        opts.max_num_iterations = iters
        problem = numeric_bal(inst, method)
        _reset_launches()
        t0 = time.perf_counter()
        s = ctt.solve(opts, problem, device=device)
        seconds = time.perf_counter() - t0
        paths[f"numeric_diff_flagship_{method.lower()}_float64"] = _launches()
        rel = _held_to_records(s, NUMERIC_DIFF_REFERENCE[method], NUMERIC_DIFF_RTOL,
                               f"numeric diff {method}")
        phase("solve", case="numeric_diff_flagship", method=method, dtype="float64",
              nvidia_smi=smi, records=len(s.iterations), final_cost=s.final_cost,
              reference_final_cost=NUMERIC_DIFF_REFERENCE[method][1], records_rel_err=rel,
              termination=s.termination_type.name, seconds=seconds,
              seconds_per_lm_iteration=s.minimizer_time_in_seconds / max(s.num_iterations, 1),
              launches=paths[f"numeric_diff_flagship_{method.lower()}_float64"])
    return paths


def solve_denoising(device, smi: str) -> dict:
    """Fields-of-Experts denoising of a 481 x 321 image (the size of a
    BSDS500 image), 24 experts of 5 x 5, written to files and loaded by the
    model, at default_options() (CGNR + JACOBI) for 10 iterations: float64
    against JAX f64, float32 against float64; K1 launches per CG iteration.
    Before them, a 1-iteration solve (the set-up: the program every solve
    uses and the loop's capture), then one under torch.profiler: the device
    operations per CG iteration and the idle share."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        noisy_path, foe_path = write_denoising_inputs(d)
        noisy, foe = denoising.read_pgm(noisy_path), denoising.load_foe_file(foe_path)
    out, paths = {}, {}
    t0 = time.perf_counter()
    problem, _ = denoising.build_problem(noisy, foe, sigma=DENOISING["sigma"])
    build_seconds = time.perf_counter() - t0
    x0 = problem.state()

    def run(dtype, iters):
        """A solve from the noisy image, on the problem built once (its
        program and plans serve every solve; the state is reset)."""
        problem.write_back(x0)
        opts = denoising.default_options()
        opts.max_num_iterations = iters
        opts.evaluation_dtype = dtype
        return ctt.solve(opts, problem, device=device)

    run("float64", 1)  # set-up: the program, its plans and the loop's capture
    summary, busy, ops, top = _device_profile(lambda: run("float64", 1))
    one = summary.iterations[1].linear_solver_iterations
    loop = summary.minimizer_time_in_seconds
    profiled = dict(dtype="float64", cg_iterations=one, loop_seconds=loop,
                    device_busy_seconds=busy, idle_share=1.0 - busy / loop, device_operations=ops,
                    device_operations_per_cg_iteration=ops / max(one, 1),
                    top_kernels=[(name[:120], sec) for name, sec in top[:5]])
    for dtype in ("float64", "float32"):
        _reset_launches()
        t0 = time.perf_counter()
        s = run(dtype, DENOISING_ITERATIONS)
        seconds = time.perf_counter() - t0
        launches, by_width = _launches(), _launches_by_width()
        paths[f"denoising_foe_{dtype}"] = launches
        cg = s.num_linear_solver_iterations
        if dtype == "float64":
            rel = _held_to_records(s, DENOISING_REFERENCE, DENOISING_RTOL, "denoising float64")
        else:
            rel = abs(s.final_cost - out["float64"].final_cost) / out["float64"].final_cost
            if rel > DENOISING_F32_RTOL:
                raise RuntimeError(f"denoising float32: {s.final_cost} against float64 "
                                   f"{out['float64'].final_cost}")
        out[dtype] = s
        phase("solve", case="denoising_foe", dtype=dtype, nvidia_smi=smi,
              pixels=noisy.size, families=1 + foe.num_filters,
              records=len(s.iterations), final_cost=s.final_cost,
              reference_final_cost=DENOISING_REFERENCE[1], rel_err=rel,
              termination=s.termination_type.name, cg_iterations=cg, seconds=seconds,
              build_problem_seconds=build_seconds, setup_seconds=s.preprocessor_time_in_seconds,
              seconds_per_lm_iteration=s.minimizer_time_in_seconds / max(s.num_iterations, 1),
              k1_launches_per_cg_iteration=launches["sorted_segment_sum"] / max(cg, 1),
              launches=launches, launches_by_width=by_width,
              **(dict(profiled_lm_iteration=profiled) if dtype == "float64" else {}))
        if launches["sorted_segment_sum"] == 0:
            raise RuntimeError(f"denoising {dtype}: K1 was never launched")
    return paths


def solve_libmv(device, smi: str) -> dict:
    """A libmv shot the size of a Blender camera solve (300 frames, 2000
    tracks, 100 000 markers in frame order), written to a .bin and loaded,
    at default_options() (ITERATIVE_SCHUR + SCHUR_JACOBI) with the
    intrinsics fixed and refined, float64, against JAX f64."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        markers = write_libmv_shot(f"{d}/shot.bin")
        shot = libmv.load_libmv_file(f"{d}/shot.bin")
    paths = {}
    for variant in (False, True, "gauge_fixed"):
        label = {False: "libmv_fixed_intrinsics_float64", True: "libmv_refined_intrinsics_float64",
                 "gauge_fixed": "libmv_refined_gauge_fixed_float64"}[variant]
        problem = libmv_problem(libmv, shot, variant)
        _reset_launches()
        t0 = time.perf_counter()
        s = ctt.solve(libmv.default_options(), problem, device=device)
        seconds = time.perf_counter() - t0
        paths[label] = _launches()
        if variant == "gauge_fixed":
            reference = LIBMV_GAUGE_FIXED_REFERENCE
            rel = _held_to_spread(s, reference, LIBMV_GAUGE_FIXED_SPREAD, label)
        elif variant:
            reference = LIBMV_REFERENCE[True]
            rel = _held_to_costs(s, reference, LIBMV_RTOL[True], LIBMV_REFINED_FINAL_RTOL, label)
        else:
            reference = LIBMV_REFERENCE[False]
            rel = _held_to_records(s, reference, LIBMV_RTOL[False], label)
        phase("solve", case=label, nvidia_smi=smi, markers=markers,
              plan=_schur_plans(problem.program(device)),
              camera_plans=[p.kind for p in problem.program(device).families[0].reduce_plans],
              records=len(s.iterations), final_cost=s.final_cost,
              reference_final_cost=reference[1], records_rel_err=rel,
              termination=s.termination_type.name, cg_iterations_by_record=[
                  r.linear_solver_iterations for r in s.iterations],
              reference_cg_iterations_by_record=[r[1] for r in reference[0]], seconds=seconds,
              setup_seconds=s.preprocessor_time_in_seconds,
              seconds_per_lm_iteration=s.minimizer_time_in_seconds / max(s.num_iterations, 1),
              launches=paths[label], launches_by_width=_launches_by_width())
        if paths[label]["unsorted_segment_sum"] == 0:
            raise RuntimeError(f"{label}: K3 was never launched")
    return paths


def solve_nist(device, smi: str) -> dict:
    """run_suite over three NIST models written as .dat files (Misra1a,
    Thurber, BoxBOD, two starts each), float64, against JAX f64: the final
    costs and LREs; the record counts and terminations are printed beside
    JAX's, not held to them (the stop is decided by rounding: tolerances of
    1e-18)."""
    import tempfile

    _reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        write_nist_files(d)
        results = nist.run_suite(d, device=device)
    seconds = time.perf_counter() - t0
    got = [(r["name"], r["start"], r["lre"], r["final_cost"], r["iterations"], r["termination"])
           for r in results]
    cost_rel = [abs(a[3] - b[3]) / b[3] for a, b in zip(got, NIST_REFERENCE)]
    lre_abs = [abs(a[2] - b[2]) for a, b in zip(got, NIST_REFERENCE)]
    phase("solve", case="nist", dtype="float64", nvidia_smi=smi, results=got,
          reference=NIST_REFERENCE, cost_rel_err=cost_rel, lre_abs_err=lre_abs,
          seconds=seconds, launches=_launches())
    if ([a[:2] for a in got] != [tuple(b[:2]) for b in NIST_REFERENCE]
            or max(cost_rel) > NIST_COST_RTOL or max(lre_abs) > NIST_LRE_ATOL):
        raise RuntimeError(f"nist: {got} against JAX {NIST_REFERENCE}")
    return _launches()


def tiny_checksums(x, iterations, status) -> dict:
    """What the TinySolver phase holds to JAX's: exact integer sums that see
    every lane's iterations and status, and the sums of x and x^2 per
    coordinate."""
    lane = np.arange(iterations.shape[0], dtype=np.int64)
    return dict(
        iterations=int(iterations.sum()),
        iterations_by_lane=int(np.dot(iterations.astype(np.int64), lane)),
        status_counts=np.bincount(status, minlength=4).tolist(),
        status_by_lane=int(np.dot(status.astype(np.int64), lane)),
        x_sum=np.sum(x, axis=0).tolist(), x_sq_sum=np.sum(x * x, axis=0).tolist(),
    )


def solve_tiny(device, smi: str) -> dict:
    """65 536 small problems in one batched tiny_solve on the card, float64:
    every lane's iterations and status (exact sums weighted by lane) and
    the sums of x and x^2 against JAX's vmap(tiny_solve). The first call
    captures the solve (its seconds printed), the repeat replays it (its
    seconds and host reads printed); both equal to the same loop run
    eagerly, to the bit."""
    from ceres_tpu_torch import tiny_solver

    x0, y = tiny_batch()
    fn = tiny_residual(y, device)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = ctt.tiny_solve(fn, x0, device=device)
    torch.cuda.synchronize()
    first_seconds = time.perf_counter() - t0
    x_dev = torch.as_tensor(x0).to(device)
    loop = tiny_solver.tiny_loop(fn, x_dev, 50, 1e-10, 1e-8, float(np.finfo(np.float64).eps))
    t0 = time.perf_counter()
    r, reads = _host_reads(lambda: ctt.tiny_solve(fn, x0, device=device))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    eager = tiny_solver._TinyLoop(fn, x_dev, *loop.options, captured=False).run(x_dev)
    equal = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(r, first, eager))
    got = tiny_checksums(r.x.cpu().numpy(), r.iterations.cpu().numpy(), r.converged.cpu().numpy())
    ref = TINY_REFERENCE
    exact = {k: got[k] == ref[k] for k in ("iterations", "iterations_by_lane", "status_counts",
                                            "status_by_lane")}
    x_rel = max(abs(a - b) / max(abs(b), 1.0) for k in ("x_sum", "x_sq_sum")
                for a, b in zip(got[k], ref[k]))
    phase("solve", case="tiny_solver_batch", dtype="float64", nvidia_smi=smi,
          problems=x0.shape[0], checksums=got, exact=exact, x_rel_err=x_rel,
          first_call_seconds=first_seconds, capture_seconds=loop.capture_seconds,
          seconds=seconds, max_iterations=int(r.iterations.max()),
          host_reads=sum(reads.values()), host_reads_by_site=dict(reads),
          captured=loop.graph is not None, equal_to_the_eager_loop_to_the_bit=equal,
          launches=_launches())
    if not all(exact.values()) or x_rel > TINY_X_RTOL:
        raise RuntimeError(f"tiny solver: {got} against JAX {ref}")
    if loop.graph is None or not equal:
        raise RuntimeError("tiny solver: not captured, or the captured and eager solves differ")
    return _launches()


def solve_c_api(device, smi: str) -> dict:
    """The C API's curve fit y = exp(m x + c): 67 residual blocks through
    ceres_problem_add_residual_block with a numpy callback and a Cauchy
    stock loss, then ceres_solve on the card: the caller's arrays written
    back, the final cost against JAX's."""
    from ceres_tpu_torch import c_api

    _reset_launches()
    t0 = time.perf_counter()
    m, c, s, text = curve_fit_c_api(c_api, device=device)
    seconds = time.perf_counter() - t0
    ref_m, ref_c, ref_cost, ref_records, _ = C_API_REFERENCE
    rel = abs(s.final_cost - ref_cost) / ref_cost
    written = bool(m[0] != 0.0 and c[0] != 0.0)
    phase("solve", case="c_api", dtype="float64", nvidia_smi=smi, m=float(m[0]), c=float(c[0]),
          reference_m=ref_m, reference_c=ref_c, arrays_written_back=written,
          records=len(s.iterations), reference_records=ref_records, final_cost=s.final_cost,
          reference_final_cost=ref_cost, rel_err=rel, report_printed="Solver Summary" in text,
          seconds=seconds, launches=_launches())
    if (not written or rel > C_API_RTOL or len(s.iterations) != ref_records
            or abs(m[0] - ref_m) > C_API_RTOL * abs(ref_m) or "Solver Summary" not in text):
        raise RuntimeError(f"c api: m {m}, c {c}, cost {s.final_cost} against JAX {C_API_REFERENCE}")
    return _launches()


def solve_interpolation(device, smi: str) -> dict:
    """examples/bicubic_interpolation.py's translation recovery on a 512 x
    512 grid with 65 536 samples, default SolverOptions, float64, record by
    record against JAX f64."""
    values, pts, vals = interpolation_instance()
    interp = ctt.BiCubicInterpolator(ctt.Grid2D(values, row_begin=-2, col_begin=-2))

    def residual(shift, data):
        q, v = data
        f = torch.func.vmap(lambda a: interp.evaluate(a[0:1] + shift[0:1], a[1:2] + shift[1:2])[0])
        return f(q).reshape(-1) - v

    problem = ctt.Problem()
    b = problem.add_parameter_block(np.zeros(2))
    problem.add_residual_block(residual, None, [b], data=(pts, vals))
    _reset_launches()
    t0 = time.perf_counter()
    s = ctt.solve(ctt.SolverOptions(max_num_iterations=50), problem, device=device)
    seconds = time.perf_counter() - t0
    shift = problem.parameter_block_value(b)
    ref = INTERPOLATION_REFERENCE
    rel = _held_to_records(s, (ref[0], ref[1], ref[3]), INTERPOLATION_RTOL, "interpolation")
    shift_err = float(np.max(np.abs(shift - np.asarray(ref[2]))))
    phase("solve", case="interpolation", dtype="float64", nvidia_smi=smi, shift=shift.tolist(),
          reference_shift=ref[2], true_shift=list(INTERPOLATION["shift"]), shift_abs_err=shift_err,
          records=len(s.iterations), records_rel_err=rel, final_cost=s.final_cost,
          termination=s.termination_type.name, seconds=seconds, launches=_launches())
    if shift_err > INTERPOLATION_SHIFT_ATOL:
        raise RuntimeError(f"interpolation: shift {shift} against JAX {ref[2]}")
    return _launches()


def solve_examples(device, smi: str) -> dict:
    """Every program of ceres_tpu_torch/examples/ once through its main on
    the card (EXAMPLES, EXAMPLE_CUTS), against the JAX package's f64
    results: per program its seconds, solves, records, final cost, relative
    error and K1 / K3 / K4 launches."""
    import importlib
    import tempfile

    paths, total = {}, 0.0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_example_inputs(d)
        phase("examples_inputs", seconds=time.perf_counter() - t0,
              cuts=EXAMPLE_CUTS, m3500=M3500, libmv=LIBMV, denoising=DENOISING,
              nist=list(NIST_MODELS))
        for name, argv in EXAMPLES:
            module = importlib.import_module(f"ceres_tpu_torch.examples.{name}")
            argv = example_argv(argv, d) + ["--device", str(device)]
            text = io.StringIO()
            _reset_launches()
            t0 = time.perf_counter()
            with recording_solves(ctt, nist) as (summaries, suites), \
                    contextlib.redirect_stdout(text):
                module.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            total += seconds
            launches = paths[f"examples_{name}"] = _launches()
            got = example_result(summaries, suites)
            rel = held_to_example(name, got, EXAMPLES_REFERENCE[name])
            lines = text.getvalue().splitlines()
            phase("solve", case="examples", program=name, nvidia_smi=smi, argv=argv,
                  cut=EXAMPLE_CUTS.get(name), seconds=seconds, solves=len(got),
                  records=[g[0] for g in got] if name != "nist" else None,
                  final_costs=[g[3] if name == "nist" else g[1] for g in got],
                  rel_err=rel, launches=launches, output_lines=len(lines),
                  last_line=lines[-1][:200] if lines else "")
            missing = [k for k in EXAMPLE_KERNELS.get(name, ()) if launches[k] == 0]
            if missing:
                raise RuntimeError(f"example {name}: {missing} never launched")
    phase("examples", programs=len(EXAMPLES), seconds=total, cuts=sorted(EXAMPLE_CUTS))
    return paths


def main() -> int:
    t0 = time.perf_counter()
    smi = check_device()
    device = torch.device("cuda", 0)
    build_kernels()
    plans = PlanLog().install()
    records = check_kernels(device)
    paths, single = {}, {}
    for dtype in ("float32", "float64"):
        paths[f"flagship_{dtype}"], single["flagship", dtype] = solve_flagship(device, dtype)
    inst = large_instance()
    launches, by_width, single["large", "float32"] = solve_large(device, "float32", inst)
    paths["large_float32"] = launches
    paths["large_float64"], _, single["large", "float64"] = solve_large(device, "float64", inst)
    paths.update(solve_captured_loop(device, inst, smi))
    paths.update(solve_sharded(single, paths, smi, plans))
    r32, paths["robust_large_float32"] = solve_robust_large(device, "float32", inst)
    r64, paths["robust_large_float64"] = solve_robust_large(device, "float64", inst)
    rel = abs(r32.final_cost - r64.final_cost) / r64.final_cost
    phase("compare", case="robust_large", float32_vs_float64_rel=rel)
    if rel > COST_RTOL:
        raise RuntimeError(f"robust large: float32 {r32.final_cost} vs float64 {r64.final_cost}")
    i32, paths["large_iterative_float32"], iter_by_width = solve_large_iterative(
        device, "float32", inst
    )
    i64, paths["large_iterative_float64"], _ = solve_large_iterative(device, "float64", inst)
    rel = abs(i32.final_cost - i64.final_cost) / i64.final_cost
    phase("compare", case="large_iterative", float32_vs_float64_rel=rel)
    if rel > LARGE_ITERATIVE_F32_RTOL:
        raise RuntimeError(f"large iterative: float32 {i32.final_cost} vs float64 {i64.final_cost}")
    del inst
    paths["robust_flagship_float64"] = solve_robust_flagship(device)
    paths.update(solve_flagship_preconditioners(device))
    paths["pose_graph_3d_float64"], cgnr_seconds = solve_pose_graph(device)
    paths["pose_graph_repeat_float64"] = solve_pose_graph_twice(device)
    solve_dense(device)
    inst = large_instance()
    for dtype in ("float32", "float64"):
        paths[f"host_loop_large_{dtype}"] = solve_host_loop_large(device, dtype, inst, smi)
    paths.update(solve_host_loop_progress(device, smi))
    paths.update(solve_dogleg_large(device, inst, smi))
    paths.update(solve_inner_iterations_large(device, inst, smi))
    paths.update(solve_inner_iterations_flagship(device, smi))
    paths["large_iterative_cluster_jacobi_float32"] = solve_large_cluster_jacobi(
        device, inst, smi)
    for dtype in ("float64", "float32"):
        paths[f"covariance_large_{dtype}"] = solve_covariance_large(device, dtype, inst, smi)
    del inst
    paths.update(solve_flagship_host_loop(device, smi))
    paths["flagship_line_search_float64"] = solve_flagship_line_search(device, smi)
    solve_gradient_problems(device, smi)
    paths["check_gradients_flagship_float64"] = solve_check_gradients(device, smi)
    paths["pose_graph_sparse_cholesky_float64"] = solve_pose_graph_sparse(
        device, smi, cgnr_seconds)
    paths["pose_graph_sparse_cholesky_dogleg_float64"] = solve_pose_graph_sparse_dogleg(
        device, smi)
    paths["pose_graph_sparse_cholesky_dogleg_mixed_float64"] = solve_pose_graph_sparse_dogleg(
        device, smi, mixed=True)
    paths.update(solve_sequential_sparse_schur(device, smi))
    paths.update(solve_flagship_clusters(device, smi))
    paths["covariance_pose_graph_matrix_free_float64"] = solve_covariance_matrix_free(device, smi)
    paths.update(solve_numeric_diff_flagship(device, smi))
    paths.update(solve_denoising(device, smi))
    paths.update(solve_libmv(device, smi))
    paths["nist_float64"] = solve_nist(device, smi)
    paths["tiny_solver_batch_float64"] = solve_tiny(device, smi)
    paths["c_api_float64"] = solve_c_api(device, smi)
    paths["interpolation_float64"] = solve_interpolation(device, smi)
    paths.update(solve_examples(device, smi))
    plans.uninstall()
    plans.check()
    for record in records:
        record["launches"] = launches[record["name"]]
        record["launches_by_path"] = {k: v[record["name"]] for k, v in paths.items()}
        if record["name"] in by_width:
            record["launches_by_width"] = by_width[record["name"]]
            record["launches_by_width_large_iterative_float32"] = iter_by_width[record["name"]]
    phase("elapsed", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
