#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mac_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line), each with
its wall time printed:
  1. require CUDA; print the card (nvidia-smi name and power limit) and the
     TF32 flags;
  2. build the hand-written CUDA kernels from mac_tpu_torch/csrc with nvcc,
     one nvcc process per source, all started together; print K4's
     registers, stack frame and spills for each instantiation (ptxas's
     report, kept beside the library, so a library built by an earlier run
     is held to the same gate), and fail unless its m = 4 and m = 12
     instantiations, float32 and float64, have a 0-byte stack frame and no
     spills; the same gate for K4w's shared-memory form (both types) and
     for ldl.cu's kernels that hold rows in registers (K3 up to 4096 rows,
     K3b's chain), both types;
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes, and time it:
       tridiag_solve (K1) on city10000's chain factor (n = 10000, q = 4),
       on sphere2500's exact chain factor (n = 2500), on an exact factor
       (n = 4000), on an exact factor at (33000, 40),
       too large for the cluster's shared memory (the tiled branch, two
       passes of columns), and at (5000, 200), wider than one launch's 128
       columns, rtol/atol 2e-4 (the JAX package's tolerance for its own
       kernel);
       assemble_ut (K2/K2b) on city10000's split tables, on sphere2500's
       tables (no split), on a small graph without a split and on a half-4
       band whose slot rows hold duplicate edges, bitwise equal; also timed: the same scatter as one
       index_add_ into a zeroed ut (the library yardstick);
       the lane forms of phase 8's sweeps, timed too: K1 on city10000's
       chain factors of its 8 budget lanes (8, 10000, 4), a factor per
       lane, at 2e-4; K2b on city10000's tables at those 8 lanes and K2 on
       sphere2500's at 2 lanes, bitwise (the yardstick one index_add_ into
       a zeroed (R, ...) ut);
     a kernel's time is its device time (device_ms: 100 calls behind a
     spin kernel), with the time of one call and its host work beside it
     (call_ms); the plain versions are timed by call_ms;
  3c. tridiag_solve_blocked (K1b) at rtol/atol 2e-4 on the two-grid chain
     factor of the n = 100000 graph of phase 5 at its start weights
     (q = 4), on blocked factors at n = 40000 (q = 8 and 32, ragged), on a
     factor decoupled every 128 rows, and on an exact factor whose
     couplings at the 1024-row boundaries are non-zero (the kernel and its
     plain version both force them to 0); then the kernel's other
     branches: q = 1, 3, 5 (scalar loads), q = 40 and 130 (many column
     groups), segments of 128 and 256 rows passed explicitly, n = 1 and
     n = 1025 (a last segment of one row), and a right-hand side 4 bytes
     off a 16-byte boundary; timed at (100000, 4); its lane form at (2,
     100000, 4) on the chain factors of phase 8b's two budget lanes,
     checked and timed;
  3d. the chain factor's kernels: tridiag_ldl_blocked (K3b) bitwise equal
     to its plain version on city10000's chain at its start weights (n
     10000, block 128, as banded.chain_factor hands it over), the n =
     100000 two-grid chain (block 1024), a chain of 100003 rows (a partial
     last segment), city10000's 8 budget lanes and phase 8b's 2, one, two
     and 17 rows, a segment shorter than its block, segments that end
     inside a ring slot (block 100 and 33, the last of 125 segments
     ragged) and one chain shared by 3 lanes (lane stride 0), in float32
     and float64; tridiag_ldl (K3) on sphere2500's chain, n = 32768 and
     40000, city10000's 8 lanes, one, two and 17 rows, and 4096 and 4097
     (the largest chain it keeps in registers, the smallest it stages),
     within one ulp of its plain doubling scan in float32 and, in float64,
     within 1e-13 relative of an extended-precision referee
     (pivot_referee) and of the plain scan within that plus the scan's own
     distance from the referee; K3's range (scaled_factor_check): the
     float64 sphere2500 chain and 4097 rows scaled by 2^400 and 2^-400,
     K3 within the referee and the unscaled factor scaled alike bit for
     bit, K3b bitwise; tridiag_solve(d, e, B) at n = 40000
     through one K3 launch; the chain probe (ldl_step_ns: one step of
     K3b's pivot chain and of K3's carry, alone on one thread) and each
     kernel's phases (ldl_phases: clock64() stamps of its first block)
     at the main paths' shapes; each kernel timed (device, call, plain
     call, and its bound: the chain bound, the steps of the shortest
     dependent chain that its method needs times the probe's step, with
     the kernel's own chain and the byte / operation bound beside it);
  3e. sym_eig (K4) on TRACEMIN's Rayleigh-Ritz matrices of city10000's
     tables at its start weights (the 4 x 4 of the entry, the 12 x 12 of an
     outer iteration, float32 and float64 coefficients), a batch of them,
     the lanes' batches (8 and 64 such 12 x 12, perturbed), random
     symmetric matrices of every k from 1 to 32 (every instantiation of
     the kernel, even and odd k) and a batch of 67 (a partial last block):
     eigenvalues within 2 k eps ||H|| of its plain Jacobi's and of
     torch.linalg.eigh's, residual and orthogonality within 2 k eps,
     ascending, each vector's largest entry positive; k 33, float16 and a
     non-contiguous matrix raise; timed at the four main-path shapes and
     the lanes' (8, 12, 12) float32 (phase 8a) and (64, 12, 12) float64
     (phase 7c): device, call, plain call, torch.linalg.eigh's device
     time (torch.profiler, the sum of its kernels) and call time, and
     the bound: the larger of the chain bound (the rounds this H takes
     times one round of the irreducible chain, timed by syev.cu's
     one-warp probe, k4_round_ms) and the byte / operation bound; also
     K4's launch floor (a 1 x 1 matrix). K4w, the two-block cluster
     body past order 32, through the same checks: TRACEMIN's 11 x 11 and
     33 x 33 (q = 11) and 36 x 36 (q = 12) matrices at city10000's start
     weights, the lanes' (2, 36, 36), random matrices of every k from 33
     to 64 and of k 96, 120 and 170, and float32 180 and float64 130,
     which must take the workspace form; each call counted under the
     body body_for names; the shared-memory and workspace forms bitwise
     equal (body=
     "wide_workspace" forces the workspace), K4w forced onto the warp
     body's inputs compared with it bit for bit (printed), syev.cu's
     workspace and shared-memory bytes and threads against the wrapper's;
     the warp body at k 33 and K4w in shared memory at float64 130
     refused; K4w's round with its two block barriers timed by syev.cu's
     block probe; timed at (33, 33) both types, (96, 96) both types and
     the lanes' (2, 36, 36); its round by phase from its stamped build
     (k4w_phases: the pushers' reads and the next round's parameters,
     the 2 x 2 blocks, the barrier waits, the waits for a free slot, the
     stop test, the V block's waits, rotations and tail) at (33, 33) and
     (96, 96) in both types;
  3f. TRACEMIN's inner CG step's kernels against their plain versions
     (cg_kernels): K5 banded_product (the inner form with its dots at
     city10000's (10000, 4) and the q = 11 CG step's (10000, 11), the
     residual and plain forms, (10000, 12) and the q = 11 outer
     iteration's (10000, 33), the coarse assembly's (10000, 500) in
     float32 and float64, sphere2500's (2500, 4), 8 lanes, float64;
     library: torch.sparse.mm of L(w) as BSR), K6 (col_sums,
     cg_update, cg_direction_dots; float32, float64, 8 lanes, and the
     first step's form; col_sums bitwise its order's numpy model,
     block_sum_model, and the fused pass's dots bitwise col_sums; library
     for the sums: torch.linalg.vecdot), K1p tridiag_solve_permuted in both
     bodies (k1p_cases: the segment body on city10000's factor, decoupled
     every 128 rows, bitwise K1b at block 128 on the gathered, centred
     input, at (10000, 4) in both forms, float32 and float64, 8 lanes, and
     at (100000, 4); its add form's column sums bitwise their order's
     numpy model; the cluster body, bitwise K1 on it, on sphere2500's
     exact factor in both forms and at (32768, 16) float64, its tiled
     branch) and K7 coarse_correct (k7_cases: city10000's (10000, 4) in
     float32, float64 and 8 lanes, sphere2500's); the matrix-free route's
     K8 ell_product (k8_cases, on the n = 100000 expander's slot-major
     tables at its start weights: (100000, 4) in the inner form with its
     dots, the residual and plain forms, (100000, 12), float64, phase 8b's
     2 lanes with a table each, GreedyEig's (1728, 256) block over intel's
     one table; its dots bitwise their order's numpy model, dot_model;
     each case's registers, resident blocks a SM and the grid's waves;
     bound: the least bytes of the work, 2m ids and weights, the row
     counts, V, B and the output; library: torch.sparse.mm of L(w) as
     CSR) and its V-cycle's K1p and
     K7 through the identity permutation (ell_cycle_cases: K1p's segment
     body at seg 1024 and K7 at nc 511, s 196 at (100000, 4), float64 and
     2 lanes; K1p's cluster body and K7 at s 4 at GreedyEig's (1728,
     256)): float32 within 1e-5 and float64 within 1e-12 relative in norm,
     two calls bitwise equal; device, call and plain times, bound and
     library time, each wrapper's launch floor (launch_floors: its
     smallest launch); and the Frank-Wolfe step's K9 fw_oracle and K10
     fw_update (fw_kernels: city10000's m 10688, k 5344 in float32 and
     float64 and the n = 100000 expander's m 50000, k 12500; K9 also at
     k = 1 and m - 1, with g = 0 ties across the threshold, the threshold
     inside a run of equal values and NaN entries; K10 from the start
     point and a random x, before and on the tail average, the gap stop
     off and fired): g, s, x, the tail average, the weights, the counters
     and the stop flag bitwise the plain version's, u and ||g|| within
     FW_TOL, two calls bitwise, a replayed CUDA graph of the pair bitwise
     the eager pair; device, call and plain times, bound, K9's yardstick
     torch.topk with scatter_;
  4. the banded path: read data/city10000.g2o, NaiveGreedy x_init, build
     MAC(..., device="cuda"), one cold and three warm solves at K = 50% of
     the loop closures; K2, K3b, K4 and the CG step's K5, K6, K1p (its
     segment body alone) and K7 must have launched, and K1, K1b and K3
     must not; the relaxed
     lambda_2 (scipy float64 referee) must sit within -1e-4 relative of
     the reference optimum 0.06944591018149751 and print as CITY_GAP_DIGITS
     (every kernel on the path is deterministic, so the gap cannot move
     unless the arithmetic does), and the rounded selection must hold
     exactly K edges; K9 and K10 launched (the Frank-Wolfe loop's
     bookkeeping on the device); then the same solve once with the loop
     on the host (PlainFW, plain_fw_check): rounded selection, x, upper
     bound and iteration counts bitwise, no K9 or K10 launch; from here to
     phase 10 no plain chain factor, and no plain form of the CG step
     (CG_PLAINS) or of K9 and K10 (FW_PLAINS), may be handed a CUDA
     tensor;
  4b. MAC(fixed, cands, n, fiedler_block_q=11) on city10000 (the
     slice's path at full width: K4w on the 33 x 33 Rayleigh-Ritz
     matrices in every outer iteration, replayed): one cold solve, then
     the counts set to 0, three warm solves, the counts read: K4w and the
     warp body launched, K1, K2b, K3b launched, no torch.linalg.eigh call,
     no capture in a warm solve, the relaxed gap >= -1e-3, exactly K,
     upper >= relaxed; the warm walls beside phase 4's at q = 4, the graph
     pool's bytes; then sphere2500 on the banded float64 route at q = 11
     (max_iters=20, two solves): K4w in float64, no float32 launch, the
     relaxed gap >= -1e-4;
  5. the matrix-free path, as scripts/bench_scale.py drives it: the
     n = 100000 expander-like graph (chain plus loop closures spanning up
     to n/4, no narrow band), K = 12500 of 50000 candidates, x_init the
     top-K candidates by weight, MAC with fiedler_inner_iters=10,
     fiedler_maxiter=60, fiedler_tol=6e-4, one cold and one warm
     solve(K, x_init, max_iters=10), then evaluate_objective of the relaxed
     solution; K3b, K4 and the CG step's K8, K6, K1p (its segment body
     alone) and K7 must have launched, and K1b, K1 and K5 must not (the
     V-cycle's chain solve is K1p's); every output finite; exactly K
     edges rounded; the relaxed lambda_2 at or above the reference
     library's 0.025668825678050997 (1 - 1e-3); the upper bound at or
     above it (1 - 1e-6); K9 and K10 launched, and the warm solve once
     more with the loop on the host, bitwise (plain_fw_check).
  6. the bundled datasets with scripts/bench_all.py's protocol: for each
     of intel, kitti_05, kitti_02, sphere2500 and ais2klinik, K = 50% of
     the loop closures, x_init from NaiveGreedy, MAC(fixed, cands, n) with
     no other argument (so on the card), solve(K, x_init, use_cache=True)
     once cold and three times warm. Gates: the reference's route (intel by
     the size gate and the kitti and ais sets by the tiny-gap escalation to
     float64 and the host engine; sphere2500 float32 on the banded operator
     with the polish and the round guard on); the relaxed lambda_2 (scipy
     referee) within -1e-6 relative of the reference library's on the host
     routes and -1e-3 on sphere2500; exactly K edges rounded; the upper
     bound at least the relaxed lambda_2 (1 - 1e-9); sphere2500's rounded
     lambda_2 at least 0.1 of its relaxed one (not collapsed), with K1p
     (its cluster body alone: the exact factor) and the assembly kernel
     launched; no kernel launched on the host routes.
     Then the graph that is disconnected even with every candidate (two
     chains of 600 nodes, three candidates): float64 on the device engine
     on the card, solve(2) selects 2, a finite upper bound,
     |evaluate_objective| < 1e-8, its chain solves through K1's float64
     instantiation alone (no plain version on the card, no float32
     launch).
  7. the greedy baselines: GreedyESP on city10000 with scripts/bench_all.py's
     lazy sweep (budgets 10, 30 and 50% of the loop closures: the chain
     closed form and the scan on the card, U float32 at (5344, 10688)),
     once cold and three times warm; gates: exactly k distinct picks per
     budget, nested budgets, the first 200 picks those of the numpy loop
     on the host and of the native lazy core, TF32 off; the scan's device
     busy time under torch.profiler. GreedyESP's Z path (a non-chain
     graph, n 5000, m 2500, k 800: Z by batched PCG on the card, then the
     scan): the host numpy loop's selection. GreedyEig on intel (n 1728,
     785 candidates, float32, chunk 64; the ELL operator through K8, the
     V-cycle through K1p's cluster body, K8 and K7 on the chunk's
     (1728, 256) block), k = 8 (cut from a user's budget to keep the
     phase short): each step's lambda_2 within 1e-3 of the scipy
     referee's, rising every step, the first chunk's batched lambda_2
     within 5e-4 of the per-lane loop's, K1p, K8 and K7 launched, K4
     launched with 64 lanes and no torch.linalg.eigh call inside
     TRACEMIN's lanes.
  8. the budget sweep MAC.solve_sweep, each part with its launch counts by
     lane count: (a) city10000 (scripts/bench_sweep.py's 8 budgets, 10 to
     50% of the loop closures, x_init NaiveGreedy's per budget) on phase
     4's solver, one cold and three warm sweeps taking turns with 8 serial
     warm solve(k, x_init) of the same budgets; gates: exactly k edges per
     lane, each lane's relaxed lambda_2 (scipy referee) at least
     (1 - 1e-2) of the serial solve's, the K = 5344 lane within -1e-3 of
     the reference optimum, each lane's Frank-Wolfe bound at least its
     relaxed lambda_2 (1 - 1e-3), K1, K2b and K4 launched with 8 lanes,
     no torch.linalg.eigh call inside TRACEMIN's lanes; prints
     the launches per sweep and per serial solve, the sweep's warm median
     against the sum of the serial warm medians and one warm sweep's
     device busy time (profiler); (b) the n = 100000 expander on phase 5's
     solver, budgets 6250 and 12500, max_iters=10, x_init the top-k by
     weight: K3b, K8, K1p, K7 and K6 launched with 2 lanes, exactly k per
     lane, the K = 12500
     lane's evaluate_objective at or above the reference library's
     (1 - 1e-3); (c) kitti_05, float64, on the device engine (budgets 6
     and 33): exactly k per lane, K1's float64 instantiation launched and
     nothing else (no plain version on the card), each lane's relaxed
     lambda_2 at least (1 - 1e-2) of the host engine's solve, printed
     beside the same sweep's on the plain scans; (d)
     sphere2500, 2 lanes (K2's no-split form): exactly k per lane, K1 and
     K2 launched with 2 lanes; (e) the same sweep at fiedler_block_q=12:
     exactly k per lane, each lane's relaxed lambda_2 at least (1 - 1e-2)
     of (d)'s, K4w launched on the (2, 36, 36) batches, no
     torch.linalg.eigh call inside TRACEMIN's lanes.
  9. the device mesh (mac_tpu_torch.parallel): a process group of
     torch.cuda.device_count() NCCL ranks (one card: in this process, a
     file:// rendezvous) and a ("sweep", "graph") mesh over it; through
     MAC(..., mesh=mesh): (a) city10000 at K = 5344 on the banded operator
     sharded by block rows, relaxed gap >= -1e-3, K edges rounded, K1 and
     K2b launched; (a') K2b on each half of a two-way split of its slot
     tables bitwise equal to the same rows of the whole assembly; (b)
     sphere2500, gap >= -1e-3, K2's no-split form and K1 launched; (c) the
     n = 100000 expander at phase 5's knobs with node-row and with edge
     shards, evaluate_objective's gap >= -1e-3, K1b launched; (d)
     solve_sweep over 2 budgets, each lane's relaxed lambda_2 at least
     (1 - 1e-2) of the meshless sweep's; (e) dryrun_multigpu(device
     count). Each part prints its wall beside the meshless one's.
 10. float64 and the remaining methods: (a) the float64 instantiations
     against their plain versions at rtol/atol 1e-10 (K1 on city10000's
     chain factor (10000, 4), on exact factors on each side of its
     whole-row / tiled threshold (66240 rows at q = 4) and at (5000,
     200); K1b at (100000, 4), also with a right-hand side 8 bytes off a
     16-byte boundary, and at (40000, 8)) and bitwise (K2b on city10000's
     tables, K2 on sphere2500's), each timed (device, call, plain, bound
     at float64, K2/K2b a float64 index_add_ beside it); (b)
     MAC(..., use_banded=True, dtype=torch.float64) on city10000 and
     sphere2500 at full size (K = 50%, NaiveGreedy x_init,
     max_iters=20), one cold and one warm solve each (and one profiled
     warm solve of city10000: device busy, the largest kernels): K2b
     (city10000) or K2 (sphere2500) and K1 launched in float64 only, no
     plain version on the card, exactly K, upper >= relaxed, the relaxed
     lambda_2 (scipy) within -1e-4 relative of the reference's; (c)
     city10000, banded float32, fiedler_method="lobpcg": exactly K and a
     gap >= -1e-3 on the warm solve; (d) fiedler_method="dense" on a banded
     n = 600 graph, 3 steps: finite, exactly K; (f) phase 5's expander in
     float64 (max_iters=2): the CG step through K8's, K1p's, K7's and
     K6's float64 instantiations and no float32 launch, exactly K, upper
     >= evaluate_objective.
 11. the chain factor's kernels end to end: warm solves of city10000,
     sphere2500 and the n = 100000 expander (K = 12500, max_iters=10) in
     turns old, new, new, old, "old" with the factor patched back to its
     plain loops, all on the eager solve path (SolvePath("eager"): a
     graph replays no Python, so it could not count the plain loops);
     each turn's wall, relaxed gap and factorisations.
 12. the reference's API on the card: make_banded_precond's four
     (smoother, kind) pairs on phase 3's city10000 and sphere2500 tables at
     their start weights, each with its build's call ms, one
     application's device ms at q = 4, the PCG steps to a 1e-5 relative
     residual on a centred seeded (n, 4) block, its K1 and K3/K3b launches
     (block-Jacobi none), TRACEMIN's outer iterations from the default
     block, and in float64 its symmetry |<Mx, y> - <x, My>| <= 1e-8
     max(|<Mx, y>|, 1) and positivity on four probes; fiedler_pair_op and
     tracemin_fiedler on city10000 without xprev0, lambda_2 within 1e-3 of
     the scipy referee; data/intel.g2o through the native parser and with
     MAC_TPU_NO_NATIVE=1, equal measurements; no plain version on the
     card.
 13. the eigensolver's single solve and the Frank-Wolfe loop on the card
     five ways (mac_tpu_torch.ops.graphs, SolvePath, PlainFW, PlainCG):
     "graph" (the loop's bookkeeping on the device, K9 and K10, its stop
     flag read with the next step's set-up; each step's set-up and
     TRACEMIN's outer iteration replayed as CUDA graphs over the route's
     static state, ops.graphs.StepSolves), "plain-fw" (the same graphs,
     the loop on the host: MAC._fw_host, the path before K9 and K10),
     "inner" (the host loop, only the inner CG steps replayed: the path
     before the set-up and the outer iteration were captured), "eager"
     (the host loop, no graph) and "plain-cg" (the device loop, with the
     CG step as PyTorch ops: the step before K5, K6, K1p, K7 and K8; its
     turns bitwise each other, held to the quality gate, no kernel of the
     CG step launched): warm solves of city10000, city10000 at
     fiedler_block_q=11 (phase 4b's solver: K4w replayed), sphere2500,
     the n = 100000 expander (K = 12500, max_iters=10) and phase 10b's
     banded float64 city10000 (max_iters=20) in turns eager, inner,
     plain-fw, plain-cg, graph, graph, plain-cg, plain-fw, inner, eager;
     each turn's wall,
     relaxed lambda_2, upper bound, FW and Fiedler iterations, captures,
     replays, set-up redos, discarded set-ups, K1 / K1b / K4 launches (K4
     by body) and K9 / K10's; every turn's unrounded x, rounded selection,
     iterations and upper bound bitwise the first's (in float64 the device
     loop's bound within 1e-12 relative), K9 and K10 once a step in the
     device loop's turns and never in the host loop's, no capture in a
     warm solve, equal launches of every kernel by dtype and of K4 by body
     in every turn, K4 launched (K4w at q = 11), no call of
     torch.linalg.eigh; the case's quality gate (city10000 relaxed gap
     >= -1e-4, at q = 11 >= -1e-3; sphere2500 >= -1e-3; n = 100000
     evaluate_objective >= the
     reference (1 - 1e-3); the banded float64 city10000 within 1e-9
     relative of the reference), exactly K rounded and upper >= relaxed;
     then one profiled warm solve each way (device busy, kernels, idle share, launch calls on the host: at most 700 on
     city10000 and 300 at n = 100000 in the device loop's turn, and the
     host reads of the loops and graphed_solve, graphs.host_reads; one
     CG step alone, step_kernels: the
     kernel nodes of a captured 6-step inner solve less a 5-step one, of STEP_KERNELS device kernels on city10000 and
     ELL_STEP_KERNELS at n = 100000); then one step of each cell again
     with its
     guard forced (banded: a NaN carried coarse inverse; ELL: the coarse
     level's singular flag raised): one eager redo, bitwise the eager
     solve; and the device loop with every set-up's guard forced
     (device_loop_guard): one redo a step, bitwise. Then a forced early stop
     on each route (forced_stops: sphere2500 at max_iters=12, the
     n = 100000 expander at 10, the banded float64 city10000 at 20, the
     first gap tolerance of FORCED_STOP_TOLS that stops the host loop
     early): host loop, device loop, device loop, host loop; the same
     step count and bitwise results, one discarded set-up in the device
     loop's turns and launches equal once its launches are taken off.
Phases 4 and 5 also print the graphs their cold solve captured (capture
seconds, pool and static bytes) and fail if a warm solve captured one; no
single solve of a graphed route runs without its graphs on the card in
phases 4 to 10 and 12 (PlainOnCard, "plain_solve").
Phases 4, 5, 6 (sphere2500), 8a, 8b, 8d, 9a-9c, 10b and 10f also require
the chain factor's kernel of their route to have launched (K3b on the
banded route past 4096 nodes and on the matrix-free route past 32768, K3
below), in the dtype and lane count of the route.
profile_scale.py profiles phase 5's warm solve; this script gates only.
The last lines are the card, a JSON summary of the kernels (launches on
their path (K1 and K1b on the mesh's, phase 9, whose V-cycles keep
them; K1 also on GreedyEig's, launches_greedy_eig), error against the plain version, device time (ms and
device_ms), call_ms, the plain version's call time, the yardstick's device
time (library_ms), and the least time the card could take, bound_ms; one
entry per lane shape, its launches those with that many lanes in phase 8;
one entry per float64 kernel, "dtype": "float64", its launches those of
its phase-10 path; K3 and K3b with "replaces" naming the JAX scan they
stand for, "chain_steps" the length of the kernel's dependent chain,
"bound_steps" that of the shortest chain its method needs (K3b: block;
K3: its chunk walks and carry at the chunk length that makes them
shortest), "chain_step_ns" one step timed by ldl.cu's probe, "bound_ms"
the larger of the chain bound (bound_steps x chain_step_ns) and the
byte / operation bound
("ops_bound_ms", "ops_bound_by"), "bound_by" "chain" where the chain's
is larger, and "launch_floor_ms" the probe's device time at 0 steps in the
entry's type; K4 one
entry per shape and dtype, "replaces" the jnp.linalg.eigh line it stands
for, "launches" those of its dtype on phase 4's path (float32) or phase
5's (float64 coefficients), and of its lane count in phase 8a (8 lanes)
or 7c (64), "library_ms" torch.linalg.eigh's device time and
"library_call_ms" its call time, "bound_ms" the larger of its chain
bound and its byte/operation bound, "bound_by" "chain" where the chain's
is larger; K4w, "name" "sym_eig_wide", one entry per shape and dtype,
its "launches" those of phase 4b (float32: the three warm city10000
solves at q = 11; float64: sphere2500's two) or 8e (the lanes), 0 for the
(96, 96) shapes no path runs, "barrier_round_ms" its round with the two
barriers) and the result line {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REFERENCE_LAM2_UNROUNDED = 0.06944591018149751  # reference relaxed optimum
GAP_FLOOR = -1e-3
K1_TOL = 2e-4
# The reference library's relaxed lambda_2 on bench_scale's n = 100000
# expander instance (scripts/bench_scale_results.json).
REFERENCE_LAM2_SCALE = 0.025668825678050997
SCALE_N = 100000
# Phase 6: the reference library's relaxed lambda_2 at K = 50% of the loop
# closures (BASELINE.md, scripts/baseline_reference.json), the route each
# dataset must take (dtype, fiedler_backend, banded) and its relaxed-gap
# floor.
BUNDLED = {
    "intel": (0.05372595512017725, "float64", "host", False, -1e-6),
    "kitti_05": (18.887283604529912, "float64", "host", False, -1e-6),
    "kitti_02": (2.3255991498563375, "float64", "host", False, -1e-6),
    "sphere2500": (0.23430047503258467, "float32", "device", True, -1e-3),
    "ais2klinik": (5.2958016833414765e-05, "float64", "host", False, -1e-6),
}
# NVIDIA H100 SXM published peaks: HBM bytes/s, float32 and float64
# (non-tensor-core) FLOP/s, and the tensor cores' dense TF32 and float64
# (DMMA) FLOP/s; bound_ms is the larger of bytes / rate and operations /
# rate, at the rate of the unit the kernel's body runs on.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_F64_FLOPS = 34e12
H100_TF32_TC_FLOPS = 495e12
H100_F64_TC_FLOPS = 67e12
# Phase 10: the float64 kernels against their plain versions.
F64_TOL = 1e-10
# Phase 10b: the banded float64 solves' relaxed gap floor.
GAP_FLOOR_F64 = -1e-4
# Phase 3d: K3 (exact factor) in float64 against the extended-precision
# referee (pivot_referee), relative.
F64_FACTOR_RTOL = 1e-13
# Phase 4: city10000's relaxed gap as printed since K1p's segment body
# (the chain solve by a pivot's reciprocal where K1 divides, x's column
# sums in another order; +1.122e-03 with K5's redesign, the coarse
# assembly in 3xTF32; +1.064e-03 with the first K5, K6, K1p and K7,
# +1.182e-03 before them with K4 on the Rayleigh-Ritz eigensolves): every
# kernel on the path is deterministic, so the gap cannot move unless the
# arithmetic does; and its floor, the tuned operating point's.
CITY_GAP_DIGITS = "+1.290e-03"
CITY_GAP_FLOOR = -1e-4
# Phase 13: host launch calls a profiled warm solve may make, replayed.
HOST_LAUNCH_CAPS = {"city10000": 700, "n = 100000": 300}
# Phase 13: device kernels one replayed CG step of city10000 runs: K5's
# inner form and K6's first pass; the V-cycle's K1p, K5 residual, K7
# (K7_LAUNCHES launches a call), K5 residual and K1p adding; K6's second
# pass with the dots (141 before kernels K5, K6, K1p and K7; 10 before the
# second pass took the dots).
K7_LAUNCHES = 2
STEP_KERNELS = 7 + K7_LAUNCHES
# Phase 13: device kernels one replayed CG step of the n = 100000 matrix-free
# route runs: K8's inner form with the dots and K6's first pass; the
# V-cycle's K1p, K8 residual, K7, K8 residual and K1p adding; K6's second
# pass with the dots (45 with the ELL product and the cycle as PyTorch ops).
ELL_STEP_KERNELS = 7 + K7_LAUNCHES


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median time of one call of fn() in milliseconds, CUDA events around
    the call on an idle device: the wrapper's host work (checks, allocation,
    the ctypes call) lies inside the window."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 100, rounds: int = 5) -> float:
    """Device time of one call of fn() in milliseconds: `reps` calls
    enqueued back to back behind a spin kernel (torch.cuda._sleep) that
    keeps the device busy while the host enqueues them, CUDA events around
    the reps calls only; the median over `rounds` of elapsed / reps. A
    round whose enqueue outlasted the spin is dropped and the spin
    doubled, so no host time lands in the window. The reps calls' kernels
    must fit the device's queue of pending launches (about a thousand),
    else the enqueue waits for the spin whatever its length."""
    import torch

    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s0, s1 = ev(), ev()
    s0.record()
    torch.cuda._sleep(1_000_000)
    s1.record()
    s1.synchronize()
    cycles_per_ms = 1e6 / s0.elapsed_time(s1)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    torch.cuda.synchronize()
    times = []
    for _ in range(8 * rounds):
        a, b = ev(), ev()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        b.synchronize()
        if enqueue_ms > 0.8 * spin_ms:
            if spin_ms > 30_000:
                break
            spin_ms *= 2
            continue
        times.append(a.elapsed_time(b) / reps)
        if len(times) == rounds:
            return statistics.median(times)
    fail("device_ms: the host never got ahead of the device (fn waits for "
         "it, or reps calls launch more kernels than the launch queue "
         "holds behind the spin)")


def bound(nbytes: float, flops: float, itemsize: int = 4, rate=None):
    """(least milliseconds on the card, what bounds it); the operations at
    `rate` FLOP/s, by default the float32 (itemsize 4) or float64 (8)
    peak outside the tensor cores."""
    if rate is None:
        rate = H100_F32_FLOPS if itemsize == 4 else H100_F64_FLOPS
    tb, to = nbytes / H100_BYTES_PER_S, flops / rate
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def tridiag_bound(n: int, q: int, lanes: int = 1, shared: bool = True,
                  itemsize: int = 4):
    """Read dp, l (n,) -- one factor, or one per lane -- and B (lanes, n,
    q), write X (lanes, n, q), of itemsize bytes each; per entry of B two
    forward operations, one division, two backward."""
    factors = 1 if shared else lanes
    return bound(itemsize * (2 * n * factors + 2 * n * q * lanes),
                 5.0 * n * q * lanes, itemsize)


def k1_whole_row_limit(q: int, itemsize: int) -> int:
    """The largest n whose rows K1 keeps in shared memory for a block of q
    columns of itemsize bytes (tridiag.cu's tile budget `fit`, times the
    cluster's 16 blocks); past it the tiled two-pass branch runs."""
    qg = min(q, 128)
    npass = -(-qg // min(qg, 8))
    fixed = 64 + 2 * npass * 256 + 7 * qg + 2 * 16 * qg + 1 + qg
    return 16 * (((200 * 1024 // itemsize - fixed) // (qg + 2)) & ~3)


# The plain versions of the chain factor's kernels K3 and K3b.
FACTOR_PLAINS = ("tridiag_ldl_plain", "tridiag_ldl_blocked_plain")
# The CG step's kernels (their wrappers' names): the banded routes launch
# all of them, every route that runs pcg_fixed on the card K6's three. K1p
# is K1's body with permuted loads and stores: on the banded routes it
# takes K1's place in the V-cycle. The matrix-free route launches
# ELL_CG_KERNELS: K8 in K5's place, and K1p (through the identity
# permutation) where its cycle ran K1b or K1.
CG_KERNELS = ("banded_product", "coarse_correct", "tridiag_solve_permuted",
              "col_sums", "cg_update", "cg_direction_dots")
ELL_CG_KERNELS = ("ell_product", "coarse_correct", "tridiag_solve_permuted",
                  "col_sums", "cg_update", "cg_direction_dots")
K6_KERNELS = ("col_sums", "cg_update", "cg_direction_dots")


def k1_body(got, key=None):
    """Launches of K1's body, K1 and K1p, from `got` (by wrapper name:
    counts, or dicts by dtype or lanes, then read at `key`)."""
    a, b = got["tridiag_solve"], got["tridiag_solve_permuted"]
    if key is None:
        return a + b
    return a.get(key, 0) + b.get(key, 0)


# The plain forms of the CG step (K5, K8, K7, K1p, K6, pcg_fixed's loop,
# the V-cycles' PyTorch form "plain", banded and ELL): none may run on the
# card on the single-solve, lane and float64 routes.
CG_PLAINS = ("banded_product_plain", "ell_product_plain",
             "coarse_correct_plain", "tridiag_solve_permuted_plain",
             "col_sums_plain", "cg_update_plain", "cg_direction_plain",
             "cg_direction_dots_plain", "pcg_fixed_plain", "plain")


class PlainOnCard:
    """While active, counts the calls of the kernels' plain versions that
    are given CUDA tensors (the main paths must make none: every block on
    the card goes to a kernel), and of the graphed routes' eager solve
    (ops.graphs.plain_solve, "plain_solve": a single solve on the card
    replays its graphs): those named in `names`, by default all of them.
    `calls` maps each plain version's name to its count."""

    def __init__(self, names=None):
        self.names = names

    def __enter__(self):
        import torch

        from mac_tpu_torch.ops import banded, cg, graphs, twogrid
        from mac_tpu_torch.ops.kernels import (assemble, ell, fw, ldl, pcg,
                                               syev, tridiag)
        from mac_tpu_torch.ops.kernels import banded as kb

        self.calls = {}
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (tridiag, "tridiag_solve_plain"),
            (tridiag, "tridiag_solve_blocked_plain"),
            (assemble, "assemble_ut_plain"),
            (ldl, FACTOR_PLAINS[0]), (ldl, FACTOR_PLAINS[1]),
            (syev, "sym_eig_plain"), (graphs, "plain_solve"),
            (kb, "banded_product_plain"), (kb, "coarse_correct_plain"),
            (ell, "ell_product_plain"),
            (tridiag, "tridiag_solve_permuted_plain"),
            (pcg, "col_sums_plain"), (pcg, "cg_update_plain"),
            (pcg, "cg_direction_plain"), (pcg, "cg_direction_dots_plain"),
            (cg, "pcg_fixed_plain"),
            (banded.VCycle, "plain"), (twogrid.EllVCycle, "plain"),
            (fw, FW_PLAINS[0]), (fw, FW_PLAINS[1]))
            if self.names is None or name in self.names]
        for mod, name, real in self.saved:
            def counted(*args, _real=real, _name=name, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args):
                    self.calls[_name] = self.calls.get(_name, 0) + 1
                return _real(*args, **kw)

            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)
        return False


class PlainScans:
    """While active, the tridiagonal dispatch runs the plain scans in place
    of K1 and K1b on the card (what the float64 routes ran before their
    kernels existed), for a comparison run."""

    def __enter__(self):
        from mac_tpu_torch.ops.kernels import tridiag

        self.mod = tridiag
        self.saved = (tridiag.tridiag_solve, tridiag.tridiag_solve_blocked)
        tridiag.tridiag_solve = tridiag.tridiag_solve_plain
        tridiag.tridiag_solve_blocked = tridiag.tridiag_solve_blocked_plain
        return self

    def __exit__(self, *exc):
        self.mod.tridiag_solve, self.mod.tridiag_solve_blocked = self.saved
        return False


class PlainFactor:
    """While active, the chain factor runs its plain loops (the doubling
    scan, the `block`-step recurrence) in place of K3 and K3b on the card,
    as before those kernels existed, for a comparison run; `calls` counts
    them."""

    def __enter__(self):
        from mac_tpu_torch.ops.kernels import ldl

        self.mod, self.calls = ldl, 0
        self.saved = (ldl.tridiag_ldl, ldl.tridiag_ldl_blocked)

        def plain(real):
            def run(*args):
                self.calls += 1
                return real(*args)
            return run

        ldl.tridiag_ldl = plain(ldl.tridiag_ldl_plain)
        ldl.tridiag_ldl_blocked = plain(ldl.tridiag_ldl_blocked_plain)
        return self

    def __exit__(self, *exc):
        self.mod.tridiag_ldl, self.mod.tridiag_ldl_blocked = self.saved
        return False


def _plain_cg_loop(*args, **kw):
    """pcg_fixed's PyTorch loop, counted in PlainCG.calls."""
    from mac_tpu_torch.ops import cg

    PlainCG.calls += 1
    return cg.pcg_fixed_plain(*args, **kw)


def _plain_vcycle(cyc, B):
    """The V-cycle's PyTorch form (ops.banded.VCycle.plain,
    ops.twogrid.EllVCycle.plain)."""
    return cyc.plain(B)


class PlainCG:
    """While active, TRACEMIN's inner CG step on the card runs as it did
    before kernels K5, K6, K1p, K7 and K8, for a comparison run:
    pcg_fixed's PyTorch loop, the V-cycles' PyTorch forms (VCycle.plain
    around K1, EllVCycle.plain around K1 or K1b), and the plain versions of
    K5 and K8 (every banded and ELL product, the outer iteration's too)
    and of K6, K1p and K7 wherever they are called. `calls` counts the
    pcg_fixed calls so run. The functions swapped in are the same objects
    every time, so that a replayed graph captured under one PlainCG is
    found again under the next. No knob selects it."""

    calls = 0

    def __enter__(self):
        from mac_tpu_torch.ops import banded, cg, twogrid
        from mac_tpu_torch.ops.kernels import banded as kb
        from mac_tpu_torch.ops.kernels import ell, pcg, tridiag

        PlainCG.calls = 0
        swaps = [(cg, "pcg_fixed_steps", _plain_cg_loop),
                 (banded, "_vcycle_kernels", _plain_vcycle),
                 (twogrid, "_ell_vcycle_kernels", _plain_vcycle),
                 (kb, "banded_product", kb.banded_product_plain),
                 (ell, "ell_product", ell.ell_product_plain),
                 (kb, "coarse_correct", kb.coarse_correct_plain),
                 (tridiag, "tridiag_solve_permuted",
                  tridiag.tridiag_solve_permuted_plain),
                 (pcg, "col_sums", pcg.col_sums_plain),
                 (pcg, "cg_update", pcg.cg_update_plain),
                 (pcg, "cg_direction_dots", pcg.cg_direction_dots_plain)]
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in swaps]
        for mod, name, new in swaps:
            setattr(mod, name, new)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)
        return False


class SolvePath:
    """While active, the graphed routes' single solves on the card take
    another path than ops.graphs.graphed_solve, for a comparison run:
    "eager" (graphs.plain_solve: the build and TRACEMIN's loop with no
    graph, K4 included) or "inner" (graphs.inner_replayed_solve: only the
    inner CG steps replayed, the form before the set-up and the outer
    iteration were captured); `calls` counts the solves so run. MAC's
    Frank-Wolfe loop runs on the host meanwhile (PlainFW): its device loop
    solves through the graphs' per-step interface, which these paths
    predate. No knob selects them."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        from mac_tpu_torch.ops import graphs

        self.mod, self.calls, self.saved = graphs, 0, graphs.graphed_solve
        path = {"eager": graphs.plain_solve,
                "inner": graphs.inner_replayed_solve}[self.kind]

        def run(*args, **kw):
            self.calls += 1
            return path(*args, **kw)

        graphs.graphed_solve = run
        self.loop = PlainFW().__enter__()
        return self

    def __exit__(self, *exc):
        self.mod.graphed_solve = self.saved
        self.loop.__exit__(*exc)
        return False


class EighCalls:
    """While active, counts the calls of torch.linalg.eigh (`calls`) and
    those made inside TRACEMIN's lanes (`lanes`: a tracemin_fiedler_lanes
    frame on the stack): the single-solve routes must make none on the
    card, and TRACEMIN's lanes none anywhere (K4 takes them)."""

    def __enter__(self):
        import torch

        self.real, self.calls, self.lanes = torch.linalg.eigh, 0, 0

        def counted(*args, **kw):
            self.calls += 1
            frame = sys._getframe(1)
            while frame is not None:
                if frame.f_code.co_name == "tracemin_fiedler_lanes":
                    self.lanes += 1
                    break
                frame = frame.f_back
            return self.real(*args, **kw)

        torch.linalg.eigh = counted
        return self

    def __exit__(self, *exc):
        import torch

        torch.linalg.eigh = self.real
        return False


GRAPH_FIELDS = ("captures", "replays", "redos", "discards", "capture_s",
                "pool_bytes", "static_bytes")


def graph_stats(op):
    """{captures, replays, redos, capture_s, pool_bytes, static_bytes}
    summed over the graph routes of an operator (ops.graphs.Route)."""
    return {f: sum(getattr(s, f) for s in op.graph_routes.values())
            for f in GRAPH_FIELDS}


def graph_lines(card, name, stats):
    """Print the graphs of a run of solves from graph_stats before the
    first and after each solve (the first one cold); fail if a warm solve
    captured."""
    cold = {f: stats[1][f] - stats[0][f] for f in GRAPH_FIELDS}
    warm = [stats[i + 1]["captures"] - stats[i]["captures"]
            for i in range(1, len(stats) - 1)]
    replays = [stats[i + 1]["replays"] - stats[i]["replays"]
               for i in range(len(stats) - 1)]
    print(f"{name} solve graphs: the cold solve captured "
          f"{cold['captures']} in {cold['capture_s']:.3f} s (warm-up step "
          f"included), pools {cold['pool_bytes'] / 2**20:.2f} MiB, static "
          f"buffers {cold['static_bytes'] / 2**20:.2f} MiB; the warm solves "
          f"captured {warm}; replays per solve {replays} ({card})",
          flush=True)
    if any(warm) or not all(replays):
        fail(f"{name}: a warm solve captured ({warm}) or a solve replayed "
             f"nothing ({replays})")


def captured_args(mod, name, fn):
    """The arguments (positional, then keyword values) of the first call of
    mod.<name> while fn() runs: what a path hands that function."""
    real, got = getattr(mod, name), []

    def record(*args, **kw):
        got.append(args + tuple(kw.values()))
        return real(*args, **kw)

    setattr(mod, name, record)
    try:
        fn()
    finally:
        setattr(mod, name, real)
    if not got:
        fail(f"{name} was never called")
    return got[0]


def pivot_referee(d, e):
    """(dp, l) of the exact factor by the sequential pivot recurrence in
    the host's extended precision (numpy longdouble), floored as the
    kernels floor, as float64 arrays (lanes, n): the referee of K3 and of
    its plain doubling scan in float64."""
    import numpy as np

    ld = np.longdouble
    d2 = np.atleast_2d(d.double().cpu().numpy()).astype(ld)
    e2 = np.atleast_2d(e.double().cpu().numpy()).astype(ld)
    dp = np.empty_like(d2)
    prev = np.ones(d2.shape[0], dtype=ld)
    for i in range(d2.shape[1]):
        prev = d2[:, i] - (e2[:, i - 1] ** 2 / prev if i else 0)
        dp[:, i] = prev
    dp = np.maximum(dp, (8 * np.finfo(np.float64).eps
                         * d2.max(axis=1, keepdims=True)))
    l = np.concatenate([np.zeros((d2.shape[0], 1), dtype=ld),
                        e2 / dp[:, :-1]], axis=1)
    return dp, l


def factor_check(kern, plain, args, label, exact):
    """Kernel K3 (exact=True) or K3b (exact=False; bitwise) against its
    plain version on args = (d, e[, block]); the largest absolute error of
    dp and l. K3 in float32: at most one ulp from the plain version. K3 in
    float64: within F64_FACTOR_RTOL relative of pivot_referee, and from
    the plain doubling scan by no more than that plus the plain scan's own
    distance from the referee (the doubling scan's rounding grows with the
    chain's conditioning, the referee's does not)."""
    import numpy as np
    import torch

    dp, l = kern(*args)
    ref_dp, ref_l = plain(*args)
    torch.cuda.synchronize()
    dtype = str(args[0].dtype).split(".")[-1]
    pairs = ((dp, ref_dp), (l, ref_l))
    err = max(float((a - b).abs().max()) for a, b in pairs)
    if not exact:
        ok = all(torch.equal(a, b) for a, b in pairs)
        what = "bitwise equal" if ok else "MISMATCH"
    elif args[0].dtype == torch.float32:
        ulps = max(int((a.view(torch.int32).long() - b.view(torch.int32)
                        .long()).abs().max()) for a, b in pairs)
        ok = ulps <= 1
        what = f"max {ulps} float32 ulp -> {'ok' if ok else 'MISMATCH'}"
    else:
        def rel(a, b):
            a = np.atleast_2d(a.cpu().numpy()).astype(np.longdouble)
            b = np.atleast_2d(b.cpu().numpy() if isinstance(b, torch.Tensor)
                              else b).astype(np.longdouble)
            return float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                           1e-300)))

        ref = pivot_referee(*args[:2])
        rel_kp = max(rel(a, b) for a, b in pairs)
        rel_k = max(rel(dp, ref[0]), rel(l, ref[1]))
        rel_p = max(rel(ref_dp, ref[0]), rel(ref_l, ref[1]))
        ok = (rel_k <= F64_FACTOR_RTOL
              and rel_kp <= F64_FACTOR_RTOL + rel_p)
        what = (f"max rel to the plain scan {rel_kp:.3e}; to the "
                f"extended-precision referee: kernel {rel_k:.3e}, plain "
                f"scan {rel_p:.3e} -> {'ok' if ok else 'MISMATCH'}")
    ok = ok and bool(torch.isfinite(dp).all() and torch.isfinite(l).all())
    print(f"{kern.__name__} {dtype} {label} {tuple(args[0].shape)}: "
          f"max|kernel - plain| {err:.3e}, {what}", flush=True)
    if not ok:
        fail(f"{kern.__name__} disagrees with its plain version on {label} "
             f"({dtype})")
    return err


def scaled_factor_check(args, power, label):
    """K3's range: the float64 chain args = (d, e) scaled by 2^power (its
    e^2 by 2^(2 power)). K3 within F64_FACTOR_RTOL relative of
    pivot_referee, and bit for bit the unscaled chain's factor with dp
    scaled by 2^power (ldl.cu scales every chain by its max(d) and back);
    the plain doubling scan is left out, its products of two maps leave
    the range there. K3b at block 128 bit for bit its plain version."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels import ldl

    d1, e1 = args[0].double(), args[1].double()
    d, e = d1 * 2.0 ** power, e1 * 2.0 ** power
    dp, l = ldl.tridiag_ldl(d, e)
    dp1, l1 = ldl.tridiag_ldl(d1, e1)
    bdp, bl = ldl.tridiag_ldl_blocked(d, e, 128)
    pdp, pl = ldl.tridiag_ldl_blocked_plain(d, e, 128)
    torch.cuda.synchronize()
    ref = pivot_referee(d, e)
    rel = max(float(np.max(np.abs(a.cpu().numpy().astype(np.longdouble) - r)
                           / np.maximum(np.abs(r), 1e-300)))
              for a, r in ((dp, ref[0][0]), (l, ref[1][0])))
    same = (torch.equal(dp, dp1 * 2.0 ** power) and torch.equal(l, l1))
    k3b_same = torch.equal(bdp, pdp) and torch.equal(bl, pl)
    ok = rel <= F64_FACTOR_RTOL and same and k3b_same
    print(f"K3, K3b float64 on {label} scaled by 2^{power}: K3 max rel to the "
          f"extended-precision referee {rel:.3e}, "
          f"{'bit for bit' if same else 'NOT'} the unscaled factor scaled; "
          f"K3b {'bitwise equal' if k3b_same else 'MISMATCH'} -> "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"K3 or K3b on {label} scaled by 2^{power}")


def factor_times(kern, plain, args, label, steps, bound_steps, step_ns,
                 card):
    """Device, call and plain times of one factorisation on args = (d,
    e[, block]) and its bound: the larger of the chain bound ("chain"), the
    shortest dependent chain that the method needs (`bound_steps` long)
    times step_ns, one step of that chain timed alone (ldl_step_ns), and
    the byte / operation bound printed beside it (d, e read once, dp, l
    written once; 5 float64 operations a row for K3b, 11 for K3, at the
    float64 peak); with the kernel's own chain (`steps`) and its device
    time per step."""
    d = args[0]
    lanes = d.shape[0] if d.dim() == 2 else 1
    n = d.shape[-1]
    tm = {"device_ms": device_ms(lambda: kern(*args)),
          "call_ms": call_ms(lambda: kern(*args)),
          "plain_ms": call_ms(lambda: plain(*args), reps=10, warmup=1),
          "chain_steps": steps, "bound_steps": bound_steps,
          "chain_step_ns": step_ns}
    tm["ops_bound_ms"], tm["ops_bound_by"] = bound(
        d.element_size() * lanes * (4 * n - 1),
        lanes * n * (5 if len(args) == 3 else 11), 8)
    tm["bound_ms"], tm["bound_by"] = max(
        (1e-6 * bound_steps * step_ns, "chain"),
        (tm["ops_bound_ms"], tm["ops_bound_by"]))
    tm["ns_per_step"] = 1e6 * tm["device_ms"] / steps
    print(f"{kern.__name__} time at {label}: kernel device "
          f"{tm['device_ms']:.5f} ms, call {tm['call_ms']:.4f} ms, plain "
          f"call {tm['plain_ms']:.4f} ms, bound {tm['bound_ms']:.5f} ms "
          f"({tm['bound_by']}: {bound_steps} dependent steps of "
          f"{step_ns:.2f} ns; {tm['ops_bound_by']} {tm['ops_bound_ms']:.2e} "
          f"ms); the kernel's chain {steps} steps, {tm['ns_per_step']:.1f} "
          f"ns a step; device / bound "
          f"{tm['device_ms'] / tm['bound_ms']:.2f} ({card})", flush=True)
    return tm


def rayleigh_ritz_matrices(bop, w, dev, q=4):
    """{(k, dtype name): H}: the first q x q (the entry's) and 3q x 3q (an
    outer iteration's) Rayleigh-Ritz matrices that TRACEMIN hands K4 on the
    banded tables bop at the weights w from MAC's start block of q columns
    (4 x 4 and 12 x 12 at the default q = 4), with float32 coefficients
    (fast32's) and float64 ones (the default), from one eager outer
    iteration each (graphs.plain_solve)."""
    import torch

    from mac_tpu_torch.ops import banded, graphs
    from mac_tpu_torch.ops.kernels import syev
    from mac_tpu_torch.ops.lobpcg import default_xprev
    from mac_tpu_torch.utils.fiedler import default_block

    n = bop.n
    X = torch.as_tensor(default_block(n, q), dtype=torch.float32, device=dev)
    real, got = syev.check_kernel_args, {}

    def record(H):  # the wrapper checks every matrix it launches on
        got.setdefault((H.shape[-1], str(H.dtype).split(".")[-1]), H.clone())
        return real(H)

    syev.check_kernel_args = record
    try:
        for coeff in (torch.float32, torch.float64):
            graphs.plain_solve(
                graphs.banded_route(bop, banded.PRECOND_KIND), w, X,
                xprev0=default_xprev(n, q, torch.float32, dev), maxiter=1,
                inner_iters=10, coeff_dtype=coeff)
    finally:
        syev.check_kernel_args = real
    want = sorted((k_, dt_) for k_ in (q, 3 * q)
                  for dt_ in ("float32", "float64"))
    if sorted(got) != want:
        fail(f"TRACEMIN handed K4 {sorted(got)}, want {want}")
    return got


def k4_check(H, label):
    """K4 against its plain version and torch.linalg.eigh on H (..., k,
    k), through the body body_for names (one launch of it counted):
    eigenvalues within 2 k eps ||H|| of both and ascending, the
    residual ||H V - V diag(evals)|| within 2 k eps ||H||, V^T V within
    2 k eps of I, each column's largest entry positive; returns the largest
    |evals - plain evals|."""
    import torch

    from mac_tpu_torch.ops.kernels import syev

    k = H.shape[-1]
    body = syev.body_for(k, H.dtype)
    before = syev.sym_eig.launches_by_body.get(body, 0)
    e, V = syev.sym_eig(H)
    if syev.sym_eig.launches_by_body.get(body, 0) != before + 1:
        fail(f"sym_eig on {label} did not count one launch of its body "
             f"{body}: {syev.sym_eig.launches_by_body}")
    ep, _ = syev.sym_eig_plain(H)
    el, _ = torch.linalg.eigh(H)
    torch.cuda.synchronize()
    eps = torch.finfo(H.dtype).eps
    hn = max(float(torch.linalg.matrix_norm(H).amax()), 1e-30)
    tol = 2 * k * eps * hn
    err = float((e - ep).abs().max())
    err_l = float((e - el).abs().max())
    resid = float(torch.linalg.matrix_norm(H @ V - V * e[..., None, :]).amax())
    eye = torch.eye(k, dtype=H.dtype, device=H.device)
    orth = float((V.mT @ V - eye).abs().max())
    top = V.gather(-2, V.abs().argmax(dim=-2, keepdim=True))
    ok = (bool(torch.isfinite(e).all() and torch.isfinite(V).all())
          and err <= tol and err_l <= tol and resid <= tol
          and orth <= 2 * k * eps and bool((top > 0).all())
          and bool((e[..., 1:] >= e[..., :-1]).all()))
    print(f"K4 sym_eig ({body}) {label} {tuple(H.shape)}: max|kernel - "
          f"plain| "
          f"{err:.3e}, max|kernel - eigh| {err_l:.3e} (tolerance 2 k eps "
          f"||H|| = {tol:.3e}), residual {resid:.3e}, max|V^T V - I| "
          f"{orth:.3e} -> {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"sym_eig disagrees with its plain version or eigh on {label}")
    return err


def k4_times(H, label, card, round_ms, wide_round_ms=None):
    """Device, call and plain times of K4 on H, torch.linalg.eigh's
    device time (kernels_ms) and call time, the sweeps this H needs and
    bound_ms, the larger of two bounds, named in bound_by: the chain bound
    ("chain"), the rounds this H takes (the most over a batch: the
    matrices run side by side) times round_ms, one round of the
    irreducible chain (k4_round_ms); and the byte/operation bound ("bytes"
    or "operations", printed beside it): H read once, evals and V written
    once, and per rotation 24 m operations on the rows and columns of A and
    V and 20 for its parameters, per sweep the stop test's 2 m^2, at the
    dtype's peak. For K4w, wide_round_ms (K4w's round with its two
    barriers, k4_round_ms(dtype, threads)) is printed and kept beside
    the bound as "barrier_round_ms"."""
    import torch

    from mac_tpu_torch.ops.kernels import syev

    k = H.shape[-1]
    m = k + k % 2
    tm = {"device_ms": device_ms(lambda: syev.sym_eig(H)),
          "call_ms": call_ms(lambda: syev.sym_eig(H)),
          "plain_ms": call_ms(lambda: syev.sym_eig_plain(H), reps=5,
                              warmup=1),
          "library_ms": kernels_ms(lambda: torch.linalg.eigh(H)),
          "library_call_ms": call_ms(lambda: torch.linalg.eigh(H))}
    sweeps = syev.jacobi_sweeps(H)
    rounds = sweeps * (m - 1)
    batch = H.numel() // (k * k)
    flat_ms, flat_by = bound(
        H.element_size() * batch * (2 * k * k + k),
        batch * (rounds * (m // 2) * (24 * m + 20)
                 + (sweeps + 1) * 2 * m * m),
        H.element_size())
    tm["bound_ms"], tm["bound_by"] = max((rounds * round_ms, "chain"),
                                         (flat_ms, flat_by))
    tm["sweeps"], tm["chain_steps"] = sweeps, rounds
    tm["ns_per_step"] = 1e6 * tm["device_ms"] / max(rounds, 1)
    tm["body"] = syev.body_for(k, H.dtype)
    barriers = ""
    if wide_round_ms is not None:
        tm["barrier_round_ms"] = wide_round_ms
        barriers = (f"; K4w's round with its two barriers "
                    f"{1e6 * wide_round_ms:.1f} ns, x {rounds} rounds = "
                    f"{rounds * wide_round_ms:.5f} ms")
    print(f"sym_eig ({tm['body']}) time at {label} {tuple(H.shape)}: "
          f"kernel device "
          f"{tm['device_ms']:.5f} ms, call {tm['call_ms']:.4f} ms, plain "
          f"call {tm['plain_ms']:.4f} ms, torch.linalg.eigh device "
          f"{tm['library_ms']:.5f} ms, call {tm['library_call_ms']:.4f} ms; "
          f"bound {tm['bound_ms']:.5f} ms ({tm['bound_by']}; chain: "
          f"{rounds} dependent rounds of {1e6 * round_ms:.1f} ns, {sweeps} "
          f"sweeps; {flat_by} {flat_ms:.2e} ms); {tm['ns_per_step']:.1f} ns "
          f"a round, device / bound "
          f"{tm['device_ms'] / max(tm['bound_ms'], 1e-12):.2f}{barriers} "
          f"({card})", flush=True)
    return tm


def ptxas_report(log: str):
    """[(entry function, registers, stack frame bytes, spill store bytes,
    spill load bytes)] from nvcc -Xptxas -v's report, in its order."""
    import re

    out, fn, frame = [], None, (0, 0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            out.append((fn, int(m.group(1)), *frame))
            fn = None
    return out


def k4_instances(log: str):
    """{(dtype name, m): (registers, stack bytes, spill stores, spill
    loads)} of K4's sym_eig_kernel<T, m> instantiations in a ptxas
    report (mangled names: ...sym_eig_kernelIfLi12E... is float, m 12)."""
    import re

    got = {}
    for fn, *rest in ptxas_report(log):
        m = re.search(r"sym_eig_kernelI([fd])Li(\d+)E", fn)
        if m:
            got[({"f": "float32", "d": "float64"}[m.group(1)],
                 int(m.group(2)))] = tuple(rest)
    return got


def k4_frame_gate(log: str):
    """k4_instances(log), failing unless K4's instantiations at the main
    paths' sizes (m 4 and 12, float32 and float64) have a 0-byte stack frame
    and no spills."""
    regs = k4_instances(log)
    for key in (("float32", 4), ("float32", 12), ("float64", 4),
                ("float64", 12)):
        if key not in regs or regs[key][1:] != (0, 0, 0):
            fail(f"K4 {key}: want a 0-byte stack frame and no spills, got "
                 f"{regs.get(key)}")
    return regs


def k4w_instances(log: str):
    """{(dtype name, form): (registers, stack bytes, spill stores, spill
    loads)} of K4w's sym_eig_wide_kernel<T, shared> instantiations in a
    ptxas report (form "shared" or "workspace"; mangled names:
    ...sym_eig_wide_kernelIfLb1E... is float in shared memory)."""
    import re

    got = {}
    for fn, *rest in ptxas_report(log):
        m = re.search(r"sym_eig_wide_kernelI([fd])Lb([01])E", fn)
        if m:
            got[({"f": "float32", "d": "float64"}[m.group(1)],
                 "shared" if m.group(2) == "1" else "workspace")] = tuple(
                     rest)
    return got


def k4w_frame_gate(log: str):
    """k4w_instances(log), failing unless both forms are there and the
    shared-memory form, float32 and float64, has a 0-byte stack frame and
    no spills."""
    regs = k4w_instances(log)
    if len(regs) != 4:
        fail(f"K4w: want four instantiations, got {sorted(regs)}")
    for key in (("float32", "shared"), ("float64", "shared")):
        if regs[key][1:] != (0, 0, 0):
            fail(f"K4w {key}: want a 0-byte stack frame and no spills, "
                 f"got {regs[key]}")
    return regs


def ldl_instances(log: str):
    """{(kernel, dtype name, rows): (registers, stack bytes, spill stores,
    spill loads)} of ldl.cu's unstamped kernels in a ptxas report: K3's
    ldl_kernel<T, rows, false> (rows 16: the chunks in registers, 0: the
    staged tiles) and K3b's ldl_blocked_kernel<T, false> (rows None)."""
    import re

    got = {}
    for fn, *rest in ptxas_report(log):
        m = re.search(r"ldl_kernelI([fd])Li(\d+)ELb0E", fn)
        b = re.search(r"ldl_blocked_kernelI([fd])Lb0E", fn)
        if m:
            got[("K3", {"f": "float32", "d": "float64"}[m.group(1)],
                 int(m.group(2)))] = tuple(rest)
        elif b:
            got[("K3b", {"f": "float32", "d": "float64"}[b.group(1)],
                 None)] = tuple(rest)
    return got


def ldl_frame_gate(log: str):
    """ldl_instances(log), failing unless the kernels that hold rows in
    registers (K3's 16-row path, K3b's chain), float32 and float64, have a
    0-byte stack frame and no spills."""
    regs = ldl_instances(log)
    for key in (("K3", "float32", 16), ("K3", "float64", 16),
                ("K3b", "float32", None), ("K3b", "float64", None)):
        if key not in regs or regs[key][1:] != (0, 0, 0):
            fail(f"ldl.cu {key}: want a 0-byte stack frame and no spills, "
                 f"got {regs.get(key)}")
    return regs


def k4_round_ms(dtype, threads=None, rounds=(256, 4352)) -> float:
    """Device milliseconds of one round of K4's irreducible chain: the
    parameter arithmetic (two hypot, three IEEE divisions) and one
    shuffle exchange, on one warp (syev.cu's sym_eig_round_probe_{f32,
    f64}, in the syev library loaded now); with `threads`, K4w's round at
    a block of that many threads instead: the same arithmetic, the
    exchange through shared memory and the round's two block barriers
    (sym_eig_wide_round_probe_{f32,f64}). The difference of two chain
    lengths' device times over their difference in rounds, so that the
    launch drops out."""
    import ctypes

    import torch

    from mac_tpu_torch.ops.kernels import _build, syev
    from mac_tpu_torch.ops.kernels.tridiag import SUFFIX

    wide = threads is not None
    fn = getattr(_build.load("syev", syev._SIGNATURES),
                 f"sym_eig{'_wide' if wide else ''}_round_probe_"
                 f"{SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + ([ctypes.c_int] if wide else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty(32, dtype=dtype, device="cuda")

    def run(n):
        err = _build.launch(fn, out.device, out.data_ptr(), n,
                            *([threads] if wide else []))
        if err != 0:
            fail(f"K4's round probe failed to launch: cudaError {err}")

    t = [device_ms(lambda n=n: run(n), reps=20) for n in rounds]
    if not bool(torch.isfinite(out).all()):
        fail("K4's round probe left a non-finite value")
    return (t[1] - t[0]) / (rounds[1] - rounds[0])


def k4w_scratch_check(ks):
    """syev.cu's workspace bytes, shared-memory bytes a block and block
    threads of K4w at each order k, against the wrapper's
    wide_scratch_bytes, wide_smem_bytes and body_for: fail where they
    disagree. Returns {k: (float32 workspace bytes, float64 workspace
    bytes, float32 shared bytes, float64 shared bytes, threads)}."""
    import ctypes

    import torch

    from mac_tpu_torch.ops.kernels import _build, syev

    lib = _build.load("syev", syev._SIGNATURES)
    got = {}
    for k in ks:
        row = []
        for what, py in (("scratch", syev.wide_scratch_bytes),
                         ("smem", syev.wide_smem_bytes)):
            for suffix, itemsize in (("f32", 4), ("f64", 8)):
                fn = getattr(lib, f"sym_eig_wide_{what}_bytes_{suffix}")
                fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
                row.append(fn(k))
                if fn(k) != py(k, itemsize):
                    fail(f"K4w's {what} bytes at k {k} ({suffix}): syev.cu "
                         f"{fn(k)}, the wrapper {py(k, itemsize)}")
        fn = lib.sym_eig_wide_threads
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        got[k] = (*row, fn(k))
    for k, (_, _, b32, b64, _) in got.items():
        for b, dt in ((b32, torch.float32), (b64, torch.float64)):
            want = ("warp" if k <= syev.WARP_MAX_K else "wide_shared"
                    if b <= syev.SMEM_LIMIT else "wide_workspace")
            if syev.body_for(k, dt) != want:
                fail(f"body_for({k}, {dt}) is {syev.body_for(k, dt)}, "
                     f"syev.cu's scratch says {want}")
    return got


# What syev.cu's K4w phase stamps measure (clk[1:]), by the body that
# stamped them (clk[13]): 1, the three-pass K4w (kernel_ab.py's stamped
# copy of its source, ab_fixtures/syev_three_pass_phases.cu); 2, the
# A and V blocks of the cluster (the A block's first pusher thread and its
# thread 0, the V block's thread 0). Each phase is a sum over the launch, per
# "round" or per "sweep" (the stop test) in clock64() cycles, or "ns"
# (%globaltimer nanoseconds, across the two SMs).
K4W_PHASES = {
    1: (("parameters", "round"), ("row update of A and V^T", "round"),
        ("barrier 1 wait", "round"), ("column update of A", "round"),
        ("barrier 2 wait", "round"), ("stop test", "sweep")),
    2: (("pusher: reads and rotations", "round"),
        ("pusher: next round's parameters", "round"),
        ("pusher: barrier wait", "round"),
        ("pair 0's mover: waits for a free slot", "round"),
        ("thread 0: 2 x 2 blocks", "round"),
        ("thread 0: barrier wait", "round"), ("stop test", "sweep"),
        ("V block: waits for a round", "round"),
        ("V block: rotations", "round"),
        ("V block's tail after the A block's end", "ns"))}


def k4w_phases(H, body=None):
    """One launch of K4w on H in the build that stamps its phases
    (syev.wide_phases, the library loaded now; the second of two
    launches): ([(phase, cycles or None, ns, ns a round or a sweep)],
    {"sweeps", "rounds", "body"}), the phases as K4W_PHASES names them for
    the body that stamped them, then ("whole", cycles, ns, ns a round): the
    A block's thread that stamps (body 1: the block), cycles by clock64(),
    ns by the kernel's %globaltimer span over its cycles."""
    from mac_tpu_torch.ops.kernels import syev

    for _ in range(2):
        clk = syev.wide_phases(H, body)[2].cpu().tolist()
    sweeps, rounds, design, total, ns = clk[11:16]
    scale = ns / max(total, 1)
    rows = []
    for i, (name, per) in enumerate(K4W_PHASES[design]):
        v = clk[1 + i]
        if per == "ns":
            rows.append((name, None, v, v))
        else:
            rows.append((name, v, scale * v,
                         scale * v / max(rounds if per == "round" else sweeps,
                                         1)))
    rows.append(("whole", total, ns, ns / max(rounds, 1)))
    return rows, {"sweeps": sweeps, "rounds": rounds, "body": design}


def k4w_phase_line(label, got, card) -> str:
    """k4w_phases's split as one line: ns a round (a sweep for the stop
    test, the whole span for the V block's tail) by phase."""
    rows, info = got
    return (f"K4w phases (body {info['body']}) {label}: {info['rounds']} "
            f"rounds, {info['sweeps']} sweeps; " + ", ".join(
                f"{name} {per:.1f} ns" for name, _, _, per in rows[:-1])
            + f"; whole {rows[-1][2] / 1e3:.2f} us, {rows[-1][3]:.1f} ns a "
            f"round ({card})")


# What ldl.cu's phase stamps measure (clk[1:]), per kernel and, for K3,
# per path (clk[13]: 1 the chunks in registers, 0 the staged tiles).
LDL_PHASES = {
    ("tridiag_ldl_blocked", 0): (
        "finishers' lane max", "chain", "chain's waits for its rows",
        "finishers' waits for the chain's pivots",
        "finishers' tail after the chain"),
    ("tridiag_ldl", 1): ("loads, lane max, step 1", "step 2 (carry)",
                         "step 3 walk", "divisions, stores"),
    ("tridiag_ldl", 0): ("lane max", "step 1", "step 2 (carry)", "step 3")}


def ldl_step_ns(dtype, steps=(128, 1024)):
    """One step of K3b's pivot chain ("K3b": __ddiv_rn then __dsub_rn) and
    of K3's carry ("K3": a 2-vector through a chunk's map, renormalised
    every 8), on one thread with the operands in registers (ldl.cu's step
    probe, in the ldl library loaded now): {chain: {"ns": (device_ms at
    steps[1] - at steps[0]) / their difference, "ns_at": {R: (device_ms
    at R - the floor) / R}, "cycles": clock64 cycles a step}, "floor_ms":
    device_ms of the probe at 0 steps}."""
    import torch

    from mac_tpu_torch.ops.kernels import ldl

    out = torch.zeros(2, dtype=torch.float64, device="cuda")
    floor = device_ms(lambda: ldl.step_probe(dtype, 0, 0, out), reps=20)
    got = {"floor_ms": floor}
    for which, chain in ((0, "K3b"), (1, "K3")):
        t = {R: device_ms(lambda R=R: ldl.step_probe(dtype, R, which, out),
                          reps=20) for R in steps}
        ldl.step_probe(dtype, steps[1], which, out)
        if not bool(torch.isfinite(out).all()):
            fail(f"the ldl step probe ({chain}) left a non-finite value")
        got[chain] = {
            "ns": 1e6 * (t[steps[1]] - t[steps[0]]) / (steps[1] - steps[0]),
            "ns_at": {R: 1e6 * (t[R] - floor) / R for R in steps},
            "cycles": float(out[1]) / steps[1]}
    return got


def ldl_phases(name, args):
    """[(phase, cycles, ns)] of one launch of K3 (name "tridiag_ldl", args
    (d, e)) or K3b ("tridiag_ldl_blocked", (d, e, block)) in the build that
    stamps its phases (ldl.phases; LDL_PHASES names them), then ("whole",
    cycles, ns) of the launch: thread 0 of the first block, cycles by
    clock64(), ns by the kernel's %globaltimer span over its cycles; the
    second of two launches."""
    from mac_tpu_torch.ops.kernels import ldl

    block = args[2] if len(args) == 3 else None
    for _ in range(2):
        clk = ldl.phases(args[0], args[1], block)[2].cpu().tolist()
    m, total, ns = clk[0], clk[14], clk[15]
    scale = ns / max(total, 1)
    rows = [(LDL_PHASES[name, clk[13]][i], clk[1 + i], scale * clk[1 + i])
            for i in range(m)]
    return rows + [("whole", total, ns)]


def kernels_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of the kernels of one call of fn(): torch.
    profiler with CUDA activity alone over `reps` calls, the kernels'
    durations summed (copies and memsets left out) over reps. For a call
    that synchronises (torch.linalg.eigh), whose device time device_ms
    cannot take."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.end_ns() - e.start_ns()
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and not e.name().startswith(("Memcpy", "Memset")))
    return ns / 1e6 / reps


def by_dtype(counted):
    """{wrapper name: {dtype: launches}} of the kernel wrappers."""
    return {kern.__name__: dict(kern.launches_by_dtype) for kern in counted}


def profiled_busy(fn, host_calls=None):
    """(device busy milliseconds, kernels and copies, the three largest
    kernels as (milliseconds, count, name)) of one call of fn(): its device
    activity under torch.profiler, CUDA activity alone, summed from the raw
    activity records (building the profiler's event tree for the ~150k
    kernels of a GreedyESP scan takes most of a minute). host_calls: a
    dict that receives the count of each CUDA runtime launch call the
    profiler recorded on the host (cudaLaunchKernel, cudaGraphLaunch, ...),
    the launches the host enqueued, where the device count above also
    holds each kernel a graph replays."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns, cnt = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.end_ns() - e.start_ns(), cnt + 1)
        elif host_calls is not None and e.name().startswith("cuda") \
                and "Launch" in e.name():
            host_calls[e.name()] = host_calls.get(e.name(), 0) + 1
    top = sorted(((ns / 1e6, cnt, name[:80]) for name, (ns, cnt)
                  in by_name.items()), reverse=True)[:3]
    return (sum(ns for ns, _ in by_name.values()) / 1e6,
            sum(cnt for _, cnt in by_name.values()), top)


def chain_instance(n, m, seed, extra=None):
    """A weighted chain, plus the fixed edge `extra` when given (the fixed
    set is then not a chain: GreedyESP's Z path), and m distinct candidates
    spanning more than 1, as tests/solvers/test_baselines.py builds them.
    Returns (fixed, candidates)."""
    import numpy as np

    from mac_tpu_torch.utils.graphs import Edge

    rng = np.random.RandomState(seed)
    fixed = [Edge(i, i + 1, 0.5 + rng.rand()) for i in range(n - 1)]
    if extra is not None:
        fixed.append(Edge(*extra))
    cands, seen = [], set()
    while len(cands) < m:
        i, j = sorted(rng.randint(0, n, 2))
        if j - i > 1 and (i, j) not in seen and (
                extra is None or (i, j) != extra[:2]):
            seen.add((i, j))
            cands.append(Edge(int(i), int(j), 0.5 + rng.rand()))
    return fixed, cands


class Phase:
    """Prints the wall time of each phase as the next one starts."""

    def __init__(self):
        self.t_start = self.t0 = time.perf_counter()
        self.name = None

    def __call__(self, name):
        self.end()
        self.name, self.t0 = name, time.perf_counter()
        print(f"== phase {name}", flush=True)

    def end(self):
        if self.name is not None:
            print(f"== phase {self.name} wall {time.perf_counter() - self.t0:.3f}"
                  f" s (total {time.perf_counter() - self.t_start:.3f} s)",
                  flush=True)
            self.name = None


def pose_graph(n, n_loops, span, seed):
    """Odometry chain plus short-range loop closures (banded after RCM)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loops = set()
    while len(loops) < n_loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(span))
        if j - i > 1:
            loops.add((i, j))
    idx = np.concatenate([chain, np.array(sorted(loops))]).astype(np.int64)
    return idx, 0.5 + rng.rand(len(idx)), n


def wide_graph(n, n_loops, span, seed, dup=0):
    """Odometry chain plus loop closures spanning up to `span` nodes, the
    first `dup` of them repeated (duplicate edges share a slot row)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    lo = rng.randint(0, n - 2, n_loops)
    loops = np.stack([lo, np.minimum(n - 1, lo + 2 + rng.randint(0, span,
                                                                  n_loops))], 1)
    idx = np.concatenate([chain, loops, loops[:dup]]).astype(np.int64)
    return idx, 0.5 + rng.rand(len(idx)), n


def synthetic(n, seed=0, local=False):
    """Odometry chain plus random loop closures (scripts/bench_scale.py's
    generator, kept here so the script stands alone). local=False: spans
    up to n/4, an expander-like graph with no narrow band (the matrix-free
    ELL route); local=True: spans <= 290 (banded)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    fixed_idx = np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int32)
    w_fixed = 0.5 + rng.rand(n - 1)
    m_loops = n // 2
    if local:
        lo = rng.randint(0, n - 300, m_loops)
        cand_idx = np.stack(
            [lo, lo + 2 + rng.randint(0, 290, m_loops)], 1).astype(np.int32)
        return fixed_idx, w_fixed, cand_idx, 0.5 + rng.rand(m_loops)
    lo = rng.randint(0, n - 3, 2 * m_loops)
    span = rng.randint(2, n // 4, 2 * m_loops)
    hi = lo + span
    keep = hi <= n - 1  # rejected, not clamped
    cand_idx = np.stack([lo[keep], hi[keep]], 1)[:m_loops].astype(np.int32)
    return fixed_idx, w_fixed, cand_idx, 0.5 + rng.rand(len(cand_idx))


def dataset_inputs(dev, name="city10000"):
    """A bundled banded dataset at K = 50% of its loop closures, x_init from
    NaiveGreedy: (path of the g2o file, n, fixed, cands, K, x_init, banded
    tables on dev, edge weights w at x_init, the chain factor's dp and l in
    float32, a (n, 4) right-hand side from seed 0)."""
    import numpy as np
    import torch

    import mac_tpu_torch
    from mac_tpu_torch.ops import banded
    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers import NaiveGreedy

    repo = Path(mac_tpu_torch.__file__).resolve().parent.parent
    dataset = repo / "data" / f"{name}.g2o"
    meas, n = read_g2o_file(str(dataset))
    fixed, cands = split_edges(rpm_to_mac(meas))
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    idx = np.array([[e.i, e.j] for e in fixed + cands])
    w_all = np.concatenate([[e.weight for e in fixed],
                            x_init * np.array([e.weight for e in cands])])
    bop = banded.build_banded_rcm(idx, n)[0].to(dev)
    w = torch.as_tensor(w_all, dtype=torch.float32, device=dev)
    fac = banded.chain_factor(bop, banded.assemble_bd(bop, w), w)
    B = torch.randn((n, 4), generator=torch.Generator().manual_seed(0)).to(dev)
    return (dataset, n, fixed, cands, k, x_init, bop, w,
            fac.dp.float().contiguous(), fac.l.float().contiguous(), B)


def k2_args(bop, w):
    """assemble_ut's arguments for the banded tables bop at edge weights w
    (m,), or at the lanes of w (R, m) (as ops.banded.assemble_bd gathers
    them)."""
    import torch

    w_pad = torch.cat([-w, w.new_zeros((*w.shape[:-1], 1))], dim=-1)
    dd = bop.du_dense
    return (bop.dcol_tbl[:dd].contiguous(),
            w_pad[..., bop.ueid_tbl[:dd]].contiguous(), bop.ocol_tbl,
            bop.olane_tbl, w_pad[..., bop.oeid_tbl].contiguous(), bop.half,
            bop.nb)


def index_add_assembly(args):
    """The library yardstick of assemble_ut: a callable that computes the
    same ut as one index_add_ of the slot weights into a zeroed ut (of
    every lane), at flat positions computed once here from the slot
    tables."""
    import torch

    from mac_tpu_torch.ops.banded import BS

    dcol, wu, ocol, olane, ow, half, nb = args
    dev = wu.device
    lanes = wu.shape[0] if wu.dim() == 3 else 1

    def flat_pos(col, lane_global):
        t = col // BS - 1
        b, r = lane_global // BS, lane_global % BS
        ok = (col >= BS) & (col < BS * (half + 2))
        return (((t * nb + b) * BS + col % BS) * BS + r)[ok], ok

    p1, ok1 = flat_pos(dcol.long(),
                       torch.arange(nb * BS, device=dev).expand_as(dcol))
    p2, ok2 = flat_pos(ocol.long(), olane.long() + BS * torch.arange(
        nb, device=dev)[None, :])
    size = (half + 1) * nb * BS * BS
    offs = size * torch.arange(lanes, device=dev)[:, None]
    pos = torch.cat([(offs + p1).reshape(-1), (offs + p2).reshape(-1)])
    wu3, ow3 = wu.reshape(lanes, *dcol.shape), ow.reshape(lanes, *ocol.shape)
    vals = torch.cat([wu3[:, ok1].reshape(-1), ow3[:, ok2].reshape(-1)])
    shape = (half + 1, nb, BS, BS) if wu.dim() == 2 else (
        lanes, half + 1, nb, BS, BS)

    def library():
        out = torch.zeros(shape, dtype=wu.dtype, device=dev)
        return out.view(-1).index_add_(0, pos, vals).view(shape)

    return library


def k2_times(args, label, card):
    """Kernel, plain and library times and the bound of one assembly (its
    weights float32 or float64)."""
    from mac_tpu_torch.ops.banded import BS
    from mac_tpu_torch.ops.kernels.assemble import (assemble_ut,
                                                    assemble_ut_plain)

    dcol_, wu_, ocol_, olane_, ow_, half_, nb_ = args
    lanes = wu_.shape[0] if wu_.dim() == 3 else 1
    library = index_add_assembly(args)
    lib_err = float((library() - assemble_ut_plain(*args)).abs().max())
    tm = {"device_ms": device_ms(lambda: assemble_ut(*args)),
          "call_ms": call_ms(lambda: assemble_ut(*args)),
          "plain_ms": call_ms(lambda: assemble_ut_plain(*args)),
          "library_ms": device_ms(library),
          "library_call_ms": call_ms(library)}
    nbytes = sum(t.numel() * t.element_size()
                 for t in (dcol_, wu_, ocol_, olane_, ow_)) \
        + wu_.element_size() * lanes * (half_ + 1) * nb_ * BS * BS
    tm["bound_ms"], tm["bound_by"] = bound(
        nbytes, wu_.numel() + ow_.numel(), wu_.element_size())
    print(f"{label}: kernel device {tm['device_ms']:.5f} ms, call "
          f"{tm['call_ms']:.4f} ms, plain call {tm['plain_ms']:.4f} ms, "
          f"index_add_ device {tm['library_ms']:.5f} ms, call "
          f"{tm['library_call_ms']:.4f} ms (max |index_add_ - plain| "
          f"{lib_err:.2e}), bound {tm['bound_ms']:.5f} ms "
          f"({tm['bound_by']}) ({card})", flush=True)
    return tm


# Phase 3f: K5, K6, K1p and K7 against their plain versions, relative in
# norm (K1p is also held bitwise to K1 on the gathered input).
CG_TOL = {"float32": 1e-5, "float64": 1e-12}


def rel_norm(got, ref) -> float:
    """||got - ref|| / ||ref|| in float64 (0 when both are 0)."""
    import torch

    d = torch.linalg.vector_norm((got - ref).double())
    r = torch.linalg.vector_norm(ref.double())
    return float(d / r) if float(r) > 0 else float(d)


def bsr_library(bop, BD, V):
    """One torch.sparse call computing L(w) V: L as a BSR matrix of 128 x
    128 blocks over the padded rows (built here, not timed), times V
    padded; None where torch refuses the dtype or layout on the card."""
    import torch

    from mac_tpu_torch.ops.banded import banded_upper

    try:
        U = banded_upper(BD.ut, bop.nb)
        L = U + U.mT + torch.diag(BD.deg.reshape(-1))
        Lbsr = L.to_sparse_bsr((128, 128))
        del U, L
        Vp = torch.zeros((bop.n_pad, V.shape[-1]), dtype=V.dtype,
                         device=V.device)
        Vp[:bop.n] = V

        def run():
            return torch.sparse.mm(Lbsr, Vp)

        run()
        torch.cuda.synchronize()
        return run
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        print(f"  torch.sparse.mm of a BSR L(w) ({V.dtype}): not available "
              f"here ({str(exc).splitlines()[0][:120]})", flush=True)
        return None


def cg_case(label, card, kern, plain, nbytes, flops, itemsize, tol,
            library=None, fresh=None, same_as=None, rate=None):
    """One kernel case of phase 3f: kern() twice (its outputs bitwise
    equal), plain() once on the same inputs (relative error in norm within
    tol, and max |kern - plain|), same_as() (if given) bitwise kern's; then
    device and call times, the plain version's call time, the bound from
    (bytes, operations) and the library call's device time. `fresh`
    (if given) restores in-place inputs before each checked call. Returns
    the timing dict."""
    import torch

    def outs(fn):
        if fresh is not None:
            fresh()
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        return tuple(t.clone() for t in got if t is not None)

    a, b, ref = outs(kern), outs(kern), outs(plain)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    err = max(rel_norm(x, y) for x, y in zip(a, ref))
    abs_err = max(float((x - y).abs().max()) for x, y in zip(a, ref))
    if same_as is not None:
        twin = outs(same_as)
        if not all(torch.equal(x, y) for x, y in zip(a, twin)):
            fail(f"3f {label}: not bitwise its twin (the kernel it shares a "
                 f"body with)")
    tm = {"device_ms": device_ms(kern), "call_ms": call_ms(kern),
          "plain_ms": call_ms(plain), "max_abs_err": abs_err,
          "rel_err": err, "bitwise_repeat": same,
          "library_ms": None if library is None else device_ms(library)}
    tm["bound_ms"], tm["bound_by"] = bound(nbytes, flops, itemsize, rate)
    print(f"3f {label}: kernel device {tm['device_ms']:.5f} ms, call "
          f"{tm['call_ms']:.4f} ms, plain call {tm['plain_ms']:.4f} ms, "
          f"library {tm['library_ms']}, bound {tm['bound_ms']:.5f} ms "
          f"({tm['bound_by']}); relative error in norm {err:.3e} (max abs "
          f"{abs_err:.3e}), two calls bitwise {same} ({card})", flush=True)
    if not same:
        fail(f"3f {label}: two calls differ")
    if not err <= tol:
        fail(f"3f {label}: relative error {err:.3e} above {tol}")
    return tm


def cg_inputs(dev, bop, w, bop_sp, w_sp, rng):
    """Phase 3f's operators: {"float32", "float64": city10000's (BD, the
    V-cycle M) at the start weights, "lanes": at 8 scaled weights (drawn
    from rng), "sphere": sphere2500's}."""
    import torch

    from mac_tpu_torch.ops import banded

    def setup(op, ws, dtype):
        BD = banded.assemble_bd(op, ws.to(dtype))
        M = banded.make_banded_precond(op, BD, w=ws.to(dtype))
        return BD, M

    bds = {"float32": setup(bop, w, torch.float32),
           "float64": setup(bop, w, torch.float64)}
    ws8 = torch.stack([w * float(0.5 + rng.rand()) for _ in range(8)])
    bds["lanes"] = setup(bop, ws8, torch.float32)
    bds["sphere"] = setup(bop_sp, w_sp, torch.float32)
    return bds


def k5_cases(dev, bop, bop_sp, bds, rng):
    """Phase 3f's K5 cases (banded_product on the main paths' shapes):
    [(key, label, kernel(), plain(), bytes, operations, itemsize,
    tolerance, library() or None, FLOP/s of the body's unit or None)]; V
    (and B) drawn from rng, the cases since the redesign from a
    RandomState of their own, so that the earlier cases' inputs stay as
    they were. The bytes read once and written once (ut, deg, V, B, out),
    the operations 2 q (2 half + 1) BS^2 per block row and lane; the
    unit's rate for the wide body (q > K5_NARROW_MAX_Q) the tensor cores':
    float32 as 3xTF32, three products at the TF32 peak, float64 on DMMA
    (None, the SIMT peak, for the narrow body); the library call
    torch.sparse.mm of L(w) as BSR for the plain form without lanes."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.banded import BS
    from mac_tpu_torch.ops.kernels import banded as kb
    from mac_tpu_torch.ops.kernels import pcg as kp

    cases = []
    rng19 = np.random.RandomState(19)

    def k5(key, label, op, BD, q, form, lanes=None, r=rng):
        dtype = BD.ut.dtype
        n = op.n
        V = torch.as_tensor(r.normal(size=((lanes,) if lanes else ())
                                     + (n, q)), dtype=dtype, device=dev)
        kw = {}
        if form == "inner":
            c = (2.0 * BD.deg.amax(dim=(-2, -1))).to(dtype)
            kw = dict(vsum=kp.col_sums(V), c=c,
                      sigma=32 * torch.finfo(dtype).eps * c, dot=True)
        elif form == "residual":
            B = torch.as_tensor(r.normal(size=V.shape), dtype=dtype,
                                device=dev)
            kw = dict(B=B, bsum=kp.col_sums(B))
        ut, deg = BD.ut, BD.deg
        it = V.element_size()
        ln = lanes or 1
        nbytes = it * (ut.numel() + deg.numel() + (2 + (form == "residual"))
                       * ln * n * q)
        flops = 2.0 * q * (2 * op.half + 1) * op.nb * BS * BS * ln
        lib = (bsr_library(op, BD, V) if lanes is None and form == "plain"
               else None)
        rate = None
        if q > kb.K5_NARROW_MAX_Q:
            rate = H100_TF32_TC_FLOPS / 3 if it == 4 else H100_F64_TC_FLOPS
        cases.append((key, label,
                      lambda: kb.banded_product(ut, deg, V, n, **kw),
                      lambda: kb.banded_product_plain(ut, deg, V, n, **kw),
                      nbytes, flops, it, CG_TOL[str(dtype).split(".")[-1]],
                      lib, rate))

    BD32, BD64 = bds["float32"][0], bds["float64"][0]
    BD8, BDsp = bds["lanes"][0], bds["sphere"][0]
    nc = bop.coarse_nc
    k5("K5", "(10000, 4) inner form with the dots, the CG step's A P", bop,
       BD32, 4, "inner")
    k5("K5_residual", "(10000, 4) residual form, the V-cycle's", bop, BD32,
       4, "residual")
    k5("K5_plain", "(10000, 4) plain form (library: BSR L(w) V)", bop, BD32,
       4, "plain")
    k5("K5_12", "(10000, 12) plain form, the outer iteration's A Q", bop,
       BD32, 12, "plain")
    k5("K5_nc", f"(10000, {nc}) plain form, the coarse assembly's L R", bop,
       BD32, nc, "plain")
    k5("K5_sphere", "sphere2500 (2500, 4) inner form with the dots", bop_sp,
       BDsp, 4, "inner")
    k5("K5_lanes", "(8, 10000, 4) inner form with the dots, 8 lanes", bop,
       BD8, 4, "inner", lanes=8)
    k5("K5_f64", "(10000, 4) inner form with the dots, float64", bop, BD64,
       4, "inner")
    k5("K5_f64_plain", "(10000, 4) plain form, float64 (library: BSR)", bop,
       BD64, 4, "plain")
    k5("K5_nc_f64", f"(10000, {nc}) plain form, float64, the banded float64 "
       "route's coarse assembly (library: BSR)", bop, BD64, nc, "plain",
       r=rng19)
    k5("K5_11", "(10000, 11) inner form with the dots, the q = 11 CG step's "
       "A P", bop, BD32, 11, "inner", r=rng19)
    k5("K5_33", "(10000, 33) plain form, the q = 11 outer iteration's A Q "
       "(library: BSR)", bop, BD32, 33, "plain", r=rng19)
    return cases


def greedy_eig_table(dev, dataset):
    """(operator, weights) of GreedyEig's incumbent on intel at its start
    (the odometry chain, every candidate at weight 0), as phase 7c's
    GreedyEig builds them: the ELL table its 64 trial lanes share."""
    import numpy as np

    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers.greedy_eig import GreedyEig

    meas, n_i = read_g2o_file(str(Path(dataset).parent / "intel.g2o"))
    fixed_i, cands_i = split_edges(rpm_to_mac(meas))
    eig = GreedyEig(fixed_i, cands_i, n_i, device=dev)
    return eig.op, eig._weights(np.zeros(len(cands_i)))


def ell_inputs(dev, dataset):
    """Phase 3f's matrix-free inputs: (op5, w5, W5, op_ge, w_ge), the
    n = 100000 expander's operator at its start weights (phase 5), phase
    8b's two budget lanes' weights (2, m) and greedy_eig_table's."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops import laplacian

    fi5, wf5, ci5, wc5 = synthetic(SCALE_N, seed=0, local=False)
    op5 = laplacian.build_operator(np.concatenate([fi5, ci5]),
                                   SCALE_N).to(dev)
    x = np.zeros((3, len(wc5)))
    for r, k_ in enumerate((len(wc5) // 4, 6250, 12500)):
        x[r, np.argpartition(wc5, -k_)[-k_:]] = 1.0
    W = torch.as_tensor(np.concatenate(
        [np.broadcast_to(wf5, (3, len(wf5))), x * wc5], axis=1),
        dtype=torch.float32, device=dev)
    return (op5, W[0].contiguous(), W[1:].contiguous(),
            *greedy_eig_table(dev, dataset))


def cg_kernels(dev, card, bop, w, bop_sp, w_sp, ell=None):
    """Phase 3f: K5 (banded_product, k5_cases: the CG step's inner form
    with its dots at city10000's (10000, 4) and the q = 11 step's (10000,
    11), the V-cycle's residual form, the outer iteration's (10000, 12)
    and (10000, 33), the coarse assembly's nc = 500 columns in float32 and
    float64, sphere2500's (2500, 4), 8 lanes (8, 10000, 4), float64), K6
    (col_sums, cg_update, cg_direction_dots; float32, float64, 8 lanes),
    K1p
    (tridiag_solve_permuted: the cycle's first smoothing with its
    centring, the second adding into x with its column sums, 8 lanes,
    float64, and the tiled branch at (32768, 16) float64) and K7
    (coarse_correct; float32, float64, 8 lanes) against their plain
    versions on the card: two calls bitwise equal, the error, device /
    call / plain / bound / library times. With `ell` (ell_inputs'
    tuple), the matrix-free route's too: K8 (ell_product, k8_cases; its
    dots bitwise dot_model's; library: torch.sparse.mm of L(w) as CSR)
    and its V-cycle's K1p and K7 through the identity permutation
    (ell_cycle_cases: K1p's segment body at seg 1024 and K7 at s 196 at
    (100000, 4), float64, 2 lanes; at GreedyEig's (1728, 256) K1p's
    cluster body and K7 at s 4). Returns {key: timing dict with "name",
    "shape", "source", "replaces"}."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels import pcg as kp

    out = {}
    rng = np.random.RandomState(18)

    def rand(*shape, dtype=torch.float32):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=dev)

    bds = cg_inputs(dev, bop, w, bop_sp, w_sp, rng)
    src5 = "mac_tpu_torch/csrc/banded.cu"
    rep5 = "mac_tpu/ops/banded.py:466 (banded_apply; not Pallas)"
    for (key, label, kern, plain, nbytes, flops, it, tol, lib,
         rate) in k5_cases(dev, bop, bop_sp, bds, rng):
        tm = cg_case(f"K5 {label}", card, kern, plain, nbytes, flops, it,
                     tol, library=lib, rate=rate)
        out[key] = dict(tm, name="banded_product", shape=label, source=src5,
                        replaces=rep5)

    # K6 at the CG step's shapes.
    floors6 = k6_floors(dev)
    print("3f K6 launch floors (the smallest launch of each wrapper): "
          + ", ".join(f"{k} {v:.5f} ms" for k, v in floors6.items())
          + f" ({card})", flush=True)
    for c in k6_cases(dev, bop.n, rng):
        tm = cg_case(c["label"], card, c["kernel"], c["plain"], c["bytes"],
                     c["flops"], c["itemsize"], c["tol"], library=c["library"],
                     fresh=c["fresh"])
        if c["model"] is not None:
            got_sums, want_sums = c["model"]()
            if not torch.equal(got_sums, want_sums):
                fail(f"3f {c['label']}: {c['model_of']}")
        out[c["key"]] = dict(tm, name=c["name"], shape=c["shape"],
                             floor_ms=floors6[f"K6 {c['name']}"],
                             source="mac_tpu_torch/csrc/pcg.cu",
                             replaces="mac_tpu/ops/cg.py:52 (pcg_fixed's loop "
                                      "body; not Pallas)")

    # K1p (both bodies) and K7 on the cycles' factors and coarse inverses.
    srcs = {"K1p": "mac_tpu_torch/csrc/tridiag.cu",
            "K7": "mac_tpu_torch/csrc/banded.cu"}
    reps = {"K1p": ("mac_tpu/ops/pallas/tridiag_kernel.py:77 with the "
                    "gathers of mac_tpu/ops/banded.py:793-800"),
            "K7": "mac_tpu/ops/banded.py:795-797 (restrict, Lc_inv @, "
                  "prolong)"}
    floors = launch_floors(dev)
    print("3f launch floors (the smallest launch of each wrapper): " + ", "
          .join(f"{k} {v:.5f} ms" for k, v in floors.items())
          + f" ({card})", flush=True)
    ell_cases = [] if ell is None else ell_cycle_cases(dev, *ell)
    reps.update(K1p_ell=("mac_tpu/ops/pallas/tridiag_kernel.py:107 and :77 "
                         "in the two-grid V-cycle's smooth, "
                         "mac_tpu/ops/twogrid.py:109-110, with its centring"),
                K7_ell="mac_tpu/ops/twogrid.py:112-129 (restrict, Lc_inv @, "
                       "prolong)")
    for c in (k1p_cases(dev, bop, bop_sp, bds)
              + k7_cases(dev, bop, bop_sp, bds) + ell_cases):
        kern = c["kernel"]
        tm = cg_case(c["label"], card, lambda: kern(c["seg"]), c["plain"],
                     c["bytes"], c["flops"], c["itemsize"], c["tol"],
                     fresh=c["fresh"], same_as=c["twin"])
        if c["model"] is not None:
            got_sums, want_sums = c["model"]()
            if not torch.equal(got_sums, want_sums):
                fail(f"3f {c['label']}: column sums not bitwise their "
                     f"order's model (k1p_segment_sum_model)")
        kind = c["key"].split("_")[0]
        rep = reps[kind + "_ell"] if "_ell" in c["key"] else reps[kind]
        out[c["key"]] = dict(tm, name=c["name"], shape=c["shape"],
                             body=c["body"], floor_ms=floors[c["floor"]],
                             source=srcs[kind], replaces=rep)
    if ell is None:
        return out

    # K8, the matrix-free route's ELL product.
    from mac_tpu_torch.ops.kernels import _build
    from mac_tpu_torch.ops.kernels import ell as k8

    # K8 keeps a trip's gathers in registers under its launch bounds: no
    # stack frame and no spill in either instantiation.
    k8_regs = ptxas_report(_build.ptxas_log("ell"))
    print("3f K8 instantiations (registers, stack frame bytes, spill "
          "stores, spill loads): " + ", ".join(
              f"{fn[-40:]}: {rest}" for fn, *rest in k8_regs), flush=True)
    if len(k8_regs) != 2 or any(any(rest[1:]) for _, *rest in k8_regs):
        fail(f"3f K8: an instantiation has a stack frame or spills, or one "
             f"is missing: {k8_regs}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c in k8_cases(dev, *ell):
        regs, per_sm = k8.occupancy(c["dtype"], dev)
        grid = k8.grid_blocks(*c["grid"])
        waves = -(-grid // max(per_sm * sms, 1))
        print(f"3f {c['label']}: {regs} registers a thread, {per_sm} "
              f"resident blocks a SM ({per_sm * sms} on {sms} SMs), grid "
              f"{grid} blocks, {waves} wave{'s' if waves > 1 else ''} "
              f"({card})", flush=True)
        tm = cg_case(c["label"], card, c["kernel"], c["plain"], c["bytes"],
                     c["flops"], c["itemsize"], c["tol"],
                     library=c["library"])
        if c["model"] is not None:
            got_dots, want_dots = c["model"]()
            if not torch.equal(got_dots, want_dots):
                fail(f"3f {c['label']}: the column dots not bitwise their "
                     f"order's model (ell.dot_model)")
        out[c["key"]] = dict(tm, name=c["name"], shape=c["shape"],
                             floor_ms=floors["K8"], registers=regs,
                             resident_blocks=per_sm, waves=waves,
                             source="mac_tpu_torch/csrc/ell.cu",
                             replaces="mac_tpu/ops/laplacian.py:169 "
                                      "(_ell_apply; not Pallas)")
    return out


# Phase 3f: K9 and K10 (csrc/fw.cu) against their plain versions: g, s, x,
# the tail average, the weights, the counters and the stop flag bitwise; u
# and ||g|| within these relative tolerances by dtype (the plain version's
# are cuBLAS's dot and PyTorch's norm, the kernel's its own sums in double).
FW_TOL = {"float32": 1e-6, "float64": 1e-14}
FW_PLAINS = ("fw_oracle_plain", "fw_update_plain")


def fw_kernels(dev, card, cands, synth):
    """Phase 3f for K9 (fw_oracle) and K10 (fw_update): at city10000's
    shape (m 10688 candidates with their endpoints, k 5344, a random Ritz
    block (10000, 4)) in float32 and float64 and at the n = 100000
    expander's (m 50000, k 12500; `synth` its instance) in float32: K9 at
    k = m / 2, 1 and m - 1, with half the nodes at one value of v (g = 0
    ties across the threshold), with v in {0, 1, 2} and unit weights (the
    threshold inside a run of equal values) and with NaN nodes (against
    the plain version on the card and on a CPU copy); K10 from K9's g and
    s at the start point k / m and at a random feasible x, the stop test
    off and fired, before the tail average and on it (counts 2 and 5), its
    ||g|| output read. Each: two calls bitwise, the plain version bitwise
    (u and ||g|| within FW_TOL), and a CUDA graph of the pair K9 then K10,
    replayed, bitwise the eager pair. Then device, call and plain times at
    each shape (K10 on the tail average's step), the bound (bytes: K9 v,
    the endpoints, w_cand, g and s; K10 g, s, x, xavg, w_cand read, x, xavg,
    w written) and K9's yardstick, torch.topk with scatter_ (device time;
    its tie order is not the reference's, so it is timed only). Returns
    {key: timing dict}."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels import fw as kfw

    rng = np.random.RandomState(24)
    ci = np.array([[e.i, e.j] for e in cands], dtype=np.int32)
    shapes = {"city": (10000, ci, np.array([e.weight for e in cands]),
                       len(cands) // 2),
              "scale": (SCALE_N, synth[2].astype(np.int32), synth[3],
                        len(synth[3]) // 4)}
    out = {}

    def state(m, dt, x):
        return dict(x=torch.tensor(x, dtype=dt, device=dev),
                    u=torch.tensor(float("inf"), dtype=dt, device=dev),
                    xavg=torch.zeros(m, dtype=dt, device=dev),
                    counters=torch.zeros(2, dtype=torch.int32, device=dev),
                    done=torch.zeros((), dtype=torch.bool, device=dev),
                    w=torch.zeros(m, dtype=dt, device=dev),
                    norm=torch.zeros((), dtype=dt, device=dev))

    def oracle_check(label, V, ends, wc, k, cpu_ref=False):
        g, s = kfw.fw_oracle(V, ends, wc, k)
        g2, s2 = kfw.fw_oracle(V, ends, wc, k)
        if cpu_ref:
            gp, sp = (t_.to(dev) for t_ in kfw.fw_oracle_plain(
                V.cpu(), ends.cpu(), wc.cpu(), k))
        else:
            gp, sp = kfw.fw_oracle_plain(V, ends, wc, k)
        def eq(a, b):  # bitwise, NaN equal to NaN
            return (torch.equal(a.isnan(), b.isnan())
                    and torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0)))

        same = (eq(g, gp) and torch.equal(s, sp) and eq(g, g2)
                and torch.equal(s, s2) and int(s.sum()) == k)
        print(f"3f K9 {label} {V.dtype} (m {len(wc)}, k {k}): g and s "
              f"{'bitwise' if same else 'NOT bitwise'} the plain version's"
              f"{' (on a CPU copy)' if cpu_ref else ''}, two calls "
              f"bitwise, {int(s.sum())} selected ({card})", flush=True)
        if not same:
            fail(f"3f K9 {label}: not bitwise its plain version or not "
                 f"repeatable: {int((s != sp).sum())} selections differ")
        return g, s

    def update_check(label, f, g, s, x, wc, k, *, gap_tol, tail_from,
                     it, cnt):
        dt = g.dtype
        m = len(g)
        got = []
        for fn in (kfw.fw_update, kfw.fw_update, kfw.fw_update_plain):
            st = state(m, dt, x)
            st["counters"].copy_(torch.tensor([it, cnt], dtype=torch.int32))
            st["xavg"].copy_(st["x"].flip(0))
            fn(f, g, s, st["x"], st["u"], st["xavg"], st["counters"],
               st["done"], st["w"], wc, grad_norm_tol=1e-8,
               gap_tol=gap_tol, tail_from=tail_from, mask_tol=1e-10,
               norm=st["norm"])
            got.append(st)
        a, b, p = got
        exact = ("x", "xavg", "w", "counters", "done")
        same = all(torch.equal(a[n_], p[n_]) for n_ in exact)
        repeat = all(torch.equal(a[n_], b[n_]) for n_ in a)
        rel = {n_: abs(float(a[n_]) - float(p[n_])) / abs(float(p[n_]))
               for n_ in ("u", "norm")}
        tol = FW_TOL[str(dt).split(".")[-1]]
        if bool(a["done"]) != (gap_tol > 1.0):
            fail(f"3f K10 {label}: the gap stop did not fire as set up")
        print(f"3f K10 {label} {dt} (m {m}): x, xavg, w, counters "
              f"{a['counters'].tolist()} and done {bool(a['done'])} "
              f"{'bitwise' if same else 'NOT bitwise'} the plain "
              f"version's, two calls {'bitwise' if repeat else 'differ'}; "
              f"u relative {rel['u']:.3e}, ||g|| relative "
              f"{rel['norm']:.3e} (within {tol}) ({card})", flush=True)
        if not (same and repeat and max(rel.values()) <= tol):
            fail(f"3f K10 {label}: not bitwise its plain version, not "
                 f"repeatable, or u / ||g|| off: {rel}")
        return max(abs(float(a[n_]) - float(p[n_])) for n_ in ("u", "norm"))

    def graph_check(label, V, ends, wc, k, x, f):
        """K9 then K10 captured in a CUDA graph over static tensors,
        replayed once from the same state as an eager pair: bitwise."""
        dt = V.dtype
        m = len(wc)
        res = {}
        for way in ("eager", "graph"):
            st = state(m, dt, x)
            st["counters"].copy_(torch.tensor([20, 3], dtype=torch.int32))

            def pair():
                g_, s_ = kfw.fw_oracle(V, ends, wc, k)
                kfw.fw_update(f, g_, s_, st["x"], st["u"], st["xavg"],
                              st["counters"], st["done"], st["w"], wc,
                              grad_norm_tol=1e-8, gap_tol=0.0, tail_from=16,
                              mask_tol=1e-10)
                return g_, s_

            if way == "eager":
                g_, s_ = pair()
            else:
                saved = {n_: v.clone() for n_, v in st.items()}
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    g_, s_ = pair()
                for n_, v in saved.items():
                    st[n_].copy_(v)
                graph.replay()
            torch.cuda.synchronize()
            res[way] = dict(st, g=g_.clone(), s=s_.clone())
        same = all(torch.equal(res["eager"][n_], res["graph"][n_])
                   for n_ in res["eager"])
        print(f"3f K9 + K10 {label} {dt}: a replayed graph of the pair "
              f"{'bitwise' if same else 'NOT bitwise'} the eager pair "
              f"({card})", flush=True)
        if not same:
            fail(f"3f K9 + K10 {label}: the replayed pair differs")

    for key, dt in (("city", torch.float32), ("city", torch.float64),
                    ("scale", torch.float32)):
        n, ends_np, wc_np, k = shapes[key]
        m = len(wc_np)
        ends = torch.as_tensor(ends_np, device=dev).contiguous()
        wc = torch.as_tensor(wc_np, dtype=dt, device=dev)
        V = torch.as_tensor(rng.normal(size=(n, 4)), dtype=dt, device=dev)
        tag = f"{key} {str(dt).split('.')[-1]}"
        g, s = oracle_check(f"{tag} k = m / 2", V, ends, wc, k)
        for kk in (1, m - 1):
            oracle_check(f"{tag} k = {kk}", V, ends, wc, kk)
        Vt = V.clone()
        Vt[: n // 2, 0] = 0.25
        zeros = int((Vt[ends[:, 0].long(), 0]
                     == Vt[ends[:, 1].long(), 0]).sum())
        gt, st_ = oracle_check(f"{tag} ties (g = 0 x {zeros})", Vt, ends, wc,
                               m - zeros // 2)
        if not 0 < int(st_[gt == 0].sum()) < zeros:
            fail(f"3f K9 {tag}: the threshold does not fall inside the "
                 f"zeros")
        Vr = torch.as_tensor(rng.randint(0, 3, size=(n, 4)), dtype=dt,
                             device=dev)
        oracle_check(f"{tag} runs of equal g", Vr, ends, torch.ones_like(wc),
                     k)
        Vn = V.clone()
        Vn[torch.as_tensor(rng.randint(0, n, 64), device=dev), 0] = \
            float("nan")
        oracle_check(f"{tag} NaN", Vn, ends, wc, k, cpu_ref=True)
        oracle_check(f"{tag} NaN", Vn, ends, wc, k)
        f = torch.tensor(0.07, dtype=dt, device=dev)
        x0 = np.full(m, k / m)
        xr = rng.rand(m)
        xr *= k / xr.sum()
        err = 0.0
        for lab, x, gap_tol, tail_from, it, cnt in (
                ("start point", x0, 0.0, None, 0, 0),
                ("random x, tail average (count 2)", xr, 0.0, 16, 17, 1),
                ("random x, tail average (count 5)", xr, 0.0, 16, 20, 4),
                ("random x, gap stop", xr, 1e30, 16, 20, 4)):
            err = max(err, update_check(f"{tag} {lab}", f, g, s, x, wc, k,
                                        gap_tol=gap_tol, tail_from=tail_from,
                                        it=it, cnt=cnt))
        graph_check(tag, V, ends, wc, k, xr, f)
        item = torch.finfo(dt).bits // 8
        st = state(m, dt, xr)
        st["counters"].copy_(torch.tensor([16, 0], dtype=torch.int32))

        def k10():
            kfw.fw_update(f, g, s, st["x"], st["u"], st["xavg"],
                          st["counters"], st["done"], st["w"], wc,
                          grad_norm_tol=1e-8, gap_tol=0.0, tail_from=16,
                          mask_tol=1e-10)

        def k10_plain():
            kfw.fw_update_plain(f, g, s, st["x"], st["u"], st["xavg"],
                                st["counters"], st["done"], st["w"], wc,
                                grad_norm_tol=1e-8, gap_tol=0.0,
                                tail_from=16, mask_tol=1e-10)

        def topk():
            return torch.zeros_like(g).scatter_(0, torch.topk(g, k).indices,
                                                1.0)

        k9_tm = {"device_ms": device_ms(lambda: kfw.fw_oracle(V, ends, wc,
                                                               k)),
                 "call_ms": call_ms(lambda: kfw.fw_oracle(V, ends, wc, k)),
                 "plain_ms": call_ms(lambda: kfw.fw_oracle_plain(V, ends, wc,
                                                                 k)),
                 "library_ms": device_ms(topk, reps=20),
                 "max_abs_err": 0.0,
                 "shape": f"V ({n}, 4), m {m}, k {k}"}
        k9_tm["bound_ms"], k9_tm["bound_by"] = bound(
            n * item + m * 8 + 3 * m * item, 4 * m, item)
        k10_tm = {"device_ms": device_ms(k10), "call_ms": call_ms(k10),
                  "plain_ms": call_ms(k10_plain), "library_ms": None,
                  "max_abs_err": err, "shape": f"m {m}, the tail average's "
                                               f"step"}
        k10_tm["bound_ms"], k10_tm["bound_by"] = bound(8 * m * item, 12 * m,
                                                       item)
        for name_, tm in (("K9", k9_tm), ("K10", k10_tm)):
            print(f"3f {name_} {tag} ({tm['shape']}): kernel device "
                  f"{tm['device_ms']:.5f} ms, call {tm['call_ms']:.4f} ms, "
                  f"plain call {tm['plain_ms']:.4f} ms, library "
                  f"{tm['library_ms']}, bound {tm['bound_ms']:.5f} ms "
                  f"({tm['bound_by']}) ({card})", flush=True)
            out[f"{name_} {tag}"] = dict(tm, dtype=str(dt).split(".")[-1])
    return out


def plain_fw_check(card, label, mac, solve, got, kernels):
    """The solve once more with the Frank-Wolfe loop on the host (PlainFW,
    "plain-fw"): its rounded selection, unrounded x, upper bound (float32:
    the float64 certificate, a function of x and the Ritz block; float64:
    the loop's own bound, within 1e-12 relative) and step and Fiedler
    iteration counts against `got`, the last solve's through the device
    loop (whose stats mac.last_solve_stats holds), and K9 and K10 (the
    `kernels`) not launched by it."""
    import numpy as np

    stats = dict(mac.last_solve_stats)
    before = [kern.launches for kern in kernels]
    with PlainFW():
        ref = solve()
    ref_stats = dict(mac.last_solve_stats)
    same = (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
            and all(stats[key] == ref_stats[key]
                    for key in ("fw_iterations", "fiedler_iterations")))
    f64 = str(mac.dtype).endswith("float64")
    upper_ok = (got[2] == ref[2] if not f64
                else abs(got[2] - ref[2]) <= 1e-12 * abs(ref[2]))
    extra = [kern.launches - b for kern, b in zip(kernels, before)]
    print(f"{label} plain-fw (the host loop): rounded selection and x "
          f"{'bitwise' if same else 'NOT bitwise'} the device loop's, "
          f"upper {ref[2]!r} against {got[2]!r} ("
          f"{'bitwise' if got[2] == ref[2] else 'within 1e-12' if upper_ok else 'OFF'}"
          f"), FW iterations {ref_stats['fw_iterations']} / "
          f"{stats['fw_iterations']}, Fiedler iterations "
          f"{ref_stats['fiedler_iterations']} / "
          f"{stats['fiedler_iterations']}; K9, K10 launched by it {extra} "
          f"({card})", flush=True)
    if not (same and upper_ok) or any(extra):
        fail(f"{label}: the device loop is not the host loop's solve, or "
             f"the host loop launched K9 / K10")


class PlainFW:
    """While active, MAC's Frank-Wolfe loop runs on the host (MAC._fw_host:
    the loop's bookkeeping as PyTorch ops, the stop test read every step),
    as before kernels K9 and K10, for a comparison run ("plain-fw"). No
    knob selects it."""

    def __enter__(self):
        from mac_tpu_torch.solvers.mac import MAC

        self.cls, self.saved = MAC, MAC.__dict__["_fw_device"]
        MAC._fw_device = MAC._fw_host
        return self

    def __exit__(self, *exc):
        self.cls._fw_device = self.saved
        return False


def launch_floors(dev, segment=True):
    """Device ms of the smallest launch each K1p body's, K7's and K8's
    wrapper can make (chip_smoke.device_ms): the segment body at (32, 1),
    seg 32 (one block of one warp; left out without `segment`, for a
    library that has none); the cluster body at (16, 1) (its 16 blocks);
    K7 at n = 1, q = 1, one aggregate (a cluster of one block); K8 at
    n = 1, q = 1, one filled slot (one block)."""
    import torch

    from mac_tpu_torch.ops.kernels import banded as kb
    from mac_tpu_torch.ops.kernels import ell as k8
    from mac_tpu_torch.ops.kernels import tridiag as k1

    def chain(n):
        one = torch.ones(n, device=dev)
        iperm = torch.arange(n, dtype=torch.int32, device=dev)
        return one, torch.zeros(n, device=dev), iperm, torch.ones(
            (n, 1), device=dev)

    d32, l32, i32, b32 = chain(32)
    d16, l16, i16, b16 = chain(16)
    x1 = torch.zeros((1, 1), device=dev)
    lc1 = torch.ones((1, 1), device=dev)
    i1 = torch.zeros(1, dtype=torch.int32, device=dev)
    floors = {}
    if segment:
        floors["K1p segment"] = device_ms(lambda: k1.tridiag_solve_permuted(
            d32, l32, b32, i32, i32, seg=32))
    floors["K1p cluster"] = device_ms(lambda: k1.tridiag_solve_permuted(
        d16, l16, b16, i16, i16))
    floors["K7"] = device_ms(lambda: kb.coarse_correct(x1, x1, i1, i1, lc1,
                                                       1))
    nbr1 = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    cnt1 = torch.ones(1, dtype=torch.int32, device=dev)
    floors["K8"] = device_ms(lambda: k8.ell_product(nbr1, cnt1, lc1, x1))
    return floors


def k6_floors(dev, dots=None):
    """Device ms of the smallest launch each K6 wrapper can make (one block
    of a (1, 1) float32 block, every sum asked for): col_sums, cg_update
    and the second pass with the dots, `dots(P, R, Z, zsum, rz, init,
    sums)`, by default cg_direction_dots (kernel_ab.py passes an older
    library's col_sums and cg_direction, two launches)."""
    import torch

    from mac_tpu_torch.ops.kernels import pcg as kp

    dots = dots or kp.cg_direction_dots
    x = torch.ones((1, 1), device=dev)
    rz = torch.ones(1, device=dev)
    pap = torch.ones(1, dtype=torch.float64, device=dev)
    return {"K6 col_sums": device_ms(lambda: kp.col_sums(x)),
            "K6 cg_update": device_ms(lambda: kp.cg_update(
                x, x, x, x, rz, pap, sums=True)),
            "K6 cg_direction_dots": device_ms(lambda: dots(
                x, x, x, None, rz, False, True))}


def k6_cases(dev, n, rng):
    """Phase 3f's K6 cases at the CG step's shapes, (n, 4) in float32 and
    float64 and (8, n, 4), inputs drawn from rng: col_sums as the dots R .
    Z with Z centred (its sums, and the plain column sums of A, bitwise
    block_sum_model in float32), cg_update with R's sums, and
    cg_direction_dots with P's sums (rz_new bitwise col_sums(R, Z, zsum));
    in float32 also its first-step form (P = Z). Each a dict: "key",
    "name" (the wrapper's), "label", "shape", "kernel", "plain", "fresh"
    (restores the in-place inputs), the bytes read once and written once,
    the operations, itemsize, tolerance, "library" (torch.linalg.vecdot
    for the dots, or None), "model" (None, or () -> (got, want) to be
    bitwise equal; "model_of" says what it holds), "kind" ("colsum",
    "update", "dots", "dots_init") and "inputs" (the tensors by name)."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels import pcg as kp

    cases = []

    def rand(*shape, dtype=torch.float32):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=dev)

    for tag, lead, dtype in (("", (), torch.float32),
                             ("_f64", (), torch.float64),
                             ("_lanes", (8,), torch.float32)):
        q = 4
        it = torch.finfo(dtype).bits // 8
        ln = lead[0] if lead else 1
        tol = CG_TOL[str(dtype).split(".")[-1]]
        shape = str((*lead, n, q))
        A, M = rand(*lead, n, q, dtype=dtype), rand(*lead, n, q, dtype=dtype)
        msum = kp.col_sums(M)
        model = None
        if not tag:
            def model(A=A, M=M, msum=msum):
                Mc = M - (msum / n).to(M.dtype)
                got = torch.stack([kp.col_sums(A), kp.col_sums(A, M, msum)])
                want = [kp.block_sum_model(v.cpu().numpy())
                        for v in (A, A * Mc)]
                return got.cpu(), torch.as_tensor(np.array(want))
        cases.append(dict(
            key="K6_colsum" + tag, name="col_sums", kind="colsum",
            label=f"K6 col_sums{tag} {shape}, the dots R . Z with Z centred",
            shape=shape, kernel=lambda A=A, M=M, msum=msum: kp.col_sums(
                A, M, msum),
            plain=lambda A=A, M=M, msum=msum: kp.col_sums_plain(A, M, msum),
            fresh=None, bytes=it * 2 * ln * n * q, flops=3.0 * ln * n * q,
            itemsize=it, tol=tol, model=model,
            model_of="sums not bitwise block_sum_model",
            library=lambda A=A, M=M: torch.linalg.vecdot(A, M, dim=-2),
            inputs=dict(A=A, M=M, msum=msum)))
        X0, R0, P0, AP = (rand(*lead, n, q, dtype=dtype) for _ in range(4))
        rz0 = rand(*lead, q, dtype=dtype)
        pap = rand(*lead, q, dtype=torch.float64)
        X, R, P, rz = X0.clone(), R0.clone(), P0.clone(), rz0.clone()

        def fresh(X=X, R=R, P=P, rz=rz, X0=X0, R0=R0, P0=P0, rz0=rz0):
            X.copy_(X0)
            R.copy_(R0)
            P.copy_(P0)
            rz.copy_(rz0)

        cases.append(dict(
            key="K6_update" + tag, name="cg_update", kind="update",
            label=f"K6 cg_update{tag} {shape} with R's sums", shape=shape,
            kernel=lambda X=X, R=R, P=P, AP=AP, rz=rz, pap=pap: (
                X, R, kp.cg_update(X, R, P, AP, rz, pap, sums=True)),
            plain=lambda X=X, R=R, P=P, AP=AP, rz=rz, pap=pap: (
                X, R, kp.cg_update_plain(X, R, P, AP, rz, pap, sums=True)),
            fresh=fresh, bytes=it * 6 * ln * n * q, flops=5.0 * ln * n * q,
            itemsize=it, tol=tol, model=None, library=None,
            inputs=dict(X=X, R=R, P=P, AP=AP, rz=rz, pap=pap)))
        Z = rand(*lead, n, q, dtype=dtype)
        zsum = kp.col_sums(Z)
        for init in ((False, True) if not tag else (False,)):
            def kern(P=P, R0=R0, Z=Z, zsum=zsum, rz=rz, init=init):
                return (P, rz, *kp.cg_direction_dots(P, R0, Z, zsum, rz,
                                                     init=init, sums=True))

            def plain(P=P, R0=R0, Z=Z, zsum=zsum, rz=rz, init=init):
                return (P, rz, *kp.cg_direction_dots_plain(
                    P, R0, Z, zsum, rz, init=init, sums=True))

            def dots_model(kern=kern, fresh=fresh, R0=R0, Z=Z, zsum=zsum):
                fresh()
                return kern()[3], kp.col_sums(R0, Z, zsum)

            form = " the first step (P = Z)," if init else ""
            cases.append(dict(
                key="K6_direction_dots" + tag + ("_init" if init else ""),
                name="cg_direction_dots",
                kind="dots_init" if init else "dots",
                label=f"K6 cg_direction_dots{tag} {shape},{form} the dots R "
                      "(Z centred) and P's sums", shape=shape, kernel=kern,
                plain=plain, fresh=fresh,
                bytes=it * (3 - init) * ln * n * q + it * ln * n * q,
                flops=(4.0 + 2.0 * (not init)) * ln * n * q,
                itemsize=it, tol=tol, model=dots_model,
                model_of="rz_new not bitwise col_sums(R, Z, zsum)",
                library=lambda R0=R0, Z=Z: torch.linalg.vecdot(R0, Z, dim=-2),
                inputs=dict(P=P, R=R0, Z=Z, zsum=zsum, rz=rz, init=init)))
    return cases


def k1p_case(cases, rand, dev, key, label, dp, l, seg, iperm, perm, lead,
             q, dtype, adding):
    """Append to `cases` one K1p case (k1p_cases' dicts) on the factor dp,
    l (decoupled every seg rows, or exact: seg None) through the
    permutation iperm / perm, B (and the old x) drawn by rand(*shape,
    dtype=): the first smoothing (centred) or, adding, the second (added
    into x, with x's sums)."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels import pcg as kp
    from mac_tpu_torch.ops.kernels import tridiag as k1

    n = iperm.shape[0]
    it = torch.finfo(dtype).bits // 8
    ln = lead[0] if lead else 1
    B = rand(*lead, n, q, dtype=dtype)
    X0 = rand(*lead, n, q, dtype=dtype)
    X = X0.clone()
    bsum = kp.col_sums(B)
    kw = dict(X=X, sums=True) if adding else dict(bsum=bsum)

    def solve(Bn):  # the twin: K1b at block seg, or K1
        if seg is None:
            return k1.tridiag_solve(dp, l, Bn)
        return k1.tridiag_solve_blocked(dp, l, Bn, block=seg)

    def twin():
        if adding:
            Bn = B[..., iperm.long(), :].contiguous()
            return X0 + solve(Bn)[..., perm.long(), :]
        m = (bsum / torch.full_like(bsum, n)).to(dtype).unsqueeze(-2)
        Bn = (B[..., iperm.long(), :] - m).contiguous()
        return solve(Bn)[..., perm.long(), :]

    def model():
        got = k1.tridiag_solve_permuted(dp, l, B, iperm, perm, X=X,
                                        sums=True, seg=seg)
        x = got[0].cpu().numpy().reshape(-1, n, q)[:, iperm.cpu().long()]
        want = np.stack([k1.k1p_segment_sum_model(v, seg) for v in x])
        return got[1].cpu().reshape(want.shape), torch.as_tensor(want)

    fac_bytes = it * 2 * dp.numel()
    nbytes = (fac_bytes + 4 * n + it * (3 if adding else 2) * ln * n * q
              + 8 * ln * q)
    cases.append(dict(
        key=key, label=f"K1p {label}", name="tridiag_solve_permuted",
        shape=label, body=k1.permuted_body(seg), seg=seg,
        kernel=lambda s: k1.tridiag_solve_permuted(dp, l, B, iperm, perm,
                                                   seg=s, **kw),
        plain=lambda: k1.tridiag_solve_permuted_plain(
            dp, l, B, iperm, perm, seg=seg, **kw),
        twin=twin, fresh=(lambda: X.copy_(X0)) if adding else None,
        model=model if adding and seg is not None else None,
        bytes=nbytes, flops=(6.0 if adding else 5.0) * ln * n * q,
        itemsize=it, tol=CG_TOL[str(dtype).split(".")[-1]],
        floor="K1p " + k1.permuted_body(seg)))


def k1p_cases(dev, bop, bop_sp, bds):
    """Phase 3f's K1p cases (tridiag_solve_permuted at the main paths'
    shapes), inputs from a RandomState(20) of their own: the segment body
    on city10000's chain factor (decoupled every 128 rows) at (10000, 4),
    the first smoothing (centred) and the second (added into x, with x's
    sums) in float32 and float64 and with 8 lanes, and on a factor
    decoupled every 128 rows at (100000, 4); the cluster body on
    sphere2500's exact factor (2500, 4), both forms, and on an exact
    (32768, 16) float64 factor (its tiled branch). Each a dict: "kernel"
    (seg -> the call; seg None runs the cluster body, as every K1p before
    the segment body did), "seg" (the factor's), "plain", "twin" (the
    kernel its body shares its arithmetic with, K1b at block seg or K1, on
    the gathered, centred input, scattered back: bitwise), "fresh"
    (restores x), "model" (the add form of the segment body: its sums and
    k1p_segment_sum_model's of the x it wrote, to be bitwise), the bytes
    read once and written once (dp, l, B, the old x, x, iperm), the
    operations, itemsize, tolerance, "floor" (launch_floors' key)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(20)
    cases = []

    def rand(*shape, dtype):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=dev)

    def add(*args):
        k1p_case(cases, rand, dev, *args)

    for tag, M, lead in (("", bds["float32"][1], ()),
                         ("_f64", bds["float64"][1], ()),
                         ("_lanes", bds["lanes"][1], (8,))):
        dtype = M.BD.ut.dtype
        dp = M.fac.dp.to(dtype).contiguous()
        l = M.fac.l.to(dtype).contiguous()
        shape = f"{lead + (bop.n, 4)} {str(dtype)[6:]}, seg {M.fac.seg}"
        add("K1p" + tag, f"{shape}, the first smoothing (centred)", dp, l,
            M.fac.seg, bop.iperm, bop.perm, lead, 4, dtype, False)
        add("K1p_add" + tag, f"{shape}, the second smoothing added into x, "
            "with x's sums", dp, l, M.fac.seg, bop.iperm, bop.perm, lead, 4,
            dtype, True)
    Msp = bds["sphere"][1]
    for key, adding, form in (
            ("K1p_sphere", False, "the first smoothing"),
            ("K1p_add_sphere", True, "the second smoothing added into x, "
             "with x's sums")):
        add(key, f"sphere2500 ({bop_sp.n}, 4), its exact factor, {form}",
            Msp.fac.dp.contiguous(), Msp.fac.l.contiguous(), Msp.fac.seg,
            bop_sp.iperm, bop_sp.perm, (), 4, torch.float32, adding)
    for key, n, q, seg, dtype in (("K1p_100000", 100000, 4, 128,
                                   torch.float32),
                                  ("K1p_tiled", 32768, 16, None,
                                   torch.float64)):
        dp = torch.as_tensor(2.5 + rng.rand(n), dtype=dtype, device=dev)
        l = torch.as_tensor(-0.3 * rng.rand(n), dtype=dtype, device=dev)
        l[::seg or n] = 0.0
        perm = torch.as_tensor(rng.permutation(n), dtype=torch.int32,
                               device=dev)
        iperm = torch.empty_like(perm)
        iperm[perm.long()] = torch.arange(n, dtype=torch.int32, device=dev)
        what = (f"a factor decoupled every {seg} rows" if seg
                else "an exact factor, the cluster body's tiled branch")
        add(key, f"({n}, {q}) {str(dtype)[6:]}, {what}, the first "
            "smoothing", dp, l, seg, iperm, perm, (), q, dtype, False)
    return cases


def k7_case(rng, dev, key, label, Lc_inv, iperm, perm, n, nc, s_, lead, q,
            dtype):
    """One K7 case (k7_cases' dicts): r and the old x drawn from rng at
    lead + (n, q), the coarse inverse Lc_inv of nc aggregates of s_ rows
    (one per lane, or shared), through iperm / perm."""
    import torch

    from mac_tpu_torch.ops.kernels import banded as kb

    it = torch.finfo(dtype).bits // 8
    ln = lead[0] if lead else 1
    r = torch.as_tensor(rng.normal(size=lead + (n, q)), dtype=dtype,
                        device=dev)
    X0 = torch.as_tensor(rng.normal(size=r.shape), dtype=dtype, device=dev)
    X = X0.clone()
    return dict(
        key=key, label=f"K7 {label}", name="coarse_correct", shape=label,
        body=None, seg=None,
        kernel=lambda _s: kb.coarse_correct(r, X, iperm, perm, Lc_inv, s_),
        plain=lambda: kb.coarse_correct_plain(r, X, iperm, perm, Lc_inv, s_),
        twin=None, fresh=lambda: X.copy_(X0), model=None,
        bytes=it * (Lc_inv.numel() + 3 * ln * n * q) + 4 * n,
        flops=2.0 * ln * nc * nc * q, itemsize=it,
        tol=CG_TOL[str(dtype).split(".")[-1]], floor="K7")


def k7_cases(dev, bop, bop_sp, bds):
    """Phase 3f's K7 cases (coarse_correct), inputs from a RandomState(21)
    of their own: city10000's coarse level (nc 500, s 20) at (10000, 4) in
    float32 and float64 and with 8 lanes (a coarse inverse each), and
    sphere2500's; dicts as k1p_cases' (no twin or model; "kernel" takes
    and ignores a seg), the bytes Lc_inv's, r's, x's read and written
    once and iperm's, the operations 2 nc^2 q a lane."""
    import numpy as np
    import torch

    rng = np.random.RandomState(21)
    cases = []
    for tag, M, op, lead in (("", bds["float32"][1], bop, ()),
                             ("_f64", bds["float64"][1], bop, ()),
                             ("_lanes", bds["lanes"][1], bop, (8,)),
                             ("_sphere", bds["sphere"][1], bop_sp, ())):
        dtype = M.BD.ut.dtype
        n, q, nc, s_ = op.n, 4, op.coarse_nc, op.coarse_s
        label = f"{lead + (n, q)} {str(dtype)[6:]}, nc {nc}, s {s_}"
        cases.append(k7_case(rng, dev, "K7" + tag, label,
                             M.Lc_inv.to(dtype).contiguous(), op.iperm,
                             op.perm, n, nc, s_, lead, q, dtype))
    return cases


def csr_library(op, w_tbl, V):
    """One torch.sparse call computing L(w) V on the ELL operator: L as a
    CSR matrix (the n degrees and the two entries of every edge, about
    n + 2 m nonzeros; built here from the slot-major weight table w_tbl
    (dmax, n), not timed) times V; None where torch refuses the dtype or
    layout on the card."""
    import torch

    try:
        dmax, n = op.slot_nbr.shape
        keep = w_tbl != 0
        rows = torch.arange(n, device=V.device)[None, :].expand(dmax, n)
        diag = torch.arange(n, device=V.device)
        idx = torch.stack([torch.cat([rows[keep], diag]),
                           torch.cat([op.slot_nbr[keep].long(), diag])])
        vals = torch.cat([-w_tbl[keep], w_tbl.sum(dim=0)])
        L = torch.sparse_coo_tensor(idx, vals, (n, n)).coalesce()
        Lcsr = L.to_sparse_csr()
        del L

        def run():
            return torch.sparse.mm(Lcsr, V)

        run()
        torch.cuda.synchronize()
        return run
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        print(f"  torch.sparse.mm of a CSR L(w) ({V.dtype}): not available "
              f"here ({str(exc).splitlines()[0][:120]})", flush=True)
        return None


def k8_cases(dev, op5, w5, W5, op_ge, w_ge):
    """Phase 3f's K8 cases (ell_product at the main paths' shapes), inputs
    from a RandomState(22) of their own: the n = 100000 expander's tables
    at its start weights w5 (phase 5), at (100000, 4) the CG step's inner
    form with its dots, the V-cycle's residual form and the plain form,
    the outer iteration's (100000, 12) inner form, float64's inner form
    with the dots and plain form (phase 10f); phase 8b's two budget lanes
    W5 (2, 100000, 4), a weight table per lane, inner form with the dots;
    GreedyEig's (1728, 256) flat block over intel's table (op_ge, w_ge),
    shared by its 64 lanes. Each a dict: key, label, "kernel", "plain",
    "model" (with the dots: the dots and dot_model's of the products V
    times the output the kernel wrote, to be bitwise), the least bytes of
    the work read once and written once (the 2m filled slots' int32 ids
    and weights, a weight table per lane where the lanes have their own,
    the int32 row counts, V, B, the output; not the padding), the
    operations (a subtraction, a product and a sum a nonzero slot and
    column, 2 more an entry for the epilogue), itemsize, tolerance, the
    library call (torch.sparse.mm of L(w) as CSR, for the plain form),
    "dtype", "grid" ((n, q, lanes), for ell.grid_blocks) and "inputs"
    (the row-major neighbour table, the weight table, V and the keywords:
    kernel_ab.py calls an older K8 on them)."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops import laplacian
    from mac_tpu_torch.ops.kernels import ell as k8
    from mac_tpu_torch.ops.kernels import pcg as kp

    rng = np.random.RandomState(22)
    cases = []

    def add(key, label, op, w, q, form, lanes=None, library=False,
            dot=False):
        dtype = w.dtype
        w_tbl = laplacian.lap_weight_table(op, w).contiguous()
        n = op.n
        lead = (lanes,) if lanes else ()
        V = torch.as_tensor(rng.normal(size=lead + (n, q)), dtype=dtype,
                            device=dev)
        kw = {}
        if form == "inner":
            c = laplacian.lap_inf_norm(op, w).to(dtype)
            kw = dict(vsum=kp.col_sums(V), c=c,
                      sigma=32 * torch.finfo(dtype).eps * c, dot=dot)
        elif form == "residual":
            B = torch.as_tensor(rng.normal(size=V.shape), dtype=dtype,
                                device=dev)
            kw = dict(B=B, bsum=kp.col_sums(B))
        it = V.element_size()
        ln = lanes or 1
        nnz = int((w_tbl != 0).sum()) * (1 if w_tbl.dim() == 3 else ln)
        slots = 2 * op.m  # the filled slots: each edge at both its ends
        nbytes = (4 * slots + it * slots * (ln if w_tbl.dim() == 3 else 1)
                  + 4 * n + it * ln * n * q * (2 + (form == "residual")))
        flops = 3.0 * nnz * q + 2.0 * ln * n * q
        tables = (op.slot_nbr, op.slot_count, w_tbl)

        def model():
            y, dots = k8.ell_product(*tables, V, **kw)
            prod = (V * y).cpu().numpy().reshape(-1, n, q)
            want = np.stack([k8.dot_model(p) for p in prod])
            return dots.cpu().reshape(want.shape), torch.as_tensor(want)

        cases.append(dict(
            key=key, label=f"K8 {label}", name="ell_product", shape=label,
            kernel=lambda: k8.ell_product(*tables, V, **kw),
            plain=lambda: k8.ell_product_plain(*tables, V, **kw),
            model=model if kw.get("dot") else None, bytes=nbytes,
            flops=flops, itemsize=it, tol=CG_TOL[str(dtype)[6:]],
            library=csr_library(op, w_tbl, V) if library else None,
            dtype=dtype, grid=(n, q, ln),
            inputs=dict(nbr_tbl=op.nbr_tbl, w_tbl=w_tbl, V=V, kw=kw)))

    n5 = op5.n
    w64 = w5.double()
    add("K8", f"({n5}, 4) inner form, the CG step's A P, with the dots",
        op5, w5, 4, "inner", dot=True)
    add("K8_residual", f"({n5}, 4) residual form, the V-cycle's", op5, w5,
        4, "residual")
    add("K8_plain", f"({n5}, 4) plain form (library: CSR L(w) V)", op5, w5,
        4, "plain", library=True)
    add("K8_12", f"({n5}, 12) inner form, the outer iteration's A Q", op5,
        w5, 12, "inner")
    add("K8_f64", f"({n5}, 4) inner form, float64, with the dots", op5, w64,
        4, "inner", dot=True)
    add("K8_f64_plain", f"({n5}, 4) plain form, float64 (library: CSR)",
        op5, w64, 4, "plain", library=True)
    add("K8_lanes", f"(2, {n5}, 4) inner form, phase 8b's 2 lanes, a "
        "table each, with the dots", op5, W5, 4, "inner", lanes=2, dot=True)
    add("K8_ge", f"({op_ge.n}, 256) plain form, GreedyEig's flat block "
        "(64 lanes of 4) over one table (library: CSR)", op_ge, w_ge, 256,
        "plain", library=True)
    return cases


def ell_cycle_cases(dev, op5, w5, W5, op_ge, w_ge):
    """Phase 3f's K1p and K7 cases on the matrix-free route's V-cycle
    (ops.twogrid.EllVCycle: the identity permutation), inputs from a
    RandomState(23) of their own: the n = 100000 expander's chain factor
    (decoupled every 1024 rows: K1p's segment body at seg 1024) and coarse
    level (nc 511, s 196) at its start weights, float32 and float64, and
    phase 8b's two budget lanes (a factor and a coarse inverse each);
    GreedyEig's (1728, 256) block on intel's exact factor (K1p's cluster
    body) and coarse level (nc 432, s 4). Dicts as k1p_cases' and
    k7_cases'."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops import twogrid

    rng = np.random.RandomState(23)
    cases = []

    def rand(*shape, dtype):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=dev)

    def level(op, w, dtype):
        fac, Lc_inv = twogrid.twogrid_level(op, w.to(dtype))
        return (fac.dp.to(dtype).contiguous(), fac.l.to(dtype).contiguous(),
                fac.seg, Lc_inv.to(dtype).contiguous())

    for tag, op, w, lead, q, dtype in (
            ("_ell", op5, w5, (), 4, torch.float32),
            ("_ell_f64", op5, w5, (), 4, torch.float64),
            ("_ell_lanes", op5, W5, (2,), 4, torch.float32),
            ("_ell_ge", op_ge, w_ge, (), 256, torch.float32)):
        dp, l, seg, Lc_inv = level(op, w, dtype)
        iperm = op.ident32
        shape = (f"{lead + (op.n, q)} {str(dtype)[6:]}, identity "
                 f"permutation, " + (f"seg {seg}" if seg else "exact factor"))
        k1p_case(cases, rand, dev, "K1p" + tag, f"{shape}, the ELL cycle's "
                 "first smoothing (centred)", dp, l, seg, iperm, iperm, lead,
                 q, dtype, False)
        k1p_case(cases, rand, dev, "K1p_add" + tag, f"{shape}, the ELL "
                 "cycle's second smoothing added into x, with x's sums", dp,
                 l, seg, iperm, iperm, lead, q, dtype, True)
        nc, s_ = op.coarse_nc, op.coarse_s
        cases.append(k7_case(
            rng, dev, "K7" + tag, f"{lead + (op.n, q)} {str(dtype)[6:]}, nc "
            f"{nc}, s {s_}, the ELL cycle's, identity permutation", Lc_inv,
            iperm, iperm, op.n, nc, s_, lead, q, dtype))
    return cases


def lane_weights(fixed, cands, ks, dev):
    """(R, m) float32 edge weights of the budget lanes ks: the fixed edges'
    weights, then each candidate's weight times NaiveGreedy's top-k[r]
    selection (the sweep's x_init), and the (R, m_cand) x_init."""
    import numpy as np
    import torch

    from mac_tpu_torch.solvers import NaiveGreedy

    naive = NaiveGreedy(cands)
    xs = np.stack([naive.subset(k) for k in ks])
    wf = np.array([e.weight for e in fixed])
    wc = np.array([e.weight for e in cands])
    w = np.concatenate([np.broadcast_to(wf, (len(ks), len(wf))),
                        xs * wc], axis=1)
    return torch.as_tensor(w, dtype=torch.float32, device=dev), xs


def baselines(dev, dataset, card, counted):
    """Phase 7: GreedyESP on city10000 (scripts/bench_all.py's lazy sweep:
    the chain closed form and the scan on the card) and on a non-chain
    graph (Z by PCG on the card), GreedyEig on intel (the ELL operator, the
    V-cycle and K1; the trial chunks' Rayleigh-Ritz through K4); every
    gate fatal. Returns the launch counts of GreedyEig's subset(8) (K4's
    by lane count too, "sym_eig_by_lanes") and K1's check and times at
    GreedyEig's shape."""
    import numpy as np
    import torch

    from mac_tpu_torch import native
    from mac_tpu_torch.ops.kernels.tridiag import (tridiag_solve,
                                                   tridiag_solve_plain)
    from mac_tpu_torch.ops.laplacian import lap_tridiagonal_part
    from mac_tpu_torch.ops.tridiag import tridiag_ldl_auto
    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers import GreedyEig, GreedyESP
    from mac_tpu_torch.solvers.greedy_eig import TRIAL_MIN_ITERS
    from mac_tpu_torch.utils.fiedler import (fiedler_pair_lanes_plain,
                                             scipy_lam2)
    from mac_tpu_torch.utils.graphs import weight_graph_lap_from_edges

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for GreedyESP's scan products")
    # (a) GreedyESP on city10000, scripts/bench_all.py's lazy sweep.
    t7 = time.perf_counter()
    meas, n7 = read_g2o_file(str(dataset))
    fixed7, cands7 = split_edges(rpm_to_mac(meas))
    m7 = len(cands7)
    ks7 = [int(f * m7) for f in (0.1, 0.3, 0.5)]
    ids7 = {id(e): i for i, e in enumerate(cands7)}
    for kern in counted:
        kern.launches = 0
    esp_s = []
    for _ in range(4):
        esp = GreedyESP(fixed7, cands7, n7, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res7, sel7, times7 = esp.subsets_lazy(ks7)
        torch.cuda.synchronize()
        esp_s.append(time.perf_counter() - t0)
    esp_launches = {kern.__name__: kern.launches for kern in counted}
    order7 = [ids7[id(e)] for e in sel7]
    if not esp._fixed_is_chain or esp.dtype != torch.float64:
        fail("GreedyESP on city10000 left the float64 chain closed form")
    if len(set(order7)) != ks7[-1] or [int(r.sum()) for r in res7] != ks7:
        fail(f"GreedyESP picked {[int(r.sum()) for r in res7]}, want {ks7}")
    for r_a, r_b in zip(res7, res7[1:]):
        if np.any(r_a > r_b):
            fail("GreedyESP's budgets are not nested")
    for k_, r_ in zip(ks7, res7):
        if set(np.flatnonzero(r_)) != set(order7[:k_]):
            fail(f"GreedyESP's budget {k_} is not its first {k_} picks")
    host7 = GreedyESP(fixed7, cands7, n7, device=dev)
    host7.SCAN_MIN_WORK = 10 ** 18
    t0 = time.perf_counter()
    order_h = [ids7[id(e)] for e in host7.subset(200)[1]]
    host_s = time.perf_counter() - t0
    u7, v7 = host7.cand_idx[:, 0], host7.cand_idx[:, 1]
    order_n = native.esp_lazy_select_chain(
        host7._chain_rcum(), np.minimum(u7, v7), np.maximum(u7, v7),
        host7.edge_weights, [200])
    if order_n is None:
        fail("the native lazy ESP core did not load")
    if order_h != order7[:200] or order_n.tolist() != order7[:200]:
        fail("GreedyESP's first 200 picks on the card differ from the "
             "host numpy loop's or the native lazy core's")
    scan_busy, scan_kernels, scan_top = profiled_busy(
        lambda: esp._select_scan_device(ks7[-1]))
    scan_bytes = 4.0 * m7 * ks7[-1] * (ks7[-1] - 1) / 2
    print(f"GreedyESP city10000 (n {n7}, m {m7}, budgets {ks7}; chain "
          f"closed form, device scan, U float32 ({ks7[-1]}, {m7})): warm "
          f"median {statistics.median(esp_s[1:]):.4f} s of "
          f"{[round(t, 4) for t in esp_s]} s (cold first); scan device busy "
          f"{scan_busy:.3f} ms over {scan_kernels} kernels and copies, "
          f"{scan_kernels / ks7[-1]:.1f} a step (profiled run; largest "
          f"{[(round(ms, 3), cnt, nm) for ms, cnt, nm in scan_top]}); U "
          f"rows read "
          f"{scan_bytes:.3e} B, bound {1e3 * scan_bytes / H100_BYTES_PER_S:.1f}"
          f" ms; first 200 picks = numpy loop ({host_s:.3f} s) = native "
          f"lazy core; kernel launches {esp_launches} ({card})", flush=True)
    part_s = [time.perf_counter() - t7]
    # (b) GreedyESP's Z path: a non-chain fixed graph, Z by batched PCG.
    t7 = t0 = time.perf_counter()
    fixed_z, cands_z = chain_instance(5000, 2500, 17, extra=(0, 5, 1.3))
    esp_z = GreedyESP(fixed_z, cands_z, 5000, device=dev)
    mask_z, _ = esp_z.subset(800)
    torch.cuda.synchronize()
    z_s = time.perf_counter() - t0
    host_z = GreedyESP(fixed_z, cands_z, 5000, device=dev)
    host_z.SCAN_MIN_WORK = 10 ** 18
    mask_zh, _ = host_z.subset(800)
    if esp_z._fixed_is_chain or esp_z._Z is None or esp_z._z_streaming():
        fail("the non-chain GreedyESP instance did not take the dense Z")
    if not np.array_equal(mask_z, mask_zh) or int(mask_z.sum()) != 800:
        fail("GreedyESP's Z-path scan on the card differs from the host "
             "numpy loop")
    print(f"GreedyESP Z path (n 5000, m 2500, k 800, float64 Z by PCG on "
          f"the card, scan on the card): {z_s:.3f} s; selected set = host "
          f"numpy loop's ({card})", flush=True)
    part_s.append(time.perf_counter() - t7)
    # (c) GreedyEig on intel: the ELL operator (K8) and the V-cycle (K1p's
    # cluster body, K8, K7).
    t7 = time.perf_counter()
    meas, n_i = read_g2o_file(str(dataset.parent / "intel.g2o"))
    fixed_i, cands_i = split_edges(rpm_to_mac(meas))
    eig = GreedyEig(fixed_i, cands_i, n_i, device=dev)
    if (eig.dtype, eig.op.mode, eig.chunk) != (torch.float32, "ell", 64):
        fail(f"GreedyEig on intel: dtype {eig.dtype}, operator "
             f"{eig.op.mode}, chunk {eig.chunk}")
    x_i = np.zeros(len(cands_i))
    # K1 at the shape GreedyEig gives its V-cycle's chain solve (since the
    # cycle's kernels, K1p's cluster body, K1's body, runs there): the
    # incumbent's chain factor, a chunk's (n, 64 q) block.
    d_i, e_i = lap_tridiagonal_part(eig.op, eig._weights(x_i))
    f_i = tridiag_ldl_auto(
        d_i + 100 * torch.finfo(torch.float32).eps * d_i.max(), e_i)
    B_i = torch.randn((n_i, eig.chunk * eig._X0.shape[1]),
                      generator=torch.Generator().manual_seed(7)).to(dev)
    got_k, ref_k = (tridiag_solve(f_i.dp, f_i.l, B_i),
                    tridiag_solve_plain(f_i.dp, f_i.l, B_i))
    k1 = {"shape": f"({n_i}, {B_i.shape[1]})",
          "max_abs_err": float((got_k - ref_k).abs().max())}
    if not (bool(torch.isfinite(got_k).all()) and torch.allclose(
            got_k, ref_k, rtol=K1_TOL, atol=K1_TOL)):
        fail(f"K1 disagrees with its plain version at GreedyEig's shape "
             f"{k1['shape']}: {k1['max_abs_err']:.3e}")
    k1["device_ms"] = device_ms(lambda: tridiag_solve(f_i.dp, f_i.l, B_i))
    k1["call_ms"] = call_ms(lambda: tridiag_solve(f_i.dp, f_i.l, B_i))
    k1["plain_ms"] = call_ms(lambda: tridiag_solve_plain(f_i.dp, f_i.l, B_i))
    k1["bound_ms"] = tridiag_bound(n_i, B_i.shape[1])[0]
    print(f"K1 at GreedyEig's shape {k1['shape']} (intel's V-cycle chain "
          f"factor): max|kernel - plain| {k1['max_abs_err']:.3e}; kernel "
          f"device {k1['device_ms']:.5f} ms, call {k1['call_ms']:.4f} ms, "
          f"plain call {k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.5f} "
          f"ms ({card})", flush=True)
    lam_i, X_i = eig._eval(x_i, eig._X0)
    grad_i = eig.grad_from_fiedler(X_i[:, 0].cpu().numpy())
    cand_i = np.argsort(-(float(lam_i) + grad_i))[:eig.chunk]
    lams_b, _ = eig._eval_chunk(x_i, cand_i, X_i)
    c_i = torch.as_tensor(cand_i, device=dev)
    ref_i = fiedler_pair_lanes_plain(
        eig.op, eig._weights(x_i), c_i + eig._m_fixed, eig._w_cand[c_i],
        X_i, xprev0=eig.xprev0, tol=eig.fiedler_tol,
        min_iters=TRIAL_MIN_ITERS)
    lams_p = ref_i.lam[:, 0].cpu().numpy()
    chunk_err = float(np.max(np.abs(lams_b - lams_p) / np.abs(lams_p)))
    chunk_ms = {}
    for label, fn in (
            ("batched", lambda: eig._eval_chunk(x_i, cand_i, X_i)),
            ("per-lane loop", lambda: fiedler_pair_lanes_plain(
                eig.op, eig._weights(x_i), c_i + eig._m_fixed,
                eig._w_cand[c_i], X_i, xprev0=eig.xprev0,
                tol=eig.fiedler_tol, min_iters=TRIAL_MIN_ITERS))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        chunk_ms[label] = 1e3 * (time.perf_counter() - t0)
    if not chunk_err <= 5e-4:
        fail(f"GreedyEig's batched chunk disagrees with its per-lane loop: "
             f"{chunk_err:.3e} relative")
    for kern in counted:
        kern.launches = 0
    k4 = next(kern for kern in counted if kern.__name__ == "sym_eig")
    k4_lanes0 = dict(k4.launches_by_lanes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with EighCalls() as eigh_i:
        mask_i, sel_i = eig.subset(8)
    torch.cuda.synchronize()
    eig_s = time.perf_counter() - t0
    eig_launches = {kern.__name__: kern.launches for kern in counted}
    eig_launches["sym_eig_by_lanes"] = {
        r: c - k4_lanes0.get(r, 0) for r, c in k4.launches_by_lanes.items()
        if c > k4_lanes0.get(r, 0)}
    fi_idx = np.array([[e.i, e.j] for e in fixed_i])
    fi_w = np.array([e.weight for e in fixed_i])
    ref_lams = []
    for t in range(1, len(sel_i) + 1):
        idx_t = np.concatenate([fi_idx, [[e.i, e.j] for e in sel_i[:t]]])
        w_t = np.concatenate([fi_w, [e.weight for e in sel_i[:t]]])
        ref_lams.append(scipy_lam2(weight_graph_lap_from_edges(idx_t, w_t,
                                                               n_i)))
    step_err = [abs(a - b) / b for a, b in zip(eig.step_lam2, ref_lams)]
    print(f"GreedyEig intel (n {n_i}, m {len(cands_i)}, k 8, chunk 64, "
          f"float32): subset {eig_s:.3f} s; step lambda_2 "
          f"{[f'{v:.9g}' for v in eig.step_lam2]}, scipy referee "
          f"{[f'{v:.9g}' for v in ref_lams]}, max rel err "
          f"{max(step_err):.2e}; first chunk (64 lanes, the V-cycle's K1p, "
          f"K8 and K7 at ({n_i}, 256))"
          f" batched {chunk_ms['batched']:.1f} ms against the per-lane loop "
          f"{chunk_ms['per-lane loop']:.1f} ms, lambda_2 within "
          f"{chunk_err:.2e}; kernel launches in subset(8) {eig_launches}; "
          f"torch.linalg.eigh calls {eigh_i.calls}, inside TRACEMIN's "
          f"lanes {eigh_i.lanes} ({card})", flush=True)
    if int(mask_i.sum()) != 8 or len(sel_i) != 8:
        fail(f"GreedyEig selected {mask_i.sum()} edges, want 8")
    if not max(step_err) <= 1e-3:
        fail(f"GreedyEig's reported lambda_2 off the referee: {step_err}")
    if not all(b > a for a, b in zip(eig.step_lam2, eig.step_lam2[1:])):
        fail(f"GreedyEig's lambda_2 did not rise every step: "
             f"{eig.step_lam2}")
    if min(k1_body(eig_launches), eig_launches["ell_product"],
           eig_launches["coarse_correct"]) <= 0:
        fail(f"GreedyEig on intel never launched its V-cycle's kernels (K1p "
             f"or K1, K8, K7): {eig_launches}")
    if (eig_launches["sym_eig_by_lanes"].get(eig.chunk, 0) <= 0
            or eigh_i.lanes):
        fail(f"GreedyEig's trial lanes: K4 launches by lanes "
             f"{eig_launches['sym_eig_by_lanes']}, torch.linalg.eigh calls "
             f"inside TRACEMIN's lanes {eigh_i.lanes}")
    part_s.append(time.perf_counter() - t7)
    print(f"phase 7 wall by part: (a) GreedyESP city10000 {part_s[0]:.3f} s,"
          f" (b) Z path {part_s[1]:.3f} s, (c) GreedyEig intel "
          f"{part_s[2]:.3f} s", flush=True)
    return eig_launches, k1


def wide_block(card, dataset, counted, warm_q4):
    """Phase 4b: MAC at fiedler_block_q=11, whose 33 x 33 Rayleigh-Ritz
    eigensolves run in K4w. (a) The slice's path at full width:
    MAC(fixed, cands, n, fiedler_block_q=11) on city10000 (banded
    float32, NaiveGreedy x_init, nearest rounding, the replayed set-up and
    outer-iteration graphs): one cold solve (it captures), then the counts
    set to 0, three warm solves, the counts read. Gates: K4w launched
    (through the replays), the warp body on the 11 x 11 entry matrices,
    K1, K2b and K3b launched, no torch.linalg.eigh call, no capture in a
    warm solve, the relaxed lambda_2 (scipy referee) within GAP_FLOOR of
    the reference optimum, exactly K rounded, upper >= relaxed; printed
    beside phase 4's warm median at q = 4 (warm_q4) and the graphs' pool
    bytes. (b) A float64 route at q = 11: sphere2500 on the banded float64
    operator (phase 10b's knobs, max_iters=20), one cold and one warm
    solve: K4w in float64, no float32 launch, the relaxed gap at least
    GAP_FLOOR_F64. Returns (the city10000 MAC, {"city10000": K4's
    launches by body in (a)'s warm solves, "city10000 launches": each
    counted wrapper's launches there, "sphere2500 float64": K4's by body in
    (b)'s two})."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels import syev
    from mac_tpu_torch.ops.kernels.tridiag import reset_counts
    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers import MAC, NaiveGreedy
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    k4 = syev.sym_eig
    out = {}
    meas, n = read_g2o_file(str(dataset))
    fixed, cands = split_edges(rpm_to_mac(meas))
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    mac11 = MAC(fixed, cands, n, fiedler_block_q=11, device="cuda")
    if mac11._banded is None or mac11._q != 11 or not mac11._fast32:
        fail("4b: city10000 at q = 11 left the banded float32 route")
    stats = [graph_stats(mac11._banded)]
    walls = []
    for turn in range(4):
        if turn == 1:
            reset_counts(*counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with EighCalls() as eigh:
            rounded, unrounded, upper = mac11.solve(
                k, x_init, rounding="nearest", use_cache=True)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stats.append(graph_stats(mac11._banded))
        if eigh.calls:
            fail(f"4b: torch.linalg.eigh called {eigh.calls} times")
    got = out["city10000 launches"] = {kern.__name__: kern.launches
                                       for kern in counted}
    bodies = out["city10000"] = dict(k4.launches_by_body)
    graph_lines(card, "4b city10000 q = 11", stats)
    lam = scipy_lam2(mac11.laplacian(unrounded))
    gap = (lam - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED
    print(f"4b city10000 at fiedler_block_q=11 (K {k}, banded float32, "
          f"fast32): cold {walls[0]:.4f} s, warm "
          f"{[round(t, 4) for t in walls[1:]]} s, warm median "
          f"{statistics.median(walls[1:]):.4f} s (phase 4's at q = 4 "
          f"{warm_q4:.4f} s); graph pool {stats[-1]['pool_bytes']} bytes "
          f"({stats[-1]['pool_bytes'] / 2**20:.2f} MiB), static buffers "
          f"{stats[-1]['static_bytes'] / 2**20:.2f} MiB; relaxed lambda_2 "
          f"(scipy) {lam:.9g}, reference {REFERENCE_LAM2_UNROUNDED:.9g}, "
          f"relative gap {gap:+.4e}; upper {upper:.9g}; rounded "
          f"{int(rounded.sum())}; last_solve_stats "
          f"{mac11.last_solve_stats}; launches in the 3 warm solves {got}, "
          f"K4 by body {bodies}, by lanes {k4.launches_by_lanes}; "
          f"torch.linalg.eigh calls 0 ({card})", flush=True)
    for kname in ("assemble_ut", "tridiag_ldl_blocked", *CG_KERNELS):
        if got[kname] <= 0:
            fail(f"4b: {kname} never launched")
    if bodies.get("wide_shared", 0) <= 0 or bodies.get("warp", 0) <= 0:
        fail(f"4b: K4 launches by body {bodies}: want K4w (33 x 33) and "
             f"the warp body (11 x 11)")
    if not (np.all(np.isfinite(unrounded)) and np.isfinite(upper)):
        fail("4b: non-finite solve output")
    if int(rounded.sum()) != k or not gap >= GAP_FLOOR:
        fail(f"4b: rounded {rounded.sum()} (K {k}), relaxed gap {gap:+.3e}")
    if upper < lam * (1 - 1e-6):
        fail(f"4b: upper bound {upper} below the relaxed lambda_2 {lam}")

    meas, n_s = read_g2o_file(str(dataset.parent / "sphere2500.g2o"))
    fixed_s, cands_s = split_edges(rpm_to_mac(meas))
    k_s = len(cands_s) // 2
    x_s = NaiveGreedy(cands_s).subset(k_s)
    mac_s = MAC(fixed_s, cands_s, n_s, use_banded=True,
                dtype=torch.float64, fiedler_block_q=11, device="cuda")
    reset_counts(*counted)
    walls = []
    with EighCalls() as eigh:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_s, u_s, up_s = mac_s.solve(k_s, x_s, max_iters=20)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    got = by_dtype(counted)
    bodies = out["sphere2500 float64"] = dict(k4.launches_by_body)
    ref = BUNDLED["sphere2500"][0]
    lam = scipy_lam2(mac_s.laplacian(u_s))
    gap = (lam - ref) / ref
    print(f"4b sphere2500 banded float64 at fiedler_block_q=11 (K {k_s}, "
          f"max_iters=20): cold {walls[0]:.4f} s, warm {walls[1]:.4f} s; "
          f"relaxed lambda_2 (scipy) {lam:.17g}, reference {ref:.17g}, "
          f"relative gap {gap:+.3e}; upper {up_s:.17g}; rounded "
          f"{int(r_s.sum())}; launches by dtype {got}, K4 by body {bodies}; "
          f"torch.linalg.eigh calls {eigh.calls} ({card})", flush=True)
    if (bodies.get("wide_shared", 0) <= 0
            or got["sym_eig"].get("float64", 0) <= 0 or eigh.calls
            or any(v.get("float32", 0) for v in got.values())):
        fail(f"4b sphere2500: K4w float64 not launched, a float32 launch, "
             f"or an eigh call: {got}, {bodies}, eigh {eigh.calls}")
    if (int(r_s.sum()) != k_s or not np.isfinite(lam) or not gap >=
            GAP_FLOOR_F64 or up_s < lam * (1 - 1e-9)):
        fail(f"4b sphere2500: rounded {r_s.sum()} (K {k_s}), relaxed gap "
             f"{gap:+.3e}, upper {up_s}")
    return mac11, k, x_init, out


def sweeps(dev, card, mac, mac5, dataset, counted, synth5):
    """Phase 8: the budget sweep (MAC.solve_sweep) on the card, every gate
    fatal: (a) city10000, banded float32, 8 lanes against 8 serial warm
    solves, turn by turn in this call; (b) the n = 100000 expander of phase
    5, 2 lanes (K1b); (c) kitti_05 on the float64 device engine (no
    kernel); (d) sphere2500, 2 lanes (K2's no-split form); (e) the same
    at fiedler_block_q=12 (K4w on the lanes' (2, 36, 36) batches). `mac`
    and `mac5` are phases 4 and 5's solvers, synth5 phase 5's instance.
    Returns the launches of each kernel by lane count in (a), (b), (d) and
    (e) ((e)'s K4 also by body, "sym_eig_by_body")."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels.tridiag import reset_counts
    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers import MAC, NaiveGreedy
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    def reset():
        reset_counts(*counted)

    def by_lanes():
        return {kern.__name__: dict(kern.launches_by_lanes)
                for kern in counted}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) city10000: 8 lanes, scripts/bench_sweep.py's budgets and starts.
    t8 = time.perf_counter()
    meas, n = read_g2o_file(str(dataset))
    fixed, cands = split_edges(rpm_to_mac(meas))
    m = len(cands)
    ks = [int(f * m) for f in np.linspace(0.1, 0.5, 8)]
    naive = NaiveGreedy(cands)
    X0 = np.stack([naive.subset(k) for k in ks])
    sweep_s, serial_s, serial_launch = [], {k: [] for k in ks}, None
    reset()
    eigh_a = EighCalls().__enter__()
    for turn in range(4):
        (r8, u8, up8), dt = timed(lambda: mac.solve_sweep(ks, X0))
        sweep_s.append(dt)
        if turn == 0:
            sweep_launch = {kern.__name__: kern.launches for kern in counted}
            lanes_a = by_lanes()
        if turn == 3:
            break
        before = {kern.__name__: kern.launches for kern in counted}
        serial_u = []
        for k, x in zip(ks, X0):
            (_, u_k, _), dt = timed(lambda: mac.solve(k, x))
            serial_s[k].append(dt)
            serial_u.append(u_k)
        if serial_launch is None:
            serial_launch = {kern.__name__: (kern.launches
                                             - before[kern.__name__]) / 8
                             for kern in counted}
    eigh_a.__exit__(None, None, None)
    busy, kernels_n, top = profiled_busy(lambda: mac.solve_sweep(ks, X0))
    lam_sw = [scipy_lam2(mac.laplacian(u)) for u in u8]
    lam_se = [scipy_lam2(mac.laplacian(u)) for u in serial_u]
    warm = statistics.median(sweep_s[1:])
    serial_sum = sum(statistics.median(v) for v in serial_s.values())
    rel = [(a - b) / b for a, b in zip(lam_sw, lam_se)]
    gap_top = (lam_sw[-1] - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED
    print(f"8a city10000 sweep (8 lanes, budgets {ks}, x_init NaiveGreedy; "
          f"banded float32, fast32 policy): sweep cold {sweep_s[0]:.4f} s, "
          f"warm {[round(t, 4) for t in sweep_s[1:]]} s, warm median "
          f"{warm:.4f} s; 8 serial warm solves, medians by budget "
          f"{[round(statistics.median(v), 4) for v in serial_s.values()]} s, "
          f"sum {serial_sum:.4f} s (sweep / serial {warm / serial_sum:.3f}); "
          f"kernel launches per sweep {sweep_launch} (by lanes {lanes_a}), "
          f"per serial solve {serial_launch}; one warm sweep's device busy "
          f"{busy:.3f} ms over {kernels_n} kernels and copies (profiled "
          f"run; largest {[(round(ms, 3), cnt, nm) for ms, cnt, nm in top]});"
          f" torch.linalg.eigh calls {eigh_a.calls}, inside TRACEMIN's "
          f"lanes {eigh_a.lanes} ({card})", flush=True)
    print(f"8a relaxed lambda_2 (scipy) by lane: sweep "
          f"{[f'{v:.9g}' for v in lam_sw]}, serial "
          f"{[f'{v:.9g}' for v in lam_se]}, sweep - serial relative "
          f"{[f'{v:+.2e}' for v in rel]}; upper "
          f"{[f'{v:.9g}' for v in up8]}; K = {ks[-1]} lane gap to the "
          f"reference {gap_top:+.3e}", flush=True)
    for i, k in enumerate(ks):
        if int(r8[i].sum()) != k or set(np.unique(r8[i])) - {0.0, 1.0}:
            fail(f"8a: lane {k} rounded {r8[i].sum()} edges")
        if not (np.isfinite(lam_sw[i]) and rel[i] >= -1e-2):
            fail(f"8a: lane {k}'s relaxed lambda_2 {lam_sw[i]} is below "
                 f"the serial solve's {lam_se[i]} (1 - 1e-2)")
        if not up8[i] >= lam_sw[i] * (1 - 1e-3):
            fail(f"8a: lane {k}'s upper {up8[i]} below its relaxed lambda_2 "
                 f"{lam_sw[i]} (1 - 1e-3)")
    if not gap_top >= GAP_FLOOR:
        fail(f"8a: the K = {ks[-1]} lane's gap {gap_top:+.3e} is below "
             f"{GAP_FLOOR}")
    for name in ("assemble_ut", "tridiag_ldl_blocked", "sym_eig",
                 *CG_KERNELS):
        if lanes_a[name].get(8, 0) <= 0:
            fail(f"8a: {name} never launched with 8 lanes: {lanes_a}")
    if eigh_a.lanes:
        fail(f"8a: {eigh_a.lanes} torch.linalg.eigh calls inside TRACEMIN's "
             f"lanes")
    part_s = [time.perf_counter() - t8]

    # (b) the n = 100000 expander, 2 lanes: K8 and the ELL V-cycle's K1p,
    # K7 on both lanes in one launch each.
    t8 = time.perf_counter()
    _, wf5, _, wc5 = synth5
    ks5 = [6250, 12500]
    X5 = np.zeros((2, len(wc5)))
    for r, k_ in enumerate(ks5):
        X5[r, np.argpartition(wc5, -k_)[-k_:]] = 1.0
    reset()
    (r5, u5, up5), dt5 = timed(
        lambda: mac5.solve_sweep(ks5, X5, max_iters=10))
    lanes_b = by_lanes()
    lam5 = mac5.evaluate_objective(u5[1])
    print(f"8b n = {SCALE_N} sweep (2 lanes, budgets {ks5}, max_iters=10, "
          f"x_init the top-k by weight; ELL float32): {dt5:.3f} s; rounded "
          f"{[int(r.sum()) for r in r5]}; K = 12500 lane's relaxed lambda_2 "
          f"(evaluate_objective) {lam5:.12g}, reference "
          f"{REFERENCE_LAM2_SCALE:.12g}, relative gap "
          f"{(lam5 - REFERENCE_LAM2_SCALE) / REFERENCE_LAM2_SCALE:+.3e}; "
          f"upper {[f'{v:.9g}' for v in up5]}; launches by lanes {lanes_b} "
          f"({card})", flush=True)
    for name in ("tridiag_ldl_blocked", *ELL_CG_KERNELS):
        if lanes_b[name].get(2, 0) <= 0:
            fail(f"8b: {name} never launched with 2 lanes: {lanes_b}")
    if [int(r.sum()) for r in r5] != ks5:
        fail(f"8b: rounded {[r.sum() for r in r5]}, want {ks5}")
    if not lam5 >= REFERENCE_LAM2_SCALE * (1 - 1e-3):
        fail(f"8b: the K = 12500 lane's relaxed lambda_2 {lam5} is below "
             f"{REFERENCE_LAM2_SCALE} (1 - 1e-3)")
    part_s.append(time.perf_counter() - t8)

    # (c) kitti_05 on the float64 device engine: K1's float64
    # instantiation, then the same sweep on the plain scans (what this part
    # ran before that kernel existed) for comparison.
    t8 = time.perf_counter()
    meas, n_k = read_g2o_file(str(dataset.parent / "kitti_05.g2o"))
    fixed_k, cands_k = split_edges(rpm_to_mac(meas))
    mac_k = MAC(fixed_k, cands_k, n_k)
    ks_k = [6, 33]
    reset()
    with PlainOnCard() as plain_k:
        (r_k, u_k, up_k), dt_k = timed(lambda: mac_k.solve_sweep(ks_k))
    got_k = by_dtype(counted)
    with PlainScans():
        (_, u_ks, _), dt_ks = timed(lambda: mac_k.solve_sweep(ks_k))
    lam_k = [scipy_lam2(mac_k.laplacian(u)) for u in u_k]
    lam_ks = [scipy_lam2(mac_k.laplacian(u)) for u in u_ks]
    lam_h = [scipy_lam2(mac_k.laplacian(mac_k.solve(k)[1])) for k in ks_k]
    rel_k = [(a - b) / b for a, b in zip(lam_k, lam_h)]
    print(f"8c kitti_05 sweep (n {n_k}, budgets {ks_k}; dtype "
          f"{str(mac_k.dtype).split('.')[-1]}, routed to the "
          f"{mac_k.fiedler_backend} engine for solve, the device engine for "
          f"the sweep, precond {mac_k.fiedler_precond}): {dt_k:.3f} s "
          f"(on the plain scans {dt_ks:.3f} s); relaxed lambda_2 sweep (5 "
          f"steps) {[f'{v:.12g}' for v in lam_k]}, on the plain scans "
          f"{[f'{v:.12g}' for v in lam_ks]}, host solve (20 steps) "
          f"{[f'{v:.12g}' for v in lam_h]}, relative "
          f"{[f'{v:+.2e}' for v in rel_k]}; upper "
          f"{[f'{v:.12g}' for v in up_k]}; kernel launches by dtype {got_k}"
          f", plain versions on the card {plain_k.calls} ({card})",
          flush=True)
    if (mac_k.dtype, mac_k.device.type) != (torch.float64, "cuda"):
        fail("8c: kitti_05 is not a float64 instance on the card")
    if [int(r.sum()) for r in r_k] != ks_k:
        fail(f"8c: rounded {[r.sum() for r in r_k]}, want {ks_k}")
    if (k1_body(got_k, "float64") <= 0 or plain_k.calls
            or any(v.get("float32", 0) for v in got_k.values())):
        fail(f"8c: the float64 sweep did not run K1's float64 "
             f"instantiation alone: {got_k}, plain {plain_k.calls}")
    if not all(v >= -1e-2 for v in rel_k):
        fail(f"8c: a lane's relaxed lambda_2 is below the host solve's "
             f"(1 - 1e-2): {rel_k}")
    part_s.append(time.perf_counter() - t8)

    # (d) sphere2500, 2 lanes: K2's no-split form with lanes.
    t8 = time.perf_counter()
    meas, n_s = read_g2o_file(str(dataset.parent / "sphere2500.g2o"))
    fixed_s, cands_s = split_edges(rpm_to_mac(meas))
    mac_s = MAC(fixed_s, cands_s, n_s)
    ks_s = [len(cands_s) // 4, len(cands_s) // 2]
    naive_s = NaiveGreedy(cands_s)
    reset()
    (r_s, u_s, up_s), dt_s = timed(lambda: mac_s.solve_sweep(
        ks_s, np.stack([naive_s.subset(k) for k in ks_s])))
    lanes_d = by_lanes()
    lam_s = [scipy_lam2(mac_s.laplacian(u)) for u in u_s]
    print(f"8d sphere2500 sweep (2 lanes, budgets {ks_s}; banded float32, "
          f"ov_rows {mac_s._banded.ov_rows}): {dt_s:.3f} s; relaxed "
          f"lambda_2 {[f'{v:.9g}' for v in lam_s]} (the K = {ks_s[1]} "
          f"reference {BUNDLED['sphere2500'][0]:.9g}); launches by lanes "
          f"{lanes_d} ({card})", flush=True)
    if [int(r.sum()) for r in r_s] != ks_s or not np.all(np.isfinite(lam_s)):
        fail(f"8d: rounded {[r.sum() for r in r_s]}, want {ks_s}")
    if mac_s._banded is None or mac_s._banded.ov_rows:
        fail("8d: sphere2500 left K2's no-split banded form")
    for name in ("assemble_ut", "tridiag_ldl", *CG_KERNELS):
        if lanes_d[name].get(2, 0) <= 0:
            fail(f"8d: {name} never launched with 2 lanes: {lanes_d}")
    part_s.append(time.perf_counter() - t8)

    # (e) sphere2500 at fiedler_block_q=12, the same 2 lanes: each outer
    # iteration's 36 x 36 Rayleigh-Ritz eigensolves as one (2, 36, 36) K4w
    # launch.
    t8 = time.perf_counter()
    mac_e = MAC(fixed_s, cands_s, n_s, fiedler_block_q=12)
    k4 = next(kern for kern in counted if kern.__name__ == "sym_eig")
    reset()
    with EighCalls() as eigh_e:
        (r_e, u_e, up_e), dt_e = timed(lambda: mac_e.solve_sweep(
            ks_s, np.stack([naive_s.subset(k) for k in ks_s])))
    lanes_e = by_lanes()
    lanes_e["sym_eig_by_body"] = dict(k4.launches_by_body)
    lam_e = [scipy_lam2(mac_e.laplacian(u)) for u in u_e]
    rel_e = [(a - b) / b for a, b in zip(lam_e, lam_s)]
    print(f"8e sphere2500 sweep at fiedler_block_q=12 (2 lanes, budgets "
          f"{ks_s}): {dt_s:.3f} s at q = 4 (8d), {dt_e:.3f} s at q = 12; "
          f"relaxed lambda_2 {[f'{v:.9g}' for v in lam_e]}, against 8d's "
          f"{[f'{v:+.2e}' for v in rel_e]} relative; upper "
          f"{[f'{v:.9g}' for v in up_e]}; launches by lanes {lanes_e}; "
          f"torch.linalg.eigh calls {eigh_e.calls}, inside TRACEMIN's "
          f"lanes {eigh_e.lanes} ({card})", flush=True)
    if [int(r.sum()) for r in r_e] != ks_s or not np.all(np.isfinite(lam_e)):
        fail(f"8e: rounded {[r.sum() for r in r_e]}, want {ks_s}")
    if not all(v >= -1e-2 for v in rel_e) or not all(
            u >= lam * (1 - 1e-3) for u, lam in zip(up_e, lam_e)):
        fail(f"8e: a lane's relaxed lambda_2 is below 8d's (1 - 1e-2) or "
             f"above its upper bound: {rel_e}, {up_e}")
    if (lanes_e["sym_eig"].get(2, 0) <= 0 or eigh_e.lanes
            or lanes_e["sym_eig_by_body"].get("wide_shared", 0) <= 0):
        fail(f"8e: K4w never launched with 2 lanes, or eigh ran in the "
             f"lanes: {lanes_e}, eigh {eigh_e.lanes}")
    part_s.append(time.perf_counter() - t8)
    print(f"phase 8 wall by part: (a) {part_s[0]:.3f} s, (b) "
          f"{part_s[1]:.3f} s, (c) {part_s[2]:.3f} s, (d) {part_s[3]:.3f} s,"
          f" (e) {part_s[4]:.3f} s", flush=True)
    return lanes_a, lanes_b, lanes_d, lanes_e


def mesh_part(rank, world, card, dataset, synth5, walls):
    """Phase 9 on one rank of a started NCCL group of `world` ranks, one GPU
    each: (a) city10000 on the banded operator sharded by block rows, (a')
    K2b on each half of a two-way split of city10000's slot tables against
    the same rows of the whole assembly, (b) sphere2500 (K2's no-split
    form), (c) the n = 100000 expander of phase 5 with node-row and with
    edge shards, (d) solve_sweep over 2 budgets against the meshless sweep,
    (e) dryrun_multigpu(world). Each part counts its kernel launches from
    0; walls are printed beside the meshless phase's (`walls`). Returns
    rank's launch counts by part."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops import banded
    from mac_tpu_torch.ops.kernels import ldl
    from mac_tpu_torch.ops.kernels.assemble import assemble_ut
    from mac_tpu_torch.ops.kernels.tridiag import (tridiag_solve,
                                                   tridiag_solve_blocked)
    from mac_tpu_torch.parallel import sharded
    from mac_tpu_torch.parallel.launch import dryrun_multigpu
    from mac_tpu_torch.parallel.mesh import (MeshGroup, make_mesh,
                                             same_on_every_rank)
    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers import MAC, NaiveGreedy
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    counted = (tridiag_solve, tridiag_solve_blocked, assemble_ut,
               ldl.tridiag_ldl, ldl.tridiag_ldl_blocked)
    mesh = make_mesh(device_type="cuda")
    # NCCL sets a group's communicator up at its first collective: do that
    # for 'graph' and the default group here, outside the timed solves.
    MeshGroup(mesh).agree(True)
    same_on_every_rank(mesh, 0.0)
    dataset = Path(dataset)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"9: mesh {tuple(mesh.mesh.shape)} over {world} NCCL rank(s), "
        f"rank {rank} on {torch.cuda.current_device()}", flush=True)

    def counts():
        return {kern.__name__: kern.launches for kern in counted}

    def timed(fn):
        for kern in counted:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts()

    def bundled(name):
        meas, n = read_g2o_file(str(dataset.parent / f"{name}.g2o"))
        fixed, cands = split_edges(rpm_to_mac(meas))
        k = len(cands) // 2
        return fixed, cands, n, k, NaiveGreedy(cands).subset(k)

    # (a) city10000, banded, block rows over 'graph'
    fixed, cands, n, k, x0 = bundled("city10000")
    mac = MAC(fixed, cands, n, mesh=mesh)
    if not isinstance(mac._sharded, sharded.ShardedBanded) \
            or not mac._banded.ov_rows:
        fail("9a: city10000 on a mesh is not row-sharded banded (K2b form)")
    (r, u, up), wall, got_a = timed(lambda: mac.solve(k, x0))
    lam = scipy_lam2(mac.laplacian(u))
    gap = (lam - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED
    say(f"9a city10000 banded x mesh (block rows [{mac._sharded.b0}, "
        f"{mac._sharded.b1}) of {mac._banded.nb}, halo from "
        f"{mac._sharded.h0}): solve {wall:.4f} s against the meshless warm "
        f"median {walls['city10000']:.4f} s ({card}); relaxed lambda_2 "
        f"{lam:.9g}, gap {gap:+.3e}; rounded {int(r.sum())}; upper "
        f"{up:.9g}; launches {got_a}", flush=True)
    if not (np.all(np.isfinite(u)) and np.isfinite(up)):
        fail("9a: non-finite solve output")
    if not gap >= GAP_FLOOR:
        fail(f"9a: relaxed lambda_2 gap {gap:+.3e} below {GAP_FLOOR}")
    if int(r.sum()) != k:
        fail(f"9a: rounded {r.sum()} edges, want {k}")
    if min(got_a["tridiag_solve"], got_a["assemble_ut"],
           got_a["tridiag_ldl_blocked"]) <= 0:
        fail(f"9a: the mesh path never launched K1, K2b or K3b: {got_a}")

    # (a') K2b on the slot tables of each half of a two-way split.
    bop = mac._banded
    w = torch.as_tensor(np.concatenate([mac._w_fixed_np, 0.5 * mac.weights]),
                        dtype=torch.float32, device=bop.ueid_tbl.device)
    whole = banded.assemble_bd(bop, w).ut
    w_pad = torch.cat([-w, w.new_zeros(1)])
    dd, half, nb_loc = bop.du_dense, bop.half, -(-bop.nb // 2)
    for part in (0, 1):
        b0, b1 = part * nb_loc, min((part + 1) * nb_loc, bop.nb)
        h0 = max(b0 - half, 0)
        cols = slice(h0 * 128, b1 * 128)
        ut = assemble_ut(bop.dcol_tbl[:dd, cols].contiguous(),
                         w_pad[bop.ueid_tbl[:dd, cols]].contiguous(),
                         bop.ocol_tbl[:, h0:b1].contiguous(),
                         bop.olane_tbl[:, h0:b1].contiguous(),
                         w_pad[bop.oeid_tbl[:, h0:b1]].contiguous(), half,
                         b1 - h0)
        if not torch.equal(ut, whole[:, h0:b1]):
            fail(f"9a': K2b on block rows [{h0}, {b1}) of the split tables "
                 "differs from the whole assembly")
    say("9a' K2b on each half of a two-way split of the slot tables (own "
        "rows and halo): bitwise equal to the same rows of the whole "
        "assembly", flush=True)

    # (b) sphere2500, K2's no-split form
    fixed_s, cands_s, n_s, k_s, x_s = bundled("sphere2500")
    mac_s = MAC(fixed_s, cands_s, n_s, mesh=mesh)
    if mac_s._banded is None or mac_s._banded.ov_rows:
        fail("9b: sphere2500 on a mesh is not banded in K2's no-split form")
    (r, u, up), wall, got_b = timed(lambda: mac_s.solve(k_s, x_s))
    ref_s = BUNDLED["sphere2500"][0]
    lam = scipy_lam2(mac_s.laplacian(u))
    gap_s = (lam - ref_s) / ref_s
    say(f"9b sphere2500 banded x mesh: solve {wall:.4f} s against the "
        f"meshless warm median {walls['sphere2500']:.4f} s ({card}); "
        f"relaxed lambda_2 {lam:.9g}, gap {gap_s:+.3e}; rounded lambda_2 "
        f"{scipy_lam2(mac_s.laplacian(r)):.9g} (no round guard on a mesh); "
        f"launches {got_b}", flush=True)
    if not gap_s >= GAP_FLOOR or int(r.sum()) != k_s:
        fail(f"9b: gap {gap_s:+.3e}, rounded {r.sum()} of {k_s}")
    if min(got_b["assemble_ut"], got_b["tridiag_solve"],
           got_b["tridiag_ldl"]) <= 0:
        fail(f"9b: the mesh path never launched K2, K1 or K3: {got_b}")

    # (c) the n = 100000 expander, node rows and edges
    (fi5, wf5, ci5, wc5), k5, x5 = synth5
    got_c = {}
    for how in ("rows", "edges"):
        # Phase 5's knobs and its route: its precision probe resolves
        # float32, given here to save the probe's seconds.
        mac5 = MAC((fi5, wf5), (ci5, wc5), SCALE_N, fiedler_inner_iters=10,
                   fiedler_maxiter=60, fiedler_tol=6e-4, mesh=mesh,
                   mesh_apply=how, dtype=torch.float32)
        (r, u, up), wall, got = timed(
            lambda: mac5.solve(k5, x5, max_iters=10))
        lam = mac5.evaluate_objective(u)
        gap5 = (lam - REFERENCE_LAM2_SCALE) / REFERENCE_LAM2_SCALE
        got_c[how] = got
        say(f"9c n {SCALE_N} ELL x mesh ({how}): solve {wall:.3f} s "
            f"against the meshless warm solve {walls['scale']:.3f} s "
            f"({card}); relaxed lambda_2 {lam:.12g}, gap {gap5:+.3e}; "
            f"rounded {int(r.sum())}; upper {up:.12g}; launches {got}",
            flush=True)
        if not (np.all(np.isfinite(u)) and np.isfinite(up)
                and np.isfinite(lam)):
            fail(f"9c ({how}): non-finite output")
        if not gap5 >= GAP_FLOOR or int(r.sum()) != k5:
            fail(f"9c ({how}): gap {gap5:+.3e}, rounded {r.sum()} of {k5}")
        if min(got["tridiag_solve_blocked"], got["tridiag_ldl_blocked"]) <= 0:
            fail(f"9c ({how}): the mesh path never launched K1b or K3b: "
                 f"{got}")

    # (d) the budget sweep over 2 budgets, against the meshless sweep
    ks = [k // 2, k]
    (r_m, x_m, u_m), wall_m, got_d = timed(lambda: mac.solve_sweep(ks))
    plain = MAC(fixed, cands, n, device=mac.device, dtype=mac.dtype)
    (r_p, x_p, u_p), wall_p, _ = timed(lambda: plain.solve_sweep(ks))
    lam_m = [scipy_lam2(mac.laplacian(x)) for x in x_m]
    lam_p = [scipy_lam2(mac.laplacian(x)) for x in x_p]
    say(f"9d city10000 sweep x mesh (budgets {ks}): {wall_m:.4f} s against "
        f"the meshless sweep {wall_p:.4f} s ({card}); relaxed lambda_2 "
        f"mesh {[round(v, 9) for v in lam_m]}, meshless "
        f"{[round(v, 9) for v in lam_p]}; launches {got_d}", flush=True)
    if [int(v) for v in r_m.sum(axis=1)] != ks:
        fail(f"9d: rounded {r_m.sum(axis=1)}, want {ks}")
    if any(a < (1 - 1e-2) * b for a, b in zip(lam_m, lam_p)):
        fail("9d: a mesh lane below (1 - 1e-2) of its meshless lane")

    # (e) the mesh's dry run on this group
    (summary, wall, got_e) = timed(lambda: dryrun_multigpu(world))
    say(f"9e dryrun_multigpu({world}): {wall:.3f} s; {summary}; launches "
        f"{got_e}", flush=True)
    return {"a": got_a, "b": got_b, "c": got_c, "d": got_d}


def mesh_phase(card, dataset, synth5, walls):
    """Phase 9: a process group of torch.cuda.device_count() NCCL ranks,
    in this process for one card (a file:// rendezvous), else one spawned
    process per card; returns rank 0's launch counts by part."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    from mac_tpu_torch.parallel.launch import spawn

    world = torch.cuda.device_count()
    args = (card, str(dataset), synth5, walls)
    if world > 1:
        return spawn(mesh_part, world, device_type="cuda", timeout_s=600,
                     args=args)[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            return mesh_part(0, 1, *args)
        finally:
            dist.destroy_process_group()


def float64_phase(dev, card, dataset, synth5, counted):
    """Phase 10, float64 and the remaining methods, every gate fatal: (a)
    the float64 instantiations of K1, K1b and K2/K2b against their plain
    versions at phase 3's shapes, timed; (b) MAC(..., use_banded=True,
    dtype=torch.float64) on city10000 and sphere2500 at full size; (c)
    LOBPCG on city10000's banded float32 operator; (d) the dense eigh on a
    banded n = 600 graph; (f) the n = 100000 expander of phase 5 in
    float64 (the V-cycle through K1b's float64 instantiation). Phase 8c is
    the float64 sweep (e). `counted` are the kernel wrappers. Returns (b)'s
    solvers {name: (MAC, K, x_init)}, the launches by dtype of (b)'s two
    datasets and of (f), and the float64 kernels' entries of the kernels
    line."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops import banded, laplacian
    from mac_tpu_torch.ops.kernels.assemble import (assemble_ut,
                                                    assemble_ut_plain)
    from mac_tpu_torch.ops.kernels.tridiag import (
        reset_counts, tridiag_solve, tridiag_solve_blocked,
        tridiag_solve_blocked_plain, tridiag_solve_plain)
    from mac_tpu_torch.ops.tridiag import (tridiag_ldl, tridiag_ldl_auto,
                                           tridiag_ldl_blocked)
    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers import MAC, NaiveGreedy
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    f64 = torch.float64
    part_s = {}

    def randn(shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed), dtype=f64).to(dev)

    def chain(n, seed):
        rng = np.random.RandomState(seed)
        e = -(0.5 + rng.rand(n - 1))
        d = (0.1 + rng.rand(n) - np.concatenate([[0], e])
             - np.concatenate([e, [0]]))
        return (torch.as_tensor(d, dtype=f64, device=dev),
                torch.as_tensor(e, dtype=f64, device=dev))

    def check(kern, plain, f, B, label, **kw):
        got = kern(f.dp, f.l, B, **kw)
        ref = plain(f.dp, f.l, B, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = (got.dtype == f64 and bool(torch.isfinite(got).all())
              and torch.allclose(got, ref, rtol=F64_TOL, atol=F64_TOL))
        print(f"{kern.__name__} float64 {label}: max|kernel - plain| "
              f"{err:.3e} (max|X| {float(ref.abs().max()):.3e}) -> "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{kern.__name__}'s float64 kernel disagrees with its plain "
                 f"version on {label} (rtol/atol {F64_TOL})")
        return err

    def times(kern, plain, f, B, n, q):
        tm = {"device_ms": device_ms(lambda: kern(f.dp, f.l, B)),
              "call_ms": call_ms(lambda: kern(f.dp, f.l, B)),
              "plain_ms": call_ms(lambda: plain(f.dp, f.l, B))}
        tm["bound_ms"], tm["bound_by"] = tridiag_bound(n, q, itemsize=8)
        print(f"{kern.__name__} float64 time at ({n}, {q}): kernel device "
              f"{tm['device_ms']:.5f} ms, call {tm['call_ms']:.4f} ms, "
              f"plain call {tm['plain_ms']:.4f} ms, bound "
              f"{tm['bound_ms']:.5f} ms ({tm['bound_by']}) ({card})",
              flush=True)
        return tm

    # (a) the float64 kernels against their plain versions.
    t10 = time.perf_counter()
    (_, n, fixed, cands, k, x_init, bop, w, _, _, _) = dataset_inputs(dev)
    w64 = w.double()
    fac = banded.chain_factor(bop, banded.assemble_bd(bop, w64), w64)
    B = randn((n, 4), 0)
    k1 = {"max_abs_err": check(tridiag_solve, tridiag_solve_plain, fac, B,
                               f"city10000's chain factor ({n}, 4)")}
    limit = k1_whole_row_limit(4, 8)
    d, e = chain(limit + 1, 1)
    for rows in (limit, limit + 1):
        f_ex = tridiag_ldl(d[:rows], e[:rows - 1])
        k1["max_abs_err"] = max(k1["max_abs_err"], check(
            tridiag_solve, tridiag_solve_plain, f_ex, randn((rows, 4), rows),
            f"exact factor ({rows}, 4), "
            f"{'whole rows' if rows == limit else 'tiled'}"))
    f_5k = tridiag_ldl(d[:5000], e[:4999])
    k1["max_abs_err"] = max(k1["max_abs_err"], check(
        tridiag_solve, tridiag_solve_plain, f_5k, randn((5000, 200), 2),
        "exact factor (5000, 200)"))
    k1.update(times(tridiag_solve, tridiag_solve_plain, fac, B, n, 4))

    fi5, wf5, ci5, wc5 = synth5
    k5 = len(wc5) // 4
    x5 = np.zeros(len(wc5))
    x5[np.argpartition(wc5, -k5)[-k5:]] = 1.0
    op5 = laplacian.build_operator(np.concatenate([fi5, ci5]),
                                   SCALE_N).to(dev)
    w5 = torch.as_tensor(np.concatenate([wf5, x5 * wc5]), dtype=f64,
                         device=dev)
    d5, e5 = laplacian.lap_tridiagonal_part(op5, w5)
    f5 = tridiag_ldl_auto(d5 + 100 * torch.finfo(f64).eps * d5.max(), e5)
    if f5.seg != 1024:
        fail(f"the float64 n = {SCALE_N} chain factor has seg {f5.seg}")
    B5 = randn((SCALE_N, 4), 3)
    k1b = {"max_abs_err": check(
        tridiag_solve_blocked, tridiag_solve_blocked_plain, f5, B5,
        f"two-grid chain factor ({SCALE_N}, 4, seg 1024)")}
    flat = torch.empty(B5.numel() + 1, dtype=f64, device=dev)
    flat[1:] = B5.reshape(-1)
    B5m = flat[1:].view(B5.shape)
    if B5m.data_ptr() % 16 != 8 or not B5m.is_contiguous():
        fail("the misaligned float64 right-hand side is not 8 bytes off")
    k1b["max_abs_err"] = max(k1b["max_abs_err"], check(
        tridiag_solve_blocked, tridiag_solve_blocked_plain, f5, B5m,
        f"two-grid chain factor, B 8 bytes off a 16-byte boundary "
        f"({SCALE_N}, 4)"))
    d_b, e_b = chain(40000, 4)
    k1b["max_abs_err"] = max(k1b["max_abs_err"], check(
        tridiag_solve_blocked, tridiag_solve_blocked_plain,
        tridiag_ldl_blocked(d_b, e_b, block=1024), randn((40000, 8), 5),
        "blocked factor (40000, 8, seg 1024)"))
    k1b.update(times(tridiag_solve_blocked, tridiag_solve_blocked_plain, f5,
                     B5, SCALE_N, 4))

    (_, _, fixed_sp, cands_sp, _, _, bop_sp, w_sp, _, _,
     _) = dataset_inputs(dev, "sphere2500")
    k2 = {}
    for key, label, b_, w_ in (
            ("K2b", "city10000 (split)", bop, w64),
            ("K2", "sphere2500 (no split)", bop_sp, w_sp.double())):
        args = k2_args(b_, w_)
        got = assemble_ut(*args)
        ref = assemble_ut_plain(*args)
        torch.cuda.synchronize()
        same = got.dtype == f64 and torch.equal(got, ref)
        print(f"assemble_ut float64 {label}: shape {tuple(got.shape)}, "
              f"max|kernel - plain| {float((got - ref).abs().max()):.3e} -> "
              f"{'bitwise equal' if same else 'MISMATCH'}", flush=True)
        if not same:
            fail(f"assemble_ut's float64 kernel differs from its plain "
                 f"version on {label}")
        k2[key] = dict(k2_times(args, f"{key} float64 time at {label}",
                                card), max_abs_err=0.0)
    part_s["a"] = time.perf_counter() - t10

    # (b) the banded operator in float64, through the user's entry point.
    t10 = time.perf_counter()
    launches_b, solvers_b = {}, {}
    for name, ref_lam in (("city10000", REFERENCE_LAM2_UNROUNDED),
                          ("sphere2500", BUNDLED["sphere2500"][0])):
        meas, n_ = read_g2o_file(str(dataset.parent / f"{name}.g2o"))
        fixed_, cands_ = split_edges(rpm_to_mac(meas))
        k_ = len(cands_) // 2
        x_ = NaiveGreedy(cands_).subset(k_)
        mac = MAC(fixed_, cands_, n_, use_banded=True, dtype=f64,
                  device="cuda")
        if (mac._banded is None or mac.fw_polish or mac.round_guard
                or (mac.fiedler_tol, mac.fiedler_maxiter,
                    mac.fiedler_inner_iters) != (1e-8, 200, 16)):
            fail(f"10b {name}: not the banded float64 route with the "
                 f"reference's conservative knobs")
        split = mac._banded.ov_rows > 0
        solvers_b[name] = (mac, k_, x_)
        reset_counts(*counted)
        walls = []
        with PlainOnCard() as plain:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r_, u_, up_ = mac.solve(k_, x_, max_iters=20)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        got = by_dtype(counted)
        launches_b[name] = got
        if name == "city10000":
            busy, kernels_n, top = profiled_busy(
                lambda: mac.solve(k_, x_, max_iters=20))
            print(f"10b city10000 banded float64, one profiled warm solve: "
                  f"device busy {busy:.3f} ms over {kernels_n} kernels and "
                  f"copies (the unprofiled warm wall {walls[1]:.4f} s); "
                  f"largest {[(round(ms, 3), c, nm) for ms, c, nm in top]} "
                  f"({card})", flush=True)
        lam = scipy_lam2(mac.laplacian(u_))
        gap = (lam - ref_lam) / ref_lam
        print(f"10b {name} banded float64 (n {n_}, K {k_}, max_iters=20, "
              f"x_init NaiveGreedy; assembly form "
              f"{'K2b (split)' if split else 'K2 (no split)'}): cold "
              f"{walls[0]:.4f} s, warm {walls[1]:.4f} s ({card}); relaxed "
              f"lambda_2 (scipy) {lam:.17g}, reference {ref_lam:.17g}, "
              f"relative gap {gap:+.3e}; upper {up_:.17g}; rounded "
              f"{int(r_.sum())}; last_solve_stats {mac.last_solve_stats}; "
              f"kernel launches by dtype {got}; plain versions on the card "
              f"{plain.calls}", flush=True)
        if (got["assemble_ut"].get("float64", 0) <= 0
                or k1_body(got, "float64") <= 0
                or min(got[kern].get("float64", 0) for kern in CG_KERNELS)
                <= 0):
            fail(f"10b {name}: K2/K2b, K1p or K5, K6, K7 float64 never "
                 f"launched: {got}")
        if any(v.get("float32", 0) for v in got.values()) or plain.calls:
            fail(f"10b {name}: a block left the float64 kernels: {got}, "
                 f"plain {plain.calls}")
        if (name == "city10000") != split:
            fail(f"10b {name}: assembly form split={split}")
        if int(r_.sum()) != k_ or set(np.unique(r_)) - {0.0, 1.0}:
            fail(f"10b {name}: rounded {r_.sum()} edges, want {k_}")
        if not (np.isfinite(lam) and up_ >= lam * (1 - 1e-9)):
            fail(f"10b {name}: upper {up_} below the relaxed {lam}")
        if not gap >= GAP_FLOOR_F64:
            fail(f"10b {name}: relaxed gap {gap:+.3e} below "
                 f"{GAP_FLOOR_F64}")
    part_s["b"] = time.perf_counter() - t10

    # (c) LOBPCG on city10000's banded float32 operator (fast32 policy).
    t10 = time.perf_counter()
    meas, n_c = read_g2o_file(str(dataset))
    fixed_c, cands_c = split_edges(rpm_to_mac(meas))
    mac_c = MAC(fixed_c, cands_c, n_c, fiedler_method="lobpcg",
                device="cuda")
    if mac_c._banded is None or mac_c.dtype != torch.float32:
        fail("10c: city10000 with LOBPCG left the banded float32 route")
    reset_counts(*counted)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_c, u_c, up_c = mac_c.solve(k, x_init)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    got_c = by_dtype(counted)
    lam_c = scipy_lam2(mac_c.laplacian(u_c))
    gap_c = (lam_c - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED
    print(f"10c city10000 LOBPCG, banded float32: cold {walls[0]:.4f} s, "
          f"warm {walls[1]:.4f} s ({card}); relaxed lambda_2 (scipy) "
          f"{lam_c:.12g}, relative gap {gap_c:+.3e}; upper {up_c:.12g}; "
          f"rounded {int(r_c.sum())}; last_solve_stats "
          f"{mac_c.last_solve_stats}; launches by dtype {got_c}", flush=True)
    if int(r_c.sum()) != k or not gap_c >= GAP_FLOOR:
        fail(f"10c: rounded {r_c.sum()} (want {k}), gap {gap_c:+.3e} "
             f"(floor {GAP_FLOOR})")
    if (k1_body(got_c, "float32") <= 0
            or got_c["assemble_ut"].get("float32", 0) <= 0):
        fail(f"10c: K1 or K2b never launched: {got_c}")
    part_s["c"] = time.perf_counter() - t10

    # (d) the dense eigh on a banded n = 600 graph, three steps.
    t10 = time.perf_counter()
    idx_d, w_d, n_d = pose_graph(600, 110, 9, 11)
    fixed_d = (idx_d[:n_d - 1], w_d[:n_d - 1])
    cands_d = (idx_d[n_d - 1:], w_d[n_d - 1:])
    k_d = len(cands_d[1]) // 2
    mac_d = MAC(fixed_d, cands_d, n_d, use_banded=True, dtype=torch.float32,
                fiedler_method="dense", device="cuda")
    reset_counts(*counted)
    r_d, u_d, up_d = mac_d.solve(k_d, max_iters=3)
    got_d = by_dtype(counted)
    print(f"10d dense eigh on the banded operator (n {n_d}, K {k_d}, 3 "
          f"steps): rounded {int(r_d.sum())}, relaxed lambda_2 (scipy) "
          f"{scipy_lam2(mac_d.laplacian(u_d)):.9g}, upper {up_d:.9g}; "
          f"launches by dtype {got_d} ({card})", flush=True)
    if (mac_d._banded is None or int(r_d.sum()) != k_d
            or not (np.all(np.isfinite(u_d)) and np.isfinite(up_d))):
        fail(f"10d: banded {mac_d._banded is not None}, rounded "
             f"{r_d.sum()} (want {k_d}), upper {up_d}")
    part_s["d"] = time.perf_counter() - t10

    # (f) the n = 100000 expander in float64: K8, the V-cycle's K1p and K7.
    t10 = time.perf_counter()
    mac_f = MAC((fi5, wf5), (ci5, wc5), SCALE_N, dtype=f64,
                fiedler_inner_iters=10, fiedler_maxiter=60,
                fiedler_tol=6e-4, device="cuda")
    if mac_f._banded is not None or mac_f.op.mode != "ell":
        fail("10f: the float64 expander left the ELL route")
    reset_counts(*counted)
    with PlainOnCard() as plain_f:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_f, u_f, up_f = mac_f.solve(k5, x5, max_iters=2)
        torch.cuda.synchronize()
        wall_f = time.perf_counter() - t0
        lam_f = mac_f.evaluate_objective(u_f)
    got_f = by_dtype(counted)
    print(f"10f n = {SCALE_N} expander in float64 (ELL, precond "
          f"{mac_f.fiedler_precond}, max_iters=2): solve {wall_f:.3f} s "
          f"({card}); evaluate_objective {lam_f:.12g} (the reference's "
          f"{REFERENCE_LAM2_SCALE:.12g} after its own 10 steps); upper "
          f"{up_f:.12g}; rounded {int(r_f.sum())}; last_solve_stats "
          f"{mac_f.last_solve_stats}; launches by dtype {got_f}; plain "
          f"versions on the card {plain_f.calls}", flush=True)
    if (min(got_f[kern].get("float64", 0) for kern in ELL_CG_KERNELS) <= 0
            or plain_f.calls
            or any(v.get("float32", 0) for v in got_f.values())):
        fail(f"10f: the CG step did not run K8's, K1p's, K7's and K6's "
             f"float64 instantiations alone: {got_f}, plain {plain_f.calls}")
    if int(r_f.sum()) != k5 or not (np.isfinite(lam_f)
                                     and up_f >= lam_f * (1 - 1e-6)):
        fail(f"10f: rounded {r_f.sum()} (want {k5}), lambda_2 {lam_f}, "
             f"upper {up_f}")
    part_s["f"] = time.perf_counter() - t10
    print("phase 10 wall by part: " + ", ".join(
        f"({p}) {v:.3f} s" for p, v in part_s.items()), flush=True)

    def entry(name, source, replaces, shape, tm, launches, path):
        return {"name": name, "dtype": "float64", "route": "cuda",
                "source": f"mac_tpu_torch/csrc/{source}",
                "replaces": replaces, "shape": shape, "launches": launches,
                "launches_path": path, "max_abs_err": tm["max_abs_err"],
                "ms": tm["device_ms"], "device_ms": tm["device_ms"],
                "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "library_ms": tm.get("library_ms")}

    for name, kern in (("city10000", "tridiag_ldl_blocked"),
                       ("sphere2500", "tridiag_ldl")):
        if launches_b[name][kern].get("float64", 0) <= 0:
            fail(f"10b {name}: {kern} float64 never launched")
    if got_f["tridiag_ldl_blocked"].get("float64", 0) <= 0:
        fail("10f: K3b float64 never launched")
    city, sphere = launches_b["city10000"], launches_b["sphere2500"]
    return solvers_b, launches_b, got_f, [
        entry("tridiag_solve_f64", "tridiag.cu",
              "mac_tpu/ops/pallas/tridiag_kernel.py:44",
              f"({n}, 4), city10000's chain factor", k1,
              k1_body(city, "float64") + k1_body(sphere, "float64"),
              "phase 10b (city10000 and sphere2500, 2 solves each; K1's "
              "body, since the V-cycle's K1p)"),
        entry("tridiag_solve_blocked_f64", "tridiag.cu",
              "mac_tpu/ops/pallas/tridiag_kernel.py:107",
              f"({SCALE_N}, 4), the two-grid chain factor", k1b,
              got_f["tridiag_solve_blocked"].get("float64", 0),
              "phase 10f: none since the matrix-free V-cycle's chain solve "
              "is K1p's segment body (K1b's solve; its float64 launches "
              "under tridiag_solve_permuted)"),
        entry("assemble_ut_f64", "assemble.cu",
              "mac_tpu/ops/pallas/assemble_kernel.py:61",
              "city10000 tables (K2b form)", k2["K2b"],
              city["assemble_ut"].get("float64", 0), "phase 10b city10000"),
        entry("assemble_ut_f64", "assemble.cu",
              "mac_tpu/ops/pallas/assemble_kernel.py:49",
              "sphere2500 tables (K2 form, no split)", k2["K2"],
              sphere["assemble_ut"].get("float64", 0),
              "phase 10b sphere2500"),
    ]


def factor_ab(card, cases, kernels):
    """Phase 11: each case's warm solve in turns old, new, new, old in this
    call, "old" with the chain factor patched back to its plain loops
    (PlainFactor), "new" through K3/K3b (`kernels`); each turn's wall, its
    relaxed gap against the case's reference and its factorisations (kernel
    launches or plain calls). `cases` maps a name to (solve(), lam_ref(out)
    -> (lambda_2, reference)); then one profiled warm solve of each on
    the kernels (device busy time, kernels). Returns {name: {"old":
    [walls], "new": [walls], "launches": per new solve, "plain_calls":
    per old solve}}."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels.tridiag import reset_counts

    out = {}
    for name, (solve, lam_ref) in cases.items():
        res = out[name] = {"old": [], "new": []}
        for turn in ("old", "new", "new", "old"):
            reset_counts(*kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if turn == "old":
                with PlainFactor() as pf:
                    got = solve()
                    torch.cuda.synchronize()
                count = pf.calls
            else:
                got = solve()
                torch.cuda.synchronize()
                count = sum(kern.launches for kern in kernels)
            wall = time.perf_counter() - t0
            res[turn].append(wall)
            res["launches" if turn == "new" else "plain_calls"] = count
            lam, ref = lam_ref(got)
            print(f"11 {name} {turn}: warm solve {wall:.4f} s, relaxed "
                  f"lambda_2 {lam:.12g}, gap {(lam - ref) / ref:+.3e}, "
                  f"factorisations {count} ("
                  f"{'plain loops' if turn == 'old' else 'K3/K3b launches'})"
                  f" ({card})", flush=True)
            if not (np.all(np.isfinite(got[1])) and np.isfinite(lam)
                    and count > 0):
                fail(f"11 {name} {turn}: non-finite output or no factor")
        print(f"11 {name}: old {[round(t, 4) for t in res['old']]} s, new "
              f"{[round(t, 4) for t in res['new']]} s; mean new / old "
              f"{sum(res['new']) / sum(res['old']):.3f} ({card})", flush=True)
        busy, kernels_n, top = profiled_busy(solve)
        print(f"11 {name} new, one profiled warm solve: device busy "
              f"{busy:.3f} ms over {kernels_n} kernels and copies; largest "
              f"{[(round(ms, 3), c, nm) for ms, c, nm in top]} ({card})",
              flush=True)
    return out


# Phase 13: the warm solves' turns: "eager" (no graph, SolvePath("eager")),
# "inner" (the inner CG steps replayed, SolvePath("inner")), "plain-fw" (the
# set-up and the outer iteration replayed, the Frank-Wolfe loop on the host:
# PlainFW, as before K9 and K10; these three run the host loop), "graph"
# (the device loop over the replayed set-up and outer iteration, K9 and
# K10) and "plain-cg" (as "graph", with the CG step as PyTorch ops, PlainCG:
# as before K5, K6, K1p and K7), interleaved.
GRAPH_TURNS = ("eager", "inner", "plain-fw", "plain-cg", "graph", "graph",
               "plain-cg", "plain-fw", "inner", "eager")
PROFILE_TURNS = ("eager", "inner", "plain-fw", "graph", "plain-cg")


def device_items(fn):
    """(busy ms, kernels, [(ms, calls, name)] by device item, largest
    first) of one call of fn() under torch.profiler, CUDA activity alone;
    kernels counts neither copies nor memsets (nor the copy kernels a
    graph's memcpy nodes may run as, memcpy32_post and its kind)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns, cnt = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.end_ns() - e.start_ns(), cnt + 1)
    items = sorted(((ns / 1e6, cnt, name) for name, (ns, cnt)
                    in by_name.items()), reverse=True)
    kernels = sum(cnt for _, cnt, name in items
                  if not name.lower().startswith(("memcpy", "memset")))
    return sum(ms for ms, _, _ in items), kernels, items


def _cudart():
    """The CUDA runtime library PyTorch loaded (its path read from
    /proc/self/maps), through ctypes."""
    import ctypes

    with open("/proc/self/maps") as maps:
        paths = sorted({ln.split()[-1] for ln in maps
                        if "libcudart" in ln and ln.split()[-1].startswith("/")})
    lib = ctypes.CDLL(paths[0] if paths else "libcudart.so.12")
    for fn in ("cudaGraphGetNodes", "cudaGraphNodeGetType",
               "cudaGraphChildGraphNodeGetGraph"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def graph_kernels(fn) -> int:
    """The kernels one replay of a CUDA graph of fn() launches: the graph
    captured (torch.cuda.CUDAGraph(keep_graph=True), never instantiated
    or replayed) and its kernel nodes counted, child graphs' too, from the
    graph itself (cudaGraphGetNodes, cudaGraphNodeGetType); copy and
    memset nodes are not kernels. No profiler trace is read: a trace on
    this card can lose or gain device items (step_kernels)."""
    import ctypes

    import torch

    rt = _cudart()

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: cudaError {err}")

    def count(graph) -> int:
        n = ctypes.c_size_t(0)
        check(rt.cudaGraphGetNodes(ctypes.c_void_p(graph), None,
                                   ctypes.byref(n)), "cudaGraphGetNodes")
        nodes = (ctypes.c_void_p * max(n.value, 1))()
        check(rt.cudaGraphGetNodes(ctypes.c_void_p(graph), nodes,
                                   ctypes.byref(n)), "cudaGraphGetNodes")
        kernels = 0
        for node in nodes[:n.value]:
            kind = ctypes.c_int(-1)
            check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                          ctypes.byref(kind)),
                  "cudaGraphNodeGetType")
            if kind.value == 0:  # cudaGraphNodeTypeKernel
                kernels += 1
            elif kind.value == 4:  # cudaGraphNodeTypeGraph
                child = ctypes.c_void_p()
                check(rt.cudaGraphChildGraphNodeGetGraph(
                    ctypes.c_void_p(node), ctypes.byref(child)),
                    "cudaGraphChildGraphNodeGetGraph")
                kernels += count(child.value)
        return kernels

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    kernels = count(graph.raw_cuda_graph())
    graph.reset()
    return kernels


def step_kernels(op, rounds: int = 3):
    """(kernels, device ms) of one inner CG step on the graphed route of
    `op` (a banded operator or an ELL one), over the route's static state
    after a solve: the kernels an inner solve of 6 steps launches less
    those of one of 5 (graph_kernels: each captured once more, its kernel
    nodes counted); the ms the replayed inner solve of 6 steps less one
    of 5 (ops.graphs.inner_replay, each captured first), each graph's
    replay alone under torch.profiler behind a spin kernel and a
    synchronize, `rounds` times in turns, the median busy of each."""
    import statistics

    import torch

    from mac_tpu_torch.ops import cg, graphs
    from mac_tpu_torch.ops.lobpcg import as_operator

    route = next(r for r in op.graph_routes.values()
                 if any(key[0] != "inner" for key in r.statics))
    s = next(s for key, s in route.statics.items() if key[0] != "inner")
    dtype = s["X"].dtype
    state = {n: s[n] for n in route.names}
    c = s["lnorm"].to(dtype)
    state.update(c=c, sigma=32 * torch.finfo(dtype).eps * c)
    B = s["X"].clone()
    replays = {}
    for iters in (5, 6):
        graphs.inner_replay(route, state, B, B, iters)  # captures
        key = (("inner", iters), route.statics[("inner", B.dtype,
                                                tuple(B.shape), B.device)]
               ["key"], graphs._kernels_in_use())
        replays[iters] = route.graphs[key].graph.replay
    inner = route.statics[("inner", B.dtype, tuple(B.shape), B.device)]

    def solve(iters):
        apply_L, Minv = route.build(inner)
        apply_inner = as_operator(apply_L).shifted(inner["c"], inner["sigma"])
        inner["Y"].copy_(cg.pcg_fixed(apply_inner, inner["B"], Minv,
                                      iters=iters, X0=inner["X0"]))

    kernels = {iters: graph_kernels(lambda: solve(iters)) for iters in (5, 6)}

    def busy(replay):
        def run():
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            replay()

        torch.cuda.synchronize()
        _, _, items = device_items(run)
        return sum(ms for ms, _, name in items if "spin_kernel" not in name)

    ms = {5: [], 6: []}
    for _ in range(rounds):
        for iters in (5, 6):
            ms[iters].append(busy(replays[iters]))
    return (kernels[6] - kernels[5],
            statistics.median(ms[6]) - statistics.median(ms[5]))


def route_op(mac):
    """The operator whose graph routes a MAC's single solves use."""
    return mac._banded if mac._banded is not None else mac.op


def discard_marks(op) -> dict:
    """How many discarded set-ups each of op's routes has recorded."""
    return {id(r): len(r.discard_launches) for r in op.graph_routes.values()}


def discarded_by_dtype(op, marks) -> dict:
    """{wrapper name: {dtype: launches}} of the set-ups op's routes
    discarded since discard_marks gave `marks` (a stopped Frank-Wolfe
    loop's next set-up, ops.graphs.StepSolves)."""
    from mac_tpu_torch.ops import graphs

    out = {}
    for route in op.graph_routes.values():
        for launches in route.discard_launches[marks.get(id(route), 0):]:
            for wrapper, (_, _, dtypes, _) in zip(graphs.WRAPPERS, launches):
                got = out.setdefault(wrapper.__name__, {})
                for dt, v in dtypes.items():
                    got[dt] = got.get(dt, 0) + v
    return out


def less(launches: dict, extra: dict) -> dict:
    """launches ({wrapper: {dtype: n}}) less extra, zeros left out."""
    out = {}
    for kern, by in launches.items():
        left = {dt: v - extra.get(kern, {}).get(dt, 0)
                for dt, v in by.items()}
        out[kern] = {dt: v for dt, v in left.items() if v}
    return out


def same_solve(got, want, f64: bool) -> bool:
    """Rounded selection and x bitwise; the upper bound bitwise, or within
    1e-12 relative in float64 (the loop's own bound, whose dot and norm the
    device loop sums in its own order)."""
    import numpy as np

    upper = (got[2] == want[2] if not f64
             else abs(got[2] - want[2]) <= 1e-12 * abs(want[2]))
    return (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1]) and upper)


# Phase 13: the turns whose Frank-Wolfe loop runs on the host (MAC._fw_host):
# SolvePath's (eager, inner) and PlainFW's; the others run the device loop.
HOST_LOOP_TURNS = ("eager", "inner", "plain-fw")


def graph_ab(card, cases, counted, fw_kerns):
    """Phase 13: each case's warm solve in the turns GRAPH_TURNS in this
    call. `cases` maps a name to (MAC, solve() -> (rounded, unrounded,
    upper), lam(unrounded) -> relaxed lambda_2, K, quality(lambda_2) ->
    (ok, text)); `counted` are the kernel wrappers of the eigensolve,
    `fw_kerns` K9 and K10's. Per turn: the wall, the relaxed lambda_2 (of
    the first turn's x, which every turn's equals; the scipy referee's
    start vector is random, so it is read once), the upper bound, the FW
    and Fiedler iterations, the captures, replays, redos and discarded
    set-ups, the kernels' launches. Gates: every turn's unrounded x and
    rounded selection bitwise the first turn's (an "eager" one, the host
    loop), its upper bound too (in float64 the device loop's within 1e-12
    relative: same_solve), and its FW and Fiedler iterations equal; K9 and
    K10 launched once a step in the device loop's turns ("graph",
    "plain-cg"), never in the host loop's (HOST_LOOP_TURNS); no capture
    in a warm solve; no replay in an eager turn; equal launches of every
    wrapper by dtype in every turn (a discarded set-up's taken off), K4
    among them, and of K4 by body; K6 launched in every turn, and K5, K1p
    and K7 on the banded routes; no torch.linalg.eigh call; the case's
    quality gate, exactly K rounded and upper >= relaxed. The "plain-cg"
    turns (PlainCG) are held to each other instead (bitwise, the same
    launches, none of the CG step's kernels) and to the quality gate.
    Then one profiled warm solve each way of PROFILE_TURNS (device busy,
    kernels and copies, idle share of its own wall, launch calls on the
    host, capped by HOST_LAUNCH_CAPS in the device loop's "graph" turn,
    and the host reads of the loops and graphed_solve, graphs.host_reads;
    for "graph" and "plain-cg" the kernels and device ms of one replayed
    CG step, step_kernels), forced_guard (the host loop's per-step
    solves) and device_loop_guard (the device loop's).
    Returns {name: {turn: [walls], "profile": {turn: (wall, busy ms,
    kernels, host launch calls, one CG step's kernels, its ms, host
    reads)}, "launches": {wrapper: {dtype: per solve}}, "bodies": K4's
    launches a solve by body, "stats": graph_stats}}."""
    from contextlib import nullcontext

    import numpy as np
    import torch

    from mac_tpu_torch.ops import graphs
    from mac_tpu_torch.ops.kernels.tridiag import reset_counts

    def turn_ctx(turn):
        if turn == "plain-cg":
            return PlainCG()
        if turn == "plain-fw":
            return PlainFW()
        return SolvePath(turn) if turn != "graph" else nullcontext()

    out = {}
    for name, (mac, solve, lam_of, k, quality) in cases.items():
        op = route_op(mac)
        f64 = str(mac.dtype).endswith("float64")
        res = out[name] = {turn: [] for turn in GRAPH_TURNS}
        # The inner-only path's, the plain CG step's and the host loop's
        # graphs (its set-ups do not chain the Ritz block) are no main
        # path's: capture them in one untimed solve each first.
        for turn in ("inner", "plain-cg", "plain-fw"):
            s0 = graph_stats(op)
            with turn_ctx(turn):
                solve()
            print(f"13 {name}: the {turn} path's first solve captured "
                  f"{graph_stats(op)['captures'] - s0['captures']} graphs",
                  flush=True)
        first, seen, plain_first, plain_seen = None, set(), None, set()
        for turn in GRAPH_TURNS:
            reset_counts(*counted, *fw_kerns)
            s0, marks = graph_stats(op), discard_marks(op)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with turn_ctx(turn), EighCalls() as eigh:
                got = solve()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = dict(mac.last_solve_stats)
            iters = (stats["fw_iterations"], stats["fiedler_iterations"])
            s1 = graph_stats(op)
            d = {f: s1[f] - s0[f] for f in ("captures", "replays", "redos",
                                            "discards")}
            disc = discarded_by_dtype(op, marks)
            launches = less(by_dtype(counted), disc)
            fw = [kern.launches for kern in fw_kerns]
            fw_ok = (fw == [0, 0] if turn in HOST_LOOP_TURNS
                     else fw == [iters[0]] * 2)
            bodies = dict(next(kern for kern in counted if kern.__name__
                               == "sym_eig").launches_by_body)
            res[turn].append(wall)
            if turn == "plain-cg":
                # The plain CG step rounds otherwise: its turns are held to
                # each other, and to the quality gate below.
                if plain_first is None:
                    plain_first, plain_lam = (got, iters), lam_of(got[1])
                same = (same_solve(got, plain_first[0], False)
                        and iters == plain_first[1])
                short = {kern: sum(v.values()) for kern, v in launches.items()}
                print(f"13 {name} plain-cg: warm solve {wall:.4f} s, relaxed "
                      f"lambda_2 {plain_lam:.17g} (x, rounded selection, "
                      f"upper bound and iterations "
                      f"{'bitwise' if same else 'NOT bitwise'} the first "
                      f"plain-cg turn's), upper {got[2]:.17g}, rounded "
                      f"{int(got[0].sum())}, FW / Fiedler iterations "
                      f"{iters}; captures {d['captures']}, replays "
                      f"{d['replays']}, discards {d['discards']}; K9, K10 "
                      f"{fw}; launches {short} ({card})", flush=True)
                if not same or d["captures"] or not d["replays"] or \
                        not fw_ok or any(
                            short[kern] for kern in set(CG_KERNELS)
                            | set(ELL_CG_KERNELS)):
                    fail(f"13 {name} plain-cg: not bitwise the first "
                         f"plain-cg turn, a capture, no replay, K9 / K10 "
                         f"not once a step, or a kernel of the CG step "
                         f"launched: {d}, {fw}, {short}")
                plain_seen.add(tuple(sorted(
                    (kern, tuple(sorted(v.items())))
                    for kern, v in launches.items())))
                continue
            if first is None:
                first, lam = (got, iters), lam_of(got[1])
            same = (same_solve(got, first[0],
                               f64 and turn not in HOST_LOOP_TURNS)
                    and iters == first[1])
            short = {kern: sum(v.values()) for kern, v in launches.items()}
            print(f"13 {name} {turn}: warm solve {wall:.4f} s, relaxed "
                  f"lambda_2 {lam:.17g} (x, rounded selection, upper bound "
                  f"and iterations {'bitwise' if same else 'NOT bitwise'} "
                  f"the first turn's), upper {got[2]:.17g}, rounded "
                  f"{int(got[0].sum())}, FW / Fiedler iterations {iters}; "
                  f"captures {d['captures']}, replays {d['replays']}, redos "
                  f"{d['redos']}, discards {d['discards']}; K1 "
                  f"{short['tridiag_solve']}, K1b "
                  f"{short['tridiag_solve_blocked']}, K4 "
                  f"{short['sym_eig']} (by body {bodies}), K9, K10 {fw}; "
                  f"eigh calls {eigh.calls} ({card})", flush=True)
            if not same:
                fail(f"13 {name} {turn}: the solve is not bitwise the first "
                     f"turn's (max |x - x_first| "
                     f"{np.abs(got[1] - first[0][1]).max():.3e}, relaxed "
                     f"lambda_2 {lam_of(got[1])!r} against {lam!r}, upper "
                     f"{got[2]!r} against {first[0][2]!r}, iterations "
                     f"{iters} against {first[1]})")
            if (d["captures"] or (turn == "eager" and d["replays"])
                    or (turn != "eager" and not d["replays"])
                    or eigh.calls or short["sym_eig"] <= 0 or not fw_ok):
                fail(f"13 {name} {turn}: {d}, eigh calls {eigh.calls}, K4 "
                     f"launches {short['sym_eig']}, K9 / K10 {fw}")
            # The CG step's kernels: K6, K1p and K7 on every route, K5 on
            # the banded one, K8 on the matrix-free one.
            cg_want = (CG_KERNELS if hasattr(op, "ueid_tbl")
                       else ELL_CG_KERNELS)
            if min(short[kern] for kern in cg_want) <= 0:
                fail(f"13 {name} {turn}: a kernel of the CG step never "
                     f"launched: {short}")
            seen.add(tuple(sorted((kern, tuple(sorted(v.items())))
                                  for kern, v in launches.items()))
                     + tuple(sorted(bodies.items())))
        if len(seen) != 1 or len(plain_seen) != 1:
            fail(f"13 {name}: launches a solve differ between the turns: "
                 f"{seen}, plain-cg {plain_seen}")
        ok_p, text_p = quality(plain_lam)
        print(f"13 {name} plain-cg: {text_p}", flush=True)
        if not ok_p:
            fail(f"13 {name} plain-cg: quality gate: {text_p}")
        res["launches"], res["bodies"] = launches, bodies
        res["stats"] = graph_stats(op)
        ok, text = quality(lam)
        got0 = first[0]
        rounded_ok = int(got0[0].sum()) == k
        bound_ok = got0[2] >= lam * (1 - 1e-6)
        print(f"13 {name}: {text}; rounded {int(got0[0].sum())} of K "
              f"{k}; upper {got0[2]:.12g} >= relaxed {lam:.12g}: "
              f"{bound_ok}", flush=True)
        if not (ok and rounded_ok and bound_ok):
            fail(f"13 {name}: quality gate: {text}, rounded "
                 f"{int(got0[0].sum())} (K {k}), upper {got0[2]!r}")
        print(f"13 {name}: " + ", ".join(
            f"{turn} {[round(t, 4) for t in res[turn]]} s"
            for turn in ("eager", "inner", "plain-fw", "graph", "plain-cg"))
            + f"; mean graph / plain-fw "
            f"{sum(res['graph']) / sum(res['plain-fw']):.3f}, graph / inner "
            f"{sum(res['graph']) / sum(res['inner']):.3f}, graph / eager "
            f"{sum(res['graph']) / sum(res['eager']):.3f}; launches a solve "
            f"{launches}; graphs on this operator since its first solve: "
            f"{res['stats']} ({card})", flush=True)
        res["profile"] = {}
        for turn in PROFILE_TURNS:
            walls = []

            def timed():
                t0 = time.perf_counter()
                solve()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)

            host = {}
            with turn_ctx(turn):
                reads0 = graphs.host_reads
                busy, kernels_n, top = profiled_busy(timed, host)
                reads = graphs.host_reads - reads0
            calls = sum(host.values())
            with turn_ctx(turn):
                per_step = (step_kernels(op) if turn in ("graph", "plain-cg")
                            else (None, None))
            res["profile"][turn] = (walls[0], busy, kernels_n, calls,
                                    per_step[0], per_step[1], reads)
            print(f"13 {name} {turn}, one profiled warm solve: wall "
                  f"{walls[0]:.4f} s, device busy {busy:.3f} ms over "
                  f"{kernels_n} kernels and copies, idle share "
                  f"{1 - busy / 1e3 / walls[0]:.3f}; launch calls on the "
                  f"host {calls} {host}; host reads {reads}; one CG step (6 "
                  f"less 5 replayed) {per_step[0]} kernels, {per_step[1]} "
                  f"ms; largest "
                  f"{[(round(ms, 3), c, nm) for ms, c, nm in top]} ({card})",
                  flush=True)
            cap = HOST_LAUNCH_CAPS.get(name)
            if turn == "graph" and cap is not None and calls > cap:
                fail(f"13 {name}: {calls} launch calls on the host in a "
                     f"replayed warm solve, more than {cap}")
        forced_guard(card, name, op, solve)
        device_loop_guard(card, name, mac, solve, first[0], f64)
    return out


def device_loop_guard(card, name, mac, solve, want, f64):
    """The case's warm solve through the device loop with the guard of
    every step's set-up forced (on fresh routes of the operator, whose
    set-up graphs are captured with a flag "forced" raised; the routes
    are put back after): each step's set-up is run again eagerly from the
    copy of the carried state it saved (ops.graphs._solve_static), so the
    solve is bitwise `want` (the first turn's; same_solve) with one redo
    a step."""
    import torch

    from mac_tpu_torch.ops import graphs

    op = route_op(mac)
    saved, real_cached = dict(op.graph_routes), graphs._cached

    def forced_cached(op_, key, make):
        def make_forced():
            route = make()
            prepare = route.prepare

            def forced(s, branch, guards):
                out = prepare(s, branch, guards)
                if guards is not None:
                    guards["forced"] = torch.ones((), dtype=torch.bool,
                                                  device=s["w"].device)
                return out

            route.prepare = forced
            return route

        return real_cached(op_, key, make_forced)

    op.graph_routes.clear()
    graphs._cached = forced_cached
    try:
        got = solve()
        torch.cuda.synchronize()
        steps = mac.last_solve_stats["fw_iterations"]
        redos = sum(r.redos for r in op.graph_routes.values())
    finally:
        graphs._cached = real_cached
        op.graph_routes.clear()
        op.graph_routes.update(saved)
    same = same_solve(got, want, f64)
    print(f"13 {name} device loop with every set-up's guard forced: redos "
          f"{redos} over {steps} FW steps, result "
          f"{'bitwise' if same else 'NOT bitwise'} the first turn's "
          f"({card})", flush=True)
    if redos != steps or not same:
        fail(f"13 {name}: the device loop's forced guards gave redos "
             f"{redos} over {steps} steps, bitwise {same}")


# Phase 13: the forced early stops' gap tolerances, tried in order until the
# host loop stops before max_iters.
FORCED_STOP_TOLS = (1e-2, 3e-2, 1e-1, 3e-1, 1.0)


def forced_stops(card, cases, counted, fw_kerns):
    """Phase 13: a Frank-Wolfe loop whose gap stop fires, on each route:
    `cases` maps a name to (MAC, K, x_init, max_iters). The tolerance is
    the first of FORCED_STOP_TOLS at which the host loop (PlainFW) stops
    before max_iters. Then one device-loop solve (it captures what it
    needs) and the turns plain-fw, device, device, plain-fw: the same step
    count, below max_iters, and Fiedler iterations, x and the rounded
    selection bitwise, the upper bound by same_solve; the device loop
    discards exactly one set-up (the step after the stop, its flag read
    with that set-up's) and launches K9 and K10 once a step, the host loop
    neither; and every wrapper's launches by dtype equal to the host
    loop's once the discarded set-up's launches are taken off (a set-up's
    K2 or K3 and K4 ran once more). Returns {name: (tolerance, steps)}."""
    from contextlib import nullcontext

    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels.tridiag import reset_counts

    out = {}
    for name, (mac, k, x, maxiter) in cases.items():
        op = route_op(mac)
        f64 = str(mac.dtype).endswith("float64")

        def solve(tol):
            return mac.solve(k, x, max_iters=maxiter,
                             relative_duality_gap_tol=tol, use_cache=True)

        tol = None
        for cand in FORCED_STOP_TOLS:
            with PlainFW():
                solve(cand)
            if mac.last_solve_stats["fw_iterations"] < maxiter:
                tol = cand
                break
        if tol is None:
            fail(f"13 {name}: no gap tolerance of {FORCED_STOP_TOLS} stops "
                 f"the loop before {maxiter} steps")
        solve(tol)
        turns = []
        for turn in ("plain-fw", "device", "device", "plain-fw"):
            reset_counts(*counted, *fw_kerns)
            s0, marks = graph_stats(op), discard_marks(op)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with PlainFW() if turn == "plain-fw" else nullcontext():
                got = solve(tol)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = dict(mac.last_solve_stats)
            s1 = graph_stats(op)
            disc = discarded_by_dtype(op, marks)
            turns.append(dict(
                turn=turn, got=got, wall=wall,
                iters=(stats["fw_iterations"], stats["fiedler_iterations"]),
                captures=s1["captures"] - s0["captures"],
                discards=s1["discards"] - s0["discards"], disc=disc,
                launches=less(by_dtype(counted), disc),
                fw=[kern.launches for kern in fw_kerns]))
        ref = turns[0]
        bad = []
        for tr in turns:
            device = tr["turn"] == "device"
            if not (same_solve(tr["got"], ref["got"], f64 and device)
                    and tr["iters"] == ref["iters"]):
                bad.append(f"{tr['turn']} not bitwise")
            if tr["discards"] != (1 if device else 0) or tr["captures"]:
                bad.append(f"{tr['turn']} discards {tr['discards']}, "
                           f"captures {tr['captures']}")
            if tr["fw"] != ([ref["iters"][0]] * 2 if device else [0, 0]):
                bad.append(f"{tr['turn']} K9, K10 {tr['fw']}")
            if tr["launches"] != ref["launches"]:
                bad.append(f"{tr['turn']} launches {tr['launches']} against "
                           f"{ref['launches']}")
            if device and not tr["disc"].get("sym_eig"):
                bad.append(f"the discarded set-up launched no K4: "
                           f"{tr['disc']}")
        steps = ref["iters"][0]
        if steps >= maxiter:
            bad.append(f"no stop: {steps} steps")
        print(f"13 forced stop {name} (max_iters {maxiter}, gap tolerance "
              f"{tol}): {steps} FW steps, Fiedler iterations "
              f"{ref['iters'][1]} in every turn; walls "
              f"{[(tr['turn'], round(tr['wall'], 4)) for tr in turns]} s; "
              f"the device loop's discarded set-up launched "
              f"{turns[1]['disc']}; upper {turns[1]['got'][2]!r} against "
              f"the host loop's {ref['got'][2]!r}; max |x - x_host| "
              f"{np.abs(turns[1]['got'][1] - ref['got'][1]).max():.3e} "
              f"({card})", flush=True)
        if bad:
            fail(f"13 forced stop {name}: {bad}")
        out[name] = (tol, steps)
    return out


def forced_guard(card, name, op, solve):
    """One Frank-Wolfe step of the case's warm solve run again with its
    guard forced: on the banded route the step's carried coarse inverse
    made NaN (a Newton-Schulz refresh from a non-finite carry, which the
    eager code rebuilds by Cholesky); on the ELL route, which carries no
    state, the coarse level's singular flag raised, on a copy of the
    operator whose set-up graph is captured with it. The replayed solve
    must run the set-up again eagerly once and give bitwise what the eager
    solve (graphs.plain_solve) gives."""
    import torch

    from mac_tpu_torch.ops import graphs

    calls, real = [], graphs.graphed_solve

    def record(route, w, X, **kw):
        calls.append((route, w.clone(), X.clone(), dict(kw)))
        return real(route, w, X, **kw)

    graphs.graphed_solve = record
    try:
        with PlainFW():  # the device loop solves through StepSolves
            solve()
    finally:
        graphs.graphed_solve = real
    banded = "ut" in calls[0][0].names
    if banded:
        route, w, X, kw = next(c for c in reversed(calls)
                               if c[3].get("branch") == "ns")
        kw["carried"] = dict(kw["carried"], Lc_inv=torch.full_like(
            kw["carried"]["Lc_inv"], float("nan")))
        how = "carried coarse inverse made NaN"
    else:
        route, w, X, kw = calls[-1]
        fresh = op.to(op.device)  # the route holds it weakly: keep it
        route = graphs.twogrid_route(fresh)
        how = "coarse level's singular flag raised"
    level = graphs._twogrid.twogrid_level

    def forced_level(op_, w_, sharded=None, guards=None):
        out = level(op_, w_, sharded, guards)
        if guards is not None:
            guards["coarse_singular"] = torch.ones_like(
                guards["coarse_singular"])
        return out

    if not banded:
        graphs._twogrid.twogrid_level = forced_level
    try:
        r0 = route.redos
        got, _ = real(route, w, X, **kw)
        redos = route.redos - r0
    finally:
        graphs._twogrid.twogrid_level = level
    ref, _ = graphs.plain_solve(route, w, X, **kw)
    torch.cuda.synchronize()
    same = (got.iters == ref.iters and torch.equal(got.X, ref.X)
            and torch.equal(got.lam, ref.lam))
    branch = kw.get("branch", "cold")
    print(f"13 {name} forced guard ({how}, branch {branch}): "
          f"redos {redos}, {got.iters} outer iterations, result "
          f"{'bitwise' if same else 'NOT bitwise'} the eager solve's "
          f"({card})", flush=True)
    if redos != 1 or not same or not bool(torch.isfinite(got.X).all()):
        fail(f"13 {name}: a forced guard gave redos {redos}, bitwise "
             f"{same}")


# Phase 12: make_banded_precond's (smoother, kind) pairs; PCG's relative
# residual per column and its step cap; the float64 symmetry gate (the JAX
# package's test's); the eigensolvers' lambda_2 against the scipy referee.
PRECOND_VARIANTS = (("chain", "mult"), ("chain", "additive"),
                    ("bjacobi", "mult"), ("bjacobi", "additive"))
PCG_TOL = 1e-5
PCG_MAXITER = 1000
SYM_TOL = 1e-8
LAM2_RTOL = 1e-3


def api_phase(dev, card, graphs, city_L, dataset, counted):
    """Phase 12, the reference's API on the card. graphs: {name: (banded
    tables on the card, float32 edge weights at the start x)} of phase 3
    (city10000, sphere2500); city_L: city10000's Laplacian at those
    weights (scipy CSR, for the referee); counted: the kernel wrappers.
    Every check that fails exits; no plain version may see a CUDA
    tensor."""
    import os

    import numpy as np
    import torch

    from mac_tpu_torch import native
    from mac_tpu_torch.ops import banded
    from mac_tpu_torch.ops.cg import pcg
    from mac_tpu_torch.ops.kernels.tridiag import reset_counts
    from mac_tpu_torch.ops.lobpcg import tracemin_fiedler
    from mac_tpu_torch.slam.pose_graph import read_g2o_file
    from mac_tpu_torch.utils.fiedler import (default_block, fiedler_pair_op,
                                             scipy_lam2)

    with PlainOnCard() as plain:
        for gname, (bop, w) in graphs.items():
            n = bop.n
            rng = np.random.RandomState(12)
            B4 = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32,
                                 device=dev)
            Bc = B4 - B4.mean(dim=0, keepdim=True)
            BD = banded.assemble_bd(bop, w)
            w64 = w.double()
            BD64 = banded.assemble_bd(bop, w64)
            X0 = torch.as_tensor(default_block(n, 4), dtype=torch.float32,
                                 device=dev)
            lnorm = 2.0 * BD.deg.amax()

            def apply_L(V):
                return banded.banded_apply(bop, BD, V)

            for smoother, kind in PRECOND_VARIANTS:
                label = f"{gname} {smoother}/{kind}"
                chain = smoother == "chain"

                def build(BD=BD, w=w):
                    return banded.make_banded_precond(
                        bop, BD, w=w if chain else None, smoother=smoother,
                        kind=kind)

                reset_counts(*counted)
                M = build()
                Y = M(B4)
                torch.cuda.synchronize()
                got = {kern.__name__: kern.launches for kern in counted}
                k1 = k1_body(got) + got["tridiag_solve_blocked"]
                k3 = got["tridiag_ldl"] + got["tridiag_ldl_blocked"]
                if not bool(torch.isfinite(Y).all()):
                    fail(f"{label}: non-finite M(B)")
                if (k1 > 0, k3 > 0) != (chain, chain):
                    fail(f"{label}: K1 {k1} and K3/K3b {k3} launches in one "
                         f"build and application; the chain smoother must "
                         f"launch both, block-Jacobi neither")
                build_ms = call_ms(build)
                # An application launches tens of kernels: six of them stay
                # inside the device's queue of pending launches (about a
                # thousand), which device_ms's spin needs.
                apply_ms = device_ms(lambda: M(B4), reps=6)
                res = pcg(apply_L, Bc, M, tol=PCG_TOL, maxiter=PCG_MAXITER)
                if not (res.iters < PCG_MAXITER
                        and bool(torch.isfinite(res.X).all())):
                    fail(f"{label}: PCG did not reach {PCG_TOL} in "
                         f"{PCG_MAXITER} steps")
                eig = tracemin_fiedler(apply_L, X0, lnorm, M)
                lam = float(eig.lam[0])
                M64 = build(BD64, w64)

                def dot(a, b):
                    return float((a * b).sum())

                x, y = (torch.as_tensor(rng.normal(size=(n, 1)), device=dev)
                        for _ in range(2))
                ip1, ip2 = dot(M64(x), y), dot(x, M64(y))
                sym = abs(ip1 - ip2) / max(abs(ip1), 1.0)
                pos = min(dot(z, M64(z)) for z in (
                    torch.as_tensor(rng.normal(size=(n, 1)), device=dev)
                    for _ in range(4)))
                print(f"{label}: build {build_ms:.4f} ms (call), one "
                      f"application {apply_ms:.5f} ms (device) at q 4; PCG "
                      f"{res.iters} steps to {PCG_TOL:g} (float32); K1 {k1}, "
                      f"K3/K3b {k3} launches a build and application; "
                      f"TRACEMIN from the default block {eig.iters} outer "
                      f"iterations, lambda_2 {lam:.9g}; float64 symmetry "
                      f"{sym:.3e}, least <z, M z> {pos:.3e} ({card})",
                      flush=True)
                if not sym <= SYM_TOL:
                    fail(f"{label}: float64 M not symmetric ({sym:.3e})")
                if not pos > 0:
                    fail(f"{label}: float64 M not positive ({pos:.3e})")
                if not np.isfinite(lam):
                    fail(f"{label}: TRACEMIN lambda_2 {lam}")

        # The eigensolvers in the reference's call form (no xprev0) on
        # city10000 at its start weights, against the scipy referee.
        bop, w = graphs["city10000"]
        BD = banded.assemble_bd(bop, w)
        X0 = torch.as_tensor(default_block(bop.n, 4), dtype=torch.float32,
                             device=dev)
        ref = scipy_lam2(city_L)
        pair = fiedler_pair_op(bop, w, X0)
        direct = tracemin_fiedler(
            lambda V: banded.banded_apply(bop, BD, V), X0,
            2.0 * BD.deg.amax(), banded.make_banded_precond(bop, BD, w=w),
            stall_patience=5, stall_factor=0.99)
        for label, out in (("fiedler_pair_op", pair),
                           ("tracemin_fiedler", direct)):
            lam = float(out.lam[0])
            gap = (lam - ref) / ref
            print(f"city10000 at its start weights, {label} without xprev0: "
                  f"lambda_2 {lam:.9g} in {out.iters} outer iterations, "
                  f"referee {ref:.9g}, relative {gap:+.3e}", flush=True)
            if not abs(gap) <= LAM2_RTOL:
                fail(f"{label}: lambda_2 {lam} off the referee {ref} by "
                     f"{gap:+.3e}")

        # The g2o reader through the native parser and with the opt-out.
        path = str(dataset.parent / "intel.g2o")
        if not native.build():
            fail("the native library did not build")
        native._lib, native._tried = None, False
        meas_n, n_n = read_g2o_file(path)
        os.environ["MAC_TPU_NO_NATIVE"] = "1"
        native._lib, native._tried = None, False
        try:
            if native.lib() is not None:
                fail("MAC_TPU_NO_NATIVE=1 did not turn the native library "
                     "off")
            meas_p, n_p = read_g2o_file(path)
        finally:
            del os.environ["MAC_TPU_NO_NATIVE"]
            native._lib, native._tried = None, False
        same = n_n == n_p and len(meas_n) == len(meas_p) and all(
            (a.i, a.j) == (b.i, b.j) and np.array_equal(a.t, b.t)
            and np.array_equal(a.R, b.R) and a.kappa == b.kappa
            and a.tau == b.tau for a, b in zip(meas_n, meas_p))
        print(f"intel.g2o: {len(meas_n)} measurements through the native "
              f"parser, {len(meas_p)} with MAC_TPU_NO_NATIVE=1; equal "
              f"{same}", flush=True)
        if not same:
            fail("the native and the Python g2o reader disagree on intel")
    if plain.calls:
        fail(f"phase 12 ran plain versions on the card: {plain.calls}")


def main():
    import numpy as np
    import torch

    phase = Phase()
    # ---- 1. the card
    phase("1 card")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    card = card_line()
    print(card, flush=True)
    try:
        import mac_tpu_torch  # noqa: F401 (sets the numerics policy)
    except ImportError as exc:
        fail(f"the mac_tpu_torch package is not importable here: {exc}")
    from concurrent.futures import ThreadPoolExecutor

    from mac_tpu_torch.ops import banded, laplacian
    from mac_tpu_torch.ops.kernels import _build, ldl, syev
    from mac_tpu_torch.ops.kernels.assemble import assemble_ut, assemble_ut_plain
    from mac_tpu_torch.ops.kernels import banded as kbanded
    from mac_tpu_torch.ops.kernels import ell as kell
    from mac_tpu_torch.ops.kernels import pcg as kpcg
    from mac_tpu_torch.ops.kernels import fw as kfw
    from mac_tpu_torch.ops.kernels.tridiag import (
        reset_counts, tridiag_solve, tridiag_solve_blocked,
        tridiag_solve_blocked_plain, tridiag_solve_permuted,
        tridiag_solve_plain)
    from mac_tpu_torch.ops.tridiag import (tridiag_ldl, tridiag_ldl_auto,
                                           tridiag_ldl_blocked)
    from mac_tpu_torch.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges
    from mac_tpu_torch.solvers import MAC, NaiveGreedy
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on; the port's numerics policy wants full float32")

    # ---- 2. build the kernels, one nvcc per source, in parallel
    phase("2 build")
    t0 = time.perf_counter()
    sources = ("tridiag", "assemble", "ldl", "syev", "banded", "pcg", "ell",
               "fw")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for src, secs, log in _build.build_log:
        print(f"  nvcc {src}.cu {secs:.2f} s: "
              + " | ".join(ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "smem" in ln), flush=True)
    # K4 keeps each matrix in registers: its instantiations' frames, from
    # the report kept beside the library (this build's or an earlier one's).
    k4_regs = k4_frame_gate(_build.ptxas_log("syev"))
    print("K4 instantiations (registers, stack frame bytes, spill stores, "
          "spill loads): " + ", ".join(
              f"{dt_} m {m_}: {v_}" for (dt_, m_), v_ in sorted(
                  k4_regs.items())), flush=True)
    # K4w keeps A and V in shared memory: no spill in that form.
    k4w_regs = k4w_frame_gate(_build.ptxas_log("syev"))
    print("K4w instantiations (registers, stack frame bytes, spill stores, "
          "spill loads): " + ", ".join(
              f"{dt_} {form_}: {v_}" for (dt_, form_), v_ in sorted(
                  k4w_regs.items())), flush=True)
    # K3 (up to 4096 rows) and K3b keep rows in registers: the same gate.
    ldl_regs = ldl_frame_gate(_build.ptxas_log("ldl"))
    print("ldl.cu kernels (registers, stack frame bytes, spill stores, "
          "spill loads): " + ", ".join(
              f"{k_} {dt_}" + (f" rows {r_}" if r_ is not None else "")
              + f": {v_}" for (k_, dt_, r_), v_ in sorted(
                  ldl_regs.items(), key=str)), flush=True)

    # ---- 3. kernels against their plain versions on the card
    phase("3 K1, K2 against their plain versions")
    (dataset, n, fixed, cands, k, _, bop, w, dp32, l32,
     B) = dataset_inputs(dev)
    print(f"city10000: n {n}, {len(fixed)} fixed, {len(cands)} candidates, "
          f"K {k}; nb {bop.nb} half {bop.half} du {bop.ueid_tbl.shape[0]} "
          f"du_dense {bop.du_dense} ov_rows {bop.ov_rows} coarse "
          f"{bop.coarse_nc} x {bop.coarse_s}", flush=True)

    def k1_check(dp, l, B, label):
        got = tridiag_solve(dp, l, B)
        ref = tridiag_solve_plain(dp, l, B)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, rtol=K1_TOL, atol=K1_TOL)
        print(f"K1 tridiag_solve {label}: max|kernel - plain| {err:.3e} "
              f"(max|X| {float(ref.abs().max()):.3e}) -> "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"tridiag_solve kernel disagrees with its plain version on "
                 f"{label}")
        return err

    k1_err = k1_check(dp32, l32, B, "city10000 chain factor (n 10000, q 4)")
    rng = np.random.RandomState(1)
    n_ex = 4000
    e = -(0.5 + rng.rand(n_ex - 1))
    d = 0.1 + rng.rand(n_ex) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    f_ex = tridiag_ldl(torch.as_tensor(d, dtype=torch.float32, device=dev),
                       torch.as_tensor(e, dtype=torch.float32, device=dev))
    B_ex = torch.as_tensor(rng.normal(size=(n_ex, 4)), dtype=torch.float32,
                           device=dev)
    k1_err = max(k1_err, k1_check(f_ex.dp, f_ex.l, B_ex,
                                  "exact factor (n 4000, q 4)"))
    # sphere2500 (phase 6): the exact chain factor of a real solve, and
    # banded tables without a split.
    (_, n_sp, fixed_sp, cands_sp, _, _, bop_sp, w_sp, dp_sp, l_sp,
     B_sp) = dataset_inputs(dev, "sphere2500")
    if bop_sp.ov_rows != 0:
        fail("sphere2500's banded tables picked a split")
    k1_err = max(k1_err, k1_check(
        dp_sp, l_sp, B_sp, f"sphere2500 exact chain factor (n {n_sp}, q 4)"))
    # An exact factor too large for the cluster's shared memory (the kernel's
    # tiled two-pass branch) and wider than one pass of columns.
    n_big = 33000
    e = -(0.5 + rng.rand(n_big - 1))
    d = (0.1 + rng.rand(n_big) - np.concatenate([[0], e])
         - np.concatenate([e, [0]]))
    f_big = tridiag_ldl(torch.as_tensor(d, dtype=torch.float32, device=dev),
                        torch.as_tensor(e, dtype=torch.float32, device=dev))
    B_big = torch.as_tensor(rng.normal(size=(n_big, 40)), dtype=torch.float32,
                            device=dev)
    k1_err = max(k1_err, k1_check(f_big.dp, f_big.l, B_big,
                                  "exact factor (n 33000, q 40)"))
    # Wider than one launch's 128 columns: two launches, each on a column
    # group of B and X at row stride 200.
    B_wide = torch.as_tensor(rng.normal(size=(5000, 200)), dtype=torch.float32,
                             device=dev)
    k1_err = max(k1_err, k1_check(f_big.dp[:5000].contiguous(),
                                  f_big.l[:5000].contiguous(), B_wide,
                                  "exact factor (n 5000, q 200)"))
    k1_dev = device_ms(lambda: tridiag_solve(dp32, l32, B))
    k1_call = call_ms(lambda: tridiag_solve(dp32, l32, B))
    k1_plain_ms = call_ms(lambda: tridiag_solve_plain(dp32, l32, B))
    k1_bound, k1_by = tridiag_bound(n, 4)
    print(f"K1 time at (10000, 4): kernel device {k1_dev:.5f} ms, call "
          f"{k1_call:.4f} ms, plain call {k1_plain_ms:.4f} ms, bound "
          f"{k1_bound:.5f} ms ({k1_by}) ({card})", flush=True)
    k1_sp_dev = device_ms(lambda: tridiag_solve(dp_sp, l_sp, B_sp))
    k1_sp_plain = call_ms(lambda: tridiag_solve_plain(dp_sp, l_sp, B_sp))
    print(f"K1 time at sphere2500's exact factor ({n_sp}, 4): kernel device "
          f"{k1_sp_dev:.5f} ms, plain call {k1_sp_plain:.4f} ms, bound "
          f"{tridiag_bound(n_sp, 4)[0]:.5f} ms ({card})", flush=True)

    idx_s, w_s, n_s = pose_graph(700, 120, 40, 3)
    bop_s, _ = banded.build_banded_rcm(idx_s, n_s)
    bop_s = bop_s.to(dev)
    if bop_s.ov_rows != 0:
        fail("the no-split assembly case picked a split")
    # A wide band (half 4, split) whose slot rows hold duplicate edges.
    idx_w, w_w, n_w = wide_graph(2000, 3000, 450, 5, dup=200)
    bop_w = banded.build_banded(idx_w, n_w).to(dev)
    if bop_w.half < 3:
        fail(f"the wide assembly case has half {bop_w.half}, want >= 3")
    k2_err = {}
    for key, label, b_, w_ in (
            ("K2b", "city10000 (split: du_dense 5, ov 5)", bop, w),
            ("K2", f"sphere2500 (no split: nb {bop_sp.nb}, half "
             f"{bop_sp.half}, du_dense {bop_sp.du_dense})", bop_sp, w_sp),
            ("K2s", "n 700 graph without a split", bop_s,
             torch.as_tensor(w_s, dtype=torch.float32, device=dev)),
            ("K2w", f"n 2000 graph, half {bop_w.half}, du_dense "
             f"{bop_w.du_dense}, ov {bop_w.ov_rows}, duplicate edges", bop_w,
             torch.as_tensor(w_w, dtype=torch.float32, device=dev))):
        args = k2_args(b_, w_)
        got = assemble_ut(*args)
        ref = assemble_ut_plain(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        k2_err[key] = err
        same = torch.equal(got, ref)
        print(f"K2 assemble_ut {label}: shape {tuple(got.shape)}, max|kernel "
              f"- plain| {err:.3e} -> {'bitwise equal' if same else 'MISMATCH'}",
              flush=True)
        if not same:
            fail(f"assemble_ut kernel differs from its plain version on {label}")

    k2_tm = k2_times(k2_args(bop_sp, w_sp),
                     "K2 time at sphere2500 (no split)", card)
    k2b_tm = k2_times(k2_args(bop, w), "K2b time at city10000", card)

    # The lane forms of the budget sweep (phase 8): K1 on city10000's chain
    # factors of its 8 budget lanes (a factor per lane), K2b on its tables
    # at those 8 lanes, K2 on sphere2500's tables at 2 lanes.
    ks8 = [int(f * len(cands)) for f in np.linspace(0.1, 0.5, 8)]
    w8, x8 = lane_weights(fixed, cands, ks8, dev)
    fac8 = banded.chain_factor(bop, banded.assemble_bd(bop, w8), w8)
    dp8, l8 = fac8.dp.float().contiguous(), fac8.l.float().contiguous()
    B8 = torch.randn((8, n, 4),
                     generator=torch.Generator().manual_seed(8)).to(dev)
    k1_lanes = {"max_abs_err": k1_check(
        dp8, l8, B8, f"city10000's 8 budget lanes (8, {n}, 4), a chain "
        "factor per lane")}
    k1_lanes["device_ms"] = device_ms(lambda: tridiag_solve(dp8, l8, B8))
    k1_lanes["call_ms"] = call_ms(lambda: tridiag_solve(dp8, l8, B8))
    k1_lanes["plain_ms"] = call_ms(lambda: tridiag_solve_plain(dp8, l8, B8))
    k1_lanes["bound_ms"], k1_lanes["bound_by"] = tridiag_bound(
        n, 4, lanes=8, shared=False)
    print(f"K1 time at 8 lanes (8, {n}, 4): kernel device "
          f"{k1_lanes['device_ms']:.5f} ms (8 single launches "
          f"{8 * k1_dev:.5f} ms), call {k1_lanes['call_ms']:.4f} ms, plain "
          f"call {k1_lanes['plain_ms']:.4f} ms, bound "
          f"{k1_lanes['bound_ms']:.5f} ms ({k1_lanes['bound_by']}) ({card})",
          flush=True)
    ks_sp = [len(cands_sp) // 4, len(cands_sp) // 2]
    w_sp2, _ = lane_weights(fixed_sp, cands_sp, ks_sp, dev)
    lane_args = {"K2b_lanes": k2_args(bop, w8),
                 "K2_lanes": k2_args(bop_sp, w_sp2)}
    for key, label in (("K2b_lanes", "city10000 tables, 8 lanes"),
                       ("K2_lanes", "sphere2500 tables, 2 lanes")):
        got = assemble_ut(*lane_args[key])
        ref = assemble_ut_plain(*lane_args[key])
        torch.cuda.synchronize()
        k2_err[key] = float((got - ref).abs().max())
        same = torch.equal(got, ref)
        print(f"K2 assemble_ut {label}: shape {tuple(got.shape)}, "
              f"max|kernel - plain| {k2_err[key]:.3e} -> "
              f"{'bitwise equal' if same else 'MISMATCH'}", flush=True)
        if not same:
            fail(f"assemble_ut kernel differs from its plain version on "
                 f"{label}")
    k2b8_tm = k2_times(lane_args["K2b_lanes"],
                       "K2b time at city10000, 8 lanes", card)
    k2sp2_tm = k2_times(lane_args["K2_lanes"],
                        "K2 time at sphere2500, 2 lanes", card)

    # ---- 3c. K1b against its plain version on the card
    phase("3c K1b against its plain version")
    fi5, wf5, ci5, wc5 = synthetic(SCALE_N, seed=0, local=False)
    k5 = len(wc5) // 4
    x5 = np.zeros(len(wc5))
    x5[np.argpartition(wc5, -k5)[-k5:]] = 1.0
    op5 = laplacian.build_operator(np.concatenate([fi5, ci5]), SCALE_N).to(dev)
    w5 = torch.as_tensor(np.concatenate([wf5, x5 * wc5]), dtype=torch.float32,
                         device=dev)
    d5, e5 = laplacian.lap_tridiagonal_part(op5, w5)
    d5 = d5 + 100 * torch.finfo(torch.float32).eps * d5.max()
    f5 = tridiag_ldl_auto(d5, e5)
    if f5.seg != 1024:
        fail(f"the n = {SCALE_N} chain factor has seg {f5.seg}, want 1024")
    k1b_err = 0.0

    def k1b_check(f, q, label, seed, block=1024, misaligned=False):
        nonlocal k1b_err
        dp, l = f.dp.float().contiguous(), f.l.float().contiguous()
        Bq = torch.randn((*dp.shape, q),  # (lanes,) n, q
                         generator=torch.Generator().manual_seed(seed)).to(dev)
        if misaligned:  # the same block, 4 bytes off a 16-byte boundary
            flat = torch.empty(Bq.numel() + 1, dtype=Bq.dtype, device=dev)
            flat[1:] = Bq.reshape(-1)
            Bq = flat[1:].view(Bq.shape)
            if Bq.data_ptr() % 16 == 0 or not Bq.is_contiguous():
                fail("the misaligned right-hand side is aligned")
        got = tridiag_solve_blocked(dp, l, Bq, block=block)
        ref = tridiag_solve_blocked_plain(dp, l, Bq, block=block)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        k1b_err = max(k1b_err, err)
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, rtol=K1_TOL, atol=K1_TOL)
        print(f"K1b tridiag_solve_blocked {label}: max|kernel - plain| "
              f"{err:.3e} (max|X| {float(ref.abs().max()):.3e}) -> "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"tridiag_solve_blocked kernel disagrees with its plain "
                 f"version on {label}")
        return dp, l, Bq, err

    dp5, l5, B5, _ = k1b_check(f5, 4, f"two-grid chain factor (n "
                               f"{SCALE_N}, q 4, seg 1024)", 0)
    rng = np.random.RandomState(2)
    n_b = 40000  # 39 segments of 1024 and a ragged one of 64 rows
    e_b = -(0.5 + rng.rand(n_b - 1))
    d_b = (0.1 + rng.rand(n_b) - np.concatenate([[0], e_b])
           - np.concatenate([e_b, [0]]))
    d_b = torch.as_tensor(d_b, dtype=torch.float32, device=dev)
    e_b = torch.as_tensor(e_b, dtype=torch.float32, device=dev)
    f_blk = tridiag_ldl_blocked(d_b, e_b, block=1024)
    k1b_check(f_blk, 8, "blocked factor (n 40000, q 8, seg 1024)", 1)
    k1b_check(f_blk, 32, "blocked factor (n 40000, q 32, seg 1024)", 2)
    k1b_check(tridiag_ldl_blocked(d_b, e_b, block=128), 4,
              "banded-style factor (n 40000, q 4, seg 128)", 3)
    f_exact = tridiag_ldl(d_b, e_b)
    if not bool((f_exact.l[1024::1024] != 0).all()):
        fail("the exact factor has zero couplings at the 1024 boundaries")
    k1b_check(f_exact, 4, "exact factor, couplings forced to 0 at the 1024 "
              "boundaries (n 40000, q 4)", 4)
    # The kernel's other branches: scalar loads (q % 4 != 0, or a block off
    # a 16-byte boundary), several column groups (q 40, 130), segment
    # lengths passed explicitly, ragged and single-row last segments.
    for q_ in (1, 3, 5, 40, 130):
        k1b_check(f_blk, q_, f"blocked factor (n 40000, q {q_}, seg 1024)",
                  5 + q_)
    k1b_check(tridiag_ldl_blocked(d_b, e_b, block=128), 4,
              "seg-128 factor in segments of 128 (n 40000, q 4)", 6, block=128)
    k1b_check(f_exact, 5, "exact factor in segments of 256 (n 40000, q 5)", 7,
              block=256)
    k1b_check(tridiag_ldl_blocked(d_b[:1], e_b[:0], block=1024), 4,
              "one row (n 1, q 4)", 8)
    k1b_check(tridiag_ldl_blocked(d_b[:1025], e_b[:1024], block=1024), 4,
              "a last segment of one row (n 1025, q 4)", 9)
    k1b_check(f5, 4, f"two-grid chain factor, B 4 bytes off a 16-byte "
              f"boundary (n {SCALE_N}, q 4)", 10, misaligned=True)
    # K1b with lanes: the V-cycle chain factors of phase 8b's two budget
    # lanes (x_init the top-k candidates by weight), a factor per lane.
    ks5 = [6250, 12500]
    x5_lanes = np.zeros((2, len(wc5)))
    for r, k_ in enumerate(ks5):
        x5_lanes[r, np.argpartition(wc5, -k_)[-k_:]] = 1.0
    W5 = torch.as_tensor(np.concatenate(
        [np.broadcast_to(wf5, (2, len(wf5))), x5_lanes * wc5], axis=1),
        dtype=torch.float32, device=dev)
    d52, e52 = laplacian.lap_tridiagonal_part(op5, W5)
    f52 = tridiag_ldl_auto(
        d52 + 100 * torch.finfo(torch.float32).eps
        * d52.amax(dim=-1, keepdim=True), e52)
    dp52, l52, B52, err52 = k1b_check(
        f52, 4, f"phase 8b's 2 budget lanes (2, {SCALE_N}, 4), a chain "
        "factor per lane", 12)
    k1b_lanes = {"max_abs_err": err52}
    k1b_lanes["device_ms"] = device_ms(
        lambda: tridiag_solve_blocked(dp52, l52, B52))
    k1b_lanes["call_ms"] = call_ms(
        lambda: tridiag_solve_blocked(dp52, l52, B52))
    k1b_lanes["plain_ms"] = call_ms(
        lambda: tridiag_solve_blocked_plain(dp52, l52, B52))
    k1b_lanes["bound_ms"], k1b_lanes["bound_by"] = tridiag_bound(
        SCALE_N, 4, lanes=2, shared=False)
    k1b_dev = device_ms(lambda: tridiag_solve_blocked(dp5, l5, B5))
    k1b_call = call_ms(lambda: tridiag_solve_blocked(dp5, l5, B5))
    k1b_plain_ms = call_ms(lambda: tridiag_solve_blocked_plain(dp5, l5, B5))
    k1b_bound, k1b_by = tridiag_bound(SCALE_N, 4)
    print(f"K1b time at ({SCALE_N}, 4): kernel device {k1b_dev:.5f} ms, call "
          f"{k1b_call:.4f} ms, plain call {k1b_plain_ms:.4f} ms, bound "
          f"{k1b_bound:.5f} ms ({k1b_by}) ({card})", flush=True)
    print(f"K1b time at 2 lanes (2, {SCALE_N}, 4): kernel device "
          f"{k1b_lanes['device_ms']:.5f} ms (2 single launches "
          f"{2 * k1b_dev:.5f} ms), call {k1b_lanes['call_ms']:.4f} ms, "
          f"plain call {k1b_lanes['plain_ms']:.4f} ms, bound "
          f"{k1b_lanes['bound_ms']:.5f} ms ({k1b_lanes['bound_by']}) "
          f"({card})", flush=True)
    # The ELL product of phase 5, against the same product gathering whole
    # (n, q) rows (V[nbr]), which PyTorch runs one thread block per row.
    apply5 = laplacian.lap_applier(op5, w5)
    w_tbl5 = torch.cat([w5, w5.new_zeros(1)])[op5.eid_tbl]

    def rows_apply(V):
        return (w_tbl5[:, :, None] * (V[:, None, :] - V[op5.nbr_tbl])).sum(1)

    ell_out, rows_out = apply5(B5), rows_apply(B5)
    ell_err = float((ell_out - rows_out).abs().max())
    if not torch.allclose(ell_out, rows_out, rtol=1e-5,
                          atol=1e-5 * float(rows_out.abs().max())):
        fail(f"the ELL product disagrees with its row-gather form: {ell_err}")
    print(f"ELL product at ({SCALE_N}, width {op5.nbr_tbl.shape[1]}, q 4): "
          f"port {call_ms(lambda: apply5(B5)):.4f} ms, row-gather form "
          f"{call_ms(lambda: rows_apply(B5)):.4f} ms (max |diff| "
          f"{ell_err:.2e}) ({card})", flush=True)
    # ---- 3d. the chain factor's kernels against their plain versions
    phase("3d K3, K3b against their plain versions")
    k3, k3b = ldl.tridiag_ldl, ldl.tridiag_ldl_blocked
    k3_plain, k3b_plain = ldl.tridiag_ldl_plain, ldl.tridiag_ldl_blocked_plain
    f32, f64 = torch.float32, torch.float64

    def chain_args(bop_, w_, name):
        """What banded.chain_factor hands its factor (`name`) at weights w_:
        (d, e) or (d, e, block)."""
        return captured_args(banded, name, lambda: banded.chain_factor(
            bop_, banded.assemble_bd(bop_, w_), w_))

    city_args = chain_args(bop, w, "tridiag_ldl_blocked")
    city8_args = chain_args(bop, w8, "tridiag_ldl_blocked")
    sphere_args = chain_args(bop_sp, w_sp, "tridiag_ldl_auto")
    sphere2_args = chain_args(bop_sp, w_sp2, "tridiag_ldl_auto")
    if city_args[2] != 128 or tuple(city8_args[0].shape) != (8, n):
        fail(f"city10000's chain factor: block {city_args[2]}, lanes "
             f"{tuple(city8_args[0].shape)}")
    d52l = d52 + 100 * torch.finfo(f32).eps * d52.amax(dim=-1, keepdim=True)
    rng = np.random.RandomState(3)

    def random_chain(rows):
        """A diagonally dominant float32 chain of `rows` rows on the card."""
        e_ = -(0.5 + rng.rand(rows - 1))
        d_ = (0.1 + rng.rand(rows) - np.concatenate([[0], e_])
              - np.concatenate([e_, [0]]))
        return (torch.as_tensor(d_, dtype=f32, device=dev),
                torch.as_tensor(e_, dtype=f32, device=dev))

    n_r = SCALE_N + 3  # 97 segments of 1024 and a last one of 675 rows
    d_r, e_r = random_chain(n_r)
    small = {rows: random_chain(rows) for rows in (1, 2, 17, 4096, 4097)}
    k3b_cases = [
        ("city10000's chain at its start weights, block 128", city_args),
        (f"the n = {SCALE_N} two-grid chain, block 1024", (d5, e5, 1024)),
        (f"a chain of {n_r} rows, block 1024 (a partial last segment)",
         (d_r, e_r, 1024)),
        ("city10000's 8 budget lanes (phase 8a), block 128", city8_args),
        ("phase 8b's 2 budget lanes, block 1024", (d52l, e52, 1024)),
        ("one row, block 128", (*small[1], 128)),
        ("two rows, block 128", (*small[2], 128)),
        ("17 rows, block 128", (*small[17], 128)),
        ("17 rows, block 1024 (one segment shorter than its block)",
         (*small[17], 1024)),
        ("city10000's chain, block 100 (segments that end inside a ring "
         "slot, 4 blocks of 32 segments)", (*city_args[:2], 100)),
        ("4097 rows, block 33 (125 segments; a ragged last one of 5 rows)",
         (*small[4097], 33)),
        ("city10000's chain shared by 3 lanes (lane stride 0), block 128",
         (city_args[0].expand(3, -1), city_args[1].expand(3, -1), 128))]
    k3_cases = [
        ("sphere2500's chain at its start weights", sphere_args),
        (f"the n = {SCALE_N} chain's first 32768 rows (the auto route's "
         "largest n)", (d5[:32768], e5[:32767])),
        (f"the n = {SCALE_N} chain's first 40000 rows", (d5[:40000],
                                                        e5[:39999])),
        ("city10000's 8 budget lanes", city8_args[:2]),
        ("one row", small[1]), ("two rows", small[2]),
        ("17 rows", small[17]),
        ("4096 rows (the largest in registers)", small[4096]),
        ("4097 rows (the smallest staged)", small[4097])]
    k3b_err, k3_err = {}, {}
    for dtype in (f32, f64):
        key = str(dtype).split(".")[-1]
        k3b_err[key] = max(factor_check(
            k3b, k3b_plain, (a[0].to(dtype), a[1].to(dtype), *a[2:]), lbl,
            exact=False) for lbl, a in k3b_cases)
        k3_err[key] = max(factor_check(
            k3, k3_plain, (a[0].to(dtype), a[1].to(dtype)), lbl, exact=True)
            for lbl, a in k3_cases)
    for power in (400, -400):
        scaled_factor_check(sphere_args, power,
                            "sphere2500's chain (in registers)")
        scaled_factor_check(small[4097], power, "4097 rows (staged)")
    # n = 40000 through tridiag_solve(d, e, B): one K3 launch, then a solve.
    from mac_tpu_torch.ops.tridiag import tridiag_solve as solve_de

    before = k3.launches
    X40 = solve_de(d5[:40000].double(), e5[:39999].double(),
                   torch.ones((d5[:40000].shape[0], 2), dtype=f64,
                              device=dev))
    torch.cuda.synchronize()
    if k3.launches != before + 1 or not bool(torch.isfinite(X40).all()):
        fail(f"tridiag_solve(d, e, B) at n = 40000: {k3.launches - before} "
             "K3 launches, or a non-finite solve")
    print(f"tridiag_solve(d, e, B) at n = 40000: one K3 launch, finite X",
          flush=True)
    f64_of = lambda a: (a[0].double(), a[1].double(), *a[2:])  # noqa: E731
    # One step of each kernel's chain alone (ldl.cu's one-thread probe), and
    # each kernel's phases at the main paths' shapes (clock64() stamps).
    ldl_step = {dt_: ldl_step_ns(dt_) for dt_ in (f32, f64)}
    print(f"ldl chain probe (one thread, operands in registers; device_ms "
          f"at 1024 steps less at 128, over 896): K3b's pivot step float32 "
          f"{ldl_step[f32]['K3b']['ns']:.2f} ns, float64 "
          f"{ldl_step[f64]['K3b']['ns']:.2f} ns; K3's carry step float32 "
          f"{ldl_step[f32]['K3']['ns']:.2f} ns, float64 "
          f"{ldl_step[f64]['K3']['ns']:.2f} ns; at 128 and 1024 steps less "
          f"the probe's floor ({ldl_step[f32]['floor_ms']:.5f} ms): " + ", ".join(
              f"{chain} {str(dt_)[6:]} {ldl_step[dt_][chain]['ns_at'][128]:.2f}"
              f" / {ldl_step[dt_][chain]['ns_at'][1024]:.2f} ns"
              for dt_ in (f32, f64) for chain in ("K3b", "K3"))
          + f"; K3b's step {ldl_step[f32]['K3b']['cycles']:.1f} cycles "
          f"({card})", flush=True)
    for label, factor, args in (
            ("K3b city10000 (10000,), block 128", "tridiag_ldl_blocked",
             city_args),
            ("K3b float64 city10000, block 128", "tridiag_ldl_blocked",
             f64_of(city_args)),
            (f"K3b ({SCALE_N},), block 1024", "tridiag_ldl_blocked",
             (d5, e5, 1024)),
            ("K3b city10000's 8 lanes, block 128", "tridiag_ldl_blocked",
             city8_args),
            ("K3 sphere2500 (2500,)", "tridiag_ldl", sphere_args),
            ("K3 float64 sphere2500", "tridiag_ldl", f64_of(sphere_args)),
            ("K3 (32768,)", "tridiag_ldl", (d5[:32768], e5[:32767]))):
        print(f"{factor} phases at {label} (first block, thread 0's clock64()):"
              + ", ".join(f" {ph} {cyc} cycles {ns / 1e3:.3f} us"
                          for ph, cyc, ns in ldl_phases(factor, args))
              + f" ({card})", flush=True)

    # The times at the main paths' shapes and their dependent chains: K3b's
    # is `block` pivot steps. K3's method walks chunks of c rows (256 chunks
    # at a time, at most 1024 chunks) twice around a serial pass over the
    # chunks, each a carry step: the kernel's own chain at its chunking
    # (at least 16 rows a chunk, ldl.cu), and the bound's at the c that
    # makes it shortest, which no chunking of the kernel's can beat.
    def k3_chain(rows, c):
        nseg = -(-rows // c)
        return 2 * c * -(-nseg // 256) + nseg

    def k3_steps(args):
        rows = args[0].shape[-1]
        return k3_chain(rows, -(-rows // min(1024, -(-rows // 16))))

    def k3_bound_steps(args):
        rows = args[0].shape[-1]
        return min(k3_chain(rows, c) for c in range(1, rows + 1)
                   if -(-rows // c) <= 1024)

    factor_tm = {}
    for key, kern, plain, args, label in (
            ("K3b", k3b, k3b_plain, city_args,
             "city10000's chain (10000,), block 128"),
            ("K3b_scale", k3b, k3b_plain, (d5, e5, 1024),
             f"the two-grid chain ({SCALE_N},), block 1024"),
            ("K3b_lanes8", k3b, k3b_plain, city8_args,
             "city10000's 8 lanes (8, 10000), block 128"),
            ("K3b_lanes2", k3b, k3b_plain, (d52l, e52, 1024),
             f"phase 8b's 2 lanes (2, {SCALE_N}), block 1024"),
            ("K3", k3, k3_plain, sphere_args, "sphere2500's chain (2500,)"),
            ("K3_32768", k3, k3_plain, (d5[:32768], e5[:32767]),
             "(32768,)"),
            ("K3_lanes2", k3, k3_plain, sphere2_args,
             "sphere2500's 2 lanes (2, 2500)"),
            ("K3b_f64", k3b, k3b_plain, f64_of(city_args),
             "city10000's chain in float64, block 128"),
            ("K3_f64", k3, k3_plain, f64_of(sphere_args),
             "sphere2500's chain in float64")):
        steps, bound_steps = ((args[2], args[2]) if kern is k3b
                              else (k3_steps(args), k3_bound_steps(args)))
        factor_tm[key] = factor_times(
            kern, plain, args, label, steps, bound_steps,
            ldl_step[args[0].dtype]["K3b" if kern is k3b else "K3"]["ns"],
            card)
        factor_tm[key]["launch_floor_ms"] = ldl_step[
            args[0].dtype]["floor_ms"]
        factor_tm[key]["max_abs_err"] = (
            k3b_err if kern is k3b else k3_err)[
                "float64" if key.endswith("f64") else "float32"]

    # ---- 3e. K4 against its plain version
    phase("3e K4 against its plain version")
    k4_mats = rayleigh_ritz_matrices(bop, w, dev)
    rng = np.random.RandomState(4)
    k4_cases = [(f"TRACEMIN's {k_}x{k_} {dt_} at city10000's start weights",
                 H_) for (k_, dt_), H_ in sorted(k4_mats.items(),
                                                 key=lambda kv: str(kv[0]))]

    def perturbed(H_, R_):
        """R_ copies of H_ (k, k), each with its own symmetric noise of
        1e-2 ||H_|| (the lanes' batches hold R_ nearby matrices)."""
        A_ = torch.as_tensor(rng.normal(size=(R_,) + tuple(H_.shape)),
                             dtype=H_.dtype, device=dev)
        return (H_ + 1e-2 * float(torch.linalg.matrix_norm(H_))
                * (A_ + A_.mT) / 2).contiguous()

    k4_lanes = {8: perturbed(k4_mats[(12, "float32")], 8),
                64: perturbed(k4_mats[(12, "float64")], 64)}
    k4_cases += [("phase 8a's lanes, 8 TRACEMIN 12x12 float32",
                  k4_lanes[8]),
                 ("phase 7c's lanes, 64 TRACEMIN 12x12 float64",
                  k4_lanes[64])]
    for dt_ in (f32, torch.float64):
        stack = torch.stack([k4_mats[(12, str(dt_).split(".")[-1])]] * 3)
        k4_cases.append((f"a batch of 3 such 12x12 {dt_}", stack))
        for k_ in range(1, 33):
            A_ = rng.normal(size=(k_, k_))
            k4_cases.append((f"random {k_}x{k_} {dt_}", torch.as_tensor(
                A_ + A_.T, dtype=dt_, device=dev)))
        A_ = rng.normal(size=(67, 12, 12))
        k4_cases.append((f"67 random 12x12 {dt_} (a partial last block)",
                         torch.as_tensor(A_ + A_.transpose(0, 2, 1),
                                         dtype=dt_, device=dev)))
    # K4w: TRACEMIN's matrices at q = 11 (11 x 11 at the entry, the warp
    # body; 33 x 33 each outer iteration) and q = 12 (36 x 36), the lanes'
    # (2, 36, 36), random orders 33 to 64, 96, 120 and 170 (K4w in shared
    # memory, or on the workspace past its limit: float32 170, float64 120)
    # and float32 180, float64 130 (the workspace).
    k4w_mats = {**rayleigh_ritz_matrices(bop, w, dev, q=11),
                **{key: H_ for key, H_ in rayleigh_ritz_matrices(
                    bop, w, dev, q=12).items() if key[0] == 36}}
    k4w_lanes = perturbed(k4w_mats[(36, "float32")], 2)
    k4w_cases = [(f"TRACEMIN's {k_}x{k_} {dt_} at city10000's start weights "
                  f"(q = {11 if k_ in (11, 33) else 12})", H_)
                 for (k_, dt_), H_ in sorted(k4w_mats.items(),
                                             key=lambda kv: str(kv[0]))]
    k4w_cases.append(("phase 8e's lanes, 2 TRACEMIN 36x36 float32",
                      k4w_lanes))
    k4w_random = {}
    for dt_, last in ((f32, 180), (torch.float64, 130)):
        for k_ in list(range(33, 65)) + [96, 120, 170, last]:
            A_ = rng.normal(size=(k_, k_))
            k4w_random[(k_, dt_)] = torch.as_tensor(A_ + A_.T, dtype=dt_,
                                                    device=dev)
            k4w_cases.append((f"random {k_}x{k_} {dt_}",
                              k4w_random[(k_, dt_)]))
    k4_err = {}
    for label, H_ in k4_cases + k4w_cases:
        key = str(H_.dtype).split(".")[-1]
        if H_.shape[-1] > syev.WARP_MAX_K:
            key = "K4w " + key
        k4_err[key] = max(k4_err.get(key, 0.0), k4_check(H_, label))
    for dt_, k_ in ((f32, 180), (torch.float64, 130)):
        if syev.body_for(k_, dt_) != "wide_workspace":
            fail(f"sym_eig at {k_}x{k_} {dt_} did not take the workspace")
    # The two storage forms of K4w, and K4w on the warp body's orders,
    # bit for bit: the same body over one layout, the same arithmetic.
    k4w_scratch = k4w_scratch_check(list(range(1, 65)) + [
        96, 118, 119, 120, 130, 168, 169, 170, 180])
    forms_same, forms_n = 0, 0
    form_cases = ([H_ for _, H_ in k4w_cases[:len(k4w_mats) + 1]
                   if H_.shape[-1] > syev.WARP_MAX_K]
                  + [k4w_random[(k_, dt_)] for dt_ in (f32, torch.float64)
                     for k_ in (33, 34, 47, 64, 96, 120)
                     if syev.body_for(k_, dt_) == "wide_shared"])
    for H_ in form_cases:
        e1, V1 = syev.sym_eig(H_)
        e2, V2 = syev.sym_eig(H_, body="wide_workspace")
        forms_n += 1
        forms_same += bool(torch.equal(e1, e2) and torch.equal(V1, V2))
    warp_same, warp_n = 0, 0
    for label, H_ in k4_cases:
        e1, V1 = syev.sym_eig(H_)
        e2, V2 = syev.sym_eig(H_, body="wide_shared")
        warp_n += 1
        warp_same += bool(torch.equal(e1, e2) and torch.equal(V1, V2))
    torch.cuda.synchronize()
    print(f"K4w's two storage forms (shared memory, workspace) bitwise "
          f"equal on {forms_same} of {forms_n} inputs; K4w forced onto the "
          f"warp body's {warp_n} inputs (k 1 to 32) bitwise the warp body "
          f"on {warp_same}; syev.cu's workspace bytes (float32, float64), "
          f"shared bytes a block (float32, float64) and threads at k 33, "
          f"64, 96, 118, 119, 168, 169: "
          f"{[(k_, k4w_scratch[k_]) for k_ in (33, 64, 96, 118, 119, 168,
                                               169)]}",
          flush=True)
    if forms_same != forms_n:
        fail("K4w's shared-memory and workspace forms differ")
    for H_, err, body_ in (
            (torch.zeros(4, 4, device=dev, dtype=torch.float16), TypeError,
             None),
            (torch.zeros(8, 8, device=dev)[:4, :4], ValueError, None),
            (torch.zeros(33, 33, device=dev), ValueError, "warp"),
            (k4w_random[(130, torch.float64)], RuntimeError, "wide_shared")):
        try:
            syev.sym_eig(H_, body=body_)
        except err:
            continue
        fail(f"sym_eig took what its kernel does not: {tuple(H_.shape)} "
             f"{H_.dtype}, contiguous {H_.is_contiguous()}, body {body_}")
    print("K4 refuses float16, a non-contiguous matrix, the warp body at k "
          "33 and K4w in shared memory past its limit (float64 130)",
          flush=True)
    one = torch.zeros(1, 1, device=dev)
    k4_floor = device_ms(lambda: syev.sym_eig(one))
    k4_round = {dt_: k4_round_ms(dt_) for dt_ in (f32, torch.float64)}
    # K4w's round with its barriers, at the block of k 33 and 36 (m 34 and
    # 36) and at 1024 threads (m 64 and past).
    k4w_threads = sorted({k4w_scratch[k_][-1] for k_ in (33, 36, 96)})
    k4w_round = {(dt_, t_): k4_round_ms(dt_, t_) for dt_ in
                 (f32, torch.float64) for t_ in k4w_threads}
    print(f"K4 launch floor (a 1 x 1 matrix, device_ms): {k4_floor:.5f} ms;"
          f" one round of its irreducible chain (one-warp probe): float32 "
          f"{1e6 * k4_round[f32]:.1f} ns, float64 "
          f"{1e6 * k4_round[torch.float64]:.1f} ns; K4w's round with its "
          f"two barriers (block probe): " + ", ".join(
              f"{str(dt_).split('.')[-1]} {t_} threads "
              f"{1e6 * v_:.1f} ns" for (dt_, t_), v_ in k4w_round.items())
          + f" ({card})", flush=True)
    k4_tm = {key: k4_times(H_, f"TRACEMIN's {key[0]}x{key[0]} {key[1]}",
                           card, k4_round[H_.dtype])
             for key, H_ in k4_mats.items()}
    k4_lane_tm = {R_: dict(k4_times(H_, f"the lanes' batch of {R_}", card,
                                    k4_round[H_.dtype]),
                           max_abs_err=k4_err[str(H_.dtype).split(".")[-1]])
                  for R_, H_ in k4_lanes.items()}

    def k4w_times(H_, label):
        dt_ = H_.dtype
        return dict(k4_times(H_, label, card, k4_round[dt_], k4w_round[
            (dt_, k4w_scratch[H_.shape[-1]][-1])]),
            max_abs_err=k4_err["K4w " + str(dt_).split(".")[-1]])

    k4w_tm = {(33, dt_): k4w_times(k4w_mats[(33, dt_)],
                                   f"TRACEMIN's 33x33 {dt_} (q = 11)")
              for dt_ in ("float32", "float64")}
    k4w_tm.update({(96, str(dt_).split(".")[-1]): k4w_times(
        k4w_random[(96, dt_)], f"random 96x96 {dt_}")
        for dt_ in (f32, torch.float64)})
    k4w_tm[("lanes", "float32")] = k4w_times(
        k4w_lanes, "phase 8e's lanes' batch of 2")
    # K4w's round by phase (its stamped build): TRACEMIN's 33 x 33 and the
    # random 96 x 96, both types.
    for key_, H_ in ((33, k4w_mats[(33, "float32")]),
                     (33, k4w_mats[(33, "float64")]),
                     (96, k4w_random[(96, f32)]),
                     (96, k4w_random[(96, torch.float64)])):
        print(k4w_phase_line(f"({key_}, {key_}) {H_.dtype}", k4w_phases(H_),
                             card), flush=True)

    # ---- 4. the banded path, through the user's entry points
    # ---- 3f. the CG step's kernels against their plain versions
    phase("3f K5, K6, K1p, K7, K8, K9, K10 against their plain versions")
    cg_tm = cg_kernels(dev, card, bop, w, bop_sp, w_sp,
                       ell=(op5, w5, W5, *greedy_eig_table(dev, dataset)))
    fw_tm = fw_kernels(dev, card, cands, (fi5, wf5, ci5, wc5))
    fw_kerns = (kfw.fw_oracle, kfw.fw_update)

    phase("4 banded path (city10000)")
    # Phases 4 to 10 hand no plain chain factor a CUDA tensor, and phases 4
    # to 10 and 12 run every single solve of a graphed route through its
    # graphs, every Rayleigh-Ritz eigensolve through K4 and every CG step
    # through K6 (and on the banded routes K5, K1p and K7).
    plain_factor = PlainOnCard(FACTOR_PLAINS).__enter__()
    plain_inner = PlainOnCard(("plain_solve", "sym_eig_plain")
                              + CG_PLAINS + FW_PLAINS).__enter__()
    t0 = time.perf_counter()
    meas, n = read_g2o_file(str(dataset))
    fixed, cands = split_edges(rpm_to_mac(meas))
    x_init = NaiveGreedy(cands).subset(k)
    mac = MAC(fixed, cands, n, device="cuda")
    print(f"setup (read, NaiveGreedy, MAC ctor with its host probe): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    k4 = syev.sym_eig
    counted = (tridiag_solve, tridiag_solve_blocked, assemble_ut, k3, k3b,
               k4, kbanded.banded_product, kbanded.coarse_correct,
               tridiag_solve_permuted, kpcg.col_sums, kpcg.cg_update,
               kpcg.cg_direction_dots, kell.ell_product)
    reset_counts(*counted, *fw_kerns)
    times, graphs4 = [], [graph_stats(mac._banded)]
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounded, unrounded, upper = mac.solve(k, x_init, rounding="nearest",
                                              use_cache=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        graphs4.append(graph_stats(mac._banded))
    graph_lines(card, "city10000", graphs4)
    launches = {"tridiag_solve_permuted": tridiag_solve_permuted.launches,
                "assemble_ut": assemble_ut.launches,
                "tridiag_ldl_blocked": k3b.launches,
                **{kern.__name__: kern.launches for kern in counted
                   if kern.__name__ in CG_KERNELS},
                "sym_eig": k4.launches}
    k4_launches = {"float32": k4.launches_by_dtype.get("float32", 0)}
    k1p_bodies = {"phase 4": dict(tridiag_solve_permuted.launches_by_body)}
    if set(k1p_bodies["phase 4"]) != {"segment"}:
        fail(f"city10000's chain factor (decoupled every 128 rows) did not "
             f"take K1p's segment body alone: {k1p_bodies['phase 4']}")
    tridiag_solve_launches_4 = tridiag_solve.launches
    if (tridiag_solve_blocked.launches or k3.launches or tridiag_solve.launches
            or kell.ell_product.launches):
        fail("the banded path launched tridiag_solve_blocked, K3, K1 or K8 "
             "(K1p takes K1's place in the V-cycle)")
    print(f"solve: cold {times[0]:.4f} s, warm {[round(t, 4) for t in times[1:]]}"
          f" s, warm median {statistics.median(times[1:]):.4f} s ({card})",
          flush=True)
    print(f"last_solve_stats: {mac.last_solve_stats}", flush=True)
    fw_launches = {"phase 4": by_dtype(fw_kerns)}
    launches.update({kern.__name__: kern.launches for kern in fw_kerns})
    print(f"kernel launches in the 4 solves: {launches}", flush=True)
    plain_fw_check(card, "4 city10000", mac, lambda: mac.solve(
        k, x_init, rounding="nearest", use_cache=True),
        (rounded, unrounded, upper), fw_kerns)
    for kname, count in launches.items():
        if count <= 0:
            fail(f"the main path never launched {kname}")
    if not (np.all(np.isfinite(unrounded)) and np.isfinite(upper)
            and np.all(np.isfinite(rounded))):
        fail("non-finite solve output")
    if rounded.shape != (len(cands),) or int(rounded.sum()) != k:
        fail(f"rounded selection holds {rounded.sum()} edges, want {k}")
    lam2 = scipy_lam2(mac.laplacian(unrounded))
    gap = (lam2 - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED
    print(f"relaxed lambda_2 (scipy) {lam2:.9g}, reference "
          f"{REFERENCE_LAM2_UNROUNDED:.9g}, relative gap {gap:+.3e}; "
          f"upper bound {upper:.9g}", flush=True)
    if not gap >= CITY_GAP_FLOOR:
        fail(f"relaxed lambda_2 gap {gap:+.3e} below {CITY_GAP_FLOOR}")
    if f"{gap:+.3e}" != CITY_GAP_DIGITS:
        fail(f"city10000's relaxed gap {gap:+.3e} moved from "
             f"{CITY_GAP_DIGITS}: the path's arithmetic is no longer the "
             "same")
    if upper < lam2 * (1 - 1e-6):
        fail(f"upper bound {upper} below the relaxed lambda_2 {lam2}")

    # ---- 4b. fiedler_block_q = 11: K4w on the main path
    phase("4b banded path at fiedler_block_q=11 (city10000; sphere2500 "
          "float64)")
    mac11, k11, x11, k4w_launches = wide_block(
        card, dataset, counted, statistics.median(times[1:]))

    # ---- 5. the matrix-free path at n = 100000, as bench_scale drives it
    phase(f"5 matrix-free path (n {SCALE_N})")
    t0 = time.perf_counter()
    mac5 = MAC((fi5, wf5), (ci5, wc5), SCALE_N, fiedler_inner_iters=10,
               fiedler_maxiter=60, fiedler_tol=6e-4, device="cuda")
    ctor_s = time.perf_counter() - t0
    print(f"n {SCALE_N}: {len(wf5)} fixed, {len(wc5)} candidates, K {k5}; "
          f"route {'banded' if mac5._banded is not None else mac5.op.mode}, "
          f"ELL width {mac5.op.nbr_tbl.shape[1]}, coarse {mac5.op.coarse_nc} "
          f"x {mac5.op.coarse_s}, precond {mac5.fiedler_precond}; MAC ctor "
          f"(host precision probe, RCM band test, ELL tables) {ctor_s:.3f} s",
          flush=True)
    if mac5._banded is not None or mac5.op.mode != "ell":
        fail("the n = 100000 expander graph did not take the ELL route")
    reset_counts(*counted, *fw_kerns)
    path_s, path_launches, graphs5 = [], [], [graph_stats(mac5.op)]
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounded5, unrounded5, upper5 = mac5.solve(k5, x5, max_iters=10,
                                                  use_cache=True)
        torch.cuda.synchronize()
        path_s.append(time.perf_counter() - t0)
        path_launches.append(kell.ell_product.launches
                             - sum(path_launches))
        graphs5.append(graph_stats(mac5.op))
        print(f"solve {label}: {path_s[-1]:.3f} s, last_solve_stats "
              f"{mac5.last_solve_stats}, K8 launches "
              f"{path_launches[-1]}", flush=True)
    graph_lines(card, f"n = {SCALE_N}", graphs5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam5 = mac5.evaluate_objective(unrounded5)
    eval_s = time.perf_counter() - t0
    launches5 = {kern.__name__: kern.launches for kern in counted}
    fw_launches["phase 5"] = by_dtype(fw_kerns)
    if min(kern.launches for kern in fw_kerns) <= 0:
        fail(f"the matrix-free path never launched K9 or K10: "
             f"{fw_launches['phase 5']}")
    plain_fw_check(card, f"5 n = {SCALE_N}", mac5, lambda: mac5.solve(
        k5, x5, max_iters=10, use_cache=True),
        (rounded5, unrounded5, upper5), fw_kerns)
    k1p_bodies["phase 5"] = dict(tridiag_solve_permuted.launches_by_body)
    k4_launches["float64"] = k4.launches_by_dtype.get("float64", 0)
    print(f"evaluate_objective: {eval_s:.3f} s, K8 launches "
          f"{kell.ell_product.launches - sum(path_launches)}", flush=True)
    print(f"matrix-free path ({card}): ctor {ctor_s:.3f} s, cold solve "
          f"{path_s[0]:.3f} s, warm solve {path_s[1]:.3f} s, "
          f"evaluate_objective {eval_s:.3f} s; kernel launches {launches5}",
          flush=True)
    gap5 = (lam5 - REFERENCE_LAM2_SCALE) / REFERENCE_LAM2_SCALE
    print(f"relaxed lambda_2 (evaluate_objective) {lam5:.12g}, reference "
          f"{REFERENCE_LAM2_SCALE:.12g}, relative gap {gap5:+.3e}; upper "
          f"bound {upper5:.12g}; rounded {int(rounded5.sum())} of "
          f"{len(wc5)}", flush=True)
    if (k3b.launches <= 0 or k4_launches["float64"] <= 0
            or min(launches5[kern] for kern in ELL_CG_KERNELS) <= 0):
        fail(f"the matrix-free path never launched K3b, K4 in float64 or a "
             f"kernel of its CG step (K8, K1p, K7, K6): {launches5}")
    if (launches5["tridiag_solve_blocked"] or launches5["tridiag_solve"]
            or launches5["banded_product"]
            or set(k1p_bodies["phase 5"]) != {"segment"}):
        fail(f"the matrix-free path's V-cycle ran K1b, K1 or K5, or K1p "
             f"outside its segment body (the chain factor is decoupled "
             f"every 1024 rows): {launches5}, K1p by body "
             f"{k1p_bodies['phase 5']}")
    if not (np.all(np.isfinite(unrounded5)) and np.all(np.isfinite(rounded5))
            and np.isfinite(upper5) and np.isfinite(lam5)):
        fail("non-finite output on the matrix-free path")
    if rounded5.shape != (len(wc5),) or int(rounded5.sum()) != k5:
        fail(f"rounded selection holds {rounded5.sum()} edges, want {k5}")
    if not lam5 >= REFERENCE_LAM2_SCALE * (1 - 1e-3):
        fail(f"relaxed lambda_2 {lam5} below the reference "
             f"{REFERENCE_LAM2_SCALE} (1 - 1e-3)")
    if not upper5 >= lam5 * (1 - 1e-6):
        fail(f"upper bound {upper5} below the relaxed lambda_2 {lam5}")

    # ---- 6. the bundled datasets, MAC(fixed, cands, n) with no knobs
    phase("6 bundled datasets")
    bundled_launches = {}
    bundled_walls = {}
    bundled_macs = {}
    for ds, (ref_lam, want_dtype, want_backend, want_banded,
             gap_floor) in BUNDLED.items():
        t0 = time.perf_counter()
        meas, n6 = read_g2o_file(str(dataset.parent / f"{ds}.g2o"))
        fixed6, cands6 = split_edges(rpm_to_mac(meas))
        k6 = len(cands6) // 2
        x6 = NaiveGreedy(cands6).subset(k6)
        mac6 = MAC(fixed6, cands6, n6)
        setup_s = time.perf_counter() - t0
        if mac6.device.type != "cuda":
            fail(f"{ds}: MAC without a device argument is on {mac6.device}")
        for kern in counted:
            kern.launches = 0
        bodies0 = dict(tridiag_solve_permuted.launches_by_body)
        times6 = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r6, u6, up6 = mac6.solve(k6, x6, use_cache=True)
            torch.cuda.synchronize()
            times6.append(time.perf_counter() - t0)
        got = {kern.__name__: kern.launches for kern in counted}
        k1p_bodies[f"phase 6 {ds}"] = {
            b: c - bodies0.get(b, 0)
            for b, c in tridiag_solve_permuted.launches_by_body.items()
            if c > bodies0.get(b, 0)}
        bundled_launches[ds] = got
        bundled_walls[ds] = statistics.median(times6[1:])
        bundled_macs[ds] = (mac6, k6, x6)
        lam_u = scipy_lam2(mac6.laplacian(u6))
        lam_r = scipy_lam2(mac6.laplacian(r6))
        gap6 = (lam_u - ref_lam) / ref_lam
        banded6 = mac6._banded is not None
        ratio = mac6.spectral_ratio
        print(f"{ds}: n {n6}, m_cand {len(cands6)}, K {k6}; dtype "
              f"{str(mac6.dtype).split('.')[-1]}, fiedler_backend "
              f"{mac6.fiedler_backend}, auto_dtype_reason "
              f"{mac6.auto_dtype_reason!r}, spectral_ratio "
              f"{'None' if ratio is None else format(ratio, '.3e')}, "
              f"{'banded' if banded6 else mac6.op.mode} operator, fw_polish "
              f"{mac6.fw_polish}, round_guard {mac6.round_guard}; setup "
              f"{setup_s:.3f} s, cold {times6[0]:.4f} s, warm "
              f"{[round(t, 4) for t in times6[1:]]} s, warm median "
              f"{statistics.median(times6[1:]):.4f} s ({card}); relaxed "
              f"lambda_2 {lam_u:.12g} (reference {ref_lam:.12g}, gap "
              f"{gap6:+.3e}), rounded lambda_2 {lam_r:.12g}, upper "
              f"{up6:.12g}; last_solve_stats {mac6.last_solve_stats}; kernel "
              f"launches in the 4 solves {got}", flush=True)
        if (str(mac6.dtype).split(".")[-1], mac6.fiedler_backend,
                banded6) != (want_dtype, want_backend, want_banded):
            fail(f"{ds} took another route than the reference's "
                 f"({want_dtype}, {want_backend}, banded {want_banded})")
        if mac6.fw_polish != want_banded or mac6.round_guard != want_banded:
            fail(f"{ds}: fw_polish {mac6.fw_polish}, round_guard "
                 f"{mac6.round_guard}, want both {want_banded}")
        if not (np.all(np.isfinite(u6)) and np.isfinite(up6)
                and np.isfinite(lam_u) and np.isfinite(lam_r)):
            fail(f"{ds}: non-finite solve output")
        if not gap6 >= gap_floor:
            fail(f"{ds}: relaxed lambda_2 gap {gap6:+.3e} below {gap_floor}")
        if r6.shape != (len(cands6),) or int(r6.sum()) != k6 \
                or set(np.unique(r6)) - {0.0, 1.0}:
            fail(f"{ds}: rounded selection holds {r6.sum()} edges, want {k6}")
        if not up6 >= lam_u * (1 - 1e-9):
            fail(f"{ds}: upper bound {up6} below the relaxed lambda_2 {lam_u}")
        if want_banded:
            if not lam_r >= 0.1 * lam_u:
                fail(f"{ds}: rounded lambda_2 {lam_r} collapsed below 0.1 of "
                     f"the relaxed {lam_u}")
            if min(k1_body(got), got["assemble_ut"], got["tridiag_ldl"],
                   *(got[kern] for kern in CG_KERNELS)) <= 0:
                fail(f"{ds} never launched K1p, K3, the assembly kernel or "
                     f"K5, K6, K7: {got}")
            b6 = mac6._banded
            print(f"{ds}: assembly form "
                  f"{'K2b (split)' if b6.ov_rows else 'K2 (no split)'}, nb "
                  f"{b6.nb}, half {b6.half}, du_dense {b6.du_dense}, ov_rows "
                  f"{b6.ov_rows}; exact chain factor (n <= 4096); K1p by "
                  f"body {k1p_bodies[f'phase 6 {ds}']}", flush=True)
            if set(k1p_bodies[f"phase 6 {ds}"]) != {"cluster"}:
                fail(f"{ds}: its exact chain factor did not take K1p's "
                     f"cluster body alone: {k1p_bodies[f'phase 6 {ds}']}")
            if b6.ov_rows:
                fail(f"{ds}: the solver's tables split, phase 3's did not")
        elif any(got.values()):
            fail(f"{ds} is host-routed but launched kernels: {got}")

    # The graph that is disconnected even with every candidate.
    from mac_tpu_torch.utils.graphs import Edge

    n_d, half_d = 1200, 600
    fixed_d = [Edge(i, i + 1, 1.0) for i in range(half_d - 1)] + \
        [Edge(i, i + 1, 1.0) for i in range(half_d, n_d - 1)]
    cands_d = [Edge(0, 5, 1.0), Edge(half_d, half_d + 9, 1.0),
               Edge(2, 30, 1.0)]
    mac_d = MAC(fixed_d, cands_d, n_d)
    reset_counts(*counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainOnCard() as plain_d:
        r_d, u_d, up_d = mac_d.solve(2)
        obj_d = mac_d.evaluate_objective(u_d)
    torch.cuda.synchronize()
    disc_s = time.perf_counter() - t0
    got_d = by_dtype(counted)
    print(f"disconnected graph (n {n_d}): dtype "
          f"{str(mac_d.dtype).split('.')[-1]}, fiedler_backend "
          f"{mac_d.fiedler_backend}, device {mac_d.device}, precond "
          f"{mac_d.fiedler_precond}; solve(2) and evaluate_objective "
          f"{disc_s:.3f} s ({card}); selected {int(r_d.sum())}, upper "
          f"{up_d:.3e}, evaluate_objective {obj_d:.3e}; last_solve_stats "
          f"{mac_d.last_solve_stats}; kernel launches by dtype {got_d}, "
          f"plain versions on the card {plain_d.calls}", flush=True)
    if (mac_d.fiedler_backend, mac_d.dtype, mac_d.device.type) != (
            "device", torch.float64, "cuda"):
        fail("the disconnected graph left the float64 device engine")
    if int(r_d.sum()) != 2 or not np.isfinite(up_d):
        fail(f"disconnected graph: selected {r_d.sum()}, upper {up_d}")
    if not (np.isfinite(obj_d) and abs(obj_d) < 1e-8):
        fail(f"disconnected graph: evaluate_objective {obj_d}, want 0")
    if (k1_body(got_d, "float64") <= 0 or plain_d.calls
            or any(v.get("float32", 0) for v in got_d.values())):
        fail(f"the float64 solve did not run its chain solves through K1's "
             f"float64 instantiation alone: {got_d}, plain {plain_d.calls}")

    # ---- 7. the greedy baselines
    phase("7 baselines")
    eig_launches, k1_ge = baselines(dev, dataset, card, counted)

    # ---- 8. the budget sweep
    phase("8 budget sweep")
    lanes_a, lanes_b, lanes_d, lanes_e = sweeps(
        dev, card, mac, mac5, dataset, counted, (fi5, wf5, ci5, wc5))

    # ---- 9. the device mesh
    phase("9 mesh")
    mesh_launches = mesh_phase(
        card, dataset, ((fi5, wf5, ci5, wc5), k5, x5),
        {"city10000": statistics.median(times[1:]),
         "sphere2500": bundled_walls["sphere2500"], "scale": path_s[1]})

    # ---- 10. float64 and the remaining methods
    phase("10 float64 and the remaining methods")
    reset_counts(*fw_kerns)
    solvers_10b, launches_10b, launches_10f, f64_kernels = float64_phase(
        dev, card, dataset, (fi5, wf5, ci5, wc5), counted)
    fw_launches["phase 10"] = by_dtype(fw_kerns)
    if min(kern.launches_by_dtype.get("float64", 0) for kern in fw_kerns) <= 0:
        fail(f"the float64 solves of phase 10 never launched K9 or K10 in "
             f"float64: {fw_launches['phase 10']}")
    plain_factor.__exit__(None, None, None)
    print(f"plain chain factors handed CUDA tensors in phases 4-10: "
          f"{plain_factor.calls}", flush=True)
    if plain_factor.calls:
        fail(f"a plain chain factor ran on the card: {plain_factor.calls}")

    plain_inner.__exit__(None, None, None)
    inner_calls = dict(plain_inner.calls)

    # ---- 11. the chain factor's kernels against its plain loops, end to end
    phase("11 K3/K3b against the plain factor loops (warm solves, eager "
          "path)")
    with SolvePath("eager"):
        ab = factor_ab(card, {
        "city10000": (lambda: mac.solve(k, x_init, rounding="nearest",
                                        use_cache=True),
                      lambda out: (scipy_lam2(mac.laplacian(out[1])),
                                   REFERENCE_LAM2_UNROUNDED)),
        "sphere2500": (lambda: bundled_macs["sphere2500"][0].solve(
            *bundled_macs["sphere2500"][1:], use_cache=True),
            lambda out: (scipy_lam2(bundled_macs["sphere2500"][0].laplacian(
                out[1])), BUNDLED["sphere2500"][0])),
        f"n = {SCALE_N}": (lambda: mac5.solve(k5, x5, max_iters=10,
                                              use_cache=True),
                           lambda out: (mac5.evaluate_objective(out[1]),
                                        REFERENCE_LAM2_SCALE))},
            (k3, k3b))

    # ---- 12. the reference's API on the card
    phase("12 the reference's API (preconditioner variants, call forms, "
          "native opt-out)")
    with PlainOnCard(("plain_solve", "sym_eig_plain")
                     + CG_PLAINS) as plain12:
        api_phase(dev, card, {"city10000": (bop, w),
                              "sphere2500": (bop_sp, w_sp)},
                  mac.laplacian(x_init), dataset, counted)
    for name_, c_ in plain12.calls.items():
        inner_calls[name_] = inner_calls.get(name_, 0) + c_
    print(f"single solves of graphed routes run without their graphs, and "
          f"plain Jacobi eigensolves, and plain forms of the CG step, on "
          f"the card in phases 4-10 and 12: {inner_calls}", flush=True)
    if inner_calls:
        fail(f"a graphed route solved without its graphs, or K4's plain "
             f"version, or a plain form of the CG step ran, on the card: "
             f"{inner_calls}")

    # ---- 13. the solve's graphs against the inner-only and eager paths
    phase("13 the solve five ways: the device loop over the replayed set-up "
          "and outer iteration, the host loop over them, inner steps only, "
          "eager, the plain CG step (warm solves); forced early stops")
    mac_sp, k_sp, x_sp = bundled_macs["sphere2500"]
    mac64, k64, x64 = solvers_10b["city10000"]

    def rel_gap(ref, floor=None, within=None):
        def quality(lam):
            gap = (lam - ref) / ref
            ok = gap >= floor if within is None else abs(gap) <= within
            rule = (f">= {floor}" if within is None
                    else f"within {within} relative")
            return ok, (f"relaxed lambda_2 {lam:.12g}, reference {ref:.12g},"
                        f" gap {gap:+.3e} ({rule})")
        return quality

    ab13 = graph_ab(card, {
        "city10000": (mac, lambda: mac.solve(
            k, x_init, rounding="nearest", use_cache=True),
            lambda u: scipy_lam2(mac.laplacian(u)), k,
            rel_gap(REFERENCE_LAM2_UNROUNDED, floor=CITY_GAP_FLOOR)),
        "city10000 q = 11": (mac11, lambda: mac11.solve(
            k11, x11, rounding="nearest", use_cache=True),
            lambda u: scipy_lam2(mac11.laplacian(u)), k11,
            rel_gap(REFERENCE_LAM2_UNROUNDED, floor=GAP_FLOOR)),
        "sphere2500": (mac_sp, lambda: mac_sp.solve(
            k_sp, x_sp, use_cache=True),
            lambda u: scipy_lam2(mac_sp.laplacian(u)), k_sp,
            rel_gap(BUNDLED["sphere2500"][0], floor=BUNDLED["sphere2500"][4])),
        f"n = {SCALE_N}": (mac5, lambda: mac5.solve(
            k5, x5, max_iters=10, use_cache=True), mac5.evaluate_objective,
            k5, rel_gap(REFERENCE_LAM2_SCALE, floor=-1e-3)),
        "city10000 banded float64": (mac64, lambda: mac64.solve(
            k64, x64, max_iters=20),
            lambda u: scipy_lam2(mac64.laplacian(u)), k64,
            rel_gap(REFERENCE_LAM2_UNROUNDED, within=1e-9))}, counted,
        fw_kerns)
    for name_, res_ in ab13.items():
        g_, p_ = res_["profile"]["graph"], res_["profile"]["plain-cg"]
        h_ = res_["profile"]["plain-fw"]
        print(f"13 {name_}: replayed warm solve, kernels / plain CG step: "
              f"device busy {g_[1]:.3f} / {p_[1]:.3f} ms, device kernels "
              f"{g_[2]} / {p_[2]}, one CG step {g_[4]} / {p_[4]} kernels, "
              f"{g_[5]} / {p_[5]} ms ({card})", flush=True)
        print(f"13 {name_}: replayed warm solve, device loop / host loop "
              f"(plain-fw): wall {g_[0]:.4f} / {h_[0]:.4f} s, device busy "
              f"{g_[1]:.3f} / {h_[1]:.3f} ms, idle share "
              f"{1 - g_[1] / 1e3 / g_[0]:.3f} / "
              f"{1 - h_[1] / 1e3 / h_[0]:.3f}, launch calls on the host "
              f"{g_[3]} / {h_[3]}, host reads {g_[6]} / {h_[6]} ({card})",
              flush=True)
    stops13 = forced_stops(card, {
        "sphere2500": (mac_sp, k_sp, x_sp, 12),
        f"n = {SCALE_N}": (mac5, k5, x5, 10),
        "city10000 banded float64": (mac64, k64, x64, 20)}, counted,
        fw_kerns)
    step13 = ab13["city10000"]["profile"]["graph"][4]
    if step13 != STEP_KERNELS:
        fail(f"13 city10000: a replayed CG step ran {step13} device kernels, "
             f"not {STEP_KERNELS}")
    step13_ell = ab13[f"n = {SCALE_N}"]["profile"]["graph"][4]
    if step13_ell != ELL_STEP_KERNELS:
        fail(f"13 n = {SCALE_N}: a replayed CG step ran {step13_ell} device "
             f"kernels, not {ELL_STEP_KERNELS}")
    if ab13["city10000 q = 11"]["bodies"].get("wide_shared", 0) <= 0:
        fail(f"13 city10000 q = 11: K4w never launched: "
             f"{ab13['city10000 q = 11']['bodies']}")
    phase.end()

    # "ms" and "device_ms": device time (device_ms); "call_ms": one call
    # with its host work (call_ms); "plain_ms": one call of the plain
    # version; "library_ms": the yardstick's device time. K2 and K2b are
    # one kernel (one wrapper, one count), timed at the two table forms;
    # city10000 (phase 4) runs only the overflow form, so its launches
    # stand under K2b; sphere2500 (phase 6) runs the form without a split,
    # and its launches stand under K2. "launches" is the count of the
    # kernel's own main path (K1 phase 4, K1b phase 5, K2 phase 6);
    # "launches_sphere2500" that of phase 6's four solves. The lane forms
    # (shape "(R, ...)") count their launches with R lanes in phase 8's
    # sweeps ("launches_path" names the part). "launches_mesh": the launches
    # on phase 9's mesh path (K1 and K2b in 9a, K2 in 9b, K1b in 9c's two
    # solves).
    def k2_entry(key, replaces, shape, tm, count, mesh_count):
        return {"name": "assemble_ut", "route": "cuda",
                "source": "mac_tpu_torch/csrc/assemble.cu",
                "replaces": replaces, "shape": shape, "launches": count[0],
                "launches_sphere2500": count[1], "launches_mesh": mesh_count,
                "max_abs_err": k2_err[key], "ms": tm["device_ms"],
                "device_ms": tm["device_ms"], "call_ms": tm["call_ms"],
                "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
                "library_call_ms": tm["library_call_ms"]}

    def lane_entry(name, replaces, shape, tm, launches, path):
        return {"name": name, "route": "cuda",
                "source": "mac_tpu_torch/csrc/" + (
                    "assemble.cu" if name == "assemble_ut" else "tridiag.cu"),
                "replaces": replaces, "shape": shape, "launches": launches,
                "launches_path": path, "max_abs_err": tm["max_abs_err"],
                "ms": tm["device_ms"], "device_ms": tm["device_ms"],
                "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "library_ms": tm.get("library_ms")}

    # K3 and K3b replace JAX scans, not Pallas kernels: "replaces" names the
    # scan's line. "launches": K3b's on phase 4's main path, K3's on phase
    # 6's sphere2500 solves; "chain_steps": the dependent chain's length.
    def factor_entry(name, key, replaces, shape, launches, path, **more):
        tm = factor_tm[key]
        return {"name": name, "route": "cuda",
                "source": "mac_tpu_torch/csrc/ldl.cu", "replaces": replaces,
                "shape": shape, "launches": launches, "launches_path": path,
                "max_abs_err": tm["max_abs_err"], "ms": tm["device_ms"],
                "device_ms": tm["device_ms"], "call_ms": tm["call_ms"],
                "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                "bound_by": tm["bound_by"], "library_ms": None,
                "chain_steps": tm["chain_steps"],
                "bound_steps": tm["bound_steps"],
                "chain_step_ns": tm["chain_step_ns"],
                "ops_bound_ms": tm["ops_bound_ms"],
                "ops_bound_by": tm["ops_bound_by"],
                "launch_floor_ms": tm["launch_floor_ms"], **more}

    # K4 stands for jnp.linalg.eigh: "library_ms" is torch.linalg.eigh's
    # device time (kernels_ms), "library_call_ms" its call time; bound_ms
    # the larger of the chain bound and the byte/operation bound.
    def k4_entry(shape, dtype, tm, launches, path, replaces):
        return {"name": "sym_eig", "route": "cuda",
                "source": "mac_tpu_torch/csrc/syev.cu", "replaces": replaces,
                "shape": shape, "dtype": dtype, "launches": launches,
                "launches_path": path,
                "max_abs_err": (tm["max_abs_err"] if "max_abs_err" in tm
                                else k4_err[dtype]),
                "ms": tm["device_ms"], "device_ms": tm["device_ms"],
                "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "library_ms": tm["library_ms"],
                "library_call_ms": tm["library_call_ms"],
                "library": "torch.linalg.eigh: device time of its kernels; "
                           "library_call_ms its call (it synchronises)",
                "launch_floor_ms": k4_floor,
                "sweeps": tm["sweeps"], "chain_steps": tm["chain_steps"]}

    # K4w, K4's thread-block body past order 32: "launches" those of K4w on
    # its path (phase 4b's three warm city10000 solves at q = 11 in float32,
    # its two sphere2500 banded float64 solves at q = 11, phase 8e's sweep
    # at q = 12), "barrier_round_ms" its round with the two barriers
    # (block probe) beside the bound.
    def k4w_entry(shape, dtype, key, launches, path, replaces):
        tm = k4w_tm[key]
        return dict(k4_entry(shape, dtype, tm, launches, path, replaces),
                    name="sym_eig_wide", body=tm["body"],
                    barrier_round_ms=tm["barrier_round_ms"])

    k4w_kernels = [
        k4w_entry("(33, 33), TRACEMIN's at q = 11", "float32",
                  (33, "float32"),
                  k4w_launches["city10000"].get("wide_shared", 0),
                  "phase 4b city10000 q = 11, 3 warm solves",
                  "mac_tpu/ops/lobpcg.py:443"),
        k4w_entry("(33, 33), TRACEMIN's at q = 11", "float64",
                  (33, "float64"),
                  k4w_launches["sphere2500 float64"].get("wide_shared", 0),
                  "phase 4b sphere2500 banded float64 q = 11, 2 solves",
                  "mac_tpu/ops/lobpcg.py:443"),
        k4w_entry("(96, 96), random", "float32", (96, "float32"), 0,
                  "none (timed only; the 3q of q = 32)",
                  "mac_tpu/ops/lobpcg.py:443"),
        k4w_entry("(96, 96), random", "float64", (96, "float64"), 0,
                  "none (timed only; the 3q of q = 32)",
                  "mac_tpu/ops/lobpcg.py:443"),
        k4w_entry("(2, 36, 36), a sweep lane each at q = 12", "float32",
                  ("lanes", "float32"),
                  lanes_e["sym_eig_by_body"].get("wide_shared", 0),
                  "phase 8e", "mac_tpu/ops/lobpcg.py:443 (under vmap)")]
    sphere = bundled_launches["sphere2500"]
    scan_blk = "mac_tpu/ops/tridiag.py:153"
    scan_ex = "mac_tpu/ops/tridiag.py:105"
    factor_kernels = [
        factor_entry("tridiag_ldl_blocked", "K3b", scan_blk,
                     "(10000,), block 128, city10000's chain",
                     launches["tridiag_ldl_blocked"], "phase 4",
                     launches_mesh=mesh_launches["a"]["tridiag_ldl_blocked"],
                     launches_ab=ab["city10000"]["launches"]),
        factor_entry("tridiag_ldl_blocked", "K3b_scale", scan_blk,
                     f"({SCALE_N},), block 1024, the two-grid chain",
                     launches5["tridiag_ldl_blocked"], "phase 5",
                     launches_mesh=sum(got["tridiag_ldl_blocked"] for got
                                       in mesh_launches["c"].values())),
        factor_entry("tridiag_ldl_blocked", "K3b_lanes8", scan_blk,
                     "(8, 10000), block 128, a chain per lane",
                     lanes_a["tridiag_ldl_blocked"].get(8, 0), "phase 8a"),
        factor_entry("tridiag_ldl_blocked", "K3b_lanes2", scan_blk,
                     f"(2, {SCALE_N}), block 1024, a chain per lane",
                     lanes_b["tridiag_ldl_blocked"].get(2, 0), "phase 8b"),
        factor_entry("tridiag_ldl", "K3", scan_ex,
                     "(2500,), sphere2500's chain", sphere["tridiag_ldl"],
                     "phase 6 sphere2500",
                     launches_mesh=mesh_launches["b"]["tridiag_ldl"],
                     launches_greedy_eig=eig_launches["tridiag_ldl"]),
        factor_entry("tridiag_ldl", "K3_lanes2", scan_ex,
                     "(2, 2500), sphere2500's chain per lane",
                     lanes_d["tridiag_ldl"].get(2, 0), "phase 8d"),
        factor_entry("tridiag_ldl_blocked_f64", "K3b_f64", scan_blk,
                     "(10000,), block 128, city10000's chain in float64",
                     launches_10b["city10000"]["tridiag_ldl_blocked"].get(
                         "float64", 0), "phase 10b city10000",
                     dtype="float64",
                     launches_scale=launches_10f["tridiag_ldl_blocked"].get(
                         "float64", 0)),
        factor_entry("tridiag_ldl_f64", "K3_f64", scan_ex,
                     "(2500,), sphere2500's chain in float64",
                     launches_10b["sphere2500"]["tridiag_ldl"].get(
                         "float64", 0), "phase 10b sphere2500",
                     dtype="float64"),
    ]
    kernels = [
        {"name": "tridiag_solve", "route": "cuda",
         "source": "mac_tpu_torch/csrc/tridiag.cu",
         "replaces": "mac_tpu/ops/pallas/tridiag_kernel.py:44",
         "shape": "(10000, 4)",
         "launches": mesh_launches["a"]["tridiag_solve"],
         "launches_path": "phase 9a (the mesh's banded V-cycle); on the "
                          "single-card banded routes, in GreedyEig's and in "
                          "every single-card ELL V-cycle, K1p (K1's body) "
                          "takes its place",
         "launches_city10000": tridiag_solve_launches_4,
         "shape_lanes": "(8, 10000, 4), a chain factor per lane",
         "ms_lanes": k1_lanes["device_ms"],
         "call_ms_lanes": k1_lanes["call_ms"],
         "plain_ms_lanes": k1_lanes["plain_ms"],
         "bound_ms_lanes": k1_lanes["bound_ms"],
         "max_abs_err_lanes": k1_lanes["max_abs_err"],
         "launches_mesh": mesh_launches["a"]["tridiag_solve"],
         "launches_sphere2500": sphere["tridiag_solve"],
         "launches_greedy_eig": eig_launches["tridiag_solve"],
         "shape_greedy_eig": k1_ge["shape"],
         "ms_greedy_eig": k1_ge["device_ms"],
         "call_ms_greedy_eig": k1_ge["call_ms"],
         "plain_ms_greedy_eig": k1_ge["plain_ms"],
         "bound_ms_greedy_eig": k1_ge["bound_ms"],
         "max_abs_err_greedy_eig": k1_ge["max_abs_err"],
         "max_abs_err": k1_err, "ms": k1_dev,
         "device_ms": k1_dev,
         "call_ms": k1_call, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        k2_entry("K2b", "mac_tpu/ops/pallas/assemble_kernel.py:61",
                 "city10000 tables (du_dense 5, ov 5)", k2b_tm,
                 (launches["assemble_ut"], 0),
                 mesh_launches["a"]["assemble_ut"]),
        k2_entry("K2", "mac_tpu/ops/pallas/assemble_kernel.py:49",
                 f"sphere2500 tables (nb {bop_sp.nb}, half {bop_sp.half}, "
                 f"du_dense {bop_sp.du_dense}, no split)", k2_tm,
                 (sphere["assemble_ut"], sphere["assemble_ut"]),
                 mesh_launches["b"]["assemble_ut"]),
        {"name": "tridiag_solve_blocked", "route": "cuda",
         "source": "mac_tpu_torch/csrc/tridiag.cu",
         "replaces": "mac_tpu/ops/pallas/tridiag_kernel.py:107",
         "shape": f"({SCALE_N}, 4)",
         "launches": sum(got["tridiag_solve_blocked"]
                         for got in mesh_launches["c"].values()),
         "launches_path": "phase 9c (the mesh's ELL V-cycle, row and edge "
                          "shards); phase 5's V-cycle runs K1p's segment "
                          "body (K1b's solve) in its place",
         "launches_phase5": launches5["tridiag_solve_blocked"],
         "launches_mesh": sum(got["tridiag_solve_blocked"]
                              for got in mesh_launches["c"].values()),
         "launches_sphere2500": sphere["tridiag_solve_blocked"],
         "max_abs_err": k1b_err, "ms": k1b_dev, "device_ms": k1b_dev,
         "call_ms": k1b_call, "plain_ms": k1b_plain_ms,
         "bound_ms": k1b_bound, "bound_by": k1b_by, "library_ms": None},
        lane_entry("assemble_ut", "mac_tpu/ops/pallas/assemble_kernel.py:61",
                   "(8, ...) city10000 tables (K2b form)",
                   dict(k2b8_tm, max_abs_err=k2_err["K2b_lanes"]),
                   lanes_a["assemble_ut"].get(8, 0), "phase 8a"),
        lane_entry("assemble_ut", "mac_tpu/ops/pallas/assemble_kernel.py:49",
                   "(2, ...) sphere2500 tables (K2 form, no split)",
                   dict(k2sp2_tm, max_abs_err=k2_err["K2_lanes"]),
                   lanes_d["assemble_ut"].get(2, 0), "phase 8d"),
        lane_entry("tridiag_solve_blocked",
                   "mac_tpu/ops/pallas/tridiag_kernel.py:107",
                   f"(2, {SCALE_N}, 4), a chain factor per lane", k1b_lanes,
                   lanes_b["tridiag_solve_blocked"].get(2, 0),
                   "phase 8b: none (its V-cycle runs K1p's segment "
                   "body on the 2 lanes)"),
    ] + f64_kernels + factor_kernels + [
        k4_entry(f"({k_}, {k_})", dt_, tm, k4_launches[dt_],
                 "phase 4 city10000, every shape" if dt_ == "float32" else
                 f"phase 5 n = {SCALE_N}, every shape",
                 f"mac_tpu/ops/lobpcg.py:{354 if k_ == 4 else 443}")
        for (k_, dt_), tm in sorted(k4_tm.items(),
                                    key=lambda kv: (kv[0][1], kv[0][0]))] + [
        k4_entry("(8, 12, 12), a TRACEMIN lane each", "float32",
                 k4_lane_tm[8], lanes_a["sym_eig"].get(8, 0), "phase 8a",
                 "mac_tpu/ops/lobpcg.py:443 (under vmap)"),
        k4_entry("(64, 12, 12), a trial lane each", "float64",
                 k4_lane_tm[64],
                 eig_launches["sym_eig_by_lanes"].get(64, 0),
                 "phase 7c (GreedyEig intel, subset(8))",
                 "mac_tpu/ops/lobpcg.py:443 (under vmap)")] + k4w_kernels
    # K5, K6, K1p and K7 (phase 3f): "launches" those of the wrapper on the
    # path "launches_path" names (every shape of a wrapper on it): phase 4's
    # four city10000 solves (float32), phase 10b's banded float64 solves,
    # phase 8a's sweep (8 lanes), phase 6's four sphere2500 solves, phase
    # 4b's three warm city10000 solves at q = 11 (K5's (10000, 11) and
    # (10000, 33)).
    def cg_entry(key, count, path):
        tm = cg_tm[key]
        extra = {} if tm.get("body") is None else {"body": tm["body"]}
        if "floor_ms" in tm:
            extra["floor_ms"] = tm["floor_ms"]
        return {"name": tm["name"], "route": "cuda", "source": tm["source"],
                "replaces": tm["replaces"], "shape": tm["shape"], **extra,
                "launches": count, "launches_path": path,
                "max_abs_err": tm["max_abs_err"], "rel_err": tm["rel_err"],
                "ms": tm["device_ms"], "device_ms": tm["device_ms"],
                "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "library_ms": tm["library_ms"]}

    def f64_of(kern):
        return sum(launches_10b[nm][kern].get("float64", 0)
                   for nm in ("city10000", "sphere2500"))

    p4, p10 = "phase 4 city10000", "phase 10b banded float64"
    # The matrix-free route's cases (K8, and K1p and K7 in its V-cycle):
    # their launches on the path that runs that shape.
    p5 = f"phase 5 n = {SCALE_N} (2 solves and evaluate_objective)"
    p7 = "phase 7c (GreedyEig intel, subset(8))"
    ell_paths = {}
    for kern, tag in (("ell_product", "K8"),
                      ("tridiag_solve_permuted", "K1p"),
                      ("tridiag_solve_permuted", "K1p_add"),
                      ("coarse_correct", "K7")):
        t = tag + ("" if tag.startswith("K8") else "_ell")
        ell_paths[t] = (launches5[kern], p5)
        ell_paths[t + "_f64"] = (launches_10f[kern].get("float64", 0),
                                 "phase 10f n = 100000 float64")
        ell_paths[t + "_lanes"] = (lanes_b[kern].get(2, 0),
                                   "phase 8b (2 lanes)")
        ell_paths[t + "_ge"] = (eig_launches[kern], p7)
    for t in ("K8_residual", "K8_plain", "K8_12"):
        ell_paths[t] = ell_paths["K8"]
    ell_paths["K8_f64_plain"] = ell_paths["K8_f64"]
    cg_line = []
    for key in sorted(cg_tm):
        kern = cg_tm[key]["name"]
        body = cg_tm[key].get("body")
        if key in ell_paths:
            count, path = ell_paths[key]
            if body is not None:
                path += f" ({body} body)"
            cg_line.append(cg_entry(key, count, path))
        elif body is not None and not key.endswith(("_f64", "_lanes")):
            # K1p: its body's launches on the path that runs it.
            path = "phase 4" if body == "segment" else "phase 6 sphere2500"
            cg_line.append(cg_entry(key, k1p_bodies[path].get(body, 0),
                                    f"{path} ({body} body)"))
        elif body is not None and key.endswith("_f64"):
            cg_line.append(cg_entry(
                key, launches_10b["city10000"][kern].get("float64", 0),
                "phase 10b banded float64 city10000 (segment body)"))
        elif key.endswith("_f64") or key.endswith("_f64_plain"):
            cg_line.append(cg_entry(key, f64_of(kern), p10))
        elif key.endswith("_lanes"):
            cg_line.append(cg_entry(key, lanes_a[kern].get(8, 0),
                                    "phase 8a (8 lanes)"))
        elif key.endswith("_sphere"):
            cg_line.append(cg_entry(key, sphere[kern], "phase 6 sphere2500"))
        elif key in ("K5_11", "K5_33"):
            cg_line.append(cg_entry(
                key, k4w_launches["city10000 launches"][kern],
                "phase 4b city10000 q = 11 (3 warm solves)"))
        else:
            cg_line.append(cg_entry(key, launches[kern], p4))
    kernels += cg_line
    # K9 and K10 (phase 3f): one entry per shape and dtype, "launches" those
    # of its dtype on the path that runs that shape: phase 4's four
    # city10000 solves (float32, m 10688), phase 5's two n = 100000 solves
    # (float32, m 50000), phase 10's float64 solves (10b's city10000 and
    # sphere2500, 10f's n = 100000; m 10688 is city10000's). "max_abs_err"
    # K9's 0 (bitwise), K10's largest |u - u_plain| or |norm - norm_plain|
    # (x, xavg, w bitwise); K9's "library_ms" torch.topk with scatter_.
    fw_paths = {"city float32": ("phase 4", "phase 4 city10000 (4 solves)"),
                "scale float32": ("phase 5", f"phase 5 n = {SCALE_N} "
                                             f"(2 solves)"),
                "city float64": ("phase 10", "phase 10 float64 solves (10b, "
                                             "10f)")}
    for key_, tm in sorted(fw_tm.items()):
        short_, tag_ = key_.split(" ", 1)
        kern = "fw_oracle" if short_ == "K9" else "fw_update"
        path_, text_ = fw_paths[tag_]
        kernels.append({
            "name": kern, "route": "cuda",
            "source": "mac_tpu_torch/csrc/fw.cu",
            "replaces": ("mac_tpu/solvers/mac.py:1468 (the supergradient) "
                         "and mac_tpu/optimization/constraints.py:20 "
                         "(lax.top_k); not Pallas" if short_ == "K9" else
                         "mac_tpu/optimization/frankwolfe.py:97 (the loop "
                         "body) and mac_tpu/solvers/mac.py:958 (the "
                         "weights); not Pallas"),
            "shape": tm["shape"], "dtype": tm["dtype"],
            "launches": fw_launches[path_][kern].get(tm["dtype"], 0),
            "launches_path": text_, "max_abs_err": tm["max_abs_err"],
            "ms": tm["device_ms"], "device_ms": tm["device_ms"],
            "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
