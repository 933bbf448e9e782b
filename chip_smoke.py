#!/usr/bin/env python3
"""Drive the PyTorch port (``spark_gp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the exit
code is non-zero and the final ``ok`` line is never printed:

1. env      -- Python, torch and CUDA versions; the card's name and power
               limit as ``nvidia-smi`` reports them.
2. build    -- compile every CUDA kernel from ``csrc/``, and the first
               designs of K1, K2-VJP and the SLQ quadrature from
               ``csrc/dev/``, one nvcc per source, all started together.
3. check    -- each kernel against its plain PyTorch version (float64 on
               the same inputs upcast).  K1: on random batches at the main
               path's shapes and more (ragged panels, the workspace path
               at n = 129 .. 512), on the gram stacks the exact lane
               hands it (the first airfoil fold's at expert 100 and 450,
               the protein split's at expert 100 and 400), NaN isolation
               of a non-PD matrix and the backward, each at n = 100 and
               on the workspace path; the Synthetics and timeseries
               stacks (18, 100), (20, 100), (2, 120) and the LOO
               objective's cotangent through K1's VJP at (18, 100); EP's
               B stack (7, 20), the Poisson config's (20, 100) and the
               greedy-scale gram stack (400, 100); the clustered and
               heteroscedastic aggregation fits' gram stacks (64, 64),
               (32, 64) and the health probe's one-expert stack (1, 97).
               K2 and K2-VJP: all seven tile transforms on the protein-matfree
               row stack (9, 4065, 9) at the path's widths n = 1, 8, 9,
               on a ragged (3, 1000, 5) stack at n = 1, 4, on (2, 777, 21)
               at n = 9 (two feature chunks) and on (2, 130, 20) at n = 17
               (right-hand sides in chunks); two VJP calls on the same
               inputs must give bit-identical gradients.
    gpc-check -- K1 against its plain version on the classifiers'
               B = I + W^1/2 K W^1/2 stacks at the converged Laplace mode
               (init theta): the MNIST training stack (16, 100), the
               first iris fold's first one-vs-rest problem (7, 20) and
               the same fold's multiclass B_c stack (E * C = 21, 20).
4. time     -- each kernel, its plain version and the library call at the
               main path's shapes, with the bound from the card's peaks;
               K1 also at (2, 256) and (1, 512), and its first design in
               turns with it at all six of its shapes; K2-VJP's first
               design in turns with it at n = 8 and n = 1; K1 also at the
               classifier's B stacks.
5. parity   -- the exact-lane objective and gradient on the card (float32,
               through K1) against the CPU (float64, Cholesky) on the
               first airfoil fold's stack.
6. airfoil  -- the reference's acceptance config, 10-fold CV; RMSE < 2.1.
7. airfoil-expert450 -- the airfoil config at expert 450 (E = 3,
               s = 451: K1's workspace path), 10-fold CV; RMSE < 2.1; one
               evaluation profiled for K1's share; one fold again with
               K1's first design.
8. protein  -- the CASP config at full size (stand-in data, E = 366).
9. profile  -- one protein objective evaluation under torch.profiler:
               wall ms, device-busy ms and share, the top kernels, K1's
               device ms and share; and the host magic solve's share of
               the PPA build.
10. matfree-parity -- the matrix-free objective and gradient at init theta
               on the protein-matfree stack (E = 9, s = 4065): on the card
               (K2) against the iterative lane on the card (materialized
               gram) and against the CPU in float64, the same probes;
               and, with no bar, the same engine fed float64 products.
11. protein-matfree -- the fit on the matrix-free lane: phase seconds,
               launches (asserted against nfev), solver metrics, RMSE;
               the peak memory of one objective evaluation beside the
               iterative lane's; the same config fitted on the iterative
               and exact lanes.
    vjp-witness -- the matfree fit again with K2-VJP's first design in
               place of its kernel (K2 unchanged), and, with no bar, the
               objective's gradient at init theta, midway, and at both
               fits' theta through K2-VJP, its first design and the plain
               VJP in float64, on the same probes.
12. matfree-profile -- one matrix-free evaluation under torch.profiler.
13. gpc-parity -- the Laplace objective and gradient on the card
               (float32, K1) against the CPU (float64, Cholesky) on the
               MNIST training stack at init theta, 0.7x and 1.3x; the
               float32 gram's error at p = 784; Newton iterations each side.
14. gpc-mnist -- examples/mnist.py's config (784 features, RBF(10), expert
               100, active 100, tol 1e-3) on the MNIST stand-in, 80/20 at
               seed 13: accuracy above quality.py's bar, phase seconds,
               Newton iterations and objective calls, K1 launches (asserted
               equal to their sum); the same fit on the CPU; one evaluation
               at the fitted theta under torch.profiler.
15. gpc-mnist-iterative -- the same fit on the iterative lane: no K1 launch.
16. iris-ovr -- examples/iris.py's one-vs-rest 10-fold CV (30 binary fits
               at E = 7, s = 20): accuracy >= 0.9, K1 launches, and the
               same CV on the CPU.
17. gpc-mc-parity -- the multiclass objective and gradient on the card
               (float32, K1 for every B_c stack) against the CPU (float64)
               on the first iris fold at two theta; the Newton iterations
               agree.
18. iris-native -- examples/iris.py --native (make_native_gpc): the
               multiclass softmax-Laplace classifier, 10-fold CV at seed
               13: accuracy > 0.9 and within 0.02 of the JAX package's,
               K1 launches = Newton iterations + 2 x objective calls, the
               gram cache engaged; the same CV on the CPU; one evaluation
               under torch.profiler.
19. iris-native-iterative -- the same CV on the iterative lane: no K1
               launch, accuracy within 0.04 of the JAX package's there.
20. gram-cache -- the cached RBF gram against the uncached one on the card
               at the gpc-mnist (16, 100, 784) and iris (7, 20, 4) stacks;
               gram_cache_engaged 1 on gpc-mnist, iris-ovr and
               iris-native, 0 on airfoil, airfoil-expert450, protein and
               protein-matfree (ARD, or the matfree lane); one gpc-mnist
               evaluation at the fitted theta with the cache and with
               GP_GRAM_CACHE=0, in turns, under torch.profiler.
21. synthetics -- examples/synthetics.py verbatim (Synthetics.scala:
               k-means active set, 2000 x 1), 10-fold CV at seed 13
               (E = 18, s = 100): RMSE < 0.11, K1 launches = evaluations,
               the gram cache engaged.
22. synthetics-objectives -- quality.py's objectives part: the same config
               fitted with the marginal, LOO and ELBO objectives on the
               1500 / 500 split: each RMSE < 0.11, NLPD, K1 launches =
               evaluations (marginal, LOO) and 0 (ELBO), the gram cache
               engaged except for the ELBO.
23. synthetics-loo -- a fit on all 2000 rows, then gp.loo: LOO RMSE < 0.11
               and within (0.5, 2) of the CV RMSE, one K1 launch at (20, 100).
24. objective-parity -- the LOO and ELBO objectives and gradients on the
               card (float32) against the CPU (float64) at init theta and
               theta*; one evaluation of each under torch.profiler.
25. timeseries-sm -- examples/timeseries.py make_gp("sm", 8) verbatim
               (E = 2, s = 120, eight host restarts): extrapolation RMSE
               < 0.1, every restart's NLL, K1 launches = the restarts'
               evaluations; the RBF contrast with no bar.
26. kernel-families -- the ARD Matern, ARD-RQ, periodic and spectral
               mixture kernels and two products: gram, cross, NLL and
               gradient on the card against the CPU at (4, 100, 5).
27. regression-phases -- the seconds of phases 21-26.
28. greedy-vs-random -- quality.py's part verbatim: the greedy (Seeger)
               provider against random at seeds 13, 17, 29 on density-
               skewed 1-d data (E = 20, s = 100, m = 24): greedy RMSE
               < 0.05 and below the best random; K1 launches = evaluations.
29. greedy-scale -- quality.py's part verbatim on the Year-MSD stand-in
               (40,000 x 90 training rows, E = 400, s = 100, m = 512):
               greedy and random RMSE within 0.02 of the JAX package's,
               fit and selection seconds; K1 launches = evaluations.
30. joint-posterior -- the Synthetics config on the 1500 / 500 split:
               predict_with_cov's diagonal against predict_with_var,
               20,000 posterior draws against the covariance, update with
               the 500 rows against the statistics of all 2000.
31. iris-ep -- examples/iris.py --ep verbatim (one-vs-rest EP, E = 7,
               s = 20), 10-fold CV on the card and the CPU: accuracy > 0.9,
               K1 launches = sweeps + evaluations + fits.
32-34. poisson, poisson-nb, poisson-iterative -- quality.py's poisson
               part verbatim (E = 20, s = 100): rate error < 0.1 / 0.15 /
               0.1, K1 launches = Newton iterations + 2 x evaluations (0 on
               the iterative lane); the exact-lane fits again on the CPU.
35. new-objective-parity -- EP's and the Poisson objective's value and
               gradient at init theta and theta*: K1 against the Cholesky
               route on the card, and the card against the CPU.
36. slice6-phases -- the seconds of phases 28-35.
37. aggregation -- quality.py's aggregation part through the port: the
               clustered stand-in (4096 + 1024 rows, E = 64, s = 64,
               ARD-RBF + white noise, active 256, 15 iterations) scored
               under poe, gpoe, rbcm and healed, the heteroscedastic ramp
               (2048 training rows) under poe and healed; every bar of
               quality.py; K1 launches = the two fits' evaluations.
38. poe-parity -- the five PoE modes on the card (float32) against the CPU
               (float64) at the clustered fit's theta: the largest mean and
               relative variance errors (recorded, no bar).
39. selection -- GP_AGG_SELECT=1 on pairwise-duplicated rows (E = 12):
               at least a quarter dropped, renorm 2, held-out NLPD within
               1% of the fit without selection.
40. quarantine -- the first airfoil fold at expert 100 with a NaN expert
               (the data screen) and a 1e300-scaled one (inf in float32:
               the recovery ladder on the card): exactly those two
               quarantined, one retry, RMSE within 5% of the clean fit on
               the kept rows (and the full clean fit's recorded); K1
               launches = 1 + E + (rungs - 1) x unhealthy experts + the
               retry's evaluations.
41. weighted-matfree -- the marginal objective with per-expert weights and
               jitter on the matrix-free lane (K2, K2-VJP) against the
               iterative lane on the card, protein-matfree stack, same
               probes: 1e-5 / 1e-5.
42. slice7-phases -- the seconds of phases 37-41.
43. obs     -- the airfoil config's first fold (E = 14, s = 97) through the
               observability shell: the span tree (root
               fit.GaussianProcessRegression, the JAX package's phase
               names under it), the journal's K1 launches = nfev = the
               wrapper's count, the peak gauge = max_memory_allocated over
               the fit, the OpenMetrics page parsed; the tracing overhead
               over 5 interleaved pairs (GP_TRACING=0 and on, each side the
               median of 7 fits): the median under 5%.
44. profile -- the same fold with setProfileDir: the Chrome trace's K1
               kernel events, one a call (n <= 128), nfev of them.
45. ladder-oom -- the protein-matfree config (maxiter 5) on the exact lane
               under a per-process memory fraction that holds a matrix-free
               evaluation and not the 595 MB gram stack: real allocator
               OOMs, native -> iterative -> matfree; K2 = nfev (iters + 2)
               + the solver report's iters, K2-VJP = 2 nfev; RMSE within 2%
               of protein-matfree's.
46. memplan -- under the same fraction the auto lane resolves matfree from
               the card's budget (no OOM, no transition), iterative at
               fraction 1.0; one evaluation's predicted peak within 1-4x
               of its measured peak on each lane at (9, 4065, 9) and
               (14, 97, 5).
47. predict-ladder -- the obs fold's model predicts all 1503 rows with
               every chunk above 128 rows failing: four halvings to 93
               rows, results within 1e-6 of the clean predict, no host rung.
48. terminal -- every fit.host dispatch failing: one
               DegradationExhaustedError of class oom and one incident
               bundle with the failing span tree, for the airfoil config
               (rungs native -> iterative -> host_f64: ARD does not stream)
               and the same fold under the isotropic RBF (every rung).
49. slice8-phases -- the seconds of phases 43-48.
50. persist -- the airfoil config on all 1503 rows (m = 1000), saved in the
               JAX package's format and loaded on the card: the loaded
               model's predictions bit-equal to the fitted one's; K1
               launches = evaluations.
51. checkpoint -- the first airfoil fold with setCheckpointDir, preempted
               after 3 checkpoint saves (chaos.preempt_after_saves) and
               refitted: the resumed theta within 1e-3 relative of the
               uninterrupted fit's; K1 launches = both legs' evaluations.
52. serve   -- the persisted model behind GPServeServer on the card,
               buckets 8 .. 256: one CUDA graph a bucket at warmup and none
               after; per bucket the eager predict block, the graph replay
               and the whole dispatch (medians of 50); a closed loop of 8
               clients x 250 requests of 1 .. 300 rows: requests/s, rows/s,
               p50 / p99 latency, mean batch rows, zero errors, every
               answer within 1e-5 of predict_with_var (mean relative to
               max |mean|, variance to the prior variance).
53. serve-cli -- python -m spark_gp_tpu_torch.serve on the card: the ready
               line, 100 predicts, health ok, metrics, then SIGTERM: the
               drained shutdown line and exit 0.
54. serve-hang -- a second model wedged (chaos.hang_model): the watchdog
               fails its batch with exec.hung and trips its breaker while
               the first model keeps answering.
55. slice9-phases -- the seconds of phases 50-54.
56. device-opt-check -- the first airfoil fold (14, 97) fitted with
               setOptimizer("device")'s loop replayed from its captured
               CUDA graph and run eagerly on the card: theta, f, n_iter and
               n_fev equal; captures, replays, masked evaluations, host
               syncs, capture seconds; the step's graph nodes beside the
               evaluation's alone and the ms of a replay of each.
57. airfoil-device -- phase 6's 10-fold CV on the device optimizer: RMSE
               < 2.1; per fold nfev and optimize seconds beside phase 6's;
               K1 launches = replays + initial evaluations.
58. synthetics-device -- phase 21's CV and phase 22's three held-out fits
               on the device optimizer: each RMSE < 0.11; K1 launches =
               replays + initial evaluations (marginal, LOO), 0 (ELBO).
59. protein-device -- phase 8's config (366, 100) on the device optimizer:
               RMSE within 2% of phase 8's; per-evaluation wall beside the
               host fit's and the step's device ms a replay.
60. timeseries-sm-device -- phase 27's config with its 8 restarts in one
               batched loop: extrapolation RMSE < 0.1, every restart's NLL
               and the winner, one K1 launch (over 16 matrices) a replay.
61. checkpoint-device -- the first airfoil fold on the device optimizer
               with setCheckpointDir and setCheckpointInterval(5),
               preempted after 2 saves and resumed: theta bit-equal to the
               uninterrupted segmented fit's; K1 launches = both legs'
               replays + their first evaluations.
62. segmented-rung -- an OOM staged at the one-shot device fit's choke
               point: native -> iterative -> segmented (the solver rungs
               apply to a device fit and fail at the same choke point; the
               ARD kernel does not stream); theta within 1e-5 relative of
               the clean device fit's.
63. slice10-phases -- the seconds of phases 56-62.
64. gpc-device-check -- gpc-mnist's training stack (16, 100) fitted by
               laplace.fit_gpc_device, its loop replayed from the captured
               graph and run eagerly: theta, latent modes, f, n_iter,
               n_fev, and the device-counted Newton iterations and
               gradient passes equal; K1 launches on the step's rule
               (every replay runs its 3 Newton iterations and its pass:
               torch 2.11 has no conditional graph node); the step's
               graph nodes and replay ms beside one trial's alone.
65. gpc-mnist-device -- phase 14 on the device optimizer: accuracy > 0.84.
66. iris-ovr-device -- phase 16 on the device optimizer (30 fits): >= 0.9.
67. iris-native-device -- phase 18 on the device optimizer: > 0.9 and
               within 0.02 of the JAX package's.
68. poisson-device, nb-device -- phases 38-39 on the device optimizer:
               rate errors < 0.1 / < 0.15.
69. multistart -- iris-native's first fold with 4 restarts in one loop:
               one K1 launch over all lanes' 84 B_c matrices a Newton
               iteration; the winner is the lowest restart NLL.
70. checkpoint-device-gpc -- iris versicolor-vs-rest on the first fold,
               segments of one iteration, preempted after 2 saves and
               resumed: theta bit-equal to the uninterrupted fit's.
71. segmented-rung-gpc -- the same fit under an OOM staged at the
               one-shot device fit's choke point: native -> iterative ->
               matfree -> segmented.
72. laplace-device-table -- the host-against-device table of gpc-mnist,
               iris-ovr, iris-native, Poisson and NB.
73. slice11-phases -- the seconds of phases 64-72.  Every K1 launch in
               64-71 follows the step's rule (``latent_k1_rule``).
74. slq-quadrature -- the SLQ quadrature kernel (csrc/slq_quadrature.cu)
               against its plain version (float64 eigh of the same
               float32 tridiagonals) on the main path's Lanczos matrices:
               protein-matfree (9, 8, 64) and the B systems of gpc-mnist
               (16, 8, 64), Poisson (20, 8, 64) and the iris fold (7, 8,
               20); its device ms and its first design's in turns, beside
               the eigh route's; its bound from this run's QL rotations of
               the first design; both work counts; then protein-matfree at
               t = 100, T over the workspace (t = 1100) and the QL route
               (a stack below the clamp), each at the bar.
75. device-opt-check-matfree -- protein-matfree's device fit at maxiter 3,
               replayed from its graph and run eagerly: theta, f, n_iter,
               n_fev equal; K2 = evaluations x (iters + 2), K2-VJP = 2 x
               evaluations, one quadrature an evaluation; the graph fit's
               peak CUDA memory under a quarter of the gram stack; the
               step's graph nodes and replay ms beside the evaluation's.
76. protein-matfree-device -- the protein-matfree config on the device
               optimizer: RMSE within 2% of phase 11's; launches on the
               rules (the solver report's iters K2 and one quadrature).
77. protein-iterative-device -- the same on the iterative lane.
78. memplan-device -- one device step's measured peak on each CG lane
               (protein-matfree's stack; gpc-mnist's binary step on the
               iterative lane) within 1-4x of the planner's prediction.
79. gpc-mnist-iterative-device -- phase 15 on the device optimizer:
               accuracy > 0.84, no K1, one quadrature kernel launch a
               gradient pass and one for the solver report.
80. iris-native-iterative-device -- phase 19 on the device optimizer:
               > 0.9 and within 0.04 of the JAX package's.
81. poisson-iterative-device -- phase 34 on the device optimizer at
               maxiter 3 (25 took 133 evaluations): rate error < 0.1.
82. ep-device-check -- the first iris fold's first one-vs-rest EP problem
               (7, 20) by ep.fit_gpc_ep_device, replayed and eager: theta,
               sites, latent mean, f, n_iter, n_fev and sweeps equal; K1 =
               (replays + eager steps) x (8 sweeps + 1) + the eager
               evaluations' sweeps + 1 each + 1 (the posterior mean).
83. iris-ep-device -- phase 31 on the device optimizer: > 0.9.
84. iris-ep-multistart -- the same with 4 restarts a loop: > 0.9.
85. ladder-oom-device -- phase 45's config as a device fit under the same
               memory fraction: native -> iterative -> matfree, each a real
               OOM; RMSE within 2% of protein-matfree's; K2, K2-VJP and
               the quadrature on their rules.
86. cg-device-table -- host against device for the new configs.
87. slice12-phases -- the seconds of phases 74-86.
88. lane-gram-check -- the lane kernel (csrc/lane_gram.cu) against its
               plain version on the card in both modes (3xTF32, TF32) on
               the first airfoil fold ARD-scaled (14, 97, 5) as a
               self-gram (diagonal exactly 0) and as distances, protein
               (366, 100, 9), the first Synthetics fold (18, 100, 1) and
               the periodic feature map's inner products, within 1e-5 of
               max|x1|^2 + max|x2|^2.
89. lane-gram-time -- its device ms in both modes, the plain version's,
               the library's TF32 matmul distances and the bound.
90. large-m -- benchmarks/large_m.py's config (120,000 x 3, E = 1200,
               m = 4096): RMSE < 0.15, one device magic solve, handed the
               statistics on the card, and no transition, K1 launches =
               nfev, kmn_stats / magic_solve
               seconds, predict rows/s; the mean-only model's mean
               bit-equal and K_mm never factored; device against host on
               the fit's (U1, u2): residuals, predictive mean and variance
               (MAGIC_SOLVE_BARS).
91. large-m-crossover -- device against host solve seconds at m = 1000,
               2048 (seeded statistics) and 4096 (the fit's), in turns.
92. large-m-oom -- an OOM staged at ppa.magic_solve: one ppa transition
               device_solve -> host_solve, the host solve's answer within
               MAGIC_SOLVE_BARS (a repeated host solve recorded beside
               it: the host BLAS need not repeat its rounding).
93-94. lanes-airfoil, lanes-synthetics -- the 10-fold CVs at the mixed
               lane (airfoil < 2.1, Synthetics < 0.11, no guard breach)
               and the fast lane (recorded); lane kernel launches =
               evaluations + folds (airfoil, ARD: a gram an evaluation)
               or 2 a fold (Synthetics, RBF: the gram cache and the
               guard's probe); K1 = evaluations (the guard's probe
               takes float64 linear algebra); beside them the strict
               lane's own float32 error on the probe expert.
95. lanes-device -- the first airfoil fold's device fit at mixed, the
               lane kernel inside the captured step: RMSE < 2.1.
96. lanes-breach -- the mixed bar forced below 0 under
               GP_GUARD_ACTION=degrade: one native -> strict_lane
               transition, theta within 1e-6 of the strict fit's.
97. lanes-breach-log -- the same under the default (log): breach 1, no
               transition.
98. lanes-k1 -- K1 at mixed bit-equal to strict.
99. slice14-phases -- the seconds of phases 88-98.
100. cost   -- cost attribution (``obs/cost.py``) with metering on: the
               first airfoil fold on the host optimizer in turns
               (unmetered, metered, metered, unmetered), a protein-matfree
               fit at maxiter 2, the fold's device fit and the gpc-mnist
               host fit, each bit-equal in theta (and RMSE or accuracy) to
               the same fit unmetered; each fit's executions equal its
               evaluations (objective calls; replays and eager steps for
               the device fit, and its initial evaluation, whose metered
               peak the memory plan compares without a
               ``plan.margin_breach``), and each kernel's metered work equals its
               work model times its launches in that entry; a 1503-row
               predict_with_var in 501-row chunks is one execution a chunk,
               100 serve requests one a bucket batch; ``xla_cost`` names the
               card, the peak and the power limit.  Recorded: the metering
               overhead of one evaluation (first signature, steady), the
               metered peak against the planner's prediction.
101. expert-quality -- the fit-time probe (``quarantine.expert_nll``) on
               the first airfoil fold on the card against the CPU in
               float64 at init theta (1e-4 of max(1, |nll|)), and at the
               fit's theta recorded beside the share of the probe's own
               float32 algebra (the float32 gram's rounding dominates
               there); one K1 launch a probe and the fit's journal equal
               to it within the bar; on the
               protein-matfree stack no [E, s, s] (peak under the matfree
               bar), K2 and the quadrature only.  Recorded: its ms at
               protein (366, 100) and large-m (1200, 100).
102. quality -- the persisted airfoil model (m = 1000) behind the server,
               the plane on: a stream whose labels follow the served
               distribution never alerts within 512 observations;
               chaos.miscalibrate(0.5) and chaos.drift_inputs(4 std(x))
               alert within 512; a canary under quality_guard rolls back
               under an active alert; the CLI's observe (serve-cli)
               joined.  Recorded: z statistics and coverage, the model's
               own labels' calibration, closed-loop requests/s with the
               plane on and off in turns against the JAX package's 2%.
103. slice15-phases -- the seconds of phases 100-102.
104. mesh-nccl1 -- the sharded fit over a process group of one rank
               under NCCL, in a child process
               (``spark_gp_tpu_torch/dev/mesh_phases.py``): airfoil 10-fold
               with ``setMesh``, each fold's theta bit-equal to phase 6's
               unsharded fit; the first fold on the device optimizer,
               bit-equal to the unsharded device fit, its all-reduce
               inside the captured step; K1 = evaluations + probes (host),
               replays + 1 + probe (device).  Recorded: the all-reduce's ms
               at the step's and the host objective's payloads.  Slice 17:
               the device fits of gpc-mnist, iris-native (fold 0),
               Poisson and iris EP (fold 0, setosa against the rest) with
               setMesh, each bit-equal to its unsharded device fit, the
               step's all-reduce captured (1 to 16 graph nodes over the
               unsharded step's); the ELBO fit of the Synthetics split on
               both optimizers and the selection config under
               GP_AGG_SELECT=1, bit-equal; each pair's K1 on its rule.
105. mesh-gloo2 -- two ranks over gloo on the one card, in two child
               processes started with mesh-nccl1's: the first evaluation
               within 1e-5 / 1e-4 of the unsharded one; airfoil 10-fold
               sharded 7 + 7, RMSE < 2.1 and within 1% of phase 6's;
               gpc-mnist's fit_distributed, each rank its block of the
               training stack (8 + 8 experts), accuracy > 0.84;
               distribute_global_experts of 900 / 603 airfoil rows, its
               padded dims _pad_stack's and one active set on both ranks;
               each rank's K1 its own evaluations' (and Newton
               iterations') plus probes.  Recorded: the all-reduce's ms
               at the host objective's payload and at U1 (m = 1000).
               Slice 17: the ELBO's first evaluation within 1e-6 / 1e-7
               of the unsharded one and its host fit's RMSE within 1% of
               the unsharded fit's; the selection config's dropped set and
               weights the single-process selection's; the row-sharded
               magic solve at the large-m fit's theta and active set (m =
               4096, U1 and u2 from each rank's half of the rows) against
               the one-rank device solve at MAGIC_SOLVE_BARS (residuals,
               predictive mean and variance on 2,000 rows), its panel
               checks counted, and a staged corrupt_device(1) raising
               PanelMismatchError naming rank 1 on both ranks.  Recorded:
               the sharded and the device solve's seconds.  Slice 18 (the
               coordination plane): fold 0 in the key-value-store mode
               (GP_DCN_MODE=1, no gloo collective), theta bit-equal on
               both ranks, RMSE < 2.1 and within 1e-6 of the gloo fold,
               K1 once an evaluation; the same fold with every evaluation
               audited (GP_INTEGRITY_DUPCHECK_P=1), every audit passing,
               its rung and K1 (one more a rank an audit, and one on its
               target) recorded; corrupt_host(1, "bitflip", op="vag")
               raising AttestationError naming rank 1 on both ranks; a
               coordinated host checkpoint with a preemption staged on
               rank 1 stopping both ranks at the same save, the resume at
               the fold's theta; last, rank 1 dead before a guarded step
               (exit 137) and rank 0 naming it within 8 s at
               GP_COORD_TIMEOUT_S=5.  Then this process resumes fold 0
               alone from the two-rank checkpoint the preemption left
               (iteration 1): one elastic resume, the logged evaluations
               replayed and the rest run live, RMSE < 2.1 and within 1%
               of the two-rank fit's, final NLL within 1e-4 relative of
               it (theta's distance recorded: a one-process float32
               continuation takes another path).  Recorded: the
               store round trip of one evaluation's payload (ms).
               mesh-nccl1 also runs fold 0's device fit with
               setCheckpointDir under the mesh, bit-equal to the same
               segmented fit without it, its all-reduce captured, and a
               staged preemption plus resume at the same theta.
106. launch-totals -- each kernel's launches beside the totals this
               script counted before the expert-quality probe and slice 15
               (``LAUNCH_TOTALS_BEFORE``), and the probes' share.
107. kernels -- one line with every kernel's numbers, the mesh phases'
               children's launches among them (``launches_mesh_*``).
The last line is ``{"ok": true, "device": {...}}``.

Every fit an estimator makes runs the fit-time expert-quality probe after
its PPA build: one batched pass over the stack with no gradient (one K1
launch on the exact lane; the CG engine's K2 and quadrature launches on
the CG lanes; a lane-gram launch at a non-strict lane).  Every launch rule
above states it as a term of its own: the fits' stamps
(``expert_quality.probe_launches.<kernel>``, :func:`probe_rule`) or their
sum since the wrapper's counter was zeroed (:func:`probes`).  Every phase line
carries ``fallback_transitions``, the ladder's transitions since the line
before it; a phase that stages no fault fails if it moved them.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the seven tile transforms of K2 with the parameters they are checked at
MATFREE_FAMILIES = {
    "rbf": [1.0], "matern12": [0.8], "matern32": [0.8], "matern52": [0.8],
    "rq": [0.9, 1.3], "dot": [0.5], "poly": [0.7],
}
POLY_DEGREE = 2

# kernel names as the profiler reports them (each with its squared-norm prologue)
K2_NAMES = {"streamed_matvec": ("streamed_matvec_kernel", "streamed_matvec_sqnorms_kernel"),
            "streamed_matvec_vjp": ("streamed_matvec_vjp_kernel",
                                    "streamed_matvec_vjp_sqnorms_kernel")}
# each K2-VJP instance in ptxas's "Compiling entry function" lines
VJP_PTXAS = (r"streamed_matvec_vjp_kernelILi(\d)ELi(\d+)EE", "F{0}/NB{1}")


# the first designs of K1, K2-VJP and the SLQ quadrature, sources under
# csrc/ built and timed beside the kernels
K1_FIRST_DESIGN = "dev/spd_inv_logdet_first"
VJP_FIRST_DESIGN = "dev/streamed_matvec_vjp_first"
SLQ_FIRST_DESIGN = "dev/slq_quadrature_first"

# host seconds per fit phase, as the estimator reports them
PHASES = ("group_seconds", "optimize_seconds", "ppa_seconds")
# a classifier fit's metrics that the classifier phases report
GPC_METRICS = ("num_experts", "expert_size", "lbfgs_nfev", "newton_iterations",
               "objective_calls") + PHASES
# the JAX package's accuracies on the same configs and data on the CPU
# (examples/mnist.py and examples/iris.py; iris-native from quality.py's
# iris_native_mc part, on the exact lane and with GP_SOLVER_LANE=iterative),
# for comparison
JAX_CPU_ACCURACY = {"gpc_mnist": 0.8725, "iris_ovr": 0.9333333333333333,
                    "iris_native": 0.9333333333333333,
                    "iris_native_iterative": 0.9333333333333333}
# quality.py's bars: the MNIST stand-in's (planted Bayes accuracy 0.970,
# less the healthy Laplace path's margin) and iris one-vs-rest's and
# native multiclass's
GPC_BARS = {"gpc_mnist": 0.84, "iris_ovr": 0.9, "iris_native": 0.9}
# how far the port's iris-native accuracy may sit from the JAX package's on
# the same folds: exact lane, iterative lane (SLQ probes, float32)
IRIS_NATIVE_SPREAD = {"exact": 0.02, "iterative": 0.04}


# the JAX package's numbers on the Synthetics and timeseries configs, on
# the CPU (QUALITY_r05.json: the loo, objectives and spectral_mixture
# parts), for comparison
JAX_CPU_REGRESSION = {
    "synthetics_cv_rmse": 0.09964753137871492,
    "loo_rmse": 0.1011248379945755, "loo_cv_ratio": 1.0148253207622977,
    "objectives": {"marginal": {"rmse": 0.09616492138033646, "nlpd": -0.9188056824936754,
                                "final_objective": -2570.724609375},
                   "loo": {"rmse": 0.09619868319016818, "nlpd": -0.9187437335545845,
                           "final_objective": -1292.34423828125},
                   "elbo": {"rmse": 0.09627648916225783, "nlpd": -0.9189714244803228,
                            "final_objective": -532.0234375}},
    "sm_extrapolation_rmse": 0.0091528613318421, "rbf_extrapolation_rmse": 0.8069934819636092,
}
# the reference's Synthetics bar (Synthetics.scala) and the timeseries
# example's extrapolation bar (examples/timeseries.py)
SYNTHETICS_BAR, TIMESERIES_BAR = 0.11, 0.1
# card (float32) against the CPU (float64) on an objective: PERF.md's
# regression bars (value; gradient over its largest component at init
# theta), the ELBO's too (its sums run in float64, the trace term as one
# residual a point: models/sgpr.py)
OBJECTIVE_BARS = {"loo": (1e-5, 1e-4), "elbo": (1e-5, 1e-4)}


# the phases that stage a fault; every other phase must leave the fit
# ladder's transition count where the phase before it left it
FAULT_PHASES = ("ladder-oom", "predict-ladder", "terminal", "segmented-rung",
                "segmented-rung-gpc", "ladder-oom-device", "large-m-oom", "lanes-breach")
_transitions_seen = [0.0]


def emit(obj) -> None:
    """Print one phase's JSON line, with the degradation-ladder
    transitions since the previous line (``fallback_transitions``); a
    phase that staged no fault and moved them fails."""
    if "phase" in obj:
        from spark_gp_tpu_torch.obs.runtime import telemetry

        now = telemetry.snapshot()["counters"].get("fallback.transitions", 0.0)
        moved, _transitions_seen[0] = now - _transitions_seen[0], now
        obj = {**obj, "fallback_transitions": moved}
        if moved and obj["phase"] not in FAULT_PHASES:
            print(json.dumps(obj), flush=True)
            raise AssertionError(f"{obj['phase']}: {moved} fallback transitions in a clean phase")
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    """The card's row of the port's peak table (``ops/precision.chip_peaks``:
    memory rate; float32, float64 and TF32 peaks; special-function rate)."""
    from spark_gp_tpu_torch.ops.precision import chip_peaks

    row = chip_peaks(name)
    if row is None:
        raise RuntimeError(f"no peak rates known for {name!r}")
    return row


def peaks_for(name: str):
    """``(bytes/s, float32 flop/s outside the tensor cores, special-function
    results/s)`` of the card."""
    row = card_peaks(name)
    return row.bytes_per_s, row.f32, row.sfu


#: the fit-time expert-quality probe's launches of each kernel when its
#: wrapper's counter was last zeroed (:func:`zero`)
PROBE_BASE: dict = {}


def zero(*wrappers):
    """Zero the wrappers' launch counters, and start each one's probe term
    (:func:`probes`) at the same point."""
    from spark_gp_tpu_torch.resilience.quarantine import PROBE_LAUNCHES

    for w in wrappers:
        w.launches = 0
        PROBE_BASE[w.__name__] = PROBE_LAUNCHES.get(w.__name__, 0.0)


def probes(wrapper) -> float:
    """The probe term of a launch rule: the launches of ``wrapper``'s kernel
    by the fits' expert-quality probes (one batched pass a fit, no
    gradient: one K1 launch on the exact lane, the CG engine's K2 and
    quadrature launches on the CG lanes, a lane-gram launch at a non-strict
    lane) since its counter was zeroed, from the stamps the fits leave
    (``expert_quality.probe_launches.<kernel>``, summed by the port in
    ``resilience/quarantine.PROBE_LAUNCHES``)."""
    from spark_gp_tpu_torch.resilience.quarantine import PROBE_LAUNCHES

    name = wrapper if isinstance(wrapper, str) else wrapper.__name__
    return PROBE_LAUNCHES.get(name, 0.0) - PROBE_BASE.get(name, 0.0)


def ptxas_usage(log: str, pattern: str, label: str) -> dict:
    """{instance: [registers, spill-store bytes]} of every kernel instance
    whose mangled name matches ``pattern`` in nvcc's ``-Xptxas -v`` log;
    ``label`` formats the pattern's groups."""
    import re

    usage, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(pattern, line)
            entry = label.format(*m.groups()) if m else None
            if entry:
                usage[entry] = [None, 0]
        elif entry and "Used" in line:
            usage[entry][0] = int(line.split("Used ")[1].split()[0])
        elif entry and "bytes spill stores" in line:
            usage[entry][1] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
    return usage


def spd_batch(b: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)


def time_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` CUDA-event windows of the mean time of
    ``reps`` back-to-back calls (library calls that stall on the host vary
    from window to window; the median keeps one stall out of the number)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


def time_device_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed in ``windows`` CUDA-event windows, the median.  No host work
    runs between the launches, so a kernel shorter than its wrapper's host
    overhead reads its own time and not the host's."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


def time_in_turns(module, first_design, fn) -> dict:
    """Device ms of ``fn`` through ``module``'s wrapper, on the package's
    library and on the library ``first_design`` in turns: kernel, first
    design, first design, kernel; ``ms`` and ``first_design_ms`` are the
    mean of each pair."""
    package_library = module._library
    turns = {"ms": [], "first_design_ms": []}
    for key in ("ms", "first_design_ms", "first_design_ms", "ms"):
        module._library = package_library if key == "ms" else (lambda: first_design)
        try:
            turns[key].append(time_device_ms(fn))
        finally:
            module._library = package_library
    return {key: float(np.mean(v)) for key, v in turns.items()}


def profile_objective(torch, vag, theta, reps: int = 10, shares=None) -> dict:
    """Wall time of ``reps`` objective evaluations (unprofiled), then the
    device kernel time of ``reps`` more under ``torch.profiler``;
    ``shares`` maps a label to kernel-name substrings whose device time,
    share and launches per evaluation are reported too."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        vag(theta)
    start = time.perf_counter()
    for _ in range(reps):
        vag(theta)
    wall_ms = (time.perf_counter() - start) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            vag(theta)
    kernels = [
        (e.self_device_time_total / 1e3 / reps, e.key, e.count // reps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    named = {}
    for label, keys in (shares or {}).items():
        picked = [k for k in kernels if any(key in k[1] for key in keys)]
        ms = sum(k[0] for k in picked)
        named[label] = {"device_ms": ms, "device_share": ms / device_ms,
                        "wall_share": ms / wall_ms,
                        "per_eval": sum(k[2] for k in picked)}
    return {
        "eval_wall_ms": wall_ms,
        "eval_device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches_per_eval": sum(k[2] for k in kernels),
        "top": [{"ms": ms, "name": name[:90], "per_eval": n}
                for ms, name, n in kernels[:6]],
        **({"kernels": named} if shares else {}),
    }


def airfoil_kernel():
    """The airfoil acceptance config's kernel (examples/airfoil.py)."""
    from spark_gp_tpu_torch import ARDRBFKernel, Const, EyeKernel

    return 1.0 * ARDRBFKernel(5) + Const(1.0) * EyeKernel()


def airfoil_gp(expert: int):
    """The airfoil acceptance config (examples/airfoil.py) at ``expert``
    points an expert (the reference's is 100)."""
    from spark_gp_tpu_torch import GaussianProcessRegression

    return (
        GaussianProcessRegression()
        .setDatasetSizeForExpert(expert)
        .setActiveSetSize(1000)
        .setSigma2(1e-4)
        .setKernel(airfoil_kernel)
        .setSeed(13)
    )


def regression_cv(gp, x, y, folds) -> dict:
    """A fit and predict per fold: the mean test RMSE, the evaluations and
    phase seconds summed over folds, each fold's (E, s) and
    ``gram_cache_engaged``, each fold's evaluations and optimize seconds,
    the first fold's model and the seconds of the whole."""
    from spark_gp_tpu_torch.utils.validation import rmse

    start = time.perf_counter()
    scores, nfev, shapes, engaged, first = [], 0, set(), set(), None
    phases = dict.fromkeys(PHASES, 0.0)
    per_fold = []
    for train, test in folds:
        model = copy.copy(gp).fit(x[train], y[train])
        per_fold.append({"nfev": model.metrics["lbfgs_nfev"],
                         "optimize_seconds": model.metrics["optimize_seconds"],
                         "theta": model.raw_predictor.theta.tolist(),
                         **{k: v for k, v in model.metrics.items()
                            if k.startswith(("device_opt.", "expert_quality.probe_launches."))}})
        pred = model.predict(x[test])
        if not np.all(np.isfinite(pred)) or pred.shape != test.shape:
            raise AssertionError("CV predictions not finite")
        scores.append(rmse(y[test], pred))
        nfev += model.metrics["lbfgs_nfev"]
        shapes.add((model.metrics["num_experts"], model.metrics["expert_size"]))
        engaged.add(model.metrics["gram_cache_engaged"])
        for key in PHASES:
            phases[key] += model.metrics[key]
        if first is None:
            first = model
    return {"rmse": float(np.mean(scores)), "seconds": time.perf_counter() - start,
            "nfev": nfev, **phases, "experts": sorted(shapes),
            "gram_cache_engaged": sorted(engaged), "per_fold": per_fold, "first_model": first}


def matfree_kernel():
    """The protein-matfree config's kernel: the isotropic RBF."""
    from spark_gp_tpu_torch import RBFKernel, WhiteNoiseKernel

    return 1.0 * RBFKernel(1.0, 1e-6, 10) + WhiteNoiseKernel(0.1, 0.0, 1.0)


def matfree_gp(lane, max_iter: int = 10):
    """The protein-matfree config (expert 4096, E = 9, s = 4065) on the
    solver lane ``lane`` (``None``: leave the process lane as it is)."""
    from spark_gp_tpu_torch import GaussianProcessRegression

    gp = (
        GaussianProcessRegression()
        .setKernel(matfree_kernel)
        .setSigma2(1e-3)
        .setDatasetSizeForExpert(4096)
        .setActiveSetSize(1000)
        .setMaxIter(max_iter)
        .setSeed(13)
    )
    return gp if lane is None else gp.setSolverLane(lane)


def protein_kernel():
    """The protein config's kernel (examples/protein.py)."""
    from spark_gp_tpu_torch import ARDRBFKernel, WhiteNoiseKernel

    return 1.0 * ARDRBFKernel(9, 9 ** -0.5) + WhiteNoiseKernel(0.1, 0.0, 1.0)


def main_path_data() -> dict:
    """Airfoil (z-scored) with its 10 CV folds; the protein stand-in with
    its 80/20 split, features and training targets standardized."""
    from spark_gp_tpu_torch.data import load_airfoil, load_protein
    from spark_gp_tpu_torch.ops.scaling import fit_scaler, scale
    from spark_gp_tpu_torch.utils.validation import kfold_indices

    x, y = load_airfoil()
    x = scale(x)
    xp, yp = load_protein()
    perm = np.random.default_rng(13).permutation(xp.shape[0])
    cut = int(0.8 * xp.shape[0])
    tr, te = perm[:cut], perm[cut:]
    mean, std = fit_scaler(xp[tr])
    y_mean, y_std = yp[tr].mean(), yp[tr].std()
    return {"x": x, "y": y, "folds": list(kfold_indices(x.shape[0], 10, seed=13)),
            "xp": (xp - mean) / std, "yp": yp, "tr": tr, "te": te,
            "yp_tr": (yp[tr] - y_mean) / y_std, "y_mean": y_mean, "y_std": y_std}


def exact_lane_stacks(torch, d: dict) -> dict:
    """The gram stacks the exact lane hands K1 at init theta, each with its
    config's kernel plus sigma2 * I: the first airfoil CV fold's training
    rows at expert 100 (14, 97) and at expert 450 (3, 451), the protein
    training split at expert 100 (366, 100) and at expert 400 (91, 403)."""
    from spark_gp_tpu_torch import Const, EyeKernel
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    train = d["folds"][0][0]
    airfoil = (airfoil_kernel, 1e-4, d["x"][train], d["y"][train])
    protein = (protein_kernel, 1e-3, d["xp"][d["tr"]], d["yp_tr"])
    stacks = {}
    for label, (factory, sigma2, xs, ys), expert, shape in [
        ("airfoil_fold", airfoil, 100, (14, 97)),
        ("protein", protein, 100, (366, 100)),
        ("airfoil_expert450", airfoil, 450, (3, 451)),
        ("protein_expert400", protein, 400, (91, 403)),
    ]:
        kernel = factory() + Const(sigma2) * EyeKernel()
        data = group_for_experts(xs, ys, expert, dtype=torch.float32, device="cuda")
        theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device="cuda")
        stacks[label] = masked_gram_stack(kernel, theta, data.x, data.mask)
        if tuple(stacks[label].shape) != (shape[0], shape[1], shape[1]):
            raise AssertionError(f"{label} stack {tuple(stacks[label].shape)}, "
                                 f"expected {shape}")
    return stacks


def mnist_gpc(device=None):
    """The reference's MNIST classifier config (examples/mnist.py)."""
    from spark_gp_tpu_torch import GaussianProcessClassifier, RBFKernel

    return (
        GaussianProcessClassifier(device=device)
        .setDatasetSizeForExpert(100)
        .setActiveSetSize(100)
        .setKernel(lambda: RBFKernel(10.0))
        .setTol(1e-3)
    )


def iris_gpc(device=None):
    """The reference's iris classifier config (examples/iris.py)."""
    from spark_gp_tpu_torch import GaussianProcessClassifier

    return GaussianProcessClassifier(device=device).setDatasetSizeForExpert(20) \
        .setActiveSetSize(30)


def iris_native_gpc(device=None):
    """The native multiclass iris config (examples/iris.py
    ``make_native_gpc``): expert 20, active 30, the default RBF kernel,
    sigma2 and tol."""
    from spark_gp_tpu_torch import GaussianProcessMulticlassClassifier

    return GaussianProcessMulticlassClassifier(device=device) \
        .setDatasetSizeForExpert(20).setActiveSetSize(30)


def classifier_data() -> dict:
    """The MNIST stand-in z-scored (as examples/mnist.py does) with the
    training rows of ``train_validation_split(seed=13)``; iris with its
    10 CV folds at seed 13 (examples/iris.py)."""
    from spark_gp_tpu_torch.data import load_iris, load_mnist_binary
    from spark_gp_tpu_torch.ops.scaling import scale
    from spark_gp_tpu_torch.utils.validation import kfold_indices

    xm, ym = load_mnist_binary()
    xm = scale(xm)
    perm = np.random.default_rng(13).permutation(xm.shape[0])
    xi, yi = load_iris()
    return {"xm": xm, "ym": ym, "tr_m": perm[:int(0.8 * xm.shape[0])], "xi": xi, "yi": yi,
            "folds_i": list(kfold_indices(xi.shape[0], 10, seed=13))}


def gpc_b_stacks(torch, lap, d: dict) -> dict:
    """The B = I + W^1/2 K W^1/2 stacks the classifier hands K1, at init
    theta and the converged Laplace mode there: the MNIST training stack
    (16, 100) and the first iris fold's first one-vs-rest problem
    (versicolor against the rest, (7, 20))."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack

    train = d["folds_i"][0][0]
    out = {}
    for label, gp, xs, ys, shape in [
        ("gpc_mnist", mnist_gpc(), d["xm"][d["tr_m"]], d["ym"][d["tr_m"]], (16, 100)),
        ("iris_fold", iris_gpc(), d["xi"][train], (d["yi"][train] == 0).astype(np.float64),
         (7, 20)),
    ]:
        kernel = gp._get_kernel()
        data = gp._group(xs, ys, torch.device("cuda"))
        theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device="cuda")
        kmat = masked_gram_stack(kernel, theta, data.x, data.mask)
        f, _ = lap.laplace_mode_batch(kmat, data.y, data.mask, torch.zeros_like(data.y),
                                      gp._tol)
        pi = torch.sigmoid(f)
        sqw = torch.sqrt(pi * (1.0 - pi) * data.mask)
        out[label] = (torch.eye(shape[1], device="cuda")
                      + sqw[:, :, None] * kmat * sqw[:, None, :])
        if tuple(out[label].shape) != (shape[0], shape[1], shape[1]):
            raise AssertionError(f"{label} B stack {tuple(out[label].shape)}, expected {shape}")
    return out


def mc_b_stack(torch, lap_mc, d: dict):
    """The ``[E * C, s, s]`` stack of B_c = I + D_c^1/2 K D_c^1/2 the
    multiclass classifier hands K1, at init theta and the converged mode
    there, on the first iris fold (E = 7, C = 3, s = 20)."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack
    from spark_gp_tpu_torch.models.gpc_mc import _one_hot_masked

    train = d["folds_i"][0][0]
    gp = iris_native_gpc()
    kernel = gp._get_kernel()
    data = gp._group(d["xi"][train], d["yi"][train], torch.device("cuda"))
    y1h = _one_hot_masked(data.y, data.mask, 3)
    theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device="cuda")
    kmat = masked_gram_stack(kernel, theta, data.x, data.mask)
    f, _ = lap_mc.laplace_mc_mode(kmat, y1h, data.mask, torch.zeros_like(y1h), gp._tol)
    sq = torch.sqrt(torch.softmax(f, dim=-1) * data.mask[..., None]).movedim(-1, 1)
    b_mats = (torch.eye(kmat.shape[-1], device="cuda")
              + sq[..., :, None] * kmat[:, None] * sq[..., None, :])
    b_mats = b_mats.reshape(-1, kmat.shape[-1], kmat.shape[-1])
    if tuple(b_mats.shape) != (21, 20, 20):
        raise AssertionError(f"iris-native B stack {tuple(b_mats.shape)}, expected (21, 20, 20)")
    return b_mats


def split_fit(gp, x, y) -> dict:
    """examples/mnist.py's measurement: ``train_validation_split`` at seed
    13 (80/20), accuracy on the held-out rows; with the fitted model's
    metrics and the seconds of the whole."""
    from spark_gp_tpu_torch.utils.validation import accuracy, train_validation_split

    fitted = []

    class Keep:
        def fit(self, xs, ys):
            fitted.append(gp.fit(xs, ys))
            return fitted[-1]

    start = time.perf_counter()
    acc = train_validation_split(Keep(), x, y, train_ratio=0.8, metric=accuracy, seed=13)
    seconds = time.perf_counter() - start
    metrics = fitted[0].metrics
    return {"accuracy": acc, "seconds": seconds, **{k: metrics[k] for k in GPC_METRICS},
            "newton_per_eval": metrics["newton_iterations"] / metrics["objective_calls"],
            "gram_cache_engaged": metrics["gram_cache_engaged"], "model": fitted[0]}


def iris_cv(torch, d: dict, device=None) -> dict:
    """examples/iris.py's measurement: one-vs-rest over the binary
    classifier, 10-fold CV at seed 13; the mean accuracy, the metrics
    summed over the 30 binary fits and the seconds of the whole."""
    from spark_gp_tpu_torch.utils.validation import OneVsRest

    return cv_fits(torch, d, lambda: OneVsRest(lambda: iris_gpc(device)),
                   lambda ovr: ovr.models_, device)


def iris_native_cv(torch, d: dict, device=None) -> dict:
    """examples/iris.py --native's measurement: the multiclass classifier,
    10-fold CV at seed 13, on the lane in effect; the mean accuracy, the
    metrics summed over the 10 fits and the seconds of the whole."""
    return cv_fits(torch, d, lambda: iris_native_gpc(device), lambda model: [model], device)


def cv_fits(torch, d: dict, make, models, device, engine: str = "newton_iterations",
            extra=()) -> dict:
    """A fit of ``make()`` per iris fold: the mean accuracy, the metrics of
    the fitted classifiers (``models(fitted)``) summed (``engine`` names
    the inference engine's count: Newton iterations, or EP's sweeps;
    ``extra`` more metrics to sum), their
    number, (E, s) and ``gram_cache_engaged`` values, and the seconds of
    the whole."""
    from spark_gp_tpu_torch.utils.validation import accuracy

    start = time.perf_counter()
    keys = ("lbfgs_nfev", engine, "objective_calls") + PHASES + tuple(extra)
    scores, sums, shapes, engaged, fits = [], dict.fromkeys(keys, 0), set(), set(), []
    for train, test in d["folds_i"]:
        fitted = make().fit(d["xi"][train], d["yi"][train])
        scores.append(accuracy(d["yi"][test], fitted.predict(d["xi"][test])))
        for model in models(fitted):
            fits.append(model)
            shapes.add((model.metrics["num_experts"], model.metrics["expert_size"]))
            engaged.add(model.metrics["gram_cache_engaged"])
            for key in sums:
                sums[key] += model.metrics.get(key, 0.0) if key in extra else model.metrics[key]
    if device is None:
        torch.cuda.synchronize()
    per_eval = "newton_per_eval" if engine == "newton_iterations" else f"{engine}_per_eval"
    return {"accuracy": float(np.mean(scores)), "seconds": time.perf_counter() - start,
            "experts": sorted(shapes), **sums, "fits": len(fits),
            per_eval: sums[engine] / sums["objective_calls"],
            "gram_cache_engaged": sorted(engaged),
            "first_theta": fits[0].raw_predictor.theta.tolist()}


def check_against_plain(torch, spd, k, label: str):
    """K1 on ``k`` against its plain version in float64 on the same input
    upcast, at the JAX package's bars (inverse within 5e-5 max|K^-1|,
    logdet rtol 1e-5 / atol 1e-4).  Returns the largest absolute errors
    of the inverse and of the logdet."""
    kinv, ld = spd.spd_inv_logdet(k)
    torch.cuda.synchronize()
    kinv_ref, ld_ref = spd.spd_inv_logdet_plain(k.double())
    err = (kinv.double() - kinv_ref).abs().max().item()
    scale = kinv_ref.abs().max().item()
    ld_err = (ld.double() - ld_ref).abs()
    if not err <= 5e-5 * scale:
        raise AssertionError(f"K^-1 of {label}: err {err} > 5e-5 * {scale}")
    if not bool((ld_err <= 1e-4 + 1e-5 * ld_ref.abs()).all()):
        raise AssertionError(f"logdet of {label}: err {ld_err.max().item()}")
    return err, ld_err.max().item()


def check_spd_inv_logdet(torch, spd, stacks):
    """K1 against its plain version on random SPD batches (the main path's
    shapes among them, ragged last panels at n = 113, 127, the workspace
    path from n = 129), on the main path's own gram stacks ``stacks``, on
    a batch with a non-PD matrix, and in the backward; the last two at
    n = 100 and on the workspace path (n = 300, 451), where each matrix
    spans many blocks."""
    errs = {}
    for b, n in [(1, 4), (5, 60), (7, 64), (8, 128), (3, 100), (3, 113), (2, 127),
                 (2, 129), (3, 200), (2, 256), (1, 512), (14, 97), (14, 100), (366, 100)]:
        k = torch.as_tensor(spd_batch(b, n, seed=n), device="cuda")
        errs[f"{b}x{n}"] = max(check_against_plain(torch, spd, k, f"({b},{n})"))
    for label, k in stacks.items():
        errs[label] = max(check_against_plain(torch, spd, k, label))

    # a non-PD matrix gives NaN; its batch mates stay exact
    for n in (100, 300):
        k = torch.as_tensor(spd_batch(4, n, seed=1), device="cuda")
        k[2, 0, 0] = -1.0
        kinv, ld = spd.spd_inv_logdet(k)
        torch.cuda.synchronize()
        bad = ~torch.isfinite(kinv).all(dim=(1, 2))
        if bad.tolist() != [False, False, True, False] or torch.isfinite(ld[2]):
            raise AssertionError(f"non-PD isolation at n = {n}: bad={bad.tolist()} "
                                 f"ld={ld.tolist()}")
        keep = [0, 1, 3]
        kinv_ref, ld_ref = spd.spd_inv_logdet_plain(k[keep].double())
        scale = kinv_ref.abs().max().item()
        if not (kinv[keep].double() - kinv_ref).abs().max().item() <= 5e-5 * scale:
            raise AssertionError(f"non-PD batch mates disagree with the plain version at n = {n}")

    # backward: the autograd function against autograd through the plain
    # float64 Cholesky, at rtol 1e-4.  The cotangent of K^-1 is symmetric,
    # as in the likelihood (0.5 y y^T): the Cholesky backward returns the
    # symmetrized gradient, the VJP formula the plain one.
    for b, n in [(3, 100), (14, 97), (2, 451)]:
        gen = np.random.default_rng(b)
        k64 = torch.as_tensor(spd_batch(b, n, seed=b), device="cuda").double()
        g = torch.as_tensor(gen.normal(size=(b, n, n)), device="cuda")
        g = 0.5 * (g + g.mT)
        gl = torch.as_tensor(gen.normal(size=(b,)), device="cuda")
        grads = []
        for fn, dtype in [(spd.spd_inv_logdet, torch.float32),
                          (spd.spd_inv_logdet_plain, torch.float64)]:
            kk = k64.to(dtype).requires_grad_(True)
            kinv, ld = fn(kk)
            ((kinv * g.to(dtype)).sum() + (ld * gl.to(dtype)).sum()).backward()
            torch.cuda.synchronize()
            grads.append(kk.grad.double())
        ref = grads[1]
        err = (grads[0] - ref).abs()
        if not bool((err <= 1e-4 * (ref.abs() + ref.abs().max())).all()):
            raise AssertionError(f"backward at ({b},{n}): err {err.max().item()}")
    return errs


def time_spd_inv_logdet(torch, spd, first_design, inputs: dict, peaks) -> dict:
    """K1, its first design (the library ``first_design`` run through the
    same wrapper), its plain version and the library call (``cholesky``
    then ``cholesky_inverse``) on each ``[B, n, n]`` input.  K1 and the
    first design run in turns: kernel, first design, first design,
    kernel; each reads the mean of its two.  ``ms`` and
    ``first_design_ms`` are device times (``time_device_ms``: the kernel is
    shorter than the wrapper's host overhead); ``wall_ms`` is the eager
    loop's time per call, host overhead included, as ``plain_ms`` and
    ``library_ms`` are.  The bound is the larger of the bytes (K read once,
    K^-1 and logdet written once) over the memory rate and the B n^3 flops
    over the f32 peak."""
    bw, f32 = peaks[:2]
    out = {}
    for label, k in inputs.items():
        b, n = k.shape[0], k.shape[-1]

        def library(k=k):
            chol = torch.linalg.cholesky(k)
            logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
            return torch.cholesky_inverse(chol), logdet

        def kernel(k=k):
            return spd.spd_inv_logdet(k)

        flops, nbytes = spd.work(b, n)
        out[label] = {
            "shape": [b, n],
            **time_in_turns(spd, first_design, kernel),
            "wall_ms": time_ms(kernel),
            "plain_ms": time_ms(lambda k=k: spd.spd_inv_logdet_plain(k)),
            "library_ms": time_ms(library),
            "bound_ms": max(nbytes / bw, flops / f32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= flops / f32 else "operations",
            "bytes": nbytes, "flops": flops,
        }
    return out


def check_streamed_matvec(torch, sm, x_slice):
    """K2 and K2-VJP against their plain versions in float64 on the same
    inputs upcast, for all seven tile transforms: on the protein-matfree
    row stack at every width the main path launches them with (n = 1: the
    quad leg, n = 8: the surrogate leg, n = 9: a CG step), which covers
    K2's accumulator templates 1, 8 and 9; on a ragged (3, 1000, 5) stack
    with n = 1 and n = 4 (s a multiple of neither tile; the template 4);
    on (2, 777, 21) at n = 9 (p > 16: two feature chunks, s ragged); and
    on (2, 130, 20) at n = 17 (the template 16 over two right-hand-side
    chunks, the second one column wide).  Bars: K2 within 1e-5
    of the largest |output| (a float32 sum of s terms); the
    theta-cotangent within 1e-4 of the largest |cotangent| (float32
    partial sums over s^2 pairs), and bit-identical over two calls (the
    blocks' partial sums are closed in a fixed order).  Returns the
    errors, absolute and relative to those scales, keyed
    ``label/n<width>/family``."""
    gen = np.random.default_rng(7)
    ragged = torch.as_tensor(gen.normal(size=(3, 1000, 5)), dtype=torch.float32, device="cuda")
    # features scaled by p^-1/2, so the maps stay away from 0 at p = 20, 21
    extra = np.random.default_rng(8)
    wide, chunked = (torch.as_tensor(extra.normal(size=shape) / np.sqrt(shape[-1]),
                                     dtype=torch.float32, device="cuda")
                     for shape in ((2, 777, 21), (2, 130, 20)))
    errs = {}
    for label, x, n in (("slice", x_slice, 1), ("slice", x_slice, 8), ("slice", x_slice, 9),
                        ("ragged", ragged, 1), ("ragged", ragged, 4), ("wide", wide, 9),
                        ("chunked", chunked, 17)):
        shape = tuple(x.shape[:2]) + (n,)
        v = torch.as_tensor(gen.normal(size=shape), dtype=torch.float32, device="cuda")
        w = torch.as_tensor(gen.normal(size=shape), dtype=torch.float32, device="cuda")
        for family, params in MATFREE_FAMILIES.items():
            par = torch.tensor(params, dtype=torch.float32, device="cuda")
            out = sm.streamed_matvec(x, v, family, par, POLY_DEGREE)
            grad = sm.streamed_matvec_vjp(x, w, v, family, par, POLY_DEGREE)
            again = sm.streamed_matvec_vjp(x, w, v, family, par, POLY_DEGREE)
            torch.cuda.synchronize()
            if not torch.equal(grad, again):
                raise AssertionError(f"K2-VJP {label}/n{n}/{family}: two calls differ: "
                                     f"{grad.tolist()} vs {again.tolist()}")
            x64, v64, p64 = x.double(), v.double(), par.double()
            ref = sm.streamed_matvec_plain(x64, v64, family, p64, POLY_DEGREE)
            gref = sm.streamed_matvec_vjp_plain(x64, w.double(), v64, family, p64, POLY_DEGREE)
            e_mv = (out.double() - ref).abs().max().item()
            e_vjp = (grad.double() - gref).abs().max().item()
            s_mv, s_vjp = ref.abs().max().item(), gref.abs().max().item()
            key = f"{label}/n{n}/{family}"
            if not e_mv <= 1e-5 * s_mv:
                raise AssertionError(f"K2 {key}: err {e_mv} > 1e-5 * {s_mv}")
            if not e_vjp <= 1e-4 * s_vjp:
                raise AssertionError(f"K2-VJP {key}: err {e_vjp} > 1e-4 * {s_vjp}")
            errs[key] = {"matvec": e_mv, "matvec_rel": e_mv / s_mv,
                         "vjp": e_vjp, "vjp_rel": e_vjp / s_vjp}
    return errs


def time_streamed_matvec(torch, sm, x, peaks, vjp_first_design):
    """K2 (n = 9: a CG step; n = 1, 8: the differentiable legs) and K2-VJP
    (n = 1, 8) on the protein-matfree row stack with the RBF map at
    sigma = 1, beside the plain version and a library yardstick that
    materializes the gram (``cdist``^2 -> ``exp`` -> ``bmm``).  K2-VJP
    runs in turns with its first design (the library
    ``vjp_first_design`` through the same wrapper): kernel, first design,
    first design, kernel; each reads the mean of its two device times
    (``time_device_ms``: at n = 1 the eager loop reads the wrapper's host
    time as often as the kernel's), and ``wall_ms`` is the eager loop.  The bound
    is the largest of: FP32 flops over the f32 peak, the ``exp``s over
    the special-function rate, the bytes over the memory rate.  K is
    symmetric, so the least work computes each distance and its map once
    per unordered off-diagonal pair (2p + 3 flops and one ``exp`` for the
    value; 2p + 6 and one ``exp`` for the derivative).  K V accumulates
    once per ordered pair (2n flops).  The VJP needs only the off-diagonal
    pairs, since the RBF map's dk/dsigma is 0 at r = 0: per unordered one
    4n flops for <W_i, V_j> + <W_j, V_i> and 2 for its product with dk."""
    bw, f32, sfu = peaks
    e, s, p = x.shape
    half = sm.exps(e, s)
    par = torch.ones(1, dtype=torch.float32, device="cuda")
    gen = np.random.default_rng(11)
    out = {}

    def gram():
        return torch.exp(-0.5 * torch.cdist(x, x) ** 2)

    for n in (9, 1, 8):
        v = torch.as_tensor(gen.normal(size=(e, s, n)), dtype=torch.float32, device="cuda")
        w = torch.as_tensor(gen.normal(size=(e, s, n)), dtype=torch.float32, device="cuda")
        legs = [("streamed_matvec", *sm.work(e, s, p, n),
                 lambda v=v: sm.streamed_matvec(x, v, "rbf", par),
                 lambda v=v: sm.streamed_matvec_plain(x, v, "rbf", par),
                 lambda v=v: torch.bmm(gram(), v))]
        if n != 9:
            def library_vjp(v=v, w=w):
                d = torch.cdist(x, x) ** 2
                return torch.sum(torch.bmm(w, v.mT) * torch.exp(-0.5 * d) * d)

            legs.append(("streamed_matvec_vjp", *sm.work_vjp(e, s, p, n),
                         lambda v=v, w=w: sm.streamed_matvec_vjp(x, w, v, "rbf", par),
                         lambda v=v, w=w: sm.streamed_matvec_vjp_plain(x, w, v, "rbf", par),
                         library_vjp))
        for name, flops, nbytes, kernel, plain, library in legs:
            times = (flops / f32, half / sfu, nbytes / bw)
            row = {
                **({**time_in_turns(sm, vjp_first_design, kernel), "wall_ms": time_ms(kernel)}
                   if name == "streamed_matvec_vjp" else {"ms": time_ms(kernel)}),
                "plain_ms": time_ms(plain, reps=5, windows=3),
                "library_ms": time_ms(library, reps=5, windows=3),
                "library": "materializing: cdist^2 -> exp -> bmm"
                           + ("" if name == "streamed_matvec" else " (W V^T * dk/dsigma, sum)"),
                "bound_ms": max(times) * 1e3,
                "bound_by": "bytes" if times[2] == max(times) else "operations",
                "flops": flops, "exps": half, "bytes": nbytes,
            }
            out.setdefault(name, {})[f"n{n}"] = row
    return out


def classifier_phases(torch, spd, lap, it_ops, cdata: dict) -> dict:
    """The binary classifier's phases (13-16 of the module doc); returns
    K1's launches over the gpc-mnist fit and over the iris CV, the
    gpc-mnist fit's theta and each config's ``gram_cache_engaged``."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack, prepare_gram_cache
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    # 13. gpc-parity: the Laplace objective and its gradient, on the card
    # (float32, K1 for every B) against the CPU (float64, Cholesky), on
    # the MNIST training stack at init theta, 0.7x and 1.3x it.  Bars,
    # relative (value; gradient over its largest component): 1e-4 and
    # 1e-3.  With no bar: the float32 gram's largest error at p = 784 and
    # each side's Newton iterations.
    xm_tr, ym_tr = cdata["xm"][cdata["tr_m"]], cdata["ym"][cdata["tr_m"]]
    mnist_kernel = mnist_gpc()._get_kernel()
    theta0 = mnist_kernel.init_theta()
    sides = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        data = group_for_experts(xm_tr, ym_tr, 100, dtype=dtype, device=device)
        theta_t = torch.as_tensor(theta0, dtype=dtype, device=device)
        sides[device] = (data, lap.make_laplace_objective(mnist_kernel, data, 1e-3),
                         masked_gram_stack(mnist_kernel, theta_t, data.x, data.mask))
    gram_err = (sides["cuda"][2].double().cpu() - sides["cpu"][2]).abs().max().item()
    points = []
    for factor in (1.0, 0.7, 1.3):
        out = {}
        for device, (data, objective, _) in sides.items():
            before = lap.laplace_mode_batch.iterations
            value, grad, _ = objective(theta0 * factor, torch.zeros_like(data.y))
            out[device] = (value, grad, lap.laplace_mode_batch.iterations - before)
        (v_gpu, g_gpu, it_gpu), (v_cpu, g_cpu, it_cpu) = out["cuda"], out["cpu"]
        dv = abs(v_gpu - v_cpu) / abs(v_cpu)
        dg = float(np.max(np.abs(g_gpu - g_cpu)) / np.max(np.abs(g_cpu)))
        points.append({"theta": (theta0 * factor).tolist(), "value_cuda": v_gpu,
                       "value_cpu": v_cpu, "grad_cuda": g_gpu.tolist(),
                       "grad_cpu": g_cpu.tolist(), "rel_value_err": dv, "rel_grad_err": dg,
                       "newton_iterations": {"cuda": it_gpu, "cpu": it_cpu}})
        if not (dv <= 1e-4 and dg <= 1e-3):
            raise AssertionError(f"gpc card vs CPU objective at {factor} x init theta: "
                                 f"rel dv {dv}, dg {dg}")
    emit({"phase": "gpc-parity", "config": "gpc-mnist", "shape": [16, 100, 784],
          "bars": {"rel_value": 1e-4, "rel_grad": 1e-3},
          "gram_max_abs_err_f32": gram_err, "points": points})

    # 14. gpc-mnist: examples/mnist.py's config on the MNIST stand-in,
    # train_validation_split at seed 13, on the card and again on the CPU.
    # K1 runs once a Newton iteration and once an evaluation (the
    # converged-state pass); the host reads one flag a Newton iteration
    # (one more as each loop ends) and the value and gradient once an
    # evaluation.  Then one evaluation at the fitted theta, warm-started
    # from its own mode, under the profiler.
    zero(spd.spd_inv_logdet)
    lap.laplace_mode_batch.iterations = lap.batched_neg_logz.calls = 0
    fit = split_fit(mnist_gpc(), cdata["xm"], cdata["ym"])
    launches_gpc_mnist = spd.spd_inv_logdet.launches
    probe_gpc_mnist = probes(spd.spd_inv_logdet)
    iterations, calls = lap.laplace_mode_batch.iterations, lap.batched_neg_logz.calls
    model = fit.pop("model")
    if (iterations, calls) != (fit["newton_iterations"], fit["objective_calls"]):
        raise AssertionError(f"gpc-mnist: counters {iterations}, {calls} against the "
                             f"fit's metrics {fit['newton_iterations']}, "
                             f"{fit['objective_calls']}")
    if launches_gpc_mnist != iterations + calls + probe_gpc_mnist or iterations == 0 \
            or calls == 0 or probe_gpc_mnist != 1:
        raise AssertionError(f"gpc-mnist: {launches_gpc_mnist} K1 launches for {iterations} "
                             f"Newton iterations, {calls} objective calls and "
                             f"{probe_gpc_mnist} probe launches")
    if (fit["num_experts"], fit["expert_size"]) != (16, 100):
        raise AssertionError(f"gpc-mnist stack ({fit['num_experts']}, {fit['expert_size']})")
    if not fit["accuracy"] > GPC_BARS["gpc_mnist"]:
        raise AssertionError(f"gpc-mnist accuracy {fit['accuracy']} <= "
                             f"{GPC_BARS['gpc_mnist']}")
    cpu_fit = split_fit(mnist_gpc("cpu"), cdata["xm"], cdata["ym"])
    cpu_fit.pop("model")
    data = group_for_experts(xm_tr, ym_tr, 100, dtype=torch.float32, device="cuda")
    theta_fit = model.raw_predictor.theta
    kernel = model.raw_predictor.kernel
    # with the gram cache, as the fit evaluates it
    objective = lap.make_laplace_objective(kernel, data, 1e-3,
                                           prepare_gram_cache(kernel, data.x))
    f_warm = objective(theta_fit, torch.zeros_like(data.y))[2]
    before = (spd.spd_inv_logdet.launches, lap.laplace_mode_batch.iterations,
              lap.batched_neg_logz.calls)
    prof = profile_objective(torch, lambda theta: objective(theta, f_warm), theta_fit,
                             shares={"spd_inv_logdet": ("spd_inv_logdet",)})
    prof["newton_per_eval"] = ((lap.laplace_mode_batch.iterations - before[1])
                               / (lap.batched_neg_logz.calls - before[2]))
    spd.spd_inv_logdet.launches = before[0]
    HOST_FITS["gpc_mnist"] = fit
    emit({"phase": "gpc-mnist", "shape": [16, 100, 784], **fit, "launches": launches_gpc_mnist,
          "probe_launches": probe_gpc_mnist,
          "host_reads": iterations + 2 * calls, "theta": theta_fit.tolist(),
          "bar": GPC_BARS["gpc_mnist"], "jax_cpu_accuracy": JAX_CPU_ACCURACY["gpc_mnist"],
          "cpu": cpu_fit, "eval_profile": prof})

    # 15. gpc-mnist-iterative: the same fit on the iterative lane, whose
    # B systems are CG solves and SLQ log-dets: no K1 launch
    zero(spd.spd_inv_logdet)
    try:
        it_fit = split_fit(mnist_gpc().setSolverLane("iterative"), cdata["xm"], cdata["ym"])
    finally:
        it_ops.set_solver_lane(None)
    launches_iterative = spd.spd_inv_logdet.launches
    lane = it_fit.pop("model").metrics["solver_lane"]
    HOST_FITS["gpc_mnist_iterative"] = it_fit
    emit({"phase": "gpc-mnist-iterative", **it_fit, "solver_lane": lane,
          "launches": launches_iterative, "bar": GPC_BARS["gpc_mnist"]})
    if lane != "iterative" or launches_iterative != 0:
        raise AssertionError(f"gpc-mnist-iterative: lane {lane}, {launches_iterative} K1 "
                             "launches")
    if not it_fit["accuracy"] > GPC_BARS["gpc_mnist"]:
        raise AssertionError(f"gpc-mnist-iterative accuracy {it_fit['accuracy']}")

    # 16. iris-ovr: examples/iris.py's one-vs-rest 10-fold CV at seed 13
    # (30 binary fits, each E = 7, s = 20), on the card and on the CPU
    zero(spd.spd_inv_logdet)
    lap.laplace_mode_batch.iterations = lap.batched_neg_logz.calls = 0
    iris = iris_cv(torch, cdata)
    launches_iris = spd.spd_inv_logdet.launches
    probe_iris = probes(spd.spd_inv_logdet)
    if launches_iris != iris["newton_iterations"] + iris["objective_calls"] + probe_iris \
            or launches_iris == 0:
        raise AssertionError(f"iris-ovr: {launches_iris} K1 launches ({probe_iris} probes) for "
                             f"{iris['newton_iterations']} Newton iterations and "
                             f"{iris['objective_calls']} objective calls")
    if iris["experts"] != [(7, 20)]:
        raise AssertionError(f"iris-ovr: (E, s) per fit {iris['experts']}")
    iris_cpu = iris_cv(torch, cdata, "cpu")
    HOST_FITS["iris_ovr"] = iris
    emit({"phase": "iris-ovr", **iris, "launches": launches_iris, "probe_launches": probe_iris,
          "host_reads": iris["newton_iterations"] + 2 * iris["objective_calls"],
          "bar": GPC_BARS["iris_ovr"], "jax_cpu_accuracy": JAX_CPU_ACCURACY["iris_ovr"],
          "cpu": iris_cpu})
    if not iris["accuracy"] >= GPC_BARS["iris_ovr"]:
        raise AssertionError(f"iris-ovr 10-fold accuracy {iris['accuracy']} < "
                             f"{GPC_BARS['iris_ovr']}")
    return {"launches_gpc_mnist": launches_gpc_mnist, "launches_iris": launches_iris,
            "theta_gpc_mnist": theta_fit,
            "engaged": {"gpc_mnist": [fit["gram_cache_engaged"]],
                        "iris_ovr": iris["gram_cache_engaged"]}}


def multiclass_phases(torch, spd, lap_mc, it_ops, cdata: dict) -> dict:
    """The multiclass classifier's phases (17-19 of the module doc);
    returns K1's launches over the iris-native CV and its
    ``gram_cache_engaged`` values."""
    from spark_gp_tpu_torch.kernels.base import prepare_gram_cache
    from spark_gp_tpu_torch.models.gpc_mc import _one_hot_masked

    # 17. gpc-mc-parity: the multiclass objective and its gradient on the
    # card (float32, K1 for every B_c) against the CPU (float64, Cholesky)
    # on the first iris fold, at init theta and 1.5x it, from zero
    # latents, tol 1e-6 (the config's).  Bars as gpc-parity's, relative:
    # 1e-4 on the value, 1e-3 on the gradient over its largest component;
    # both sides take the same number of Newton iterations.
    train = cdata["folds_i"][0][0]
    gp = iris_native_gpc()
    kernel = gp._get_kernel()
    theta0 = kernel.init_theta()
    sides = {}
    for device in ("cuda", "cpu"):
        data = gp._group(cdata["xi"][train], cdata["yi"][train], torch.device(device))
        y1h = _one_hot_masked(data.y, data.mask, 3)
        sides[device] = (y1h, lap_mc.make_mc_objective(
            kernel, data.x, y1h, data.mask, gp._tol, prepare_gram_cache(kernel, data.x)))
    points = []
    for factor in (1.0, 1.5):
        out = {}
        for device, (y1h, objective) in sides.items():
            before = lap_mc.laplace_mc_mode.iterations
            value, grad, _ = objective(theta0 * factor, torch.zeros_like(y1h))
            out[device] = (value, grad, lap_mc.laplace_mc_mode.iterations - before)
        (v_gpu, g_gpu, it_gpu), (v_cpu, g_cpu, it_cpu) = out["cuda"], out["cpu"]
        dv = abs(v_gpu - v_cpu) / abs(v_cpu)
        dg = float(np.max(np.abs(g_gpu - g_cpu)) / np.max(np.abs(g_cpu)))
        points.append({"theta": (theta0 * factor).tolist(), "value_cuda": v_gpu,
                       "value_cpu": v_cpu, "grad_cuda": g_gpu.tolist(),
                       "grad_cpu": g_cpu.tolist(), "rel_value_err": dv, "rel_grad_err": dg,
                       "newton_iterations": {"cuda": it_gpu, "cpu": it_cpu}})
        if not (dv <= 1e-4 and dg <= 1e-3 and it_gpu == it_cpu):
            raise AssertionError(f"gpc-mc card vs CPU objective at {factor} x init theta: "
                                 f"rel dv {dv}, dg {dg}, Newton {it_gpu} / {it_cpu}")
    emit({"phase": "gpc-mc-parity", "config": "iris-native", "shape": [7, 20, 3],
          "bars": {"rel_value": 1e-4, "rel_grad": 1e-3}, "points": points})

    # 18. iris-native: make_native_gpc's 10-fold CV at seed 13 (E = 7,
    # s = 20, C = 3 on every fold), on the card and on the CPU.  K1 runs
    # once a Newton iteration (the [21, 20, 20] B_c stack) and twice an
    # evaluation (the differentiable step and the determinants, both
    # through K1's backward too).  Then one evaluation of the first
    # fold's objective at its fitted theta, warm-started from its own
    # mode, under the profiler.
    zero(spd.spd_inv_logdet)
    lap_mc.laplace_mc_mode.iterations = lap_mc.batched_neg_logz_mc.calls = 0
    # the Newton loops' lengths, by a wrapper in the loop's place for this
    # CV: the loop counts into whatever the module name holds
    mode, lengths = lap_mc.laplace_mc_mode, []

    def counted_mode(*args):
        before = counted_mode.iterations
        out = mode(*args)
        lengths.append(counted_mode.iterations - before)
        return out

    counted_mode.iterations = 0
    lap_mc.laplace_mc_mode = counted_mode
    try:
        native = iris_native_cv(torch, cdata)
    finally:
        lap_mc.laplace_mc_mode = mode
        mode.iterations = counted_mode.iterations
    launches = spd.spd_inv_logdet.launches
    probe_native = probes(spd.spd_inv_logdet)
    iterations, calls = lap_mc.laplace_mc_mode.iterations, lap_mc.batched_neg_logz_mc.calls
    if (iterations, calls) != (native["newton_iterations"], native["objective_calls"]):
        raise AssertionError(f"iris-native: counters {iterations}, {calls} against the fits' "
                             f"metrics {native['newton_iterations']}, "
                             f"{native['objective_calls']}")
    if launches != iterations + 2 * calls + probe_native or calls == 0:
        raise AssertionError(f"iris-native: {launches} K1 launches for {iterations} Newton "
                             f"iterations, {calls} objective calls and {probe_native} probes")
    if native["experts"] != [(7, 20)] or native["gram_cache_engaged"] != [1.0]:
        raise AssertionError(f"iris-native: (E, s) {native['experts']}, gram cache "
                             f"{native['gram_cache_engaged']}")
    native_cpu = iris_native_cv(torch, cdata, "cpu")
    model = iris_native_gpc().fit(cdata["xi"][train], cdata["yi"][train])
    data = gp._group(cdata["xi"][train], cdata["yi"][train], torch.device("cuda"))
    y1h = _one_hot_masked(data.y, data.mask, 3)
    objective = lap_mc.make_mc_objective(kernel, data.x, y1h, data.mask, gp._tol,
                                         prepare_gram_cache(kernel, data.x))
    theta_fit = model.raw_predictor.theta
    f_warm = objective(theta_fit, torch.zeros_like(y1h))[2]
    before = (spd.spd_inv_logdet.launches, lap_mc.laplace_mc_mode.iterations,
              lap_mc.batched_neg_logz_mc.calls)
    prof = profile_objective(torch, lambda theta: objective(theta, f_warm), theta_fit,
                             shares={"spd_inv_logdet": ("spd_inv_logdet",)})
    prof["newton_per_eval"] = ((lap_mc.laplace_mc_mode.iterations - before[1])
                               / (lap_mc.batched_neg_logz_mc.calls - before[2]))
    spd.spd_inv_logdet.launches = launches
    HOST_FITS["iris_native"] = native
    spread = abs(native["accuracy"] - JAX_CPU_ACCURACY["iris_native"])
    emit({"phase": "iris-native", "shape": [7, 20, 3], "b_stack": [21, 20], **native,
          "launches": launches, "probe_launches": probe_native,
          "launches_rule": "newton_iterations + 2 * objective_calls + probes",
          "host_reads": iterations + 2 * calls,
          "newton_loop_lengths": {str(n): lengths.count(n) for n in sorted(set(lengths))},
          "bar": GPC_BARS["iris_native"],
          "jax_cpu_accuracy": JAX_CPU_ACCURACY["iris_native"], "spread": spread,
          "cpu": native_cpu, "eval_profile": prof})
    if not (native["accuracy"] > GPC_BARS["iris_native"]
            and spread <= IRIS_NATIVE_SPREAD["exact"]):
        raise AssertionError(f"iris-native 10-fold accuracy {native['accuracy']}: bar "
                             f"{GPC_BARS['iris_native']}, JAX {JAX_CPU_ACCURACY['iris_native']}")

    # 19. iris-native-iterative: the same CV on the iterative lane, whose
    # Newton steps are CG solves on the factored operator and whose
    # determinant is SLQ: no K1 launch
    zero(spd.spd_inv_logdet)
    try:
        it_ops.set_solver_lane("iterative")
        native_it = iris_native_cv(torch, cdata)
    finally:
        it_ops.set_solver_lane(None)
    launches_iterative = spd.spd_inv_logdet.launches
    HOST_FITS["iris_native_iterative"] = native_it
    spread_it = abs(native_it["accuracy"] - JAX_CPU_ACCURACY["iris_native_iterative"])
    emit({"phase": "iris-native-iterative", **native_it, "solver_lane": "iterative",
          "launches": launches_iterative,
          "jax_cpu_accuracy": JAX_CPU_ACCURACY["iris_native_iterative"],
          "spread": spread_it})
    if launches_iterative != 0 or spread_it > IRIS_NATIVE_SPREAD["iterative"]:
        raise AssertionError(f"iris-native-iterative: {launches_iterative} K1 launches, "
                             f"accuracy {native_it['accuracy']}")
    return {"launches_iris_native": launches,
            "engaged": {"iris_native": native["gram_cache_engaged"]}}


def gram_cache_phase(torch, lap, cdata: dict, theta_gpc_mnist, engaged: dict) -> None:
    """20. gram-cache: the cached RBF gram against the uncached one on the
    card, within float32 rounding (and, recorded, each against the
    float64 gram on the CPU) at the gpc-mnist and iris stacks; which configs engaged the cache (asserted); one
    gpc-mnist evaluation at the fitted theta with the cache and with
    ``GP_GRAM_CACHE=0``, in turns (cached, uncached, uncached, cached),
    under the profiler.  No speed is claimed: the distance GEMM the cache
    saves is a few microseconds of an evaluation that is mostly idle."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack, prepare_gram_cache
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    xm_tr, ym_tr = cdata["xm"][cdata["tr_m"]], cdata["ym"][cdata["tr_m"]]
    train_i = cdata["folds_i"][0][0]
    grams = {}
    for label, gp, xs, ys in [("gpc_mnist", mnist_gpc(), xm_tr, ym_tr),
                              ("iris", iris_native_gpc(), cdata["xi"][train_i],
                               cdata["yi"][train_i])]:
        kernel = gp._get_kernel()
        out = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            data = gp._group(xs, ys, torch.device(device))
            theta = torch.as_tensor(kernel.init_theta(), dtype=dtype, device=device)
            out[device] = (masked_gram_stack(kernel, theta, data.x, data.mask,
                                             prepare_gram_cache(kernel, data.x)),
                           masked_gram_stack(kernel, theta, data.x, data.mask))
        (cached, plain), (ref, _) = out["cuda"], out["cpu"]
        grams[label] = {
            "shape": list(gp._group(xs, ys, torch.device("cpu")).x.shape),
            "max_abs_cached_vs_uncached": (cached - plain).abs().max().item(),
            "max_abs_cached_vs_f64": (cached.double().cpu() - ref).abs().max().item(),
            "max_abs_uncached_vs_f64": (plain.double().cpu() - ref).abs().max().item(),
        }
        # entries are at most 1: float32 rounding is a few times 1.2e-7
        # (the distances' own float32 error, ~1e-5 on iris's unscaled
        # features, is the same with and without the cache: recorded)
        if not grams[label]["max_abs_cached_vs_uncached"] <= 4 * 1.2e-7:
            raise AssertionError(f"cached {label} gram off the uncached one: {grams[label]}")
    expected = {"gpc_mnist": [1.0], "iris_ovr": [1.0], "iris_native": [1.0],
                "airfoil": [0.0], "airfoil_expert450": [0.0], "protein": [0.0],
                "protein_matfree": [0.0]}
    if engaged != expected:
        raise AssertionError(f"gram_cache_engaged {engaged}, expected {expected}")

    kernel = mnist_gpc()._get_kernel()
    data = group_for_experts(xm_tr, ym_tr, 100, dtype=torch.float32, device="cuda")
    caches = {"cached": prepare_gram_cache(kernel, data.x)}
    os.environ["GP_GRAM_CACHE"] = "0"
    try:
        caches["uncached"] = prepare_gram_cache(kernel, data.x)
    finally:
        del os.environ["GP_GRAM_CACHE"]
    if caches["cached"] is None or caches["uncached"] is not None:
        raise AssertionError("GP_GRAM_CACHE did not switch the gpc-mnist cache")
    metrics = ("eval_wall_ms", "eval_device_ms", "device_busy_share",
               "kernel_launches_per_eval")
    turns = {"cached": [], "uncached": []}
    for key in ("cached", "uncached", "uncached", "cached"):
        objective = lap.make_laplace_objective(kernel, data, 1e-3, caches[key])
        f_warm = objective(theta_gpc_mnist, torch.zeros_like(data.y))[2]
        prof = profile_objective(torch, lambda theta: objective(theta, f_warm),
                                 theta_gpc_mnist)
        turns[key].append({metric: prof[metric] for metric in metrics})
    evals = {key: {metric: float(np.mean([r[metric] for r in runs])) for metric in metrics}
             for key, runs in turns.items()}
    emit({"phase": "gram-cache", "grams": grams, "engaged": engaged,
          "gpc_mnist_eval": evals, "gpc_mnist_eval_turns": turns})


def synthetics_gp(objective: str = "marginal", device=None):
    """examples/synthetics.py ``make_gp`` (Synthetics.scala), copied:
    ``1.0 * RBF(0.1, 1e-6, 10) + WhiteNoise(0.5, 0, 1)`` with sigma2 1e-3,
    or for the ELBO the kernel without the noise term and sigma2 1e-2;
    the k-means provider, expert 100, active 100, seed 13."""
    from spark_gp_tpu_torch import (
        GaussianProcessRegression,
        KMeansActiveSetProvider,
        RBFKernel,
        WhiteNoiseKernel,
    )

    if objective == "elbo":
        def kernel_factory():
            return 1.0 * RBFKernel(0.1, 1e-6, 10)
        sigma2 = 1e-2
    else:
        def kernel_factory():
            return 1.0 * RBFKernel(0.1, 1e-6, 10) + WhiteNoiseKernel(0.5, 0, 1)
        sigma2 = 1e-3
    return (
        GaussianProcessRegression(device=device)
        .setKernel(kernel_factory)
        .setDatasetSizeForExpert(100)
        .setActiveSetProvider(KMeansActiveSetProvider())
        .setActiveSetSize(100)
        .setSeed(13)
        .setSigma2(sigma2)
        .setObjective(objective)
    )


def timeseries_signal(x):
    """examples/timeseries.py ``signal``, copied: two frequencies."""
    return np.cos(2 * np.pi * 1.0 * x[:, 0]) + 0.5 * np.cos(2 * np.pi * 2.6 * x[:, 0])


def timeseries_data():
    """examples/timeseries.py ``make_data``, copied: three periods in
    (240 points), one out (60)."""
    rng = np.random.default_rng(0)
    xs = np.linspace(0, 3, 240)[:, None]
    xe = np.linspace(3, 4, 60)[:, None]
    return xs, timeseries_signal(xs) + 0.03 * rng.normal(size=240), xe, timeseries_signal(xe)


def timeseries_gp(kind: str = "sm", restarts: int = 8, device=None):
    """examples/timeseries.py ``make_gp``, copied: the spectral mixture
    (or the RBF contrast), expert 120, active 100, sigma2 1e-3, seed 3,
    maxiter 150, ``restarts`` host restarts."""
    from spark_gp_tpu_torch import (
        GaussianProcessRegression,
        RBFKernel,
        SpectralMixtureKernel,
        WhiteNoiseKernel,
    )

    if kind == "rbf":
        def kernel_factory():
            return 1.0 * RBFKernel(1.0, 1e-3, 100) + WhiteNoiseKernel(0.05, 0, 1)
    else:
        def kernel_factory():
            return (1.0 * SpectralMixtureKernel(1, 3, means=np.array([[0.8], [2.0], [3.0]]))
                    + WhiteNoiseKernel(0.05, 0, 1))
    return (
        GaussianProcessRegression(device=device)
        .setKernel(kernel_factory)
        .setDatasetSizeForExpert(120)
        .setActiveSetSize(100)
        .setSigma2(1e-3)
        .setSeed(3)
        .setMaxIter(150)
        .setNumRestarts(restarts)
    )


def regression_data() -> dict:
    """The Synthetics data (2000 x 1) with its 10 CV folds at seed 13 and
    quality.py's objectives split (``default_rng(5)``, 1500 / 500); the
    timeseries data."""
    from spark_gp_tpu_torch.data import make_synthetics
    from spark_gp_tpu_torch.utils.validation import kfold_indices

    x, y = make_synthetics()
    perm = np.random.default_rng(5).permutation(len(y))
    return {"x": x, "y": y, "folds": list(kfold_indices(x.shape[0], 10, seed=13)),
            "tr": perm[:1500], "te": perm[1500:], "ts": timeseries_data()}


def regression_stacks(torch, d: dict) -> dict:
    """The gram stacks the new regression configs hand K1 at init theta:
    the first Synthetics fold's (18, 100), all 2000 rows' (20, 100, the
    ``gp.loo`` stack) and the timeseries spectral mixture's (2, 120)."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack

    xs, ys = d["ts"][:2]
    train = d["folds"][0][0]
    stacks = {}
    for label, gp, x, y, shape in [
        ("synthetics_fold", synthetics_gp(), d["x"][train], d["y"][train], (18, 100)),
        ("synthetics_all", synthetics_gp(), d["x"], d["y"], (20, 100)),
        ("timeseries", timeseries_gp(), xs, ys, (2, 120)),
    ]:
        kernel = gp._get_kernel()
        data = gp._group(x, y, torch.device("cuda"))
        theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device="cuda")
        stacks[label] = masked_gram_stack(kernel, theta, data.x, data.mask)
        if tuple(stacks[label].shape) != (shape[0], shape[1], shape[1]):
            raise AssertionError(f"{label} stack {tuple(stacks[label].shape)}, expected {shape}")
    return stacks


def check_loo_cotangent(torch, spd, d: dict) -> dict:
    """The LOO objective's cotangent through K1's VJP: the gradient in K of
    ``-sum(log p(y_i | y_-i))`` on the first Synthetics fold's (18, 100)
    stack at init theta, through K1 (float32) against the same through
    ``spd_inv_logdet_plain`` in float64 on the input upcast; the first
    cotangent with a diagonal term and a y-dependent rank-one part.  That
    cotangent is not symmetric, so K1's VJP (``-K^-1 G K^-1``) is not
    either, while the Cholesky backward returns its symmetric part; the
    gram is symmetric, so theta sees only that part, and the symmetric
    parts are compared.  Bar as the backward check's: within 1e-4 of
    |ref| + max|ref|."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack
    from spark_gp_tpu_torch.models.loo import moments_from_inverse

    train = d["folds"][0][0]
    gp = synthetics_gp()
    kernel = gp._get_kernel()
    data = gp._group(d["x"][train], d["y"][train], torch.device("cuda"))
    theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device="cuda")
    k32 = masked_gram_stack(kernel, theta, data.x, data.mask).detach()
    grads, values = [], []
    for fn, dtype in [(spd.spd_inv_logdet, torch.float32),
                      (spd.spd_inv_logdet_plain, torch.float64)]:
        kk = k32.to(dtype, copy=True).requires_grad_(True)
        mask = data.mask.to(dtype)
        _, _, logp = moments_from_inverse(fn(kk)[0], data.y.to(dtype) * mask)
        value = -torch.sum(logp * mask)
        value.backward()
        torch.cuda.synchronize()
        grads.append(0.5 * (kk.grad + kk.grad.mT).double())
        values.append(value.item())
    ref = grads[1]
    err = (grads[0] - ref).abs()
    if not bool((err <= 1e-4 * (ref.abs() + ref.abs().max())).all()):
        raise AssertionError(f"LOO cotangent at (18, 100): err {err.max().item()}")
    return {"shape": [18, 100], "max_abs_err": err.max().item(),
            "max_abs_ref": ref.abs().max().item(),
            "rel_value_err": abs(values[0] - values[1]) / abs(values[1]),
            "diag_share": float(torch.diagonal(ref, dim1=-2, dim2=-1).abs().sum()
                                / ref.abs().sum())}


def regression_phases(torch, spd, d: dict, smi: str) -> dict:
    """The Synthetics and timeseries configs, the LOO and ELBO objectives
    and the new kernel families (the phases after gram-cache in the module
    doc); returns K1's launches on each."""
    from spark_gp_tpu_torch.kernels.base import prepare_gram_cache
    from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.utils.validation import nlpd, rmse

    start_all = time.perf_counter()
    x, y, tr, te = d["x"], d["y"], d["tr"], d["te"]
    launches = {}

    # synthetics: examples/synthetics.py verbatim, 10-fold CV at seed 13
    # (E = 18, s = 100 on every fold); K1 once an evaluation; the
    # isotropic RBF engages the gram cache
    zero(spd.spd_inv_logdet)
    cv = regression_cv(synthetics_gp(), x, y, d["folds"])
    cv.pop("first_model")
    cv["launches"] = launches["synthetics"] = spd.spd_inv_logdet.launches
    cv["probe_launches"] = probes(spd.spd_inv_logdet)
    emit({"phase": "synthetics", **cv, "bar": SYNTHETICS_BAR,
          "jax_cpu_rmse": JAX_CPU_REGRESSION["synthetics_cv_rmse"]})
    if not (cv["rmse"] < SYNTHETICS_BAR and cv["experts"] == [(18, 100)]
            and cv["launches"] == cv["nfev"] + cv["probe_launches"] > 0
            and cv["probe_launches"] == len(d["folds"]) and cv["gram_cache_engaged"] == [1.0]):
        raise AssertionError(f"synthetics: {cv}")
    HOST_FITS["synthetics"] = {"rmse": cv["rmse"]}

    # synthetics-objectives: quality.py's objectives part, one fit per
    # objective on the 1500 / 500 split (E = 15, s = 100).  K1 once an
    # evaluation for the marginal NLL and for LOO; none for the ELBO,
    # whose [m, m] factors are torch.linalg calls; the ELBO takes no gram
    # cache
    objectives, models = {}, {}
    for objective, rule, cached in (("marginal", 1, 1.0), ("loo", 1, 1.0), ("elbo", 0, 0.0)):
        zero(spd.spd_inv_logdet)
        start = time.perf_counter()
        model = synthetics_gp(objective).fit(x[tr], y[tr])
        mean, var = model.predict_with_var(x[te])
        seconds = time.perf_counter() - start
        m = model.metrics
        models[objective] = model
        objectives[objective] = {
            "rmse": rmse(y[te], mean), "nlpd": nlpd(y[te], mean, var),
            "final_objective": m["final_nll"], "nfev": m["lbfgs_nfev"],
            "launches": spd.spd_inv_logdet.launches, "seconds": seconds,
            "probe_launches": probes(spd.spd_inv_logdet),
            "gram_cache_engaged": m["gram_cache_engaged"],
            **{key: m[key] for key in PHASES},
            "jax_cpu": JAX_CPU_REGRESSION["objectives"][objective]}
        launches[f"objectives_{objective}"] = spd.spd_inv_logdet.launches
        row = objectives[objective]
        if not (row["rmse"] < SYNTHETICS_BAR and np.isfinite(row["nlpd"])
                and row["launches"] == rule * row["nfev"] + row["probe_launches"]
                and row["probe_launches"] == 1 and row["nfev"] > 0
                and row["gram_cache_engaged"] == cached and m["objective"] == objective
                and (m["num_experts"], m["expert_size"]) == (15, 100)):
            raise AssertionError(f"synthetics-objectives {objective}: {row}")
    emit({"phase": "synthetics-objectives", "split": [1500, 500], "bar": SYNTHETICS_BAR,
          **objectives})

    # synthetics-loo: the marginal fit on all 2000 rows, then gp.loo at
    # its theta: one K1 launch at (20, 100)
    zero(spd.spd_inv_logdet)
    gp = synthetics_gp()
    model = gp.fit(x, y)
    fit_launches = spd.spd_inv_logdet.launches
    if fit_launches != model.metrics["lbfgs_nfev"] + probes(spd.spd_inv_logdet):
        raise AssertionError(f"synthetics-loo fit: {fit_launches} K1 launches for "
                             f"{model.metrics['lbfgs_nfev']} evaluations and "
                             f"{probes(spd.spd_inv_logdet)} probes")
    zero(spd.spd_inv_logdet)
    start = time.perf_counter()
    diag = gp.loo(x, y, model)
    loo_seconds = time.perf_counter() - start
    loo_launches = spd.spd_inv_logdet.launches
    launches["synthetics_loo"] = fit_launches + loo_launches
    ratio = diag["loo_rmse"] / cv["rmse"]
    emit({"phase": "synthetics-loo", "loo_rmse": diag["loo_rmse"], "cv_rmse": cv["rmse"],
          "ratio": ratio, "loo_log_pseudo_likelihood": diag["loo_log_pseudo_likelihood"],
          "loo_seconds": loo_seconds, "loo_launches": loo_launches,
          "fit_nfev": model.metrics["lbfgs_nfev"], "fit_launches": fit_launches,
          "shape": [model.metrics["num_experts"], model.metrics["expert_size"]],
          "bar": SYNTHETICS_BAR, "ratio_band": [0.5, 2.0],
          "jax_cpu": {"loo_rmse": JAX_CPU_REGRESSION["loo_rmse"],
                      "ratio": JAX_CPU_REGRESSION["loo_cv_ratio"]}})
    if not (diag["loo_rmse"] < SYNTHETICS_BAR and 0.5 < ratio < 2.0 and loo_launches == 1
            and (model.metrics["num_experts"], model.metrics["expert_size"]) == (20, 100)):
        raise AssertionError(f"synthetics-loo: loo_rmse {diag['loo_rmse']}, ratio {ratio}, "
                             f"{loo_launches} K1 launches")

    # objective-parity: the LOO and ELBO objectives and their gradients on
    # the card (float32) against the CPU (float64), on the objectives
    # split's training stack, at init theta and at the card fit's theta*
    # (the ELBO over the fit's own inducing set).  The gradient's error is
    # taken over the largest component of the init-theta gradient: at
    # theta* the gradient is close to 0.  Then one evaluation of each at
    # theta* under the profiler.  None of these launches is the main path's.
    before = spd.spd_inv_logdet.launches
    parity, profiles = {}, {}
    for objective in ("loo", "elbo"):
        model = models[objective]
        kernel = model.raw_predictor.kernel
        extra = (model.raw_predictor.active, synthetics_gp(objective)._sigma2) \
            if objective == "elbo" else ()
        sides = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            data = group_for_experts(x[tr], y[tr], 100, dtype=dtype, device=device)
            cache = None if objective == "elbo" else prepare_gram_cache(kernel, data.x)
            sides[device] = make_value_and_grad(kernel, data, cache, objective, extra)
        points, scale = [], None
        bar_v, bar_g = OBJECTIVE_BARS[objective]
        for label, theta in (("init", kernel.init_theta()), ("fit", model.raw_predictor.theta)):
            (v_gpu, g_gpu), (v_cpu, g_cpu) = sides["cuda"](theta), sides["cpu"](theta)
            scale = scale or float(np.max(np.abs(g_cpu)))
            dv = abs(v_gpu - v_cpu) / abs(v_cpu)
            dg = float(np.max(np.abs(g_gpu - g_cpu))) / scale
            points.append({"theta": label, "value_cuda": v_gpu, "value_cpu": v_cpu,
                           "grad_cuda": g_gpu.tolist(), "grad_cpu": g_cpu.tolist(),
                           "rel_value_err": dv, "rel_grad_err": dg})
            if not (dv <= bar_v and dg <= bar_g):
                raise AssertionError(f"{objective} card vs CPU at {label} theta: rel dv {dv}, "
                                     f"dg {dg}")
        parity[objective] = {"bars": {"rel_value": bar_v, "rel_grad": bar_g}, "points": points}
        profiles[objective] = profile_objective(
            torch, sides["cuda"], model.raw_predictor.theta,
            shares={"spd_inv_logdet": ("spd_inv_logdet",)})
    spd.spd_inv_logdet.launches = before
    emit({"phase": "objective-parity", "shape": [15, 100], **parity, "eval_profile": profiles})

    # timeseries-sm: examples/timeseries.py make_gp("sm", 8) verbatim
    # (E = 2, s = 120): eight host restarts, K1 once an evaluation of
    # every restart; the spectral mixture has no gram cache.  Then the
    # RBF contrast, with no bar
    ts = {}
    xs, ys, xe, ye = d["ts"]
    for kind in ("sm", "rbf"):
        zero(spd.spd_inv_logdet)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        model = timeseries_gp(kind).fit(xs, ys)
        pred = model.predict(xe)
        seconds = time.perf_counter() - start
        m = model.metrics
        ts[kind] = {"extrapolation_rmse": rmse(ye, pred), "seconds": seconds,
                    "restart_nlls": [m[f"restart_{r}_nll"] for r in range(m["num_restarts"])],
                    "best_restart": m["best_restart"], "restarts_nfev": m["restarts_nfev"],
                    "best_nfev": m["lbfgs_nfev"], "launches": spd.spd_inv_logdet.launches,
                    "probe_launches": probes(spd.spd_inv_logdet),
                    "gram_cache_engaged": m["gram_cache_engaged"],
                    "shape": [m["num_experts"], m["expert_size"]],
                    "peak_cuda_bytes_above_base": torch.cuda.max_memory_allocated() - base,
                    **{key: m[key] for key in PHASES}}
        launches[f"timeseries_{kind}"] = spd.spd_inv_logdet.launches
        if not (np.all(np.isfinite(pred))
                and ts[kind]["launches"] == m["restarts_nfev"] + ts[kind]["probe_launches"]
                and ts[kind]["shape"] == [2, 120]
                and m["gram_cache_engaged"] == (0.0 if kind == "sm" else 1.0)):
            raise AssertionError(f"timeseries-{kind}: {ts[kind]}")
    HOST_FITS["timeseries"] = {key: ts["sm"][key] for key in (
        "extrapolation_rmse", "restart_nlls", "best_restart", "restarts_nfev",
        "optimize_seconds", "seconds")}
    emit({"phase": "timeseries-sm", **ts["sm"], "bar": TIMESERIES_BAR,
          "jax_cpu_rmse": JAX_CPU_REGRESSION["sm_extrapolation_rmse"],
          "rbf_contrast": ts["rbf"],
          "rbf_jax_cpu_rmse": JAX_CPU_REGRESSION["rbf_extrapolation_rmse"]})
    if not ts["sm"]["extrapolation_rmse"] < TIMESERIES_BAR:
        raise AssertionError(f"timeseries-sm extrapolation RMSE "
                             f"{ts['sm']['extrapolation_rmse']} >= {TIMESERIES_BAR}")

    # kernel-families: each new kernel (and RBF * Periodic, RBF *
    # Matern12) on the card in float32 against the port on the CPU in
    # float64 at E = 4, s = 100, p = 5: gram, cross, and one exact-lane
    # NLL and gradient (plus white noise and sigma2 I), the product of
    # isotropic kernels through its gram cache.  Recorded, with one bar:
    # the periodic gram's cos-sum cancellation, widest at p = 5, within
    # 1e-5 of the CPU's (entries are at most 1)
    launches_before = spd.spd_inv_logdet.launches
    families = kernel_family_checks(torch)
    spd.spd_inv_logdet.launches = launches_before
    emit({"phase": "kernel-families", "shape": [4, 100, 5], "families": families})

    seconds = time.perf_counter() - start_all
    emit({"phase": "regression-phases", "seconds": seconds, "card": smi})
    return launches


def kernel_family_checks(torch) -> dict:
    """The kernel-families phase's numbers (see ``regression_phases``)."""
    import spark_gp_tpu_torch as tgp
    from spark_gp_tpu_torch.kernels.base import prepare_gram_cache
    from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    p = 5
    families = {
        "ard_matern32": lambda: tgp.ARDMatern32Kernel(p, 0.7),
        "ard_matern52": lambda: tgp.ARDMatern52Kernel(p, 0.7),
        "ard_rq": lambda: tgp.ARDRationalQuadraticKernel(p, 0.7, 1.5),
        "periodic": lambda: tgp.PeriodicKernel(2.0, 0.9),
        "spectral_mixture": lambda: tgp.SpectralMixtureKernel(p, 3),
        "rbf_x_periodic": lambda: tgp.RBFKernel(1.5) * tgp.PeriodicKernel(2.0, 0.9),
        "rbf_x_matern12": lambda: tgp.RBFKernel(1.5) * tgp.Matern12Kernel(1.2),
    }
    rng = np.random.default_rng(17)
    x, xt = rng.normal(size=(400, p)), rng.normal(size=(4, 30, p))
    y = np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=400)
    out = {}
    for name, make in families.items():
        kernel = make() + tgp.WhiteNoiseKernel(0.1, 0, 1) + tgp.Const(1e-3) * tgp.EyeKernel()
        theta = kernel.init_theta() * np.linspace(0.9, 1.1, kernel.n_hypers)
        side = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            data = group_for_experts(x, y, 100, dtype=dtype, device=device)
            cache = prepare_gram_cache(kernel, data.x)
            th = torch.as_tensor(theta, dtype=dtype, device=device)
            xtd = torch.as_tensor(xt, dtype=dtype, device=device)
            with torch.no_grad():
                gram = make().gram(th[:make().n_hypers], data.x)
                cross = make().cross(th[:make().n_hypers], xtd, data.x)
            value, grad = make_value_and_grad(kernel, data, cache)(theta)
            side[device] = (gram.double().cpu(), cross.double().cpu(), value, grad,
                            cache is not None)
        (g32, c32, v32, gr32, cached), (g64, c64, v64, gr64, _) = side["cuda"], side["cpu"]
        out[name] = {
            "gram_max_abs_err": (g32 - g64).abs().max().item(),
            "gram_max_rel_err": ((g32 - g64).abs().max() / g64.abs().max()).item(),
            "cross_max_rel_err": ((c32 - c64).abs().max() / c64.abs().max()).item(),
            "nll_rel_err": abs(v32 - v64) / abs(v64),
            "grad_rel_err": float(np.max(np.abs(gr32 - gr64)) / np.max(np.abs(gr64))),
            "gram_cache_engaged": cached,
        }
        finite = np.isfinite(v32) and np.all(np.isfinite(gr32))
        if not finite or (name == "rbf_x_matern12") != cached \
                or (name == "periodic" and not out[name]["gram_max_abs_err"] <= 1e-5):
            raise AssertionError(f"kernel-families {name}: {out[name]}")
    return out


# the JAX package's numbers on this slice's configs on the CPU
# (QUALITY_r05.json: the greedy_vs_random, greedy_scale, iris_ep and
# poisson parts), for comparison
JAX_CPU_SLICE6 = {
    "greedy_rmse": 0.010887112873454743,
    "random_rmses": [0.1530516769296176, 0.15334854217587543, 0.14690949019052327],
    "greedy_scale": {"greedy": 0.6051842540933051, "random": 0.6095638809416019,
                     "greedy_fit_seconds": 22.400155260998872,
                     "greedy_active_set_seconds": 16.847409398003947},
    "iris_ep": 0.9400000000000001,
    "poisson": 0.024360798610672363, "poisson_nb": 0.04785056044988611,
}
# quality.py's bars: greedy below 0.05 and below the best random seed;
# each greedy-scale RMSE within 0.02 of the JAX package's; iris EP; the
# Poisson and NB rate errors (the iterative lane held to Poisson's)
SLICE6_BARS = {"greedy": 0.05, "greedy_scale_spread": 0.02, "iris_ep": 0.9,
               "poisson": 0.1, "poisson_nb": 0.15, "poisson_iterative": 0.1}
# the joint posterior: predict_with_cov's diagonal against predict_with_var
# (float32 on the card), over the prior variance k(x, x): the variance
# k(x, x) + k(x, A) M k(x, A)^T cancels ~1.5 to ~0.01 here, so float32
# rounding of the two evaluation orders is ~1e-7 of k(x, x) and ~1e-5 of
# the variance itself (recorded); and update's float64 statistics
# against the A u B statistics
JOINT_BARS = {"cov_diag_rel_prior": 1e-5, "update_stats_rel": 1e-8}
# card vs CPU and K1 route vs Cholesky route on the EP and generic
# Laplace objectives: the classifiers' bars (value; gradient over its
# largest component at init theta)
NEW_OBJECTIVE_BARS = (1e-4, 1e-3)


def greedy_vs_random_data():
    """quality.py ``part_greedy_vs_random``'s data, copied: 2000 points,
    95% of them in [0, 0.5), the rest spread over [0.5, 20)."""
    rng = np.random.default_rng(7)
    n = 2000
    x = np.concatenate(
        [rng.uniform(0.0, 0.5, size=int(0.95 * n)),
         rng.uniform(0.5, 20.0, size=n - int(0.95 * n))]
    )[:, None]
    return x, np.sin(1.5 * x[:, 0]) + 0.01 * rng.normal(size=n)


def greedy_vs_random_gp(provider, seed: int, device=None):
    """quality.py ``part_greedy_vs_random``'s estimator, copied:
    ``RBF(0.3, 1e-6, 10)``, active 24, maxiter 30."""
    from spark_gp_tpu_torch import GaussianProcessRegression, RBFKernel

    return (GaussianProcessRegression(device=device)
            .setKernel(lambda: RBFKernel(0.3, 1e-6, 10)).setActiveSetSize(24)
            .setActiveSetProvider(provider).setMaxIter(30).setSeed(seed))


def prep_regression(loader, n: int):
    """quality.py ``_prep_regression``, copied: the 80/20 split at seed 13,
    features z-scored and targets standardized on the training rows;
    ``(x, ys, tr, te)``."""
    from spark_gp_tpu_torch.ops.scaling import fit_scaler

    x, y = loader(None, n=n)
    perm = np.random.default_rng(13).permutation(x.shape[0])
    cut = int(0.8 * x.shape[0])
    tr, te = perm[:cut], perm[cut:]
    mean, std = fit_scaler(x[tr])
    x = (x - mean) / std
    return x, (y - y[tr].mean()) / y[tr].std(), tr, te


def ard_kernel_factory(p: int):
    """quality.py ``_ard_kernel_factory``, copied: dimension-aware ARD init
    and trained white noise."""
    from spark_gp_tpu_torch import ARDRBFKernel, WhiteNoiseKernel

    return lambda: 1.0 * ARDRBFKernel(p, p ** -0.5) + WhiteNoiseKernel(0.1, 0.0, 1.0)


def greedy_scale_gp(provider, max_iter: int, p: int, m: int = 512):
    """quality.py ``part_greedy_scale``'s ``make_gp``, copied: expert 100,
    active ``m``, seed 13."""
    from spark_gp_tpu_torch import GaussianProcessRegression

    return (GaussianProcessRegression().setKernel(ard_kernel_factory(p))
            .setDatasetSizeForExpert(100).setActiveSetSize(m)
            .setActiveSetProvider(provider).setMaxIter(max_iter).setSeed(13))


def ep_gpc(device=None):
    """examples/iris.py ``make_ep_gpc``, copied: the EP engine at expert 20,
    active 30."""
    from spark_gp_tpu_torch import GaussianProcessEPClassifier

    return GaussianProcessEPClassifier(device=device).setDatasetSizeForExpert(20) \
        .setActiveSetSize(30)


def poisson_data() -> dict:
    """quality.py ``part_poisson``'s data, copied: rate exp(1 + sin 2x) on
    2000 points of [0, 4] at seed 42, Poisson counts, then gamma-Poisson
    (dispersion 2) counts from the same generator."""
    rng = np.random.default_rng(42)
    n = 2000
    x = np.linspace(0, 4, n)[:, None]
    rate = np.exp(1.0 + np.sin(2 * x[:, 0]))
    y = rng.poisson(rate).astype(np.float64)
    lam = rate * rng.gamma(shape=2.0, scale=0.5, size=n)
    return {"x": x, "rate": rate, "y": y, "y_nb": rng.poisson(lam).astype(np.float64)}


def poisson_gp(dispersion=None, device=None):
    """quality.py ``part_poisson``'s estimators, copied: ``1.0 * RBF(0.5,
    1e-2, 10)``, active 100, maxiter 25 (expert 100, sigma2 1e-3)."""
    from spark_gp_tpu_torch import (
        GaussianProcessNegativeBinomialRegression,
        GaussianProcessPoissonRegression,
        RBFKernel,
    )

    gp = (GaussianProcessPoissonRegression(device=device) if dispersion is None
          else GaussianProcessNegativeBinomialRegression(dispersion, device=device))
    return gp.setKernel(lambda: 1.0 * RBFKernel(0.5, 1e-2, 10.0)).setActiveSetSize(100) \
        .setMaxIter(25)


def timed_greedy():
    """The greedy provider, recording the seconds of each selection (the
    card synchronized at both ends) in ``seconds``."""
    import torch

    from spark_gp_tpu_torch import GreedilyOptimizingActiveSetProvider

    class Timed(GreedilyOptimizingActiveSetProvider):
        def __init__(self):
            self.seconds = []

        def __call__(self, *args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            rows = super().__call__(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - start)
            return rows

    return Timed()


def slice6_data() -> dict:
    """The data of this slice's configs: greedy-vs-random's, the Year-MSD
    stand-in (50,000 x 90) prepared as quality.py does, the Poisson / NB
    counts."""
    from spark_gp_tpu_torch.data import load_year_msd

    xg, yg = greedy_vs_random_data()
    xy, ysy, tr, te = prep_regression(load_year_msd, 50000)
    return {"xg": xg, "yg": yg, "xy": xy, "ysy": ysy, "tr_y": tr, "te_y": te,
            **poisson_data()}


def slice6_stacks(torch, ep, lg, d6: dict, cdata: dict) -> dict:
    """The stacks this slice hands K1, from the fits' own inputs at init
    theta: EP's B = I + S K S at the converged sites of the first iris
    fold's first one-vs-rest problem (7, 20); the generic Laplace's
    B = I + W^1/2 K W^1/2 at the Poisson config's converged mode
    (20, 100); the greedy-scale fit's marginal gram stack (400, 100)."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack

    dev = torch.device("cuda")
    out = {}
    train = cdata["folds_i"][0][0]
    gp = ep_gpc()
    kernel = gp._get_kernel()
    data = gp._group(cdata["xi"][train], (cdata["yi"][train] == 0).astype(np.float64), dev)
    theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device=dev)
    kmat = masked_gram_stack(kernel, theta, data.x, data.mask)
    zeros = torch.zeros_like(data.y)
    tau, _, _ = ep.ep_fit_sites(kmat, (2.0 * data.y - 1.0) * data.mask, data.mask, zeros,
                                zeros, gp._tol)
    sq = torch.sqrt(tau)
    out["ep_iris_b"] = (torch.eye(kmat.shape[-1], device=dev)
                        + sq[:, :, None] * kmat * sq[:, None, :])

    gp = poisson_gp()
    kernel = gp._get_kernel()
    data = gp._group(d6["x"], d6["y"], dev)
    theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device=dev)
    kmat = masked_gram_stack(kernel, theta, data.x, data.mask)
    f, _ = lg.laplace_generic_mode(gp._likelihood, kmat, data.y, data.mask,
                                   torch.zeros_like(data.y), gp._tol)
    sqw = torch.sqrt(torch.exp(f) * data.mask)
    out["poisson_b"] = (torch.eye(kmat.shape[-1], device=dev)
                        + sqw[:, :, None] * kmat * sqw[:, None, :])

    gp = greedy_scale_gp(None, 12, d6["xy"].shape[1])
    kernel = gp._get_kernel()
    data = gp._group(d6["xy"][d6["tr_y"]], d6["ysy"][d6["tr_y"]], dev)
    theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device=dev)
    out["year_msd"] = masked_gram_stack(kernel, theta, data.x, data.mask)
    for label, shape in (("ep_iris_b", (7, 20)), ("poisson_b", (20, 100)),
                         ("year_msd", (400, 100))):
        if tuple(out[label].shape) != (shape[0], shape[1], shape[1]):
            raise AssertionError(f"{label} stack {tuple(out[label].shape)}, expected {shape}")
    return out


def count_fit(gp, d6: dict, y) -> dict:
    """A count-regression fit on quality.py's Poisson data: the mean
    relative error of the predicted rate against the planted one, the
    fit's metrics and Newton iterations per evaluation, the seconds."""
    start = time.perf_counter()
    model = gp.fit(d6["x"], y)
    rate = model.predict_rate(d6["x"])
    seconds = time.perf_counter() - start
    if not (np.all(np.isfinite(rate)) and rate.shape == d6["rate"].shape):
        raise AssertionError("count predictions not finite")
    m = model.metrics
    return {"mean_relative_rate_error": float(np.mean(np.abs(rate - d6["rate"]) / d6["rate"])),
            "seconds": seconds, "theta": model.raw_predictor.theta.tolist(),
            **{key: m[key] for key in ("num_experts", "expert_size", "solver_lane",
                                       "lbfgs_nfev", "newton_iterations", "objective_calls",
                                       "gram_cache_engaged") + PHASES},
            "newton_per_eval": m["newton_iterations"] / m["objective_calls"]}


def slice6_phases(torch, spd, d6: dict, rdata: dict, cdata: dict, smi: str) -> dict:
    """This slice's phases (the greedy provider, the joint posterior, EP,
    count regression; the module doc's phases after regression-phases);
    returns K1's launches on each."""
    from spark_gp_tpu_torch import RandomActiveSetProvider
    from spark_gp_tpu_torch.kernels.base import prepare_gram_cache
    from spark_gp_tpu_torch.models import ep
    from spark_gp_tpu_torch.models import laplace_generic as lg
    from spark_gp_tpu_torch.models.ppa import kmn_stats
    from spark_gp_tpu_torch.ops import iterative as it_ops
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.utils.validation import OneVsRest, rmse

    start_all = time.perf_counter()
    launches = {}

    # greedy-vs-random: quality.py's part verbatim (E = 20, s = 100): the
    # greedy fit at seed 13, random at seeds 13, 17, 29; RMSE on the
    # training rows; K1 once an evaluation of every fit
    zero(spd.spd_inv_logdet)
    start = time.perf_counter()
    rows, nfev = {}, 0
    for label, provider, seed in (("greedy", timed_greedy(), 13),
                                  ("random_13", RandomActiveSetProvider, 13),
                                  ("random_17", RandomActiveSetProvider, 17),
                                  ("random_29", RandomActiveSetProvider, 29)):
        fit_start = time.perf_counter()
        model = greedy_vs_random_gp(provider, seed).fit(d6["xg"], d6["yg"])
        pred = model.predict(d6["xg"])
        m = model.metrics
        rows[label] = {"rmse": rmse(d6["yg"], pred), "seconds": time.perf_counter() - fit_start,
                       "nfev": m["lbfgs_nfev"], "gram_cache_engaged": m["gram_cache_engaged"],
                       "shape": [m["num_experts"], m["expert_size"]]}
        if label == "greedy":
            rows[label]["active_set_seconds"] = provider.seconds[0]
        nfev += m["lbfgs_nfev"]
        if not (np.all(np.isfinite(pred)) and rows[label]["shape"] == [20, 100]):
            raise AssertionError(f"greedy-vs-random {label}: {rows[label]}")
    launches["greedy_vs_random"] = spd.spd_inv_logdet.launches
    probe = probes(spd.spd_inv_logdet)
    best_random = min(rows[k]["rmse"] for k in rows if k != "greedy")
    emit({"phase": "greedy-vs-random", **rows, "best_random_rmse": best_random,
          "launches": launches["greedy_vs_random"], "nfev": nfev, "probe_launches": probe,
          "seconds": time.perf_counter() - start, "bar": SLICE6_BARS["greedy"],
          "jax_cpu": {"greedy_rmse": JAX_CPU_SLICE6["greedy_rmse"],
                      "random_rmses": JAX_CPU_SLICE6["random_rmses"]}})
    if not (rows["greedy"]["rmse"] < SLICE6_BARS["greedy"] and rows["greedy"]["rmse"] < best_random
            and launches["greedy_vs_random"] == nfev + probe > 0 and probe == 4):
        raise AssertionError(f"greedy-vs-random: greedy {rows['greedy']['rmse']}, best random "
                             f"{best_random}, {launches['greedy_vs_random']} K1 launches for "
                             f"{nfev} evaluations and {probe} probes")

    # greedy-scale: quality.py's part verbatim on the Year-MSD stand-in
    # (40,000 x 90 training rows, E = 400, s = 100, m = 512): one warm-up
    # fit of each provider at maxiter 1, then greedy and random at
    # maxiter 12; K1 once an evaluation at (400, 100)
    xy, ysy, tr, te = d6["xy"], d6["ysy"], d6["tr_y"], d6["te_y"]
    p = xy.shape[1]
    zero(spd.spd_inv_logdet)
    nfev = 0
    start = time.perf_counter()
    for provider in (RandomActiveSetProvider, timed_greedy()):
        nfev += greedy_scale_gp(provider, 1, p).fit(xy[tr], ysy[tr]).metrics["lbfgs_nfev"]
    warmup_seconds = time.perf_counter() - start
    scale = {}
    for label, provider in (("greedy", timed_greedy()), ("random", RandomActiveSetProvider)):
        torch.cuda.synchronize()
        fit_start = time.perf_counter()
        model = greedy_scale_gp(provider, 12, p).fit(xy[tr], ysy[tr])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - fit_start
        pred = model.predict(xy[te])
        m = model.metrics
        scale[label] = {"fit_seconds": seconds, "rmse_scaled": rmse(ysy[te], pred),
                        "nfev": m["lbfgs_nfev"], "gram_cache_engaged": m["gram_cache_engaged"],
                        "shape": [m["num_experts"], m["expert_size"]],
                        **{key: m[key] for key in PHASES},
                        "jax_cpu_rmse": JAX_CPU_SLICE6["greedy_scale"][label]}
        if label == "greedy":
            scale[label]["active_set_seconds"] = provider.seconds[0]
        nfev += m["lbfgs_nfev"]
        if not (np.all(np.isfinite(pred)) and scale[label]["shape"] == [400, 100]
                and m["gram_cache_engaged"] == 0.0):
            raise AssertionError(f"greedy-scale {label}: {scale[label]}")
    launches["greedy_scale"] = spd.spd_inv_logdet.launches
    probe = probes(spd.spd_inv_logdet)
    emit({"phase": "greedy-scale", "n": int(xy.shape[0]), "p": p, "m": 512, **scale,
          "launches": launches["greedy_scale"], "nfev": nfev, "probe_launches": probe,
          "warmup_seconds": warmup_seconds,
          "seconds": time.perf_counter() - start,
          "bar_spread": SLICE6_BARS["greedy_scale_spread"],
          "jax_cpu_greedy_fit_seconds": JAX_CPU_SLICE6["greedy_scale"]["greedy_fit_seconds"],
          "jax_cpu_greedy_active_set_seconds":
              JAX_CPU_SLICE6["greedy_scale"]["greedy_active_set_seconds"], "card": smi})
    for label in ("greedy", "random"):
        if not abs(scale[label]["rmse_scaled"] - JAX_CPU_SLICE6["greedy_scale"][label]) \
                < SLICE6_BARS["greedy_scale_spread"]:
            raise AssertionError(f"greedy-scale {label} RMSE {scale[label]['rmse_scaled']}")
    if launches["greedy_scale"] != nfev + probe or probe != 4:
        raise AssertionError(f"greedy-scale: {launches['greedy_scale']} K1 launches for {nfev} "
                             f"evaluations and {probe} probes")

    # joint-posterior: the Synthetics config fitted on the objectives
    # split's 1500 rows (A); predict_with_cov against predict_with_var on
    # 200 held-out rows; 20,000 posterior draws at 50 of them against the
    # covariance; update with the 500 held-out rows (B) against the
    # statistics of A and B together at the same theta and active set
    x, y, tr_s, te_s = rdata["x"], rdata["y"], rdata["tr"], rdata["te"]
    zero(spd.spd_inv_logdet)
    start = time.perf_counter()
    model = synthetics_gp().fit(x[tr_s], y[tr_s])
    launches["joint_posterior"] = spd.spd_inv_logdet.launches
    probe = probes(spd.spd_inv_logdet)
    nfev = model.metrics["lbfgs_nfev"]
    xt = x[te_s][:200]
    mean, cov = model.predict_with_cov(xt)
    mean_v, var = model.predict_with_var(xt)
    prior = float(np.max(model.raw_predictor.kernel.self_diag(
        torch.as_tensor(model.raw_predictor.theta), torch.as_tensor(xt)).numpy()))
    diag_err = float(np.max(np.abs(np.diag(cov) - var))) / prior
    diag_err_var = float(np.max(np.abs(np.diag(cov) - var) / np.abs(var)))
    mean_err = float(np.max(np.abs(mean - mean_v)) / np.max(np.abs(mean_v)))
    n_draws = 20000
    draws = model.sample_posterior(xt[:50], n_samples=n_draws, seed=5)
    c50 = np.asarray(cov[:50, :50], dtype=np.float64)
    centered = draws - draws.mean(axis=0)
    sample_cov = centered.T @ centered / (n_draws - 1)
    cov_err = float(np.linalg.norm(sample_cov - c50) / np.linalg.norm(c50))
    # 5 standard deviations of a sample covariance's Frobenius error
    cov_bar = 5.0 * float(np.sqrt((np.linalg.norm(c50) ** 2 + np.trace(c50) ** 2)
                                  / n_draws) / np.linalg.norm(c50))
    updated = model.update(x[te_s], y[te_s])
    raw, up = model.raw_predictor, updated.raw_predictor
    # the statistics of A and B together: A's rows as the fit held them
    # (float32 on the card), B's as update reads them (float64)
    xa = x[tr_s].astype(np.float32).astype(np.float64)
    ya = y[tr_s].astype(np.float32).astype(np.float64)
    union = group_for_experts(np.concatenate([xa, x[te_s]]), np.concatenate([ya, y[te_s]]), 100,
                              dtype=torch.float64, device="cuda")
    u1, u2 = kmn_stats(raw.kernel, torch.as_tensor(raw.theta, device="cuda"),
                       torch.as_tensor(raw.active, device="cuda"), union)
    u1, u2 = u1.cpu().numpy(), u2.cpu().numpy()
    stats_err = max(float(np.max(np.abs(up.u1 - u1)) / np.max(np.abs(u1))),
                    float(np.max(np.abs(up.u2 - u2)) / np.max(np.abs(u2))))
    pred_up = updated.predict(x[te_s])
    joint = {"cov_diag_err_rel_prior": diag_err, "cov_diag_err_rel_var": diag_err_var,
             "prior_variance": prior, "mean_rel_err": mean_err, "t": 200,
             "draws": n_draws, "sample_cov_rel_fro_err": cov_err, "sample_cov_bar": cov_bar,
             "update_stats_rel_err": stats_err,
             "rmse_held_out_before": rmse(y[te_s], model.predict(x[te_s])),
             "rmse_held_out_after_update": rmse(y[te_s], pred_up),
             "nfev": nfev, "launches": launches["joint_posterior"], "probe_launches": probe,
             "gram_cache_engaged": model.metrics["gram_cache_engaged"],
             "seconds": time.perf_counter() - start}
    emit({"phase": "joint-posterior", "split": [1500, 500], **joint, "bars": JOINT_BARS})
    if not (diag_err <= JOINT_BARS["cov_diag_rel_prior"] and cov_err <= cov_bar
            and stats_err <= JOINT_BARS["update_stats_rel"] and np.all(np.isfinite(pred_up))
            and np.all(np.isfinite(draws)) and launches["joint_posterior"] == nfev + probe > 0):
        raise AssertionError(f"joint-posterior: {joint}")

    # iris-ep: examples/iris.py --ep verbatim (one-vs-rest over EP, 30
    # binary fits at E = 7, s = 20), 10-fold CV at seed 13, on the card
    # and on the CPU.  K1 once a site sweep, once an evaluation (log Z_EP,
    # differentiated) and once a fit (the posterior mean)
    zero(spd.spd_inv_logdet)
    sweeps, calls = ep.ep_fit_sites.sweeps, ep.batched_neg_logz_ep.calls
    iris = cv_fits(torch, cdata, lambda: OneVsRest(ep_gpc), lambda ovr: ovr.models_, None,
                   engine="ep_sweeps")
    launches["iris_ep"] = spd.spd_inv_logdet.launches
    probe = probes(spd.spd_inv_logdet)
    HOST_FITS["iris_ep"] = iris
    if (ep.ep_fit_sites.sweeps - sweeps, ep.batched_neg_logz_ep.calls - calls) \
            != (iris["ep_sweeps"], iris["objective_calls"]):
        raise AssertionError(f"iris-ep: counters against the fits' metrics {iris}")
    iris_cpu = cv_fits(torch, cdata, lambda: OneVsRest(lambda: ep_gpc("cpu")),
                       lambda ovr: ovr.models_, "cpu", engine="ep_sweeps")
    emit({"phase": "iris-ep", **iris, "launches": launches["iris_ep"], "probe_launches": probe,
          "bar": SLICE6_BARS["iris_ep"], "jax_cpu_accuracy": JAX_CPU_SLICE6["iris_ep"],
          "cpu": iris_cpu})
    if not (iris["accuracy"] > SLICE6_BARS["iris_ep"] and iris["experts"] == [(7, 20)]
            and iris["gram_cache_engaged"] == [0.0] and probe == iris["fits"]
            and launches["iris_ep"]
            == iris["ep_sweeps"] + iris["objective_calls"] + iris["fits"] + probe > 0):
        raise AssertionError(f"iris-ep: accuracy {iris['accuracy']}, {launches['iris_ep']} K1 "
                             f"launches, {iris}")

    # poisson, poisson-nb, poisson-iterative: quality.py's poisson part
    # verbatim (E = 20, s = 100), on the card (and the CPU for the Newton
    # iterations an evaluation); K1 once a Newton iteration and twice an
    # evaluation on the exact lane, never on the iterative one
    counts = {}
    for label, dispersion, y_counts, lane in (("poisson", None, d6["y"], None),
                                              ("poisson_nb", 2.0, d6["y_nb"], None),
                                              ("poisson_iterative", None, d6["y"], "iterative")):
        zero(spd.spd_inv_logdet)
        try:
            gp = poisson_gp(dispersion)
            if lane is not None:
                gp.setSolverLane(lane)
            row = count_fit(gp, d6, y_counts)
        finally:
            it_ops.set_solver_lane(None)
        row["launches"] = launches[label] = spd.spd_inv_logdet.launches
        row["probe_launches"] = probes(spd.spd_inv_logdet)
        expected = (0 if lane else row["newton_iterations"] + 2 * row["objective_calls"]) \
            + row["probe_launches"]
        if lane is None:
            row["cpu"] = count_fit(poisson_gp(dispersion, "cpu"), d6, y_counts)
        counts[label] = HOST_FITS[label] = row
        emit({"phase": label.replace("_", "-"), **row, "bar": SLICE6_BARS[label],
              "jax_cpu": JAX_CPU_SLICE6.get(label)})
        if not (row["mean_relative_rate_error"] < SLICE6_BARS[label]
                and row["launches"] == expected and row["objective_calls"] > 0
                and (row["num_experts"], row["expert_size"]) == (20, 100)
                and row["gram_cache_engaged"] == 1.0
                and row["solver_lane"] == (lane or "exact")):
            raise AssertionError(f"{label}: {row}")

    # new-objective-parity: EP's and the Poisson objective's value and
    # theta-gradient at init theta and at the card fit's theta*: through
    # K1 (float32) against the Cholesky route on the card (float32), and
    # against the CPU (float64), from zero sites / latents; none of these
    # launches is the main path's.  The gradient's error is taken over the
    # largest component of the CPU's init-theta gradient
    before = spd.spd_inv_logdet.launches
    start = time.perf_counter()
    train = cdata["folds_i"][0][0]
    ep_kernel = ep_gpc()._get_kernel()
    pois_gp = poisson_gp()
    pois_kernel = pois_gp._get_kernel()
    configs = {
        "ep": (ep_kernel, cdata["xi"][train], (cdata["yi"][train] == 0).astype(np.float64), 20,
               iris["first_theta"],
               lambda data: ep.make_ep_objective(ep_kernel, data, 1e-6),
               lambda data: (torch.zeros_like(data.y), torch.zeros_like(data.y))),
        "poisson": (pois_kernel, d6["x"], d6["y"], 100, counts["poisson"]["theta"],
                    lambda data: lg.make_generic_objective(
                        pois_gp._likelihood, pois_kernel, data.x, data.y, data.mask, 1e-6,
                        prepare_gram_cache(pois_kernel, data.x)),
                    lambda data: torch.zeros_like(data.y)),
    }
    package_applies = spd.kernel_applies
    parity = {}
    bar_v, bar_g = NEW_OBJECTIVE_BARS
    for name, (kernel, xs, ys, expert, theta_fit, make, carry) in configs.items():
        points, scale = [], None
        for label, theta in (("init", kernel.init_theta()), ("fit", np.asarray(theta_fit))):
            out = {}
            for side, device, dtype in (("k1", "cuda", torch.float32),
                                        ("cholesky", "cuda", torch.float32),
                                        ("cpu", "cpu", torch.float64)):
                data = group_for_experts(xs, ys, expert, dtype=dtype, device=device)
                try:
                    if side == "cholesky":
                        spd.kernel_applies = lambda k: False
                    value, grad, _ = make(data)(theta, carry(data))
                finally:
                    spd.kernel_applies = package_applies
                out[side] = (value, np.asarray(grad))
            scale = scale or float(np.max(np.abs(out["cpu"][1])))
            row = {"theta": label}
            for a, b in (("k1", "cholesky"), ("k1", "cpu")):
                dv = abs(out[a][0] - out[b][0]) / abs(out[b][0])
                dg = float(np.max(np.abs(out[a][1] - out[b][1]))) / scale
                row[f"{a}_vs_{b}"] = {"rel_value_err": dv, "rel_grad_err": dg}
                if not (dv <= bar_v and dg <= bar_g):
                    raise AssertionError(f"{name} {a} vs {b} at {label} theta: rel dv {dv}, "
                                         f"dg {dg}")
            row.update(value_k1=out["k1"][0], value_cpu=out["cpu"][0],
                       grad_k1=out["k1"][1].tolist(), grad_cpu=out["cpu"][1].tolist())
            points.append(row)
        parity[name] = points
    spd.spd_inv_logdet.launches = before
    emit({"phase": "new-objective-parity", "bars": {"rel_value": bar_v, "rel_grad": bar_g},
          "shapes": {"ep": [7, 20], "poisson": [20, 100]}, **parity,
          "seconds": time.perf_counter() - start})

    emit({"phase": "slice6-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return launches


# ---------------------------------------------------------------------------
# slice 7: the expert-weight plane (PoE aggregation, selection, quarantine)
# ---------------------------------------------------------------------------

# the JAX package's ``python quality.py --parts aggregation`` on the CPU
# (float32, JAX's default there), for comparison
JAX_CPU_AGGREGATION = {
    "clustered": {"poe": {"nlpd": 5.9917807712457485, "coverage90": 0.408203125,
                          "rmse_scaled": 0.06898042391181261},
                  "gpoe": {"nlpd": -1.0501158283532983, "coverage90": 0.9873046875,
                           "rmse_scaled": 0.06898042391181261},
                  "rbcm": {"nlpd": 16.612996572256133, "coverage90": 0.337890625,
                           "rmse_scaled": 0.06011950570439133},
                  "healed": {"nlpd": -1.3856843284969942, "coverage90": 0.890625,
                             "rmse_scaled": 0.0602419146610377}},
    "heteroscedastic": {"poe": {"nlpd": 13.699521973084558, "coverage90": 0.3388671875,
                                "rmse_scaled": 0.3224370108588016},
                        "healed": {"nlpd": 0.2835657658593719, "coverage90": 0.90234375,
                                   "rmse_scaled": 0.3224386221774402}},
}
# quality.py's aggregation bars: the healed product's 90% coverage band,
# plain PoE's overconfidence, and the planted-SNR RMSE bar's structural
# part (sqrt(0.0609^2 + clustered_noise_floor^2))
AGG_COVERAGE_BAND, AGG_POE_COVERAGE_MAX, AGG_STRUCTURAL_RMSE = (0.84, 0.97), 0.80, 0.0609
# fit-time selection may worsen the held-out NLPD by 1% of its size at most
# (the JAX package's test_aggregation.py bar); a fit that quarantines two of
# airfoil's 14 experts keeps its test RMSE within 5% of the clean fit on the
# rows the quarantine keeps (the full clean fit's RMSE is recorded beside
# it: two experts' rows are an eighth of the training set, and on the first
# fold that data loss alone costs 7.8% in float64 on the CPU)
SELECTION_NLPD_REL, QUARANTINE_RMSE_REL = 0.01, 0.05


def aggregation_gp(p: int, lengthscale: float, device=None):
    """quality.py ``part_aggregation``'s estimator: ARD-RBF + white noise,
    expert 64, active 256, 15 iterations, seed 13."""
    from spark_gp_tpu_torch import ARDRBFKernel, GaussianProcessRegression, WhiteNoiseKernel

    return (GaussianProcessRegression(device=device)
            .setKernel(lambda: 1.0 * ARDRBFKernel(p, lengthscale) + WhiteNoiseKernel(0.1, 0.0, 1.0))
            .setDatasetSizeForExpert(64).setActiveSetSize(256).setMaxIter(15).setSeed(13))


def policy_scores(gp, model, x_tr, ys_tr, x_te, ys_te, modes) -> dict:
    """quality.py ``_policy_scores``: held-out NLPD, 90% coverage and
    scaled RMSE of each PoE mode at the fitted theta."""
    out = {}
    for mode in modes:
        mu, var = gp.poe_predictor(x_tr, ys_tr, model=model, mode=mode).predict_with_var(x_te)
        var = np.maximum(np.asarray(var, np.float64), 1e-12)
        err = np.asarray(ys_te, np.float64) - np.asarray(mu, np.float64)
        out[mode] = {"nlpd": float(np.mean(0.5 * np.log(2 * np.pi * var) + err ** 2 / (2 * var))),
                     "coverage90": float(np.mean(np.abs(err) <= 1.6449 * np.sqrt(var))),
                     "rmse_scaled": float(np.sqrt(np.mean(err ** 2)))}
    return out


def slice7_data() -> dict:
    """quality.py ``part_aggregation``'s data: the clustered stand-in (4096
    training rows, the next 1024 held out, targets standardized on the
    training rows) and the heteroscedastic ramp (3072 rows, every third
    held out); the selection phase's pairwise-duplicated rows (the JAX
    package's test_aggregation.py: 240 rows twice, E = 12, expert 2j + 1 a
    copy of expert 2j) with 160 held-out rows."""
    from spark_gp_tpu_torch.data import make_clustered, make_heteroscedastic

    x, y = make_clustered(4096 + 1024)
    ys = (y - y[:4096].mean()) / y[:4096].std()
    xh, yh, _ = make_heteroscedastic(3072)
    te = np.zeros(yh.shape[0], bool)
    te[::3] = True
    yh = (yh - yh[~te].mean()) / yh[~te].std()
    rng = np.random.default_rng(0)
    xb = rng.normal(size=(240, 2))
    yb = np.sin(xb.sum(axis=1)) + 0.05 * rng.normal(size=240)
    x_sel_te = rng.normal(size=(160, 2))
    y_sel_te = np.sin(x_sel_te.sum(axis=1)) + 0.05 * rng.normal(size=160)
    return {"xc": x[:4096], "yc": ys[:4096], "xc_te": x[4096:], "yc_te": ys[4096:],
            "xh": xh[~te], "yh": yh[~te], "xh_te": xh[te], "yh_te": yh[te],
            "x_sel": np.repeat(xb, 2, axis=0), "y_sel": np.repeat(yb, 2),
            "x_sel_te": x_sel_te, "y_sel_te": y_sel_te}


def selection_gp():
    """The selection phase's estimator (the JAX package's
    test_aggregation.py config): RBF(1.0), expert 40 (E = 12 on the
    duplicated rows), active 30, sigma2 1e-3, maxiter 5, seed 7."""
    from spark_gp_tpu_torch import GaussianProcessRegression, RBFKernel

    return (GaussianProcessRegression().setKernel(lambda: RBFKernel(1.0))
            .setDatasetSizeForExpert(40).setActiveSetSize(30).setSigma2(1e-3)
            .setMaxIter(5).setSeed(7))


def slice7_stacks(torch, d7: dict, stacks: dict) -> dict:
    """The stacks this slice hands K1 at init theta: the clustered fit's
    gram stack (64, 64), the heteroscedastic fit's (32, 64), and the
    health probe's one-expert stack (1, 97): expert 0 of the first airfoil
    fold's gram (the probe evaluates each expert on its own)."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack

    out = {}
    for label, gp, xs, ys in (("clustered", aggregation_gp(2, 0.7), d7["xc"], d7["yc"]),
                              ("heteroscedastic", aggregation_gp(1, 0.5), d7["xh"], d7["yh"])):
        kernel = gp._get_kernel()
        data = gp._group(xs, ys, torch.device("cuda"))
        theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device="cuda")
        out[label] = masked_gram_stack(kernel, theta, data.x, data.mask)
    out["quarantine_probe"] = stacks["airfoil_fold"][:1].contiguous()
    for label, shape in (("clustered", (64, 64)), ("heteroscedastic", (32, 64)),
                         ("quarantine_probe", (1, 97))):
        if tuple(out[label].shape) != (shape[0], shape[1], shape[1]):
            raise AssertionError(f"{label} stack {tuple(out[label].shape)}, expected {shape}")
    return out


def weighted_matfree_phase(torch, mf_data) -> dict:
    """weighted-matfree: the marginal objective with per-expert weights and
    the recovery ladder's jitter on the matrix-free lane (K2, K2-VJP)
    against the iterative lane on the card, on the protein-matfree stack at
    init theta with the same probes (matfree-parity's bars); returns K2's
    and K2-VJP's launches on the matrix-free evaluation."""
    from spark_gp_tpu_torch import Const, EyeKernel, RBFKernel, WhiteNoiseKernel
    from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
    from spark_gp_tpu_torch.ops import iterative as it_ops
    from spark_gp_tpu_torch.ops import streamed_matvec as sm

    start = time.perf_counter()
    kernel = (1.0 * RBFKernel(1.0, 1e-6, 10) + WhiteNoiseKernel(0.1, 0.0, 1.0)
              + Const(1e-3) * EyeKernel())
    e, s = mf_data.num_experts, mf_data.expert_size
    extra = (np.where(np.arange(e) % 3 == 1, 1e-3, 0.0), np.linspace(1.0, 0.0, e))
    cfg = it_ops.solver_config(s)
    g1, g2 = it_ops.draw_probes(cfg, (e,), cfg.rank, s, mf_data.x.dtype, mf_data.x.device)
    draw_probes = it_ops.draw_probes
    it_ops.draw_probes = lambda cfg, batch, rank, s, dtype, device: (g1, g2)
    k2 = {}
    try:
        out = {}
        for lane in ("matfree", "iterative"):
            it_ops.set_solver_lane(lane)
            zero(sm.streamed_matvec, sm.streamed_matvec_vjp)
            out[lane] = make_value_and_grad(kernel, mf_data, None, "marginal", extra)(
                kernel.init_theta())
            if lane == "matfree":
                k2 = {"streamed_matvec": sm.streamed_matvec.launches,
                      "streamed_matvec_vjp": sm.streamed_matvec_vjp.launches}
    finally:
        it_ops.draw_probes = draw_probes
        it_ops.set_solver_lane(None)
    (v_mf, g_mf), (v_it, g_it) = out["matfree"], out["iterative"]
    dv = abs(v_mf - v_it) / abs(v_it)
    dg = float(np.max(np.abs(g_mf - g_it)) / np.max(np.abs(g_it)))
    emit({"phase": "weighted-matfree", "shape": [e, s, mf_data.x.shape[-1]],
          "weights": extra[1].tolist(), "jitter": extra[0].tolist(), "value": v_mf,
          "value_iterative": v_it, "rel_value_err": dv, "rel_grad_err": dg,
          "bars": {"rel_value": 1e-5, "rel_grad": 1e-5}, "launches": k2,
          "seconds": time.perf_counter() - start})
    if not (dv <= 1e-5 and dg <= 1e-5 and min(k2.values()) > 0):
        raise AssertionError(f"weighted-matfree: rel dv {dv}, dg {dg}, launches {k2}")
    return k2


def slice7_phases(torch, spd, d7: dict, data_main: dict, mf_data, smi: str):
    """This slice's phases (aggregation, poe-parity, selection,
    quarantine, weighted-matfree); returns K1's launches on each, and K2's
    and K2-VJP's on the weighted matrix-free evaluation."""
    from spark_gp_tpu_torch.data import clustered_noise_floor
    from spark_gp_tpu_torch.models.poe import make_poe_predictor
    from spark_gp_tpu_torch.ops.linalg import JITTER_SCHEDULE
    from spark_gp_tpu_torch.resilience import diagnose_experts
    from spark_gp_tpu_torch.resilience.chaos import poison_expert
    from spark_gp_tpu_torch.utils.validation import rmse

    launches = {}
    start_all = time.perf_counter()

    # aggregation: quality.py's part through the port on the card
    zero(spd.spd_inv_logdet)
    start = time.perf_counter()
    gp = aggregation_gp(2, 0.7)
    model = gp.fit(d7["xc"], d7["yc"])
    clustered = policy_scores(gp, model, d7["xc"], d7["yc"], d7["xc_te"], d7["yc_te"],
                              ("poe", "gpoe", "rbcm", "healed"))
    gph = aggregation_gp(1, 0.5)
    modelh = gph.fit(d7["xh"], d7["yh"])
    hetero = policy_scores(gph, modelh, d7["xh"], d7["yh"], d7["xh_te"], d7["yh_te"],
                           ("poe", "healed"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches["aggregation"] = spd.spd_inv_logdet.launches
    probe = probes(spd.spd_inv_logdet)
    nfev = model.metrics["lbfgs_nfev"] + modelh.metrics["lbfgs_nfev"]
    rmse_bar = float(np.hypot(AGG_STRUCTURAL_RMSE, clustered_noise_floor()))
    lo, hi = AGG_COVERAGE_BAND
    bars = {
        "clustered_healed_nlpd_below_poe": clustered["healed"]["nlpd"] < clustered["poe"]["nlpd"],
        "clustered_healed_coverage_in_band": lo <= clustered["healed"]["coverage90"] <= hi,
        "clustered_poe_coverage_below": clustered["poe"]["coverage90"] < AGG_POE_COVERAGE_MAX,
        "clustered_healed_rmse_below_bar": clustered["healed"]["rmse_scaled"] < rmse_bar,
        "hetero_healed_nlpd_below_poe": hetero["healed"]["nlpd"] < hetero["poe"]["nlpd"],
        "hetero_healed_coverage_in_band": lo <= hetero["healed"]["coverage90"] <= hi,
    }
    emit({"phase": "aggregation", "clustered": clustered, "heteroscedastic": hetero,
          "rmse_bar": rmse_bar, "coverage_band": list(AGG_COVERAGE_BAND), "bars": bars,
          "jax_cpu": JAX_CPU_AGGREGATION, "seconds": seconds, "launches": launches["aggregation"],
          "nfev": nfev, "probe_launches": probe,
          "shapes": {"clustered": [model.metrics["num_experts"],
                                   model.metrics["expert_size"]],
                     "heteroscedastic": [modelh.metrics["num_experts"],
                                         modelh.metrics["expert_size"]]},
          "theta": {"clustered": model.raw_predictor.theta.tolist(),
                    "heteroscedastic": modelh.raw_predictor.theta.tolist()},
          **{f"{k}_seconds": model.metrics[k + "_seconds"] for k in ("optimize", "ppa")}})
    if not all(bars.values()):
        raise AssertionError(f"aggregation bars: {bars}")
    if launches["aggregation"] != nfev + probe or nfev == 0 or probe != 2:
        raise AssertionError(f"aggregation: {launches['aggregation']} launches for {nfev} "
                             f"evaluations and {probe} probes")
    if (model.metrics["num_experts"], model.metrics["expert_size"]) != (64, 64):
        raise AssertionError(f"clustered stack {model.metrics['num_experts']}")

    # poe-parity: the five modes on the card (float32) against the CPU
    # (float64) at the clustered fit's theta, on the held-out rows
    start = time.perf_counter()
    kernel, theta = model.raw_predictor.kernel, model.raw_predictor.theta
    parity = {}
    for mode in ("poe", "gpoe", "bcm", "rbcm", "healed"):
        out = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            pred = make_poe_predictor(kernel, theta, d7["xc"], d7["yc"], 64, mode=mode,
                                      dtype=dtype, device=device)
            out[device] = pred.predict_with_var(d7["xc_te"])
        (m_gpu, v_gpu), (m_cpu, v_cpu) = out["cuda"], out["cpu"]
        if not (np.all(np.isfinite(m_gpu)) and np.all(np.isfinite(v_gpu))):
            raise AssertionError(f"poe-parity {mode}: card predictions not finite")
        parity[mode] = {
            "max_abs_mean_err": float(np.max(np.abs(m_gpu - m_cpu))),
            "max_rel_mean_err": float(np.max(np.abs(m_gpu - m_cpu)) / np.max(np.abs(m_cpu))),
            "max_rel_var_err": float(np.max(np.abs(v_gpu - v_cpu) / np.abs(v_cpu))),
            "min_var_cpu": float(np.min(v_cpu)),
        }
    emit({"phase": "poe-parity", "config": "clustered", "shape": [64, 64, 1024], **parity,
          "max_rel_mean_err": max(r["max_rel_mean_err"] for r in parity.values()),
          "max_rel_var_err": max(r["max_rel_var_err"] for r in parity.values()),
          "seconds": time.perf_counter() - start})

    # selection: GP_AGG_SELECT=1 on the duplicated rows against the fit
    # without it; the held-out NLPD within 1%
    def nlpd(m):
        mean, var = m.predict_with_var(d7["x_sel_te"])
        var = np.maximum(np.asarray(var, np.float64), 1e-12)
        err = d7["y_sel_te"] - np.asarray(mean, np.float64)
        return float(np.mean(0.5 * np.log(2 * np.pi * var) + err ** 2 / (2 * var)))

    zero(spd.spd_inv_logdet)
    start = time.perf_counter()
    saved = {key: os.environ.pop(key, None) for key in ("GP_AGG_SELECT", "GP_AGG_SELECT_MODE")}
    try:
        off = selection_gp().fit(d7["x_sel"], d7["y_sel"])
        os.environ["GP_AGG_SELECT"] = "1"
        on = selection_gp().fit(d7["x_sel"], d7["y_sel"])
    finally:
        os.environ.pop("GP_AGG_SELECT", None)
        os.environ.update({key: value for key, value in saved.items() if value is not None})
    launches["selection"] = spd.spd_inv_logdet.launches
    probe = probes(spd.spd_inv_logdet)
    sel = {"nlpd_off": nlpd(off), "nlpd_on": nlpd(on),
           "final_nll_off": off.metrics["final_nll"],
           "final_nll_renormalized_on": on.metrics["final_nll_renormalized"],
           **{key: on.metrics[key] for key in ("agg.selection_dropped", "agg.renorm",
                                               "agg.effective_experts", "num_experts")},
           "nfev": [off.metrics["lbfgs_nfev"], on.metrics["lbfgs_nfev"]],
           "launches": launches["selection"], "probe_launches": probe,
           "seconds": time.perf_counter() - start}
    emit({"phase": "selection", **sel, "bar_nlpd_rel": SELECTION_NLPD_REL})
    if not (sel["agg.selection_dropped"] >= 0.25 * on.metrics["num_experts"]
            and sel["agg.renorm"] == 2.0
            and sel["nlpd_on"] - sel["nlpd_off"] <= SELECTION_NLPD_REL * abs(sel["nlpd_off"])
            and launches["selection"] == sum(sel["nfev"]) + probe and probe == 2):
        raise AssertionError(f"selection: {sel}")

    # quarantine: the first airfoil fold at expert 100 with one expert's
    # rows NaN (the data screen drops it) and another's scaled by 1e300
    # (finite on the host, inf in float32 on the card: the first evaluation
    # fails, the health probe finds the expert at every jitter rung, the
    # recovery quarantines it and the retry fits), against the clean fit on
    # the other experts' rows and the clean fit on all rows
    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    train, test = folds[0]
    experts, nan_expert, huge_expert = 14, 3, 9
    start = time.perf_counter()
    clean = airfoil_gp(100).fit(x[train], y[train])
    full_rmse = rmse(y[test], clean.predict(x[test]))
    kept = ~np.isin(np.arange(train.shape[0]) % experts, [nan_expert, huge_expert])
    survivors = airfoil_gp(100).fit(x[train][kept], y[train][kept])
    clean_rmse = rmse(y[test], survivors.predict(x[test]))
    # the port's injector: every row of one expert given a NaN feature,
    # every row of another scaled by 1e300 (round-robin grouping puts row
    # i in expert i % E)
    xq, yq = poison_expert(x[train], y[train], nan_expert, experts, kind="nan", seed=1)
    xq, yq = poison_expert(xq, yq, huge_expert, experts, kind="huge")
    zero(spd.spd_inv_logdet)
    model = airfoil_gp(100).fit(xq, yq)
    launches["quarantine"] = spd.spd_inv_logdet.launches
    quality_probe = probes(spd.spd_inv_logdet)
    pred = model.predict(x[test])
    if not np.all(np.isfinite(pred)):
        raise AssertionError("quarantine predictions not finite")
    m = model.metrics
    # one failed first evaluation, then the probe: every expert on its own
    # at rung 0, the one unhealthy expert alone at each jitter rung (the
    # huge expert never heals), then the retry's evaluations, and the
    # fit-time expert-quality probe's one batched pass
    rungs = len(JITTER_SCHEDULE)
    unhealthy = 1  # the huge expert; the NaN one is masked inert by the screen
    probe_launches = experts + (rungs - 1) * unhealthy
    rule = 1 + probe_launches + m["lbfgs_nfev"] + quality_probe
    q = {"rmse": rmse(y[test], pred), "clean_rmse": clean_rmse,
         "rmse_rel_change": rmse(y[test], pred) / clean_rmse - 1.0,
         "full_clean_rmse": full_rmse, "rmse_rel_change_full": rmse(y[test], pred) / full_rmse - 1.0,
         **{key: m.get(key) for key in ("experts_active_initial", "experts_quarantined",
                                        "bcm_renorm", "experts_jittered", "fit_retries",
                                        "final_nll", "final_nll_renormalized",
                                        "agg.effective_experts", "lbfgs_nfev")},
         "clean_final_nll": clean.metrics["final_nll"], "probe_rungs": rungs,
         "launches": launches["quarantine"],
         "launches_rule": "1 + E + (rungs - 1) * unhealthy + nfev + expert-quality probes",
         "probe_launches": probe_launches, "expert_quality_probe_launches": quality_probe,
         "active_set_finite": bool(np.all(np.isfinite(model.raw_predictor.active))),
         "seconds": time.perf_counter() - start}
    # which experts: the screen's (host rows) and the probe's on the card's
    # screened stack (these launches are not the fit's)
    gp = airfoil_gp(100)
    finite = gp._finite_row_mask(xq, yq)
    q["screened"] = sorted(set((np.flatnonzero(~finite) % experts).tolist()))
    stack = gp._group(xq, yq, torch.device("cuda")).with_experts_masked(
        np.isin(np.arange(experts), q["screened"]))
    kernel = gp._get_kernel()
    report = diagnose_experts(kernel, kernel.init_theta(), stack)
    q["probed_bad"] = np.flatnonzero(report.bad).tolist()
    q["probed_jitter_max"] = float(report.jitter.max())
    emit({"phase": "quarantine", "poisoned": {"nan": nan_expert, "huge": huge_expert},
          "bar_rmse_rel": QUARANTINE_RMSE_REL, **q})
    if not (m["experts_quarantined"] == 2.0 and m["bcm_renorm"] == experts / (experts - 2)
            and m.get("fit_retries") == 1.0 and q["active_set_finite"]
            and q["screened"] == [nan_expert] and q["probed_bad"] == [huge_expert]
            and abs(q["rmse_rel_change"]) <= QUARANTINE_RMSE_REL
            and launches["quarantine"] == rule and quality_probe == 1):
        raise AssertionError(f"quarantine: {q}, rule {rule}")

    k2 = weighted_matfree_phase(torch, mf_data)
    emit({"phase": "slice7-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return launches, k2


# -- slice 8: the fit's observability shell and its degradation ladder -----

# the JAX package's phase names, in the order a regression fit runs them
FIT_PHASES = ["group_experts", "optimize_hypers", "active_set", "kmn_stats", "magic_solve"]
# tracing overhead on an airfoil fold fit: the median over interleaved
# pairs (tracing off, on) must stay under this.  Each side of a pair is
# the median of seven fits run in turns with the other side's: one fit's
# host time (L-BFGS and the host magic solve) spreads by up to ~20% a
# pair, and with three fits a side the median still read -3.1% to +4.5%
# across runs of the same code, against a shell cost of ~0.1%
TRACING_OVERHEAD_BAR, TRACING_PAIRS, TRACING_FITS = 0.05, 5, 7
# the ladder-oom budget: what the process holds after emptying the cache,
# plus this much -- under the 595 MB float32 gram stack (and the exact and
# iterative lanes' evaluations, 5.4 and 4.3 GB), over a matrix-free
# evaluation (34 MB), the PPA statistics' chunks and the predict
LADDER_HEADROOM = 400e6
# ladder-oom's RMSE against protein-matfree's (maxiter 10 there, 5 here)
LADDER_RMSE_REL = 0.02
# predicted peak of one evaluation over the measured one
MEMPLAN_BRACKET = (1.0, 4.0)
# the predict ladder against the clean predict, relative to its largest
PREDICT_LADDER_REL = 1e-6

def check_openmetrics(page: str) -> dict:
    """Parse an OpenMetrics page as a scraper would: ``# TYPE`` /
    ``# UNIT`` / ``# HELP`` lines, samples ``name{labels} value`` of a
    declared family, one block per family, ``# EOF`` last.  Returns the
    family and sample counts; raises on the first malformed line."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
                        r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*)\})? '
                        r'(NaN|[+-]Inf|-?[0-9.]+(e[+-]?[0-9]+)?)$')
    lines = page.rstrip("\n").split("\n")
    if lines[-1] != "# EOF":
        raise AssertionError("OpenMetrics page does not end with # EOF")
    families, samples, seen = {}, 0, []
    for line in lines[:-1]:
        if line.startswith("# "):
            kind, family = line.split(" ")[1:3]
            if kind not in ("TYPE", "UNIT", "HELP"):
                raise AssertionError(f"OpenMetrics: bad descriptor {line!r}")
            if kind == "TYPE":
                if family in families:
                    raise AssertionError(f"OpenMetrics: family {family} declared twice")
                families[family] = line.split(" ")[3]
                seen.append(family)
            continue
        match = sample.match(line)
        if match is None or not match.group(1).startswith(seen[-1]):
            raise AssertionError(f"OpenMetrics: bad sample {line!r}")
        samples += 1
    return {"families": len(families), "samples": samples}


def airfoil_fold_fit(gp, x, y, train):
    """``gp`` fitted on one airfoil fold, synchronized, and its seconds."""
    import torch

    start = time.perf_counter()
    model = gp.fit(x[train], y[train])
    torch.cuda.synchronize()
    return model, time.perf_counter() - start


def slice8_phases(torch, spd, sm, it_ops, data_main: dict, mf_data, mf_rmse: float, smi: str):
    """This slice's phases (obs, profile, ladder-oom, memplan,
    predict-ladder, terminal); returns the launches of K1, K2 and K2-VJP
    on each phase's fits."""
    import shutil
    import tempfile

    from spark_gp_tpu_torch import Const, EyeKernel, GaussianProcessRegression, RBFKernel
    from spark_gp_tpu_torch.kernels.base import supports_matfree
    from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
    from spark_gp_tpu_torch.obs import expo
    from spark_gp_tpu_torch.obs.recorder import validate_bundle
    from spark_gp_tpu_torch.obs.runtime import telemetry, validate_journal, write_run_journal
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.resilience import chaos, fallback, memplan
    from spark_gp_tpu_torch.utils.validation import rmse

    def counters():
        return telemetry.snapshot()["counters"]

    def delta(before, key):
        return counters().get(key, 0.0) - before.get(key, 0.0)

    launches = {"spd_inv_logdet": {}, "streamed_matvec": {}, "streamed_matvec_vjp": {}}
    start_all = time.perf_counter()
    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    train, test = folds[0]
    total_memory = torch.cuda.get_device_properties(0).total_memory

    # obs: the airfoil config's first fold with the shell on; then the
    # tracing overhead over interleaved pairs with GP_TRACING=0 and on
    zero(spd.spd_inv_logdet)
    torch.cuda.reset_peak_memory_stats()
    obs_model, fit_s = airfoil_fold_fit(airfoil_gp(100), x, y, train)
    peak_allocated = torch.cuda.max_memory_allocated()
    journal = obs_model.run_journal
    nfev = obs_model.metrics["lbfgs_nfev"]
    tree = journal["spans"]
    page = expo.render_openmetrics(obs_model.instr, telemetry.snapshot())
    parsed = check_openmetrics(page)
    k1_journal = journal["kernels"]["launches"].get("spd_inv_logdet")
    k1_wrapper = spd.spd_inv_logdet.launches
    obs_probe = probes(spd.spd_inv_logdet)
    peak_gauge = journal["memory"]["peak"]["memory.peak_bytes_in_use"]
    seconds, phases = {"off": [], "on": []}, {"off": [], "on": []}
    for pair in range(TRACING_PAIRS):
        for _ in range(TRACING_FITS):
            for mode in (("off", "on") if pair % 2 == 0 else ("on", "off")):
                if mode == "off":
                    os.environ["GP_TRACING"] = "0"
                try:
                    fitted, fit = airfoil_fold_fit(airfoil_gp(100), x, y, train)
                finally:
                    os.environ.pop("GP_TRACING", None)
                seconds[mode].append(fit)
                phases[mode].append([fitted.metrics[key] for key in PHASES])
    overhead = [float(np.median(seconds["on"][i:i + TRACING_FITS])
                      / np.median(seconds["off"][i:i + TRACING_FITS]) - 1.0)
                for i in range(0, TRACING_PAIRS * TRACING_FITS, TRACING_FITS)]
    # the shell's own work: one allocator sample (a fit takes 7) and one
    # journal, each timed over a loop
    shell_ms = {}
    for label, fn, reps in (("memory_sample", telemetry.sample_memory, 200),
                            ("journal", lambda: write_run_journal(obs_model.instr, None, None), 50)):
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        shell_ms[label] = (time.perf_counter() - start) / reps * 1e3
    median = float(np.median(overhead))
    launches["spd_inv_logdet"]["obs"] = spd.spd_inv_logdet.launches
    obs = {"fit_seconds": fit_s, "nfev": nfev,
           "span_tree": [{"name": n["name"], "children": [c["name"] for c in n["children"]]}
                         for n in tree],
           "journal_valid": validate_journal(journal) == [], "trace_id": journal["trace_id"],
           "k1_launches_journal": k1_journal, "k1_launches_wrapper": k1_wrapper,
           "probe_launches": obs_probe, "expert_quality": journal["expert_quality"],
           "peak_gauge_bytes": peak_gauge, "max_memory_allocated": peak_allocated,
           "memory_samples": [s["phase"] for s in journal["memory"]["samples"]],
           "openmetrics": parsed, "openmetrics_bytes": len(page),
           "tracing_seconds": seconds, "tracing_phase_seconds": phases,
           "tracing_overhead_per_pair": overhead,
           "tracing_overhead_median": median, "bar": TRACING_OVERHEAD_BAR,
           "shell_ms": shell_ms,
           "launches": launches["spd_inv_logdet"]["obs"]}
    emit({"phase": "obs", **obs, "card": smi})
    if not (len(tree) == 1 and tree[0]["name"] == "fit.GaussianProcessRegression"
            and [c["name"] for c in tree[0]["children"]] == FIT_PHASES
            and obs["journal_valid"] and k1_journal == nfev + obs_probe == k1_wrapper
            and obs_probe == 1 and journal["expert_quality"]["experts"] == 14
            and all(np.isfinite(journal["expert_quality"]["nll"]))
            and peak_gauge == peak_allocated and median < TRACING_OVERHEAD_BAR):
        raise AssertionError(f"obs: {obs}")

    # profile: the same fold with setProfileDir; K1's kernel events in the
    # Chrome trace, one a call at n <= 128
    profile_dir = tempfile.mkdtemp(prefix="gp_profile_")
    try:
        zero(spd.spd_inv_logdet)
        start = time.perf_counter()
        model, _ = airfoil_fold_fit(airfoil_gp(100).setProfileDir(profile_dir), x, y, train)
        seconds = time.perf_counter() - start
        files = os.listdir(profile_dir)
        with open(os.path.join(profile_dir, files[0]), encoding="utf-8") as fh:
            doc = json.load(fh)
        trace_bytes = os.path.getsize(os.path.join(profile_dir, files[0]))
    finally:
        shutil.rmtree(profile_dir, ignore_errors=True)
    kernel_events = {}
    for event in doc.get("traceEvents", []):
        if event.get("cat") == "kernel" and "spd_inv_logdet" in event.get("name", ""):
            kernel_events[event["name"]] = kernel_events.get(event["name"], 0) + 1
    launches["spd_inv_logdet"]["profile"] = spd.spd_inv_logdet.launches
    nfev = model.metrics["lbfgs_nfev"]
    probe = probes(spd.spd_inv_logdet)
    prof = {"files": len(files), "trace_bytes": trace_bytes, "seconds": seconds,
            "k1_kernel_events": kernel_events, "nfev": nfev, "probe_launches": probe,
            "launches": launches["spd_inv_logdet"]["profile"]}
    emit({"phase": "profile", **prof})
    if not (len(files) == 1 and list(kernel_events.values()) == [nfev + probe]
            and "spd_inv_logdet_blocked_kernel" in next(iter(kernel_events))
            and launches["spd_inv_logdet"]["profile"] == nfev + probe and probe == 1):
        raise AssertionError(f"profile: {prof}")

    # ladder-oom: the protein-matfree config on the exact lane under a
    # per-process memory fraction that holds a matrix-free evaluation and
    # not the gram stack: a real allocator OOM at native, then at
    # iterative, and the fit completes on matfree
    xp, yp, tr, te = (data_main[key] for key in ("xp", "yp", "tr", "te"))
    yp_tr, y_mean, y_std = (data_main[key] for key in ("yp_tr", "y_mean", "y_std"))
    cfg = it_ops.solver_config(4065)

    def set_budget():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        budget = torch.cuda.memory_reserved() + LADDER_HEADROOM
        torch.cuda.set_per_process_memory_fraction(budget / total_memory)
        return budget

    before = counters()
    zero(sm.streamed_matvec, sm.streamed_matvec_vjp)
    start = time.perf_counter()
    budget = set_budget()
    try:
        model = matfree_gp(None, max_iter=5).fit(xp[tr], yp_tr)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - start
    pred = model.predict(xp[te]) * y_std + y_mean
    nfev = model.metrics["lbfgs_nfev"]
    k2, vjp = sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches
    probe_k2, probe_vjp = probes(sm.streamed_matvec), probes(sm.streamed_matvec_vjp)
    launches["streamed_matvec"]["ladder_oom"] = k2
    launches["streamed_matvec_vjp"]["ladder_oom"] = vjp
    rungs = [(d["from"], d["to"], d["failure_class"]) for d in model.degradations]
    ladder = {"budget_bytes": budget, "fraction": budget / total_memory,
              "degradations": model.degradations, "solver_lane": model.metrics["solver_lane"],
              "nfev": nfev, "rmse": rmse(yp[te], pred), "protein_matfree_rmse": mf_rmse,
              "rmse_rel": rmse(yp[te], pred) / mf_rmse - 1.0, "bar_rmse_rel": LADDER_RMSE_REL,
              "launches": {"streamed_matvec": k2, "streamed_matvec_vjp": vjp},
              "probe_launches": {"streamed_matvec": probe_k2, "streamed_matvec_vjp": probe_vjp},
              "k2_rule": "nfev * (iters + 2) + iters (solver report) + probes",
              "oom_failures": delta(before, "fallback.failures.oom"),
              "journal_degradations": len(model.run_journal["degradations"]),
              "seconds": seconds}
    emit({"phase": "ladder-oom", **ladder, "card": smi})
    if not (rungs == [("native", "iterative", "oom"), ("iterative", "matfree", "oom")]
            and model.metrics["solver_lane"] == "matfree" and np.all(np.isfinite(pred))
            and k2 == nfev * (cfg.iters + 2) + cfg.iters + probe_k2 and vjp == 2 * nfev
            and probe_k2 == cfg.iters + 2 and probe_vjp == 0
            and abs(ladder["rmse_rel"]) <= LADDER_RMSE_REL):
        raise AssertionError(f"ladder-oom: {ladder}")

    # memplan: under the same fraction the auto lane resolves matfree from
    # the card's budget before any dispatch, and the fit runs with no OOM
    # and no transition; at fraction 1.0 it resolves iterative.  Then the
    # byte model against one evaluation's measured peak on each lane at
    # two shapes
    hints = {"num_experts": 9, "n_features": 9, "itemsize": 4}
    before = counters()
    zero(sm.streamed_matvec, sm.streamed_matvec_vjp)
    start = time.perf_counter()
    budget = set_budget()
    try:
        resolved_limited = it_ops.resolve_solver(4065, "auto", **hints)
        card_budget = memplan.memory_budget_bytes()
        model = matfree_gp("auto", max_iter=5).fit(xp[tr], yp_tr)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
        it_ops.set_solver_lane(None)
    fit_s = time.perf_counter() - start
    resolved_full = it_ops.resolve_solver(4065, "auto", **hints)
    pred = model.predict(xp[te]) * y_std + y_mean
    launches["streamed_matvec"]["memplan"] = sm.streamed_matvec.launches
    launches["streamed_matvec_vjp"]["memplan"] = sm.streamed_matvec_vjp.launches
    auto = {"budget_bytes": budget, "card_budget_bytes": card_budget,
            "resolved_under_fraction": resolved_limited, "resolved_at_fraction_1": resolved_full,
            "solver_lane": model.metrics["solver_lane"], "rmse": rmse(yp[te], pred),
            "oom_failures": delta(before, "fallback.failures.oom"),
            "transitions": delta(before, "fallback.transitions"), "fit_seconds": fit_s,
            "nfev": model.metrics["lbfgs_nfev"],
            "launches": {"streamed_matvec": launches["streamed_matvec"]["memplan"],
                         "streamed_matvec_vjp": launches["streamed_matvec_vjp"]["memplan"]}}
    counts = (spd.spd_inv_logdet.launches, sm.streamed_matvec.launches,
              sm.streamed_matvec_vjp.launches)
    brackets = {}
    for label, kernel, data in (
            ("protein_matfree", matfree_kernel() + Const(1e-3) * EyeKernel(), mf_data),
            ("airfoil", airfoil_kernel() + Const(1e-4) * EyeKernel(),
             group_for_experts(x[train], y[train], 100, dtype=torch.float32, device="cuda"))):
        e, s, p = (int(d) for d in data.x.shape)
        stack = sum(t.numel() * t.element_size() for t in (data.x, data.y, data.mask))
        for lane in ("exact", "iterative", "matfree"):
            it_ops.set_solver_lane(lane)
            try:
                vag = make_value_and_grad(kernel, data)
                vag(kernel.init_theta())
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                vag(kernel.init_theta())
                torch.cuda.synchronize()
                measured = torch.cuda.max_memory_allocated() - base + stack
            finally:
                it_ops.set_solver_lane(None)
                torch.cuda.empty_cache()
            rung = memplan.fit_rung_of_lane(lane, supports_matfree(kernel))
            predicted = memplan.predicted_bytes(memplan.fit_dispatch_bytes(e, s, p, 4, rung))
            brackets[f"{label}/{lane}"] = {"shape": [e, s, p], "rung": rung,
                                           "measured_bytes": measured,
                                           "predicted_bytes": predicted,
                                           "ratio": predicted / measured}
    spd.spd_inv_logdet.launches, sm.streamed_matvec.launches, \
        sm.streamed_matvec_vjp.launches = counts
    # the measured peaks calibrate the models: a model the peak exceeds
    # ratchets up (none should: the brackets' low end)
    for label, b in brackets.items():
        e, s, p = b["shape"]
        key = memplan.fit_model_key(None, b["rung"])
        memplan.observe_measured(key, memplan.fit_dispatch_bytes(e, s, p, 4, b["rung"]),
                                 b["measured_bytes"])
        b["calibration_scale"] = memplan.calibration_scale(key)
    memplan.reset_calibration()
    emit({"phase": "memplan", **auto,
          "brackets": brackets, "bracket": MEMPLAN_BRACKET, "card": smi})
    low, high = MEMPLAN_BRACKET
    if not (resolved_limited == "matfree" and resolved_full == "iterative"
            and model.metrics["solver_lane"] == "matfree" and auto["oom_failures"] == 0
            and auto["transitions"] == 0 and not model.degradations
            and all(low <= b["ratio"] <= high for b in brackets.values())):
        raise AssertionError(f"memplan: {auto}, {brackets}")

    # predict-ladder: the obs phase's airfoil model predicts all 1503 rows
    # with every chunk above 128 rows failing: the chunk halves to 93
    clean_mean, clean_var = obs_model.predict_with_var(x)
    before = counters()
    with chaos.oom_after_calls(0, op="predict.chunk", rows_above=128) as fired:
        mean, var = obs_model.predict_with_var(x)
    halvings = {key: value - before.get(key, 0.0) for key, value in counters().items()
                if key.startswith("fallback.rung.chunk_") and value != before.get(key, 0.0)}
    err = {"mean": float(np.max(np.abs(mean - clean_mean)) / np.max(np.abs(clean_mean))),
           "var": float(np.max(np.abs(var - clean_var)) / np.max(np.abs(clean_var)))}
    # why the predict contracts in float64: the same means with a float32
    # contraction, in one 1503-row chunk against 93-row chunks
    raw = obs_model.raw_predictor
    xt = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    theta_t, active_t = (torch.as_tensor(a, dtype=torch.float32, device="cuda")
                         for a in (raw.theta, raw.active))
    mv32 = torch.as_tensor(raw.magic_vector, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        whole = (raw.kernel.cross(theta_t, xt, active_t) @ mv32).cpu().numpy()
        parts = torch.cat([raw.kernel.cross(theta_t, xt[i:i + 93], active_t) @ mv32
                           for i in range(0, xt.shape[0], 93)]).cpu().numpy()
    err["mean_float32_contraction"] = float(np.max(np.abs(parts - whole)) / np.max(np.abs(whole)))
    pl = {"rows": int(x.shape[0]), "injected": fired[0], "halvings": halvings,
          "host_solve": delta(before, "fallback.rung.host_solve"), "rel_err": err,
          "bar": PREDICT_LADDER_REL, "plan_miss": delta(before, "plan.miss")}
    emit({"phase": "predict-ladder", **pl})
    if not (set(halvings) == {"fallback.rung.chunk_751", "fallback.rung.chunk_375",
                              "fallback.rung.chunk_187", "fallback.rung.chunk_93"}
            and pl["host_solve"] == 0 and max(err["mean"], err["var"]) <= PREDICT_LADDER_REL):
        raise AssertionError(f"predict-ladder: {pl}")

    # terminal: every fit.host dispatch OOMs, so the fit exhausts its
    # ladder: one DegradationExhaustedError of class oom and one incident
    # bundle with the failing span tree -- the airfoil config (ARD, which
    # does not stream: no matfree rung) and the same fold under the
    # isotropic RBF (every rung)
    incident_dir = tempfile.mkdtemp(prefix="gp_incident_")
    os.environ["GP_INCIDENT_DIR"] = incident_dir
    terminal = {}
    try:
        for label, gp in (("airfoil", airfoil_gp(100)),
                          ("airfoil_rbf", airfoil_gp(100).setKernel(lambda: 1.0 * RBFKernel(1.0)
                                                                    + Const(1.0) * EyeKernel()))):
            before_files = set(os.listdir(incident_dir))
            errors = []
            with chaos.oom_after_calls(0, op="fit.host"):
                try:
                    gp.fit(x[train], y[train])
                except fallback.DegradationExhaustedError as exc:
                    errors.append(exc)
            new = sorted(set(os.listdir(incident_dir)) - before_files)
            bundle = {}
            if len(new) == 1:
                with open(os.path.join(incident_dir, new[0]), encoding="utf-8") as fh:
                    bundle = json.load(fh)
            root = (bundle.get("spans") or [{}])[0]
            terminal[label] = {
                "errors": len(errors),
                "failure_class": errors[0].failure_class if errors else None,
                "rungs": ([errors[0].degradations[0]["from"]]
                          + [d["to"] for d in errors[0].degradations]) if errors else None,
                "bundles": len(new), "bundle_valid": validate_bundle(bundle) == [],
                "bundle_root": root.get("name"), "bundle_root_status": root.get("status"),
                "bundle_children": [c["name"] for c in root.get("children", [])],
                "bundle_events": [e["name"] for e in root.get("events", [])]}
    finally:
        os.environ.pop("GP_INCIDENT_DIR", None)
        shutil.rmtree(incident_dir, ignore_errors=True)
    emit({"phase": "terminal", **terminal})
    expected = {"airfoil": ["native", "iterative", "host_f64"],
                "airfoil_rbf": ["native", "iterative", "matfree", "host_f64"]}
    for label, t in terminal.items():
        if not (t["errors"] == 1 and t["failure_class"] == "oom" and t["rungs"] == expected[label]
                and t["bundles"] == 1 and t["bundle_valid"]
                and t["bundle_root"] == "fit.GaussianProcessRegression"
                and t["bundle_root_status"] == "error"
                and t["bundle_children"] == ["group_experts"]):
            raise AssertionError(f"terminal: {terminal}")
    emit({"phase": "slice8-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return launches


# --- slice 9: persistence, checkpoints and the serving plane -------------

# the serve phase's bucket ladder and closed loop: CLIENTS threads, each
# REQUESTS requests of 1 .. MAX_ROWS rows (seeded), over the persisted
# airfoil model; requests above the top bucket are chunked by the batcher
SERVE_BUCKETS = (8, 256)
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_ROWS = 8, 250, 300
# the answers against the model's own predict_with_var: the mean relative
# to max |mean|, the variance relative to the prior variance
SERVE_MEAN_REL, SERVE_VAR_REL = 1e-5, 1e-5
# eager block and graph replay timings per bucket: medians of this many
SERVE_TIMING_REPS = 50
# the resumed fold fit's theta against the uninterrupted one's
CHECKPOINT_THETA_REL = 1e-3
CHECKPOINT_KILL_AFTER = 3
SERVE_CLI_PREDICTS = 100
#: the serve-cli phase's ``observed`` reply (the quality phase reads it)
CLI_OBSERVED: dict = {}


def _serve_timings(torch, server, name: str) -> dict:
    """Per bucket: the eager ``_predict_block`` (the body the graph holds,
    launched op by op), the graph's replay alone, and the whole bucketed
    dispatch (copy in, replay, copy out), each the median wall ms of
    ``SERVE_TIMING_REPS`` synchronized calls."""
    entry = server.registry.get(name)
    bp = entry.predictor
    rows = {}
    for bucket in bp.buckets:
        x = np.broadcast_to(bp._pad_row, (bucket, bp.n_features)).copy()
        xt = torch.as_tensor(x, device="cuda")
        graph = bp._graphs[bucket]

        def eager():
            with torch.no_grad():
                bp._body(xt)

        def replay():
            graph.graph.replay()

        out = {}
        for label, fn in (("eager_ms", eager), ("replay_ms", replay),
                          ("dispatch_ms", lambda: bp.predict(x))):
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(SERVE_TIMING_REPS):
                start = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
            out[label] = float(np.median(times))
        out["eager_over_replay"] = out["eager_ms"] / out["replay_ms"]
        rows[str(bucket)] = out
    return rows


def _closed_loop(server, name: str, pool: np.ndarray, ref_mean, ref_var, prior: float) -> dict:
    """``SERVE_CLIENTS`` threads, each submitting ``SERVE_REQUESTS``
    requests one after another (a closed loop), of seeded sizes and rows
    drawn from ``pool``; every answer is held against the reference."""
    import threading

    rng = np.random.default_rng(13)
    plans = [[(int(size), rng.integers(0, pool.shape[0], size=int(size)))
              for size in rng.integers(1, SERVE_MAX_ROWS + 1, size=SERVE_REQUESTS)]
             for _ in range(SERVE_CLIENTS)]
    latencies, errors, worst = [], [], {"mean": 0.0, "var": 0.0}
    lock = threading.Lock()
    mean_scale = float(np.max(np.abs(ref_mean)))

    def client(plan):
        for size, idx in plan:
            start = time.perf_counter()
            try:
                mean, var = server.submit(name, pool[idx]).result(timeout=60)
            except Exception as exc:  # noqa: BLE001 -- counted, the bar is zero
                with lock:
                    errors.append(f"{type(exc).__name__}: {exc}"[:200])
                continue
            elapsed = time.perf_counter() - start
            e_mean = float(np.max(np.abs(mean - ref_mean[idx]))) / mean_scale
            e_var = float(np.max(np.abs(var - ref_var[idx]))) / prior
            with lock:
                latencies.append(elapsed)
                worst["mean"] = max(worst["mean"], e_mean)
                worst["var"] = max(worst["var"], e_var)

    batches0 = server.metrics.counter("batches")
    rows0 = server.metrics.counter("requests_rows")
    threads = [threading.Thread(target=client, args=(plan,)) for plan in plans]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - start
    batches = server.metrics.counter("batches") - batches0
    rows = server.metrics.counter("requests_rows") - rows0
    return {
        "clients": SERVE_CLIENTS, "requests": SERVE_CLIENTS * SERVE_REQUESTS,
        "wall_seconds": wall, "requests_per_s": len(latencies) / wall, "rows_per_s": rows / wall,
        "latency_p50_ms": float(np.percentile(latencies, 50) * 1e3),
        "latency_p99_ms": float(np.percentile(latencies, 99) * 1e3),
        "batches": batches, "mean_batch_rows": rows / max(batches, 1),
        "errors": len(errors), "first_errors": errors[:3],
        "max_mean_err_rel": worst["mean"], "max_var_err_rel_prior": worst["var"],
    }


def _serve_cli(path: str) -> dict:
    """``python -m spark_gp_tpu_torch.serve`` on the card as a
    subprocess: the ready line, ``SERVE_CLI_PREDICTS`` predicts, one more
    carrying a ``request_id`` and the ``observe`` of its three labels (the
    quality plane is on by default), health, metrics, then SIGTERM and the
    drained shutdown line with exit 0."""
    import signal
    import threading

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_gp_tpu_torch.serve", "--model", f"airfoil={path}",
         "--max-batch", str(SERVE_BUCKETS[1]), "--min-bucket", str(SERVE_BUCKETS[0])],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO, start_new_session=True,
    )
    fence = threading.Timer(180, lambda: os.killpg(proc.pid, signal.SIGKILL))
    fence.start()
    try:
        ready = json.loads(proc.stdout.readline())
        ready_s = time.perf_counter() - start
        rng = np.random.default_rng(5)
        x = rng.normal(size=(SERVE_CLI_PREDICTS, 20, 5))
        for i in range(SERVE_CLI_PREDICTS):
            rows = int(rng.integers(1, 21))
            proc.stdin.write(json.dumps({"id": i, "model": "airfoil",
                                         "x": x[i, :rows].tolist()}) + "\n")
        proc.stdin.write(json.dumps({"id": SERVE_CLI_PREDICTS, "model": "airfoil",
                                     "x": x[0, :3].tolist(), "request_id": "cli-q"}) + "\n")
        proc.stdin.write(json.dumps({"cmd": "observe", "model": "airfoil", "request_id": "cli-q",
                                     "y": [0.0, 0.5, -0.5]}) + "\n")
        proc.stdin.write(json.dumps({"cmd": "health"}) + "\n")
        proc.stdin.write(json.dumps({"cmd": "metrics"}) + "\n")
        proc.stdin.flush()
        answers, health, metrics, observed = 0, None, None, None
        while metrics is None or observed is None:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError("serve-cli: the server closed its output early")
            event = json.loads(line)
            if "id" in event:
                if "error" in event or not np.all(np.isfinite(event["mean"])):
                    raise AssertionError(f"serve-cli: {event}")
                answers += 1
            elif event.get("event") == "health":
                health = event
            elif event.get("event") == "metrics":
                metrics = event
            elif event.get("event") == "observed":
                observed = event
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=120)
    finally:
        fence.cancel()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    last = json.loads(rest.strip().splitlines()[-1]) if rest.strip() else {}
    return {"ready": ready.get("event"), "ready_platform": ready.get("platform"),
            "ready_seconds": ready_s, "buckets_warmed": ready.get("buckets_warmed"),
            "answers": answers, "health": health and health["status"], "observed": observed,
            "metrics_requests": metrics["counters"].get("requests"),
            "shutdown": last, "returncode": proc.returncode, "stderr_tail": err[-300:]}


def slice9_phases(torch, spd, data_main: dict, smi: str) -> dict:
    """This slice's phases (persist, checkpoint, serve, serve-cli,
    serve-hang); returns K1's launches on each phase's fits."""
    import shutil
    import tempfile

    from spark_gp_tpu_torch.models.gpr import GaussianProcessRegressionModel
    from spark_gp_tpu_torch.resilience import chaos
    from spark_gp_tpu_torch.serve import ExecHungError, GPServeServer
    from spark_gp_tpu_torch.utils.checkpoint import load_checkpoint

    launches = {}
    start_all = time.perf_counter()
    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    train, test = folds[0]
    work = tempfile.mkdtemp(prefix="gp_slice9_")
    try:
        # persist: the airfoil config on all 1503 rows (m = 1000), saved
        # and loaded on the card; the loaded model's predictions bit-equal
        zero(spd.spd_inv_logdet)
        start = time.perf_counter()
        model = airfoil_gp(100).fit(x, y)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - start
        launches["persist"] = spd.spd_inv_logdet.launches
        persist_probe = probes(spd.spd_inv_logdet)
        path = os.path.join(work, "airfoil.npz")
        start = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - start
        start = time.perf_counter()
        loaded = GaussianProcessRegressionModel.load(path)
        load_s = time.perf_counter() - start
        mean, var = model.predict_with_var(x)
        lmean, lvar = loaded.predict_with_var(x)
        persist = {"rows": int(x.shape[0]), "m": int(model.raw_predictor.active.shape[0]),
                   "fit_seconds": fit_s, "save_seconds": save_s, "load_seconds": load_s,
                   "file_bytes": os.path.getsize(path), "nfev": model.metrics["lbfgs_nfev"],
                   "launches": launches["persist"], "probe_launches": persist_probe,
                   "bit_equal": bool(np.array_equal(mean, lmean) and np.array_equal(var, lvar)),
                   "loaded_device": loaded.raw_predictor.device,
                   "provenance": loaded.provenance}
        emit({"phase": "persist", **persist, "card": smi})
        if not (persist["bit_equal"]
                and persist["launches"] == persist["nfev"] + persist_probe == persist["nfev"] + 1
                and persist["loaded_device"] == "cuda"):
            raise AssertionError(f"persist: {persist}")

        # checkpoint: the first airfoil fold, uninterrupted, then preempted
        # after CHECKPOINT_KILL_AFTER saves and resumed
        full, full_s = airfoil_fold_fit(airfoil_gp(100), x, y, train)
        ck_dir = os.path.join(work, "ckpt")
        zero(spd.spd_inv_logdet)
        start = time.perf_counter()
        try:
            with chaos.preempt_after_saves(CHECKPOINT_KILL_AFTER):
                airfoil_gp(100).setCheckpointDir(ck_dir).fit(x[train], y[train])
            raise AssertionError("checkpoint: the staged preemption did not fire")
        except chaos.SimulatedPreemption as exc:
            leg1_nfev = exc.nfev
        leg1_s = time.perf_counter() - start
        saved_iteration = load_checkpoint(ck_dir, tag="GaussianProcessRegression")[0]
        resumed, leg2_s = airfoil_fold_fit(airfoil_gp(100).setCheckpointDir(ck_dir), x, y, train)
        launches["checkpoint"] = spd.spd_inv_logdet.launches
        ckpt_probe = probes(spd.spd_inv_logdet)
        theta_rel = float(np.max(np.abs(resumed.raw_predictor.theta - full.raw_predictor.theta)
                                 / np.abs(full.raw_predictor.theta)))
        from spark_gp_tpu_torch.utils.validation import rmse

        ckpt = {"fold": [int(len(train)), int(len(test))], "kill_after_saves": CHECKPOINT_KILL_AFTER,
                "saved_iteration": saved_iteration,
                "leg1_nfev": leg1_nfev, "leg1_seconds": leg1_s,
                "leg2_nfev": resumed.metrics["lbfgs_nfev"], "leg2_seconds": leg2_s,
                "leg2_iters": resumed.metrics["lbfgs_iters"],
                "resumed_from_iteration": resumed.metrics.get("resumed_from_iteration"),
                "full_iters": full.metrics["lbfgs_iters"], "full_nfev": full.metrics["lbfgs_nfev"],
                "full_seconds": full_s, "theta_rel_err": theta_rel,
                "bar": CHECKPOINT_THETA_REL, "launches": launches["checkpoint"],
                "probe_launches": ckpt_probe,
                "rmse_full": rmse(y[test], full.predict(x[test])),
                "rmse_resumed": rmse(y[test], resumed.predict(x[test]))}
        emit({"phase": "checkpoint", **ckpt, "card": smi})
        if not (theta_rel < CHECKPOINT_THETA_REL and saved_iteration == CHECKPOINT_KILL_AFTER
                and ckpt["resumed_from_iteration"] == CHECKPOINT_KILL_AFTER
                and launches["checkpoint"] == leg1_nfev + ckpt["leg2_nfev"] + ckpt_probe
                and ckpt_probe == 1):
            raise AssertionError(f"checkpoint: {ckpt}")

        # serve: the persisted model behind the server on the card, buckets
        # 8 .. 256: one graph a bucket at warmup and none after; eager
        # against replay per bucket; the closed loop against the model
        server = GPServeServer(min_bucket=SERVE_BUCKETS[0], max_batch=SERVE_BUCKETS[1],
                               request_timeout_ms=30_000.0, hang_timeout_s=30.0)
        start = time.perf_counter()
        entry = server.register("airfoil", path)
        warmup_s = time.perf_counter() - start
        server.start()
        try:
            captures = dict(entry.predictor.compile_counts)
            timings = _serve_timings(torch, server, "airfoil")
            rng = np.random.default_rng(17)
            pool = np.concatenate([x, x[rng.integers(0, x.shape[0], size=2497)]
                                   + 0.1 * rng.standard_normal((2497, x.shape[1]))])
            ref_mean, ref_var = loaded.predict_with_var(pool)
            raw = loaded.raw_predictor
            theta64 = torch.as_tensor(raw.theta, dtype=torch.float64)
            prior = float(torch.max(raw.kernel.self_diag(
                theta64, torch.as_tensor(pool[:64], dtype=torch.float64))))
            loop = _closed_loop(server, "airfoil", pool, ref_mean, ref_var, prior)
            captures_after = dict(entry.predictor.compile_counts)
            serve = {"buckets": list(entry.predictor.buckets), "warmup_seconds": warmup_s,
                     "captures": captures, "captures_after": captures_after,
                     "prior_variance": prior, "per_bucket": timings, "closed_loop": loop,
                     "bars": {"mean_rel": SERVE_MEAN_REL, "var_rel_prior": SERVE_VAR_REL},
                     "health": server.health()["status"]}
        finally:
            server.stop()
        emit({"phase": "serve", **serve, "card": smi})
        if not (set(captures.values()) == {1} and len(captures) == len(entry.predictor.buckets)
                and captures_after == captures and loop["errors"] == 0
                and loop["max_mean_err_rel"] < SERVE_MEAN_REL
                and loop["max_var_err_rel_prior"] < SERVE_VAR_REL and serve["health"] == "ok"):
            raise AssertionError(f"serve: {serve}")

        # serve-cli: the CLI on the card as a subprocess
        cli = _serve_cli(path)
        CLI_OBSERVED.update(cli["observed"] or {})
        emit({"phase": "serve-cli", **cli, "card": smi})
        if not (cli["ready"] == "ready" and cli["ready_platform"] == "gpu"
                and cli["answers"] == SERVE_CLI_PREDICTS + 1 and cli["health"] == "ok"
                and cli["metrics_requests"] == SERVE_CLI_PREDICTS + 1
                and cli["observed"].get("joined") == 3 and "error" not in cli["observed"]
                and cli["shutdown"].get("event") == "shutdown"
                and cli["shutdown"].get("drained") is True and cli["returncode"] == 0):
            raise AssertionError(f"serve-cli: {cli}")

        # serve-hang: a second model wedged; the watchdog fails its batch
        # with exec.hung and trips its breaker, the first keeps answering
        server = GPServeServer(min_bucket=SERVE_BUCKETS[0], max_batch=32, hang_timeout_s=1.0,
                               breaker_reset_s=600.0)
        server.register("airfoil", path)
        server.register("wedged", path)
        server.start()
        hanging = chaos.hang_model(server, "wedged", hang_forever=True)
        try:
            start = time.perf_counter()
            future = server.submit("wedged", x[:4])
            try:
                future.result(timeout=60)
                code = None
            except ExecHungError as exc:
                code = exc.code
            verdict_s = time.perf_counter() - start
            answered = server.predict("airfoil", x[:16])[0]
            health = server.health()
            hang = {"code": code, "verdict_seconds": verdict_s,
                    "other_model_answers": bool(np.array_equal(answered, lmean[:16])
                                                or np.allclose(answered, lmean[:16], rtol=1e-5)),
                    "broken_models": health["broken_models"], "status": health["status"],
                    "exec_hung": server.metrics.counter("exec.hung"),
                    "breaker_trips": server.metrics.counter("breaker.trips")}
        finally:
            hanging.release()
            server.stop()
        emit({"phase": "serve-hang", **hang, "card": smi})
        if not (code == "exec.hung" and hang["other_model_answers"]
                and hang["broken_models"] == ["wedged"] and hang["exec_hung"] == 1):
            raise AssertionError(f"serve-hang: {hang}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "slice9-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return launches


# slice 10: the on-device optimizer
DEVICE_CKPT_INTERVAL, DEVICE_CKPT_KILL_AFTER = 5, 2
#: the segmented rung's theta against the clean device fit's: the same
#: captured step on the same inputs, so float32 noise at most
SEGMENTED_THETA_REL = 1e-5
PROTEIN_DEVICE_RMSE_REL = 0.02
REPLAY_TIMING_REPS = 30
#: the host optimizer's fits the device phases are set beside (airfoil,
#: protein, timeseries), filled by their phases
HOST_FITS: dict = {}


def staged_oom_walk(gp) -> list:
    """The rungs an OOM staged at every one-shot device dispatch walks: the
    solver rungs (a device fit takes them, and fails there at the same
    choke point; matfree only for a kernel that streams), then
    ``segmented``, whose segments complete the fit."""
    from spark_gp_tpu_torch.kernels.base import supports_matfree

    rungs = ["native", "iterative"] + (["matfree"] if supports_matfree(gp._get_kernel()) else [])
    return list(zip(rungs, rungs[1:] + ["segmented"]))


def k1_rule(m: dict) -> float:
    """K1 launches a device fit on the marginal or LOO objective makes: one
    per replay of its step, plus its first evaluation (the initial one, or
    a resumed leg's capture warm-up)."""
    first = m.get("device_opt.warmup_evaluations", 0.0) if m.get("resumed_from_iteration") \
        else 1.0
    return m.get("device_opt.replays", 0.0) + first


def probe_rule(m: dict, kernel: str = "spd_inv_logdet") -> float:
    """The probe term of a launch rule from one fit's metrics: the launches
    of ``kernel`` its expert-quality probe stamped
    (``expert_quality.probe_launches.<kernel>``; one batched pass, no
    gradient)."""
    return m.get(f"expert_quality.probe_launches.{kernel}", 0.0)


def with_probes(rule: dict, *metrics) -> dict:
    """``rule`` (kernel name -> launches) with each fit's probe term
    (:func:`probe_rule`) added, ``metrics`` one dict a fit."""
    return {k: v + sum(probe_rule(m, k) for m in metrics) for k, v in rule.items()}


def loop_record(m: dict) -> dict:
    """A device fit's loop metrics, named without the prefix."""
    return {k.split(".", 1)[1]: v for k, v in m.items() if k.startswith("device_opt.")}


def replay_profile(torch, kernel, data, cache=None, objective="marginal", extra=()) -> dict:
    """The device optimizer's step at its first iterate, captured as the
    fit captures it, beside the objective evaluation alone captured into a
    graph of its own: node counts (``cuGraphGetNodes``) and device ms a
    replay (CUDA events over REPLAY_TIMING_REPS replays), and the host ms
    of one eager step.  The launches these make are not the main path's:
    the caller restores K1's count."""
    from spark_gp_tpu_torch.models import likelihood as lk
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.optimize import lbfgs_device as ld

    dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=data.x.dtype,
                                    device=data.x.device)
    vag = ld.log_transform_vag(lk.make_device_value_and_grad(kernel, data, cache, objective,
                                                             extra))
    lower, upper = ld.log_transform_bounds(*(dev(b) for b in kernel.bounds()))
    cfg = ld.LbfgsConfig(lower=lower, upper=upper)
    state = ld.lbfgs_init_state(vag, torch.log(dev(kernel.init_theta()))[None], cfg)

    def replay_ms(graph):
        graph.replay()
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(REPLAY_TIMING_REPS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return begin.elapsed_time(end) / REPLAY_TIMING_REPS

    eager = {k: v.clone() for k, v in state.items()}
    limit = torch.full((), 10 ** 6, dtype=torch.int32, device=data.x.device)
    ld.lbfgs_step(vag, eager, cfg, limit)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(3):
        eager = ld.lbfgs_step(vag, eager, cfg, limit)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - start) / 3 * 1e3
    loop = ld.DeviceLoop(vag, state, cfg)
    loop.iter_limit.fill_(10 ** 6)
    try:
        loop.capture(warm=True)
        step_ms = replay_ms(loop.graph)
        theta = state["theta"].clone()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with cuda_lib.collector_held(), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            vag(theta)
        graph.instantiate()
        eval_nodes, eval_ms = ld.graph_nodes(graph), replay_ms(graph)
        graph.reset()
    finally:
        loop.release()
    return {"h": int(state["theta"].shape[1]), "step_graph_nodes": loop.counts["graph_nodes"],
            "eval_graph_nodes": eval_nodes, "step_ms_per_replay": step_ms,
            "eval_ms_per_replay": eval_ms, "eager_step_host_ms": eager_ms,
            "capture_seconds": loop.counts["capture_seconds"]}


def slice10_phases(torch, spd, data_main: dict, rdata: dict, host: dict, smi: str) -> dict:
    """This slice's phases (device-opt-check, airfoil-device,
    synthetics-device, protein-device, timeseries-sm-device,
    checkpoint-device, segmented-rung); ``host`` carries the host
    optimizer's phases to set beside them.  Returns K1's launches on each
    phase's fits."""
    import shutil
    import tempfile

    from spark_gp_tpu_torch import Const, EyeKernel
    from spark_gp_tpu_torch.models import likelihood as lk
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.resilience import chaos
    from spark_gp_tpu_torch.utils.validation import rmse

    launches = {}
    start_all = time.perf_counter()
    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    train, test = folds[0]

    # device-opt-check: the fold's device fit, replayed and eager
    kernel = airfoil_kernel() + Const(1e-4) * EyeKernel()
    data = group_for_experts(x[train], y[train], 100, dtype=torch.float32, device="cuda")
    dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float32,
                                    device="cuda")
    lower, upper = (dev(b) for b in kernel.bounds())
    runs = {}
    before = spd.spd_inv_logdet.launches
    for mode, capture in (("graph", True), ("eager", False)):
        loop = {}
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = lk.fit_gpr_device(kernel, True, dev(kernel.init_theta()), lower, upper, data, 100,
                                1e-6, capture=capture, loop_metrics=loop)
        theta, f, n_iter, n_fev, _ = (v.cpu().numpy() for v in out)
        runs[mode] = {"theta": theta, "f": float(f), "n_iter": int(n_iter),
                      "n_fev": int(n_fev), "seconds": time.perf_counter() - start, "loop": loop}
    profile = replay_profile(torch, kernel, data)
    spd.spd_inv_logdet.launches = before
    g, e = runs["graph"], runs["eager"]
    check = {"shape": list(data.x.shape[:2]), "theta_equal": bool(np.array_equal(g["theta"],
                                                                                  e["theta"])),
             "f_equal": g["f"] == e["f"], "n_iter": [g["n_iter"], e["n_iter"]],
             "n_fev": [g["n_fev"], e["n_fev"]],
             "seconds": {"graph": g["seconds"], "eager": e["seconds"]},
             "loop": g["loop"], "eager_loop": e["loop"], **profile,
             "theta_max_abs_diff": float(np.max(np.abs(g["theta"] - e["theta"])))}
    emit({"phase": "device-opt-check", **check, "card": smi})
    if not (check["theta_equal"] and check["f_equal"] and g["n_iter"] == e["n_iter"]
            and g["n_fev"] == e["n_fev"] and g["loop"]["captures"] == 1):
        raise AssertionError(f"device-opt-check: {check}")

    # airfoil-device: the 10-fold CV on the device optimizer
    zero(spd.spd_inv_logdet)
    cv = regression_cv(airfoil_gp(100).setOptimizer("device"), x, y, folds)
    cv.pop("first_model")
    rule = sum(k1_rule(fold) + probe_rule(fold) for fold in cv["per_fold"])
    cv["launches"] = launches["airfoil_device"] = spd.spd_inv_logdet.launches
    emit({"phase": "airfoil-device", **cv, "k1_rule": rule,
          "k1_rule_terms": "replays + first evaluations + expert-quality probes",
          "probe_launches": probes(spd.spd_inv_logdet),
          "host_per_fold": host["airfoil"]["per_fold"],
          "host_optimize_seconds": host["airfoil"]["optimize_seconds"],
          "host_nfev": host["airfoil"]["nfev"], "card": smi})
    if not (cv["rmse"] < 2.1 and cv["launches"] == rule > 0
            and probes(spd.spd_inv_logdet) == len(folds)):
        raise AssertionError(f"airfoil-device: rmse {cv['rmse']}, {cv['launches']} K1 launches "
                             f"for {rule} by the rule")

    # synthetics-device: the CV and the three held-out objective fits
    xs, ys, tr, te = rdata["x"], rdata["y"], rdata["tr"], rdata["te"]
    zero(spd.spd_inv_logdet)
    scv = regression_cv(synthetics_gp().setOptimizer("device"), xs, ys, rdata["folds"])
    scv.pop("first_model")
    scv["launches"] = spd.spd_inv_logdet.launches
    scv["k1_rule"] = sum(k1_rule(fold) + probe_rule(fold) for fold in scv["per_fold"])
    held = {}
    total = scv["launches"]
    for objective, counted in (("marginal", 1), ("loo", 1), ("elbo", 0)):
        zero(spd.spd_inv_logdet)
        model = synthetics_gp(objective).setOptimizer("device").fit(xs[tr], ys[tr])
        m = model.metrics
        held[objective] = {"rmse": rmse(ys[te], model.predict(xs[te])),
                           "final_objective": m["final_nll"], "nfev": m["lbfgs_nfev"],
                           "optimize_seconds": m["optimize_seconds"],
                           "launches": spd.spd_inv_logdet.launches,
                           "k1_rule": counted * k1_rule(m) + probe_rule(m),
                           "probe_launches": probe_rule(m), "loop": loop_record(m)}
        total += spd.spd_inv_logdet.launches
    launches["synthetics_device"] = total
    emit({"phase": "synthetics-device", "cv": scv, "held_out": held, "bar": SYNTHETICS_BAR,
          "card": smi})
    if not (scv["rmse"] < SYNTHETICS_BAR and scv["launches"] == scv["k1_rule"] > 0
            and all(r["rmse"] < SYNTHETICS_BAR and r["launches"] == r["k1_rule"]
                    for r in held.values())):
        raise AssertionError(f"synthetics-device: cv {scv['rmse']}, held-out {held}")

    # protein-device: the protein config on the device optimizer
    xp, yp, ptr, pte = data_main["xp"], data_main["yp"], data_main["tr"], data_main["te"]
    gp = copy.copy(host["protein"]["gp"]).setOptimizer("device")
    zero(spd.spd_inv_logdet)
    start = time.perf_counter()
    model = gp.fit(xp[ptr], data_main["yp_tr"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    m = model.metrics
    launches["protein_device"] = spd.spd_inv_logdet.launches
    pred = model.predict(xp[pte]) * data_main["y_std"] + data_main["y_mean"]
    pdata = group_for_experts(xp[ptr], data_main["yp_tr"], 100, dtype=torch.float32,
                              device="cuda")
    before = spd.spd_inv_logdet.launches
    pprof = replay_profile(torch, model.raw_predictor.kernel, pdata)
    spd.spd_inv_logdet.launches = before
    evals = k1_rule(m)
    probe = probe_rule(m)
    prot = {"rmse": rmse(yp[pte], pred), "host_rmse": host["protein"]["rmse"],
            "fit_seconds": fit_s, "nfev": m["lbfgs_nfev"], "lbfgs_iters": m["lbfgs_iters"],
            "optimize_seconds": m["optimize_seconds"], "launches": launches["protein_device"],
            "k1_rule": evals + probe, "probe_launches": probe, "loop": loop_record(m),
            "wall_ms_per_evaluation": m["optimize_seconds"] / evals * 1e3,
            "host_optimize_seconds": host["protein"]["optimize_seconds"],
            "host_nfev": host["protein"]["nfev"],
            "host_wall_ms_per_evaluation": host["protein"]["optimize_seconds"]
                                           / host["protein"]["nfev"] * 1e3,
            "bar_rel": PROTEIN_DEVICE_RMSE_REL, **pprof}
    emit({"phase": "protein-device", **prot, "card": smi})
    if not (abs(prot["rmse"] - prot["host_rmse"]) <= PROTEIN_DEVICE_RMSE_REL * prot["host_rmse"]
            and prot["launches"] == evals + probe and evals > 0 and probe == 1):
        raise AssertionError(f"protein-device: {prot}")

    # timeseries-sm-device: eight restarts as one batched loop
    xs_ts, ys_ts, xe, ye = rdata["ts"]
    zero(spd.spd_inv_logdet)
    start = time.perf_counter()
    model = timeseries_gp("sm").setOptimizer("device").fit(xs_ts, ys_ts)
    pred = model.predict(xe)
    seconds = time.perf_counter() - start
    m = model.metrics
    launches["timeseries_sm_device"] = spd.spd_inv_logdet.launches
    ts = {"extrapolation_rmse": rmse(ye, pred), "seconds": seconds,
          "restart_nlls": [m[f"restart_{r}_nll"] for r in range(m["num_restarts"])],
          "best_restart": m["best_restart"], "nfev_winner": m["lbfgs_nfev"],
          "optimize_seconds": m["optimize_seconds"], "launches": launches["timeseries_sm_device"],
          "k1_rule": k1_rule(m) + probe_rule(m), "probe_launches": probe_rule(m),
          "matrices_per_launch": int(m["num_restarts"] * m["num_experts"]),
          "expert_size": m["expert_size"], "loop": loop_record(m), "bar": TIMESERIES_BAR,
          "host": host["timeseries"]}
    emit({"phase": "timeseries-sm-device", **ts, "card": smi})
    if not (ts["extrapolation_rmse"] < TIMESERIES_BAR and ts["launches"] == ts["k1_rule"] > 0
            and ts["matrices_per_launch"] == 16):
        raise AssertionError(f"timeseries-sm-device: {ts}")

    work = tempfile.mkdtemp(prefix="gp_slice10_")
    try:
        # checkpoint-device: interval 5, preempted after 2 saves, resumed
        def ck_gp(directory):
            return airfoil_gp(100).setOptimizer("device").setCheckpointDir(directory) \
                .setCheckpointInterval(DEVICE_CKPT_INTERVAL)

        full = ck_gp(os.path.join(work, "full")).fit(x[train], y[train])
        zero(spd.spd_inv_logdet)
        try:
            with chaos.preempt_after_saves(DEVICE_CKPT_KILL_AFTER):
                ck_gp(os.path.join(work, "cut")).fit(x[train], y[train])
            raise AssertionError("checkpoint-device: the staged preemption did not fire")
        except chaos.SimulatedPreemption as exc:
            leg1 = {"nfev": exc.nfev, **exc.loop_metrics}
        resumed = ck_gp(os.path.join(work, "cut")).fit(x[train], y[train])
        launches["checkpoint_device"] = spd.spd_inv_logdet.launches
        leg2 = loop_record(resumed.metrics)
        rule = (leg1["replays"] + 1) + k1_rule(resumed.metrics) + probe_rule(resumed.metrics)
        ck = {"interval": DEVICE_CKPT_INTERVAL, "kill_after_saves": DEVICE_CKPT_KILL_AFTER,
              "theta_bit_equal": bool(np.array_equal(resumed.raw_predictor.theta,
                                                     full.raw_predictor.theta)),
              "resumed_from_iteration": resumed.metrics.get("resumed_from_iteration"),
              "leg1": leg1, "leg2": leg2, "full_iters": full.metrics["lbfgs_iters"],
              "resumed_iters": resumed.metrics["lbfgs_iters"],
              "launches": launches["checkpoint_device"], "k1_rule": rule}
        emit({"phase": "checkpoint-device", **ck, "card": smi})
        if not (ck["theta_bit_equal"]
                and ck["resumed_from_iteration"] == DEVICE_CKPT_INTERVAL * DEVICE_CKPT_KILL_AFTER
                and ck["launches"] == rule):
            raise AssertionError(f"checkpoint-device: {ck}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # segmented-rung: a staged OOM at the one-shot device fit's choke point
    clean = airfoil_gp(100).setOptimizer("device").fit(x[train], y[train])
    zero(spd.spd_inv_logdet)
    with chaos.oom_after_calls(0, op="one_dispatch") as fired:
        model = airfoil_gp(100).setOptimizer("device").fit(x[train], y[train])
    launches["segmented_rung"] = spd.spd_inv_logdet.launches
    rel = float(np.max(np.abs(model.raw_predictor.theta - clean.raw_predictor.theta)
                       / np.abs(clean.raw_predictor.theta)))
    seg = {"injected": fired[0], "degradations": model.degradations, "theta_rel_err": rel,
           "bar": SEGMENTED_THETA_REL, "launches": launches["segmented_rung"],
           "k1_rule": k1_rule(model.metrics) + probe_rule(model.metrics),
           "probe_launches": probe_rule(model.metrics), "loop": loop_record(model.metrics)}
    emit({"phase": "segmented-rung", **seg, "card": smi})
    walk = staged_oom_walk(airfoil_gp(100))
    if not (fired[0] == len(walk) and [(d["from"], d["to"]) for d in model.degradations]
            == walk and rel <= SEGMENTED_THETA_REL and seg["launches"] == seg["k1_rule"]):
        raise AssertionError(f"segmented-rung: {seg}")
    emit({"phase": "slice10-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return launches


# --- slice 11: the device fits of the Laplace families ------------------------

#: the checkpoint-device-gpc leg's interval and kill point
GPC_CKPT_INTERVAL, GPC_CKPT_KILL_AFTER = 1, 2
#: the multistart phase's restarts (iris-native, one batched loop)
MC_RESTARTS = 4


def latent_k1_rule(m: dict) -> float:
    """K1 launches of a Laplace family's device fit (summed metrics of one
    or more fits): every replay or eager step runs the step's ``newton_k``
    Newton iterations and its gradient pass (``pass_k1_calls`` K1 calls;
    the card's PyTorch has no conditional graph node to skip them), and
    every eager evaluation (the initial one, a resumed leg's warm-up) its
    own Newton iterations and pass; plus the probe term, the fit's
    expert-quality probe (:func:`probe_rule`: one K1 launch on the exact
    lane; 0 for a loop's metrics outside an estimator's fit)."""
    steps = m.get("device_opt.replays", 0.0) + m.get("device_opt.eager_steps", 0.0)
    k, p = m["device_opt.newton_k"], m["device_opt.pass_k1_calls"]
    return (steps * (k + p) + m["device_opt.eager_newton_iterations"]
            + p * m["device_opt.eager_evaluations"] + probe_rule(m))


def summed_rule(models) -> float:
    """:func:`latent_k1_rule` over several fits (each with its probe term)."""
    return sum(latent_k1_rule(model.metrics) for model in models)


#: the device-loop metrics a device CV sums over its fits
LATENT_LOOP_KEYS = tuple(f"device_opt.{k}" for k in (
    "replays", "eager_steps", "masked_evaluations", "host_syncs", "capture_seconds",
    "graph_nodes", "newton_iterations", "gradient_passes"))


def latent_replay_profile(torch, lanes, log_space: bool, theta0) -> dict:
    """The Laplace device step at its first iterate, captured as the fit
    captures it, beside one trial alone (the step's Newton iterations and
    gradient pass from a fresh Newton state) captured into a graph of its
    own: node counts and device ms a replay, the host ms of one eager step,
    and whether the capture used conditional nodes (the card's PyTorch
    has none).  The launches are not the main path's: the caller restores
    K1's count."""
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.optimize import lbfgs_device as ld

    dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=lanes.x.dtype,
                                    device=lanes.x.device)
    vag = ld.log_transform_vag(lanes) if log_space else lanes
    lower, upper = (dev(b) for b in lanes.kernel.bounds())
    if log_space:
        lower, upper = ld.log_transform_bounds(lower, upper)
    start = torch.log(dev(theta0)) if log_space else dev(theta0)
    cfg = ld.LbfgsConfig(lower=lower, upper=upper)
    state = ld.lbfgs_init_state(vag, start[None], cfg, lanes.aux0(1))

    def replay_ms(graph):
        graph.replay()
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(REPLAY_TIMING_REPS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return begin.elapsed_time(end) / REPLAY_TIMING_REPS

    eager = {k: v.clone() for k, v in state.items()}
    limit = torch.full((), 10 ** 6, dtype=torch.int32, device=lanes.x.device)
    ld.lbfgs_step(vag, eager, cfg, limit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eager = ld.lbfgs_step(vag, eager, cfg, limit)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 3 * 1e3
    loop = ld.DeviceLoop(vag, state, cfg)
    loop.iter_limit.fill_(10 ** 6)
    try:
        loop.capture(warm=True)
        step_ms = replay_ms(loop.graph)
        theta = state["theta"].clone()
        carry = lanes.reset(state["aux"].clone())
        run = torch.ones(1, dtype=torch.bool, device=lanes.x.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with cuda_lib.collector_held(), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            vag.trial(theta, carry, run)
        graph.instantiate()
        trial_nodes, trial_ms = ld.graph_nodes(graph), replay_ms(graph)
        graph.reset()
    finally:
        loop.release()
    return {"h": int(state["theta"].shape[1]), "newton_k": lanes.newton_k,
            "step_graph_nodes": loop.counts["graph_nodes"], "trial_graph_nodes": trial_nodes,
            "step_ms_per_replay": step_ms, "trial_ms_per_replay": trial_ms,
            "eager_step_host_ms": eager_ms, "capture_seconds": loop.counts["capture_seconds"],
            "conditional_nodes": hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")}


def device_row(label: str, seconds: float, m: dict, fits: int = 1) -> dict:
    """One row of the host-against-device table: optimize seconds,
    evaluations, Newton iterations an evaluation, the loop's replays,
    masked lane steps, graph nodes and capture seconds, and wall ms an
    evaluation (``m`` the fits' summed metrics)."""
    nfev = m["lbfgs_nfev"]
    return {"config": label, "fits": fits, "seconds": seconds,
            "optimize_seconds": m["optimize_seconds"], "evaluations": nfev,
            "newton_per_eval": m["newton_iterations"] / max(1.0, m["objective_calls"]),
            "replays": m.get("device_opt.replays"),
            "masked_lane_steps": m.get("device_opt.masked_evaluations"),
            "graph_nodes_per_fit": m.get("device_opt.graph_nodes", 0.0) / fits,
            "capture_seconds": m.get("device_opt.capture_seconds"),
            "wall_ms_per_evaluation": m["optimize_seconds"] / nfev * 1e3}


def host_row(label: str, h, fits: int = 1):
    """The host optimizer's row of the same config, from its phase."""
    if not h:
        return None
    return {"config": label, "fits": fits, "seconds": h["seconds"],
            "optimize_seconds": h["optimize_seconds"], "evaluations": h["lbfgs_nfev"],
            "newton_per_eval": h["newton_iterations"] / max(1.0, h["objective_calls"]),
            "wall_ms_per_evaluation": h["optimize_seconds"] / h["lbfgs_nfev"] * 1e3}


def slice11_phases(torch, spd, cdata: dict, d6: dict, host: dict, smi: str) -> dict:
    """This slice's phases (gpc-device-check, gpc-mnist-device,
    iris-ovr-device, iris-native-device, poisson-device, nb-device,
    multistart, checkpoint-device-gpc, segmented-rung-gpc,
    laplace-device-table); ``host`` carries the host optimizer's phases
    to set beside them.  Returns K1's launches on each phase's fits."""
    import shutil
    import tempfile

    from spark_gp_tpu_torch.kernels.base import prepare_gram_cache
    from spark_gp_tpu_torch.models import laplace as lap
    from spark_gp_tpu_torch.resilience import chaos
    from spark_gp_tpu_torch.utils.validation import OneVsRest

    launches, rows = {}, []
    start_all = time.perf_counter()
    xm_tr, ym_tr = cdata["xm"][cdata["tr_m"]], cdata["ym"][cdata["tr_m"]]

    # gpc-device-check: gpc-mnist's device fit (E = 16, s = 100), replayed
    # and eager: the same theta, latent modes, objective and counts
    gp = mnist_gpc()
    kernel = gp._get_kernel()
    data = gp._group(xm_tr, ym_tr, torch.device("cuda"))
    cache = prepare_gram_cache(kernel, data.x)
    dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float32,
                                    device="cuda")
    lower, upper = (dev(b) for b in kernel.bounds())
    log_space = gp._use_log_space(kernel)
    runs = {}
    before = spd.spd_inv_logdet.launches
    for mode, capture in (("graph", True), ("eager", False)):
        loop = {}
        zero(spd.spd_inv_logdet)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lap.fit_gpc_device(kernel, gp._tol, log_space, dev(kernel.init_theta()), lower,
                                 upper, data, gp._max_iter, cache, capture=capture,
                                 loop_metrics=loop)
        theta, aux, f, n_iter, n_fev, _ = (v.cpu().numpy() for v in out)
        m = {f"device_opt.{k}": float(v) for k, v in loop.items() if v is not None}
        runs[mode] = {"theta": theta, "aux": aux, "f": float(f), "n_iter": int(n_iter),
                      "n_fev": int(n_fev), "seconds": time.perf_counter() - t0, "loop": loop,
                      "launches": spd.spd_inv_logdet.launches, "k1_rule": latent_k1_rule(m)}
    profile = latent_replay_profile(torch, lap.BinaryLaplaceLanes(kernel, data, gp._tol, cache),
                                    log_space, kernel.init_theta())
    spd.spd_inv_logdet.launches = before
    g, e = runs["graph"], runs["eager"]
    launches["gpc_device_check"] = g["launches"] + e["launches"]
    check = {"shape": list(data.x.shape[:2]),
             "theta_equal": bool(np.array_equal(g["theta"], e["theta"])),
             "aux_equal": bool(np.array_equal(g["aux"], e["aux"])), "f_equal": g["f"] == e["f"],
             "n_iter": [g["n_iter"], e["n_iter"]], "n_fev": [g["n_fev"], e["n_fev"]],
             "newton_iterations": [g["loop"]["newton_iterations"],
                                   e["loop"]["newton_iterations"]],
             "gradient_passes": [g["loop"]["gradient_passes"], e["loop"]["gradient_passes"]],
             "launches": [g["launches"], e["launches"]], "k1_rule": [g["k1_rule"], e["k1_rule"]],
             "seconds": {"graph": g["seconds"], "eager": e["seconds"]},
             "loop": g["loop"], "eager_loop": e["loop"], **profile}
    emit({"phase": "gpc-device-check", **check, "card": smi})
    if not (check["theta_equal"] and check["aux_equal"] and check["f_equal"]
            and g["n_iter"] == e["n_iter"] and g["n_fev"] == e["n_fev"]
            and g["loop"]["newton_iterations"] == e["loop"]["newton_iterations"]
            and g["loop"]["gradient_passes"] == e["loop"]["gradient_passes"] == g["n_fev"]
            and g["launches"] == g["k1_rule"] > 0 and e["launches"] == e["k1_rule"]
            and g["loop"]["captures"] == 1):
        raise AssertionError(f"gpc-device-check: {check}")

    # gpc-mnist-device: examples/mnist.py's config on the device optimizer
    zero(spd.spd_inv_logdet)
    fit = split_fit(mnist_gpc().setOptimizer("device"), cdata["xm"], cdata["ym"])
    model = fit.pop("model")
    m = model.metrics
    launches["gpc_mnist_device"] = spd.spd_inv_logdet.launches
    row = device_row("gpc-mnist", fit["seconds"],
                     {**m, "optimize_seconds": fit["optimize_seconds"]})
    rows.append({"device": row, "host": host_row("gpc-mnist", host.get("gpc_mnist"))})
    emit({"phase": "gpc-mnist-device", **fit, "launches": launches["gpc_mnist_device"],
          "probe_launches": probe_rule(m),
          "k1_rule": latent_k1_rule(m), "loop": loop_record(m), "bar": GPC_BARS["gpc_mnist"],
          "host_accuracy": (host.get("gpc_mnist") or {}).get("accuracy"), "card": smi})
    if not (fit["accuracy"] > GPC_BARS["gpc_mnist"]
            and launches["gpc_mnist_device"] == latent_k1_rule(m) > 0):
        raise AssertionError(f"gpc-mnist-device: {fit}, {launches['gpc_mnist_device']} K1")

    # iris-ovr-device: one-vs-rest 10-fold CV (30 device fits)
    zero(spd.spd_inv_logdet)
    fitted = []
    iris = cv_fits(torch, cdata, lambda: OneVsRest(lambda: iris_gpc().setOptimizer("device")),
                   lambda ovr: fitted.extend(ovr.models_) or ovr.models_, None,
                   extra=LATENT_LOOP_KEYS)
    launches["iris_ovr_device"] = spd.spd_inv_logdet.launches
    rule = summed_rule(fitted)
    rows.append({"device": device_row("iris-ovr", iris["seconds"], iris, iris["fits"]),
                 "host": host_row("iris-ovr", host.get("iris_ovr"), 30)})
    emit({"phase": "iris-ovr-device", **iris, "launches": launches["iris_ovr_device"],
          "probe_launches": probes(spd.spd_inv_logdet),
          "k1_rule": rule, "bar": GPC_BARS["iris_ovr"],
          "host_accuracy": (host.get("iris_ovr") or {}).get("accuracy"), "card": smi})
    if not (iris["accuracy"] >= GPC_BARS["iris_ovr"] and iris["fits"] == 30
            and launches["iris_ovr_device"] == rule > 0):
        raise AssertionError(f"iris-ovr-device: {iris}, {launches['iris_ovr_device']} K1")

    # iris-native-device: the multiclass 10-fold CV on the device optimizer
    zero(spd.spd_inv_logdet)
    fitted = []
    native = cv_fits(torch, cdata, lambda: iris_native_gpc().setOptimizer("device"),
                     lambda model: fitted.append(model) or [model], None,
                     extra=LATENT_LOOP_KEYS)
    launches["iris_native_device"] = spd.spd_inv_logdet.launches
    rule = summed_rule(fitted)
    spread = abs(native["accuracy"] - JAX_CPU_ACCURACY["iris_native"])
    rows.append({"device": device_row("iris-native", native["seconds"], native, native["fits"]),
                 "host": host_row("iris-native", host.get("iris_native"), 10)})
    emit({"phase": "iris-native-device", **native, "launches": launches["iris_native_device"],
          "probe_launches": probes(spd.spd_inv_logdet),
          "k1_rule": rule, "bar": GPC_BARS["iris_native"],
          "jax_cpu_accuracy": JAX_CPU_ACCURACY["iris_native"], "spread": spread,
          "host_accuracy": (host.get("iris_native") or {}).get("accuracy"), "card": smi})
    if not (native["accuracy"] > GPC_BARS["iris_native"]
            and spread <= IRIS_NATIVE_SPREAD["exact"]
            and launches["iris_native_device"] == rule > 0):
        raise AssertionError(f"iris-native-device: {native}, {launches['iris_native_device']}")

    # poisson-device, nb-device: quality.py's Poisson part (E = 20,
    # s = 100) on the device optimizer
    for label, key, dispersion, y_counts in (("poisson-device", "poisson", None, d6["y"]),
                                             ("nb-device", "poisson_nb", 2.0, d6["y_nb"])):
        zero(spd.spd_inv_logdet)
        t0 = time.perf_counter()
        model = poisson_gp(dispersion).setOptimizer("device").fit(d6["x"], y_counts)
        rate = model.predict_rate(d6["x"])
        seconds = time.perf_counter() - t0
        m = model.metrics
        launches[key + "_device"] = spd.spd_inv_logdet.launches
        err = float(np.mean(np.abs(rate - d6["rate"]) / d6["rate"]))
        rows.append({"device": device_row(key, seconds, m), "host": host_row(key, host.get(key))})
        emit({"phase": label, "mean_relative_rate_error": err, "seconds": seconds,
              **{k: m[k] for k in GPC_METRICS}, "launches": launches[key + "_device"],
              "probe_launches": probe_rule(m),
              "k1_rule": latent_k1_rule(m), "loop": loop_record(m), "bar": SLICE6_BARS[key],
              "host_error": (host.get(key) or {}).get("mean_relative_rate_error"), "card": smi})
        if not (np.all(np.isfinite(rate)) and err < SLICE6_BARS[key]
                and launches[key + "_device"] == latent_k1_rule(m) > 0):
            raise AssertionError(f"{label}: error {err}, {launches[key + '_device']} K1 for "
                                 f"{latent_k1_rule(m)}")

    # multistart: iris-native's first fold with 4 restarts as one loop,
    # every Newton iteration one K1 launch over all lanes' B_c stacks
    train, test = cdata["folds_i"][0]
    zero(spd.spd_inv_logdet)
    t0 = time.perf_counter()
    model = iris_native_gpc().setOptimizer("device").setNumRestarts(MC_RESTARTS) \
        .fit(cdata["xi"][train], cdata["yi"][train])
    m = model.metrics
    launches["multistart_device"] = spd.spd_inv_logdet.launches
    ms = {"restarts": MC_RESTARTS, "seconds": time.perf_counter() - t0,
          "restart_nlls": [m[f"restart_{r}_nll"] for r in range(MC_RESTARTS)],
          "best_restart": m["best_restart"], "final_nll": m["final_nll"],
          "accuracy": float(np.mean(model.predict(cdata["xi"][test]) == cdata["yi"][test])),
          "b_c_matrices_per_launch": MC_RESTARTS * int(m["num_experts"]) * 3,
          "launches": launches["multistart_device"], "k1_rule": latent_k1_rule(m),
          "probe_launches": probe_rule(m),
          "loop": loop_record(m)}
    emit({"phase": "multistart", **ms, "card": smi})
    if not (ms["launches"] == ms["k1_rule"] > 0 and ms["b_c_matrices_per_launch"] == 84
            and ms["final_nll"] == min(ms["restart_nlls"])):
        raise AssertionError(f"multistart: {ms}")

    # checkpoint-device-gpc: iris versicolor-vs-rest on the first fold, in
    # segments of one iteration, preempted after 2 saves and resumed
    yb = (cdata["yi"][train] == 1).astype(np.float64)
    work = tempfile.mkdtemp(prefix="gp_slice11_")
    try:
        def ck_gp(directory):
            return iris_gpc().setOptimizer("device").setCheckpointDir(directory) \
                .setCheckpointInterval(GPC_CKPT_INTERVAL)

        full = ck_gp(os.path.join(work, "full")).fit(cdata["xi"][train], yb)
        zero(spd.spd_inv_logdet)
        try:
            with chaos.preempt_after_saves(GPC_CKPT_KILL_AFTER):
                ck_gp(os.path.join(work, "cut")).fit(cdata["xi"][train], yb)
            raise AssertionError("checkpoint-device-gpc: the staged preemption did not fire")
        except chaos.SimulatedPreemption as exc:
            leg1 = {"nfev": exc.nfev, **exc.loop_metrics}
        resumed = ck_gp(os.path.join(work, "cut")).fit(cdata["xi"][train], yb)
        launches["checkpoint_device_gpc"] = spd.spd_inv_logdet.launches
        leg1_rule = latent_k1_rule({f"device_opt.{k}": v for k, v in leg1.items()
                                    if isinstance(v, (int, float))})
        ck = {"interval": GPC_CKPT_INTERVAL, "kill_after_saves": GPC_CKPT_KILL_AFTER,
              "theta_bit_equal": bool(np.array_equal(resumed.raw_predictor.theta,
                                                     full.raw_predictor.theta)),
              "predictions_equal": bool(np.array_equal(resumed.predict(cdata["xi"][test]),
                                                       full.predict(cdata["xi"][test]))),
              "resumed_from_iteration": resumed.metrics.get("resumed_from_iteration"),
              "leg1": leg1, "leg2": loop_record(resumed.metrics),
              "full_iters": full.metrics["lbfgs_iters"],
              "launches": launches["checkpoint_device_gpc"],
              "k1_rule": leg1_rule + latent_k1_rule(resumed.metrics)}
        emit({"phase": "checkpoint-device-gpc", **ck, "card": smi})
        if not (ck["theta_bit_equal"] and ck["predictions_equal"]
                and ck["resumed_from_iteration"] == GPC_CKPT_INTERVAL * GPC_CKPT_KILL_AFTER
                < ck["full_iters"] and ck["launches"] == ck["k1_rule"]):
            raise AssertionError(f"checkpoint-device-gpc: {ck}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # segmented-rung-gpc: a staged OOM at the one-shot device fit's choke
    # point of the same binary fit
    clean = iris_gpc().setOptimizer("device").fit(cdata["xi"][train], yb)
    zero(spd.spd_inv_logdet)
    with chaos.oom_after_calls(0, op="one_dispatch") as fired:
        model = iris_gpc().setOptimizer("device").fit(cdata["xi"][train], yb)
    launches["segmented_rung_gpc"] = spd.spd_inv_logdet.launches
    rel = float(np.max(np.abs(model.raw_predictor.theta - clean.raw_predictor.theta)
                       / np.abs(clean.raw_predictor.theta)))
    seg = {"injected": fired[0], "degradations": model.degradations, "theta_rel_err": rel,
           "bar": SEGMENTED_THETA_REL, "launches": launches["segmented_rung_gpc"],
           "k1_rule": latent_k1_rule(model.metrics), "loop": loop_record(model.metrics)}
    emit({"phase": "segmented-rung-gpc", **seg, "card": smi})
    walk = staged_oom_walk(iris_gpc())
    if not (fired[0] == len(walk) and [(d["from"], d["to"]) for d in model.degradations]
            == walk and rel <= SEGMENTED_THETA_REL and seg["launches"] == seg["k1_rule"]):
        raise AssertionError(f"segmented-rung-gpc: {seg}")

    emit({"phase": "laplace-device-table", "rows": rows, "card": smi})
    emit({"phase": "slice11-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return launches


# --- slice 12: the device optimizer on the CG lanes and for EP --------------------

#: the SLQ quadrature kernel against its plain version in float64 on the
#: same (float32) tridiagonals: absolute error over max(1, |reference|)
SLQ_BAR = 1e-5
#: the CG lanes' device fits against the host protein-matfree fit: RMSE
#: within 2%; the matfree device step's peak under a quarter of the gram
#: stack (PERF.md §2)
CG_DEVICE_RMSE_REL = 0.02
MATFREE_PEAK_SHARE = 0.25
#: restarts of iris-ep-multistart's loops
EP_RESTARTS = 4
#: poisson-iterative-device's maxiter: the device L-BFGS-B's line search
#: on this surrogate takes ~11 evaluations an iteration on the card (25
#: iterations: 133 evaluations, 63 s; 5: 56, 29 s), so the host fit's 25
#: cost a minute of every run for the same rate error (PERF.md §6)
POISSON_DEVICE_MAXITER = 3


def k2_launch_rule(evaluations: float, iters: int, reports: int = 0) -> tuple:
    """(K2, K2-VJP) launches of ``evaluations`` matfree evaluations (every
    replay or eager step is one): ``iters`` CG products and the two
    differentiated ones each, their two VJPs; a solver report runs
    ``iters`` products more."""
    return evaluations * (iters + 2) + reports * iters, 2 * evaluations


def regression_evaluations(m: dict) -> float:
    """The evaluations a single-start regression device fit ran (its loop
    metrics): every replay and eager step, and its first evaluation."""
    return k1_rule(m) + m.get("device_opt.eager_steps", 0.0)


def latent_quad_rule(m: dict) -> float:
    """Quadrature launches of a Laplace family's device fit on a CG lane:
    one a gradient pass (every replay or eager step runs one, masked or
    not, and every eager evaluation its own) and one for the post-fit
    solver report."""
    steps = m.get("device_opt.replays", 0.0) + m.get("device_opt.eager_steps", 0.0)
    return steps + m["device_opt.eager_evaluations"] + 1.0


def slq_tridiagonals(torch, it_ops, mf_data, kernel, b_stacks: dict) -> dict:
    """The Lanczos tridiagonals the main path hands the quadrature kernel,
    from real PCG runs at init theta: the protein-matfree marginal engine
    (E = 9, 8 probes, t = 64), and the B systems' log-dets of gpc-mnist
    (16, 100), the Poisson config (20, 100) and the iris fold (7, 20).
    ``protein_matfree_t100`` is the same engine at 100 PCG steps (a
    ``GP_SOLVER_MAX_ITERS`` over 64), for the large-t check."""
    from spark_gp_tpu_torch.models.likelihood import masked_matfree_operator
    from spark_gp_tpu_torch.ops.slq_quadrature import lanczos_tridiagonal

    out = {}
    theta = torch.as_tensor(kernel.init_theta(), dtype=torch.float32, device="cuda")
    _, mv_sg, diag_sg, col_sg = masked_matfree_operator(kernel, theta, mf_data.x, mf_data.mask)
    cfg = it_ops.solver_config(mf_data.x.shape[1])
    with torch.no_grad():
        for label, iters in (("protein_matfree", cfg.iters), ("protein_matfree_t100", 100)):
            res, _, _ = it_ops._solve_pass(mv_sg, diag_sg, col_sg, mf_data.y * mf_data.mask,
                                           cfg._replace(iters=iters))
            out[label] = lanczos_tridiagonal(res.alphas[..., 1:], res.betas[..., 1:])
        for label, amat in b_stacks.items():
            cfg = it_ops.solver_config(amat.shape[-1])
            apply_p, lmat, delta, _ = it_ops._spd_preconditioner(amat, cfg)
            g1, g2 = it_ops.draw_probes(cfg._replace(seed=cfg.seed + 1), amat.shape[:-2],
                                        lmat.shape[-1], amat.shape[-1], amat.dtype, amat.device)
            z = lmat @ g1 + torch.sqrt(delta)[..., None, None] * g2
            res = it_ops.batched_pcg(lambda v: amat @ v, z, apply_p, cfg.iters, cfg.tol)
            out[label] = lanczos_tridiagonal(res.alphas, res.betas)
    return out


def slq_check_stacks(torch, tridiagonals: dict) -> dict:
    """The quadrature kernel's other routes on the card: protein-matfree
    at t = 100, 1100-row SPD tridiagonals (T over the workspace: above the
    kernel's 1024 shared-memory rows) and the protein-matfree stack shifted
    below the clamp (the QL route), each held to SLQ_BAR."""
    gen = torch.Generator(device="cpu").manual_seed(18)
    diag = 2.0 + torch.rand(4, 1100, generator=gen)
    off = 0.1 + 0.8 * torch.rand(4, 1099, generator=gen)
    pd, po = tridiagonals["protein_matfree"]
    return {"protein_matfree_t100": tridiagonals["protein_matfree_t100"],
            "workspace_t1100": (diag.to("cuda"), off.to("cuda")),
            "below_clamp": (pd - float(pd.amax()) / 2, po)}


def slq_quadrature_phase(torch, sq, tridiagonals: dict, peaks, f64_peak, smi: str) -> dict:
    """slq-quadrature: the kernel against its plain version on each of the
    main path's tridiagonal stacks (float64 eigh of the same float32
    inputs, at SLQ_BAR; the first design's and the float32 eigh route's
    errors recorded), its device ms (graph replay) and its first design's
    (``csrc/dev/slq_quadrature_first.cu``) timed in turns, beside the
    eigh route's (plain ms: the whole plain version; library ms:
    ``torch.linalg.eigh`` alone on the dense T), its bound from this run's
    QL rotations of the first design (the same work whatever design runs
    it), and both designs' work counts (``steps``: the kernel's pivot
    steps or QL rotations).  Then the large-t, workspace and QL-route
    checks of :func:`slq_check_stacks`.  Launches here are not the main
    path's: the count is restored."""
    from spark_gp_tpu_torch.ops import cuda_lib

    first_design = sq.bind(cuda_lib.load(SLQ_FIRST_DESIGN))
    package_library = sq._library

    def counts(diag, off, library):
        sq._library = library
        try:
            work = torch.zeros(diag.shape[:-1], dtype=torch.int32, device="cuda")
            out = sq._launch(diag, off, work)
        finally:
            sq._library = package_library
        return out, work

    before = sq.slq_quadrature.launches
    rows, checks = {}, {}
    main_stacks = {k: v for k, v in tridiagonals.items() if k != "protein_matfree_t100"}
    for label, (diag, off) in main_stacks.items():
        out, steps = counts(diag, off, package_library)
        first_out, rotations = counts(diag, off, lambda: first_design)
        torch.cuda.synchronize()
        ref = sq.slq_quadrature_plain(diag.double(), off.double())
        route32 = sq.slq_quadrature_plain(diag, off)
        err = float((out.double() - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        tmat = torch.diag_embed(diag) + torch.diag_embed(off, offset=1) \
            + torch.diag_embed(off, offset=-1)
        nbytes = (diag.numel() + off.numel() + out.numel()) * diag.element_size()
        ops = float(rotations.sum()) * sq.OPS_PER_ROTATION
        bound = {"bytes": nbytes / peaks[0] * 1e3, "operations": ops / f64_peak * 1e3}
        by = max(bound, key=bound.get)
        turns = time_in_turns(sq, first_design, lambda: sq.slq_quadrature(diag, off))
        rows[label] = {
            "shape": list(diag.shape), "max_abs_err": err, "rel_err": err / scale,
            "first_design_rel_err": float((first_out.double() - ref).abs().max()) / scale,
            "eigh_f32_route_abs_err": float((route32.double() - ref).abs().max()),
            **turns, "speedup": turns["first_design_ms"] / turns["ms"],
            "plain_ms": time_ms(lambda: sq.slq_quadrature_plain(diag, off), reps=3, windows=3),
            "library_ms": time_ms(lambda: torch.linalg.eigh(tmat), reps=3, windows=3),
            "bound_ms": bound[by], "bound_by": by, "rotations": float(rotations.sum()),
            "rotations_per_matrix": float(rotations.double().mean()),
            "steps": float(steps.double().sum()),
            "steps_per_matrix": float(steps.double().mean()),
        }
    for label, (diag, off) in slq_check_stacks(torch, tridiagonals).items():
        out, steps = counts(diag, off, package_library)
        ref = sq.slq_quadrature_plain(diag.double(), off.double())
        err = float((out.double() - ref).abs().max())
        checks[label] = {"shape": list(diag.shape), "rel_err": err / max(1.0, float(ref.abs().max())),
                         "ms": time_device_ms(lambda: sq.slq_quadrature(diag, off)),
                         "steps_per_matrix": float(steps.double().mean())}
    sq.slq_quadrature.launches = before
    bad = {k: r["rel_err"] for k, r in {**rows, **checks}.items() if not r["rel_err"] <= SLQ_BAR}
    emit({"phase": "slq-quadrature", "kernel": "slq_quadrature", "bar": SLQ_BAR, "rows": rows,
          "checks": checks, "first_design_source": f"spark_gp_tpu_torch/csrc/{SLQ_FIRST_DESIGN}.cu",
          "card": smi})
    if bad:
        raise AssertionError(f"slq-quadrature: {bad}")
    return rows


class LaunchCounts:
    """The wrappers' launch counters around a slice's phases (K1, K2,
    K2-VJP and the quadrature; the lane gram's too when ``lg`` is given):
    :meth:`zero` before a phase's fits, :meth:`take` after them (recorded
    under the phase's label in ``launches``)."""

    def __init__(self, spd, sm, sq, lg=None):
        wrappers = [spd.spd_inv_logdet, sm.streamed_matvec, sm.streamed_matvec_vjp,
                    sq.slq_quadrature] + ([lg.lane_gram] if lg is not None else [])
        self.wrappers = {w.__name__: w for w in wrappers}
        self.launches = {n: {} for n in self.wrappers}

    def zero(self):
        zero(*self.wrappers.values())

    def take(self, label):
        got = {n: w.launches for n, w in self.wrappers.items()}
        for n, v in got.items():
            self.launches[n][label] = v
        return got


def cg_regression_phases(torch, it_ops, counts, data_main: dict, mf_data, cdata: dict,
                         mf_rmse: float, host: dict, rows: list, smi: str) -> None:
    """device-opt-check-matfree, protein-matfree-device,
    protein-iterative-device and memplan-device (``counts`` a
    :class:`LaunchCounts`; the host-against-device rows go to ``rows``)."""
    from spark_gp_tpu_torch.kernels.base import supports_matfree
    from spark_gp_tpu_torch.models import laplace as lap
    from spark_gp_tpu_torch.models import likelihood as lk
    from spark_gp_tpu_torch.optimize import lbfgs_device as ld
    from spark_gp_tpu_torch.resilience import memplan
    from spark_gp_tpu_torch.utils.validation import rmse

    xp, yp, tr, te = (data_main[key] for key in ("xp", "yp", "tr", "te"))
    yp_tr, y_mean, y_std = (data_main[key] for key in ("yp_tr", "y_mean", "y_std"))
    gram_stack_bytes = 9 * 4065 * 4065 * 4
    iters = it_ops.solver_config(4065).iters
    gp = matfree_gp(None, max_iter=3)
    kernel = gp._get_kernel()

    # device-opt-check-matfree: protein-matfree's device fit at maxiter 3,
    # its loop replayed from the captured graph and run eagerly: theta, f,
    # n_iter, n_fev equal; K2, K2-VJP and the quadrature on their rules;
    # the graph's peak CUDA memory against the gram stack's
    dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float32,
                                    device="cuda")
    lower, upper = (dev(b) for b in kernel.bounds())
    log_space = gp._use_log_space(kernel)
    runs = {}
    with it_ops.solver_lane_scope("matfree"):
        for mode, capture in (("graph", True), ("eager", False)):
            loop = {}
            counts.zero()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = lk.fit_gpr_device(kernel, log_space, dev(kernel.init_theta()), lower, upper,
                                    mf_data, 3, gp._tol, capture=capture, loop_metrics=loop)
            theta, f, n_iter, n_fev, _ = (v.cpu().numpy() for v in out)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            m = {f"device_opt.{k}": float(v) for k, v in loop.items() if v is not None}
            runs[mode] = {"theta": theta, "f": float(f), "n_iter": int(n_iter),
                          "n_fev": int(n_fev), "seconds": seconds, "loop": loop,
                          "peak_cuda_bytes": peak, "launches": counts.take(f"check_{mode}"),
                          "evaluations": regression_evaluations(m)}
        profile = replay_profile(torch, kernel, mf_data)
    counts.zero()
    g, e = runs["graph"], runs["eager"]
    rules = {mode: dict(zip(("streamed_matvec", "streamed_matvec_vjp"),
                            k2_launch_rule(r["evaluations"], iters)),
                        slq_quadrature=r["evaluations"], spd_inv_logdet=0)
             for mode, r in runs.items()}
    check = {"shape": list(mf_data.x.shape), "max_iter": 3,
             "theta_equal": bool(np.array_equal(g["theta"], e["theta"])),
             "f_equal": g["f"] == e["f"], "n_iter": [g["n_iter"], e["n_iter"]],
             "n_fev": [g["n_fev"], e["n_fev"]], "launches": [g["launches"], e["launches"]],
             "rules": [rules["graph"], rules["eager"]],
             "seconds": {"graph": g["seconds"], "eager": e["seconds"]},
             "peak_cuda_bytes": {"graph": g["peak_cuda_bytes"], "eager": e["peak_cuda_bytes"]},
             "gram_stack_bytes": gram_stack_bytes, "loop": g["loop"], "eager_loop": e["loop"],
             **profile}
    emit({"phase": "device-opt-check-matfree", **check, "card": smi})
    if not (check["theta_equal"] and check["f_equal"] and g["n_iter"] == e["n_iter"]
            and g["n_fev"] == e["n_fev"] and g["loop"]["captures"] == 1
            and all(runs[k]["launches"] == rules[k] for k in runs)
            and g["peak_cuda_bytes"] < MATFREE_PEAK_SHARE * gram_stack_bytes):
        raise AssertionError(f"device-opt-check-matfree: {check}")

    # protein-matfree-device and its iterative twin: the protein-matfree
    # config (maxiter 10) on the device optimizer, RMSE within 2% of the
    # host protein-matfree fit's
    for lane in ("matfree", "iterative"):
        counts.zero()
        t0 = time.perf_counter()
        try:
            model = matfree_gp(lane).setOptimizer("device").fit(xp[tr], yp_tr)
            torch.cuda.synchronize()
        finally:
            it_ops.set_solver_lane(None)
        seconds = time.perf_counter() - t0
        got = counts.take(f"protein_{lane}_device")
        m = model.metrics
        pred = model.predict(xp[te]) * y_std + y_mean
        err = rmse(yp[te], pred)
        evals = regression_evaluations(m)
        k2, vjp = k2_launch_rule(evals, iters, 1) if lane == "matfree" else (0, 0)
        rule = with_probes({"spd_inv_logdet": 0, "streamed_matvec": k2,
                            "streamed_matvec_vjp": vjp, "slq_quadrature": evals + 1}, m)
        row = {"rmse": err, "host_matfree_rmse": mf_rmse, "rmse_rel": err / mf_rmse - 1.0,
               "bar_rmse_rel": CG_DEVICE_RMSE_REL, "seconds": seconds,
               "solver_lane": m["solver_lane"], "nfev": m["lbfgs_nfev"],
               "optimize_seconds": m["optimize_seconds"], "launches": got, "rule": rule,
               "loop": loop_record(m), "theta": model.raw_predictor.theta.tolist(),
               **{k: v for k, v in m.items() if k.startswith("solver.")}}
        emit({"phase": f"protein-{lane}-device", **row, "card": smi})
        h = host.get(f"protein_{lane}")
        rows.append({"device": regression_row(f"protein-{lane}", seconds, m),
                     "host": None if not h else {
                         "config": f"protein-{lane}", "seconds": h["fit_seconds"],
                         "optimize_seconds": h["optimize_seconds"], "evaluations": h["nfev"],
                         "wall_ms_per_evaluation": h["optimize_seconds"] / h["nfev"] * 1e3}})
        if not (np.all(np.isfinite(pred)) and abs(row["rmse_rel"]) <= CG_DEVICE_RMSE_REL
                and m["solver_lane"] == lane and got == rule):
            raise AssertionError(f"protein-{lane}-device: {row}")

    # memplan-device: one device step's measured peak on each CG lane
    # against the planner's byte model, protein-matfree's stack and
    # gpc-mnist's (a Laplace family's step; the binary classifier's B
    # systems on the iterative lane)
    brackets = {}
    xm_tr, ym_tr = cdata["xm"][cdata["tr_m"]], cdata["ym"][cdata["tr_m"]]
    cases = [("protein_matfree", lane, "GaussianProcessRegression", 0) for lane in
             ("iterative", "matfree")] + [("gpc_mnist", "iterative",
                                           "GaussianProcessClassifier", 1)]
    for label, lane, family, heads in cases:
        with it_ops.solver_lane_scope(lane):
            if heads:
                cgp = mnist_gpc()
                ckernel = cgp._get_kernel()
                data = cgp._group(xm_tr, ym_tr, torch.device("cuda"))
                vag = lap.BinaryLaplaceLanes(ckernel, data, cgp._tol)
                aux0, bounds, theta0 = vag.aux0(1), ckernel.bounds(), ckernel.init_theta()
            else:
                data, aux0 = mf_data, None
                vag = lk.make_device_value_and_grad(kernel, data)
                bounds, theta0 = kernel.bounds(), kernel.init_theta()
            cfg = ld.LbfgsConfig(lower=dev(bounds[0]), upper=dev(bounds[1]))
            state = ld.lbfgs_init_state(vag, dev(theta0)[None], cfg, aux0)
            limit = torch.full((), 10 ** 6, dtype=torch.int32, device="cuda")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ld.lbfgs_step(vag, state, cfg, limit)
            torch.cuda.synchronize()
            stack = sum(t.numel() * t.element_size() for t in (data.x, data.y, data.mask))
            measured = torch.cuda.max_memory_allocated() - base + stack
            del state, vag
            torch.cuda.empty_cache()
        e_, s_, p_ = (int(d) for d in data.x.shape)
        rung = memplan.fit_rung_of_lane(lane, supports_matfree(kernel))
        predicted = memplan.predicted_bytes(
            memplan.fit_dispatch_bytes(e_, s_, p_, 4, rung, 1, family, heads))
        brackets[f"{label}/{lane}"] = {"shape": [e_, s_, p_], "rung": rung, "family": family,
                                       "measured_bytes": measured, "predicted_bytes": predicted,
                                       "ratio": predicted / measured}
    counts.zero()
    low, high = MEMPLAN_BRACKET
    emit({"phase": "memplan-device", "brackets": brackets, "bracket": MEMPLAN_BRACKET,
          "card": smi})
    if not all(low <= b["ratio"] <= high for b in brackets.values()):
        raise AssertionError(f"memplan-device: {brackets}")



def cg_latent_phases(torch, it_ops, counts, cdata: dict, d6: dict, host: dict, rows: list,
                     smi: str) -> None:
    """gpc-mnist-iterative-device, iris-native-iterative-device and
    poisson-iterative-device."""
    # gpc-mnist-iterative-device: phase 15 on the device optimizer
    counts.zero()
    try:
        fit = split_fit(mnist_gpc().setSolverLane("iterative").setOptimizer("device"),
                        cdata["xm"], cdata["ym"])
    finally:
        it_ops.set_solver_lane(None)
    model = fit.pop("model")
    m = model.metrics
    got = counts.take("gpc_mnist_iterative_device")
    rule = with_probes({"spd_inv_logdet": 0, "streamed_matvec": 0, "streamed_matvec_vjp": 0,
                        "slq_quadrature": latent_quad_rule(m)}, m)
    rows.append({"device": device_row("gpc-mnist-iterative", fit["seconds"],
                                      {**m, "optimize_seconds": m["optimize_seconds"]}),
                 "host": host_row("gpc-mnist-iterative", host.get("gpc_mnist_iterative"))})
    emit({"phase": "gpc-mnist-iterative-device", **fit, "solver_lane": m["solver_lane"],
          "launches": got, "rule": rule, "loop": loop_record(m), "bar": GPC_BARS["gpc_mnist"],
          "host_accuracy": (host.get("gpc_mnist_iterative") or {}).get("accuracy"),
          "card": smi})
    if not (fit["accuracy"] > GPC_BARS["gpc_mnist"] and m["solver_lane"] == "iterative"
            and got == rule):
        raise AssertionError(f"gpc-mnist-iterative-device: {fit}, {got}, {rule}")

    # iris-native-iterative-device: phase 19 on the device optimizer
    counts.zero()
    fitted = []
    try:
        it_ops.set_solver_lane("iterative")
        native = cv_fits(torch, cdata, lambda: iris_native_gpc().setOptimizer("device"),
                         lambda model: fitted.append(model) or [model], None,
                         extra=LATENT_LOOP_KEYS)
    finally:
        it_ops.set_solver_lane(None)
    got = counts.take("iris_native_iterative_device")
    rule = with_probes({"spd_inv_logdet": 0, "streamed_matvec": 0, "streamed_matvec_vjp": 0,
                        "slq_quadrature": sum(latent_quad_rule(f.metrics) for f in fitted)},
                       *(f.metrics for f in fitted))
    spread = abs(native["accuracy"] - JAX_CPU_ACCURACY["iris_native_iterative"])
    rows.append({"device": device_row("iris-native-iterative", native["seconds"], native,
                                      native["fits"]),
                 "host": host_row("iris-native-iterative", host.get("iris_native_iterative"),
                                  10)})
    emit({"phase": "iris-native-iterative-device", **native, "launches": got, "rule": rule,
          "bar": GPC_BARS["iris_native"], "spread": spread,
          "jax_cpu_accuracy": JAX_CPU_ACCURACY["iris_native_iterative"],
          "lanes": sorted({f.metrics["solver_lane"] for f in fitted}), "card": smi})
    if not (native["accuracy"] > GPC_BARS["iris_native"]
            and spread <= IRIS_NATIVE_SPREAD["iterative"] and got == rule
            and all(f.metrics["solver_lane"] == "iterative" for f in fitted)):
        raise AssertionError(f"iris-native-iterative-device: {native}, {got}, {rule}")

    # poisson-iterative-device: phase 34 on the device optimizer at
    # POISSON_DEVICE_MAXITER (the host fit's 25 took 133 evaluations, 63 s,
    # on this surrogate: PERF.md §6)
    counts.zero()
    t0 = time.perf_counter()
    try:
        model = poisson_gp().setMaxIter(POISSON_DEVICE_MAXITER).setSolverLane("iterative") \
            .setOptimizer("device").fit(d6["x"], d6["y"])
    finally:
        it_ops.set_solver_lane(None)
    rate = model.predict_rate(d6["x"])
    seconds = time.perf_counter() - t0
    m = model.metrics
    got = counts.take("poisson_iterative_device")
    rule = with_probes({"spd_inv_logdet": 0, "streamed_matvec": 0, "streamed_matvec_vjp": 0,
                        "slq_quadrature": latent_quad_rule(m)}, m)
    err = float(np.mean(np.abs(rate - d6["rate"]) / d6["rate"]))
    rows.append({"device": {**device_row("poisson-iterative", seconds, m),
                            "max_iter": POISSON_DEVICE_MAXITER},
                 "host": host_row("poisson-iterative", host.get("poisson_iterative"))})
    emit({"phase": "poisson-iterative-device", "mean_relative_rate_error": err,
          "seconds": seconds, **{k: m[k] for k in GPC_METRICS}, "solver_lane": m["solver_lane"],
          "launches": got, "rule": rule, "loop": loop_record(m),
          "max_iter": POISSON_DEVICE_MAXITER, "bar": SLICE6_BARS["poisson_iterative"],
          "host_error": (host.get("poisson_iterative") or {}).get("mean_relative_rate_error"),
          "card": smi})
    if not (np.all(np.isfinite(rate)) and err < SLICE6_BARS["poisson_iterative"]
            and m["solver_lane"] == "iterative" and got == rule):
        raise AssertionError(f"poisson-iterative-device: error {err}, {got}, {rule}")



def ep_device_phases(torch, counts, cdata: dict, host: dict, rows: list, smi: str) -> None:
    """ep-device-check, iris-ep-device and iris-ep-multistart."""
    from spark_gp_tpu_torch.models import ep
    from spark_gp_tpu_torch.utils.validation import OneVsRest

    dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float32,
                                    device="cuda")
    # ep-device-check: the first iris fold's first one-vs-rest EP problem
    # (7, 20) fitted by ep.fit_gpc_ep_device, its loop replayed from the
    # captured graph and run eagerly: theta, sites, latent mean, f, n_iter,
    # n_fev and the sweeps equal; K1 on the step's rule plus the posterior
    # mean
    train, _ = cdata["folds_i"][0]
    egp = ep_gpc()
    ekernel = egp._get_kernel()
    yb = (cdata["yi"][train] == 0).astype(np.float64)
    data = egp._group(cdata["xi"][train], yb, torch.device("cuda"))
    elower, eupper = (dev(b) for b in ekernel.bounds())
    runs = {}
    for mode, capture in (("graph", True), ("eager", False)):
        loop = {}
        counts.zero()
        t0 = time.perf_counter()
        out = ep.fit_gpc_ep_device(ekernel, egp._tol, egp._use_log_space(ekernel),
                                   dev(ekernel.init_theta()), elower, eupper, data,
                                   egp._max_iter, capture=capture, loop_metrics=loop)
        theta, (tau, nu), mu, f, n_iter, n_fev, _ = out
        m = {f"device_opt.{k}": float(v) for k, v in loop.items() if v is not None}
        runs[mode] = {"theta": theta.cpu().numpy(), "tau": tau.cpu().numpy(),
                      "nu": nu.cpu().numpy(), "mu": mu.cpu().numpy(), "f": float(f),
                      "n_iter": int(n_iter), "n_fev": int(n_fev),
                      "sweeps": loop["newton_iterations"], "loop": loop,
                      "seconds": time.perf_counter() - t0, "launches": counts.take(f"ep_check_{mode}"),
                      "k1_rule": latent_k1_rule(m) + 1}
    counts.zero()
    g, e = runs["graph"], runs["eager"]
    check = {"shape": list(data.x.shape[:2]),
             **{f"{k}_equal": bool(np.array_equal(g[k], e[k]))
                for k in ("theta", "tau", "nu", "mu")},
             "f_equal": g["f"] == e["f"], "n_iter": [g["n_iter"], e["n_iter"]],
             "n_fev": [g["n_fev"], e["n_fev"]], "sweeps": [g["sweeps"], e["sweeps"]],
             "launches": [g["launches"], e["launches"]], "k1_rule": [g["k1_rule"], e["k1_rule"]],
             "seconds": {"graph": g["seconds"], "eager": e["seconds"]}, "loop": g["loop"],
             "eager_loop": e["loop"]}
    emit({"phase": "ep-device-check", **check, "card": smi})
    if not (all(check[f"{k}_equal"] for k in ("theta", "tau", "nu", "mu")) and check["f_equal"]
            and g["n_iter"] == e["n_iter"] and g["n_fev"] == e["n_fev"]
            and g["sweeps"] == e["sweeps"] and g["loop"]["captures"] == 1
            and all(r["launches"]["spd_inv_logdet"] == r["k1_rule"] for r in (g, e))):
        raise AssertionError(f"ep-device-check: {check}")

    # iris-ep-device and iris-ep-multistart: phase 31's 10-fold one-vs-rest
    # CV on the device optimizer, single start and 4 restarts in one loop
    for label, restarts in (("iris_ep_device", 1), ("iris_ep_multistart", EP_RESTARTS)):
        counts.zero()
        fitted = []
        iris = cv_fits(torch, cdata,
                       lambda: OneVsRest(lambda: ep_gpc().setOptimizer("device")
                                         .setNumRestarts(restarts)),
                       lambda ovr: fitted.extend(ovr.models_) or ovr.models_, None,
                       engine="ep_sweeps", extra=LATENT_LOOP_KEYS)
        got = counts.take(label)
        rule = sum(latent_k1_rule(f.metrics) + 1 for f in fitted)
        if restarts == 1:
            rows.append({"device": device_row("iris-ep", iris["seconds"],
                                              {**iris, "newton_iterations": iris["ep_sweeps"]},
                                              iris["fits"]),
                         "host": host_row("iris-ep", {**host["iris_ep"], "newton_iterations":
                                                      host["iris_ep"]["ep_sweeps"]}, 30)
                         if host.get("iris_ep") else None})
        emit({"phase": label.replace("_", "-"), **iris, "restarts": restarts, "launches": got,
              "k1_rule": rule, "bar": SLICE6_BARS["iris_ep"],
              "host_accuracy": (host.get("iris_ep") or {}).get("accuracy"), "card": smi})
        if not (iris["accuracy"] > SLICE6_BARS["iris_ep"] and iris["fits"] == 30
                and got["spd_inv_logdet"] == rule > 0
                and all(f.metrics.get("num_restarts", 1) == restarts for f in fitted)):
            raise AssertionError(f"{label}: {iris}, {got}, {rule}")



def ladder_oom_device_phase(torch, it_ops, counts, data_main: dict, mf_rmse: float,
                            smi: str) -> None:
    """ladder-oom-device."""
    from spark_gp_tpu_torch.utils.validation import rmse

    xp, yp, tr, te = (data_main[key] for key in ("xp", "yp", "tr", "te"))
    yp_tr, y_mean, y_std = (data_main[key] for key in ("yp_tr", "y_mean", "y_std"))
    iters = it_ops.solver_config(4065).iters
    # ladder-oom-device: ladder-oom's config as a device fit under the same
    # memory fraction: real allocator OOMs at native and iterative, the
    # device fit completes on matfree
    total_memory = torch.cuda.get_device_properties(0).total_memory
    counts.zero()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    budget = torch.cuda.memory_reserved() + LADDER_HEADROOM
    torch.cuda.set_per_process_memory_fraction(budget / total_memory)
    try:
        model = matfree_gp(None, max_iter=5).setOptimizer("device").fit(xp[tr], yp_tr)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    m = model.metrics
    got = counts.take("ladder_oom_device")
    pred = model.predict(xp[te]) * y_std + y_mean
    evals = regression_evaluations(m)
    k2, vjp = k2_launch_rule(evals, iters, 1)
    rule = with_probes({"spd_inv_logdet": 0, "streamed_matvec": k2, "streamed_matvec_vjp": vjp,
                        "slq_quadrature": evals + 1}, m)
    rungs = [(d["from"], d["to"], d["failure_class"]) for d in model.degradations]
    ladder = {"budget_bytes": budget, "fraction": budget / total_memory,
              "degradations": model.degradations, "solver_lane": m["solver_lane"],
              "optimizer": m.get("optimizer"), "nfev": m["lbfgs_nfev"], "rmse": rmse(yp[te], pred),
              "protein_matfree_rmse": mf_rmse, "rmse_rel": rmse(yp[te], pred) / mf_rmse - 1.0,
              "bar_rmse_rel": LADDER_RMSE_REL, "launches": got, "rule": rule,
              "loop": loop_record(m), "seconds": seconds}
    emit({"phase": "ladder-oom-device", **ladder, "card": smi})
    if not (rungs == [("native", "iterative", "oom"), ("iterative", "matfree", "oom")]
            and m["solver_lane"] == "matfree" and m.get("optimizer") == "device"
            and np.all(np.isfinite(pred)) and got == rule
            and abs(ladder["rmse_rel"]) <= LADDER_RMSE_REL):
        raise AssertionError(f"ladder-oom-device: {ladder}")



def slice12_phases(torch, spd, sm, sq, it_ops, cdata: dict, d6: dict, data_main: dict,
                   mf_data, mf_rmse: float, b_stacks: dict, host: dict, smi: str) -> dict:
    """This slice's phases (slq-quadrature, device-opt-check-matfree,
    protein-matfree-device, protein-iterative-device, memplan-device,
    gpc-mnist-iterative-device, iris-native-iterative-device,
    poisson-iterative-device, ep-device-check, iris-ep-device,
    iris-ep-multistart, ladder-oom-device, cg-device-table); ``host``
    carries the host optimizer's phases to set beside them.  Returns each
    kernel's launches on each phase's fits, and the quadrature kernel's
    checks."""
    start_all = time.perf_counter()
    counts = LaunchCounts(spd, sm, sq)
    rows: list = []
    name = torch.cuda.get_device_name(0)
    quad = slq_quadrature_phase(
        torch, sq, slq_tridiagonals(torch, it_ops, mf_data, matfree_gp(None)._get_kernel(),
                                    b_stacks),
        peaks_for(name), card_peaks(name).f64, smi)
    cg_regression_phases(torch, it_ops, counts, data_main, mf_data, cdata, mf_rmse, host, rows,
                         smi)
    cg_latent_phases(torch, it_ops, counts, cdata, d6, host, rows, smi)
    ep_device_phases(torch, counts, cdata, host, rows, smi)
    ladder_oom_device_phase(torch, it_ops, counts, data_main, mf_rmse, smi)
    emit({"phase": "cg-device-table", "rows": rows, "card": smi})
    emit({"phase": "slice12-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return {"launches": counts.launches, "slq_quadrature": quad}


# --- slice 14: the device magic solve (item 11), the precision lanes (item 14)

#: the large-m config (benchmarks/large_m.py): rows, active points, RMSE bar
LARGE_M_N = 120_000
LARGE_M = 4096
LARGE_M_RMSE_BAR = 0.15
#: the active-set sizes of the crossover timing's seeded statistics
CROSSOVER_M = (1000, 2048)
#: device against host magic solve on the large-m fit's (U1, u2), float64.
#: PD = sn2 K_mm + U1 has a condition number ~2e13 here (recorded), so two
#: backward-stable factorizations (cuSOLVER's, LAPACK's) give magic vectors
#: that differ entrywise far above 1e-8 (debug runs: 4.2e-4, the matrices
#: 3.3e-3; recorded).  Held: each solve's normwise residual
#: |PD mv - u2| / (|PD| |mv|) (backward stability); the magic vectors'
#: normwise difference within 10 x cond(PD) x the two residuals (the
#: forward error two such solves may show); and what a user reads on the
#: first 2,000 rows: the predictive mean (over max |mean|; debug run
#: 9.6e-7) and variance (over the prior variance; 8.1e-10)
MAGIC_SOLVE_BARS = {"residual_device": 1e-11, "residual_host": 1e-11, "mean": 1e-5,
                    "variance": 1e-8}

#: lane_gram against its plain version: over max|x1|^2 + max|x2|^2 (the
#: terms that cancel), or max|x1| max|x2| for inner products
LANE_GRAM_BAR = 1e-5
#: the mixed lane's hard bars (the strict lane's own, examples/*.py)
MIXED_BARS = {"airfoil": 2.1, "synthetics": 0.11}
GUARD_KEYS = ("delta_nll_rel", "delta_grad_rel", "delta_predict_rel", "breach")


def large_m_data():
    """benchmarks/large_m.py's surface, copied: 120,000 x 3 uniform rows
    (rng 42), y = sin(2 pi x . [1, 0.7, 0.4]) + 0.05 noise."""
    rng = np.random.default_rng(42)
    x = rng.uniform(size=(LARGE_M_N, 3))
    y = np.sin(2.0 * np.pi * x @ np.array([1.0, 0.7, 0.4])) + 0.05 * rng.normal(size=LARGE_M_N)
    return x, y


def large_m_gp(variance: bool = True):
    """benchmarks/large_m.py's estimator, copied: RBF(0.3, 1e-6, 10),
    expert 100 (E = 1200), active 4096, seed 13, sigma2 1e-3, maxiter 10."""
    from spark_gp_tpu_torch import GaussianProcessRegression, RBFKernel

    return (GaussianProcessRegression().setKernel(lambda: RBFKernel(0.3, 1e-6, 10))
            .setDatasetSizeForExpert(100).setActiveSetSize(LARGE_M).setSeed(13)
            .setSigma2(1e-3).setMaxIter(10).setPredictiveVariance(variance))


#: the large-m fit's theta and active set, for mesh-gloo2's sharded solve
LARGE_M_FIT: dict = {}


class SolveRecord:
    """Around fits: counts the device magic solves, records whether each
    was handed its statistics on the card (no round trip through the
    host), and the name and jitter of every device factorization
    (``ppa._device_factor``)."""

    def __init__(self, ppa):
        self.ppa, self.solves, self.factors, self.stats_on_card = ppa, 0, [], []

    def __enter__(self):
        ppa = self.ppa
        self._solve, self._factor = ppa.magic_solve_device, ppa._device_factor

        def solve(*args, **kw):
            self.solves += 1
            self.stats_on_card.append(bool(getattr(args[3], "is_cuda", False)))
            return self._solve(*args, **kw)

        def factor(mat, tau, name):
            self.factors.append([name, tau])
            return self._factor(mat, tau, name)

        ppa.magic_solve_device, ppa._device_factor = solve, factor
        return self

    def __exit__(self, *exc):
        self.ppa.magic_solve_device, self.ppa._device_factor = self._solve, self._factor


def seeded_stats(torch, ppa, kernel, theta, x, m: int, rows: int = 20_000):
    """``(active, U1, u2)`` over the first ``rows`` of ``x`` against ``m``
    of them drawn at seed m, on the card in float64."""
    from spark_gp_tpu_torch.parallel.experts import ExpertData

    active = x[np.random.default_rng(m).choice(rows, size=m, replace=False)]
    dev = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    xs = dev(x[:rows])[None]
    data = ExpertData(x=xs, y=dev(np.sin(x[:rows].sum(1)))[None], mask=torch.ones_like(xs[..., 0]))
    u1, u2 = ppa.kmn_stats(kernel, dev(theta), dev(active), data)
    return active, u1.cpu().numpy(), u2.cpu().numpy()


def solve_seconds(torch, fn) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - start


def magic_crossover(torch, ppa, kernel, theta, x, fits: dict) -> dict:
    """Wall seconds of the device solve (transfers in and out included)
    and the host solve, in turns device, host, host, device, at m = 1000
    and 2048 on seeded statistics and at 4096 on the large-m fit's own."""
    out = {}
    for m in CROSSOVER_M + (LARGE_M,):
        if m == LARGE_M:
            active, u1, u2 = fits["active"], fits["u1"], fits["u2"]
            th = fits["theta"]
        else:
            active, u1, u2 = seeded_stats(torch, ppa, kernel, theta, x, m)
            th = theta
        runs = {"device": [], "host": []}
        for side in ("device", "host", "host", "device"):
            fn = (lambda: ppa.magic_solve_device(kernel, th, active, u1, u2, device="cuda")) \
                if side == "device" else (lambda: ppa._host_magic_solve(kernel, th, active, u1, u2))
            runs[side].append(solve_seconds(torch, fn))
        out[str(m)] = {"device_seconds": runs["device"], "host_seconds": runs["host"],
                       "device_mean": float(np.mean(runs["device"])),
                       "host_mean": float(np.mean(runs["host"])),
                       "host_over_device": float(np.mean(runs["host"]) / np.mean(runs["device"]))}
    return out


def large_m_phases(torch, spd, smi: str) -> dict:
    """large-m, large-m-crossover and large-m-oom (module doc).  Returns
    K1's launches on the two fits."""
    from spark_gp_tpu_torch.models import ppa
    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.resilience import chaos
    from spark_gp_tpu_torch.utils.validation import rmse

    x, y = large_m_data()
    x_eval, y_eval = x[:20_000], y[:20_000]
    zero(spd.spd_inv_logdet)
    with SolveRecord(ppa) as rec:
        torch.cuda.reset_peak_memory_stats()
        model, fit_s = airfoil_fold_fit(large_m_gp(), x, y, np.arange(LARGE_M_N))
        peak = torch.cuda.max_memory_allocated()
    k1_full = spd.spd_inv_logdet.launches
    probe_full = probes(spd.spd_inv_logdet)
    m = model.metrics
    torch.cuda.synchronize()
    start = time.perf_counter()
    mean, var = model.predict_with_var(x_eval)
    predict_s = time.perf_counter() - start
    score = rmse(y_eval, mean)
    raw = model.raw_predictor
    if not (np.all(np.isfinite(mean)) and np.all(np.isfinite(var)) and mean.shape == (20_000,)):
        raise AssertionError("large-m predictions not finite")
    # the same config mean-only: its mean is the full model's, and K_mm is
    # never factored
    zero(spd.spd_inv_logdet)
    with SolveRecord(ppa) as rec_mean:
        model_mean, fit_mean_s = airfoil_fold_fit(large_m_gp(False), x, y, np.arange(LARGE_M_N))
    k1_mean = spd.spd_inv_logdet.launches
    probe_mean = probes(spd.spd_inv_logdet)
    mean_only = model_mean.predict(x_eval)
    LARGE_M_FIT.update(theta=raw.theta.tolist(), active=raw.active.tolist())
    # device against host on the fit's own statistics
    kernel = raw.kernel
    dev_mv, dev_mm = ppa.magic_solve_device(kernel, raw.theta, raw.active, raw.u1, raw.u2,
                                            device="cuda")
    host_mv, host_mm = ppa._host_magic_solve(kernel, raw.theta, raw.active, raw.u1, raw.u2)
    # the predictive mean and variance each solve gives, in float64 on the
    # card; each solve's residual; the two matrices' condition numbers
    dev64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device="cuda")
    theta64, xq, act64 = dev64(raw.theta), dev64(x_eval[:2000]), dev64(raw.active)
    cross = kernel.cross(theta64, xq, act64)
    prior = kernel.self_diag(theta64, xq)
    kmm = kernel.gram(theta64, act64)
    pd = kernel.white_noise_var(theta64) * kmm + dev64(raw.u1)

    def residual(mv):
        mv = dev64(mv)
        r = torch.linalg.vector_norm(pd @ mv - dev64(raw.u2))
        return float(r / (torch.linalg.matrix_norm(pd, 2) * torch.linalg.vector_norm(mv)))

    def cond(a):
        ev = torch.linalg.eigvalsh(a)
        return float(ev[-1] / ev[0])

    def agreement(a, b, names):
        """Solve ``a`` against solve ``b`` (each ``(magicVector,
        magicMatrix)``): the MAGIC_SOLVE_BARS quantities under ``names``
        (the residual keys) and the entrywise gaps, recorded without a bar."""
        means = [(cross @ dev64(mv)).cpu().numpy() for mv in (a[0], b[0])]
        variances = [(prior + torch.einsum("tm,mk,tk->t", cross, dev64(mm), cross)).cpu().numpy()
                     for mm in (a[1], b[1])]
        return {names[0]: residual(a[0]), names[1]: residual(b[0]),
                "magic_vector_norm_rel": float(np.linalg.norm(a[0] - b[0])
                                               / np.linalg.norm(b[0])),
                "mean": float(np.abs(means[0] - means[1]).max() / np.abs(means[1]).max()),
                "variance": float(np.abs(variances[0] - variances[1]).max()
                                  / float(prior.max())),
                "magic_vector_no_bar": float(np.abs(a[0] - b[0]).max() / np.abs(b[0]).max()),
                "magic_matrix_no_bar": float(np.abs(a[1] - b[1]).max() / np.abs(b[1]).max()),
                "bit_equal": bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))}

    def agrees(errs, names):
        bars = MAGIC_SOLVE_BARS
        return (errs[names[0]] <= bars["residual_device"]
                and errs[names[1]] <= bars["residual_host"]
                and errs["mean"] <= bars["mean"] and errs["variance"] <= bars["variance"]
                and errs["magic_vector_norm_rel"] <= 10.0 * cond_pd * (errs[names[0]]
                                                                      + errs[names[1]]))

    cond_pd = cond(pd)
    errs = agreement((dev_mv, dev_mm), (host_mv, host_mm), ("residual_device", "residual_host"))
    errs.update(cond_pd=cond_pd, cond_kmm=cond(kmm))
    errs["magic_vector_bound"] = 10.0 * cond_pd * (errs["residual_device"]
                                                 + errs["residual_host"])
    row = {"phase": "large-m", "n": LARGE_M_N, "m": LARGE_M,
           "num_experts": m["num_experts"], "expert_size": m["expert_size"],
           "rmse": score, "rmse_bar": LARGE_M_RMSE_BAR, "fit_seconds": fit_s,
           "kmn_stats_seconds": model.instr.timings.get("kmn_stats"),
           "magic_solve_seconds": model.instr.timings.get("magic_solve"),
           "phase_seconds": dict(model.instr.timings),
           "predict_rows_per_second": 20_000 / predict_s, "predict_seconds": predict_s,
           "nfev": m["lbfgs_nfev"], "k1_launches": k1_full, "probe_launches": probe_full,
           "device_solves": rec.solves,
           "stats_on_card": rec.stats_on_card, "factors": rec.factors, "peak_cuda_bytes": peak,
           "mean_only": {"fit_seconds": fit_mean_s, "device_solves": rec_mean.solves,
                         "factors": rec_mean.factors, "k1_launches": k1_mean,
                         "probe_launches": probe_mean,
                         "nfev": model_mean.metrics["lbfgs_nfev"],
                         "mean_max_abs_diff": float(np.abs(mean_only - mean).max())},
           "device_vs_host": errs, "bars": MAGIC_SOLVE_BARS,
           "degradations": getattr(model, "degradations", None), "card": smi}
    emit(row)
    if not (score < LARGE_M_RMSE_BAR and rec.solves == 1
            and k1_full == m["lbfgs_nfev"] + probe_full and m["lbfgs_nfev"] > 0 and probe_full == 1
            and rec.stats_on_card == [True] and not getattr(model, "degradations", None)):
        raise AssertionError(f"large-m: rmse {score}, {rec.solves} device solves, {k1_full} K1 "
                             f"launches for {m['lbfgs_nfev']} evaluations")
    if not (rec_mean.solves == 1 and all(f[0] == "PD" for f in rec_mean.factors)
            and np.array_equal(mean_only, mean)
            and k1_mean == model_mean.metrics["lbfgs_nfev"] + probe_mean):
        raise AssertionError(f"large-m mean-only: {row['mean_only']}")
    if not agrees(errs, ("residual_device", "residual_host")):
        raise AssertionError(f"large-m device vs host magic solve: {errs}")

    # large-m-crossover: the device solve against the host solve
    fits = {"active": raw.active, "u1": raw.u1, "u2": raw.u2, "theta": raw.theta}
    emit({"phase": "large-m-crossover", "threshold_m": ppa._DEVICE_SOLVE_MIN_M,
          "seconds": magic_crossover(torch, ppa, kernel, kernel.init_theta(), x, fits),
          "card": smi})

    # large-m-oom: an OOM staged at the device solve's choke point takes the
    # ppa ladder's one transition and gives the host solve's answer, held
    # as device against host is: the host BLAS need not repeat its own
    # rounding bit for bit (one run of this phase read the two host solves
    # unequal), and at cond(PD) ~2e13 a rounding moves the magic vector
    # ~4e-4; a second direct host solve records how far it does
    counters = lambda: telemetry.snapshot()["per_entry"].get("fallback.rung.host_solve", {})
    before = counters().get("ppa", 0.0)
    with chaos.oom_after_calls(0, op="ppa.magic_solve"):
        oom = ppa.magic_solve(kernel, raw.theta, raw.active, raw.u1, raw.u2, device="cuda")
    moved = counters().get("ppa", 0.0) - before
    names = ("residual_oom", "residual_host")
    oom_errs = agreement(oom, (host_mv, host_mm), names)
    repeat = agreement(ppa._host_magic_solve(kernel, raw.theta, raw.active, raw.u1, raw.u2),
                       (host_mv, host_mm), ("residual_repeat", "residual_host"))
    emit({"phase": "large-m-oom", "ppa_host_solve_transitions": moved,
          "against_host_solve": oom_errs, "host_solve_repeat_no_bar": repeat,
          "bars": MAGIC_SOLVE_BARS, "card": smi})
    if not (moved == 1 and agrees(oom_errs, names)):
        raise AssertionError(f"large-m-oom: {moved} ppa transitions, {oom_errs}")
    return {"large_m": k1_full, "large_m_mean_only": k1_mean}


def lane_gram_inputs(torch, data_main: dict, rdata: dict) -> dict:
    """The operands the lanes hand the kernel: the first airfoil fold's
    stack (14, 97, 5) ARD-scaled by the kernel's initial weights, as a
    self-gram and as distances; the protein stack (366, 100, 9); the first
    Synthetics fold's (18, 100, 1); and the periodic feature map of the
    airfoil fold as inner products."""
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    def stack(x, y, expert):
        return group_for_experts(x, y, expert, dtype=torch.float32, device="cuda").x

    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    air = stack(x[folds[0][0]], y[folds[0][0]], 100)
    w = torch.as_tensor(1.0 / airfoil_kernel().init_theta()[1:6], dtype=torch.float32,
                        device="cuda")
    prot = stack(data_main["xp"][data_main["tr"]], data_main["yp_tr"], 100)
    syn_tr = rdata["folds"][0][0]
    syn = stack(rdata["x"][syn_tr], rdata["y"][syn_tr], 100)
    phi = torch.cat([torch.cos(2.0 * np.pi * air), torch.sin(2.0 * np.pi * air)], dim=-1)
    return {"airfoil_ard_self": (air * w, True, False), "airfoil_ard": (air * w, False, False),
            "protein": (prot, False, False), "synthetics": (syn, True, False),
            "periodic_inner": (phi, False, True)}


def check_lane_gram(torch, lg, inputs: dict) -> dict:
    """The kernel against its plain version on the card, both modes, every
    input: the error over the bar's scale; self-gram diagonals exactly 0.
    Launches here are not the main path's: the caller restores the count."""
    errs = {}
    for label, (x, self_gram, inner) in inputs.items():
        sq = x.double().pow(2).sum(-1).max().item()
        scale = sq if inner else 2.0 * sq
        for mode in lg.MODES:
            got = lg.lane_gram(x, x, mode, self_gram=self_gram, inner=inner)
            ref = lg.lane_gram_plain(x, x, mode, self_gram, inner)
            torch.cuda.synchronize()
            err = float((got.double() - ref.double()).abs().max()) / scale
            diag_zero = (not self_gram) or bool(
                (torch.diagonal(got, dim1=-2, dim2=-1) == 0).all())
            errs[f"{label}/{mode}"] = err
            if not (err <= LANE_GRAM_BAR and diag_zero and torch.isfinite(got).all()):
                raise AssertionError(f"lane_gram {label} {mode}: error {err} over "
                                     f"{LANE_GRAM_BAR}, zero diagonal {diag_zero}")
    return errs


def time_lane_gram(torch, lg, inputs: dict, peaks, tf32_peak: float) -> dict:
    """Device ms of the kernel (both modes), its plain version and the
    library's one call for the same distances (``sq_dist`` by
    ``torch.matmul`` with TF32 on, inside ``tf32_library_matmuls``), and
    the bound: the operand read once (every timed call is ``x`` against
    itself) and the output written once at the card's memory rate, against
    2 n1 n2 p flop a TF32 pass at the tensor cores' peak."""
    from spark_gp_tpu_torch.ops.precision import tf32_library_matmuls

    def library(x):
        n = torch.sum(x * x, dim=-1)
        d = n[..., :, None] + n[..., None, :] - 2.0 * torch.matmul(x, x.mT)
        return torch.clamp_min(d, 0.0)

    rows = {}
    for label in ("airfoil_ard_self", "protein", "synthetics"):
        x, self_gram, inner = inputs[label]
        b, n, p = x.shape
        out = {"shape": [b, n, p]}
        for mode in ("3xtf32", "tf32"):
            key = "" if mode == "3xtf32" else "_tf32"
            out[f"ms{key}"] = time_device_ms(lambda: lg._launch(x, x, mode, int(self_gram)))
            out[f"plain_ms{key}"] = time_device_ms(
                lambda: lg.lane_gram_plain(x, x, mode, self_gram, inner))
            flops, nbytes = lg.work(b, n, n, p, mode, same_operand=True)
            byte_s, flop_s = nbytes / peaks[0], flops / tf32_peak
            out[f"bound_ms{key}"] = max(byte_s, flop_s) * 1e3
            out[f"bound_by{key}"] = "bytes" if byte_s >= flop_s else "operations"
        with tf32_library_matmuls():
            out["library_ms"] = time_device_ms(lambda: library(x))
        rows[label] = out
    return rows


def lane_cv(torch, lg, spd, lane: str, make_gp, x, y, folds) -> dict:
    """``regression_cv`` at ``lane`` with the lane kernel's and K1's
    launches, and each fold's guard metrics."""
    from spark_gp_tpu_torch.ops.precision import set_precision_lane

    zero(lg.lane_gram, spd.spd_inv_logdet)
    prev = set_precision_lane(lane)
    try:
        cv = regression_cv(make_gp(), x, y, folds)
    finally:
        set_precision_lane(prev)
    first = cv.pop("first_model")
    cv.update(lane_gram_launches=lg.lane_gram.launches,
              k1_launches=spd.spd_inv_logdet.launches,
              probe_launches={"lane_gram": probes(lg.lane_gram),
                              "spd_inv_logdet": probes(spd.spd_inv_logdet)},
              precision_lane=first.metrics["precision_lane"],
              first_theta=first.raw_predictor.theta)
    return cv


def strict_probe_noise(torch, spd, x, y, theta) -> dict:
    """How far the strict lane's float32 objective (K1's route) on the
    guard's probe expert -- the first expert of ``(x, y)`` at expert 100 --
    lies from float64 at ``theta``: the relative NLL and gradient deltas
    on the guard's scales.  It is rounding every lane shares, which the
    guard's float64 probe leaves out."""
    from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
    from spark_gp_tpu_torch.parallel.experts import ExpertData, group_for_experts

    before = spd.spd_inv_logdet.launches
    out = {}
    for dtype in (torch.float32, torch.float64):
        d = group_for_experts(x, y, 100, dtype=dtype, device="cuda")
        one = ExpertData(x=d.x[:1], y=d.y[:1], mask=d.mask[:1])
        out[dtype] = make_value_and_grad(airfoil_gp(100)._get_kernel(), one)(theta)
    spd.spd_inv_logdet.launches = before
    (v32, g32), (v64, g64) = out[torch.float32], out[torch.float64]
    scale = max(abs(v64), 97.0, 1.0)
    return {"delta_nll_rel": abs(v32 - v64) / scale,
            "delta_grad_rel": float(np.max(np.abs(g32 - g64)) / max(np.max(np.abs(g64)), scale))}


def lanes_phases(torch, lg, spd, data_main: dict, rdata: dict, smi: str) -> dict:
    """lanes-airfoil, lanes-synthetics, lanes-device, lanes-breach,
    lanes-breach-log and lanes-k1 (module doc).  Returns K1's launches on
    each phase's fits and the lane kernel's."""
    from spark_gp_tpu_torch.ops import precision
    from spark_gp_tpu_torch.parallel.experts import group_for_experts

    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    xs, ys, sfolds = rdata["x"], rdata["y"], rdata["folds"]
    from spark_gp_tpu_torch import GaussianProcessRegression

    k1, lane_launches = {}, {}
    guards = {}
    guard_log: list = []
    emit_guard = GaussianProcessRegression._emit_precision_guard

    def recorded_guard(self, instr, *args):
        emit_guard(self, instr, *args)
        guard_log.append({k: instr.metrics.get(f"mixed_precision_guard.{k}")
                          for k in GUARD_KEYS})

    for config, make_gp, xx, yy, ff, bar in (
            ("airfoil", lambda: airfoil_gp(100), x, y, folds, MIXED_BARS["airfoil"]),
            ("synthetics", synthetics_gp, xs, ys, sfolds, MIXED_BARS["synthetics"])):
        rows = {}
        for lane in ("mixed", "fast"):
            guard_log.clear()
            GaussianProcessRegression._emit_precision_guard = recorded_guard
            try:
                cv = lane_cv(torch, lg, spd, lane, make_gp, xx, yy, ff)
            finally:
                GaussianProcessRegression._emit_precision_guard = emit_guard
            guard = list(guard_log)
            nfev = cv["nfev"]
            # ARD (airfoil): one gram an evaluation and one for the guard's
            # probe; RBF (Synthetics): the gram cache once a fit and once
            # in the probe; and each fit's expert-quality probe, one gram
            # and one K1 launch a fit
            probe = cv["probe_launches"]
            rule = (nfev + len(ff) if config == "airfoil" else 2 * len(ff)) + probe["lane_gram"]
            # the guard's probes take float64 linear algebra: no K1
            k1_rule_lanes = nfev + probe["spd_inv_logdet"]
            rows[lane] = {**{k: cv[k] for k in ("rmse", "seconds", "nfev", "optimize_seconds",
                                                 "lane_gram_launches", "k1_launches",
                                                 "precision_lane", "first_theta",
                                                 "probe_launches")},
                          "lane_gram_rule": rule, "k1_rule": k1_rule_lanes, "guard": guard}
            k1[f"lanes_{config}_{lane}"] = cv["k1_launches"]
            lane_launches[f"lanes_{config}_{lane}"] = cv["lane_gram_launches"]
            if cv["lane_gram_launches"] != rule or cv["k1_launches"] != k1_rule_lanes \
                    or cv["precision_lane"] != lane \
                    or probe != {"lane_gram": len(ff), "spd_inv_logdet": len(ff)}:
                raise AssertionError(f"lanes-{config} {lane}: {rows[lane]}")
            if lane == "mixed" and not (cv["rmse"] < bar
                                        and all(g["breach"] == 0.0 for g in guard)):
                raise AssertionError(f"lanes-{config} mixed: rmse {cv['rmse']} (bar {bar}), "
                                     f"guard {guard}")
        guards[config] = rows
        extra = {}
        if config == "airfoil":
            extra["strict_probe_noise_fold0"] = strict_probe_noise(
                torch, spd, x[folds[0][0]], y[folds[0][0]], rows["mixed"].pop("first_theta"))
        for row in rows.values():
            row.pop("first_theta", None)
        emit({"phase": f"lanes-{config}", "strict_rmse": HOST_FITS.get(config, {}).get("rmse"),
              **rows, **extra, "bar_mixed": bar, "card": smi})

    # lanes-device: the first airfoil fold's device fit at mixed, the lane
    # kernel inside the captured step
    train, test = folds[0]
    zero(lg.lane_gram, spd.spd_inv_logdet)
    prev = precision.set_precision_lane("mixed")
    try:
        model, seconds = airfoil_fold_fit(airfoil_gp(100).setOptimizer("device"), x, y, train)
    finally:
        precision.set_precision_lane(prev)
    from spark_gp_tpu_torch.utils.validation import rmse

    m = model.metrics
    dev_rmse = rmse(y[test], model.predict(x[test]))
    lane_rule = k1_rule(m) + 1 + probe_rule(m, "lane_gram")
    k1_dev_rule = k1_rule(m) + probe_rule(m)
    row = {"phase": "lanes-device", "rmse": dev_rmse, "seconds": seconds,
           "nfev": m["lbfgs_nfev"], "loop": loop_record(m),
           "lane_gram_launches": lg.lane_gram.launches, "lane_gram_rule": lane_rule,
           "k1_launches": spd.spd_inv_logdet.launches, "k1_rule": k1_dev_rule,
           "guard": {k: m.get(f"mixed_precision_guard.{k}") for k in GUARD_KEYS}, "card": smi}
    k1["lanes_device"] = spd.spd_inv_logdet.launches
    lane_launches["lanes_device"] = lg.lane_gram.launches
    emit(row)
    if not (dev_rmse < MIXED_BARS["airfoil"] and m.get("device_opt.captures") == 1
            and row["lane_gram_launches"] == lane_rule and row["k1_launches"] == k1_dev_rule):
        raise AssertionError(f"lanes-device: {row}")

    # lanes-breach: the mixed bar forced below 0 under GP_GUARD_ACTION=degrade
    # makes one strict_lane transition and ends at the strict fit's theta;
    # under the default (log) it warns and makes none
    strict_model, _ = airfoil_fold_fit(airfoil_gp(100), x, y, train)
    bar_before = precision.GUARD_BARS["mixed"]
    precision.GUARD_BARS["mixed"] = -1.0
    prev = precision.set_precision_lane("mixed")
    os.environ["GP_GUARD_ACTION"] = "degrade"
    zero(lg.lane_gram, spd.spd_inv_logdet)
    try:
        degraded, _ = airfoil_fold_fit(airfoil_gp(100), x, y, train)
        k1["lanes_breach"] = spd.spd_inv_logdet.launches
        lane_launches["lanes_breach"] = lg.lane_gram.launches
        os.environ.pop("GP_GUARD_ACTION")
        logged, _ = airfoil_fold_fit(airfoil_gp(100), x, y, train)
    finally:
        os.environ.pop("GP_GUARD_ACTION", None)
        precision.set_precision_lane(prev)
        precision.GUARD_BARS["mixed"] = bar_before
    walk = [(d["from"], d["to"]) for d in getattr(degraded, "degradations", None) or []]
    theta_rel = float(np.max(np.abs(degraded.raw_predictor.theta
                                    - strict_model.raw_predictor.theta)
                             / np.abs(strict_model.raw_predictor.theta)))
    row = {"phase": "lanes-breach", "walk": walk, "theta_rel_vs_strict": theta_rel,
           "theta_equal": bool(np.array_equal(degraded.raw_predictor.theta,
                                              strict_model.raw_predictor.theta)),
           "precision_lane": degraded.metrics["precision_lane"], "card": smi}
    emit(row)
    if not (walk == [("native", "strict_lane")] and theta_rel <= 1e-6
            and row["precision_lane"] == "strict"):
        raise AssertionError(f"lanes-breach: {row}")
    k1["lanes_breach_log"] = spd.spd_inv_logdet.launches - k1["lanes_breach"]
    lane_launches["lanes_breach_log"] = lg.lane_gram.launches - lane_launches["lanes_breach"]
    row = {"phase": "lanes-breach-log", "breach": logged.metrics["mixed_precision_guard.breach"],
           "degradations": getattr(logged, "degradations", None),
           "precision_lane": logged.metrics["precision_lane"], "card": smi}
    emit(row)
    if not (row["breach"] == 1.0 and not row["degradations"] and row["precision_lane"] == "mixed"):
        raise AssertionError(f"lanes-breach-log: {row}")

    # lanes-k1: K1 reads no lane -- its output at mixed is strict's, bit for bit
    data = group_for_experts(x[train], y[train], 100, dtype=torch.float32, device="cuda")
    kmat = airfoil_kernel().gram(torch.as_tensor(airfoil_kernel().init_theta(),
                                                 dtype=torch.float32, device="cuda"), data.x)
    kmat = kmat + 1e-4 * torch.eye(kmat.shape[-1], device="cuda")
    before = spd.spd_inv_logdet.launches
    outs = {}
    for lane in ("strict", "mixed"):
        with precision.precision_lane_scope(lane):
            outs[lane] = spd.spd_inv_logdet(kmat)
    spd.spd_inv_logdet.launches = before
    equal = all(torch.equal(a, b) for a, b in zip(outs["strict"], outs["mixed"]))
    emit({"phase": "lanes-k1", "shape": list(kmat.shape[:2]), "bit_equal": equal, "card": smi})
    if not equal:
        raise AssertionError("lanes-k1: K1 at mixed differs from strict")
    return {"k1": k1, "lane_gram": lane_launches, "guards": guards}


def slice14_phases(torch, spd, lg, data_main: dict, rdata: dict, smi: str) -> dict:
    """This slice's phases: lane-gram-check, lane-gram-time, large-m,
    large-m-crossover, large-m-oom, lanes-airfoil, lanes-synthetics,
    lanes-device, lanes-breach, lanes-breach-log, lanes-k1.  Returns K1's
    launches on each phase's fits, the lane kernel's and its checks and
    timings."""
    start_all = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    inputs = lane_gram_inputs(torch, data_main, rdata)
    before = lg.lane_gram.launches
    errs = check_lane_gram(torch, lg, inputs)
    emit({"phase": "lane-gram-check", "bar": f"{LANE_GRAM_BAR} x (max|x1|^2 + max|x2|^2)",
          "max_err_over_scale": errs, "card": smi})
    timing = time_lane_gram(torch, lg, inputs, peaks_for(name), card_peaks(name).tf32)
    lg.lane_gram.launches = before
    emit({"phase": "lane-gram-time", "rows": timing, "card": smi})
    k1 = large_m_phases(torch, spd, smi)
    lanes = lanes_phases(torch, lg, spd, data_main, rdata, smi)
    k1.update(lanes["k1"])
    emit({"phase": "slice14-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return {"k1": k1, "lane_gram": lanes["lane_gram"], "errs": errs, "timing": timing}


# --- slice 15: cost attribution and the statistical quality plane ------------

#: the quality plane's acceptance bound (the JAX package's
#: tests/test_quality_obs.py): an injected fault alerts within this many
#: observations (rows, for drift); the clean stream never does
ALERT_BUDGET = 512
#: the card's per-expert NLL against the CPU's float64 on the same stack
#: and theta: |difference| over max(1, |nll|)
EXPERT_NLL_BAR = 1e-4
#: the JAX package's bar on the quality plane's share of the serve path
#: (recorded against the closed loop here, not asserted)
QUALITY_OVERHEAD_BAR = 0.02
#: the closed loop timed with the plane on and off: clients x requests of
#: QUALITY_LOOP_ROWS rows, each with a request_id
QUALITY_LOOP_CLIENTS, QUALITY_LOOP_REQUESTS, QUALITY_LOOP_ROWS = 4, 150, 4
#: the cost phase's serve requests (4 rows: one bucket-8 batch each)
COST_SERVE_REQUESTS = 100
#: the launch totals this script counted on the H100 before the
#: expert-quality probe and slice 15, beside which this run's stand
LAUNCH_TOTALS_BEFORE = {"spd_inv_logdet": 25574, "streamed_matvec": 5732,
                      "streamed_matvec_vjp": 164, "slq_quadrature": 516, "lane_gram": 799}


def metered(on: bool, fn):
    """``fn()`` with cost metering forced on or off, the gate restored."""
    from spark_gp_tpu_torch.obs import cost

    cost.set_cost_metering(on)
    try:
        return fn()
    finally:
        cost.set_cost_metering(None)


def cost_row(model, entry: str = "fit.GaussianProcessRegression") -> dict:
    """A fit's journal ``xla_cost`` entry row (raises if absent)."""
    xc = model.run_journal["xla_cost"]
    if not xc or entry not in xc["entries"] or len(xc["entries"]) != 1:
        raise AssertionError(f"cost: journal xla_cost {xc}")
    return xc["entries"][entry]


def kernel_work_matches(row: dict, name: str, launches: float, flops: float,
                        nbytes: float) -> bool:
    k = row["kernels"].get(name, {"launches": 0.0, "flops": 0.0, "bytes": 0.0})
    return k["launches"] == launches and k["flops"] == flops and k["bytes"] == nbytes


def cost_phase(torch, spd, sm, sq, data_main: dict, cdata: dict, model_path: str,
               counts, smi: str) -> dict:
    """cost (module doc); returns the phase's record."""
    from spark_gp_tpu_torch.models import laplace as lap
    from spark_gp_tpu_torch.models import ppa
    from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
    from spark_gp_tpu_torch.obs import cost
    from spark_gp_tpu_torch.obs.runtime import telemetry
    from spark_gp_tpu_torch.ops import iterative as it_ops
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.resilience import memplan
    from spark_gp_tpu_torch import GaussianProcessRegressionModel
    from spark_gp_tpu_torch.serve import GPServeServer
    from spark_gp_tpu_torch.utils.validation import rmse

    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    train, test = folds[0]
    out, checks = {}, {}
    counts.zero()
    memplan.reset_calibration()
    cost.clear_cache()

    # host fit of the first airfoil fold, in turns: unmetered, metered,
    # metered, unmetered; all four bit-equal
    turns = []
    for on in (False, True, True, False):
        model, seconds = metered(on, lambda: airfoil_fold_fit(airfoil_gp(100), x, y, train))
        turns.append((on, model, seconds))
    ref = turns[0][1]
    m = turns[1][1].metrics
    e, s = int(m["num_experts"]), int(m["expert_size"])
    row = cost_row(turns[1][1])
    flops, nbytes = spd.work(e, s)
    nfev = m["lbfgs_nfev"]
    xc = turns[1][1].run_journal["xla_cost"]
    mfu = xc["measured_mfu_optimize"]
    host_peak = memplan.compiled_peak("fit.GaussianProcessRegression")
    out["airfoil_host"] = {
        "turns_seconds": [[on, sec] for on, _, sec in turns],
        "optimize_seconds_turns": [[on, mm.metrics["optimize_seconds"]] for on, mm, _ in turns],
        "row": row, "nfev": nfev, "shape": [e, s], "flops_total": xc["flops_total"],
        "measured_mfu_optimize": mfu,
        "compiled_peak_bytes": host_peak,
        "predicted_bytes": memplan.predicted_bytes(
            memplan.fit_dispatch_bytes(e, s, 5, 4, "native")),
        "actual_peak_bytes": turns[1][1].run_journal["memory"]["peak"].get(
            "memory.peak_bytes_in_use"),
        "memory_plan": turns[1][1].run_journal["memory_plan"],
        "expert_quality_in_journal": turns[1][1].run_journal["expert_quality"] is not None,
        "expert_quality_metrics": {k: v for k, v in m.items() if k.startswith("expert_quality.")}}
    checks["airfoil_host"] = (
        all(np.array_equal(t[1].raw_predictor.theta, ref.raw_predictor.theta) for t in turns)
        and all(rmse(y[test], t[1].predict(x[test])) == rmse(y[test], ref.predict(x[test]))
                for t in turns)
        and row["executions"] == nfev
        and kernel_work_matches(row, "spd_inv_logdet", nfev, nfev * flops, nfev * nbytes)
        and turns[0][1].run_journal["xla_cost"] is None
        and mfu is not None and mfu["device_kind"] == torch.cuda.get_device_name(0)
        and mfu["peak"] == "float32 (no tensor cores)" and mfu["power_limit"]
        and out["airfoil_host"]["expert_quality_in_journal"]
        and {"expert_quality.nll_spread", "expert_quality.nll_std", "expert_quality.jitter_max",
             "expert_quality.weight_min"} <= set(m))

    # the overhead of metering one evaluation: a plain call, the first of a
    # signature (measured under the counter) and a cached one
    data = group_for_experts(x[train], y[train], 100, dtype=torch.float32, device="cuda")
    kernel, theta = ref.raw_predictor.kernel, ref.raw_predictor.theta

    def eval_ms(vag, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vag(theta)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    plain = metered(False, lambda: eval_ms(make_value_and_grad(kernel, data), 21))
    first = [metered(True, lambda: eval_ms(make_value_and_grad(kernel, data), 1))[0]
             for _ in range(5)]
    vag = make_value_and_grad(kernel, data)
    steady = metered(True, lambda: eval_ms(vag, 21))[1:]
    out["overhead_ms"] = {"plain": float(np.median(plain[1:])),
                          "first_signature": float(np.median(first)),
                          "steady": float(np.median(steady))}

    # protein-matfree at maxiter 2 on the host optimizer: K2, K2-VJP and
    # the quadrature, every launch's work its work model's
    xp, tr, yp_tr = data_main["xp"], data_main["tr"], data_main["yp_tr"]
    cfg = it_ops.solver_config(4065)
    pm = {}
    for on in (False, True):
        try:
            pm[on] = metered(on, lambda: matfree_gp("matfree", max_iter=2).fit(xp[tr], yp_tr))
        finally:
            it_ops.set_solver_lane(None)
    m = pm[True].metrics
    e, s, p = int(m["num_experts"]), int(m["expert_size"]), xp.shape[1]
    nfev = m["lbfgs_nfev"]
    row = cost_row(pm[True])
    # per evaluation: iters CG products of width 1 + probes, and the two
    # differentiated legs (widths 1 and probes)
    widths = {1 + cfg.probes: cfg.iters, 1: 1, cfg.probes: 1}
    k2 = tuple(sum(sm.work(e, s, p, n)[i] * times for n, times in widths.items())
               for i in (0, 1))
    vjp = tuple(sum(sm.work_vjp(e, s, p, n)[i] for n in (1, cfg.probes)) for i in (0, 1))
    quad = sq.work(e * cfg.probes, cfg.iters)
    out["protein_matfree_host"] = {"row": row, "nfev": nfev, "shape": [e, s, p],
                                   "iters": cfg.iters, "probes": cfg.probes}
    checks["protein_matfree_host"] = (
        np.array_equal(pm[True].raw_predictor.theta, pm[False].raw_predictor.theta)
        and row["executions"] == nfev
        and kernel_work_matches(row, "streamed_matvec", nfev * (cfg.iters + 2), nfev * k2[0],
                                nfev * k2[1])
        and kernel_work_matches(row, "streamed_matvec_vjp", 2 * nfev, nfev * vjp[0],
                                nfev * vjp[1])
        and kernel_work_matches(row, "slq_quadrature", nfev, nfev * quad[0], nfev * quad[1]))

    # the fold's device fit: one execution a replay or eager step, the
    # step's cost counted at its capture, and one for the initial
    # evaluation, which runs eagerly before the capture and carries the
    # fit's one per-execution peak: the memory plan compares that peak,
    # like for like, and must not breach (ROADMAP.md fault 3b).
    # The unmetered fit has no per-execution peak, so its plan compares the
    # whole fit's (the JAX package's rule): the counter is read around the
    # metered fit alone
    dev = {False: metered(False, lambda: airfoil_fold_fit(
        airfoil_gp(100).setOptimizer("device"), x, y, train)[0])}
    breaches = telemetry.snapshot()["counters"].get("plan.margin_breach", 0.0)
    dev[True] = metered(True, lambda: airfoil_fold_fit(airfoil_gp(100).setOptimizer("device"),
                                                       x, y, train)[0])
    m = dev[True].metrics
    steps = m.get("device_opt.replays", 0.0) + m.get("device_opt.eager_steps", 0.0)
    execs = steps + 1
    row = cost_row(dev[True])
    e, s = int(m["num_experts"]), int(m["expert_size"])
    flops, nbytes = spd.work(e, s)
    plan = dev[True].run_journal["memory_plan"]
    out["airfoil_device"] = {"row": row, "steps": steps, "executions": execs,
                             "loop": loop_record(m), "memory_plan": plan,
                             "plan_margin_breach": telemetry.snapshot()["counters"].get(
                                 "plan.margin_breach", 0.0) - breaches}
    checks["airfoil_device"] = (
        np.array_equal(dev[True].raw_predictor.theta, dev[False].raw_predictor.theta)
        and row["executions"] == execs and steps > 0
        and kernel_work_matches(row, "spd_inv_logdet", execs, execs * flops, execs * nbytes)
        and row.get("peak_bytes_per_execution", 0.0) > 0
        and out["airfoil_device"]["plan_margin_breach"] == 0
        and not any(r.get("margin_breach") for r in plan))

    # gpc-mnist on the host optimizer: one execution an objective call, K1
    # once a Newton iteration and once a call inside them
    lap.laplace_mode_batch.iterations = lap.batched_neg_logz.calls = 0
    gfit = {on: metered(on, lambda: split_fit(mnist_gpc(), cdata["xm"], cdata["ym"]))
            for on in (False, True)}
    gm = gfit[True]["model"].metrics
    row = cost_row(gfit[True]["model"], "fit.GaussianProcessClassifier")
    k1_launches = gm["newton_iterations"] + gm["objective_calls"]
    flops, nbytes = spd.work(int(gm["num_experts"]), int(gm["expert_size"]))
    out["gpc_mnist_host"] = {"row": row, "objective_calls": gm["objective_calls"],
                             "newton_iterations": gm["newton_iterations"],
                             "accuracy": [gfit[False]["accuracy"], gfit[True]["accuracy"]]}
    checks["gpc_mnist_host"] = (
        np.array_equal(gfit[True]["model"].raw_predictor.theta,
                       gfit[False]["model"].raw_predictor.theta)
        and gfit[True]["accuracy"] == gfit[False]["accuracy"]
        and row["executions"] == gm["objective_calls"]
        and kernel_work_matches(row, "spd_inv_logdet", k1_launches, k1_launches * flops,
                                k1_launches * nbytes))

    # a 1503-row predict_with_var of the persisted model in 501-row chunks:
    # one execution a chunk
    loaded = GaussianProcessRegressionModel.load(model_path)
    raw = loaded.raw_predictor
    raw._PREDICT_CHUNK_ELEMS = 501 * raw.active.shape[0]

    def predict_flops():
        before = telemetry.snapshot()["counters"].get("xla.flops.predict.ppa", 0.0)
        keys = set(cost._CACHE)
        mean, var = loaded.predict_with_var(x)
        new = [cost._CACHE[k] for k in set(cost._CACHE) - keys]
        return telemetry.snapshot()["counters"]["xla.flops.predict.ppa"] - before, new, mean

    d1, new1, mean_metered = metered(True, predict_flops)
    d2, new2, _ = metered(True, predict_flops)
    mean_plain = loaded.predict_with_var(x)[0]
    out["predict"] = {"rows": int(x.shape[0]), "chunks": 3, "flops_first": d1,
                      "flops_second": d2, "chunk_cost": new1}
    checks["predict"] = (len(new1) == 1 and d1 == 3 * new1[0]["flops"] == d2 and not new2
                         and np.array_equal(mean_metered, mean_plain))

    # 100 requests of 4 rows to the persisted model behind the server: one
    # bucket-8 batch a request, one execution a batch
    def serve_flops():
        server = GPServeServer(min_bucket=8, max_batch=32, request_timeout_ms=30_000.0)
        server.register("airfoil", model_path)
        server.start()
        try:
            graph = server.registry.get("airfoil").predictor._graphs[8]
            before = telemetry.snapshot()["counters"].get("xla.flops.serve.batch", 0.0)
            batches = server.metrics.counter("batches")
            for i in range(COST_SERVE_REQUESTS):
                server.predict("airfoil", x[4 * i:4 * i + 4])
            flops = telemetry.snapshot()["counters"]["xla.flops.serve.batch"] - before
            return flops, server.metrics.counter("batches") - batches, graph.meter.cost
        finally:
            server.stop()

    flops, batches, bucket_cost = metered(True, serve_flops)
    out["serve"] = {"requests": COST_SERVE_REQUESTS, "batches": batches, "flops": flops,
                    "bucket_8_cost": bucket_cost}
    checks["serve"] = (batches == COST_SERVE_REQUESTS and bucket_cost is not None
                       and flops == batches * bucket_cost["flops"])
    out["launches"] = counts.take("cost")
    out["checks"] = checks
    emit({"phase": "cost", **out, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"cost: {checks}")
    return out


def expert_nll_on_f64_algebra(torch, kernel, theta, data):
    """Per-expert NLL of ``data``'s float32 gram (built on its device, as
    the probe builds it) in float64 linear algebra: the reference that
    leaves out the probe's float32 algebra but keeps the gram's rounding."""
    from spark_gp_tpu_torch.kernels.base import masked_gram_stack

    with torch.no_grad():
        t = torch.as_tensor(np.asarray(theta), dtype=data.x.dtype, device=data.x.device)
        kmat = masked_gram_stack(kernel, t, data.x, data.mask).double()
        ym = (data.y * data.mask).double()
        chol = torch.linalg.cholesky(kmat)
        alpha = torch.cholesky_solve(ym[..., None], chol)[..., 0]
        logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return (0.5 * (ym * alpha).sum(-1) + 0.5 * logdet).cpu().numpy()


def expert_quality_phase(torch, spd, sm, sq, data_main: dict, mf_data, counts, smi: str) -> dict:
    """expert-quality (module doc)."""
    from spark_gp_tpu_torch import Const, EyeKernel, RBFKernel
    from spark_gp_tpu_torch.ops import iterative as it_ops
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.resilience.quarantine import expert_nll

    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    train = folds[0][0]
    counts.zero()
    model, _ = airfoil_fold_fit(airfoil_gp(100), x, y, train)
    fit_launches = counts.take("expert_quality_fit")
    kernel, theta = model.raw_predictor.kernel, model.raw_predictor.theta
    card = group_for_experts(x[train], y[train], 100, dtype=torch.float32, device="cuda")
    cpu = group_for_experts(x[train], y[train], 100, dtype=torch.float64, device="cpu")
    # the bar at init theta (the parity phase's point); at the fit's theta
    # (sigma2 1e-4, cond ~3e5) the float32 gram alone is 1.4e-2 off the
    # float64 one, so there the error is recorded beside the part of it
    # the probe's own float32 algebra makes (float64 algebra on the card's
    # float32 gram)
    counts.zero()
    nll_card = expert_nll(kernel, theta, card)
    probe_launches = counts.take("expert_quality_probe")
    nll_cpu = expert_nll(kernel, theta, cpu)
    theta0 = kernel.init_theta()
    rel = {"init_theta": expert_nll(kernel, theta0, card), "init_theta_cpu":
           expert_nll(kernel, theta0, cpu)}
    err = np.abs(rel["init_theta"] - rel["init_theta_cpu"]) / np.maximum(
        1.0, np.abs(rel["init_theta_cpu"]))
    err_fit = np.abs(nll_card - nll_cpu) / np.maximum(1.0, np.abs(nll_cpu))
    algebra = expert_nll_on_f64_algebra(torch, kernel, theta, card)
    err_algebra = np.abs(nll_card - algebra) / np.maximum(1.0, np.abs(algebra))
    journal_nll = np.asarray(model.run_journal["expert_quality"]["nll"])

    # the matfree lane: K2 and the quadrature, no [E, s, s] stack
    mkernel = matfree_gp(None)._get_kernel()
    gram_stack_bytes = mf_data.num_experts * mf_data.expert_size ** 2 * 4
    counts.zero()
    with it_ops.solver_lane_scope("matfree"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        nll_mf = expert_nll(mkernel, mkernel.init_theta(), mf_data)
        peak = torch.cuda.max_memory_allocated() - base
    mf_launches = counts.take("expert_quality_matfree")

    # the probe's time at protein (366, 100, 9) and large-m (1200, 100, 3),
    # exact lane; its launches there are not a fit's
    xp, tr, yp_tr = data_main["xp"], data_main["tr"], data_main["yp_tr"]
    xl, yl = large_m_data()
    timing = {}
    before = spd.spd_inv_logdet.launches
    for label, kern, stack in (
            ("protein", protein_kernel() + Const(1e-3) * EyeKernel(),
             group_for_experts(xp[tr], yp_tr, 100, dtype=torch.float32, device="cuda")),
            ("large_m", RBFKernel(0.3, 1e-6, 10) + Const(1e-3) * EyeKernel(),
             group_for_experts(xl, yl, 100, dtype=torch.float32, device="cuda"))):
        theta0 = kern.init_theta()
        expert_nll(kern, theta0, stack)
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            expert_nll(kern, theta0, stack)
            times.append((time.perf_counter() - t0) * 1e3)
        timing[label] = {"shape": list(stack.x.shape), "ms": float(np.median(times)),
                         "ms_all": times}
    spd.spd_inv_logdet.launches = before
    out = {"shape": list(card.x.shape[:2]), "bar": EXPERT_NLL_BAR,
           "max_rel_err": float(err.max()), "nll_card_init_theta": rel["init_theta"].tolist(),
           "fit_theta": {"max_rel_err": float(err_fit.max()),
                         "max_rel_err_of_float32_algebra": float(err_algebra.max()),
                         "nll_card": nll_card.tolist(), "nll_cpu_f64": nll_cpu.tolist()},
           "journal_vs_probe_max_abs": float(np.max(np.abs(journal_nll - nll_card))),
           "fit_probe_stamps": {k: v for k, v in model.metrics.items()
                                if k.startswith("expert_quality.probe_launches.")},
           "fit_launches": fit_launches, "probe_launches": probe_launches,
           "matfree": {"shape": list(mf_data.x.shape), "peak_bytes": peak,
                       "gram_stack_bytes": gram_stack_bytes, "bar_share": MATFREE_PEAK_SHARE,
                       "launches": mf_launches, "finite": bool(np.all(np.isfinite(nll_mf)))},
           "probe_ms": timing}
    emit({"phase": "expert-quality", **out, "card": smi})
    iters = it_ops.solver_config(mf_data.expert_size).iters
    if not (out["max_rel_err"] <= EXPERT_NLL_BAR
            and out["journal_vs_probe_max_abs"] <= EXPERT_NLL_BAR * max(1.0, float(
                np.max(np.abs(nll_cpu))))
            and probe_launches == {"spd_inv_logdet": 1, "streamed_matvec": 0,
                                   "streamed_matvec_vjp": 0, "slq_quadrature": 0, "lane_gram": 0}
            and out["fit_probe_stamps"] == {"expert_quality.probe_launches.spd_inv_logdet": 1.0}
            and mf_launches == {"spd_inv_logdet": 0, "streamed_matvec": iters + 2,
                                "streamed_matvec_vjp": 0, "slq_quadrature": 1, "lane_gram": 0}
            and peak < MATFREE_PEAK_SHARE * gram_stack_bytes and out["matfree"]["finite"]):
        raise AssertionError(f"expert-quality: {out}")
    return out


def quality_phase(torch, data_main: dict, model_path: str, counts, smi: str) -> dict:
    """quality (module doc)."""
    import threading

    from spark_gp_tpu_torch.resilience import chaos
    from spark_gp_tpu_torch.serve import GPServeServer
    from spark_gp_tpu_torch.serve.lifecycle import CanaryPolicy

    x, y = data_main["x"], data_main["y"]
    counts.zero()
    server = GPServeServer(min_bucket=8, max_batch=32, max_wait_ms=1.0,
                           request_timeout_ms=30_000.0, quality_window=64)
    for name in ("calibration", "drift", "canary", "labels"):
        server.register(name, model_path)
    server.start()
    out = {}
    try:
        rng = np.random.default_rng(17)

        def feed(name, n_obs, factor, tag):
            """Requests of 4 rows with ids; each observed with labels drawn
            from the served distribution at ``factor`` x its sigma.  The
            observations when ``name`` first alerts, or 0."""
            done = i = 0
            while done < n_obs:
                rid = f"{tag}-{i}"
                i += 1
                row = int(rng.integers(0, x.shape[0] - 8))
                mean, var = server.submit(name, x[row:row + 4], request_id=rid).result(30.0)
                server.observe(name, rid, mean + factor * np.sqrt(var) * rng.standard_normal(4))
                done += 4
                if server.quality.alert_reason(name) is not None:
                    return done
            return 0

        clean = feed("calibration", ALERT_BUDGET, 1.0, "clean")
        snap = server.quality.snapshot()["models"]["calibration"]["calibration"]
        out["clean"] = {"alerted_at": clean, "observations": snap["observations"],
                        "z_mean": snap["z_mean"], "z_std": snap["z_std"],
                        "coverage": snap["coverage"]}
        health_clean = server.health()["status"]
        with chaos.miscalibrate(0.5):
            tripped = feed("calibration", ALERT_BUDGET, 2.0, "shrunk")
        out["miscalibrate"] = {"scale": 0.5, "alerted_at": tripped,
                               "reason": server.quality.alert_reason("calibration"),
                               "health": server.health()["status"]}

        def pump(n_rows):
            """Requests of 8 training rows drawn at random (the file's rows
            are ordered, so consecutive ones are not the training mass)."""
            done = 0
            while done < n_rows:
                server.submit("drift", x[rng.integers(0, x.shape[0], size=8)]).result(30.0)
                done += 8
                if server.quality.alert_reason("drift") is not None:
                    return done
            return 0

        drift_clean = pump(ALERT_BUDGET)
        shift = 4.0 * float(x.std())
        with chaos.drift_inputs(shift):
            drift = pump(ALERT_BUDGET)
        out["drift"] = {"shift": shift, "clean_alerted_at": drift_clean, "alerted_at": drift,
                        "reason": server.quality.alert_reason("drift")}

        # the canary: the model under an active miscalibration alert, then a
        # candidate that clears the shadow bar under quality_guard
        for i in range(40):
            rid = f"g{i}"
            row = int(rng.integers(0, x.shape[0] - 8))
            mean, var = server.submit("canary", x[row:row + 4], request_id=rid).result(30.0)
            server.observe("canary", rid, mean + 3.0 * np.sqrt(var) * rng.standard_normal(4))
        alert_before = server.quality.alert_reason("canary")
        server.register("canary", model_path, canary_policy=CanaryPolicy(
            fraction=1.0, promote_after=3, quality_guard=True))
        for i in range(8):
            server.submit("canary", x[i:i + 2]).result(30.0)
            if server.canaries.active("canary") is None:
                break
        out["canary"] = {"alert_before": alert_before,
                         "rollbacks": server.metrics.counter("canary.rollbacks"),
                         "promotions": server.metrics.counter("canary.promotions"),
                         "quarantined": server.canaries.snapshot()["quarantined"]}

        # the model's own labels (its training rows): recorded
        for i in range(ALERT_BUDGET // 4):
            rid = f"y{i}"
            idx = np.arange(4 * i, 4 * i + 4) % x.shape[0]
            server.submit("labels", x[idx], request_id=rid).result(30.0)
            server.observe("labels", rid, y[idx])
        snap = server.quality.snapshot()["models"]["labels"]["calibration"]
        out["true_labels"] = {"observations": snap["observations"], "z_mean": snap["z_mean"],
                              "z_std": snap["z_std"], "coverage": snap["coverage"],
                              "alert": snap["alert"]}
        out["health_clean"] = health_clean
        out["health_end"] = server.health()["quality"]["alerting"]
    finally:
        server.stop()
    out["cli_observed"] = dict(CLI_OBSERVED)

    # the closed loop with the plane on and off, in turns (on, off, off, on)
    servers = {}
    for on in (True, False):
        servers[on] = GPServeServer(min_bucket=8, max_batch=32, max_wait_ms=1.0,
                                    request_timeout_ms=30_000.0, quality=on)
        servers[on].register("airfoil", model_path)
        servers[on].start()

    def loop(server, tag):
        plans = [np.random.default_rng(c).integers(0, x.shape[0] - QUALITY_LOOP_ROWS,
                                                   size=QUALITY_LOOP_REQUESTS)
                 for c in range(QUALITY_LOOP_CLIENTS)]

        def client(c, plan):
            for j, row in enumerate(plan):
                server.submit("airfoil", x[row:row + QUALITY_LOOP_ROWS],
                              request_id=f"{tag}-{c}-{j}").result(30.0)

        threads = [threading.Thread(target=client, args=(c, plan))
                   for c, plan in enumerate(plans)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return QUALITY_LOOP_CLIENTS * QUALITY_LOOP_REQUESTS / (time.perf_counter() - t0)

    try:
        rates = {True: [], False: []}
        for k, on in enumerate((True, False, False, True) * 2):
            rates[on].append(loop(servers[on], f"t{k}"))
    finally:
        for server in servers.values():
            server.stop()
    on_rps, off_rps = float(np.mean(rates[True])), float(np.mean(rates[False]))
    overhead = 1.0 - on_rps / off_rps
    out["closed_loop"] = {"clients": QUALITY_LOOP_CLIENTS, "requests": QUALITY_LOOP_REQUESTS,
                          "rows": QUALITY_LOOP_ROWS, "requests_per_s_on": rates[True],
                          "requests_per_s_off": rates[False], "overhead": overhead,
                          "jax_bar": QUALITY_OVERHEAD_BAR,
                          "jax_bar_met": bool(overhead <= QUALITY_OVERHEAD_BAR)}
    out["launches"] = counts.take("quality")
    out["alert_budget"] = ALERT_BUDGET
    emit({"phase": "quality", **out, "card": smi})
    if not (out["clean"]["alerted_at"] == 0 and out["health_clean"] == "ok"
            and 0 < out["miscalibrate"]["alerted_at"] <= ALERT_BUDGET
            and out["miscalibrate"]["health"] == "degraded"
            and out["drift"]["clean_alerted_at"] == 0
            and 0 < out["drift"]["alerted_at"] <= ALERT_BUDGET
            and out["canary"]["alert_before"] is not None and out["canary"]["rollbacks"] == 1
            and out["canary"]["promotions"] == 0
            and any("quality alert" in r for r in out["canary"]["quarantined"].values())
            and out["cli_observed"].get("joined") == 3):
        raise AssertionError(f"quality: {out}")
    return out


def slice15_phases(torch, spd, sm, sq, lg, data_main: dict, mf_data, cdata: dict,
                   smi: str) -> dict:
    """This slice's phases: cost, expert-quality, quality.  The airfoil
    config on all 1503 rows (m = 1000) is fitted and saved once for the
    cost phase's predict and serve legs and the quality phase's server.
    Returns each kernel's launches on each phase."""
    import shutil
    import tempfile

    start_all = time.perf_counter()
    counts = LaunchCounts(spd, sm, sq, lg)
    work = tempfile.mkdtemp(prefix="gp_slice15_")
    try:
        counts.zero()
        model = airfoil_gp(100).fit(data_main["x"], data_main["y"])
        counts.take("persist_model")
        path = os.path.join(work, "airfoil.npz")
        model.save(path)
        cost = cost_phase(torch, spd, sm, sq, data_main, cdata, path, counts, smi)
        eq = expert_quality_phase(torch, spd, sm, sq, data_main, mf_data, counts, smi)
        quality = quality_phase(torch, data_main, path, counts, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "slice15-phases", "seconds": time.perf_counter() - start_all, "card": smi})
    return {"launches": counts.launches, "cost": cost, "expert_quality": eq, "quality": quality}


def mesh_phases(airfoil_thetas, airfoil_rmse: float, smi: str) -> dict:
    """mesh-nccl1 and mesh-gloo2 (module doc), each rank a child process
    (``spark_gp_tpu_torch/dev/mesh_phases.py``), all three started at once;
    returns each kernel's launches in each child, under the labels
    ``mesh_nccl1``, ``mesh_gloo2_rank0`` and ``mesh_gloo2_rank1``."""
    from spark_gp_tpu_torch.dev.mesh_phases import elastic_resume, run_mesh_phases

    out = run_mesh_phases(airfoil_thetas, LARGE_M_FIT)
    # this process's own step: fold 0 resumed alone from mesh-gloo2's
    # two-rank host checkpoint (an elastic resume, 2 -> 1)
    elastic = elastic_resume(out)
    nccl, gloo = out["nccl1"], out["gloo2"]
    emit({"phase": "mesh-nccl1", "seconds": nccl["seconds"], "wall_seconds": out["seconds"],
          "card": smi, **{k: v for k, v in nccl.items() if k != "seconds"}})
    if not all(nccl["checks"].values()):
        raise AssertionError(f"mesh-nccl1: {nccl['checks']}")
    rmse_mesh = gloo[0]["airfoil"]["rmse"]
    agree = {
        "airfoil_thetas": gloo[0]["airfoil"]["thetas"] == gloo[1]["airfoil"]["thetas"],
        "gpc_mnist_theta": gloo[0]["gpc_mnist"]["theta"] == gloo[1]["gpc_mnist"]["theta"],
        "gpc_mnist_accuracy": gloo[0]["gpc_mnist"]["accuracy"] == gloo[1]["gpc_mnist"]["accuracy"],
        "distribute_active": (gloo[0]["distribute"]["active_digest"]
                              == gloo[1]["distribute"]["active_digest"]),
        "distribute_theta": gloo[0]["distribute"]["theta"] == gloo[1]["distribute"]["theta"],
        "airfoil_rmse": rmse_mesh == gloo[1]["airfoil"]["rmse"],
        "elbo_rmse": gloo[0]["slice17"]["elbo"]["rmse"] == gloo[1]["slice17"]["elbo"]["rmse"],
        "selection_weights": (gloo[0]["slice17"]["selection"]["weights"]
                              == gloo[1]["slice17"]["selection"]["weights"]),
        # slice 18: the store mode and the coordinated checkpoint
        **{f"{key}_theta": gloo[0]["coord"][key]["theta"] == gloo[1]["coord"][key]["theta"]
           for key in ("store_fit", "audited_fit", "preemption")},
        "audit_rungs": (gloo[0]["coord"]["audited_fit"]["audit_rungs"]
                        == gloo[1]["coord"]["audited_fit"]["audit_rungs"]),
        "corrupt_host_verdict": (gloo[0]["coord"]["corrupt_host"]["verdict"]
                                 == gloo[1]["coord"]["corrupt_host"]["verdict"]),
        "coord_checkpoints": (gloo[0]["coord"]["preemption"]["checkpoints"]
                              == gloo[1]["coord"]["preemption"]["checkpoints"] >= 1),
    }
    bars = {"airfoil_rmse": rmse_mesh < 2.1,
            "airfoil_within_1pct": abs(rmse_mesh - airfoil_rmse) / airfoil_rmse < 0.01,
            "elastic_resume_counted": elastic["elastic_resumes"] == 1
            and elastic["stored_process_count"] == 2,
            "elastic_resume_live": elastic["resumed_from_iteration"] == 1
            and elastic["nfev"] > 0,
            "elastic_resume_fit": elastic["rmse"] < 2.1
            and abs(elastic["rmse"] - elastic["two_rank_rmse"]) < 0.01 * elastic["two_rank_rmse"]
            and abs(elastic["final_nll"] - elastic["two_rank_final_nll"])
            <= 1e-4 * abs(elastic["two_rank_final_nll"]),
            "elastic_k1_rule": elastic["k1"] == elastic["k1_rule"]}
    emit({"phase": "mesh-gloo2", "seconds": max(r["seconds"] for r in gloo), "card": smi,
          "unsharded_airfoil_rmse": airfoil_rmse, "ranks_agree": agree, "bars": bars,
          "elastic_resume": elastic,
          "ranks": [{k: v for k, v in r.items() if k != "thetas"} for r in gloo]})
    failed = [f"rank {r['rank']}: {r['checks']}" for r in gloo if not all(r["checks"].values())]
    if failed or not all(agree.values()) or not all(bars.values()):
        raise AssertionError(f"mesh-gloo2: {failed} {agree} {bars}")
    launches = {}
    for label, rec in (("mesh_nccl1", nccl), ("mesh_gloo2_rank0", gloo[0]),
                       ("mesh_gloo2_rank1", gloo[1])):
        for name, n in rec["launches"].items():
            launches.setdefault(name, {})[label] = n
    launches["spd_inv_logdet"]["mesh_elastic_main"] = elastic["k1"]
    return launches


def regression_row(label: str, seconds: float, m: dict) -> dict:
    """One row of the host-against-device table for a regression device
    fit (no Newton loop): optimize seconds, evaluations, the loop's
    replays, masked evaluations, graph nodes and capture seconds."""
    nfev = m["lbfgs_nfev"]
    return {"config": label, "fits": 1, "seconds": seconds,
            "optimize_seconds": m["optimize_seconds"], "evaluations": nfev,
            "replays": m.get("device_opt.replays"),
            "masked_lane_steps": m.get("device_opt.masked_evaluations"),
            "graph_nodes_per_fit": m.get("device_opt.graph_nodes"),
            "capture_seconds": m.get("device_opt.capture_seconds"),
            "wall_ms_per_evaluation": m["optimize_seconds"] / nfev * 1e3}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from spark_gp_tpu_torch import (
        Const,
        EyeKernel,
        GaussianProcessRegression,
    )
    from spark_gp_tpu_torch.models import ep
    from spark_gp_tpu_torch.models import laplace as lap
    from spark_gp_tpu_torch.models import laplace_generic as lap_gen
    from spark_gp_tpu_torch.models import laplace_mc as lap_mc
    from spark_gp_tpu_torch.models.likelihood import make_value_and_grad
    from spark_gp_tpu_torch.models.ppa import magic_solve
    from spark_gp_tpu_torch.ops import cuda_lib
    from spark_gp_tpu_torch.ops import iterative as it_ops
    from spark_gp_tpu_torch.ops import lane_gram as lg
    from spark_gp_tpu_torch.ops import slq_quadrature as sq
    from spark_gp_tpu_torch.ops import spd_linalg as spd
    from spark_gp_tpu_torch.ops import streamed_matvec as sm
    from spark_gp_tpu_torch.parallel.experts import group_for_experts
    from spark_gp_tpu_torch.utils.validation import rmse

    # 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": name, "nvidia_smi": smi})

    # 2. build: one nvcc per source, all started together; the first
    # designs of K1, K2-VJP and the quadrature (csrc/dev/) are built to be
    # timed beside them
    start = time.perf_counter()
    built = cuda_lib.build_all(["spd_inv_logdet", "streamed_matvec", "slq_quadrature",
                                "lane_gram", K1_FIRST_DESIGN, VJP_FIRST_DESIGN,
                                SLQ_FIRST_DESIGN], force=True)
    report = {}
    for source, (seconds, log) in built.items():
        regs = sorted({int(ln.split("Used ")[1].split()[0]) for ln in log.splitlines()
                       if "registers" in ln})
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        report[source] = {"seconds": seconds, "registers": regs, "spills": spills}
    emit({"phase": "build", "seconds": time.perf_counter() - start, "kernels": report})
    # the quadrature kernel runs in the device fits on the CG lanes of the
    # phases below: its count is the main path's from here on
    zero(sq.slq_quadrature)
    from spark_gp_tpu_torch.resilience.quarantine import PROBE_LAUNCHES

    probe_start = dict(PROBE_LAUNCHES)
    # the main path's data and the gram stacks it hands K1 at init theta
    data_main = main_path_data()
    x, y, folds = data_main["x"], data_main["y"], data_main["folds"]
    xp, yp, tr, te = (data_main[key] for key in ("xp", "yp", "tr", "te"))
    yp_tr, y_mean, y_std = (data_main[key] for key in ("yp_tr", "y_mean", "y_std"))
    stacks = exact_lane_stacks(torch, data_main)
    # the Synthetics and timeseries data and the stacks they hand K1
    rdata = regression_data()
    stacks.update(regression_stacks(torch, rdata))
    # the classifiers' data and the B stacks they hand K1
    cdata = classifier_data()
    b_stacks = gpc_b_stacks(torch, lap, cdata)
    b_stacks["iris_native"] = mc_b_stack(torch, lap_mc, cdata)
    # this slice's data and the stacks it hands K1: EP's and the Poisson
    # config's B, the greedy-scale fit's gram
    d6 = slice6_data()
    stacks.update(slice6_stacks(torch, ep, lap_gen, d6, cdata))
    # slice 7's data and the stacks it hands K1: the aggregation fits' gram
    # stacks and the health probe's one-expert stack
    d7 = slice7_data()
    stacks.update(slice7_stacks(torch, d7, stacks))
    # each config's gram_cache_engaged, asserted in the gram-cache phase
    engaged = {}

    # the protein-matfree configuration: the same split, experts of
    # s = 4065 (E = 9, one masked row), the isotropic RBF
    mf_data = group_for_experts(xp[tr], yp_tr, 4096, dtype=torch.float32, device="cuda")
    if tuple(mf_data.x.shape) != (9, 4065, 9):
        raise AssertionError(f"protein-matfree stack {tuple(mf_data.x.shape)}")
    gram_stack_bytes = 9 * 4065 * 4065 * 4

    # 3. check
    errs = check_spd_inv_logdet(torch, spd, stacks)
    emit({"phase": "check", "kernel": "spd_inv_logdet", "passed": True,
          "max_abs_err": errs})
    loo_cotangent = check_loo_cotangent(torch, spd, rdata)
    emit({"phase": "check", "kernel": "spd_inv_logdet", "check": "loo-cotangent",
          "passed": True, **loo_cotangent})
    gpc_errs = {label: check_against_plain(torch, spd, k, label)
                for label, k in b_stacks.items()}
    emit({"phase": "gpc-check", "kernel": "spd_inv_logdet", "passed": True,
          "shapes": {label: list(k.shape[:2]) for label, k in b_stacks.items()},
          "bars": {"inverse": "5e-5 * max|B^-1|", "logdet": "1e-4 + 1e-5 * |logdet|"},
          "max_abs_err": {label: {"inverse": e[0], "logdet": e[1]}
                          for label, e in gpc_errs.items()}})
    gpc_errs = {label: max(e) for label, e in gpc_errs.items()}
    k2_errs = check_streamed_matvec(torch, sm, mf_data.x)
    emit({"phase": "check", "kernel": "streamed_matvec + streamed_matvec_vjp",
          "passed": True, "bars": {"matvec": "1e-5 * max|ref|", "vjp": "1e-4 * max|ref|"},
          "errors": k2_errs})

    # 4. time, at the main path's shapes (and K1 on the workspace path's)
    peaks = peaks_for(name)
    first_design = spd.bind(cuda_lib.load(K1_FIRST_DESIGN))
    launches = spd.spd_inv_logdet.launches
    timing = time_spd_inv_logdet(torch, spd, first_design, {
        **stacks,
        **b_stacks,
        "2x256": torch.as_tensor(spd_batch(2, 256, seed=256), device="cuda"),
        "1x512": torch.as_tensor(spd_batch(1, 512, seed=512), device="cuda"),
    }, peaks)
    spd.spd_inv_logdet.launches = launches
    for label, row in timing.items():
        emit({"phase": "time", "kernel": "spd_inv_logdet", "input": label, **row, "card": smi})
    launches = (sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches)
    vjp_first = sm.bind(cuda_lib.load(VJP_FIRST_DESIGN))
    k2_timing = time_streamed_matvec(torch, sm, mf_data.x, peaks, vjp_first)
    sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches = launches
    for kname, rows in k2_timing.items():
        emit({"phase": "time", "kernel": kname, "input": "protein-matfree",
              "shape": list(mf_data.x.shape), "rows": rows, "card": smi})

    # 5. parity: the objective and its gradient, card vs CPU, on the first
    # airfoil fold's stack
    kernel = airfoil_kernel() + Const(1e-4) * EyeKernel()
    theta0 = kernel.init_theta()
    theta1 = theta0 * np.linspace(0.7, 1.3, theta0.shape[0])
    for theta in (theta0, theta1):
        out = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            data = group_for_experts(x[folds[0][0]], y[folds[0][0]], 100,
                                     dtype=dtype, device=device)
            out[device] = make_value_and_grad(kernel, data)(theta)
        (v_gpu, g_gpu), (v_cpu, g_cpu) = out["cuda"], out["cpu"]
        dv = abs(v_gpu - v_cpu) / abs(v_cpu)
        dg = float(np.max(np.abs(g_gpu - g_cpu)) / np.max(np.abs(g_cpu)))
        if not (dv < 1e-5 and dg < 1e-4):
            raise AssertionError(f"card vs CPU objective: rel dv {dv}, dg {dg}")
        emit({"phase": "parity", "rel_value_err": dv, "rel_grad_err": dg})

    # 6. airfoil: 10-fold CV of the reference's acceptance config
    zero(spd.spd_inv_logdet)
    cv = regression_cv(airfoil_gp(100), x, y, folds)
    launches_airfoil = spd.spd_inv_logdet.launches
    probe_airfoil = probes(spd.spd_inv_logdet)
    model = cv.pop("first_model")
    engaged["airfoil"] = [model.metrics["gram_cache_engaged"]]
    HOST_FITS["airfoil"] = cv
    # the unsharded folds the mesh phases hold their sharded fits to
    airfoil_thetas = [f.pop("theta") for f in cv["per_fold"]]
    airfoil_rmse = cv["rmse"]
    emit({"phase": "airfoil", **cv, "launches": launches_airfoil,
          "probe_launches": probe_airfoil, "k1_rule": "nfev + expert-quality probes",
          "num_experts": model.metrics["num_experts"],
          "expert_size": model.metrics["expert_size"]})
    if not cv["rmse"] < 2.1:
        raise AssertionError(f"airfoil 10-fold RMSE {cv['rmse']} >= 2.1")
    if launches_airfoil != cv["nfev"] + probe_airfoil or launches_airfoil == 0 \
            or probe_airfoil != len(folds):
        raise AssertionError(f"airfoil: {launches_airfoil} launches for {cv['nfev']} evaluations "
                             f"and {probe_airfoil} probes")

    # 7. airfoil-expert450: the same config at expert 450, E = 3 and
    # s = 451 on every fold, so every evaluation runs K1's workspace path
    zero(spd.spd_inv_logdet)
    cv = regression_cv(airfoil_gp(450), x, y, folds)
    launches_450 = spd.spd_inv_logdet.launches
    probe_450 = probes(spd.spd_inv_logdet)
    model = cv.pop("first_model")
    engaged["airfoil_expert450"] = [model.metrics["gram_cache_engaged"]]
    if cv["experts"] != [(3, 451)]:
        raise AssertionError(f"airfoil-expert450: (E, s) per fold {cv['experts']}")
    if not cv["rmse"] < 2.1:
        raise AssertionError(f"airfoil-expert450 10-fold RMSE {cv['rmse']} >= 2.1")
    if launches_450 != cv["nfev"] + probe_450 or launches_450 == 0 or probe_450 != len(folds):
        raise AssertionError(f"airfoil-expert450: {launches_450} launches for "
                             f"{cv['nfev']} evaluations and {probe_450} probes")
    # K1's share: one evaluation of the first fold at its fitted theta
    # under the profiler; and that fold fitted again with K1's first design
    # between two fits with K1, for the optimize seconds side by side
    train0 = folds[0][0]
    data = group_for_experts(x[train0], y[train0], 450, dtype=torch.float32, device="cuda")
    raw = model.raw_predictor
    prof = profile_objective(torch, make_value_and_grad(raw.kernel, data), raw.theta,
                             shares={"spd_inv_logdet": ("spd_inv_logdet",)})
    k1_eval = prof["kernels"]["spd_inv_logdet"]
    package_library = spd._library
    fold0 = {"kernel": [], "first_design": []}
    try:
        for key in ("kernel", "first_design", "kernel"):
            spd._library = package_library if key == "kernel" else (lambda: first_design)
            fit = copy.copy(airfoil_gp(450)).fit(x[train0], y[train0])
            fold0[key].append({k: fit.metrics[k] for k in ("optimize_seconds", "lbfgs_nfev")})
    finally:
        spd._library = package_library
    spd.spd_inv_logdet.launches = launches_450
    emit({"phase": "airfoil-expert450", **cv, "launches": launches_450,
          "probe_launches": probe_450,
          "num_experts": 3, "expert_size": 451,
          "k1_device_ms_per_eval": k1_eval["device_ms"],
          "k1_device_share": k1_eval["device_share"], "k1_wall_share": k1_eval["wall_share"],
          "k1_optimize_share_est": k1_eval["device_ms"] * cv["nfev"] / 1e3
                                   / cv["optimize_seconds"],
          "eval_profile": prof, "fold0_optimize": fold0})

    # 8. protein stand-in at full size: 45,730 x 9, 80/20 split, E = 366
    gp = (
        GaussianProcessRegression()
        .setKernel(protein_kernel)
        .setDatasetSizeForExpert(100)
        .setActiveSetSize(1000)
        .setSigma2(1e-3)
        .setMaxIter(10)
        .setSeed(13)
    )
    torch.cuda.reset_peak_memory_stats()
    zero(spd.spd_inv_logdet)
    start = time.perf_counter()
    model = gp.fit(xp[tr], yp_tr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    launches_protein = spd.spd_inv_logdet.launches
    probe_protein = probes(spd.spd_inv_logdet)
    engaged["protein"] = [model.metrics["gram_cache_engaged"]]
    pred = model.predict(xp[te]) * y_std + y_mean
    if not np.all(np.isfinite(pred)) or pred.shape != te.shape:
        raise AssertionError("protein predictions not finite")
    HOST_FITS["protein"] = {"gp": gp, "rmse": rmse(yp[te], pred),
                            "optimize_seconds": model.metrics["optimize_seconds"],
                            "nfev": model.metrics["lbfgs_nfev"]}
    emit({"phase": "protein", "fit_seconds": fit_s, "rmse": rmse(yp[te], pred),
          "launches": launches_protein, "probe_launches": probe_protein,
          "nfev": model.metrics["lbfgs_nfev"],
          **{key: model.metrics[key] for key in PHASES},
          "num_experts": model.metrics["num_experts"],
          "expert_size": model.metrics["expert_size"],
          "peak_cuda_bytes": torch.cuda.max_memory_allocated()})
    if launches_protein != model.metrics["lbfgs_nfev"] + probe_protein or launches_protein == 0 \
            or probe_protein != 1:
        raise AssertionError(f"protein: {launches_protein} launches")

    # 9. profile: where one protein objective evaluation spends its time,
    # and how much of the PPA build is the host magic solve
    raw = model.raw_predictor
    start = time.perf_counter()
    magic_solve(raw.kernel, raw.theta, raw.active, raw.u1, raw.u2)
    solve_s = time.perf_counter() - start
    data = group_for_experts(xp[tr], yp_tr, 100,
                             dtype=torch.float32, device="cuda")
    launches = spd.spd_inv_logdet.launches
    prof = profile_objective(torch, make_value_and_grad(raw.kernel, data), raw.theta,
                             shares={"spd_inv_logdet": ("spd_inv_logdet",)})
    spd.spd_inv_logdet.launches = launches
    emit({"phase": "profile", "config": "protein", "magic_solve_seconds": solve_s, **prof})

    # 10. matfree-parity at init theta on the protein-matfree stack: the
    # matrix-free objective on the card against the iterative lane on the
    # card and against the CPU in float64, all with the card's probes.
    # Bars, relative (value; gradient over its largest component): 1e-5
    # and 1e-5 against the iterative lane (the same float32 engine on the
    # same probes; only the products differ); 1e-5 and 1e-3 against the
    # CPU, whose float64 CG stopped at tol 1e-5 takes another path.
    # Recorded beside them, with no bar: the same float32 engine on the
    # card fed the plain float64 product rounded to float32 in place of
    # K2's, which says how far the engine carries a product's rounding.
    mf_kernel = matfree_kernel() + Const(1e-3) * EyeKernel()
    theta0 = mf_kernel.init_theta()
    cfg = it_ops.solver_config(4065)
    g1, g2 = it_ops.draw_probes(cfg, (9,), cfg.rank, 4065, torch.float32, "cuda")
    draw_probes, launch = it_ops.draw_probes, sm._launch
    it_ops.draw_probes = lambda cfg, batch, rank, s, dtype, device: (
        g1.to(device=device, dtype=dtype), g2.to(device=device, dtype=dtype))
    family_of = {spec.fid: name for name, spec in sm.TILE_TRANSFORMS.items()}

    def f64_product(x, v, params, spec, degree):
        return sm.streamed_matvec_plain(x.double(), v.double(), family_of[spec.fid],
                                        params.double(), degree).float()

    try:
        out = {}
        for label, lane, device, dtype in (("matfree", "matfree", "cuda", torch.float32),
                                           ("iterative", "iterative", "cuda", torch.float32),
                                           ("cpu_f64", "matfree", "cpu", torch.float64),
                                           ("f64_products", "matfree", "cuda", torch.float32)):
            it_ops.set_solver_lane(lane)
            sm._launch = f64_product if label == "f64_products" else launch
            data = (mf_data if device == "cuda" else
                    group_for_experts(xp[tr], yp_tr, 4096, dtype=dtype, device=device))
            start = time.perf_counter()
            out[label] = make_value_and_grad(mf_kernel, data)(theta0)
            out[label] += (time.perf_counter() - start,)
    finally:
        it_ops.draw_probes, sm._launch = draw_probes, launch
        it_ops.set_solver_lane(None)
    v_mf, g_mf, _ = out["matfree"]
    parity = {"value": v_mf, "grad": g_mf.tolist(),
              "seconds": {k: o[2] for k, o in out.items()}}
    bars = {"iterative": (1e-5, 1e-5), "cpu_f64": (1e-5, 1e-3)}
    for label, (bar_v, bar_g) in bars.items():
        v_ref, g_ref, _ = out[label]
        dv = abs(v_mf - v_ref) / abs(v_ref)
        dg = float(np.max(np.abs(g_mf - g_ref)) / np.max(np.abs(g_ref)))
        parity[label] = {"value": v_ref, "grad": g_ref.tolist(),
                         "rel_value_err": dv, "rel_grad_err": dg,
                         "bars": {"rel_value": bar_v, "rel_grad": bar_g}}
        if not (dv <= bar_v and dg <= bar_g):
            raise AssertionError(f"matfree vs {label}: rel dv {dv}, dg {dg}")
    v_f64p = out["f64_products"][0]
    parity["f64_products"] = {"value": v_f64p, **{
        f"rel_value_err_vs_{label}": abs(v_f64p - out[label][0]) / abs(out[label][0])
        for label in ("matfree", "iterative", "cpu_f64")}}
    emit({"phase": "matfree-parity", "theta": theta0.tolist(), **parity})

    # 11. protein-matfree: the fit on the matrix-free lane, its launches
    # (K2: iters + 2 per evaluation, K2-VJP: 2; the post-fit solver report
    # counted on its own), then the same config on the iterative and
    # exact lanes.  RMSE bars: within 2% of the iterative lane's (the same
    # surrogate objective) and 5% of the exact lane's.
    report_launches = {}
    emit_solver_stats = GaussianProcessRegression._emit_solver_stats

    def counted_emit(self, *args):
        before = (sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches)
        emit_solver_stats(self, *args)
        report_launches["streamed_matvec"] = sm.streamed_matvec.launches - before[0]
        report_launches["streamed_matvec_vjp"] = sm.streamed_matvec_vjp.launches - before[1]

    fits = {}
    for lane in ("matfree", "iterative", "exact"):
        if lane == "matfree":
            GaussianProcessRegression._emit_solver_stats = counted_emit
        try:
            zero(sm.streamed_matvec, sm.streamed_matvec_vjp)
            start = time.perf_counter()
            model = matfree_gp(lane).fit(xp[tr], yp_tr)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - start
            total = (sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches)
            total_probe = (probes(sm.streamed_matvec), probes(sm.streamed_matvec_vjp))
        finally:
            GaussianProcessRegression._emit_solver_stats = emit_solver_stats
            it_ops.set_solver_lane(None)
        pred = model.predict(xp[te]) * y_std + y_mean
        if not np.all(np.isfinite(pred)) or pred.shape != te.shape:
            raise AssertionError(f"protein-matfree ({lane}) predictions not finite")
        fits[lane] = {"rmse": rmse(yp[te], pred), "fit_seconds": fit_s,
                      **{key: model.metrics[key] for key in PHASES},
                      "nfev": model.metrics["lbfgs_nfev"],
                      "theta": model.raw_predictor.theta.tolist(),
                      **{k: v for k, v in model.metrics.items() if k.startswith("solver")}}
        if lane == "matfree":
            mf_model, mf_total, mf_probe = model, total, total_probe
            engaged["protein_matfree"] = [model.metrics["gram_cache_engaged"]]
        if lane != "exact":
            HOST_FITS[f"protein_{lane}"] = fits[lane]
    nfev = fits["matfree"]["nfev"]
    launches_k2 = mf_total[0] - report_launches["streamed_matvec"]
    launches_vjp = mf_total[1] - report_launches["streamed_matvec_vjp"]
    # the rule's probe term: the expert-quality probe's one pass, no gradient
    if launches_k2 != nfev * (cfg.iters + 2) + mf_probe[0] or launches_vjp != nfev * 2 \
            or mf_probe != (cfg.iters + 2, 0):
        raise AssertionError(f"protein-matfree: {launches_k2} K2 and {launches_vjp} "
                             f"K2-VJP launches for {nfev} evaluations and {mf_probe} probes")
    if report_launches != {"streamed_matvec": cfg.iters, "streamed_matvec_vjp": 0}:
        raise AssertionError(f"solver report launches {report_launches}")
    if fits["matfree"]["solver.matfree_engaged"] != 1.0:
        raise AssertionError("the matfree fit did not engage the matrix-free lane")

    # vjp-witness: the fit with the VJP entries of K2-VJP's first design
    # (the forward from the package's library), then the objective's
    # gradient on the matfree lane at four theta through three VJPs, all
    # on the matfree-parity probes.  Launches of this phase are not the
    # main path's: the counters are restored after it.
    package_library = sm._library
    lib = package_library()
    first_vjp = types.SimpleNamespace(
        streamed_matvec_f32=lib.streamed_matvec_f32,
        streamed_matvec_row_tile=lib.streamed_matvec_row_tile,
        streamed_matvec_vjp_f32=vjp_first.streamed_matvec_vjp_f32,
        streamed_matvec_vjp_blocks=vjp_first.streamed_matvec_vjp_blocks)
    launches = (sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches)

    def f64_vjp(x, w, v, params, spec, degree):
        return sm.streamed_matvec_vjp_plain(x.double(), w.double(), v.double(),
                                            family_of[spec.fid], params.double(),
                                            degree).float()

    launch_vjp = sm._launch_vjp
    try:
        sm._library = lambda: first_vjp
        start = time.perf_counter()
        model = matfree_gp("matfree").fit(xp[tr], yp_tr)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - start
        sm._library = package_library
        pred = model.predict(xp[te]) * y_std + y_mean
        if not np.all(np.isfinite(pred)) or pred.shape != te.shape:
            raise AssertionError("protein-matfree (first-design VJP) predictions not finite")
        first_fit = {"rmse": rmse(yp[te], pred), "fit_seconds": fit_s,
                     "nfev": model.metrics["lbfgs_nfev"],
                     "theta": model.raw_predictor.theta.tolist()}
        thetas = {"init": theta0, "midway": (theta0 + mf_model.raw_predictor.theta) / 2,
                  "fit": mf_model.raw_predictor.theta, "first_design_fit": model.raw_predictor.theta}
        it_ops.set_solver_lane("matfree")
        it_ops.draw_probes = lambda cfg, batch, rank, s, dtype, device: (
            g1.to(device=device, dtype=dtype), g2.to(device=device, dtype=dtype))
        witness = {}
        for point, theta in thetas.items():
            grads = {}
            for label in ("kernel", "first_design", "f64_vjp"):
                sm._library = (lambda: first_vjp) if label == "first_design" else package_library
                sm._launch_vjp = f64_vjp if label == "f64_vjp" else launch_vjp
                grads[label] = np.asarray(make_value_and_grad(mf_kernel, mf_data)(theta)[1])
            ref = grads["f64_vjp"]
            witness[point] = {
                "grad_f64_vjp": ref.tolist(),
                **{f"rel_grad_err_{label}": float(np.max(np.abs(grads[label] - ref))
                                                  / np.max(np.abs(ref)))
                   for label in ("kernel", "first_design")},
                **{f"grad_err_{label}": (grads[label] - ref).tolist()
                   for label in ("kernel", "first_design")}}
    finally:
        sm._library, sm._launch_vjp = package_library, launch_vjp
        it_ops.draw_probes = draw_probes
        it_ops.set_solver_lane(None)
    sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches = launches
    emit({"phase": "vjp-witness", "config": "protein-matfree",
          "kernel_fit": {key: fits["matfree"][key]
                         for key in ("rmse", "fit_seconds", "nfev", "theta")},
          "first_design_fit": first_fit, "gradients": witness})

    # peak CUDA memory of one objective evaluation at the fitted theta,
    # above what was allocated before it, on each solver lane
    peaks_eval = {}
    for lane in ("matfree", "iterative"):
        it_ops.set_solver_lane(lane)
        try:
            vag = make_value_and_grad(mf_kernel, mf_data)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            vag(mf_model.raw_predictor.theta)
            peaks_eval[lane] = torch.cuda.max_memory_allocated() - base
        finally:
            it_ops.set_solver_lane(None)
    if not peaks_eval["matfree"] < gram_stack_bytes / 4:
        raise AssertionError(f"matfree evaluation peak {peaks_eval['matfree']} bytes "
                             f">= a quarter of the {gram_stack_bytes}-byte gram stack")
    rm, ri, rx = (fits[k]["rmse"] for k in ("matfree", "iterative", "exact"))
    emit({"phase": "protein-matfree", "num_experts": mf_model.metrics["num_experts"],
          "expert_size": mf_model.metrics["expert_size"], **fits["matfree"],
          "launches": {"streamed_matvec": launches_k2, "streamed_matvec_vjp": launches_vjp,
                       "solver_report": report_launches},
          "eval_peak_cuda_bytes": peaks_eval, "gram_stack_bytes": gram_stack_bytes,
          "iterative": fits["iterative"], "exact": fits["exact"],
          "rmse_bars": {"vs_iterative": 0.02, "vs_exact": 0.05}})
    if not (abs(rm - ri) <= 0.02 * ri and abs(rm - rx) <= 0.05 * rx):
        raise AssertionError(f"protein-matfree RMSE {rm}: iterative {ri}, exact {rx}")

    # 12. matfree-profile: one matrix-free evaluation at the fitted theta
    it_ops.set_solver_lane("matfree")
    try:
        launches = (sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches)
        prof = profile_objective(torch, make_value_and_grad(mf_kernel, mf_data),
                                 mf_model.raw_predictor.theta, reps=3, shares=K2_NAMES)
        sm.streamed_matvec.launches, sm.streamed_matvec_vjp.launches = launches
    finally:
        it_ops.set_solver_lane(None)
    emit({"phase": "matfree-profile", "config": "protein-matfree", **prof})

    # 13-16. the binary classifier: gpc-parity, gpc-mnist,
    # gpc-mnist-iterative, iris-ovr
    binary = classifier_phases(torch, spd, lap, it_ops, cdata)
    launches_gpc_mnist, launches_iris = binary["launches_gpc_mnist"], binary["launches_iris"]
    # 17-19. the multiclass classifier: gpc-mc-parity, iris-native,
    # iris-native-iterative
    multiclass = multiclass_phases(torch, spd, lap_mc, it_ops, cdata)
    launches_iris_native = multiclass["launches_iris_native"]
    # 20. gram-cache
    engaged.update(binary["engaged"], **multiclass["engaged"])
    gram_cache_phase(torch, lap, cdata, binary["theta_gpc_mnist"], engaged)
    # 21-27. the Synthetics and timeseries configs, the objectives and the
    # new kernel families
    regression = regression_phases(torch, spd, rdata, smi)
    # 29-37. this slice: the greedy provider, the joint posterior, EP and
    # count regression
    slice6 = slice6_phases(torch, spd, d6, rdata, cdata, smi)
    # 37-42. slice 7: PoE aggregation, fit-time selection, quarantine,
    # the weighted matrix-free objective
    slice7, k2_weighted = slice7_phases(torch, spd, d7, data_main, mf_data, smi)
    # 43-49. slice 8: obs, profile, ladder-oom, memplan, predict-ladder,
    # terminal
    slice8 = slice8_phases(torch, spd, sm, it_ops, data_main, mf_data, rm, smi)
    # 50-55. slice 9: persist, checkpoint, serve, serve-cli, serve-hang
    slice9 = slice9_phases(torch, spd, data_main, smi)
    # 56-63. slice 10: the on-device optimizer
    slice10 = slice10_phases(torch, spd, data_main, rdata, HOST_FITS, smi)
    # 64-73. slice 11: the device fits of the Laplace families
    slice11 = slice11_phases(torch, spd, cdata, d6, HOST_FITS, smi)
    # 74-87. slice 12: the device optimizer on the CG lanes and for EP (its
    # phases zero the wrappers' counters and record each phase's launches)
    quad_before = sq.slq_quadrature.launches
    slice12 = slice12_phases(
        torch, spd, sm, sq, it_ops, cdata, d6, data_main, mf_data, rm,
        {"gpc_mnist_b": b_stacks["gpc_mnist"], "poisson_b": stacks["poisson_b"],
         "iris_b": b_stacks["iris_fold"]}, HOST_FITS, smi)
    quad = slice12["slq_quadrature"]
    l12 = slice12["launches"]
    # 88-99. slice 14: the device magic solve at m = 4096 and the precision
    # lanes (K1's launches on each phase's fits; the lane kernel's)
    slice14 = slice14_phases(torch, spd, lg, data_main, rdata, smi)
    # 100-103. slice 15: cost attribution and the statistical quality plane
    # (each phase's launches, all five kernels)
    slice15 = slice15_phases(torch, spd, sm, sq, lg, data_main, mf_data, cdata, smi)
    s15 = slice15["launches"]
    # 104-105. slice 16: the mesh phases, each rank a child process (each
    # kernel's launches in each child)
    mesh = mesh_phases(airfoil_thetas, airfoil_rmse, smi)

    # 56. kernels: K1 at the protein stack, then at the airfoil fold's, on
    # the workspace path and at the classifiers' B stacks, launches over
    # the three exact-lane regression fits and the three classifier runs; K2
    # at a CG step's width (n = 9) and K2-VJP at the surrogate leg's
    # (n = 8), launches over the protein-matfree fit (optimization and
    # solver report).  Each error is the RBF map's (the path's) at the
    # shape its entry names.
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k2_rows, vjp_rows = k2_timing["streamed_matvec"], k2_timing["streamed_matvec_vjp"]

    def leg(rows, n, err, extra=()):
        return {"shape": [9, 4065, 9, n], **{key: rows[f"n{n}"][key] for key in keys + extra},
                "max_abs_err": k2_errs[f"slice/n{n}/rbf"][err]}

    # registers and spill bytes of the VJP's instances at the path's widths
    vjp_ptxas = {key: value for key, value in
                 ptxas_usage(built["streamed_matvec"][1], *VJP_PTXAS).items()
                 if key.endswith(("/NB1", "/NB8"))}

    kernels = [{
        "name": "spd_inv_logdet",
        "route": "cuda",
        "source": "spark_gp_tpu_torch/csrc/spd_inv_logdet.cu",
        "replaces": "spark_gp_tpu/ops/pallas_linalg.py:228",
        "launches": (launches_airfoil + launches_protein + launches_450
                     + launches_gpc_mnist + launches_iris + launches_iris_native
                     + sum(regression.values()) + sum(slice6.values())
                     + sum(slice7.values()) + sum(slice8["spd_inv_logdet"].values())
                     + sum(slice9.values()) + sum(slice10.values())
                     + sum(slice11.values()) + sum(l12["spd_inv_logdet"].values())
                     + sum(slice14["k1"].values()) + sum(s15["spd_inv_logdet"].values())
                     + sum(mesh["spd_inv_logdet"].values())),
        "launches_airfoil": launches_airfoil,
        "launches_protein": launches_protein,
        "launches_airfoil_expert450": launches_450,
        "launches_gpc_mnist": launches_gpc_mnist,
        "launches_iris": launches_iris,
        "launches_iris_native": launches_iris_native,
        **{f"launches_{key}": value for key, value in regression.items()},
        **{f"launches_{key}": value for key, value in slice6.items()},
        **{f"launches_{key}": value for key, value in slice7.items()},
        **{f"launches_{key}": value for key, value in slice8["spd_inv_logdet"].items()},
        **{f"launches_{key}": value for key, value in slice9.items()},
        **{f"launches_{key}": value for key, value in slice10.items()},
        **{f"launches_{key}": value for key, value in slice11.items()},
        **{f"launches_{key}": value for key, value in l12["spd_inv_logdet"].items()},
        **{f"launches_{key}": value for key, value in slice14["k1"].items()},
        **{f"launches_{key}": value for key, value in s15["spd_inv_logdet"].items()},
        **{f"launches_{key}": value for key, value in mesh["spd_inv_logdet"].items()},
        "max_abs_err": max(errs["airfoil_fold"], errs["protein"]),
        "shape": [366, 100],
        **{key: timing["protein"][key] for key in keys + ("first_design_ms",)},
        "airfoil_fold": {"shape": [14, 97], "max_abs_err": errs["airfoil_fold"],
                         **{key: timing["airfoil_fold"][key]
                            for key in keys + ("first_design_ms",)}},
        "workspace_kernel": {label: {"shape": timing[label]["shape"], "max_abs_err": errs[label],
                                     **{key: timing[label][key]
                                        for key in keys + ("first_design_ms",)}}
                             for label in ("2x256", "1x512", "airfoil_expert450",
                                           "protein_expert400")},
        "gpc_b_stacks": {label: {"shape": timing[label]["shape"], "max_abs_err": gpc_errs[label],
                                 **{key: timing[label][key]
                                    for key in keys + ("first_design_ms",)}}
                         for label in b_stacks},
        "regression_stacks": {label: {"shape": timing[label]["shape"], "max_abs_err": errs[label],
                                      **{key: timing[label][key]
                                         for key in keys + ("first_design_ms", "wall_ms")}}
                              for label in ("synthetics_fold", "synthetics_all", "timeseries")},
        "slice6_stacks": {label: {"shape": timing[label]["shape"], "max_abs_err": errs[label],
                                  **{key: timing[label][key]
                                     for key in keys + ("first_design_ms", "wall_ms")}}
                          for label in ("ep_iris_b", "poisson_b", "year_msd")},
        "slice7_stacks": {label: {"shape": timing[label]["shape"], "max_abs_err": errs[label],
                                  **{key: timing[label][key]
                                     for key in keys + ("first_design_ms", "wall_ms")}}
                          for label in ("clustered", "heteroscedastic", "quarantine_probe")},
        "loo_cotangent_max_abs_err": loo_cotangent["max_abs_err"],
        "checked": True,
    }, {
        "name": "streamed_matvec",
        "route": "cuda",
        "source": "spark_gp_tpu_torch/csrc/streamed_matvec.cu",
        "replaces": "spark_gp_tpu/ops/pallas_matvec.py:211",
        "launches": (launches_k2 + report_launches["streamed_matvec"]
                     + k2_weighted["streamed_matvec"]
                     + sum(slice8["streamed_matvec"].values())
                     + sum(l12["streamed_matvec"].values())
                     + sum(s15["streamed_matvec"].values())
                     + sum(mesh["streamed_matvec"].values())),
        "launches_optimize": launches_k2,
        **{f"launches_{key}": value for key, value in slice8["streamed_matvec"].items()},
        **{f"launches_{key}": value for key, value in l12["streamed_matvec"].items()},
        **{f"launches_{key}": value for key, value in s15["streamed_matvec"].items()},
        **{f"launches_{key}": value for key, value in mesh["streamed_matvec"].items()},
        "launches_weighted_matfree": k2_weighted["streamed_matvec"],
        "launches_solver_report": report_launches["streamed_matvec"],
        **leg(k2_rows, 9, "matvec"),
        "max_rel_err_all_checks": max(e["matvec_rel"] for e in k2_errs.values()),
        "legs": {f"n{n}": leg(k2_rows, n, "matvec") for n in (1, 8)},
        "checked": True,
    }, {
        "name": "streamed_matvec_vjp",
        "route": "cuda",
        "source": "spark_gp_tpu_torch/csrc/streamed_matvec.cu",
        "replaces": "spark_gp_tpu/ops/pallas_matvec.py:133",
        "replaces_note": "no Pallas kernel: XLA differentiates the checkpointed scan",
        "launches": (launches_vjp + k2_weighted["streamed_matvec_vjp"]
                     + sum(slice8["streamed_matvec_vjp"].values())
                     + sum(l12["streamed_matvec_vjp"].values())
                     + sum(s15["streamed_matvec_vjp"].values())
                     + sum(mesh["streamed_matvec_vjp"].values())),
        "launches_weighted_matfree": k2_weighted["streamed_matvec_vjp"],
        **{f"launches_{key}": value for key, value in slice8["streamed_matvec_vjp"].items()},
        **{f"launches_{key}": value for key, value in l12["streamed_matvec_vjp"].items()},
        **{f"launches_{key}": value for key, value in s15["streamed_matvec_vjp"].items()},
        **{f"launches_{key}": value for key, value in mesh["streamed_matvec_vjp"].items()},
        **leg(vjp_rows, 8, "vjp", ("first_design_ms", "wall_ms")),
        "max_rel_err_all_checks": max(e["vjp_rel"] for e in k2_errs.values()),
        "legs": {"n1": leg(vjp_rows, 1, "vjp", ("first_design_ms", "wall_ms"))},
        "first_design_source": f"spark_gp_tpu_torch/csrc/{VJP_FIRST_DESIGN}.cu",
        "ptxas_registers_spill_bytes": vjp_ptxas,
        "checked": True,
    }, {
        "name": "slq_quadrature",
        "route": "cuda",
        "source": "spark_gp_tpu_torch/csrc/slq_quadrature.cu",
        "replaces": "spark_gp_tpu/ops/iterative.py:510",
        "replaces_note": "no Pallas kernel: XLA's eigh in slq_logdet_from_coeffs, which "
                         "torch.linalg.eigh cannot replace inside a captured step",
        "launches": (quad_before + sum(l12["slq_quadrature"].values())
                     + sum(s15["slq_quadrature"].values())
                     + sum(mesh["slq_quadrature"].values())),
        "launches_before_slice12": quad_before,
        **{f"launches_{key}": value for key, value in l12["slq_quadrature"].items()},
        **{f"launches_{key}": value for key, value in s15["slq_quadrature"].items()},
        **{f"launches_{key}": value for key, value in mesh["slq_quadrature"].items()},
        "shape": quad["protein_matfree"]["shape"],
        **{key: quad["protein_matfree"][key]
           for key in keys + ("first_design_ms", "rotations", "steps")},
        "first_design_source": f"spark_gp_tpu_torch/csrc/{SLQ_FIRST_DESIGN}.cu",
        "max_abs_err": max(r["max_abs_err"] for r in quad.values()),
        "inputs": quad,
        "checked": True,
    }, {
        "name": "lane_gram",
        "route": "cuda",
        "source": "spark_gp_tpu_torch/csrc/lane_gram.cu",
        "replaces": "spark_gp_tpu/ops/distance.py:63",
        "replaces_note": "no Pallas kernel: XLA's contractions of the mixed lane's "
                         "_inner_compensated (the fast lane's _inner, distance.py:47, is the "
                         "kernel's tf32 mode); the lane is an argument of the launch",
        "launches": (sum(slice14["lane_gram"].values()) + sum(s15["lane_gram"].values())
                     + sum(mesh["lane_gram"].values())),
        **{f"launches_{key}": value for key, value in slice14["lane_gram"].items()},
        **{f"launches_{key}": value for key, value in s15["lane_gram"].items()},
        **{f"launches_{key}": value for key, value in mesh["lane_gram"].items()},
        "shape": slice14["timing"]["airfoil_ard_self"]["shape"],
        "mode": "3xtf32",
        **{key: slice14["timing"]["airfoil_ard_self"][key] for key in keys},
        "max_abs_err": max(slice14["errs"].values()),
        "max_abs_err_note": f"over max|x1|^2 + max|x2|^2 (bar {LANE_GRAM_BAR})",
        "inputs": slice14["timing"],
        "checks": slice14["errs"],
        "checked": True,
    }]
    # the totals beside the ones before the probe, and the probes' share
    from spark_gp_tpu_torch.resilience.quarantine import PROBE_LAUNCHES

    emit({"phase": "launch-totals", "card": smi, "kernels": {
        k["name"]: {"launches": k["launches"], "before_probe": LAUNCH_TOTALS_BEFORE[k["name"]],
                    "probe_launches": PROBE_LAUNCHES.get(k["name"], 0.0)
                    - probe_start.get(k["name"], 0.0),
                    "probe_share": (PROBE_LAUNCHES.get(k["name"], 0.0)
                                    - probe_start.get(k["name"], 0.0)) / k["launches"]}
        for k in kernels}})
    # every kernel of the path ran on it
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
