#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``evox_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
``nvcc`` and PyTorch built for CUDA::

    python3 chip_smoke.py [--out PATH] [--profile]

Phases (each raises on failure; nothing is caught so the run could still
exit 0):

1. device: the card's name and power limit (nvidia-smi); build every CUDA
   source of the port from the checkout (one nvcc per source, in parallel).
2. kernels against plain: ``fused_rollout`` against
   ``fused_rollout_plain`` — pendulum at pop 65536, 2 episodes, T 200 (the
   first main path's shape), wide-angle pendulum stress (th in ±1e3) at
   pop 65536, 1500 and an odd episode count, and cartpole (early exit) at
   pop 8192 and 1500 (ragged edge), T 500; every libdevice function the
   rollout kernel reaches in another form (``sincosf``, ``tanhf`` without
   its clamp) against the original over all 2^32 inputs; acrobot on main
   path 12's first-generation inputs (pop 65536, 2 episodes, T 500) and at
   n 1500 with 3 episodes, mountain car at pop 65536 x 2 x T 999 and at n
   1500, both at n 8192 and 1500 with every other env on the brink of done
   (pos 0.44, vel 0.07; t1 2.8), where done must fire in at least half the
   brink envs, and all four envs at hidden 8 (n 1500); ptxas's registers
   and spills and the runtime's blocks an SM of all eight (env, hidden)
   instances;
   ``packed_dominance`` against
   ``packed_dominance_reference`` on the second main path's first merged
   fitness (n 20000, m 3) and on stress inputs (m 2, 3, 4, 5, 8, 16, 32
   against n 1, 31, 32, 33, 1000, 20001, with ties, duplicates, ±inf, NaN
   and ±0.0); ``partial_topk`` against
   ``partial_topk_reference`` on that path's cut key (n 20000, k 10000), at
   every shape of the top-k sweep (n 1000 to 2**24 + 1, k 1, 100, n/10,
   n/2, n; the value laws of ``topk_values``; one k at 2**24 + 1), on
   all-equal inputs, at n 1 to 100 and on both sides of each route's
   limit;
   ``fused_mlp_rollout`` against ``fused_mlp_rollout_plain`` on the third
   main path's first-generation inputs (pop 65536, MLP 244-64-64-17, T
   100) and on stress inputs (large
   weights, envs pushed to fall, explode, start done or run out of time; a
   ragged n of 1500 with 2 episodes; a low-rank ``linear=(0,)`` policy;
   the 7-mass walker; widths whose dot products split raggedly; a policy
   whose block is one warp); at bf16 policy residency, the same on main
   path 13's first-generation inputs and on the same stress inputs. All bit
   for bit, NaN returns by bit pattern, and a non-finite return only where
   the env exploded. Times each kernel and its plain version with CUDA
   events, and ``torch.topk`` beside ``partial_topk`` (also at n 1e6, k
   n/2, with an empty launch's time as the floor). Records the block
   shape of the rollout, dominance and walker kernels (instance, threads,
   blocks an SM, planned and as the runtime reports it) and ptxas's
   registers and spills of each of their instances, and fails if any
   rollout, dominance or topk instance, or the walker's main one, spills,
   or if the main paths' instances fit fewer blocks an SM than their
   plans.
3. main path 1: ``StdWorkflow(OpenES(zeros(81), 65536),
   PolicyRolloutProblem(flat_mlp_policy 3-16-1, pendulum(200), 2 episodes,
   fused_env=pendulum_soa(200)), opt_direction="max")`` — init, one
   warm-up step, then ``run`` for 20 generations with every launch counter
   set to 0 just before and read just after. Checks one rollout launch per
   generation, finite fitness, a center that moved, and the fused engine
   against the scan engine on a small population. Then main path 12, the
   same with acrobot: ``StdWorkflow(OpenES(zeros(163), 65536),
   PolicyRolloutProblem(flat_mlp_policy 6-16-3, acrobot(500), 2 episodes,
   fused_env=acrobot_soa(500)))``, driven and checked as path 1 (the
   engines at T 100), with the mean live steps an env of the last
   population; the mountain car phase, the same with mountain_car(999),
   2-16-1, for 5 generations; and the normaliser phase: the scan engine
   with ``CapEpisode(200)`` and ``ObsNormalizer`` on cartpole(500) (pop
   4096, 2 episodes, 3 evaluations) on the card, then ``CapEpisode.update``,
   ``ObsNormalizer.merge_moments`` and ``normalize`` on the card against
   the CPU on the card's own episode lengths and moments.
4. main path 2: ``StdWorkflow(NSGA2(*LSMOP1(d=300, m=3).bounds(), n_objs=3,
   pop_size=10000, use_kernel=True), LSMOP1(d=300, m=3))`` — init step,
   one warm-up generation, then ``run`` for 20 generations, counters as
   above. Checks one ``packed_dominance`` and one ``partial_topk`` launch
   per generation, finite fitness, a population within bounds; one
   ``tell`` on the card against the same ``tell`` on the CPU's plain
   routes (survivors and ranks equal); ``partial_topk`` on that late
   generation's cut key against its plain version; the lexsort truncation
   against the
   partial-top-k one (same survivor set). Reports ms per generation, the
   fronts peeled per generation and a per-stage breakdown of a generation.
5. main path 3: ``StdWorkflow(OpenES(zeros(20945), 65536),
   PolicyRolloutProblem(mlp_policy 244-64-64-17, chain_walker(100), 1
   episode, fused_planes=chain_walker_planes(100)), opt_direction="max",
   pop_transforms=(TreeAndVector.batched_to_tree,),
   fit_transforms=(rank_based_fitness,))`` — init, one warm-up step, then
   ``run`` for 20 generations, counters as above. Checks one
   ``fused_mlp_rollout`` launch per generation and no other, fitness finite
   or non-finite only where the env exploded, a center that moved, and the
   fused engine against the scan engine on 512 genomes near the center at
   T 25. Reports ms per generation, evals/s and the mean episode length.
   Then main path 13, path 3 with ``fused_planes_dtype=torch.bfloat16``
   (bf16 policy residency), driven and checked as path 3 (the engines on
   genomes rounded to bfloat16), and both residencies in turns (f32, bf16,
   bf16, f32: ms a generation over 10 generations, B2's ms by CUDA events,
   peak device memory).
6. main path 4: ``StdWorkflow(CSO(lb=-32·1, ub=32·1, pop 4096, d 1024),
   Ackley())`` (``bench.py:134-185``, no monitor, as there) — init, the
   init step (everyone evaluated) and one warm-up generation, then ``run``
   for 20 generations, counters as above (no kernel runs). Checks the
   population within bounds and finite fitness; reports ms per generation,
   generations/s and evals/s (pop/2 a generation), and times the replay
   form of ``tell`` (the JAX package's) against the carried one in five
   rounds of turns, equal bit for bit. Then the same run with
   ``EvalMonitor(topk=8)`` from a fresh state: one ``partial_topk`` launch
   a generation, the best fitness falling, the last elite update equal to
   the plain route (indices, values, solutions), and ``partial_topk`` timed
   at the monitor's shapes (n 2048 + k, k 1 and 8) beside ``torch.topk``
   (CUDA events, device time, host time). One CSO generation on the card
   against the CPU on the same draws (positions and velocities bit for bit,
   fitness within 1e-5 relative). PSO, CLPSO, SLPSOGS, SLPSOUS, FIPS
   (ring), DMS-PSO-EL, FSPSO and SwmmPSO (with and without shortcuts) for
   10 generations each on Sphere (pop 1024, d 100) with an EvalMonitor.
   Between paths 2 and 3: the EvalMonitor Pareto archive (pf_capacity 1024)
   over two NSGA-II batches of 10000 on the card (``packed_dominance`` at n
   11024) against the CPU's plain route, rows, order and ``pf_count``
   equal.
7. main path 5: ``StdWorkflow(CMAES(full(1000, 3.0), init_stdev=1.0),
   Rastrigin())``, pop 24 and ``decomp_per_iter`` 8 at their defaults —
   init, one warm-up step and one untimed ``safe_eigh`` (cuSOLVER's first
   call sets it up), then ``run`` over 3 whole decomposition periods (24
   generations), counters as above (no kernel runs). Checks finite
   fitness, a finite and symmetric covariance, a mean that moved and one
   eigendecomposition a period; reports ms per generation, generations/s,
   one ``safe_eigh`` at d 1000 (CUDA events and the host's clock) and a
   split of a generation (ask, Rastrigin, tell, eigh). One CMA-ES
   generation on the card against the CPU (the same draws, fitness and
   (B, D); mean, C, ps, pc and sigma within 1e-4 relative), run on the card
   with TF32 allowed and not (equal bit for bit: its products are full
   float32 either way).
8. main path 6: main path 3 with ``PGPE(pop_size=65536,
   center_init=zeros(20945))`` (ClipUp) in OpenES's place, driven and
   checked as path 3 (one ``fused_mlp_rollout`` launch a generation and no
   other, a center that moved, fused against scan engine); the tell's one
   redraw of delta timed.
9. the rest of the ES family, 10 generations each on Sphere (pop 1024,
   ESMC 1025, d 100) with an EvalMonitor: SepCMAES, IPOPCMAES, MAES,
   LMMAES, RMES, XNES, SeparableNES, SNES, CR_FM_NES, ARS, ASEBO,
   GuidedES, PersistentES, NoiseReuseES, ESMC, DES, AMaLGaM and
   IndependentAMaLGaM, and LES with its bundled meta-trained parameters.
   ARS's tell launches ``partial_topk`` once a
   generation (n 512, k 51) beside the monitor's: its last tell equals a
   tell on the plain route, and B4 at that shape is timed beside
   ``torch.topk``. ``RestartCMAESDriver`` for 2 restarts (pop 17, then 34).
10. main path 7: ``StdWorkflow(MOEAD(zeros(12), ones(12), n_objs=3,
   pop_size=10000, aggregate_op="pbi"), DTLZ2(d=12, m=3))`` (9870
   subproblems, T 20, max_replace 4) — the constructor and its (9870, 20)
   neighbour table timed, the table built on the CPU too (equal element
   for element); init, the init step, one warm-up generation, then ``run``
   for 20 generations, counters as above (no kernel runs). Checks, after
   the run, finite fitness and a population within the bounds; reports ms
   a generation, generations/s, a split (ask, DTLZ2, tell), IGD against ``DTLZ2.pf()``
   and the exact hypervolume at (1.1, 1.1, 1.1); one tell on the card
   against the CPU (the same replacement decisions; population and fitness
   bit for bit where they agree, the deciding aggregation values printed
   where they do not).
11. main path 8: ``StdWorkflow(NSGA3(zeros(7), ones(7), n_objs=3,
   pop_size=10000), DTLZ1(d=7, m=3))`` (9870 reference points, merged n
   19740) — driven and reported as path 7, with one ``packed_dominance``
   launch a generation and the fronts peeled a generation; B3 at n 19740
   against its plain version; the split adds B3, the sort to the cut
   against the full peel, the normalisation and association, the
   closed-form niching and the sequential loop (once, equal); one
   selection on the card against the CPU (survivors and ranks equal).
12. the MO family: MOEADDRA, MOEADM2M, EAGMOEAD, RVEA, RVEAa, TDEA and
   LMOCSO, 10 generations each on DTLZ2(d=12, m=3) at pop 1000 requested
   (990 vectors; B3 once a generation in MOEADM2M's, TDEA's and EAGMOEAD's
   tells), ms a generation and IGD; DTLZ1-7 on the card against the CPU at
   pop 9870, and DTLZ7's ``pf()`` (one B3 launch) against the CPU's.
13. main path 9: ``StdWorkflow(SHADE(lb=-32·1, ub=32·1, pop 4096, d 1024,
   memory_size 100), Ackley())`` (``bench.py:134-185``'s Ackley workload
   at path 4's shape) — init, the init step and one warm-up generation,
   then ``run`` for 20 generations, counters as above: one
   ``partial_topk`` launch a generation (SHADE's pbest cut, n 4096, k 819)
   and no other. Checks the population within bounds, finite fitness and a
   best that did not rise, the cut on the card against a stable argsort,
   B4 at (4096, 819) against its plain version and beside ``torch.topk``;
   reports ms a generation, generations/s, evals/s (pop a generation) and
   a split (ask, Ackley, tell). One SHADE generation on the card against
   the CPU from that state, on the same draws and the same fitness handed
   to both tells (pbest rows, trials, population, fitness, archive, its
   size, the memory position, F, CR and the attribution bit for bit; M_F
   and M_CR within 1e-4 relative).
14. the DE family: DE (rand/1 and best/2), ODE, CoDE (3·pop evaluations a
   generation), SaDE, JaDE and SHADE, 10 generations each on Sphere (pop
   1024, d 100), launches counted (JaDE's and SHADE's pbest cut: one B4
   launch a generation), ms a generation and the best fitness; JaDE's cut
   (n 1024, k 51) against the plain route and beside ``torch.topk``. CEC
   2022 F1-F12 at d 2, 10 and 20 (F6-F8 at 10 and 20) on the card against
   the CPU at 1024 points each, and each member at its optimum.
15. main path 10: ``StdWorkflow(GDE3(*LSMOP1(d=300, m=3).bounds(),
   n_objs=3, pop_size=10000, F=0.5, CR=0.3), LSMOP1(d=300, m=3))`` (path
   2's shape) — driven and reported as path 7, with one
   ``packed_dominance`` launch a generation (n 20000 in ``non_dominate``);
   the split adds the pre-selection, B3, the sort to the cut and the whole
   ``non_dominate``; B3 at the merged fitness (``+inf`` rows included)
   against its plain version; one tell on the card against the CPU's plain
   routes, on a told fitness that pushes 100 parents and 100 trials to
   ``+inf`` (population and fitness, in order, bit for bit). Main path 11:
   ``StdWorkflow(IBEA(zeros(12), ones(12), n_objs=3, pop_size=10000,
   kappa=0.05), DTLZ2(d=12, m=3))`` — 6 timed generations, no kernel
   launch; the split adds the (20000, 20000) indicator terms and the
   10000-removal loop, with the launches a removal makes (profiler) and
   its host time; one selection's fast loop against the step-by-step loop
   on the card (survivors equal) and against the CPU (terms within 1e-5,
   survivors and removal order equal).
16. the indicator and knee family: IBEA, SRA, BCE-IBEA, SPEA2, HypE, KnEA
   and BiGE, 10 generations each on DTLZ2(d=12, m=3) at pop 1000, B3
   launches checked (HypE and KnEA 1 a generation, BiGE 3, BCE-IBEA 1 on
   even generations, the others 0), ms a generation, the split, each
   selection's sequential loop timed alone, IGD; MaF1-15 at m 3 and 5 on
   the card against the CPU at pop 10000, and MaF11's ``pf()`` (one B3
   launch each) against the CPU's.
17. main path 14: ``IslandWorkflow(PSO(±32, d 256, pop 512), Ackley(),
   n_islands=8, migrate_every=8)`` (``bench.py:405-456``, seed 5) and its
   panmictic twin ``StdWorkflow(PSO(±32, d 256, pop 4096), Ackley())`` in
   turns (islands, panmictic, panmictic, islands; 16 generations each, two
   migration periods, after a warm-up period), counters as above: one
   ``partial_topk`` launch a migration on the islands (one batched launch
   over the 8 islands, k 1), none on the twin. Reports ms a generation and
   evaluations/s of each and their ratio, a migrating generation against
   one without on the host's clock, and (``--profile``) both idle shares.
   B4's batched launch against its plain version, bit for bit, at the
   migration's input and at (8, 512, 1), (8, 512, 4), (4, 2000, 4), (64,
   2049, 8), (3, 20000, 10000) and (3, 30000, 15000) (the large route, a
   launch sequence a row) on stress rows (ties, NaN, ±0.0, ±inf, +inf
   rows, an all-equal row), one launch a call on the small route; timed at
   (8, 512, 1) against ``torch.topk(dim=1)`` and against 8 one-row
   launches. One migrating generation on the card against the CPU (the
   same draws; positions, velocities, bests and elites bit for bit,
   fitness within 1e-6 relative).
18. main path 15: ``docs/GUIDE.md:504-520``'s IPOP-CMA-ES at path 5's
   shape, ``StdWorkflow(GuardedAlgorithm(CMAES(zeros(1000), 1.0, pop 24),
   stagnation_limit=80), Rastrigin()).run(state, N, restarts=IPOPRestarts(
   factory, max_restarts=4, check_every=100))`` for 200 generations in two
   calls, C, B and D poisoned with NaN between them (after generation 40):
   one restart at the next tell, one doubling (24 to 48) at generation
   100, a whole segment at 48; ms a generation a segment, the events, peak
   device memory, and guarded against bare CMA-ES in turns. Then the
   containers phase (ClusteredAlgorithm(CSO), VectorizedCoevolution and
   Coevolution of PSO over 8 blocks of 128 on Ackley at d 1024,
   RandomMaskAlgorithm through a mask change, TreeAlgorithm over a
   two-leaf dict; each on the card against the CPU on the same draws,
   states bit for bit; clusters and blocks stacked, one member call) and
   the MO islands phase (4 stacked NSGA-II islands, pop 1000, on DTLZ2:
   one batched B3 launch a tell, one for the elites and one for the
   migrate a migration, one batched B4 cut a steady tell; the elites and
   one migrating generation's tell and migration held against the CPU).
19. main path 16: ``bench.py:613-707``'s workload 6,
   ``StdWorkflow(PSO(±5, pop 2048, d 512), _HostEvalSphere())`` (numpy
   ``sum(x²)`` after a 4 ms sleep, seed 13), through ``run_host_pipelined``
   (the executor: pinned copies, the host evaluation inline, hook lanes)
   and through ``bench.py``'s serialized ask, evaluate, tell loop in turns
   (piped, serial, serial, piped; 40 generations each after 3 warm): ms a
   generation, the device halves' CUDA-event time, the host evaluation,
   ``overlap_efficiency``, the copies' bytes and ms, the executor's report;
   10 pipelined generations equal 10 ``wf.step`` generations bit for bit,
   also with ``eval_chunk=500``; one host-evaluated generation on the card
   against the CPU. Main path 17: ``bench.py:157-196``'s workload 1b, path
   4's CSO with ``dtype_policy=BF16_STORAGE, donate_carries=True`` against
   float32 (turns bf16, f32, f32, bf16; 20 generations each): ms a
   generation, evaluations/s, the carried bytes, peak memory, the casts'
   device time, the best fitness, every field's dtype after ``step`` and
   ``run``; CMA-ES at path 5's shape keeps its strategy float32. Main path
   18: path 2's NSGA-II for 30 generations from ``init`` under
   ``WorkflowCheckpointer(every=10, keep=3)``, twice (bit for bit: the run
   reproduces itself; one B3 launch a generation, one B4 launch a tell),
   with and without the checkpointer in turns; the gen-30 snapshot deleted
   and the gen-20 manifest torn, ``latest()`` falls back to gen 10 with a
   warning; with gen 20 restored, a fresh workflow's ``resume`` equals the
   straight run bit for bit; a workflow at pop 9998 is refused.
20. main path 19: ``bench.py:904-1059``'s workload 8,
   ``SurrogateWorkflow(PSO(±5, pop 64, d 8), _SleepySphere(),
   surrogate=GPSurrogate(), screen_frac=0.125, warmup=64, refit_every=1,
   rank_floor=0.3, monitors=(TelemetryMonitor(capacity=4),))`` (a numpy
   ``sum(x²)`` after a 2 ms sleep a row, seed 31; archive 256) and its
   full-evaluation twin ``StdWorkflow`` on the same PSO, problem and
   monitor, from the state after 3 warm generations, ``run`` (the
   executor's host pipeline) in turns (screened, full, full, screened; 8
   generations each): ms a generation and their ratio, the problem's rows
   against the ledger (equal; 8 a screened generation), the executor's
   ``bg_refit`` (one a generation) and each refit's CUDA-event ms, host
   copies a generation (``--profile``), ``surrogate_report`` and
   ``TelemetryMonitor.report`` as strict-JSON lines; the sleep-free ledger
   at pop 128 (seed 3, runs of 2 to a best under 1e-2, at most 120
   generations): generations, true evaluations and their ratio, the JAX
   test's ≥ 5× printed beside it; one screened generation on the card
   against the CPU on the same draws (the row count and the screened rows
   in order equal, archive and PSO state bit for bit, the refitted GP's
   scales within 1e-3 and its posterior within 1e-2). The GP phase:
   ``GPSurrogate`` at its bound (capacity 2048, d 64, 1536 live rows) on
   the card against the CPU (mean and deviation at 512 points within
   1e-2, Spearman of the two orders), fit and predict by CUDA events with
   their kernels; ``EnsembleSurrogate.fit`` on that archive (ms and kernel
   launches a refit); path 19's screened side with ``EnsembleSurrogate()``
   for 10 generations. Main path 20: ``StdWorkflow(IMMOEA(zeros(12),
   ones(12), n_objs=3, pop_size=1000), DTLZ2(d=12, m=3))`` (3 clusters of
   333: pop 999) driven as path 7, one ``packed_dominance`` launch a
   generation (n 1998) and no other; IGD, the hypervolume, a split (the
   clusters, the batched GP fits, sampling, mutation, DTLZ2, tell, B3,
   the sort to the cut, ``non_dominate``), the GP fit's kernels; B3 at the
   merged fitness against its plain version; one ask on the card against
   the CPU on CPU-made draws (offspring within 2e-3, mean 1e-4) and one
   tell (population and fitness bit for bit).
21. main path 21: ``bench.py:1452-1523``'s run-telemetry leg,
   ``StdWorkflow(PSO(±32, pop 256, d 64), Ackley(),
   monitors=(TelemetryMonitor(capacity=30),), donate_carries=True)`` under
   ``instrument(wf, analyze=True, block_dispatch=True)``, seed 11: run 30,
   run 30, run 300, three steps (each run under ``RunSupervisor(
   deadline_s=600, max_retries=2)``, as bench's leg), the fetch of
   ``gbest_fitness``, ``run_report`` and
   ``write_chrome_trace`` (``chiprun_out/telemetry_trace.json``): both
   pass ``tools/check_report.py``, ``run``'s ``per_work_s`` is the
   differenced slope, the generation is 363, the final state equals an
   uninstrumented run's bit for bit (also after the report's analysis);
   ms a generation with the recorder and without it in turns (recorder,
   plain, plain, recorder). Main path 22: path 2 under ``instrument(wf,
   analyze=True, block_dispatch=True)``, runs of 4 and 8 generations (one
   B3 and one B4 launch a generation); the report's analysis of ``step``
   and ``run`` charges one B3 launch of ``dominance_work(20000, 3)`` and
   one B4 launch of ``topk_work(20000, 10000)`` each, and the report
   validates; the roofline's classification and achieved rates.
22. main path 23: stale tells on workload 6's host Sphere and shapes
   (pop 2048, d 512, 4 ms, seed 13) under OpenES, ``run_host_pipelined(
   max_staleness=K)`` at K 0, 1, 2 in turns (ms a generation, stale tells,
   the largest lag and window, ``overlap_efficiency``, the copies), K 0
   against a ``wf.step`` loop bit for bit, and JAX's staleness gate (OpenES
   d 8, pop 64, 2 ms, 150 generations at K 1 and 2: f(center) < 0.05, more
   than 100 stale tells, lag in [1, K], the report valid). Main path 24:
   path 14 with a host Ackley (``external_problem=True``) against the
   device problem, checkpointed every 8 for 32 generations with a crash and
   a resume, and bf16 storage with donated carries in turns with float32,
   all bit for bit where stated, one batched B4 launch a migration. Main
   path 25: ``bench.py``'s workload 12, path 4's CSO through
   ``GenerationExecutor(metrics=FlightRecorder(directory=tmp)).run_fused``
   in chunks of 100 with a fsynced sample a chunk against ``metrics=None``
   (trip counts 100 and 400 differenced, in turns): the stream and the
   report validate, the states are equal. Main path 26: workload 12b,
   ``StateAttestor(every=10, capacity=64)`` against bare ``wf.run`` the same
   way; D1 (``csrc/digest.cu``) once an attestation, each ring digest equal
   to ``host_state_digest``, D1 against its plain version on CSO's state,
   on stress leaves and on a chained state, bit for bit; ``run_fused(
   verify_every=1)`` healing a lying dispatch, three distinct digests
   raising ``IntegrityError``, ``bisect_divergence`` naming a flipped
   generation. Main path 27: ``LineageMonitor`` on paths 9 and 2 against
   unmonitored twins in turns (states bit for bit, one more B3 launch a
   generation on path 2, the ``search`` section valid). B3 batched over
   members (``DOMINANCE_BATCHES``, stress rows) in one launch against its
   plain version and against single launches, bit for bit; SHADE islands
   (8 × 512, d 64, the pbest cut one batched B4 launch a generation) and
   one migrating generation on the card against the CPU on the same draws.
   Main path 28: ``bench.py``'s workload 5, ``VectorizedWorkflow(CMAES(
   zeros(16), 1.0, pop_size=256), Sphere(), n_tenants=64)`` against the
   same 64 runs one after the other in turns (differenced trip counts 10
   and 60): ms a generation and their ratio, the member draws' share,
   peak memory, M1's seven launches a generation; tenants 0, 31 and 63
   each step against the solo step and after 10 generations against
   their solo runs, under ``tests/test_tenancy.py:68``'s law and bit for
   bit, ``fleet_split_points`` (each CMA-ES operation of a
   tenant in the fleet, in a batch of one and alone), one fleet
   generation on the card against the CPU. Main path 29: ``RunQueue`` (4
   slots, chunks of 5, a journal, 6 specs of 10 steps) under a
   ``RunSupervisor``, the report valid with its ``supervisor`` section, an
   eviction resumed solo bit for bit and equal to an uninterrupted solo
   run bit for bit.
23. kernel M1 (``csrc/smallmm.cu``) against ``smallmm_plain`` at paths 28's
   and 5's shapes (``SMALLMM_SHAPES``), and a batch against each member in
   a batch of 1, bit for bit, timed beside ``torch.bmm``; B3's rows form
   (``packed_dominance_rows``) slab by slab against its plain version and
   the concatenated slabs against the full B3 at path 31's n 20000 on 8
   shards and at shapes with a remainder (``DOMINANCE_ROWS``, stress rows),
   bit for bit, timed a slab and a generation. Main path 30: ``bench.py``'s
   workload 7, ``ShardedES(SepCMAES(zeros(32), 1.0, pop_size=65536))`` on
   Sphere on an 8-shard mesh of the card against ``mesh=None, n_shards=8``
   (samples bit for bit each of 10 generations, mean, C and sigma within
   rtol 1e-4, atol 1e-4; in turns, ms a generation). Main path 31: path 2
   with ``mesh=`` an 8-shard mesh of the card (8 B3 rows launches and one
   B4 a generation) against path 2, population, fitness and ranks bit for
   bit each of 5 generations, in turns. Main path 32: path 2 under
   ``RunSupervisor(WorkflowCheckpointer(every=10), deadline_s=3)`` with a
   transient fault, a hang past the deadline and an out-of-memory error
   injected: bit for bit with the clean run, the report and the trace
   accepted by ``tools/check_report.py``. The NCCL world of one: init, an
   ``all_reduce``, the barriers, shutdown.
24. main path 33: ``StdWorkflow(OpenES(zeros(114), 4096),
   HostEnvProblem(flat_mlp_policy 4-16-2, NativeVectorEnv("cartpole",
   4096, 500, min(8, cpus) threads), cap 500), opt_direction="max")``: the
   C++ engine built with g++ from the checkout, 10 timed generations after
   2 (a step's split: env, copies by the problem's HostLink; the
   policy's span in one more generation, outside the timed window), one
   generation's returns against a CPU replay of the card's actions bit
   for bit, the card's policy against the CPU's within 1e-5; a pendulum turn (pop 2048, 200
   steps); the engine against B1 on pendulum at pop 65536 x 1 episode x
   200 steps from B1's own initial states (median and 99th percentile of
   the relative difference). Main path 34: ``StdWorkflow(OpenES(zeros(25450),
   4096, adam), DatasetProblem(InMemoryDataLoader(60000 x 784, 256), the
   cross-entropy of an MLP 784-32-10))`` on an MNIST-shaped stream made
   from the seed (labels from a random teacher MLP): 20 timed generations,
   the batches' rows against a CPU loader's, losses against the CPU, the
   mean loss falling, accuracy on 10000 held-out rows through
   ``StdWorkflow.validate`` and a metric view. Main path 35: the thread
   farm (8 threads, both placements) and the process farm (4 spawned
   workers) on a gymnasium-API cartpole (pop 1024, cap 200): process
   against thread farm bit for bit, clean and with a worker killed
   mid-generation, ``FarmDegradedError`` under the floor, 5 generations
   through ``run_host_pipelined`` with the ``farm/*`` counter tracks in a
   Chrome trace; every worker joined.
25. main path 36: ``bench.py:1177-1400``'s ``serving_elastic`` leg,
   ``ElasticServer`` over PSO on Sphere (d 64, width 16, chunk 10, pop
   rungs 256, 512 and 1024) with a serving cache on disk: a seeded trace
   of 48 requests (pops 200-1024) served, tenant-generations a second
   differenced over serve rounds; a padded tenant against its
   ``solo_workflow``, bit for bit; a healthy tenant's ring and state bit
   for bit between fleets whose neighbours differ; admissions into a warm
   bucket under a frozen cache (every chunk's ``run`` looked up in it, all
   hits) and a strict ``DispatchRecorder``; a guarded tenant grown a rung by
   ``PopAutoscaler``, journaled in both buckets; the cold start of a
   fresh process (``--cold-start``) with the manifest's pre-warm against
   without it, in turns. Main path 37: path 28's fleet under
   ``RunQueue(chunk=10, health_policy=FleetHealthPolicy(...))``, NaN in
   three tenants drawing a restart, an eviction and a restart escalated
   to a freeze; the other 61 bit for bit with the sweep without the
   injection; ms a chunk with and without the policy, in turns (and
   with ``--profile`` the DtoH copies). Main path 38: ``MultiLevelES(
   OpenES, PolicyRolloutProblem(pendulum, fused), fleet=False)``, OpenES
   with adam, 4 groups of pop 16384, 5 inner and 4 outer generations: 80
   B1 launches, the outer update replayed on the host bit for bit,
   proposals inside their bounds, the best equal to the best fitness the
   run returned; ms an outer generation and B1's share. Path 36 also holds
   a fleet tenant's telemetry rings against its solo run's, bit for bit.
26. main path 39: ``bench.py:1639-1795``'s workload 13 at path 36's widths,
   ``ControlPlane`` over path 36's factory (3 pods, width 16, chunk 10,
   a ``FlightRecorder``) against the same plane with one pod, 360 specs
   (pop 256, d 64, budgets of 2-4 chunks): 2 warm rounds, ``pod00``
   declared dead (its journals stolen), 1 round, then serve rounds 2 and
   6 differenced, 3 times in turns with the single-pod plane, the
   backlog outlasting the window; the report through
   ``tools/check_report.py``, each spec admitted once, the census with
   the dead pod and its steals; every tenant completed in both planes
   equal in both (results and telemetry fingerprints); the gateway killed
   mid-steal (``_CRASH_HOOK`` at ``steal_target_durable:``) on a plane of
   48 specs and ``ControlPlane.recover`` served to the end against an
   uncrashed plane. Main path 40: path 2 under ``PodSupervisor`` in a
   world of one over NCCL (a ``FileStore``): ``RunSupervisor.run(...,
   pod_supervisor=)`` of 30 generations against a plain run bit for bit
   with B3 and B4 once a generation; a supervised call past a 1 s
   deadline classified ``hung_collective`` and the next chunk run; a
   drain at generation 10 (the final checkpoint fsynced, ``pod_drain``
   journaled) resumed from the barrier to 30, bit for bit; the report
   and the trace's ``supervisor:pod:*`` markers through
   ``tools/check_report.py``; ms a generation pod-supervised against bare,
   in turns.
27. a ``{"kernels": [...]}`` line (B1-B4, D1 and M1 with their call sites:
   B1 on paths 1, 12 and 38, the mountain car phase and path 33's
   cross-check, B2 on paths 3, 6 and
   13, B3 and B4 on paths 18, 22 and 40 too, B3 on paths 20 and 27, B4 batched
   on paths 14 and 24 as ``partial_topk_rows``, B4 under vmap on the SHADE
   and MO islands, ``packed_dominance_batched`` on the MO islands, D1 on
   path 26, ``packed_dominance_rows`` on path 31, ``smallmm`` on paths 28
   and 5), then the last line ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler breakdown of 5 generations of each main
path (of one decomposition period on path 5). Exits non-zero, with no
result line, when CUDA is unavailable or when the checkout is missing.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM datasheet peaks: FP32 outside the tensor cores and HBM
# bandwidth, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
GENERATIONS = 20  # timed main-path generations, after one warm-up step
SEED = 0
# main path 2: bench.py:374-388's NSGA-II workload, at full width
NSGA2_POP = 10000
LSMOP_D, LSMOP_M = 300, 3
# main path 3: bench.py:286-338's walker workload at the north-star
# population (bench.py:329), at full width and full episode cap
WALKER_POP = 65536
WALKER_SIZES = (244, 64, 64, 17)
WALKER_T = 100
# main path 4: bench.py:134-185's CSO workload, at full width (bounds ±32)
CSO_POP, CSO_DIM, CSO_BOUND = 4096, 1024, 32.0
MONITOR_TOPK = 8  # the monitored run's EvalMonitor(topk=8)
CSO_AB_ROUNDS = 5  # rounds of the replay-against-carry turns
# the rest of the PSO family on Sphere, a few generations each
PSO_POP, PSO_DIM, PSO_GENERATIONS = 1024, 100, 10
ARCHIVE_CAP = 1024  # the EvalMonitor Pareto archive's pf_capacity
# main path 5: BASELINE.json's dense CMA-ES at its width, d 1000 (on
# Rastrigin: CEC'22 stops at d 20), default pop (24) and decomposition
# period; the timed run is the smallest whole number of periods >= 20
# generations
CMAES_DIM, CMAES_CENTER = 1000, 3.0
# the rest of the ES family on Sphere, a few generations each
ES_POP, ES_DIM, ES_GENERATIONS = 1024, 100, 10
RESTARTS, RESTART_GENERATIONS = 2, 50  # RestartCMAESDriver on Sphere, d 100
# main paths 7 and 8: BASELINE.json's "NSGA-II + MOEA/D on DTLZ/LSMOP" at
# path 2's pop (10000 requested: 9870 Das-Dennis vectors at m 3), on Deb
# et al.'s DTLZ widths for m 3 (k 10 for DTLZ2: d 12; k 5 for DTLZ1: d 7)
MO_POP, MO_M = 10000, 3
MO_SUBPROBLEMS = 9870  # UniformSampling(10000, 3): H 139
MOEAD_D, NSGA3_D = 12, 7
HV_REF = (1.1, 1.1, 1.1)  # the hypervolume's reference point
# the rest of the decomposition and reference-vector family on DTLZ2(d 12)
MO_FAMILY_POP, MO_GENERATIONS = 1000, 10
# main path 9: bench.py:134-185's Ackley workload and shape (path 4's), with
# SHADE at its default memory size; SHADE's pbest cut on B4 once a generation
SHADE_POP, SHADE_DIM, SHADE_BOUND, SHADE_MEMORY = 4096, 1024, 32.0, 100
# the DE family on Sphere, a few generations each
DE_POP, DE_DIM, DE_GENERATIONS = 1024, 100, 10
CEC_ROWS = 1024  # CEC 2022's points a member and dimension, card against CPU
# main path 10: BASELINE.json's "NSGA-II + MOEA/D on DTLZ/LSMOP" with its DE
# member, GDE3, at path 2's shape (LSMOP1, d 300, m 3, pop 10000) and the
# JAX package's defaults; GDE3_FORCED pairs of the tell checked against the
# CPU are pushed into each +inf branch
GDE3_F, GDE3_CR, GDE3_FORCED = 0.5, 0.3, 100
# main path 11: IBEA on path 7's DTLZ2 (d 12, m 3) at pop 10000, its default
# kappa; a generation is 10000 sequential removals (PERF.md §5 has its
# time), so fewer timed generations
IBEA_KAPPA, IBEA_GENERATIONS = 0.05, 6
MAF_POP = 10000  # MaF1-15's points a member, card against CPU
# main path 14: bench.py:405-456's island workload, 8 PSO islands of 512 on
# Ackley at d 256 (±32) with ring migration every 8 generations (k 1, its
# default), seed 5, against its panmictic twin, one PSO of 4096; each timed
# turn is two whole migration periods
ISL_N, ISL_POP, ISL_DIM, ISL_BOUND, ISL_EVERY, ISL_SEED = 8, 512, 256, 32.0, 8, 5
ISL_GENERATIONS = 2 * ISL_EVERY
# B4's batched launch, held bit for bit: (rows, n, k); (3, 20000, 10000) and
# (64, 2049, 8) on the small route, (3, 30000, 15000) on the large (per row);
# the launches under vmap: the MO islands' NSGA-II cut (4, 2000, 1000) and
# the SHADE islands' pbest cut (8, 512, pbest_k(512) = 102)
TOPK_BATCHES = ((8, 512, 1), (8, 512, 4), (4, 2000, 4), (64, 2049, 8), (3, 20000, 10000),
                (3, 30000, 15000), (4, 2000, 1000), (8, 512, 102))
# main path 15: docs/GUIDE.md:504-520's IPOP-CMA-ES recipe at path 5's shape
# (d 1000, pop 24, Rastrigin); C, B and D poisoned with NaN after
# generation 40, so the boundary at 100 doubles λ to 48 for the segment
# 100-200
IPOP_POP, IPOP_STAGNATION, IPOP_RESTARTS, IPOP_CHECK = 24, 80, 4, 100
IPOP_POISON_GEN, IPOP_GENERATIONS = 40, 200
# the containers phase: path 4's Ackley width in 8 blocks, members of 512
CONTAINER_POP, CONTAINER_DIM, CONTAINER_BLOCKS = 512, 1024, 8
# the MO islands phase: NSGA-II islands at the MO family's pop on DTLZ2
MO_ISLANDS, MO_ISLAND_GENERATIONS = 4, 10
# main path 16: bench.py:613-707's workload 6, PSO (±5, pop 2048, d 512) on
# a host Sphere that sleeps 4 ms a generation, seed 13, 3 warm generations;
# each timed turn 40 generations; the run == step law over 10 generations,
# whole and in row slices of 500 (a ragged last slice of 48)
HE_POP, HE_DIM, HE_SLEEP, HE_SEED, HE_WARM, HE_GENERATIONS = 2048, 512, 0.004, 13, 3, 40
HE_LAW_GENERATIONS, HE_EVAL_CHUNK = 10, 500
# main path 17: bench.py:157-196's workload 1b, path 4's CSO under
# BF16_STORAGE against float32, both with donate_carries, seed 42 as there
BF16_SEED = 42
# main path 18: path 2's NSGA-II for 30 generations, a snapshot every 10
CKPT_GENERATIONS, CKPT_EVERY = 30, 10
# main path 19: bench.py:904-1059's workload 8, PSO (±5, pop 64, d 8) on a
# host Sphere that sleeps 2 ms a row it scores, screened by GPSurrogate at
# 1/8 (8 rows a screened generation), seed 31, 3 warm generations, turns of
# 8; the ledger sleep-free at pop 128, seed 3, to a best under 1e-2 in runs
# of 2 up to 120 generations; the ensemble on path 19 for 10 generations
SUR_POP, SUR_DIM, SUR_SLEEP, SUR_FRAC, SUR_SEED, SUR_WARM, SUR_TURN = 64, 8, 0.002, 0.125, 31, 3, 8
SUR_LEDGER_POP, SUR_LEDGER_SEED, SUR_THRESHOLD, SUR_MAX_GENS = 128, 3, 1e-2, 120
SUR_ENSEMBLE_GENERATIONS = 10
# the refitted GP on the card against the CPU: its scales are plain sums in
# each device's order (1e-3); its posterior is K^-1 y through a float32
# Cholesky with a noise floor of 1e-4 of the amplitude, so K's condition
# number reaches ~1e4, the solve's relative error ~1e4 x 6e-8, and the mean
# sum(Ks * alpha) cancels terms up to ~10x its value: 1e-2
SUR_GP_RTOL, SUR_POSTERIOR_RTOL = 1e-3, 1e-2
# the GP phase: GPSurrogate at its bound, capacity 2048 and d 64, 1536 live
# rows, predictions at 512 new points (the posterior's tolerance as above)
GP_CAP, GP_DIM, GP_FILL, GP_TEST = 2048, 64, 1536, 512
# main path 20: IM-MOEA on DTLZ2 (d 12, m 3; pop 1000 requested: 3 clusters
# of 333, 36 inverse GPs of 333 points a generation); the card's ask against
# the CPU's on the same draws: GP samples after 10 adam steps a model
IMM_D, IMM_POP = 12, 1000
IMM_OFFSPRING_ATOL, IMM_OFFSPRING_MEAN_ATOL = 2e-3, 1e-4
# main path 21: bench.py:1452-1523's run-telemetry leg, PSO (±32, pop 256, d
# 64) on Ackley with TelemetryMonitor(capacity=30) and donated carries, seed
# 11: run 30, run 30, run 300, three steps (363 generations), instrumented
# against a plain twin in turns
TEL_GENS, TEL_POP, TEL_DIM, TEL_BOUND, TEL_SEED = 30, 256, 64, 32.0, 11
TEL_GENERATION = 2 * TEL_GENS + 10 * TEL_GENS + 3  # 363
# main path 22: path 2 instrumented with analyze=True, runs of 4, 4 and 8
# generations (two warm work counts: the differenced slope without the cold call)
INS_RUNS = (4, 4, 8)
# main path 23: workload 6's host Sphere and shapes (pop 2048, d 512, 4 ms,
# seed 13) under OpenES with JAX's staleness gate's steps (center 5,
# learning rate 0.15, noise 0.3), K 0, 1, 2 in turns of 20 generations; the
# gate itself: d 8, pop 64, a 2 ms sleep, 150 generations at K 1 and 2
STALE_CENTER, STALE_LR, STALE_SIGMA, STALE_GENERATIONS, STALE_LAW_GENERATIONS = 5.0, 0.15, 0.3, 20, 10
STALE_GATE_POP, STALE_GATE_DIM, STALE_GATE_SLEEP, STALE_GATE_GENERATIONS = 64, 8, 0.002, 150
# main path 24: path 14 checkpointed every 8 for 32 generations
ISL_CKPT_EVERY, ISL_CKPT_GENERATIONS = 8, 32
# B3 batched over a leading member axis: (members, n, m), the MO islands'
# merged rows (4, 2000, 3) and their migrate's (4, 1004, 3: 1000 and 4
# migrants) among them, and 64 small members
DOMINANCE_BATCHES = ((4, 1000, 3), (4, 2000, 3), (8, 1250, 3), (64, 512, 2), (4, 1004, 3))
# main path 28, bench.py's workload 5 (bench.py:458-606): 64 CMA-ES tenants
# of pop 256 at d 16, the differenced trip counts (10, 60 until PR 21, whose
# three paths took the script past 540 s: the depth was cut, not the
# width), the tenants held against their solo runs
TEN_N, TEN_POP, TEN_DIM = 64, 256, 16
TEN_PAIR = (10, 40)
TEN_CHECK, TEN_CHECK_GENERATIONS = (0, 31, 63), 10
# M1 launches a CMA-ES generation: the ask's (z D) B^T; the tell's mu rows,
# w y, w z, B z_w, the rank-mu product and |ps|'s dot product
CMAES_M1_LAUNCHES = 7
# M1 at CMA-ES's shapes: (name, batch, p, k, q, trans_a, trans_b): every
# call shape of cma_es._product and _norm on path 28 (64 tenants, pop 256,
# d 16, mu 128) and on path 5 (pop 24, d 1000, mu 12), the ask also in a
# batch of 8; w y and w z share a shape, and p = 1 is a partial tile
SMALLMM_SHAPES = (
    ("path 28 ask (z D) B^T", 64, 256, 16, 16, False, True),
    ("path 28 tell's mu rows (z D) B^T", 64, 128, 16, 16, False, True),
    ("path 28 w y and w z", 64, 1, 128, 16, False, False),
    ("path 28 B z_w", 64, 16, 16, 1, False, False),
    ("path 28 rank-mu y^T diag(w) y", 64, 16, 128, 16, True, False),
    ("path 28 |ps|'s ps . ps", 64, 1, 16, 1, False, False),
    ("path 5 ask (z D) B^T", 1, 24, 1000, 1000, False, True),
    ("path 5 ask, a batch of 8", 8, 24, 1000, 1000, False, True),
    ("path 5 tell's mu rows (z D) B^T", 1, 12, 1000, 1000, False, True),
    ("path 5 w y and w z", 1, 1, 12, 1000, False, False),
    ("path 5 B z_w", 1, 1000, 1000, 1, False, False),
    ("path 5 rank-mu", 1, 1000, 12, 1000, True, False),
    ("path 5 |ps|'s ps . ps", 1, 1, 1000, 1, False, False),
)
# main path 30 (bench.py's workload 7): SepCMAES at pop 65536, d 32, seed 21,
# 8 shards on one card against mesh=None, n_shards=8; the differenced pair
LP_POP, LP_DIM, LP_SEED, LP_SHARDS = 65536, 32, 21, 8
LP_PAIR = (2, 10)
LP_CHECK_GENERATIONS = 10
# main path 31: path 2 with the mesh-sharded sort; generations held bit for
# bit against path 2, then timed a turn
SN_CHECK_GENERATIONS, SN_GENERATIONS = 5, 10
# main path 32: path 2 under RunSupervisor with three faults injected
SUP_GENERATIONS, SUP_DEADLINE_S = 30, 3.0
# main path 33: OpenES on HostEnvProblem over the native C++ engine (cartpole,
# the policy 4-16-2 on the card), 10 timed generations after 2; a pendulum
# turn (pop, steps, generations); the engine against B1 on one workload
HENV_ENV, HENV_POP, HENV_STEPS, HENV_HIDDEN = "cartpole", 4096, 500, 16
HENV_WARM, HENV_GENERATIONS, HENV_LR, HENV_SIGMA = 2, 10, 0.05, 0.1
HENV_PENDULUM = (2048, 200, 5)
NATIVE_B1_POP, NATIVE_B1_T = 65536, 200
# main path 34: supervised OpenES on DatasetProblem over an MNIST-shaped
# stream (60000 training rows of 784 features, 10 classes, 10000 held out),
# an MLP 784-32-10 student at pop 4096, batch 256, 20 timed generations
DS_ROWS, DS_VALID, DS_FEATURES, DS_CLASSES = 60000, 10000, 784, 10
DS_HIDDEN, DS_TEACHER_HIDDEN, DS_POP, DS_BATCH, DS_VALID_BATCH = 32, 64, 4096, 256, 2000
DS_GENERATIONS, DS_LR, DS_SIGMA, DS_CHECK_ROWS = 20, 0.01, 0.02, 256
# main path 35: the thread farm (8 threads, both placements) and the process
# farm (4 spawned workers) on a gymnasium-API cartpole, pop 1024, cap 200,
# 2 timed generations each (an env step is ~80 us of numpy: the generations
# take seconds), 5 through run_host_pipelined
FARM_POP, FARM_CAP, FARM_THREADS, FARM_PROCS, FARM_GENERATIONS = 1024, 200, 8, 4, 2
FARM_PIPELINED = 5
# B3's rows form: (n, m, shards); path 31's merged n 20000 on 8 shards, and
# shapes whose n is not a multiple of 32 * shards
PATH31_SHARDS = 8
DOMINANCE_ROWS = ((20000, 3, 8), (20001, 3, 8), (1000, 3, 8), (33, 3, 8), (4100, 5, 4),
                  (777, 2, 3))
# main path 36, bench.py:1177-1400's serving_elastic leg at a served size:
# PSO on Sphere at d 64, bucket width 16, chunk 10, pop rungs 256-1024, a
# seeded trace of 48 requests (pops 200-1024, two chunks each); the serve
# rounds differenced; the padded tenant's live rows; admissions into a warm
# bucket; the cold-start rounds (pre-warm and none, in turns)
EL_DIM, EL_WIDTH, EL_CHUNK, EL_RUNGS = 64, 16, 10, (256, 512, 1024)
EL_REQUESTS, EL_POP_LO, EL_POP_HI, EL_PAIR = 48, 200, 1024, (1, 3)
EL_PADDED, EL_CHECK_GENERATIONS, EL_ADMISSIONS, EL_COLD_ROUNDS = 700, 10, 4, 2
# main path 37: path 28's fleet under a health policy, chunks of 10, budgets
# of 40; the slots NaN goes into, by the action they must draw
FH_CHUNK, FH_BUDGET = 10, 40
FH_SLOTS = {"restart": 5, "freeze": 17, "evict": 40}
# main path 38: MultiLevelES over path 1's B1 pendulum in 4 groups of 16384,
# 5 inner generations, 4 outer ones, OpenES with adam (path 1's sgd steps
# the center into the policy's saturation within a phase, where every
# candidate returns the same fitness and the groups tie); the adapted
# hyperparameters (name, init, lb, ub), log-transformed. The learning rate
# is adapted through lr_scale, the multiplier OpenES's update reads: its
# optimizer takes learning_rate at construction, so a spec on
# learning_rate moves nothing
ML_GROUPS, ML_POP, ML_INNER, ML_OUTER = 4, 16384, 5, 4
ML_LR, ML_SIGMA, ML_OPTIMIZER = 0.05, 0.05, "adam"
ML_SPECS = (("lr_scale", 1.0, 0.1, 10.0), ("noise_stdev", 0.05, 1e-3, 1.0))
# main path 39, bench.py:1639-1795's workload 13 at path 36's widths: pods,
# specs (pop 256, d 64, budgets (2 + i % 3) chunks, seeds 3000 up), the
# differenced pair of serve rounds, its rounds in turns with the one-pod
# plane; the mid-steal crash's plane
CP_PODS, CP_SPECS, CP_POP, CP_PAIR, CP_ROUNDS = 3, 360, 256, (2, 6), 3
CP_CRASH_SPECS = 48
# main path 40: path 2 under PodSupervisor, checkpointed every 10; the hung
# call's deadline and sleep; the drain's generation
POD_GENERATIONS, POD_EVERY, POD_DEADLINE_S, POD_HANG_S, POD_DRAIN_AT = 30, 10, 1.0, 2.5, 10
# main path 29, bench.py's RunQueue leg (bench.py:592-603)
RQ_SLOTS, RQ_CHUNK, RQ_SPECS, RQ_STEPS = 4, 5, 6, 10
# SHADE islands: the pbest cut on B4 under vmap
SHADE_ISL_N, SHADE_ISL_POP, SHADE_ISL_DIM, SHADE_ISL_GENERATIONS = 8, 512, 64, 8
# main paths 25 and 26: bench.py:1525-1638's workloads 12 and 12b, path 4's
# CSO (seed 42) in chunks of 100 with one sample a chunk, and attested every
# 10 into a ring of 64; trip counts 100 and 400 differenced (100 and 600
# until PR 21: depth cut, as path 28's), each the least of three timings, in
# six turns; the ring checked against the host over 60 generations
MET_CHUNK, MET_PAIR, MET_REPEATS = 100, (100, 400), 3
ATT_EVERY, ATT_CAPACITY, ATT_PAIR, ATT_RING_CHECK = 10, 64, (100, 400), 60
# the voted re-dispatch on path 4: 30 generations in chunks of 10; the
# bisection: a bit flipped at generation 13, attested every 5, 30 generations
VOTE_GENERATIONS, VOTE_CHUNK = 30, 10
BISECT_EVERY, BISECT_FLIP, BISECT_GENERATIONS = 5, 13, 30
# main path 27: the lineage rings' capacity on paths 9 and 2
LIN_CAPACITY = 64
# fused_rollout's wide-angle pendulum cases: (n, episodes)
PENDULUM_STRESS = ((65536, 2), (1500, 2), (40000, 3))
# main path 12: path 1's shape (OpenES, pop 65536, 2 episodes, flat 1-hidden
# MLP at hidden 16) with acrobot, the JAX kernel's fourth built-in env, at
# its default episode cap, in pendulum's place
ACROBOT_T = 500
# the mountain car phase: the same at mountain car's default cap, a few
# generations (a call site of B1's mountain car instance)
MOUNTAIN_CAR_T, MOUNTAIN_CAR_GENERATIONS = 999, 5
# B1's envs: (default T, obs, act); their operations a step are
# kernels/rollout.py's ENV_OPS
ROLLOUT_ENVS = {"pendulum": (200, 3, 1), "cartpole": (500, 4, 2), "mountain_car": (999, 2, 1),
                "acrobot": (500, 6, 3)}
# the normaliser phase: the scan engine with CapEpisode and ObsNormalizer on
# cartpole, card against CPU
NORM_POP, NORM_GENERATIONS, NORM_CAP = 4096, 3, 200
# partial_topk's sweep: every n against k in {1, 100, n/10, n/2, n} and three
# value laws (topk_values); at 2**24 + 1, just above the JAX kernel's
# envelope, the plain version checks k = n/2 only
TOPK_NS = (1000, 20000, 100003, 1000000, 16777217)
TOPK_LAWS = ("distinct", "rounded", "cut")
TOPK_SPECIAL_BITS = (0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFF00000, 0x7F800000,
                     0xFF800000, 0x00000000, 0x80000000)
# packed_dominance's stress cases: every objective count against every n
DOMINANCE_STRESS_M = (2, 3, 4, 5, 8, 16, 32)
DOMINANCE_STRESS_N = (1, 31, 32, 33, 1000, 20001)
# fused_mlp_rollout's stress cases: (name, sizes, n, episodes, T, weight
# scale, linear, walker configuration)
WALKER_STRESS = (
    ("full width", WALKER_SIZES, 8192, 1, WALKER_T, 3.0, (), {}),
    ("ragged n, 2 episodes", (244, 16, 8, 17), 1500, 2, WALKER_T, 3.0, (), {}),
    ("low-rank linear=(0,)", (244, 16, 64, 17), 4096, 1, WALKER_T, 1.0, (0,), {}),
    ("7-mass walker", (64, 16, 16, 4), 2000, 1, 40, 3.0, (), dict(n_masses=7, act_dim=4, obs_dim=64)),
    ("ragged split", (244, 37, 23, 17), 3000, 1, WALKER_T, 3.0, (), {}),
    # 32 threads: the generic instance's one-warp block (slices 4, 2, 1)
    ("one warp", (64, 8, 4, 4), 2000, 1, 40, 3.0, (), dict(n_masses=7, act_dim=4, obs_dim=64)),
)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def _time_ms(fn, warmup: int, reps: int) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rollout_work(n: int, episodes: int, steps: int, obs: int, hidden: int, act: int,
                 env: str) -> tuple:
    """(bytes, operations) of a fused rollout: ``kernels/rollout.py``'s
    count, the one the cost analysis charges."""
    from evox_tpu_torch.kernels.rollout import rollout_work as work

    return work(n, episodes, steps, obs, hidden, act, env)


def bound_ms(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name: str, got, want, rtol: float, atol: float) -> dict:
    """Per-env returns against a reference: every env within
    ``atol + rtol * |want|`` (0 and 0: bit for bit)."""
    import torch

    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    stats = {
        "elements": int(got.numel()),
        "max_abs_err": float(diff.max()),
        "max_rel_err": float((diff / want.abs().clamp_min(1e-6)).max()),
        "median_abs_err": float(diff.median()),
        "outside_tol": int(bad.sum()),
        "rtol": rtol,
        "atol": atol,
        "exact_frac": float((diff == 0).float().mean()),
    }
    print(f"[compare] {name}: {json.dumps(stats)}", flush=True)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel returned non-finite values")
    if stats["outside_tol"]:
        raise AssertionError(f"{name}: disagrees with its reference: {stats}")
    return stats


def build_b1_path(torch, soa, hidden: int = 16, pop: int = 65536, early_exit: bool = True,
                  device=None):
    """A B1 path as a user builds it: ``StdWorkflow(OpenES(zeros(dim), pop),
    PolicyRolloutProblem(flat_mlp_policy obs-hidden-act, soa.base, 2
    episodes, fused_env=soa))``; returns ``(workflow, make_problem)``.
    ``make_problem(fused, max_episode_length=None)`` builds the problem on
    the fused or the scan engine."""
    from evox_tpu_torch import Monitor, StdWorkflow
    from evox_tpu_torch.algorithms.so.es import OpenES
    from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem, flat_mlp_policy

    apply, dim = flat_mlp_policy(soa.base.obs_dim, hidden, soa.base.act_dim)

    def make_problem(fused, max_episode_length=None):
        return PolicyRolloutProblem(
            apply, soa.base, num_episodes=2, stochastic_reset=False,
            max_episode_length=max_episode_length, fused_env=soa if fused else None,
            early_exit=early_exit, device=device,
        )

    class FitnessRecorder(Monitor):
        """Each generation's mean fitness and a finite flag, kept as device
        tensors and read once, after the run."""

        def init(self, seed=None):
            return ()

        def hooks(self):
            return ("post_eval",)

        def post_eval(self, mstate, cand, fitness):
            return mstate + ((fitness.mean(), torch.isfinite(fitness).all()),)

    algo = OpenES(torch.zeros(dim), pop, learning_rate=0.05, noise_stdev=0.05, device=device)
    wf = StdWorkflow(algo, make_problem(True), monitors=[FitnessRecorder()], opt_direction="max",
                     device=device)
    return wf, make_problem


def build_main_path(torch, seed: int):
    """Main path 1 as a user builds it: ``(workflow, make_problem)``."""
    from evox_tpu_torch.kernels import rollout as kr

    return build_b1_path(torch, kr.pendulum_soa(max_steps=200), early_exit=False)


def build_acrobot_path(torch, pop: int = 65536, device=None):
    """Main path 12: OpenES on the fused acrobot(500), 6-16-3."""
    from evox_tpu_torch.kernels import rollout as kr

    return build_b1_path(torch, kr.acrobot_soa(max_steps=ACROBOT_T), pop=pop, device=device)


def b1_stress_inputs(torch, env, n: int, episodes: int, scale: float, seed: int, hidden: int = 16,
                     dev=None):
    """Large random genomes and a fresh reset per env: policies that drive
    the system hard, where trajectories are sensitive."""
    dev = torch.device("cuda") if dev is None else dev
    g = torch.Generator().manual_seed(seed)
    obs, act = env.base.obs_dim, env.base.act_dim
    dim = obs * hidden + hidden + hidden * act + act
    theta = (scale * torch.randn(n, dim, generator=g)).to(dev)
    g_dev = torch.Generator(device=dev).manual_seed(seed)
    states = env.base.reset(g_dev, episodes * n, dev)
    planes = {k: v.contiguous() for k, v in env.to_soa(states).items()}
    return theta, planes


def phase_kernels(torch, kr, wf, seed: int) -> dict:
    """Hold fused_rollout against fused_rollout_plain on the card."""
    dev = torch.device("cuda")
    results = {}

    # pendulum: the inputs the main path hands the kernel in its first
    # generation (OpenES's population, the problem's episode resets)
    state = wf.init(seed)
    pop, _ = wf.algorithm.ask(state.algo)
    kw = wf.problem.fused_inputs(state.prob, pop)
    plain_kw = {k: v for k, v in kw.items() if k != "device"}
    got = kr.fused_rollout(**kw)
    torch.cuda.synchronize()
    want = kr.fused_rollout_plain(**plain_kw)
    torch.cuda.synchronize()
    # bit for bit: the kernel does the plain version's operations in the
    # same order, each rounded on its own (no FMA contraction)
    stats = compare("pendulum, main-path inputs n=65536 ep=2 T=200", got, want,
                    rtol=0.0, atol=0.0)
    stats["ms"] = _time_ms(lambda: kr.fused_rollout(**kw), 3, 20)
    stats["plain_ms"] = _time_ms(lambda: kr.fused_rollout_plain(**plain_kw), 1, 3)
    n, ep, T = pop.shape[0], kw["episodes"], kw["T"]
    nbytes, ops = rollout_work(n, ep, ep * n * T, 3, 16, 1, "pendulum")
    stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
    stats["bytes"], stats["ops"] = nbytes, ops
    results["pendulum"] = stats

    # a driven pendulum turns any last-ulp difference into a different
    # trajectory in some envs, so bit-for-bit agreement is the only check
    # that means something here
    env = kr.pendulum_soa(200)
    theta, planes = b1_stress_inputs(torch, env, 65536, 2, 0.5, seed)
    args = (theta, planes, 200, 3, 16, 1, env, 2)
    got = kr.fused_rollout(*args, device=dev)
    want = kr.fused_rollout_plain(*args)
    torch.cuda.synchronize()
    results["pendulum_stress"] = compare(
        "pendulum, stress inputs n=65536 ep=2 T=200", got, want,
        rtol=0.0, atol=0.0)

    # wide angles: th in ±1e3 runs the floored modulo and the trig calls'
    # range reduction far from [-pi, pi]; a ragged n of 1500; an odd
    # episode count
    for sn, sep in PENDULUM_STRESS:
        theta, planes = b1_stress_inputs(torch, env, sn, sep, 0.5, seed)
        g = torch.Generator(device=dev).manual_seed(seed + sn)
        planes["th"] = 2e3 * torch.rand(sep * sn, generator=g, device=dev) - 1e3
        args = (theta, planes, 200, 3, 16, 1, env, sep)
        got = kr.fused_rollout(*args, device=dev)
        want = kr.fused_rollout_plain(*args)
        torch.cuda.synchronize()
        results[f"pendulum_wide_th_{sn}_{sep}"] = compare(
            f"pendulum, stress inputs th in ±1e3 n={sn} ep={sep} T=200", got, want,
            rtol=0.0, atol=0.0)

    # cartpole: terminating, the per-warp early exit; ragged edge at 1500
    env = kr.cartpole_soa(500)
    for n in (8192, 1500):
        theta, planes = b1_stress_inputs(torch, env, n, 2, 0.5, seed)
        args = (theta, planes, 500, 4, 16, 2, env, 2)
        got = kr.fused_rollout(*args, device=dev)
        torch.cuda.synchronize()
        want = kr.fused_rollout_plain(*args)
        torch.cuda.synchronize()
        # bit for bit, as for pendulum (a bang-bang action flips on a
        # last-ulp difference of a1 - a0)
        stats = compare(f"cartpole n={n} ep=2 T=500", got, want, rtol=0.0, atol=0.0)
        if n == 8192:
            stats["ms"] = _time_ms(lambda: kr.fused_rollout(*args, device=dev), 3, 20)
            stats["plain_ms"] = _time_ms(lambda: kr.fused_rollout_plain(*args), 1, 3)
            steps = int(want.sum().item())  # live env-steps this data needs
            nbytes, ops = rollout_work(n, 2, steps, 4, 16, 2, "cartpole")
            stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
            stats["mean_return"] = float(want.mean())
        results[f"cartpole_{n}"] = stats

    # every libdevice function the kernel replaces, against the original
    # over all 2^32 float32 bit patterns, bit for bit
    for name in kr.REPLACED_LIBDEVICE:
        res = kr.check_replaced_libdevice(name)
        print(f"[exhaustive] {name}: {json.dumps(res)}", flush=True)
        if res["mismatches"]:
            raise AssertionError(f"{name} differs from the libdevice original: {res}")
        results[f"exhaustive_{name}"] = res

    # the block of each env's instance; no instance spills
    ptxas = rollout_ptxas(kr)
    results["pendulum"]["block"] = rollout_block_shape(kr, "pendulum", pop.shape[0],
                                                       kw["episodes"], ptxas)
    results["cartpole_8192"]["block"] = rollout_block_shape(kr, "cartpole", 8192, 2, ptxas)
    return results


def rollout_ptxas(kr) -> dict:
    """ptxas's report of every (env, hidden) instance of csrc/rollout.cu,
    keyed "env/hidden"; fails if an instance spills or is missing."""
    names = {"Pendulum": "pendulum", "CartPole": "cartpole", "MountainCar": "mountain_car",
             "Acrobot": "acrobot"}
    ptxas = {}
    for fname, rep in ptxas_functions(_build_log("rollout")).items():
        found = re.search(r"rollout_kernelINS_\d+(Pendulum|CartPole|MountainCar|Acrobot)ELi(\d+)E",
                          fname)
        if found:
            ptxas[f"{names[found.group(1)]}/{found.group(2)}"] = rep
    for env_name, hidden in kr.BLOCKS_PER_SM:
        check_no_spill(ptxas, f"rollout_kernel<{env_name}, {hidden}>", f"{env_name}/{hidden}")
    return ptxas


def phase_rollout_envs(torch, kr, wf12, seed: int) -> dict:
    """Hold B1's mountain car and acrobot instances, and every env's hidden-8
    instance, against fused_rollout_plain on the card, bit for bit: acrobot
    on main path 12's first-generation inputs and at n 1500 with 3
    episodes, mountain car at pop 65536 x 2 x T 999 and at n 1500, both
    with half their envs on the brink of done, and all four envs at hidden
    8 (n 1500, 2 episodes). Then the registers, spills and blocks an SM of
    all eight instances."""
    dev = wf12.device
    results = {}

    def check(label, kw, timed=False):
        plain_kw = {k: v for k, v in kw.items() if k != "device"}
        got = kr.fused_rollout(**kw)
        torch.cuda.synchronize()
        want, steps = kr.fused_rollout_plain(**plain_kw, stats=True)
        torch.cuda.synchronize()
        st = compare(label, got, want, rtol=0.0, atol=0.0)
        st["mean_live_steps"] = float(steps.float().mean())
        if timed:
            n, ep = kw["theta"].shape[0], kw["episodes"]
            st["ms"] = _time_ms(lambda: kr.fused_rollout(**kw), 3, 20)
            st["plain_ms"] = _time_ms(lambda: kr.fused_rollout_plain(**plain_kw), 0, 1)
            live = int(steps.sum())  # the env-steps this run's data needs
            nbytes, ops = rollout_work(n, ep, live, kw["obs_dim"], kw["hidden"], kw["act_dim"],
                                       kw["env"].cuda_env)
            st["bound_ms"], st["bound_by"] = bound_ms(nbytes, ops)
            st.update(bytes=nbytes, ops=ops, live_steps=live, mean_return=float(want.mean()))
        return st, steps

    def stress_kw(name, n, ep, hidden=16, T=None, brink=False):
        env = getattr(kr, f"{name}_soa")()
        T = T or ROLLOUT_ENVS[name][0]
        theta, planes = b1_stress_inputs(torch, env, n, ep, 0.5, seed + n + hidden, hidden, dev)
        if brink:  # every other env on the brink of done (tests/test_kernels.py:296-317)
            half = torch.arange(ep * n, device=dev) % 2 == 0
            near = ({"pos": 0.44, "vel": 0.07} if name == "mountain_car"
                    else {"t1": 2.8, "t2": 0.1, "td1": 0.5, "td2": 0.0})
            planes = {k: torch.where(half, near[k], v).contiguous() for k, v in planes.items()}
        return dict(theta=theta, init_state=planes, T=T, obs_dim=env.base.obs_dim, hidden=hidden,
                    act_dim=env.base.act_dim, env=env, episodes=ep, device=dev)

    # acrobot: the inputs main path 12 hands the kernel in its first
    # generation (OpenES's population, the problem's episode resets)
    state = wf12.init(seed)
    pop, _ = wf12.algorithm.ask(state.algo)
    kw = wf12.problem.fused_inputs(state.prob, pop)
    results["acrobot"], _ = check(
        f"acrobot, main-path inputs n={pop.shape[0]} ep=2 T={ACROBOT_T}", kw, timed=True)
    del pop, kw
    results["mountain_car"], _ = check(
        f"mountain car n=65536 ep=2 T={MOUNTAIN_CAR_T}", stress_kw("mountain_car", 65536, 2),
        timed=True)
    results["acrobot_1500"], _ = check("acrobot n=1500 ep=3", stress_kw("acrobot", 1500, 3))
    results["mountain_car_1500"], _ = check("mountain car n=1500 ep=2",
                                            stress_kw("mountain_car", 1500, 2))
    # on the brink: done fires within the horizon in the brink half, so the
    # warp exit and the masked rewards are really held
    for name in ("mountain_car", "acrobot"):
        for n in (8192, 1500):
            kw = stress_kw(name, n, 2, brink=True)
            st, steps = check(f"{name} near done n={n} ep=2", kw)
            half = torch.arange(2 * n, device=dev) % 2 == 0
            st["brink_done"] = int((steps[half] < kw["T"]).sum())
            if st["brink_done"] < n // 2:
                raise AssertionError(f"{name} near done: done fired in only {st['brink_done']} "
                                     f"of {n} brink envs")
            results[f"{name}_near_done_{n}"] = st
    for name in ROLLOUT_ENVS:
        results[f"{name}_hidden8"], _ = check(f"{name} hidden 8 n=1500 ep=2",
                                              stress_kw(name, 1500, 2, hidden=8))

    # all eight instances: no spill, and the runtime fits at least the
    # blocks an SM each is built for
    ptxas = rollout_ptxas(kr)
    results["instances"] = {
        f"{env_name}/{hidden}": rollout_block_shape(kr, env_name, 65536, 2, ptxas, hidden)
        for env_name, hidden in kr.BLOCKS_PER_SM}
    results["acrobot"]["block"] = results["instances"]["acrobot/16"]
    results["mountain_car"]["block"] = results["instances"]["mountain_car/16"]
    print(f"[rollout instances] {json.dumps(results['instances'])}", flush=True)
    return results


def _build_log(name: str) -> str:
    from evox_tpu_torch.kernels import _build

    return _build.build_log(name) or ""


def rollout_block_shape(kr, env_name: str, n: int, episodes: int, ptxas: dict,
                        hidden: int = 16) -> dict:
    """The rollout kernel's launch for an env at ``(n, episodes)``: the
    plan's threads, grid and blocks an SM, the runtime's blocks an SM and
    registers, and ptxas's registers and spills of the (env, hidden)
    instance."""
    plan = kr.launch_plan(env_name, n, episodes, torch_sm_count(), hidden=hidden)
    runtime = kr.kernel_occupancy(env_name, hidden)
    if runtime["blocks_per_sm"] < plan["blocks_per_sm"]:
        raise AssertionError(f"the rollout kernel for {env_name}/{hidden} fits fewer blocks an "
                             f"SM than its plan: {runtime} against {plan}")
    return {"instance": f"{env_name}/{hidden}",
            **{k: (list(v) if isinstance(v, tuple) else v) for k, v in plan.items()},
            "runtime_blocks_per_sm": runtime["blocks_per_sm"],
            "registers": runtime["registers"], "ptxas": ptxas.get(f"{env_name}/{hidden}")}


def phase_main_path(torch, kr, wf, make_problem, gens: int, seed: int, profile: bool,
                    engine_T=None, live_steps: bool = False) -> dict:
    """A B1 path (1, 12, the mountain car phase): init, one warm-up step,
    ``run`` for ``gens`` generations with the launch counts set to 0 just
    before and read just after; the fused engine against the scan engine on
    512 genomes (at ``engine_T`` steps, default the problem's cap); with
    ``live_steps``, the mean live steps an env of the last population (the
    plain version's count)."""
    state = wf.init(seed)
    center0 = state.algo.center.clone()
    state = wf.step(state)  # warm-up: first-use library loads, cuBLAS handle
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()  # read just after
    want = {"fused_rollout": gens, "packed_dominance": 0, "partial_topk": 0,
            "fused_mlp_rollout": 0}
    if counts != want:
        raise AssertionError(f"launches in {gens} OpenES generations: {counts}, expected {want}")
    launches = counts["fused_rollout"]
    if state.generation != gens + 1:
        raise AssertionError(f"generation {state.generation} != {gens + 1}")
    records = state.monitors[0]
    means = [float(m) for m, _ in records]
    if not all(bool(f) for _, f in records):
        raise AssertionError("non-finite fitness on the main path")
    moved = float((state.algo.center - center0).norm())
    if not (moved > 0 and math.isfinite(moved)):
        raise AssertionError(f"the center did not move (|delta| = {moved})")

    # the repo's own means: fused engine == scan engine on the same resets,
    # up to float rounding (the scan engine's policy sums in another order)
    g = torch.Generator(device=wf.device).manual_seed(seed + 1)
    dim = state.algo.center.shape[0]
    small = state.algo.center + 0.05 * torch.randn(512, dim, generator=g, device=wf.device)
    pstate = wf.problem.init(seed)
    f_fused, _ = make_problem(True, engine_T).evaluate(pstate, small)
    f_scan, _ = make_problem(False, engine_T).evaluate(pstate, small)
    torch.cuda.synchronize()
    env_name = wf.problem.fused_env.cuda_env
    engines = compare(f"{env_name} fused engine vs scan engine, pop 512, T {engine_T or 'full'}",
                      f_fused, f_scan, rtol=1e-4, atol=1e-2)
    out = {
        "generations": gens,
        "pop": wf.algorithm.pop_size,
        "episodes": wf.problem.num_episodes,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "evals_per_s": gens * wf.algorithm.pop_size / wall,
        "mean_return_first": means[0],
        "mean_return_last": means[-1],
        "center_moved": moved,
        "engines": engines,
    }
    if live_steps:
        pop, _ = wf.algorithm.ask(state.algo)
        kw = wf.problem.fused_inputs(state.prob, pop)
        kw.pop("device")
        _, steps = kr.fused_rollout_plain(**kw, stats=True)
        out["mean_live_steps_last"] = float(steps.float().mean())
        del pop, kw, steps
    if profile:
        prof = profile_generations(torch, wf, state, 5)
        # the profiler slows the host; the idle share is taken against the
        # unprofiled wall time of a generation
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


def profile_generations(torch, wf, state, gens: int) -> dict:
    """Device time by kernel over ``gens`` steady generations
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wf.run(state, gens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats the time of its kernels
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    table = [{"kernel": k[:90], "device_us_per_gen": us / gens, "calls_per_gen": c / gens}
             for us, k, c in rows[:15]]
    for r in table:
        print(f"[profile] {json.dumps(r)}", flush=True)
    copies = [r for r in rows if r[1].startswith(("Memcpy", "Memset"))]
    return {
        "generations": gens,
        "profiled_wall_us_per_gen": wall_us / gens,
        "device_busy_us_per_gen": busy_us / gens,
        # device work items a generation: kernels, and the copies to the
        # host (each a blocking read of the device on the host)
        "kernel_launches_per_gen": sum(c for _, k, c in rows
                                       if not k.startswith(("Memcpy", "Memset"))) / gens,
        "memcpy_dtoh_per_gen": sum(c for _, k, c in copies if "DtoH" in k) / gens,
        "top": table,
    }


# ----------------------------------------------------------- main path 2


def launch_counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from evox_tpu_torch.kernels import dominance, rollout, rollout_mlp, topk

    return {"fused_rollout": rollout.fused_rollout, "packed_dominance": dominance.packed_dominance,
            "partial_topk": topk.partial_topk, "fused_mlp_rollout": rollout_mlp.fused_mlp_rollout}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def compare_exact(name: str, got, want) -> dict:
    """Tensors equal bit for bit (floats as their int32 bit patterns, so the
    sign of zero and NaN payloads count). ``max_abs_err`` is the largest
    difference of the compared integers (0 when equal)."""
    import torch

    stats = {"elements": 0, "mismatches": 0, "max_abs_err": 0.0}
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} != {w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        g, w = g.cpu().to(torch.float64), w.cpu().to(torch.float64)
        stats["elements"] += g.numel()
        stats["mismatches"] += int((g != w).sum())
        if g.numel():
            stats["max_abs_err"] = max(stats["max_abs_err"], float((g - w).abs().max()))
    print(f"[compare] {name}: {json.dumps(stats)}", flush=True)
    if stats["mismatches"]:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {stats}")
    return stats


def build_nsga2_path(torch):
    """Main path 2 as a user builds it."""
    from evox_tpu_torch import Monitor, StdWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.problems.numerical import LSMOP1

    class FrontRecorder(Monitor):
        """Each evaluation's finite flag and each generation's fronts peeled
        (the survivors' worst rank + 1: the peel stops at the cut front),
        kept as device tensors and read once, after the run."""

        def init(self, seed=None):
            return ((), ())

        def hooks(self):
            return ("post_eval", "post_step")

        def post_eval(self, mstate, cand, fitness):
            return (mstate[0] + (torch.isfinite(fitness).all(),), mstate[1])

        def post_step(self, mstate, wf_state):
            return (mstate[0], mstate[1] + (wf_state.algo.rank.max() + 1,))

    prob = LSMOP1(d=LSMOP_D, m=LSMOP_M)
    algo = NSGA2(*prob.bounds(), n_objs=LSMOP_M, pop_size=NSGA2_POP, use_kernel=True)
    return StdWorkflow(algo, prob, monitors=[FrontRecorder()])


def dominance_work(n: int, m: int) -> tuple:
    """(bytes, operations) of the packed dominance matrix:
    ``kernels/dominance.py``'s count, the one the cost analysis charges."""
    from evox_tpu_torch.kernels.dominance import dominance_work as work

    return work(n, m)


def topk_work(n: int, k: int, rows: int = 1) -> tuple:
    """(bytes, operations) of selecting the k smallest of each row:
    ``kernels/topk.py``'s count, the one the cost analysis charges."""
    from evox_tpu_torch.kernels.topk import topk_work as work

    return work(n, k, rows)


def stress_fitness(torch, n: int, m: int, seed: int, dev):
    """Rounded uniform objectives (ties, zeros of both signs), duplicate
    rows, +inf, -inf and NaN rows and a NaN objective, as far as n and m
    have room for them."""
    g = torch.Generator().manual_seed(seed)
    fit = torch.round(torch.rand(n, m, generator=g) * 20) / 20
    # -0.0 must compare equal to +0.0: flip the sign of half the zeros
    flip = (fit == 0) & (torch.rand(n, m, generator=g) < 0.5)
    fit = torch.where(flip, -fit, fit)
    fit[n // 2] = fit[0]
    fit[n // 3] = fit[min(1, n - 1)]
    if n > 13:  # row 12: row 13 with its zeros negated
        fit[13, 0] = 0.0
        fit[12] = torch.where(fit[13] == 0, -fit[13], fit[13])
    for row, value in ((3, "inf"), (7, "nan")):
        if n > row:
            fit[row] = float(value)
    if n > 11:
        fit[11, m - 1] = float("nan")
    fit[n - 1, 0] = float("-inf")
    return fit.to(dev)


def topk_ks(n: int) -> list:
    return sorted({1, 100, n // 10, n // 2, n} - {0})


def topk_values(torch, law: str, n: int, seed: int, inf_share: float, n_ninf: int):
    """(n,) float32 values on the CPU, made from ``seed``, by value law:
    ``distinct`` (a permutation of the integers, shifted to hold both signs;
    exact in float32 up to 2**24 + 1), ``rounded`` (normals rounded to
    quarters, heavy ties, with NaNs of both signs and payloads, ±inf and
    ±0.0), ``cut`` (NSGA-II's cut key: -crowding on a front of n * (1 -
    inf_share) rows, n_ninf of them -inf, +inf elsewhere)."""
    import numpy as np

    g = torch.Generator().manual_seed(seed)
    if law == "distinct":
        return torch.randperm(n, generator=g).to(torch.float32) - float(n // 2)
    if law == "rounded":
        v = torch.round(torch.randn(n, generator=g) * 4) / 4
        special = torch.from_numpy(np.array(TOPK_SPECIAL_BITS, np.uint32).view(np.int32).copy())
        hit = torch.randint(0, n, (min(n, max(64, n // 1000)),), generator=g)
        v[hit] = special.view(torch.float32).repeat(len(hit) // len(TOPK_SPECIAL_BITS) + 1)[: len(hit)]
        return v
    if law == "cut":
        front = max(1, min(n, round(n * (1.0 - inf_share))))
        v = torch.full((n,), float("inf"))
        rows = torch.randperm(n, generator=g)[:front]
        crowd = torch.rand(front, generator=g) * 2.0
        crowd[: min(n_ninf, front)] = float("inf")  # the front's boundary rows
        v[rows] = -crowd
        return v
    raise ValueError(law)


def topk_stress(torch, kt, dev, seed: int, inf_share: float, n_ninf: int) -> dict:
    """partial_topk against partial_topk_reference, bit for bit: every shape
    and value law of the sweep (one k at 2**24 + 1), all-equal inputs, n of
    a warp or less, and n and k on both sides of each route's limit."""
    results = {}

    def check(label, v, k):
        results[f"partial_topk_{label}"] = compare_exact(
            f"partial_topk, {label}", kt.partial_topk(v, k, device=dev),
            kt.partial_topk_reference(v, k))

    for n in TOPK_NS:
        for law in TOPK_LAWS:
            v = topk_values(torch, law, n, seed + n, inf_share, n_ninf).to(dev)
            for k in topk_ks(n) if n < 2**24 else [n // 2]:
                check(f"sweep {law} n={n} k={k} ({kt.launch_plan(n, k)['route']})", v, k)
            del v
    # all-equal inputs: +inf, one NaN payload, -0.0, on both routes
    for name, bits in (("+inf", 0x7F800000), ("nan 0xffc00123", 0xFFC00123), ("-0.0", 0x80000000)):
        for n in (20000, 100003):
            v = torch.full((n,), bits - 2**32 if bits >= 2**31 else bits, dtype=torch.int32,
                           device=dev).view(torch.float32)
            for k in (1, n // 2, n):
                check(f"all equal {name} n={n} k={k}", v, k)
    # small populations: a warp or less, a ragged warp
    for n in (1, 2, 31, 33, 100):
        for law in ("distinct", "rounded"):
            v = topk_values(torch, law, n, seed + n, inf_share, n_ninf).to(dev)
            for k in sorted({1, max(1, n // 2), n}):
                check(f"small n {law} n={n} k={k}", v, k)
    # each route's limit, from both sides (launch_plan's rules)
    w = kt.SMALL_WORDS
    for n, k in ((w - 2, 1), (w - 1, 1), (w // 4, w // 4), (w // 4 + 1, w // 4 + 1),
                 (w // 2, w // 4), (w // 2 + 1, w // 4), (100003, w // 4), (100003, w // 4 + 1),
                 (kt.SMALL_N, kt.SMALL_N // 2), (kt.SMALL_N + 1, kt.SMALL_N // 2)):
        for law in ("distinct", "rounded"):
            v = topk_values(torch, law, n, seed + n + k, inf_share, n_ninf).to(dev)
            plan = kt.launch_plan(n, k)
            check(f"limit {law} n={n} k={k} ({plan['route']}, {plan['sort']}, "
                  f"scratch {plan['scratch_words']})", v, k)
    return results


def dominance_block_shape(kd, n: int, m: int) -> dict:
    """The dominance kernel's launch at ``(n, m)``: the plan's instance,
    threads, super-tile, grid, shared memory and blocks an SM, the
    runtime's blocks an SM and registers for that instance, and ptxas's
    registers and spills of every instance (keyed by m, 0 the generic)."""
    from evox_tpu_torch.kernels import _build

    plan = kd.launch_plan(n, m)
    ptxas = {}
    for name, rep in ptxas_functions(_build.build_log("dominance") or "").items():
        found = re.search(r"dominance_kernelILi(\d+)E", name)
        ptxas[int(found.group(1)) if found else name] = rep
    runtime = kd.kernel_occupancy(plan, m)
    if runtime["blocks_per_sm"] < plan["blocks_per_sm"]:
        raise AssertionError(f"the dominance kernel fits fewer blocks an SM than its plan: "
                             f"{runtime} against {plan}")
    return {"instance": plan["instance"], "threads": plan["threads"],
            "tile_words": plan["tile_words"], "grid": list(plan["grid"]),
            "working_blocks": plan["working_blocks"], "smem_bytes": plan["smem_bytes"],
            "planned_blocks_per_sm": plan["blocks_per_sm"],
            "runtime_blocks_per_sm": runtime["blocks_per_sm"],
            "registers": runtime["registers"], "ptxas": ptxas}


def check_no_spill(ptxas: dict, label: str, key) -> None:
    """Fail unless ptxas reported the function under ``key`` without
    spills."""
    rep = ptxas.get(key)
    if rep is None or rep.get("spill_stores", 1) or rep.get("spill_loads", 1):
        raise AssertionError(f"{label}: ptxas reports spills or no report ({key}: {rep})")


def torch_sm_count() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_nsga2_kernels(torch, wf, seed: int) -> dict:
    """Hold packed_dominance and partial_topk against their plain versions
    on the card, on the main path's inputs and on stress inputs."""
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.kernels import topk as kt
    from evox_tpu_torch.operators.selection import crowding_distance, non_dominated_sort

    # the main path's first merged fitness: parents after the init step,
    # then the first generation's offspring
    state = wf.step(wf.init(seed))
    off, astate = wf.algorithm.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    merged = torch.cat([astate.fitness, fit])
    n, m = merged.shape
    k = wf.algorithm.pop_size
    dev = merged.device
    results = {}

    got = kd.packed_dominance(merged, device=dev)
    want = kd.packed_dominance_reference(merged)
    torch.cuda.synchronize()
    stats = compare_exact(f"packed_dominance, main-path merged fitness n={n} m={m}", got, want)
    stats["ms"] = _time_ms(lambda: kd.packed_dominance(merged, device=dev), 3, 20)
    stats["plain_ms"] = _time_ms(lambda: kd.packed_dominance_reference(merged), 1, 3)
    nbytes, ops = dominance_work(n, m)
    stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
    stats["bytes"], stats["ops"] = nbytes, ops
    results["packed_dominance"] = stats
    stats["block"] = dominance_block_shape(kd, n, m)
    # every instance (exact m = 2, 3, 4; generic 5 to 32) at ragged and
    # whole words (1, 31, 32, 33), a few column blocks (1000) and the plain
    # version's chunked build (20001), with duplicates, ±inf, NaN and ±0.0
    for sm in DOMINANCE_STRESS_M:
        for sn in DOMINANCE_STRESS_N:
            fit_s = stress_fitness(torch, sn, sm, seed + sn + sm, dev)
            results[f"packed_dominance_stress_{sn}_{sm}"] = compare_exact(
                f"packed_dominance, stress n={sn} m={sm}",
                kd.packed_dominance(fit_s, device=dev), kd.packed_dominance_reference(fit_s))
            del fit_s
    for sm in DOMINANCE_STRESS_M:  # no instance spills
        check_no_spill(stats["block"]["ptxas"], f"dominance_kernel, m={sm}",
                       kd.launch_plan(1000, sm)["instance"])

    # the main path's cut key: -crowding on the cut front, +inf elsewhere
    rank, cut = non_dominated_sort(merged, until=k, return_cut_rank=True)
    crowd = crowding_distance(merged, mask=rank == cut)
    cut_key = torch.where(rank == cut, -crowd, float("inf"))
    got = kt.partial_topk(cut_key, k, device=dev)
    want = kt.partial_topk_reference(cut_key, k)
    torch.cuda.synchronize()
    stats = compare_exact(f"partial_topk, main-path cut key n={n} k={k}", got, want)
    stats["ms"] = _time_ms(lambda: kt.partial_topk(cut_key, k, device=dev), 3, 20)
    stats["plain_ms"] = _time_ms(lambda: kt.partial_topk_reference(cut_key, k), 3, 20)
    # the library call: torch.topk's tie order is unspecified, so it computes
    # the same set of values but not necessarily the same indices
    stats["library_ms"] = _time_ms(lambda: torch.topk(cut_key, k, largest=False), 3, 20)
    nbytes, ops = topk_work(n, k)
    stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
    stats["bytes"], stats["ops"] = nbytes, ops
    stats["cut_front"] = int((rank == cut).sum())
    plan = kt.launch_plan(n, k)
    stats["block"] = {key: plan[key] for key in ("route", "sort", "threads", "launches", "smem_bytes",
                                                 "scratch_words")}
    from evox_tpu_torch.kernels import _build

    # ptxas's registers and spills of every topk kernel; none may spill
    ptxas = {}
    for name, rep in ptxas_functions(_build.build_log("topk") or "").items():
        found = re.search(r"\d+((?:small|block_sort|select|compact_count|compact_scatter|sort_count|"
                          r"sort_scan|sort_scatter|emit|empty)_kernel|block_sort_pass)(?:ILi(\d+)E)?",
                          name)
        ptxas[f"{found.group(1)}<{found.group(2)}>" if found and found.group(2) else
              found.group(1) if found else name] = rep
    for key in ptxas:
        check_no_spill(ptxas, f"topk {key}", key)
    stats["block"]["ptxas"] = ptxas
    # the card's floor under any call that launches: one empty kernel
    stats["empty_launch_ms"] = _time_ms(lambda: kt.empty_launch(100, dev), 2, 5) / 100
    # and at n 1e6, k n/2 (distinct values), beside the library call
    inf_share = 1.0 - stats["cut_front"] / n
    n_ninf = int((cut_key == float("-inf")).sum())
    big = topk_values(torch, "distinct", 10**6, seed, inf_share, n_ninf).to(dev)
    stats["ms_1e6"] = _time_ms(lambda: kt.partial_topk(big, 10**6 // 2, device=dev), 2, 10)
    stats["library_ms_1e6"] = _time_ms(lambda: torch.topk(big, 10**6 // 2, largest=False), 2, 10)
    del big
    results["partial_topk"] = stats
    results.update(topk_stress(torch, kt, dev, seed, inf_share, n_ninf))
    return results


def nsga2_breakdown(torch, wf, state, reps: int = 5) -> dict:
    """Median host-clock ms of each stage of one generation, each stage
    synchronised on both sides: ask (mating and variation), LSMOP1, the
    whole tell, and inside the tell packed_dominance, the sort (the kernel
    and the peel loop), and partial_topk on the cut key."""
    import statistics

    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.kernels import topk as kt
    from evox_tpu_torch.operators.selection import crowding_distance, non_dominated_sort

    algo, prob = wf.algorithm, wf.problem
    k = algo.pop_size
    times = {name: [] for name in ("ask", "evaluate", "tell", "packed_dominance", "sort",
                                   "partial_topk")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        off, astate = timed("ask", lambda: algo.ask(state.algo))
        fit, _ = timed("evaluate", lambda: prob.evaluate(state.prob, off))
        timed("tell", lambda: algo.tell(astate, fit))
        merged = torch.cat([astate.fitness, fit])
        timed("packed_dominance", lambda: kd.packed_dominance(merged, device=merged.device))
        rank, cut = timed("sort", lambda: non_dominated_sort(merged, until=k, return_cut_rank=True))
        crowd = crowding_distance(merged, mask=rank == cut)
        cut_key = torch.where(rank == cut, -crowd, float("inf"))
        timed("partial_topk", lambda: kt.partial_topk(cut_key, k, device=merged.device))
    out = {name: statistics.median(v) for name, v in times.items()}
    out["peel"] = out["sort"] - out["packed_dominance"]
    out["tell_rest"] = out["tell"] - out["sort"] - out["partial_topk"]
    return out


def phase_nsga2_path(torch, wf, gens: int, seed: int, profile: bool) -> dict:
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.kernels import topk as kt
    from evox_tpu_torch.operators.selection import (crowding_distance, non_dominated_sort,
                                                    rank_crowding_truncate)

    algo = wf.algorithm
    state = wf.step(wf.init(seed))  # init step: evaluate the parents, sort them
    state = wf.step(state)  # warm-up generation
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": gens, "partial_topk": gens,
            "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} NSGA-II generations: {launches}, expected {want}")
    if state.generation != gens + 2:
        raise AssertionError(f"generation {state.generation} != {gens + 2}")
    flags, fronts = state.monitors[0]
    if not all(bool(f) for f in flags):
        raise AssertionError("non-finite fitness on the NSGA-II path")
    fronts = [int(f) for f in fronts[-gens:]]  # the timed generations
    pop = state.algo.population
    if not (torch.isfinite(state.algo.fitness).all() and (pop >= algo.lb).all()
            and (pop <= algo.ub).all()):
        raise AssertionError("the final population leaves the bounds or its fitness is not finite")

    # one tell on the card against the same tell on the CPU's plain routes
    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    on_card = algo.tell(astate, fit)
    cpu_algo = NSGA2(algo.lb.cpu(), algo.ub.cpu(), n_objs=algo.n_objs, pop_size=algo.pop_size,
                     use_kernel=True, device="cpu")
    cpu_state = astate.replace(**{f: getattr(astate, f).cpu() for f in
                                  ("population", "fitness", "offspring", "rank", "crowd")})
    t_cpu = time.perf_counter()
    on_cpu = cpu_algo.tell(cpu_state, fit.cpu())
    cpu_tell_s = time.perf_counter() - t_cpu
    tell_stats = compare_exact(
        "NSGA-II tell on the card against the CPU's plain routes (population, fitness, rank)",
        [on_card.population.cpu(), on_card.fitness.cpu(), on_card.rank.cpu()],
        [on_cpu.population, on_cpu.fitness, on_cpu.rank])
    crowd_card, crowd_cpu = on_card.crowd.cpu(), on_cpu.crowd
    finite = torch.isfinite(crowd_cpu)
    if not torch.equal(torch.isfinite(crowd_card), finite) or not torch.equal(
            crowd_card[~finite], crowd_cpu[~finite]):
        raise AssertionError("NSGA-II tell: the infinite crowding distances differ")
    # the same float32 operations on both devices; the tolerance allows an
    # ulp of the division, which no run has shown
    tell_stats["crowd"] = compare("NSGA-II tell crowd (finite entries), card against CPU",
                                  crowd_card[finite], crowd_cpu[finite], rtol=1e-6, atol=0.0)
    tell_stats["cpu_tell_s"] = cpu_tell_s

    # partial_topk on this late generation's cut key (the first
    # generation's is checked in phase_nsga2_kernels)
    merged = torch.cat([astate.fitness, fit])
    rank, cut = non_dominated_sort(merged, until=algo.pop_size, return_cut_rank=True)
    crowd = crowding_distance(merged, mask=rank == cut)
    cut_key = torch.where(rank == cut, -crowd, float("inf"))
    late_topk = compare_exact(
        f"partial_topk, cut key after {state.generation} generations n={merged.shape[0]} "
        f"k={algo.pop_size}", kt.partial_topk(cut_key, algo.pop_size, device=cut_key.device),
        kt.partial_topk_reference(cut_key, algo.pop_size))
    late_topk["cut_front"] = int((rank == cut).sum())

    # the lexsort truncation against the partial-top-k one, same input
    o_lex, r_lex = rank_crowding_truncate(merged, algo.pop_size, use_kernel=False)
    o_top, r_top = rank_crowding_truncate(merged, algo.pop_size, use_kernel=True)
    lex = dict(zip(o_lex.tolist(), r_lex.tolist()))
    top = dict(zip(o_top.tolist(), r_top.tolist()))
    if lex != top or len(top) != algo.pop_size:
        raise AssertionError("lexsort and partial-top-k truncation keep different survivors")
    print(f"[compare] truncation, lexsort against partial-top-k: {len(top)} survivors, "
          "same set and ranks", flush=True)

    out = {
        "generations": gens,
        "pop": algo.pop_size,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "generations_per_s": gens / wall,
        "fronts_peeled": fronts,
        "tell_vs_cpu": tell_stats,
        "late_cut_key_topk": late_topk,
        "breakdown_ms": nsga2_breakdown(torch, wf, state),
    }
    if profile:
        prof = profile_generations(torch, wf, state, 5)
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


# ----------------------------------------------------------- main path 3


def build_walker_path(torch, pop: int = WALKER_POP, T: int = WALKER_T, device=None,
                      algorithm=None, weight_dtype=None):
    """Main path 3 as a user builds it: ``(workflow, make_problem, adapter)``.
    ``algorithm(dim, pop, device)`` builds the algorithm in OpenES's place
    (main path 6: PGPE); ``weight_dtype=torch.bfloat16`` is main path 13's
    bf16 policy residency (``fused_planes_dtype``); ``pop``, ``T`` and
    ``device`` exist for a rehearsal on the CPU at a small size; the chip
    run takes the defaults."""
    from evox_tpu_torch import Monitor, StdWorkflow
    from evox_tpu_torch.algorithms.so.es import OpenES
    from evox_tpu_torch.kernels import rollout_mlp as km
    from evox_tpu_torch.problems.neuroevolution import PolicyRolloutProblem, mlp_policy
    from evox_tpu_torch.utils import TreeAndVector, rank_based_fitness

    penv = km.chain_walker_planes(max_steps=T)
    init_params, apply = mlp_policy(WALKER_SIZES)
    adapter = TreeAndVector(init_params(SEED, device=device))

    def make_problem(fused, max_episode_length=None):
        return PolicyRolloutProblem(
            apply, penv.base, num_episodes=1, stochastic_reset=False,
            max_episode_length=max_episode_length, fused_planes=penv if fused else None,
            fused_planes_dtype=weight_dtype if fused else None, device=device,
        )

    class FitnessRecorder(Monitor):
        """Each generation's raw fitness, kept on the card: no work and no
        host read inside a run. With ``keep_nonfinite`` set (a replay after
        the timed run), also the candidates whose fitness is not finite, for
        the explosion check; finding them reads one count a generation."""

        keep_nonfinite = False

        def init(self, seed=None):
            return ()

        def hooks(self):
            return ("post_eval",)

        def post_eval(self, mstate, cand, fitness):
            kept = None
            if self.keep_nonfinite:
                bad = (~torch.isfinite(fitness)).nonzero()[:, 0]
                if bad.numel():
                    kept = ([{k: v[bad].clone() for k, v in layer.items()} for layer in cand],
                            fitness[bad].clone())
            return mstate + ((fitness, kept),)

    if algorithm is None:
        algo = OpenES(torch.zeros(adapter.dim), pop, learning_rate=0.05, noise_stdev=0.05,
                      device=device)
    else:
        algo = algorithm(adapter.dim, pop, device)
    wf = StdWorkflow(algo, make_problem(True), monitors=[FitnessRecorder()],
                     opt_direction="max", pop_transforms=(adapter.batched_to_tree,),
                     fit_transforms=(rank_based_fitness,), device=device)
    return wf, make_problem, adapter


def mlp_rollout_work(sizes, n: int, episodes: int, steps: int, n_masses: int, act_dim: int,
                     substeps: int) -> tuple:
    """(bytes, operations) of a fused walker rollout:
    ``kernels/rollout_mlp.py``'s count, the one the cost analysis charges."""
    from evox_tpu_torch.kernels.rollout_mlp import mlp_rollout_work as work

    return work(sizes, n, episodes, steps, n_masses, act_dim, substeps)


def ptxas_functions(log: str) -> dict:
    """ptxas's report per kernel function in an nvcc log: registers a
    thread and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def walker_block_shape(km, sizes, linear=(), weight_dtype=None) -> dict:
    """The walker kernel's block shape at ``sizes`` and residency: the
    plan's instance, threads, registers, shared memory and blocks an SM, the
    blocks an SM the runtime reports for that instance, and ptxas's
    registers and spills of all four instances ("main", "generic", and
    their "_bf16" residencies)."""
    import ctypes

    from evox_tpu_torch.kernels import _build

    plan = km.fused_rollout_analysis(sizes, linear=linear, weight_dtype=weight_dtype)
    bf16 = plan["weight_dtype"] == "torch.bfloat16"
    fn = _build.function("rollout_mlp", "evox_mlp_rollout_blocks_per_sm", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    _build.check_launch("rollout_mlp", fn(int(plan["instance"] == "main"), int(bf16),
                                          plan["threads_per_block"],
                                          plan["smem_bytes_per_block"], ctypes.byref(blocks)),
                        "occupancy query")
    ptxas = {}
    for name, rep in ptxas_functions(_build.build_log("rollout_mlp") or "").items():
        # mlp_rollout_kernel<true, float> (the main instance) mangles to
        # ...ILb1EfE..., its bf16 residency to ...ILb1E13__nv_bfloat16E...
        kind = "main" if "ILb1E" in name else "generic" if "ILb0E" in name else name
        ptxas[kind + ("_bf16" if "bfloat16" in name else "")] = rep
    return {"instance": plan["instance"], "weight_dtype": plan["weight_dtype"],
            "threads": plan["threads_per_block"], "slices": plan["slices"],
            "smem_bytes": plan["smem_bytes_per_block"],
            "planned_registers": plan["registers_per_thread"],
            "planned_blocks_per_sm": plan["blocks_per_sm"],
            "runtime_blocks_per_sm": blocks.value, "ptxas": ptxas}


def check_exploded(torch, name: str, totals, exploded) -> int:
    """A non-finite return is allowed only where the env exploded (its state
    went non-finite or beyond the bound); returns how many there were."""
    bad = ~torch.isfinite(totals)
    if bool((bad & ~exploded).any()):
        raise AssertionError(f"{name}: non-finite returns from envs that did not explode")
    return int(bad.sum())


def walker_stress_inputs(torch, km, sizes, n: int, episodes: int, T: int, w_scale: float,
                         seed: int, dev, **walker):
    """Large random weights given through strided views, and resets pushed
    to every end of an episode: every 7th env with two masses on one spot
    (the torque term hits its 1e6 cap and the chain explodes), every 11th
    with a NaN velocity, every 13th fallen, every 17th done from the start,
    every 19th two steps from the time limit, every 23rd moved beyond the
    1e3 bound."""
    penv = km.chain_walker_planes(max_steps=T, **walker)
    g = torch.Generator(device=dev).manual_seed(seed)
    weights = tuple((w_scale * torch.randn(n, fi, fo, generator=g, device=dev)).permute(1, 2, 0)
                    for fi, fo in zip(sizes[:-1], sizes[1:]))
    biases = tuple((0.1 * torch.randn(n, fo, generator=g, device=dev)).T for fo in sizes[1:])
    states = penv.base.reset(g, episodes * n, dev)
    planes = penv.to_planes(states)
    idx = torch.arange(episodes * n, device=dev)
    for k, col in (("px", 4), ("py", 4)):
        planes[k][col] = torch.where(idx % 7 == 0, planes[k][col - 1], planes[k][col])
    planes["vx"][2] = torch.where(idx % 11 == 0, float("nan"), planes["vx"][2])
    planes["py"] = torch.where(idx % 13 == 0, 0.3 * planes["py"], planes["py"])
    planes["done"] = (idx % 17 == 0).float()[None]
    planes["t"] = torch.where(idx % 19 == 0, float(T - 2), planes["t"][0])[None]
    planes["px"] = torch.where(idx % 23 == 0, planes["px"] + 2e3, planes["px"])
    return dict(weights=weights, biases=biases, init_state=planes, T=T, sizes=sizes, env=penv,
                episodes=episodes)


def phase_walker_kernels(torch, wf, adapter, seed: int, prefix: str = "walker") -> dict:
    """Hold fused_mlp_rollout against fused_mlp_rollout_plain on the card,
    on the main path's first-generation inputs and on stress inputs, at the
    path's residency (path 3: float32; path 13, ``prefix`` "walker_bf16":
    bfloat16)."""
    from evox_tpu_torch.kernels import rollout_mlp as km

    dev = wf.device
    weight_dtype = wf.problem.fused_planes_dtype
    results = {}
    state = wf.init(seed)
    pop, _ = wf.algorithm.ask(state.algo)
    kw = wf.problem.fused_planes_inputs(state.prob, adapter.batched_to_tree(pop))
    plain_kw = {k: v for k, v in kw.items() if k != "device"}
    got = km.fused_mlp_rollout(**kw)
    torch.cuda.synchronize()
    want, steps, exploded = km.fused_mlp_rollout_plain(**plain_kw, stats=True)
    torch.cuda.synchronize()
    n, ep, T = pop.shape[0], kw["episodes"], kw["T"]
    # bit for bit: the kernel does the plain version's operations in its
    # fixed order, each rounded on its own (no FMA contraction)
    stats = compare_exact(f"fused_mlp_rollout ({prefix}), main-path inputs n={n} ep={ep} T={T}",
                          [got], [want])
    stats["nonfinite"] = check_exploded(torch, "main-path inputs", got, exploded)
    stats["ms"] = _time_ms(lambda: km.fused_mlp_rollout(**kw), 2, 10)
    # T = 0: the launch, the policy copies and the state loads alone; the
    # rest of "ms" is the episodes' steps
    stats["copy_only_ms"] = _time_ms(lambda: km.fused_mlp_rollout(**dict(kw, T=0)), 2, 10)
    stats["plain_ms"] = _time_ms(lambda: km.fused_mlp_rollout_plain(**plain_kw), 1, 2)
    live = int(steps.sum())  # the env-steps this data needs
    cfg = kw["env"].config
    nbytes, ops = mlp_rollout_work(kw["sizes"], n, ep, live, cfg["n_masses"], cfg["act_dim"],
                                   cfg["substeps"])
    stats["bound_ms"], stats["bound_by"] = bound_ms(nbytes, ops)
    stats.update(bytes=nbytes, ops=ops, live_steps=live, mean_episode_length=live / (n * ep),
                 exploded=int(exploded.sum()), mean_return=float(want.mean()),
                 block=walker_block_shape(km, kw["sizes"], kw["linear"], weight_dtype))
    print(f"[{prefix} kernel] {json.dumps(stats)}", flush=True)
    del got, want, kw, plain_kw, pop
    results[prefix] = stats

    for i, (name, sizes, sn, sep, sT, scale, linear, walker) in enumerate(WALKER_STRESS):
        skw = walker_stress_inputs(torch, km, sizes, sn, sep, sT, scale, seed + i, dev, **walker)
        skw.update(linear=linear, weight_dtype=weight_dtype)
        got = km.fused_mlp_rollout(**skw, device=dev)
        torch.cuda.synchronize()
        want, steps, exploded = km.fused_mlp_rollout_plain(**skw, stats=True)
        torch.cuda.synchronize()
        label = (f"fused_mlp_rollout ({prefix}), stress: {name}, sizes {sizes} n={sn} ep={sep} "
                 f"T={sT}")
        st = compare_exact(label, [got], [want])
        st.update(nonfinite=check_exploded(torch, label, got, exploded),
                  exploded=int(exploded.sum()), mean_episode_length=float(steps.float().mean()))
        if not st["exploded"] or not (steps < sT).any():
            raise AssertionError(f"{label}: the stress inputs ended no episode early")
        results[f"{prefix}_stress_{i}"] = st

    # the main path's instance keeps its plan: no spill, its registers, its
    # blocks an SM (a fall to two undoes the register-held layer)
    block = stats["block"]
    main = block["ptxas"].get("main_bf16" if weight_dtype is not None else "main", {})
    if (block["instance"] != "main" or main.get("spill_stores", 1) or main.get("spill_loads", 1)
            or main.get("registers", 999) > block["planned_registers"]
            or block["runtime_blocks_per_sm"] != block["planned_blocks_per_sm"]):
        raise AssertionError(f"the walker kernel's main instance misses its plan: {block}")
    return results


def phase_walker_turns(torch, seed: int, gens: int = 10, **build) -> dict:
    """Paths 3 (float32 residency) and 13 (bfloat16) in turns, f32, bf16,
    bf16, f32, each from a fresh workflow: ms a generation of ``run`` after a
    warm-up step, B2's ms at that turn's first-generation inputs (CUDA
    events) and peak device memory of the run."""
    from evox_tpu_torch.kernels import rollout_mlp as km

    turns = []
    for dtype in (None, torch.bfloat16, torch.bfloat16, None):
        wf, _, adapter = build_walker_path(torch, weight_dtype=dtype, **build)
        state = wf.init(seed)
        pop, _ = wf.algorithm.ask(state.algo)
        kw = wf.problem.fused_planes_inputs(state.prob, adapter.batched_to_tree(pop))
        kernel_ms = _time_ms(lambda: km.fused_mlp_rollout(**kw), 1, 5)
        del pop, kw
        state = wf.step(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wf.run(state, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        turns.append({"weight_dtype": str(dtype or torch.float32), "kernel_ms": kernel_ms,
                      "ms_per_generation": wall / gens * 1e3,
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        print(f"[walker turn] {json.dumps(turns[-1])}", flush=True)
        del wf, state, adapter
        torch.cuda.empty_cache()
    return {"generations": gens, "turns": turns}


def phase_walker_path(torch, wf, make_problem, adapter, gens: int, seed: int,
                      profile: bool) -> dict:
    from evox_tpu_torch.kernels import rollout_mlp as km

    on_card = wf.device.type == "cuda"  # False only in a rehearsal on the CPU
    state = wf.init(seed)
    center0 = state.algo.center.clone()
    state = wf.step(state)  # warm-up
    before = state  # states are not changed in place: a replay starts here
    torch.cuda.synchronize()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0,
            "fused_mlp_rollout": gens}
    if launches != want:
        raise AssertionError(f"launches in {gens} walker generations: {launches}, expected {want}")
    if state.generation != gens + 1:
        raise AssertionError(f"generation {state.generation} != {gens + 1}")
    fitness = torch.stack([f for f, _ in state.monitors[0][-gens:]])  # (gens, pop)
    finite = torch.isfinite(fitness)
    means = (torch.where(finite, fitness, 0.0).sum(1) / finite.sum(1).clamp_min(1)).tolist()
    if not finite.any(1).all():
        raise AssertionError("no finite fitness in a generation of the walker path")
    nonfinite = int((~finite).sum())
    if nonfinite:
        # non-finite fitness only where the env exploded: replay the timed
        # generations, untimed, keeping the candidates at fault
        wf.monitors[0].keep_nonfinite = True
        replay = wf.run(before, gens)
        wf.monitors[0].keep_nonfinite = False
        records = replay.monitors[0][-gens:]
        compare_exact("walker main path, replayed fitness", [f for f, _ in records],
                      list(fitness))
        for _, kept in records:
            if kept is not None:
                tree, fit = kept
                kw = wf.problem.fused_planes_inputs(replay.prob, tree)
                kw.pop("device")
                _, _, exploded = km.fused_mlp_rollout_plain(**kw, stats=True)
                check_exploded(torch, "walker main path", fit, exploded)
    moved = float((state.algo.center - center0).norm())
    if not (moved > 0 and math.isfinite(moved)):
        raise AssertionError(f"the center did not move (|delta| = {moved})")

    # the episode lengths of the last population, from the plain version
    pop, _ = wf.algorithm.ask(state.algo)
    kw = wf.problem.fused_planes_inputs(state.prob, adapter.batched_to_tree(pop))
    kw.pop("device")
    _, steps, _ = km.fused_mlp_rollout_plain(**kw, stats=True)
    del pop, kw

    # the repo's own means: fused engine == scan engine on the same resets,
    # up to float rounding (the scan engine's matmuls sum in another order);
    # JAX's own tolerance (tests/test_kernels_mlp.py:158-160)
    dev = wf.device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    small = state.algo.center + 0.05 * torch.randn(512, adapter.dim, generator=g, device=dev)
    if wf.problem.fused_planes_dtype is not None:
        # bf16 residency: both engines see the genomes as the kernel keeps
        # them (rounding again in the kernel is then the identity)
        small = small.to(wf.problem.fused_planes_dtype).float()
    tree = adapter.batched_to_tree(small)
    pstate = wf.problem.init(seed)
    f_fused, _ = make_problem(True, 25).evaluate(pstate, tree)
    f_scan, _ = make_problem(False, 25).evaluate(pstate, tree)
    torch.cuda.synchronize()
    engines = compare("walker fused engine vs scan engine, pop 512, T 25", f_fused, f_scan,
                      rtol=2e-3, atol=2e-3)
    pop_size = wf.algorithm.pop_size
    out = {
        "generations": gens,
        "pop": pop_size,
        "episodes": wf.problem.num_episodes,
        "T": wf.problem.max_len,
        "launches": launches["fused_mlp_rollout"],
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "evals_per_s": gens * pop_size / wall,
        "mean_fitness_first": means[0],
        "mean_fitness_last": means[-1],
        "nonfinite_fitness": nonfinite,
        "mean_episode_length_last": float(steps.float().mean()),
        "peak_memory_gb": peak_gb,  # of the timed generations (the state included)
        "center_moved": moved,
        "engines": engines,
    }
    if profile:
        prof = profile_generations(torch, wf, state, 5)
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


def phase_normalizer(torch, seed: int, pop: int = NORM_POP, gens: int = NORM_GENERATIONS,
                     device=None) -> dict:
    """The scan engine with CapEpisode and ObsNormalizer on the card
    (cartpole(500), flat 4-16-2 MLP, 2 episodes, ``gens`` evaluations of one
    population), then the helpers on the card against the CPU on the card's
    own inputs of the last evaluation (its episode lengths and moments):
    the new cap equal, the merged (count, mean, m2) and a batch normalised
    with them within 1e-6 relative (the same elementwise float32 operations
    on both; the moments' sums were taken on the card only)."""
    from evox_tpu_torch.problems.neuroevolution import (
        CapEpisode,
        ObsNormalizer,
        PolicyRolloutProblem,
        flat_mlp_policy,
    )
    from evox_tpu_torch.problems.neuroevolution.control import cartpole

    dev = torch.device("cuda") if device is None else torch.device(device)
    env = cartpole(500)
    apply, dim = flat_mlp_policy(4, 16, 2)
    cap, norm = CapEpisode(NORM_CAP), ObsNormalizer(4)
    seen = {}
    update, merge = cap.update, norm.merge_moments
    cap.update = lambda c, lengths: seen.update(cap=(c, lengths)) or update(c, lengths)
    norm.merge_moments = lambda st, *m: seen.update(norm=(st, m)) or merge(st, *m)
    prob = PolicyRolloutProblem(apply, env, num_episodes=2, cap_episode=cap, obs_normalizer=norm,
                                device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    population = 0.5 * torch.randn(pop, dim, generator=g, device=dev)
    state, caps, counts = prob.init(seed), [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(gens):
        fitness, state = prob.evaluate(state, population)
        caps.append(int(state.cap))
        counts.append(float(state.norm[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(fitness).all()):
        raise AssertionError("non-finite fitness on the normaliser phase")
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else tuple(y.cpu() for y in x)
    c_in, lengths = seen["cap"]
    n_in, moments = seen["norm"]
    if float(moments[0]) != float(lengths.sum()):
        raise AssertionError("the normaliser counted other steps than the live ones")
    out = {"pop": pop, "episodes": 2, "evaluations": gens, "ms_per_evaluation": wall / gens * 1e3,
           "caps": caps, "counts": counts, "mean_episode_length": float(lengths.float().mean())}
    new_cap, want_cap = update(c_in, lengths), update(cpu(c_in), cpu(lengths))
    if int(new_cap) != int(want_cap):
        raise AssertionError(f"CapEpisode.update: card {int(new_cap)} != CPU {int(want_cap)}")
    got = merge(n_in, *moments)
    want = merge(cpu(n_in), *cpu(moments))
    out["merge_moments"] = compare("ObsNormalizer.merge_moments, card vs CPU",
                                   torch.cat([x.reshape(-1).cpu() for x in got]),
                                   torch.cat([x.reshape(-1) for x in want]), rtol=1e-6, atol=0.0)
    obs = env.obs(env.reset(g, pop, dev)) * 20.0
    out["normalize"] = compare("ObsNormalizer.normalize, card vs CPU",
                               norm.normalize(got, obs).cpu(), norm.normalize(want, obs.cpu()),
                               rtol=1e-6, atol=1e-7)
    out["cap"] = int(new_cap)
    print(f"[normalizer] {json.dumps(out)}", flush=True)
    return out


# ----------------------------------------------------------- main path 4


def build_cso_path(torch, pop: int = CSO_POP, dim: int = CSO_DIM, monitor: bool = False,
                   algo_cls=None, device=None):
    """Main path 4 as a user builds it (``bench.py:134-185``): ``(workflow,
    monitor or None)``. ``algo_cls`` swaps in a CSO variant (the replay
    form); ``pop``, ``dim`` and ``device`` exist for a rehearsal on the CPU
    at a small size."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.pso import CSO
    from evox_tpu_torch.monitors import EvalMonitor
    from evox_tpu_torch.problems.numerical import Ackley

    cls = algo_cls or CSO
    bound = torch.full((dim,), CSO_BOUND)
    algo = cls(lb=-bound, ub=bound, pop_size=pop, device=device)
    mon = EvalMonitor(topk=MONITOR_TOPK, device=device) if monitor else None
    wf = StdWorkflow(algo, Ackley(), monitors=[mon] if monitor else [], device=device)
    return wf, mon


def replay_cso_class():
    """CSO whose ``tell`` replays ``ask``'s pass from the generation seed,
    the JAX package's design (``evox_tpu/algorithms/so/pso/cso.py:142-159``),
    in place of taking the pass that ``ask`` kept: timed beside the port's
    form, with the same numbers."""
    from evox_tpu_torch.algorithms.so.pso import CSO

    class ReplayCSO(CSO):
        def ask(self, state):
            cand, state = super().ask(state)
            return cand, state.replace(pending=None)

        def tell(self, state, fitness):
            done = self._pair_pass(state, *self._draw(state.pair_seed))
            return super().tell(state.replace(pending=done), fitness)

    return ReplayCSO


def _check_swarm(torch, name: str, algo, population) -> None:
    if not (torch.isfinite(population).all() and (population >= algo.lb).all()
            and (population <= algo.ub).all()):
        raise AssertionError(f"{name}: the population leaves the bounds or is not finite")


def phase_cso_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 4: CSO on Ackley at pop 4096, d 1024, no monitor (as
    bench.py), then the replay form against the carried one in turns."""
    wf, _ = build_cso_path(torch)
    algo = wf.algorithm
    # the init step (everyone evaluated, no pair pass), then one warm-up
    # generation: the first pair pass allocates its buffers
    state = wf.step(wf.step(wf.init(seed)))
    warm = state
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} CSO generations: {launches}, expected {want}")
    if state.generation != gens + 2:
        raise AssertionError(f"generation {state.generation} != {gens + 2}")
    _check_swarm(torch, "CSO path", algo, state.algo.population)
    if not torch.isfinite(state.algo.fitness).all():
        raise AssertionError("non-finite fitness on the CSO path")

    # the replay form against the carried one: CSO_AB_ROUNDS rounds of turns
    # carry, replay, replay, carry from the same state (the host's time
    # swings between runs); the same draws give the same numbers
    replay_wf, _ = build_cso_path(torch, algo_cls=replay_cso_class())
    turns, finals = [], {}
    order = (("carry", wf), ("replay", replay_wf), ("replay", replay_wf), ("carry", wf))
    for name, w in order * CSO_AB_ROUNDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = w.run(warm, gens)
        torch.cuda.synchronize()
        turns.append({"form": name, "ms_per_generation": (time.perf_counter() - t0) / gens * 1e3})
        finals[name] = end.algo
    compare_exact("CSO replay form against the carried form, after 20 generations",
                  [finals["replay"].population, finals["replay"].velocity, finals["replay"].fitness],
                  [finals["carry"].population, finals["carry"].velocity, finals["carry"].fitness])
    half = algo.pop_size // 2
    medians = {form: statistics.median(t["ms_per_generation"] for t in turns if t["form"] == form)
               for form in ("carry", "replay")}
    print(f"[cso path] replay against carry, medians of {2 * CSO_AB_ROUNDS} runs each: "
          f"{json.dumps(medians)}", flush=True)
    out = {
        "generations": gens,
        "pop": algo.pop_size,
        "dim": algo.dim,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "generations_per_s": gens / wall,
        "evals_per_s": gens * half / wall,
        "best_fitness_last": float(state.algo.fitness.min()),
        "replay_against_carry": turns,
        "replay_against_carry_median_ms": medians,
        "breakdown_ms": cso_breakdown(torch, wf, state),
    }
    if profile:
        prof = profile_generations(torch, wf, state, 5)
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


def cso_breakdown(torch, wf, state, reps: int = 10) -> dict:
    """Median host-clock ms of each stage of one CSO generation, each stage
    synchronised on both sides: the seed split (host only), the draw, the
    ask (the draw and the pair pass), Ackley, the tell, and a whole step."""
    from evox_tpu_torch.utils.common import split_seed

    algo, prob = wf.algorithm, wf.problem
    times = {name: [] for name in ("split_seed", "draw", "ask", "evaluate", "tell", "step")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        timed("split_seed", lambda: split_seed(state.algo.seed))
        timed("draw", lambda: algo._draw(state.algo.seed))
        cand, astate = timed("ask", lambda: algo.ask(state.algo))
        fit, _ = timed("evaluate", lambda: prob.evaluate(state.prob, cand))
        timed("tell", lambda: algo.tell(astate, fit))
        timed("step", lambda: wf.step(state))
    return {name: statistics.median(v) for name, v in times.items()}


def device_us_per_call(torch, fn, calls: int = 20) -> float:
    """Device microseconds a call of ``fn`` keeps the card busy (every kernel
    it launches, torch.profiler), without the host's side of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def host_us_per_call(torch, fn, calls: int = 500) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue, back to back
    (the card keeps up with calls this small)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def phase_cso_monitored(torch, gens: int, seed: int) -> dict:
    """The same run from a fresh state with ``EvalMonitor(topk=8)``: one
    elite update (one ``partial_topk`` launch) a generation, the best
    fitness falling, the last update held against the plain route, and B4
    timed at the monitor's shapes beside ``torch.topk``."""
    from evox_tpu_torch.kernels import topk as kt

    wf, mon = build_cso_path(torch, monitor=True)
    state = wf.step(wf.step(wf.init(seed)))  # the init step and a warm-up generation, as above
    best_warm = float(mon.get_best_fitness(state.monitors[0]))
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens - 1)
    before = state
    state = wf.step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": gens, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} monitored CSO generations: {launches}, "
                             f"expected {want}")
    best_end = float(mon.get_best_fitness(state.monitors[0]))
    print(f"[cso monitored] best fitness after the warm-up {best_warm!r}, after {gens} more "
          f"generations {best_end!r}", flush=True)
    if not best_end < best_warm:
        raise AssertionError(f"the best fitness did not fall: {best_warm} -> {best_end}")

    # the last elite update: the same generation again (the draws come from
    # the state's seeds), its merged key through the plain route
    cand, _ = wf.algorithm.ask(before.algo)
    fit, _ = wf.problem.evaluate(before.prob, cand)
    prev = before.monitors[0]
    sign = mon.opt_direction[0]
    merged_key = torch.cat([prev.topk_fitness * sign, fit * sign])
    merged_fit = torch.cat([prev.topk_fitness, fit])
    merged_sol = torch.cat([prev.topk_solution, cand])
    plain_v, plain_i = kt.partial_topk_reference(merged_key, MONITOR_TOPK)
    last = state.monitors[0]
    elite = compare_exact(
        f"EvalMonitor elite, last update (n={merged_key.shape[0]}, k={MONITOR_TOPK}) against the "
        "plain route", [kt.partial_topk(merged_key, MONITOR_TOPK)[1], last.topk_fitness,
                        last.topk_solution],
        [plain_i, merged_fit[plain_i], merged_sol[plain_i]])

    # B4 at the monitor's shapes (n = pop/2 + topk), against torch.topk
    shapes = []
    for k in (1, MONITOR_TOPK):
        v = torch.cat([merged_key[:k], fit * sign]).contiguous()
        n = v.shape[0]
        compare_exact(f"partial_topk at the monitor's shape n={n} k={k}",
                      kt.partial_topk(v, k), kt.partial_topk_reference(v, k))
        b4 = lambda: kt.partial_topk(v, k)
        lib = lambda: torch.topk(v, k, largest=False)
        nbytes, ops = topk_work(n, k)
        row = {"n": n, "k": k, "ms": _time_ms(b4, 20, 200), "library_ms": _time_ms(lib, 20, 200),
               "device_us": device_us_per_call(torch, b4),
               "library_device_us": device_us_per_call(torch, lib),
               "host_us": host_us_per_call(torch, b4), "library_host_us": host_us_per_call(torch, lib),
               "plain_ms": _time_ms(lambda: kt.partial_topk_reference(v, k), 5, 50)}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops)
        print(f"[monitor topk] {json.dumps(row)}", flush=True)
        shapes.append(row)
    return {
        "generations": gens,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "best_fitness_warmup": best_warm,
        "best_fitness_end": best_end,
        "last_elite_update": elite,
        "topk_at_monitor_shapes": shapes,
    }


def phase_cso_card_vs_cpu(torch, seed: int) -> dict:
    """One CSO generation on the card against the same generation on the
    CPU, from the same first-generation state with the draws made on the
    CPU and moved to the card."""
    from evox_tpu_torch.problems.numerical import ackley_func

    wf_cpu, _ = build_cso_path(torch, device="cpu")
    wf_card, _ = build_cso_path(torch)
    cpu, card = wf_cpu.algorithm, wf_card.algorithm
    state = cpu.init(seed)
    cand, state = cpu.init_ask(state)
    state = cpu.init_tell(state, ackley_func(cand))
    card_state = state.replace(population=state.population.cuda(), velocity=state.velocity.cuda(),
                               fitness=state.fitness.cuda())
    draws = cpu._draw(seed + 1)
    cpu._draw = lambda s: draws
    card._draw = lambda s: tuple(d.cuda() for d in draws)
    results = {}
    for name, algo, st in (("cpu", cpu, state), ("card", card, card_state)):
        c, st = algo.ask(st)
        st = algo.tell(st, ackley_func(c))
        results[name] = st
    got, want = results["card"], results["cpu"]
    # phi = 0 (bench.py's CSO): positions and velocities are the same
    # elementwise float32 operations on both devices, one rounding each, on
    # the same draws: bit for bit. The new fitness is Ackley's two means over
    # d 1024, which the card sums in another order: n·eps ≈ 1.2e-4 relative
    # in a mean at worst, shrunk by Ackley's outer terms (its value ~20 here
    # moves by less than 1e-5 relative for such an error)
    out = {"population": compare("CSO generation, population, card against CPU",
                                 got.population.cpu(), want.population, rtol=0.0, atol=0.0),
           "velocity": compare("CSO generation, velocity, card against CPU",
                               got.velocity.cpu(), want.velocity, rtol=0.0, atol=0.0),
           "fitness": compare("CSO generation, fitness, card against CPU",
                              got.fitness.cpu(), want.fitness, rtol=1e-5, atol=0.0)}
    return out


def phase_pso_family(torch, gens: int, seed: int) -> dict:
    """Every other algorithm of the PSO family for a few generations on the
    card: Sphere, pop 1024, d 100, an EvalMonitor on each (FIPS on the ring,
    DMS-PSO-EL in sub-swarms of 16 so that they divide 1024)."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so import pso
    from evox_tpu_torch.monitors import EvalMonitor
    from evox_tpu_torch.problems.numerical import Sphere

    lb, ub = torch.full((PSO_DIM,), -10.0), torch.full((PSO_DIM,), 10.0)
    n = PSO_POP
    makers = {
        "PSO": lambda: pso.PSO(lb, ub, n),
        "CLPSO": lambda: pso.CLPSO(lb, ub, n),
        "SLPSOGS": lambda: pso.SLPSOGS(lb, ub, n),
        "SLPSOUS": lambda: pso.SLPSOUS(lb, ub, n),
        "FIPS (ring)": lambda: pso.FIPS(lb, ub, n, topology="ring"),
        "DMSPSOEL": lambda: pso.DMSPSOEL(lb, ub, n, sub_swarm_size=16),
        "FSPSO": lambda: pso.FSPSO(n, PSO_DIM),
        "SwmmPSO": lambda: pso.SwmmPSO(lb, ub, n),
        "SwmmPSO (shortcuts)": lambda: pso.SwmmPSO(lb, ub, n, shortcut_p=0.05),
    }
    out = {}
    for name, make in makers.items():
        algo = make()
        mon = EvalMonitor()
        wf = StdWorkflow(algo, Sphere(), monitors=[mon])
        state = wf.step(wf.init(seed))
        best_warm = float(mon.get_best_fitness(state.monitors[0]))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = wf.run(state, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if launches["partial_topk"] != gens:
            raise AssertionError(f"{name}: {launches} in {gens} monitored generations")
        best = float(mon.get_best_fitness(state.monitors[0]))
        if not (math.isfinite(best) and best <= best_warm):
            raise AssertionError(f"{name}: best fitness {best_warm} -> {best}")
        _check_swarm(torch, name, algo, state.algo.population)
        row = {"pop": n, "dim": PSO_DIM, "generations": gens, "ms_per_generation": wall / gens * 1e3,
               "best_fitness_warmup": best_warm, "best_fitness": best}
        print(f"[pso family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row
    return out


def phase_monitor_archive(torch, wf, seed: int) -> dict:
    """The EvalMonitor Pareto archive (pf_capacity 1024) on the card
    against the CPU's plain route, on the NSGA-II path's fitness: the
    parents' batch of 10000, then the offspring's; B3 runs at n 11024."""
    from evox_tpu_torch.monitors import EvalMonitor

    state = wf.step(wf.init(seed))  # the init step: the parents evaluated
    off, _ = wf.algorithm.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    batches = [(state.algo.population, state.algo.fitness), (off, fit)]
    card = EvalMonitor(multi_obj=True, pf_capacity=ARCHIVE_CAP)
    cpu = EvalMonitor(multi_obj=True, pf_capacity=ARCHIVE_CAP, device="cpu")
    s_card, s_cpu = card.init(), cpu.init()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for cand, f in batches:
        s_card = card.post_eval(s_card, cand, f)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {"fused_rollout": 0, "packed_dominance": 2, "partial_topk": 0, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in two archive updates: {launches}, expected {want}")
    for cand, f in batches:
        s_cpu = cpu.post_eval(s_cpu, cand.cpu(), f.cpu())
    # B3 alone at the second update's merged fitness (the archive after the
    # first batch, then the offspring's)
    from evox_tpu_torch.kernels import dominance as kd

    merged = torch.cat([card.post_eval(card.init(), *batches[0]).topk_fitness, batches[1][1]])
    b3 = {"ms": _time_ms(lambda: kd.packed_dominance(merged), 3, 20)}
    b3["bound_ms"], b3["bound_by"] = bound_ms(*dominance_work(*merged.shape))
    stats = compare_exact(
        f"EvalMonitor archive (cap {ARCHIVE_CAP}, n {ARCHIVE_CAP + f.shape[0]}) on the card "
        "against the CPU's plain route (fitness, solutions, pf_count)",
        [s_card.topk_fitness, s_card.topk_solution, s_card.pf_count],
        [s_cpu.topk_fitness, s_cpu.topk_solution, s_cpu.pf_count])
    stats.update({"n": ARCHIVE_CAP + f.shape[0], "m": f.shape[1], "launches": launches,
                  "pf_count": int(s_card.pf_count), "ms_per_update": wall / len(batches) * 1e3,
                  "packed_dominance": b3})
    return stats


# ----------------------------------------------------------- main path 5


def build_cmaes_path(torch, dim: int = CMAES_DIM, device=None):
    """Main path 5 as a user builds it: ``StdWorkflow(CMAES(full(dim, 3.0),
    1.0), Rastrigin())``, pop and decomposition period at their defaults.
    ``dim`` and ``device`` exist for a rehearsal on the CPU."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import CMAES
    from evox_tpu_torch.problems.numerical import Rastrigin

    algo = CMAES(torch.full((dim,), CMAES_CENTER), init_stdev=1.0, device=device)
    return StdWorkflow(algo, Rastrigin(), device=device)


def count_decompositions(algo) -> list:
    """Wrap ``algo._decompose`` to count its calls; returns the counter (a
    one-element list)."""
    calls = [0]
    decompose = algo._decompose

    def counted(C):
        calls[0] += 1
        return decompose(C)

    algo._decompose = counted
    return calls


def cmaes_breakdown(torch, wf, state, reps: int = 8) -> dict:
    """Median host-clock ms of each stage of a CMA-ES generation, each stage
    synchronised on both sides: ask, Rastrigin, tell and a whole step
    without the decomposition (from a state whose next iteration does not
    decompose), and ``safe_eigh`` of the covariance."""
    from evox_tpu_torch.algorithms.so.es.common import safe_eigh

    algo, prob = wf.algorithm, wf.problem
    period = algo.decomp_per_iter
    if (state.algo.iteration + 1) % period == 0 and period > 1:
        state = wf.step(state)
    times = {name: [] for name in ("ask", "evaluate", "tell", "step", "eigh")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        cand, astate = timed("ask", lambda: algo.ask(state.algo))
        fit, _ = timed("evaluate", lambda: prob.evaluate(state.prob, cand))
        if period > 1:
            timed("tell", lambda: algo.tell(astate, fit))
            timed("step", lambda: wf.step(state))
        timed("eigh", lambda: safe_eigh(state.algo.C, algo.cond_cap, max_dim=algo.eigh_max_dim))
    return {name: statistics.median(v) for name, v in times.items() if v}


def phase_cmaes_path(torch, seed: int, profile: bool) -> dict:
    """Main path 5: CMA-ES with dense covariance at d 1000 on Rastrigin."""
    from evox_tpu_torch.algorithms.so.es.common import safe_eigh

    wf = build_cmaes_path(torch)
    algo = wf.algorithm
    period = algo.decomp_per_iter
    gens = period * math.ceil(GENERATIONS / period)
    print(f"[cmaes path] d {algo.dim}, pop {algo.pop_size}, mu {algo.mu}, decomp_per_iter "
          f"{period}, {gens} timed generations", flush=True)
    decomps = count_decompositions(algo)
    state = wf.init(seed)
    mean0 = state.algo.mean.clone()
    state = wf.step(state)  # warm-up: iteration 1, no decomposition unless the period is 1
    # cuSOLVER's first eigh creates its handle and workspace (~0.25 s, once
    # a process): made here, on the warm-up state's C, and timed on its own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    safe_eigh(state.algo.C, algo.cond_cap, max_dim=algo.eigh_max_dim)
    torch.cuda.synchronize()
    eigh_first_ms = (time.perf_counter() - t0) * 1e3

    from evox_tpu_torch.kernels import smallmm as km

    reset_launches()  # every count to 0 just before the run
    km.smallmm.launches = 0
    decomps[0] = 0
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    m1_launches = km.smallmm.launches
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} CMA-ES generations: {launches}, expected {want}")
    # M1: the ask's product and the tell's five and |ps|, every generation
    if m1_launches != CMAES_M1_LAUNCHES * gens:
        raise AssertionError(f"{m1_launches} M1 launches in {gens} CMA-ES generations, expected "
                             f"{CMAES_M1_LAUNCHES * gens}")
    launches = {**launches, "smallmm": m1_launches}
    if decomps[0] != gens // period:
        raise AssertionError(f"{decomps[0]} decompositions in {gens} generations, expected "
                             f"{gens // period}")
    s = state.algo
    C = s.C
    asym = float((C - C.T).abs().max() / C.abs().max())
    if not (bool(torch.isfinite(C).all()) and asym <= 1e-5):
        raise AssertionError(f"the covariance is not finite and symmetric (asymmetry {asym})")
    moved = float((s.mean - mean0).norm())
    if not (moved > 0 and math.isfinite(moved)):
        raise AssertionError(f"the mean did not move (|delta| = {moved})")
    cand, _ = algo.ask(s)
    fit, _ = wf.problem.evaluate(state.prob, cand)
    if not (cand.shape == (algo.pop_size, algo.dim) and bool(torch.isfinite(fit).all())):
        raise AssertionError("non-finite fitness on the CMA-ES path")

    # one safe_eigh at d 1000: CUDA events, and the host's clock (eigh waits
    # for the host inside the call)
    eigh = lambda: safe_eigh(C, algo.cond_cap, max_dim=algo.eigh_max_dim)
    eigh_ms = _time_ms(eigh, 2, 10)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eigh()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t1) * 1e3)
    out = {
        "dim": algo.dim,
        "pop": algo.pop_size,
        "mu": algo.mu,
        "decomp_per_iter": period,
        "generations": gens,
        "decompositions": decomps[0],
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "generations_per_s": gens / wall,
        "evals_per_s": gens * algo.pop_size / wall,
        "sigma_last": float(s.sigma),
        "best_fitness_last": float(fit.min()),
        "mean_moved": moved,
        "covariance_asymmetry": asym,
        "eigh_ms": eigh_ms,
        "eigh_host_ms": statistics.median(host),
        "eigh_first_call_ms": eigh_first_ms,
        "breakdown_ms": cmaes_breakdown(torch, wf, state),
    }
    if profile:
        # one whole period, so the decompositions' share is the timed run's
        prof = profile_generations(torch, wf, state, period)
        prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
        out["profile"] = prof
    return out


def phase_cmaes_card_vs_cpu(torch, seed: int) -> dict:
    """One CMA-ES generation at d 1000 on the card against the CPU: the state
    after one decomposition period on the CPU, moved to the card, the same
    draws, the same Rastrigin fitness (the CPU's), the same (B, D). The
    card's generation runs twice, with TF32 allowed and not: CMA-ES's
    products are full float32 either way, so the two are equal bit for bit."""
    wf_cpu = build_cmaes_path(torch, device="cpu")
    cpu = wf_cpu.algorithm
    card = build_cmaes_path(torch).algorithm
    state = cpu.init(seed)
    for _ in range(cpu.decomp_per_iter):  # ends on a decomposition: B and D are not I and 1
        cand, state = cpu.ask(state)
        state = cpu.tell(state, wf_cpu.problem.evaluate(None, cand)[0])
    z = cpu._draw(seed + 1)
    cpu._draw = lambda s: z
    card._draw = lambda s: z.cuda()
    # should the compared generation decompose, both take the state's (B, D)
    cpu._decompose = lambda C: (state.B, state.D)
    card._decompose = lambda C: (state.B.cuda(), state.D.cuda())
    cand, cpu_state = cpu.ask(state)
    fit = wf_cpu.problem.evaluate(None, cand)[0]
    want = cpu.tell(cpu_state, fit)
    card_state = state.replace(**{
        f: getattr(state, f).cuda() for f in ("mean", "sigma", "pc", "ps", "C", "B", "D", "z")})
    results = {}
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            _, st = card.ask(card_state)
            results[tf32] = card.tell(st, fit.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    fields = ("mean", "C", "ps", "pc", "sigma")
    compare_exact("CMA-ES generation on the card, TF32 allowed against not",
                  [getattr(results[True], f) for f in fields],
                  [getattr(results[False], f) for f in fields])
    got = results[False]
    # float32 products of length 1000 (B z, (z D) B^T) and 12 (the selected
    # steps), summed by cuBLAS and by the CPU's BLAS in other orders: n eps =
    # 6e-5 of a field's scale at worst over a 1000-term sum, ~4e-6 typical;
    # so 1e-4 relative, with an absolute floor of 1e-5 of the field's
    # largest entry for entries near 0
    out = {}
    for f in fields:
        ref = getattr(want, f)
        scale = float(ref.abs().max())
        out[f] = compare(f"CMA-ES generation at d {cpu.dim}, {f}, card against CPU",
                         getattr(got, f).cpu().reshape(-1), ref.reshape(-1), rtol=1e-4,
                         atol=1e-5 * scale)
    return out


# ----------------------------------------------------------- main path 6


def make_pgpe(dim: int, pop: int, device):
    """Main path 6's algorithm: PGPE with its defaults (ClipUp, center lr
    0.15, stdev 0.1) from a zero center."""
    import torch

    from evox_tpu_torch.algorithms.so.es import PGPE

    return PGPE(pop_size=pop, center_init=torch.zeros(dim), device=device)


def phase_pgpe_walker(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 6: the walker path with PGPE (ClipUp) in OpenES's place,
    driven and checked by ``phase_walker_path``; and the tell's one redraw
    of delta, timed."""
    from evox_tpu_torch.utils import ClipUp

    wf, make_problem, adapter = build_walker_path(torch, algorithm=make_pgpe)
    algo = wf.algorithm
    if not isinstance(algo.optimizer, ClipUp):
        raise AssertionError(f"PGPE's optimizer is {type(algo.optimizer).__name__}, not ClipUp")
    out = phase_walker_path(torch, wf, make_problem, adapter, gens, seed, profile)
    state = algo.init(seed)
    out["delta_redraw_ms"] = _time_ms(lambda: algo._delta(state), 1, 3)
    out["delta_bytes"] = 4 * (algo.pop_size // 2) * algo.dim
    return out


# ------------------------------------------------------ the ES family phase


def es_family_makers(torch, n: int, dim: int) -> dict:
    """The ES family phase's algorithms at pop ``n`` (ESMC ``n + 1``: the
    mean and n/2 antithetic pairs), from a center of 3.0 in every
    coordinate."""
    from evox_tpu_torch.algorithms.so import es

    c = torch.full((dim,), 3.0)
    return {
        "SepCMAES": lambda: es.SepCMAES(c, 1.0, pop_size=n),
        "IPOPCMAES": lambda: es.IPOPCMAES(c, 1.0, pop_size=n),
        "MAES": lambda: es.MAES(c, 1.0, pop_size=n),
        "LMMAES": lambda: es.LMMAES(c, 1.0, pop_size=n),
        "RMES": lambda: es.RMES(c, 1.0, pop_size=n),
        "XNES": lambda: es.XNES(c, 1.0, pop_size=n),
        "SeparableNES": lambda: es.SeparableNES(c, 1.0, pop_size=n),
        "SNES": lambda: es.SNES(c, 1.0, pop_size=n),
        "CR_FM_NES": lambda: es.CR_FM_NES(c, 1.0, pop_size=n),
        "ARS": lambda: es.ARS(c, n, learning_rate=0.1),
        "ASEBO": lambda: es.ASEBO(c, n, subspace_dims=3),
        "GuidedES": lambda: es.GuidedES(c, n, subspace_dims=2),
        "PersistentES": lambda: es.PersistentES(c, n, truncation_length=5),
        "NoiseReuseES": lambda: es.NoiseReuseES(c, n, truncation_length=5),
        "ESMC": lambda: es.ESMC(c, n + 1),
        "DES": lambda: es.DES(c, 1.0, pop_size=n),
        "AMaLGaM": lambda: es.AMaLGaM(c, 1.0, pop_size=n),
        "IndependentAMaLGaM": lambda: es.IndependentAMaLGaM(c, 1.0, pop_size=n),
        "LES": lambda: es.LES(c, 1.0, pop_size=n),  # its bundled meta-trained parameters
    }


def phase_ars_topk(torch, wf, before, state) -> dict:
    """ARS's last tell against the same tell on the plain route of
    ``partial_topk``, and B4 at ARS's shape timed beside ``torch.topk``."""
    from evox_tpu_torch.algorithms.so.es import ars as ars_module
    from evox_tpu_torch.kernels import topk as kt

    algo = wf.algorithm
    cand, astate = algo.ask(before.algo)  # the last generation again, from its seeds
    fit, _ = wf.problem.evaluate(before.prob, cand)
    fit = fit * wf.opt_direction[0]
    score = torch.minimum(fit[: algo.n_dirs], fit[algo.n_dirs :])
    n, k = score.shape[0], algo.top_k
    top = compare_exact(f"ARS's top-k (n={n}, k={k}) against the plain route",
                        kt.partial_topk(score, k), kt.partial_topk_reference(score, k))
    kernel_route = ars_module.partial_topk
    ars_module.partial_topk = lambda v, kk, device=None: kt.partial_topk_reference(v, kk)
    try:
        plain_state = algo.tell(astate, fit)
    finally:
        ars_module.partial_topk = kernel_route
    compare_exact("ARS's last center against a tell on the plain route",
                  [state.algo.center], [plain_state.center])
    b4 = lambda: kt.partial_topk(score, k)
    lib = lambda: torch.topk(score, k, largest=False)
    row = {"n": n, "k": k, "ms": _time_ms(b4, 20, 200), "library_ms": _time_ms(lib, 20, 200),
           "device_us": device_us_per_call(torch, b4),
           "library_device_us": device_us_per_call(torch, lib),
           "host_us": host_us_per_call(torch, b4), "library_host_us": host_us_per_call(torch, lib),
           "plain_ms": _time_ms(lambda: kt.partial_topk_reference(score, k), 5, 50),
           "max_abs_err": top["max_abs_err"]}
    row["bound_ms"], row["bound_by"] = bound_ms(*topk_work(n, k))
    print(f"[ars topk] {json.dumps(row)}", flush=True)
    return row


def phase_es_family(torch, gens: int, seed: int) -> dict:
    """Every other algorithm of the ES family for a few generations on the
    card: Sphere, pop 1024 (ESMC 1025), d 100, an EvalMonitor on each; ARS's
    top-k checked and timed; and RestartCMAESDriver for two restarts."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import RestartCMAESDriver
    from evox_tpu_torch.monitors import EvalMonitor
    from evox_tpu_torch.problems.numerical import Sphere, sphere_func

    out = {}
    for name, make in es_family_makers(torch, ES_POP, ES_DIM).items():
        algo = make()
        mon = EvalMonitor()
        wf = StdWorkflow(algo, Sphere(), monitors=[mon])
        state = wf.step(wf.init(seed))
        best_warm = float(mon.get_best_fitness(state.monitors[0]))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = wf.run(state, gens - 1)
        before = state
        state = wf.step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        # the monitor's elite launches B4 once a generation, ARS's tell once more
        topk = 2 * gens if name == "ARS" else gens
        want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": topk,
                "fused_mlp_rollout": 0}
        if launches != want:
            raise AssertionError(f"{name}: {launches} in {gens} monitored generations, "
                                 f"expected {want}")
        best = float(mon.get_best_fitness(state.monitors[0]))
        if not (math.isfinite(best) and best <= best_warm):
            raise AssertionError(f"{name}: best fitness {best_warm} -> {best}")
        row = {"pop": algo.pop_size, "dim": ES_DIM, "generations": gens,
               "ms_per_generation": wall / gens * 1e3, "best_fitness_warmup": best_warm,
               "best_fitness": best, "launches": launches}
        if name == "ARS":
            row["tell_topk_launches"] = launches["partial_topk"] - gens
            row["topk"] = phase_ars_topk(torch, wf, before, state)
        print(f"[es family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row

    driver = RestartCMAESDriver(torch.full((ES_DIM,), 3.0), 1.0, sphere_func)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best_x, best_f = driver.run(seed, max_restarts=RESTARTS, gens_per_run=RESTART_GENERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    base = driver.base_pop_size
    if driver.pop_sizes != [base * 2**i for i in range(RESTARTS)]:
        raise AssertionError(f"IPOP pop sizes {driver.pop_sizes}, base {base}")
    start = ES_DIM * 3.0**2
    again = float(sphere_func(best_x[None])[0])  # one row's sum: another order, ~1 ulp
    if not (math.isfinite(best_f) and best_f < start and best_x.device.type == driver.device.type
            and abs(again - best_f) <= 1e-5 * best_f):
        raise AssertionError(f"RestartCMAESDriver's best {best_f}: not a Sphere value below "
                             f"the start's {start}")
    out["RestartCMAESDriver"] = {"dim": ES_DIM, "pop_sizes": driver.pop_sizes,
                                 "generations_per_run": RESTART_GENERATIONS, "wall_s": wall,
                                 "best_fitness": best_f}
    print(f"[es family] RestartCMAESDriver: {json.dumps(out['RestartCMAESDriver'])}", flush=True)
    return out


# ------------------------------------------- main paths 7 and 8, MO family


def _time_host_ms(torch, fn) -> float:
    """Host-clock ms of one call of ``fn``, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def mo_breakdown(torch, wf, state, extra: dict, reps: int = 5) -> dict:
    """Median host-clock ms of each stage of one generation of an MO path,
    each synchronised: ask, evaluate, tell, and the stages of ``extra``
    (name -> fn(astate, fitness))."""
    algo, prob = wf.algorithm, wf.problem
    times = {name: [] for name in ("ask", "evaluate", "tell", *extra)}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        off, astate = timed("ask", lambda: algo.ask(state.algo))
        fit, _ = timed("evaluate", lambda: prob.evaluate(state.prob, off))
        timed("tell", lambda: algo.tell(astate, fit))
        for name, fn in extra.items():
            timed(name, lambda fn=fn: fn(astate, fit))
    return {name: statistics.median(v) for name, v in times.items()}


def run_mo_path(torch, wf, gens: int, seed: int, want_launches: dict) -> tuple:
    """The init step, one warm-up generation, then ``gens`` timed
    generations with every launch counter set to 0 just before and read
    just after. Checks the launches, and, once after the run, fitness that
    is finite (or an empty niche's +inf) and a population within the
    bounds; returns ``(state, wall_s, launches)``."""
    algo = wf.algorithm
    state = wf.step(wf.init(seed))  # the init step: the parents evaluated
    state = wf.step(state)  # warm-up generation
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0, "fused_mlp_rollout": 0,
            **want_launches}
    name = type(algo).__name__
    if launches != want:
        raise AssertionError(f"{name}: launches in {gens} generations {launches}, expected {want}")
    if state.generation != gens + 2:
        raise AssertionError(f"{name}: generation {state.generation} != {gens + 2}")
    pop, fit = state.algo.population, state.algo.fitness
    # RVEA's, RVEAa's and LMOCSO's empty niches hold +inf rows
    finite = torch.isfinite(fit).all(dim=1)
    if not (finite.any() and (fit[~finite] == float("inf")).all() and (pop >= algo.lb).all()
            and (pop <= algo.ub).all()):
        raise AssertionError(f"{name}: the population leaves the bounds or its fitness is neither "
                             "finite nor an empty niche's")
    return state, wall, launches


def mo_quality(torch, wf, state) -> dict:
    """IGD against the problem's true front, and the exact 3-D hypervolume
    of the final population at ``HV_REF`` (outside the timed window)."""
    from evox_tpu_torch.metrics import hypervolume_3d, igd

    fit = state.algo.fitness
    # empty niches' +inf rows count as far away, as tests/test_mo_algorithms.py counts them
    fit = torch.where(torch.isfinite(fit).all(dim=1, keepdim=True), fit, 1e6)
    value = float(igd(fit, wf.problem.pf()))
    ref = torch.tensor(HV_REF, device=fit.device)
    hv_ms = _time_host_ms(torch, lambda: hypervolume_3d(fit, ref))
    hv = float(hypervolume_3d(fit, ref))
    if not (math.isfinite(value) and 0.0 <= hv <= math.prod(HV_REF)):
        raise AssertionError(f"IGD {value}, hypervolume {hv}: not a measure of a front")
    return {"igd": value, "hypervolume": hv, "hypervolume_ref": list(HV_REF),
            "hypervolume_ms": hv_ms}


def profile_path(torch, wf, state, wall: float, gens: int, prof_gens: int = 5) -> dict:
    prof = profile_generations(torch, wf, state, prof_gens)
    prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (wall / gens * 1e6)
    return prof


def phase_moead_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 7: ``StdWorkflow(MOEAD(zeros(12), ones(12), n_objs=3,
    pop_size=10000, aggregate_op="pbi"), DTLZ2(d=12, m=3))``: 9870
    subproblems, T 20, max_replace 4, no kernel. Also the constructor's
    neighbour table timed on the card and built on the CPU (equal element
    for element), IGD and the hypervolume, and one tell on the card against
    the same tell on the CPU."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import MOEAD
    from evox_tpu_torch.algorithms.mo.moead import neighbor_table
    from evox_tpu_torch.problems.numerical import DTLZ2

    lb, ub = torch.zeros(MOEAD_D), torch.ones(MOEAD_D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    algo = MOEAD(lb, ub, n_objs=MO_M, pop_size=MO_POP, aggregate_op="pbi")
    torch.cuda.synchronize()
    build = {"constructor_s": time.perf_counter() - t0}
    build["neighbor_table_ms"] = statistics.median(
        _time_host_ms(torch, lambda: neighbor_table(algo.weights, algo.T)) for _ in range(3))
    t0 = time.perf_counter()
    cpu_algo = MOEAD(lb, ub, n_objs=MO_M, pop_size=MO_POP, aggregate_op="pbi", device="cpu")
    build["cpu_constructor_s"] = time.perf_counter() - t0
    if (algo.pop_size, algo.T, algo.nr) != (MO_SUBPROBLEMS, 20, 4):
        raise AssertionError(f"MOEA/D: {algo.pop_size} subproblems, T {algo.T}, nr {algo.nr}")
    build["table"] = compare_exact(f"MOEA/D neighbour table ({algo.pop_size}, 20), built on the card against "
                                   "built on the CPU", [algo.neighbors.cpu()], [cpu_algo.neighbors])

    wf = StdWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M))
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {})
    out = {"pop": algo.pop_size, "dim": MOEAD_D, "T": algo.T, "generations": gens,
           "launches": launches, "wall_s": wall, "ms_per_generation": wall / gens * 1e3,
           "generations_per_s": gens / wall, "build": build,
           "breakdown_ms": mo_breakdown(torch, wf, state, {}), **mo_quality(torch, wf, state)}

    # one tell on the card against the same tell on the CPU
    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    on_card = algo.tell(astate, fit)
    cpu_state = astate.replace(**{f: getattr(astate, f).cpu() for f in
                                  ("population", "fitness", "ideal", "offspring")})
    on_cpu = cpu_algo.tell(cpu_state, fit.cpu())
    ideal = torch.minimum(astate.ideal, torch.amin(fit, dim=0))
    rep_card, win_card = algo.replacement(astate.fitness, ideal, fit)
    rep_cpu, win_cpu = cpu_algo.replacement(cpu_state.fitness, ideal.cpu(), fit.cpu())
    differ = (rep_card.cpu() != rep_cpu) | (rep_cpu & (win_card.cpu() != win_cpu))
    tell = {"replaced": int(rep_cpu.sum()), "decisions_differ": int(differ.sum())}
    if tell["decisions_differ"]:
        # the aggregation values that decided each differing slot, both sides
        off_c, inc_c = (v.cpu() for v in algo.aggregation_values(astate.fitness, ideal, fit))
        off_h, inc_h = cpu_algo.aggregation_values(cpu_state.fitness, ideal.cpu(), fit.cpu())
        nbr = cpu_algo.neighbors
        for s in torch.nonzero(differ)[:20, 0].tolist():
            i, j = torch.nonzero(nbr == s, as_tuple=True)
            print(f"[moead tell] slot {s}: card off {off_c[i, j].tolist()} inc {inc_c[i, j].tolist()}"
                  f"; cpu off {off_h[i, j].tolist()} inc {inc_h[i, j].tolist()}", flush=True)
        # PBI over m = 3 in index order on both, the root correctly rounded:
        # equal by construction; 1e-6 would allow an ulp or two
        tell["values"] = compare("MOEA/D aggregation values, card against CPU",
                                 torch.cat([off_c, inc_c]), torch.cat([off_h, inc_h]),
                                 rtol=1e-6, atol=0.0)
    same = ~differ
    tell.update(compare_exact(
        "MOEA/D tell on the card against the CPU (population and fitness where the decisions "
        "agree, ideal)", [on_card.population.cpu()[same], on_card.fitness.cpu()[same],
                          on_card.ideal.cpu()],
        [on_cpu.population[same], on_cpu.fitness[same], on_cpu.ideal]))
    out["tell_vs_cpu"] = tell
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    return out


def phase_nsga3_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 8: ``StdWorkflow(NSGA3(zeros(7), ones(7), n_objs=3,
    pop_size=10000), DTLZ1(d=7, m=3))``: 9870 reference points, merged n
    19740, one ``packed_dominance`` launch a generation. Also the fronts
    peeled a generation, B3 at n 19740 against its plain version, the sort
    to the cut against the full peel, the closed-form niching against the
    sequential loop (timed once), IGD and the hypervolume, and one
    selection on the card against the CPU's plain route."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA3
    from evox_tpu_torch.algorithms.mo import nsga3 as mod
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.operators.selection import non_dominated_sort
    from evox_tpu_torch.problems.numerical import DTLZ1

    algo = NSGA3(torch.zeros(NSGA3_D), torch.ones(NSGA3_D), n_objs=MO_M, pop_size=MO_POP)
    k = algo.pop_size
    fronts = []  # each selection's fronts peeled, kept on the device
    select_mask = algo.select_mask

    def recording_select_mask(fit):
        selected, rank = select_mask(fit)
        # no host read: unranked rows (rank n) count as -1
        fronts.append(torch.where(rank < fit.shape[0], rank, -1).amax() + 1)
        return selected, rank

    algo.select_mask = recording_select_mask
    wf = StdWorkflow(algo, DTLZ1(d=NSGA3_D, m=MO_M))
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": gens})
    algo.select_mask = select_mask
    out = {"pop": k, "dim": NSGA3_D, "merged_n": 2 * k, "generations": gens, "launches": launches,
           "wall_s": wall, "ms_per_generation": wall / gens * 1e3, "generations_per_s": gens / wall,
           "fronts_peeled": [int(f) for f in fronts[-gens:]], **mo_quality(torch, wf, state)}

    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    merged = torch.cat([astate.fitness, fit])
    n = merged.shape[0]

    def niching_inputs(f):
        return mod.niching_inputs(f, algo.refs.to(f.device), k)[1]

    args = niching_inputs(merged)
    merged_of = lambda a, f: torch.cat([a.fitness, f])
    extra = {
        "packed_dominance": lambda a, f: kd.packed_dominance(merged_of(a, f)),
        "sort_to_cut": lambda a, f: non_dominated_sort(merged_of(a, f), until=k),
        "sort_full_peel": lambda a, f: non_dominated_sort(merged_of(a, f)),
        "normalize_associate": lambda a, f: mod.associate(mod.normalize(merged_of(a, f)), algo.refs),
        "niche_closed_form": lambda a, f: mod.niche(*args),
    }
    out["breakdown_ms"] = mo_breakdown(torch, wf, state, extra)
    out["breakdown_ms"]["niche_sequential_once"] = _time_host_ms(torch, lambda: mod.niche_sequential(*args))
    out["need"], out["candidates"] = int(args[5]), int(args[1].sum())
    if not torch.equal(mod.niche_sequential(*args), mod.niche(*args)):
        raise AssertionError("NSGA-III: the closed-form niching differs from the loop on the card")

    # B3 at the path's merged fitness, against its plain version
    got = kd.packed_dominance(merged, device=merged.device)
    want = kd.packed_dominance_reference(merged)
    b3 = compare_exact(f"packed_dominance, NSGA-III merged fitness n={n} m={MO_M}", got, want)
    b3["ms"] = _time_ms(lambda: kd.packed_dominance(merged, device=merged.device), 3, 20)
    b3["plain_ms"] = _time_ms(lambda: kd.packed_dominance_reference(merged), 1, 3)
    b3["bound_ms"], b3["bound_by"] = bound_ms(*dominance_work(n, MO_M))
    out["packed_dominance"] = b3

    # one selection on the card against the CPU's plain route
    cpu_algo = NSGA3(algo.lb.cpu(), algo.ub.cpu(), n_objs=MO_M, pop_size=MO_POP, device="cpu")
    if not torch.equal(cpu_algo.refs, algo.refs.cpu()):
        raise AssertionError("NSGA-III: the reference directions differ between the card and the CPU")
    sel_card, rank_card = algo.select_mask(merged)
    t0 = time.perf_counter()
    sel_cpu, rank_cpu = cpu_algo.select_mask(merged.cpu())
    cpu_s = time.perf_counter() - t0
    differ = sel_card.cpu() != sel_cpu
    if differ.any() or not torch.equal(rank_card.cpu(), rank_cpu):
        # the near-ties that decided each difference: association and distance
        c_args, h_args = niching_inputs(merged), niching_inputs(merged.cpu())
        for i in torch.nonzero(differ)[:20, 0].tolist():
            print(f"[nsga3 select] row {i}: card pi {int(c_args[2][i])} dist {float(c_args[3][i])!r}"
                  f"; cpu pi {int(h_args[2][i])} dist {float(h_args[3][i])!r}", flush=True)
    out["select_vs_cpu"] = compare_exact(
        "NSGA-III selection on the card against the CPU (survivor mask, ranks)",
        [sel_card.cpu(), rank_card.cpu()], [sel_cpu, rank_cpu])
    out["select_vs_cpu"]["cpu_select_s"] = cpu_s
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    return out


def mo_family_makers(torch) -> dict:
    """The family phase's algorithms at pop ``MO_FAMILY_POP`` requested, each
    with the B3 launches it makes a generation."""
    from evox_tpu_torch.algorithms import mo

    lb, ub = torch.zeros(MOEAD_D), torch.ones(MOEAD_D)

    def make(cls):
        return lambda: cls(lb, ub, n_objs=MO_M, pop_size=MO_FAMILY_POP)

    return {
        "MOEADDRA": (make(mo.MOEADDRA), 0),
        "MOEADM2M": (make(mo.MOEADM2M), 1),  # the full sort of its tell
        "EAGMOEAD": (make(mo.EAGMOEAD), 1),  # the archive's selection
        "RVEA": (make(mo.RVEA), 0),
        "RVEAa": (make(mo.RVEAa), 0),
        "TDEA": (make(mo.TDEA), 1),  # the sort to the cut of its selection
        "LMOCSO": (make(mo.LMOCSO), 0),
    }


def phase_mo_family(torch, gens: int, seed: int) -> dict:
    """The rest of the decomposition and reference-vector family, ``gens``
    generations each on DTLZ2(d=12, m=3) at pop 1000 requested: ms a
    generation, IGD after the run, launches checked."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.problems.numerical import DTLZ2

    out = {}
    for name, (make, b3) in mo_family_makers(torch).items():
        algo = make()
        wf = StdWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M))
        state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": b3 * gens})
        row = {"pop": algo.pop_size, "generations": gens, "ms_per_generation": wall / gens * 1e3,
               "launches": launches, **mo_quality(torch, wf, state)}
        if b3:
            row["n"] = 2 * algo.pop_size  # B3's input: parents and offspring
        print(f"[mo family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row
    return out


def phase_dtlz(torch, seed: int) -> dict:
    """DTLZ1-7 evaluated on the card against the CPU at pop 9870 (m 3, each
    at its default d), and DTLZ7's ``pf()``, which sorts on B3, against the
    CPU's."""
    from evox_tpu_torch.operators.sampling import UniformSampling
    from evox_tpu_torch.problems import numerical

    out = {}
    g = torch.Generator().manual_seed(seed)
    for i in range(1, 8):
        prob = getattr(numerical, f"DTLZ{i}")(m=MO_M)
        pop = torch.rand((MO_SUBPROBLEMS, prob.d), generator=g)
        got, _ = prob.evaluate(None, pop.cuda())
        want, _ = prob.evaluate(None, pop)
        # the card's cosf/sinf/powf and the CPU's differ by an ulp or two;
        # DTLZ1's and DTLZ3's g scale a sum of cosines by 100
        out[f"DTLZ{i}"] = compare(f"DTLZ{i} (m 3, d {prob.d}, pop {MO_SUBPROBLEMS}) on the card "
                                  "against the CPU",
                                  got.cpu(), want, rtol=1e-5, atol=1e-5)
    card, cpu = numerical.DTLZ7(m=MO_M), numerical.DTLZ7(m=MO_M, device="cpu")
    torch.cuda.synchronize()
    reset_launches()
    pf = card.pf()
    torch.cuda.synchronize()
    launches = read_launches()["packed_dominance"]
    if launches != 1:
        raise AssertionError(f"DTLZ7.pf() launched packed_dominance {launches} times, expected 1")
    pf_cpu = cpu.pf()
    if pf.shape != pf_cpu.shape:
        raise AssertionError(f"DTLZ7.pf(): {tuple(pf.shape)} on the card, {tuple(pf_cpu.shape)} on the CPU")
    out["DTLZ7_pf"] = compare("DTLZ7.pf() on the card against the CPU", pf.cpu(), pf_cpu,
                              rtol=1e-6, atol=1e-6)
    out["DTLZ7_pf"].update({"launches": launches,
                            "n": UniformSampling(card.ref_num * 10, MO_M - 1, device="cpu")()[1]})
    return out


# ------------------------------------------- main path 9, DE family, CEC 2022


def build_shade_path(torch, pop: int = SHADE_POP, dim: int = SHADE_DIM, device=None):
    """Main path 9 as a user builds it: SHADE on the port's Ackley at path
    4's shape (``bench.py:134-185``'s workload). ``pop``, ``dim`` and
    ``device`` exist for a rehearsal on the CPU at a small size."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.de import SHADE
    from evox_tpu_torch.problems.numerical import Ackley

    bound = torch.full((dim,), SHADE_BOUND)
    algo = SHADE(lb=-bound, ub=bound, pop_size=pop, memory_size=SHADE_MEMORY, device=device)
    return StdWorkflow(algo, Ackley(), device=device)


def topk_row(torch, v, k: int, name: str) -> dict:
    """``partial_topk`` on ``v`` held against its plain version, and timed
    beside ``torch.topk`` (CUDA events, device time, host time) and its
    bound."""
    from evox_tpu_torch.kernels import topk as kt

    check = compare_exact(f"{name} (n={v.shape[0]}, k={k}) against the plain route",
                          kt.partial_topk(v, k), kt.partial_topk_reference(v, k))
    b4 = lambda: kt.partial_topk(v, k)
    lib = lambda: torch.topk(v, k, largest=False)
    row = {"n": v.shape[0], "k": k, "ms": _time_ms(b4, 20, 200), "library_ms": _time_ms(lib, 20, 200),
           "device_us": device_us_per_call(torch, b4),
           "library_device_us": device_us_per_call(torch, lib),
           "host_us": host_us_per_call(torch, b4), "library_host_us": host_us_per_call(torch, lib),
           "plain_ms": _time_ms(lambda: kt.partial_topk_reference(v, k), 5, 50),
           "max_abs_err": check["max_abs_err"]}
    row["bound_ms"], row["bound_by"] = bound_ms(*topk_work(v.shape[0], k))
    print(f"[{name}] {json.dumps(row)}", flush=True)
    return row


def phase_shade_path(torch, gens: int, seed: int, profile: bool) -> tuple:
    """Main path 9: SHADE(±32, d 1024, pop 4096, memory 100) on Ackley —
    the init step, one warm-up generation, then ``gens`` timed generations
    with every count set to 0 just before and read just after: one
    ``partial_topk`` launch a generation (the pbest cut) and no other. Then
    the cut on the card against a stable argsort, B4 at (4096, k) against
    its plain version and ``torch.topk``, the split, and the profile.
    Returns ``(results, workflow, final state)``."""
    from evox_tpu_torch.algorithms.so.de.common import pbest_cut, sort_key

    wf = build_shade_path(torch)
    algo = wf.algorithm
    state = wf.step(wf.step(wf.init(seed)))  # the init step, then a warm-up generation
    best_warm = float(state.algo.fitness.min())
    torch.cuda.synchronize()

    reset_launches()  # every count to 0 just before the run
    t0 = time.perf_counter()
    state = wf.run(state, gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()  # read just after
    want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": gens, "fused_mlp_rollout": 0}
    if launches != want:
        raise AssertionError(f"launches in {gens} SHADE generations: {launches}, expected {want}")
    if state.generation != gens + 2:
        raise AssertionError(f"generation {state.generation} != {gens + 2}")
    _check_swarm(torch, "SHADE path", algo, state.algo.population)
    fit = state.algo.fitness
    best = float(fit.min())
    if not (torch.isfinite(fit).all() and best <= best_warm):
        raise AssertionError(f"SHADE path: fitness not finite or the best rose ({best_warm} -> {best})")
    k = algo.pbest_k
    stable = torch.argsort(fit, stable=True)[:k]
    cut = compare_exact(f"SHADE's pbest cut (n={algo.pop_size}, k={k}) against a stable argsort",
                        [pbest_cut(fit, k)], [stable])
    out = {
        "generations": gens,
        "pop": algo.pop_size,
        "dim": algo.dim,
        "memory_size": algo.H,
        "pbest_k": k,
        "launches": launches,
        "wall_s": wall,
        "ms_per_generation": wall / gens * 1e3,
        "generations_per_s": gens / wall,
        "evals_per_s": gens * algo.pop_size / wall,
        "best_fitness_warmup": best_warm,
        "best_fitness": best,
        "archive_size": int(state.algo.archive_size),
        "mem_pos": int(state.algo.mem_pos),
        "pbest_cut_vs_argsort": cut,
        "topk": topk_row(torch, sort_key(fit), k, "shade topk"),
        "breakdown_ms": mo_breakdown(torch, wf, state, {}),
    }
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    return out, wf, state


def phase_shade_card_vs_cpu(torch, wf, state, seed: int) -> dict:
    """One SHADE generation on the card against the same generation on the
    CPU, from path 9's last state, with the same draws (made on the CPU and
    moved) and the same fitness handed to both tells (Ackley of the CPU's
    trials, so its transcendental last bits decide no selection)."""
    from evox_tpu_torch.algorithms.so.de import SHADE
    from evox_tpu_torch.problems.numerical import ackley_func

    card = wf.algorithm
    cpu = SHADE(lb=card.lb.cpu(), ub=card.ub.cpu(), pop_size=card.pop_size, memory_size=card.H,
                device="cpu")
    card_state = state.algo
    cpu_state = _state_on(torch, card_state, "cpu")
    draws = cpu._draw(seed + 1)
    cpu._draw = lambda s: draws
    card._draw = lambda s: {name: d.cuda() for name, d in draws.items()}
    try:
        cand_card, after_card = card.ask(card_state)
        cand_cpu, after_cpu = cpu.ask(cpu_state)
        pbest = compare_exact("SHADE pbest rows, card against CPU",
                              [card.pbest_indices(card_state.fitness, draws["p"].cuda(),
                                                  draws["u_pbest"].cuda()).cpu()],
                              [cpu.pbest_indices(cpu_state.fitness, draws["p"], draws["u_pbest"])])
        trials = compare_exact("SHADE trials, card against CPU", [cand_card.cpu()], [cand_cpu])
        fit = ackley_func(cand_cpu)
        got = card.tell(after_card, fit.cuda())
        want = cpu.tell(after_cpu, fit)
    finally:
        del card._draw
    out = {"pbest": pbest, "trials": trials, "replaced": int(want.attrib.success.sum()),
           "archive_size": int(want.archive_size), "mem_pos": int(want.mem_pos)}
    out["state"] = compare_exact(
        "SHADE tell, card against CPU (population, fitness, archive, archive_size, mem_pos, F, CR, "
        "attribution)",
        [got.population.cpu(), got.fitness.cpu(), got.archive.cpu(), got.archive_size.cpu(),
         got.mem_pos.cpu(), got.F.cpu(), got.CR.cpu(), got.attrib.success.cpu(),
         got.attrib.improvement.cpu()],
        [want.population, want.fitness, want.archive, want.archive_size, want.mem_pos, want.F,
         want.CR, want.attrib.success, want.attrib.improvement])
    # M_F and M_CR take weighted sums over the 4096 candidates, which the
    # card adds in another order than the CPU: n eps ~ 2.4e-4 relative at
    # worst for positive terms, ~1e-6 in practice; 1e-4 relative
    out["memory"] = compare("SHADE memories M_F and M_CR, card against CPU",
                            torch.cat([got.M_F, got.M_CR]).cpu(), torch.cat([want.M_F, want.M_CR]),
                            rtol=1e-4, atol=0.0)
    return out


def de_family_makers(torch) -> dict:
    """The DE family phase's algorithms (pop 1024, d 100, ±10), each with
    its B4 launches a generation and its evaluations a generation."""
    from evox_tpu_torch.algorithms.so import de

    lb, ub = torch.full((DE_DIM,), -10.0), torch.full((DE_DIM,), 10.0)
    n = DE_POP
    return {
        "DE (rand/1)": (lambda: de.DE(lb, ub, n), 0, n),
        "DE (best/2)": (lambda: de.DE(lb, ub, n, base_vector="best", num_difference_vectors=2), 0, n),
        "ODE": (lambda: de.ODE(lb, ub, n), 0, n),
        "CoDE": (lambda: de.CoDE(lb, ub, n), 0, 3 * n),  # three trials a parent
        "SaDE": (lambda: de.SaDE(lb, ub, n), 0, n),
        "JaDE": (lambda: de.JaDE(lb, ub, n), 1, n),  # the pbest cut
        "SHADE": (lambda: de.SHADE(lb, ub, n), 1, n),
    }


def phase_de_family(torch, gens: int, seed: int) -> dict:
    """The DE family for a few generations each on the card: Sphere, pop
    1024, d 100; launches counted as on a main path (JaDE's and SHADE's
    pbest cut: one B4 launch a generation), ms a generation and the best
    fitness; JaDE's cut (n 1024, k 51) held against the plain route and
    timed beside ``torch.topk``."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.de.common import sort_key
    from evox_tpu_torch.problems.numerical import Sphere

    out = {}
    for name, (make, b4, evals) in de_family_makers(torch).items():
        algo = make()
        wf = StdWorkflow(algo, Sphere())
        state = wf.step(wf.init(seed))  # the init step: the population evaluated
        best_warm, mean_warm = float(state.algo.fitness.min()), float(state.algo.fitness.mean())
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = wf.run(state, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": b4 * gens,
                "fused_mlp_rollout": 0}
        if launches != want:
            raise AssertionError(f"{name}: {launches} in {gens} generations, expected {want}")
        # greedy slot selection: the best cannot rise, and any success lowers
        # the mean (the best slot itself need not improve in a few generations)
        best, mean = float(state.algo.fitness.min()), float(state.algo.fitness.mean())
        if not (math.isfinite(mean) and best <= best_warm and mean < mean_warm):
            raise AssertionError(f"{name}: best fitness {best_warm} -> {best}, mean {mean_warm} "
                                 f"-> {mean}")
        _check_swarm(torch, name, algo, state.algo.population)
        row = {"pop": algo.pop_size, "dim": DE_DIM, "generations": gens,
               "evals_per_generation": evals, "ms_per_generation": wall / gens * 1e3,
               "best_fitness_warmup": best_warm, "best_fitness": best, "mean_fitness_warmup": mean_warm,
               "mean_fitness": mean, "launches": launches}
        if name == "JaDE":
            row["topk"] = topk_row(torch, sort_key(state.algo.fitness), algo.p_num, "jade topk")
        print(f"[de family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row
    return out


def phase_cec2022(torch, seed: int) -> dict:
    """CEC 2022 F1-F12 at every dimension the suite defines (F6-F8 at 10
    and 20), on the card against the CPU at 1024 points in the box; each
    member's optimum (the shift vector) on the card."""
    from evox_tpu_torch.problems.numerical import cec2022

    g = torch.Generator().manual_seed(seed)
    out = {}
    for f in range(1, 13):
        card = cec2022.CEC2022TestSuite.create(f)
        cpu = cec2022.CEC2022TestSuite.create(f, device="cpu")
        for d in cec2022.SUPPORTED_DIMS:
            if d not in cec2022.HYBRID_DIMS and f in (6, 7, 8):
                continue
            x = torch.rand((CEC_ROWS, d), generator=g) * 200.0 - 100.0
            x[0] = cpu.shift[:d] if cpu.shift.ndim == 1 else cpu.shift[0, :d]
            got, _ = card.evaluate(None, x.cuda())
            want, _ = cpu.evaluate(None, x)
            # the card's and the CPU's sin, cos, exp and pow differ by an ulp
            # or two and the rotations' products add in other orders; a
            # Schwefel part keeps a few ulps of its 418.98 k constant (4.9e-4
            # at d 20) near the optimum (tests/test_torch_cec2022.py)
            schwefel = f in (7, 8, 10, 11, 12)
            row = compare(f"CEC2022 F{f} (d {d}, {CEC_ROWS} points) on the card against the CPU",
                          got.cpu(), want, rtol=1e-4, atol=4e-3 if schwefel else 1e-6)
            opt = float(got[0])
            # 0, or the float32 residue of a Schwefel or Ackley constant
            if not (opt == 0.0 or (f in (7, 8, 10) and 0.0 < opt <= 4e-3)):
                raise AssertionError(f"CEC2022 F{f} (d {d}) at its optimum: {opt}")
            row["at_optimum"] = opt
            out[f"F{f}_d{d}"] = row
    return out


# ----------------------- main paths 10 and 11, the indicator and knee family, MaF


def gde3_pre_selection(fit_parent, fit_trial):
    """GDE3's ``+inf`` branches: (parents its trial dominates, trials their
    parent dominates), as ``(n,)`` bool."""
    from evox_tpu_torch.algorithms.mo.gde3 import pairwise_dominates

    return pairwise_dominates(fit_trial, fit_parent), pairwise_dominates(fit_parent, fit_trial)


def phase_gde3_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 10: ``StdWorkflow(GDE3(*LSMOP1(d=300, m=3).bounds(),
    n_objs=3, pop_size=10000, F=0.5, CR=0.3), LSMOP1(d=300, m=3))`` (path
    2's shape): one ``packed_dominance`` launch a generation at n 20000 in
    ``non_dominate``. Also the split, B3 at the path's merged fitness
    against its plain version, IGD and the hypervolume, and one tell on the
    card against the CPU's plain routes on a told fitness that takes both
    ``+inf`` branches."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import GDE3
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.operators.selection import non_dominate, non_dominated_sort
    from evox_tpu_torch.problems.numerical import LSMOP1

    prob = LSMOP1(d=LSMOP_D, m=LSMOP_M)
    algo = GDE3(*prob.bounds(), n_objs=LSMOP_M, pop_size=NSGA2_POP, F=GDE3_F, CR=GDE3_CR)
    wf = StdWorkflow(algo, prob)
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": gens})
    k = algo.pop_size
    out = {"pop": k, "dim": LSMOP_D, "merged_n": 2 * k, "F": algo.F, "CR": algo.CR,
           "generations": gens, "launches": launches, "wall_s": wall,
           "ms_per_generation": wall / gens * 1e3, "generations_per_s": gens / wall,
           **mo_quality(torch, wf, state)}

    def merged_of(a, f):
        par_inf, tri_inf = gde3_pre_selection(a.fitness, f)
        return torch.cat([torch.where(par_inf[:, None], torch.inf, a.fitness),
                          torch.where(tri_inf[:, None], torch.inf, f)])

    extra = {
        "pre_selection": merged_of,
        "packed_dominance": lambda a, f: kd.packed_dominance(merged_of(a, f)),
        "sort_to_cut": lambda a, f: non_dominated_sort(merged_of(a, f), until=k),
        "non_dominate": lambda a, f: non_dominate(torch.cat([a.population, a.offspring]),
                                                  merged_of(a, f), k),
    }
    out["breakdown_ms"] = mo_breakdown(torch, wf, state, extra)

    # one tell on the card against the CPU, on a told fitness with both
    # +inf branches: trials that dominate their parents, trials that their
    # parents dominate
    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    fit = fit.clone()
    fit[:GDE3_FORCED] = astate.fitness[:GDE3_FORCED] - 0.01
    fit[GDE3_FORCED:2 * GDE3_FORCED] = astate.fitness[GDE3_FORCED:2 * GDE3_FORCED] + 0.01
    par_inf, tri_inf = gde3_pre_selection(astate.fitness, fit)
    branches = {"parents_to_inf": int(par_inf.sum()), "trials_to_inf": int(tri_inf.sum())}
    if min(branches.values()) < GDE3_FORCED:
        raise AssertionError(f"GDE3 tell: the +inf branches were not both taken: {branches}")
    merged = merged_of(astate, fit)
    on_card = algo.tell(astate, fit)
    cpu_algo = GDE3(algo.lb.cpu(), algo.ub.cpu(), n_objs=LSMOP_M, pop_size=k, F=GDE3_F, CR=GDE3_CR,
                    device="cpu")
    cpu_state = _state_on(torch, astate, "cpu")
    t0 = time.perf_counter()
    on_cpu = cpu_algo.tell(cpu_state, fit.cpu())
    tell = compare_exact("GDE3 tell on the card against the CPU's plain routes (population and "
                         "fitness, in order)", [on_card.population.cpu(), on_card.fitness.cpu()],
                         [on_cpu.population, on_cpu.fitness])
    tell.update(branches, cpu_tell_s=time.perf_counter() - t0,
                inf_in_merged=int(torch.isinf(merged).any(dim=1).sum()))
    out["tell_vs_cpu"] = tell

    # B3 at the path's merged fitness (+inf rows included), against its plain version
    n = merged.shape[0]
    b3 = compare_exact(f"packed_dominance, GDE3 merged fitness n={n} m={LSMOP_M}",
                       kd.packed_dominance(merged, device=merged.device),
                       kd.packed_dominance_reference(merged))
    b3["ms"] = _time_ms(lambda: kd.packed_dominance(merged, device=merged.device), 3, 20)
    b3["plain_ms"] = _time_ms(lambda: kd.packed_dominance_reference(merged), 1, 3)
    b3["bound_ms"], b3["bound_by"] = bound_ms(*dominance_work(n, LSMOP_M))
    out["packed_dominance"] = b3
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    return out


def removal_launches(torch, expo, removals: int) -> float:
    """CUDA kernels a removal of IBEA's loop launches, counted by the
    profiler over ``removals`` removals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from evox_tpu_torch.algorithms.mo.ibea import worst_removal

    keep = expo.shape[0] - removals
    worst_removal(expo, keep)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        worst_removal(expo, keep)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    # the loop's setup (the scores' halving sum, the final sort) launches
    # a fixed number: take the count at one removal off
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        worst_removal(expo, expo.shape[0] - 1)
        torch.cuda.synchronize()
    setup = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return (kernels - setup) / (removals - 1)


def phase_ibea_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 11: ``StdWorkflow(IBEA(zeros(12), ones(12), n_objs=3,
    pop_size=10000, kappa=0.05), DTLZ2(d=12, m=3))``: merged n 20000, a
    (20000, 20000) float32 indicator matrix and 10000 sequential removals a
    generation, no
    kernel of the port. Also the split (the matrix, the removal loop), the
    launches a removal makes and its host time, IGD and the hypervolume,
    and one selection on the card held against the same loop step by step
    on the card (survivors equal) and against the CPU (terms within the
    tests' tolerance, survivors and the removal order equal)."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import IBEA
    from evox_tpu_torch.algorithms.mo import ibea as mod
    from evox_tpu_torch.problems.numerical import DTLZ2

    torch.cuda.reset_peak_memory_stats()  # the phase's own peak, not an earlier path's
    algo = IBEA(torch.zeros(MOEAD_D), torch.ones(MOEAD_D), n_objs=MO_M, pop_size=MO_POP,
                kappa=IBEA_KAPPA)
    wf = StdWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M))
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {})
    k = algo.pop_size
    out = {"pop": k, "dim": MOEAD_D, "merged_n": 2 * k, "kappa": algo.kappa, "generations": gens,
           "launches": launches, "wall_s": wall, "ms_per_generation": wall / gens * 1e3,
           "generations_per_s": gens / wall, **mo_quality(torch, wf, state)}

    off, astate = algo.ask(state.algo)
    fit, _ = wf.problem.evaluate(state.prob, off)
    merged = torch.cat([astate.fitness, fit])
    n = merged.shape[0]
    expo = mod.indicator_terms(merged, algo.kappa)
    extra = {
        "indicator_terms": lambda a, f: mod.indicator_terms(torch.cat([a.fitness, f]), algo.kappa),
        "removal_loop": lambda a, f: mod.worst_removal(expo, k),
    }
    out["breakdown_ms"] = mo_breakdown(torch, wf, state, extra, reps=3)
    out["removals"] = n - k
    out["removal_us"] = out["breakdown_ms"]["removal_loop"] * 1e3 / (n - k)
    out["launches_per_removal"] = removal_launches(torch, expo.clone(), 200)
    out["expo_bytes"] = expo.numel() * expo.element_size()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    # the fast loop against the step-by-step one, on the card
    fast = mod.worst_removal(expo, k)
    t0 = time.perf_counter()
    stepwise, order = mod.worst_removal_stepwise(expo, k)
    torch.cuda.synchronize()
    out["stepwise_loop_s"] = time.perf_counter() - t0
    out["select_vs_stepwise"] = compare_exact(
        f"IBEA select (n {n}, keep {k}), the fast loop against the step-by-step one on the card",
        [fast], [stepwise])

    # against the CPU: the terms within the tests' score tolerance, then the
    # survivors and the removal order
    t0 = time.perf_counter()
    expo_cpu = mod.indicator_terms(merged.cpu(), algo.kappa)
    stepwise_cpu, order_cpu = mod.worst_removal_stepwise(expo_cpu, k)
    out["cpu_select_s"] = time.perf_counter() - t0
    # tests/test_torch_mo_indicator.py's SCORE_RTOL: the terms are rounded
    # once from float64 on both, so they should agree to the bit
    terms = compare("IBEA terms -exp(-I/(c kappa)), card against CPU", expo.cpu(), expo_cpu,
                    rtol=1e-5, atol=0.0)
    terms["bit_equal"] = bool(torch.equal(expo.cpu(), expo_cpu))
    out["select_vs_cpu"] = compare_exact(
        "IBEA select, card against CPU (survivors, removal order)",
        [stepwise.cpu(), order.cpu()], [stepwise_cpu, order_cpu])
    out["select_vs_cpu"]["terms"] = terms
    del expo, expo_cpu
    if profile:
        # 40000 launches a generation: two generations under the profiler
        out["profile"] = profile_path(torch, wf, state, wall, gens, prof_gens=2)
    return out


def indicator_family_makers(torch, g: int) -> dict:
    """The family phase's algorithms at pop ``MO_FAMILY_POP``, each with its
    ``packed_dominance`` launches in ``g`` timed generations (which start on
    an even BCE-IBEA generation)."""
    from evox_tpu_torch.algorithms import mo

    lb, ub = torch.zeros(MOEAD_D), torch.ones(MOEAD_D)

    def make(cls):
        return lambda: cls(lb, ub, n_objs=MO_M, pop_size=MO_FAMILY_POP)

    return {
        "IBEA": (make(mo.IBEA), 0),
        "SRA": (make(mo.SRA), 0),
        "BCEIBEA": (make(mo.BCEIBEA), (g + 1) // 2),  # the PC selection, even generations
        "SPEA2": (make(mo.SPEA2), 0),
        "HypE": (make(mo.HypE), g),  # the full sort of its tell
        "KnEA": (make(mo.KnEA), g),  # the full sort of its tell
        "BiGE": (make(mo.BiGE), 3 * g),  # the mating's bi-goals, the merged and the cut's bi-goals
    }


def family_loops(torch, algo, astate, fit) -> dict:
    """Each sequential loop of the family's selections on one generation's
    merged rows, alone: name -> fn()."""
    from evox_tpu_torch.algorithms.mo import bce_ibea, ibea, knea, spea2, sra
    from evox_tpu_torch.operators.selection import non_dominated_sort

    name = type(algo).__name__
    k = algo.pop_size
    if name in ("IBEA", "BCEIBEA"):
        merged = torch.cat([astate.npc_fit if name == "BCEIBEA" else astate.fitness, fit])
        expo = ibea.indicator_terms(merged, algo.kappa)
        loops = {"removal_loop": lambda: ibea.worst_removal(expo, k)}
        if name == "BCEIBEA" and astate.counter % 2 == 0:
            pc_fit = torch.cat([astate.fitness, fit, astate.new_pc_fit])
            mask = non_dominated_sort(pc_fit, until=1) == 0
            n_nd = mask.sum().to(torch.int32)
            removals = int(n_nd) - k
            if removals > 0:
                loops["pc_thinning"] = lambda: bce_ibea.pc_thinning(pc_fit, mask, n_nd, removals)
        return loops
    merged = torch.cat([astate.fitness, fit])
    if name == "SRA":
        i_eps, sde = sra.sra_indicators(merged)
        d = astate.select_draws
        return {"sweeps": lambda: sra.stochastic_ranking(i_eps, sde, d["perm"], d["u_sweeps"], d["pc"])}
    if name == "SPEA2":
        dist = spea2.masked_dist(merged)
        nd = spea2.spea2_fitness(merged, dist) < 1.0
        removals = int(nd.sum()) - k
        return {"truncation": lambda: spea2.truncate(dist, nd, removals)} if removals > 0 else {}
    if name == "KnEA":
        order, rank, last, sizes = algo.sorted_fronts(merged)
        fit_sel = torch.where((rank <= last)[:, None], merged[order], torch.nan)
        return {"knee_loop": lambda: algo.find_knees(fit_sel, rank, sizes, astate.r, astate.t)}
    return {}


def phase_indicator_family(torch, gens: int, seed: int) -> dict:
    """IBEA, SRA, BCE-IBEA, SPEA2, HypE, KnEA and BiGE, ``gens`` generations
    each on DTLZ2(d=12, m=3) at pop 1000: ms a generation, the split, each
    sequential loop of the selection alone, IGD; launches checked."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.problems.numerical import DTLZ2

    out = {}
    for name, (make, b3) in indicator_family_makers(torch, gens).items():
        algo = make()
        wf = StdWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M))
        state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": b3})
        row = {"pop": algo.pop_size, "generations": gens, "ms_per_generation": wall / gens * 1e3,
               "launches": launches, **mo_quality(torch, wf, state)}
        off, astate = algo.ask(state.algo)
        fit, _ = wf.problem.evaluate(state.prob, off)
        row["loops_ms"] = {loop: statistics.median(_time_host_ms(torch, fn) for _ in range(3))
                           for loop, fn in family_loops(torch, algo, astate, fit).items()}
        row["breakdown_ms"] = mo_breakdown(torch, wf, state, {}, reps=3)
        print(f"[indicator family] {name}: {json.dumps(row)}", flush=True)
        out[name] = row
    return out


def phase_maf(torch, seed: int) -> dict:
    """MaF1-15 at m 3 and 5, each at its default d, evaluated on the card
    against the CPU at pop 10000 in its own box; MaF11's ``pf()``, which
    filters its points on B3, against the CPU's at m 3 and 5."""
    from evox_tpu_torch.problems.numerical import maf

    out = {}
    g = torch.Generator().manual_seed(seed)
    for m in (3, 5):
        for i in range(1, 16):
            card = getattr(maf, f"MaF{i}")(m=m)
            cpu = getattr(maf, f"MaF{i}")(m=m, device="cpu")
            lb, ub = cpu.bounds()
            pop = torch.rand((MAF_POP, cpu.d), generator=g) * (ub - lb) + lb
            got, _ = card.evaluate(None, pop.cuda())
            want, _ = cpu.evaluate(None, pop)
            # the card's and the CPU's cos, sin and pow differ by an ulp or
            # two; where a factor nearly cancels (MaF4's and MaF15's 1 - a
            # front of cosines, scaled by 1 + g up to ~1e5) that ulp is of the
            # row's scale, not of the value: 1e-4 relative, 1e-6 of the
            # row's largest |objective| (at least 1) absolute. MaF12's
            # s_decept (slope 1/B = 1000) and s_multi (slope (4A + 2) pi ~
            # 383) magnify an ulp of their input up to a thousandfold: 1e-4
            # of the row's scale there
            scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
            out[f"MaF{i}_m{m}"] = compare(f"MaF{i} (m {m}, d {cpu.d}, pop {MAF_POP}) on the card "
                                          "against the CPU, over each row's scale",
                                          got.cpu() / scale, want / scale, rtol=1e-4,
                                          atol=1e-4 if i == 12 else 1e-6)
        card, cpu = maf.MaF11(m=m), maf.MaF11(m=m, device="cpu")
        torch.cuda.synchronize()
        reset_launches()
        pf = card.pf()
        torch.cuda.synchronize()
        launches = read_launches()["packed_dominance"]
        if launches != 1:
            raise AssertionError(f"MaF11.pf() (m {m}) launched packed_dominance {launches} times")
        pf_cpu = cpu.pf()
        if pf.shape != pf_cpu.shape:
            raise AssertionError(f"MaF11.pf() (m {m}): {tuple(pf.shape)} on the card, "
                                 f"{tuple(pf_cpu.shape)} on the CPU")
        row = compare(f"MaF11.pf() (m {m}) on the card against the CPU", pf.cpu(), pf_cpu,
                      rtol=1e-6, atol=2e-6)
        row.update({"launches": launches, "n": cpu._uniform_pts().shape[0], "front": pf.shape[0]})
        out[f"MaF11_pf_m{m}"] = row
    return out


# ----------------------------------------------------------- main path 14


def build_island_paths(torch, pop: int = ISL_POP, dim: int = ISL_DIM, n: int = ISL_N,
                       device=None):
    """Main path 14 as ``bench.py:415-440`` builds it, ``IslandWorkflow(PSO(
    ±32, d 256, pop 512), Ackley(), n_islands=8, migrate_every=8)``
    (``migrate_k`` at its default of 1), and its panmictic twin
    (``bench.py:443-455``), ``StdWorkflow(PSO(±32, d 256, pop 4096),
    Ackley())``. ``pop``, ``dim``, ``n`` and ``device`` exist for a
    rehearsal on the CPU."""
    from evox_tpu_torch import IslandWorkflow, StdWorkflow
    from evox_tpu_torch.algorithms.so.pso import PSO
    from evox_tpu_torch.problems.numerical import Ackley

    bound = torch.full((dim,), ISL_BOUND)
    islands = IslandWorkflow(PSO(lb=-bound, ub=bound, pop_size=pop, device=device), Ackley(),
                             n_islands=n, migrate_every=ISL_EVERY, device=device)
    panmictic = StdWorkflow(PSO(lb=-bound, ub=bound, pop_size=n * pop, device=device), Ackley(),
                            device=device)
    return islands, panmictic


def catch_elites(wf) -> list:
    """Wrap ``wf.elites`` to keep each migration's fitness input (a clone)
    and the elites' indices; returns the list they go to. Unwrap with
    ``del wf.elites``."""
    caught = []
    elites = type(wf).elites.__get__(wf)

    def kept(fitness):
        idx = elites(fitness)
        caught.append((fitness.clone(), idx))
        return idx

    wf.elites = kept
    return caught


def _timed_host_ms(torch, fn, reps: int) -> float:
    """Median host-clock ms of ``fn``, synchronised on both sides."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_topk_batched(torch, v_path) -> dict:
    """B4's batched launch: ``partial_topk`` over ``(rows, n)`` against its
    plain version (row by row, the 1-D plain version), bit for bit, at path
    14's migration input and at every shape of ``TOPK_BATCHES`` (rounded
    normals with NaNs, ±inf and ±0.0 in every row, an all-equal row, and the
    NSGA-II cut key's +inf rows); one launch a call on the small route, one
    a row on the large; then timed at path 14's shape against
    ``torch.topk(v, 1, dim=1, largest=False)`` and against one-row launches."""
    from evox_tpu_torch.kernels import topk as kt

    out = {"shapes": []}
    cases = [("path 14's migration input", v_path, 1)]
    for rows, n, k in TOPK_BATCHES:
        laws = [topk_values(torch, "rounded" if r % 2 else "cut", n, 7 * r + n, 0.5, 3)
                for r in range(rows)]
        v = torch.stack(laws).cuda()
        v[-1] = v[-1, 0]  # an all-equal row
        cases.append((f"stress rows ({rows}, {n}, {k})", v, k))
    for name, v, k in cases:
        plan = kt.launch_plan(v.shape[1], k, rows=v.shape[0])
        before = kt.partial_topk.launches
        got = kt.partial_topk(v, k)
        launches = kt.partial_topk.launches - before
        want_launches = 1 if plan["route"] == "small" else v.shape[0]
        if launches != want_launches:
            raise AssertionError(f"batched partial_topk {name}: {launches} launches, expected "
                                 f"{want_launches} ({plan['route']} route)")
        check = compare_exact(f"batched partial_topk, {name}, {plan['route']} route", got,
                              kt.partial_topk_reference(v, k))
        out["shapes"].append({"rows": v.shape[0], "n": v.shape[1], "k": k, "route": plan["route"],
                              "launches": launches, "max_abs_err": check["max_abs_err"]})
    v, k = v_path, 1
    rows, n = v.shape
    b4 = lambda: kt.partial_topk(v, k)
    lib = lambda: torch.topk(v, k, dim=1, largest=False)
    singles = lambda: [kt.partial_topk(v[r], k) for r in range(rows)]
    timing = {"rows": rows, "n": n, "k": k,
              "ms": _time_ms(b4, 20, 200), "library_ms": _time_ms(lib, 20, 200),
              "one_row_launches_ms": _time_ms(singles, 5, 50),
              "device_us": device_us_per_call(torch, b4),
              "library_device_us": device_us_per_call(torch, lib),
              "one_row_launches_device_us": device_us_per_call(torch, singles),
              "host_us": host_us_per_call(torch, b4), "library_host_us": host_us_per_call(torch, lib),
              "plain_ms": _time_ms(lambda: kt.partial_topk_reference(v, k), 3, 20),
              "max_abs_err": out["shapes"][0]["max_abs_err"]}
    timing["bound_ms"], timing["bound_by"] = bound_ms(*topk_work(n, k, rows))
    print(f"[topk batched] {json.dumps(timing)}", flush=True)
    out.update(timing)
    return out


def phase_island_path(torch, seed: int, profile: bool) -> dict:
    """Main path 14: the islands and their panmictic twin in turns
    (islands, panmictic, panmictic, islands), ``ISL_GENERATIONS`` each
    (two migration periods) after a warm-up of one period; counts set to 0
    just before each turn and read just after: one ``partial_topk`` launch
    a migration on the islands (a batched launch over the 8 islands), none
    on the twin. Then B4's batched holds and times, a migrating generation
    against one without on the host's clock, and one migrating generation
    on the card against the CPU."""
    wf, twin = build_island_paths(torch)
    state = wf.run(wf.init(ISL_SEED), ISL_EVERY - 1)
    caught = catch_elites(wf)
    state = wf.step(state)  # generation 8 migrates: builds and warms B4's batched route
    del wf.elites
    tstate = twin.run(twin.init(ISL_SEED), ISL_EVERY)
    torch.cuda.synchronize()
    if len(caught) != 1 or caught[0][1].shape != (ISL_N, 1):
        raise AssertionError(f"the warm-up's migration chose {caught and caught[0][1].shape}")
    turns, launches = [], []
    order = (("islands", wf), ("panmictic", twin), ("panmictic", twin), ("islands", wf))
    for name, w in order:
        s = state if name == "islands" else tstate
        reset_launches()  # every count to 0 just before the run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = w.run(s, ISL_GENERATIONS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()  # read just after
        migrations = ISL_GENERATIONS // ISL_EVERY if name == "islands" else 0
        want = {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": migrations,
                "fused_mlp_rollout": 0}
        if got != want:
            raise AssertionError(f"launches in {ISL_GENERATIONS} {name} generations: {got}, "
                                 f"expected {want}")
        launches.append(got["partial_topk"])
        turns.append({"workflow": name, "generations": ISL_GENERATIONS, "wall_s": wall,
                      "ms_per_generation": wall / ISL_GENERATIONS * 1e3,
                      "evals_per_s": ISL_GENERATIONS * ISL_N * ISL_POP / wall,
                      "migrations": migrations})
        print(f"[island path] {json.dumps(turns[-1])}", flush=True)
        if name == "islands":
            state = s
        else:
            tstate = s
    for name, s in (("islands", state.algo.population.reshape(-1, ISL_DIM)),
                    ("panmictic", tstate.algo.population)):
        if not bool(torch.isfinite(s).all()) or float(s.abs().max()) > ISL_BOUND:
            raise AssertionError(f"{name}: the population leaves the bounds or is not finite")
    per_island, best = wf.best(state)
    if not (per_island.shape == (ISL_N,) and bool(torch.isfinite(per_island).all())):
        raise AssertionError(f"islands' best: {per_island}")
    med = {w: statistics.median(t["ms_per_generation"] for t in turns if t["workflow"] == w)
           for w in ("islands", "panmictic")}
    out = {
        "n_islands": ISL_N, "pop": ISL_POP, "dim": ISL_DIM, "migrate_every": ISL_EVERY,
        "migrate_k": wf.migrate_k, "member_route": wf.member_route, "turns": turns,
        "launches": sum(launches),
        "launches_per_turn": launches,
        "ms_per_generation": med["islands"], "panmictic_ms_per_generation": med["panmictic"],
        "evals_per_s": ISL_N * ISL_POP / med["islands"] * 1e3,
        "panmictic_evals_per_s": ISL_N * ISL_POP / med["panmictic"] * 1e3,
        "island_cost_ratio": med["islands"] / med["panmictic"],
        "best_fitness": float(best),
        "panmictic_best_fitness": float(tstate.algo.gbest_fitness),
    }
    # the host's clock of one generation that migrates (from generation
    # 8k - 1) against one that does not (from 8k)
    before = state
    while (before.generation + 1) % ISL_EVERY:
        before = wf.step(before)
    after = wf.step(before)
    out["migration_generation_ms"] = _timed_host_ms(torch, lambda: wf.step(before), 10)
    out["plain_generation_ms"] = _timed_host_ms(torch, lambda: wf.step(after), 10)
    out["topk_batched"] = phase_topk_batched(torch, caught[0][0])
    out["card_vs_cpu"] = phase_island_card_vs_cpu(torch, wf, before)
    if profile:
        for name, w, s in (("islands", wf, before), ("panmictic", twin, tstate)):
            prof = profile_generations(torch, w, s, ISL_EVERY)  # one migration on the islands
            prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (
                med[name] * 1e3)
            out[f"profile_{name}"] = prof
    print(f"[island path] {json.dumps({k: v for k, v in out.items() if k != 'turns'})}",
          flush=True)
    return out


def phase_island_card_vs_cpu(torch, wf, state) -> dict:
    """One migrating generation of path 14 on the card against the same
    generation on the CPU: the card's state moved to the CPU, each island's
    PSO draws made once on the CPU and handed to both. Ackley's sums of 256
    squares and cosines run in other orders on the two devices, and CUDA's
    ``exp``/``cos`` may differ from the CPU's by an ulp, so the fitness and
    the personal-best fitness are held within 1e-6 relative; every position,
    velocity, personal and global best position and the elites' indices
    bit for bit (no decision lands within an ulp here; a flip would show as
    a mismatch and fail the phase)."""
    cpu_wf, _ = build_island_paths(torch, device="cpu")
    card, cpu = wf.algorithm, cpu_wf.algorithm
    draws = {}
    draw = cpu._draw
    cpu._draw = lambda s: draws.setdefault(s, draw(s))
    card._draw = lambda s: tuple(t.cuda() for t in draws[s])
    cpu_state = _state_on(torch, state, "cpu")
    caught_cpu, caught_card = catch_elites(cpu_wf), catch_elites(wf)
    try:
        want = cpu_wf.step(cpu_state)
        got = wf.step(state)
    finally:
        del card._draw, wf.elites
    if not (len(caught_cpu) == len(caught_card) == 1):
        raise AssertionError("the compared generation did not migrate")
    fit = compare("island generation, fitness, card against CPU",
                  caught_card[0][0].cpu().reshape(-1), caught_cpu[0][0].reshape(-1), 1e-6, 0.0)
    out = {"fitness": fit, "elites": compare_exact("island generation, elites, card against CPU",
                                                   [caught_card[0][1].cpu()], [caught_cpu[0][1]])}
    exact = ("population", "velocity", "pbest_position", "gbest_position")
    out["state"] = compare_exact(
        "island generation, positions, velocities and bests, card against CPU",
        [getattr(got.algo, f).cpu() for f in exact], [getattr(want.algo, f) for f in exact])
    out["pbest_fitness"] = compare(
        "island generation, personal-best fitness, card against CPU",
        got.algo.pbest_fitness.reshape(-1).cpu(), want.algo.pbest_fitness.reshape(-1), 1e-6, 0.0)
    return out


# ----------------------------------------------------------- main path 15


def build_ipop_path(torch, dim: int = CMAES_DIM, device=None):
    """Main path 15 as ``docs/GUIDE.md:504-520`` builds it, at path 5's
    shape: ``factory(pop) = GuardedAlgorithm(CMAES(zeros(1000), 1.0,
    pop_size=pop), stagnation_limit=80)``, ``StdWorkflow(factory(24),
    Rastrigin())`` and ``IPOPRestarts(factory, max_restarts=4,
    check_every=100)``. Returns ``(workflow, policy, factory)``."""
    from evox_tpu_torch import GuardedAlgorithm, IPOPRestarts, StdWorkflow
    from evox_tpu_torch.algorithms.so.es import CMAES
    from evox_tpu_torch.problems.numerical import Rastrigin

    def factory(pop):
        return GuardedAlgorithm(CMAES(torch.zeros(dim), 1.0, pop_size=pop, device=device),
                                stagnation_limit=IPOP_STAGNATION)

    policy = IPOPRestarts(factory, max_restarts=IPOP_RESTARTS, check_every=IPOP_CHECK)
    return StdWorkflow(factory(IPOP_POP), Rastrigin(), device=device), policy, factory


def phase_ipop_path(torch, seed: int) -> dict:
    """Main path 15: ``wf.run(state, N, restarts=policy)`` in two calls, the
    covariance and its factorization poisoned with NaN between them (the
    way ``tests/test_numeric_chaos.py`` does): the guard restarts at the
    next tell, and the boundary at 100 doubles λ from 24 to 48; one whole
    segment runs at 48. Each segment timed (synchronised at its ends, where
    the host reads the counters anyway); then guarded against bare CMA-ES
    (path 5's algorithm at its shape) in turns; peak device memory."""
    import evox_tpu_torch.workflows.std as std_module
    from evox_tpu_torch.algorithms.so.es import CMAES
    from evox_tpu_torch.algorithms.so.es.common import safe_eigh

    wf, policy, factory = build_ipop_path(torch)
    segments = []
    fused = std_module.fused_run

    def timed_segment(w, s, chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = s.generation
        s = fused(w, s, chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        segments.append({"from": start, "to": s.generation, "pop": w.algorithm.pop_size,
                         "ms_per_generation": wall / chunk * 1e3,
                         "restarts": s.algo.restarts})
        return s

    state = wf.init(seed)
    safe_eigh(torch.eye(CMAES_DIM).cuda(), 1e14)  # cuSOLVER's first call, untimed
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    std_module.fused_run = timed_segment
    try:
        state = wf.run(state, IPOP_POISON_GEN, restarts=policy)
        inner = state.algo.inner
        state = state.replace(algo=state.algo.replace(inner=inner.replace(
            C=torch.full_like(inner.C, float("nan")), B=torch.full_like(inner.B, float("nan")),
            D=torch.full_like(inner.D, float("nan")))))
        state = wf.run(state, IPOP_GENERATIONS - IPOP_POISON_GEN, restarts=policy)
    finally:
        std_module.fused_run = fused
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    events = wf._ipop_events
    if launches != {"fused_rollout": 0, "packed_dominance": 0, "partial_topk": 0,
                    "fused_mlp_rollout": 0}:
        raise AssertionError(f"kernel launches on the IPOP path: {launches}")
    if [(e["generation"], e["pop_size"]) for e in events] != [(IPOP_CHECK, 2 * IPOP_POP)]:
        raise AssertionError(f"IPOP events {events}, expected one doubling to {2 * IPOP_POP} "
                             f"at generation {IPOP_CHECK}")
    s = state.algo
    if not (state.generation == IPOP_GENERATIONS and s.pop_size == 2 * IPOP_POP
            and s.restarts >= 1 and s.checked_restarts >= 1):
        raise AssertionError(f"IPOP path ended at generation {state.generation}, pop "
                             f"{s.pop_size}, restarts {s.restarts}")
    if not (bool(torch.isfinite(s.inner.C).all()) and math.isfinite(float(s.best_fitness))):
        raise AssertionError("the IPOP path's state is not finite after the restart")
    at48 = [g for g in segments if g["pop"] == 2 * IPOP_POP]
    if not at48 or at48[0]["to"] - at48[0]["from"] < IPOP_CHECK:
        raise AssertionError(f"no whole segment at {2 * IPOP_POP}: {segments}")
    report = wf.algorithm.health_report(s)

    # the guard's cost: guarded against bare CMA-ES at path 5's shape, from
    # warm states, in turns (guarded, bare, bare, guarded), whole periods
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.problems.numerical import Rastrigin

    bare = StdWorkflow(CMAES(torch.zeros(CMAES_DIM), 1.0, pop_size=IPOP_POP), Rastrigin())
    guarded = StdWorkflow(factory(IPOP_POP), Rastrigin())
    period = bare.algorithm.decomp_per_iter
    gens = period * math.ceil(GENERATIONS / period)
    warm = {"bare": bare.step(bare.init(seed)), "guarded": guarded.step(guarded.init(seed))}
    turns = []
    for name, w in (("guarded", guarded), ("bare", bare), ("bare", bare), ("guarded", guarded)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = w.run(warm[name], gens)
        torch.cuda.synchronize()
        turns.append({"algorithm": name, "ms_per_generation": (time.perf_counter() - t0) / gens * 1e3})
    if end.algo.restarts:
        raise AssertionError("the guard fired on the healthy run it was timed on")
    med = {n: statistics.median(t["ms_per_generation"] for t in turns if t["algorithm"] == n)
           for n in ("guarded", "bare")}
    out = {"dim": CMAES_DIM, "pop": IPOP_POP, "generations": IPOP_GENERATIONS,
           "poisoned_at": IPOP_POISON_GEN, "segments": segments, "ipop_events": events,
           "launches": launches, "health_report": report, "peak_memory_bytes": peak,
           "guard_turns": turns, "guarded_ms_per_generation": med["guarded"],
           "bare_ms_per_generation": med["bare"],
           "guard_cost_ms_per_generation": med["guarded"] - med["bare"]}
    print(f"[ipop path] {json.dumps(out)}", flush=True)
    return out


# ------------------------------------------------ containers and MO islands


def _same_draws(torch, cpu_algo, card_algo, name: str = "_draw") -> None:
    """Each draw made once on the CPU (by the CPU algorithm's own method)
    and handed to both sides, keyed by its seed."""
    made = {}
    draw = getattr(cpu_algo, name)

    def on_cpu(seed):
        if seed not in made:
            made[seed] = draw(seed)
        return made[seed]

    setattr(cpu_algo, name, on_cpu)
    setattr(card_algo, name, lambda seed: _state_on(torch, made[seed], "cuda"))


def _state_on(torch, state, device):
    """Any state or draw (tuples of member states, nested states, dicts)
    with every tensor on ``device``."""
    from evox_tpu_torch.core.struct import map_tensors

    return map_tensors(lambda t: t.to(device), state)


def _tensors(torch, state) -> list:
    """Every tensor of a state or batch, in field (or sorted key) order."""
    import dataclasses

    if isinstance(state, torch.Tensor):
        return [state]
    if dataclasses.is_dataclass(state):
        return [t for f in dataclasses.fields(state) for t in _tensors(torch, getattr(state, f.name))]
    if isinstance(state, (tuple, list)):
        return [t for v in state for t in _tensors(torch, v)]
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _tensors(torch, state[k])]
    return []


def container_run(torch, name: str, make, evaluate, gens: int, draws=("_draw",)) -> dict:
    """``make(device) -> (container, base algorithms)`` built on the card and
    on the CPU; the CPU's initial state moved to the card; ``gens``
    generations (the init protocol, then steady), each draw made once on the
    CPU and handed to both; each side evaluates its own batch
    (``evaluate(cand) -> fitness``), the fitness held within 1e-5 relative
    (Ackley's float32 sums and transcendentals on two devices), then both
    tell the CPU's fitness, and the states are held bit for bit."""
    card, card_bases = make(None)
    cpu, cpu_bases = make("cpu")
    for c_base, g_base in zip(cpu_bases, card_bases):
        for d in draws:
            if hasattr(c_base, d):
                _same_draws(torch, c_base, g_base, d)
    for d in ("_draw_active", "_draw_permutation"):
        if hasattr(cpu, d):
            _same_draws(torch, cpu, card, d)
    s_cpu = cpu.init(SEED)
    s_card = _state_on(torch, s_cpu, "cuda")
    fit_err = 0.0
    for gen in range(gens):
        ask, tell = ("init_ask", "init_tell") if gen == 0 else ("ask", "tell")
        c_cpu, s_cpu = getattr(cpu, ask)(s_cpu)
        c_card, s_card = getattr(card, ask)(s_card)
        compare_exact(f"{name}, generation {gen}, candidates, card against CPU",
                      _tensors(torch, c_card), _tensors(torch, c_cpu))
        f_cpu, f_card = evaluate(c_cpu), evaluate(c_card)
        fit_err = max(fit_err, compare(f"{name}, generation {gen}, fitness, card against CPU",
                                       f_card.cpu(), f_cpu, 1e-5, 0.0)["max_rel_err"])
        s_cpu = getattr(cpu, tell)(s_cpu, f_cpu)
        s_card = getattr(card, tell)(s_card, f_cpu.cuda())
        check = compare_exact(f"{name}, generation {gen}, state, card against CPU",
                              [t.cpu() for t in _tensors(torch, s_card)], _tensors(torch, s_cpu))
    return {"generations": gens, "state_elements": check["elements"], "fitness_max_rel_err": fit_err}


def phase_containers(torch) -> dict:
    """The containers phase: ClusteredAlgorithm(CSO(pop 512), dim 1024, 8
    clusters) on Ackley; VectorizedCoevolution and Coevolution of PSO(pop
    512) over 8 blocks of 128 (``random_subpop`` on the vectorized one) on
    Ackley at d 1024; RandomMaskAlgorithm(PSO(pop 512), 8 clusters, 2
    masked, a new mask every 2 generations) through one mask change; and
    TreeAlgorithm(PSO(pop 512)) over {"w": (32, 32), "b": (32,)} on a sum
    of squares: each on the card against the CPU (``container_run``). The
    clusters and blocks are stacked states, asked and told in one member
    call (the tree container is a tuple, as in the JAX package)."""
    from evox_tpu_torch.algorithms import containers as tc
    from evox_tpu_torch.algorithms.so.pso import CSO, PSO
    from evox_tpu_torch.problems.numerical import Ackley

    ackley = lambda c: Ackley().evaluate(None, c)[0]
    sub = CONTAINER_DIM // CONTAINER_BLOCKS
    bound = lambda d: torch.full((d,), 32.0)

    def clustered(device):
        base = CSO(-bound(sub), bound(sub), CONTAINER_POP, device=device)
        return tc.ClusteredAlgorithm(base, CONTAINER_DIM, CONTAINER_BLOCKS), [base]

    def coevolution(cls, **kw):
        def make(device):
            base = PSO(-bound(sub), bound(sub), CONTAINER_POP, device=device)
            return cls(base, CONTAINER_DIM, CONTAINER_BLOCKS, **kw), [base]
        return make

    def random_mask(device):
        base = PSO(-bound(sub), bound(sub), CONTAINER_POP, device=device)
        return tc.RandomMaskAlgorithm(base, CONTAINER_DIM, CONTAINER_BLOCKS, num_mask=2,
                                      change_every=2), [base]

    def tree(device):
        params = {"w": torch.zeros(32, 32), "b": torch.zeros(32)}
        lbs = {"w": -torch.ones(1024), "b": -torch.ones(32)}
        ubs = {"w": torch.ones(1024), "b": torch.ones(32)}
        algo = tc.TreeAlgorithm(lambda lb, ub: PSO(lb, ub, CONTAINER_POP, device=device), params,
                                lbs, ubs)
        return algo, algo.inner

    tree_fitness = lambda c: (c["w"] ** 2).sum(dim=(1, 2)) + (c["b"] ** 2).sum(dim=1)
    out = {}
    for name, make, evaluate, gens in (
        ("ClusteredAlgorithm(CSO)", clustered, ackley, 4),
        ("VectorizedCoevolution(PSO, random_subpop)",
         coevolution(tc.VectorizedCoevolution, random_subpop=True), ackley, 3),
        ("Coevolution(PSO)", coevolution(tc.Coevolution), ackley, 4),
        ("RandomMaskAlgorithm(PSO)", random_mask, ackley, 6),
        ("TreeAlgorithm(PSO)", tree, tree_fitness, 3),
    ):
        t0 = time.perf_counter()
        out[name] = container_run(torch, name, make, evaluate, gens)
        out[name]["command_s"] = time.perf_counter() - t0
    print(f"[containers] {json.dumps(out)}", flush=True)
    return out


def build_mo_islands(torch, device=None):
    """The MO islands phase's workflow: ``IslandWorkflow(NSGA2(pop 1000, m
    3, use_kernel=True), DTLZ2(d 12), n_islands=4, migrate_every=5,
    migrate_k=4, num_objectives=3)``."""
    from evox_tpu_torch import IslandWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.problems.numerical import DTLZ2

    algo = NSGA2(torch.zeros(MOEAD_D), torch.ones(MOEAD_D), n_objs=MO_M, pop_size=MO_FAMILY_POP,
                 use_kernel=True, device=device)
    return IslandWorkflow(algo, DTLZ2(d=MOEAD_D, m=MO_M, device=device), n_islands=MO_ISLANDS,
                          migrate_every=5, migrate_k=4, num_objectives=MO_M, device=device)


def island_generation_halves(torch, wf, cpu_wf, state, cpu_state, evaluate) -> dict:
    """One stacked island generation on the card and on the CPU, as
    ``IslandWorkflow``'s step runs it (one member call each for ask and
    tell, then the ring migration with its elites), from ``state`` on the
    card and ``cpu_state`` on the CPU: the same state on the CPU, or a
    function that moves the card's asked state there (its candidates go
    with it). ``evaluate(candidates)`` scores the CPU's flattened
    candidates, and that fitness is told to both sides, so no
    transcendental's last bit decides a selection. Returns each side's
    candidates, told and migrated states and elites, the fitness, and the
    kernel launches of the card's tell and migration."""
    from evox_tpu_torch.core.members import member_call
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.kernels import topk as kt

    route = wf.member_route
    if callable(cpu_state):
        cand, asked = member_call(wf.algorithm.ask, state.algo, route=route)
        cand_cpu, asked_cpu = cand.cpu(), cpu_state(asked)
    else:  # the CPU asks first: ``_same_draws`` hands the CPU's draws to the card
        cand_cpu, asked_cpu = member_call(cpu_wf.algorithm.ask, cpu_state.algo, route=route)
        cand, asked = member_call(wf.algorithm.ask, state.algo, route=route)
    n, batch = cand_cpu.shape[:2]
    raw = evaluate(cand_cpu.reshape((n * batch,) + cand_cpu.shape[2:]))
    if wf.num_objectives > 1:
        fit = (raw * cpu_wf.opt_direction).reshape(n, batch, wf.num_objectives)
    else:
        fit = (raw * cpu_wf.opt_direction[0]).reshape(n, batch)
    out = {"cand": (cand, cand_cpu), "fitness": fit}
    for side, w, s, c, f in (("card", wf, asked, cand, fit.cuda()),
                             ("cpu", cpu_wf, asked_cpu, cand_cpu, fit)):
        b3, b4 = kd.packed_dominance.launches, kt.partial_topk.launches
        told = member_call(w.algorithm.tell, s, f, route=route)
        caught = catch_elites(w)
        try:
            moved = w._migrate(told, c, f)
        finally:
            del w.elites
        out[side] = {"told": told, "moved": moved, "elites": caught[0][1],
                     "launches": {"packed_dominance": kd.packed_dominance.launches - b3,
                                  "partial_topk": kt.partial_topk.launches - b4}}
    torch.cuda.synchronize()
    for key in ("told", "moved", "elites"):
        out[key] = (out["card"][key], out["cpu"][key])
    out["launches"] = out["card"]["launches"]
    return out


def _nsga2_states_equal(torch, name: str, got, want) -> dict:
    """Stacked NSGA-II states, card against CPU: population, fitness, rank
    and offspring bit for bit; crowding's infinite entries equal and its
    finite ones within 1e-6 relative (the same float32 operations on both
    devices; the tolerance allows an ulp of the division, as path 2's tell
    check does)."""
    fields = ("population", "fitness", "rank", "offspring")
    out = compare_exact(f"{name} (population, fitness, rank, offspring)",
                        [getattr(got, f).cpu() for f in fields], [getattr(want, f) for f in fields])
    crowd, crowd_cpu = got.crowd.cpu(), want.crowd
    finite = torch.isfinite(crowd_cpu)
    if not torch.equal(torch.isfinite(crowd), finite) or not torch.equal(crowd[~finite],
                                                                         crowd_cpu[~finite]):
        raise AssertionError(f"{name}: the infinite crowding distances differ")
    out["crowd"] = compare(f"{name}, crowd (finite entries)", crowd[finite], crowd_cpu[finite],
                           rtol=1e-6, atol=0.0)
    return out


def phase_mo_island_card_vs_cpu(torch, wf, state) -> dict:
    """One migrating MO island generation on the card against the CPU's
    plain routes. NSGA-II's operators draw from the device's own
    generator, so the card's offspring and asked states are moved to the
    CPU; DTLZ2 of those offspring on the CPU is told to both. Then NSGA-II's
    tell under vmap (one batched B3 sort, the peel over all islands, one
    batched B4 cut) and the migration (B3 for the elites, B3 for the
    ingesting migrate): the told and migrated states as
    ``_nsga2_states_equal`` holds them, the elites bit for bit."""
    from evox_tpu_torch.problems.numerical import DTLZ2

    cpu_wf = build_mo_islands(torch, device="cpu")
    dtlz2 = DTLZ2(d=MOEAD_D, m=MO_M, device="cpu")
    halves = island_generation_halves(torch, wf, cpu_wf, state,
                                      lambda asked: _state_on(torch, asked, "cpu"),
                                      lambda c: dtlz2.evaluate(None, c)[0])
    want = {"packed_dominance": 3, "partial_topk": 1}
    if halves["launches"] != want:
        raise AssertionError(f"the compared MO island generation launched {halves['launches']}, "
                             f"expected {want} (the tell's sort and cut, the elites, the migrate)")
    out = {"generation": state.generation + 1, "launches": halves["launches"]}
    out["tell"] = _nsga2_states_equal(torch, "MO island tell under vmap, card against CPU",
                                      *halves["told"])
    out["elites"] = compare_exact("MO island elites under vmap, card against CPU",
                                  [halves["elites"][0].cpu()], [halves["elites"][1]])
    out["migrate"] = _nsga2_states_equal(torch, "MO island migrate under vmap, card against CPU",
                                         *halves["moved"])
    return out


def phase_mo_islands(torch, seed: int) -> dict:
    """The MO islands phase: ``IslandWorkflow(NSGA2(pop 1000, m 3), DTLZ2(d
    12), n_islands=4, migrate_every=5, migrate_k=4, num_objectives=3)`` for
    10 generations on stacked island states: NSGA-II's tell one batched B3
    launch a generation over the 4 islands' merged rows (init_tell's sort
    too), and at each migration one batched B3 launch for the elites (rank,
    then crowding) and one for the ingesting ``migrate``; NSGA-II's cut
    (``use_kernel=True``) one batched B4 launch a steady tell; the elites of
    the last migration held against the CPU's plain route, island by
    island; then one migrating generation's tell and migration on the card
    against the CPU (``phase_mo_island_card_vs_cpu``)."""
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.workflows.islands import mo_elites

    wf = build_mo_islands(torch)
    elite_launches = []
    caught = catch_elites(wf)
    inner = wf.elites

    def counted(fitness):
        before = kd.packed_dominance.launches
        idx = inner(fitness)
        elite_launches.append(kd.packed_dominance.launches - before)
        return idx

    wf.elites = counted
    state = wf.init(seed)
    reset_launches()
    t0 = time.perf_counter()
    state = wf.run(state, MO_ISLAND_GENERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    del wf.elites
    migrations = MO_ISLAND_GENERATIONS // 5
    if elite_launches != [1] * migrations:
        raise AssertionError(f"B3 launches a migration's elites: {elite_launches}, expected one "
                             f"batched launch for the {MO_ISLANDS} islands each")
    want_b3 = MO_ISLAND_GENERATIONS + 2 * migrations
    if launches["packed_dominance"] != want_b3:
        raise AssertionError(f"B3 launches in {MO_ISLAND_GENERATIONS} MO island generations: "
                             f"{launches['packed_dominance']}, expected {want_b3} (one a tell, "
                             "two a migration)")
    if launches["partial_topk"] != MO_ISLAND_GENERATIONS - 1:
        raise AssertionError(f"B4 launches of NSGA-II's cut under vmap: {launches['partial_topk']}, "
                             f"expected one a steady tell ({MO_ISLAND_GENERATIONS - 1})")
    fitness, idx = caught[-1]
    want = torch.stack([mo_elites(f, 4) for f in fitness.cpu()])
    check = compare_exact("MO islands' elites, card against CPU", [idx.cpu()], [want])
    before = state  # the state before the next migrating generation
    while (before.generation + 1) % wf.migrate_every:
        before = wf.step(before)
    card_vs_cpu = phase_mo_island_card_vs_cpu(torch, wf, before)
    per_island, ideal = wf.best(state)
    if not (per_island.shape == (MO_ISLANDS, MO_M) and bool(torch.isfinite(per_island).all())):
        raise AssertionError(f"MO islands' ideal points: {per_island}")
    out = {"n_islands": MO_ISLANDS, "pop": MO_FAMILY_POP, "generations": MO_ISLAND_GENERATIONS,
           "member_route": wf.member_route, "launches": launches,
           "elite_launches": elite_launches,
           "ms_per_generation": wall / MO_ISLAND_GENERATIONS * 1e3,
           "ideal": ideal.tolist(), "elites_max_abs_err": check["max_abs_err"],
           "card_vs_cpu": card_vs_cpu}
    print(f"[mo islands] {json.dumps(out)}", flush=True)
    return out


# ------------------------------------------- B3 batched, paths 28 and 29


def phase_dominance_batched(torch) -> dict:
    """B3 over a leading member axis: ``packed_dominance_batched`` at each
    shape of ``DOMINANCE_BATCHES`` (every member a different draw of phase
    2's stress rows: ties, NaN, ±0.0, ±inf and +inf rows) in one launch,
    held bit for bit against its plain batched version on the same card
    tensors and against ``b`` single-member launches; timed by CUDA events
    against the ``b`` single launches and the plain version, with its bound
    from the bytes and operations of ``b`` members."""
    from evox_tpu_torch.kernels import dominance as kd

    out = {"shapes": []}
    for b, n, m in DOMINANCE_BATCHES:
        fit = torch.stack([stress_fitness(torch, n, m, 1000 * b + n + r, "cpu")
                           for r in range(b)]).cuda()
        before = kd.packed_dominance.launches
        got = kd.packed_dominance_batched(fit, device=fit.device)
        launches = kd.packed_dominance.launches - before
        if launches != 1:
            raise AssertionError(f"batched packed_dominance ({b}, {n}, {m}): {launches} launches")
        check = compare_exact(f"batched packed_dominance ({b}, {n}, {m}) with stress rows", got,
                              kd.packed_dominance_batched_reference(fit))
        singles = [kd.packed_dominance(f, device=fit.device) for f in fit]
        compare_exact(f"batched packed_dominance ({b}, {n}, {m}) against single launches", got,
                      (torch.stack([p for p, _ in singles]), torch.stack([c for _, c in singles])))
        entry = {"b": b, "n": n, "m": m, "launches": launches, "max_abs_err": check["max_abs_err"],
                 "ms": _time_ms(lambda: kd.packed_dominance_batched(fit, device=fit.device), 3, 20),
                 "single_launches_ms": _time_ms(
                     lambda: [kd.packed_dominance(f, device=fit.device) for f in fit], 2, 10),
                 "plain_ms": _time_ms(lambda: kd.packed_dominance_batched_reference(fit), 1, 3)}
        nbytes, ops = dominance_work(n, m)
        entry["bound_ms"], entry["bound_by"] = bound_ms(b * nbytes, b * ops)
        out["shapes"].append(entry)
        print(f"[dominance batched] {json.dumps(entry)}", flush=True)
    return out


def build_shade_islands(torch, device=None):
    """The SHADE islands phase's workflow: ``IslandWorkflow(SHADE(±32, pop
    512, d 64), Ackley(), n_islands=8, migrate_every=4)``."""
    from evox_tpu_torch import IslandWorkflow
    from evox_tpu_torch.algorithms.so.de import SHADE
    from evox_tpu_torch.problems.numerical import Ackley

    bound = torch.full((SHADE_ISL_DIM,), 32.0)
    return IslandWorkflow(SHADE(-bound, bound, SHADE_ISL_POP, device=device), Ackley(),
                          n_islands=SHADE_ISL_N, migrate_every=4, device=device)


def phase_shade_island_card_vs_cpu(torch, wf, state) -> dict:
    """One migrating SHADE island generation on the card against the CPU on
    the same draws (each island's made once on the CPU from its own seed and
    handed to both): the trials of the ask under vmap (its pbest cut one
    batched B4 launch) bit for bit; Ackley of the CPU's trials told to both;
    the told states bit for bit but for the memories M_F and M_CR, weighted
    sums over each island's 512 candidates in each device's order (1e-4
    relative, as path 9's check); then the migration (B4 for the elites)
    and the migrated states bit for bit."""
    from evox_tpu_torch.problems.numerical import ackley_func

    cpu_wf = build_shade_islands(torch, device="cpu")
    _same_draws(torch, cpu_wf.algorithm, wf.algorithm)
    try:
        halves = island_generation_halves(torch, wf, cpu_wf, state, _state_on(torch, state, "cpu"),
                                          ackley_func)
    finally:
        del wf.algorithm._draw
    if halves["launches"] != {"packed_dominance": 0, "partial_topk": 1}:
        raise AssertionError(f"the compared SHADE island generation's tell and migration "
                             f"launched {halves['launches']}, expected one B4 (the elites)")
    out = {"generation": state.generation + 1,
           "trials": compare_exact("SHADE island trials under vmap, card against CPU",
                                   [halves["cand"][0].cpu()], [halves["cand"][1]])}
    exact = ("population", "fitness", "archive", "archive_size", "mem_pos", "F", "CR")
    for key in ("told", "moved"):
        got, want = halves[key]
        out[key] = compare_exact(
            f"SHADE island {'tell' if key == 'told' else 'migrate'} under vmap, card against CPU "
            f"({', '.join(exact)}, attribution)",
            [getattr(got, f).cpu() for f in exact] + [got.attrib.success.cpu(),
                                                      got.attrib.improvement.cpu()],
            [getattr(want, f) for f in exact] + [want.attrib.success, want.attrib.improvement])
        out[key]["memory"] = compare(
            f"SHADE island memories M_F and M_CR ({key}), card against CPU",
            torch.cat([got.M_F, got.M_CR], dim=1).cpu(), torch.cat([want.M_F, want.M_CR], dim=1),
            rtol=1e-4, atol=0.0)
    out["elites"] = compare_exact("SHADE island elites, card against CPU",
                                  [halves["elites"][0].cpu()], [halves["elites"][1]])
    out["replaced"] = int(halves["told"][1].attrib.success.sum())
    return out


def phase_shade_islands(torch, seed: int = SEED, device=None) -> dict:
    """SHADE islands: ``IslandWorkflow(SHADE(pop 512, d 64), Ackley(),
    n_islands=8, migrate_every=4)`` for 8 generations on stacked states:
    the pbest cut of every island's ask is one batched B4 launch (the cut's
    vmap rule folds the islands into a (8, 512) launch), and each migration
    one more for the elites. Then one migrating generation on the card
    against the CPU (``phase_shade_island_card_vs_cpu``)."""
    wf = build_shade_islands(torch, device=device)
    state = wf.step(wf.init(seed))  # the init generation evaluates the population
    reset_launches()
    t0 = time.perf_counter()
    state = wf.run(state, SHADE_ISL_GENERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    migrations = (SHADE_ISL_GENERATIONS + 1) // 4
    if got["partial_topk"] != SHADE_ISL_GENERATIONS + migrations:
        raise AssertionError(f"B4 launches in {SHADE_ISL_GENERATIONS} SHADE island generations: "
                             f"{got['partial_topk']}, expected one a generation and one a "
                             f"migration ({SHADE_ISL_GENERATIONS + migrations})")
    if not bool(torch.isfinite(state.algo.fitness).all()):
        raise AssertionError("SHADE islands: non-finite fitness")
    out = {"n_islands": SHADE_ISL_N, "pop": SHADE_ISL_POP, "dim": SHADE_ISL_DIM,
           "generations": SHADE_ISL_GENERATIONS, "member_route": wf.member_route,
           "launches": got, "ms_per_generation": wall / SHADE_ISL_GENERATIONS * 1e3,
           "best_fitness": float(wf.best(state)[1])}
    before = state  # the state before the next migrating generation
    while (before.generation + 1) % wf.migrate_every:
        before = wf.step(before)
    out["card_vs_cpu"] = phase_shade_island_card_vs_cpu(torch, wf, before)
    print(f"[shade islands] {json.dumps(out)}", flush=True)
    return out


def build_fleet_path(torch, n: int = TEN_N, pop: int = TEN_POP, dim: int = TEN_DIM, device=None):
    """Main path 28 as ``bench.py:458-606`` builds it: ``VectorizedWorkflow(
    CMAES(zeros(16), init_stdev=1.0, pop_size=256), Sphere(), n_tenants=64)``
    and the one solo ``StdWorkflow`` of the same algorithm that drives the
    sequential side."""
    from evox_tpu_torch import StdWorkflow, VectorizedWorkflow
    from evox_tpu_torch.algorithms.so.es import CMAES
    from evox_tpu_torch.problems.numerical import Sphere

    algo = CMAES(torch.zeros(dim), init_stdev=1.0, pop_size=pop, device=device)
    return (VectorizedWorkflow(algo, Sphere(), n_tenants=n, device=device),
            StdWorkflow(algo, Sphere(), device=device))


class _Sequential:
    """The sequential side as one workflow: ``run`` drives every solo state
    ``n`` generations through one ``StdWorkflow``, one after the other."""

    def __init__(self, wf):
        self.wf = wf

    def run(self, states, n):
        return [self.wf.run(s, n) for s in states]


def _leaves_close(torch, name: str, got, want, rtol: float = 1e-5, atol: float = 1e-6,
                  skip=()) -> dict:
    """Every tensor leaf of ``got`` within ``atol + rtol * |want|`` of
    ``want`` (``tests/test_tenancy.py:68``'s tolerance), and how many are
    equal bit for bit; leaves whose path is in ``skip`` are left out."""
    from evox_tpu_torch.core.struct import named_leaves

    worst, equal, total = 0.0, 0, 0
    for (path, x), (_, y) in zip(named_leaves(got), named_leaves(want)):
        if path in skip:
            continue
        if not isinstance(x, torch.Tensor):
            if x != y:
                raise AssertionError(f"{name}: {path} {x} != {y}")
            continue
        x, y = x.cpu(), y.cpu()
        total += 1
        if torch.equal(x, y):
            equal += 1
            continue
        diff = (x.double() - y.double()).abs()
        bad = diff > atol + rtol * y.double().abs()
        if bool(bad.any()):
            raise AssertionError(f"{name}: {path} differs by up to {float(diff.max())}")
        worst = max(worst, float(diff.max()))
    return {"leaves": total, "bit_for_bit": equal, "max_abs_err": worst, "rtol": rtol,
            "atol": atol}


def phase_fleet_path(torch, seed: int = SEED, profile: bool = False, device=None) -> dict:
    """Main path 28, bench.py's workload 5: the 64-tenant CMA-ES fleet
    against the same 64 runs (seeds 0..63) driven one after the other
    through one solo ``StdWorkflow``, in turns (fleet, sequential,
    sequential, fleet), each turn bench's differenced protocol over
    ``TEN_PAIR`` = (10, 40) generations: ms a fleet generation against ms
    a generation of all 64 sequential runs. Beside them: the host's thread
    time a generation, the per-member draws' host share (``member_draw``),
    peak memory, and with ``profile`` the kernels and DtoH copies a
    generation, and M1's launches (seven a generation). Then tenants 0, 31
    and 63: each of 10 fleet steps against the solo step from
    the same state, bit for bit, and the 10-generation runs against their
    solo runs, under tests/test_tenancy.py:68's law (rtol 1e-5, atol 1e-6)
    and bit for bit; where a tenant could split from its solo run; and one
    fleet generation on the card against the CPU on the same draws."""
    from evox_tpu_torch.core import members

    fleet, solo = build_fleet_path(torch, device=device)
    seq = _Sequential(solo)
    seeds = list(range(TEN_N))
    fstate = fleet.step(fleet.init(seeds))  # the first generation, then steady
    sstates = [solo.step(solo.init(s)) for s in seeds]
    for n in TEN_PAIR:  # warm both trip counts on both sides
        fleet.run(fstate, n)
        solo.run(sstates[0], n)
    torch.cuda.synchronize()

    def timed(side, state, n):
        torch.cuda.synchronize()
        d0, c0 = members.member_draw.seconds, time.thread_time()
        t0 = time.perf_counter()
        side.run(state, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall, time.thread_time() - c0, members.member_draw.seconds - d0

    from evox_tpu_torch.kernels import smallmm as km

    turns = []
    for name in ("fleet", "sequential", "sequential", "fleet"):
        side, state = (fleet, fstate) if name == "fleet" else (seq, sstates)
        reset_launches()
        km.smallmm.launches = 0
        lo, hi = (timed(side, state, n) for n in TEN_PAIR)
        got = read_launches()
        if any(got.values()):
            raise AssertionError(f"{name}: CMA-ES on Sphere launched a kernel: {got}")
        # M1: seven a generation, one launch each for all tenants
        gens = sum(TEN_PAIR) * (1 if name == "fleet" else TEN_N)
        if km.smallmm.launches != CMAES_M1_LAUNCHES * gens:
            raise AssertionError(f"{name}: {km.smallmm.launches} M1 launches in {gens} "
                                 f"generations, expected {CMAES_M1_LAUNCHES * gens}")
        span = TEN_PAIR[1] - TEN_PAIR[0]
        turn = {"side": name, "ms_per_generation": (hi[0] - lo[0]) / span * 1e3,
                "host_thread_ms_per_generation": (hi[1] - lo[1]) / span * 1e3,
                "wall_s": lo[0] + hi[0], "m1_launches": km.smallmm.launches}
        if name == "fleet":
            turn["member_draw_ms_per_generation"] = (hi[2] - lo[2]) / span * 1e3
            turn["member_draw_share"] = turn["member_draw_ms_per_generation"] / turn[
                "ms_per_generation"]
        turns.append(turn)
        print(f"[fleet path] {json.dumps(turn)}", flush=True)
    med = {side: statistics.median(t["ms_per_generation"] for t in turns if t["side"] == side)
           for side in ("fleet", "sequential")}
    out = {"n_tenants": TEN_N, "pop": TEN_POP, "dim": TEN_DIM, "pair": list(TEN_PAIR),
           "member_route": fleet.member_route, "turns": turns,
           "fleet_ms_per_generation": med["fleet"],
           "sequential_ms_per_generation": med["sequential"],
           "sequential_over_fleet": med["sequential"] / med["fleet"],
           "member_draws_per_generation": TEN_N}
    torch.cuda.reset_peak_memory_stats()
    fleet.run(fstate, TEN_PAIR[0])
    torch.cuda.synchronize()
    out["fleet_peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seq.run(sstates, TEN_PAIR[0])
    torch.cuda.synchronize()
    out["sequential_peak_bytes"] = torch.cuda.max_memory_allocated()
    if profile:
        for name, side, state in (("fleet", fleet, fstate), ("sequential", seq, sstates)):
            prof = profile_generations(torch, side, state, 5)
            prof["device_idle_share"] = 1.0 - prof["device_busy_us_per_gen"] / (med[name] * 1e3)
            out[f"profile_{name}"] = prof
    # tenants against their solo runs: each of the first 10
    # fleet generations against the solo step of the same tenant's state,
    # and 10 generations of a tenant against 10 of its solo run, as
    # tests/test_tenancy.py:68 writes the law (rtol 1e-5, atol 1e-6).
    # CMA-ES's products go through M1, whose summation order does not
    # depend on the batch count, so both are held bit for bit
    fresh = fleet.init(seeds)
    steps = {str(i): [] for i in TEN_CHECK}
    for _ in range(TEN_CHECK_GENERATIONS):
        nxt = fleet.step(fresh)
        for i in TEN_CHECK:
            got = fleet.extract_tenant(nxt, i)
            want = solo.step(fleet.extract_tenant(fresh, i).replace(first_step=fresh.first_step))
            steps[str(i)].append(_states_exact(
                torch, f"fleet tenant {i}'s step against its solo step", got.algo, want.algo))
        fresh = nxt
    out["tenants_vs_solo_steps"] = {
        i: {"steps": len(v), "bit_for_bit_steps": sum(s["mismatches"] == 0 for s in v)}
        for i, v in steps.items()}
    out["tenants_after_10"] = {}
    for i in TEN_CHECK:
        want = solo.run(solo.init(seeds[i]), TEN_CHECK_GENERATIONS).algo
        got = fleet.extract_tenant(fresh, i).algo
        law = _leaves_close(torch, f"fleet tenant {i} after {TEN_CHECK_GENERATIONS} generations "
                            "against its solo run", got, want)
        exact = _states_exact(torch, f"fleet tenant {i} after {TEN_CHECK_GENERATIONS} "
                              "generations against its solo run, bit for bit", got, want)
        out["tenants_after_10"][str(i)] = {"law": law, "bit_for_bit": exact}
    out["where_they_split"] = fleet_split_points(torch, fleet, fresh)
    out["card_vs_cpu"] = phase_fleet_card_vs_cpu(torch, fleet, fresh)
    print(f"[fleet path] {json.dumps({k: v for k, v in out.items() if k != 'turns'})}",
          flush=True)
    return out


def _states_exact(torch, name: str, got, want) -> dict:
    """Every tensor leaf of two states equal bit for bit (floats as their
    int32 bits); on a mismatch the error names the leaves that differ."""
    from evox_tpu_torch.core.struct import named_leaves

    bad, elements = [], 0
    for (path, x), (_, y) in zip(named_leaves(got), named_leaves(want)):
        if not isinstance(x, torch.Tensor):
            continue
        x, y = x.cpu(), y.cpu()
        elements += x.numel()
        xi = x.view(torch.int32) if x.dtype == torch.float32 else x
        yi = y.view(torch.int32) if y.dtype == torch.float32 else y
        n = int((xi != yi).sum())
        if n:
            bad.append({"leaf": path, "mismatches": n,
                        "max_abs_err": float((x.double() - y.double()).abs().max())})
    stats = {"elements": elements, "mismatches": sum(b["mismatches"] for b in bad), "leaves": bad}
    print(f"[compare] {name}: {json.dumps(stats)}", flush=True)
    if bad:
        raise AssertionError(f"{name}: not bit for bit: {bad}")
    return stats


def fleet_split_points(torch, fleet, state) -> dict:
    """Where a fleet tenant's numbers could leave its solo run's: each
    product of CMA-ES's ask and tell as the port computes it
    (``cma_es._product``: M1 on the card), the norm of ``ps`` (M1's dot
    product) and the eigendecomposition, on every tenant's own inputs from ``state`` (its B,
    D, C, ps and z, the first mu rows of z standing for the sorted ones;
    each operation fed the solo results of the one before it), run three
    ways: under ``torch.func.vmap`` over all tenants (the fleet's call),
    under ``vmap`` over a batch of that one tenant, and on the tenant alone
    (the solo call). For each operation: how many tenants' fleet and
    batch-of-one results equal the solo result bit for bit, and the largest
    differences."""
    from evox_tpu_torch.algorithms.so.es.cma_es import _norm, _product

    algo, s = fleet.algorithm, state.tenants.algo
    w, mu, n = algo.weights, algo.mu, s.z.shape[0]
    eigh = lambda C: torch.linalg.eigh((C + C.transpose(-1, -2)) / 2.0)
    steps = (
        ("ask: (z D) B^T", lambda zd, B: _product("pd,ed->pe", zd, B), ("zD", "B")),
        ("tell: y = (z D) B^T, mu rows", lambda zd, B: _product("md,ed->me", zd[:mu], B),
         ("zD", "B")),
        ("tell: y_w = w y", lambda y: _product("m,md->d", w, y), ("y",)),
        ("tell: z_w = w z", lambda z: _product("m,md->d", w, z[:mu]), ("z",)),
        ("tell: B z_w", lambda B, zw: _product("de,e->d", B, zw), ("B", "z_w")),
        ("tell: rank-mu y^T diag(w) y", lambda y: _product("md,me->de", y * w[:, None], y),
         ("y",)),
        ("tell: |ps|", lambda ps: _norm(ps), ("ps",)),
        ("eigh: eigenvalues", lambda C: eigh(C)[0], ("C",)),
        ("eigh: eigenvectors", lambda C: eigh(C)[1], ("C",)),
    )
    inputs = {"zD": s.z * s.D[:, None, :], "B": s.B, "z": s.z, "ps": s.ps, "C": s.C}
    keep = {"tell: y = (z D) B^T, mu rows": "y", "tell: z_w = w z": "z_w"}
    out = {}
    for name, fn, args in steps:
        xs = [inputs[a] for a in args]
        batched = torch.func.vmap(fn)(*xs)
        solo = torch.stack([fn(*(x[i] for x in xs)) for i in range(n)])
        one = torch.stack([torch.func.vmap(fn)(*(x[i:i + 1] for x in xs))[0] for i in range(n)])
        if name in keep:
            inputs[keep[name]] = solo
        out[name] = {
            "fleet_equal_solo": sum(torch.equal(batched[i], solo[i]) for i in range(n)),
            "batch_of_one_equal_solo": sum(torch.equal(one[i], solo[i]) for i in range(n)),
            "fleet_equal_batch_of_one": sum(torch.equal(batched[i], one[i]) for i in range(n)),
            "fleet_max_abs_err": float((batched - solo).abs().max()),
            "batch_of_one_max_abs_err": float((one - solo).abs().max()),
            "tenants": n}
    return out


def phase_fleet_card_vs_cpu(torch, fleet, state) -> dict:
    """One fleet generation on the card against the same generation on the
    CPU: the card's state moved to the CPU, every tenant's draw made once on
    the CPU and handed to both. CMA-ES decomposes its covariance every
    generation at this shape, and ``eigh``'s eigenvectors are unique only up
    to sign, so B is left out; mean, sigma, the paths, C, D and the
    population are held within 1e-5 relative (atol 1e-6)."""
    cpu_fleet, _ = build_fleet_path(torch, device="cpu")
    _same_draws(torch, cpu_fleet.algorithm, fleet.algorithm)
    try:
        want = cpu_fleet.step(_state_on(torch, state, "cpu"))
        got = fleet.step(state)
    finally:
        del fleet.algorithm._draw
    out = {}
    for f in ("mean", "sigma", "pc", "ps", "C", "D", "z"):
        out[f] = compare(f"fleet generation, {f}, card against CPU",
                         getattr(got.tenants.algo, f).cpu().reshape(-1),
                         getattr(want.tenants.algo, f).reshape(-1), 1e-5, 1e-6)["max_abs_err"]
    return out


def phase_runqueue_path(torch, device=None) -> dict:
    """Main path 29, bench.py's RunQueue leg: a 4-slot CMA-ES fleet (path
    28's algorithm), ``RunQueue(chunk=5, journal=<temp dir>, supervisor=
    RunSupervisor(WorkflowCheckpointer(every=5), deadline_s=3))`` (every
    chunk dispatched under the supervisor; the report's ``supervisor``
    section with its dispatches), 6 specs of
    10 steps each run to completion (every result completed at 10
    generations, the journal's chunk barriers and the fleet snapshots
    written); ``run_report``'s tenancy section passes
    ``tools/check_report.py``. Then one eviction after the first chunk: the
    evicted tenant's checkpoint, resumed by a solo ``StdWorkflow`` to its
    budget, equals the solo continuation of the extracted state bit for
    bit, and an uninterrupted solo run bit for bit."""
    import tempfile

    from evox_tpu_torch import RunQueue, TenantSpec, run_report

    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer
    from evox_tpu_torch.workflows.supervisor import RunSupervisor

    out = {"slots": RQ_SLOTS, "chunk": RQ_CHUNK, "specs": RQ_SPECS, "steps": RQ_STEPS}
    with tempfile.TemporaryDirectory() as td, tempfile.TemporaryDirectory() as sd:
        fleet, _ = build_fleet_path(torch, n=RQ_SLOTS, device=device)
        sup = RunSupervisor(WorkflowCheckpointer(sd, every=RQ_CHUNK), deadline_s=SUP_DEADLINE_S)
        q = RunQueue(fleet, chunk=RQ_CHUNK, journal=td, supervisor=sup)
        for i in range(RQ_SPECS):
            q.submit(TenantSpec(seed=i, n_steps=RQ_STEPS, tag=f"bench{i}"))
        reset_launches()
        t0 = time.perf_counter()
        results = q.run()
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = read_launches()
        done = sorted((r["tag"], r["status"], r["generations"]) for r in results)
        want = sorted((f"bench{i}", "completed", RQ_STEPS) for i in range(RQ_SPECS))
        if done != want:
            raise AssertionError(f"RunQueue results {done}, expected {want}")
        report = run_report(fleet, q.state)
        validate(report=report, label="RunQueue tenancy report")
        if report["supervisor"]["counters"]["dispatches"] < q.counters["chunks"]:
            raise AssertionError(f"RunQueue: the supervisor dispatched "
                                 f"{report['supervisor']['counters']}, chunks {q.counters}")
        out["supervisor"] = {k: report["supervisor"][k] for k in ("counters", "outcome")}
        out["counters"] = report["tenancy"]["queue"]["counters"]
        out["journal_events"] = report["tenancy"]["queue"]["journal"]["events"]
    with tempfile.TemporaryDirectory() as td:
        fleet, solo = build_fleet_path(torch, n=RQ_SLOTS, device=device)
        q = RunQueue(fleet, chunk=RQ_CHUNK, checkpoint_dir=td)
        for i in range(RQ_SLOTS):
            q.submit(TenantSpec(seed=i, n_steps=RQ_STEPS, tag=f"evict{i}"))
        q.start()
        q.step_chunk()
        extracted = fleet.extract_tenant(q.state, 0)
        entry = q.evict(0)
        wf = fleet.solo_workflow(index=0, state=q.state)
        resumed = wf.run(wf.init(0), RQ_STEPS, resume_from=entry["checkpoint"])
        continued = wf.run(extracted, RQ_STEPS - int(extracted.generation))
        check = compare_exact("evicted tenant resumed from its checkpoint against the extracted "
                              "state's solo continuation", _tensors(torch, resumed.algo),
                              _tensors(torch, continued.algo))
        straight = solo.run(solo.init(0), RQ_STEPS).algo
        # a run that never entered the fleet: M1's products round as the
        # fleet's, so the evicted tenant equals it bit for bit
        uninterrupted = compare_exact("evicted tenant resumed solo against its uninterrupted "
                                      "solo run", _tensors(torch, resumed.algo),
                                      _tensors(torch, straight))
        out["eviction"] = {"generation": entry["generations"], "resume_bit_for_bit": check,
                           "uninterrupted_bit_for_bit": uninterrupted}
    print(f"[runqueue path] {json.dumps(out)}", flush=True)
    return out


# ----------------------------------------------------------- main path 16


class HostEvalSphere:
    """``bench.py:633-647``'s ``_HostEvalSphere``: Sphere in numpy float32
    on the host after a fixed sleep (a stand-in for a simulator with a
    known host floor); duck-typed, as a user's host problem is."""

    jittable = False
    fit_dtype = "float32"

    def init(self, seed=None):
        return None

    def fit_shape(self, pop_size):
        return (pop_size,)

    def evaluate(self, state, pop):
        import numpy as np

        time.sleep(HE_SLEEP)
        return np.sum(np.asarray(pop) ** 2, axis=1).astype(np.float32), state


def build_host_path(torch, pop: int = HE_POP, dim: int = HE_DIM, device=None):
    """Main path 16 as ``bench.py:650-657`` builds it: PSO (±5) on the host
    Sphere."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.pso import PSO

    bound = torch.full((dim,), 5.0)
    return StdWorkflow(PSO(lb=-bound, ub=bound, pop_size=pop, device=device), HostEvalSphere(),
                       device=device)


def _pso_tensors(s) -> list:
    return [s.population, s.velocity, s.pbest_position, s.pbest_fitness, s.gbest_position,
            s.gbest_fitness]


def phase_host_path(torch, seed: int = HE_SEED, gens: int = HE_GENERATIONS,
                    warm: int = HE_WARM) -> dict:
    """Main path 16: ``bench.py``'s workload 6, the host problem through
    ``run_host_pipelined`` (the executor) and through the serialized ask,
    evaluate, tell loop of ``bench.py:676-706``, in turns (piped, serial,
    serial, piped), each from the state after ``warm`` generations. The
    device halves are timed by CUDA events recorded around
    ``pipeline_ask`` and ``pipeline_tell`` (wrapped on the workflow, which
    the executor calls through), the host ``evaluate`` on the host's clock,
    the copies by ``wf.host_link``'s events. Then 10 pipelined generations
    against 10 ``wf.step`` generations, with and without ``eval_chunk=500``,
    bit for bit, and one host-evaluated generation on the card against the
    CPU on the same state and draws."""
    from evox_tpu_torch.core.executor import GenerationExecutor
    from evox_tpu_torch.workflows import chunked_evaluate, run_host_pipelined
    from evox_tpu_torch.workflows.common import host_candidates

    wf = build_host_path(torch)
    state = run_host_pipelined(wf, wf.init(seed), warm)  # warm both halves and the copies
    torch.cuda.synchronize()
    spans = {"ask": [], "tell": []}
    raw_ask, raw_tell = wf.pipeline_ask, wf.pipeline_tell

    def timed(name, fn):
        def call(*args):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            spans[name].append((start, stop))
            return out
        return call

    wf.pipeline_ask, wf.pipeline_tell = timed("ask", raw_ask), timed("tell", raw_tell)

    def serial(s, n, host_ms):
        for _ in range(n):
            cand, ctx = wf.pipeline_ask(s)
            host = host_candidates(wf.host_link, cand)
            t0 = time.perf_counter()
            fitness, _ = chunked_evaluate(wf.problem, s.prob, host, None)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            s = wf.pipeline_tell(s, ctx, fitness, s.prob)
        return s

    turns, finals = [], {}
    for mode in ("piped", "serial", "serial", "piped"):
        for v in spans.values():
            v.clear()
        link0 = wf.host_link.report()
        host_ms = []
        ex = GenerationExecutor()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "piped":
            end = run_host_pipelined(wf, state, gens, executor=ex)
        else:
            end = serial(state, gens, host_ms)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        link1 = wf.host_link.report()
        if any(launches.values()):
            raise AssertionError(f"kernel launches on the host path: {launches}")
        device_ms = {k: sum(a.elapsed_time(b) for a, b in v) / gens for k, v in spans.items()}
        host = (ex.overlap["host_eval_s"] * 1e3 / gens if mode == "piped"
                else statistics.fmean(host_ms))
        per_gen = wall_ms / gens
        turn = {
            "mode": mode,
            "ms_per_generation": per_gen,
            "device_ms_per_generation": device_ms,
            "host_eval_ms_per_generation": host,
            # bench.py's overlap_efficiency: wall / max(device, host), with
            # the device side the two halves' event spans
            "overlap_efficiency": per_gen / max(sum(device_ms.values()), host),
            "bench_bound": 1.2,  # bench.py's acceptance bound, a reference only
            "copies": {
                "pinned": link1["pinned"],
                "d2h_bytes_per_generation": (link1["d2h_bytes"] - link0["d2h_bytes"]) / gens,
                "h2d_bytes_per_generation": (link1["h2d_bytes"] - link0["h2d_bytes"]) / gens,
                **{f"{k}_ms_per_generation": (None if link1[f"{k}_ms"] is None
                                              else (link1[f"{k}_ms"] - link0[f"{k}_ms"]) / gens)
                   for k in ("d2h", "h2d")},
            },
        }
        if mode == "piped":
            turn["executor"] = ex.report()
        print(f"[host path] {json.dumps(turn)}", flush=True)
        turns.append(turn)
        finals[mode] = end
    wf.pipeline_ask, wf.pipeline_tell = raw_ask, raw_tell
    if finals["piped"].generation != warm + gens:
        raise AssertionError(f"generation {finals['piped'].generation} != {warm + gens}")
    compare_exact(f"host path: {gens} pipelined generations against the serialized loop",
                  _pso_tensors(finals["piped"].algo), _pso_tensors(finals["serial"].algo))

    # the run == step law on the card, whole and in ragged row slices
    looped = state
    for _ in range(HE_LAW_GENERATIONS):
        looped = wf.step(looped)
    law = {}
    for chunk in (None, HE_EVAL_CHUNK):
        piped = run_host_pipelined(wf, state, HE_LAW_GENERATIONS, eval_chunk=chunk)
        law[f"eval_chunk={chunk}"] = compare_exact(
            f"host path: {HE_LAW_GENERATIONS} pipelined generations (eval_chunk={chunk}) against "
            f"{HE_LAW_GENERATIONS} wf.step generations", _pso_tensors(piped.algo),
            _pso_tensors(looped.algo))
    medians = {m: statistics.median(t["ms_per_generation"] for t in turns if t["mode"] == m)
               for m in ("piped", "serial")}
    out = {"pop": HE_POP, "dim": HE_DIM, "sleep_ms": HE_SLEEP * 1e3, "generations": gens,
           "turns": turns, "median_ms_per_generation": medians, "run_equals_step": law,
           "card_vs_cpu": phase_host_card_vs_cpu(torch, state)}
    print(f"[host path] medians {json.dumps(medians)}", flush=True)
    return out


def phase_host_card_vs_cpu(torch, state) -> dict:
    """One host-evaluated PSO generation (``wf.step``) on the card against
    the same on the CPU: the same state, the draws made once on the CPU.
    The candidates are the state's population, the fitness numpy's on the
    same rows, and the update elementwise float32 on the same draws, one
    rounding an operation on both devices: bit for bit."""
    cpu_wf, card_wf = build_host_path(torch, device="cpu"), build_host_path(torch)
    cpu_state = _state_on(torch, state, "cpu")
    seed = state.algo.seed
    from evox_tpu_torch.utils.common import split_seed

    draws = cpu_wf.algorithm._draw(split_seed(seed)[1])
    cpu_wf.algorithm._draw = lambda s: draws
    card_wf.algorithm._draw = lambda s: tuple(d.cuda() for d in draws)
    got, want = card_wf.step(state), cpu_wf.step(cpu_state)
    return compare_exact("host path: one host-evaluated PSO generation, card against CPU",
                         [t.cpu() for t in _pso_tensors(got.algo)], _pso_tensors(want.algo))


# ----------------------------------------------------------- main path 17


def _storage_bytes(torch, state) -> dict:
    """The algorithm state's tensor bytes: storage-annotated and the rest."""
    import dataclasses

    out = {"storage_annotated": 0, "other": 0}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            key = "storage_annotated" if f.metadata.get("storage") else "other"
            out[key] += v.numel() * v.element_size()
    return out


def check_storage_dtypes(torch, state, ref, label: str) -> None:
    """Every storage-annotated float field of ``state`` (an algorithm state)
    is bfloat16; every other tensor keeps ``ref``'s (the float32 run's)
    dtype."""
    import dataclasses

    for f in dataclasses.fields(state):
        v, r = getattr(state, f.name), getattr(ref, f.name)
        if not isinstance(v, torch.Tensor):
            continue
        want = torch.bfloat16 if (f.metadata.get("storage") and r.is_floating_point()) else r.dtype
        if v.dtype != want:
            raise AssertionError(f"{label}: {f.name} is {v.dtype}, expected {want}")


def phase_bf16_path(torch, seed: int = BF16_SEED, gens: int = GENERATIONS,
                    profile: bool = False) -> dict:
    """Main path 17: ``bench.py``'s workload 1b, CSO (±32, pop 4096, d 1024)
    on Ackley with ``dtype_policy=BF16_STORAGE, donate_carries=True``
    against the same CSO in float32 with ``donate_carries=True``, in turns
    (bf16, f32, f32, bf16), each ``gens`` generations from its own state
    after the init step and one warm-up generation. Checks the dtypes of
    every field after ``step`` and after ``run``; reports ms a generation,
    evaluations/s, their ratio, the carried state's bytes, peak device
    memory, the device time of the casts (CUDA events around
    ``apply_compute`` and ``apply_storage`` on the path's state), the best
    fitness, and (``--profile``) each run's idle share and top kernels.
    Then one CMA-ES step at path 5's shape under bf16: its strategy
    parameters stay float32."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import CMAES
    from evox_tpu_torch.core.dtype_policy import BF16_STORAGE, apply_compute, apply_storage
    from evox_tpu_torch.problems.numerical import Rastrigin

    runs = {}
    for name, policy in (("bf16", BF16_STORAGE), ("f32", None)):
        wf, _ = build_cso_path(torch)
        wf = StdWorkflow(wf.algorithm, wf.problem, dtype_policy=policy, donate_carries=True)
        runs[name] = {"wf": wf, "state": wf.step(wf.step(wf.init(seed)))}
    f32_algo = runs["f32"]["state"].algo
    check_storage_dtypes(torch, runs["bf16"]["state"].algo, f32_algo, "bf16 CSO after step")
    turns = []
    for name in ("bf16", "f32", "f32", "bf16"):
        r = runs[name]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = r["wf"].run(r["state"], gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(read_launches().values()):
            raise AssertionError(f"kernel launches on the bf16 path: {read_launches()}")
        turns.append({"policy": name, "ms_per_generation": wall / gens * 1e3,
                      "evals_per_s": gens * CSO_POP // 2 / wall,
                      "peak_bytes": torch.cuda.max_memory_allocated()})
        r["end"] = end
    check_storage_dtypes(torch, runs["bf16"]["end"].algo, runs["f32"]["end"].algo,
                         "bf16 CSO after run")
    for name, r in runs.items():
        _check_swarm(torch, f"{name} CSO", r["wf"].algorithm, r["end"].algo.population.float())
    med = {p: statistics.median(t["ms_per_generation"] for t in turns if t["policy"] == p)
           for p in ("bf16", "f32")}
    bf16_state = runs["bf16"]["end"]
    wide = apply_compute(bf16_state, BF16_STORAGE).algo
    casts = {
        "apply_compute_ms": _time_ms(lambda: apply_compute(bf16_state, BF16_STORAGE), 2, 10),
        "apply_storage_ms": _time_ms(lambda: apply_storage(wide, BF16_STORAGE), 2, 10),
    }
    out = {
        "pop": CSO_POP, "dim": CSO_DIM, "generations": gens, "turns": turns,
        "median_ms_per_generation": med,
        "bf16_over_f32": med["bf16"] / med["f32"],
        "evals_per_s": {p: gens * CSO_POP // 2 / (med[p] * gens / 1e3) for p in med},
        "state_bytes": {p: _storage_bytes(torch, r["end"].algo) for p, r in runs.items()},
        "peak_bytes": {p: max(t["peak_bytes"] for t in turns if t["policy"] == p) for p in med},
        "casts_device_ms": casts,
        "best_fitness": {p: float(r["end"].algo.fitness.float().min()) for p, r in runs.items()},
    }
    if profile:
        out["profile"] = {p: profile_path(torch, r["wf"], r["end"], med[p] * gens / 1e3, gens)
                          for p, r in runs.items()}
    print(f"[bf16 path] {json.dumps(out)}", flush=True)

    # CMA-ES under bf16 at path 5's shape: z narrow, the strategy float32
    cma_wf = StdWorkflow(CMAES(torch.full((CMAES_DIM,), CMAES_CENTER), 1.0), Rastrigin(),
                         dtype_policy=BF16_STORAGE)
    cma = cma_wf.step(cma_wf.step(cma_wf.init(seed))).algo
    kept = {name: str(getattr(cma, name).dtype) for name in ("mean", "C", "B", "D", "pc", "ps")}
    if any(v != "torch.float32" for v in kept.values()) or cma.z.dtype != torch.bfloat16:
        raise AssertionError(f"CMA-ES under bf16: {kept}, z {cma.z.dtype}")
    out["cmaes_dtypes"] = {**kept, "z": str(cma.z.dtype)}
    return out


# ----------------------------------------------------------- main path 18


def build_checkpoint_path(torch, pop: int = NSGA2_POP, device=None):
    """Main path 18's workflow: path 2's configuration (NSGA-II on LSMOP1, d
    300, m 3, ``use_kernel=True``), without path 2's recording monitor."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.problems.numerical import LSMOP1

    prob = LSMOP1(d=LSMOP_D, m=LSMOP_M, device=device)
    algo = NSGA2(*prob.bounds(), n_objs=LSMOP_M, pop_size=pop, use_kernel=True, device=device)
    return StdWorkflow(algo, prob, device=device)


def snapshot_split(state) -> dict:
    """Host ms of each piece of one snapshot write of ``state``, on the
    calling thread with nothing beside it: the copy to the host, pickle,
    SHA-256, the attest digest, the config record, and the write with its
    fsync."""
    import hashlib
    import os
    import pickle
    import tempfile

    from evox_tpu_torch.core.state_io import host_copy
    from evox_tpu_torch.workflows.checkpoint import attest_digest_hex, state_config

    out = {}
    t = time.perf_counter()
    host = host_copy(state)
    out["host_copy"] = (time.perf_counter() - t) * 1e3
    for name, fn in (("pickle", lambda: pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL)),
                     ("attest_digest", lambda: attest_digest_hex(host)),
                     ("config", lambda: state_config(host))):
        t = time.perf_counter()
        value = fn()
        out[name] = (time.perf_counter() - t) * 1e3
        if name == "pickle":
            payload = value
    t = time.perf_counter()
    hashlib.sha256(payload).hexdigest()
    out["sha256"] = (time.perf_counter() - t) * 1e3
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        with open(Path(d) / "snapshot", "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        out["write_fsync"] = (time.perf_counter() - t) * 1e3
    return out


def phase_checkpoint_path(torch, seed: int = SEED, gens: int = CKPT_GENERATIONS,
                          every: int = CKPT_EVERY, pop: int = NSGA2_POP) -> dict:
    """Main path 18: NSGA-II at path 2's shape for ``gens`` generations
    from ``init`` under ``WorkflowCheckpointer(dir, every, keep=3)``, twice
    (the two final states bit for bit: the run reproduces itself), with
    and without the checkpointer in turns; then a crash: the newest
    snapshot deleted and the one before it torn, ``latest()`` warns and
    falls back one more, and with the torn snapshot restored a fresh
    workflow's ``resume`` reaches the straight run's final state bit for
    bit; a workflow at another population size is refused."""
    import shutil
    import tempfile
    import warnings

    from evox_tpu_torch.workflows import CheckpointConfigError, WorkflowCheckpointer

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        def straight(tag):
            wf = build_checkpoint_path(torch, pop=pop)
            ck = WorkflowCheckpointer(root / tag, every=every, keep=3)
            state = wf.init(seed)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            end = wf.run(state, gens, checkpointer=ck)
            torch.cuda.synchronize()
            return wf, ck, end, time.perf_counter() - t0, read_launches()

        wf_a, ck_a, end_a, wall_a, launches = straight("a")
        _, _, end_b, wall_b, _ = straight("b")
        # one B3 launch a generation (the init step's sort of the parents
        # and every tell's), one B4 launch a tell
        want = {"fused_rollout": 0, "packed_dominance": gens, "partial_topk": gens - 1,
                "fused_mlp_rollout": 0}
        if launches != want:
            raise AssertionError(f"launches in {gens} checkpointed NSGA-II generations: "
                                 f"{launches}, expected {want}")
        determinism = compare_exact(
            f"checkpoint path: two straight runs of {gens} generations, final states",
            _tensors(torch, end_b), _tensors(torch, end_a))
        ex = wf_a._run_executor
        saves = [s for s in ex.trace_spans() if s["track"] == "io:checkpoint"]
        save_split = snapshot_split(end_a)
        chunks = [s for s in ex.trace_spans() if s["track"] == "device"]
        snaps = ck_a.snapshots()
        if [p.name for p in snaps] != [f"ckpt_{g:08d}.pkl" for g in range(every, gens + 1, every)][-3:]:
            raise AssertionError(f"snapshots {[p.name for p in snaps]}")

        # with and without the checkpointer, in turns, from the same state
        wf_t = build_checkpoint_path(torch, pop=pop)
        start = wf_t.init(seed)
        turns = []
        for with_ckpt in (True, False, False, True):
            ck = WorkflowCheckpointer(root / "turn", every=every, keep=3) if with_ckpt else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wf_t.run(start, gens, checkpointer=ck)
            torch.cuda.synchronize()
            turns.append({"checkpointer": with_ckpt,
                          "ms_per_generation": (time.perf_counter() - t0) / gens * 1e3})

        # the crash: the newest snapshot gone, the one before it torn
        keep = root / "intact"
        keep.mkdir()
        g_last, g_prev = gens, gens - every
        name_prev = f"ckpt_{g_prev:08d}.pkl"
        for suffix in ("", ".manifest.json"):
            shutil.copy(root / "a" / (name_prev + suffix), keep / (name_prev + suffix))
            (root / "a" / f"ckpt_{g_last:08d}.pkl{suffix}").unlink()
        manifest = root / "a" / (name_prev + ".manifest.json")
        manifest.write_text(manifest.read_text()[: len(manifest.read_text()) // 2])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fallback = WorkflowCheckpointer(root / "a", every=every).latest()
        if fallback is None or fallback.generation != gens - 2 * every or not any(
                name_prev in str(w.message) for w in caught):
            raise AssertionError(f"latest() after the crash: generation "
                                 f"{getattr(fallback, 'generation', None)}, warnings "
                                 f"{[str(w.message) for w in caught]}")
        for suffix in ("", ".manifest.json"):
            shutil.copy(keep / (name_prev + suffix), root / "a" / (name_prev + suffix))
        wf_r = build_checkpoint_path(torch, pop=pop)
        reset_launches()
        resumed = wf_r.resume(WorkflowCheckpointer(root / "a", every=every), gens)
        torch.cuda.synchronize()
        resume_launches = read_launches()
        resume_check = compare_exact(
            f"checkpoint path: resumed from generation {g_prev} to {gens}, against the straight run",
            _tensors(torch, resumed), _tensors(torch, end_a))
        refused = False
        try:
            build_checkpoint_path(torch, pop=pop - 2).resume(
                WorkflowCheckpointer(root / "a", every=every), gens)
        except CheckpointConfigError as e:
            refused = True
            print(f"[checkpoint path] pop {pop - 2} refused: {str(e)[:120]}", flush=True)
        if not refused:
            raise AssertionError(f"a workflow at pop {pop - 2} restored a pop {pop} snapshot")
        med = {k: statistics.median(t["ms_per_generation"] for t in turns
                                    if t["checkpointer"] == (k == "with"))
               for k in ("with", "without")}
        out = {
            "pop": pop, "generations": gens, "every": every, "launches": launches,
            "ms_per_generation_straight": [wall_a / gens * 1e3, wall_b / gens * 1e3],
            "determinism": determinism,
            "snapshot_bytes": snaps[-1].stat().st_size,
            "save_ms": [s["dur"] * 1e3 for s in saves],
            "save_split_ms": save_split,
            # host ms of each chunk's dispatch (every=10 generations); the
            # chunks after the first follow a save whose pickle and fsync
            # run on the background lane beside them
            "chunk_ms": [s["dur"] * 1e3 for s in chunks],
            "turns": turns,
            "median_ms_per_generation": med,
            "fallback_generation": fallback.generation,
            "resume_launches": resume_launches,
            "resume_equals_straight": resume_check,
            "executor": ex.report(),
        }
        print(f"[checkpoint path] {json.dumps(out)}", flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------- main path 19


class SleepySphere:
    """``bench.py:925-949``'s ``_SleepySphere``: a numpy float32 Sphere that
    sleeps ``sleep_per_row`` seconds a row it evaluates (the cost of an
    expensive problem grows with the rows it truly scores) and counts the
    rows; duck-typed, as a user's host problem is."""

    jittable = False
    fit_dtype = "float32"

    def __init__(self, sleep_per_row: float = SUR_SLEEP):
        self.sleep_per_row = sleep_per_row
        self.rows = 0

    def init(self, seed=None):
        return None

    def fit_shape(self, pop_size):
        return (pop_size,)

    def evaluate(self, state, pop):
        import numpy as np

        pop = np.asarray(pop)
        self.rows += pop.shape[0]
        if self.sleep_per_row:
            time.sleep(self.sleep_per_row * pop.shape[0])
        return np.sum(pop**2, axis=1).astype(np.float32), state


def build_surrogate_path(torch, pop: int = SUR_POP, dim: int = SUR_DIM, sleep: float = SUR_SLEEP,
                         surrogate=None, device=None):
    """Main path 19 as ``bench.py:952-975`` builds it: ``SurrogateWorkflow``
    (PSO ±5 on the sleepy Sphere, ``GPSurrogate``, screen_frac 1/8, warmup
    one population, a refit every generation, rank floor 0.3,
    ``TelemetryMonitor(capacity=4)``)."""
    from evox_tpu_torch import SurrogateWorkflow
    from evox_tpu_torch.algorithms.so.pso import PSO
    from evox_tpu_torch.monitors import TelemetryMonitor
    from evox_tpu_torch.operators.surrogate import GPSurrogate

    bound = torch.full((dim,), 5.0)
    return SurrogateWorkflow(
        PSO(lb=-bound, ub=bound, pop_size=pop, device=device), SleepySphere(sleep),
        surrogate=surrogate if surrogate is not None else GPSurrogate(device=device),
        screen_frac=SUR_FRAC, warmup=pop, refit_every=1, rank_floor=0.3,
        monitors=(TelemetryMonitor(capacity=4, device=device),), device=device)


def full_twin(wf):
    """The full-evaluation twin of a screened workflow: ``StdWorkflow`` on
    the same PSO, problem and monitor objects."""
    from evox_tpu_torch import StdWorkflow

    return StdWorkflow(wf.algorithm, wf.problem, monitors=wf.monitors, device=wf.device)


def catch_refits(torch, wf) -> list:
    """Wrap ``wf.dispatch_refit`` (the executor calls it through the
    instance) with CUDA events; the list collects the (start, stop) pairs."""
    spans = []
    raw = wf.dispatch_refit

    def timed(state, generation):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = raw(state, generation)
        stop.record()
        spans.append((start, stop))
        return out

    wf.dispatch_refit = timed
    return spans


def host_copies(torch, fn, gens: int) -> dict:
    """Memcpy events a generation (the profiler's rows) over ``fn()``, which
    runs ``gens`` generations (DtoH is a host read), with the kernels
    launched and the device's busy time a generation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"DtoH": 0, "HtoD": 0}
    launches, busy = 0, 0.0
    for evt in prof.key_averages():
        for kind in out:
            if f"Memcpy {kind}" in evt.key:
                out[kind] += evt.count
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            launches += evt.count
            busy += evt.self_device_time_total
    return {**{f"memcpy_{k}_per_generation": v / gens for k, v in out.items()},
            "device_ops_per_generation": launches / gens,
            "device_busy_us_per_generation": busy / gens}


def kernel_rows(torch, fn, top: int = 8) -> dict:
    """The device kernels ``fn()`` launches (torch.profiler): their count,
    device time and the top rows by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    return {"kernel_launches": sum(r[2] for r in rows),
            "device_ms": sum(r[0] for r in rows) / 1e3,
            "top": [{"kernel": k[:90], "device_us": us, "calls": c} for us, k, c in rows[:top]]}


def run_to_threshold(wf, seed: int) -> tuple:
    """``bench.py:1001-1011``: ``run`` in chunks of 2 until the telemetry's
    best is under the threshold or 120 generations have run."""
    state, gens = wf.init(seed), 0
    mon = wf.monitors[0]
    while gens < SUR_MAX_GENS:
        state = wf.run(state, 2)
        gens += 2
        if float(mon.get_best_fitness(state.monitors[0])) < SUR_THRESHOLD:
            break
    return state, gens, float(mon.get_best_fitness(state.monitors[0]))


def phase_surrogate_path(torch, seed: int = SUR_SEED, turn: int = SUR_TURN, warm: int = SUR_WARM,
                         profile: bool = False) -> dict:
    """Main path 19: ``bench.py``'s workload 8. Both sides from the state
    after ``warm`` generations, ``run`` (the executor's host pipeline) in
    turns screened, full, full, screened, ``turn`` generations each; the
    problem's rows against the ledger; the executor's ``bg_refit`` and the
    refits' CUDA-event ms; the strict-JSON reports; then the sleep-free
    ledger to the threshold at pop 128, and one screened generation on the
    card against the CPU."""
    from evox_tpu_torch.core.executor import GenerationExecutor
    from evox_tpu_torch.workflows import run_host_pipelined

    scr = build_surrogate_path(torch)
    full = full_twin(scr)
    prob = scr.problem
    refit_spans = catch_refits(torch, scr)
    starts = {"screened": run_host_pipelined(scr, scr.init(seed), warm),
              "full": run_host_pipelined(full, full.init(seed), warm)}
    torch.cuda.synchronize()
    turns = []
    ends = {}
    for mode in ("screened", "full", "full", "screened"):
        wf, start = (scr, starts[mode]) if mode == "screened" else (full, starts[mode])
        refit_spans.clear()
        ex = GenerationExecutor()
        rows0 = prob.rows
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = run_host_pipelined(wf, start, turn, executor=ex)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if any(launches.values()):
            raise AssertionError(f"kernel launches on the surrogate path: {launches}")
        rows = prob.rows - rows0
        out = {"mode": mode, "ms_per_generation": wall / turn * 1e3, "rows": rows,
               "rows_per_generation": rows / turn,
               "host_eval_ms_per_generation": ex.overlap["host_eval_s"] * 1e3 / turn,
               "executor_counters": dict(ex.counters)}
        if mode == "screened":
            sur0, sur = start.sur, end.sur
            ledger = int(sur.true_evals) - int(sur0.true_evals)
            screened = int(sur.screened_gens) - int(sur0.screened_gens)
            k = scr._k_for(SUR_POP)
            if rows != ledger or rows != k * screened + SUR_POP * (turn - screened):
                raise AssertionError(f"surrogate path: the problem scored {rows} rows, the ledger "
                                     f"says {ledger} ({screened} screened generations)")
            if screened < turn // 2:
                raise AssertionError(f"surrogate path: only {screened} of {turn} warm generations "
                                     "screened")
            if ex.counters["bg_refit"] != turn or int(sur.refits) - int(sur0.refits) != turn:
                raise AssertionError(f"surrogate path: {ex.counters['bg_refit']} refits through the "
                                     f"executor in {turn} generations, expected {turn}")
            out.update(screened_generations=screened, true_evals=ledger,
                       rows_per_screened_generation=k,
                       fallback_generations=int(sur.fallback_gens) - int(sur0.fallback_gens),
                       refits=ex.counters["bg_refit"],
                       refit_ms=[a.elapsed_time(b) for a, b in refit_spans])
            out["refit_ms_mean"] = statistics.fmean(out["refit_ms"])
        elif rows != SUR_POP * turn:
            raise AssertionError(f"full evaluation scored {rows} rows, expected {SUR_POP * turn}")
        print(f"[surrogate path] {json.dumps(out)}", flush=True)
        turns.append(out)
        ends[mode] = end
    med = {m: statistics.median(t["ms_per_generation"] for t in turns if t["mode"] == m)
           for m in ("screened", "full")}
    result = {"pop": SUR_POP, "dim": SUR_DIM, "sleep_ms_per_row": SUR_SLEEP * 1e3,
              "screen_frac": SUR_FRAC, "archive_capacity": scr._archive.capacity,
              "generations_per_turn": turn, "turns": turns, "median_ms_per_generation": med,
              "full_over_screened": med["full"] / med["screened"]}
    # the reports, strict JSON
    report = scr.surrogate_report(ends["screened"])
    telemetry = scr.monitors[0].report(ends["screened"].monitors[0])
    for name, rep in (("surrogate_report", report), ("telemetry_report", telemetry)):
        print(f"[surrogate path] {name} {json.dumps(rep, allow_nan=False)}", flush=True)
    result.update(surrogate_report=report, telemetry_report=telemetry)
    if profile:
        result["host_copies_screened"] = host_copies(
            torch, lambda: run_host_pipelined(scr, starts["screened"], turn), turn)
        result["host_copies_full"] = host_copies(
            torch, lambda: run_host_pipelined(full, starts["full"], turn), turn)
        print(f"[surrogate path] host copies {json.dumps(result['host_copies_screened'])} "
              f"(full: {json.dumps(result['host_copies_full'])})", flush=True)
    del scr.dispatch_refit  # the class's method again

    # the ledger, sleep-free at pop 128 (bench.py:985-1036)
    led_scr = build_surrogate_path(torch, pop=SUR_LEDGER_POP, sleep=0.0)
    led_full = full_twin(build_surrogate_path(torch, pop=SUR_LEDGER_POP, sleep=0.0))
    s_scr, g_scr, b_scr = run_to_threshold(led_scr, SUR_LEDGER_SEED)
    s_full, g_full, b_full = run_to_threshold(led_full, SUR_LEDGER_SEED)
    evals_scr, evals_full = int(s_scr.sur.true_evals), g_full * SUR_LEDGER_POP
    if led_scr.problem.rows != evals_scr or led_full.problem.rows != evals_full:
        raise AssertionError("ledger runs: the problem's rows disagree with the ledgers")
    result["eval_ledger"] = {
        "threshold": SUR_THRESHOLD, "pop": SUR_LEDGER_POP,
        "archive_capacity": led_scr._archive.capacity,
        "screened": {"true_evals": evals_scr, "generations": g_scr, "best": b_scr,
                     "fallback_gens": int(s_scr.sur.fallback_gens)},
        "full": {"true_evals": evals_full, "generations": g_full, "best": b_full},
        "ratio": evals_full / max(evals_scr, 1),
        "jax_test_law": "tests/test_surrogate.py:391 asserts a ratio >= 5 (printed, not asserted)",
    }
    print(f"[surrogate path] eval ledger {json.dumps(result['eval_ledger'])}", flush=True)
    result["card_vs_cpu"] = phase_surrogate_card_vs_cpu(torch, scr, ends["screened"])
    return result


def phase_surrogate_card_vs_cpu(torch, card_wf, state) -> dict:
    """One screened generation (``wf.step``, the inline refit) on the card
    against the CPU, from the same state on the same draws (made once on the
    CPU): the row count and the screened rows in order equal (the inert
    rest as a set), the predicted fitness within ``SUR_POSTERIOR_RTOL``, the
    archive bit for bit (the same rows, scored by numpy on the host), the
    tell's PSO state bit for bit (elementwise float32 on equal fitness and
    draws), the refitted GP's scales within ``SUR_GP_RTOL`` (sums in the two
    devices' orders) and its posterior at the next ask within
    ``SUR_POSTERIOR_RTOL`` (a Cholesky solve of condition up to ~1e4)."""
    from evox_tpu_torch.utils.common import split_seed

    # the first generation from here whose plan screens (a rank fallback
    # may be armed)
    for _ in range(4):
        if not bool(card_wf._screen_plan(state.sur, card_wf.sample(state)).full_eval):
            break
        state = card_wf.step(state)
    cpu_wf = build_surrogate_path(torch, sleep=0.0, device="cpu")
    cpu_state = _state_on(torch, state, "cpu")
    draws = cpu_wf.algorithm._draw(split_seed(state.algo.seed)[1])
    cpu_wf.algorithm._draw = lambda s: draws
    card_wf.algorithm._draw = lambda s: tuple(d.cuda() for d in draws)
    try:
        plan_card = card_wf._screen_plan(state.sur, card_wf.sample(state))
        plan_cpu = cpu_wf._screen_plan(cpu_state.sur, cpu_wf.sample(cpu_state))
        if bool(plan_cpu.full_eval):
            raise AssertionError("surrogate path: no generation screens in 4 from the last turn")
        # the evaluated head in order; the inert tail as a set (its rows all
        # take one fill value, so its order reaches nothing)
        k = int(plan_cpu.n_eval)
        plan = compare_exact("surrogate path: the row count and the screened rows in order, card "
                             "against CPU", [plan_card.n_eval.cpu(), plan_card.order[:k].cpu()],
                             [plan_cpu.n_eval, plan_cpu.order[:k]])
        plan["tail"] = compare_exact("surrogate path: the inert rows (as a set), card against CPU",
                                     [plan_card.order[k:].sort().values.cpu()],
                                     [plan_cpu.order[k:].sort().values])
        plan["tail_order_equal"] = bool(torch.equal(plan_card.order.cpu(), plan_cpu.order))
        plan["mean_perm"] = compare("surrogate path: the predicted fitness in evaluation order, "
                                    "card against CPU", plan_card.mean_perm[:k].cpu(),
                                    plan_cpu.mean_perm[:k], SUR_POSTERIOR_RTOL, SUR_POSTERIOR_RTOL)
        got, want = card_wf.step(state), cpu_wf.step(cpu_state)
    finally:
        del card_wf.algorithm._draw
    a, b = got.sur.archive, want.sur.archive
    archive = compare_exact("surrogate path: the archive after one screened generation, card "
                            "against CPU", [a.x.cpu(), a.y.cpu(), a.count.cpu()], [b.x, b.y, b.count])
    pso = compare_exact("surrogate path: the tell's PSO state, card against CPU",
                        [t.cpu() for t in _pso_tensors(got.algo)], _pso_tensors(want.algo))
    gp = {}
    for name in ("lengthscale2", "amplitude", "y_mean"):
        gp[name] = compare(f"surrogate path: the refitted GP's {name}, card against CPU",
                           getattr(got.sur.model, name).cpu().reshape(1),
                           getattr(want.sur.model, name).reshape(1), SUR_GP_RTOL, 0.0)
    nxt = cpu_wf.sample(want)
    mean_card, sd_card = card_wf.surrogate.predict(got.sur.model, nxt.cuda())
    mean_cpu, sd_cpu = cpu_wf.surrogate.predict(want.sur.model, nxt)
    gp["next_mean"] = compare("surrogate path: the refitted GP's mean at the next ask, card "
                              "against CPU", mean_card.cpu(), mean_cpu, SUR_POSTERIOR_RTOL,
                              SUR_POSTERIOR_RTOL)
    gp["next_sd"] = compare("surrogate path: the refitted GP's deviation at the next ask, card "
                            "against CPU", sd_card.cpu(), sd_cpu, SUR_POSTERIOR_RTOL,
                            SUR_POSTERIOR_RTOL)
    return {"plan": plan, "archive": archive, "pso_state": pso, "gp": gp,
            "n_eval": int(plan_cpu.n_eval)}


def phase_gp_bound(torch, seed: int = SEED) -> dict:
    """``GPSurrogate`` at its bound (capacity 2048, d 64, the archive three
    quarters full, Sphere values) on the card against the CPU: mean and
    deviation at 512 new points within ``SUR_POSTERIOR_RTOL``, Spearman of the
    two predicted orders; fit and predict timed by CUDA events. Then
    ``EnsembleSurrogate.fit`` on the same archive (ms and kernel launches a
    refit), and path 19's screened side with the ensemble for 10
    generations."""
    from evox_tpu_torch.core.executor import GenerationExecutor
    from evox_tpu_torch.operators.surrogate import (
        EnsembleSurrogate,
        GPSurrogate,
        spearman_correlation,
    )
    from evox_tpu_torch.workflows import run_host_pipelined

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((GP_CAP, GP_DIM), generator=g)
    y = (x**2).sum(1)
    x[GP_FILL:] = 0.0  # the archive's empty slots, as SurrogateArchive.init leaves them
    y[GP_FILL:] = float("inf")
    mask = torch.arange(GP_CAP) < GP_FILL
    xt = torch.randn((GP_TEST, GP_DIM), generator=g)
    card, cpu = GPSurrogate(), GPSurrogate(device="cpu")
    xc, yc, mc, xtc = x.cuda(), y.cuda(), mask.cuda(), xt.cuda()
    model = card.fit(card.init_model(GP_CAP, GP_DIM), xc, yc, mc)
    model_cpu = cpu.fit(cpu.init_model(GP_CAP, GP_DIM), x, y, mask)
    mean, sd = card.predict(model, xtc)
    mean_cpu, sd_cpu = cpu.predict(model_cpu, xt)
    out = {"capacity": GP_CAP, "dim": GP_DIM, "live_rows": GP_FILL, "test_points": GP_TEST,
           "mean": compare("GP at its bound: the posterior mean, card against CPU", mean.cpu(),
                           mean_cpu, SUR_POSTERIOR_RTOL, SUR_POSTERIOR_RTOL),
           "sd": compare("GP at its bound: the posterior deviation, card against CPU", sd.cpu(),
                         sd_cpu, SUR_POSTERIOR_RTOL, SUR_POSTERIOR_RTOL),
           "spearman_of_orders": float(spearman_correlation(mean.cpu(), mean_cpu))}
    out["fit_ms"] = _time_ms(lambda: card.fit(model, xc, yc, mc), 2, 5)
    out["predict_ms"] = _time_ms(lambda: card.predict(model, xtc), 2, 10)
    out["fit"] = kernel_rows(torch, lambda: card.fit(model, xc, yc, mc))
    torch.cuda.reset_peak_memory_stats()
    card.fit(model, xc, yc, mc)
    torch.cuda.synchronize()
    out["fit_peak_bytes"] = torch.cuda.max_memory_allocated()

    ens = EnsembleSurrogate()
    emodel = ens.init_model(GP_CAP, GP_DIM)
    ens.fit(emodel, xc, yc, mc, 1)  # warm
    out["ensemble"] = {
        "members": ens.n_members, "hidden": ens.hidden, "fit_steps": ens.fit_steps,
        "fit_ms": _time_ms(lambda: ens.fit(emodel, xc, yc, mc, 1), 1, 3),
        "fit_host_ms": _time_host_ms(torch, lambda: ens.fit(emodel, xc, yc, mc, 1)),
        **kernel_rows(torch, lambda: ens.fit(emodel, xc, yc, mc, 1)),
    }
    print(f"[gp bound] {json.dumps(out)}", flush=True)

    # path 19's screened side with the ensemble
    wf = build_surrogate_path(torch, surrogate=EnsembleSurrogate())
    state = run_host_pipelined(wf, wf.init(SUR_SEED), SUR_WARM)
    ex = GenerationExecutor()
    rows0 = wf.problem.rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    end = run_host_pipelined(wf, state, SUR_ENSEMBLE_GENERATIONS, executor=ex)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gens = SUR_ENSEMBLE_GENERATIONS
    rows = wf.problem.rows - rows0
    if rows != int(end.sur.true_evals) - int(state.sur.true_evals) or ex.counters["bg_refit"] != gens:
        raise AssertionError(f"ensemble path: {rows} rows, ledger "
                             f"{int(end.sur.true_evals) - int(state.sur.true_evals)}, "
                             f"{ex.counters['bg_refit']} refits")
    out["ensemble_path"] = {
        "generations": gens, "ms_per_generation": wall / gens * 1e3, "refits": ex.counters["bg_refit"],
        "fallback_generations": int(end.sur.fallback_gens) - int(state.sur.fallback_gens),
        "screened_generations": int(end.sur.screened_gens) - int(state.sur.screened_gens),
        "rows": rows, "best": float(wf.monitors[0].get_best_fitness(end.monitors[0]))}
    print(f"[gp bound] ensemble path {json.dumps(out['ensemble_path'])}", flush=True)
    return out


# ----------------------------------------------------------- main path 20


def build_immoea_path(torch, pop: int = IMM_POP, device=None):
    """Main path 20: ``StdWorkflow(IMMOEA(zeros(12), ones(12), n_objs=3,
    pop_size=1000), DTLZ2(d=12, m=3))`` (``docs/GUIDE.md:1383-1393``'s
    recipe at the MO family's shape)."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import IMMOEA
    from evox_tpu_torch.problems.numerical import DTLZ2

    algo = IMMOEA(torch.zeros(IMM_D), torch.ones(IMM_D), n_objs=MO_M, pop_size=pop, device=device)
    return StdWorkflow(algo, DTLZ2(d=IMM_D, m=MO_M, device=device), device=device)


def phase_immoea_path(torch, gens: int, seed: int, profile: bool) -> dict:
    """Main path 20: the init step, one warm-up generation, ``gens`` timed
    generations with one ``packed_dominance`` launch each (n 1998) and no
    other; IGD and the hypervolume; a split of a generation (the clusters,
    the batched GP fits, sampling, mutation, DTLZ2, the tell with B3, the
    sort to the cut and ``non_dominate``); the GP fit's kernels (cuSOLVER's
    batched route or a loop); B3 at the path's merged fitness against its
    plain version; one ask (on CPU-made draws) and one tell on the card
    against the CPU."""
    from evox_tpu_torch.kernels import dominance as kd
    from evox_tpu_torch.operators.selection import non_dominate, non_dominated_sort

    wf = build_immoea_path(torch)
    algo = wf.algorithm
    state, wall, launches = run_mo_path(torch, wf, gens, seed, {"packed_dominance": gens})
    n = algo.pop_size
    out = {"pop": n, "clusters": algo.K, "per_cluster": algo.S, "dim": IMM_D,
           "gp_batch": [algo.K * IMM_D, algo.S, algo.S], "gp_fit_steps": algo.gp.fit_steps,
           "merged_n": 2 * n, "generations": gens, "launches": launches, "wall_s": wall,
           "ms_per_generation": wall / gens * 1e3, "generations_per_s": gens / wall,
           **mo_quality(torch, wf, state)}
    from evox_tpu_torch.utils.common import split_seed

    draws = algo._draw(split_seed(state.algo.seed)[1])
    fx, xv = algo.inverse_data(state.algo, draws["obj_pick"])
    model = algo.gp.fit(fx, xv)
    merged = lambda a, f: torch.cat([a.fitness, f])
    extra = {
        "clusters": lambda a, f: algo.inverse_data(a, draws["obj_pick"]),
        "gp_fit": lambda a, f: algo.gp.fit(fx, xv),
        "sample": lambda a, f: algo.sample(model, fx, draws),
        "mutation": lambda a, f: algo.mutate(a.offspring, draws),
        "packed_dominance": lambda a, f: kd.packed_dominance(merged(a, f)),
        "sort_to_cut": lambda a, f: non_dominated_sort(merged(a, f), until=n),
        "non_dominate": lambda a, f: non_dominate(torch.cat([a.population, a.offspring]),
                                                  merged(a, f), n),
    }
    out["breakdown_ms"] = mo_breakdown(torch, wf, state, extra)
    out["gp_fit"] = kernel_rows(torch, lambda: algo.gp.fit(fx, xv))
    print(f"[immoea path] gp fit {json.dumps(out['gp_fit'])}", flush=True)

    # one ask on the card against the CPU, on draws made once on the CPU
    cpu_wf = build_immoea_path(torch, device="cpu")
    cpu_algo = cpu_wf.algorithm
    _same_draws(torch, cpu_algo, algo)
    try:
        cpu_state = _state_on(torch, state.algo, "cpu")
        off_cpu, asked_cpu = cpu_algo.ask(cpu_state)
        off, asked = algo.ask(state.algo)
    finally:
        del algo._draw
    diff = (off.cpu() - off_cpu).abs()
    ask = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
           "atol": IMM_OFFSPRING_ATOL, "mean_atol": IMM_OFFSPRING_MEAN_ATOL}
    print(f"[compare] IM-MOEA ask on the card against the CPU: {json.dumps(ask)}", flush=True)
    if not (ask["max_abs_err"] <= IMM_OFFSPRING_ATOL and ask["mean_abs_err"] <= IMM_OFFSPRING_MEAN_ATOL):
        raise AssertionError(f"IM-MOEA ask: the card's offspring disagree with the CPU's: {ask}")
    out["ask_vs_cpu"] = ask
    # one tell on the same merged fitness: the card's offspring, scored once
    fit, _ = wf.problem.evaluate(state.prob, off)
    told = algo.tell(asked, fit)
    told_cpu = cpu_algo.tell(_state_on(torch, asked, "cpu"), fit.cpu())
    out["tell_vs_cpu"] = compare_exact(
        "IM-MOEA tell on the card against the CPU's plain routes (population and fitness, in "
        "order)", [told.population.cpu(), told.fitness.cpu()],
        [told_cpu.population, told_cpu.fitness])
    # B3 at the path's merged fitness, against its plain version
    mf = merged(asked, fit)
    b3 = compare_exact(f"packed_dominance, IM-MOEA merged fitness n={mf.shape[0]} m={MO_M}",
                       kd.packed_dominance(mf, device=mf.device), kd.packed_dominance_reference(mf))
    b3["ms"] = _time_ms(lambda: kd.packed_dominance(mf, device=mf.device), 3, 20)
    b3["plain_ms"] = _time_ms(lambda: kd.packed_dominance_reference(mf), 1, 5)
    b3["bound_ms"], b3["bound_by"] = bound_ms(*dominance_work(mf.shape[0], MO_M))
    out["packed_dominance"] = b3
    if profile:
        out["profile"] = profile_path(torch, wf, state, wall, gens)
    print(f"[immoea path] {json.dumps(out)}", flush=True)
    return out


# --------------------------------------------------- main paths 21 and 22


def check_report_module():
    """``tools/check_report.py``, the repo's validator of run reports and
    Chrome traces (plain Python: no JAX)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import check_report

    return check_report


def validate(report=None, trace=None, label: str = "") -> None:
    cr = check_report_module()
    errors = []
    if report is not None:
        errors += cr.validate_run_report(json.loads(json.dumps(report)))
    if trace is not None:
        errors += cr.validate_chrome_trace(trace)
    if errors:
        raise AssertionError(f"{label}: tools/check_report.py rejects the output: {errors[:5]}")
    print(f"[compare] {label}: tools/check_report.py accepts the "
          + ("report and the trace" if trace is not None else "report"), flush=True)


def build_telemetry_path(torch, device=None):
    """Main path 21's workflow as ``bench.py``'s ``telemetry_report`` builds
    it."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.pso import PSO
    from evox_tpu_torch.monitors import TelemetryMonitor
    from evox_tpu_torch.problems.numerical import Ackley

    dev = torch.device("cuda" if device is None else device)
    bound = TEL_BOUND * torch.ones(TEL_DIM, device=dev)
    return StdWorkflow(PSO(lb=-bound, ub=bound, pop_size=TEL_POP, device=dev), Ackley(),
                       monitors=(TelemetryMonitor(capacity=TEL_GENS, device=dev),),
                       donate_carries=True, device=dev)


def telemetry_sequence(wf, seed: int):
    """``bench.py``'s sequence: init, then :func:`telemetry_runs`."""
    return telemetry_runs(wf, wf.init(seed))


def telemetry_runs(wf, state):
    """The sequence after init: run 30, run 30, run 300 (each under its
    ``RunSupervisor(deadline_s=600, max_retries=2)``), three steps."""
    from evox_tpu_torch.workflows.supervisor import RunSupervisor

    sup = RunSupervisor(deadline_s=600.0, max_retries=2)
    for n in (TEL_GENS, TEL_GENS, 10 * TEL_GENS):
        state = sup.run(wf, state, n)
    for _ in range(3):
        state = wf.step(state)
    return state


def phase_telemetry_path(torch, seed: int = TEL_SEED, device=None, out_dir=None) -> dict:
    """Main path 21: ``bench.py:1452-1523``'s run-telemetry leg.
    ``instrument(wf, analyze=True, block_dispatch=True)``, the sequence, the
    fetch of ``gbest_fitness``, ``run_report`` and ``write_chrome_trace``:
    both pass ``tools/check_report.py``, ``run``'s ``per_work_s`` is the
    differenced slope over 30 and 300, the report's generation is 363, and
    the final state (also after the report's analysis run) equals an
    uninstrumented run's of the same seed and sequence bit for bit. Then
    ms a generation with the recorder and without it, in turns (recorder,
    plain, plain, recorder; the 363 generations after ``init``, the runs
    supervised, so the span holds each run's watchdog thread) after an
    untimed plain sequence; the report's
    ``supervisor`` section (3 dispatches, clean). The report's first
    analysis pays PyTorch's
    lazy imports behind its first ``TorchDispatchMode`` (seconds, once a
    process); ``report_s`` includes them."""
    from evox_tpu_torch.core.instrument import instrument, run_report, write_chrome_trace

    def timed_turn(instrumented):
        wf = build_telemetry_path(torch, device)
        rec = instrument(wf, analyze=True, block_dispatch=True) if instrumented else None
        state = wf.init(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = telemetry_runs(wf, state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / TEL_GENERATION, wf, rec, state

    timed_turn(False)  # warm: the first sequence of a process pays the first calls
    reset_launches()
    turns = []
    for instrumented in (True, False, False, True):
        ms, wf, rec, state = timed_turn(instrumented)
        turns.append({"recorder": instrumented, "ms_per_generation": ms})
        print(f"[telemetry path] {json.dumps(turns[-1])}", flush=True)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"kernel launches on the telemetry path: {launches}")
    # the last turn's instrumented run: fetch, report, trace
    gbest = rec.fetch(state.algo.gbest_fitness, name="gbest_fitness")
    plain = telemetry_sequence(build_telemetry_path(torch, device), seed)
    kept = [t.clone() for t in _tensors(torch, state)]
    t0 = time.perf_counter()
    report = run_report(wf, state, recorder=rec)
    report_s = time.perf_counter() - t0
    out_dir = Path(out_dir) if out_dir is not None else ROOT / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = write_chrome_trace(str(out_dir / "telemetry_trace.json"), recorder=rec,
                               workflow=wf, state=state)
    validate(report, trace, "path 21 (run telemetry)")
    if report["supervisor"]["counters"]["dispatches"] != 3 or \
            report["supervisor"]["outcome"] != "clean":
        raise AssertionError(f"path 21's supervisor section: {report['supervisor']}")
    if report["generation"] != TEL_GENERATION:
        raise AssertionError(f"report generation {report['generation']} != {TEL_GENERATION}")
    if report["telemetry"][0]["generations"] != TEL_GENERATION:
        raise AssertionError(f"telemetry generations {report['telemetry'][0]['generations']}")
    ep = report["dispatch"]["entry_points"]
    calls = {name: e["calls"] for name, e in ep.items()}
    # donated carries: each run peels one generation through step
    if calls != {"init": 1, "run": 3, "step": 6}:
        raise AssertionError(f"entry-point calls {calls}")
    per_work = ep["run"]["per_work_s"]
    if per_work["method"] != "differenced" or per_work["work_pair"] != [TEL_GENS, 10 * TEL_GENS]:
        raise AssertionError(f"run's per_work_s is not the differenced slope: {per_work}")
    compare_exact("path 21: the instrumented final state against an uninstrumented run",
                  _tensors(torch, state), _tensors(torch, plain))
    compare_exact("path 21: the final state after run_report's analysis run",
                  _tensors(torch, state), kept)
    roof = report["roofline"]["entries"]
    out = {
        "generations": TEL_GENERATION,
        "turns": turns,
        "ms_per_generation_recorder": [t["ms_per_generation"] for t in turns if t["recorder"]],
        "ms_per_generation_plain": [t["ms_per_generation"] for t in turns if not t["recorder"]],
        "run_per_work_s": per_work,
        "step_dispatch_s": ep["step"]["dispatch_s"],
        "calls": calls,
        "gbest_fitness": float(gbest),
        "report_s": report_s,
        "roofline": {name: {k: e.get(k) for k in ("classification", "achieved_tflops",
                                                  "achieved_gbps", "measured_s_per_unit")}
                     | {"flops": e["static"].get("flops"),
                        "bytes": e["static"].get("bytes_accessed"),
                        "ops": e["static"].get("ops")}
                     for name, e in roof.items()},
        "trace_events": len(trace["traceEvents"]),
        "launches": launches,
    }
    print(f"[telemetry path] {json.dumps(out)}", flush=True)
    return out


def phase_instrumented_nsga2(torch, seed: int = SEED, device=None) -> dict:
    """Main path 22: path 2 (NSGA-II on LSMOP1, pop 10000, d 300, m 3,
    ``use_kernel=True``) under ``instrument(wf, analyze=True,
    block_dispatch=True)``: the init step, one warm step, runs of 4, 4 and
    8 generations and three steps, with every launch counter set to 0 just
    before and read just after each (B3 and B4 once a generation). ``run_report``'s
    analysis of ``step`` and ``run`` must charge exactly one B3 launch of
    ``dominance_work(20000, 3)`` and one B4 launch of ``topk_work(20000,
    10000)`` each, and the report must pass ``tools/check_report.py``.
    Records the roofline's classification and achieved rates of both."""
    from evox_tpu_torch.core.instrument import instrument, run_report

    wf = build_checkpoint_path(torch, device=device)
    rec = instrument(wf, analyze=True, block_dispatch=True)
    state = wf.step(wf.init(seed))
    state = wf.step(state)
    launches = []
    for n in INS_RUNS + (1, 1, 1):
        reset_launches()
        state = wf.run(state, n) if n > 1 else wf.step(state)
        torch.cuda.synchronize()
        got = read_launches()
        want = {"fused_rollout": 0, "packed_dominance": n, "partial_topk": n,
                "fused_mlp_rollout": 0}
        if got != want:
            raise AssertionError(f"launches in {n} generation(s): {got}, expected {want}")
        launches.append(got)
    t0 = time.perf_counter()
    report = run_report(wf, state, recorder=rec)
    report_s = time.perf_counter() - t0
    validate(report, None, "path 22 (path 2 instrumented)")
    n = 2 * NSGA2_POP
    b3_bytes, b3_ops = dominance_work(n, LSMOP_M)
    b4_bytes, b4_ops = topk_work(n, NSGA2_POP)
    want_kernels = {"packed_dominance": {"launches": 1, "flops": float(b3_ops),
                                         "bytes": float(b3_bytes)},
                    "partial_topk": {"launches": 1, "flops": float(b4_ops),
                                     "bytes": float(b4_bytes)}}
    entries = report["roofline"]["entries"]
    for name in ("step", "run"):
        got = entries[name]["static"].get("kernels")
        if got != want_kernels:
            raise AssertionError(f"path 22: {name}'s analysis charges {got}, want {want_kernels}")
    print(f"[compare] path 22: step and run each charge one B3 launch ({b3_ops:.3g} operations, "
          f"{b3_bytes} bytes) and one B4 launch ({b4_bytes} bytes)", flush=True)
    per_work = report["dispatch"]["entry_points"]["run"]["per_work_s"]
    out = {
        "runs": list(INS_RUNS),
        "steps": 3,
        "launches": {k: sum(x[k] for x in launches) for k in launches[0]},
        "launches_per_run": launches,
        "run_per_work_s": per_work,
        "report_s": report_s,
        "kernels_charged": want_kernels,
        "roofline": {name: {k: e.get(k) for k in (
            "classification", "measured_s_per_unit", "timing_method", "achieved_tflops",
            "achieved_gbps", "frac_peak_compute", "frac_peak_bandwidth", "ideal_s",
            "dispatch_overhead_frac")} | {
            "flops": e["static"]["flops"], "bytes": e["static"]["bytes_accessed"],
            "ops": e["static"]["ops"], "flops_by_dtype": e["static"]["flops_by_dtype"]}
            for name, e in entries.items()},
    }
    print(f"[instrumented nsga2] {json.dumps(out)}", flush=True)
    return out


# ----------------------------------------------------------- main path 23


class StaleHostSphere(HostEvalSphere):
    """The host Sphere with its own sleep: workload 6's at 4 ms, JAX's
    staleness gate's at 2 ms."""

    def __init__(self, sleep: float):
        self.sleep = sleep

    def evaluate(self, state, pop):
        import numpy as np

        time.sleep(self.sleep)
        return np.sum(np.asarray(pop) ** 2, axis=1).astype(np.float32), state


def build_stale_path(torch, pop: int = HE_POP, dim: int = HE_DIM, sleep: float = HE_SLEEP,
                     center: float = STALE_CENTER, device=None):
    """Main path 23: workload 6's host Sphere and shapes (``bench.py:613-
    707``) under OpenES with JAX's staleness gate's step sizes (learning
    rate 0.15, noise 0.3, center 5)."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import OpenES

    algo = OpenES(torch.full((dim,), center), pop, learning_rate=STALE_LR,
                  noise_stdev=STALE_SIGMA, device=device)
    return StdWorkflow(algo, StaleHostSphere(sleep), device=device)


def phase_stale_path(torch, seed: int = HE_SEED, gens: int = STALE_GENERATIONS,
                     device=None) -> dict:
    """Main path 23: stale tells. ``run_host_pipelined(max_staleness=K)`` at
    K 0, 1 and 2 in turns (0, 1, 2, 2, 1, 0), each ``gens`` generations
    from the state after 3 warm ones: ms a generation, the executor's
    stale counters and ``overlap_efficiency``, the copies. K 0 equals a
    ``wf.step`` loop bit for bit. Then JAX's gate on the card: OpenES d 8,
    pop 64, a host Sphere sleeping 2 ms, 150 generations at K 1 and 2."""
    from evox_tpu_torch.core.executor import GenerationExecutor
    from evox_tpu_torch.core.instrument import run_report
    from evox_tpu_torch.monitors import TelemetryMonitor
    from evox_tpu_torch.workflows import run_host_pipelined

    wf = build_stale_path(torch, device=device)
    state = run_host_pipelined(wf, wf.init(seed), 3)
    # warm the pinned blocks and worker threads of the widest window
    run_host_pipelined(wf, state, 3, max_staleness=2)
    looped = state
    for _ in range(STALE_LAW_GENERATIONS):
        looped = wf.step(looped)
    piped = run_host_pipelined(wf, state, STALE_LAW_GENERATIONS, max_staleness=0)
    law = compare_exact(f"stale path: {STALE_LAW_GENERATIONS} generations at K 0 against a "
                        "wf.step loop", [piped.algo.center], [looped.algo.center])
    turns = []
    for K in (0, 1, 2, 2, 1, 0):
        ex = GenerationExecutor(max_staleness=K)
        link0 = wf.host_link.report()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = run_host_pipelined(wf, state, gens, executor=ex)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(read_launches().values()):
            raise AssertionError(f"kernel launches on the stale path: {read_launches()}")
        link1 = wf.host_link.report()
        rep = ex.report()
        if end.generation != state.generation + gens or rep["counters"]["tells"] != gens:
            raise AssertionError(f"stale path K {K}: {end.generation}, {rep['counters']}")
        if rep["counters"]["max_lag"] != K or rep["queue"]["stale_window_max"] != K + 1:
            raise AssertionError(f"stale path K {K}: lag {rep['counters']['max_lag']}, "
                                 f"window {rep['queue']['stale_window_max']}")
        turn = {"K": K, "ms_per_generation": wall / gens * 1e3,
                "stale_tells": rep["counters"]["stale_tells"],
                "max_lag": rep["counters"]["max_lag"],
                "stale_window_max": rep["queue"]["stale_window_max"],
                "overlap_efficiency": rep["overlap"]["overlap_efficiency"],
                "host_eval_ms_per_generation": rep["overlap"]["host_eval_s"] * 1e3 / gens,
                "d2h_bytes_per_generation": (link1["d2h_bytes"] - link0["d2h_bytes"]) / gens,
                "d2h_ms_per_generation": (None if link1["d2h_ms"] is None
                                          else (link1["d2h_ms"] - link0["d2h_ms"]) / gens),
                "f_center": float(torch.sum(end.algo.center ** 2))}
        print(f"[stale path] {json.dumps(turn)}", flush=True)
        turns.append(turn)
    medians = {K: statistics.median(t["ms_per_generation"] for t in turns if t["K"] == K)
               for K in (0, 1, 2)}
    gate = {}
    for K in (1, 2):
        gwf = build_stale_path(torch, pop=STALE_GATE_POP, dim=STALE_GATE_DIM, sleep=STALE_GATE_SLEEP,
                               device=device)
        gwf = type(gwf)(gwf.algorithm, gwf.problem, monitors=(TelemetryMonitor(16, device=device),),
                        device=device)
        ex = GenerationExecutor(max_staleness=K)
        t0 = time.perf_counter()
        end = ex.run_host(gwf, gwf.init(0), STALE_GATE_GENERATIONS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = run_report(gwf, end, executor=ex)
        c = rep["executor"]["counters"]
        f = float(torch.sum(end.algo.center ** 2))
        gate[f"K{K}"] = {"f_center": f, "stale_tells": c["stale_tells"], "max_lag": c["max_lag"],
                         "ms_per_generation": wall / STALE_GATE_GENERATIONS * 1e3}
        if not (f < 0.05 and c["stale_tells"] > 100 and 1 <= c["max_lag"] <= K
                and rep["executor"]["max_staleness"] == K):
            raise AssertionError(f"JAX's staleness gate at K {K}: {gate[f'K{K}']}")
        validate(report=rep, label=f"stale path, the gate's report at K {K}")
    out = {"pop": HE_POP, "dim": HE_DIM, "sleep_ms": HE_SLEEP * 1e3, "generations": gens,
           "turns": turns, "median_ms_per_generation": medians, "k0_equals_step_loop": law,
           "gate": gate}
    print(f"[stale path] medians {json.dumps(medians)} gate {json.dumps(gate)}", flush=True)
    return out


# ----------------------------------------------------------- main path 24


class HostAckley:
    """Ackley as a host problem (numpy in, numpy out) that scores through
    the card's own ``Ackley``: the island run through the host path then
    equals the device problem's run bit for bit, and the comparison checks
    the host plumbing (the flattened batch's copies) alone."""

    jittable = False
    fit_dtype = "float32"

    def __init__(self, torch, device):
        from evox_tpu_torch.problems.numerical import Ackley

        self.torch, self.device, self.inner, self.calls = torch, device, Ackley(), 0

    def init(self, seed=None):
        return None

    def fit_shape(self, pop_size):
        return (pop_size,)

    def evaluate(self, state, pop):
        self.calls += 1
        x = self.torch.from_numpy(pop).to(self.device)
        return self.inner.evaluate(None, x)[0].cpu().numpy(), state


def _island_tensors(state) -> list:
    return _pso_tensors(state.algo)


def phase_island_arguments(torch, seed: int = ISL_SEED, device=None) -> dict:
    """Main path 24: path 14 (8 PSO islands of 512, Ackley d 256, migration
    every 8) with A5's arguments. (a) ``external_problem=True`` on a host
    Ackley against the device problem, 16 generations, bit for bit. (b)
    ``run(checkpointer=WorkflowCheckpointer(every=8, keep=3))`` for 32
    generations against the straight run, then the newest snapshot
    deleted (a crash after 24), and a fresh workflow's
    ``run(resume_from=)`` to 32: bit for bit. (c) ``dtype_policy=
    BF16_STORAGE, donate_carries=True`` in turns with the float32 twin
    (bf16, f32, f32, bf16), 16 generations each. One batched B4 launch a
    migration throughout."""
    import tempfile

    from evox_tpu_torch import IslandWorkflow
    from evox_tpu_torch.core.dtype_policy import BF16_STORAGE
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer

    dev = torch.device("cuda") if device is None else torch.device(device)
    base, _ = build_island_paths(torch, device=device)

    def make(**kw):
        return IslandWorkflow(base.algorithm, kw.pop("problem", base.problem), n_islands=ISL_N,
                              migrate_every=ISL_EVERY, device=device, **kw)

    out = {"n_islands": ISL_N, "pop": ISL_POP, "dim": ISL_DIM, "every": ISL_EVERY}
    # (a) a host problem over the flattened (8 x 512, 256) batch
    host_problem = HostAckley(torch, dev)
    host_wf, device_wf = make(problem=host_problem, external_problem=True), make()
    walls, ends = {}, {}
    for name, wf in (("host", host_wf), ("device", device_wf)):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ends[name] = wf.run(wf.init(seed), ISL_GENERATIONS)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) / ISL_GENERATIONS * 1e3
        if read_launches()["partial_topk"] != ISL_GENERATIONS // ISL_EVERY:
            raise AssertionError(f"island arguments ({name}): {read_launches()}")
    out["external_problem"] = {
        "ms_per_generation": walls, "host_calls": host_problem.calls,
        "copies": host_wf.host_link.report(),
        "equal": compare_exact("islands: a host Ackley against the device problem, "
                               f"{ISL_GENERATIONS} generations", _island_tensors(ends["host"]),
                               _island_tensors(ends["device"]))}
    # (b) the checkpointed run, a crash and a resume
    with tempfile.TemporaryDirectory(prefix="evox_islands_") as tmp:
        wf = make()
        straight = wf.run(wf.init(seed), ISL_CKPT_GENERATIONS)
        ckpt = WorkflowCheckpointer(tmp, every=ISL_CKPT_EVERY, keep=3)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = wf.run(wf.init(seed), ISL_CKPT_GENERATIONS, checkpointer=ckpt)
        torch.cuda.synchronize()
        ckpt_ms = (time.perf_counter() - t0) / ISL_CKPT_GENERATIONS * 1e3
        launches = read_launches()["partial_topk"]
        snapshots = [p.name for p in ckpt.snapshots()]
        for p in Path(tmp).glob(f"ckpt_{ISL_CKPT_GENERATIONS:08d}*"):
            p.unlink()
        fresh = make()
        resumed = fresh.run(fresh.init(seed), ISL_CKPT_GENERATIONS, resume_from=tmp)
        out["checkpoint"] = {
            "every": ISL_CKPT_EVERY, "generations": ISL_CKPT_GENERATIONS,
            "ms_per_generation": ckpt_ms, "snapshots": snapshots, "partial_topk_launches": launches,
            "saved_equals_straight": compare_exact("islands: the checkpointed run against the "
                                                   "straight run", _island_tensors(saved),
                                                   _island_tensors(straight)),
            "resume_equals_straight": compare_exact(
                f"islands: resumed from generation {ISL_CKPT_GENERATIONS - ISL_CKPT_EVERY} to "
                f"{ISL_CKPT_GENERATIONS} against the straight run", _island_tensors(resumed),
                _island_tensors(straight))}
    # (c) bf16 storage with donated carries against float32, in turns
    runs = {"bf16": make(dtype_policy=BF16_STORAGE, donate_carries=True),
            "f32": make(donate_carries=True)}
    states = {k: wf.run(wf.init(seed), ISL_EVERY) for k, wf in runs.items()}
    turns = []
    for name in ("bf16", "f32", "f32", "bf16"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = runs[name].run(states[name], ISL_GENERATIONS)
        torch.cuda.synchronize()
        turns.append({"policy": name,
                      "ms_per_generation": (time.perf_counter() - t0) / ISL_GENERATIONS * 1e3,
                      "partial_topk_launches": read_launches()["partial_topk"]})
        if name == "bf16":
            # the stacked island states: every island's leaves at once
            check_storage_dtypes(torch, end.algo, states["f32"].algo, "bf16 islands")
    out["bf16"] = {"turns": turns, "median_ms_per_generation": {
        p: statistics.median(t["ms_per_generation"] for t in turns if t["policy"] == p)
        for p in ("bf16", "f32")}}
    print(f"[island arguments] {json.dumps(out)}", flush=True)
    return out


# ----------------------------------------------------- main paths 25 and 26


def _differenced_ms(timed, pair) -> dict:
    """bench.py's differenced slope: the least of ``MET_REPEATS`` timings
    at each trip count, ms a generation from their difference."""
    t1 = min(timed(pair[0]) for _ in range(MET_REPEATS))
    t2 = min(timed(pair[1]) for _ in range(MET_REPEATS))
    return {"t_s": [t1, t2], "ms_per_generation": (t2 - t1) / (pair[1] - pair[0]) * 1e3}


def phase_metrics_path(torch, seed: int = BF16_SEED, device=None, out_dir=None) -> dict:
    """Main path 25: ``bench.py``'s workload 12. Path 4's CSO through
    ``GenerationExecutor(metrics=FlightRecorder(directory=tmp)).run_fused``
    in chunks of 100, with ``slo.tenant_gens`` counted and one fsynced
    ``sample`` a chunk, against the same chunked loop with
    ``metrics=None``, in turns (instrumented, bare, bare, instrumented),
    trip counts 100 and 400 differenced. The stream must pass
    ``validate_metrics_stream``, the report's ``metrics`` and ``slo``
    sections ``validate_run_report``, and the final states must be equal
    bit for bit."""
    import shutil
    import tempfile

    from evox_tpu_torch.core.executor import GenerationExecutor
    from evox_tpu_torch.core.instrument import run_report
    from evox_tpu_torch.workflows.flightrec import FlightRecorder, read_stream

    wf, _ = build_cso_path(torch, device=device)
    state = wf.step(wf.step(wf.init(seed)))
    tmp = tempfile.mkdtemp(prefix="evox_metrics_", dir=out_dir)
    recorder = FlightRecorder(directory=tmp)
    sides = {"instrumented": (GenerationExecutor(metrics=recorder), recorder),
             "bare": (GenerationExecutor(), None)}
    finals = {}

    def measurer(name):
        ex, fr = sides[name]

        def timed(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = state
            for k in range(n // MET_CHUNK):
                s = ex.run_fused(wf, s, MET_CHUNK)
                if fr is not None:
                    fr.count("slo.tenant_gens", MET_CHUNK)
                    fr.sample(generation=(k + 1) * MET_CHUNK)
            torch.cuda.synchronize()
            finals[name] = s
            return time.perf_counter() - t0

        return timed

    for name in sides:
        for n in MET_PAIR:
            measurer(name)(n)  # warm both trip counts
    turns = []
    for name in ("instrumented", "bare", "bare", "instrumented", "instrumented", "bare"):
        turn = {"side": name, **_differenced_ms(measurer(name), MET_PAIR)}
        print(f"[metrics path] {json.dumps(turn)}", flush=True)
        turns.append(turn)
    med = {s: statistics.median(t["ms_per_generation"] for t in turns if t["side"] == s)
           for s in sides}
    equal = compare_exact("metrics path: the instrumented run's final state against the bare one",
                          [finals["instrumented"].algo.population, finals["instrumented"].algo.velocity,
                           finals["instrumented"].algo.fitness],
                          [finals["bare"].algo.population, finals["bare"].algo.velocity,
                           finals["bare"].algo.fitness])
    records = read_stream(tmp)
    errors = check_report_module().validate_metrics_stream(records)
    if errors:
        raise AssertionError(f"metrics path: the stream fails validation: {errors[:5]}")
    report = run_report(wf, finals["instrumented"], executor=sides["instrumented"][0],
                        metrics=recorder)
    validate(report=report, label="metrics path, the report's metrics and slo sections")
    snap = recorder.registry.snapshot()
    shutil.rmtree(tmp, ignore_errors=True)
    out = {"pop": CSO_POP, "dim": CSO_DIM, "chunk": MET_CHUNK, "pair": list(MET_PAIR),
           "turns": turns, "median_ms_per_generation": med,
           "bare_over_instrumented": med["bare"] / med["instrumented"],
           "bench_law": 0.98,  # the JAX package's ratio, a reference only
           "stream_records": len(records),
           "samples": sum(1 for r in records if r.get("kind") == "sample"),
           "dispatches": snap["counters"]["executor.dispatches"],
           "dispatch_ms_histogram": snap["histograms"]["executor.dispatch_ms"],
           "slo": report["slo"], "states_equal": equal}
    print(f"[metrics path] {json.dumps(out)}", flush=True)
    return out


def _flip_bit(torch, state, leaf: str, index: int = 0, bit: int = 0):
    """``state`` with one bit flipped in the float32 tensor at the dotted
    path ``leaf`` (a silent-data-corruption stand-in)."""
    import dataclasses

    head, _, rest = leaf.partition(".")
    if rest:
        return dataclasses.replace(state, **{head: _flip_bit(torch, getattr(state, head), rest,
                                                             index, bit)})
    x = getattr(state, head)
    words = x.contiguous().view(torch.int32).reshape(-1).clone()
    words[index] ^= 1 << bit
    return dataclasses.replace(state, **{head: words.view(torch.float32).reshape(x.shape)})


class LyingRun:
    """``wf.run`` that answers wrongly on scripted call indices: ``perturb``
    flips one mantissa bit of the population, ``stale`` hands back the
    previous honest result."""

    def __init__(self, torch, fn, lies):
        self.torch, self.fn, self.lies, self.calls, self.last = torch, fn, dict(lies), 0, None

    def __call__(self, state, n):
        flavor = self.lies.get(self.calls)
        self.calls += 1
        result = self.fn(state, n)
        if flavor is None:
            self.last = result
            return result
        if flavor == "stale":
            return self.last
        return _flip_bit(self.torch, result, "algo.population", 5)


def digest_stress_leaves(torch, dev) -> dict:
    """Leaves of every dtype case on the card: NaN with payloads, +-inf,
    +-0.0, float64 and float16 with NaN and inf, bf16 (no NaN counted),
    int64, int8, bool, uint8, an empty leaf, a leaf at an odd offset (the
    scalar route), a 0-d leaf and Python seeds."""
    g = torch.Generator(device="cpu").manual_seed(3)
    f32 = torch.randn(100003, generator=g)
    f32[:4] = torch.tensor([0x7FC00000, -0x3FFFFFFF, 0x7F800001, 0x7FBFFFFF],
                           dtype=torch.int32).view(torch.float32)
    f32[4:8] = torch.tensor([float("inf"), float("-inf"), 0.0, -0.0])
    f64 = torch.randn(4099, generator=g, dtype=torch.float64)
    f64[:3] = torch.tensor([float("nan"), float("inf"), -0.0], dtype=torch.float64)
    f16 = torch.randn(5001, generator=g).half()
    f16[:2] = torch.tensor([float("nan"), float("-inf")]).half()
    bf16 = torch.randn(7000, generator=g).bfloat16()
    bf16[:2] = torch.tensor([float("nan"), float("inf")]).bfloat16()
    leaves = {"f32": f32, "f64": f64, "f16": f16, "bf16": bf16,
              "i64": torch.randint(-2**62, 2**62, (3001,), generator=g),
              "i8": torch.randint(-128, 128, (999,), generator=g, dtype=torch.int8),
              "u8": torch.randint(0, 256, (65537,), generator=g, dtype=torch.uint8),
              "bool": torch.rand(4097, generator=g) < 0.5,
              "empty": torch.zeros((0, 5)),
              "scalar": torch.tensor(2.5)}
    leaves = {k: v.to(dev) for k, v in leaves.items()}
    leaves["odd_offset"] = leaves["f32"][1:]  # not 16-byte aligned: the scalar route
    leaves["f64_odd"] = leaves["f64"][1:]
    return {**leaves, "seed": 12345, "big_seed": 2**40 + 7}


def d1_kernel_ms(torch, leaves, salts, reps: int = 40) -> float:
    """D1's device ms a launch: raw launches of ``csrc/digest.cu`` on
    prebuilt tables (a few µs of host a call, under the kernel's time),
    alternating between ``leaves`` and a copy of them, so that the two
    (2 x 33.6 MB on CSO's state) exceed the 50 MB L2 and each launch reads
    its words from device memory; CUDA events around ``reps`` launches."""
    import numpy as np

    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import digest as kd

    fn = _build.function("digest", "evox_state_digest", kd._SIGNATURE)
    stream = torch.cuda.current_stream().cuda_stream
    calls, alive = [], []
    for group in (list(leaves), [x.clone() for x in leaves]):
        rows, n_blocks, flat = kd._table(group, salts)
        carry = np.asarray(kd.IDENTITY, np.uint32)
        dev = group[0].device
        partial = torch.empty((n_blocks * kd.DIGEST_WORDS + 1,), dtype=torch.int32, device=dev)
        leaf_out = torch.empty((len(group), kd.DIGEST_WORDS), dtype=torch.int64, device=dev)
        out = torch.empty((kd.DIGEST_WORDS,), dtype=torch.int64, device=dev)
        calls.append((rows.ctypes.data, len(group), carry.ctypes.data, n_blocks, partial.data_ptr(),
                      leaf_out.data_ptr(), out.data_ptr(), None, stream))
        alive.append((rows, carry, partial, leaf_out, out, flat, group))

    def run():
        for i in range(reps):
            _build.check_launch("digest", fn(*calls[i % 2]), "state digest")

    return _time_ms(run, 1, 1) / reps


def phase_digest_kernel(torch, state, dev) -> dict:
    """D1 against its plain version on the card, bit for bit: every tensor
    leaf of path 4's CSO state in one launch, the stress leaves, and a
    state of more leaves than a table (chained launches); both against
    ``host_state_digest``. Times D1 and the plain version on CSO's state
    (CUDA events) beside their bound."""
    import numpy as np

    from evox_tpu_torch.core.attest import _salt, host_state_digest, state_digest
    from evox_tpu_torch.core.struct import named_leaves
    from evox_tpu_torch.kernels import digest as kd

    def check(label, tree):
        named = [(n, x) for n, x in named_leaves(tree) if isinstance(x, torch.Tensor) and x.numel()]
        leaves, salts = [x for _, x in named], [_salt(n) for n, _ in named]
        got, got_rows = kd.digest_leaves(leaves, salts)
        want, want_rows = kd.digest_leaves_plain(leaves, salts)
        stats = compare_exact(f"D1 state digest, {label}: combined and per-leaf words",
                              [got, got_rows], [want, want_rows])
        host = host_state_digest(tree)
        full = state_digest(tree).cpu().numpy().astype(np.uint32)
        if not (full == host).all():
            raise AssertionError(f"D1 {label}: state_digest {full} != host_state_digest {host}")
        return stats

    def two_streams(tree_a, tree_b):
        # two digests in flight at once on two streams: each launch owns
        # its block counter, so neither finishes the other's digest
        def args(tree):
            named = [(n, x) for n, x in named_leaves(tree)
                     if isinstance(x, torch.Tensor) and x.numel()]
            return [x for _, x in named], [_salt(n) for n, _ in named]

        (la, sa), (lb, sb) = args(tree_a), args(tree_b)
        streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
        torch.cuda.synchronize(dev)
        got = []
        for _ in range(4):
            for st, (leaves, salts) in zip(streams, ((la, sa), (lb, sb))):
                with torch.cuda.stream(st):
                    got.append(kd.digest_leaves(leaves, salts)[0])
        torch.cuda.synchronize(dev)
        want = [kd.digest_leaves_plain(la, sa)[0], kd.digest_leaves_plain(lb, sb)[0]] * 4
        return compare_exact("D1 on two streams at once", got, want)

    selected = state.replace(monitors=())
    stress = digest_stress_leaves(torch, dev)
    out = {"cso_state": check("path 4's CSO state", selected),
           "two_streams": two_streams(selected, stress),
           "stress": check("the stress leaves", stress),
           "chained": check(f"{kd.MAX_LEAVES + 9} leaves (two launches)",
                            {f"x{i:03d}": torch.full((37,), float(i), device=dev)
                             for i in range(kd.MAX_LEAVES + 9)})}
    named = [(n, x) for n, x in named_leaves(selected) if isinstance(x, torch.Tensor) and x.numel()]
    leaves, salts = [x for _, x in named], [_salt(n) for n, _ in named]
    nbytes, ops = kd.digest_work(leaves)
    t_bound, bound_by = bound_ms(nbytes, ops)
    before = kd.digest_leaves.launches
    launch = lambda: kd.digest_leaves(leaves, salts)  # noqa: E731
    out.update({
        "leaves": len(leaves), "bytes": nbytes, "operations": ops,
        # the kernel's own time from device memory (raw launches, CUDA
        # events); the wrapper's calls back to back (its host time shows
        # when it exceeds the kernel's), the profiler's device time of a
        # wrapper call (the words in L2 after the first), its host time
        "ms": d1_kernel_ms(torch, leaves, salts),
        "wrapper_ms": _time_ms(launch, 3, 20),
        "device_us": device_us_per_call(torch, launch),
        "host_us": host_us_per_call(torch, launch, 200),
        "plain_ms": _time_ms(lambda: kd.digest_leaves_plain(leaves, salts), 1, 3),
        "bound_ms": t_bound, "bound_by": bound_by,
        "max_abs_err": max(v["max_abs_err"] for v in out.values()),
        "state_digest_host_us": host_us_per_call(torch, lambda: state_digest(selected), 200),
    })
    kd.digest_leaves.launches = before  # the comparison's launches are not the path's
    print(f"[digest kernel] {json.dumps(out)}", flush=True)
    return out


def phase_attest_path(torch, seed: int = BF16_SEED, device=None) -> dict:
    """Main path 26: ``bench.py``'s workload 12b. Path 4's CSO with
    ``StateAttestor(every=10, capacity=64)`` against bare ``wf.run``, in
    turns, trip counts 100 and 400 differenced; D1's launches counted over
    an attested run of 400 (one an attestation). Every ring digest of a
    run equals ``host_state_digest`` of that generation's state. D1 against
    its plain version (``phase_digest_kernel``). ``run_fused(verify_every=
    1)`` with a lying dispatch heals, three distinct digests raise
    ``IntegrityError``, and ``bisect_divergence`` names a generation with
    one flipped bit."""
    import tempfile

    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.core.attest import (
        IntegrityError,
        StateAttestor,
        bisect_divergence,
        digest_hex,
        host_state_digest,
    )
    from evox_tpu_torch.core.executor import GenerationExecutor
    from evox_tpu_torch.core.instrument import run_report
    from evox_tpu_torch.kernels import digest as kd
    from evox_tpu_torch.workflows.journal import RunJournal

    dev = torch.device("cuda") if device is None else torch.device(device)
    bare, _ = build_cso_path(torch, device=device)
    att = StateAttestor(every=ATT_EVERY, capacity=ATT_CAPACITY, device=device)
    attested = StdWorkflow(bare.algorithm, bare.problem, monitors=(att,), device=device)
    states = {"attested": attested.init(seed), "bare": bare.init(seed)}
    wfs = {"attested": attested, "bare": bare}

    def measurer(name):
        def timed(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wfs[name].run(states[name], n)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        return timed

    for name in wfs:
        for n in ATT_PAIR:
            measurer(name)(n)
    turns = []
    for name in ("attested", "bare", "bare", "attested", "attested", "bare"):
        turn = {"side": name, **_differenced_ms(measurer(name), ATT_PAIR)}
        print(f"[attest path] {json.dumps(turn)}", flush=True)
        turns.append(turn)
    med = {s: statistics.median(t["ms_per_generation"] for t in turns if t["side"] == s)
           for s in wfs}
    # the main path's run: D1 once an attestation, nothing else launched
    reset_launches()
    kd.digest_leaves.launches = 0
    end = attested.run(states["attested"], ATT_PAIR[1])
    torch.cuda.synchronize()
    launches = {**read_launches(), "state_digest": kd.digest_leaves.launches}
    if launches["state_digest"] != ATT_PAIR[1] // ATT_EVERY or any(
            v for k, v in launches.items() if k != "state_digest"):
        raise AssertionError(f"attest path: launches {launches}")
    ledger = att.ledger(end.monitors[0])
    # every ring digest against the host digest of that generation's state
    s, host = attested.init(seed), {}
    for _ in range(ATT_RING_CHECK // ATT_EVERY):
        s = attested.run(s, ATT_EVERY)
        host[s.generation] = digest_hex(host_state_digest(s.replace(monitors=())))
    ring = att.ledger(s.monitors[0])
    bad = [e for e in ring if host[e["generation"]] != e["digest"]]
    if bad or len(ring) != ATT_RING_CHECK // ATT_EVERY:
        raise AssertionError(f"attest path: ring digests against the host: {bad[:3]}, {len(ring)}")
    kernel = phase_digest_kernel(torch, s, dev)

    # the voted re-dispatch on the card
    start = bare.init(seed)
    straight = bare.run(start, VOTE_GENERATIONS)
    votes = {}
    for name, lies in (("heal", {2: "perturb"}), ("abort", {2: "perturb", 3: "stale"})):
        voter = StdWorkflow(bare.algorithm, bare.problem, device=device)
        voter.run = LyingRun(torch, voter.run, lies)
        ex = GenerationExecutor()
        kd.digest_leaves.launches = 0
        try:
            healed = ex.run_fused(voter, start, VOTE_GENERATIONS, chunk=VOTE_CHUNK,
                                  attest=StateAttestor(device=device), verify_every=1)
        except IntegrityError as e:
            votes[name] = {"raised": str(e)[:120], "counters": ex.integrity_counters()}
            continue
        votes[name] = {
            "counters": ex.integrity_counters(), "digest_launches": kd.digest_leaves.launches,
            "equal": compare_exact("attest path: the healed run against the straight run",
                                   [healed.algo.population, healed.algo.velocity],
                                   [straight.algo.population, straight.algo.velocity]),
            "verdict": run_report(voter, healed, executor=ex)["integrity"]["verdict"]}
    chunks = VOTE_GENERATIONS // VOTE_CHUNK
    heal = votes["heal"]["counters"]
    if not (heal["mismatches"] == 1 and heal["healed"] == 1 and heal["verified_chunks"] == chunks - 1
            and votes["heal"]["verdict"] == "healed"):
        raise AssertionError(f"attest path: the vote did not heal as expected: {votes['heal']}")
    if "raised" not in votes["abort"] or votes["abort"]["counters"]["aborted"] != 1:
        raise AssertionError(f"attest path: three distinct digests did not raise: {votes['abort']}")

    # bisect_divergence names the flipped generation
    batt = StateAttestor(every=BISECT_EVERY, capacity=16, device=device)
    bwf = StdWorkflow(bare.algorithm, bare.problem, monitors=(batt,), device=device)
    state0 = bwf.step(bwf.init(seed))

    def faulty(s, n):
        for _ in range(int(n)):
            s = bwf.run(s, 1)
            if s.generation == BISECT_FLIP:  # a high mantissa bit: the fault survives rounding
                s = _flip_bit(torch, s, "algo.population", 7, 20)
        return s

    bad_end = faulty(state0, BISECT_GENERATIONS)
    with tempfile.TemporaryDirectory(prefix="evox_journal_") as tmp:
        journal = RunJournal(tmp)
        batt.journal_ring(bad_end.monitors[0], journal)
        t0 = time.perf_counter()
        forensics = bisect_divergence(tmp, wf=bwf, start_state=state0, suspect=faulty,
                                      attestor=batt, report_to=bwf)
        bisect_s = time.perf_counter() - t0
    if forensics["first_divergent_generation"] != BISECT_FLIP or ".algo.population" not in \
            forensics["leaves"]:
        raise AssertionError(f"attest path: bisect_divergence: {forensics}")
    report = run_report(bwf, bad_end)
    validate(report=report, label="attest path, the integrity section with its bisection")
    out = {"pop": CSO_POP, "dim": CSO_DIM, "every": ATT_EVERY, "pair": list(ATT_PAIR),
           "turns": turns, "median_ms_per_generation": med,
           "bare_over_attested": med["bare"] / med["attested"], "bench_law": 0.98,
           "launches": launches, "ring_entries": len(ledger), "ring_checked": len(ring),
           "digest_kernel": kernel, "votes": votes,
           "bisect": {**{k: forensics[k] for k in ("window", "first_divergent_generation",
                                                    "leaves", "chunks_replayed",
                                                    "generations_replayed")},
                      "seconds": bisect_s}}
    print(f"[attest path] {json.dumps({k: v for k, v in out.items() if k != 'digest_kernel'})}",
          flush=True)
    return out


# ----------------------------------------------------------- main path 27


def _tensor_leaves(torch, tree) -> list:
    from evox_tpu_torch.core.struct import named_leaves

    return [x for _, x in named_leaves(tree) if isinstance(x, torch.Tensor)]


def phase_lineage_path(torch, seed: int = SEED, gens: int = GENERATIONS, device=None) -> dict:
    """Main path 27: ``LineageMonitor(64)`` on path 9 (SHADE on Ackley, pop
    4096, d 1024: DE's exact parent maps) and ``LineageMonitor(64,
    num_objectives=3, default_op="crossover")`` on path 2 (NSGA-II on
    LSMOP1, pop 10000: one more B3 launch a generation for the batch's
    front, and a 10000 x 10000 churn distance), each in turns with its
    unmonitored twin (monitored, twin, twin, monitored), ``gens``
    generations from the state after two; every algorithm state equal to
    the twin's bit for bit, the ``search`` section valid."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.core.instrument import run_report
    from evox_tpu_torch.monitors import LineageMonitor

    out = {}
    shade = build_shade_path(torch, device=device)
    nsga2 = build_nsga2_path(torch)
    cases = (("shade", shade, {}),
             ("nsga2", StdWorkflow(nsga2.algorithm, nsga2.problem, device=device),
              {"num_objectives": LSMOP_M, "default_op": "crossover"}))
    for name, twin, kw in cases:
        mon = LineageMonitor(LIN_CAPACITY, device=device, **kw)
        watched = StdWorkflow(twin.algorithm, twin.problem, monitors=(mon,), device=device)
        wfs = {"monitored": watched, "twin": twin}
        starts = {k: wf.step(wf.step(wf.init(seed))) for k, wf in wfs.items()}
        turns, ends = [], {}
        for side in ("monitored", "twin", "twin", "monitored"):
            torch.cuda.empty_cache()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ends[side] = wfs[side].run(starts[side], gens)
            torch.cuda.synchronize()
            turns.append({"side": side, "ms_per_generation": (time.perf_counter() - t0) / gens * 1e3,
                          "launches": read_launches()})
            print(f"[lineage path] {name} {json.dumps(turns[-1])}", flush=True)
        equal = compare_exact(f"lineage path: {name} with the monitor against its twin",
                              _tensor_leaves(torch, ends["monitored"].algo),
                              _tensor_leaves(torch, ends["twin"].algo))
        report = run_report(watched, ends["monitored"])
        validate(report=report, label=f"lineage path, {name}'s search section")
        search = report["search"]
        med = {s: statistics.median(t["ms_per_generation"] for t in turns if t["side"] == s)
               for s in wfs}
        b3 = {s: [t["launches"]["packed_dominance"] for t in turns if t["side"] == s] for s in wfs}
        if name == "nsga2" and not all(m == t + gens for m, t in zip(b3["monitored"], b3["twin"])):
            raise AssertionError(f"lineage path: B3 launches {b3}, one more a generation expected")
        out[name] = {"turns": turns, "median_ms_per_generation": med,
                     "monitored_over_twin": med["monitored"] / med["twin"],
                     "b3_launches": b3, "equal": equal,
                     "ancestry_length": len(search["ancestry"]), "ledger": search["ledger"],
                     "front_size": search["trajectory"].get("front_size", [])[-3:],
                     "churn": search["trajectory"].get("churn", [])[-3:]}
    out["launches"] = out["nsga2"]["b3_launches"]["monitored"][-1] \
        - out["nsga2"]["b3_launches"]["twin"][-1]
    print(f"[lineage path] {json.dumps({k: v for k, v in out.items()})}", flush=True)
    return out


# ------------------------------------------------- M1 and B3's rows form


def smallmm_work(b: int, p: int, k: int, q: int) -> tuple:
    """(bytes, operations) of ``b`` products (p, k)(k, q):
    ``kernels/smallmm.py``'s count, the one the cost analysis charges."""
    from evox_tpu_torch.kernels.smallmm import smallmm_work as work

    return work(b, p, k, q)


def _smallmm_operands(torch, b, p, k, q, trans_a, trans_b, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((b,) + ((k, p) if trans_a else (p, k)), generator=g)
    bb = torch.randn((b,) + ((q, k) if trans_b else (k, q)), generator=g)
    return a.cuda(), bb.cuda()


def phase_smallmm_kernel(torch) -> dict:
    """Kernel M1 (``csrc/smallmm.cu``) at CMA-ES's shapes on paths 28 and 5
    (``SMALLMM_SHAPES``): against ``smallmm_plain`` on the same card
    tensors, bit for bit; a batch against each of its members launched as a
    batch of 1, bit for bit (the batch-count law M1 exists for); timed by
    CUDA events (3 warm-up runs, mean of 20) beside the plain version and
    ``torch.bmm`` on the same operands (the library column), with its bound
    from ``smallmm_work``."""
    from evox_tpu_torch.kernels import smallmm as km

    out = {"shapes": []}
    for name, b, p, k, q, ta, tb in SMALLMM_SHAPES:
        a, bb = _smallmm_operands(torch, b, p, k, q, ta, tb, 1000 + p + k + q)
        before = km.smallmm.launches
        got = km.smallmm(a, bb, ta, tb, device=a.device)
        if km.smallmm.launches - before != 1:
            raise AssertionError(f"M1 {name}: {km.smallmm.launches - before} launches")
        check = compare_exact(f"M1 {name} against its plain version", (got,),
                              (km.smallmm_plain(a, bb, ta, tb),))
        singles = torch.stack([km.smallmm(a[i:i + 1], bb[i:i + 1], ta, tb, device=a.device)[0]
                               for i in range(b)])
        compare_exact(f"M1 {name}: a batch of {b} against each member in a batch of 1", (got,),
                      (singles,))
        A = a.transpose(-1, -2) if ta else a
        B = bb.transpose(-1, -2) if tb else bb
        entry = {"name": name, "b": b, "p": p, "k": k, "q": q, "trans_a": ta, "trans_b": tb,
                 "max_abs_err": check["max_abs_err"],
                 "ms": _time_ms(lambda: km.smallmm(a, bb, ta, tb, device=a.device), 3, 20),
                 "plain_ms": _time_ms(lambda: km.smallmm_plain(a, bb, ta, tb), 1,
                                      3 if k > 100 else 20),
                 "library_ms": _time_ms(lambda: torch.bmm(A, B), 3, 20)}
        nbytes, ops = smallmm_work(b, p, k, q)
        entry["bound_ms"], entry["bound_by"] = bound_ms(nbytes, ops)
        out["shapes"].append(entry)
        print(f"[smallmm] {json.dumps(entry)}", flush=True)
    return out


def dominance_rows_work(r: int, n: int, m: int) -> tuple:
    """(bytes, operations) of a slab of ``r`` rows against ``n`` columns:
    ``kernels/dominance.py``'s count."""
    from evox_tpu_torch.kernels.dominance import dominance_rows_work as work

    return work(r, n, m)


def phase_dominance_rows(torch) -> dict:
    """B3's rows form: at each (n, m, shards) of ``DOMINANCE_ROWS`` (path
    31's n 20000 with 8 shards of 2528 padded rows, and shapes whose n
    leaves a remainder of ``32 * shards``), every shard's slab of phase 2's
    stress rows (ties, NaN, ±0.0, ±inf), ``+inf``-padded, launched once:
    each slab bit for bit against ``packed_dominance_rows_reference``, the
    concatenated slabs against the full B3 (its words, then zero words)
    and the summed partial counts against its counts, bit for bit. Timed
    at path 31's shape: one slab, the 8 slabs of a generation, the plain
    version of a slab, and the full B3 as the unsharded twin."""
    from evox_tpu_torch.kernels import dominance as kd

    out = {"shapes": []}
    for n, m, shards in DOMINANCE_ROWS:
        fit = stress_fitness(torch, n, m, 7000 + n + shards, "cpu").cuda()
        n_words = -(-n // 32)
        words_per = -(-n_words // shards)
        rows = torch.cat([fit, torch.full((words_per * shards * 32 - n, m), float("inf"),
                                          device=fit.device)])
        slab_rows = [rows[s * words_per * 32:(s + 1) * words_per * 32] for s in range(shards)]
        before = kd.packed_dominance_rows.launches
        slabs = [kd.packed_dominance_rows(r, fit, device=fit.device) for r in slab_rows]
        launches = kd.packed_dominance_rows.launches - before
        if launches != shards:
            raise AssertionError(f"B3 rows ({n}, {m}, {shards}): {launches} launches")
        worst = 0.0
        for s, (r, got) in enumerate(zip(slab_rows, slabs)):
            worst = max(worst, compare_exact(
                f"B3 rows slab {s} of {shards} (n {n}, m {m}) against its plain version", got,
                kd.packed_dominance_rows_reference(r, fit))["max_abs_err"])
        full_p, full_c = kd.packed_dominance(fit, device=fit.device)
        words = torch.cat([p for p, _ in slabs])
        compare_exact(f"B3 rows, {shards} slabs concatenated (n {n}, m {m}) against the full B3",
                      (words[:n_words], words[n_words:], sum(c for _, c in slabs)),
                      (full_p, torch.zeros_like(words[n_words:]), full_c))
        entry = {"n": n, "m": m, "shards": shards, "slab_rows": words_per * 32,
                 "launches": launches, "max_abs_err": worst}
        if (n, m, shards) == (2 * NSGA2_POP, LSMOP_M, PATH31_SHARDS):
            r0 = slab_rows[0]
            entry.update({
                "ms": _time_ms(lambda: kd.packed_dominance_rows(r0, fit, device=fit.device), 3, 20),
                "generation_ms": _time_ms(lambda: [kd.packed_dominance_rows(r, fit, device=fit.device)
                                                   for r in slab_rows], 3, 20),
                "plain_ms": _time_ms(lambda: kd.packed_dominance_rows_reference(r0, fit), 1, 3),
                "full_b3_ms": _time_ms(lambda: kd.packed_dominance(fit, device=fit.device), 3, 20)})
            nbytes, ops = dominance_rows_work(words_per * 32, n, m)
            entry["bound_ms"], entry["bound_by"] = bound_ms(nbytes, ops)
            gen = [dominance_rows_work(words_per * 32, n, m)] * shards
            entry["generation_bound_ms"], _ = bound_ms(sum(b for b, _ in gen), sum(o for _, o in gen))
        out["shapes"].append(entry)
        print(f"[dominance rows] {json.dumps(entry)}", flush=True)
    out["main"] = next(e for e in out["shapes"] if "ms" in e)
    return out


# ----------------------------------------------------------- paths 30-32


def build_sharded_es_path(torch, mesh, n_shards: int, pop: int = LP_POP, dim: int = LP_DIM,
                          device=None):
    """Main path 30 as ``bench.py:764-903`` builds workload 7:
    ``StdWorkflow(ShardedES(SepCMAES(zeros(32), 1.0, pop_size=65536),
    mesh=mesh, n_shards=n_shards), Sphere())``."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import SepCMAES
    from evox_tpu_torch.core.distributed import ShardedES
    from evox_tpu_torch.problems.numerical import Sphere

    algo = ShardedES(SepCMAES(torch.zeros(dim), 1.0, pop_size=pop, device=device), mesh=mesh,
                     n_shards=n_shards)
    return StdWorkflow(algo, Sphere(), device=device)


def phase_sharded_es(torch, seed: int = LP_SEED, device=None) -> dict:
    """Main path 30, ``bench.py``'s workload 7: ``ShardedES(SepCMAES)`` at
    pop 65536, d 32 on Sphere, on an 8-shard mesh of the one card
    (per-shard draws, rank-weighted partial moments summed in mesh order)
    against its replicated twin ``mesh=None, n_shards=8`` (the same draws,
    the sorted-selection tell). From the same seed, 10 generations of each:
    the samples ``z`` bit for bit every generation, and mean, C and sigma
    within rtol 1e-4, atol 1e-4 (``tests/test_large_pop.py:154-168``'s
    sharded-against-replicated tolerance) after 10. Then in turns (sharded,
    replicated, replicated, sharded) bench's differenced pair ``LP_PAIR`` =
    (2, 10): ms a generation of each, with every launch counter at 0 before
    and read after (no kernel on this path)."""
    from evox_tpu_torch.core.distributed import create_mesh
    from evox_tpu_torch.kernels import smallmm as km

    dev = torch.device("cuda" if device is None else device)
    mesh = create_mesh(devices=[torch.device(dev.type, 0) if dev.type == "cuda" else dev]
                       * LP_SHARDS)
    sharded = build_sharded_es_path(torch, mesh, LP_SHARDS, device=device)
    replicated = build_sharded_es_path(torch, None, LP_SHARDS, device=device)
    a, b = sharded.init(seed), replicated.init(seed)
    for _ in range(LP_CHECK_GENERATIONS):
        a, b = sharded.step(a), replicated.step(b)
        compare_exact("path 30: the sharded generation's samples against the replicated ones",
                      (a.algo.z,), (b.algo.z,))
    out = {"pop": LP_POP, "dim": LP_DIM, "shards": LP_SHARDS, "pair": list(LP_PAIR),
           "after_10": {f: compare(f"path 30: {f} after {LP_CHECK_GENERATIONS} generations, "
                                   "sharded against replicated",
                                   getattr(a.algo, f).reshape(-1).cpu(),
                                   getattr(b.algo, f).reshape(-1).cpu(), 1e-4, 1e-4)["max_abs_err"]
                        for f in ("mean", "C", "sigma")}}
    if not (bool(torch.isfinite(a.algo.mean).all()) and float(a.algo.sigma) > 0):
        raise AssertionError("path 30: the sharded state is not finite")
    states = {"sharded": (sharded, a), "replicated": (replicated, b)}
    turns = []
    for name in ("sharded", "replicated", "replicated", "sharded"):
        wf, state = states[name]
        reset_launches()
        km.smallmm.launches = 0
        walls = []
        for n in LP_PAIR:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wf.run(state, n)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        got = {**read_launches(), "smallmm": km.smallmm.launches}
        if any(got.values()):
            raise AssertionError(f"path 30 ({name}) launched a kernel: {got}")
        turn = {"side": name,
                "ms_per_generation": (walls[1] - walls[0]) / (LP_PAIR[1] - LP_PAIR[0]) * 1e3}
        turns.append(turn)
        print(f"[sharded es] {json.dumps(turn)}", flush=True)
    out["turns"] = turns
    for side in ("sharded", "replicated"):
        out[f"{side}_ms_per_generation"] = statistics.median(
            t["ms_per_generation"] for t in turns if t["side"] == side)
    print(f"[sharded es] {json.dumps({k: v for k, v in out.items() if k != 'turns'})}", flush=True)
    return out


def build_sharded_nsga2_path(torch, mesh, pop: int = NSGA2_POP, device=None):
    """Main path 31: path 2's NSGA-II on LSMOP1 (pop 10000, d 300, m 3,
    ``use_kernel=True``) with ``mesh=``."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.mo import NSGA2
    from evox_tpu_torch.problems.numerical import LSMOP1

    prob = LSMOP1(d=LSMOP_D, m=LSMOP_M, device=device)
    algo = NSGA2(*prob.bounds(), n_objs=LSMOP_M, pop_size=pop, use_kernel=True, mesh=mesh,
                 device=device)
    return StdWorkflow(algo, prob, device=device)


def phase_sharded_nsga2(torch, seed: int = SEED, device=None) -> dict:
    """Main path 31: path 2 with the mesh-sharded sort on an 8-shard mesh
    of the one card (each tell's sort of 20000 merged rows: one B3 rows
    launch a shard, 2528 padded rows against n 20000, the peel's delta the
    sum of the shards' popcounts; B4 the last-front cut) against the
    unsharded path 2 (one B3 launch). From the same seed, every generation
    of ``SN_CHECK_GENERATIONS``: population, fitness and ranks bit for bit
    (the ranks and the survivor sets the same). Then in turns (sharded,
    unsharded, unsharded, sharded), ``SN_GENERATIONS`` generations each, ms
    a generation, with every counter at 0 just before and read just after:
    8 rows launches and one B4 launch a sharded generation, one B3 and one
    B4 an unsharded one."""
    from evox_tpu_torch.core.distributed import create_mesh
    from evox_tpu_torch.kernels import dominance as kd

    dev = torch.device("cuda" if device is None else device)
    mesh = create_mesh(devices=[torch.device(dev.type, 0) if dev.type == "cuda" else dev]
                       * PATH31_SHARDS)
    sharded = build_sharded_nsga2_path(torch, mesh, device=device)
    plain = build_sharded_nsga2_path(torch, None, device=device)
    a, b = sharded.init(seed), plain.init(seed)
    for g in range(SN_CHECK_GENERATIONS):
        a, b = sharded.step(a), plain.step(b)
        compare_exact(f"path 31 generation {g}: population, fitness and ranks, sharded against "
                      "unsharded", (a.algo.population, a.algo.fitness, a.algo.rank),
                      (b.algo.population, b.algo.fitness, b.algo.rank))
    states = {"sharded": (sharded, a), "unsharded": (plain, b)}
    turns = []
    for name in ("sharded", "unsharded", "unsharded", "sharded"):
        wf, state = states[name]
        reset_launches()
        kd.packed_dominance_rows.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = wf.run(state, SN_GENERATIONS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {**read_launches(), "packed_dominance_rows": kd.packed_dominance_rows.launches}
        want = {"fused_rollout": 0, "fused_mlp_rollout": 0, "partial_topk": SN_GENERATIONS,
                "packed_dominance": 0 if name == "sharded" else SN_GENERATIONS,
                "packed_dominance_rows": PATH31_SHARDS * SN_GENERATIONS if name == "sharded" else 0}
        if got != want:
            raise AssertionError(f"path 31 ({name}): launches {got}, expected {want}")
        if not bool(torch.isfinite(end.algo.fitness).all()):
            raise AssertionError(f"path 31 ({name}): non-finite fitness")
        turn = {"side": name, "ms_per_generation": wall / SN_GENERATIONS * 1e3, "launches": got}
        turns.append(turn)
        print(f"[sharded nsga2] {json.dumps(turn)}", flush=True)
    out = {"pop": NSGA2_POP, "shards": PATH31_SHARDS, "generations": SN_GENERATIONS,
           "checked_generations": SN_CHECK_GENERATIONS, "turns": turns,
           "launches": next(t["launches"] for t in turns if t["side"] == "sharded")}
    for side in ("sharded", "unsharded"):
        out[f"{side}_ms_per_generation"] = statistics.median(
            t["ms_per_generation"] for t in turns if t["side"] == side)
    return out


class _Faults:
    """A workflow's ``run`` with faults on chosen calls (1-based): a
    transient error as NCCL reports a lost peer, a hang past the
    supervisor's deadline (the call sleeps, then returns its input), and
    PyTorch's out-of-memory error. Other calls run."""

    def __init__(self, wf, faults: dict, hang_s: float):
        self.run = wf.run
        self.faults = dict(faults)
        self.hang_s = hang_s
        self.calls = 0

    def __call__(self, state, n, *args, **kwargs):
        import torch

        self.calls += 1
        kind = self.faults.get(self.calls)
        if kind == "transient":
            raise RuntimeError("NCCL error in: ProcessGroupNCCL.cpp, remote process exited or "
                               "there was a network error, NCCL version 2.21.5: Connection "
                               "reset by peer")
        if kind == "hang":
            time.sleep(self.hang_s)
            return state
        if kind == "oom":
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of "
                "79.19 GiB of which 1.02 GiB is free.")
        return self.run(state, n, *args, **kwargs)


def phase_supervised_nsga2(torch, seed: int = SEED, device=None, out_dir: str = "chiprun_out"
                           ) -> dict:
    """Main path 32: path 2 (as path 18 builds it) for ``SUP_GENERATIONS``
    under ``RunSupervisor(WorkflowCheckpointer(every=10), deadline_s=
    SUP_DEADLINE_S)`` with three faults injected into its chunk dispatches
    (``_Faults``: a transient NCCL-style error on call 2, a hang past the
    deadline on call 3, an out-of-memory error on call 5, which takes the
    restore rung back to the snapshot at generation 20 and replays from
    there): the final state equal to the clean run's bit for bit; the
    supervisor's counters (2 retries, 1 deadline hit, 1 restore) and
    outcome ``recovered``; B3 and B4 launched; ``run_report`` and the
    Chrome trace (``chiprun_out/supervised_trace.json``) accepted by
    ``tools/check_report.py``. Times the supervised run without faults
    against the same run checkpointed every 10 generations and
    unsupervised, in turns."""
    import tempfile

    from evox_tpu_torch.core.instrument import run_report, write_chrome_trace
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer
    from evox_tpu_torch.workflows.supervisor import RunSupervisor

    clean_wf = build_checkpoint_path(torch, device=device)
    start = clean_wf.init(seed)
    reset_launches()
    t0 = time.perf_counter()
    clean = clean_wf.run(start, SUP_GENERATIONS)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    out = {"generations": SUP_GENERATIONS, "deadline_s": SUP_DEADLINE_S,
           "clean_launches": read_launches(), "clean_s": clean_s}
    with tempfile.TemporaryDirectory() as td:
        wf = build_checkpoint_path(torch, device=device)
        wf.run = _Faults(wf, {2: "transient", 3: "hang", 5: "oom"}, SUP_DEADLINE_S + 1.0)
        sup = RunSupervisor(WorkflowCheckpointer(td, every=10), deadline_s=SUP_DEADLINE_S,
                            backoff_s=0.01)
        reset_launches()
        t0 = time.perf_counter()
        state = sup.run(wf, wf.init(seed), SUP_GENERATIONS)
        torch.cuda.synchronize()
        out["supervised_s"] = time.perf_counter() - t0
        out["launches"] = read_launches()
        report = sup.report()
        want = {"retries": 2, "deadline_hits": 1, "restores": 1, "aborts": 0}
        got = {k: report["counters"][k] for k in want}
        if got != want or report["outcome"] != "recovered":
            raise AssertionError(f"path 32: supervisor {report['counters']} {report['outcome']}, "
                                 f"expected {want} and recovered")
        if out["launches"]["packed_dominance"] < SUP_GENERATIONS or \
                out["launches"]["partial_topk"] < SUP_GENERATIONS - 1:
            raise AssertionError(f"path 32: launches {out['launches']}")
        out["bit_for_bit"] = _states_exact(torch, "path 32: the supervised run with three faults "
                                           "against the clean run", state.algo, clean.algo)
        out["supervisor"] = report
        rr = run_report(wf, state)
        path = Path(out_dir) / "supervised_trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        trace = write_chrome_trace(str(path), workflow=wf, state=state)
        validate(report=rr, trace=trace, label="path 32's run_report and trace")
        markers = sorted(e["name"] for e in trace["traceEvents"] if e.get("cat") == "supervisor")
        out["trace_markers"] = markers
    # without faults, in turns with the same checkpointed run unsupervised:
    # what the supervisor's watchdog thread and ladder cost (both write a
    # snapshot every 10 generations)
    turns = []
    for name in ("checkpointed", "supervised", "supervised", "checkpointed"):
        with tempfile.TemporaryDirectory() as td:
            wf = build_checkpoint_path(torch, device=device)
            s0 = wf.step(wf.init(seed))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "checkpointed":
                wf.run(s0, SUP_GENERATIONS, checkpointer=WorkflowCheckpointer(td, every=10))
            else:
                RunSupervisor(WorkflowCheckpointer(td, every=10), deadline_s=SUP_DEADLINE_S).run(
                    wf, s0, SUP_GENERATIONS)
            torch.cuda.synchronize()
            turns.append({"side": name, "ms_per_generation":
                          (time.perf_counter() - t0) / SUP_GENERATIONS * 1e3})
    out["turns"] = turns
    for side in ("checkpointed", "supervised"):
        out[f"{side}_ms_per_generation"] = statistics.median(
            t["ms_per_generation"] for t in turns if t["side"] == side)
    print(f"[supervised nsga2] {json.dumps({k: v for k, v in out.items() if k != 'supervisor'})}",
          flush=True)
    return out


def phase_nccl_world(torch) -> dict:
    """The process layer on the card: a world of one over NCCL (a
    ``FileStore`` in a temporary directory: no network), an ``all_reduce``
    of a CUDA tensor (a sum over one rank equals it bit for bit), the
    store barrier and ``torch.distributed``'s own, then shutdown."""
    import tempfile

    from evox_tpu_torch.core import distributed as dist

    out = {}
    with tempfile.TemporaryDirectory() as td:
        if dist.is_dist_initialized():
            raise AssertionError("a process group exists before init_distributed")
        dist.init_distributed(f"file://{td}/store", num_processes=1, process_id=0,
                              backend="nccl", timeout_s=60)
        try:
            import torch.distributed as tdist

            out["backend"] = str(tdist.get_backend())
            out["world"] = [dist.process_id(), dist.process_count()]
            x = torch.arange(1024, dtype=torch.float32, device="cuda") * 0.5
            y = x.clone()
            tdist.all_reduce(y)
            torch.cuda.synchronize()
            compare_exact("NCCL all_reduce over a world of one", (y,), (x,))
            dist.process_barrier("nccl_world", timeout_s=30)
            tdist.barrier(device_ids=[0])
            out["all_reduce"] = "bit for bit"
        finally:
            dist.shutdown_distributed()
        out["initialized_after_shutdown"] = dist.is_dist_initialized()
    if out["backend"] != "nccl" or out["world"] != [0, 1] or out["initialized_after_shutdown"]:
        raise AssertionError(f"the NCCL world of one: {out}")
    print(f"[nccl world] {json.dumps(out)}", flush=True)
    return out


# ------------------------------------------ main paths 33-35: host and supervised problems


class EnvProbe:
    """A host vector env wrapper for path 33: the env's host time, its
    steps, and with ``record`` the reset seed and each step's observations
    and actions (for the CPU replay)."""

    def __init__(self, env, record: bool = False):
        self.env, self.record = env, record
        self.num_envs, self.obs_dim = env.num_envs, env.obs_dim
        self.steps, self.step_s = 0, 0.0
        self.seed, self.obs, self.actions, self._last = None, [], [], None

    def reset(self, seed):
        self._last = self.env.reset(seed)
        if self.record:
            self.seed, self.obs, self.actions = seed, [], []
        return self._last

    def step(self, actions):
        if self.record:
            import numpy as np

            self.obs.append(np.array(self._last))  # what these actions answer
            self.actions.append(np.array(actions))
        t0 = time.perf_counter()
        out = self.env.step(actions)
        self.step_s += time.perf_counter() - t0
        self.steps += 1
        self._last = out[0]
        return out


def replay_host_env(env, seed: int, actions: list, cap) -> "np.ndarray":
    """The returns of a fresh host env fed recorded actions, by a plain
    numpy loop with ``HostEnvProblem``'s semantics: the float32 sum of the
    rewards of the envs not done yet, until every env is done or the cap.
    Fails if the recorded episode stepped past that end or stopped short."""
    import numpy as np

    env.reset(seed)
    done = np.zeros((env.num_envs,), dtype=bool)
    total = np.zeros((env.num_envs,), dtype=np.float32)
    for t, a in enumerate(actions):
        if done.all() or (cap is not None and t >= cap):
            raise AssertionError(f"the recorded episode stepped past its end at step {t}")
        _, r, te, tr = env.step(a)
        total = total + np.where(done, np.float32(0.0), r)
        done = done | te | tr
    if not (done.all() or (cap is not None and len(actions) == cap)):
        raise AssertionError(f"the recorded episode stopped after {len(actions)} steps, "
                             "before its end")
    return total


def build_hostenv_path(torch, env_name: str = HENV_ENV, pop: int = HENV_POP,
                       steps: int = HENV_STEPS, device=None):
    """Main path 33 as a user builds it: ``StdWorkflow(OpenES(zeros(dim),
    pop), HostEnvProblem(flat_mlp_policy obs-16-act, NativeVectorEnv(env,
    pop, steps, min(8, cpus) threads), cap steps), opt_direction="max")``."""
    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import OpenES
    from evox_tpu_torch.problems.neuroevolution import (
        HostEnvProblem,
        NativeVectorEnv,
        flat_mlp_policy,
    )

    env = NativeVectorEnv(env_name, pop, max_steps=steps, num_threads=min(8, os.cpu_count()))
    apply, dim = flat_mlp_policy(env.obs_dim, HENV_HIDDEN, env.act_dim)
    problem = HostEnvProblem(apply, env, cap_episode_length=steps, device=device)
    algo = OpenES(torch.zeros(dim), pop, learning_rate=HENV_LR, noise_stdev=HENV_SIGMA,
                  device=device)
    return StdWorkflow(algo, problem, opt_direction="max", device=device)


def time_hostenv_run(torch, wf, state, gens: int, policy_gens: int = 1) -> tuple:
    """``wf.run`` for ``gens`` generations, timed, with the env's host time
    and the evaluations' host time caught by wrappers (host clock reads)
    and the copies' counts, bytes and device ms read from the problem's own
    ``host_link``; launch counts set to 0 before and read after (the path
    launches no kernel of the port). Then ``policy_gens`` more generations,
    outside the timed window, with CUDA events around each batched policy
    call for the policy's device span a step."""
    problem = wf.problem
    probe = EnvProbe(problem.env)
    raw_env, raw_policy, raw_eval = problem.env, problem.batched_policy, problem.evaluate
    cuda = wf.device.type == "cuda"
    spans, eval_s = [], []

    def policy(params, obs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = raw_policy(params, obs)
        stop.record()
        spans.append((start, stop))
        return out

    def evaluate(pstate, pop):
        t0 = time.perf_counter()
        out = raw_eval(pstate, pop)
        eval_s.append(time.perf_counter() - t0)
        return out

    link0 = problem.host_link.report()
    problem.env, problem.evaluate = probe, evaluate
    try:
        if cuda:
            torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = wf.run(state, gens)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        link1 = problem.host_link.report()
        timed_steps, timed_env_s = probe.steps, probe.step_s
        if cuda and policy_gens:
            problem.batched_policy = policy
            state = wf.run(state, policy_gens)
            torch.cuda.synchronize()
    finally:
        problem.env, problem.batched_policy, problem.evaluate = raw_env, raw_policy, raw_eval
    if any(launches.values()):
        raise AssertionError(f"kernel launches on a host env path: {launches}")
    steps = max(timed_steps, 1)
    link = {k: link1[k] - link0[k] for k in ("d2h", "h2d", "d2h_bytes", "h2d_bytes")}
    if cuda:
        link.update(d2h_ms=link1["d2h_ms"] - link0["d2h_ms"],
                    h2d_ms=link1["h2d_ms"] - link0["h2d_ms"])
    policy_steps = probe.steps - timed_steps
    policy_ms = (sum(a.elapsed_time(b) for a, b in spans) / policy_steps
                 if spans and policy_steps else None)
    timed_eval_s = sum(eval_s[:gens])
    out = {
        "generations": gens,
        "ms_per_generation": wall * 1e3 / gens,
        "evaluate_ms_per_generation": timed_eval_s * 1e3 / gens,
        "steps_per_generation": timed_steps / gens,
        "per_step_ms": {
            "loop": timed_eval_s * 1e3 / steps,
            "env_step": timed_env_s * 1e3 / steps,
            "rest_of_loop": (timed_eval_s - timed_env_s) * 1e3 / steps,
            # a copy each way a step, and the return once a generation
            "copy_d2h": link["d2h_ms"] / link["d2h"] if cuda and link["d2h"] else None,
            "copy_h2d": link["h2d_ms"] / link["h2d"] if cuda and link["h2d"] else None,
        },
        "host_link": link,
        "policy_pass": {"generations": policy_gens if spans else 0, "steps": policy_steps,
                        "policy_device_ms_per_step": policy_ms},
        "launches": launches,
    }
    return state, out


def phase_hostenv_path(torch, seed: int = SEED, device=None) -> dict:
    """Main path 33: OpenES on ``HostEnvProblem`` over the native engine's
    cartpole at pop 4096, 500 steps: init, ``HENV_WARM`` warm-up
    generations, ``HENV_GENERATIONS`` timed (ms a generation and the step's
    split: env, the copies as the problem's ``host_link`` counts them, the
    rest of the loop), one more generation for the policy's CUDA-event
    span, the center must move; one generation's returns on the card against a CPU replay of the
    card's recorded actions through a fresh engine with the same seed, bit
    for bit, and the card's policy outputs against the CPU's on the same
    observations; then a pendulum turn (pop 2048, 200 steps)."""
    import numpy as np

    from evox_tpu_torch.problems.neuroevolution import NativeVectorEnv

    dev = torch.device("cuda" if device is None else device)
    wf = build_hostenv_path(torch, device=dev)
    problem = wf.problem
    state = wf.init(seed)
    center0 = state.algo.center.clone()
    for _ in range(HENV_WARM):
        state = wf.step(state)
    state, timed = time_hostenv_run(torch, wf, state, HENV_GENERATIONS)
    moved = float((state.algo.center - center0).norm())
    if not (moved > 0 and math.isfinite(moved)):
        raise AssertionError(f"path 33: the center did not move (|delta| = {moved})")

    # one generation recorded on the card, replayed on the CPU
    cand = wf.sample(state)
    raw_env = problem.env
    probe = EnvProbe(raw_env, record=True)
    problem.env = probe
    try:
        fit, _ = problem.evaluate(state.prob, cand)
    finally:
        problem.env = raw_env
    fresh = NativeVectorEnv(HENV_ENV, HENV_POP, max_steps=HENV_STEPS,
                            num_threads=raw_env.num_threads)
    total = replay_host_env(fresh, probe.seed, probe.actions, problem.cap)
    replay = compare_exact("path 33: one generation's returns on the card against the CPU "
                           "replay of its actions", (fit.cpu(),), (torch.from_numpy(total),))
    # the card's policy against the CPU's on the observations the card saw
    cpu_policy = torch.func.vmap(problem.policy)
    cpu_cand = cand.cpu()
    got = torch.from_numpy(np.stack(probe.actions))
    want = torch.stack([cpu_policy(cpu_cand, torch.from_numpy(o)) for o in probe.obs])
    policy_cmp = compare("path 33: the card's policy outputs against the CPU's "
                         "(float32 sums in another order, tanh to 1 ulp)", got, want, 1e-5, 1e-6)
    out = {"env": HENV_ENV, "pop": HENV_POP, "steps": HENV_STEPS, "dim": int(cand.shape[1]),
           "threads": raw_env.num_threads, **timed,
           "replay_steps": len(probe.actions), "replay": replay, "policy_vs_cpu": policy_cmp,
           "mean_return": float(fit.mean())}
    print(f"[path 33] {json.dumps(out)}", flush=True)

    pop_p, steps_p, gens_p = HENV_PENDULUM
    wf_p = build_hostenv_path(torch, "pendulum", pop_p, steps_p, device=dev)
    state_p = wf_p.step(wf_p.init(seed))
    _, out["pendulum"] = time_hostenv_run(torch, wf_p, state_p, gens_p)
    out["pendulum"].update(pop=pop_p, steps=steps_p)
    print(f"[path 33 pendulum] {json.dumps(out['pendulum'])}", flush=True)
    out["native_vs_b1"] = phase_native_vs_b1(torch, seed, device=dev)
    return out


class StartFrom:
    """A native env whose every reset lands on given states (set after the
    engine's own reset); the observations are computed from them as the
    engine observes (float32 of the float64 cos, sin and speed)."""

    def __init__(self, env, state):
        self.env, self.state = env, state
        self.num_envs, self.obs_dim = env.num_envs, env.obs_dim

    def reset(self, seed):
        import numpy as np

        self.env.reset(seed)
        self.env.set_state(self.state)
        th, thdot = self.state[:, 0], self.state[:, 1]
        return np.stack([np.cos(th), np.sin(th), thdot], axis=1).astype(np.float32)

    def step(self, actions):
        return self.env.step(actions)


def phase_native_vs_b1(torch, seed: int = SEED, pop: int = NATIVE_B1_POP, steps: int = NATIVE_B1_T,
                       device=None) -> dict:
    """The native engine against B1 on one workload: pendulum, pop 65536 x
    1 episode, ``steps`` steps, the flat policy 3-16-1 on random genomes.
    B1 (``fused_rollout``, one launch) takes ``PolicyRolloutProblem``'s
    injected initial states (``_episode_states``, caught by a wrapper); the
    native engine is set to the same states with ``set_state`` and stepped
    through ``HostEnvProblem``. The returns agree within a tolerance: the
    engine integrates in float64, B1 in float32, and a trajectory near the
    pendulum's top separates (the gate reads the median and the 99th
    percentile of the relative difference). The ms of an evaluation of
    each, B1 by CUDA events."""
    import numpy as np

    from evox_tpu_torch.kernels import rollout as kr
    from evox_tpu_torch.problems.neuroevolution import (
        HostEnvProblem,
        NativeVectorEnv,
        PolicyRolloutProblem,
        flat_mlp_policy,
    )

    dev = torch.device("cuda" if device is None else device)
    soa = kr.pendulum_soa(max_steps=steps)
    apply, dim = flat_mlp_policy(3, 16, 1)
    b1 = PolicyRolloutProblem(apply, soa.base, num_episodes=1, stochastic_reset=False,
                              fused_env=soa, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 33)
    genomes = 0.3 * torch.randn((pop, dim), generator=g, device=dev)
    caught = []
    raw_states = b1._episode_states
    b1._episode_states = lambda s, env: caught.append(raw_states(s, env)) or caught[-1]
    pstate = b1.init(seed)
    reset_launches()
    f_b1, _ = b1.evaluate(pstate, genomes)
    launches = read_launches()
    b1._episode_states = raw_states
    want = {"fused_rollout": 1, "packed_dominance": 0, "partial_topk": 0, "fused_mlp_rollout": 0}
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"native against B1: launches {launches}, expected {want}")
    start = caught[0].to(torch.float64).cpu().numpy()  # (1, 2): one episode for all
    native = NativeVectorEnv("pendulum", pop, max_steps=steps, num_threads=min(8, os.cpu_count()))
    host = HostEnvProblem(apply, StartFrom(native, np.repeat(start, pop, axis=0)),
                          cap_episode_length=steps, device=dev)
    f_native, _ = host.evaluate(0, genomes)
    got, want_r = f_native.cpu().double(), f_b1.cpu().double()
    rel = ((got - want_r).abs() / want_r.abs().clamp_min(1.0))
    stats = {"median_rel": float(rel.median()), "p99_rel": float(rel.quantile(0.99)),
             "max_rel": float(rel.max()), "mean_b1": float(want_r.mean()),
             "mean_native": float(got.mean()), "tol_median": 1e-5, "tol_p99": 1e-4}
    if not (torch.isfinite(got).all() and stats["median_rel"] <= stats["tol_median"]
            and stats["p99_rel"] <= stats["tol_p99"]):
        raise AssertionError(f"the native engine disagrees with B1: {stats}")
    timing = {}
    if dev.type == "cuda":
        timing["b1_ms"] = _time_ms(lambda: b1.evaluate(pstate, genomes), 1, 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.evaluate(0, genomes)
        torch.cuda.synchronize()
        timing["native_ms"] = (time.perf_counter() - t0) * 1e3
    bound, by = bound_ms(*rollout_work(pop, 1, pop * steps, 3, 16, 1, "pendulum"))  # env-steps
    out = {"pop": pop, "steps": steps, "episodes": 1, "launches": launches, "returns": stats,
           "b1_bound_ms": bound, "b1_bound_by": by, **timing}
    print(f"[native vs B1] {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------- main path 34


def mnist_like(seed: int, rows: int = DS_ROWS + DS_VALID, features: int = DS_FEATURES,
               classes: int = DS_CLASSES, hidden: int = DS_TEACHER_HIDDEN) -> tuple:
    """An MNIST-shaped stream made from ``seed``: pixels uniform in [0, 1)
    (float32) and the labels of a fixed random teacher MLP (tanh, ``hidden``
    units), so the data has a signal to learn."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.random((rows, features), dtype=np.float32)
    w1 = (rng.standard_normal((features, hidden)) / np.sqrt(features)).astype(np.float32)
    w2 = rng.standard_normal((hidden, classes)).astype(np.float32)
    y = np.argmax(np.tanh(4.0 * (x - 0.5) @ w1) @ w2, axis=1).astype(np.int32)
    return x, y


def student(torch, features: int = DS_FEATURES, hidden: int = DS_HIDDEN,
            classes: int = DS_CLASSES) -> tuple:
    """The MLP ``features``-``hidden``-``classes`` over a flat genome:
    ``(loss, accuracy, dim)``, each a function of one genome and a batch
    ``{"x", "y", "i"}`` (cross-entropy, and the share classified right)."""
    n1 = features * hidden
    n2 = n1 + hidden
    n3 = n2 + hidden * classes
    dim = n3 + classes

    def logits(w, x):
        h = torch.tanh(x @ w[:n1].reshape(features, hidden) + w[n1:n2])
        return h @ w[n2:n3].reshape(hidden, classes) + w[n3:]

    def loss(w, batch):
        logp = torch.log_softmax(logits(w, batch["x"]), dim=-1)
        onehot = torch.nn.functional.one_hot(batch["y"].long(), classes).to(logp.dtype)
        return -(logp * onehot).sum(-1).mean()

    def accuracy(w, batch):
        return (logits(w, batch["x"]).argmax(-1) == batch["y"].long()).to(torch.float32).mean()

    return loss, accuracy, dim


def build_dataset_path(torch, seed: int = SEED, pop: int = DS_POP, rows: int = DS_ROWS,
                       valid: int = DS_VALID, device=None) -> tuple:
    """Main path 34 as a user builds it: ``StdWorkflow(OpenES(zeros(dim),
    pop, adam), DatasetProblem(InMemoryDataLoader(train, 256, seed), loss,
    valid_iterator=InMemoryDataLoader(held out, 2000, seed + 1)))``; returns
    ``(workflow, train data, accuracy)``."""
    import numpy as np

    from evox_tpu_torch import Monitor, StdWorkflow
    from evox_tpu_torch.algorithms.so.es import OpenES
    from evox_tpu_torch.problems.supervised import DatasetProblem, InMemoryDataLoader

    x, y = mnist_like(seed, rows + valid)
    train = {"x": x[:rows], "y": y[:rows], "i": np.arange(rows, dtype=np.int32)}
    held = {"x": x[rows:], "y": y[rows:], "i": np.arange(valid, dtype=np.int32)}
    loss, accuracy, dim = student(torch)
    problem = DatasetProblem(InMemoryDataLoader(train, DS_BATCH, seed), loss,
                             valid_iterator=InMemoryDataLoader(held, DS_VALID_BATCH, seed + 1),
                             device=device)

    class MeanLoss(Monitor):
        """Each generation's mean training loss, kept on the device."""

        def init(self, seed=None):
            return ()

        def hooks(self):
            return ("post_eval",)

        def post_eval(self, mstate, cand, fitness):
            return mstate + (fitness.mean(),)

    algo = OpenES(torch.zeros(dim), pop, learning_rate=DS_LR, noise_stdev=DS_SIGMA,
                  optimizer="adam", device=device)
    return StdWorkflow(algo, problem, monitors=[MeanLoss()], device=device), train, accuracy


def phase_dataset_path(torch, seed: int = SEED, device=None) -> dict:
    """Main path 34: init and one generation (generation 0), then ``run``
    for ``DS_GENERATIONS`` with the launch counts set to 0 just before and
    read just after (no kernel of the port runs); ms a generation, the
    batch copy's device ms (the problem's ``HostLink``), peak memory. Gates:
    every batch's row indices, as they reached the device, equal a CPU
    loader's with the same seed, and the last batch's rows equal the host
    data bit for bit; losses on the card against the CPU on the same
    genomes and batch; the mean training loss after the run below
    generation 0's; accuracy and loss on the held-out rows through
    ``StdWorkflow.validate`` with a metric view."""
    from evox_tpu_torch.problems.supervised import InMemoryDataLoader

    dev = torch.device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    wf, train, accuracy = build_dataset_path(torch, seed, device=dev)
    setup_s = time.perf_counter() - t0
    problem = wf.problem
    seen = []
    raw_to_device = problem._to_device
    problem._to_device = lambda batch: seen.append(raw_to_device(batch)) or seen[-1]
    state = wf.step(wf.init(seed))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    link0 = problem.host_link.report()
    reset_launches()
    t0 = time.perf_counter()
    state = wf.run(state, DS_GENERATIONS)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    link1 = problem.host_link.report()
    if any(launches.values()):
        raise AssertionError(f"kernel launches on path 34: {launches}")
    means = [float(m) for m in state.monitors[0]]
    if not all(math.isfinite(m) for m in means) or not means[-1] < means[0]:
        raise AssertionError(f"path 34: the mean training loss did not fall: {means}")

    loader = InMemoryDataLoader(train, DS_BATCH, seed)
    want_i = [torch.from_numpy(next(loader)["i"]) for _ in seen]
    indices = compare_exact(f"path 34: the row indices of {len(seen)} batches on the device "
                            "against a CPU loader's", [b["i"].cpu() for b in seen], want_i)
    last = seen[-1]
    rows = compare_exact("path 34: the last batch's rows on the device against the host data",
                         (last["x"].cpu(), last["y"].cpu()),
                         (torch.from_numpy(train["x"][last["i"].cpu().numpy()]),
                          torch.from_numpy(train["y"][last["i"].cpu().numpy()])))
    cand = wf.sample(state)[:DS_CHECK_ROWS]
    card = torch.func.vmap(problem.loss_func, in_dims=(0, None))(cand, last)
    cpu = torch.func.vmap(problem.loss_func, in_dims=(0, None))(
        cand.cpu(), {k: v.cpu() for k, v in last.items()})
    losses = compare("path 34: losses on the card against the CPU (float32 dot products of 784 "
                     "and 32 terms summed in another order)", card.cpu(), cpu, 1e-4, 1e-5)
    val_acc = wf.validate(state, problem=problem.valid(metric=accuracy))
    val_loss = wf.validate(state, problem=problem.valid())
    if not (val_acc.shape == (DS_POP,) and bool(((val_acc >= 0) & (val_acc <= 1)).all())
            and bool(torch.isfinite(val_loss).all())):
        raise AssertionError("path 34: validation out of range")
    copies = link1["h2d"] - link0["h2d"]
    out = {
        "pop": DS_POP, "dim": int(cand.shape[1]), "batch": DS_BATCH, "rows": DS_ROWS,
        "generations": DS_GENERATIONS, "setup_s": setup_s,
        "ms_per_generation": wall * 1e3 / DS_GENERATIONS,
        "forward_gflop_per_generation": 2.0 * DS_POP * DS_BATCH * (
            DS_FEATURES * DS_HIDDEN + DS_HIDDEN * DS_CLASSES) / 1e9,
        "batch_copies": copies,
        "batch_copy_ms_per_generation": (None if link1["h2d_ms"] is None
                                         else (link1["h2d_ms"] - link0["h2d_ms"]) / DS_GENERATIONS),
        "batch_bytes_per_generation": (link1["h2d_bytes"] - link0["h2d_bytes"]) / DS_GENERATIONS,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "mean_loss_first_last": [means[0], means[-1]],
        "indices": indices, "rows_bit_for_bit": rows, "card_vs_cpu": losses,
        "valid_accuracy_mean": float(val_acc.mean()), "valid_accuracy_max": float(val_acc.max()),
        "valid_loss_mean": float(val_loss.mean()), "launches": launches,
    }
    print(f"[path 34] {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------- main path 35


def farm_helpers():
    """``tests/_torch_farm_helpers.py`` (a gymnasium-API scalar cartpole,
    the flat policy 4-8-2 and a fault-injecting worker), imported by its own
    name from the checkout so spawned workers unpickle the same module."""
    path = str(ROOT / "tests")
    if path not in sys.path:
        sys.path.append(path)
    import _torch_farm_helpers

    return _torch_farm_helpers


def phase_farm_path(torch, seed: int = SEED, out_dir: str = "chiprun_out", device=None) -> dict:
    """Main path 35: the rollout farms on a gymnasium-API cartpole, pop
    1024, cap 200. ``HostRolloutFarm`` with 8 threads in both placements
    (the lockstep policy on the card), ``FARM_GENERATIONS`` timed;
    ``ProcessRolloutFarm`` with 4 spawned local workers, whose fitness must
    equal ``HostRolloutFarm(batch_policy=False)``'s with 4 workers bit for
    bit on the same injected seed, timed likewise, then 5 generations of
    OpenES through ``run_host_pipelined`` whose Chrome trace
    (``out_dir/farm_trace.json``) must hold the three ``farm/*`` counter
    tracks. A second farm of 4 (one worker that hard-exits on its first
    request): that generation bit for bit with the thread farm, the drop
    and the redispatch counted; then, with 3 alive under a floor of 4,
    ``FarmDegradedError``. Every spawned process is joined under a
    timeout."""
    import numpy as np

    from evox_tpu_torch import StdWorkflow
    from evox_tpu_torch.algorithms.so.es import OpenES
    from evox_tpu_torch.core.instrument import write_chrome_trace
    from evox_tpu_torch.problems.neuroevolution import (
        FarmDegradedError,
        HostRolloutFarm,
        ProcessRolloutFarm,
        spawn_local_workers,
    )
    from evox_tpu_torch.workflows.pipelined import run_host_pipelined

    helpers = farm_helpers()
    dev = torch.device("cuda" if device is None else device)
    kw = dict(num_workers=FARM_PROCS, cap_episode=FARM_CAP, host="127.0.0.1",
              request_timeout=60.0, heartbeat_timeout=10.0, retry_backoff=0.01)
    clean = ProcessRolloutFarm(helpers.flat_policy, helpers.ScalarCartPole, **kw)
    chaos = ProcessRolloutFarm(helpers.flat_policy, helpers.ScalarCartPole, **kw)
    t_spawn = time.perf_counter()
    procs = spawn_local_workers(clean.address, FARM_PROCS)
    procs.append(helpers.spawn_chaos_worker(chaos.address, mode="kill"))
    procs += spawn_local_workers(chaos.address, FARM_PROCS - 1)
    pop = (0.5 * np.random.default_rng(seed + 35).standard_normal((FARM_POP, helpers.DIM))
           ).astype(np.float32)
    out = {"pop": FARM_POP, "cap": FARM_CAP, "threads": FARM_THREADS, "processes": FARM_PROCS}

    def timed(farm):  # nothing compiles on the host side: no warm-up
        t0 = time.perf_counter()
        fits = [farm.evaluate(None, pop)[0] for _ in range(FARM_GENERATIONS)]
        return (time.perf_counter() - t0) * 1e3 / FARM_GENERATIONS, fits[-1]

    def twin(rng_seed):
        farm = HostRolloutFarm(helpers.flat_policy, helpers.ScalarCartPole,
                               num_workers=FARM_PROCS, batch_policy=False,
                               cap_episode=FARM_CAP, device="cpu")
        farm._seed_rng = np.random.default_rng(rng_seed)
        return farm

    try:
        reset_launches()
        for name, batch_policy in (("lockstep", True), ("per_worker", False)):
            farm = HostRolloutFarm(helpers.flat_policy, helpers.ScalarCartPole,
                                   num_workers=FARM_THREADS, batch_policy=batch_policy,
                                   cap_episode=FARM_CAP, device=dev if batch_policy else "cpu")
            ms, fit = timed(farm)
            out[f"thread_{name}"] = {"ms_per_generation": ms, "mean_return": float(fit.mean())}
        clean.bind(timeout=120.0)
        chaos.bind(timeout=120.0)
        out["spawn_to_bound_s"] = time.perf_counter() - t_spawn
        clean._seed_rng = np.random.default_rng(seed)
        f_proc, _ = clean.evaluate(None, pop)
        f_thread, _ = twin(seed).evaluate(None, pop)
        out["process_vs_thread"] = compare_exact(
            "path 35: the process farm's fitness against the thread farm's (batch_policy=False)",
            (torch.from_numpy(f_proc),), (torch.from_numpy(f_thread),))
        ms, fit = timed(clean)
        out["process"] = {"ms_per_generation": ms, "mean_return": float(fit.mean())}

        algo = OpenES(torch.zeros(helpers.DIM), FARM_POP, learning_rate=0.05, noise_stdev=0.1,
                      device=dev)
        wf = StdWorkflow(algo, clean, opt_direction="max", device=dev)
        best = []
        t0 = time.perf_counter()
        state = run_host_pipelined(wf, wf.init(seed), FARM_PIPELINED,
                                   on_generation=lambda g, s, f: best.append(float(f.max())))
        out["pipelined_ms_per_generation"] = (time.perf_counter() - t0) * 1e3 / FARM_PIPELINED
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        trace_path = Path(out_dir) / "farm_trace.json"
        tracks = clean.counter_tracks()
        write_chrome_trace(str(trace_path), extra_counters=tracks)
        counters = [e for e in json.loads(trace_path.read_text())["traceEvents"]
                    if e.get("ph") == "C" and e.get("name", "").startswith("farm/")]
        names = sorted({e["name"] for e in counters})
        if names != ["farm/slices_redispatched", "farm/workers_alive", "farm/workers_dropped"] \
                or int(state.generation) != FARM_PIPELINED or len(best) != FARM_PIPELINED:
            raise AssertionError(f"path 35: the pipelined run or its trace: {names}, "
                                 f"generation {state.generation}")
        out["trace"] = {"path": str(trace_path), "farm_tracks": names,
                        "samples": len(counters), "best": best}

        chaos._seed_rng = np.random.default_rng(seed + 1)
        f_chaos, _ = chaos.evaluate(None, pop)
        f_thread, _ = twin(seed + 1).evaluate(None, pop)
        out["killed_vs_thread"] = compare_exact(
            "path 35: with a worker killed mid-generation, the fitness against the thread farm's",
            (torch.from_numpy(f_chaos),), (torch.from_numpy(f_thread),))
        health = chaos.health_report()
        if not (health["workers_dropped"] == 1 and health["slices_redispatched"] >= 1
                and health["workers_alive"] == FARM_PROCS - 1):
            raise AssertionError(f"path 35: the killed worker's health report: {health}")
        out["health_after_kill"] = health
        chaos.min_workers = FARM_PROCS
        try:
            chaos.evaluate(None, pop)
        except FarmDegradedError as e:
            out["degraded"] = str(e)
        else:
            raise AssertionError("path 35: no FarmDegradedError below min_workers")
        launches = read_launches()
        if any(launches.values()):
            raise AssertionError(f"kernel launches on path 35: {launches}")
    finally:
        clean.shutdown()
        chaos.shutdown()
        codes = helpers.reap(procs, timeout=30.0)
    alive = [p.pid for p in procs if p.is_alive()]
    out["exit_codes"] = codes
    if alive or codes != [0] * FARM_PROCS + [1] + [0] * (FARM_PROCS - 1):
        raise AssertionError(f"path 35: workers left {alive}, exit codes {codes}")
    print(f"[path 35] {json.dumps(out)}", flush=True)
    return out


# ----------------------------------------------- main paths 36, 37 and 38


def elastic_factory(torch, device=None, guarded=False, flat=False):
    """``bench.py:1195``'s serving factory at this path's shapes: PSO (lb -5,
    ub 5) on Sphere in an ``ElasticWorkflow`` of the bucket's width, with a
    ``TelemetryMonitor(capacity=8)``; ``guarded`` wraps PSO in
    ``GuardedAlgorithm(stagnation_limit=3)``, and ``flat`` scores every
    candidate 0 (nothing improves: the guard's escalation signal)."""
    import numpy as np

    from evox_tpu_torch import GuardedAlgorithm
    from evox_tpu_torch.algorithms.so.pso import PSO
    from evox_tpu_torch.monitors import TelemetryMonitor
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows.elastic import ACTIVE_ROWS, ElasticWorkflow

    class FlatSphere(Sphere):
        def evaluate(self, state, pop):
            fit, state = super().evaluate(state, pop)
            return torch.zeros_like(fit), state

    def factory(shape):
        algo = PSO(-5.0 * torch.ones(shape.dim), 5.0 * torch.ones(shape.dim), pop_size=shape.pop,
                   device=device)
        if guarded:
            algo = GuardedAlgorithm(algo, stagnation_limit=3)
        return ElasticWorkflow(
            algo, FlatSphere() if flat else Sphere(), n_tenants=shape.width,
            hyperparams={ACTIVE_ROWS: np.full((shape.width,), shape.pop, np.int32)},
            monitors=(TelemetryMonitor(capacity=8, device=device),), device=device)

    return factory


def elastic_server(torch, cache, device=None, **kw):
    from evox_tpu_torch.workflows.elastic import BucketTable, ElasticServer

    return ElasticServer(elastic_factory(torch, device), table=BucketTable(
        pop_rungs=EL_RUNGS, width_rungs=(EL_WIDTH,)), cache=cache, width=EL_WIDTH,
        chunk=EL_CHUNK, **kw)


def elastic_trace() -> list:
    """The seeded churn trace: pops drawn from 200-1024 (every rung), each
    request living two chunks."""
    import numpy as np

    rng = np.random.RandomState(7)
    return [(int(rng.randint(EL_POP_LO, EL_POP_HI + 1)), 2 * EL_CHUNK)
            for _ in range(EL_REQUESTS)]


def _sync(torch, device):
    if device is None or str(device).startswith("cuda"):
        torch.cuda.synchronize()


def cold_start_child(mode: str, cache_dir: str, device=None) -> dict:
    """One fresh process's cold start: build the server (``prewarm`` finds
    the manifest and warms every listed bucket before serving; ``none``
    has no manifest), submit one request of pop ``EL_PADDED``, serve one round and
    fetch its generation. Seconds from this function's start (the
    interpreter and ``import torch`` come before it; the parent times the
    whole process)."""
    t0 = time.perf_counter()
    import torch

    from evox_tpu_torch.core.exec_cache import ExecutableCache
    from evox_tpu_torch.workflows.elastic import ElasticSpec

    cache = ExecutableCache(directory=cache_dir if mode == "prewarm" else None)
    srv = elastic_server(torch, cache, device=device)
    prewarmed = srv.prewarm()
    _sync(torch, device)
    t_ready = time.perf_counter()
    shape = srv.submit(ElasticSpec(seed=0, n_steps=EL_CHUNK, pop=EL_PADDED, dim=EL_DIM,
                                   tag="cold"))
    srv.serve(max_rounds=1)
    gen = int(srv._buckets[shape.key].queue.state.generation)
    t_first = time.perf_counter()
    return {"mode": mode, "generation": gen, "prewarmed": prewarmed,
            "server_ready_s": t_ready - t0, "submit_to_first_generation_s": t_first - t_ready,
            "to_first_generation_s": t_first - t0, "counters": dict(cache.counters)}


def _cold_start_round(mode: str, cache_dir: str) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--cold-start", mode,
                           cache_dir], capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cold start ({mode}) failed: {proc.stderr[-2000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["generation"] < 1:
        raise AssertionError(f"cold start ({mode}) fetched no generation: {child}")
    if mode == "prewarm" and (child["counters"]["misses"] or not child["prewarmed"]):
        raise AssertionError(f"the pre-warmed cold start warmed off the manifest: {child}")
    return {**child, "process_wall_s": wall}


def _tenant_leaves(torch, state, index: int) -> list:
    from evox_tpu_torch.core.members import take_state

    return [x for x in torch.utils._pytree.tree_leaves(take_state(state.tenants, index))
            if isinstance(x, torch.Tensor)]


def phase_elastic_path(torch, seed: int = SEED, device=None, cold_rounds: int = EL_COLD_ROUNDS
                       ) -> dict:
    """Main path 36, ``bench.py:1177-1400``'s ``serving_elastic`` leg at a
    size its users run: PSO on Sphere at d 64, bucket width 16, chunk 10,
    pop rungs 256, 512 and 1024, a seeded churn trace of 48 requests (pops
    200-1024, two chunks each). Warms the three buckets through a serving
    cache on disk (its manifest), then: sustained tenant-generations a
    second differenced over ``EL_PAIR`` serve rounds; (a) a padded tenant
    (``EL_PADDED`` = 700 of 1024 rows) against its ``solo_workflow`` run with the mask over
    ``EL_CHECK_GENERATIONS``; (b) a healthy tenant's telemetry ring and
    state, bit for bit, between two fleets whose other tenants (padding and
    filler neighbours) differ; (c) admissions into a warm bucket under a
    frozen cache and ``DispatchRecorder(strict_retrace=True)``, the ms of
    one; (d) a guarded tenant on a flat Sphere grown from the 256 to the
    512 bucket by ``PopAutoscaler``, journaled in both; the cold start of a
    fresh process with the manifest's pre-warm against without it, in
    ``cold_rounds`` interleaved rounds of subprocesses; ``run_report``'s
    ``serving`` section through ``tools/check_report.py``."""
    import tempfile

    import numpy as np

    from evox_tpu_torch import instrument, run_report
    from evox_tpu_torch.core.exec_cache import ExecutableCache
    from evox_tpu_torch.core.members import take_state
    from evox_tpu_torch.core.struct import named_leaves
    from evox_tpu_torch.workflows.elastic import (
        ACTIVE_ROWS, BucketShape, BucketTable, ElasticServer, ElasticSpec, PopAutoscaler)

    out = {"dim": EL_DIM, "width": EL_WIDTH, "chunk": EL_CHUNK, "rungs": list(EL_RUNGS),
           "requests": EL_REQUESTS}
    trace = elastic_trace()
    with tempfile.TemporaryDirectory() as td:
        cache_dir = os.path.join(td, "cache")
        cache = ExecutableCache(directory=cache_dir)
        srv = elastic_server(torch, cache, device=device)
        warm = {}
        for pop in EL_RUNGS:
            t0 = time.perf_counter()
            srv._get_bucket(BucketShape(pop, EL_DIM, EL_WIDTH))
            _sync(torch, device)
            warm[str(pop)] = (time.perf_counter() - t0) * 1e3
        out["bucket_build_and_warm_ms"] = warm
        out["warm_up_s"] = cache.report()["compile_s_paid"]
        if cache.counters["misses"] != 4 * len(EL_RUNGS):
            raise AssertionError(f"elastic: warming {len(EL_RUNGS)} buckets made "
                                 f"{cache.counters}")

        # sustained tenant-generations a second, differenced
        def timed(n):
            s = elastic_server(torch, cache, device=device)
            s.prewarm()
            for i, (pop, steps) in enumerate(trace):
                s.submit(ElasticSpec(seed=i, n_steps=steps, pop=pop, dim=EL_DIM, tag=f"churn{i}"))
            _sync(torch, device)
            t0 = time.perf_counter()
            s.serve(max_rounds=n)
            gens = sum(int(b.queue.state.generation) * b.shape.width for b in s._buckets.values()
                       if b.queue.state is not None)
            return time.perf_counter() - t0, gens, s

        runs = {}
        for n in EL_PAIR + EL_PAIR[::-1]:
            dt, gens, s = timed(n)
            runs.setdefault(n, []).append((dt, gens))
        (t1, g1), (t2, g2) = [min(runs[n]) for n in EL_PAIR]
        out["serve_rounds"] = list(EL_PAIR)
        out["tenant_generations"] = [g1, g2]
        out["round_s"] = {str(n): [r[0] for r in runs[n]] for n in EL_PAIR}
        out["sustained_tenant_generations_per_s"] = (g2 - g1) / (t2 - t1)
        results = s.serve()
        done = sorted(r["tag"] for r in results if r["status"] == "completed")
        if done != sorted(f"churn{i}" for i in range(EL_REQUESTS)):
            raise AssertionError(f"elastic: the trace did not complete: {len(done)} of "
                                 f"{EL_REQUESTS}")
        out["buckets"] = {k: {"admitted": b.queue.counters["admitted"], "fillers": b.fillers}
                          for k, b in s._buckets.items()}
        bucket_wf = s._buckets[f"pop{EL_RUNGS[-1]}_dim{EL_DIM}_w{EL_WIDTH}"].workflow
        report = run_report(bucket_wf, s._buckets[f"pop{EL_RUNGS[-1]}_dim{EL_DIM}_w{EL_WIDTH}"].queue.state)
        validate(report=report, label="elastic serving report")
        out["serving_counters"] = report["serving"]["cache"]["counters"]

        # (a) and (b): the padded-tenant law and the ring law
        wf = elastic_factory(torch, device)(BucketShape(EL_RUNGS[-1], EL_DIM, EL_WIDTH))
        seeds = list(range(seed, seed + EL_WIDTH))
        top = EL_RUNGS[-1]
        active = [EL_PADDED] + [top] * (EL_WIDTH - 1)
        fleet = wf.run(wf.init(seeds, hyperparams={ACTIVE_ROWS: np.asarray(active, np.int32)}),
                       EL_CHECK_GENERATIONS)
        solo_wf = wf.solo_workflow(hyperparams={ACTIVE_ROWS: np.int32(EL_PADDED)})
        solo = solo_wf.run(solo_wf.init(seeds[0]), EL_CHECK_GENERATIONS)
        solo_leaves = [x for x in torch.utils._pytree.tree_leaves(solo.algo)
                       if isinstance(x, torch.Tensor)]
        member = [x for x in torch.utils._pytree.tree_leaves(take_state(fleet.tenants, 0).algo)
                  if isinstance(x, torch.Tensor)]
        if len(member) != len(solo_leaves):
            raise AssertionError(f"elastic (a): {len(member)} member leaves against "
                                 f"{len(solo_leaves)} solo leaves")
        out["padded_vs_solo"] = {**compare_exact("elastic (a): padded tenant against its solo "
                                                 "run", member, solo_leaves),
                                 "padded_rows": EL_PADDED, "generations": EL_CHECK_GENERATIONS}
        other = [s + 1000 if i != 1 else s for i, s in enumerate(seeds)]
        active2 = [top, top] + [EL_PADDED // 2] * (EL_WIDTH - 2)
        fleet2 = wf.run(wf.init(other, hyperparams={ACTIVE_ROWS: np.asarray(active2, np.int32)}),
                        EL_CHECK_GENERATIONS)
        mon = wf.monitors[0]
        ring = mon.fingerprint(take_state(fleet.tenants, 1).monitors[0])
        ring2 = mon.fingerprint(take_state(fleet2.tenants, 1).monitors[0])
        if ring != ring2:
            raise AssertionError("elastic (b): a healthy tenant's ring moved with its neighbours")
        out["ring_law"] = compare_exact("elastic (b): tenant 1 among other neighbours",
                                        _tenant_leaves(torch, fleet, 1),
                                        _tenant_leaves(torch, fleet2, 1))
        solo_wf1 = wf.solo_workflow(hyperparams={ACTIVE_ROWS: np.int32(top)})
        solo_r1 = solo_wf1.run(solo_wf1.init(seeds[1]), EL_CHECK_GENERATIONS)
        out["ring_law"]["neighbour_ring_equals_solo"] = (
            mon.fingerprint(solo_r1.monitors[0]) == ring)
        # where a member's ring and state part from its solo run's, if they do
        part = {}
        for name, got_t, want_t in (("monitor", take_state(fleet.tenants, 1).monitors[0],
                                     solo_r1.monitors[0]),
                                    ("algo", take_state(fleet.tenants, 1).algo, solo_r1.algo)):
            for (path, x), (_, y) in zip(named_leaves(got_t), named_leaves(want_t)):
                if isinstance(x, torch.Tensor) and not torch.equal(x, y):
                    d = (x.double() - y.double()).abs()
                    finite = torch.isfinite(d)
                    part[name + path] = float(d[finite].max()) if bool(finite.any()) else None
        out["ring_law"]["neighbour_vs_solo_differing_leaves"] = part
        # every sum of the monitor's post_eval is in a fixed order: a member's
        # rings equal its solo run's under member_call on the card
        member_mon = take_state(fleet.tenants, 1).monitors[0]
        out["ring_law"]["rings_vs_solo"] = compare_exact(
            "elastic (b): tenant 1's rings against its solo run",
            [getattr(member_mon, k) for k in ("ring_mean", "ring_best", "ring_diversity")],
            [getattr(solo_r1.monitors[0], k) for k in ("ring_mean", "ring_best",
                                                       "ring_diversity")])
        if not out["ring_law"]["neighbour_ring_equals_solo"]:
            raise AssertionError(f"elastic (b): tenant 1's ring fingerprint differs from its solo "
                                 f"run's: {part}")
        del fleet, fleet2, solo, solo_r1

        # (c) warm admissions under a frozen cache and a strict recorder
        s = elastic_server(torch, cache, device=device)
        s.prewarm()
        for i in range(EL_WIDTH + EL_ADMISSIONS):
            s.submit(ElasticSpec(seed=500 + i, n_steps=EL_CHUNK, pop=EL_RUNGS[-2] + 1 + i, dim=EL_DIM,
                                 tag=f"adm{i}"))
        b = s._buckets[f"pop{EL_RUNGS[-1]}_dim{EL_DIM}_w{EL_WIDTH}"]
        q = b.queue
        q.start()
        cache.freeze()
        before = dict(cache.counters)
        rec = instrument(b.workflow, strict_retrace=True)
        admissions = []
        refill = q._refill

        def timed_refill(index):
            _sync(torch, device)
            before, t0 = q.counters["admitted"], time.perf_counter()
            refill(index)
            _sync(torch, device)
            if q.counters["admitted"] > before:
                admissions.append((time.perf_counter() - t0) * 1e3)

        q._refill = timed_refill
        s.serve()
        if len(admissions) < EL_ADMISSIONS or rec.summary()["retrace_flags"]:
            raise AssertionError(f"elastic (c): {len(admissions)} admissions, retraces "
                                 f"{rec.summary()['retrace_flags']}")
        # every chunk's run went through the frozen cache's lookup, all hits
        # (PSO declares no init hooks: an admission dispatches no peel)
        lookups = cache.counters["hits"] - before["hits"]
        if lookups != q.counters["chunks"] or cache.counters["misses"] != before["misses"]:
            raise AssertionError(f"elastic (c): {lookups} cache hits for {q.counters['chunks']} "
                                 f"chunks, counters {before} -> {cache.counters}")
        out["warm_admission_ms"] = statistics.median(admissions)
        out["warm_admissions"] = len(admissions)
        out["frozen_cache_counters"] = dict(cache.counters)

        # (d) growth into the next rung, journaled in both buckets
        jd = os.path.join(td, "journals")
        grow = ElasticServer(elastic_factory(torch, device, guarded=True, flat=True),
                             table=BucketTable(pop_rungs=EL_RUNGS, width_rungs=(EL_WIDTH,)),
                             width=EL_WIDTH, chunk=EL_CHUNK, journal_dir=jd,
                             checkpoint_dir=os.path.join(td, "ckpt"),
                             autoscaler=PopAutoscaler(max_grows=1))
        grow.submit(ElasticSpec(seed=1, n_steps=4 * EL_CHUNK, pop=EL_POP_LO, dim=EL_DIM,
                                tag="grow"))
        grown = grow.serve()
        ev = grow.autoscale_events
        src = f"pop{EL_RUNGS[0]}_dim{EL_DIM}_w{EL_WIDTH}"
        dst = f"pop{EL_RUNGS[1]}_dim{EL_DIM}_w{EL_WIDTH}"
        kinds_src = [r["kind"] for r in grow._buckets[src].queue.journal.records()]
        resumed = [r for r in grow._buckets[dst].queue.journal.records()
                   if r["kind"] == "submit" and r.get("resume_from")]
        final = {r["status"]: r for r in grown if r["tag"] == "grow"}
        if (len(ev) != 1 or (ev[0]["from"], ev[0]["to"]) != (src, dst)
                or "autoscale" not in kinds_src or len(resumed) != 1
                or final.get("completed", {}).get("bucket") != dst):
            raise AssertionError(f"elastic (d): growth {ev}, source kinds {kinds_src}, "
                                 f"target submits {resumed}, results {final}")
        out["autoscale"] = {"event": ev[0], "source_journal_autoscale": True,
                            "target_journal_resume": resumed[0]["resume_from"] is not None,
                            "completed_generations": final["completed"]["generations"]}

        # the cold start of a fresh process, pre-warm against none, in turns
        rounds = []
        for _ in range(cold_rounds):
            for mode in ("prewarm", "none"):
                rounds.append(_cold_start_round(mode, cache_dir))
        out["cold_start"] = rounds
        for mode in ("prewarm", "none") if rounds else ():
            mine = [r for r in rounds if r["mode"] == mode]
            out[f"cold_start_{mode}_process_s"] = statistics.median(r["process_wall_s"]
                                                                    for r in mine)
            out[f"cold_start_{mode}_submit_to_first_generation_s"] = statistics.median(
                r["submit_to_first_generation_s"] for r in mine)
    print(f"[elastic path] {json.dumps(out)}", flush=True)
    return out


def fleet_health_sweep(torch, policy, inject: bool, device=None, probe=None):
    """Path 28's fleet (64 CMA-ES tenants, pop 256, d 16, M1) with a
    ``TelemetryMonitor(capacity=8)``, 64 specs of ``FH_BUDGET`` generations
    through ``RunQueue(chunk=FH_CHUNK, health_policy=policy)``. With
    ``inject``: after chunk 1, NaN in slot R's and slot F's CMA-ES mean and
    in slot E's telemetry best (its state stays finite, its best can never
    improve again); after chunk 2, NaN in slot F's mean again. ``probe(q)``,
    when given, runs the second chunk in place of ``q.step_chunk`` and
    returns its result. Returns the queue and the seconds of each chunk."""
    from evox_tpu_torch import RunQueue, TenantSpec, VectorizedWorkflow
    from evox_tpu_torch.algorithms.so.es import CMAES
    from evox_tpu_torch.monitors import TelemetryMonitor
    from evox_tpu_torch.problems.numerical import Sphere

    fleet = VectorizedWorkflow(
        CMAES(torch.zeros(TEN_DIM), init_stdev=1.0, pop_size=TEN_POP, device=device), Sphere(),
        n_tenants=TEN_N, monitors=(TelemetryMonitor(capacity=8, device=device),), device=device)
    q = RunQueue(fleet, chunk=FH_CHUNK, health_policy=policy)
    for i in range(TEN_N):
        q.submit(TenantSpec(seed=i, n_steps=FH_BUDGET, tag=f"t{i}"))
    q.start()

    def poison(slot, field):
        solo = fleet.extract_tenant(q.state, slot)
        if field == "mean":
            solo = solo.replace(algo=solo.algo.replace(
                mean=torch.full_like(solo.algo.mean, float("nan"))))
        else:
            mon = solo.monitors[0]
            solo = solo.replace(monitors=(mon.replace(
                best_key=torch.full_like(mon.best_key, float("nan"))),))
        q.state = fleet.insert_tenant(q.state, slot, solo)

    chunks, k = [], 0
    while True:
        _sync(torch, device)
        t0 = time.perf_counter()
        more = probe(q) if probe is not None and k == 1 else q.step_chunk()
        _sync(torch, device)
        chunks.append(time.perf_counter() - t0)
        k += 1
        if inject and k == 1:
            poison(FH_SLOTS["restart"], "mean")
            poison(FH_SLOTS["freeze"], "mean")
            poison(FH_SLOTS["evict"], "telemetry")
        if inject and k == 2:
            poison(FH_SLOTS["freeze"], "mean")
        if not more:
            break
    return q, chunks


def phase_fleet_health_path(torch, profile: bool = False, device=None) -> dict:
    """Main path 37: path 28's fleet under ``RunQueue(chunk=10,
    health_policy=FleetHealthPolicy(on_nonfinite="restart",
    stagnation_limit=10, on_stagnation="evict", max_restarts_per_slot=1))``
    with a ``TelemetryMonitor(capacity=8)``, budgets of 40. NaN goes into
    three tenants (``fleet_health_sweep``): slot R restarts once and
    completes, slot E (its telemetry best NaN) is evicted for stagnation,
    slot F restarts and, poisoned again, escalates to freeze. Gate: the
    61 healthy tenants' final states and telemetry fingerprints equal,
    bit for bit, the same sweep's without the injection. Then the ms of a
    chunk with the policy against without it, in turns (policy, plain,
    plain, policy; the median of chunks 2-4), and with ``profile`` the DtoH
    copies of one chunk with and without the policy and of one fleet step
    with the frozen mask against one without."""
    from evox_tpu_torch.workflows.fleet_health import FleetHealthPolicy

    def policy():
        return FleetHealthPolicy(on_nonfinite="restart", stagnation_limit=FH_CHUNK,
                                 on_stagnation="evict", max_restarts_per_slot=1)

    out = {"tenants": TEN_N, "pop": TEN_POP, "dim": TEN_DIM, "chunk": FH_CHUNK,
           "budget": FH_BUDGET, "slots": dict(FH_SLOTS)}
    base, _ = fleet_health_sweep(torch, policy(), inject=False, device=device)
    q, _ = fleet_health_sweep(torch, policy(), inject=True, device=device)
    events = [(e["slot"], e["action"], e["reason"].split(":")[0], e["chunk"])
              for e in q.health_events]
    want = [(FH_SLOTS["restart"], "restart", "nonfinite_state", 2),
            (FH_SLOTS["freeze"], "restart", "nonfinite_state", 2),
            (FH_SLOTS["evict"], "evict", "stagnation", 2),
            (FH_SLOTS["freeze"], "freeze", "nonfinite_state", 3)]
    if sorted(events) != sorted(want):
        raise AssertionError(f"fleet health: actions {events}, expected {want}")
    status = {r["tag"]: r["status"] for r in q.results}
    if (status[f"t{FH_SLOTS['restart']}"], status[f"t{FH_SLOTS['evict']}"],
            status[f"t{FH_SLOTS['freeze']}"]) != ("completed", "evicted", "frozen"):
        raise AssertionError(f"fleet health: statuses {status}")
    out["events"] = q.health_events
    out["counters"] = dict(q.counters)
    healthy = [i for i in range(TEN_N) if i not in FH_SLOTS.values()]
    got = [x for i in healthy for x in _tenant_leaves(torch, q.state, i)]
    ref = [x for i in healthy for x in _tenant_leaves(torch, base.state, i)]
    out["isolation"] = compare_exact(f"fleet health: {len(healthy)} healthy tenants against the "
                                     "sweep without the injection", got, ref)
    prints = lambda qq: {r["tag"]: r.get("fingerprints") for r in qq.results}
    p_got, p_ref = prints(q), prints(base)
    if any(p_got[f"t{i}"] != p_ref[f"t{i}"] for i in healthy):
        raise AssertionError("fleet health: a healthy tenant's telemetry ring moved")
    out["isolation"]["healthy_tenants"] = len(healthy)
    del q, base, got, ref

    chunk_ms = {"policy": [], "plain": []}
    for mode in ("policy", "plain", "plain", "policy"):
        _, chunks = fleet_health_sweep(torch, policy() if mode == "policy" else None,
                                       inject=False, device=device)
        chunk_ms[mode].append(statistics.median(chunks[1:]) * 1e3)
    out["chunk_ms"] = chunk_ms
    out["chunk_ms_policy"] = statistics.median(chunk_ms["policy"])
    out["chunk_ms_plain"] = statistics.median(chunk_ms["plain"])
    # the policy's parts: a fleet step with one slot frozen (the select
    # runs) against one with none, in turns, and the signals' fetch alone
    from evox_tpu_torch.core.members import select_members
    from evox_tpu_torch.workflows.fleet_health import fleet_health_signals

    qq, _ = fleet_health_sweep(torch, policy(), inject=False, device=device)
    wf, plain = qq.workflow, qq.state
    masked = wf.set_frozen(plain, FH_SLOTS["freeze"], True)
    split = {"step_plain": [], "step_one_frozen": []}
    for key in ("step_plain", "step_one_frozen") * 2:
        st = plain if key == "step_plain" else masked
        _sync(torch, device)
        t0 = time.perf_counter()
        for _ in range(FH_CHUNK):
            wf.step(st)
        _sync(torch, device)
        split[key].append((time.perf_counter() - t0) / FH_CHUNK * 1e3)
    t0 = time.perf_counter()
    for _ in range(FH_CHUNK):
        select_members(masked.frozen, masked.frozen_rows, plain.tenants, plain.tenants)
    _sync(torch, device)
    split["select"] = (time.perf_counter() - t0) / FH_CHUNK * 1e3
    t0 = time.perf_counter()
    for _ in range(FH_CHUNK):
        fleet_health_signals(plain)
    split["signals"] = (time.perf_counter() - t0) / FH_CHUNK * 1e3
    out["policy_split_ms"] = split
    if profile:
        copies = {}
        for mode in ("policy", "plain"):
            def probe(q, mode=mode):
                box = {}
                copies[mode] = host_copies(torch, lambda: box.update(more=q.step_chunk()),
                                           FH_CHUNK)
                return box["more"]

            qq, _ = fleet_health_sweep(torch, policy() if mode == "policy" else None,
                                       inject=False, device=device, probe=probe)
        out["copies_per_generation"] = copies
        wf = qq.workflow
        state = wf.with_freeze_mask(qq.state)
        masked = wf.set_frozen(state, FH_SLOTS["freeze"], True)
        out["step_copies"] = {"masked": host_copies(torch, lambda: wf.step(masked), 1),
                              "unmasked": host_copies(torch, lambda: wf.step(
                                  state.replace(frozen=None)), 1)}
    print(f"[fleet health path] {json.dumps(out)}", flush=True)
    return out


def phase_multilevel_path(torch, seed: int = SEED, device=None) -> dict:
    """Main path 38: ``MultiLevelES(OpenES, PolicyRolloutProblem(pendulum,
    fused), fleet=False)`` with 4 groups of pop 16384 (path 1's 65536 in
    all), OpenES with adam, ``inner_steps`` 5, 4 outer generations,
    ``HyperSpec`` s on
    ``lr_scale`` and ``noise_stdev`` (attr, log). ``init`` evaluates
    nothing, so B1's launch count, read from its wrapper's counter, must be
    4 x 5 x 4 = 80. Gates: that count; every outer update replayed on the
    host from the phase scores the card reported (the JAX package's CEM
    formula in numpy float32, written out here) gives the card's outer mean
    and sigma bit for bit; every proposal inside its spec's bounds; the
    best fitness after each outer generation is, bit for bit, the best of
    every fitness the run's evaluations returned so far (read beside the
    drive), and never worse. Prints the ms of an outer generation and the
    share of it inside B1 (CUDA events around each launch)."""
    import numpy as np

    from evox_tpu_torch.algorithms.so.es import OpenES
    from evox_tpu_torch.kernels import rollout as kr
    from evox_tpu_torch.workflows.multilevel import HyperSpec, MultiLevelES

    wf, _ = build_b1_path(torch, kr.pendulum_soa(max_steps=200), pop=ML_POP, early_exit=False,
                          device=device)
    algo = OpenES(torch.zeros(wf.algorithm.dim), ML_POP, learning_rate=ML_LR,
                  noise_stdev=ML_SIGMA, optimizer=ML_OPTIMIZER, device=device)
    specs = [HyperSpec(name, init, sigma=0.3, lb=lb, ub=ub) for name, init, lb, ub in ML_SPECS]
    ml = MultiLevelES(algo, wf.problem, n_groups=ML_GROUPS, hyper_specs=specs,
                      inner_steps=ML_INNER, opt_direction="max", fleet=False, device=device)
    records = []
    update = ml._outer_update

    def recorded(state, gain):
        new = update(state, gain)
        records.append((state, new))
        return new

    ml._outer_update = recorded
    evaluate = ml.problem.evaluate
    seen = []  # each evaluation's best fitness, device scalars read after the run

    def recording_evaluate(pstate, pop):
        fitness, pstate = evaluate(pstate, pop)
        seen.append(fitness.max())
        return fitness, pstate

    ml.problem.evaluate = recording_evaluate
    b1 = kr.fused_rollout
    events = []

    def timed_b1(*a, **k):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = b1(*a, **k)
        stop.record()
        events.append((start, stop))
        return result

    state = ml.init(seed)
    torch.cuda.synchronize()
    reset_launches()
    # the wrapper counts its launches on the module's ``fused_rollout``,
    # which is this timing shim while it is in place
    timed_b1.launches = 0
    kr.fused_rollout = timed_b1
    outer_ms, bests, b1_ms, seen_at = [], [], [], []
    try:
        for _ in range(ML_OUTER):
            events.clear()
            t0 = time.perf_counter()
            state = ml.step(state)
            torch.cuda.synchronize()
            outer_ms.append((time.perf_counter() - t0) * 1e3)
            b1_ms.append(sum(a.elapsed_time(b) for a, b in events))
            bests.append(ml.best_fitness(state)[1])
            seen_at.append(len(seen))
            for spec in specs:
                v = ml.hyper_values(state)[spec.name]
                if not ((v >= spec.lb) & (v <= spec.ub)).all():
                    raise AssertionError(f"multi-level: {spec.name} proposals {v} outside bounds")
    finally:
        kr.fused_rollout = b1
        b1.launches += timed_b1.launches
        del ml.problem.evaluate
    launches = read_launches()["fused_rollout"]
    want = ML_GROUPS * ML_INNER * ML_OUTER
    if launches != want:
        raise AssertionError(f"multi-level: {launches} B1 launches, expected {want}")
    seen_best = [float(torch.stack(seen[:n]).max()) for n in seen_at]
    if bests != seen_best or any(b2 < b1_ for b1_, b2 in zip(bests, bests[1:])) or not all(
            math.isfinite(b) for b in bests):
        raise AssertionError(f"multi-level: the best {bests} is not the best of the fitness "
                             f"returned {seen_best}, or got worse")
    # the replay: gain = -score (exploit), the top half of the active groups,
    # the mean moved outer_lr of the way to theirs, sigma decayed
    mismatches = 0
    for old, new in records:
        active = old.active.cpu().numpy()
        gain = np.nan_to_num(-old.score.cpu().numpy(), nan=0.0, posinf=0.0, neginf=0.0)
        k = max(1, int(round(ml.elite_frac * int(active.sum()))))
        elite = np.argsort(-np.where(active, gain, -np.inf))[:k]
        lr = ml.outer_lr
        mean = ((1 - lr) * old.outer_mean.cpu().numpy()
                + lr * old.theta.cpu().numpy()[elite].mean(axis=0)).astype(np.float32)
        sigma = np.maximum(old.outer_sigma.cpu().numpy() * ml.sigma_decay,
                           1e-4).astype(np.float32)
        mismatches += int(not np.array_equal(mean, new.outer_mean.cpu().numpy()))
        mismatches += int(not np.array_equal(sigma, new.outer_sigma.cpu().numpy()))
    if mismatches or len(records) != ML_OUTER:
        raise AssertionError(f"multi-level: the host replay of the outer update differs "
                             f"({mismatches} of {2 * len(records)})")
    out = {"groups": ML_GROUPS, "pop_per_group": ML_POP, "inner_steps": ML_INNER,
           "outer_generations": ML_OUTER, "launches": {"fused_rollout": launches},
           "init_evaluates": False, "outer_ms": outer_ms,
           "outer_ms_steady": statistics.median(outer_ms[1:]),
           "b1_ms": b1_ms, "b1_share": sum(b1_ms[1:]) / sum(outer_ms[1:]),
           "best": bests, "best_is_best_seen": True, "replay_bit_for_bit": True,
           "score": state.score.cpu().tolist(),
           "outer_mean_external": ml.report(state)["outer_mean_external"],
           "hyper_values": {k: v.tolist() for k, v in ml.hyper_values(state).items()}}
    print(f"[multilevel path] {json.dumps(out)}", flush=True)
    return out


# ----------------------------------------------- main paths 39 and 40


def control_plane_specs(prefix: str, n: int | None = None) -> list:
    """``bench.py``'s ``_cpl_specs`` at path 36's widths: ``CP_SPECS`` specs
    (or ``n``) of pop ``CP_POP``, seeds 3000 up, budgets of 2, 3 and 4
    chunks (completions churn admissions through the window), one bucket
    shape, no deadline."""
    from evox_tpu_torch.workflows.elastic import ElasticSpec

    return [ElasticSpec(seed=3000 + i, n_steps=(2 + i % 3) * EL_CHUNK, pop=CP_POP, dim=EL_DIM,
                        tag=f"{prefix}{i:04d}") for i in range(CP_SPECS if n is None else n)]


def control_plane(torch, root, n_pods: int, device=None, metrics=None):
    from evox_tpu_torch.workflows.control_plane import ControlPlane
    from evox_tpu_torch.workflows.elastic import BucketTable

    return ControlPlane(elastic_factory(torch, device), str(root), n_pods=n_pods,
                        table=BucketTable(pop_rungs=EL_RUNGS, width_rungs=(EL_WIDTH,)),
                        width=EL_WIDTH, chunk=EL_CHUNK, metrics=metrics)


def completed_digest(results: list) -> dict:
    """tag -> (generations, telemetry fingerprints, monitor reports) of the
    completed entries: what a tenant's acknowledged budget produced,
    without its placement (pod, bucket, slot, checkpoint directory)."""
    return {r["tag"]: (r["generations"], tuple(r.get("fingerprints") or ()),
                       json.dumps(r.get("monitors"), sort_keys=True))
            for r in results if r["status"] == "completed"}


def phase_control_plane_path(torch, device=None) -> dict:
    """Main path 39, ``bench.py:1639-1795``'s workload 13 at path 36's
    widths: a ``ControlPlane`` of ``CP_PODS`` pods over path 36's factory
    (PSO on Sphere, d 64, width 16, chunk 10, ``TelemetryMonitor(8)``) with
    a ``FlightRecorder``, against the same plane with one pod, each given
    ``CP_SPECS`` specs of pop 256. Two warm rounds, ``pod00`` declared dead
    (the steal from its journals timed), one round to absorb the stolen
    work, then the serve rounds ``CP_PAIR`` differenced, ``CP_ROUNDS``
    times in turns with the one-pod plane: tenant-generations a second
    (the generations that each dispatch advanced its active, non-padding
    slots by, over the seconds) of both and their ratio, and each round's
    seconds inside the pods' serve rounds and in the gateway around them;
    the backlog must outlast the window. Gates: (a) the report
    passes ``tools/check_report.py`` and no spec is admitted twice; (b)
    the census shows ``pod00`` dead and at least one steal; (c) every
    tenant completed in both planes has equal results and telemetry
    fingerprints in both; (d) on a plane of ``CP_CRASH_SPECS`` specs the
    gateway is killed at its first ``steal_target_durable:`` point after
    ``mark_dead`` (``_CRASH_HOOK``), abandoned, ``ControlPlane.recover``ed
    from disk (timed) and served to the end: its completed results equal
    an uncrashed plane's, each spec admitted once."""
    import tempfile

    from evox_tpu_torch.core.instrument import run_report
    from evox_tpu_torch.workflows import control_plane as cp

    out = {"pods": CP_PODS, "specs": CP_SPECS, "pop": CP_POP, "dim": EL_DIM, "width": EL_WIDTH,
           "chunk": EL_CHUNK, "serve_rounds": list(CP_PAIR)}
    with tempfile.TemporaryDirectory() as td:
        ours = control_plane(torch, Path(td) / "plane", CP_PODS, device,
                             metrics=os.path.join(td, "metrics"))
        base = control_plane(torch, Path(td) / "solo", 1, device,
                             metrics=os.path.join(td, "metrics_solo"))
        t0 = time.perf_counter()
        for s in control_plane_specs("m"):
            ours.submit(s)
        out["submit_ms_per_spec"] = (time.perf_counter() - t0) / CP_SPECS * 1e3
        for s in control_plane_specs("s"):
            base.submit(s)
        for plane in (ours, base):
            plane.serve(max_rounds=2)
        _sync(torch, device)
        t0 = time.perf_counter()
        ours.mark_dead("pod00", reason="path 39 injection")
        out["steal_s"] = time.perf_counter() - t0
        out["stolen"] = ours.counters["stolen"]
        ours.serve(max_rounds=1)

        from evox_tpu_torch.core.executor import _IoLane
        from evox_tpu_torch.workflows.elastic import ElasticServer
        from evox_tpu_torch.workflows.tenancy import RunQueue

        def queue_sum(plane, get):
            return sum(get(b.queue) for pid in plane.live_pods()
                       for b in plane.pods[pid].server._buckets.values())

        def snapshot_busy_s(q):
            return q.executor.background_lane("fleet_snapshot").busy_s

        # inclusive seconds of each piece of a pod's serve round (``read`` is
        # the slots' generation read, where the host waits for the card)
        pieces = {"pod": (ElasticServer, "serve_round"), "sweep": (RunQueue, "_sweep"),
                  "read": (RunQueue, "_tenant_generations"), "retire": (RunQueue, "_retire"),
                  "refill": (RunQueue, "_refill"), "dispatch": (RunQueue, "_dispatch"),
                  "barrier": (RunQueue, "_barrier"), "snapshot_wait": (_IoLane, "submit")}

        def timed(plane, n):
            """(seconds, tenant-generations served, {piece: seconds}) of ``n``
            gateway rounds. The served count is each dispatch's generation
            delta over its active slots that are not width padding, read
            after the clock stops; ``snapshot_wait`` is the chunk barriers'
            wait for the previous fleet snapshot, ``snapshot_busy`` the
            snapshot lanes' own work (on their threads), ``retirements``
            the tenants retired (each closed out with its checkpoint and
            its slot refilled)."""
            dispatches = []
            spent = dict.fromkeys([*pieces, "snapshot_busy", "retirements"], 0.0)
            originals = {name: getattr(cls, attr) for name, (cls, attr) in pieces.items()}

            def timer(name):
                fn = originals[name]

                def wrapped(obj, *args, **kwargs):
                    t = time.perf_counter()
                    try:
                        return fn(obj, *args, **kwargs)
                    finally:
                        if name != "snapshot_wait" or obj.name == "fleet_snapshot":
                            spent[name] += time.perf_counter() - t
                return wrapped

            timers = {name: timer(name) for name in pieces}
            timed_dispatch = timers["dispatch"]

            def counted_dispatch(q, k):
                real = [i for i, sl in enumerate(q.slots) if sl is not None and sl.active
                        and not str(sl.spec.tag).startswith("_pad_")]
                before = q.state.tenants.generation.clone()
                timed_dispatch(q, k)
                dispatches.append((before, q.state.tenants.generation.clone(), real))

            timers["dispatch"] = counted_dispatch
            busy0 = queue_sum(plane, snapshot_busy_s)
            retired0 = queue_sum(plane, lambda q: q.counters["retired"])
            for name, (cls, attr) in pieces.items():
                setattr(cls, attr, timers[name])
            try:
                _sync(torch, device)
                t0 = time.perf_counter()
                for _ in range(n):
                    plane.serve_round()
                for pid in plane.live_pods():
                    for b in plane.pods[pid].server._buckets.values():
                        if b.queue.state is not None:
                            int(b.queue.state.generation)
                _sync(torch, device)
                wall = time.perf_counter() - t0
            finally:
                for name, (cls, attr) in pieces.items():
                    setattr(cls, attr, originals[name])
            spent["snapshot_busy"] = queue_sum(plane, snapshot_busy_s) - busy0
            spent["retirements"] = queue_sum(plane, lambda q: q.counters["retired"]) - retired0
            served = sum(int((after - before)[real].sum()) for before, after, real in dispatches)
            return wall, served, spent

        live = len(ours.live_pods())
        rates = {"ours": [], "single_pod": [], "ratio": [], "served_per_round": [],
                 "single_pod_served_per_round": [], "split_s_per_round": [],
                 "single_pod_split_s_per_round": []}
        for _ in range(CP_ROUNDS):
            for name, prefix, plane in (("ours", "", ours), ("single_pod", "single_pod_", base)):
                (t_lo, g_lo, s_lo), (t_hi, g_hi, s_hi) = timed(plane, CP_PAIR[0]), timed(
                    plane, CP_PAIR[1])
                rounds = CP_PAIR[1] - CP_PAIR[0]
                slope, served = (t_hi - t_lo) / rounds, (g_hi - g_lo) / rounds
                split = {k: (s_hi[k] - s_lo[k]) / rounds for k in s_hi}
                split["gateway"] = slope - split["pod"]
                rates[name].append(served / slope)
                rates[prefix + "served_per_round"].append(served)
                rates[prefix + "split_s_per_round"].append(split)
            rates["ratio"].append(rates["ours"][-1] / rates["single_pod"][-1])
        if not (ours.has_work() and base.has_work()):
            raise AssertionError("path 39: the backlog drained inside the measured window")
        out["live_pods"] = live
        out["full_round_tenant_generations"] = EL_CHUNK * EL_WIDTH * live
        out["round_rates"] = rates
        out["tenant_generations_per_s"] = statistics.median(rates["ours"])
        out["single_pod_tenant_generations_per_s"] = statistics.median(rates["single_pod"])
        out["ratio"] = statistics.median(rates["ratio"])
        # (a) and (b)
        report = run_report(control_plane=ours)
        validate(report=report, label="path 39's control_plane report")
        rep = report["control_plane"]
        if rep["exactly_once"]["duplicate_admissions"]:
            raise AssertionError(f"path 39 (a): duplicate admissions "
                                 f"{rep['exactly_once']['duplicate_admissions']}")
        if rep["pods"]["dead"] != ["pod00"] or rep["tenants"]["stolen"] < 1:
            raise AssertionError(f"path 39 (b): census {rep['pods']}, {rep['tenants']}")
        out["census"] = rep["pods"]
        out["tenants"] = rep["tenants"]
        out["audited_tags"] = rep["exactly_once"]["audited_tags"]
        out["slo"] = rep.get("slo")
        # (c) placement independence: both planes' tags carry one prefix each
        mine = {t[1:]: v for t, v in completed_digest(ours.results()).items()}
        theirs = {t[1:]: v for t, v in completed_digest(base.results()).items()}
        both = sorted(set(mine) & set(theirs))
        differ = [t for t in both if mine[t] != theirs[t]]
        if not both or differ:
            raise AssertionError(f"path 39 (c): {len(differ)} of {len(both)} tenants completed "
                                 f"in both planes differ: {differ[:5]}")
        out["completed_in_both"] = len(both)
        ours.close()
        base.close()

        # (d) the gateway killed mid-steal, recovered from disk
        class Killed(BaseException):
            pass

        def drive(plane, crash):
            # one round: pod00's tenants (every third spec, budgets of two
            # chunks) are all still running when it dies
            for s in control_plane_specs("k", CP_CRASH_SPECS):
                plane.submit(s)
            plane.serve(max_rounds=1)
            if not crash:
                plane.mark_dead("pod00", reason="path 39 (d)")
                return plane
            fired = []

            def hook(point):
                if point.startswith("steal_target_durable:"):
                    fired.append(point)
                    raise Killed(point)

            cp._CRASH_HOOK = hook
            try:
                plane.mark_dead("pod00", reason="path 39 (d)")
            except Killed:
                pass
            finally:
                cp._CRASH_HOOK = None
            if len(fired) != 1:
                raise AssertionError(f"path 39 (d): the crash hook fired {len(fired)} times")
            return plane  # abandoned: only its lanes are joined, at the end

        ref = drive(control_plane(torch, Path(td) / "ref", CP_PODS, device), crash=False)
        ref_done = completed_digest(ref.serve())
        ref.close()
        crashed = drive(control_plane(torch, Path(td) / "crash", CP_PODS, device), crash=True)
        _sync(torch, device)
        t0 = time.perf_counter()
        from evox_tpu_torch.workflows.elastic import BucketTable

        rec = cp.ControlPlane.recover(elastic_factory(torch, device), str(Path(td) / "crash"),
                                      table=BucketTable(pop_rungs=EL_RUNGS,
                                                        width_rungs=(EL_WIDTH,)),
                                      width=EL_WIDTH, chunk=EL_CHUNK)
        _sync(torch, device)
        out["recover_s"] = time.perf_counter() - t0
        done = completed_digest(rec.serve())
        rrep = rec.report()
        tags = sorted(f"k{i:04d}" for i in range(CP_CRASH_SPECS))
        if (sorted(done) != tags or done != ref_done
                or rrep["exactly_once"]["duplicate_admissions"]
                or rrep["tenants"]["steal_dedup"] < 1):
            raise AssertionError(
                f"path 39 (d): {len(done)} of {CP_CRASH_SPECS} completed, "
                f"{sum(done.get(t) != ref_done.get(t) for t in tags)} differ from the uncrashed "
                f"plane, duplicates {rrep['exactly_once']['duplicate_admissions']}, dedup "
                f"{rrep['tenants']['steal_dedup']}")
        out["mid_steal_crash"] = {"specs": CP_CRASH_SPECS, "completed_equal": len(done),
                                  "steal_dedup": rrep["tenants"]["steal_dedup"],
                                  "recoveries": rrep["ledger"]["recoveries"]}
        rec.close()
        crashed.close()  # its threads joined before the directory goes
    print(f"[control plane path] {json.dumps(out)}", flush=True)
    return out


def phase_pod_supervised_nsga2(torch, seed: int = SEED, device=None) -> dict:
    """Main path 40: path 2 (NSGA-II on LSMOP1, pop 10000, d 300, m 3,
    ``use_kernel=True``) under ``PodSupervisor`` in a world of one over NCCL
    (a ``FileStore`` in a temporary directory, as ``phase_nccl_world``).
    (1) ``RunSupervisor(WorkflowCheckpointer(every=10)).run(wf, state, 30,
    pod_supervisor=)`` against a plain ``run`` of 30, bit for bit, with one
    B3 and one B4 launch a generation in both (B4 from the second); (2) a
    supervised call sleeping past a 1 s deadline raised as
    ``hung_collective``, then the next chunk (generations 0-10 through the
    executor) equal to the plain run's; (3) ``request_drain`` while the
    chunk to generation 10 runs: the chunk finishes, the barrier checkpoint
    is fsynced and ``pod_drain`` journaled (seconds from the request to the
    return), ``resume_from_barrier`` run to 30 equals the plain run; (4)
    the heartbeat advanced, ``run_report``'s ``pod_supervisor`` section and
    the trace's ``supervisor:pod:*`` markers through
    ``tools/check_report.py``; ms a generation pod-supervised (watchdog,
    rendezvous, a snapshot every 10) against the same run checkpointed
    unsupervised and against bare, in turns."""
    import tempfile

    from evox_tpu_torch.core import distributed as dist
    from evox_tpu_torch.core.executor import GenerationExecutor
    from evox_tpu_torch.core.instrument import run_report, write_chrome_trace
    from evox_tpu_torch.core.pod_supervisor import (HUNG_COLLECTIVE, PodFailureError,
                                                    PodSupervisor)
    from evox_tpu_torch.workflows.checkpoint import WorkflowCheckpointer
    from evox_tpu_torch.workflows.journal import RunJournal
    from evox_tpu_torch.workflows.supervisor import RunSupervisor

    out = {"generations": POD_GENERATIONS, "every": POD_EVERY, "deadline_s": POD_DEADLINE_S}
    on_card = device is None or str(device).startswith("cuda")
    with tempfile.TemporaryDirectory() as td:
        dist.init_distributed(f"file://{td}/store", num_processes=1, process_id=0,
                              backend="nccl" if on_card else "gloo", timeout_s=60)
        try:
            import torch.distributed as tdist

            out["backend"] = str(tdist.get_backend())
            wf = build_checkpoint_path(torch, device=device)
            start = wf.init(seed)
            reset_launches()
            plain10 = wf.run(start, POD_DRAIN_AT)
            plain = wf.run(plain10, POD_GENERATIONS - POD_DRAIN_AT)
            _sync(torch, device)
            out["plain_launches"] = read_launches()
            # (1) pod-supervised against plain
            sup = PodSupervisor(deadline_s=60.0, heartbeat_interval_s=0.1,
                                journal=os.path.join(td, "journal")).start()
            reset_launches()
            state = RunSupervisor(WorkflowCheckpointer(os.path.join(td, "ck1"), every=POD_EVERY)
                                  ).run(wf, start, POD_GENERATIONS, pod_supervisor=sup)
            _sync(torch, device)
            out["launches"] = read_launches()
            want = {"packed_dominance": POD_GENERATIONS, "partial_topk": POD_GENERATIONS - 1}
            for side in ("plain_launches", "launches"):
                got = {k: out[side][k] for k in want}
                if got != want:
                    raise AssertionError(f"path 40: {side} {out[side]}, expected {want}")
            out["supervised_vs_plain"] = _states_exact(torch, "path 40 (1): pod-supervised "
                                                       "against plain", state.algo, plain.algo)
            if wf._pod_supervisor is not sup or sup.report()["outcome"] != "clean":
                raise AssertionError(f"path 40 (1): {sup.report()}")
            # (2) a hung call, classified, then the next chunk
            hung = PodSupervisor(deadline_s=POD_DEADLINE_S, heartbeat_interval_s=0.1).start()
            t0 = time.perf_counter()
            try:
                hung.supervised(lambda: time.sleep(POD_HANG_S), entry="chunk")
            except PodFailureError as e:
                out["hung"] = {"classification": e.classification,
                               "detect_s": e.post_mortem["detect_s"],
                               "raised_after_s": time.perf_counter() - t0}
            else:
                raise AssertionError("path 40 (2): the hung call returned")
            if out["hung"]["classification"] != HUNG_COLLECTIVE:
                raise AssertionError(f"path 40 (2): {out['hung']}")
            nxt = GenerationExecutor(pod_supervisor=hung).run_fused(wf, start, POD_DRAIN_AT)
            _sync(torch, device)
            _states_exact(torch, "path 40 (2): the chunk after the deadline hit", nxt.algo,
                          plain10.algo)
            hung.stop()
            # (3) the drain at generation 10, resumed from the barrier
            drain = PodSupervisor(deadline_s=60.0, heartbeat_interval_s=0.1,
                                  journal=os.path.join(td, "journal_drain")).start()
            orig, marks = wf.run, {}

            def run(st, n):
                res = orig(st, n)
                if "request" not in marks:
                    marks["request"] = time.perf_counter()
                    drain.request_drain("path 40")
                return res

            wf.run = run
            ck3 = os.path.join(td, "ck3")
            try:
                drained = RunSupervisor(WorkflowCheckpointer(ck3, every=POD_EVERY)).run(
                    wf, start, POD_GENERATIONS, pod_supervisor=drain)
            finally:
                wf.run = orig
            out["drain_s"] = time.perf_counter() - marks["request"]
            kinds = [r["kind"] for r in RunJournal(os.path.join(td, "journal_drain")).records()]
            if int(drained.generation) != POD_DRAIN_AT or "pod_drain" not in kinds:
                raise AssertionError(f"path 40 (3): drained at {int(drained.generation)}, "
                                     f"journal {kinds}")
            resumed = drain.resume_from_barrier(wf, ck3, expect_like=start)
            final = wf.run(resumed, POD_GENERATIONS - int(resumed.generation))
            _sync(torch, device)
            out["drain_resume_vs_plain"] = _states_exact(
                torch, "path 40 (3): drained, resumed from the barrier", final.algo, plain.algo)
            out["drain_journal"] = kinds
            drain.stop()
            # (4) the heartbeat, the report and the trace
            if sup.counters["heartbeats"] < 2:
                raise AssertionError(f"path 40 (4): heartbeats {sup.counters}")
            out["heartbeats"] = sup.counters["heartbeats"]
            wf._pod_supervisor = hung  # the failed pod: a census, a failure, the markers
            report = run_report(wf, state)
            trace = write_chrome_trace(os.path.join(td, "pod_supervisor_trace.json"),
                                       workflow=wf, state=state)
            validate(report=report, trace=trace, label="path 40's pod_supervisor report and trace")
            markers = sorted({e["name"] for e in trace["traceEvents"]
                              if e.get("name", "").startswith("supervisor:pod:")})
            if "supervisor:pod:failure" not in markers:
                raise AssertionError(f"path 40 (4): markers {markers}")
            out["trace_markers"] = markers
            out["report_outcome"] = report["pod_supervisor"]["outcome"]
            sup.stop()
            # ms a generation, in turns: pod-supervised (watchdog, rendezvous,
            # a snapshot every 10), the same run checkpointed every 10 without
            # a supervisor (the snapshots' share), and bare
            s0 = wf.step(start)
            turns = []
            for side in ("bare", "checkpointed", "pod", "pod", "checkpointed", "bare"):
                pod = PodSupervisor(deadline_s=60.0, heartbeat_interval_s=0.1).start()
                ck = WorkflowCheckpointer(os.path.join(td, f"t{len(turns)}"), every=POD_EVERY)
                _sync(torch, device)
                t0 = time.perf_counter()
                if side == "bare":
                    wf.run(s0, POD_GENERATIONS)
                elif side == "checkpointed":
                    wf.run(s0, POD_GENERATIONS, checkpointer=ck)
                else:
                    RunSupervisor(ck).run(wf, s0, POD_GENERATIONS, pod_supervisor=pod)
                _sync(torch, device)
                turns.append({"side": side, "ms_per_generation":
                              (time.perf_counter() - t0) / POD_GENERATIONS * 1e3})
                pod.stop()
            out["turns"] = turns
            for side in ("bare", "checkpointed", "pod"):
                out[f"{side}_ms_per_generation"] = statistics.median(
                    t["ms_per_generation"] for t in turns if t["side"] == side)
        finally:
            dist.shutdown_distributed()
    print(f"[pod supervised nsga2] {json.dumps(out)}", flush=True)
    return out


def monitor_callers(name: str, paths: dict) -> list:
    """Each call site of B3 or B4 on the main paths, with its shape and its
    launches in that path's run."""
    if name == "packed_dominance":
        arch = paths["monitor_archive"]
        nsga3 = paths["nsga3"]
        family = paths["mo_family"]
        gde3, ind, maf = paths["gde3"], paths["indicator_family"], paths["maf"]
        imm = paths["immoea"]
        b3 = {key: nsga3["packed_dominance"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                              "max_abs_err")}
        return [{"caller": "non_dominated_sort in NSGA-II's tell (path 2)", "n": 2 * NSGA2_POP,
                 "m": LSMOP_M, "launches": paths["nsga2"]["launches"][name]},
                {"caller": "EvalMonitor Pareto archive (two updates)", "n": arch["n"], "m": arch["m"],
                 "launches": arch["launches"][name], "ms_per_update": arch["ms_per_update"],
                 **arch["packed_dominance"]},
                {"caller": "non_dominated_sort(until=k) in NSGA-III's select (path 8)",
                 "n": nsga3["merged_n"], "m": MO_M, "launches": nsga3["launches"][name], **b3},
                *({"caller": f"{algo}'s tell (the MO family phase)", "n": family[algo]["n"], "m": MO_M,
                   "launches": family[algo]["launches"][name]}
                  for algo in ("MOEADM2M", "TDEA", "EAGMOEAD")),
                {"caller": "DTLZ7.pf() (the DTLZ phase)", "n": paths["dtlz"]["DTLZ7_pf"]["n"],
                 "m": MO_M, "launches": paths["dtlz"]["DTLZ7_pf"]["launches"]},
                {"caller": "non_dominate in GDE3's tell (path 10)", "n": gde3["merged_n"], "m": LSMOP_M,
                 "launches": gde3["launches"][name],
                 **{key: gde3["packed_dominance"][key] for key in ("ms", "plain_ms", "bound_ms",
                                                                   "bound_by", "max_abs_err")}},
                *({"caller": caller, "n": n, "m": m, "launches": ind[algo]["launches"][name]}
                  for algo, caller, n, m in (
                      ("HypE", "HypE's tell (the indicator family phase)", 2 * MO_FAMILY_POP, MO_M),
                      ("KnEA", "KnEA's tell (the indicator family phase)", 2 * MO_FAMILY_POP, MO_M),
                      ("BiGE", "BiGE's mating bi-goals, merged objectives and cut front's "
                               "bi-goals (the indicator family phase)",
                       [MO_FAMILY_POP, 2 * MO_FAMILY_POP, 2 * MO_FAMILY_POP], [2, MO_M, 2]),
                      ("BCEIBEA", "BCE-IBEA's PC selection, until=1, even generations (the "
                                  "indicator family phase)", 3 * MO_FAMILY_POP, MO_M))),
                *({"caller": f"MaF11.pf() at m {m} (the MaF phase)", "n": maf[f"MaF11_pf_m{m}"]["n"],
                   "m": m, "launches": maf[f"MaF11_pf_m{m}"]["launches"]} for m in (3, 5)),
                {"caller": "NSGA-II under WorkflowCheckpointer, straight run from init (path 18)",
                 "n": [NSGA2_POP, 2 * NSGA2_POP], "m": LSMOP_M,
                 "launches": paths["checkpoint"]["launches"][name]},
                {"caller": "non_dominate in IM-MOEA's tell (path 20)", "n": imm["merged_n"],
                 "m": MO_M, "launches": imm["launches"][name],
                 **{key: imm["packed_dominance"][key] for key in ("ms", "plain_ms", "bound_ms",
                                                                  "bound_by", "max_abs_err")}},
                {"caller": "non_dominated_sort in NSGA-II's tell, instrumented with "
                           "analyze=True (path 22)", "n": 2 * NSGA2_POP, "m": LSMOP_M,
                 "launches": paths["instrumented_nsga2"]["launches"][name]},
                {"caller": "non_dominated_sort in NSGA-II's tell under RunSupervisor and "
                           "PodSupervisor, straight run from init (path 40)",
                 "n": [NSGA2_POP, 2 * NSGA2_POP], "m": LSMOP_M,
                 "launches": paths["pod_supervised_nsga2"]["launches"][name]},
                {"caller": "LineageMonitor's rank-0 front in post_eval, NSGA-II on LSMOP1 "
                           "(path 27), one more launch a generation than its twin",
                 "n": NSGA2_POP, "m": LSMOP_M, "launches": paths["lineage"]["launches"],
                 "b3_launches_a_turn": paths["lineage"]["nsga2"]["b3_launches"]}]
    from evox_tpu_torch.algorithms.so.de.shade import pbest_k

    mon = paths["cso_monitored"]
    ars = paths["es_family"]["ARS"]
    shade = paths["shade"]
    jade = paths["de_family"]["JaDE"]
    return [{"caller": "rank_crowding_truncate in NSGA-II's tell (path 2)", "n": 2 * NSGA2_POP,
             "k": NSGA2_POP, "launches": paths["nsga2"]["launches"][name]},
            {"caller": "EvalMonitor elite (path 4, monitored run)",
             "n": CSO_POP // 2 + MONITOR_TOPK, "k": MONITOR_TOPK,
             "launches": mon["launches"][name], "shapes": mon["topk_at_monitor_shapes"]},
            {"caller": "ARS's tell (the ES family phase)", "n": ars["topk"]["n"],
             "k": ars["topk"]["k"], "launches": ars["tell_topk_launches"], "shapes": [ars["topk"]]},
            {"caller": "SHADE's pbest cut in its ask (path 9)", "n": shade["topk"]["n"],
             "k": shade["topk"]["k"], "launches": shade["launches"][name], "shapes": [shade["topk"]]},
            {"caller": "JaDE's pbest cut in its ask (the DE family phase)", "n": jade["topk"]["n"],
             "k": jade["topk"]["k"], "launches": jade["launches"][name], "shapes": [jade["topk"]]},
            {"caller": "IslandWorkflow's migration elites, one batched launch over the islands "
                       "(path 14; the partial_topk_rows entry)", "rows": ISL_N, "n": ISL_POP, "k": 1,
             "launches": paths["islands"]["launches"]},
            {"caller": "SHADE's pbest cut under vmap over 8 stacked islands (the SHADE islands "
                       "phase), one (8, 512) launch a generation, plus the migration elites",
             "rows": SHADE_ISL_N, "n": SHADE_ISL_POP, "k": pbest_k(SHADE_ISL_POP),
             "launches": paths["shade_islands"]["launches"][name]},
            {"caller": "rank_crowding_truncate's cut under vmap in NSGA-II's tell over 4 stacked "
                       "islands (the MO islands phase), one (4, 2000) launch a steady tell",
             "rows": MO_ISLANDS, "n": 2 * MO_FAMILY_POP, "k": MO_FAMILY_POP,
             "launches": paths["mo_islands"]["launches"][name]},
            {"caller": "rank_crowding_truncate in NSGA-II's tell under WorkflowCheckpointer, "
                       "straight run from init (path 18)", "n": 2 * NSGA2_POP, "k": NSGA2_POP,
             "launches": paths["checkpoint"]["launches"][name]},
            {"caller": "rank_crowding_truncate in NSGA-II's tell, instrumented with "
                       "analyze=True (path 22)", "n": 2 * NSGA2_POP, "k": NSGA2_POP,
             "launches": paths["instrumented_nsga2"]["launches"][name]},
            {"caller": "rank_crowding_truncate in NSGA-II's tell under RunSupervisor and "
                       "PodSupervisor, straight run from init (path 40)", "n": 2 * NSGA2_POP,
             "k": NSGA2_POP, "launches": paths["pod_supervised_nsga2"]["launches"][name]}]


def kernel_entries(kernels: dict, paths: dict) -> list:
    """The ``kernels`` line: one entry per kernel of the main paths."""
    pend = kernels["pendulum"]
    entries = [{
        "name": "fused_rollout",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/rollout.cu",
        "replaces": "evox_tpu/kernels/rollout.py:468",
        "launches": paths["pendulum"]["launches"],
        "max_abs_err": pend["max_abs_err"],
        "ms": pend["ms"],
        "plain_ms": pend["plain_ms"],
        "bound_ms": pend["bound_ms"],
        "bound_by": pend["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this
        "block": pend["block"],
        "callers": [
            {"caller": "PolicyRolloutProblem, fused pendulum under OpenES (path 1)",
             "launches": paths["pendulum"]["launches"]},
            *({"caller": caller, "launches": paths[key]["launches"],
               **{f: kernels[key][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "max_abs_err", "mean_live_steps", "block")}}
              for key, caller in (
                  ("acrobot", "PolicyRolloutProblem, fused acrobot 6-16-3 under OpenES (path 12)"),
                  ("mountain_car", "PolicyRolloutProblem, fused mountain car 2-16-1 under OpenES "
                                   "(the mountain car phase)"))),
            {"caller": "PolicyRolloutProblem, fused pendulum 3-16-1 at one episode, held against "
                       "the native C++ engine (path 33's cross-check)",
             "launches": paths["hostenv"]["native_vs_b1"]["launches"]["fused_rollout"],
             **{f: paths["hostenv"]["native_vs_b1"][k] for f, k in (
                 ("ms", "b1_ms"), ("native_engine_ms", "native_ms"), ("bound_ms", "b1_bound_ms"),
                 ("bound_by", "b1_bound_by"))}},
            {"caller": "MultiLevelES over 4 groups of PolicyRolloutProblem's fused pendulum "
                       "(pop 16384 each; path 38)",
             "launches": paths["multilevel"]["launches"]["fused_rollout"],
             "b1_share_of_outer_generation": paths["multilevel"]["b1_share"]},
        ],
    }]
    for name, source, replaces in (
        ("packed_dominance", "dominance.cu", "evox_tpu/kernels/dominance.py:222"),
        ("partial_topk", "topk.cu", "evox_tpu/kernels/topk.py:185"),
    ):
        k = kernels[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"evox_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": paths["nsga2"]["launches"][name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # partial_topk: torch.topk(v, k, largest=False), the same
            # values with an unspecified tie order; packed_dominance: no
            # single PyTorch call computes it
            "library_ms": k.get("library_ms"),
            **({"block": k["block"]} if "block" in k else {}),
            **{key: k[key] for key in ("empty_launch_ms", "ms_1e6", "library_ms_1e6") if key in k},
            "callers": monitor_callers(name, paths),
        })
    isl = paths["islands"]
    tb = isl["topk_batched"]
    entries.append({
        "name": "partial_topk_rows",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/topk.cu",
        "replaces": "evox_tpu/kernels/topk.py:185",
        "launches": isl["launches"],
        "max_abs_err": max(s["max_abs_err"] for s in tb["shapes"]),
        "ms": tb["ms"],
        "plain_ms": tb["plain_ms"],
        "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"],
        # torch.topk(v, 1, dim=1, largest=False): the same values, its tie
        # order unspecified
        "library_ms": tb["library_ms"],
        "rows": tb["rows"], "n": tb["n"], "k": tb["k"],
        **{key: tb[key] for key in ("device_us", "library_device_us", "one_row_launches_ms",
                                    "one_row_launches_device_us", "host_us", "library_host_us")},
        "shapes": tb["shapes"],
        "callers": [{"caller": "IslandWorkflow's migration elites over 8 PSO islands of 512 "
                               "(path 14), one launch a migration",
                     "launches": isl["launches"], "launches_per_turn": isl["launches_per_turn"]}],
    })
    db = paths["dominance_batched"]
    main = next(e for e in db["shapes"]
                if (e["b"], e["n"], e["m"]) == (MO_ISLANDS, 2 * MO_FAMILY_POP, MO_M))
    moi = paths["mo_islands"]
    entries.append({
        "name": "packed_dominance_batched",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/dominance.cu",
        # vmap of the JAX kernel over the islands (evox_tpu/workflows/islands.py:320-325)
        "replaces": "evox_tpu/kernels/dominance.py:222",
        "launches": moi["launches"]["packed_dominance"],
        "max_abs_err": max(e["max_abs_err"] for e in db["shapes"]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this
        "b": main["b"], "n": main["n"], "m": main["m"],
        "single_launches_ms": main["single_launches_ms"],
        "shapes": db["shapes"],
        "callers": [{"caller": "non_dominated_sort's vmap rule in NSGA-II's tell over 4 stacked "
                               "islands' merged rows (the MO islands phase), one launch a tell",
                     "b": MO_ISLANDS, "n": 2 * MO_FAMILY_POP, "m": MO_M,
                     "launches": moi["generations"]},
                    {"caller": "mo_elites under vmap (the MO islands' migration elites) and the "
                               "migrate's truncation, one launch each a migration",
                     "b": MO_ISLANDS, "n": [MO_FAMILY_POP, MO_FAMILY_POP + 4], "m": MO_M,
                     "launches": moi["launches"]["packed_dominance"] - moi["generations"]}],
    })
    att = paths["attest"]
    d1 = att["digest_kernel"]
    entries.append({
        "name": "state_digest",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/digest.cu",
        # no pallas_call: the JAX package's digest is XLA-fused jnp
        "replaces": "evox_tpu/core/attest.py:316 (XLA-fused jnp, no Pallas kernel)",
        "launches": att["launches"]["state_digest"],
        "max_abs_err": d1["max_abs_err"],
        "ms": d1["ms"],
        "plain_ms": d1["plain_ms"],
        "bound_ms": d1["bound_ms"],
        "bound_by": d1["bound_by"],
        "library_ms": None,  # no single PyTorch call computes these words
        "leaves": d1["leaves"], "bytes": d1["bytes"],
        "wrapper_ms": d1["wrapper_ms"], "device_us": d1["device_us"], "host_us": d1["host_us"],
        "state_digest_host_us": d1["state_digest_host_us"],
        "callers": [{"caller": "StateAttestor(every=10) on path 4's CSO, one launch an "
                               "attestation (path 26)", "launches": att["launches"]["state_digest"]},
                    {"caller": "run_fused(verify_every=1)'s voted re-dispatch on path 4's CSO, "
                               "two launches a verified chunk and one more a mismatch (path 26)",
                     "launches": att["votes"]["heal"]["digest_launches"]}],
    })
    rows = paths["dominance_rows"]["main"]
    sn = paths["sharded_nsga2"]
    entries.append({
        "name": "packed_dominance_rows",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/dominance.cu",
        # the sharded sort's slab: dominate_relation + pack_dominator_rows
        # around the Pallas kernel (evox_tpu/kernels/dominance.py:88-102,
        # evox_tpu/operators/selection/non_dominate.py:161-250)
        "replaces": "evox_tpu/kernels/dominance.py:222",
        "launches": sn["launches"]["packed_dominance_rows"],
        "max_abs_err": max(e["max_abs_err"] for e in paths["dominance_rows"]["shapes"]),
        "ms": rows["ms"],
        "plain_ms": rows["plain_ms"],
        "bound_ms": rows["bound_ms"],
        "bound_by": rows["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this
        "slab_rows": rows["slab_rows"], "n": rows["n"], "m": rows["m"],
        "generation_ms": rows["generation_ms"], "generation_bound_ms": rows["generation_bound_ms"],
        "full_b3_ms": rows["full_b3_ms"],
        "shapes": paths["dominance_rows"]["shapes"],
        "callers": [{"caller": "the mesh-sharded non_dominated_sort in NSGA-II's tell on an "
                               "8-shard mesh of the card (path 31), 8 launches a generation",
                     "launches": sn["launches"]["packed_dominance_rows"]}],
    })
    mm = paths["smallmm"]
    main_mm = next(e for e in mm["shapes"] if e["name"].startswith("path 28 ask"))
    entries.append({
        "name": "smallmm",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/smallmm.cu",
        # no pallas_call: the JAX package leaves CMA-ES's products to XLA
        "replaces": "evox_tpu/algorithms/so/es/cma_es.py:147-174 (XLA products, no Pallas kernel)",
        "launches": paths["fleet"]["turns"][0]["m1_launches"],
        "max_abs_err": max(e["max_abs_err"] for e in mm["shapes"]),
        "ms": main_mm["ms"],
        "plain_ms": main_mm["plain_ms"],
        "bound_ms": main_mm["bound_ms"],
        "bound_by": main_mm["bound_by"],
        # torch.bmm on the same operands: another summation order
        "library_ms": main_mm["library_ms"],
        "shapes": mm["shapes"],
        "callers": [{"caller": "CMA-ES's seven products a generation over 64 stacked tenants "
                               f"(path 28's fleet turn, {sum(TEN_PAIR)} generations)",
                     "launches": paths["fleet"]["turns"][0]["m1_launches"]},
                    {"caller": "CMA-ES at d 1000 (path 5), seven a generation",
                     "launches": paths["cmaes"]["launches"]["smallmm"]}],
    })
    w = kernels["walker"]
    entries.append({
        "name": "fused_mlp_rollout",
        "route": "cuda",
        "source": "evox_tpu_torch/csrc/rollout_mlp.cu",
        "replaces": "evox_tpu/kernels/rollout_mlp.py:569",
        "launches": paths["walker"]["launches"],
        "max_abs_err": w["max_abs_err"],
        "ms": w["ms"],
        "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this
        "copy_only_ms": w["copy_only_ms"],
        "block": w["block"],
        "callers": [{"caller": "PolicyRolloutProblem under OpenES (path 3)",
                     "launches": paths["walker"]["launches"]},
                    {"caller": "PolicyRolloutProblem under PGPE with ClipUp (path 6)",
                     "launches": paths["pgpe_walker"]["launches"]},
                    {"caller": "PolicyRolloutProblem under OpenES, bf16 policy residency "
                               "(fused_planes_dtype, path 13)",
                     "launches": paths["walker_bf16"]["launches"],
                     **{f: kernels["walker_bf16"][f] for f in (
                         "ms", "copy_only_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                         "block")}}],
    })
    return entries


class _TimedPaths(dict):
    """The paths' results; ``seconds`` holds each entry's command time
    since the entry before it (phases that store no result fall into the
    next one's)."""

    def __init__(self):
        super().__init__()
        self.seconds = {}
        self._last = time.perf_counter()

    def __setitem__(self, key, value):
        now = time.perf_counter()
        self.seconds[key] = round(now - self._last, 2)
        self._last = now
        super().__setitem__(key, value)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None, help="also write the full results as JSON here")
    parser.add_argument("--profile", action="store_true", help="also profile 5 generations")
    parser.add_argument("--cold-start", nargs=2, metavar=("MODE", "CACHE_DIR"), default=None,
                        help="run path 36's cold start in this process and print it (a child "
                             "of path 36)")
    args = parser.parse_args()
    if args.cold_start is not None:
        import torch

        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, str(ROOT))
        print(json.dumps(cold_start_child(*args.cold_start)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    if not (ROOT / "evox_tpu_torch" / "csrc" / "rollout.cu").exists():
        print(f"chip_smoke: no evox_tpu_torch checkout beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # OpenES's tell matmul in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device and build
    smi = _nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import rollout as kr

    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(built)} CUDA source(s) in {build_s:.2f} s: "
          + ", ".join(p.name for p in built.values()), flush=True)
    for name in built:
        for line in (_build.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    # 2. kernels against plain, on the main paths' inputs and on stress inputs
    wf, make_problem = build_main_path(torch, SEED)
    kernels = phase_kernels(torch, kr, wf, SEED)
    wf2 = build_nsga2_path(torch)
    kernels.update(phase_nsga2_kernels(torch, wf2, SEED))
    wf12, make_acrobot_problem = build_acrobot_path(torch)
    kernels.update(phase_rollout_envs(torch, kr, wf12, SEED))
    wf3, make_walker_problem, adapter = build_walker_path(torch)
    kernels.update(phase_walker_kernels(torch, wf3, adapter, SEED))

    # 3.-5. the main paths; each phase's seconds, for the time budget
    paths = _TimedPaths()
    paths["pendulum"] = phase_main_path(torch, kr, wf, make_problem, GENERATIONS, SEED,
                                        args.profile)
    print(f"[main path] {json.dumps(paths['pendulum'])}", flush=True)
    del wf
    # main path 12 (acrobot), the mountain car phase, the normaliser
    paths["acrobot"] = phase_main_path(torch, kr, wf12, make_acrobot_problem, GENERATIONS, SEED,
                                       args.profile, engine_T=100, live_steps=True)
    print(f"[acrobot path] {json.dumps(paths['acrobot'])}", flush=True)
    del wf12
    wf_mc, make_mc_problem = build_b1_path(torch, kr.mountain_car_soa(max_steps=MOUNTAIN_CAR_T))
    paths["mountain_car"] = phase_main_path(torch, kr, wf_mc, make_mc_problem,
                                            MOUNTAIN_CAR_GENERATIONS, SEED, False, engine_T=100,
                                            live_steps=True)
    print(f"[mountain car] {json.dumps(paths['mountain_car'])}", flush=True)
    del wf_mc
    paths["normalizer"] = phase_normalizer(torch, SEED)
    paths["nsga2"] = phase_nsga2_path(torch, wf2, GENERATIONS, SEED, args.profile)
    print(f"[nsga2 path] {json.dumps(paths['nsga2'])}", flush=True)
    paths["monitor_archive"] = phase_monitor_archive(torch, wf2, SEED)
    print(f"[monitor archive] {json.dumps(paths['monitor_archive'])}", flush=True)
    del wf2
    paths["walker"] = phase_walker_path(torch, wf3, make_walker_problem, adapter,
                                        GENERATIONS, SEED, args.profile)
    print(f"[walker path] {json.dumps(paths['walker'])}", flush=True)
    del wf3, adapter, make_walker_problem
    torch.cuda.empty_cache()
    # main path 13: path 3 with bf16 policy residency, its kernel checks, and
    # both residencies in turns
    wf13, make_walker_problem, adapter = build_walker_path(torch, weight_dtype=torch.bfloat16)
    kernels.update(phase_walker_kernels(torch, wf13, adapter, SEED, prefix="walker_bf16"))
    paths["walker_bf16"] = phase_walker_path(torch, wf13, make_walker_problem, adapter,
                                             GENERATIONS, SEED, args.profile)
    print(f"[walker bf16 path] {json.dumps(paths['walker_bf16'])}", flush=True)
    del wf13, adapter, make_walker_problem
    torch.cuda.empty_cache()
    paths["walker_turns"] = phase_walker_turns(torch, SEED)
    # 6. main path 4 (CSO on Ackley), its monitored run, one generation
    # against the CPU, and the rest of the PSO family
    paths["cso"] = phase_cso_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[cso path] {json.dumps(paths['cso'])}", flush=True)
    paths["cso_monitored"] = phase_cso_monitored(torch, GENERATIONS, SEED)
    print(f"[cso monitored] {json.dumps(paths['cso_monitored'])}", flush=True)
    paths["cso_card_vs_cpu"] = phase_cso_card_vs_cpu(torch, SEED)
    paths["pso_family"] = phase_pso_family(torch, PSO_GENERATIONS, SEED)
    # 7. main path 5 (CMA-ES, dense covariance, d 1000) and one of its
    # generations against the CPU; main path 6 (PGPE on the walker); the
    # rest of the ES family
    paths["cmaes"] = phase_cmaes_path(torch, SEED, args.profile)
    print(f"[cmaes path] {json.dumps(paths['cmaes'])}", flush=True)
    paths["cmaes_card_vs_cpu"] = phase_cmaes_card_vs_cpu(torch, SEED)
    paths["pgpe_walker"] = phase_pgpe_walker(torch, GENERATIONS, SEED, args.profile)
    print(f"[pgpe walker path] {json.dumps(paths['pgpe_walker'])}", flush=True)
    torch.cuda.empty_cache()
    paths["es_family"] = phase_es_family(torch, ES_GENERATIONS, SEED)
    # 8. main paths 7 (MOEA/D on DTLZ2) and 8 (NSGA-III on DTLZ1), the rest
    # of their family, and DTLZ on the card against the CPU
    torch.cuda.empty_cache()
    paths["moead"] = phase_moead_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[moead path] {json.dumps(paths['moead'])}", flush=True)
    paths["nsga3"] = phase_nsga3_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[nsga3 path] {json.dumps(paths['nsga3'])}", flush=True)
    torch.cuda.empty_cache()
    paths["mo_family"] = phase_mo_family(torch, MO_GENERATIONS, SEED)
    paths["dtlz"] = phase_dtlz(torch, SEED)
    # 9. main path 9 (SHADE on Ackley) and one of its generations against the
    # CPU, the DE family, and CEC 2022 on the card against the CPU
    paths["shade"], wf9, state9 = phase_shade_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[shade path] {json.dumps(paths['shade'])}", flush=True)
    paths["shade_card_vs_cpu"] = phase_shade_card_vs_cpu(torch, wf9, state9, SEED)
    del wf9, state9
    paths["de_family"] = phase_de_family(torch, DE_GENERATIONS, SEED)
    paths["cec2022"] = phase_cec2022(torch, SEED)
    # 10. main paths 10 (GDE3 on LSMOP1) and 11 (IBEA on DTLZ2), the
    # indicator and knee family, and MaF on the card against the CPU
    torch.cuda.empty_cache()
    paths["gde3"] = phase_gde3_path(torch, GENERATIONS, SEED, args.profile)
    print(f"[gde3 path] {json.dumps(paths['gde3'])}", flush=True)
    torch.cuda.empty_cache()
    paths["ibea"] = phase_ibea_path(torch, IBEA_GENERATIONS, SEED, args.profile)
    print(f"[ibea path] {json.dumps(paths['ibea'])}", flush=True)
    torch.cuda.empty_cache()
    paths["indicator_family"] = phase_indicator_family(torch, MO_GENERATIONS, SEED)
    paths["maf"] = phase_maf(torch, SEED)
    # 11. main paths 14 (the island workload, B4 batched over the islands)
    # and 15 (IPOP-CMA-ES), the containers and the MO islands
    torch.cuda.empty_cache()
    paths["islands"] = phase_island_path(torch, SEED, args.profile)
    paths["ipop"] = phase_ipop_path(torch, SEED)
    paths["containers"] = phase_containers(torch)
    paths["mo_islands"] = phase_mo_islands(torch, SEED)
    paths["dominance_batched"] = phase_dominance_batched(torch)
    paths["shade_islands"] = phase_shade_islands(torch)
    # 12. main paths 16 (bench.py's workload 6: a host problem through the
    # executor), 17 (workload 1b: bf16 storage) and 18 (checkpoint and
    # resume on NSGA-II, B3 and B4 once a generation)
    torch.cuda.empty_cache()
    paths["host"] = phase_host_path(torch)
    paths["bf16"] = phase_bf16_path(torch, profile=args.profile)
    torch.cuda.empty_cache()
    paths["checkpoint"] = phase_checkpoint_path(torch)
    # 13. main paths 19 (bench.py's workload 8: surrogate screening through
    # the executor's refit hooks) and 20 (IM-MOEA on DTLZ2, B3 once a
    # generation), and the GP at its bound
    torch.cuda.empty_cache()
    paths["surrogate"] = phase_surrogate_path(torch, profile=args.profile)
    paths["gp_bound"] = phase_gp_bound(torch)
    paths["immoea"] = phase_immoea_path(torch, GENERATIONS, SEED, args.profile)
    # 14. main paths 21 (bench.py's run-telemetry leg: instrument,
    # run_report, the roofline and the Chrome trace) and 22 (path 2
    # instrumented, its analysis charging B3 and B4)
    torch.cuda.empty_cache()
    paths["telemetry"] = phase_telemetry_path(torch)
    paths["instrumented_nsga2"] = phase_instrumented_nsga2(torch)
    # 15. main paths 23 (stale tells on workload 6's host problem), 24 (path
    # 14 with A5's arguments), 25 (bench.py's workload 12, the metrics
    # plane), 26 (workload 12b: the attestor on D1, the voted re-dispatch,
    # bisection) and 27 (lineage on paths 9 and 2, one more B3 launch)
    torch.cuda.empty_cache()
    paths["stale"] = phase_stale_path(torch)
    paths["island_arguments"] = phase_island_arguments(torch)
    torch.cuda.empty_cache()
    paths["metrics"] = phase_metrics_path(torch)
    paths["attest"] = phase_attest_path(torch)
    torch.cuda.empty_cache()
    paths["lineage"] = phase_lineage_path(torch)
    # 16. main paths 28 (bench.py's workload 5: a stacked 64-tenant CMA-ES
    # fleet against its 64 runs one after the other) and 29 (bench.py's
    # RunQueue leg, an eviction resumed solo)
    torch.cuda.empty_cache()
    paths["fleet"] = phase_fleet_path(torch, profile=args.profile)
    paths["runqueue"] = phase_runqueue_path(torch)
    # 17. kernel M1 and B3's rows form against their plain versions; main
    # paths 30 (bench.py's workload 7: ShardedES on an 8-shard mesh of the
    # card), 31 (path 2 with the mesh-sharded sort) and 32 (path 2 under
    # RunSupervisor with three faults); the NCCL world of one
    torch.cuda.empty_cache()
    paths["smallmm"] = phase_smallmm_kernel(torch)
    paths["dominance_rows"] = phase_dominance_rows(torch)
    paths["sharded_es"] = phase_sharded_es(torch)
    torch.cuda.empty_cache()
    paths["sharded_nsga2"] = phase_sharded_nsga2(torch)
    paths["supervised_nsga2"] = phase_supervised_nsga2(torch)
    paths["nccl_world"] = phase_nccl_world(torch)
    # 18. main paths 33 (OpenES on HostEnvProblem over the native C++
    # engine, with the engine against B1 on one workload), 34 (supervised
    # OpenES on DatasetProblem over an MNIST-shaped stream) and 35 (the
    # thread and process rollout farms, a worker killed, the floor)
    torch.cuda.empty_cache()
    paths["hostenv"] = phase_hostenv_path(torch)
    torch.cuda.empty_cache()
    paths["dataset"] = phase_dataset_path(torch)
    torch.cuda.empty_cache()
    paths["farm"] = phase_farm_path(torch)
    # 19. main paths 36 (bench.py's serving_elastic leg: buckets, warm
    # admission, autoscaling, the cold start), 37 (path 28's fleet under a
    # health policy, NaN in three tenants) and 38 (MultiLevelES over B1)
    torch.cuda.empty_cache()
    paths["elastic"] = phase_elastic_path(torch)
    torch.cuda.empty_cache()
    paths["fleet_health"] = phase_fleet_health_path(torch, profile=args.profile)
    torch.cuda.empty_cache()
    paths["multilevel"] = phase_multilevel_path(torch)
    # 20. main paths 39 (bench.py's workload 13: the multi-pod control plane
    # with a pod declared dead) and 40 (path 2 under the pod fault domain)
    torch.cuda.empty_cache()
    paths["control_plane"] = phase_control_plane_path(torch)
    torch.cuda.empty_cache()
    paths["pod_supervised_nsga2"] = phase_pod_supervised_nsga2(torch)
    if "jax" in sys.modules or any(
        k == "evox_tpu" or k.startswith("evox_tpu.") for k in sys.modules
    ):
        raise AssertionError("the port pulled in jax or the JAX package")

    print(f"[phase seconds] {json.dumps(paths.seconds)}", flush=True)
    line = {"kernels": kernel_entries(kernels, paths)}
    result = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "kernels": kernels,
        "main_path": paths["pendulum"],
        "nsga2_path": paths["nsga2"],
        "walker_path": paths["walker"],
        "acrobot_path": paths["acrobot"],
        "mountain_car": paths["mountain_car"],
        "normalizer": paths["normalizer"],
        "walker_bf16_path": paths["walker_bf16"],
        "walker_turns": paths["walker_turns"],
        "cso_path": paths["cso"],
        "cso_monitored": paths["cso_monitored"],
        "cso_card_vs_cpu": paths["cso_card_vs_cpu"],
        "pso_family": paths["pso_family"],
        "monitor_archive": paths["monitor_archive"],
        "cmaes_path": paths["cmaes"],
        "cmaes_card_vs_cpu": paths["cmaes_card_vs_cpu"],
        "pgpe_walker_path": paths["pgpe_walker"],
        "es_family": paths["es_family"],
        "moead_path": paths["moead"],
        "nsga3_path": paths["nsga3"],
        "mo_family": paths["mo_family"],
        "dtlz": paths["dtlz"],
        "shade_path": paths["shade"],
        "shade_card_vs_cpu": paths["shade_card_vs_cpu"],
        "de_family": paths["de_family"],
        "cec2022": paths["cec2022"],
        "gde3_path": paths["gde3"],
        "ibea_path": paths["ibea"],
        "indicator_family": paths["indicator_family"],
        "maf": paths["maf"],
        "island_path": paths["islands"],
        "ipop_path": paths["ipop"],
        "containers": paths["containers"],
        "mo_islands": paths["mo_islands"],
        "host_path": paths["host"],
        "bf16_path": paths["bf16"],
        "checkpoint_path": paths["checkpoint"],
        "surrogate_path": paths["surrogate"],
        "gp_bound": paths["gp_bound"],
        "immoea_path": paths["immoea"],
        "telemetry_path": paths["telemetry"],
        "instrumented_nsga2_path": paths["instrumented_nsga2"],
        "stale_path": paths["stale"],
        "island_arguments_path": paths["island_arguments"],
        "metrics_path": paths["metrics"],
        "attest_path": paths["attest"],
        "lineage_path": paths["lineage"],
        "dominance_batched": paths["dominance_batched"],
        "shade_islands": paths["shade_islands"],
        "fleet_path": paths["fleet"],
        "runqueue_path": paths["runqueue"],
        "smallmm": paths["smallmm"],
        "dominance_rows": paths["dominance_rows"],
        "sharded_es_path": paths["sharded_es"],
        "sharded_nsga2_path": paths["sharded_nsga2"],
        "supervised_nsga2_path": paths["supervised_nsga2"],
        "nccl_world": paths["nccl_world"],
        "hostenv_path": paths["hostenv"],
        "dataset_path": paths["dataset"],
        "farm_path": paths["farm"],
        "elastic_path": paths["elastic"],
        "fleet_health_path": paths["fleet_health"],
        "multilevel_path": paths["multilevel"],
        "control_plane_path": paths["control_plane"],
        "pod_supervised_nsga2_path": paths["pod_supervised_nsga2"],
        "phase_seconds": paths.seconds,
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(smi, flush=True)  # the card's name and power limit again, near the verdict
    print(json.dumps(line), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
