#!/usr/bin/env python3
"""Build and drive the PyTorch port's main path on one NVIDIA GPU, and
check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 39-46  # one block alone, in a fresh process
    python3 chip_smoke.py --phases 47-48  # the data-parallel block alone
    python3 chip_smoke.py --phases 49     # the tools' sweep alone
    python3 chip_smoke.py --phases 50     # determinism and checkpoints
    python3 chip_smoke.py --phases 51     # S2 and S3, the engines' steps

Eight main paths, each driven with its kernels' launch counters reset just
before it and read just after (the threefry path's learning checks
each with S2's and S3's).  The rollout path is the batched random
play at 8192 lanes on the 5x4 (slip 0.2) and 11x7 (slip 0.2) boards:
``fused_rollout`` (kernel K1), ``fused_journal_rollout`` (kernel K2) with
``unpack_journal``, and the batched engine ``core.batch``.  The training
path is ``fused_minimax_train`` (kernel K5, and kernel R1 for the RM+
re-solve) and ``exploitability``.  The parity path is ``parity_events`` (kernel K12,
closed loop) and ``parity_scripted_events`` (kernel K13) with
``unpack_journal``: bit-exact reference trajectories from seeds, one
MT19937 draw per event.  The independent-Q path is ``fused_iql_train``
(kernel K8, and kernel K9 with ``packed=False``).  The mixed-geometry path
is ``multigrid_rollout`` (kernel K3) on a mixture of three boards and
``fused_minimax_train`` on that mixture (kernel K6, and kernel K7's
multigrid site with ``packed=False``) and on one board with
``packed=False`` (kernel K7).  The alternating-turn path is
``alt_rollout`` (kernel K4) and ``fused_altq_train`` (kernel K10, and
kernel K11 with ``packed=False``), with ``alt_value_iteration_torch`` and
``alt_policy_rollout`` for its gate.  The reference-user surface runs
last: the native host libraries, the ``SoccerSimultaneousEnv`` facade,
``value_iteration_torch``, the best-response gate through
``fused_best_response_train`` (kernel K5) and ``entry()`` (kernel K5).
The threefry path runs last: the entry point
``gym_soccer_tpu_torch.examples.train_minimax``, whose HBM-table learner
steps the engine through kernel S1 (the transition's and the resets'
draws inside it), draws its actions through kernel T1, sums its updates
in lane order through kernel A1 and re-solves through kernel R1, and
whose evaluation draws its policy through T1's keyed entry; the
learners, the engines and ``SoccerVectorEnv``; the JAX package's learning
checks, whose mixture learner steps its engine through kernel S2 and whose
turn-based learner steps its engine through kernel S3.  The
data-parallel path (parallel/mesh) runs after it: the four trainers with
``mesh=`` (K5, K6, K8, K10 and R1, their all-reduces in the CUDA graphs
on an NCCL mesh), the HBM-table learners through ``sharded_*_train_fn``,
the sharded chunks of K5-K11 and the sharded re-solve on two ranks that
share the card over gloo.  The tools run next: ``tools.bench_all``'s 24
rows, every path through its entry timed side by side, each row with its
launches counted, and ``tools.bench_parity_kernel``.  Determinism and
checkpoints run next: A1 against its plain version, the HBM-table
learners and the entry point against the CPU and against themselves,
and ``save_orbax`` / ``load_orbax``.  S2 and S3 against their plain
versions run last.
Phases, each of which raises on failure:

1. device: a CUDA device is present; its name and power limit;
2. build: the kernels compile from the sources in this checkout, one nvcc
   per library, in parallel; for each kernel's bound, cuobjdump's SASS
   gives the fewest instructions one step (or event) of its main loop
   issues (``loop_instructions``; K12/K13's MT19937 twist amortised over
   the 312 events between twists; K1-K11's producer code loop plus their
   consumer tile loop over its 8 steps);
3. main path: the user entry points at 8192 lanes, with the kernels'
   launch counters reset before and read after; outputs are checked by
   the repo's own means (valid states, journal decodes, stats agree);
4. K1: bit-equal to its plain version at 64 lanes per block (the
   default), 96 (a ragged last block) and 32; a run split by
   ``step_offset`` equals one run; lanes the step table cannot start from
   (walked by arithmetic) equal the plain version;
5. K2: journal bit-equal to its plain version at 64 and 96 lanes per
   block; fields and stats equal K1's;
6. small inputs: both kernels equal the plain versions run on the CPU;
7. batched engine: 8192 lanes x 100 steps on the card equal the CPU run;
8. timing: env-steps/s of K1, K2 and their plain versions (CUDA events,
   median of 5 legs of at least 50 ms each, after warmup), K1/K2 on 11x7
   too; each board's K1/K2 design line (walk, block shape, shared memory,
   registers, SASS per lane-step, bound, and the ms beside the previous
   design's ``ROLLOUT_OLD_MS``); a ``torch.profiler`` window of K1 for
   device time and idle share;
9. training path: ``fused_minimax_train`` on 5x4 at 8192 lanes for a few
   chunks, K5's launch counter reset before and read after; Q finite,
   |v| <= 1.05, policy rows summing to 1;
10. K5: bit-equal to its plain version (fields, stats, visit counts and
    the int64 residual sums) at 8192 lanes x 64 steps and at the contract's
    65536 x 32 on 5x4 and 11x7, at the default lanes per block (one wave:
    64 and 512) and at a size that leaves a ragged last block (96, 480),
    on a non-uniform table with v != 0; from goal states; and on a small
    input equal to the plain version run on the CPU;
11. exact resume: 2 chunks equal 1 + 1 through the resume dict, bit for
    bit in q, n and the fields;
12. the 5x4 contract: the JAX package's recipe (65536 lanes, 1000 chunks
    x 32 steps, seed 1; tests/test_learner_kernel.py:117-120) reaches
    exploitability <= 0.010 at gamma 0.99, reading 0.0034149587; wall time
    split into chunk calls and the work between them; then at
    ``chunks_per_dispatch=8`` (``grouped_phase``: 125 CUDA-graph replays,
    K5 and R1 launched once a chunk by the counts, q, v, pi and the history
    bit-equal to the per-chunk run), with its wall, capture and replay
    times;
13. timing: learner env-steps/s of K5 and its plain version at 8192 lanes
    x 64 steps and 65536 x 32 on 5x4 and 11x7; each one's design line
    (the rows' place, block shape, shared memory, registers, SASS per
    lane-step, bound, the previous design's ms) and a ``torch.profiler``
    window of K5 for its device time beside the call's;
14. parity path: ``parity_events`` at 8192 lanes x 1536 events on 5x4 and
    11x7 (slip 0.2, numpy-seeded random policies, seeds arange(B) % 997)
    and ``parity_scripted_events`` at 8192 x 768 events with an 800-row
    script, the launch counters reset before and read after; the journals
    decode (reachable raw codes, consistent flags, steps = transition
    events);
15. K12/K13: journal and all 8 final fields bit-equal to the plain
    versions at those shapes for two block sizes that fit the shared-memory
    budget (the default 64 lanes, and 80, which leaves a ragged last
    block), and at 128 lanes x 640 events equal to the plain versions run
    on the CPU, at the default block size and at 2 lanes per block (fewer
    threads than 5x4's four ISD states); the kernel's shared memory per
    block equals ``smem_bytes``, and a block that does not fit is refused;
16. the reference's own runs through the kernels: all 1000 episodes of
    the reference main()'s VI-vs-random-B evaluation and the 200-episode
    joint evaluation through K12 (episode lengths, rewards and the step
    stream digest), and every multi-agent trajectory fixture through K13,
    step for step (tests/golden/reference_golden.json, read with json);
17. timing: events/s and bit-exact env-steps/s of K12, K13 and their plain
    versions at the phase-14 shapes, with each kernel's block size, shared
    memory per block and registers per thread, beside the previous
    design's ms per call;
18. IQL path: ``fused_iql_train`` on 5x4 at 8192 lanes for 4 chunks x 64
    steps through its default device, packed (K8) and unpacked (K9), the
    launch counters reset before and read after (one launch a chunk); Q
    finite, |Q| <= 1.05, and the visit counts of one more chunk from the
    resume state sum to B * T per player;
19. K8/K9: bit-equal to their plain versions (fields, stats, counts and the
    int64 sums) at 8192 lanes x 64 steps on 5x4 and 11x7 at the default
    lanes per block (64) and 96 (a ragged last block), on Q tables with
    near-ties, from step 640, and at 1024 x 129 at 512 lanes per block
    (more visits a cell than a block's private accumulators take, so
    added by device-memory atomics); K8 and K9 step the same fields, stats
    and counts; at 256 x 16 equal to the plain versions run on the CPU, and
    counting the same values out of the int64 sums' range on tables that
    hold nan or 1e7;
20. resume and learning: 2 chunks equal 1 + 1 through the resume dict, bit
    for bit; the JAX package's learning check (tests/test_iql_kernel.py
    ``test_fused_iql_training_learns``) on the card; a 65536-lane x 200
    chunk x 32 step run with its wall time split into chunk calls and the
    work between them, and at ``chunks_per_dispatch=8`` (``grouped_phase``)
    bit-equal to it, and greedy-vs-greedy play of its tables through the
    batched engine (a measurement, not a gate);
21. timing: learner env-steps/s of K8, K9 and their plain versions at 8192
    x 64 on 5x4 and 11x7, K8 at 32768 x 64; each one's design line per
    board (the rows' place, block shape, shared memory, registers, SASS
    per lane-step, bound, the previous design's ms) and ``torch.profiler``
    windows of K8 and K9 for device time and idle share;
22. mixed-geometry path: ``multigrid_rollout`` at 8192 lanes x 1024 steps on
    tools/bench_all.py's mixture (5x4 slip 0.2, 6x5 slip 0.1, 8x6 slip 0.3)
    through its default device, ``fused_minimax_train`` on that mixture for
    4 chunks of 8192 x 64, packed (K6) and ``packed=False`` (K7 multigrid),
    and on 5x4 with ``packed=False`` (K7), the launch counters reset before
    and read after; every lane ends on its own board in a reachable state
    of its variant, the per-variant stats are plausible and sum to the
    batch's totals, Q finite and |v| <= 1.05, and one more chunk from each
    mixture run's resume state counts each variant's lanes x 64 visits in
    its own table block;
23. K3: bit-equal to its plain version (fields and per-variant stats) at
    8192 x 1024 at 64 lanes per block (the default) and 96 (a ragged last
    block); a run split by ``step_offset`` equals one run; the one-variant
    mixture (5x4,) equals K1; at 1024 x 64 equal to the plain version run
    on the CPU;
24. K6 and K7 (both sites): bit-equal to their plain versions (fields,
    stats, counts, the int64 sums and the out-of-range count) at 8192 x 64
    on the mixture, on 5x4+11x7 and on the ``--multigrid`` recipe's 5x4+6x5
    (K6, K7 multigrid; the recipe's prepared rows in shared memory, the
    others' in L2) and on 5x4 and 11x7 (K5, K7), at the default lanes per
    block and 96 (a ragged last block), on tables with non-uniform pi and
    v, q != 0;
    K6 and K7 step the same fields, stats and counts; at 256 x 16 equal to
    the plain versions run on the CPU; K5, K6 and K7 count the same
    out-of-range values as their plain versions on tables holding nan and
    1e7; the (5x4,) mixture trainer equals the static trainer for 3 chunks
    bit for bit in q, n and the fields; a mixture run resumed 1 + 1 equals
    2, packed and not;
25. learning: the JAX package's ``--multigrid`` recipe
    (examples/train_minimax_tpu.py:141-151: 5x4 + 6x5 at slip 0.2, 16384
    lanes, 312 chunks x 64 steps, lr 1.0, eps 0.2, anneal from chunk 156
    with tau 25 and pow 1.5, 2000 final solver iterations), packed and
    ``packed=False``; each variant's exploitability on its slice of the
    concatenated policies at most 0.05 on 5x4 and 0.08 on 6x5; wall time
    split into chunk calls and the work between them; each again at
    ``chunks_per_dispatch=8`` (``grouped_phase``), bit-equal;
26. timing: K3 at 8192 x 1024 on the mixture; K6 at 8192 x 64 and 32768 x
    64 on the mixture, at 8192 x 64 on 5x4+11x7 and at the recipe's 16384
    x 64 on 5x4+6x5; K7 at 8192 x 64 on 5x4 and 11x7; K7 multigrid at 8192
    x 64 on the mixture and 16384 x 64 on 5x4+6x5; each against its plain
    version; the design lines of K3, K6 (each cell) and K7 (both sites:
    the rows' place, block shape, shared memory, registers, SASS per
    lane-step, bound, device time by CUDA-graph replay for K6 and K7
    multigrid, the previous design's time) and ``torch.profiler`` windows
    of K3 and K7 (both sites) for device time and idle share;
27. alternating path: ``alt_rollout`` at 8192 x 1024 on 5x4 and 11x7 (slip
    0.2) and ``fused_altq_train`` on 5x4 for 4 chunks of 8192 x 64, packed
    (K10) and ``packed=False`` (K11), through their default device, the
    launch counters reset before and read after; every lane ends in a
    reachable alternating state with turn 0 or 1, the stats are
    plausible, q finite and |q| <= 1.05, and one more chunk from each
    resume state counts B * T visits;
28. K4: bit-equal to its plain version at 8192 x 1024 on 5x4 and 11x7 at
    64 lanes per block (the default), 96 (a ragged last block) and 32; a
    run split by ``step_offset`` equals one run; lanes the tick table
    cannot start from (walked by arithmetic) equal the plain version; at
    1024 x 64 equal to the plain version run on the CPU;
29. K10/K11: bit-equal to their plain versions (fields, stats with the
    out-of-range count, counts, int64 sums) at 8192 x 64 on 5x4 and 11x7
    at 64 lanes per block (the default), 96 (a ragged last block) and 32,
    on Q tables with near-ties and a step offset; a chunk split by
    ``step_offset`` equals one chunk; lanes in goal states, a few steps
    before truncation or with turn 2 (walked by arithmetic) equal the
    plain version; at the gate's 65536 x 32 on 5x4 (512 lanes per block);
    K10 and K11 step the same trajectories; at 256 x 16 equal to the plain
    versions run on the CPU, and counting the same values out of range on
    tables that hold nan or 1e7;
30. resume and the gate: 2 chunks equal 1 + 1 through the resume dict,
    packed and not; the JAX package's ``test_altq_convergence_tpu`` recipe
    (65536 lanes, 400 chunks x 32 steps, seed 1) reaches mean |V - V*| <=
    0.05 against ``alt_value_iteration`` at gamma 0.99 (which
    ``alt_value_iteration_torch`` repeats on the card), and its greedy
    policy wins more than 95 % of completed episodes against a frozen
    random policy (``alt_policy_rollout``, 256 lanes x 300 steps, seed 6);
    wall time split into chunk calls and the work between them; the gate's
    run again at ``chunks_per_dispatch=8`` (``grouped_phase``), bit-equal;
31. timing: K4 at 8192 x 1024 and K10/K11 at 8192 x 64, on 5x4 and 11x7,
    each against its plain version; K4's and K10/K11's design lines per
    board (walk, block shape, shared memory, registers, SASS per
    lane-step, bound; K4's previous design's ms, and K10/K11's device time
    by CUDA-graph replay beside their previous design's) and
    ``torch.profiler`` windows of K4 (both boards) and K10 for device time
    and idle share;
32. R1 (``solve_matrix_games``, ``csrc/rmplus_kernel.cu``, a group of
    lanes of one warp a game): bit-equal to ``solve_matrix_games_plain``
    on the card on the 5x4 contract's own Q after a chunk (761 games) at
    400, 3000 and 200 iterations (the contract's re-solve and final solve,
    the HBM-table learner's re-solve), on random games at the
    ``--multigrid`` recipe's 2502 x 200 and the 11x7 contract's
    11705 x 600, and on 7 games and 1 (a warp partly empty); bit-equal to
    its previous design (one thread a game, ``csrc/rmplus_thread_kernel.cu``
    built beside the libraries); both timed at each shape by CUDA events
    and by CUDA-graph replay, with cycles an iteration; the plain
    version's ms at 761 x 400; its design line (lanes a game, games a
    warp, blocks, registers, SASS per lane-iteration and per
    game-iteration, the bound at this design's count and at the previous
    design's, the share of the smaller);
33. the 11x7 contract: the JAX package's test_equilibrium_11x7_tpu recipe
    (65536 lanes, 6000 chunks x 32 steps, solver 600, avg_q from chunk
    4000, a 3000-iteration final solve, seed 2) at its
    ``chunks_per_dispatch=8``, K5 and R1 counted once a chunk over 750
    replays, reaches exploitability <= 0.005 at gamma 0.99
    (``segment_iters=200``), with its wall and evaluation times;
34. native: both C++ host libraries (``gym_soccer_tpu_torch/native``)
    compile with g++ from this checkout and load, timed in a fresh
    process, and
    ``build_tables(backend="native")`` equals the numpy backend byte for
    byte on 5x4 and 11x7 (slip 0.2), with both build times and the host's
    CPU model;
35. facade: 20,000 random-action steps with resets through
    ``SoccerSimultaneousEnv`` on 11x7 slip 0.2, multi-agent and against
    ``get_random_policy(nS, 5, 42)`` as B, equal step for step on the
    native and the numpy tables; steps/s (host clock) with the CPU model;
36. planners: ``value_iteration_torch`` in float32 on the card against
    ``value_iteration_arrays`` in float64 at theta 1e-4, gamma 0.99 (5x4
    against the stand policy, 11x7 against a random B) on
    tests/test_planners_jax.py's terms; ms a sweep and in all;
37. the best-response gate (tests/test_learner_kernel.py:459-486):
    ``fused_best_response_train`` at 32768 lanes x 300 chunks x 32 steps
    against ``get_random_policy_array(761, 5, seed=42)``, K5's counter
    +300 and nothing else launched, per chunk and at
    ``chunks_per_dispatch=8``, each mode twice (a mode's first and second
    run in the process, with their walls and splits), all four bit-equal;
    the greedy policy wins more than 95 % of the ended episodes
    (``evaluation.greedy_win_share``, 2048 lanes x 400 steps of the
    counter-RNG batched engine), and scored again as the JAX test scores
    it (``batch.init(cfg, key(9), 2048)``, a threefry rollout of 400
    steps); the mean gap of v to ``best_response_value``;
38. ``entry()``: one K5 chunk at 8192 x 64 (K5's counter +1) bit-equal to
    the plain version on the card (fields, counts, int64 sums, stats), and
    its ms;
39. the threefry slice's main path: the entry point
    ``gym_soccer_tpu_torch.examples.train_minimax``'s default mode (the
    HBM-table minimax-Q learner at 8192 envs, 2000 steps in chunks of 500,
    then ``eval_episode_stats`` at 1024 x 400) through ``main`` in this
    process, S1's, T1's, A1's and R1's counters reset just before and
    read just after (T1 ``ENTRY_T1`` launches, its keyed entry
    ``ENTRY_T1_KEYED``, S1 ``ENTRY_S1``, A1 ``ENTRY_A1``, R1
    ``ENTRY_R1``); its JSON lines checked;
40. T1 (``threefry_uniforms``, ``csrc/threefry_kernel.cu``): bit-equal to
    its plain version on the card at 8192 lanes with count 1, 2, 4 and 7,
    salt 0, 1 and 9, counters 0, 37 and 2**31 - 1, and to the plain
    version on the CPU; T1 and the plain version timed at 8192 x 2 (salt
    1, the learner's action draw) and 8192 x 1 (the inits' reset draw),
    T1's device time by the replay of a CUDA graph of 100 calls there and
    at 1 lane (the floor of a launch); its bound from the SASS of the
    action draw's instance;
41. the threefry engine: ``batch.init`` and 64 steps of ``rollout`` with
    ``random_policy_fn`` at 8192 lanes on 5x4 and 11x7, equal to the CPU
    run in every field;
42. the JAX package's learning checks on the card at their own sizes and
    thresholds (tests/test_learners.py:48, :73, :87, :130, :159 and
    tests/test_multigrid.py:206), 64 steps a CUDA-graph replay
    (``learners.GROUP_STEPS``), each with its wall seconds;
43. the entry point through ``python -m`` in fresh processes: the default
    mode at 8192 envs; ``--fused`` stopped at 640 steps and resumed to 1280
    from ``--ckpt``, bit-identical to one uninterrupted run; and
    ``--best-response player_a``;
44. ``SoccerVectorEnv`` at 8192 envs x 1000 steps, the card's stream equal
    to the CPU's;
45. the learners' CUDA-graph replays against the CPU: at 2 lanes, 162
    steps of minimax-Q, IQL, turn-based Q and mixture minimax-Q (an
    unaligned head, two replays, a period on its own, a tail) bit-equal
    to the same calls on the CPU, with S1's, T1's, A1's and R1's launches
    counted; at 512 lanes, one 64-step minimax-Q period (one replay, the
    re-solve on its last step) bit-equal in q, v, pi, n and the env
    fields, each step's |TD| within ``GRAPH_TOL``;
46. S1 (``batch.step`` on the card, ``csrc/engine_kernel.cu``): bit-equal
    to ``batch.step_plain`` on the card in every state and StepOut field
    at 8192 lanes on 5x4 and 11x7, slip 0.2 and 0, autoreset on and off,
    threefry and counter, from goal-state, wrapping and truncating lanes,
    one launch a step; captured in a CUDA graph and replayed, equal to its
    eager call; S1 and ``step_plain`` timed (call ms, and device ms by
    CUDA-graph replay) beside T1's device ms, with S1's bound; counted by
    ``torch.profiler`` right after the build, the device operations of
    one engine step, one eager minimax learner step and one evaluation
    policy draw, before (``step_plain``, the plain draw) and after (S1,
    the keyed entry), and of one A1 call (SCATTER_DEVICE_OPS);
    ``eval_episode_stats``' loop on both designs, in
    turns; T1's keyed entry (``keyed_kernel``) bit-equal to its plain
    versions, timed at the evaluation's 2 x 1024 (call ms, device ms by
    CUDA-graph replay) beside its plain version, with its bound;
47. data parallelism (parallel/mesh), NCCL at world size 1 in this
    process: the 5x4 contract, the IQL run, the alternating gate, the
    best-response gate and the --multigrid recipe (packed) at
    chunks_per_dispatch=8 without and with ``mesh=`` (the all-reduces
    captured in the CUDA graph), launches counted, bit-equal, both walls;
    the contract's exploitability 0.0034149587 and each gate's threshold
    under the mesh; ``sharded_solve_fn`` at 11705 x 600 bit-equal to R1
    replicated; the minimax-Q and IQL learning checks through
    ``sharded_*_train_fn``; ``dryrun_multichip(1)`` in a spawned rank;
48. two spawned processes on the one card over gloo with CUDA tensors
    (killed by their PIDs past a time limit): K5, K6, K7 (both sites) and
    K8-K11 at 2 x 4096 lanes x 64 steps, the all-reduced sums, counts and
    stats bit-equal to the sum of the same two shard-seed chunks run in
    this process; R1's sharded solve bit-equal to the replicated one; the
    5x4 contract at 2 x 32768 lanes per chunk, exploitability <= 0.010;
    ``save_orbax`` / ``load_orbax`` under the mesh: each rank's resume
    dict (its block of the fields) back bit-equal, the chunk resumed from
    it equal to the uninterrupted run, and this process, with no mesh,
    loading the global batch, the ranks' blocks in rank order;
49. the tools: ``tools.bench_all``'s 24 rows in this process at their
    default sizes, every kernel counter reset before each row and read
    after it: no error row, every rate finite and > 0, every slope's long
    leg longer than its short one, and each row's launches exactly those
    ``BENCH_LAUNCHES`` names for its calls, chunks and steps (every other
    counter 0); then ``tools.bench_parity_kernel`` in a subprocess: exit
    0 with both on-card checks true;
50. determinism and checkpoints: A1 (``scatter_add``,
    ``csrc/scatter_kernel.cu``, a stable radix sort by cell in one block's
    shared memory) bit-equal to its plain version (``index_add_`` on the
    CPU, lane order) in sums and counts, directly, from a CUDA-graph
    replay and on its previous design (``csrc/scatter_walk_kernel.cu``),
    on ``SCATTER_CASES`` (65536 lanes on one cell, 8192 over the 5x4
    minimax table's 19025 cells, 8192 over 3, values of magnitudes 1e-6 to
    1e2; the minimax learner's own cells and TDs at steps 1 and 64) and
    ``SCATTER_CHECKED`` (a cell on every tile's edge and a run longer than
    a tile; one lane); per timed case its design line (threads, lanes a
    tile, shared memory, radix passes, at most two device operations a
    call), the longest run, A1's and the previous design's device ms by
    CUDA-graph replay in turns; ``index_add_`` with its zero fill and the
    plain version timed at 8192 lanes (call ms, device ms by CUDA-graph
    replay), how many of 20 ``index_add_`` calls differ in a bit
    (recorded); minimax-Q with the
    entry point's halflives, IQL, turn-based Q and mixture minimax-Q on
    5x4+6x5 at 8192 lanes x 128 steps (two re-solve periods, replayed)
    bit-equal to the CPU in every state leaf, the per-step |TD| apart by
    at most ``GRAPH_TOL``; the entry point's default mode twice with
    ``--ckpt``, bit-equal with the same exploitability (phase 39's too),
    and stopped right after its step-1000 checkpoint and resumed from it,
    bit-equal to the uninterrupted run; ``save_orbax`` / ``load_orbax`` on
    the card: a K5 resume dict and an HBM-table learner state back
    bit-equal on the card, the template untouched, the resumed chunk
    equal to the uninterrupted run;
51. S2 (``multigrid.step`` / ``step_obs`` on the card) and S3
    (``alt_step`` / ``alt_step_obs``, ``csrc/mixed_alt_kernel.cu``):
    bit-equal to their plain versions in every output at S23_LANES x
    S23_STEPS (S2 on the four S2_MIXTURES, S3 on 5x4 and 11x7 at slip 0.2;
    autoreset on and off, int32 and int64 actions, with and without the
    observations; from goal-state, wrapping and truncating lanes), one
    launch a step; captured in a CUDA graph and replayed, equal to the
    eager call; S2, S3, their plain versions and S1 timed (call ms, and
    device ms by CUDA-graph replay) with S2's and S3's bounds; counted by
    ``torch.profiler`` right after the build, the device operations of
    each engine's step and of a multigrid minimax-Q, multigrid IQL and
    turn-based Q learner step before (the plain versions) and after.

``--phases`` runs one block of phases alone in a fresh process, building
only its libraries: 34-38 (K5), 39-46 and 50 (S1, S2, S3, T1, A1, R1,
K5), 47-48 or 49 (every library), 51 (S1, S2, S3, T1, A1, R1; with phase
42's turn-based and mixture checks, phase 50's learners against the CPU
and phase 49's three rows that step S2 or S3); it prints the block's
figures but no kernels line and no verdict.

The second-to-last lines are the kernels' JSON record (the 14 kernel
sites, R1, T1, its keyed entry, S1, S2, S3 and A1, with each kernel's
bound: the
larger of its bytes over the HBM rate and its SASS instructions per
step, R1's per
game-iteration (the fewer of its lanes' and its previous design's, so
that the shuffles and sums the split repeats in each lane do not raise
its bound), T1's, its keyed entry's, S1's, S2's and S3's on the shortest
way
through a thread (``path_instructions``), times its steps over the
instruction rate; A1's its additions at the float32 rate, with
``index_add_``'s ms as its ``library_ms``) and
the card's name and power limit; the last line is the JSON verdict.  The whole run prints
its wall time.  Exits non-zero, with no verdict, if anything fails or no
CUDA device is present.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

B = 8192
BOARDS = ((5, 4), (11, 7))
SLIP = 0.2
T_K1 = 1000
T_K2 = 1024
T_K5 = 64
T_K8 = 64
E_K12 = 1536
E_K13 = 768
SCRIPT_ROWS = 800
# K12/K13's second block size: fits the shared-memory budget and leaves a
# ragged last block at 8192 lanes (102 blocks of 80 and one of 32).
RAGGED_LANES = 80
# ms per call of K12 (8192 x 1536, 5x4) and K13 (8192 x 768) in their
# previous design (the collision chain per event, MT19937 states in a
# device-memory scratch), NVIDIA H100 80GB HBM3 at 700 W.
PARITY_OLD_MS = {"parity_events": 5.30, "parity_scripted_events": 3.18}
# K1/K2's second block size: 96 lanes fit the 5x4 step table's shared
# memory and leave a ragged last block at 8192 lanes (85 of 96, one of 32).
ROLLOUT_RAGGED_LANES = 96
# ms per 8192 x 1024 call of K1/K2 in their previous design (one thread a
# lane hashing and stepping, 64 blocks of 128), NVIDIA H100 80GB HBM3 at
# 700 W, as PERF.md section 6 records them.
ROLLOUT_OLD_MS = {("fused_rollout", (5, 4)): 0.637,
                  ("fused_journal_rollout", (5, 4)): 0.7148,
                  ("fused_rollout", (11, 7)): 0.6014,
                  ("fused_journal_rollout", (11, 7)): 0.6805}
# ms per call of K4 (8192 x 1024) and K5 (8192 x 64) in their previous
# design (one thread a lane hashing and stepping, 64 blocks of 128), NVIDIA
# H100 80GB HBM3 at 700 W, as PERF.md section 6 records them.
ALT_OLD_MS = {(5, 4): 0.4087, (11, 7): 0.3878}
LEARNER_OLD_MS = {(5, 4): 0.1549, (11, 7): 0.1348}
# ms per call of K3 (8192 x 1024, the 3-board mixture) and K7 (8192 x 64,
# 5x4) in their previous design (one thread a lane hashing and stepping, 64
# blocks of 128), NVIDIA H100 80GB HBM3 at 700 W (run 6 of the K4/K5
# redesign, PERF.md section 6).
MG_OLD_MS = {"multigrid_rollout": 0.4705, "learner_chunk": 0.0947}
# Device ms (CUDA-graph replay: memset, prep pass and kernel) of K6's
# previous design (one thread a lane hashing and stepping, blocks of 128)
# in each of its timed cells and of K7 multigrid's on the mixture, NVIDIA
# H100 80GB HBM3 at 700 W (ops/learner_variants.py in run 1 of the K6
# redesign, PERF.md section 6).
MG_OLD_DEVICE_MS = {
    ("multigrid_packed_learner_chunk", "mixture", 8192): 0.05568,
    ("multigrid_packed_learner_chunk", "5x4+11x7", 8192): 0.05573,
    ("multigrid_packed_learner_chunk", "mixture", 32768): 0.09594,
    ("multigrid_packed_learner_chunk", "5x4+6x5", 16384): 0.05645,
    ("multigrid_learner_chunk", "mixture", 8192): 0.06906}
# ms per 8192 x 64 call of K8/K9 in their previous design (one thread a
# lane hashing, scanning and stepping, 64 blocks of 128), NVIDIA H100 80GB
# HBM3 at 700 W (run 2 of the K3/K7 redesign, PERF.md section 6).
IQL_OLD_MS = {("iql_packed_chunk", (5, 4)): 0.1465,
              ("iql_packed_chunk", (11, 7)): 0.1202,
              ("iql_chunk", (5, 4)): 0.1442, ("iql_chunk", (11, 7)): 0.1369}
# K8/K9's second block size: a ragged last block at 8192 lanes.
IQL_RAGGED_LANES = 96
# K5 at the 5x4 contract's chunk (65536 lanes x 32 steps) beside the
# flagship 8192 x 64; the second block sizes leave a ragged last block
# (8192 / 96, 65536 / 480).
B_CONTRACT, T_CONTRACT = 65536, 32
LEARNER_RAGGED_LANES = {B: 96, B_CONTRACT: 480}
# The mixed-geometry cells: tools/bench_all.py:421's mixture, and the
# JAX package's 5x4 + 11x7 stress mixture (examples/train_minimax_tpu.py:
# 141-143).
MIX3 = ((5, 4, 0.2), (6, 5, 0.1), (8, 6, 0.3))
MIX_BIG = ((5, 4, 0.2), (11, 7, 0.2))
T_K3 = 1024
T_K6 = 64
B_WIDE = 32768   # tools/bench_all.py:333-337, the packed mixture learner
# examples/train_minimax_tpu.py:141-151 (--multigrid), at the example's
# 328M env-steps (BASELINE.md:224); gates about twice the JAX package's
# recorded per-variant exploitability 0.023 / 0.040.  Its 3,624 prepared
# rows fit a block's shared memory (K6 and K7 multigrid).
MG_BOARDS = ((5, 4, 0.2), (6, 5, 0.2))
MG_RECIPE = dict(batch=16384, n_chunks=312, chunk_len=64, lr=1.0, eps=0.2,
                 lr_anneal_start=156, lr_anneal_tau=25.0, lr_anneal_pow=1.5,
                 final_solver_iters=2000)
MG_EXPLOITABILITY = (0.05, 0.08)
T_K4 = 1024
T_K10 = 64
# K10/K11's second block size (a ragged last block at 8192 lanes) and the
# alternating gate's chunk (ALT_RECIPE's 65536 lanes x 32 steps).
ALTQ_RAGGED_LANES = 96
B_GATE, T_GATE = 65536, 32
# Device ms (CUDA-graph replay: memset and kernel) of an 8192 x 64 call of
# K10/K11 in their previous design (one thread a lane hashing, scanning and
# stepping, 64 blocks of 128), NVIDIA H100 80GB HBM3 at 700 W
# (ops/altq_variants.py in run 7 of the K10/K11 redesign, PERF.md section 6).
ALTQ_OLD_DEVICE_MS = {("altq_packed_chunk", (5, 4)): 0.0577,
                      ("altq_packed_chunk", (11, 7)): 0.0672,
                      ("altq_chunk", (5, 4)): 0.0570,
                      ("altq_chunk", (11, 7)): 0.0667}
# tests/test_altq_kernel.py:199-220 (test_altq_convergence_tpu)
ALT_RECIPE = dict(batch=65536, n_chunks=400, chunk_len=32, lr=1.0, eps=0.25,
                  eps_min=0.1, eps_halflife=300_000, lr_anneal_start=200,
                  lr_anneal_tau=25.0, lr_anneal_pow=1.5, seed=1)
ALT_V_ERR = 0.05
ALT_WIN_SHARE = 0.95
LEARNER_SRC = "gym_soccer_tpu_torch/ops/csrc/learner_kernel.cu"
SOURCE = {"fused_rollout": "gym_soccer_tpu_torch/ops/csrc/step_kernel.cu",
          "fused_journal_rollout":
              "gym_soccer_tpu_torch/ops/csrc/step_kernel.cu",
          "multigrid_rollout": "gym_soccer_tpu_torch/ops/csrc/step_kernel.cu",
          "packed_learner_chunk": LEARNER_SRC,
          "multigrid_packed_learner_chunk": LEARNER_SRC,
          "learner_chunk": LEARNER_SRC, "multigrid_learner_chunk": LEARNER_SRC,
          "iql_packed_chunk": "gym_soccer_tpu_torch/ops/csrc/iql_kernel.cu",
          "iql_chunk": "gym_soccer_tpu_torch/ops/csrc/iql_kernel.cu",
          "parity_events": "gym_soccer_tpu_torch/ops/csrc/parity_kernel.cu",
          "parity_scripted_events":
              "gym_soccer_tpu_torch/ops/csrc/parity_kernel.cu",
          "alt_rollout": "gym_soccer_tpu_torch/ops/csrc/step_kernel.cu",
          "altq_packed_chunk": "gym_soccer_tpu_torch/ops/csrc/altq_kernel.cu",
          "altq_chunk": "gym_soccer_tpu_torch/ops/csrc/altq_kernel.cu"}
REPLACES = {"fused_rollout": "gym_soccer_tpu/ops/step_kernel.py:254",
            "fused_journal_rollout": "gym_soccer_tpu/ops/step_kernel.py:714",
            "multigrid_rollout": "gym_soccer_tpu/ops/step_kernel.py:526",
            "packed_learner_chunk": "gym_soccer_tpu/ops/learner_kernel.py:666",
            "multigrid_packed_learner_chunk":
                "gym_soccer_tpu/ops/learner_kernel.py:677",
            "learner_chunk": "gym_soccer_tpu/ops/learner_kernel.py:356",
            "multigrid_learner_chunk":
                "gym_soccer_tpu/ops/learner_kernel.py:368",
            "iql_packed_chunk": "gym_soccer_tpu/ops/iql_kernel.py:212",
            "iql_chunk": "gym_soccer_tpu/ops/iql_kernel.py:64",
            "parity_events": "gym_soccer_tpu/ops/parity_kernel.py:196",
            "parity_scripted_events":
                "gym_soccer_tpu/ops/parity_kernel.py:196",
            "alt_rollout": "gym_soccer_tpu/ops/step_kernel.py:430",
            "altq_packed_chunk": "gym_soccer_tpu/ops/altq_kernel.py:222",
            "altq_chunk": "gym_soccer_tpu/ops/altq_kernel.py:70"}
# Each kernel's device function in the built libraries (a substring of its
# mangled name).
SYMBOL = {"fused_rollout": "14rollout_kernelILb0ELb1E",
          "fused_journal_rollout": "14rollout_kernelILb1ELb1E",
          "multigrid_rollout": "17mg_rollout_kernel",
          "packed_learner_chunk": "12chunk_kernelILb1ELb1ELb0E",
          "multigrid_packed_learner_chunk": "12chunk_kernelILb1ELb0ELb1E",
          "learner_chunk": "12chunk_kernelILb0ELb1ELb0E",
          "multigrid_learner_chunk": "12chunk_kernelILb0ELb0ELb1E",
          "iql_packed_chunk": "16iql_chunk_kernelILb1ELb1ELb1E",
          "iql_chunk": "16iql_chunk_kernelILb0ELb1ELb1E",
          "parity_events": "parity_kernelILb0E",
          "parity_scripted_events": "parity_kernelILb1E",
          "alt_rollout": "18alt_rollout_kernelILb1E",
          "altq_packed_chunk": "17altq_chunk_kernelILb1ELb1ELb1ELb1E",
          "altq_chunk": "17altq_chunk_kernelILb0ELb1ELb1ELb1E"}
# K1/K2/K4 on a board whose table does not fit (11x7): the arithmetic
# walk; K5 and K7 there: their prepared rows read from L2.  SYMBOL's are
# the 5x4 kernels' (the kernels line's board).  K6's and K7 multigrid's
# SYMBOL is the 3-board mixture's (rows in L2); here is their instance on
# the --multigrid recipe's 5x4+6x5, whose rows fit shared memory (the
# "arith" key of their SASS count names it).  K8/K9 keep both boards'
# prepared rows in shared memory, and on 11x7 add each visit to device
# memory (its accumulators do not fit beside them); K10/K11 on 5x4 walk
# K4's tick table beside their rows and private accumulators, and on 11x7
# walk by arithmetic beside their rows, adding to device memory.
ARITH_SYMBOL = {"fused_rollout": "14rollout_kernelILb0ELb0E",
                "fused_journal_rollout": "14rollout_kernelILb1ELb0E",
                "alt_rollout": "18alt_rollout_kernelILb0E",
                "packed_learner_chunk": "12chunk_kernelILb1ELb0ELb0E",
                "multigrid_packed_learner_chunk":
                    "12chunk_kernelILb1ELb1ELb1E",
                "learner_chunk": "12chunk_kernelILb0ELb0ELb0E",
                "multigrid_learner_chunk": "12chunk_kernelILb0ELb1ELb1E",
                "iql_packed_chunk": "16iql_chunk_kernelILb1ELb1ELb0E",
                "iql_chunk": "16iql_chunk_kernelILb0ELb1ELb0E",
                "altq_packed_chunk": "17altq_chunk_kernelILb1ELb0ELb1ELb0E",
                "altq_chunk": "17altq_chunk_kernelILb0ELb0ELb1ELb0E"}
# H100 SXM peaks (NVIDIA's data sheet): 3.35 TB/s of HBM, and 67 TFLOP/s of
# float32 outside the tensor cores, i.e. 3.35e13 FMA instructions a second
# (132 SMs x 4 schedulers x 32 lanes x 1.98 GHz), the rate at which the
# card starts instructions.  A kernel's operations are counted as the SASS
# instructions a lane runs, each against that rate.
HBM_BYTES_PER_S = 3.35e12
FLOAT32_PER_S = 67e12
INSTRUCTIONS_PER_S = 67e12 / 2
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "reference_golden.json")
# tests/test_learner_kernel.py:117-120 (test_equilibrium_convergence_tpu)
CONTRACT = dict(batch=65536, n_chunks=1000, chunk_len=32, lr=1.0, eps=0.2,
                lr_anneal_start=500, lr_anneal_tau=25.0, lr_anneal_pow=1.5,
                solver_iters=400, final_solver_iters=3000, seed=1)
CONTRACT_EXPLOITABILITY = 0.010
# The contract's exploitability as the port has read it since the K5
# redesign, to 10 digits: R1 and the grouped mode change no bit of it.
CONTRACT_READING = 0.0034149587
# The grouped dispatch mode's chunks a CUDA-graph replay, as the JAX
# package runs its recipes (examples/train_minimax_tpu.py:151, :199).
GROUPED_CHUNKS = 8
# tests/test_learner_kernel.py:145-151 (test_equilibrium_11x7_tpu), at its
# chunks_per_dispatch; evaluated with segment_iters=200.
CONTRACT_11X7 = dict(batch=65536, n_chunks=6000, chunk_len=32, lr=1.0,
                     eps=0.25, eps_halflife=40000, eps_min=0.15,
                     lr_anneal_start=2500, lr_anneal_tau=160.0,
                     lr_anneal_pow=1.2, solver_iters=600, avg_after=4000,
                     avg_q=True, final_solver_iters=3000, seed=2,
                     chunks_per_dispatch=GROUPED_CHUNKS)
CONTRACT_11X7_EXPLOITABILITY = 0.005
# R1, the RM+ solve (no TPU kernel: the JAX package's XLA ops), in the
# kernels line beside the 14 pallas_call sites.
RMPLUS = "solve_matrix_games"
RMPLUS_SRC = "gym_soccer_tpu_torch/ops/csrc/rmplus_kernel.cu"
RMPLUS_REPLACES = "gym_soccer_tpu/agents/learners.py:84"
RMPLUS_SYMBOL = "13rmplus_kernel"
# Phase 32: (label, input, games, iterations); "contract" the 5x4
# contract's Q after its first chunk (its first games where fewer), a
# number random games from a numpy seed.  761 x 400 and x 3000: the
# contract's re-solve and final solve; 761 x 200: the HBM-table learner's
# re-solve; 2502 x 200: the --multigrid recipe's; 11705 x 600: the 11x7
# contract's; 7 and 1 games leave a warp's lane groups partly empty.
RMPLUS_SHAPES = (("the contract's Q", "contract", 761, 400),
                 ("the contract's Q", "contract", 761, 3000),
                 ("the contract's Q", "contract", 761, 200),
                 ("random recipe games", 2502, 2502, 200),
                 ("random 11x7 games", 11705, 11705, 600),
                 ("the contract's first games", "contract", 7, 400),
                 ("the contract's first game", "contract", 1, 400))
# A longer independent-Q run at the learning check's lr and eps (phase 20).
IQL_RUN = dict(batch=65536, n_chunks=200, chunk_len=32, lr=0.4, eps=0.3,
               seed=1)
# Phases 34-35: the facade's random-action steps on 11x7 slip 0.2, and
# the tensors the native builder must give byte for byte.
FACADE_STEPS = 20_000
# Phase 34's fresh process: loads native/__init__.py by its path (no torch,
# no package import), times the g++ build of library argv[2], then loads it
# with its prototypes; prints the seconds and whether it loaded.
NATIVE_BUILD = """
import importlib.util, sys, time
spec = importlib.util.spec_from_file_location("native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
t0 = time.perf_counter()
native.build(sys.argv[2])
took = time.perf_counter() - t0
load = {"tables_builder": native.have_native_tables,
        "mt19937_stream": native.have_native}[sys.argv[2]]
print(took, load())
"""
TABLE_FIELDS = ("t_prob", "t_cum", "t_next_raw", "t_next_dense",
                "t_reward", "t_done", "t_mask", "t_first")
# Phase 36: tests/test_planners_jax.py:35-57's theta and gamma.
VI_THETA, VI_GAMMA = 1e-4, 0.99
# Phase 37: tests/test_learner_kernel.py:459-486 (test_br_convergence_tpu),
# scored on 2048 lanes x 400 steps of the batched engine.
BR_RECIPE = dict(batch=32768, n_chunks=300, chunk_len=32, lr=1.0,
                 gamma=0.99, eps=0.3, eps_halflife=2400, eps_min=0.05,
                 lr_anneal_start=150, lr_anneal_tau=25.0, lr_anneal_pow=1.0,
                 seed=1)
BR_OPP_SEED, BR_LANES, BR_STEPS, BR_EVAL_SEED = 42, 2048, 400, 9
BR_WIN_SHARE = 0.95


# Phases 39-46, the threefry slice.  T1, the per-lane threefry draw (no
# TPU kernel: the JAX package's XLA threefry under batch.per_env_uniforms).
T1 = "threefry_uniforms"
T1_SRC = "gym_soccer_tpu_torch/ops/csrc/threefry_kernel.cu"
T1_REPLACES = "gym_soccer_tpu/core/batch.py:157"
# T1's instance on the main path, the learner's action draw (2 uniforms,
# salt 1), whose SASS gives T1's bound; the shapes T1 is timed at, that
# draw first (its ms and bound) and the inits' reset draw (1 uniform).
T1_SYMBOL = "24threefry_uniforms_kernelILi2ELb1E"
T1_SHAPES = ((2, 1), (1, 0))
# T1's keyed entry, a kernel of its own (keyed_kernel<RANDINT>): the
# evaluation's policy draw uniform(fold_in(key, i), (2, 1024)) on the main
# path (no TPU kernel: the JAX example's jax.random draw), its uniform
# instance's symbol, and the calls a CUDA graph replays to time it.
T1_KEYED = "threefry_keyed"
T1_KEYED_REPLACES = "examples/train_minimax_tpu.py:37"
T1_KEYED_SYMBOL = "12keyed_kernelILb0E"
T1_KEYED_SHAPE = (2, 1024)
KEYED_GRAPH_CALLS = 100
# Phase 46, S1: the batched engine's step, its draws inside (no TPU
# kernel: the JAX package's XLA batch.step).  Its instance on the main
# path (threefry, autoreset, int64 actions), whose SASS gives its bound;
# each bit-equality case's steps; the calls a CUDA graph replays to time
# S1 and its plain version.
S1 = "engine_step"
S1_SRC = "gym_soccer_tpu_torch/ops/csrc/engine_kernel.cu"
S1_REPLACES = "gym_soccer_tpu/core/batch.py:227"
S1_SYMBOL = "18engine_step_kernelILi0ELb1ELb1E"
S1_STEPS = 6
S1_GRAPH_CALLS, PLAIN_GRAPH_CALLS = 100, 10
# A1: the HBM-table learners' scatter-add in lane order (no TPU kernel:
# the JAX package's XLA scatter-add, its IQL update's first).
SCATTER = "scatter_add"
SCATTER_SRC = "gym_soccer_tpu_torch/ops/csrc/scatter_kernel.cu"
SCATTER_REPLACES = "gym_soccer_tpu/agents/learners.py:193"
# Phase 51, S2 and S3: the mixed-geometry engine's step and the
# alternating engine's tick, their draws and autoreset inside (no TPU
# kernel: the JAX package's XLA multigrid.step and alt_step).  Their
# instances on the main paths (autoreset, the learners' observations,
# int64 actions), whose SASS gives their bounds; the cases held bit-equal
# to the plain versions at S23_LANES x S23_STEPS: mixtures of (width,
# height, slip) boards, lane i on variant i % nV (tools/bench_all's row,
# the --multigrid recipe's, 5x4+11x7, and slips whose two thresholds
# round differently from S1's constants), and the alternating boards at
# slip 0.2; the mixture and board they are timed on.
S2, S3 = "multigrid_step", "alt_step"
S23_SRC = "gym_soccer_tpu_torch/ops/csrc/mixed_alt_kernel.cu"
S2_REPLACES = "gym_soccer_tpu/core/multigrid.py:186"
S3_REPLACES = "gym_soccer_tpu/envs/soccer_alternating_env.py:94"
S2_SYMBOL = "21multigrid_step_kernelILb1ELb1ELb1E"
S3_SYMBOL = "15alt_step_kernelILb1ELb1E"
S2_MIXTURES = {"bench row": ((5, 4, 0.2), (6, 5, 0.1), (9, 6, 0.3)),
               "--multigrid recipe": ((5, 4, 0.2), (6, 5, 0.2)),
               "5x4+11x7": ((5, 4, 0.2), (11, 7, 0.2)),
               "slips 0.058, 0.111": ((5, 4, 0.058), (6, 5, 0.111))}
S3_BOARDS = ((5, 4), (11, 7))
S23_LANES, S23_STEPS = 8192, 256
S23_TIMED = "bench row"
# The redesign's yardsticks, built by ops/mixed_alt_variants and timed in
# phase 51 beside S2 and S3: their previous design (blocks of 256 lanes,
# the observations' and the reset's reads after the draws), the kernel
# built at each other lanes-a-block shape, and an empty kernel launched
# with the grid and block of each shape (the floor); the widths each is
# timed at (mixed_alt_variants.CASES: S3 at 8192 lanes, the turn-based Q
# check's 256 and alt_policy_rollout's 128 on 5x4; S2 at 8192 on the
# bench mixture and at the mixture check's 512 on its 5x4+6x4 and on the
# bench mixture), the lanes-a-block shapes and the turns of the timing.
S23_VARIANTS = "gym_soccer_tpu_torch/ops/mixed_alt_variants.py"
S23_PREV_SRC = "gym_soccer_tpu_torch/ops/csrc/mixed_alt_prev_kernel.cu"
S23_FLOOR_SRC = "gym_soccer_tpu_torch/ops/csrc/launch_floor_kernel.cu"
S23_WIDTHS = {S3: (8192, 256, 128), S2: (8192, 512, 512)}
S23_SHAPES = (32, 64, 128, 256)
S23_ROUNDS = 4
S23_LEG_MS = 10.0   # time_cuda's legs there: the turns give the spread
# Their main paths, phase 42's learning checks: the mixture check's two
# multigrid_minimax_train runs of 2000 steps (S2 once a step), the
# turn-based Q checks' two altq_train runs of 15000 (against a frozen B,
# 12000) steps and their alt_policy_rollout of 300 (S3 once a step).
MIX_CHECK_S2 = 2 * 2000
ALTQ_CHECK_S3 = 2 * 15000 + 300
ALTQ_FROZEN_S3 = 2 * 12000 + 300
# The kernels no TPU kernel precedes: their sources and the JAX functions
# they compute.
ADDED_SOURCE = {RMPLUS: RMPLUS_SRC, T1: T1_SRC, T1_KEYED: T1_SRC,
                S1: S1_SRC, S2: S23_SRC, S3: S23_SRC, SCATTER: SCATTER_SRC}
ADDED_REPLACES = {RMPLUS: RMPLUS_REPLACES, T1: T1_REPLACES,
                  T1_KEYED: T1_KEYED_REPLACES, S1: S1_REPLACES,
                  S2: S2_REPLACES, S3: S3_REPLACES,
                  SCATTER: SCATTER_REPLACES}
# The entry point's default mode at its own widths (examples/
# train_minimax_tpu.py:247-251), 2000 steps in chunks of 500: per step T1
# draws the learner's actions, S1 steps the engine (the transition's and
# the resets' draws inside it) and A1 sums the update, R1 re-solves every
# 64th step; then eval_episode_stats' 400 steps (T1's keyed entry and S1 a
# step) and the two initialisations (T1).
ENTRY = ["--envs", "8192", "--chunk", "500", "--steps", "2000"]
ENTRY_T1, ENTRY_T1_KEYED = 1 + 2000 + 1, 400
ENTRY_S1 = 2000 + 400
ENTRY_A1 = 2000
ENTRY_R1 = 2000 // 64
# Phase 45: GRAPH_STEPS from step GRAPH_START at resolve_every 16 (4
# periods a replay) run a head of 11 steps, two replays, one period on its
# own and a tail of 7, at GRAPH_LANES lanes.  GRAPH_WIDE: the learning
# checks' width, for one 64-step period (one replay).
GRAPH_LANES, GRAPH_START, GRAPH_STEPS, GRAPH_WIDE = 2, 5, 162, 512
# Phase 45's tolerance at GRAPH_WIDE for each step's mean |TD|, relative
# to 1 + |TD|: the card's mean reduces in another order than the CPU's.
# Every state leaf is bit-equal (A1 adds the scatter-adds in lane order).
GRAPH_TOL = 1e-6
# Phase 50, A1 (scatter_add, csrc/scatter_kernel.cu): its inputs, name ->
# (lanes, cells, cells hit: a number, None for uniform over the cells, or
# "learner"): every lane on one cell, the entry point's width over the 5x4
# minimax table's 761 x 25 cells, and over 3 cells, values of magnitudes
# 10**-6 to 10**2 with random signs; and the cells and TDs of the port's
# minimax_train at the entry point's recipe at its steps 1 and 64, from a
# run on the CPU (ops/scatter_variants.py, whose CASES these are).  Each
# is timed on the kernel and its previous design by the replay of a CUDA
# graph of SCATTER_GRAPH_CALLS calls; index_add_ and the plain version on
# SCATTER_TIMED, index_add_'s bits compared over SCATTER_REPEATS calls.
# SCATTER_CHECKED are held bit-equal too, untimed: a cell on both sides of
# every tile's edge and a run longer than a tile, and one lane.
SCATTER_CASES = {"one cell": (65536, 19025, 1),
                 "minimax table": (8192, 19025, None),
                 "3 cells": (8192, 3, 3),
                 "learner step 1": (8192, 19025, "learner"),
                 "learner step 64": (8192, 19025, "learner")}
SCATTER_CHECKED = ("tiles", "one lane")
SCATTER_TIMED = "minimax table"
SCATTER_REPEATS, SCATTER_GRAPH_CALLS = 20, 100
# A1's launch: one kernel, which writes every cell (no zero fill).
SCATTER_DEVICE_OPS = 1
# Phase 50, the four HBM-table learners at the entry point's width: two
# re-solve periods of 64 steps each, on the card (replays) and the CPU.
DET_LANES, DET_STEPS = 8192, 128
# The entry point's default mode stopped right after its checkpoint at
# this step and resumed from --ckpt.
ENTRY_STOP = 1000
# --fused stopped at 640 steps and resumed to 1280 from --ckpt.
FUSED_STEPS = (640, 1280)
# Phases 47-48, data parallelism (parallel/mesh).  Phase 48's chunks: the
# eight kernel sites (launch-count name -> game, packed, mixture) on
# 2 ranks x DP_LANES lanes x DP_STEPS steps, the mixture the --multigrid
# recipe's boards; the sharded re-solve at the 11x7 contract's games and
# iterations (phase 47 too); the ranks' time limit, past which they are
# killed by their PIDs.
DP_SITES = {"packed_learner_chunk": ("minimax", True, False),
            "multigrid_packed_learner_chunk": ("minimax", True, True),
            "learner_chunk": ("minimax", False, False),
            "multigrid_learner_chunk": ("minimax", False, True),
            "iql_packed_chunk": ("iql", True, False),
            "iql_chunk": ("iql", False, False),
            "altq_packed_chunk": ("altq", True, False),
            "altq_chunk": ("altq", False, False)}
DP_RANKS, DP_LANES, DP_STEPS = 2, 4096, 64
DP_SEED, DP_EPS_INT, DP_OFFSET = 7, int(0.3 * 65536), 64
DP_SOLVE = (11705, 600)
DP_TIMEOUT = 300.0
# Phase 49, the tools' sweep: the launches of each tools.bench_all row, as
# {counter: (unit, n, once)}: n launches a call ("call"), a chunk of a call
# ("chunk") or a step of a call ("step"), and ``once`` more at its set-up
# (an engine's initial reset draw); every other counter stays at 0.
BENCH_LAUNCHES = {
    "facade_single_env": {},
    "xla_batch_engine_traj": {"engine_step": ("step", 1, 0),
                              "threefry_keyed": ("step", 1, 0),
                              "threefry_uniforms": ("step", 0, 1)},
    "xla_stats_threefry": {"engine_step": ("step", 1, 0),
                           "threefry_uniforms": ("step", 1, 1)},
    "xla_stats_counter": {"engine_step": ("step", 1, 0),
                          "threefry_uniforms": ("step", 0, 1)},
    "xla_multigrid_mixed": {"multigrid_step": ("step", 1, 0),
                            "threefry_uniforms": ("step", 1, 1)},
    "xla_alternating_engine": {"alt_step": ("step", 1, 0),
                               "threefry_uniforms": ("step", 0, 1)},
    "xla_altq_learner": {"alt_step": ("step", 1, 0),
                         "threefry_uniforms": ("step", 1, 1),
                         "scatter_add": ("step", 1, 0)},
    "pallas_minimax_learner": {"learner_chunk": ("chunk", 1, 0)},
    "pallas_minimax_learner_packed": {
        "packed_learner_chunk": ("chunk", 1, 0)},
    "pallas_learner_11x7_packed": {"packed_learner_chunk": ("chunk", 1, 0)},
    "pallas_br_learner": {"packed_learner_chunk": ("chunk", 1, 0)},
    "pallas_iql_learner": {"iql_chunk": ("chunk", 1, 0)},
    "pallas_iql_learner_packed": {"iql_packed_chunk": ("chunk", 1, 0)},
    "pallas_multigrid_learner": {"multigrid_learner_chunk": ("chunk", 1, 0)},
    "pallas_multigrid_learner_packed": {
        "multigrid_packed_learner_chunk": ("chunk", 1, 0)},
    "pallas_altq_learner": {"altq_chunk": ("chunk", 1, 0)},
    "pallas_altq_learner_packed": {"altq_packed_chunk": ("chunk", 1, 0)},
    "parity_bit_exact": {},
    "parity_kernel_fused": {"parity_events": ("call", 1, 0)},
    "pallas_fused": {"fused_rollout": ("call", 1, 0)},
    "pallas_fused_journal": {"fused_journal_rollout": ("call", 1, 0)},
    "pallas_multigrid_fused": {"multigrid_rollout": ("call", 1, 0)},
    "pallas_alt_fused": {"alt_rollout": ("call", 1, 0)},
    "table_build_native": {},
}
BENCH_PARITY_TIMEOUT = 300.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ints(stats):
    return [int(x) for x in stats]


def max_abs_err(pairs):
    """max |a - b| over pairs of integer tensors (or ints)."""
    import torch
    err = 0
    for a, b in pairs:
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            d = (a.cpu().long() - b.cpu().long()).abs().max()
            err = max(err, int(d))
    return err


def bits_equal(a, b) -> bool:
    """Tensors equal in dtype, shape and every bit (-0.0 and NaN
    payloads included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def sass_listing(path):
    """``cuobjdump -sass`` of the library at ``path``."""
    from gym_soccer_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def added_instructions(_build):
    """{kernel name: SASS instructions on the shortest way through a
    thread} of T1's main path instance, its keyed entry's, S1's, S2's and
    S3's (``path_instructions``)."""
    counts = {}
    for name, library, sym in ((T1, "threefry_kernel", T1_SYMBOL),
                               (T1_KEYED, "threefry_kernel", T1_KEYED_SYMBOL),
                               (S1, "engine_kernel", S1_SYMBOL),
                               (S2, "mixed_alt_kernel", S2_SYMBOL),
                               (S3, "mixed_alt_kernel", S3_SYMBOL)):
        found = path_instructions(sass_listing(_build.build(library)), [sym])
        check(len(found) == 1, f"{name}: {len(found)} kernels match {sym}")
        counts[name] = next(iter(found.values()))
    return counts


def sass_loop_instructions(path, names=None):
    """{mangled kernel name: SASS instructions per trip of its main loop}
    in the library at ``path``; see ``loop_instructions``."""
    return loop_instructions(sass_listing(path), names)


BRANCH = re.compile(r"^(@!?U?P\d\s+)?BRA\s+(?:!?U?P\d,\s*)?0x([0-9a-f]+)")
SHARED_STORE = re.compile(r"^(@!?U?P\d\s+)?STS(\.\S+)?\s")
# K12/K13 twist each lane's 624-word MT19937 state once every 312 events.
TWIST = (624, 312)
TWISTING = (SYMBOL["parity_events"], SYMBOL["parity_scripted_events"])
BARRIER_WAIT = re.compile(r"^(@!?U?P\d\s+)?BAR\.SYNC")
# fmix32's first multiplier, 0x85EBCA6B, as SASS writes it: every
# producer's code loop hashes.
HASH = re.compile(r"-0x7a143595|0x85ebca6b")
# Accumulation atomics: to device memory (RED, ATOM) or to a block's own
# accumulators in shared memory (ATOMS).
ATOMIC = re.compile(r"(@!?U?P\d\s+)?(RED|ATOM)[GS]?\.")
# K1-K11 split a lane-step between two threads: a producer makes its step
# code, one a trip of the innermost loop that stores codes to shared
# memory, and the lane's consumer walks TILE_STEPS steps a trip of an
# innermost loop that waits on a barrier for the tile (the table walk and
# the arithmetic walk; csrc/step_kernel.cu kTileSteps, csrc/
# learner_kernel.cu, csrc/iql_kernel.cu and csrc/altq_kernel.cu kTile).
SPLIT = ("14rollout_kernelI", "18alt_rollout_kernelI", "17mg_rollout_kernel",
         "12chunk_kernelI", "16iql_chunk_kernelI", "17altq_chunk_kernelI")
TILE_STEPS = 8


def loop_instructions(text, names=None):
    """``sass_loop_instructions`` of a ``cuobjdump -sass`` listing, for the
    kernels whose mangled name contains one of ``names`` (all by default).

    The main loop is the span of the longest backward branch (the step or
    event loop).  A trip around it counts the instructions on the shortest
    way from its head to that back edge through the loop's control flow:
    the instructions every step (or event) issues whatever its data.  An
    if/else counts its shorter side, and a block that a branch may skip (a
    goal's reset, a collision's resolution) counts not at all, with one
    exception: a branch that skips atomics (RED, ATOM to device memory,
    ATOMS to shared memory) is taken as not taken.  Those blocks are the
    step's accumulation, which K5-K11 skip only on a lane's first step,
    the one with no pending visit.  A call counts as one instruction.

    K12 and K13 (``TWISTING``) rewrite each lane's 624-word MT19937 state
    in shared memory once every 312 events (``TWIST``), in loops nested in
    the main loop behind a branch.  Their count adds 624 / 312 times the
    fewest instructions per word of those loops (a nested loop's body over
    the shared-memory stores it makes).

    K1-K11 (``SPLIT``) serve each lane-step from two loops, neither
    nested in another: the count is the shortest way around the
    producers' (the innermost loop holding a shared-memory store: one step
    code a trip) plus the shortest way around the consumers' over
    TILE_STEPS (the innermost loops holding a barrier wait, the fewest of
    them: a tile a trip).  A producer's loop hashes (``HASH``): a loop that
    stores to shared memory without hashing (K8-K11 zeroing their private
    accumulators) is no producer's."""
    counts = {}
    for name, ins in sass_functions(text, names).items():
        loops = [(int(b.group(2), 16), addr) for addr, op in ins
                 for b in [BRANCH.match(op)]
                 if b and int(b.group(2), 16) < addr]
        check(loops, f"no loop found in the SASS of {name}")
        if any(sym in name for sym in SPLIT):
            counts[name] = _split_count(name, ins, loops)
            continue
        lo, hi = max(loops, key=lambda span: span[1] - span[0])
        body = [(addr, op) for addr, op in ins if lo <= addr <= hi]
        at = {addr: i for i, (addr, _) in enumerate(body)}
        counts[name] = _trip(name, body)
        if any(sym in name for sym in TWISTING):
            per_word = [
                (end - start + 1) / stores
                for start, end in ((at[t], at[a]) for t, a in loops
                                   if t in at and (t, a) != (lo, hi))
                for stores in [sum(bool(SHARED_STORE.match(op))
                                   for _, op in body[start:end + 1])]
                if stores]
            check(per_word, f"no shared-memory loop to amortise in {name}")
            counts[name] += TWIST[0] / TWIST[1] * min(per_word)
    return counts


def sass_functions(text, names=None):
    """{mangled kernel name: [(address, instruction), ...]} of a
    ``cuobjdump -sass`` listing, for the kernels whose name contains one
    of ``names`` (all by default)."""
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:   # a function seen before is a second copy of the same code
            name = m.group(1) if m.group(1) not in kernels else None
            if name and names is not None and not any(
                    n in name for n in names):
                name = None
            if name:
                kernels[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and name:
            kernels[name].append((int(m.group(1), 16), m.group(2).strip()))
    return kernels


def path_instructions(text, names=None):
    """{mangled kernel name: SASS instructions a thread issues on the
    shortest way from the kernel's entry to an unpredicated EXIT} for the
    kernels of one thread a lane (T1, its keyed entry, S1): ``_shortest``
    over the whole kernel.  A predicated EXIT (the lanes past the last)
    counts as issued and not taken, a loop as the fewest trips its
    branches allow, a call as one instruction."""
    counts = {}
    for name, ins in sass_functions(text, names).items():
        found = _shortest(ins, lambda j: ins[j][1] == "EXIT")
        check(found < math.inf, f"no way to an EXIT in the SASS of {name}")
        counts[name] = found
    return counts


def _trip(name, body):
    """The fewest instructions from the head of the loop ``body`` (its
    (address, op) pairs) to its back edge, inclusive."""
    found = _shortest(body, lambda j: j == len(body) - 1)
    check(found < math.inf, f"no way around the loop of {name}")
    return found


def _shortest(body, end):
    """The fewest instructions from ``body[0]`` to an instruction ``j``
    with ``end(j)``, both inclusive (math.inf if none): a breadth-first
    search over ``_successors`` in which every instruction weighs one."""
    at = {addr: i for i, (addr, _) in enumerate(body)}
    atomic = [bool(ATOMIC.match(op)) for _, op in body]
    dist = [math.inf] * len(body)
    dist[0], todo = 1, [0]
    for j in todo:
        if end(j):
            return dist[j]
        for k in _successors(body, at, atomic, j):
            if dist[k] == math.inf:
                dist[k] = dist[j] + 1
                todo.append(k)
    return math.inf


def _split_count(name, ins, loops):
    """A split kernel's instructions per lane-step (``loop_instructions``)."""
    innermost = [(t, a) for t, a in loops
                 if not any((t2, a2) != (t, a) and t <= t2 and a2 <= a
                            for t2, a2 in loops)]
    trips = {"producer": [], "consumer": []}
    for t, a in innermost:
        body = [(addr, op) for addr, op in ins if t <= addr <= a]
        if any(SHARED_STORE.match(op) for _, op in body) and any(
                HASH.search(op) for _, op in body):
            trips["producer"].append(_trip(name, body))
        elif any(BARRIER_WAIT.match(op) for _, op in body):
            trips["consumer"].append(_trip(name, body))
    for role, found in trips.items():
        check(found, f"no {role} loop found in the SASS of {name}")
    return min(trips["producer"]) + min(trips["consumer"]) / TILE_STEPS


def _successors(body, at, atomic, j):
    """Indices in ``body`` (a loop or a whole kernel) that instruction
    ``j`` may pass control to; the last (a loop's back edge) and an
    unpredicated EXIT have none, and a forward branch over an atomic is
    not taken (atomics count in full)."""
    if j == len(body) - 1:
        return ()
    b = BRANCH.match(body[j][1])
    if b is None:
        return () if body[j][1] == "EXIT" else (j + 1,)
    target = at.get(int(b.group(2), 16))
    if b.group(1) is None and "," not in body[j][1]:   # unconditional
        return () if target is None else (target,)
    if target is not None and target > j and any(atomic[j + 1:target]):
        return (j + 1,)
    return (j + 1,) if target is None else (j + 1, target)


def ptxas_registers(log):
    """{mangled kernel name: registers per thread} from nvcc's ``-Xptxas
    -v`` report."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def bound(units, instructions, nbytes):
    """(ms, 'bytes' or 'operations'): the least time of ``units`` lane-steps
    (or lane-events) of ``instructions`` SASS instructions each, moving
    ``nbytes``, at the card's instruction rate and HBM rate."""
    ops_ms = units * instructions / INSTRUCTIONS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def time_cuda(fn, min_leg_ms=50.0, legs=5, slow_legs=None):
    """Median ms per call of ``fn`` over ``legs`` legs, each of enough
    back-to-back calls to last at least ``min_leg_ms``; CUDA events.  With
    ``slow_legs``, a function whose call takes over a second is timed over
    that many legs instead."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    one = e0.elapsed_time(e1)
    if slow_legs is not None and one > 1000.0:
        legs = slow_legs
    reps = max(1, math.ceil(min_leg_ms / max(one, 1e-3)))
    per_call = []
    for _ in range(legs):
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        per_call.append(e0.elapsed_time(e1) / reps)
    return statistics.median(per_call), reps, per_call


def grouped_phase(torch, label, train, per, per_wall, n_tensors, counts,
                  kernel, n_chunks, card, solves=None):
    """A trainer's grouped mode against its per-chunk run ``per`` on the
    card.  ``train(chunks_per_dispatch=GROUPED_CHUNKS, timing=...)`` runs
    with the launch counters ``counts`` and R1's reset just before and read
    just after: it must launch ``kernel`` replays x g plus the remainder
    times (R1 ``solves`` times, where given), which rules out an eager run
    in place of the replays, and give the per-chunk run's first
    ``n_tensors`` outputs bit for bit and its history's rows.  Returns the
    grouped run's outputs, its wall time in s and its timing."""
    from gym_soccer_tpu_torch.agents import learners
    g = GROUPED_CHUNKS
    for d in (counts, learners.launch_counts):
        for k in d:
            d[k] = 0
    timing = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train(chunks_per_dispatch=g, timing=timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replays, rest = divmod(n_chunks, g)
    launched = counts[kernel]
    check(timing["replays"] == replays and launched == replays * g + rest,
          f"{label}: {launched} launches of {kernel} over "
          f"{timing['replays']} replays, not {replays} x {g} + {rest}")
    if solves is not None:
        check(learners.launch_counts[RMPLUS] == solves,
              f"{label}: {learners.launch_counts[RMPLUS]} launches of R1, "
              f"not {solves}")
    same = all(torch.equal(a, b.to(a.device))
               for a, b in zip(per[:n_tensors], out[:n_tensors]))
    rows = [r for k, r in enumerate(out[n_tensors])
            if k % 16 == 0 or k == n_chunks - 1]
    check(same and per[n_tensors] == rows and len(out[n_tensors]) == n_chunks,
          f"{label}: the grouped run differs from the per-chunk run")
    print(f"[grouped] {label}, chunks_per_dispatch={g}: {replays} replays "
          f"of one CUDA graph of {g} chunks and {rest} chunk(s) one at a "
          f"time; {kernel} launched {launched} times"
          + (f", R1 {solves}" if solves is not None else "")
          + f"; outputs and history bit-equal to the per-chunk run | wall "
          f"{wall} s against the per-chunk run's {per_wall} s: capture "
          f"{timing['capture_ms']} ms (host clock, with one warm-up "
          f"chunk), replays {timing['segments_ms']} ms, remainder "
          f"{timing['remainder_ms']} ms (CUDA events) | {card}")
    return out, wall, timing


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Build and drive the port on one CUDA device.")
    parser.add_argument(
        "--phases", choices=("34-38", "39-46", "47-48", "49", "50", "51"),
        help="build only the block's libraries (34-38: K5; 39-46 and 50: "
             "S1, S2, S3, T1, A1, R1 and K5; 47-48 and 49: every library; "
             "51: S1, S2, S3, T1, A1 and R1) and run its phases alone, in "
             "this fresh process: their figures before any earlier phase "
             "has run; prints no kernels line and no verdict")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from gym_soccer_tpu_torch.agents.evaluation import exploitability
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, tables
    from gym_soccer_tpu_torch.ops import _build
    from gym_soccer_tpu_torch.ops import learner_codes as lc
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.ops import rollout_codes as rc
    from gym_soccer_tpu_torch.ops import step_kernel as sk

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    if args.phases:
        libraries, run = {
            "34-38": (("learner_kernel",),
                      lambda: surface_phases(torch, dev, card, lk)),
            "39-46": (("engine_kernel", "mixed_alt_kernel",
                       "threefry_kernel", "rmplus_kernel", "scatter_kernel",
                       "learner_kernel"),
                      lambda: threefry_phases(
                          torch, dev, card, added_instructions(_build),
                          step_counts)),
            "47-48": (tuple(_build.LIBRARIES),
                      lambda: mesh_phases(torch, dev, card, exploitability)),
            "49": (tuple(_build.LIBRARIES),
                   lambda: tools_phase(torch, dev, card)),
            "50": (("engine_kernel", "mixed_alt_kernel", "threefry_kernel",
                    "rmplus_kernel", "scatter_kernel", "learner_kernel"),
                   lambda: determinism_phase(torch, dev, card)),
            "51": (("engine_kernel", "mixed_alt_kernel", "threefry_kernel",
                    "rmplus_kernel", "scatter_kernel"),
                   lambda: mixed_alt_block(
                       torch, dev, card, added_instructions(_build),
                       s23_counts)),
        }[args.phases]
        t0 = time.perf_counter()
        from concurrent.futures import ThreadPoolExecutor
        from gym_soccer_tpu_torch.ops import mixed_alt_variants
        extra = mixed_alt_variants.builders() if args.phases == "51" else []
        with ThreadPoolExecutor(len(libraries) + len(extra)) as pool:
            list(pool.map(lambda f: f(), (   # one nvcc each
                *(lambda n=n: _build.build(n) for n in libraries), *extra)))
        for name in libraries:
            _build.load(name)
        print(f"[build] {', '.join(libraries)}"
              f"{' and S2/S3 variants' if extra else ''}"
              f" in {time.perf_counter() - t0:.3f} s")
        step_counts = (step_kernel_counts(torch, dev, card)
                       if args.phases == "39-46" else None)
        s23_counts = (mixed_alt_counts(torch, dev, card)
                      if args.phases == "51" else None)
        run()
        print(f"[done] chip_smoke.py --phases {args.phases} ran "
              f"{time.perf_counter() - t_start} s")
        return 0

    # ---- 2. build -----------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from gym_soccer_tpu_torch.ops import (mixed_alt_variants,
                                          rmplus_variants, scatter_variants)
    t0 = time.perf_counter()
    s23_jobs = mixed_alt_variants.builders()
    with ThreadPoolExecutor(2 + len(s23_jobs)) as pool:   # one nvcc each
        thread_build = pool.submit(rmplus_variants.build_variant,
                                   rmplus_variants.PREVIOUS)
        walk_build = pool.submit(scatter_variants.build_variant,
                                 scatter_variants.PREVIOUS)
        s23_builds = [pool.submit(f) for f in s23_jobs]
        built = _build.build_all()
        thread_build = thread_build.result()
        walk_build = walk_build.result()
        s23_builds = [f.result() for f in s23_builds]
    for name in built:
        _build.load(name)
    print(f"[build] {', '.join(p.name for p in built.values())} and the "
          f"previous designs of R1, {thread_build.name}, of A1, "
          f"{walk_build.name}, and of S2/S3, {s23_builds[0].name}, the "
          f"empty kernel, {s23_builds[1].name}, and S2/S3 at other lanes a "
          f"block, {', '.join(b.name for b in s23_builds[2:])}, in "
          f"{time.perf_counter() - t0:.3f} s")
    for path in built.values():
        print(path.with_suffix(".log").read_text().strip())
    # early in the process, where the profiler records every launch
    step_counts = step_kernel_counts(torch, dev, card)
    s23_counts = mixed_alt_counts(torch, dev, card)
    shape = (ctypes.c_int32 * 3)()
    sk._library().gst_rollout_shape(ctypes.addressof(shape))
    check(shape[0] == TILE_STEPS, f"K1/K2/K4 tiles of {shape[0]} steps, "
          f"the bound counts {TILE_STEPS}")
    k5_shape = (ctypes.c_int32 * 3)()
    lk._library().gst_chunk_shape(ctypes.addressof(k5_shape))
    check(k5_shape[0] == TILE_STEPS, f"K5/K7 tiles of {k5_shape[0]} steps, "
          f"the bound counts {TILE_STEPS}")
    check((k5_shape[0], k5_shape[1], k5_shape[2]) ==
          (lc.TILE_STEPS, lc.STAGES, lc.PRODUCER_WARPS),
          "K5/K7's ring differs from learner_codes'")
    from gym_soccer_tpu_torch.ops import iql_codes as qc
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    k8_shape = (ctypes.c_int32 * 3)()
    ik._library().gst_iql_shape(ctypes.addressof(k8_shape))
    check((k8_shape[0], k8_shape[1], k8_shape[2]) ==
          (TILE_STEPS, qc.STAGES, qc.PRODUCER_WARPS),
          "K8/K9's ring differs from iql_codes' or the bound's tile")
    from gym_soccer_tpu_torch.ops import altq_codes as ac
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    k10_shape = (ctypes.c_int32 * 3)()
    ak._library().gst_altq_shape(ctypes.addressof(k10_shape))
    check((k10_shape[0], k10_shape[1], k10_shape[2]) ==
          (TILE_STEPS, ac.STAGES, ac.PRODUCER_WARPS),
          "K10/K11's ring differs from altq_codes' or the bound's tile")
    loops = {}
    for path in built.values():
        loops.update(sass_loop_instructions(
            path, [*SYMBOL.values(), *ARITH_SYMBOL.values(), RMPLUS_SYMBOL]))
    per_step = {}
    for name, sym in [*SYMBOL.items(),
                      *((n + " arith", s) for n, s in ARITH_SYMBOL.items()),
                      (RMPLUS, RMPLUS_SYMBOL)]:
        found = [n for k, n in loops.items() if sym in k]
        check(len(found) == 1, f"{name}: {len(found)} kernels match {sym}")
        per_step[name] = found[0]
    print(f"[build] SASS instructions per lane-step (K12/K13: lane-event, "
          f"with the MT19937 twist amortised over its {TWIST[1]} events; "
          f"K1-K11: a producer's code loop plus a consumer's tile loop "
          f"over its {TILE_STEPS} steps, 'arith' the walk of boards whose "
          f"table does not fit; R1: a lane-iteration) on the shortest way "
          f"around each kernel's main loop (cuobjdump -sass): {per_step}")

    cfgs = {b: EnvConfig(width=b[0], height=b[1], slip_prob=SLIP)
            for b in BOARDS}

    # ---- 3. main path, through the user entry points -------------------
    sk.reset_launch_counts()
    main_out = {}
    for board, cfg in cfgs.items():
        seed = 11 + board[0]
        k1 = sk.fused_rollout(cfg, seed, B, T_K1, dev)
        k2 = sk.fused_journal_rollout(cfg, seed, B, T_K2, dev)
        traj = sk.unpack_journal(cfg, k2[2])
        main_out[board] = (seed, k1, k2, traj)
    torch.cuda.synchronize()
    launches = {k: sk.launch_counts[k]
                for k in ("fused_rollout", "fused_journal_rollout")}
    print(f"[main path] launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    for board, (seed, k1, k2, traj) in main_out.items():
        cfg = cfgs[board]
        ss = tables.build_statespace(cfg)
        r2d = torch.as_tensor(ss.raw_to_dense, device=dev)
        for fields, stats, T in ((k1[0], k1[1], T_K1), (k2[0], k2[1], T_K2)):
            ra, ca, rb, cb, p, t = fields
            dense = r2d[((((ra * cfg.W + ca) * cfg.H + rb) * cfg.W + cb) * 2
                         + p).long()]
            check(bool((dense > 0).all()), "a lane ended terminal/unreachable")
            check(bool(((t >= 0) & (t < cfg.max_steps)).all()), "t out of range")
            rew, goals, truncs = ints(stats)
            check(0 < goals < B * T and abs(rew) <= goals and truncs >= 0,
                  f"implausible stats {ints(stats)}")
        rew, goals, truncs = ints(k2[1])
        check(int(traj["done"].sum()) == goals, "journal goals != stats")
        check(int(traj["truncated"].sum()) == truncs, "journal truncs != stats")
        check(int(traj["reward_a"].sum()) == rew, "journal reward != stats")
        check(int(traj["obs"].min()) >= 0 and int(traj["obs"].max()) < ss.nS,
              f"obs outside [0, {ss.nS})")
        check(int(traj["actions_a"].max()) <= 4, "action outside the space")
        print(f"[main path] {board[0]}x{board[1]} B={B}: K1 T={T_K1} stats "
              f"{ints(k1[1])}; K2 T={T_K2} stats {ints(k2[1])}, obs in "
              f"[0, {ss.nS})")

    errs = {"fused_rollout": 0, "fused_journal_rollout": 0}

    # ---- 4. K1 ---------------------------------------------------------
    for board, (seed, k1, _, _) in main_out.items():
        cfg = cfgs[board]
        pf, ps = sk.fused_rollout_plain(cfg, seed, B, T_K1, dev)
        e = max_abs_err([*zip(k1[0], pf), (ints(k1[1]), ints(ps))])
        errs["fused_rollout"] = max(errs["fused_rollout"], e)
        check(e == 0, f"K1 != plain on {board}: max abs err {e}")
        for lanes in (ROLLOUT_RAGGED_LANES, 32):
            fl, sl = sk.fused_rollout(cfg, seed, B, T_K1, dev, threads=lanes)
            check(max_abs_err([*zip(fl, pf), (ints(sl), ints(ps))]) == 0,
                  f"K1 at {lanes} lanes per block != plain on {board}")
        h = T_K1 // 2
        fa, sa = sk.fused_rollout(cfg, seed, B, h, dev)
        fb, sb = sk.fused_rollout(cfg, seed, B, T_K1 - h, dev,
                                  init_fields=fa, step_offset=h)
        split = [x + y for x, y in zip(ints(sa), ints(sb))]
        check(max_abs_err([*zip(fb, pf), (split, ints(ps))]) == 0,
              f"K1 split at step {h} != one run on {board}")
        # lanes the table walk cannot start from (a player without the ball
        # in a goal column, every 7th lane): their warps walk by arithmetic
        bad = [f.clone() for f in pf]
        bad[0][::7], bad[1][::7], bad[4][::7] = cfg.goal_row_bounds[0], 0, 1
        kf, ks = sk.fused_rollout(cfg, seed, B, 64, dev, init_fields=bad)
        qf, qs = sk.fused_rollout_plain(cfg, seed, B, 64, dev,
                                        init_fields=bad)
        check(max_abs_err([*zip(kf, qf), (ints(ks), ints(qs))]) == 0,
              f"K1 from unwalkable lanes != plain on {board}")
        print(f"[K1] {board[0]}x{board[1]} B={B} T={T_K1}: bit-equal to plain "
              f"(max abs err {e}) at 64 (default), {ROLLOUT_RAGGED_LANES} "
              f"(ragged) and 32 lanes per block; {h}+{T_K1 - h} split equals "
              f"one run; from unwalkable lanes equal to plain")

    # ---- 5. K2 ---------------------------------------------------------
    for board, (seed, _, k2, _) in main_out.items():
        cfg = cfgs[board]
        pf, ps, pj = sk.fused_journal_rollout_plain(cfg, seed, B, T_K2, dev)
        e = max_abs_err([*zip(k2[0], pf), (ints(k2[1]), ints(ps)),
                         (k2[2], pj)])
        errs["fused_journal_rollout"] = max(errs["fused_journal_rollout"], e)
        check(e == 0, f"K2 != plain on {board}: max abs err {e}")
        kf, ks = sk.fused_rollout(cfg, seed, B, T_K2, dev)
        check(max_abs_err([*zip(k2[0], kf), (ints(k2[1]), ints(ks))]) == 0,
              f"K2 fields/stats != K1's on {board}")
        jf, js, jj = sk.fused_journal_rollout(
            cfg, seed, B, T_K2, dev, threads=ROLLOUT_RAGGED_LANES)
        check(max_abs_err([(jj, pj), *zip(jf, pf), (ints(js), ints(ps))])
              == 0, f"K2 depends on the block size on {board}")
        print(f"[K2] {board[0]}x{board[1]} B={B} T={T_K2}: journal bit-equal "
              f"to plain (max abs err {e}); fields and stats equal K1's; "
              f"64 and {ROLLOUT_RAGGED_LANES} lanes per block equal")

    # ---- 6. small inputs against the CPU plain versions ----------------
    for board, cfg in cfgs.items():
        cf, cs, cj = sk.fused_journal_rollout(cfg, 3, 1024, 64, "cpu")
        gf, gs, gj = sk.fused_journal_rollout(cfg, 3, 1024, 64, dev)
        kf, ks = sk.fused_rollout(cfg, 3, 1024, 64, dev)
        check(max_abs_err([*zip(gf, cf), *zip(kf, cf), (gj, cj),
                           (ints(gs), ints(cs)), (ints(ks), ints(cs))]) == 0,
              f"kernels != CPU plain versions on {board}")
    print("[small] K1 and K2 at B=1024 T=64 equal the CPU plain versions")

    # ---- 7. batched engine, card against CPU ---------------------------
    import numpy as np
    key_words = np.random.default_rng(0).integers(0, 2**32, (B, 2),
                                                  dtype=np.uint64)
    for board, cfg in cfgs.items():
        runs = []
        for d in (dev, torch.device("cpu")):
            st = batch.init_from_keys(cfg, key_words, d, rng="counter")
            st, acc = batch.random_rollout_stats(cfg, st, 100, rng="counter")
            runs.append((st, acc))
        (gst, gacc), (cst, cacc) = runs
        check(max_abs_err(list(zip(gst, cst))) == 0,
              f"batched engine state differs CUDA vs CPU on {board}")
        check([a.item() for a in gacc] == [a.item() for a in cacc],
              f"batched engine stats differ CUDA vs CPU on {board}")
        print(f"[engine] {board[0]}x{board[1]} B={B} x 100 steps: CUDA == CPU, "
              f"stats {[a.item() for a in gacc]}")

    # ---- 8. timing -----------------------------------------------------
    cfg = cfgs[(5, 4)]
    T = T_K2
    timed = {
        "fused_rollout": lambda: sk.fused_rollout(cfg, 1, B, T, dev),
        "fused_rollout_plain":
            lambda: sk.fused_rollout_plain(cfg, 1, B, T, dev),
        "fused_journal_rollout":
            lambda: sk.fused_journal_rollout(cfg, 1, B, T, dev),
        "fused_journal_rollout_plain":
            lambda: sk.fused_journal_rollout_plain(cfg, 1, B, T, dev),
    }
    ms = {}
    for name, fn in timed.items():
        med, reps, legs = time_cuda(fn)
        ms[name] = med
        print(f"[time] {name} 5x4 B={B} T={T}: {med} ms/call, "
              f"{B * T / (med / 1e3)} env-steps/s (median of {len(legs)} "
              f"legs x {reps} calls; legs ms/call {legs}) | {card}")
    for name in ("fused_rollout", "fused_journal_rollout"):
        big = cfgs[(11, 7)]
        fn = getattr(sk, name)
        med, reps, legs = time_cuda(lambda: fn(big, 1, B, T, dev))
        ms[name + " 11x7"] = med
        print(f"[time] {name} 11x7 B={B} T={T}: {med} ms/call, "
              f"{B * T / (med / 1e3)} env-steps/s (median of {len(legs)} "
              f"legs x {reps} calls) | {card}")
    log = built["step_kernel"].with_suffix(".log").read_text()
    regs = ptxas_registers(log)
    for board, c in cfgs.items():
        table = rc.uses_table(c)
        n_codes = rc.build_step_table(c).n_codes if table else 0
        smem = rc.smem_bytes(rc.DEFAULT_LANES, n_codes)
        check(sk._library().gst_rollout_smem_bytes(rc.DEFAULT_LANES, n_codes)
              == smem, "K1/K2's shared memory differs from smem_bytes")
        for name in ("fused_rollout", "fused_journal_rollout"):
            sym = (SYMBOL if table else ARITH_SYMBOL)[name]
            reg = [r for k, r in regs.items() if sym in k]
            key = name if table else name + " arith"
            now = ms[name] if board == (5, 4) else ms[name + " 11x7"]
            old = ROLLOUT_OLD_MS[(name, board)]
            print(f"[design] {name} {board[0]}x{board[1]} "
                  f"({'table' if table else 'arithmetic'} walk): "
                  f"{rc.DEFAULT_LANES} lanes and {shape[2]} producer warps "
                  f"a block ({-(-B // rc.DEFAULT_LANES)} blocks of "
                  f"{rc.DEFAULT_LANES + 32 * shape[2]} threads), {smem} B of "
                  f"shared memory per block (ring of {shape[1]} tiles of "
                  f"{shape[0]} steps), {reg} registers per thread; "
                  f"{per_step[key]} SASS per lane-step, bound "
                  f"{bound(B * T, per_step[key], 0)[0]} ms; {now} ms/call "
                  f"against the previous design's {old} ms ({old / now}x) "
                  f"| {card}")
    profile_window(torch, lambda: sk.fused_rollout(cfg, 1, B, T, dev),
                   f"fused_rollout 5x4 B={B} T={T}", "rollout_kernel<", card)
    print(f"[clocks] sm MHz, power W, temp C after timing: "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}")

    regs = {}
    for path in built.values():
        regs.update(ptxas_registers(path.with_suffix(".log").read_text()))
    learner_launches, errs["packed_learner_chunk"], learner_ms = \
        learner_phases(torch, dev, card, cfgs, lk, exploitability, per_step,
                       regs)
    launches.update(learner_launches)
    ms.update(learner_ms)

    parity_launches, parity_errs, parity_ms, parity_bytes = parity_phases(
        torch, dev, card, regs)
    launches.update(parity_launches)
    errs.update(parity_errs)
    ms.update(parity_ms)

    iql_launches, iql_errs, iql_ms = iql_phases(torch, dev, card, cfgs,
                                                batch, per_step, regs)
    launches.update(iql_launches)
    errs.update(iql_errs)
    ms.update(iql_ms)

    mg_launches, mg_errs, mg_ms, mg_work = multigrid_phases(
        torch, dev, card, exploitability, per_step, regs)
    launches.update(mg_launches)
    for name, e in mg_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    ms.update(mg_ms)

    t0 = time.perf_counter()
    alt_launches, alt_errs, alt_ms, alt_work = alt_phases(
        torch, dev, card, cfgs, per_step, regs)
    print(f"[alt] phases 27-31 ran {time.perf_counter() - t0} s")
    launches.update(alt_launches)
    errs.update(alt_errs)
    ms.update(alt_ms)

    rm_err, rm_ms, rm_work = rmplus_phase(torch, dev, card, lk, per_step,
                                          regs, thread_build)
    errs[RMPLUS] = rm_err
    ms.update(rm_ms)
    contract_11x7_phase(torch, dev, card, lk, exploitability)

    surface_phases(torch, dev, card, lk)
    per_step.update(added_instructions(_build))
    t_launches, t_errs, t_ms, t_work, entry_ex = threefry_phases(
        torch, dev, card, per_step, step_counts)
    launches.update(t_launches)
    errs.update(t_errs)
    ms.update(t_ms)
    mesh_phases(torch, dev, card, exploitability)
    tools_phase(torch, dev, card)
    errs[SCATTER], a1_ms, a1_work = determinism_phase(torch, dev, card,
                                                      entry_ex)
    ms.update(a1_ms)
    s23_errs, s23_ms, s23_work = mixed_alt_phase(torch, dev, card, per_step,
                                                 s23_counts)
    errs.update(s23_errs)
    ms.update(s23_ms)

    # Each kernel's work at the shape its ms was timed: lane-steps (or
    # lane-events) and the bytes of its inputs and outputs, each once.
    fields_bytes = 2 * 6 * 4 * B + 3 * 8   # state planes in and out, stats
    n54 = lk.n_codes(cfgs[(5, 4)])
    st54 = rc.build_step_table(cfgs[(5, 4)])
    table_bytes = st54.table.nbytes + rc.raw_bytes(st54.n_codes)
    work = {
        "fused_rollout": (B * T_K2, fields_bytes + table_bytes),
        "fused_journal_rollout": (B * T_K2, fields_bytes + table_bytes
                                  + 4 * B * T_K2),
        "packed_learner_chunk": (B * T_K5, fields_bytes
                                 + n54 * (11 * 4 + 25 * (8 + 4))),
        "iql_packed_chunk": (B * T_K8, fields_bytes
                             + n54 * (10 * 4 + 10 * (8 + 4))),
        "iql_chunk": (B * T_K8, fields_bytes + n54 * (10 * 4 + 10 * (8 + 4))),
        "parity_events": (B * E_K12, parity_bytes["parity_events"]),
        "parity_scripted_events": (B * E_K13,
                                   parity_bytes["parity_scripted_events"]),
        **mg_work,
        **alt_work,
        RMPLUS: rm_work,
        **t_work,
        SCATTER: a1_work,
        **s23_work,
    }
    kernels = []
    for name in ("fused_rollout", "fused_journal_rollout",
                 "multigrid_rollout", "alt_rollout", "packed_learner_chunk",
                 "multigrid_packed_learner_chunk", "learner_chunk",
                 "multigrid_learner_chunk", "iql_packed_chunk", "iql_chunk",
                 "altq_packed_chunk", "altq_chunk", "parity_events",
                 "parity_scripted_events", RMPLUS, T1, T1_KEYED, S1, S2,
                 S3, SCATTER):
        units, nbytes = work[name]
        if name == SCATTER:   # additions at the float32 rate
            bound_ms, bound_by = scatter_bound(units, nbytes)
        else:
            bound_ms, bound_by = bound(units, per_step[name], nbytes)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": {**SOURCE, **ADDED_SOURCE}[name],
             "replaces": {**REPLACES, **ADDED_REPLACES}[name],
             "launches": launches[name],
             "max_abs_err": errs[name], "ms": ms[name],
             "plain_ms": ms[name + "_plain"], "bound_ms": bound_ms,
             "bound_by": bound_by,
             "library_ms": ms.get(name + "_library")})
        print(f"[bound] {name}: {units} units x "
              f"{per_step.get(name, 'one addition')} SASS instructions, "
              f"{nbytes} bytes -> {bound_ms} ms ({bound_by}); measured "
              f"{ms[name]} ms ({bound_ms / ms[name] * 100} % of the "
              f"bound)")
    print(f"[done] chip_smoke.py ran {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def rmplus_phase(torch, dev, card, lk, per_step, regs, thread_path):
    """Phase 32: R1 against ``solve_matrix_games_plain`` on the card, bit
    for bit, at each of ``RMPLUS_SHAPES`` (the 5x4 contract's own Q after
    its first chunk, random games at the recipe's and the 11x7 contract's
    counts, games that leave a warp partly empty), and against its previous
    design (one thread a game, built from ``thread_path``); both timed at
    each shape, by CUDA events and by CUDA-graph replay, the plain version
    at 761 x 400.  Sets ``per_step[RMPLUS]`` to the smaller of R1's SASS
    per game-iteration and its previous design's, the work its bound
    counts.  Returns R1's max abs error, its ms and the plain version's at
    761 x 400, and its work there (game-iterations, bytes)."""
    import numpy as np
    from gym_soccer_tpu_torch.agents import learners
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.ops import rmplus_variants
    c54 = EnvConfig(5, 4, 0.2)
    rng = np.random.default_rng(5)
    inputs = {"contract": lk.fused_minimax_train(c54, device=dev, **dict(
        CONTRACT, n_chunks=1, final_solver_iters=0))[0]}
    for n in (11705, 2502):
        inputs[n] = torch.tensor(rng.uniform(-1, 1, (n, 5, 5)),
                                 dtype=torch.float32, device=dev)
    thread = learners.declare(ctypes.CDLL(str(thread_path)))
    committed = learners._library
    shape = (ctypes.c_int32 * 3)()
    committed().gst_rmplus_shape(shape)
    lanes, per_warp, warps = shape
    lane_sass = per_step[RMPLUS]
    game_sass = lanes * lane_sass
    found = sass_loop_instructions(thread_path, [RMPLUS_SYMBOL])
    check(len(found) == 1, f"R1's previous design: {len(found)} kernels")
    thread_sass = next(iter(found.values()))
    per_step[RMPLUS] = min(game_sass, thread_sass)
    err, ms = 0.0, {}
    for label, key, games, iters in RMPLUS_SHAPES:
        M = inputs[key][:games]
        got = learners.solve_matrix_games(M, iters)
        want = learners.solve_matrix_games_plain(M, iters)
        torch.cuda.synchronize()
        e = max(float((a - b).abs().max()) for a, b in zip(got, want))
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))
        err = max(err, e)
        check(same, f"R1 != plain on {label}, {games} x {iters}: max abs "
              f"err {e}")

        def call(M=M, iters=iters):
            return learners.solve_matrix_games(M, iters)
        med, reps, legs = time_cuda(call)
        dms = rmplus_variants.device_ms(call)
        learners._library = lambda: thread
        try:
            old = call()
            check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(old, got)),
                  f"R1's previous design != R1 on {label}, {games} x "
                  f"{iters}")
            old_med = time_cuda(call)[0]
            old_dms = rmplus_variants.device_ms(call)
        finally:
            learners._library = committed
        if (games, iters) == (761, 400) and RMPLUS not in ms:
            ms[RMPLUS], now_dms, then_dms = med, dms, old_dms
        nbytes = games * (25 + 11) * 4
        b = bound(games * iters, per_step[RMPLUS], nbytes)[0]
        print(f"[R1] {label}, {games} games x {iters} iterations: bit-equal "
              f"to the plain version (max abs err {e}) and to the previous "
              f"design; {med} ms/call (median of {len(legs)} legs x {reps} "
              f"calls), {dms} ms of device time (CUDA-graph replay), "
              f"{dms * 1e-3 * rmplus_variants.CLOCK_HZ / iters} cycles an "
              f"iteration at 1.98 GHz, {b / dms * 100} % of the bound "
              f"{b} ms; the previous design (one thread a game) {old_med} "
              f"ms/call, {old_dms} ms of device time ({old_dms / dms}x) "
              f"| {card}")
    med, reps, legs = time_cuda(
        lambda: learners.solve_matrix_games_plain(inputs["contract"], 400),
        slow_legs=3)
    ms[RMPLUS + "_plain"] = med
    games, iters = 761, 400
    nbytes = games * (25 + 11) * 4
    new_ms, by = bound(games * iters, game_sass, nbytes)
    old_ms = bound(games * iters, thread_sass, nbytes)[0]
    reg = [r for k, r in regs.items() if RMPLUS_SYMBOL in k]
    old_reg = list(ptxas_registers(
        thread_path.with_suffix(".log").read_text()).values())
    print(f"[design] R1 {games} x {iters}: {lanes} lanes a game, {per_warp} "
          f"games a warp, {warps} warp(s) a block "
          f"({-(-games // (per_warp * warps))} blocks of {32 * warps} "
          f"threads), {reg} registers per thread; {lane_sass} SASS per "
          f"lane-iteration, {game_sass} per game-iteration ({lanes} lanes); "
          f"the previous design {thread_sass} per game-iteration, "
          f"{old_reg} registers; "
          f"{now_dms * 1e-3 * rmplus_variants.CLOCK_HZ / iters} cycles an "
          f"iteration (device ms x 1.98e6 / iterations), the previous "
          f"design {then_dms * 1e-3 * rmplus_variants.CLOCK_HZ / iters}; "
          f"bound {new_ms} ms at this design's count and {old_ms} ms at the "
          f"previous design's ({by}); {ms[RMPLUS]} ms/call and "
          f"{now_dms} ms of device time, "
          f"{min(new_ms, old_ms) / now_dms * 100} % of the smaller "
          f"bound; the plain version {med} ms ({med / ms[RMPLUS]}x) "
          f"| {card}")
    return err, ms, (games * iters, nbytes)


def contract_11x7_phase(torch, dev, card, lk, exploitability):
    """Phase 33: the JAX package's 11x7 contract (test_equilibrium_11x7_tpu)
    at its chunks_per_dispatch, with K5's and R1's launch counters reset
    just before and read just after: exploitability at most 0.005 at gamma
    0.99 (``segment_iters=200``)."""
    from gym_soccer_tpu_torch.agents import learners
    from gym_soccer_tpu_torch.config import EnvConfig
    cfg117 = EnvConfig(11, 7, 0.2)
    lk.reset_launch_counts()
    learners.reset_launch_counts()
    timing = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q, v, pa, pb, hist = lk.fused_minimax_train(cfg117, device=dev,
                                                timing=timing,
                                                **CONTRACT_11X7)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, g = CONTRACT_11X7["n_chunks"], CONTRACT_11X7["chunks_per_dispatch"]
    check(lk.launch_counts["packed_learner_chunk"] == n
          and timing["replays"] == n // g
          and learners.launch_counts[RMPLUS] == n + 1,
          f"11x7 contract: launches {lk.launch_counts}, "
          f"{learners.launch_counts}, {timing['replays']} replays")
    t1 = time.perf_counter()
    ex = exploitability(cfg117, pa, pb, gamma=0.99, segment_iters=200)
    t_eval = time.perf_counter() - t1
    steps = (CONTRACT_11X7["batch"] * CONTRACT_11X7["chunk_len"] * n)
    print(f"[contract 11x7] recipe {CONTRACT_11X7}: exploitability {ex} "
          f"(limit {CONTRACT_11X7_EXPLOITABILITY}) at gamma 0.99 | train "
          f"wall {wall} s for {steps} env-steps: {timing['replays']} replays "
          f"of {g} chunks ({timing['segments_ms']} ms), capture "
          f"{timing['capture_ms']} ms, remainder {timing['remainder_ms']} "
          f"ms; K5 launched {lk.launch_counts['packed_learner_chunk']} "
          f"times, R1 {learners.launch_counts[RMPLUS]}; exploitability eval "
          f"{t_eval} s | {card}")
    check(ex <= CONTRACT_11X7_EXPLOITABILITY,
          f"11x7 exploitability {ex} > {CONTRACT_11X7_EXPLOITABILITY}")


def surface_phases(torch, dev, card, lk):
    """Phases 34-38, the reference-user surface, with their wall time."""
    t0 = time.perf_counter()
    host_phases(card)
    planner_phase(torch, dev, card)
    best_response_phase(torch, dev, card, lk)
    entry_phase(torch, dev, card, lk)
    print(f"[surface] phases 34-38 ran {time.perf_counter() - t0} s")


def cpu_model():
    """The host's CPU, for host-side rates: /proc/cpuinfo's model name, or
    where the host hides it its vendor, family, model number and clock,
    and the count."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break   # the first processor's block
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id')} family {info.get('cpu family')} "
                f"model {info.get('model')} at {info.get('cpu MHz')} MHz")
    return f"{name} x {os.cpu_count()}"


def facade_run(env, n_steps, seed):
    """``n_steps`` random actions (numpy ``RandomState(seed)``) through
    the facade from ``reset(seed=seed)``, resetting when an episode ends.
    Returns every reset's and step's return value and the steps' wall time
    in s (host clock)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    actions = [{a: int(x) for a, x in zip(env.return_agent, row)}
               for row in rng.randint(0, 5, (n_steps,
                                             len(env.return_agent)))]
    out = [env.reset(seed=seed)]
    t0 = time.perf_counter()
    for action in actions:
        if env.needs_reset:
            out.append(env.reset())
        out.append(env.step(action))
    return out, time.perf_counter() - t0


def host_phases(card):
    """Phases 34-35: the native libraries and the facade, on the host.

    34: both native libraries compile with g++ from this checkout, each
    removed first and compiled, timed and loaded by a fresh process (this
    process may hold the handle of an earlier phase's first build of the
    same source; it loads or reuses it for the comparison), and
    ``build_tables(backend="native")`` gives the numpy backend's tensors
    byte for byte on 5x4 and 11x7 (slip 0.2); a failed build fails here,
    with no numpy stand-in.  35: 20,000 random-action steps with resets
    through ``SoccerSimultaneousEnv`` on 11x7 slip 0.2, multi-agent and
    against ``get_random_policy(nS, 5, 42)`` as player B, equal step for
    step to a second facade built on the numpy backend's tables; steps/s
    for each.  The facade's cache keeps the native 11x7 tables."""
    from gym_soccer_tpu_torch import native
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import tables
    from gym_soccer_tpu_torch.envs import soccer_simultaneous_env as sse
    from gym_soccer_tpu_torch.utils.policies import get_random_policy
    cpu = cpu_model()
    for name in ("tables_builder", "mt19937_stream"):
        path = native.library_path(name)
        if path.exists():
            path.unlink()
        proc = subprocess.run(
            [sys.executable, "-c", NATIVE_BUILD, native.__file__, name],
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0 and proc.stdout.split()[-1:] == ["True"]
              and path.exists(), f"native {name} did not build and load in "
              f"a fresh process:\n{proc.stdout}{proc.stderr}")
        print(f"[native] {name}: g++ {' '.join(native.CXX_FLAGS)} in "
              f"{proc.stdout.split()[0]} s in a fresh process, which then "
              f"loads it -> {path.name} | host {cpu}")
    check(native.have_native() and native.have_native_tables(),
          "a native library does not load")
    built = {}
    for board in BOARDS:
        cfg = EnvConfig(*board, SLIP)
        times = {}
        for backend in ("native", "numpy"):
            t0 = time.perf_counter()
            built[board, backend] = tables.build_tables(cfg, backend=backend)
            times[backend] = time.perf_counter() - t0
        nat, ref = built[board, "native"], built[board, "numpy"]
        same = all(getattr(nat, f).tobytes() == getattr(ref, f).tobytes()
                   for f in TABLE_FIELDS)
        check(same, f"native tables differ from numpy's on {board}")
        print(f"[native] build_tables {board[0]}x{board[1]} slip {SLIP} "
              f"(nS {nat.nS}): native {times['native']} s, numpy "
              f"{times['numpy']} s, {len(TABLE_FIELDS)} tensors byte-equal "
              f"| host {cpu}")

    big = (11, 7)
    cfg = EnvConfig(*big, SLIP)
    nS = built[big, "numpy"].nS
    for mode, kw in (("multi-agent", {}),
                     ("player_b_policy=get_random_policy(nS, 5, 42)",
                      {"player_b_policy": get_random_policy(nS, 5, 42)})):
        runs = {}
        for backend in ("native", "numpy"):
            sse._TABLE_CACHE[cfg] = built[big, backend]
            env = sse.SoccerSimultaneousEnv(width=big[0], height=big[1],
                                            slip_prob=SLIP, **kw)
            check(env._tb is built[big, backend], "the facade's tables")
            runs[backend] = facade_run(env, FACADE_STEPS, seed=5)
        (a, ta), (b, tb_) = runs["native"], runs["numpy"]
        check(repr(a) == repr(b), f"11x7 facade ({mode}): the native and "
              f"numpy tables give different trajectories")
        resets = len(a) - 1 - FACADE_STEPS
        print(f"[facade] 11x7 slip {SLIP}, {mode}: {FACADE_STEPS} random "
              f"steps with {resets} resets equal on native and numpy "
              f"tables; {FACADE_STEPS / ta} / {FACADE_STEPS / tb_} steps/s "
              f"(host clock, row cache cold) | host {cpu}")
    sse._TABLE_CACHE[cfg] = built[big, "native"]


def planner_phase(torch, dev, card):
    """Phase 36: ``value_iteration_torch`` on the card in float32 against
    ``value_iteration_arrays`` (float64, host) at theta 1e-4, gamma 0.99,
    on 5x4 against the stand policy and 11x7 against a random B, on
    tests/test_planners_jax.py's terms: greedy actions equal wherever the
    float64 gap exceeds 1e-3, V within 2e-3, max|V - max_a Q| < theta,
    sweep counts within 2.  Prints ms per sweep and the total."""
    import numpy as np
    from gym_soccer_tpu_torch.agents import planners
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import tables
    from gym_soccer_tpu_torch.envs import SoccerSimultaneousEnv
    from gym_soccer_tpu_torch.utils import policies
    cpu = cpu_model()
    for board, opp in (((5, 4), "stand"), ((11, 7), "random")):
        nS = tables.build_statespace(EnvConfig(*board, SLIP)).nS
        pol = (policies.get_stand_policy(nS) if opp == "stand"
               else policies.get_random_policy(nS, 5, 42))
        env = SoccerSimultaneousEnv(width=board[0], height=board[1],
                                    slip_prob=SLIP, player_b_policy=pol)
        prob, ns, rew, done = planners._env_arrays(env)
        t0 = time.perf_counter()
        pi_np, V_np, Q_np, cc_np = planners.value_iteration_arrays(
            prob, ns, rew, done, VI_THETA, VI_GAMMA)
        host_s = time.perf_counter() - t0
        args = (torch.as_tensor(prob, dtype=torch.float32, device=dev),
                torch.as_tensor(ns, device=dev),
                torch.as_tensor(rew, dtype=torch.float32, device=dev),
                torch.as_tensor(done, device=dev))
        planners.value_iteration_torch(*args, VI_THETA, VI_GAMMA,
                                       max_sweeps=3)   # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pi, V, Q, cc = planners.value_iteration_torch(
                *args, VI_THETA, VI_GAMMA)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        sweeps_ms = sorted(w * 1e3 / cc for w in walls)
        V64, Q64 = V.double().cpu().numpy(), Q.double().cpu().numpy()
        gap = np.sort(Q_np, axis=1)
        distinct = (gap[:, -1] - gap[:, -2]) > 1e-3
        greedy = bool((pi.cpu().numpy()[distinct] == pi_np[distinct]).all())
        v_err = float(np.abs(V64 - V_np).max())
        resid = float(np.abs(V64 - Q64.max(axis=1)).max())
        print(f"[planners] value_iteration_torch {board[0]}x{board[1]} vs "
              f"{opp} B (nS {nS}), float32 on the card: {cc} sweeps in "
              f"{wall * 1e3} ms ({wall * 1e3 / cc} ms a sweep, median of 3; "
              f"the three {sweeps_ms}; one host read of the residual a "
              f"sweep); "
              f"value_iteration_arrays float64: {cc_np} sweeps in "
              f"{host_s * 1e3} ms on the host ({cpu}); greedy equal on "
              f"{int(distinct.sum())} states with a gap > 1e-3: {greedy}; "
              f"max|V - V64| {v_err}; max|V - max_a Q| {resid} | {card}")
        check(greedy and v_err < 2e-3 and resid < VI_THETA
              and abs(cc - cc_np) <= 2,
              f"value_iteration_torch on {board} outside the JAX test's "
              f"terms")


def best_response_phase(torch, dev, card, lk):
    """Phase 37: the JAX package's best-response gate
    (test_br_convergence_tpu) through ``fused_best_response_train``, K5's
    launch counter reset just before and read just after each run (+300);
    per chunk and at ``chunks_per_dispatch=8``, each mode run twice, all
    four runs bit-equal.  Each run prints its wall and its split (chunk
    calls and between them; or capture, replays and remainder): a mode's
    first run in a process pays what that process has not yet done (K5's
    first launch at this shape, the first CUDA-graph capture), its second
    does not.  Then the greedy policy's win share against the frozen
    policy on the batched engine (2048 lanes x 400 steps) above 0.95, and
    the mean gap of v to ``best_response_value``
    (examples/train_minimax_tpu.py's --best-response metric)."""
    import numpy as np
    from gym_soccer_tpu_torch.agents import evaluation, learners
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.utils.policies import get_random_policy_array
    cfg = EnvConfig(5, 4, SLIP)
    opp = get_random_policy_array(761, 5, seed=BR_OPP_SEED)
    n = BR_RECIPE["n_chunks"]
    runs = {}
    for g in (1, GROUPED_CHUNKS):
        for call in (1, 2):
            lk.reset_launch_counts()
            learners.reset_launch_counts()
            timing = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lk.fused_best_response_train(
                cfg, opp, "player_a", device=dev, chunks_per_dispatch=g,
                timing=timing, **BR_RECIPE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(lk.launch_counts)
            check(counts["packed_learner_chunk"] == n
                  and sum(counts.values()) == n
                  and learners.launch_counts[RMPLUS] == 0,
                  f"BR gate (chunks_per_dispatch={g}): launches {counts}, "
                  f"R1 {learners.launch_counts[RMPLUS]}, not {n} of K5 "
                  f"alone")
            runs[g, call] = out
            split = (f"chunk calls {timing['kernel_ms']} ms, between "
                     f"{timing['between_ms']} ms (CUDA events)" if g == 1
                     else f"capture {timing['capture_ms']} ms (host clock, "
                     f"with one warm-up chunk), {timing['replays']} replays "
                     f"{timing['segments_ms']} ms, remainder "
                     f"{timing['remainder_ms']} ms (CUDA events)")
            print(f"[best response] chunks_per_dispatch={g}, run {call} of "
                  f"this mode in this process: {n} chunks of "
                  f"{BR_RECIPE['batch']} x {BR_RECIPE['chunk_len']} in "
                  f"{wall} s (host clock; {split}; K5 launched "
                  f"{counts['packed_learner_chunk']} times) | {card}")
    (q, v, pa, pb, hist) = runs[1, 1]
    for (g, call), other in runs.items():
        # the grouped mode keeps every chunk's row, the per-chunk mode
        # every 16th and the last
        rows = (other[4] if g == 1 else
                [r for k, r in enumerate(other[4]) if k % 16 == 0
                 or k == n - 1] if len(other[4]) == n else None)
        check(all(torch.equal(a, b) for a, b in zip((q, v, pa, pb), other))
              and rows == hist, f"BR gate: run {call} at "
              f"chunks_per_dispatch={g} differs from the first per-chunk run")
    pol_a = pa.argmax(-1)
    t0 = time.perf_counter()
    share = evaluation.greedy_win_share(cfg, pol_a, opp, lanes=BR_LANES,
                                        steps=BR_STEPS, seed=BR_EVAL_SEED,
                                        device=dev)
    t_share = time.perf_counter() - t0
    opp_oh = torch.nn.functional.one_hot(
        torch.as_tensor(opp, device=dev).long(), 5).float()
    v_br, _ = evaluation.best_response_value(cfg, opp_oh, "player_a")
    gap = float((v - v_br).abs().mean())
    print(f"[best response] recipe {BR_RECIPE}, opponent "
          f"get_random_policy_array(761, 5, seed={BR_OPP_SEED}): all four "
          f"runs bit-equal; greedy win share {share} (limit > "
          f"{BR_WIN_SHARE}) over {BR_LANES} lanes x {BR_STEPS} steps "
          f"(default_rng({BR_EVAL_SEED}) key words, {t_share} s); mean "
          f"|v - v_br| {gap}, start value {evaluation.start_value(cfg, v)} "
          f"against {evaluation.start_value(cfg, v_br)} | {card}")
    check(share > BR_WIN_SHARE, f"BR win share {share} <= {BR_WIN_SHARE}")
    # scored a second time as the JAX test scores it: batch.init(CFG,
    # key(9), 2048) and a threefry rollout (tests/test_learner_kernel.py:481)
    from gym_soccer_tpu_torch.core import batch, threefry
    opp_t = torch.as_tensor(opp, device=dev).long()
    t0 = time.perf_counter()
    st = batch.init(cfg, threefry.key(BR_EVAL_SEED), BR_LANES, dev)
    _, out = batch.rollout(
        cfg, st, lambda obs, i: (pol_a[obs.long()], opp_t[obs.long()]),
        BR_STEPS)
    share_tf = evaluation.win_share(out)
    print(f"[best response] greedy win share on the threefry engine from "
          f"key({BR_EVAL_SEED}) as the JAX test scores it: {share_tf} "
          f"(limit > {BR_WIN_SHARE}; {time.perf_counter() - t0} s) | {card}")
    check(share_tf > BR_WIN_SHARE,
          f"BR win share (threefry) {share_tf} <= {BR_WIN_SHARE}")


def entry_phase(torch, dev, card, lk):
    """Phase 38: the twin of ``__graft_entry__.entry()`` on the card at
    8192 x 64, K5's launch counter reset just before and read just after
    (+1); its fields, counts, int64 sums and stats bit-equal to the plain
    version on the card from the same inputs; its ms by ``time_cuda``."""
    from gym_soccer_tpu_torch import entry
    lk.reset_launch_counts()
    fn, args = entry.entry()
    fields, (sums, cnt), stats = fn(*args)
    torch.cuda.synchronize()
    launched = lk.launch_counts["packed_learner_chunk"]
    check(launched == 1, f"entry(): K5 launched {launched} times, not 1")
    got = [*(f.clone() for f in fields), sums.clone(), cnt.clone(),
           torch.stack([torch.as_tensor(x, device=dev) for x in stats])]
    B, T = entry.CARD_SHAPE
    pf, (ps, pc), pstats = lk.packed_learner_chunk_plain(entry.CFG, *args,
                                                         B, T)
    want = [*pf, ps, pc, torch.stack([torch.as_tensor(x, device=dev)
                                      for x in pstats])]
    err = max_abs_err(list(zip(got, want)))
    check(err == 0, f"entry(): K5 != plain, max abs err {err}")
    check(int(cnt.sum()) == B * T and args[1].device == dev,
          "entry(): visits do not sum to B * T on the card")
    med, reps, legs = time_cuda(lambda: fn(*args))
    print(f"[entry] entry() {B} x {T} on 5x4 slip {SLIP}: K5 launched "
          f"{launched} time(s), fields, counts, int64 sums and stats "
          f"bit-equal to the plain version; {med} ms/call, "
          f"{B * T / (med / 1e3)} env-steps/s (median of {len(legs)} legs "
          f"x {reps} calls) | {card}")


def learner_inputs(torch, lk, cfg, B, dev, seed):
    """A non-uniform table with v != 0 made from a numpy seed, and the
    initial fields."""
    import numpy as np
    nS = len(lk._cell_rows(cfg))
    rng = np.random.default_rng(seed)
    pa, pb = (torch.tensor(rng.dirichlet(np.ones(5), nS), dtype=torch.float32,
                           device=dev) for _ in range(2))
    v = torch.tensor(rng.uniform(-1, 1, nS), dtype=torch.float32, device=dev)
    return lk.pack_m2(cfg, pa, pb, v, 0.2), lk.init_state_fields(cfg, B, dev)


def chunk_err(a, b):
    """max |a - b| over two chunk results' fields, stats, counts and int64
    residual sums."""
    (fa, (ra, ca), sa), (fb, (rb, cb), sb) = a, b
    return max_abs_err([*zip(fa, fb), (ra, rb), (ca, cb),
                        (ints(sa), ints(sb))])


def learner_phases(torch, dev, card, cfgs, lk, exploitability, per_step,
                   regs):
    """Phases 9-13: the training path and kernel K5.  Returns K5's launches
    on the training path, its max abs error against the plain version,
    and the ms per call of K5 and its plain version."""
    from gym_soccer_tpu_torch.ops import learner_codes as lc
    cfg = cfgs[(5, 4)]

    # ---- 9. training path, through the entry point ---------------------
    from gym_soccer_tpu_torch.agents import learners
    lk.reset_launch_counts()
    learners.reset_launch_counts()
    q, v, pa, pb, hist = lk.fused_minimax_train(
        cfg, batch=B, n_chunks=4, chunk_len=T_K5, lr=1.0, eps=0.2,
        solver_iters=200, seed=3, device=dev)
    torch.cuda.synchronize()
    launches = {"packed_learner_chunk":
                lk.launch_counts["packed_learner_chunk"],
                RMPLUS: learners.launch_counts[RMPLUS]}
    print(f"[train path] launches {launches}")
    check(launches["packed_learner_chunk"] > 0,
          "packed_learner_chunk was not launched on the training path")
    check(launches[RMPLUS] > 0, "R1 was not launched on the training path")
    check(bool(torch.isfinite(q).all()), "Q is not finite")
    check(float(v.abs().max()) <= 1.05, f"|v| = {float(v.abs().max())} > 1.05")
    for pi in (pa, pb):
        check(float((pi.sum(-1) - 1).abs().max()) < 1e-5,
              "policy rows do not sum to 1")
    goals = sum(h[1] for h in hist)
    check(goals > 0, "no goals on the training path")
    print(f"[train path] 5x4 B={B} 4 chunks x {T_K5} steps: max|v| "
          f"{float(v.abs().max())}, goals in recorded chunks {goals}")

    # ---- 10. K5 against its plain version ------------------------------
    err = 0
    for board, c in cfgs.items():
        for BB, TT in ((B, T_K5), (B_CONTRACT, T_CONTRACT)):
            table, fields = learner_inputs(torch, lk, c, BB, dev, seed=board[0])
            plain = lk.packed_learner_chunk_plain(c, 77, table, fields, BB, TT,
                                                  0.99)
            for lanes in (None, LEARNER_RAGGED_LANES[BB]):
                got = lk.packed_learner_chunk(c, 77, table, fields, BB, TT,
                                              0.99, threads=lanes)
                e = chunk_err(got, plain)
                err = max(err, e)
                check(e == 0, f"K5 != plain on {board} at {BB} x {TT}, "
                      f"{lanes or 'default'} lanes per block: max abs err {e}")
            cnt = int(plain[1][1].sum())
            check(cnt == BB * TT, f"{cnt} visits counted, not {BB * TT}")
        table, fields = learner_inputs(torch, lk, c, B, dev, seed=board[0])
        # lanes that start in goal states, every 7th lane
        bad = [f.clone() for f in fields]
        bad[0][::7], bad[1][::7], bad[4][::7] = c.goal_row_bounds[0], c.W - 1, 0
        e = chunk_err(lk.packed_learner_chunk(c, 8, table, bad, B, T_K5, 0.99),
                      lk.packed_learner_chunk_plain(c, 8, table, bad, B, T_K5,
                                                    0.99))
        check(e == 0, f"K5 from goal states != plain on {board}")
        small = lk.packed_learner_chunk(c, 5, table, fields, B, 8, 0.99)
        cpu = lk.packed_learner_chunk(c, 5, table.cpu(),
                                      [f.cpu() for f in fields], B, 8, 0.99)
        check(chunk_err(small, cpu) == 0, f"K5 != CPU plain on {board}")
        print(f"[K5] {board[0]}x{board[1]} (rows in "
              f"{'shared memory' if lc.shared_rows(c) else 'L2'}): "
              f"bit-equal to plain (fields, stats, counts, int64 residual "
              f"sums; max abs err {err}) at {B} x {T_K5} and {B_CONTRACT} x "
              f"{T_CONTRACT}, at the default lanes per block ("
              f"{lc.default_lanes(B)}, {lc.default_lanes(B_CONTRACT)}) and "
              f"at {LEARNER_RAGGED_LANES[B]}, {LEARNER_RAGGED_LANES[B_CONTRACT]} "
              f"(ragged); from goal states equal to plain; B={B} T=8 "
              "equals the CPU plain version")

    # ---- 11. exact resume on the card ----------------------------------
    kw = dict(batch=B, chunk_len=T_K5, lr=0.5, eps=0.3, eps_halflife=64,
              lr_anneal_start=1, lr_anneal_tau=4.0, solver_iters=100, seed=9,
              device=dev)
    whole = lk.fused_minimax_train(cfg, n_chunks=2, return_state=True, **kw)
    r = lk.fused_minimax_train(cfg, n_chunks=1, return_state=True, **kw)[5]
    part = lk.fused_minimax_train(
        cfg, n_chunks=1, return_state=True,
        init=tuple(r[k] for k in ("q", "v", "pi_a", "pi_b", "n")),
        fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
    check(all(torch.equal(a, b) for a, b in
              [*zip(whole[:4], part[:4]), (whole[5]["n"], part[5]["n"]),
               *zip(whole[5]["fields"], part[5]["fields"])]),
          "2 chunks != 1 + 1 through the resume dict")
    print("[resume] 2 chunks == 1 + 1 through the resume dict, bit for bit "
          "in q, v, pi, n and fields")

    # ---- 12. the 5x4 contract, per chunk and grouped --------------------
    timing = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per = lk.fused_minimax_train(cfg, device=dev, timing=timing, **CONTRACT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    q, v, pa, pb, hist = per
    t1 = time.perf_counter()
    ex = exploitability(cfg, pa, pb, gamma=0.99)
    t_eval = time.perf_counter() - t1
    steps = CONTRACT["batch"] * CONTRACT["chunk_len"] * CONTRACT["n_chunks"]
    print(f"[contract] 5x4 recipe {CONTRACT}: exploitability {ex} "
          f"(limit {CONTRACT_EXPLOITABILITY}) at gamma 0.99 | train wall "
          f"{wall} s for {steps} env-steps: chunk calls {timing['kernel_ms']} "
          f"ms, between chunks {timing['between_ms']} ms over "
          f"{timing['chunks']} chunks; exploitability eval {t_eval} s | {card}")
    check(ex <= CONTRACT_EXPLOITABILITY,
          f"exploitability {ex} > {CONTRACT_EXPLOITABILITY}")
    check(round(ex, 10) == CONTRACT_READING,
          f"exploitability {ex} does not read {CONTRACT_READING}")
    grouped_phase(
        torch, "5x4 contract",
        lambda **g: lk.fused_minimax_train(cfg, device=dev, **CONTRACT, **g),
        per, wall, 4, lk.launch_counts, "packed_learner_chunk",
        CONTRACT["n_chunks"], card, solves=CONTRACT["n_chunks"] + 1)

    # ---- 13. timing ----------------------------------------------------
    ms = {}
    for board, c in cfgs.items():
        for BB, TT in ((B, T_K5), (B_CONTRACT, T_CONTRACT)):
            table, fields = learner_inputs(torch, lk, c, BB, dev, seed=board[0])
            for name, fn in (("packed_learner_chunk", lk.packed_learner_chunk),
                             ("packed_learner_chunk_plain",
                              lk.packed_learner_chunk_plain)):
                med, reps, legs = time_cuda(
                    lambda: fn(c, 77, table, fields, BB, TT, 0.99))
                if board == (5, 4) and BB == B:
                    ms[name] = med
                if name == "packed_learner_chunk":
                    now = med
                print(f"[time] {name} {board[0]}x{board[1]} B={BB} T={TT}: "
                      f"{med} ms/call, {BB * TT / (med / 1e3)} learner "
                      f"env-steps/s (median of {len(legs)} legs x {reps} "
                      f"calls; legs ms/call {legs}) | {card}")
            us = profile_window(
                torch, lambda: lk.packed_learner_chunk(c, 77, table, fields,
                                                       BB, TT, 0.99),
                f"packed_learner_chunk {board[0]}x{board[1]} B={BB} T={TT}",
                "chunk_kernel<true", card)
            shared = lc.shared_rows(c)
            lanes = lc.default_lanes(BB)
            key = "packed_learner_chunk" + ("" if shared else " arith")
            sym = (SYMBOL if shared else ARITH_SYMBOL)["packed_learner_chunk"]
            smem = lc.smem_bytes(lanes, lk.n_codes(c) if shared else 0)
            check(lk._library().gst_chunk_smem_bytes(lanes, lk.n_codes(c), 0)
                  == smem, "K5's shared memory differs from smem_bytes")
            offsets = (ctypes.c_longlong * 7)()
            lk._library().gst_chunk_layout(lk.n_codes(c), BB,
                                           ctypes.addressof(offsets))
            check(tuple(offsets) == tuple(lc.layout(lk.n_codes(c), BB)),
                  "K5's layout differs from learner_codes.layout")
            reg = [r for k, r in regs.items() if sym in k]
            old = (f" against the previous design's "
                   f"{LEARNER_OLD_MS[board]} ms ({LEARNER_OLD_MS[board] / now}x)"
                   if BB == B else "")
            print(f"[design] packed_learner_chunk {board[0]}x{board[1]} B={BB} "
                  f"T={TT} (rows in {'shared memory' if shared else 'L2'}): "
                  f"{lanes} lanes and {lc.PRODUCER_WARPS} producer warps a "
                  f"block ({-(-BB // lanes)} blocks of "
                  f"{lanes + 32 * lc.PRODUCER_WARPS} threads), "
                  f"{smem} B of shared memory "
                  f"per block, {reg} registers per thread; {per_step[key]} "
                  f"SASS per lane-step, bound "
                  f"{bound(BB * TT, per_step[key], 0)[0]} ms; {now} ms/call, "
                  f"{us} us of kernel a launch{old} | {card}")
    return launches, err, ms


def journal_checks(torch, pk, cfg, out, n_events):
    """The journal decodes by the repo's own rules: raw codes of reachable
    or goal states, a reset first on every lane and right after every
    termination, rewards only on goals, steps = transition events, and
    final flags that agree with the last event.  Returns the share of
    events that are transitions."""
    from gym_soccer_tpu_torch.core import tables
    J = pk.unpack_journal(out.journal)
    r2d = torch.as_tensor(tables.build_statespace(cfg).raw_to_dense,
                          device=out.journal.device)
    check(bool((r2d[J["raw"].long()] >= 0).all()), "unreachable raw code")
    reset, done, trunc = J["was_reset"], J["done"], J["truncated"]
    term = done | trunc
    check(bool((reset[0] == 1).all()), "a lane did not start with a reset")
    check(bool(((reset & term) == 0).all()), "reset event with a transition")
    check(torch.equal(reset[1:], term[:-1]), "resets do not follow ends")
    check(bool(((J["reward_a"] != 0) <= (done == 1)).all()),
          "reward without a goal")
    check(int(J["reward_a"].abs().max()) <= 1, "reward outside {-1, 0, 1}")
    check(torch.equal(out.steps, (1 - reset).sum(0).int()),
          "steps != transition events")
    check(torch.equal(out.needs_reset, term[-1].int()),
          "final needs_reset != last event's end")
    check(bool(((out.t >= 0) & (out.t <= cfg.max_steps)).all()),
          "t out of range")
    return int(out.steps.sum()) / (n_events * out.steps.shape[0])


def parity_inputs(pk, tables, np, cfg, B, seed_a=1, seed_b=7):
    """Seeds arange(B) % 997 and the joint-row table of two numpy-seeded
    random policies (tools/bench_parity_kernel.py's inputs)."""
    nS = tables.build_statespace(cfg).nS
    pol_a = np.random.RandomState(seed_a).randint(0, 5, nS)
    pol_b = np.random.RandomState(seed_b).randint(0, 5, nS)
    return np.arange(B) % 997, pk.jointrow_raw(cfg, pol_a, pol_b)


def lane_stream(pk, tables, cfg, out, lane=0):
    """Lane ``lane``'s events as host lists: (was_reset, state fields, obs,
    reward, done, truncated) per event."""
    from gym_soccer_tpu_torch.core import rules
    import numpy as np
    J = {k: v[:, lane].cpu().numpy() for k, v in
         pk.unpack_journal(out.journal).items()}
    r2d = tables.build_statespace(cfg).raw_to_dense
    fields = np.stack(rules.raw_decode(np, J["raw"].astype(np.int64), cfg), 1)
    return [(int(J["was_reset"][k]), fields[k].tolist(), int(r2d[J["raw"][k]]),
             int(J["reward_a"][k]), bool(J["done"][k]),
             bool(J["truncated"][k])) for k in range(len(fields))]


def check_policy_eval(pk, tables, cfg, out, fx, name):
    """Episode lengths, rewards and the step stream digest of one
    closed-loop golden evaluation from lane 0's journal; every lane ran
    the same seed, so every lane's journal is lane 0's."""
    import hashlib
    import numpy as np
    check(bool((out.journal == out.journal[:, :1]).all()),
          f"{name}: lanes of one seed differ")
    h = hashlib.sha256()
    lengths, rewards, n, total = [], [], 0, np.float64(0.0)
    for reset, _, obs, r, done, trunc in lane_stream(pk, tables, cfg, out):
        if reset:
            continue
        h.update(obs.to_bytes(4, "little"))
        h.update(np.float32(r).tobytes())
        h.update(b"\x01" if done else b"\x00")
        h.update(b"\x01" if trunc else b"\x00")
        n += 1
        total += np.float64(r)
        if done or trunc:
            lengths.append(n)
            rewards.append(total)
            n, total = 0, np.float64(0.0)
    want = [np.frombuffer(bytes.fromhex(x), np.float64)[0]
            for x in fx["episode_rewards"]]
    check(len(lengths) == fx["n_episodes"],
          f"{name}: {len(lengths)} episodes, not {fx['n_episodes']}")
    check(lengths == fx["episode_lengths"], f"{name}: episode lengths differ")
    check(rewards == want, f"{name}: episode rewards differ")
    check(h.hexdigest() == fx["step_stream_digest"],
          f"{name}: step stream digest differs")
    return len(lengths), sum(lengths)


def check_trajectory(pk, tables, cfg, out, rec, name):
    """Lane 0's events against a golden trajectory: the first event is the
    seeded reset, then one event per fixture record (resets included)."""
    import numpy as np
    ev = lane_stream(pk, tables, cfg, out)
    check(len(ev) == 1 + len(rec["steps"]), f"{name}: event count")
    check(ev[0][0] == 1 and ev[0][1] == rec["reset"]["state"],
          f"{name}: first reset")
    for k, r in enumerate(rec["steps"], start=1):
        reset, state, obs, rew, done, trunc = ev[k]
        if r.get("reset"):
            check(reset == 1 and state == r["state"],
                  f"{name}: reset at t={r['t']}")
            continue
        want_r = float(np.frombuffer(bytes.fromhex(r["reward"]["player_a"]),
                                     np.float64)[0])
        check(reset == 0 and state == r["state"]
              and obs == r["obs"]["player_a"] and float(rew) == want_r
              and done == r["done"]["player_a"]
              and trunc == r["trunc"]["player_a"],
              f"{name}: step t={r['t']} differs")
    return len(rec["steps"])


def parity_phases(torch, dev, card, regs):
    """Phases 14-17: the parity path and kernels K12/K13.  ``regs``: the
    build's registers per thread by kernel.  Returns their launches on the
    parity path, their max abs error against the plain versions, and the
    ms per call of both kernels and plain versions."""
    import numpy as np
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import tables
    from gym_soccer_tpu_torch.ops import parity_kernel as pk

    cfgs = {b: EnvConfig(width=b[0], height=b[1], slip_prob=SLIP)
            for b in BOARDS}
    # inputs made with numpy, kept on the card like a user's across calls
    on_dev = lambda a: torch.as_tensor(a, device=dev)
    inputs = {b: tuple(map(on_dev, parity_inputs(pk, tables, np, c, B)))
              for b, c in cfgs.items()}
    cfg54 = cfgs[(5, 4)]
    seeds = inputs[(5, 4)][0]
    rng = np.random.RandomState(3)
    script_np = (rng.randint(0, 5, (SCRIPT_ROWS, B)) * 5
                 + rng.randint(0, 5, (SCRIPT_ROWS, B))).astype(np.int32)
    script = on_dev(script_np)
    for c in cfgs.values():
        pk.build_pk(c)  # host tables: set-up, not the path

    # ---- 14. parity path, through the entry points ---------------------
    pk.reset_launch_counts()
    closed = {b: pk.parity_events(c, inputs[b][0], inputs[b][1], E_K12, dev)
              for b, c in cfgs.items()}
    scripted = pk.parity_scripted_events(cfg54, seeds, script, E_K13, dev)
    torch.cuda.synchronize()
    launches = dict(pk.launch_counts)
    print(f"[parity path] launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the parity path")
    frac = {}
    for b, out in closed.items():
        frac[b] = journal_checks(torch, pk, cfgs[b], out, E_K12)
        goals = int(pk.unpack_journal(out.journal)["done"].sum())
        print(f"[parity path] {b[0]}x{b[1]} B={B} E={E_K12}: journal "
              f"decodes; {int(out.steps.sum())} transitions (step fraction "
              f"{frac[b]}), {goals} goals")
    frac["script"] = journal_checks(torch, pk, cfg54, scripted, E_K13)
    check(int(scripted.steps.max()) <= SCRIPT_ROWS,
          "the script does not cover the events")
    print(f"[parity path] scripted 5x4 B={B} E={E_K13} rows={SCRIPT_ROWS}: "
          f"journal decodes; step fraction {frac['script']}, max steps "
          f"{int(scripted.steps.max())}")

    # ---- 15. K12/K13 against their plain versions ----------------------
    errs = {"parity_events": 0, "parity_scripted_events": 0}

    def err(a, b):
        return max_abs_err(list(zip(a, b)))

    lanes = {b: pk.lanes_per_block(len(pk.build_pk(c).occ_codes))
             for b, c in cfgs.items()}
    check(all(B % RAGGED_LANES and -(-B // n) >= 128
              for n in lanes.values()),
          f"block sizes {lanes}, {RAGGED_LANES}: not >= 128 blocks, or no "
          "ragged block")
    for b, c in cfgs.items():
        plain = pk.parity_events_plain(c, *inputs[b], E_K12, dev)
        for threads in (None, RAGGED_LANES):
            e = err(closed[b] if threads is None else pk.parity_events(
                c, *inputs[b], E_K12, dev, threads=threads), plain)
            errs["parity_events"] = max(errs["parity_events"], e)
            check(e == 0, f"K12 != plain on {b}, threads {threads}: "
                  f"max abs err {e}")
    splain = pk.parity_scripted_events_plain(cfg54, seeds, script, E_K13, dev)
    for threads in (None, RAGGED_LANES):
        e = err(scripted if threads is None else pk.parity_scripted_events(
            cfg54, seeds, script, E_K13, dev, threads=threads), splain)
        errs["parity_scripted_events"] = e
        check(e == 0, f"K13 != plain, threads {threads}: max abs err {e}")
    print(f"[K12/K13] B={B}: K12 (E={E_K12}, 5x4 and 11x7) and K13 "
          f"(E={E_K13}) bit-equal to the plain versions in the journal and "
          f"all 8 final fields (max abs err {errs}) at {lanes} lanes per "
          f"block (the default) and at {RAGGED_LANES} (a ragged last "
          f"block of {B % RAGGED_LANES} lanes)")
    lib = pk._library()
    for b, c in cfgs.items():
        P = len(pk.build_pk(c).occ_codes)
        for n in (32, lanes[b], RAGGED_LANES):
            check(lib.gst_parity_smem_bytes(n, P) == pk.smem_bytes(n, P),
                  f"the kernel's shared memory at {n} lanes, {P} classes "
                  "differs from smem_bytes")
    try:
        pk.parity_events(cfg54, *inputs[(5, 4)], 8, dev, threads=128)
        check(False, "a 128-lane block was not refused")
    except ValueError as e:
        print(f"[K12/K13] a block whose shared memory does not fit is "
              f"refused: {e}")
    # blocks of 2 lanes hold fewer threads than 5x4's four ISD states
    for b, c in cfgs.items():
        sd, jr = parity_inputs(pk, tables, np, c, 128, 5, 6)
        sc = script_np[:200, :128]
        want = (pk.parity_events(c, sd, jr, 640, "cpu"),
                pk.parity_scripted_events(c, sd, sc, 640, "cpu"))
        for threads in (None, 2):
            check(err(pk.parity_events(c, sd, jr, 640, dev, threads=threads),
                      want[0]) == 0, f"K12 != CPU plain on {b}, threads "
                  f"{threads}")
            check(err(pk.parity_scripted_events(c, sd, sc, 640, dev,
                                                threads=threads),
                      want[1]) == 0, f"K13 != CPU plain on {b}, threads "
                  f"{threads}")
    print("[K12/K13] B=128 E=640 on 5x4 and 11x7 equal the CPU plain "
          "versions at the default block size and at 2 lanes per block")

    # ---- 16. the reference's own runs, through the kernels -------------
    with open(GOLDEN) as f:
        gold = json.load(f)
    fx = gold["policy_eval_5x4_slip02_vi_vs_randomB"]
    pol_b = np.random.RandomState(0).randint(0, 5, 761)
    runs = (("policy_eval_5x4_slip02_vi_vs_randomB",
             pk.jointrow_raw(cfg54, fx["policy"], pol_b)),
            ("policy_eval_5x4_slip02_joint",
             pk.jointrow_raw(cfg54, gold["policy_eval_5x4_slip02_joint"][
                 "policy_a"], gold["policy_eval_5x4_slip02_joint"][
                 "policy_b"])))
    for name, jr in runs:
        fx = gold[name]
        out = pk.parity_events(cfg54, [fx["reset_seed"]] * 128, jr,
                               fx["total_steps"] + fx["n_episodes"], dev)
        n_epi, n_steps = check_policy_eval(pk, tables, cfg54, out, fx, name)
        print(f"[reference] {name}: all {n_epi} episodes ({n_steps} steps, "
              f"seed {fx['reset_seed']}) reproduced through K12: episode "
              "lengths, rewards and step stream digest match")
    slips = {"slip00": 0.0, "slip01": 0.1, "slip02": 0.2, "slip025": 0.25,
             "slip03": 0.3}
    for name in sorted(k for k in gold if k.startswith("traj_")
                       and "_multi_" in k):
        rec = gold[name]
        board, slip = name.split("_")[1:3]
        w, h = (int(x) for x in board.split("x"))
        c = EnvConfig(width=w, height=h, slip_prob=slips[slip])
        rows = np.asarray([r["action"]["player_a"] * 5
                           + r["action"]["player_b"]
                           for r in rec["steps"] if not r.get("reset")],
                          np.int32)
        out = pk.parity_scripted_events(
            c, [rec["seed"]] * 128, np.repeat(rows[:, None], 128, 1),
            1 + len(rec["steps"]), dev)
        n = check_trajectory(pk, tables, c, out, rec, name)
        print(f"[reference] {name}: {n} records reproduced through K13, "
              "step for step")

    # ---- 17. timing ----------------------------------------------------
    ms = {}
    timed = []
    for b, c in cfgs.items():
        timed.append(("parity_events", b, E_K12, frac[b],
                      lambda c=c, b=b: pk.parity_events(c, *inputs[b], E_K12,
                                                        dev),
                      lambda c=c, b=b: pk.parity_events_plain(
                          c, *inputs[b], E_K12, dev)))
    timed.append(("parity_scripted_events", (5, 4), E_K13, frac["script"],
                  lambda: pk.parity_scripted_events(cfg54, seeds, script,
                                                    E_K13, dev),
                  lambda: pk.parity_scripted_events_plain(
                      cfg54, seeds, script, E_K13, dev)))
    for name, b, E, f, kern, plain in timed:
        for label, fn in ((name, kern), (name + "_plain", plain)):
            med, reps, leg_ms = time_cuda(fn, slow_legs=3)
            few = ("; 3 legs, not 5: a call took over 1 s"
                   if len(leg_ms) == 3 else "")
            if b == (5, 4):
                ms[label] = med
            ev_s = B * E / (med / 1e3)
            print(f"[time] {label} {b[0]}x{b[1]} B={B} E={E}: {med} ms/call, "
                  f"{ev_s} events/s, {ev_s * f} bit-exact env-steps/s (step "
                  f"fraction {f}; median of {len(leg_ms)} legs x {reps} "
                  f"calls; legs ms/call {leg_ms}{few}) | {card}")
            if label == name:
                P = len(pk.build_pk(cfgs[b]).occ_codes)
                n = pk.lanes_per_block(P)
                reg = [r for k, r in regs.items() if SYMBOL[name] in k]
                old = (f"; the previous design {PARITY_OLD_MS[name]} ms on "
                       "5x4 (NVIDIA H100 80GB HBM3, 700 W)"
                       if b == (5, 4) else "")
                print(f"[design] {name} {b[0]}x{b[1]}: {n} lanes per block "
                      f"({-(-B // n)} blocks), {pk.smem_bytes(n, P)} B of "
                      f"shared memory per block ({P} classes), {reg} "
                      f"registers per thread; {med} ms/call{old} | {card}")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # inputs, and the journal and 8 final fields written
    io_bytes = {"parity_events": nbytes(*inputs[(5, 4)]) + 4 * B * (E_K12 + 8),
                "parity_scripted_events": nbytes(seeds, script)
                + 4 * B * (E_K13 + 8)}
    return launches, errs, ms, io_bytes


def iql_inputs(torch, ik, cfg, B, dev, seed):
    """Q tables in [-1, 1] with near-ties (every third state's action 1 one
    float32 step above action 0, a tie once double-bf16 rounded) made from
    a numpy seed, as the chunk's table; and the initial fields."""
    import numpy as np
    nS = len(ik.lk._cell_rows(cfg))
    rng = np.random.default_rng(seed)
    qa, qb = (torch.tensor(rng.uniform(-1, 1, (nS, 5)), dtype=torch.float32)
              for _ in range(2))
    qa[::3, 1] = torch.nextafter(qa[::3, 0], torch.tensor(2.0))
    return (ik.pack_iql_table(cfg, qa.to(dev), qb.to(dev)),
            ik.init_iql_state_fields(cfg, B, dev))


def iql_phases(torch, dev, card, cfgs, batch, per_step, regs):
    """Phases 18-21: the independent-Q path and kernels K8/K9.  Returns
    their launches on the IQL path, their max abs error against the plain
    versions, and the ms per call of both kernels and plain versions."""
    from gym_soccer_tpu_torch.ops import iql_codes as qc
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    cfg = cfgs[(5, 4)]
    names = {True: "iql_packed_chunk", False: "iql_chunk"}
    eps = int(round(0.3 * 65536))

    # ---- 18. IQL path, through the entry point, on its default device ---
    ik.reset_launch_counts()
    path = {packed: ik.fused_iql_train(
        cfg, batch=B, n_chunks=4, chunk_len=T_K8, lr=0.5, eps=0.3, seed=3,
        packed=packed, return_state=True) for packed in (True, False)}
    torch.cuda.synchronize()
    launches = dict(ik.launch_counts)
    print(f"[iql path] launches {launches}")
    check(launches == {"iql_packed_chunk": 4, "iql_chunk": 4},
          "the IQL path did not launch K8 and K9 once a chunk")
    for packed, (q_a, q_b, hist, res) in path.items():
        check(q_a.device.type == "cuda", "fused_iql_train did not default "
              "to the card")
        q_max = float(max(q_a.abs().max(), q_b.abs().max()))
        check(bool(torch.isfinite(q_a).all() & torch.isfinite(q_b).all()),
              "Q is not finite")
        check(q_max <= 1.05, f"|Q| = {q_max} > 1.05")
        goals = sum(h[1] for h in hist)
        check(goals > 0, "no goals on the IQL path")
        _, acc, _ = getattr(ik, names[packed])(
            cfg, 3, eps, ik.pack_iql_table(cfg, q_a, q_b), res["fields"], B,
            T_K8, 0.99, 4 * T_K8)
        cnt_a, cnt_b = ik.unpack_iql_acc(cfg, acc)[1::2]
        check(int(cnt_a.sum()) == int(cnt_b.sum()) == B * T_K8,
              "visit counts do not sum to B * T per player")
        print(f"[iql path] 5x4 B={B} 4 chunks x {T_K8} steps, packed="
              f"{packed}: max|Q| {q_max}, goals in recorded chunks {goals}; "
              f"a fifth chunk counts {B * T_K8} visits per player")

    # ---- 19. K8/K9 against their plain versions ------------------------
    errs = {name: 0 for name in names.values()}
    for board, c in cfgs.items():
        table, fields = iql_inputs(torch, ik, c, B, dev, seed=board[0])
        plain = {}
        for name in names.values():
            want = getattr(ik, name + "_plain")(c, 77, eps, table, fields, B,
                                                T_K8, 0.99, 640)
            for lanes in (None, IQL_RAGGED_LANES):
                e = chunk_err(getattr(ik, name)(c, 77, eps, table, fields, B,
                                                T_K8, 0.99, 640, lanes),
                              want)
                errs[name] = max(errs[name], e)
                check(e == 0, f"{name} != plain on {board}, "
                      f"{lanes or 'default'} lanes per block: max abs err "
                      f"{e}")
            # 512 lanes x 129 steps: more visits than a block's private
            # accumulators take (2**16), added by device-memory atomics
            long = [f[:1024] for f in fields]
            check(chunk_err(
                getattr(ik, name)(c, 6, eps, table, long, 1024, 129, 0.99, 3,
                                  512),
                getattr(ik, name + "_plain")(c, 6, eps, table, long, 1024, 129,
                                             0.99, 3)) == 0,
                f"{name} != plain on {board} at 512 lanes x 129 steps")
            small = [f[:256] for f in fields]
            check(chunk_err(
                getattr(ik, name)(c, 5, eps, table, small, 256, 16, 0.99, 9),
                getattr(ik, name)(c, 5, eps, table.cpu(),
                                  [f.cpu() for f in small], 256, 16, 0.99,
                                  9)) == 0,
                f"{name} != CPU plain on {board}")
            check(int(want[2][3]) == 0, f"{name}: values out of range")
            for bad in (float("nan"), 1e7):   # every value; terminal ones
                counts = [int(getattr(ik, name)(c, 5, eps, t + bad, f, 256, 16,
                                                0.99, 9)[2][3])
                          for t, f in ((table, small), (table.cpu(),
                                       [x.cpu() for x in small]))]
                check(counts[0] == counts[1] > 0, f"{name} counts {counts} "
                      f"values out of range with a table + {bad}")
            plain[name] = want
        (fa, (_, ca), sa), (fb, (_, cb), sb) = plain.values()
        check(max_abs_err([*zip(fa, fb), (ca, cb), (ints(sa), ints(sb))]) == 0,
              f"K8 and K9 step different trajectories on {board}")
        check(int(ca.sum()) == 2 * B * T_K8, "visit counts != 2 * B * T")
        print(f"[K8/K9] {board[0]}x{board[1]} B={B} T={T_K8} step offset "
              f"640: bit-equal to plain (fields, stats, counts, int64 sums; "
              f"max abs err {errs}) at the default lanes per block "
              f"({qc.default_lanes(B)}) and {IQL_RAGGED_LANES} (ragged), and "
              "at B=1024 T=129 at 512 lanes per block (device-memory "
              "atomics); K8 and K9 step the same fields, stats and counts; "
              "B=256 T=16 "
              "equals the CPU plain versions, and counts the same values out "
              "of range on tables + nan and + 1e7")

    # ---- 20. resume and learning on the card ---------------------------
    kw = dict(batch=B, chunk_len=T_K8, lr=0.5, eps=0.3, eps_halflife=64,
              lr_anneal_start=1, lr_anneal_tau=4.0, seed=9)
    for packed in (True, False):
        whole = ik.fused_iql_train(cfg, n_chunks=2, return_state=True,
                                   packed=packed, **kw)
        r = ik.fused_iql_train(cfg, n_chunks=1, return_state=True,
                               packed=packed, **kw)[3]
        part = ik.fused_iql_train(
            cfg, n_chunks=1, return_state=True, packed=packed,
            init=(r["q_a"], r["q_b"]), fields_init=r["fields"],
            start_chunk=r["next_chunk"], **kw)
        check(all(torch.equal(a, b) for a, b in
                  [*zip(whole[:2], part[:2]),
                   *zip(whole[3]["fields"], part[3]["fields"])]),
              f"2 chunks != 1 + 1 through the resume dict (packed={packed})")
    print("[iql resume] 2 chunks == 1 + 1 through the resume dict, bit for "
          "bit in q_a, q_b and fields, packed and unpacked")
    # tests/test_iql_kernel.py test_fused_iql_training_learns
    q_a, q_b, hist = ik.fused_iql_train(cfg, batch=1024, n_chunks=30,
                                        chunk_len=16, lr=0.4, eps=0.3)
    q_a, q_b = q_a.cpu().numpy(), q_b.cpu().numpy()
    import numpy as np
    check(np.abs(q_a).max() > 0.05 and np.abs(q_b).max() > 0.05,
          "IQL tables did not move")
    check(np.abs(q_a).max() <= 1.05 and np.abs(q_b).max() <= 1.05,
          "|Q| > 1.05")
    check(sum(h[1] for h in hist) > 0, "no goals while learning")
    va, vb = q_a.max(-1), q_b.max(-1)
    mask = (np.abs(va) > 0.2) & (np.abs(vb) > 0.2)
    corr = (float(np.corrcoef(va[mask], vb[mask])[0, 1])
            if mask.sum() > 20 else None)
    check(corr is None or corr < 0.5, f"A's and B's values correlate {corr}")
    print(f"[iql learn] the JAX package's learning check passes on the card: "
          f"max|q_a| {np.abs(q_a).max()}, max|q_b| {np.abs(q_b).max()}, "
          f"corr(max q_a, max q_b) on {int(mask.sum())} states {corr}")
    timing = {}
    big = IQL_RUN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_a, q_b, hist = ik.fused_iql_train(cfg, timing=timing, **big)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = big["batch"] * big["n_chunks"] * big["chunk_len"]
    print(f"[iql run] 5x4 {big}: train wall {wall} s for {steps} env-steps "
          f"({steps / wall} env-steps/s): chunk calls {timing['kernel_ms']} "
          f"ms, between chunks {timing['between_ms']} ms over "
          f"{timing['chunks']} chunks | {card}")
    grouped_phase(torch, "IQL run",
                  lambda **g: ik.fused_iql_train(cfg, **big, **g),
                  (q_a, q_b, hist), wall, 2, ik.launch_counts,
                  "iql_packed_chunk", big["n_chunks"], card)
    key_words = np.random.default_rng(2).integers(0, 2**32, (512, 2),
                                                  dtype=np.uint64)
    state = batch.init_from_keys(cfg, key_words, dev, rng="counter")
    _, stats = batch.rollout_stats(
        cfg, state, lambda obs, i: (q_a[obs.long()].argmax(-1).int(),
                                    q_b[obs.long()].argmax(-1).int()), 200,
        rng="counter")
    print(f"[iql run] greedy vs greedy, 512 lanes x 200 steps through the "
          f"batched engine: reward sum {float(stats.reward_sum)}, goals "
          f"{int(stats.goals)}, truncations {int(stats.truncs)}")

    # ---- 21. timing ----------------------------------------------------
    ms = {}
    lanes = qc.default_lanes(B)
    for board, c in cfgs.items():
        table, fields = iql_inputs(torch, ik, c, B, dev, seed=board[0])
        for name in (*names.values(), *(n + "_plain" for n in names.values())):
            fn = getattr(ik, name)
            med, reps, legs = time_cuda(
                lambda: fn(c, 77, eps, table, fields, B, T_K8, 0.99, 640))
            ms[name, board] = med
            print(f"[time] {name} {board[0]}x{board[1]} B={B} T={T_K8}: "
                  f"{med} ms/call, {B * T_K8 / (med / 1e3)} learner "
                  f"env-steps/s (median of {len(legs)} legs x {reps} calls; "
                  f"legs ms/call {legs}) | {card}")
        n = ik.n_codes(c)
        shared = qc.shared_rows(c)
        acc = qc.shared_acc(c, lanes, T_K8)
        smem = qc.block_smem_bytes(c, lanes, T_K8)
        check(ik._library().gst_iql_smem_bytes(lanes, n, T_K8) == smem,
              "K8/K9's shared memory differs from iql_codes.smem_bytes")
        offsets = (ctypes.c_longlong * 7)()
        ik._library().gst_iql_layout(n, B, ctypes.addressof(offsets))
        check(tuple(offsets) == tuple(qc.layout(n, B)),
              "K8/K9's layout differs from iql_codes.layout")
        for name in names.values():
            sym = (SYMBOL if acc else ARITH_SYMBOL)[name]
            key = name if acc else name + " arith"
            reg = [r for k, r in regs.items() if sym in k]
            now, old = ms[name, board], IQL_OLD_MS[name, board]
            print(f"[design] {name} {board[0]}x{board[1]} B={B} T={T_K8} "
                  f"(rows in {'shared memory' if shared else 'L2'}, "
                  f"accumulators in "
                  f"{'shared memory' if acc else 'device memory'}): {lanes} "
                  f"lanes and {qc.PRODUCER_WARPS} producer warps a block "
                  f"({-(-B // lanes)} blocks of "
                  f"{lanes + 32 * qc.PRODUCER_WARPS} threads), {smem} B of "
                  f"shared memory per block ({qc.row_bytes(n)} B of rows), "
                  f"{reg} registers per thread; {per_step[key]} SASS per "
                  f"lane-step, bound {bound(B * T_K8, per_step[key], 0)[0]} "
                  f"ms; {now} ms/call against the previous design's {old} "
                  f"ms ({old / now}x) | {card}")
    ms = {name: t for (name, board), t in ms.items() if board == (5, 4)}
    wide = 32768
    table, fields = iql_inputs(torch, ik, cfg, wide, dev, seed=5)
    med, reps, legs = time_cuda(lambda: ik.iql_packed_chunk(
        cfg, 77, eps, table, fields, wide, T_K8, 0.99, 640))
    print(f"[time] iql_packed_chunk 5x4 B={wide} T={T_K8}: {med} ms/call, "
          f"{wide * T_K8 / (med / 1e3)} learner env-steps/s (median of "
          f"{len(legs)} legs x {reps} calls) | {card}")
    table, fields = iql_inputs(torch, ik, cfg, B, dev, seed=5)
    for packed, name in names.items():
        profile_window(torch, lambda: getattr(ik, name)(
            cfg, 77, eps, table, fields, B, T_K8, 0.99, 640),
            f"{name} 5x4 B={B} T={T_K8}",
            f"iql_chunk_kernel<{str(packed).lower()}", card)
    return launches, errs, ms


def mg_inputs(torch, lk, cfg, B, dev, seed, bad=None):
    """Tables with non-uniform pi and v, q in [-1, 1] made from a numpy
    seed (``bad`` added to every v and q), packed and unpacked, and the
    initial state: six fields, or (planes, fields) for a mixture."""
    import numpy as np
    nS = lk.n_states(cfg)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    pa, pb = (t(rng.dirichlet(np.ones(5), nS)) for _ in range(2))
    v, q = t(rng.uniform(-1, 1, nS)), t(rng.uniform(-1, 1, (nS, 5, 5)))
    if bad is not None:
        v, q = v + bad, q + bad
    return (lk.pack_m2(cfg, pa, pb, v, 0.2), lk.pack_m(cfg, pa, pb, q, v, 0.2),
            lk.init_state_fields(cfg, B, dev))


def run_chunk(lk, name, cfg, seed, table, state, B, T, **kw):
    """One chunk of learner ``name`` (a wrapper or a plain version) from
    ``state`` as ``mg_inputs`` makes it."""
    fn = getattr(lk, name)
    if isinstance(cfg, tuple):
        planes, fields = state
        return fn(cfg, seed, table, planes, fields, B, T, 0.99, **kw)
    return fn(cfg, seed, table, state, B, T, 0.99, **kw)


def to_cpu(state):
    return tuple(to_cpu(x) if isinstance(x, tuple) else x.cpu()
                 for x in state)


def multigrid_phases(torch, dev, card, exploitability, per_step, regs):
    """Phases 22-26: the mixed-geometry path and kernels K3, K6 and K7
    (both sites).  Returns their launches on the path, their max abs
    error against the plain versions (K5's too, from phase 24), their ms
    per call and those of their plain versions, and each kernel's work at
    its timed shape (lane-steps, bytes)."""
    import numpy as np
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import multigrid as mg
    from gym_soccer_tpu_torch.core import tables
    from gym_soccer_tpu_torch.ops import learner_codes as lc
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.ops import rollout_codes as rc
    from gym_soccer_tpu_torch.ops import step_kernel as sk
    mix = tuple(EnvConfig(*b) for b in MIX3)
    big = tuple(EnvConfig(*b) for b in MIX_BIG)
    mgc = tuple(EnvConfig(*b) for b in MG_BOARDS)
    c54, c117 = EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)
    K6, K7, K7M = ("multigrid_packed_learner_chunk", "learner_chunk",
                   "multigrid_learner_chunk")
    train_kw = dict(batch=B, n_chunks=4, chunk_len=T_K6, lr=1.0, eps=0.2,
                    solver_iters=200, seed=3)

    # ---- 22. mixed-geometry path, through the entry points -------------
    sk.reset_launch_counts()
    lk.reset_launch_counts()
    k3 = sk.multigrid_rollout(mix, 21, B, T_K3)
    train = {packed: lk.fused_minimax_train(mix, packed=packed,
                                            return_state=True, **train_kw)
             for packed in (True, False)}
    lk.fused_minimax_train(c54, packed=False, **train_kw)
    torch.cuda.synchronize()
    launches = {"multigrid_rollout": sk.launch_counts["multigrid_rollout"],
                **{n: lk.launch_counts[n] for n in (K6, K7, K7M)}}
    print(f"[mixture path] launches {launches}")
    check(launches == {"multigrid_rollout": 1, K6: 4, K7: 4, K7M: 4},
          "the mixed-geometry path did not launch K3 once and K6, K7 and "
          "K7 multigrid once a chunk")
    fields, stats = k3
    check(fields[0].device.type == "cuda",
          "multigrid_rollout did not default to the card")
    geo = mg.lane_geometry(mix, B, device=dev)
    ra, ca, rb, cb, p, t = fields
    inside = ((ra >= 0) & (ra < geo.H) & (rb >= 0) & (rb < geo.H)
              & (ca >= 0) & (ca < geo.W) & (cb >= 0) & (cb < geo.W))
    check(bool(inside.all()), "a lane left its own board")
    dense = mg.dense_obs(mg.build_codec(mix), fields, geo)
    check(bool((dense > 0).all()),
          "a lane ended terminal or unreachable on its own board")
    check(bool(((t >= 0) & (t < 100)).all()), "t out of range")
    per_variant = stats.cpu().tolist()
    for (rew, goals, truncs), b in zip(per_variant, MIX3):
        check(goals > 0 and abs(rew) <= goals and truncs >= 0,
              f"implausible stats {[rew, goals, truncs]} on {b}")
    totals = stats.sum(0).tolist()
    check(0 < totals[1] < B * T_K3, f"implausible totals {totals}")
    print(f"[mixture path] K3 {MIX3} B={B} T={T_K3}: per-variant stats "
          f"{per_variant}, totals {totals}; every lane on its own board in "
          "a reachable state of its variant")
    lanes_v = np.bincount(np.arange(B) * len(mix) // B)
    offs = list(lk.mg_offsets(mix)) + [lk.n_codes(mix)]
    for packed, (q, v, pa, pb, hist, res) in train.items():
        check(bool(torch.isfinite(q).all()), "Q is not finite")
        check(float(v.abs().max()) <= 1.05,
              f"|v| = {float(v.abs().max())} > 1.05")
        check(sum(h[1] for h in hist) > 0, "no goals on the mixture path")
        # one more chunk at v = q = 0: its sums are the rewards, so each
        # variant's block holds its lanes' reward sum and visit count
        zv, zq = torch.zeros_like(v), torch.zeros_like(q)
        table = (lk.pack_m2(mix, pa, pb, zv, 0.2) if packed
                 else lk.pack_m(mix, pa, pb, zq, zv, 0.2))
        planes, _ = lk.init_state_fields(mix, B, dev)
        _, (sums, cnt), st = getattr(lk, K6 if packed else K7M)(
            mix, 5, table, planes, res["fields"], B, T_K6)
        rew_v = [int(sums[o:e].sum()) // 2 ** 32
                 for o, e in zip(offs, offs[1:])]
        cnt_v = [int(cnt[o:e].sum()) for o, e in zip(offs, offs[1:])]
        check(cnt_v == [int(n) * T_K6 for n in lanes_v],
              f"per-variant visits {cnt_v} != lanes x T")
        check(sum(rew_v) == int(st[0]) and sum(cnt_v) == B * T_K6,
              "per-variant sums do not add up to the chunk's totals")
        print(f"[mixture path] fused_minimax_train {MIX3} B={B} 4 chunks x "
              f"{T_K6} steps, packed={packed}: max|v| "
              f"{float(v.abs().max())}; a fifth chunk counts {cnt_v} visits "
              f"per variant block (lanes {lanes_v.tolist()} x {T_K6}) and "
              f"rewards {rew_v}, summing to its totals {ints(st[:3])}")

    errs = {n: 0 for n in ("multigrid_rollout", "packed_learner_chunk",
                           K6, K7, K7M)}

    # ---- 23. K3 --------------------------------------------------------
    pf, ps = sk.multigrid_rollout_plain(mix, 21, B, T_K3, dev)
    for lanes in (None, ROLLOUT_RAGGED_LANES):
        got = k3 if lanes is None else sk.multigrid_rollout(
            mix, 21, B, T_K3, dev, threads=lanes)
        e = max_abs_err([*zip(got[0], pf), (got[1], ps)])
        errs["multigrid_rollout"] = max(errs["multigrid_rollout"], e)
        check(e == 0, f"K3 != plain at {lanes or 'default'} lanes per block: "
              f"max abs err {e}")
    h = T_K3 // 2
    fa, sa = sk.multigrid_rollout(mix, 21, B, h, dev)
    fb, sb = sk.multigrid_rollout(mix, 21, B, T_K3 - h, dev, init_fields=fa,
                                  step_offset=h)
    check(max_abs_err([*zip(fb, pf), (sa + sb, ps)]) == 0,
          f"K3 split at step {h} != one run")
    f1, s1 = sk.fused_rollout(c54, 21, B, T_K3, dev)
    fm, sm = sk.multigrid_rollout((c54,), 21, B, T_K3, dev)
    check(max_abs_err([*zip(f1, fm), (ints(s1), ints(sm[0]))]) == 0,
          "the (5x4,) mixture != K1")
    gf, gs = sk.multigrid_rollout(mix, 3, 1024, 64, dev)
    cf, cs = sk.multigrid_rollout(mix, 3, 1024, 64, "cpu")
    check(max_abs_err([*zip(gf, cf), (gs, cs)]) == 0, "K3 != CPU plain")
    print(f"[K3] {MIX3} B={B} T={T_K3}: bit-equal to plain (fields and "
          f"per-variant stats; max abs err {errs['multigrid_rollout']}) at "
          f"{rc.DEFAULT_LANES} (default) and {ROLLOUT_RAGGED_LANES} (ragged) "
          f"lanes per block; {h}+{T_K3 - h} split equals one run; the "
          "(5x4,) mixture equals K1; B=1024 T=64 equals the CPU plain "
          "version")

    # ---- 24. K6 and K7 against their plain versions --------------------
    cells = (("mixture", mix, (K6, K7M)), ("5x4+11x7", big, (K6, K7M)),
             ("5x4", c54, ("packed_learner_chunk", K7)),
             ("11x7", c117, ("packed_learner_chunk", K7)),
             ("5x4+6x5", mgc, (K6, K7M)))
    for seed, (label, cfg, pair) in enumerate(cells, start=1):
        m2, m, state = mg_inputs(torch, lk, cfg, B, dev, seed)
        small = lk.init_state_fields(cfg, 256, dev)
        plain = {}
        for name, table in zip(pair, (m2, m)):
            want = run_chunk(lk, name + "_plain", cfg, 77, table, state, B,
                             T_K6)
            for threads in (None, LEARNER_RAGGED_LANES[B]):
                e = chunk_err(run_chunk(lk, name, cfg, 77, table, state, B,
                                        T_K6, threads=threads), want)
                errs[name] = max(errs[name], e)
                check(e == 0, f"{name} != plain on {label}, threads "
                      f"{threads}: max abs err {e}")
            check(int(want[2][3]) == 0, f"{name}: values out of range")
            check(chunk_err(
                run_chunk(lk, name, cfg, 5, table, small, 256, 16),
                run_chunk(lk, name, cfg, 5, table.cpu(), to_cpu(small), 256,
                          16)) == 0, f"{name} != CPU plain on {label}")
            plain[name] = want
        for bad in (float("nan"), 1e7):
            b2, b1, _ = mg_inputs(torch, lk, cfg, 256, dev, seed, bad)
            for name, table in zip(pair, (b2, b1)):
                counts = [int(run_chunk(lk, name, cfg, 5, tb, st, 256, 16)[2][3])
                          for tb, st in ((table, small),
                                         (table.cpu(), to_cpu(small)))]
                check(counts[0] == counts[1] > 0, f"{name} counts {counts} "
                      f"values out of range on {label} with v, q + {bad}")
        (fa, (_, ca), sa), (fb, (_, cb), sb) = plain.values()
        check(max_abs_err([*zip(fa, fb), (ca, cb), (ints(sa), ints(sb))]) == 0,
              f"{pair} step different trajectories on {label}")
        check(int(ca.sum()) == B * T_K6, "visit counts != B * T")
        print(f"[K6/K7] {label} B={B} T={T_K6} (rows in "
              f"{'shared memory' if lc.shared_rows(cfg) else 'L2'}): {pair} "
              "bit-equal to plain (fields, stats, counts, int64 sums, "
              f"out-of-range count) at {lc.default_lanes(B)} (default) and "
              f"{LEARNER_RAGGED_LANES[B]} (ragged) lanes per block; both "
              "step the same fields, stats and counts; B=256 T=16 equals the "
              "CPU plain versions, and counts the same values out of range "
              "with v, q + nan and + 1e7")
    print(f"[K6/K7] max abs err {errs}")
    kw = dict(batch=B, chunk_len=T_K6, lr=0.5, eps=0.3, eps_halflife=64,
              lr_anneal_start=1, lr_anneal_tau=4.0, solver_iters=100, seed=9,
              device=dev)
    one = lk.fused_minimax_train((c54,), n_chunks=3, return_state=True, **kw)
    static = lk.fused_minimax_train(c54, n_chunks=3, return_state=True, **kw)
    check(all(torch.equal(a, b) for a, b in
              [(one[0], static[0]), (one[5]["n"], static[5]["n"]),
               *zip(one[5]["fields"], static[5]["fields"])]),
          "the (5x4,) mixture trainer != the static trainer")
    for packed in (True, False):
        whole = lk.fused_minimax_train(mix, n_chunks=2, return_state=True,
                                       packed=packed, **kw)
        r = lk.fused_minimax_train(mix, n_chunks=1, return_state=True,
                                   packed=packed, **kw)[5]
        part = lk.fused_minimax_train(
            mix, n_chunks=1, return_state=True, packed=packed,
            init=tuple(r[k] for k in ("q", "v", "pi_a", "pi_b", "n")),
            fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
        check(all(torch.equal(a, b) for a, b in
                  [*zip(whole[:4], part[:4]), (whole[5]["n"], part[5]["n"]),
                   *zip(whole[5]["fields"], part[5]["fields"])]),
              f"mixture: 2 chunks != 1 + 1 (packed={packed})")
    print("[mixture resume] the (5x4,) mixture trainer equals the static "
          "trainer for 3 chunks, bit for bit in q, n and fields; mixture "
          "runs resumed 1 + 1 equal 2, packed and unpacked")

    # ---- 25. learning: the --multigrid recipe --------------------------
    for packed in (True, False):
        timing = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, v, pa, pb, hist = lk.fused_minimax_train(
            mgc, device=dev, timing=timing, packed=packed, **MG_RECIPE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        off, exs = 0, []
        for c in mgc:
            nS = tables.build_statespace(c).nS
            exs.append(exploitability(c, pa[off:off + nS], pb[off:off + nS],
                                      gamma=0.99))
            off += nS
        t_eval = time.perf_counter() - t1
        steps = (MG_RECIPE["batch"] * MG_RECIPE["chunk_len"]
                 * MG_RECIPE["n_chunks"])
        print(f"[mixture learn] {MG_BOARDS} recipe {MG_RECIPE}, packed="
              f"{packed}: exploitability per variant {exs} (limits "
              f"{MG_EXPLOITABILITY}) | train wall {wall} s for {steps} "
              f"env-steps: chunk calls {timing['kernel_ms']} ms, between "
              f"chunks {timing['between_ms']} ms over {timing['chunks']} "
              f"chunks; exploitability eval {t_eval} s | {card}")
        for ex, limit, b in zip(exs, MG_EXPLOITABILITY, MG_BOARDS):
            check(ex <= limit, f"exploitability {ex} > {limit} on {b} "
                  f"(packed={packed})")
        grouped_phase(
            torch, f"--multigrid recipe, packed={packed}",
            lambda **g: lk.fused_minimax_train(mgc, device=dev, packed=packed,
                                               **MG_RECIPE, **g),
            (q, v, pa, pb, hist), wall, 4, lk.launch_counts,
            K6 if packed else K7M, MG_RECIPE["n_chunks"], card,
            solves=MG_RECIPE["n_chunks"] + 1)

    # ---- 26. timing ----------------------------------------------------
    ms = {}
    med_k, reps, legs = time_cuda(lambda: sk.multigrid_rollout(mix, 1, B,
                                                               T_K3, dev))
    med_p, _, _ = time_cuda(lambda: sk.multigrid_rollout_plain(
        mix, 1, B, T_K3, dev), slow_legs=3)
    ms["multigrid_rollout"], ms["multigrid_rollout_plain"] = med_k, med_p
    print(f"[time] multigrid_rollout {MIX3} B={B} T={T_K3}: {med_k} ms/call, "
          f"{B * T_K3 / (med_k / 1e3)} env-steps/s (median of {len(legs)} "
          f"legs x {reps} calls; legs ms/call {legs}); plain {med_p} ms/call "
          f"| {card}")
    b_recipe = MG_RECIPE["batch"]
    timed = (("mixture", mix, B, (K6, K7M)), ("mixture", mix, B_WIDE, (K6,)),
             ("5x4+11x7", big, B, (K6,)),
             ("5x4+6x5", mgc, b_recipe, (K6, K7M)),
             ("5x4", c54, B, (K7,)), ("11x7", c117, B, (K7,)))
    calls = {}
    for label, cfg, BB, names in timed:
        m2, m, state = mg_inputs(torch, lk, cfg, BB, dev, 5)
        for name in names:
            table = m2 if name == K6 else m
            med_k, reps, legs = time_cuda(lambda: run_chunk(
                lk, name, cfg, 77, table, state, BB, T_K6))
            med_p, _, _ = time_cuda(lambda: run_chunk(
                lk, name + "_plain", cfg, 77, table, state, BB, T_K6),
                slow_legs=3)
            if BB == B and label in ("mixture", "5x4"):
                ms[name], ms[name + "_plain"] = med_k, med_p
            calls[name, label, BB] = med_k
            print(f"[time] {name} {label} B={BB} T={T_K6}: {med_k} ms/call, "
                  f"{BB * T_K6 / (med_k / 1e3)} learner env-steps/s (median "
                  f"of {len(legs)} legs x {reps} calls; legs ms/call {legs});"
                  f" plain {med_p} ms/call | {card}")
    us = {"multigrid_rollout": profile_window(
        torch, lambda: sk.multigrid_rollout(mix, 1, B, T_K3, dev),
        f"multigrid_rollout mixture B={B} T={T_K3}", "mg_rollout_kernel",
        card)}
    for label, cfg, BB, name in (("mixture", mix, B, K7M),
                                 ("5x4", c54, B, K7)):
        _, m, state = mg_inputs(torch, lk, cfg, BB, dev, 5)
        us[name] = profile_window(
            torch, lambda: run_chunk(lk, name, cfg, 77, m, state, BB, T_K6),
            f"{name} {label} B={BB} T={T_K6}", "chunk_kernel<false", card)
    # the design lines of K6 and K7 multigrid in each cell, with their
    # device time by CUDA-graph replay (memset, prep pass, kernel)
    from gym_soccer_tpu_torch.ops import rollout_variants
    for label, cfg, BB, names in timed[:4]:
        m2, m, state = mg_inputs(torch, lk, cfg, BB, dev, 5)
        n, lanes = lk.n_codes(cfg), lc.default_lanes(BB)
        shared = lc.shared_rows(cfg)
        smem = lc.smem_bytes(lanes, n if shared else 0, True)
        check(lk._library().gst_chunk_smem_bytes(lanes, n, 1) == smem,
              "K6/K7 multigrid's shared memory differs from "
              "learner_codes.smem_bytes")
        for name in names:
            table = m2 if name == K6 else m
            device = rollout_variants._device_ms(lambda: run_chunk(
                lk, name, cfg, 77, table, state, BB, T_K6))
            key = name + (" arith" if shared else "")
            sym = (ARITH_SYMBOL if shared else SYMBOL)[name]
            reg = [r for k, r in regs.items() if sym in k]
            old = MG_OLD_DEVICE_MS.get((name, label, BB))
            old = ("" if old is None else f" against the previous design's "
                   f"{old} ms ({old / device}x)")
            print(f"[design] {name} {label} B={BB} T={T_K6} (rows in "
                  f"{'shared memory' if shared else 'L2'}): {lanes} lanes and "
                  f"{lc.PRODUCER_WARPS} producer warps a block "
                  f"({-(-BB // lanes)} blocks of "
                  f"{lanes + 32 * lc.PRODUCER_WARPS} threads), {smem} B of "
                  f"shared memory per block, {reg} registers per thread; "
                  f"{per_step[key]} SASS per lane-step, bound "
                  f"{bound(BB * T_K6, per_step[key], 0)[0]} ms; "
                  f"{calls[name, label, BB]} ms/call, {device} ms of device "
                  f"time (CUDA graph replay: memset, prep pass, kernel){old} "
                  f"| {card}")
    # the design lines of the split kernels K3 and K7
    lanes = rc.DEFAULT_LANES
    check(sk._library().gst_mg_rollout_smem_bytes(lanes)
          == rc.mg_smem_bytes(lanes), "K3's shared memory differs from "
          "mg_smem_bytes")
    design = [("multigrid_rollout", "mixture", T_K3, "multigrid_rollout",
               SYMBOL["multigrid_rollout"], lanes, rc.mg_smem_bytes(lanes),
               "")]
    lanes = lc.default_lanes(B)
    for name, label, cfg, arith in ((K7, "5x4", c54, False),
                                    (K7, "11x7", c117, True)):
        shared = lc.shared_rows(cfg)
        smem = lc.smem_bytes(lanes, lk.n_codes(cfg) if shared else 0)
        check(lk._library().gst_chunk_smem_bytes(
            lanes, lk.n_codes(cfg), 0) == smem,
            f"{name}'s shared memory differs from learner_codes.smem_bytes")
        design.append((name, label, T_K6, name + " arith" if arith else name,
                       (ARITH_SYMBOL if arith else SYMBOL)[name], lanes, smem,
                       f" (rows in {'shared memory' if shared else 'L2'})"))
    for name, label, T, key, sym, lanes, smem, rows in design:
        reg = [r for k, r in regs.items() if sym in k]
        now = (calls[name, label, B] if name == K7 else ms[name])
        old = ("" if label == "11x7" else
               f", {us[name]} us of kernel a launch, against the previous "
               f"design's {MG_OLD_MS[name]} ms ({MG_OLD_MS[name] / now}x)")
        print(f"[design] {name} {label}{rows}: {lanes} lanes and 8 producer "
              f"warps a block ({-(-B // lanes)} blocks of {lanes + 256} "
              f"threads), {smem} B of shared memory per block, {reg} "
              f"registers per thread; {per_step[key]} SASS per lane-step, "
              f"bound {bound(B * T, per_step[key], 0)[0]} ms; {now} "
              f"ms/call{old} | {card}")

    fields_bytes = 2 * 6 * 4 * B + 3 * 8
    planes_bytes = 6 * 4 * B
    acc = 25 * (8 + 4)
    work = {
        "multigrid_rollout": (B * T_K3, fields_bytes + planes_bytes
                              + len(mix) * 3 * 8),
        K6: (B * T_K6, fields_bytes + planes_bytes
             + lk.n_codes(mix) * (11 * 4 + acc)),
        K7: (B * T_K6, fields_bytes + lk.n_codes(c54) * (36 * 4 + acc)),
        K7M: (B * T_K6, fields_bytes + planes_bytes
              + lk.n_codes(mix) * (36 * 4 + acc)),
    }
    return launches, errs, ms, work


def alt_inputs(torch, ak, cfg, B, dev, seed, bad=None):
    """A Q table in [-1, 1] with near-ties (every third state's action 1
    one float32 step above action 0, a tie once double-bf16 rounded) made
    from a numpy seed (``bad`` added to every value), as the chunks'
    table, and the initial fields."""
    import numpy as np
    from gym_soccer_tpu_torch.envs.soccer_alternating_env import (
        build_alt_tables)
    nS = build_alt_tables(cfg).nS
    q = torch.tensor(np.random.default_rng(seed).uniform(-1, 1, (nS, 5)),
                     dtype=torch.float32)
    q[::3, 1] = torch.nextafter(q[::3, 0], torch.tensor(2.0))
    if bad is not None:
        q = q + bad
    return (ak.pack_alt_table(cfg, q.to(dev)),
            ak.init_alt_state_fields(cfg, B, dev))


def alt_phases(torch, dev, card, cfgs, per_step, regs):
    """Phases 27-31: the alternating-turn path and kernels K4, K10 and
    K11.  Returns their launches on the path, their max abs error against
    the plain versions, their ms per call and those of their plain
    versions, and each kernel's work at its timed shape."""
    import numpy as np
    from gym_soccer_tpu_torch.agents.learners import altq_greedy_policy
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    from gym_soccer_tpu_torch.ops import altq_codes as ac
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    from gym_soccer_tpu_torch.ops import rollout_variants
    from gym_soccer_tpu_torch.ops import rollout_codes as rc
    from gym_soccer_tpu_torch.ops import step_kernel as sk
    c54 = cfgs[(5, 4)]
    names = {True: "altq_packed_chunk", False: "altq_chunk"}
    eps = int(round(0.3 * 65536))
    tables = {b: alt.build_alt_tables(c) for b, c in cfgs.items()}

    # ---- 27. alternating path, through the entry points ----------------
    sk.reset_launch_counts()
    ak.reset_launch_counts()
    rolls = {b: sk.alt_rollout(c, 31 + b[0], B, T_K4)
             for b, c in cfgs.items()}
    train = {packed: ak.fused_altq_train(
        c54, batch=B, n_chunks=4, chunk_len=T_K10, lr=0.5, eps=0.3, seed=3,
        packed=packed, return_state=True) for packed in (True, False)}
    torch.cuda.synchronize()
    launches = {"alt_rollout": sk.launch_counts["alt_rollout"],
                **ak.launch_counts}
    print(f"[alt path] launches {launches}")
    check(launches == {"alt_rollout": 2, "altq_packed_chunk": 4,
                       "altq_chunk": 4},
          "the alternating path did not launch K4 once a board and K10 and "
          "K11 once a chunk")
    for b, (fields, stats) in rolls.items():
        cfg, tb = cfgs[b], tables[b]
        check(fields[0].device.type == "cuda",
              "alt_rollout did not default to the card")
        ra, ca, rb, cb, p, turn, t = fields
        r2d = torch.as_tensor(tb.raw_to_dense, device=dev)
        dense = r2d[alt.alt_raw_encode(torch, ra, ca, rb, cb, p, turn,
                                       cfg).long()]
        check(bool((dense > 0).all()), "a lane ended terminal/unreachable")
        check(bool(((turn == 0) | (turn == 1)).all()), "turn not 0 or 1")
        check(bool(((t >= 0) & (t < cfg.max_steps)).all()), "t out of range")
        rew, goals, truncs = ints(stats)
        check(0 < goals < B * T_K4 and abs(rew) <= goals and truncs >= 0,
              f"implausible stats {ints(stats)}")
        print(f"[alt path] alt_rollout {b[0]}x{b[1]} B={B} T={T_K4}: stats "
              f"{ints(stats)}; every lane in a reachable alternating state")
    for packed, (q, hist, res) in train.items():
        check(q.device.type == "cuda",
              "fused_altq_train did not default to the card")
        q_max = float(q.abs().max())
        check(bool(torch.isfinite(q).all()), "q is not finite")
        check(q_max <= 1.05, f"|q| = {q_max} > 1.05")
        check(sum(h[1] for h in hist) > 0, "no goals on the alternating path")
        _, acc, _ = getattr(ak, names[packed])(
            c54, 3, eps, ak.pack_alt_table(c54, q), res["fields"], B, T_K10,
            0.99, 4 * T_K10)
        check(int(ak.unpack_alt_acc(c54, acc)[1].sum()) == B * T_K10,
              "visit counts do not sum to B * T")
        print(f"[alt path] fused_altq_train 5x4 B={B} 4 chunks x {T_K10} "
              f"steps, packed={packed}: max|q| {q_max}, goals in recorded "
              f"chunks {sum(h[1] for h in hist)}; a fifth chunk counts "
              f"{B * T_K10} visits")

    errs = {"alt_rollout": 0, **{n: 0 for n in names.values()}}

    # ---- 28. K4 --------------------------------------------------------
    for b, c in cfgs.items():
        seed = 31 + b[0]
        pf, ps = sk.alt_rollout_plain(c, seed, B, T_K4, dev)
        for lanes in (None, ROLLOUT_RAGGED_LANES, 32):
            got = rolls[b] if lanes is None else sk.alt_rollout(
                c, seed, B, T_K4, dev, threads=lanes)
            e = max_abs_err([*zip(got[0], pf), (ints(got[1]), ints(ps))])
            errs["alt_rollout"] = max(errs["alt_rollout"], e)
            check(e == 0, f"K4 != plain on {b}, {lanes or 'default'} lanes "
                  f"per block: max abs err {e}")
        h = T_K4 // 2
        fa, sa = sk.alt_rollout(c, seed, B, h, dev)
        fb, sb = sk.alt_rollout(c, seed, B, T_K4 - h, dev, init_fields=fa,
                                step_offset=h)
        split = [x + y for x, y in zip(ints(sa), ints(sb))]
        check(max_abs_err([*zip(fb, pf), (split, ints(ps))]) == 0,
              f"K4 split at step {h} != one run on {b}")
        # lanes the tick table cannot start from (a player without the ball
        # in a goal column every 7th lane, turn 2 every 11th): their warps
        # walk by arithmetic
        bad = [f.clone() for f in pf]
        bad[0][::7], bad[1][::7], bad[4][::7] = c.goal_row_bounds[0], 0, 1
        bad[5][::11] = 2
        kf, ks = sk.alt_rollout(c, seed, B, 64, dev, init_fields=bad)
        qf, qs = sk.alt_rollout_plain(c, seed, B, 64, dev, init_fields=bad)
        check(max_abs_err([*zip(kf, qf), (ints(ks), ints(qs))]) == 0,
              f"K4 from unwalkable lanes != plain on {b}")
        gf, gs = sk.alt_rollout(c, 3, 1024, 64, dev)
        cf, cs = sk.alt_rollout(c, 3, 1024, 64, "cpu")
        check(max_abs_err([*zip(gf, cf), (ints(gs), ints(cs))]) == 0,
              f"K4 != CPU plain on {b}")
        print(f"[K4] {b[0]}x{b[1]} B={B} T={T_K4} "
              f"({'tick table' if rc.uses_alt_table(c) else 'arithmetic walk'}"
              f"): bit-equal to plain (max abs err {errs['alt_rollout']}) at "
              f"64 (default), {ROLLOUT_RAGGED_LANES} (ragged) and 32 lanes per "
              f"block; {h}+{T_K4 - h} split equals one run; from unwalkable "
              "lanes equal to plain; B=1024 T=64 equals the CPU plain version")

    # ---- 29. K10/K11 ---------------------------------------------------
    for b, c in cfgs.items():
        table, fields = alt_inputs(torch, ak, c, B, dev, seed=b[0])
        small = [f[:256] for f in fields]
        # lanes in goal states (A carrying the ball into the right goal, B
        # into the left), a few steps before truncation, or with turn 2:
        # their warps step by arithmetic
        odd = [f.clone() for f in fields]
        lo = c.goal_row_bounds[0]
        odd[1][5::97], odd[0][5::97], odd[4][5::97] = c.W - 1, lo, 0
        odd[2][40::131], odd[3][40::131], odd[4][40::131] = lo, 0, 1
        odd[6][::3] = c.max_steps - 3
        odd[5][7::301] = 2
        plain = {}
        for name in names.values():
            kernel, plain_fn = getattr(ak, name), getattr(ak, name + "_plain")
            want = plain_fn(c, 77, eps, table, fields, B, T_K10, 0.99, 640)
            for lanes in (None, ALTQ_RAGGED_LANES, 32):
                e = chunk_err(kernel(c, 77, eps, table, fields, B, T_K10,
                                     0.99, 640, lanes), want)
                errs[name] = max(errs[name], e)
                check(e == 0, f"{name} != plain on {b}, "
                      f"{lanes or 'default'} lanes per block: max abs err "
                      f"{e}")
            h = T_K10 // 2
            fa, (ra, ca), sa = kernel(c, 77, eps, table, fields, B, h, 0.99,
                                      640)
            fb, (rb, cb), sb = kernel(c, 77, eps, table, fa, B, T_K10 - h,
                                      0.99, 640 + h)
            check(max_abs_err([*zip(fb, want[0]), (ra + rb, want[1][0]),
                               (ca + cb, want[1][1]),
                               ([x + y for x, y in zip(ints(sa), ints(sb))],
                                ints(want[2]))]) == 0,
                  f"{name} split at step {h} != one chunk on {b}")
            check(chunk_err(kernel(c, 4, 0, table, odd, B, 24, 0.9, 21),
                            plain_fn(c, 4, 0, table, odd, B, 24, 0.9, 21))
                  == 0, f"{name} from goal-state, late and odd-turn lanes "
                  f"!= plain on {b}")
            check(int(want[2][3]) == 0, f"{name}: values out of range")
            check(chunk_err(
                kernel(c, 5, eps, table, small, 256, 16, 0.99, 9),
                kernel(c, 5, eps, table.cpu(), [f.cpu() for f in small], 256,
                       16, 0.99, 9)) == 0, f"{name} != CPU plain on {b}")
            for bad in (float("nan"), 1e7):
                tb_bad, _ = alt_inputs(torch, ak, c, 256, dev, b[0], bad)
                counts = [int(kernel(c, 5, eps, t, f, 256, 16, 0.99, 9)[2][3])
                          for t, f in ((tb_bad, small),
                                       (tb_bad.cpu(), [x.cpu() for x in small]))]
                check(counts[0] == counts[1] > 0, f"{name} counts {counts} "
                      f"values out of range with a table + {bad}")
            plain[name] = want
        (fa, (_, ca), sa), (fb, (_, cb), sb) = plain.values()
        check(max_abs_err([*zip(fa, fb), (ca, cb), (ints(sa), ints(sb))]) == 0,
              f"K10 and K11 step different trajectories on {b}")
        check(int(ca.sum()) == B * T_K10, "visit counts != B * T")
        print(f"[K10/K11] {b[0]}x{b[1]} B={B} T={T_K10} step offset 640 "
              f"({'tick table' if ac.uses_table(c) else 'arithmetic walk'}): "
              f"bit-equal to plain (fields, stats with the out-of-range "
              f"count, counts, int64 sums; max abs err {errs}) at "
              f"{ac.default_lanes(B)} (default), {ALTQ_RAGGED_LANES} (ragged) "
              f"and 32 lanes per block; {h}+{T_K10 - h} split equals one "
              "chunk; from goal-state, late and odd-turn lanes equal to "
              "plain; K10 and K11 step the same fields, stats and counts; "
              "B=256 T=16 equals the CPU plain versions, and counts the same "
              "values out of range on tables + nan and + 1e7")
    table, fields = alt_inputs(torch, ak, c54, B_GATE, dev, seed=7)
    for name in names.values():
        e = chunk_err(
            getattr(ak, name)(c54, 77, eps, table, fields, B_GATE, T_GATE,
                              0.99, 640),
            getattr(ak, name + "_plain")(c54, 77, eps, table, fields, B_GATE,
                                         T_GATE, 0.99, 640))
        errs[name] = max(errs[name], e)
        check(e == 0, f"{name} != plain at {B_GATE} x {T_GATE}: max abs err "
              f"{e}")
    print(f"[K10/K11] 5x4 B={B_GATE} T={T_GATE} (the gate's chunk, "
          f"{ac.default_lanes(B_GATE)} lanes per block, private accumulators "
          f"{ac.shared_acc(c54, ac.default_lanes(B_GATE), T_GATE)}): bit-equal "
          "to plain")

    # ---- 30. resume and the gate ---------------------------------------
    kw = dict(batch=B, chunk_len=T_K10, lr=0.5, eps=0.3, eps_halflife=64,
              lr_anneal_start=1, lr_anneal_tau=4.0, seed=9)
    for packed in (True, False):
        whole = ak.fused_altq_train(c54, n_chunks=2, return_state=True,
                                    packed=packed, **kw)
        r = ak.fused_altq_train(c54, n_chunks=1, return_state=True,
                                packed=packed, **kw)[2]
        part = ak.fused_altq_train(
            c54, n_chunks=1, return_state=True, packed=packed, init=r["q"],
            fields_init=r["fields"], start_chunk=r["next_chunk"], **kw)
        check(torch.equal(whole[0], part[0]) and all(
            torch.equal(a, b) for a, b in zip(whole[2]["fields"],
                                              part[2]["fields"])),
              f"2 chunks != 1 + 1 through the resume dict (packed={packed})")
    print("[alt resume] 2 chunks == 1 + 1 through the resume dict, bit for "
          "bit in q and fields, packed and unpacked")
    tb = tables[(5, 4)]
    t0 = time.perf_counter()
    _, v_star, _, sweeps = alt.alt_value_iteration(tb)
    t_vi = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, v_dev, _, sweeps_dev = alt.alt_value_iteration_torch(
        tb.t_prob, tb.t_next_dense, tb.t_reward, tb.t_done, tb.turn,
        theta=1e-10)
    t_vi_dev = time.perf_counter() - t0
    vi_gap = float(np.abs(v_dev.cpu().numpy() - v_star).max())
    check(vi_gap <= 1e-6, f"alt_value_iteration_torch differs by {vi_gap}")
    timing = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q, hist = ak.fused_altq_train(c54, timing=timing, **ALT_RECIPE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grouped_phase(torch, "alternating gate",
                  lambda **g: ak.fused_altq_train(c54, **ALT_RECIPE, **g),
                  (q, hist), wall, 1, ak.launch_counts, "altq_packed_chunk",
                  ALT_RECIPE["n_chunks"], card)
    q = q.cpu()
    v_l = torch.where(torch.as_tensor(tb.turn == 0), q.max(-1).values,
                      q.min(-1).values).numpy()
    v_err = float(np.abs(v_l - v_star).mean())
    pol = altq_greedy_policy(c54, q)
    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    t0 = time.perf_counter()
    w, losses, truncs = alt.alt_policy_rollout(
        c54, tb.raw_to_dense, pol.numpy(), randpol, batch=256, steps=300,
        seed=6)
    t_eval = time.perf_counter() - t0
    share = w / max(w + losses, 1)
    steps = (ALT_RECIPE["batch"] * ALT_RECIPE["chunk_len"]
             * ALT_RECIPE["n_chunks"])
    print(f"[alt gate] 5x4 recipe {ALT_RECIPE}: mean |V - V*| {v_err} (limit "
          f"{ALT_V_ERR}; V* by alt_value_iteration in {sweeps} sweeps, "
          f"{t_vi} s; alt_value_iteration_torch on the card {sweeps_dev} "
          f"sweeps, {t_vi_dev} s, max gap {vi_gap}); greedy vs frozen random "
          f"256 x 300: wins {w}, losses {losses}, truncations {truncs}, win "
          f"share {share} (limit > {ALT_WIN_SHARE}; {t_eval} s) | train wall "
          f"{wall} s for {steps} env-steps: chunk calls {timing['kernel_ms']} "
          f"ms, between chunks {timing['between_ms']} ms over "
          f"{timing['chunks']} chunks | {card}")
    check(v_err <= ALT_V_ERR, f"mean |V - V*| = {v_err} > {ALT_V_ERR}")
    check(share > ALT_WIN_SHARE, f"win share {share} <= {ALT_WIN_SHARE}")

    # ---- 31. timing ----------------------------------------------------
    ms = {}
    for b, c in cfgs.items():
        for label, fn in (("alt_rollout", sk.alt_rollout),
                          ("alt_rollout_plain", sk.alt_rollout_plain)):
            med, reps, legs = time_cuda(lambda: fn(c, 1, B, T_K4, dev),
                                        slow_legs=3)
            if b == (5, 4):
                ms[label] = med
            if label == "alt_rollout":
                now = med
            print(f"[time] {label} {b[0]}x{b[1]} B={B} T={T_K4}: {med} "
                  f"ms/call, {B * T_K4 / (med / 1e3)} env-steps/s (median of "
                  f"{len(legs)} legs x {reps} calls; legs ms/call {legs}) | "
                  f"{card}")
        us = profile_window(torch, lambda: sk.alt_rollout(c, 1, B, T_K4, dev),
                            f"alt_rollout {b[0]}x{b[1]} B={B} T={T_K4}",
                            "alt_rollout_kernel", card)
        table = rc.uses_alt_table(c)
        smem = rc.alt_smem_bytes(rc.DEFAULT_LANES,
                                 rc.build_alt_table(c).n_codes if table else 0)
        check(sk._library().gst_alt_rollout_smem_bytes(
            rc.DEFAULT_LANES, rc.build_alt_table(c).n_codes if table else 0)
            == smem, "K4's shared memory differs from alt_smem_bytes")
        key = "alt_rollout" + ("" if table else " arith")
        sym = (SYMBOL if table else ARITH_SYMBOL)["alt_rollout"]
        reg = [r for k, r in regs.items() if sym in k]
        print(f"[design] alt_rollout {b[0]}x{b[1]} "
              f"({'tick table' if table else 'arithmetic walk'}): "
              f"{rc.DEFAULT_LANES} lanes and {rc.PRODUCER_WARPS} producer "
              f"warps a block ({-(-B // rc.DEFAULT_LANES)} blocks of "
              f"{rc.DEFAULT_LANES + 32 * rc.PRODUCER_WARPS} threads), {smem} B "
              f"of shared memory per block, {reg} registers per thread; "
              f"{per_step[key]} SASS per lane-step, bound "
              f"{bound(B * T_K4, per_step[key], 0)[0]} ms; {now} ms/call, "
              f"{us} us of kernel a launch, against the previous design's "
              f"{ALT_OLD_MS[b]} ms ({ALT_OLD_MS[b] / now}x) | {card}")
        table, fields = alt_inputs(torch, ak, c, B, dev, seed=5)
        call = {}
        for name in (*names.values(), *(n + "_plain" for n in names.values())):
            fn = getattr(ak, name)
            med, reps, legs = time_cuda(
                lambda: fn(c, 77, eps, table, fields, B, T_K10, 0.99, 640))
            call[name] = med
            if b == (5, 4):
                ms[name] = med
            print(f"[time] {name} {b[0]}x{b[1]} B={B} T={T_K10}: {med} "
                  f"ms/call, {B * T_K10 / (med / 1e3)} learner env-steps/s "
                  f"(median of {len(legs)} legs x {reps} calls; legs ms/call "
                  f"{legs}) | {card}")
        lanes, n = ac.default_lanes(B), ak.n_codes(c)
        table_walk = ac.uses_table(c)
        acc = ac.shared_acc(c, lanes, T_K10)
        smem = ac.block_smem_bytes(c, lanes, T_K10)
        where = (ctypes.c_int32 * 1)()
        check(ak._library().gst_altq_smem_bytes(
            lanes, n, int(table_walk), T_K10, ctypes.addressof(where)) == smem
            and where[0] == (ac.shared_rows(c) | table_walk << 1 | acc << 2),
            "K10/K11's shared memory or placement differs from altq_codes'")
        offsets = (ctypes.c_longlong * 7)()
        ak._library().gst_altq_layout(n, B, ctypes.addressof(offsets))
        check(tuple(offsets) == tuple(ac.layout(n, B)),
              "K10/K11's layout differs from altq_codes.layout")
        for name in names.values():
            fn = getattr(ak, name)
            device = rollout_variants._device_ms(
                lambda: fn(c, 77, eps, table, fields, B, T_K10, 0.99, 640))
            key = name if table_walk else name + " arith"
            sym = (SYMBOL if table_walk else ARITH_SYMBOL)[name]
            reg = [r for k, r in regs.items() if sym in k]
            old = ALTQ_OLD_DEVICE_MS[name, b]
            print(f"[design] {name} {b[0]}x{b[1]} B={B} T={T_K10} "
                  f"({'tick table' if table_walk else 'arithmetic walk'}, "
                  f"rows in {'shared memory' if ac.shared_rows(c) else 'L2'}, "
                  f"accumulators in "
                  f"{'shared memory' if acc else 'device memory'}): {lanes} "
                  f"lanes and {ac.PRODUCER_WARPS} producer warps a block "
                  f"({-(-B // lanes)} blocks of "
                  f"{lanes + 32 * ac.PRODUCER_WARPS} threads), {smem} B of "
                  f"shared memory per block, {reg} registers per thread; "
                  f"{per_step[key]} SASS per lane-step, bound "
                  f"{bound(B * T_K10, per_step[key], 0)[0]} ms; "
                  f"{call[name]} ms/call, {device} ms of device time (CUDA "
                  f"graph replay: memset, prep pass, kernel) against the "
                  f"previous design's {old} ({old / device}x) | {card}")
    table, fields = alt_inputs(torch, ak, c54, B, dev, seed=5)
    profile_window(torch, lambda: ak.altq_packed_chunk(
        c54, 77, eps, table, fields, B, T_K10, 0.99, 640),
        f"altq_packed_chunk 5x4 B={B} T={T_K10}", "altq_chunk_kernel<true",
        card)

    alt_fields_bytes = 2 * 7 * 4 * B + 3 * 8
    acc = ak.n_codes(c54) * (10 * 4 + 10 * (8 + 4)) + 8
    alt_table = rc.build_alt_table(c54)
    work = {"alt_rollout": (B * T_K4, alt_fields_bytes + alt_table.table.nbytes
                            + rc.raw_bytes(alt_table.n_codes)),
            "altq_packed_chunk": (B * T_K10, alt_fields_bytes + acc),
            "altq_chunk": (B * T_K10, alt_fields_bytes + acc)}
    return launches, errs, ms, work


def threefry_phases(torch, dev, card, instructions, step_counts):
    """Phases 39-46, the threefry slice, each with its wall seconds.
    Returns the launches of T1, its keyed entry, S1 and A1 on the slice's
    main path (and of S2 and S3 on phase 42's checks), the max abs errors of T1, its keyed entry and S1 against
    their plain versions, their ms and plain ms, and their work, each a
    dict by kernel name, and the entry point's exploitability;
    ``instructions`` is ``added_instructions``."""
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    launches, entry_exploitability = entry_main_path(torch, dev, card)
    print(f"[phase 39] {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    err, ms, work = t1_phase(torch, dev, card, instructions[T1])
    errs, work = {T1: err}, {T1: work}
    print(f"[phase 40] {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    engine_phase(torch, dev, card)
    print(f"[phase 41] {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    launches.update(learning_checks(torch, dev, card))
    print(f"[phase 42] {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    entry_cli_phase(torch, dev, card)
    print(f"[phase 43] {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    vector_env_phase(torch, dev, card)
    print(f"[phase 44] {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    graph_phase(torch, dev, card)
    print(f"[phase 45] {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    errs[S1], s1_ms, work[S1] = s1_phase(torch, dev, card, instructions[S1],
                                         ms[T1 + "_device"], step_counts)
    ms.update(s1_ms)
    errs[T1_KEYED], keyed_ms, work[T1_KEYED] = keyed_phase(
        torch, dev, card, instructions[T1_KEYED])
    ms.update(keyed_ms)
    print(f"[phase 46] {time.perf_counter() - t0} s")
    print(f"[threefry] phases 39-46 ran {time.perf_counter() - t_all} s")
    return launches, errs, ms, work, entry_exploitability


def scatter_inputs(np, case: str, seed: int = 0):
    """(idx int64 [lanes], values float32 [lanes], n_cells) of A1's input
    ``case`` (``SCATTER_CASES`` or ``SCATTER_CHECKED``), from ``seed``
    (``ops/scatter_variants.case_inputs``)."""
    from gym_soccer_tpu_torch.ops import scatter_variants
    return scatter_variants.case_inputs(np, case, seed)


def json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def entry_main_path(torch, dev, card):
    """Phase 39, the slice's main path: the entry point's default mode
    (``train_minimax.main``, the HBM-table minimax-Q learner, then
    ``eval_episode_stats``) at 8192 envs in this process, S1's, T1's,
    A1's and R1's launch counters reset just before and read just after:
    T1's per-lane entry launched ENTRY_T1 times, its keyed entry
    ENTRY_T1_KEYED, S1 ENTRY_S1, A1 ENTRY_A1, R1 ENTRY_R1; its lines are
    the JAX example's, v in [-1.05, 1.05], the exploitability finite, the
    eval's episodes counted.  Returns the launches of T1, its keyed entry,
    S1 and A1 by kernel name, and the finished line's exploitability."""
    import contextlib
    import io
    from gym_soccer_tpu_torch.agents import learners
    from gym_soccer_tpu_torch.examples import train_minimax
    from gym_soccer_tpu_torch.ops import engine_kernel as ek
    from gym_soccer_tpu_torch.ops import scatter_kernel as sc
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    out = io.StringIO()
    tk.reset_launch_counts()
    ek.reset_launch_counts()
    sc.reset_launch_counts()
    learners.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train_minimax.main(ENTRY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t1, keyed = tk.launch_counts[T1], tk.launch_counts[T1_KEYED]
    s1, r1 = ek.launch_counts[S1], learners.launch_counts[RMPLUS]
    a1 = sc.launch_counts[SCATTER]
    check((t1, keyed, s1, a1, r1) == (ENTRY_T1, ENTRY_T1_KEYED, ENTRY_S1,
                                      ENTRY_A1, ENTRY_R1),
          f"entry point: T1 launched {t1} + {keyed} (keyed) times, S1 {s1}, "
          f"A1 {a1}, R1 {r1}; not {ENTRY_T1} ({ENTRY_T1_KEYED} keyed), "
          f"{ENTRY_S1}, {ENTRY_A1}, {ENTRY_R1}")
    lines = json_lines(out.getvalue())
    events = [ln.get("event") for ln in lines]
    check(events == ["compiled", None, None, None, "finished",
                     "eval_episode_stats"], f"entry point lines {events}")
    fin, ev = lines[4], lines[5]
    check(fin["steps"] == 2000 and -1.05 <= fin["v_min"] <= fin["v_max"]
          <= 1.05 and math.isfinite(fin["exploitability"])
          and ev["episodes"] > 0, f"entry point: {fin} {ev}")
    print(f"[main path] python -m gym_soccer_tpu_torch.examples."
          f"train_minimax {' '.join(ENTRY)} (default mode) in this process: "
          f"{wall} s (host clock; the first chunk {lines[0]['seconds']} s "
          f"with the kernels' loads); T1 launched {t1} times, its keyed "
          f"entry {keyed}, S1 {s1}, A1 {a1}, R1 {r1}; finished {fin}; "
          f"eval_episode_stats {ev} | {card}")
    return {T1: t1, T1_KEYED: keyed, S1: s1, SCATTER: a1}, \
        fin["exploitability"]


def t1_phase(torch, dev, card, t1_instructions):
    """Phase 40: T1 against its plain version on the card bit for bit at
    8192 lanes with count 1, 2 and 4, salt 0, 1 and 9 and counters 0, 37
    and 2**31 - 1 (random key words), and the generic count 7; one shape
    against the plain version on the CPU; T1 and the plain version timed
    at T1_SHAPES (the learner's action draw, 8192 x 2 salt 1, which gives
    T1's ms and bound, and the inits' reset draw, 8192 x 1); T1's device
    time by the replay of a CUDA graph of 100 calls at both shapes and at
    1 lane (the floor of a launch, whatever its lanes do)."""
    import numpy as np
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    rng = np.random.default_rng(16)
    key = torch.as_tensor(rng.integers(0, 2 ** 32, (B, 2), dtype=np.uint64)
                          .astype(np.int64), device=dev)
    err, cases = 0.0, 0
    for n0 in (0, 37, 2 ** 31 - 1):
        n = torch.full((B,), n0, dtype=torch.int32, device=dev)
        n[::3] = torch.as_tensor(rng.integers(0, 2 ** 31, B)[::3]
                                 .astype(np.int32), device=dev)
        for count in (1, 2, 4, 7):
            for salt in (0, 1, 9):
                got = tk.threefry_uniforms(key, n, count, salt)
                want = tk.threefry_uniforms_plain(key, n, count, salt)
                check(got.shape == (B, count) and torch.equal(got, want),
                      f"T1 != plain at count {count}, salt {salt}, n {n0}")
                err = max(err, float((got - want).abs().max()))
                cases += 1
    cpu = tk.threefry_uniforms_plain(key.cpu(), n.cpu(), 4, 9)
    check(torch.equal(tk.threefry_uniforms(key, n, 4, 9).cpu(), cpu),
          "T1 != the plain version on the CPU")
    ms = {}
    for count, salt in T1_SHAPES:
        n = torch.arange(B, dtype=torch.int32, device=dev)
        for name, fn in ((T1, tk.threefry_uniforms),
                         (T1 + "_plain", tk.threefry_uniforms_plain)):
            med, reps, legs = time_cuda(lambda: fn(key, n, count, salt))
            ms.setdefault(name, med)
            print(f"[time] {name} {B} x {count} (salt {salt}): {med} "
                  f"ms/call (median of {len(legs)} legs x {reps} calls) "
                  f"| {card}")
    count = T1_SHAPES[0][0]
    nbytes = B * (2 * 8 + 4) + B * count * 4
    bound_ms, bound_by = bound(B, t1_instructions, nbytes)
    # device time: a CUDA graph of 100 calls, replayed (the call is bound
    # by the host's launch); at 1 lane, what a launch costs the device
    device_ms = {}
    for lanes in (B, 1):
        for c, salt in T1_SHAPES:
            k, n = key[:lanes], torch.arange(lanes, dtype=torch.int32,
                                             device=dev)
            tk.threefry_uniforms(k, n, c, salt)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(100):
                    tk.threefry_uniforms(k, n, c, salt)
            device_ms[lanes, c] = time_cuda(graph.replay)[0] / 100
    lib = tk._library()
    print(f"[T1] bit-equal to the plain version in {cases} cases (max abs "
          f"err {err}) and to the CPU's; {lib.gst_threefry_block()} lanes a "
          f"block, {t1_instructions} SASS instructions a lane at "
          f"{B} x {count} (salt {T1_SHAPES[0][1]}), bound {bound_ms} ms "
          f"({bound_by}); {ms[T1]} ms a "
          f"call, {device_ms[B, count]} ms of device time (CUDA-graph "
          f"replay), against the plain version's {ms[T1 + '_plain']} ms "
          f"({ms[T1 + '_plain'] / ms[T1]}x) | {card}")
    print(f"[T1] device ms a call by the replay of 100 calls (lanes, "
          f"count): {device_ms}; 1 lane, a launch's floor, is "
          f"{device_ms[1, count] / device_ms[B, count] * 100} % of "
          f"{B} x {count} | {card}")
    ms[T1 + "_device"] = device_ms[B, count]
    return err, ms, (B, nbytes)


def engine_phase(torch, dev, card):
    """Phase 41: the threefry engine: ``batch.init`` then 64 steps of
    ``rollout`` with ``random_policy_fn`` at 8192 lanes on 5x4 and 11x7,
    every StepOut field and the final state equal to the same call on the
    CPU bit for bit."""
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, threefry
    for w, h in BOARDS:
        cfg = EnvConfig(width=w, height=h, slip_prob=SLIP)
        runs = []
        for d in (dev, torch.device("cpu")):
            st = batch.init(cfg, threefry.key(5), B, d)
            pol = batch.random_policy_fn(cfg, threefry.key(6), B)
            runs.append(batch.rollout(cfg, st, pol, 64))
        (gend, gout), (cend, cout) = runs
        check(all(torch.equal(a.cpu(), b) for a, b in
                  zip((*gend, *gout), (*cend, *cout))),
              f"threefry engine differs CUDA vs CPU on {w}x{h}")
        print(f"[engine] threefry {w}x{h} B={B} x 64 steps (init, "
              f"random_policy_fn, rollout): CUDA == CPU in every field; "
              f"goals {int(gout.done.sum())}, truncations "
              f"{int(gout.truncated.sum())}")


def learning_checks(torch, dev, card, only=None):
    """Phase 42: the JAX package's learning checks on the card at their
    own sizes and thresholds (``only``: the labels of those to run, all by
    default), each with its wall seconds:
    tests/test_learners.py:48 (IQL self-play: goals > truncations), :73
    (minimax-Q: |v| <= 1 + 1e-3, max |v| > 0.05, pi rows sum to 1), :87
    (IQL against a frozen random B: B untouched, win share > 0.9), :130
    (turn-based Q: mean |V - V*| < 0.08, > 95 % wins against random through
    the threefry alt_policy_rollout), :159 (against a frozen standing B),
    and tests/test_multigrid.py:206 (mixture slices match); each trains
    ``learners.GROUP_STEPS`` steps a CUDA-graph replay (single steps are
    host-bound).  S2's and S3's counters are reset before each check and
    read after it: the mixture check launches S2 MIX_CHECK_S2 times, the
    turn-based ones S3 ALTQ_CHECK_S3 and ALTQ_FROZEN_S3 times (every
    other check neither).  Returns {S2: the mixture check's launches, S3:
    the turn-based Q check's}, of the checks that ran: their main
    paths."""
    import numpy as np
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, threefry
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk
    from gym_soccer_tpu_torch.utils.policies import get_random_policy_array
    cfg = EnvConfig(5, 4, 0.2)
    key = threefry.key
    launched = {}

    def timed(label, fn, want=None):
        if only is not None and label not in only:
            return
        torch.cuda.synchronize()
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        msg = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(mk.launch_counts)
        check(got == {S2: 0, S3: 0, **(want or {})},
              f"{label}: S2 and S3 launched {got}, not {want or 0}")
        launched.update({k: n for k, n in got.items() if n})
        print(f"[learning] {label}: {msg}; {wall} s; S2 and S3 launches "
              f"{got} | {card}")

    def greedy_rollout(pol, seed, lanes, steps):
        st = batch.init(cfg, key(seed), lanes, dev)
        return batch.rollout(cfg, st, lambda obs, i: pol(obs.long()),
                             steps)[1]

    def iql():
        st = L.iql_init(cfg, key(0), 512, dev)
        st, _ = L.iql_train(cfg, L.IQLConfig(lr=0.5, eps=0.25), st, 6000)
        qmax = float(st.q_a.abs().max())
        check(qmax > 0.3, f"IQL: Q never moved ({qmax})")
        out = greedy_rollout(lambda o: (st.q_a[o].argmax(-1),
                                        st.q_b[o].argmax(-1)), 3, 512, 200)
        goals, truncs = int(out.done.sum()), int(out.truncated.sum())
        check(goals > truncs, f"IQL: {goals} goals vs {truncs} truncations")
        return (f"test_learners.py:48 IQL 512 x 6000: max |Q_a| {qmax}, "
                f"greedy self-play {goals} goals > {truncs} truncations")

    def minimax():
        st = L.minimax_init(cfg, key(0), 512, dev)
        st, _ = L.minimax_train(cfg, L.MinimaxQConfig(lr=0.2,
                                                      resolve_every=16),
                                st, 2000)
        v, pi = st.v.abs(), st.pi_a
        check(float(v.max()) <= 1.0 + 1e-3 and float(v.max()) > 0.05
              and bool(((pi.sum(-1) - 1).abs() <= 1e-3).all())
              and bool((pi >= -1e-6).all()),
              f"minimax-Q: max |v| {float(v.max())}")
        return (f"test_learners.py:73 minimax-Q 512 x 2000: max |v| "
                f"{float(v.max())}, pi rows sum to 1")

    def iql_frozen():
        frozen_b = get_random_policy_array(761, 5, seed=42)
        st = L.iql_init(cfg, key(0), 512, dev)
        st, _ = L.iql_train(cfg, L.IQLConfig(lr=0.5, eps=0.25), st, 8000,
                            frozen_b=frozen_b)
        check(float(st.q_b.abs().max()) == 0.0, "frozen side learned")
        fb = torch.as_tensor(frozen_b, device=dev).long()
        out = greedy_rollout(lambda o: (st.q_a[o].argmax(-1), fb[o]), 9,
                             512, 300)
        wins = int(((out.reward_a > 0) & out.done).sum())
        share = wins / int((out.done | out.truncated).sum())
        check(share > 0.9, f"IQL vs frozen B: win share {share}")
        return (f"test_learners.py:87 IQL vs frozen random B 512 x 8000: "
                f"q_b untouched, win share {share} > 0.9")

    def altq(frozen):
        tb = alt.build_alt_tables(cfg)
        stand = np.zeros(tb.nS, dtype=np.int32)
        kw = {} if frozen is None else {"frozen_b": stand}
        n = 15000 if frozen is None else 12000
        st = L.altq_init(cfg, key(0 if frozen is None else 1), 256, dev)
        for lr, eps in ((0.25, 0.3), (0.08, 0.15)):
            st, _ = L.altq_train(cfg, L.AltQConfig(lr=lr, gamma=0.99,
                                                   eps=eps), st, n,
                                 **kw)
        q = st.q.cpu().numpy()
        turn = tb.turn
        pol = L.altq_greedy_policy(cfg, st.q).cpu().numpy()
        if frozen is None:
            V_star = alt.alt_value_iteration(tb)[1]
            err = float(np.abs(np.where(turn == 0, q.max(-1), q.min(-1))
                               - V_star).mean())
            opp, seed = np.random.RandomState(0).randint(
                0, 5, tb.nS).astype(np.int32), 6
        else:
            V_br = alt.alt_value_iteration(tb, frozen_b=stand)[1]
            b_rows = turn == 1
            b_rows[0] = False
            check((q[b_rows][:, 1:] == 0.0).all()
                  and (q[b_rows][:, 0] != 0.0).any(),
                  "turn-based Q: frozen B rows")
            visited = (q != 0.0).any(-1)
            visited[0] = False
            check(visited.sum() > 50, "turn-based Q: too few states visited")
            V_l = np.where(turn == 0, q.max(-1), q[np.arange(tb.nS), stand])
            err = float(np.abs(V_l - V_br)[visited].mean())
            opp, seed = stand, 3
        w, lo, tr = alt.alt_policy_rollout(cfg, tb.raw_to_dense, pol, opp,
                                           batch=128, steps=300, seed=seed,
                                           device=dev)
        check(err < 0.08 and w > 0 and w / max(w + lo, 1) > 0.95,
              f"turn-based Q ({frozen}): err {err}, wins {w}, losses {lo}")
        return (f"test_learners.py:{130 if frozen is None else 159} "
                f"turn-based Q 256 x {2 * n}"
                f"{'' if frozen is None else ' vs frozen standing B'}: mean "
                f"|V - V*| {err} < 0.08, alt_policy_rollout (threefry) wins "
                f"{w}, losses {lo}, truncations {tr}: share "
                f"{w / max(w + lo, 1)} > 0.95")

    def mixture():
        mcfg = L.MinimaxQConfig(resolve_every=32, solver_iters=50)
        nS = 761

        def corr(a, b):
            m = (np.abs(a) > 0) & (np.abs(b) > 0)
            return np.corrcoef(a[m], b[m])[0, 1]

        cfgs = (cfg, cfg)
        st = L.multigrid_minimax_init(cfgs, key(7), 512, dev)
        st, _ = L.multigrid_minimax_train(cfgs, mcfg, st, 2000)
        q, v = st.q.cpu().numpy(), st.v.cpu().numpy()
        ca, cv = corr(q[:nS], q[nS:]), np.corrcoef(v[:nS], v[nS:])[0, 1]
        cfgs2 = (cfg, EnvConfig(6, 4, 0.1))
        st2 = L.multigrid_minimax_init(cfgs2, key(8), 512, dev)
        st2, _ = L.multigrid_minimax_train(cfgs2, mcfg, st2, 2000)
        sg = L.minimax_init(cfg, key(9), 256, dev)
        sg, _ = L.minimax_train(cfg, mcfg, sg, 2000)
        cb = corr(st2.q.cpu().numpy()[:nS], sg.q.cpu().numpy())
        cvb = np.corrcoef(st2.v.cpu().numpy()[:nS], sg.v.cpu().numpy())[0, 1]
        check(ca > 0.75 and cv > 0.9 and cb > 0.75 and cvb > 0.9,
              f"mixture slices: {ca} {cv} {cb} {cvb}")
        return (f"test_multigrid.py:206 mixture slices: same-variant q corr "
                f"{ca} > 0.75, v corr {cv} > 0.9; 5x4 in 5x4+6x4 against "
                f"one board: q corr {cb} > 0.75, v corr {cvb} > 0.9")

    timed("IQL self-play", iql)
    timed("minimax-Q", minimax)
    timed("IQL vs frozen", iql_frozen)
    timed("turn-based Q vs frozen", lambda: altq("b"), {S3: ALTQ_FROZEN_S3})
    timed("turn-based Q", lambda: altq(None), {S3: ALTQ_CHECK_S3})
    timed("mixture minimax-Q", mixture, {S2: MIX_CHECK_S2})
    return launched


def entry_cli_phase(torch, dev, card):
    """Phase 43: the entry point through ``python -m``: the default mode
    at full width (its finished line's exploitability and its
    eval_episode_stats printed); ``--fused --steps 1280`` stopped at 640
    and resumed from ``--ckpt``, bit-identical in q, v, pi, n and the
    fields to one uninterrupted ``fused_minimax_train`` with the first
    segment's anneal anchor; ``--best-response player_a``."""
    import tempfile
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.utils import checkpoint
    root = os.path.dirname(os.path.abspath(__file__))

    def run(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gym_soccer_tpu_torch.examples."
             "train_minimax", *args], cwd=root, capture_output=True,
            text=True, timeout=600)
        check(proc.returncode == 0, f"train_minimax {args} exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        lines = json_lines(proc.stdout)
        print(f"[entry cli] train_minimax {' '.join(args)}: "
              f"{time.perf_counter() - t0} s (host clock, a fresh process)")
        return lines

    lines = run(*ENTRY)
    fin = [ln for ln in lines if ln.get("event") == "finished"]
    ev = [ln for ln in lines if ln.get("event") == "eval_episode_stats"]
    check(len(fin) == 1 and len(ev) == 1, "default mode: no finished line")
    print(f"[entry cli] default mode: exploitability "
          f"{fin[0]['exploitability']}, {fin[0]['env_steps_per_s']} "
          f"env-steps/s; eval_episode_stats {ev[0]} | {card}")
    build = os.path.join(root, "build", "gym_soccer_tpu_torch")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ckpt = os.path.join(tmp, "fused.npz")
        for steps in FUSED_STEPS:
            lines = run("--fused", "--steps", str(steps), "--ckpt", ckpt)
        events = [ln.get("event") for ln in lines]
        check(events[:2] == ["resumed_fused", "checkpointed"],
              f"--fused resume: {events}")
        cfg = EnvConfig(5, 4, SLIP)
        n1 = FUSED_STEPS[0] // 64
        *_, res = lk.fused_minimax_train(
            cfg, batch=8192, n_chunks=FUSED_STEPS[1] // 64, chunk_len=64,
            lr=1.0, eps=0.2, lr_anneal_start=n1 // 2, lr_anneal_tau=25.0,
            lr_anneal_pow=1.5, final_solver_iters=2000, return_state=True,
            device=dev)
        saved = checkpoint.load_pytree(ckpt, dict(res, lr_anneal_start=0))
        same = all(torch.equal(saved[k], res[k])
                   for k in ("q", "v", "pi_a", "pi_b", "n")) and all(
            torch.equal(a, b) for a, b in zip(saved["fields"],
                                              res["fields"]))
        check(same and saved["next_chunk"] == res["next_chunk"],
              "--fused resumed from --ckpt differs from one run")
    fin = [ln for ln in lines if ln.get("event") == "finished_fused"][0]
    print(f"[entry cli] --fused {FUSED_STEPS[0]} + resume to "
          f"{FUSED_STEPS[1]} from --ckpt: bit-identical to one run of "
          f"{FUSED_STEPS[1] // 64} chunks (q, v, pi, n, fields); "
          f"exploitability {fin['exploitability']} | {card}")
    lines = run("--best-response", "player_a")
    br = [ln for ln in lines if ln.get("event") == "finished_best_response"]
    ev = [ln for ln in lines if ln.get("event") == "eval_episode_stats"]
    check(len(br) == 1 and len(ev) == 1
          and math.isfinite(br[0]["mean_gap_to_exact_br"])
          and ev[0]["episodes"] > 0, f"--best-response: {lines}")
    print(f"[entry cli] --best-response player_a: {br[0]}; "
          f"eval_episode_stats {ev[0]} | {card}")


def vector_env_phase(torch, dev, card):
    """Phase 44: ``SoccerVectorEnv`` at 8192 envs for 1000 random-action
    steps on the card and on the CPU from the same seed (slip 0.2, with a
    reseed at step 500): every observation, reward, flag and info equal."""
    import numpy as np
    from gym_soccer_tpu_torch.envs import SoccerVectorEnv
    envs = [SoccerVectorEnv(B, slip_prob=SLIP, seed=3, device=d)
            for d in (dev, "cpu")]
    rng = np.random.RandomState(0)
    walls = [0.0, 0.0]

    def same(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return a.dtype == b.dtype and np.array_equal(a, b)

    ended = 0
    for k in range(1000):
        if k % 500 == 0:
            outs = [e.reset(seed=None if k == 0 else 17) for e in envs]
            check(same(*outs), f"vector env reset {k} differs")
        acts = {a: rng.randint(0, 5, B) for a in envs[0].agents}
        outs = []
        for i, e in enumerate(envs):
            t0 = time.perf_counter()
            outs.append(e.step(acts))
            walls[i] += time.perf_counter() - t0
        check(same(*outs), f"vector env step {k} differs CUDA vs CPU")
        ended += int(outs[0][2]["player_a"].sum())
    stats = envs[0].episode_stats
    print(f"[vector env] SoccerVectorEnv {B} envs x 1000 steps: CUDA == CPU "
          f"in every return value; {ended} goals; episode stats since the "
          f"reseed {[float(x) for x in stats]}; step wall {walls[0]} s on "
          f"the card, {walls[1]} s on the CPU (host clock) | {card}")


def graph_phase(torch, dev, card):
    """Phase 45: the HBM-table learners' grouped path on the card (steps as
    CUDA-graph replays, each step's lr and eps read from the schedule
    table at the device's step counter, the carry written back, the
    re-solve on each period's last step) against the same call on the CPU,
    both from one state.  At GRAPH_LANES lanes, from the state after
    GRAPH_START steps, GRAPH_STEPS steps of minimax-Q (lr and eps
    halflives), IQL, turn-based Q against a frozen standing B and mixture
    minimax-Q on 5x4+6x5: every leaf and every step's |TD| bit-equal, T1,
    the engine's step (S1, S2 or S3: one a step) and A1 launched a single
    step's count each step and R1 once a period.  At GRAPH_WIDE lanes, one 64-step minimax-Q period from step 0
    (one replay, the re-solve on its last step): every state leaf (q, v,
    pi, n and the env fields) bit-equal to the CPU's, each step's |TD|
    within GRAPH_TOL * (1 + |TD|) (its mean reduces in another order)."""
    import numpy as np
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    from gym_soccer_tpu_torch.ops import engine_kernel as ek
    from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk
    from gym_soccer_tpu_torch.ops import scatter_kernel as sc
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    cfg = EnvConfig(5, 4, SLIP)
    mix = (cfg, EnvConfig(6, 5, SLIP))
    cpu, key = torch.device("cpu"), threefry.key

    def to(state, d):
        return L._rebuild(state, [t.to(d) for t in L._tensors(state)])

    def reset():
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        ek.reset_launch_counts()
        mk.reset_launch_counts()
        sc.reset_launch_counts()
        L.reset_launch_counts()

    def engines():   # S1's, S2's and S3's launches
        return ek.launch_counts[S1] + mk.launch_counts[S2] + \
            mk.launch_counts[S3]

    mc = L.MinimaxQConfig(lr=0.3, resolve_every=16, solver_iters=50,
                          lr_halflife=40, eps_halflife=30, eps_min=0.05)
    ic, ac = L.IQLConfig(lr=0.5, eps=0.25), L.AltQConfig()
    stand = np.zeros(alt.build_alt_tables(cfg).nS, np.int32)
    runs = {
        "minimax-Q": (L.minimax_init(cfg, key(0), GRAPH_LANES, cpu),
                      lambda s, n: L.minimax_train(cfg, mc, s, n), 16),
        "IQL": (L.iql_init(cfg, key(1), GRAPH_LANES, cpu),
                lambda s, n: L.iql_train(cfg, ic, s, n), 0),
        "turn-based Q vs frozen B": (
            L.altq_init(cfg, key(2), GRAPH_LANES, cpu),
            lambda s, n: L.altq_train(cfg, ac, s, n, frozen_b=stand), 0),
        "mixture minimax-Q 5x4+6x5": (
            L.multigrid_minimax_init(mix, key(3), GRAPH_LANES, cpu),
            lambda s, n: L.multigrid_minimax_train(mix, mc, s, n), 16),
    }
    steps = range(GRAPH_START, GRAPH_START + GRAPH_STEPS)
    for name, (st, train, period) in runs.items():
        st, _ = train(st, GRAPH_START)
        reset()
        train(to(st, dev), 1)
        torch.cuda.synchronize()
        per_step, s1_step = tk.launch_counts[T1], engines()
        a1_step = sc.launch_counts[SCATTER]
        reset()
        t0 = time.perf_counter()
        got, gtd = train(to(st, dev), GRAPH_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1, r1 = tk.launch_counts[T1], L.launch_counts[RMPLUS]
        s1, a1 = engines(), sc.launch_counts[SCATTER]
        want, wtd = train(st, GRAPH_STEPS)
        leaves = list(zip(L._tensors(got), L._tensors(want)))
        bad = [i for i, (x, y) in enumerate(leaves)
               if not torch.equal(x.cpu(), y)]
        resolves = sum(1 for s in steps if period and s % period == period - 1)
        check(not bad and torch.equal(gtd.cpu(), wtd),
              f"{name}: the graph run differs from the CPU's in leaves {bad} "
              f"(max abs err {max_abs_err(leaves)}) or in |TD|")
        check(per_step > 0 and a1_step > 0 and s1_step == 1
              and t1 == per_step * GRAPH_STEPS
              and s1 == s1_step * GRAPH_STEPS
              and a1 == a1_step * GRAPH_STEPS and r1 == resolves,
              f"{name}: T1 launched {t1} times (not {per_step} x "
              f"{GRAPH_STEPS}), S1, S2 or S3 {s1} (not {s1_step} x "
              f"{GRAPH_STEPS}), "
              f"A1 {a1} (not {a1_step} x {GRAPH_STEPS}), R1 {r1} (not "
              f"{resolves})")
        group = -(-L.GROUP_STEPS // max(period, 1)) * max(period, 1)
        print(f"[graph] {name} {GRAPH_LANES} lanes, steps {steps.start}-"
              f"{steps.stop - 1} (replays of {group} steps, with the steps "
              f"around them on their own): all {len(leaves)} leaves "
              f"and every step's |TD| equal the CPU's bit for bit; T1 "
              f"{t1} launches, the engine's step (S1, S2 or S3) {s1}, A1 "
              f"{a1}, R1 {r1}; {wall} s on the card | {card}")

    wide = L.MinimaxQConfig(lr=0.3, resolve_every=64, solver_iters=200,
                            lr_halflife=400, eps_halflife=667)
    st = L.minimax_init(cfg, key(4), GRAPH_WIDE, cpu)
    got, gtd = L.minimax_train(cfg, wide, to(st, dev), 64)
    want, wtd = L.minimax_train(cfg, wide, st, 64)

    names = ("q", "v", "pi_a", "pi_b", "n", "env", "step")
    bad = [f"{n}[{i}]" for n in names
           for i, (x, y) in enumerate(zip(L._tensors((getattr(got, n),)),
                                          L._tensors((getattr(want, n),))))
           if not bits_equal(x.cpu(), y)]
    etd = float(((gtd.cpu() - wtd).abs() / (1 + wtd.abs())).max())
    print(f"[graph] minimax-Q {GRAPH_WIDE} lanes, one 64-step period (one "
          f"replay, the re-solve on step 63): q, v, pi, n and the env "
          f"fields bit-equal to the CPU's: {not bad} (differing: {bad}); "
          f"max |d|TD|| / (1 + |TD|) {etd} (limit {GRAPH_TOL}); q changed "
          f"in {int((want.q != 0).sum())} cells | {card}")
    check(not bad and etd <= GRAPH_TOL and int(got.step) == 64,
          f"minimax-Q {GRAPH_WIDE} lanes: the graph run differs from the "
          f"CPU's in {bad} or its |TD| beyond {GRAPH_TOL}")


def device_ops(torch, fn, calls=3):
    """Device operations (kernels, copies, memsets) a call of ``fn(i)``
    under ``torch.profiler`` over calls i = 1 .. ``calls``, after the
    warm-up call fn(0)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i + 1)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def step_kernel_counts(torch, dev, card):
    """Phase 46's launch counts, taken early in the process (where the
    profiler records every launch): device operations a call of the
    engine's step at 8192 lanes (5x4 slip 0.2, threefry, autoreset) as
    ``step_plain`` (the previous design: ~350 ops and two T1 draws) and as
    ``batch.step`` (S1); of an eager minimax learner step at the entry
    point's 8192 lanes and lr/eps (no re-solve) on ``step_plain`` and on
    S1; of ``eval_episode_stats``' policy draw at 2 x 1024, plain and
    keyed; and of A1's call on ``SCATTER_TIMED``.  S1's step and the keyed
    draw must be one operation each, A1's call SCATTER_DEVICE_OPS."""
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, threefry
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    cfg = EnvConfig(5, 4, SLIP)
    st = batch.init(cfg, threefry.key(3), B, dev)
    acts = torch.randint(0, 5, (2, B), device=dev)
    lcfg = L.MinimaxQConfig(lr=0.3, eps=0.3, resolve_every=64,
                            solver_iters=200, lr_halflife=400,
                            eps_halflife=666)
    lst = L.minimax_init(cfg, threefry.key(0), B, dev)
    eng = L._batch_engine(cfg)

    def plain_step(env, aa, ab):
        env2, out = batch.step_plain(cfg, env, aa, ab)
        return env2, out.reward_a, out.done, out.truncated, out.final_obs

    key = threefry.key(7, dev)
    import numpy as np
    from gym_soccer_tpu_torch.ops import scatter_kernel as sc
    idx, vals, n = scatter_inputs(np, SCATTER_TIMED)
    gi, gv = torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev)
    counts = {
        "engine step, step_plain": device_ops(
            torch, lambda i: batch.step_plain(cfg, st, acts[0], acts[1])),
        "engine step, S1": device_ops(
            torch, lambda i: batch.step(cfg, st, acts[0], acts[1])),
        "learner step, step_plain": device_ops(
            torch, lambda i: L._minimax_step_engine(
                eng._replace(step=plain_step), lcfg, lst, i)),
        "learner step, S1": device_ops(
            torch, lambda i: L._minimax_step_engine(eng, lcfg, lst, i)),
        "eval draw, plain": device_ops(
            torch, lambda i: tk.keyed_uniform_plain(key, i, (2, 1024))),
        "eval draw, keyed T1": device_ops(
            torch, lambda i: tk.keyed_uniform(key, i, (2, 1024))),
        "A1 call, " + SCATTER_TIMED: device_ops(
            torch, lambda i: sc.scatter_add(gi, gv, n)),
    }
    print(f"[S1] device operations a call (torch.profiler, 3 calls after a "
          f"warm-up, early in the process; {B} lanes, 5x4 slip 0.2, "
          f"threefry): {counts} | {card}")
    check(counts["engine step, S1"] == 1 and counts["eval draw, keyed T1"]
          == 1 and counts["A1 call, " + SCATTER_TIMED] == SCATTER_DEVICE_OPS,
          f"S1's step or the keyed draw is not one operation, or A1's call "
          f"not {SCATTER_DEVICE_OPS}: {counts}")
    return counts


def engine_start(torch, cfg, rng, lanes, dev, seed):
    """``lanes`` lanes after 8 steps of ``step_plain`` without autoreset
    from random key words (the lanes that scored stay in their goal
    states), every 5th counter at 2**31 - 3 (the draws' counters wrap) and
    every 7th clock one step from truncation; on ``dev``."""
    import numpy as np
    from gym_soccer_tpu_torch.core import batch
    rng_np = np.random.default_rng(seed)
    words = rng_np.integers(0, 2 ** 32, (lanes, 2), dtype=np.uint64)
    st = batch.init_from_keys(cfg, words, dev, rng=rng)
    for _ in range(8):
        aa, ab = (torch.as_tensor(rng_np.integers(0, 5, lanes), device=dev)
                  for _ in range(2))
        st, _ = batch.step_plain(cfg, st, aa, ab, autoreset=False, rng=rng)
    n, t = st.n.clone(), st.t.clone()
    n[::5] = 2 ** 31 - 3
    t[1::7] = cfg.max_steps - 1
    return st._replace(n=n, t=t)


def s1_phase(torch, dev, card, s1_instructions, t1_device_ms, step_counts):
    """Phase 46: S1 (``batch.step`` on the card, csrc/engine_kernel.cu)
    against ``batch.step_plain`` on the card, bit for bit in every state
    and StepOut field, at 8192 lanes on 5x4 and 11x7, slip 0.2 and 0,
    autoreset on and off, threefry and counter, S1_STEPS steps from
    goal-state, wrapping and truncating lanes (``engine_start``), int64
    and int32 actions in turn, one launch a step; S1 captured once in a
    CUDA graph and replayed, equal to its eager call; S1's and
    ``step_plain``'s call ms (CUDA
    events) and device ms (graph replay of S1_GRAPH_CALLS /
    PLAIN_GRAPH_CALLS calls) beside T1's; the bound from S1's SASS; the
    launch counts of ``step_kernel_counts``.  Returns S1's max abs error,
    its ms and plain ms, and its work."""
    import numpy as np
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, rules
    from gym_soccer_tpu_torch.ops import engine_kernel as ek
    err, cases, seen = 0, 0, {"goal lanes": 0, "done": 0, "truncated": 0}
    rng_np = np.random.default_rng(46)
    for (w, h), q, auto, rng in [(b, q, a, r) for b in BOARDS
                                 for q in (SLIP, 0.0) for a in (True, False)
                                 for r in ("threefry", "counter")]:
        cfg = EnvConfig(width=w, height=h, slip_prob=q)
        st = engine_start(torch, cfg, rng, B, dev, cases)
        seen["goal lanes"] += int(rules.is_goal_state(torch, *st[:5],
                                                      cfg).sum())
        for k in range(S1_STEPS):
            acts = torch.as_tensor(rng_np.integers(0, 5, (2, B)), device=dev)
            acts = acts if k % 2 else acts.int()
            ek.reset_launch_counts()
            got = batch.step(cfg, st, acts[0], acts[1], auto, rng)
            check(ek.launch_counts[S1] == 1, "S1 not launched once a step")
            want = batch.step_plain(cfg, st, acts[0], acts[1], auto, rng)
            pairs = list(zip((*got[0], *got[1]), (*want[0], *want[1])))
            same = all(a.dtype == b.dtype and a.shape == b.shape
                       and torch.equal(a, b) for a, b in pairs)
            e = max(float((a.double() - b.double()).abs().max())
                    for a, b in pairs)
            err = max(err, e)
            check(same, f"S1 != step_plain on {w}x{h} slip {q} autoreset "
                        f"{auto} {rng}, step {k}: max abs err {e}")
            seen["done"] += int(got[1].done.sum())
            seen["truncated"] += int(got[1].truncated.sum())
            st = got[0]
        cases += 1
    check(all(seen.values()), f"S1's cases missed a kind of lane: {seen}")
    print(f"[S1] bit-equal to step_plain on the card in every state and "
          f"StepOut field: {cases} cases ({B} lanes, 5x4 and 11x7, slip "
          f"{SLIP} and 0, autoreset on and off, threefry and counter) x "
          f"{S1_STEPS} steps, one launch a step, max abs err {err}; "
          f"{seen} | {card}")

    cfg = EnvConfig(5, 4, SLIP)
    st = engine_start(torch, cfg, "threefry", B, dev, 99)
    aa, ab = (torch.as_tensor(x, device=dev) for x in
              np.random.default_rng(7).integers(0, 5, (2, B)))
    eager = batch.step(cfg, st, aa, ab)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = batch.step(cfg, st, aa, ab)
    for t in (*captured[0][:7], *captured[1]):
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((*captured[0], *captured[1]),
                                               (*eager[0], *eager[1]))),
          "S1 replayed from a CUDA graph != its eager call")

    ms = {}
    for name, fn in ((S1, batch.step), (S1 + "_plain", batch.step_plain)):
        med, reps, legs = time_cuda(lambda: fn(cfg, st, aa, ab))
        ms[name] = med
        print(f"[time] {name} {B} lanes 5x4 (threefry, autoreset): {med} "
              f"ms/call (median of {len(legs)} legs x {reps} calls) | "
              f"{card}")
    device_ms = {}
    for name, fn, calls in ((S1, batch.step, S1_GRAPH_CALLS),
                            (S1 + "_plain", batch.step_plain,
                             PLAIN_GRAPH_CALLS)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn(cfg, st, aa, ab)
        device_ms[name] = time_cuda(graph.replay)[0] / calls
        del graph
    maps = batch.device_maps(cfg, dev)
    nbytes = B * (7 * 4 + 2 * 8 + 2 * 8 + 9 * 4 + 2 * 4 + 2) + sum(
        t.numel() * t.element_size() for t in maps)
    bound_ms, bound_by = bound(B, s1_instructions, nbytes)
    from gym_soccer_tpu_torch.ops import _build
    regs = ptxas_registers(
        _build.build("engine_kernel").with_suffix(".log").read_text())
    shape = (ctypes.c_int32 * 2)()
    ek._library().gst_engine_shape(ctypes.addressof(shape))
    print(f"[S1] {shape[0]} lanes a block, "
          f"{[r for k, r in regs.items() if S1_SYMBOL in k]} registers, "
          f"{s1_instructions} SASS instructions on the shortest way through "
          f"a lane, {nbytes} B; bound {bound_ms} ms ({bound_by}); {ms[S1]} "
          f"ms a call, {device_ms[S1]} ms of device time (CUDA-graph "
          f"replay of {S1_GRAPH_CALLS} calls), against step_plain's "
          f"{ms[S1 + '_plain']} ms a call and {device_ms[S1 + '_plain']} ms "
          f"of device time (the previous design; {PLAIN_GRAPH_CALLS} calls "
          f"a replay) and T1's {t1_device_ms} ms of device time a draw | "
          f"{card}")
    print(f"[S1] device operations a call: {step_counts} | {card}")
    eval_walls(torch, dev, card)
    ms[S1 + "_device"] = device_ms[S1]
    return err, ms, (B, nbytes)


def eval_walls(torch, dev, card):
    """The loop of ``eval_episode_stats`` (1024 lanes x 400 steps of
    uniform policies) written out, host clock, on S1 and the keyed draw
    (``batch.step``, ``keyed_uniform``) and on the previous design
    (``step_plain``, ``keyed_uniform_plain``), in turns previous, S1, S1,
    previous; every run's trajectory equal, and equal to
    ``eval_episode_stats``' statistics."""
    from gym_soccer_tpu_torch.agents import learners
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, threefry
    from gym_soccer_tpu_torch.examples import train_minimax
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    from gym_soccer_tpu_torch.utils.metrics import chunk_stats
    cfg = EnvConfig(5, 4, SLIP)
    pi = torch.full((761, 5), 0.2, device=dev)
    key = threefry.key(7, dev)

    def run(step, draw):
        st = batch.init(cfg, threefry.key(8), 1024, dev)
        obs, outs = batch.observe(cfg, st), []
        for i in range(400):
            u = draw(key, i, (2, 1024))
            rows = pi[obs.long()]
            st, out = step(cfg, st, learners._sample_mixed(rows, u[0]),
                           learners._sample_mixed(rows, u[1]))
            outs.append(out)
            obs = out.obs
        return batch.StepOut(*(torch.stack(f) for f in zip(*outs)))

    designs = {"previous": (batch.step_plain, tk.keyed_uniform_plain),
               "S1": (batch.step, tk.keyed_uniform)}
    walls, runs = {"previous": [], "S1": []}, []
    for design in ("previous", "S1", "S1", "previous"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(run(*designs[design]))
        torch.cuda.synchronize()
        walls[design].append(time.perf_counter() - t0)
    check(all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0])),
          "eval_episode_stats' loop differs between the designs")
    s = chunk_stats(runs[0])
    ev = train_minimax.eval_episode_stats(cfg, pi, pi, device=dev)
    check((int(s.episodes), int(s.goals), int(s.truncations)) ==
          (ev["episodes"], ev["goals"], ev["truncations"]),
          f"eval_episode_stats {ev} != its loop written out {s}")
    print(f"[S1] eval_episode_stats' loop 1024 x 400 (host clock, in "
          f"turns): on S1 and T1's keyed entry {walls['S1']} s, on the "
          f"previous design's step_plain and plain draw {walls['previous']} "
          f"s; equal trajectories, eval_episode_stats {ev} | {card}")


def keyed_phase(torch, dev, card, instructions):
    """Phase 46, T1's keyed entry: ``keyed_uniform`` and ``keyed_randint``
    against their plain versions on the card bit for bit at the
    evaluation's T1_KEYED_SHAPE, 2 x 8192, 7 and 3 x 5 x 2, i 0, 399 and
    2**31 - 1; ``keyed_uniform`` and its plain version timed at
    T1_KEYED_SHAPE by CUDA events a call and by the replay of a CUDA graph
    of KEYED_GRAPH_CALLS calls (10 for the plain version) for device time;
    the bound from ``instructions`` SASS a thread of its uniform instance.
    Returns its max abs error, its ms and plain ms, and its work."""
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.ops import threefry_kernel as tk
    key = threefry.key(5, dev)
    err = 0.0
    for shape in (T1_KEYED_SHAPE, (2, B), (7,), (3, 5, 2)):
        for i in (0, 399, 2 ** 31 - 1):
            pairs = ((tk.keyed_uniform(key, i, shape),
                      tk.keyed_uniform_plain(key, i, shape)),
                     (tk.keyed_randint(key, i, shape, 0, 5),
                      tk.keyed_randint_plain(key, i, shape, 0, 5)))
            check(all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in pairs),
                  f"T1's keyed entry != plain at {shape}, i {i}")
            err = max(err, *(float((a.double() - b.double()).abs().max())
                             for a, b in pairs))
    ms, device_ms = {}, {}
    for name, fn, calls in ((T1_KEYED, tk.keyed_uniform, KEYED_GRAPH_CALLS),
                            (T1_KEYED + "_plain", tk.keyed_uniform_plain,
                             10)):
        ms[name] = time_cuda(lambda: fn(key, 399, T1_KEYED_SHAPE))[0]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(calls):
                fn(key, i, T1_KEYED_SHAPE)
        device_ms[name] = time_cuda(graph.replay)[0] / calls
        del graph
    units = math.prod(T1_KEYED_SHAPE)
    nbytes = 2 * 8 + units * 4
    bound_ms, bound_by = bound(units, instructions, nbytes)
    print(f"[T1 keyed] keyed_uniform and keyed_randint bit-equal to their "
          f"plain versions at {T1_KEYED_SHAPE}, 2 x {B}, 7 and 3 x 5 x 2, i "
          f"0, 399 and 2**31 - 1 (max abs err {err}); keyed_uniform at "
          f"{T1_KEYED_SHAPE}: {instructions} SASS instructions on the "
          f"shortest way through a thread, {nbytes} B, bound {bound_ms} ms "
          f"({bound_by}); {ms[T1_KEYED]} ms a call, {device_ms[T1_KEYED]} "
          f"ms of device time (CUDA-graph replay of {KEYED_GRAPH_CALLS} "
          f"calls), against the plain version's {ms[T1_KEYED + '_plain']} "
          f"ms a call and {device_ms[T1_KEYED + '_plain']} ms of device "
          f"time | {card}")
    ms[T1_KEYED + "_device"] = device_ms[T1_KEYED]
    return err, ms, (units, nbytes)


def profile_window(torch, fn, label, kernel, card, calls=20):
    """Device time per launch of the kernel whose name holds ``kernel``
    (launched once a call), all device time, and the device's idle share
    over ``calls`` back-to-back calls of ``fn`` under ``torch.profiler``
    (the profiler's own host cost included); returns the first, in us
    (None if the profiler recorded no launch of it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]   # kernels, memsets
    total = sum(device_us(e) for e in events)
    mine = [e for e in events if kernel in e.key]
    seen = sum(e.count for e in mine)
    if not seen:
        print(f"[profile] {label}: the profiler saw no {kernel} launch")
        return None
    # The profiler can drop device records late in a long process: the
    # kernel's time is taken per launch it recorded, and the idle share
    # only when it recorded every launch.
    idle = (f"all device time {total / calls} us per call, idle share "
            f"{1 - total / window_us}" if seen == calls else
            "idle share not measured")
    per_launch = sum(device_us(e) for e in mine) / seen
    print(f"[profile] {label}: {calls} calls in {window_us} us of window; "
          f"{kernel} {per_launch} us of device time per launch ({seen} of "
          f"{calls} launches recorded), {idle} | {card}")
    return per_launch


# ----------------------------------------------------------------------
# Phases 47-48: data parallelism (parallel/mesh)
# ----------------------------------------------------------------------

def mesh_phases(torch, dev, card, exploitability):
    """Phases 47 (NCCL at world size 1, in this process) and 48 (two
    processes on the one card over gloo), each with its wall seconds."""
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    nccl_phase(torch, dev, card, exploitability)
    print(f"[phase 47] {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    two_ranks_phase(torch, dev, card, exploitability)
    print(f"[phase 48] {time.perf_counter() - t0} s")
    print(f"[mesh] phases 47-48 ran {time.perf_counter() - t_all} s")


def _dp_counts():
    from gym_soccer_tpu_torch.agents import learners
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    return lk.launch_counts, ik.launch_counts, ak.launch_counts, \
        learners.launch_counts


def _dp_reset():
    for d in _dp_counts():
        for k in d:
            d[k] = 0


def _dp_launched() -> dict:
    return {k: n for d in _dp_counts() for k, n in d.items() if n}


def nccl_phase(torch, dev, card, exploitability):
    """Phase 47: an NCCL process group of one rank in this process
    (``distributed_init(..., backend="nccl")``), so every all-reduce of
    the data-parallel paths runs (and, in the grouped modes, is captured
    in the CUDA graph with the chunks).  Each recipe runs at
    chunks_per_dispatch=8 without and then with ``mesh=``, its launches
    counted (K5-K11 replays x 8 + remainder, R1 once a re-solve): the 5x4
    contract (q bit-equal, exploitability 0.0034149587), the IQL run, the
    alternating gate (|V - V*| <= 0.05, win share > 0.95), the
    best-response gate (win share > 0.95) and the --multigrid recipe
    packed, each bit-equal to its run without the mesh, with both walls;
    ``sharded_solve_fn`` at 11705 x 600 bit-equal to R1 replicated; the
    minimax-Q and IQL learning checks (tests/test_learners.py:48, :73)
    through ``sharded_*_train_fn``; then ``dryrun_multichip(1)`` in a
    spawned rank."""
    import tempfile

    import numpy as np
    from gym_soccer_tpu_torch import entry
    from gym_soccer_tpu_torch.agents import evaluation, learners
    from gym_soccer_tpu_torch.agents.learners import solve_matrix_games
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    from gym_soccer_tpu_torch.utils.policies import get_random_policy_array
    cfg = EnvConfig(5, 4, SLIP)
    g = GROUPED_CHUNKS

    def pair(label, train, n_tensors, kernel, n_chunks, solves=None):
        """``train`` at chunks_per_dispatch=8 without and with the mesh:
        launches, outputs bit for bit, walls."""
        runs = {}
        for which, m in (("no mesh", None), ("mesh", mesh)):
            _dp_reset()
            timing = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train(mesh=m, chunks_per_dispatch=g, timing=timing)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _dp_launched()
            check(got.get(kernel) == n_chunks
                  and timing["replays"] == n_chunks // g
                  and (solves is None or got.get(RMPLUS, 0) == solves),
                  f"{label} ({which}): launches {got}, replays "
                  f"{timing['replays']}")
            runs[which] = (out, wall, timing, got)
        (a, wa, ta, _), (b, wb, tb, got) = runs["no mesh"], runs["mesh"]
        check(all(torch.equal(x, y) for x, y in zip(a[:n_tensors],
                                                     b[:n_tensors]))
              and a[n_tensors] == b[n_tensors],
              f"{label}: the mesh run differs from the run without it")
        print(f"[mesh nccl] {label}, chunks_per_dispatch={g}: outputs and "
              f"history bit-equal without and with the 1-rank NCCL mesh; "
              f"launches with the mesh {got}; wall {wb} s with the mesh "
              f"(capture {tb['capture_ms']} ms, replays {tb['segments_ms']} "
              f"ms) against {wa} s without (capture {ta['capture_ms']} ms, "
              f"replays {ta['segments_ms']} ms) | {card}")
        return b

    with tempfile.TemporaryDirectory() as tmp:
        pmesh.distributed_init(f"file://{tmp}/store", 1, 0, backend="nccl",
                               device=dev)
        try:
            mesh = pmesh.env_mesh(1, device=dev)
            check(mesh.backend == "nccl" and mesh.capturable,
                  f"phase 47's mesh {mesh}")
            q, v, pa, pb, _ = pair(
                "5x4 contract",
                lambda **k: lk.fused_minimax_train(cfg, device=dev,
                                                   **CONTRACT, **k),
                4, "packed_learner_chunk", CONTRACT["n_chunks"],
                CONTRACT["n_chunks"] + 1)
            ex = exploitability(cfg, pa, pb, gamma=0.99)
            check(round(ex, 10) == CONTRACT_READING,
                  f"mesh contract: exploitability {ex} does not read "
                  f"{CONTRACT_READING}")
            print(f"[mesh nccl] 5x4 contract with the mesh: exploitability "
                  f"{ex} | {card}")
            pair("IQL run", lambda **k: ik.fused_iql_train(cfg, **IQL_RUN,
                                                           **k),
                 2, "iql_packed_chunk", IQL_RUN["n_chunks"])
            q, _ = pair("alternating gate",
                        lambda **k: ak.fused_altq_train(cfg, **ALT_RECIPE,
                                                        **k),
                        1, "altq_packed_chunk", ALT_RECIPE["n_chunks"])
            tb = alt.build_alt_tables(cfg)
            q = q.cpu()
            v_star = alt.alt_value_iteration(tb)[1]
            v_l = torch.where(torch.as_tensor(tb.turn == 0),
                              q.max(-1).values, q.min(-1).values).numpy()
            v_err = float(np.abs(v_l - v_star).mean())
            randpol = np.random.RandomState(0).randint(
                0, 5, tb.nS).astype(np.int32)
            w, losses, _ = alt.alt_policy_rollout(
                cfg, tb.raw_to_dense,
                learners.altq_greedy_policy(cfg, q).numpy(), randpol,
                batch=256, steps=300, seed=6, device=dev)
            share = w / max(w + losses, 1)
            check(v_err <= ALT_V_ERR and share > ALT_WIN_SHARE,
                  f"mesh alternating gate: |V - V*| {v_err}, share {share}")
            print(f"[mesh nccl] alternating gate with the mesh: mean |V - "
                  f"V*| {v_err}, win share {share}")
            opp = get_random_policy_array(761, 5, seed=BR_OPP_SEED)
            _, _, pa, _, _ = pair(
                "best-response gate",
                lambda **k: lk.fused_best_response_train(
                    cfg, opp, "player_a", device=dev, **BR_RECIPE, **k),
                4, "packed_learner_chunk", BR_RECIPE["n_chunks"], 0)
            share = evaluation.greedy_win_share(
                cfg, pa.argmax(-1), opp, lanes=BR_LANES, steps=BR_STEPS,
                seed=BR_EVAL_SEED, device=dev)
            check(share > BR_WIN_SHARE, f"mesh BR gate: win share {share}")
            print(f"[mesh nccl] best-response gate with the mesh: win "
                  f"share {share}")
            mgc = tuple(EnvConfig(*b) for b in MG_BOARDS)
            pair("--multigrid recipe, packed",
                 lambda **k: lk.fused_minimax_train(mgc, device=dev,
                                                    packed=True, **MG_RECIPE,
                                                    **k),
                 4, "multigrid_packed_learner_chunk", MG_RECIPE["n_chunks"],
                 MG_RECIPE["n_chunks"] + 1)
            games = _dp_games(torch, dev)
            want = solve_matrix_games(games, iters=DP_SOLVE[1])
            solve = pmesh.sharded_solve_fn(mesh, DP_SOLVE[1])
            got = solve(games)
            check(all(torch.equal(a, b) for a, b in zip(want, got)),
                  "sharded solve != R1 replicated")
            ms_rep, _, _ = time_cuda(
                lambda: solve_matrix_games(games, iters=DP_SOLVE[1]))
            ms_mesh, _, _ = time_cuda(lambda: solve(games))
            print(f"[mesh nccl] sharded_solve_fn {DP_SOLVE[0]} x "
                  f"{DP_SOLVE[1]}: bit-equal to R1 replicated; {ms_mesh} "
                  f"ms/call against {ms_rep} ms replicated (CUDA events) "
                  f"| {card}")
            dp_learning_checks(torch, dev, card, mesh)
        finally:
            torch.distributed.destroy_process_group()
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    print(f"[mesh nccl] dryrun_multichip(1) in a spawned rank: "
          f"{time.perf_counter() - t0} s | {card}")


def dp_learning_checks(torch, dev, card, mesh):
    """Phase 47's learning checks through ``sharded_*_train_fn`` on the
    1-rank NCCL mesh: tests/test_learners.py:73 (minimax-Q: |v| <= 1 +
    1e-3, max |v| > 0.05, pi rows sum to 1) and :48 (IQL self-play: greedy
    goals > truncations), the HBM-table learners' sums and counts
    all-reduced every step inside their 64-step CUDA-graph replays."""
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, threefry
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    cfg = EnvConfig(5, 4, SLIP)
    f32 = dict(dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = L.minimax_init(cfg, threefry.key(0), 512, dev)._replace(
        env=pmesh.sharded_init(cfg, mesh, threefry.key(0), 512))
    train = pmesh.sharded_minimax_train_fn(
        cfg, L.MinimaxQConfig(lr=0.2, resolve_every=16), mesh, 2000)
    st, _ = train(st)
    v, pi = st.v.abs(), st.pi_a
    check(float(v.max()) <= 1.0 + 1e-3 and float(v.max()) > 0.05
          and bool(((pi.sum(-1) - 1).abs() <= 1e-3).all()),
          f"mesh minimax-Q: max |v| {float(v.max())}")
    torch.cuda.synchronize()
    print(f"[mesh learning] test_learners.py:73 minimax-Q 512 x 2000 through "
          f"sharded_minimax_train_fn: max |v| {float(v.max())}, pi rows sum "
          f"to 1; {time.perf_counter() - t0} s | {card}")
    t0 = time.perf_counter()
    st = L.IQLState(q_a=torch.zeros((761, 5), **f32),
                    q_b=torch.zeros((761, 5), **f32),
                    env=pmesh.sharded_init(cfg, mesh, threefry.key(0), 512),
                    step=torch.zeros((), dtype=torch.int32, device=dev))
    st, _ = pmesh.sharded_iql_train_fn(cfg, L.IQLConfig(lr=0.5, eps=0.25),
                                       mesh, 6000)(st)
    env = batch.init(cfg, threefry.key(3), 512, dev)
    out = batch.rollout(cfg, env, lambda o, i: (
        st.q_a[o.long()].argmax(-1), st.q_b[o.long()].argmax(-1)), 200)[1]
    goals, truncs = int(out.done.sum()), int(out.truncated.sum())
    check(goals > truncs, f"mesh IQL: {goals} goals vs {truncs} truncations")
    torch.cuda.synchronize()
    print(f"[mesh learning] test_learners.py:48 IQL 512 x 6000 through "
          f"sharded_iql_train_fn: greedy self-play {goals} goals > {truncs} "
          f"truncations; {time.perf_counter() - t0} s | {card}")


def _dp_games(torch, dev):
    import numpy as np
    rng = np.random.default_rng(DP_SOLVE[0])
    return torch.tensor(rng.uniform(-1, 1, (DP_SOLVE[0], 5, 5)).astype(
        np.float32), device=dev)


def _dp_inputs(torch, name, dev):
    """(config, table, planes or None, fields) of a phase-48 kernel site
    on the global batch: tables from a numpy seed, made alike on every
    rank and in the script's process."""
    import numpy as np
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    game, packed, mix = DP_SITES[name]
    cfg = (tuple(EnvConfig(*b) for b in MG_BOARDS) if mix
           else EnvConfig(5, 4, SLIP))
    n = DP_RANKS * DP_LANES
    rng = np.random.default_rng(11)

    def t(a):
        return torch.tensor(a.astype(np.float32), device=dev)
    if game == "minimax":
        nS = lk.n_states(cfg)
        pa, pb = (t(rng.dirichlet(np.ones(5), nS)) for _ in range(2))
        q, v = t(rng.uniform(-1, 1, (nS, 5, 5))), t(rng.uniform(-1, 1, nS))
        table = (lk.pack_m2(cfg, pa, pb, v, 0.2) if packed
                 else lk.pack_m(cfg, pa, pb, q, v, 0.2))
        made = lk.init_state_fields(cfg, n, dev)
        planes, fields = made if mix else (None, made)
        return cfg, table, planes, fields
    if game == "iql":
        nS = lk.n_states(cfg)
        table = ik.pack_iql_table(cfg, t(rng.uniform(-0.5, 0.5, (nS, 5))),
                                  t(rng.uniform(-0.5, 0.5, (nS, 5))))
        return cfg, table, None, ik.init_iql_state_fields(cfg, n, dev)
    nS = alt.build_alt_tables(cfg).nS
    table = ak.pack_alt_table(cfg, t(rng.uniform(-0.5, 0.5, (nS, 5))))
    return cfg, table, None, ak.init_alt_state_fields(cfg, n, dev)


def _dp_chunk(torch, name, dev, mesh=None, rank=None):
    """A phase-48 kernel site's chunk: the sharded one on ``mesh``'s rank,
    or (``rank`` given) that rank's shard-seed chunk standalone."""
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    game, packed, mix = DP_SITES[name]
    cfg, table, planes, fields = _dp_inputs(torch, name, dev)
    n = DP_RANKS * DP_LANES
    if mesh is None:
        blk = slice(rank * DP_LANES, (rank + 1) * DP_LANES)
        fields = tuple(f[blk].clone() for f in fields)
        planes = None if planes is None else \
            tuple(p[blk].clone() for p in planes)
        seed = pmesh.shard_seed(DP_SEED, rank)
        fn = getattr({"minimax": lk, "iql": ik, "altq": ak}[game], name)
        if game != "minimax":
            return fn(cfg, seed, DP_EPS_INT, table, fields, DP_LANES,
                      DP_STEPS, step_offset=DP_OFFSET, global_batch=n)
        args = (planes, fields) if mix else (fields,)
        return fn(cfg, seed, table, *args, DP_LANES, DP_STEPS,
                  global_batch=n)
    fields = pmesh.shard_fields(fields, mesh, n)
    if game == "iql":
        return pmesh.sharded_iql_chunk_fn(cfg, mesh, n, DP_STEPS,
                                          packed=packed)(
            DP_SEED, DP_EPS_INT, table, fields, DP_OFFSET)
    if game == "altq":
        return pmesh.sharded_altq_chunk_fn(cfg, mesh, n, DP_STEPS,
                                           packed=packed)(
            DP_SEED, DP_EPS_INT, table, fields, DP_OFFSET)
    fn = pmesh.sharded_learner_chunk_fn(cfg, mesh, n, DP_STEPS,
                                        packed=packed)
    if mix:
        return fn(DP_SEED, table, fields, pmesh.shard_fields(planes, mesh, n))
    return fn(DP_SEED, table, fields)


def _to_cpu(x):
    if hasattr(x, "cpu"):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(y) for y in x)
    return x


def dp_orbax(torch, mesh, path):
    """On one of phase 48's ranks: ``fused_minimax_train`` on 5x4 at
    DP_RANKS x DP_LANES lanes, 1 chunk of DP_STEPS steps saved by
    ``save_orbax`` under the mesh at ``path`` (the fields the rank's
    block), loaded back into a zeroed template and resumed for 1 chunk.
    Returns the saved dict on the CPU and whether the load was bit-equal
    and on the rank's device and the resumed chunk equal to 2 chunks at
    once."""
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.utils import checkpoint
    cfg, blocks = EnvConfig(5, 4, SLIP), ("fields",)
    kw = dict(batch=DP_RANKS * DP_LANES, chunk_len=DP_STEPS, lr=1.0,
              eps=0.2, return_state=True, device=mesh.device, mesh=mesh)
    *_, whole = lk.fused_minimax_train(cfg, n_chunks=2, **kw)
    *_, r = lk.fused_minimax_train(cfg, n_chunks=1, **kw)
    checkpoint.save_orbax(path, r, mesh=mesh, blocks=blocks)
    got = checkpoint.load_orbax(path, _zeros_tree(r), mesh=mesh,
                                blocks=blocks)
    *_, part = lk.fused_minimax_train(
        cfg, n_chunks=1, init=(got["q"], got["v"], got["pi_a"], got["pi_b"],
                               got["n"]), fields_init=got["fields"],
        start_chunk=got["next_chunk"], **kw)
    on_device = all(x.device == mesh.device for x in _tree_leaves(got)
                    if isinstance(x, torch.Tensor))
    saved = checkpoint._unflatten(r, iter(
        x.cpu() if isinstance(x, torch.Tensor) else x
        for x in _tree_leaves(r)))
    return saved, (_trees_equal(got, r), on_device,
                   _trees_equal(part, whole))


def dp_rank(mesh, orbax_path):
    """One of phase 48's ranks (a spawned process on the card, gloo with
    CUDA tensors): the eight kernel sites' sharded chunks, the sharded
    re-solve and the 5x4 contract per chunk on its half of the 65536
    lanes, with the kernels it launched and its walls; then the orbax
    pair under the mesh (``dp_orbax``)."""
    import torch
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    dev = mesh.device
    out = {"mesh": str(mesh), "chunks": {}}
    _dp_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name in DP_SITES:
        out["chunks"][name] = _to_cpu(_dp_chunk(torch, name, dev, mesh))
    out["chunks_s"] = time.perf_counter() - t0
    out["solve"] = _to_cpu(pmesh.sharded_solve_fn(mesh, DP_SOLVE[1])(
        _dp_games(torch, dev)))
    out["chunk_launches"] = _dp_launched()
    _dp_reset()
    cfg = EnvConfig(5, 4, SLIP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, pa, pb, hist = lk.fused_minimax_train(cfg, device=dev, mesh=mesh,
                                                **CONTRACT)
    torch.cuda.synchronize()
    out["contract"] = (pa.cpu(), pb.cpu(), hist,
                       time.perf_counter() - t0, _dp_launched())
    out["orbax"] = dp_orbax(torch, mesh, orbax_path)
    return out


def two_ranks_phase(torch, dev, card, exploitability):
    """Phase 48: two spawned processes share the card over gloo with CUDA
    tensors (NCCL refuses two ranks on one device), killed by their PIDs
    past ``DP_TIMEOUT``.  The eight kernel sites' all-reduced sums, counts
    and stats at 2 x 4096 lanes x 64 steps equal, bit for bit, the sum of
    the same two shard-seed chunks run here on the card, and each rank's
    fields its chunk's; R1's sharded solve equals the replicated one; the
    5x4 contract at 2 x 32768 lanes, per chunk, reads exploitability <=
    0.010 (other shard seeds: another run than the 1-process one).  The
    orbax pair under the mesh (``dp_orbax``): each rank's resume dict
    saved and loaded back bit-equal on its device, the resumed chunk
    equal to the uninterrupted run; this process, with no mesh, loads the
    global batch from the ranks' checkpoint, their blocks in rank
    order."""
    from gym_soccer_tpu_torch.agents.learners import solve_matrix_games
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.parallel import mesh as pmesh
    from gym_soccer_tpu_torch.utils import checkpoint
    t0 = time.perf_counter()
    with build_tmpdir() as tmp:
        path = os.path.join(tmp, "orbax")
        ranks = pmesh.spawn(dp_rank, DP_RANKS, (path,), device="cuda",
                            backend="gloo", timeout=DP_TIMEOUT)
        wall = time.perf_counter() - t0
        r0, r1 = (r["orbax"][0] for r in ranks)
        tmpl = _zeros_tree(dict(r0, fields=tuple(
            torch.zeros(DP_RANKS * f.shape[0], dtype=f.dtype, device=dev)
            for f in r0["fields"])))
        got = checkpoint.load_orbax(path, tmpl)
        files = sorted(os.listdir(path))
    want = dict(r0, fields=tuple(torch.cat(p) for p in zip(r0["fields"],
                                                           r1["fields"])))
    whole = _trees_equal(checkpoint._unflatten(got, iter(
        x.cpu() if isinstance(x, torch.Tensor) else x
        for x in _tree_leaves(got))), want)
    oks = [r["orbax"][1] for r in ranks]
    print(f"[mesh gloo] orbax pair on {DP_RANKS} ranks ({files}): each "
          f"rank's resume dict back bit-equal, on its device, the resumed "
          f"chunk equal to 2 chunks at once: {oks}; one process without a "
          f"mesh loads the global batch, the ranks' blocks in rank order: "
          f"{whole} | {card}")
    check(all(all(ok) for ok in oks) and whole,
          f"the orbax pair under the 2-rank mesh: {oks}, global {whole}")
    print(f"[mesh gloo] {DP_RANKS} ranks on {ranks[0]['mesh']} and "
          f"{ranks[1]['mesh']}: {wall} s from spawn to their results; the "
          f"eight chunks {[r['chunks_s'] for r in ranks]} s a rank, "
          f"launches {ranks[0]['chunk_launches']} | {card}")
    for name in DP_SITES:
        sums = cnt = stats = None
        for r in range(DP_RANKS):
            f, (s, c), st = _dp_chunk(torch, name, dev, rank=r)
            check(all(torch.equal(a.cpu(), b) for a, b in
                      zip(f, ranks[r]["chunks"][name][0])),
                  f"{name}: rank {r}'s fields differ from its chunk's")
            sums = s if sums is None else sums + s
            cnt = c if cnt is None else cnt + c
            stats = st if stats is None else [a + b for a, b in zip(stats,
                                                                    st)]
        for r in range(DP_RANKS):
            _, (s, c), st = ranks[r]["chunks"][name]
            check(torch.equal(s, sums.cpu()) and torch.equal(c, cnt.cpu())
                  and [int(x) for x in st] == [int(x) for x in stats],
                  f"{name}: rank {r}'s all-reduced sums differ from the "
                  f"summed shard chunks")
        check(int(stats[3]) == 0, f"{name}: values out of range")
        print(f"[mesh gloo] {name} {DP_RANKS} x {DP_LANES} x {DP_STEPS}: "
              f"all-reduced int64 sums, int32 counts ({int(cnt.sum())} "
              f"visits) and stats equal on both ranks the sum of the two "
              f"shard-seed chunks run in one process, bit for bit")
    want = solve_matrix_games(_dp_games(torch, dev), iters=DP_SOLVE[1])
    for r in range(DP_RANKS):
        check(all(torch.equal(a.cpu(), b) for a, b in
                  zip(want, ranks[r]["solve"])),
              f"rank {r}'s sharded solve != R1 replicated")
    print(f"[mesh gloo] sharded_solve_fn {DP_SOLVE[0]} x {DP_SOLVE[1]} "
          f"over 2 ranks: bit-equal to R1 replicated on both")
    pa, pb, hist, c_wall, launched = ranks[0]["contract"]
    cfg = EnvConfig(5, 4, SLIP)
    ex = exploitability(cfg, pa.to(dev), pb.to(dev), gamma=0.99)
    same = all(torch.equal(a, b) for a, b in
               zip((pa, pb), ranks[1]["contract"][:2]))
    print(f"[mesh gloo] 5x4 contract {CONTRACT} per chunk over {DP_RANKS} "
          f"ranks x {CONTRACT['batch'] // DP_RANKS} lanes: exploitability "
          f"{ex} (limit {CONTRACT_EXPLOITABILITY}); ranks' pi equal {same}; "
          f"train wall {c_wall} s on rank 0 ({ranks[1]['contract'][3]} s on "
          f"rank 1); rank 0's launches {launched} | {card}")
    check(same, "the two ranks' tables differ")
    check(ex <= CONTRACT_EXPLOITABILITY,
          f"2-rank contract: exploitability {ex} > {CONTRACT_EXPLOITABILITY}")


# ----------------------------------------------------------------------
# Phase 49: the tools (tools/bench_all, tools/bench_parity_kernel)
# ----------------------------------------------------------------------

def _bench_counts():
    from gym_soccer_tpu_torch.agents import learners
    from gym_soccer_tpu_torch.ops import (altq_kernel, engine_kernel,
                                          iql_kernel, learner_kernel,
                                          mixed_alt_kernel, parity_kernel,
                                          scatter_kernel, step_kernel,
                                          threefry_kernel)
    return (step_kernel.launch_counts, learner_kernel.launch_counts,
            iql_kernel.launch_counts, altq_kernel.launch_counts,
            parity_kernel.launch_counts, threefry_kernel.launch_counts,
            engine_kernel.launch_counts, mixed_alt_kernel.launch_counts,
            scatter_kernel.launch_counts, learners.launch_counts)


def bench_expected(name: str, row: dict) -> dict:
    """The launches ``BENCH_LAUNCHES`` gives row ``name`` for the calls,
    chunks and steps its result ``row`` reports."""
    per = {"call": 1, "chunk": row.get("chunks"), "step": row.get("steps")}
    return {k: n * row["calls"] * per[unit] + once
            for k, (unit, n, once) in BENCH_LAUNCHES[name].items()}


def tools_phase(torch, dev, card, rows=None):
    """Phase 49: ``tools.bench_all``'s rows on the card at their default
    sizes, each with the kernel counters reset before it and read after
    it, then ``tools.bench_parity_kernel`` in a subprocess; with ``rows``
    (names), those rows alone and no subprocess."""
    from gym_soccer_tpu_torch.tools import bench_all
    t_all = time.perf_counter()
    names = [name for name, _ in bench_all.ROWS]
    check(names == list(BENCH_LAUNCHES),
          f"bench_all's rows {names} are not BENCH_LAUNCHES'")
    counts = _bench_counts()
    for name, fn in bench_all.ROWS:
        if rows is not None and name not in rows:
            continue
        for d in counts:
            for k in d:
                d[k] = 0
        t0 = time.perf_counter()
        line = bench_all.run_row(name, fn, dev, False, card)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: n for d in counts for k, n in d.items() if n}
        print(f"[phase 49] {json.dumps(line)} | launches {launched} | row "
              f"wall {wall} s")
        check("error" not in line, f"bench_all row {name} failed: "
              f"{line.get('error')}")
        v = line["env_steps_per_s"]
        check(math.isfinite(v) and v > 0, f"{name}: rate {v}")
        if "lengths" in line:
            check(line["long_ms"] > line["short_ms"] > 0,
                  f"{name}: legs {line['short_ms']} / {line['long_ms']} ms")
        want = {k: n for k, n in bench_expected(name, line).items() if n}
        check(launched == want, f"{name}: launches {launched}, not {want}")
    print(f"[phase 49] bench_all: {len(rows or names)} rows in "
          f"{time.perf_counter() - t_all} s, no error, launches as named")
    if rows is not None:
        return
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m",
         "gym_soccer_tpu_torch.tools.bench_parity_kernel"], cwd=root, capture_output=True, text=True,
        timeout=BENCH_PARITY_TIMEOUT)
    lines = json_lines(proc.stdout)
    for line in lines:
        print(f"[phase 49] bench_parity_kernel {json.dumps(line)}")
    checks = {d["check"]: d["ok"] for d in lines if "check" in d}
    check(proc.returncode == 0 and checks == {
        "on_chip_bit_exact": True, "scripted_on_chip_bit_exact": True},
        f"bench_parity_kernel exited {proc.returncode} with checks {checks}: "
        f"{proc.stderr[-2000:]}")
    print(f"[phase 49] bench_parity_kernel: exit 0, both checks true, "
          f"{time.perf_counter() - t0} s | {card}")
    print(f"[phase 49] {time.perf_counter() - t_all} s")


# ----------------------------------------------------------------------
# Phase 50: determinism and checkpoints (A1, the orbax pair)
# ----------------------------------------------------------------------

def determinism_phase(torch, dev, card, entry_exploitability=None):
    """Phase 50, with its wall seconds: A1 against its plain version
    (``scatter_phase``), the four HBM-table learners on the card against
    the CPU (``learners_equal_cpu``), the entry point's default mode run
    twice and resumed from ``--ckpt`` (``entry_repeats``; its
    exploitability also equal to phase 39's, ``entry_exploitability``,
    where given) and the orbax pair on the card (``orbax_on_card``).
    Returns A1's max abs err, its ms and its work (lanes, bytes)."""
    t0 = time.perf_counter()
    err, ms, work = scatter_phase(torch, dev, card)
    learners_equal_cpu(torch, dev, card)
    entry_repeats(torch, dev, card, entry_exploitability)
    orbax_on_card(torch, dev, card)
    print(f"[phase 50] {time.perf_counter() - t0} s")
    return err, ms, work


def scatter_bound(lanes: int, nbytes: int):
    """(ms, 'bytes' or 'operations'): A1's least time, its ``lanes``
    additions at the float32 rate or its ``nbytes`` at the HBM rate."""
    ops_ms = lanes / FLOAT32_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def _graph_ms(torch, fn, calls, min_leg_ms=50.0):
    """Device ms a call of ``fn``: a CUDA graph of ``calls`` calls,
    replayed (``time_cuda``, legs of at least ``min_leg_ms``)."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_cuda(graph.replay, min_leg_ms)[0] / calls


def scatter_phase(torch, dev, card):
    """A1 (``scatter_add``, csrc/scatter_kernel.cu) on each of
    ``SCATTER_CASES`` and ``SCATTER_CHECKED``: sums and counts bit-equal to
    its plain version (``index_add_`` on the CPU, lane order), one launch
    a call, bit-equal again from the replay of a CUDA graph that captured
    it, and its previous design (csrc/scatter_walk_kernel.cu) and the
    design measured and not kept (csrc/scatter_sort_kernel.cu: one block,
    a stable radix sort by cell), both built by ops/scatter_variants,
    bit-equal too; its launch's shape the one ``launch_shape`` computes.
    On ``SCATTER_CASES``: each case's cells hit and longest run, its
    serial chain at 4 cycles an addition and 1.98 GHz, the device
    operations of a call (``torch.profiler``, at most SCATTER_DEVICE_OPS),
    A1's, the previous design's and the sort design's device ms a call by
    graph replay, timed in turns (A1, walk, sort, sort, walk, A1), the
    kernel's time by ``torch.profiler``, and how many of SCATTER_REPEATS
    calls of
    ``index_add_`` on the card (the PyTorch call for the same function,
    atomics) differ in a bit (recorded, not required).  On
    ``SCATTER_TIMED``: A1's call ms, ``index_add_``'s call and device ms
    (with its zero fill, the values and ones as rows), the device ms of
    ordering the lanes by ``torch.sort`` (global passes A1 does without),
    the plain version's call ms, and A1's bound.  Returns A1's max abs
    err, ms, work."""
    import numpy as np
    from gym_soccer_tpu_torch.ops import _build
    from gym_soccer_tpu_torch.ops import scatter_kernel as sc
    from gym_soccer_tpu_torch.ops import scatter_variants as sv
    lib = sc._library()
    t0 = time.perf_counter()
    for name in (sv.PREVIOUS, sv.SORTED):
        sv.load(name)
    regs = re.findall(r"Used (\d+) registers", _build.library_path(
        "scatter_kernel").with_suffix(".log").read_text())
    print(f"[A1] the previous design (walk) and the sort design built in "
          f"{time.perf_counter() - t0} s; the kernel's registers {regs}")
    designs = {"A1": lambda gi, gv, n: sc.scatter_add(gi, gv, n),
               "walk": lambda gi, gv, n: sv.scatter_add(sv.PREVIOUS, gi,
                                                        gv, n),
               "sort": lambda gi, gv, n: sv.scatter_add(sv.SORTED, gi, gv,
                                                        n)}

    err, ms = 0.0, {}
    for case in (*SCATTER_CASES, *SCATTER_CHECKED):
        idx, v, n = scatter_inputs(np, case)
        gi, gv = torch.from_numpy(idx).to(dev), torch.from_numpy(v).to(dev)
        shape = (ctypes.c_int32 * 6)()
        lib.gst_scatter_shape(len(idx), n, ctypes.addressof(shape))
        design = dict(zip(("threads", "tile", "smem", "blocks", "cells",
                           "cell_bits"), shape))
        check(design == sc.launch_shape(len(idx), n),
              f"A1's launch {design} is not launch_shape's "
              f"{sc.launch_shape(len(idx), n)}")
        before = sc.launch_counts[SCATTER]
        got = sc.scatter_add(gi, gv, n)
        torch.cuda.synchronize()
        launched = sc.launch_counts[SCATTER] - before
        want = sc.scatter_add_plain(gi, gv, n)
        same = all(bits_equal(a, b) for a, b in zip(got, want))
        e = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(got, want))
        err = max(err, e)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = sc.scatter_add(gi, gv, n)
        graph.replay()
        torch.cuda.synchronize()
        replay_same = all(bits_equal(a, b) for a, b in zip(replayed, want))
        others_same = all(bits_equal(a, b) for name in ("walk", "sort")
                          for a, b in zip(designs[name](gi, gv, n), want))
        bc = np.bincount(idx[(idx >= 0) & (idx < n)], minlength=n)
        longest = int(bc.max())
        chain_ms = longest * 4 / 1.98e9 * 1e3
        stats = (f"{len(idx)} lanes over {n} cells ({int((bc > 0).sum())} "
                 f"hit, the longest run {longest} lanes: a serial chain of "
                 f"{chain_ms} ms at 4 cycles an addition)")
        equal = (f"sums and counts bit-equal to the plain version {same} "
                 f"(max abs err {e}), from a CUDA-graph replay "
                 f"{replay_same}, the walk's and the sort design's "
                 f"{others_same}; {launched} launch a call")
        check(same and replay_same and others_same and launched == 1,
              f"A1 on {case}: {equal}")
        if case in SCATTER_CHECKED:
            print(f"[A1] {case}: {stats}: {equal} | {card}")
            continue
        # Late in a long process the profiler can record no device
        # operation at all; phase 46's count, taken early, holds then.
        ops = device_ops(torch, lambda i: sc.scatter_add(gi, gv, n))
        check(ops <= SCATTER_DEVICE_OPS,
              f"A1 on {case}: {ops} device operations a call")
        ops = ops or "not recorded (phase 46: the early count)"
        rows = torch.stack([gv, torch.ones_like(gv)], 1)

        def library():
            return torch.zeros((n, 2), device=dev).index_add_(0, gi, rows)

        differ = 0
        for _ in range(SCATTER_REPEATS):
            out = library()
            differ += not (bits_equal(out[:, 0].contiguous(), want[0])
                           and bits_equal(out[:, 1].contiguous(), want[1]))
        turns = {name: [] for name in designs}
        for name in ("A1", "walk", "sort", "sort", "walk", "A1"):
            fn = designs[name]
            turns[name].append(_graph_ms(torch, lambda: fn(gi, gv, n),
                                         SCATTER_GRAPH_CALLS))
        best = {name: min(t) for name, t in turns.items()}
        device = best["A1"]
        profile_window(torch, lambda: sc.scatter_add(gi, gv, n),
                       f"A1 {case}", "partition_add_kernel", card)
        print(f"[A1] {case}: {stats}: {equal}; design: {design['blocks']} "
              f"blocks of {design['threads']} threads, {design['cells']} "
              f"cells a block, {design['tile']} lanes a tile, "
              f"{design['smem']} B of shared memory, one counting-sort pass "
              f"by cell ({design['cell_bits']} ballots a kept 32), {ops} "
              f"device operations a call (torch.profiler); "
              f"device ms a call (CUDA-graph replay of "
              f"{SCATTER_GRAPH_CALLS}, in turns A1, walk, sort, sort, walk, "
              f"A1): {turns}: A1 {device} ms, the previous design (walk) "
              f"{best['walk']} ms ({best['walk'] / device} x A1's), the sort "
              f"design {best['sort']} ms ({best['sort'] / device} x); "
              f"index_add_ on the card differed in a bit in {differ} of "
              f"{SCATTER_REPEATS} calls | {card}")
        if case != SCATTER_TIMED:
            continue
        calls = {SCATTER: lambda: sc.scatter_add(gi, gv, n),
                 SCATTER + "_plain": lambda: sc.scatter_add_plain(gi, gv, n),
                 SCATTER + "_library": library}
        for name, fn in calls.items():
            ms[name] = time_cuda(fn)[0]
        sort_ms = _graph_ms(torch, lambda: torch.sort(gi, stable=True),
                            SCATTER_GRAPH_CALLS)
        lib_device = _graph_ms(torch, library, SCATTER_GRAPH_CALLS)
        nbytes = len(idx) * 12 + n * 8
        bound_ms, bound_by = scatter_bound(len(idx), nbytes)
        work = (len(idx), nbytes)
        ms[SCATTER + "_device"] = device
        print(f"[A1] {case}: A1 {ms[SCATTER]} ms a call, {device} ms of "
              f"device time (one launch); ordering the lanes "
              f"by torch.sort alone {sort_ms} ms of device time; index_add_ "
              f"(zero fill and one call on [values, 1] rows) "
              f"{ms[SCATTER + '_library']} ms a call, {lib_device} ms of "
              f"device time; the plain version (a CPU round trip) "
              f"{ms[SCATTER + '_plain']} ms; bound {bound_ms} ms "
              f"({bound_by}: {nbytes} B, {len(idx)} additions), the longest "
              f"run's chain {chain_ms} ms | {card}")
    return err, ms, work


def _learner_runs(torch, dev):
    """{name: (state on the CPU, train(state, n) -> (state, |TD| per
    step), A1 launches a step)} of the four HBM-table learners at
    DET_LANES lanes: minimax-Q with the entry point's lr, eps, re-solve
    and halflives (for its 2000 steps), IQL, turn-based Q and mixture
    minimax-Q on 5x4+6x5."""
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import threefry
    cfg, cpu, key = EnvConfig(5, 4, SLIP), torch.device("cpu"), threefry.key
    mix = (cfg, EnvConfig(6, 5, SLIP))
    mc = L.MinimaxQConfig(lr=0.3, eps=0.3, resolve_every=64,
                          solver_iters=200, lr_halflife=2000 // 5,
                          eps_halflife=2000 // 3)
    ic, ac = L.IQLConfig(lr=0.5, eps=0.25), L.AltQConfig()
    return {
        "minimax-Q": (L.minimax_init(cfg, key(0), DET_LANES, cpu),
                      lambda s, n: L.minimax_train(cfg, mc, s, n), 1),
        "IQL": (L.iql_init(cfg, key(1), DET_LANES, cpu),
                lambda s, n: L.iql_train(cfg, ic, s, n), 2),
        "turn-based Q": (L.altq_init(cfg, key(2), DET_LANES, cpu),
                         lambda s, n: L.altq_train(cfg, ac, s, n), 1),
        "mixture minimax-Q 5x4+6x5": (
            L.multigrid_minimax_init(mix, key(3), DET_LANES, cpu),
            lambda s, n: L.multigrid_minimax_train(mix, mc, s, n), 1),
    }


def learners_equal_cpu(torch, dev, card):
    """The four HBM-table learners (``_learner_runs``) for DET_STEPS steps
    from step 0 (two re-solve periods, each a 64-step CUDA-graph replay)
    on the card and on the CPU from one state: every state leaf bit-equal,
    A1 launched its count a step; each step's mean |TD| apart only in its
    reduction's last bits (printed)."""
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.ops import scatter_kernel as sc
    for name, (st, train, per_step) in _learner_runs(torch, dev).items():
        card_st = L._rebuild(st, [t.to(dev) for t in L._tensors(st)])
        torch.cuda.synchronize()
        sc.reset_launch_counts()
        t0 = time.perf_counter()
        got, gtd = train(card_st, DET_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        a1 = sc.launch_counts[SCATTER]
        t0 = time.perf_counter()
        want, wtd = train(st, DET_STEPS)
        cpu_wall = time.perf_counter() - t0
        leaves = list(zip(L._tensors(got), L._tensors(want)))
        bad = [i for i, (x, y) in enumerate(leaves)
               if not bits_equal(x.cpu(), y)]
        td = float(((gtd.cpu() - wtd).abs() / (1 + wtd.abs())).max())
        td_bits = int((gtd.cpu().view(torch.int32)
                       != wtd.view(torch.int32)).sum())
        print(f"[determinism] {name} {DET_LANES} lanes x {DET_STEPS} steps: "
              f"all {len(leaves)} state leaves bit-equal to the CPU's "
              f"{not bad} (differing: {bad}); the per-step mean |TD| "
              f"differs in {td_bits} of {DET_STEPS} steps, by at most "
              f"{td} relative to 1 + |TD|; A1 {a1} launches; {wall} s on "
              f"the card, {cpu_wall} s on the CPU | {card}")
        check(not bad and a1 == per_step * DET_STEPS and td <= GRAPH_TOL,
              f"{name}: the card's state differs from the CPU's in leaves "
              f"{bad}, or A1 launched {a1} times, or |TD| by {td}")


def entry_repeats(torch, dev, card, entry_exploitability=None):
    """The entry point's default mode (``ENTRY``) with ``--ckpt``, twice in
    this process: every leaf of the final state bit-equal and the same
    exploitability printed (and phase 39's, where given); then a third
    run stopped right after its checkpoint at step ENTRY_STOP, as a
    killed run would stop, and the same command resumed from that
    checkpoint to the end: its final state bit-equal to the uninterrupted
    run's, its exploitability the same."""
    import contextlib
    import io
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.examples import train_minimax
    from gym_soccer_tpu_torch.utils import checkpoint

    class Stopped(Exception):
        pass

    def run(ckpt, stop=None):
        out = io.StringIO()
        save = checkpoint.save_pytree

        def save_then_stop(path, tree):
            save(path, tree)
            if int(tree.step) >= stop:
                raise Stopped

        if stop is not None:
            checkpoint.save_pytree = save_then_stop
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                train_minimax.main(ENTRY + ["--ckpt", ckpt])
        except Stopped:
            pass
        finally:
            checkpoint.save_pytree = save
        torch.cuda.synchronize()
        lines = json_lines(out.getvalue())
        fin = [ln for ln in lines if ln.get("event") == "finished"]
        return lines, fin, time.perf_counter() - t0

    cfg = EnvConfig(5, 4, SLIP)
    envs, steps = (int(ENTRY[ENTRY.index(f) + 1]) for f in ("--envs",
                                                            "--steps"))
    tmpl = L.minimax_init(cfg, threefry.key(0), envs, dev)
    with build_tmpdir() as tmp:
        paths = [os.path.join(tmp, f"run{i}.npz") for i in range(3)]
        runs = [run(paths[0]), run(paths[1])]
        stopped = run(paths[2], stop=ENTRY_STOP)
        runs.append(run(paths[2]))
        states = [checkpoint.load_pytree(p, tmpl) for p in paths]
    for lines, fin, _ in runs:
        check(len(fin) == 1 and fin[0]["steps"] == steps,
              f"entry point: {lines}")
    ex = [fin[0]["exploitability"] for _, fin, _ in runs]
    check(stopped[2] > 0 and not stopped[1]
          and runs[2][0][0] == {"event": "resumed", "step": ENTRY_STOP},
          f"the stopped run: {stopped[0]}; the resumed: {runs[2][0][:1]}")

    def same(a, b):
        leaves = list(zip(L._tensors(a), L._tensors(b)))
        return [i for i, (x, y) in enumerate(leaves) if not bits_equal(x, y)]

    twice, resumed = same(states[0], states[1]), same(states[0], states[2])
    print(f"[determinism] the entry point {' '.join(ENTRY)} twice: final "
          f"state bit-equal {not twice} (differing leaves {twice}), "
          f"exploitability {ex[0]} and {ex[1]} (phase 39: "
          f"{entry_exploitability}); stopped after its step-{ENTRY_STOP} "
          f"checkpoint ({stopped[2]} s) and resumed from --ckpt: bit-equal "
          f"to the uninterrupted run {not resumed} (differing {resumed}), "
          f"exploitability {ex[2]}; walls {[r[2] for r in runs]} s | {card}")
    check(not twice and not resumed and ex[0] == ex[1] == ex[2]
          and entry_exploitability in (None, ex[0]),
          f"the entry point is not repeatable: leaves {twice} / {resumed}, "
          f"exploitability {ex} (phase 39 {entry_exploitability})")


def build_tmpdir():
    """A temporary directory under the checkout's build/ (which .gitignore
    lists), removed when its ``with`` block ends."""
    import tempfile
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "gym_soccer_tpu_torch")
    os.makedirs(build, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=build)


def _tree_leaves(tree) -> list:
    """The leaves of a checkpoint tree, in the checkpoint's order."""
    from gym_soccer_tpu_torch.utils import checkpoint
    return [x for x, _ in checkpoint._flatten(tree)]


def _trees_equal(a, b) -> bool:
    """Two trees' leaves equal: tensors bit for bit, the rest by ==."""
    import torch
    la, lb = _tree_leaves(a), _tree_leaves(b)
    return len(la) == len(lb) and all(
        bits_equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _zeros_tree(tree):
    """``tree`` with every tensor zeroed, the other leaves kept."""
    import torch
    from gym_soccer_tpu_torch.utils import checkpoint
    return checkpoint._unflatten(tree, iter(
        torch.zeros_like(x) if isinstance(x, torch.Tensor) else x
        for x in _tree_leaves(tree)))


def orbax_on_card(torch, dev, card):
    """``save_orbax`` / ``load_orbax`` on the card: ``fused_minimax_train``
    (K5) at 8192 lanes, 1 chunk of 64 steps saved and loaded into a zeroed
    CUDA template and resumed for 1, bit-equal to 2 chunks at once; the
    loaded dict bit-equal to the saved one, on the card, the template
    untouched; an HBM-table learner state (key words) round-trips."""
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    from gym_soccer_tpu_torch.utils import checkpoint
    cfg = EnvConfig(5, 4, SLIP)
    kw = dict(batch=B, chunk_len=64, lr=1.0, eps=0.2, eps_halflife=8,
              return_state=True, device=dev)

    *_, whole = lk.fused_minimax_train(cfg, n_chunks=2, **kw)
    *_, r = lk.fused_minimax_train(cfg, n_chunks=1, **kw)
    st = L.minimax_init(cfg, threefry.key(5), B, dev)
    with build_tmpdir() as tmp:
        t0 = time.perf_counter()
        checkpoint.save_orbax(os.path.join(tmp, "fused"), r)
        save_s = time.perf_counter() - t0
        tmpl = _zeros_tree(r)
        t0 = time.perf_counter()
        got = checkpoint.load_orbax(os.path.join(tmp, "fused"), tmpl)
        load_s = time.perf_counter() - t0
        checkpoint.save_orbax(os.path.join(tmp, "learner"), st)
        back = checkpoint.load_orbax(os.path.join(tmp, "learner"),
                                     _zeros_tree(st))
    on_card = all(x.device == dev for x in _tree_leaves(got)
                  if isinstance(x, torch.Tensor))
    untouched = all(not bool(x.any()) for x in _tree_leaves(tmpl)
                    if isinstance(x, torch.Tensor))
    *_, part = lk.fused_minimax_train(
        cfg, n_chunks=1, init=(got["q"], got["v"], got["pi_a"], got["pi_b"],
                               got["n"]), fields_init=got["fields"],
        start_chunk=got["next_chunk"], **kw)
    ok = (_trees_equal(got, r), on_card, untouched, _trees_equal(part, whole),
          _trees_equal(back, st) and back.env.key.device == dev)
    print(f"[orbax] fused_minimax_train {B} x 64, resume dict on the card: "
          f"save_orbax {save_s} s, load_orbax {load_s} s; loaded bit-equal, "
          f"on the card, template untouched, resumed chunk equal to 2 "
          f"chunks at once, learner state with its key words round-trips: "
          f"{ok} | {card}")
    check(all(ok), f"the orbax pair on the card: {ok}")



# ----------------------------------------------------------------------
# Phase 51: S2 and S3, the mixed-geometry and alternating engines' steps
# ----------------------------------------------------------------------

def mixed_start(torch, cfgs, lanes, dev, seed):
    """``lanes`` lanes of the mixture ``cfgs`` after 8 steps of
    ``step_plain`` without autoreset from ``key(seed)`` (the lanes that
    scored stay in their goal states), every 5th counter at 2**31 - 3
    (the draws' counters wrap) and every 7th clock one step from
    truncation; on ``dev``."""
    import numpy as np
    from gym_soccer_tpu_torch.core import multigrid as mg
    from gym_soccer_tpu_torch.core import threefry
    rng = np.random.default_rng(seed)
    st = mg.init(tuple(cfgs), threefry.key(seed), lanes, dev)
    for _ in range(8):
        aa, ab = (torch.as_tensor(rng.integers(0, 5, lanes), device=dev)
                  for _ in range(2))
        st, _ = mg.step_plain(st, aa, ab, autoreset=False)
    n, t = st.n.clone(), st.t.clone()
    n[::5] = 2 ** 31 - 3
    t[1::7] = st.geo.max_steps - 1
    return st._replace(n=n, t=t)


def alt_start(torch, cfg, lanes, dev, seed):
    """``lanes`` alternating lanes after 8 ticks of ``alt_step_plain``
    without autoreset from ``key(seed)``, the mover flipped on every 3rd
    lane, A in its goal with the ball on every 11th (goals do not absorb
    here), counters and clocks as ``mixed_start``'s; on ``dev``."""
    import numpy as np
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    rng = np.random.default_rng(seed)
    st = alt.alt_init(cfg, threefry.key(seed), lanes, seed % 2, dev)
    for _ in range(8):
        st, _ = alt.alt_step_plain(cfg, st, torch.as_tensor(
            rng.integers(0, 5, lanes), device=dev), autoreset=False)
    ra, ca, rb, cb, p, turn, t, n = (f.clone() for f in st[:8])
    turn[::3] = 1 - turn[::3]
    ra[::11], ca[::11], rb[::11], cb[::11], p[::11] = (
        cfg.goal_row_bounds[0], cfg.W - 1, 0, 1, 0)
    n[::5] = 2 ** 31 - 3
    t[1::7] = cfg.max_steps - 1
    return alt.AltEnvState(ra, ca, rb, cb, p, turn, t, n, st.key)


class _PlainEngines:
    """Within the block, ``multigrid.step_obs`` and ``alt_step_obs`` are
    their plain versions (the learners' engines before S2 and S3)."""

    def __enter__(self):
        from gym_soccer_tpu_torch.core import multigrid as mg
        from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
        self.saved = mg.step_obs, alt.alt_step_obs
        mg.step_obs, alt.alt_step_obs = mg.step_obs_plain, \
            alt.alt_step_obs_plain

    def __exit__(self, *exc):
        from gym_soccer_tpu_torch.core import multigrid as mg
        from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
        mg.step_obs, alt.alt_step_obs = self.saved


def mixed_alt_counts(torch, dev, card):
    """Phase 51's launch counts, taken early in the process (where the
    profiler records every launch): device operations a call
    (``device_ops``) at 8192 lanes of the mixed-geometry engine's
    observing step on tools/bench_all's mixture and of the alternating
    engine's on 5x4 slip 0.2, each as its plain version (the previous
    design) and as S2 / S3, and of an eager learner step of multigrid
    minimax-Q (the entry point's lr and eps, no re-solve), multigrid IQL
    and turn-based Q on their engines before (``_PlainEngines``) and after.
    S2's and S3's steps must be one operation each."""
    from gym_soccer_tpu_torch.agents import learners as L
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import multigrid as mg
    from gym_soccer_tpu_torch.core import threefry
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    cfgs = tuple(EnvConfig(*b) for b in S2_MIXTURES[S23_TIMED])
    codec = mg.build_codec(cfgs)
    cfg = EnvConfig(5, 4, SLIP)
    st = mixed_start(torch, cfgs, B, dev, 1)
    ast = alt_start(torch, cfg, B, dev, 2)
    acts = torch.randint(0, 5, (2, B), device=dev)
    lcfg = L.MinimaxQConfig(lr=0.3, eps=0.3, resolve_every=64,
                            solver_iters=200, lr_halflife=400,
                            eps_halflife=666)
    eng = L._multigrid_engine(codec)
    mst = L.multigrid_minimax_init(cfgs, threefry.key(0), B, dev)
    ist = L.multigrid_iql_init(cfgs, threefry.key(1), B, dev)
    qst = L.altq_init(cfg, threefry.key(2), B, dev)
    steps = {
        "mixed engine step": lambda i: mg.step_obs(codec, st, *acts),
        "alternating engine step": lambda i: alt.alt_step_obs(cfg, ast,
                                                              acts[0]),
        "multigrid minimax-Q step": lambda i: L._minimax_step_engine(
            eng, lcfg, mst, i),
        "multigrid IQL step": lambda i: L._iql_step_engine(
            eng, L.IQLConfig(), ist),
        "turn-based Q step": lambda i: L._altq_step(cfg, L.AltQConfig(),
                                                    qst, None, None),
    }
    counts = {}
    for name, fn in steps.items():
        with _PlainEngines():
            counts[name + ", plain"] = device_ops(torch, fn)
        counts[name + ", S2/S3"] = device_ops(torch, fn)
    print(f"[S2/S3] device operations a call (torch.profiler, 3 calls after "
          f"a warm-up, early in the process; {B} lanes; the mixture "
          f"{S23_TIMED}, 5x4 slip 0.2): {counts} | {card}")
    check(counts["mixed engine step, S2/S3"] == 1
          and counts["alternating engine step, S2/S3"] == 1,
          f"S2's or S3's step is not one operation: {counts}")
    return counts


def _step_outputs(res, n_fields):
    """The tensors an engine step computes: the new state's ``n_fields``
    fields (not its key or geometry), the step's outputs and, from an
    observing step, (obs, final_obs)."""
    return [*res[0][:n_fields], *res[1], *(res[2] if len(res) > 2 else ())]


def _same(torch, got, want):
    """(bit-equal, max abs err) of two sequences of tensors."""
    same = all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    return same, err


def mixed_alt_phase(torch, dev, card, instructions, counts):
    """Phase 51: S2 (``multigrid.step`` / ``step_obs`` on the card) and S3
    (``alt_step`` / ``alt_step_obs``) against their plain versions on the
    card, bit for bit in every output, at S23_LANES x S23_STEPS from
    ``mixed_start`` / ``alt_start``, autoreset on and off, each step's
    actions int32 and int64 in turn and S2's observations written on half
    the steps, one launch a step: S2 on every mixture of S2_MIXTURES, S3 on
    S3_BOARDS at slip 0.2; each captured once in a CUDA graph and replayed,
    equal to its eager call; S2, S3, their plain versions and S1 timed
    (call ms, and device ms by CUDA-graph replay) at 8192 lanes on the
    S23_TIMED mixture, 5x4 and 5x4; their bounds from their SASS; the
    launch counts of ``mixed_alt_counts``.  Returns ({S2, S3: max abs
    err}, their ms and plain ms, {S2, S3: (lanes, bytes)})."""
    import numpy as np
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.core import batch, rules, threefry
    from gym_soccer_tpu_torch.core import multigrid as mg
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk
    from gym_soccer_tpu_torch.ops import mixed_alt_variants as mv
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(51)
    errs = {S2: 0.0, S3: 0.0}
    seen = {"goal lanes": 0, "goals": 0, "truncated": 0}

    def run(kernel, name, step, plain, prev, start, n_acts, goal_lanes):
        n_fields = 7 if kernel == S2 else 8
        st = start
        seen["goal lanes"] += goal_lanes
        for k in range(S23_STEPS):
            acts = torch.randint(0, 5, (n_acts, S23_LANES),
                                 generator=gen).to(dev)
            acts = acts if k % 2 else acts.int()
            mk.reset_launch_counts()
            got = step(k, st, acts)
            check(mk.launch_counts[kernel] == 1,
                  f"{kernel} not launched once a step")
            want = _step_outputs(plain(k, st, acts), n_fields)
            same, err = _same(torch, _step_outputs(got, n_fields), want)
            errs[kernel] = max(errs[kernel], err)
            check(same, f"{kernel} != its plain version on {name}, step "
                        f"{k}: max abs err {err}")
            ints, rew, flags = prev(k, st, acts)
            obs = ints[n_fields:] if k % 4 < 2 else ()
            same, err = _same(torch, [*ints[:n_fields], rew, *flags, *obs],
                              want)
            check(same, f"{kernel}'s previous design != its plain version "
                        f"on {name}, step {k}: max abs err {err}")
            seen["goals"] += int(got[1][1].sum())
            seen["truncated"] += int(got[1][2].sum())
            st = got[0]

    for name, mix in S2_MIXTURES.items():
        cfgs = tuple(EnvConfig(*b) for b in mix)
        codec = mg.build_codec(cfgs)
        for auto in (True, False):
            def step(k, st, acts, plain=False):
                if k % 4 < 2:
                    return (mg.step_obs_plain if plain else mg.step_obs)(
                        codec, st, acts[0], acts[1], auto)
                return (mg.step_plain if plain else mg.step)(
                    st, acts[0], acts[1], auto)
            def prev(k, st, acts):
                geo = st.geo
                return mv.multigrid_step_on(
                    mv.PREVIOUS, st[:7], st.key, acts[0], acts[1],
                    (geo.H, geo.W, geo.glo, geo.ghi, geo.vid, geo.slip),
                    geo.max_steps, auto,
                    mg._codec_on(codec.cfgs, dev) if k % 4 < 2 else None)
            start = mixed_start(torch, cfgs, S23_LANES, dev, len(name))
            goals = int(rules.is_goal_state(torch, *start[:5],
                                            start.geo).sum())
            run(S2, f"{name} autoreset {auto}", step,
                lambda k, st, a: step(k, st, a, plain=True), prev, start, 2,
                goals)
    for w, h in S3_BOARDS:
        cfg = EnvConfig(w, h, SLIP)
        for auto in (True, False):
            def step(k, st, acts, plain=False):
                if k % 4 < 2:
                    return (alt.alt_step_obs_plain if plain
                            else alt.alt_step_obs)(cfg, st, acts[0], auto)
                return (alt.alt_step_plain if plain else alt.alt_step)(
                    cfg, st, acts[0], auto)
            def prev(k, st, acts):
                return mv.alt_step_on(mv.PREVIOUS, cfg, st[:8], st.key,
                                      acts[0], auto)
            start = alt_start(torch, cfg, S23_LANES, dev, w)
            run(S3, f"{w}x{h} autoreset {auto}", step,
                lambda k, st, a: step(k, st, a, plain=True), prev, start, 1,
                S23_LANES // 11 + 1)
    check(all(seen.values()), f"S2/S3's cases missed a kind of lane: {seen}")
    print(f"[S2/S3] bit-equal to their plain versions on the card in every "
          f"output, and so is their previous design ({S23_PREV_SRC}): S2 on "
          f"{list(S2_MIXTURES)}, S3 on "
          f"{[f'{w}x{h}' for w, h in S3_BOARDS]} slip {SLIP}, autoreset on "
          f"and off, {S23_LANES} lanes x {S23_STEPS} steps, int32 and int64 "
          f"actions, one launch a step; max abs err {errs}; {seen}; "
          f"{time.perf_counter() - t0} s | {card}")

    # the observing steps at 8192 lanes: eager, from a graph, timed
    cfgs = tuple(EnvConfig(*b) for b in S2_MIXTURES[S23_TIMED])
    codec = mg.build_codec(cfgs)
    cfg = EnvConfig(5, 4, SLIP)
    mst = mixed_start(torch, cfgs, B, dev, 99)
    ast = alt_start(torch, cfg, B, dev, 98)
    est = batch.init(cfg, threefry.key(97), B, dev)
    aa, ab = (torch.as_tensor(x, device=dev) for x in
              np.random.default_rng(7).integers(0, 5, (2, B)))
    calls = {S2: lambda: mg.step_obs(codec, mst, aa, ab),
             S2 + "_plain": lambda: mg.step_obs_plain(codec, mst, aa, ab),
             S3: lambda: alt.alt_step_obs(cfg, ast, aa),
             S3 + "_plain": lambda: alt.alt_step_obs_plain(cfg, ast, aa),
             S1: lambda: batch.step(cfg, est, aa, ab)}
    for name, n_fields in ((S2, 7), (S3, 8)):
        eager = _step_outputs(calls[name](), n_fields)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = _step_outputs(calls[name](), n_fields)
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        check(_same(torch, captured, eager)[0],
              f"{name} replayed from a CUDA graph != its eager call")
        del graph
    ms, device_ms = {}, {}
    for name, fn in calls.items():
        ms[name] = time_cuda(fn)[0]
        device_ms[name] = _graph_ms(
            torch, fn, PLAIN_GRAPH_CALLS if "plain" in name
            else S1_GRAPH_CALLS)
    r2d, offsets = mg._codec_on(codec.cfgs, dev)
    nbytes = {S2: B * (7 * 4 + 2 * 8 + 2 * 8 + 5 * 4 + 4 + 9 * 4 + 4 + 2)
              + (r2d.numel() + offsets.numel()) * 4,
              S3: B * (8 * 4 + 2 * 8 + 8 + 10 * 4 + 4 + 2)
              + alt.alt_device_maps(cfg, dev).numel() * 4
              + ctypes.sizeof(mk.AltReset)}
    from gym_soccer_tpu_torch.ops import _build
    regs = ptxas_registers(
        _build.build("mixed_alt_kernel").with_suffix(".log").read_text())
    for name, sym, where in ((S2, S2_SYMBOL, f"the {S23_TIMED} mixture"),
                             (S3, S3_SYMBOL, "5x4")):
        bound_ms, bound_by = bound(B, instructions[name], nbytes[name])
        print(f"[{'S2' if name == S2 else 'S3'}] {B} lanes on {where} "
              f"(autoreset, observations, int64 actions): "
              f"{mk.LANES_PER_BLOCK} lanes "
              f"a block, {[r for k, r in regs.items() if sym in k]} "
              f"registers, {instructions[name]} SASS instructions on the "
              f"shortest way through a lane, {nbytes[name]} B; bound "
              f"{bound_ms} ms ({bound_by}); {ms[name]} ms a call, "
              f"{device_ms[name]} ms of device time (CUDA-graph replay of "
              f"{S1_GRAPH_CALLS} calls), against the plain version's "
              f"{ms[name + '_plain']} ms a call and "
              f"{device_ms[name + '_plain']} ms of device time "
              f"({PLAIN_GRAPH_CALLS} calls a replay) and S1's "
              f"{device_ms[S1]} ms of device time ({ms[S1]} ms a call) on "
              f"5x4 | {card}")
    print(f"[S2/S3] device operations a call: {counts} | {card}")
    redesign_timings(torch, dev, card, instructions, regs, nbytes)
    print(f"[phase 51] {time.perf_counter() - t0} s")
    return errs, {**{k: v for k, v in ms.items() if k != S1},
                  S2 + "_device": device_ms[S2],
                  S3 + "_device": device_ms[S3]}, \
        {S2: (B, nbytes[S2]), S3: (B, nbytes[S3])}


def redesign_timings(torch, dev, card, instructions, regs, nbytes):
    """Phase 51's timing of the redesign (ops/mixed_alt_variants): on each
    of its CASES (S3 at S23_WIDTHS[S3] lanes, S2 at S23_WIDTHS[S2]), the
    learners' step on S2 or S3 as the wrapper launches it, built at each
    other of S23_SHAPES, on the previous design and as the plain version,
    each bit-equal to the plain version; the device ms a call of each and
    of the empty kernel at each shape by CUDA-graph replay (legs of
    S23_LEG_MS), in S23_ROUNDS turns (every call in one order, then in the
    other), as the mean and the range of the turns, and each design's time
    above the floor at its own shape, turn by turn; the plain version's
    once.  Then a design line of the
    kernel and of the previous design: lanes a block, registers, SASS on
    the shortest way through a lane, bytes and bound at 8192 lanes."""
    from gym_soccer_tpu_torch.ops import mixed_alt_kernel as mk
    from gym_soccer_tpu_torch.ops import mixed_alt_variants as mv
    check(mv.SHAPES == S23_SHAPES and mv.ROUNDS == S23_ROUNDS and
          {k: tuple(c[2] for c in mv.CASES.values() if c[0] == k)
           for k in (S3, S2)} == S23_WIDTHS,
          "mixed_alt_variants' shapes, turns or widths differ from S23_*")
    for case in mv.CASES:
        calls = mv.case_calls(case, dev)
        want = mv.outputs(calls["plain"]())
        for name, fn in calls.items():
            if not name.startswith("floor") and name != "plain":
                check(_same(torch, mv.outputs(fn()), want)[0],
                      f"{case}: {name} != the plain version")
        ms, above = mv.summary(mv.time_in_turns(
            calls, lambda fn, n: _graph_ms(torch, fn, n, S23_LEG_MS)))
        verdict = ("faster than" if ms["kernel"][0] < ms[mv.PREVIOUS][0]
                   else "NOT faster than")
        shapes = {t: ms[f"kernel, {t} lanes a block"
                        if t != mk.LANES_PER_BLOCK else "kernel"][0]
                  for t in mv.SHAPES}
        print(f"[S2/S3 redesign] {case}: device ms a call by CUDA-graph "
              f"replay, (mean, min, max) of {mv.ROUNDS} turns (the plain "
              f"version one): the kernel "
              f"({mk.LANES_PER_BLOCK} lanes a block) {ms['kernel']}, "
              f"{verdict} the previous design's ({mv.PREV_THREADS}) "
              f"{ms[mv.PREVIOUS]}; the plain version {ms['plain']}; the "
              f"empty kernel {{lanes a block: ms}} "
              f"{ {t: ms[f'floor, {t} lanes a block'] for t in mv.SHAPES} }; "
              f"each shape's mean {shapes}; above the floor at the same "
              f"lanes a block, turn by turn {above}; every design bit-equal "
              f"to the plain version | {card}")
    prev_path = mv.build_previous()
    prev_regs = ptxas_registers(prev_path.with_suffix(".log").read_text())
    prev_text = sass_listing(prev_path)
    for name, sym in ((S2, S2_SYMBOL), (S3, S3_SYMBOL)):
        prev_ins = next(iter(path_instructions(prev_text, [sym]).values()))
        new_b = bound(B, instructions[name], nbytes[name])
        prev_b = bound(B, prev_ins, nbytes[name])
        print(f"[{'S2' if name == S2 else 'S3'} design] {B} lanes: the kernel "
              f"{mk.LANES_PER_BLOCK} lanes a block at every width, "
              f"{[r for k, r in regs.items() if sym in k]} registers, "
              f"{instructions[name]} SASS on the shortest way through a "
              f"lane, bound {new_b[0]} ms ({new_b[1]}); the previous design "
              f"{mv.PREV_THREADS} lanes a block, "
              f"{[r for k, r in prev_regs.items() if sym in k]} registers, "
              f"{prev_ins} SASS, bound {prev_b[0]} ms ({prev_b[1]}); "
              f"{nbytes[name]} B | {card}")


def mixed_alt_block(torch, dev, card, instructions, counts):
    """``--phases 51`` alone: phase 51, then what earlier phases check of
    S2 and S3 where the whole script runs them: phase 42's turn-based and
    mixture learning checks (their launches counted), phase 50's four
    HBM-table learners against the CPU (``learners_equal_cpu``) and phase
    49's three rows that step S2 or S3 (``tools_phase``)."""
    mixed_alt_phase(torch, dev, card, instructions, counts)
    t0 = time.perf_counter()
    learning_checks(torch, dev, card, only=(
        "turn-based Q vs frozen", "turn-based Q", "mixture minimax-Q"))
    print(f"[phase 42] S2's and S3's checks {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    learners_equal_cpu(torch, dev, card)
    print(f"[phase 50] the learners {time.perf_counter() - t0} s")
    tools_phase(torch, dev, card, rows=(
        "xla_multigrid_mixed", "xla_alternating_engine", "xla_altq_learner"))


if __name__ == "__main__":
    sys.exit(main())
