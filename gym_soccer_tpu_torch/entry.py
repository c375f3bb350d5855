"""The port's twin of the JAX package's ``__graft_entry__.entry()``.

``entry(device)`` returns ``(fn, example_args)``: ``fn(*example_args)``
runs one packed minimax-Q learner chunk (``packed_learner_chunk``, kernel
K5 on the card: act, batched env transition and Bellman-residual
accumulation in one launch) on 5x4 at slip 0.2, from the default trainer's
chunk-0 table (``pack_m2`` of uniform policies, v = 0, exploration eps
0.2) and its initial state fields.  On the card it runs the JAX package's
TPU shape, 8192 lanes x 64 steps; on the CPU (``device="cpu"``) 256 x 4,
the JAX entry's off-TPU shape, through the plain version.

``dryrun_multichip(n_devices, device)`` spawns ``n_devices`` ranks
(parallel/mesh ``spawn``: NCCL on the card, one device a rank; gloo on the
CPU) and runs every check of the JAX entry's: one data-parallel minimax-Q
training call, the four data-parallel fused chunks (minimax, turn-based,
independent-Q, the mixture) with their visit counts, the state-sharded
re-solve against the replicated one and the exact resume across a save;
and, beyond the JAX entry's, the grouped mode against the per-chunk mode
(on the card its all-reduces captured in the CUDA graph).
"""
from __future__ import annotations

import torch

from .config import EnvConfig
from .core import tables
from .ops import learner_kernel as lk

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)
CARD_SHAPE = (8192, 64)
CPU_SHAPE = (256, 4)


def entry(device="cuda"):
    """(fn, (seed, table, fields)) for one K5 chunk on ``device``; fn
    returns ``packed_learner_chunk``'s (fields, (sums, cnt), stats)."""
    device = torch.device(device)
    B, T = CARD_SHAPE if device.type == "cuda" else CPU_SHAPE
    nS = tables.build_statespace(CFG).nS
    uniform = torch.full((nS, 5), 0.2, dtype=torch.float32, device=device)
    table = lk.pack_m2(CFG, uniform, uniform,
                       torch.zeros(nS, dtype=torch.float32, device=device),
                       0.2)
    fields = lk.init_state_fields(CFG, B, device)

    def fn(seed, table, fields):
        return lk.packed_learner_chunk(CFG, seed, table, fields, B, T)

    return fn, (0, table, fields)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The twin of ``__graft_entry__.dryrun_multichip``: ``n_devices``
    ranks (on CUDA at most ``torch.cuda.device_count()``, else
    ValueError) each run ``_dryrun_rank``; rank 0's summary is printed as
    the JAX entry prints it.  Raises if a rank fails a check."""
    from .parallel import mesh as pmesh
    device = torch.device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need as many CUDA devices; "
                         f"{torch.cuda.device_count()} present")
    out = pmesh.spawn(_dryrun_rank, n_devices, device=device.type)
    print("dryrun_multichip ok:", n_devices, "devices, td:", out[0],
          "+ fused DP chunks (minimax/altq/iql/multigrid) + sharded solve"
          " + sharded exact resume")


def _dryrun_rank(mesh) -> list:
    """One rank of ``dryrun_multichip``; returns the training call's TD
    summary (the same on every rank)."""
    from .agents import learners
    from .agents.learners import solve_matrix_games
    from .core import threefry
    from .envs.soccer_alternating_env import build_alt_tables
    from .ops import altq_kernel as ak
    from .ops import iql_kernel as ik
    from .parallel import mesh as pmesh

    def check(cond, what):
        if not cond:
            raise AssertionError(f"rank {mesh.rank}: {what}")

    dev, n = mesh.device, mesh.world
    f32 = dict(dtype=torch.float32, device=dev)
    nS = tables.build_statespace(CFG).nS
    lcfg = learners.MinimaxQConfig(resolve_every=2)
    state = learners.MinimaxQState(
        q=torch.zeros((nS, 5, 5), **f32), v=torch.zeros(nS, **f32),
        pi_a=torch.full((nS, 5), 0.2, **f32),
        pi_b=torch.full((nS, 5), 0.2, **f32),
        env=pmesh.sharded_init(CFG, mesh, threefry.key(0), 8 * n),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        n=torch.zeros((nS, 5, 5), **f32))
    train = pmesh.sharded_minimax_train_fn(CFG, lcfg, mesh, n_steps=2)
    state, td = train(state)
    check(tuple(state.q.shape) == (nS, 5, 5), "q's shape")

    # The fused chunks over the mesh, psum'd accumulators.
    B, T = 128 * n, 2
    uni = torch.full((nS, 5), 0.2, **f32)
    m = lk.pack_m(CFG, uni, uni, torch.zeros((nS, 5, 5), **f32),
                  torch.zeros(nS, **f32), 0.3)
    fields = pmesh.shard_fields(lk.init_state_fields(CFG, B, dev), mesh, B)
    _, acc, _ = pmesh.sharded_learner_chunk_fn(CFG, mesh, B, T)(0, m, fields)
    check(int(acc[1].sum()) == B * T, "fused DP visit count")

    # The state-sharded re-solve equals the replicated one bit for bit.
    want = solve_matrix_games(state.q, iters=40)
    got = pmesh.sharded_solve_fn(mesh, iters=40)(state.q)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "sharded solve diverged from replicated solve")

    # (a) the turn-based chunk, (b) the independent-Q chunk
    nSa = build_alt_tables(CFG).nS
    ma = ak.pack_alt_table(CFG, torch.zeros((nSa, 5), **f32))
    fa = pmesh.shard_fields(ak.init_alt_state_fields(CFG, B, dev), mesh, B)
    _, acca, _ = pmesh.sharded_altq_chunk_fn(CFG, mesh, B, T)(
        0, int(0.3 * 65536), ma, fa, 0)
    check(int(acca[1].sum()) == B * T, "sharded altq visits")
    mi = ik.pack_iql_table(CFG, torch.zeros((nS, 5), **f32),
                           torch.zeros((nS, 5), **f32))
    fi = pmesh.shard_fields(ik.init_iql_state_fields(CFG, B, dev), mesh, B)
    _, acci, _ = pmesh.sharded_iql_chunk_fn(CFG, mesh, B, T)(
        0, int(0.3 * 65536), mi, fi, 0)
    _, ca, _, cb = ik.unpack_iql_acc(CFG, acci)
    check(int(ca.sum()) == B * T and int(cb.sum()) == B * T,
          "sharded iql visits")

    # (c) the mixture's chunk, its planes the global batch's block
    cfgs = (CFG, EnvConfig(width=6, height=5, slip_prob=0.1))
    nSm = lk.n_states(cfgs)
    um = torch.full((nSm, 5), 0.2, **f32)
    mgm = lk.pack_m(cfgs, um, um, torch.zeros((nSm, 5, 5), **f32),
                    torch.zeros(nSm, **f32), 0.3)
    planes, fmg = lk.init_state_fields(cfgs, B, dev)
    _, accm, _ = pmesh.sharded_learner_chunk_fn(cfgs, mesh, B, T)(
        0, mgm, pmesh.shard_fields(fmg, mesh, B),
        pmesh.shard_fields(planes, mesh, B))
    check(int(accm[1].sum()) == B * T, "sharded multigrid visits")

    # (d) 1 + 1 chunks across a save and load equal 2, on the mesh.
    kw = dict(batch=B, chunk_len=T, lr=0.5, eps=0.4, solver_iters=20,
              seed=11, device=dev, mesh=mesh)
    qc = lk.fused_minimax_train(CFG, n_chunks=2, **kw)[0]
    r1 = lk.fused_minimax_train(CFG, n_chunks=1, return_state=True, **kw)[5]
    r1 = {k: (tuple(x.cpu() for x in v) if isinstance(v, tuple) else
              v.cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in r1.items()}   # the save and load
    q2 = lk.fused_minimax_train(
        CFG, n_chunks=1, init=(r1["q"], r1["v"], r1["pi_a"], r1["pi_b"],
                               r1["n"]),
        fields_init=r1["fields"], start_chunk=r1["next_chunk"], **kw)[0]
    check(torch.equal(q2, qc),
          "sharded resume diverged from uninterrupted sharded run")

    # (e) 3 chunks grouped two a replay (a remainder of one) equal 3 per
    # chunk, on the mesh.
    per = lk.fused_minimax_train(CFG, n_chunks=3, **kw)
    grouped = lk.fused_minimax_train(CFG, n_chunks=3, chunks_per_dispatch=2,
                                     **kw)
    check(all(torch.equal(a, b) for a, b in zip(per[:4], grouped[:4])),
          "sharded grouped run diverged from the per-chunk run")
    return [float(x) for x in td]
