"""Data parallelism over the env batch (gym_soccer_tpu_torch.parallel.mesh)
on the CPU, the plain versions running in place of the kernels.

At world size 1, in this process: every ``sharded_*`` function, and every
trainer with ``mesh=``, equals its call without a mesh bit for bit.

At 2 ranks: two gloo processes (``pmesh.spawn``, a FileStore in a new
temporary directory), spawned once for the module, run every check's rank
side and hand their results back through files; the references run here.

(a) the sharded chunks K5, K7, K6, K7 multigrid, K8, K9, K10 and K11: the
    all-reduced sums and counts equal the sum of the two shard-seed chunks
    run standalone, bit for bit; against the JAX package's 2-device
    ``sharded_*_chunk_fn`` (``shard_map`` of the kernels in interpret
    mode) the fields and counts are bit-equal, a mixture's per-variant
    counts (B / 2) * T, and the sums within cnt * (2**-8 * max|delta| +
    1e-6) (JAX rounds each visit to bfloat16);
(b) ``sharded_solve_fn`` at 761 states, padded to 381 games a rank: bit
    for bit the replicated ``solve_matrix_games``, and JAX's
    ``sharded_solve_fn`` within the RM+ tests' tolerance;
(c) ``sharded_{minimax,iql,altq}_train_fn`` from tools/demo_multihost.py's
    non-zero start table: the env states bit-equal to JAX's 2-device run
    and to the port's 1-process run over the whole batch; the tables
    bit-equal to JAX's (no schedules: a sum of two float32 values does
    not depend on its order) and within 1e-6 relative of the 1-process
    run (the float32 sums of a step's TDs are added in another order);
(d) the four trainers with ``mesh=``: per chunk equal to
    ``chunks_per_dispatch=3`` across a remainder, 1 + 1 chunks across a
    save and load equal to 2, and the twins of the JAX package's
    ``test_fused_train_on_mesh_learns`` and
    ``test_fused_altq_train_on_mesh_learns``;
(e) the orbax pair on torch.distributed.checkpoint: both ranks save
    their minimax resume dict (``blocks=("fields",)``) and load it back
    bit-equal, the run resumed from it equals the uninterrupted one, and
    one process loads the global batch, the ranks' blocks in rank order.
"""
import os

import numpy as np
import pytest
import torch

from gym_soccer_tpu_torch import interop
from gym_soccer_tpu_torch.agents import learners
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import batch as cbatch
from gym_soccer_tpu_torch.core import threefry
from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
from gym_soccer_tpu_torch.ops import altq_kernel as ak
from gym_soccer_tpu_torch.ops import iql_kernel as ik
from gym_soccer_tpu_torch.ops import learner_kernel as lk
from gym_soccer_tpu_torch.parallel import mesh as pmesh
from gym_soccer_tpu_torch.tools.demo_multihost import initial_q
from gym_soccer_tpu_torch.utils import checkpoint
from gym_soccer_tpu_torch.utils.policies import get_random_policy_array

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

W = 2                      # ranks
B, T = W * 256, 8          # the chunks' global lanes and steps
CFG = EnvConfig(5, 4, 0.2)
MIX = (CFG, EnvConfig(6, 5, 0.1))   # tests/test_sharded_fused.py:108
EPS_INT = int(0.3 * 65536)
SEED, OFFSET = 3, 37
# kernel -> (game, packed, mixture)
KERNELS = {"K5": ("minimax", True, False), "K7": ("minimax", False, False),
           "K6": ("minimax", True, True), "K7mg": ("minimax", False, True),
           "K8": ("iql", True, False), "K9": ("iql", False, False),
           "K10": ("altq", True, False), "K11": ("altq", False, False)}
N_ENVS, STEPS = 64, 12     # tools/demo_multihost.py's learner call
LEARNERS = ("minimax", "iql", "altq")
SOLVE_ITERS = 120
TB, TT = W * 128, 4        # the trainers' global lanes and chunk length
TRAINERS = ("minimax", "mixture", "best_response", "iql", "altq")
OPP = get_random_policy_array(761, 5, seed=42)


# ----------------------------------------------------------------------
# Inputs, made alike here and on every rank
# ----------------------------------------------------------------------

def _chunk_tables(kernel):
    """Numpy tables of the kernel's game from a seeded generator."""
    game, _, mix = KERNELS[kernel]
    cfg = MIX if mix else CFG
    rng = np.random.default_rng(7)
    if game == "minimax":
        nS = lk.n_states(cfg)
        return [rng.dirichlet(np.ones(5), nS).astype(np.float32),
                rng.dirichlet(np.ones(5), nS).astype(np.float32),
                rng.uniform(-1, 1, (nS, 5, 5)).astype(np.float32),
                rng.uniform(-1, 1, nS).astype(np.float32)]
    nS = (alt.build_alt_tables(cfg).nS if game == "altq"
          else lk.n_states(cfg))
    return [rng.uniform(-0.5, 0.5, (nS, 5)).astype(np.float32)
            for _ in range(1 if game == "altq" else 2)]


def _chunk_state(kernel):
    """(planes or None, fields) of the global batch on the CPU."""
    game, _, mix = KERNELS[kernel]
    if mix:
        return lk.init_state_fields(MIX, B, "cpu")
    init = {"minimax": lk.init_state_fields, "iql": ik.init_iql_state_fields,
            "altq": ak.init_alt_state_fields}[game]
    return None, init(CFG, B, "cpu")


def _chunk_fn(kernel, mesh):
    game, packed, mix = KERNELS[kernel]
    make = {"minimax": pmesh.sharded_learner_chunk_fn,
            "iql": pmesh.sharded_iql_chunk_fn,
            "altq": pmesh.sharded_altq_chunk_fn}[game]
    return make(MIX if mix else CFG, mesh, B, T, packed=packed)


def _run_chunk(kernel, mesh, table):
    """The kernel's sharded chunk on this rank's block."""
    game = KERNELS[kernel][0]
    planes, fields = _chunk_state(kernel)
    fields = pmesh.shard_fields(fields, mesh, B)
    fn = _chunk_fn(kernel, mesh)
    if game != "minimax":
        return fn(SEED, EPS_INT, table, fields, OFFSET)
    if planes is None:
        return fn(SEED, table, fields)
    return fn(SEED, table, fields, pmesh.shard_fields(planes, mesh, B))


def _solve_q():
    rng = np.random.default_rng(3)
    return torch.tensor(rng.uniform(-1, 1, (761, 5, 5)).astype(np.float32))


def _learner_state(game, mesh):
    """The learner's state from ``initial_q`` on ``N_ENVS`` global
    instances, this rank's block of them."""
    f32 = dict(dtype=torch.float32)
    if game == "altq":
        nS = alt.build_alt_tables(CFG).nS
        q0 = (np.arange(nS * 5, dtype=np.float32).reshape(nS, 5) % 17) \
            * np.float32(1e-2)
        env = pmesh.shard_env_state(
            alt.alt_init(CFG, threefry.key(0), N_ENVS, device="cpu"), mesh)
        return learners.AltQState(q=torch.tensor(q0), env=env,
                                  step=torch.zeros((), dtype=torch.int32))
    env = pmesh.sharded_init(CFG, mesh, threefry.key(0), N_ENVS)
    q0, v0 = initial_q(761)
    if game == "iql":
        return learners.IQLState(
            q_a=torch.tensor(q0[:, 0]), q_b=torch.tensor(q0[:, 1]), env=env,
            step=torch.zeros((), dtype=torch.int32))
    return learners.MinimaxQState(
        q=torch.tensor(q0), v=torch.tensor(v0),
        pi_a=torch.full((761, 5), 0.2, **f32),
        pi_b=torch.full((761, 5), 0.2, **f32), env=env,
        step=torch.zeros((), dtype=torch.int32),
        n=torch.zeros((761, 5, 5), **f32))


LCFG = {"minimax": learners.MinimaxQConfig(resolve_every=2),
        "iql": learners.IQLConfig(lr=0.5, eps=0.25),
        "altq": learners.AltQConfig(lr=0.5, eps=0.25)}


def _train_fn(game, mesh):
    make = {"minimax": pmesh.sharded_minimax_train_fn,
            "iql": pmesh.sharded_iql_train_fn,
            "altq": pmesh.sharded_altq_train_fn}[game]
    return make(CFG, LCFG[game], mesh, STEPS)


def _trainer(name, mesh, **kw):
    """One of the four trainers on ``TB`` global lanes under ``mesh``."""
    common = dict(batch=TB, chunk_len=TT, seed=11, device="cpu", mesh=mesh)
    if name in ("minimax", "mixture"):
        return lk.fused_minimax_train(
            MIX if name == "mixture" else CFG, lr=0.5, eps=0.4,
            eps_halflife=8, solver_iters=20, packed=name == "minimax",
            **common, **kw)
    if name == "best_response":
        return lk.fused_best_response_train(CFG, OPP, "player_a", eps=0.3,
                                            **common, **kw)
    fn = ik.fused_iql_train if name == "iql" else ak.fused_altq_train
    return fn(CFG, lr=0.5, eps=0.3, eps_halflife=16, **common, **kw)


def _resume_args(name, r):
    if name in ("minimax", "mixture"):
        return dict(init=(r["q"], r["v"], r["pi_a"], r["pi_b"], r["n"]))
    return dict(init={"best_response": (r.get("q"), r.get("n")),
                      "iql": (r.get("q_a"), r.get("q_b")),
                      "altq": r.get("q")}[name])


def _trainer_runs(name, mesh):
    """(per chunk, chunks_per_dispatch=3, 2 chunks, 1 + 1 chunks through
    a save and load) of a trainer under ``mesh``."""
    per = _trainer(name, mesh, n_chunks=4)
    grouped = _trainer(name, mesh, n_chunks=4, chunks_per_dispatch=3)
    whole = _trainer(name, mesh, n_chunks=2, return_state=True)
    r = _trainer(name, mesh, n_chunks=1, return_state=True)[-1]
    r = torch.load(_roundtrip(r), weights_only=False)   # the save and load
    part = _trainer(name, mesh, n_chunks=1, return_state=True,
                    fields_init=r["fields"], start_chunk=r["next_chunk"],
                    **_resume_args(name, r))
    return per, grouped, whole, part


def _roundtrip(obj):
    import io
    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return buf


def _learns(mesh):
    """The twins of test_fused_train_on_mesh_learns and
    test_fused_altq_train_on_mesh_learns at 256 lanes a rank."""
    kw = dict(batch=mesh.world * 256, n_chunks=10, chunk_len=8, lr=0.5,
              eps=0.3, device="cpu", mesh=mesh)
    q, v, pa, pb, _ = lk.fused_minimax_train(CFG, solver_iters=50, **kw)
    qa, _ = ak.fused_altq_train(CFG, **kw)
    return v, pa, qa


def _orbax(mesh, path):
    """A minimax resume dict after 1 chunk, saved by ``save_orbax`` under
    the mesh, what ``load_orbax`` gives back into a zeroed template, and
    the chunk resumed from that."""
    blocks = ("fields",)
    r = _trainer("minimax", mesh, n_chunks=1, return_state=True)[-1]
    checkpoint.save_orbax(path, r, mesh=mesh, blocks=blocks)
    zeros = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v)
             for k, v in r.items()}
    zeros["fields"] = tuple(torch.zeros_like(f) for f in r["fields"])
    got = checkpoint.load_orbax(path, zeros, mesh=mesh, blocks=blocks)
    part = _trainer("minimax", mesh, n_chunks=1, return_state=True,
                    fields_init=got["fields"], start_chunk=got["next_chunk"],
                    **_resume_args("minimax", got))[-1]
    return r, got, part


def _ranks(mesh, tables, ckpt):
    """One rank's side of every 2-rank check (runs in a spawned rank)."""
    return {
        "orbax": _orbax(mesh, ckpt),
        "chunks": {k: _run_chunk(k, mesh, tables[k]) for k in KERNELS},
        "solve": pmesh.sharded_solve_fn(mesh, SOLVE_ITERS)(_solve_q()),
        "learners": {g: _train_fn(g, mesh)(_learner_state(g, mesh))
                     for g in LEARNERS},
        "trainers": {n: _trainer_runs(n, mesh) for n in TRAINERS},
        "single": _trainer("minimax", mesh, n_chunks=4, single_dispatch=True),
        "learns": _learns(mesh),
        "replicated": pmesh.replicated(mesh, torch.full((3,), mesh.rank)),
    }


# ----------------------------------------------------------------------
# The JAX side and the port's tables from it
# ----------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp

    from gym_soccer_tpu.config import EnvConfig as JaxConfig
    from gym_soccer_tpu.ops import altq_kernel as jak
    from gym_soccer_tpu.ops import iql_kernel as jik
    from gym_soccer_tpu.ops import learner_kernel as jlk
    from gym_soccer_tpu.parallel import mesh as jmesh
    return jax, jnp, JaxConfig, jlk, jik, jak, jmesh


def _jcfg(mix):
    JaxConfig = _jax()[2]
    if mix:
        return tuple(JaxConfig(c.width, c.height, c.slip_prob) for c in MIX)
    return JaxConfig(5, 4, 0.2)


@pytest.fixture(scope="module")
def jax_chunks():
    """Each kernel's JAX M, the port's table read from it, and JAX's
    2-device sharded chunk on the same state."""
    jax, jnp, _, jlk, jik, jak, jmesh = _jax()
    mesh = jmesh.env_mesh(W)
    out = {}
    for kernel, (game, packed, mix) in KERNELS.items():
        jc, cfg = _jcfg(mix), MIX if mix else CFG
        arrays = [jnp.asarray(a) for a in _chunk_tables(kernel)]
        if game == "minimax":
            pa, pb, q, v = arrays
            m = (jlk.pack_m2(jc, pa, pb, v, 0.2) if packed
                 else jlk.pack_m(jc, pa, pb, q, v, 0.2))
            table = (interop.table_from_packed_m if packed
                     else interop.table_from_m)(cfg, np.asarray(m), "cpu")
            fn = jmesh.sharded_learner_chunk_fn(jc, mesh, B, T,
                                                interpret=True, packed=packed)
            if mix:
                planes, fields = jlk.init_state_fields(jc, B)
                res = fn(SEED, m, fields, planes)
            else:
                res = fn(SEED, m, jlk.init_state_fields(jc, B))
        else:
            if game == "iql":
                pack = jik.pack_iql_m2 if packed else jik.pack_iql_m
                init = jik.init_iql_state_fields
                make = jmesh.sharded_iql_chunk_fn
            else:
                pack = jak.pack_alt_m2 if packed else jak.pack_alt_m
                init = jak.init_alt_state_fields
                make = jmesh.sharded_altq_chunk_fn
            m = pack(jc, *arrays)
            table = interop.iql_table_from_packed_m(cfg, np.asarray(m),
                                                    packed, "cpu")
            fn = make(jc, mesh, B, T, interpret=True, packed=packed)
            res = fn(SEED, EPS_INT, m, init(jc, B), OFFSET)
        out[kernel] = (table, jax.block_until_ready(res))
    return out


@pytest.fixture(scope="module")
def orbax_path(tmp_path_factory):
    """The directory the ranks' orbax checkpoint is saved in."""
    return str(tmp_path_factory.mktemp("orbax") / "ckpt")


@pytest.fixture(scope="module")
def ranks(jax_chunks, orbax_path):
    """The two ranks' results, spawned once for the module."""
    tables = {k: v[0] for k, v in jax_chunks.items()}
    return pmesh.spawn(_ranks, W, (tables, orbax_path), device="cpu",
                       timeout=600)


# ----------------------------------------------------------------------
# World size 1
# ----------------------------------------------------------------------

def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _standalone_chunk(kernel, table, planes, fields, batch, seed,
                      global_batch=None):
    game, packed, mix = KERNELS[kernel]
    cfg = MIX if mix else CFG
    if game == "minimax":
        fn = {(True, False): lk.packed_learner_chunk,
              (True, True): lk.multigrid_packed_learner_chunk,
              (False, False): lk.learner_chunk,
              (False, True): lk.multigrid_learner_chunk}[packed, mix]
        args = (planes, fields) if mix else (fields,)
        return fn(cfg, seed, table, *args, batch, T,
                  global_batch=global_batch)
    fn = {("iql", True): ik.iql_packed_chunk, ("iql", False): ik.iql_chunk,
          ("altq", True): ak.altq_packed_chunk,
          ("altq", False): ak.altq_chunk}[game, packed]
    return fn(cfg, seed, EPS_INT, table, fields, batch, T, step_offset=OFFSET,
              global_batch=global_batch)


WORLD_ONE = [f"chunk-{k}" for k in KERNELS] + ["solve", "rollout"] + [
    f"train_fn-{g}" for g in LEARNERS] + [
    f"trainer-{n}-{mode}" for n in TRAINERS for mode in ("per", "grouped")
] + ["trainer-minimax-single"]


@pytest.mark.parametrize("case", WORLD_ONE)
def test_world_one_equals_no_mesh(case, jax_chunks):
    """A mesh of one rank, no process group: every sharded function and
    every trainer under it equals its call without a mesh, bit for bit."""
    one = pmesh.env_mesh(device="cpu")
    assert one.backend is None and one.world == 1 and one.capturable
    kind, _, rest = case.partition("-")
    if kind == "chunk":
        table = jax_chunks[rest][0]
        planes, fields = _chunk_state(rest)
        want = _standalone_chunk(rest, table, planes, fields, B, SEED)
        assert _equal(_run_chunk(rest, one, table), want)
    elif kind == "solve":
        want = learners.solve_matrix_games(_solve_q(), iters=SOLVE_ITERS)
        assert _equal(pmesh.sharded_solve_fn(one, SOLVE_ITERS)(_solve_q()),
                      want)
    elif kind == "rollout":
        pol = cbatch.random_policy_fn(CFG, threefry.key(1), N_ENVS)
        st = pmesh.sharded_init(CFG, one, threefry.key(0), N_ENVS)
        got_st, sums = pmesh.sharded_rollout_fn(CFG, one, pol, 20)(st)
        want_st, out = cbatch.rollout(
            CFG, cbatch.init(CFG, threefry.key(0), N_ENVS, "cpu"), pol, 20)
        assert _equal(got_st, want_st)
        assert [int(x) for x in sums] == [int(out.reward_a.sum()),
                                          int(out.done.sum()),
                                          int(out.truncated.sum())]
    elif kind == "train_fn":
        train = {"minimax": learners.minimax_train,
                 "iql": learners.iql_train, "altq": learners.altq_train}
        st = _learner_state(rest, one)
        want = train[rest](CFG, LCFG[rest], st, STEPS)
        assert _equal(_train_fn(rest, one)(st), want)
    else:
        name, mode = rest.split("-")
        kw = dict(n_chunks=3, return_state=True)
        if mode == "grouped":
            kw["chunks_per_dispatch"] = 2
        elif mode == "single":
            kw["single_dispatch"] = True
        assert _equal(_trainer(name, one, **kw), _trainer(name, None, **kw))


# ----------------------------------------------------------------------
# (a) the sharded chunks at 2 ranks
# ----------------------------------------------------------------------

def _unpack(kernel, acc, jax_side=False):
    game, packed, mix = KERNELS[kernel]
    if jax_side:
        _, _, _, jlk, jik, jak, _ = _jax()
        jc = _jcfg(mix)
        fn = {"minimax": jlk.unpack_acc2 if packed else jlk.unpack_acc,
              "iql": jik.unpack_iql_acc2 if packed else jik.unpack_iql_acc,
              "altq": jak.unpack_alt_acc2 if packed
              else jak.unpack_alt_acc}[game]
        return [np.asarray(a) for a in fn(jc, acc)]
    cfg = MIX if mix else CFG
    fn = {"minimax": lk.unpack_acc2, "iql": ik.unpack_iql_acc,
          "altq": ak.unpack_alt_acc}[game]
    return [a.numpy() for a in fn(cfg, acc)]


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_sharded_chunk_sums_equal_the_shard_chunks(kernel, ranks,
                                                   jax_chunks):
    """The all-reduced int64 sums, int32 counts and stats equal, on both
    ranks, the sum of the two shard-seed chunks run here standalone, bit
    for bit; each rank's fields are its standalone chunk's."""
    table = jax_chunks[kernel][0]
    planes, fields = _chunk_state(kernel)
    sums = cnt = stats = None
    for r in range(W):
        blk = slice(r * (B // W), (r + 1) * (B // W))
        f, (s, c), st = _standalone_chunk(
            kernel, table, None if planes is None else
            tuple(p[blk].clone() for p in planes),
            tuple(x[blk].clone() for x in fields), B // W,
            pmesh.shard_seed(SEED, r), global_batch=B)
        assert _equal(tuple(f), tuple(ranks[r]["chunks"][kernel][0]))
        sums = s if sums is None else sums + s
        cnt = c if cnt is None else cnt + c
        stats = st if stats is None else [a + b for a, b in zip(stats, st)]
    for r in range(W):
        _, (s, c), st = ranks[r]["chunks"][kernel]
        assert torch.equal(s, sums) and torch.equal(c, cnt)
        assert [int(x) for x in st] == [int(x) for x in stats]
    n = (2 if KERNELS[kernel][0] == "iql" else 1) * B * T
    assert int(cnt.sum()) == n and int(stats[3]) == 0


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_sharded_chunk_equals_jax_shard_map(kernel, ranks, jax_chunks):
    """Against JAX's 2-device sharded chunk: fields and counts bit-equal
    (a mixture's per-variant counts (B / 2) * T), stats equal, the sums
    within cnt * (2**-8 * max|delta| + 1e-6)."""
    game, packed, mix = KERNELS[kernel]
    table, (jf, jacc, jst) = jax_chunks[kernel]
    f = [torch.cat([ranks[r]["chunks"][kernel][0][i] for r in range(W)])
         for i in range(len(jf))]
    for a, b in zip(interop.planes_to_tiles(f), jf):
        assert np.array_equal(a, np.asarray(b))
    _, acc, st = ranks[0]["chunks"][kernel]
    assert [int(x) for x in st] == [int(x) for x in jst] + [0]
    ours, theirs = _unpack(kernel, acc), _unpack(kernel, jacc, True)
    if game == "minimax":
        cols = table[:, lk.COL_V] if packed else table[:, lk.COL_V:]
        max_delta = 1 + 2 * float(cols.abs().max())
    else:
        max_delta = 1 + 1.99 * float(table.abs().max())
    for k in range(0, len(ours), 2):   # (sum, count) pairs
        c = ours[k + 1]
        assert np.array_equal(c, theirs[k + 1]) and int(c.sum()) == B * T
        tol = c * (2.0 ** -8 * max_delta + 1e-6)
        assert (np.abs(ours[k] - theirs[k]) <= tol).all()
    if mix:
        nS0 = lk.n_states(MIX[0])
        c = ours[1].reshape(-1, 25).sum(-1)
        assert c[:nS0].sum() == c[nS0:].sum() == (B // 2) * T


# ----------------------------------------------------------------------
# (b) the state-sharded solve
# ----------------------------------------------------------------------

def test_sharded_solve_equals_the_replicated_solve(ranks):
    """761 states over 2 ranks (381 games a rank, one padded): both ranks
    hold the replicated solve's v, x and y bit for bit."""
    want = learners.solve_matrix_games(_solve_q(), iters=SOLVE_ITERS)
    for r in range(W):
        assert _equal(tuple(ranks[r]["solve"]), tuple(want))


def test_sharded_solve_equals_jax(ranks):
    """JAX's 2-device ``sharded_solve_fn`` on the same games, within the
    port's RM+ tests' tolerance (tests/test_torch_learner_kernel.py)."""
    jax, jnp, *_, jmesh = _jax()
    want = jmesh.sharded_solve_fn(jmesh.env_mesh(W), iters=SOLVE_ITERS)(
        jnp.asarray(_solve_q().numpy()))
    for g, w in zip(ranks[0]["solve"], want):
        assert np.allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


# ----------------------------------------------------------------------
# (c) the HBM-table learners
# ----------------------------------------------------------------------

TABLES = {"minimax": ("q", "v", "pi_a", "pi_b", "n"), "iql": ("q_a", "q_b"),
          "altq": ("q",)}


def _env_cat(ranks, game):
    envs = [ranks[r]["learners"][game][0].env for r in range(W)]
    return type(envs[0])(*(torch.cat(x) for x in zip(*envs)))


def _jax_learner(game):
    """JAX's 2-device ``sharded_*_train_fn`` from the same start."""
    jax, jnp, JaxConfig, *_, jmesh = _jax()
    from gym_soccer_tpu.agents import learners as jl
    from gym_soccer_tpu.envs import soccer_alternating_env as jalt
    jc, m = JaxConfig(5, 4, 0.2), jmesh.env_mesh(W)
    st = _learner_state(game, pmesh.env_mesh(device="cpu"))
    step = jnp.int32(0)
    if game == "altq":
        cfg = jl.AltQConfig(**LCFG[game]._asdict())
        jst = jl.AltQState(q=jnp.asarray(st.q.numpy()),
                           env=jalt.alt_init(jc, jax.random.key(0), N_ENVS),
                           step=step)
        fn = jmesh.sharded_altq_train_fn(jc, cfg, m, STEPS)
    else:
        env = jmesh.sharded_init(jc, m, jax.random.key(0), N_ENVS)
        arrays = {k: jnp.asarray(getattr(st, k).numpy())
                  for k in TABLES[game]}
        if game == "iql":
            cfg = jl.IQLConfig(**LCFG[game]._asdict())
            jst = jl.IQLState(env=env, step=step, **arrays)
            fn = jmesh.sharded_iql_train_fn(jc, cfg, m, STEPS)
        else:
            cfg = jl.MinimaxQConfig(**LCFG[game]._asdict())
            jst = jl.MinimaxQState(env=env, step=step, **arrays)
            fn = jmesh.sharded_minimax_train_fn(jc, cfg, m, STEPS)
    return jax.block_until_ready(fn(jst))


def _np(x):
    import jax
    if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x)).astype(np.int64)
    return np.asarray(x)


@pytest.mark.parametrize("game", LEARNERS)
def test_sharded_learner_equals_jax(game, ranks):
    """2 ranks against JAX's 2-device shard_map run: env states (keys
    included) bit-equal, the tables bit-equal (each cell's all-reduced
    sum is one addition of the two ranks' float32 sums), the TD summary
    within 1e-6 relative."""
    jst, jtd = _jax_learner(game)
    env = _env_cat(ranks, game)
    for i, name in enumerate(type(env)._fields):
        assert np.array_equal(env[i].numpy(), _np(jst.env[i])), name
    for r in range(W):
        st, td = ranks[r]["learners"][game]
        for name in TABLES[game]:
            assert np.array_equal(getattr(st, name).numpy(),
                                  np.asarray(getattr(jst, name))), name
        assert int(st.step) == STEPS
        assert np.allclose(td.numpy(), np.asarray(jtd), rtol=1e-6,
                           atol=1e-7)


@pytest.mark.parametrize("game", LEARNERS)
def test_sharded_learner_equals_one_process(game, ranks):
    """2 ranks against the port's 1-process run over the whole batch: env
    states bit-equal, the tables within 1e-6 relative."""
    one = pmesh.env_mesh(device="cpu")
    st, td = _train_fn(game, one)(_learner_state(game, one))
    assert _equal(_env_cat(ranks, game), st.env)
    got, _ = ranks[0]["learners"][game]
    for name in TABLES[game]:
        a, b = getattr(got, name).double(), getattr(st, name).double()
        assert ((a - b).abs() <= 1e-6 * (1 + b.abs())).all(), name


# ----------------------------------------------------------------------
# (d) the trainers with mesh=
# ----------------------------------------------------------------------

def _tensors(out):
    """A trainer's result tensors and its history (the last element)."""
    return [x for x in out[:-1] if isinstance(x, torch.Tensor)], out[-1]


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_per_chunk_equals_grouped_on_the_mesh(name, ranks):
    """Per chunk and at chunks_per_dispatch=3 (4 chunks: one segment and a
    remainder) under the 2-rank mesh: the same tables bit for bit and the
    same history rows; both ranks hold the same tables."""
    for r in range(W):
        per, grouped = ranks[r]["trainers"][name][:2]
        tp, hp = _tensors(per)
        tg, hg = _tensors(grouped)
        assert _equal(tp, tg)
        assert hp == [row for k, row in enumerate(hg) if k % 16 == 0
                      or k == len(hg) - 1]
        assert _equal(tp, _tensors(ranks[0]["trainers"][name][0])[0])


def test_single_dispatch_on_the_mesh(ranks):
    """``single_dispatch`` under the 2-rank mesh equals the per-chunk
    mode, bit for bit."""
    for r in range(W):
        per = ranks[r]["trainers"]["minimax"][0]
        single = ranks[r]["single"]
        assert _equal(_tensors(per)[0], _tensors(single)[0])
        assert per[-1] == [row for k, row in enumerate(single[-1])
                           if k % 16 == 0 or k == len(single[-1]) - 1]


def test_replicated_is_rank_zeros(ranks):
    """``replicated`` broadcasts rank 0's tensor to every rank."""
    for r in range(W):
        assert torch.equal(ranks[r]["replicated"], torch.zeros(3).long())


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_resume_on_the_mesh(name, ranks):
    """1 + 1 chunks through a save and load of the resume dict (the
    rank's block of the fields) equal 2 chunks, bit for bit."""
    for r in range(W):
        whole, part = ranks[r]["trainers"][name][2:]
        assert _equal(whole[-1], part[-1])
        assert _equal(_tensors(whole[:-1])[0], _tensors(part[:-1])[0])


def test_fused_train_on_mesh_learns(ranks):
    """The twin of tests/test_sharded_fused.py::
    test_fused_train_on_mesh_learns at 2 ranks x 256 lanes."""
    v, pa, _ = ranks[0]["learns"]
    assert float(v.abs().max()) > 0.02, "values never moved"
    assert np.allclose(pa.sum(-1).numpy(), 1.0, atol=1e-3)


def test_fused_altq_train_on_mesh_learns(ranks):
    """The twin of tests/test_sharded_fused.py::
    test_fused_altq_train_on_mesh_learns at 2 ranks x 256 lanes."""
    assert float(ranks[0]["learns"][2].abs().max()) > 0.02


# ----------------------------------------------------------------------
# The mesh's own rules
# ----------------------------------------------------------------------

def test_sharded_init_is_the_global_blocks():
    """Global instance ids: the blocks of two meshes' ranks concatenate to
    ``batch.init`` over the whole batch; ``shard_env_state`` cuts the same
    blocks."""
    full = cbatch.init(CFG, threefry.key(4), 96, "cpu")
    blocks = []
    for r in range(3):
        m = pmesh.Mesh(r, 3, torch.device("cpu"), None)
        part = pmesh.sharded_init(CFG, m, threefry.key(4), 96)
        assert _equal(part, pmesh.shard_env_state(full, m))
        blocks.append(part)
    assert _equal(type(full)(*(torch.cat(x) for x in zip(*blocks))), full)


def test_shard_seed_is_jax_int32_wrap():
    """rank * 0x61C88647 wraps in int32 before the xor, as JAX's
    ``axis_index * GOLD`` does (tests/test_sharded_fused.py:40-42)."""
    for seed in (3, -5, 2 ** 31 - 1):
        for r in range(9):
            bits = (seed ^ ((r * 0x61C88647) & 0xFFFFFFFF)) & 0xFFFFFFFF
            assert pmesh.shard_seed(seed, r) == bits
    m = pmesh.Mesh(5, 8, torch.device("cpu"), None)
    t = pmesh._seed_xor(m, 3)(torch.tensor([-5, 7, 9], dtype=torch.int32))
    assert [int(x) & 0xFFFFFFFF for x in t] == [pmesh.shard_seed(-5, 5), 7, 9]


def test_dispatch_refuses_a_mesh_it_cannot_capture():
    """``dispatch.run`` refuses a gloo mesh on the card, naming the
    backend, before any body runs, wherever a full segment would be
    captured; fewer chunks than a segment run as they are."""
    from gym_soccer_tpu_torch.ops import dispatch
    gloo_card = pmesh.Mesh(0, 2, torch.device("cuda", 0), "gloo")
    x = torch.zeros(1)

    def body():
        x.add_(1)
    with pytest.raises(ValueError, match="gloo"):
        dispatch.run(body, [x], 7, 3, mesh=gloo_card)
    assert int(x) == 0
    dispatch.run(body, [x], 2, 3, mesh=gloo_card)
    dispatch.run(body, [x], 7, 3,
                 mesh=pmesh.Mesh(0, 2, torch.device("cuda", 0), "nccl"))
    assert int(x) == 9


def test_mesh_rules():
    """A batch the ranks cannot split, a backend without a group, a size
    other than the group's and a CUDA mesh without a card are refused;
    distributed_init is a no-op at one process with no backend asked."""
    m = pmesh.Mesh(1, 2, torch.device("cpu"), "gloo")
    assert m.block(512) == slice(256, 512) and m.capturable
    with pytest.raises(ValueError, match="multiple"):
        m.block(511)
    assert not pmesh.Mesh(0, 2, torch.device("cuda", 0), "gloo").capturable
    assert pmesh.Mesh(0, 2, torch.device("cuda", 0), "nccl").capturable
    pmesh.distributed_init(world_size=1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="distributed_init"):
        pmesh.env_mesh(backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="world size"):
        pmesh.env_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.env_mesh()
    with pytest.raises(ValueError, match="global_batch"):
        lk.packed_learner_chunk(CFG, 0, torch.zeros(lk.n_codes(CFG), 11),
                                lk.init_state_fields(CFG, 256, "cpu"), 256,
                                4, global_batch=384)


def test_global_batch_sets_the_exact_range():
    """A chunk whose sums join a larger batch's counts the values outside
    that batch's range: a table value inside 256 lanes' range but outside
    512's is counted at global_batch=512 (every rank raises together),
    and 2**29 lane-steps are counted over the global batch."""
    table = torch.zeros(lk.n_codes(CFG), 11)
    table[:, :10] = 0.2
    table[:, lk.COL_V] = lk.value_limit(512, 4) * 1.5
    fields = lk.init_state_fields(CFG, 256, "cpu")
    assert int(lk.packed_learner_chunk(CFG, 0, table, fields, 256, 4)[2][3]) \
        == 0
    assert int(lk.packed_learner_chunk(CFG, 0, table, fields, 256, 4,
                                       global_batch=512)[2][3]) > 0
    with pytest.raises(ValueError, match="2\\*\\*29"):
        lk.packed_learner_chunk(CFG, 0, table, fields, 256, 2 ** 20,
                                global_batch=1024)


# ----------------------------------------------------------------------
# (e) the orbax pair under the mesh
# ----------------------------------------------------------------------

def test_orbax_two_ranks_round_trip_and_resume(ranks):
    """Each rank's resume dict comes back bit for bit (its block of the
    fields, the replicated tables and scalars), and the chunk resumed from
    it equals the uninterrupted 2-chunk run on that rank."""
    for r in range(W):
        saved, got, part = ranks[r]["orbax"]
        assert _equal(got, saved)
        assert type(got["next_chunk"]) is int and got["next_chunk"] == 1
        whole = ranks[r]["trainers"]["minimax"][2][-1]
        assert _equal(part, whole)


def test_orbax_two_rank_checkpoint_loads_the_global_batch(ranks,
                                                          orbax_path):
    """One process, no mesh, loads the 2-rank checkpoint into a template
    of the global batch: the fields are the ranks' blocks in rank order,
    the tables rank 0's (equal on both)."""
    import torch.distributed.checkpoint as dcp
    r0, r1 = (ranks[r]["orbax"][0] for r in range(W))
    tmpl = dict(r0, fields=tuple(torch.zeros(2 * f.shape[0], dtype=f.dtype)
                                 for f in r0["fields"]))
    got = checkpoint.load_orbax(orbax_path, tmpl)
    want = dict(r0, fields=tuple(torch.cat(pair) for pair in
                                 zip(r0["fields"], r1["fields"])))
    assert _equal(got, want) and _equal(r0["q"], r1["q"])
    assert sorted(os.listdir(orbax_path)) == [".metadata", "__0_0.distcp",
                                              "__1_0.distcp"]
    saved = dcp.FileSystemReader(orbax_path).read_metadata()
    assert tuple(saved.state_dict_metadata["leaf_0"].size) == (TB,)
