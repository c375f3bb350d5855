"""Data parallelism over the env batch on ``torch.distributed``: the port
of gym_soccer_tpu/parallel/mesh.py.

The scale axis is the env batch: there are no model weights or sequences
to shard.  JAX puts many devices in one process and shards arrays over a
1-D mesh; here one process is one rank, on one device, and a ``Mesh`` is
that rank's view of the group (its rank, the world size, its device and
the process group's backend).  The contract is the JAX layer's:

* rank r holds the contiguous block of lanes r*b .. (r+1)*b - 1 of the
  global batch (b = batch / world); env stepping needs no collective;
* tables are replicated: every rank holds the same Q, v and policies;
* each chunk's or step's sums and counts are all-reduced before the
  count-normalised divide, so every rank applies the whole batch's update.
  The fused chunks' sums are int64 and their counts int32, exact in any
  order of addition, so the all-reduced sums equal the sum of the ranks'
  chunks bit for bit; the HBM-table learners' float32 sums of two ranks
  are one addition, which does not depend on its order;
* per-instance keys come from global instance ids (``sharded_init``), and
  a fused chunk's seed is JAX's shard seed ``seed ^ (rank * 0x61C88647)``
  with int32 wrap (mesh.py:199-201), so each lane's stream is the one the
  JAX mesh gives it.

Start one process a rank and call ``distributed_init`` in each (or let
``spawn`` do both), then ``env_mesh``.  ``distributed_init`` is a no-op at
one process with no backend asked: ``env_mesh`` then gives a mesh of one
rank with no process group, whose collectives are the identity.  The
backend defaults to NCCL for a CUDA device and gloo for the CPU; gloo may
be named for CUDA tensors, which is how two ranks share one card (NCCL
refuses two ranks on one device).  A gloo collective on CUDA tensors
cannot be captured in a CUDA graph, so under such a mesh
``ops/dispatch.run`` refuses (ValueError) the trainers' grouped modes and
the HBM-table learners' replays wherever they would capture; an NCCL
collective is captured once its communicator exists, which the warm-up
body before each capture creates.

The JAX functions' counterparts: JAX's ``batch_sharding`` is
``Mesh.block``, the rank's block slice, and ``replicated`` a broadcast
from rank 0, not shardings;
``sharded_solve_fn`` gathers each rank's games with NCCL's all-gather,
or under gloo by summing bit patterns as int32 (one ``all_reduce``, which
gloo takes on CUDA tensors too), which keeps every bit, -0.0 included;
``fused_minimax_train`` re-solves replicated, where JAX shards the
re-solve (see its docstring for the measurement).  JAX's
``batch % (n_dev * 128)`` is a Pallas layout rule; the port asks
``batch % world == 0`` (and the fused chunks' own multiple of 128 lanes a
rank).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..config import EnvConfig
from ..core import batch as corebatch
from ..core import threefry

# JAX's shard-seed decorrelation constant (mesh.py:199-201).
GOLD = 0x61C88647
M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Mesh:
    """One rank of a data-parallel group: ``rank`` of ``world``, its
    ``device``, and the process group's ``backend`` ("nccl" or "gloo"), or
    None for one rank without a process group (collectives are then the
    identity)."""
    rank: int
    world: int
    device: torch.device
    backend: Optional[str]

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives."""
        return (self.backend in (None, "nccl")
                or self.device.type != "cuda")

    def local_batch(self, n: int) -> int:
        """Lanes (or instances) a rank holds of a global batch ``n``."""
        if n % self.world:
            raise ValueError(f"batch {n} is not a multiple of the world size "
                             f"{self.world}")
        return n // self.world

    def block(self, n: int) -> slice:
        """This rank's lanes of a global batch ``n``: r*b .. (r+1)*b - 1."""
        b = self.local_batch(n)
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        if self.backend is not None:
            dist.all_reduce(t)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """JAX's ``pmean``: the ranks' sum divided by the world size, in
        place (float tensors)."""
        return self.all_reduce_(t).div_(self.world)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place; returns it."""
        if self.backend is not None:
            dist.broadcast(t, 0)
        return t

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` [n, ...] (4-byte dtype, the same n on every
        rank) stacked in rank order, [world * n, ...], bit for bit: NCCL's
        all-gather; under gloo, each rank writes its rows into zeros and
        the ranks' bit patterns are summed as int32, which adds only zeros
        to each value."""
        if self.backend is None:
            return x
        n = x.shape[0]
        if self.backend == "nccl":
            full = torch.empty((self.world * n, *x.shape[1:]),
                               dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(full, x.contiguous())
            return full
        full = torch.zeros((self.world * n, *x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        full[self.rank * n:(self.rank + 1) * n] = x
        dist.all_reduce(full.view(torch.int32))
        return full


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> None:
    """Join this process to the group as ``rank`` of ``world_size``
    (``torch.distributed.init_process_group``), with ``init_method`` the
    rendezvous (``file://`` a path, or ``tcp://127.0.0.1:<port>``).  A
    no-op at one process with no ``backend`` asked.  ``backend`` defaults
    to NCCL where ``device`` is a CUDA device and gloo on the CPU."""
    world_size = 1 if world_size is None else int(world_size)
    if backend is None and world_size == 1:
        return
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("distributed_init: a CUDA device was asked for "
                           "and none is present")
    dist.init_process_group(backend or _default_backend(device),
                            init_method=init_method, world_size=world_size,
                            rank=0 if rank is None else int(rank))


def env_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
             device="cuda") -> Mesh:
    """This rank's ``Mesh``: the initialised process group's rank, size and
    backend (``backend``, if named, must be the group's), or one rank with
    no group where none was initialised.  ``n_devices``, if given, must
    be the world size.  ``device`` "cuda" without an index is
    cuda:(rank % device count); a CUDA mesh with no CUDA device raises
    RuntimeError."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        world, rank, have = dist.get_world_size(), dist.get_rank(), \
            dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"the process group's backend is {have}, not "
                             f"{backend}")
    else:
        if backend is not None:
            raise ValueError(f"backend {backend} asked for, but no process "
                             "group is initialised: call distributed_init")
        world, rank, have = 1, 0, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices {n_devices} != the world size {world}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("env_mesh: a CUDA mesh needs a CUDA device")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
    if have == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group takes CUDA tensors only")
    return Mesh(rank=rank, world=world, device=device, backend=have)


def replicated(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The counterpart of JAX's replicated placement: ``t`` on the mesh's
    device, with rank 0's values on every rank (a broadcast)."""
    return mesh.broadcast_(t.to(mesh.device).clone())


def shard_env_state(state, mesh: Mesh, n: Optional[int] = None):
    """A batched state (any NamedTuple tree of tensors: ``batch.EnvState``,
    ``AltEnvState``, ``MultiGridState``) of global batch ``n`` (default:
    the first leaf's length) cut to this rank's block: every tensor leaf
    whose leading dimension is ``n``, on the mesh's device."""
    leaves = [x for x in _leaves(state)]
    n = leaves[0].shape[0] if n is None else n
    blk = mesh.block(n)

    def go(t):
        return type(t)(*(
            x[blk].to(mesh.device).clone()
            if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == n
            else go(x) if isinstance(x, tuple) else x for x in t))
    return go(state)


def _leaves(tree):
    for x in tree:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, tuple):
            yield from _leaves(x)


def sharded_init(cfg: EnvConfig, mesh: Mesh, key, n_envs: int):
    """This rank's block of ``batch.init(cfg, key, n_envs)`` on the mesh's
    device, made here: instance i's key is ``fold_in(key, i)`` for its
    GLOBAL id i, so every instance behaves as it does on one rank."""
    blk = mesh.block(n_envs)
    key = threefry.wrap_key_data(key, mesh.device)
    ids = torch.arange(blk.start, blk.stop, device=mesh.device)
    return corebatch.init_from_keys(cfg, threefry.fold_in(key, ids),
                                    mesh.device)


def sharded_rollout_fn(cfg: EnvConfig, mesh: Mesh, policy_fn, n_steps: int):
    """``fn(state) -> (state, (reward_sum, goals, truncs))``: ``n_steps``
    of ``batch.rollout`` on this rank's lanes (``policy_fn(obs, i)`` gets
    and returns the rank's lanes), the three int64 sums all-reduced, the
    one collective of the rollout."""
    def fn(state):
        state, out = corebatch.rollout(cfg, state, policy_fn, n_steps)
        sums = torch.stack([out.reward_a.to(torch.int64).sum(),
                            out.done.sum(dtype=torch.int64),
                            out.truncated.sum(dtype=torch.int64)])
        return state, tuple(mesh.all_reduce_(sums).unbind())
    return fn


# ----------------------------------------------------------------------
# The HBM-table learners
# ----------------------------------------------------------------------

def _train_fn(train, cfg, lcfg, mesh: Mesh, n_steps: int):
    def fn(state):
        st, td = train(cfg, lcfg, state, n_steps, psum_axis=mesh)
        return st, mesh.mean_(td)
    return fn


def sharded_iql_train_fn(cfg: EnvConfig, lcfg, mesh: Mesh, n_steps: int):
    """``fn(local_state) -> (local_state, td)``: ``learners.iql_train``
    on this rank's lanes with the tables' sums and counts all-reduced each
    step (``psum_axis=mesh``); ``td``, the mean |TD| per step, averaged
    over the ranks (JAX's ``pmean``)."""
    from ..agents import learners
    return _train_fn(learners.iql_train, cfg, lcfg, mesh, n_steps)


def sharded_minimax_train_fn(cfg: EnvConfig, lcfg, mesh: Mesh,
                             n_steps: int):
    """``sharded_iql_train_fn`` for ``learners.minimax_train`` (the
    periodic all-state re-solve runs replicated on every rank, as in
    JAX)."""
    from ..agents import learners
    return _train_fn(learners.minimax_train, cfg, lcfg, mesh, n_steps)


def sharded_altq_train_fn(cfg: EnvConfig, lcfg, mesh: Mesh, n_steps: int):
    """``sharded_iql_train_fn`` for ``learners.altq_train``."""
    from ..agents import learners
    return _train_fn(learners.altq_train, cfg, lcfg, mesh, n_steps)


# ----------------------------------------------------------------------
# The state-sharded RM+ solve
# ----------------------------------------------------------------------

def sharded_solve_fn(mesh: Mesh, iters: int):
    """``fn(q [nS, 5, 5]) -> (v [nS], x [nS, 5], y [nS, 5])``: the
    all-states RM+ re-solve sharded STATE-wise.  q is zero-padded to
    ceil(nS / world) games a rank (as JAX pads it); each rank solves its
    games with ``solve_matrix_games`` (kernel R1 on the card, the plain
    version on the CPU) and the strategies are gathered back
    (``Mesh.gather``, one collective of the ranks' [games, 11] float32
    values).  A game's arithmetic does not depend on the others, so the
    result equals the replicated solve bit for bit."""
    from ..agents.learners import N_ACTIONS, solve_matrix_games

    def fn(q):
        nS = q.shape[0]
        per = -(-nS // mesh.world)
        pad = per * mesh.world - nS
        if pad:
            q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        mine = q[mesh.rank * per:(mesh.rank + 1) * per].contiguous()
        v, x, y = solve_matrix_games(mine, iters=iters)
        if mesh.backend is None:
            return v[:nS], x[:nS], y[:nS]
        full = mesh.gather(torch.cat([v[:, None], x, y], 1))
        return (full[:nS, 0], full[:nS, 1:1 + N_ACTIONS],
                full[:nS, 1 + N_ACTIONS:])
    return fn


# ----------------------------------------------------------------------
# The fused chunks
# ----------------------------------------------------------------------

def shard_seed(seed: int, rank: int) -> int:
    """JAX's shard seed ``seed ^ (rank * 0x61C88647)`` with int32 wrap, as
    the uint32 a chunk reads."""
    return (int(seed) & M32) ^ ((rank * GOLD) & M32)


def _seed_xor(mesh: Mesh, n: int):
    """seed -> this rank's shard seed: an int, or (a grouped run's) int32
    [n] tensor of scalars whose first element is the seed, xored on the
    device (the mask is made here, outside any capture)."""
    m = (mesh.rank * GOLD) & M32
    mask = torch.tensor([m - (1 << 32) if m >= 1 << 31 else m]
                        + [0] * (n - 1), dtype=torch.int32,
                        device=mesh.device)

    def xor(seed):
        if isinstance(seed, torch.Tensor):
            return torch.bitwise_xor(seed, mask)
        return shard_seed(seed, mesh.rank)
    return xor


def _reduce(mesh: Mesh, out):
    """A chunk's (fields, (sums, counts), stats) with the sums, counts and
    the four stats (the out-of-range count among them, so that every rank
    raises together) all-reduced."""
    fields, (sums, cnt), stats = out
    stats = mesh.all_reduce_(torch.stack(tuple(stats)))
    return (fields, (mesh.all_reduce_(sums), mesh.all_reduce_(cnt)),
            tuple(stats.unbind()))


def sharded_learner_chunk_fn(cfg, mesh: Mesh, batch: int, n_steps: int,
                             gamma: float = 0.99, packed: bool = False):
    """Data-parallel fused minimax-Q chunks (ops/learner_kernel): the
    global ``batch`` split over the ranks, each rank running its chunk (K5
    or K7, for a mixture K6 or K7 multigrid) on its block of b lanes with
    its shard seed, and the int64 sums, int32 counts and stats
    all-reduced before any conversion, so the between-chunk update sees
    the whole batch.  The chunks count the values outside the exact range
    of the GLOBAL batch's sums.

    Returns ``fn(seed, m, fields [, planes]) -> (fields, acc, stats)`` on
    the rank's [b] fields (and, for a mixture, its block of the global
    batch's planes); ``seed`` an int or an int32 [1] tensor."""
    from ..ops import learner_kernel as lk
    b = mesh.local_batch(batch)
    multi = isinstance(cfg, tuple)
    chunk = {(True, False): lk.packed_learner_chunk,
             (True, True): lk.multigrid_packed_learner_chunk,
             (False, False): lk.learner_chunk,
             (False, True): lk.multigrid_learner_chunk}[bool(packed), multi]
    xor = _seed_xor(mesh, 1)

    def fn(seed, m, fields, planes=None):
        if multi != (planes is not None):
            raise ValueError("a mixture's chunk takes its planes; one "
                             "board's takes none")
        args = (planes, fields) if multi else (fields,)
        return _reduce(mesh, chunk(cfg, xor(seed), m, *args, b, n_steps,
                                   gamma, global_batch=batch))
    return fn


def _scalar_chunk_fn(chunk, cfg, mesh: Mesh, batch: int, n_steps: int,
                     gamma: float):
    b = mesh.local_batch(batch)
    xor = _seed_xor(mesh, 3)

    def fn(seed, eps_int, m, fields, step_offset=0):
        return _reduce(mesh, chunk(cfg, xor(seed), eps_int, m, fields, b,
                                   n_steps, gamma, step_offset,
                                   global_batch=batch))
    return fn


def sharded_altq_chunk_fn(cfg: EnvConfig, mesh: Mesh, batch: int,
                          n_steps: int, gamma: float = 0.99,
                          packed: bool = False):
    """Data-parallel fused alternating-turn Q chunks (ops/altq_kernel: K10,
    or K11 unpacked), laid out as ``sharded_learner_chunk_fn``.  Returns
    ``fn(seed, eps_int, m, fields, step_offset) -> (fields, acc, stats)``
    on the rank's seven [b] fields; ``seed`` may be an int32 [3] tensor
    of (seed, eps_int, step offset), ``eps_int`` then None and
    ``step_offset`` 0."""
    from ..ops import altq_kernel as ak
    return _scalar_chunk_fn(ak.altq_packed_chunk if packed else ak.altq_chunk,
                            cfg, mesh, batch, n_steps, gamma)


def sharded_iql_chunk_fn(cfg: EnvConfig, mesh: Mesh, batch: int,
                         n_steps: int, gamma: float = 0.99,
                         packed: bool = False):
    """Data-parallel fused independent-Q chunks (ops/iql_kernel: K8, or K9
    unpacked), laid out as ``sharded_altq_chunk_fn`` on six fields."""
    from ..ops import iql_kernel as ik
    return _scalar_chunk_fn(ik.iql_packed_chunk if packed else ik.iql_chunk,
                            cfg, mesh, batch, n_steps, gamma)


def shard_fields(fields, mesh: Mesh, batch: int) -> tuple:
    """This rank's block of a global batch's [batch] planes (fields or a
    mixture's geometry), each a tensor of its own."""
    blk = mesh.block(batch)
    return tuple(f[blk].clone() for f in fields)


def check_device(mesh: Mesh, device) -> torch.device:
    """The device a trainer runs on under ``mesh``: the mesh's, which
    ``device`` must name."""
    device = torch.device(device)
    if device.type != mesh.device.type or (
            device.index is not None and device != mesh.device):
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


# ----------------------------------------------------------------------
# Ranks in processes
# ----------------------------------------------------------------------

def _rank_main(rank: int, fn, world: int, init_method: str, backend, device,
               args, out_dir: str) -> None:
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)   # the ranks share the machine's cores
    elif device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    distributed_init(init_method, world, rank, backend or
                     _default_backend(device), device)
    try:
        result = fn(env_mesh(world, device=device), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), device="cuda", backend=None,
          timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, one spawned process each
    (``torch.multiprocessing``), joined through a ``FileStore`` in a new
    temporary directory; returns each rank's result (saved by the rank
    with ``torch.save``, loaded here to the CPU), in rank order.  ``fn``
    must be importable by name.  CPU ranks run one torch thread; CUDA ranks
    sit on cuda:(rank % device count).  A rank that fails raises here; at
    ``timeout`` seconds every rank still running is killed by its PID and
    TimeoutError raised."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, init, backend, str(device), args,
                              tmp), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks not done in "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
