"""Grouped dispatch for the chunked trainers: g chunk bodies a CUDA-graph
replay.

The port of the JAX trainers' ``chunks_per_dispatch`` and
``single_dispatch`` modes (gym_soccer_tpu/ops/learner_kernel.py
``chunk_body``, ``seg_run`` and the remainder loop), shared by
``fused_minimax_train``, ``fused_best_response_train``, ``fused_iql_train``
and ``fused_altq_train``.  A trainer hands ``run`` a body: one chunk and
the work after it, reading the run's carry (fields, tables, sums) from
tensors that stay in place and writing it back with ``copy_``.  On a CUDA
device ``run`` captures g bodies once as a CUDA graph and replays it once
for each full segment of g chunks, then runs the remaining chunks one body
at a time; every body launches the same kernels in the same order, so the
arithmetic does not depend on the grouping.  On the CPU the bodies run one
after another, with no graph: that is what the tests compare.

The body reads its chunk's schedule from a ``Schedule``: per-run tables of
every chunk's float values (lr, eps, the averaging weight) and int32
scalars (the chunk seed; eps_int and the step offset), computed on the host
exactly as the per-chunk mode computes them and uploaded once, indexed by a
chunk counter on the device that each body advances.  Each body writes its
chunk's stats row into the schedule's [n_chunks, 4] table; the out-of-range
count is read once, at the end, with the stats history.

A chunk wrapper counts one launch when it launches, which for a captured
body is once at capture: ``run`` takes the counts the capture added (the g
bodies' launches) back, and adds them again at every replay, so that a
kernel's count is replays x g plus the remainder, as if each chunk had
been launched on its own.

Under a data-parallel mesh (parallel/mesh) a body all-reduces its chunk's
sums: an NCCL collective is captured like a kernel once its communicator
exists, which the warm-up body before the capture creates; a gloo
collective on CUDA tensors goes through the host and cannot be captured,
so ``run``, handed the mesh, refuses such a mesh (``check_capture``)
before the warm-up body of a capture.  On the CPU the bodies run one
after another under any mesh.
"""
from __future__ import annotations

import time

import numpy as np
import torch

# ``single_dispatch``: the whole run with no host round trip between
# chunks, as segments of this many chunks a replay (the JAX package's one
# scan of every chunk would capture a graph of every chunk).
SINGLE_DISPATCH_CHUNKS = 32


def group_size(n_chunks: int, single_dispatch: bool,
               chunks_per_dispatch: int):
    """Chunks a replay of a grouped run, or None for the per-chunk mode
    (``chunks_per_dispatch`` 1 without ``single_dispatch``)."""
    if int(chunks_per_dispatch) != chunks_per_dispatch or \
            chunks_per_dispatch < 1:
        raise ValueError("chunks_per_dispatch must be a positive integer, "
                         f"got {chunks_per_dispatch}")
    if single_dispatch:
        return max(min(n_chunks, SINGLE_DISPATCH_CHUNKS), 1)
    return int(chunks_per_dispatch) if chunks_per_dispatch > 1 else None


class Schedule:
    """A grouped run's per-chunk tables on the device.

    ``floats``: [n_chunks, F] values already rounded to float32 on the host
    (a chunk's lr, eps, ...); ``ints``: [n_chunks, I] int32 values (its
    seed, ...).  ``k`` counts the chunks run (int64 [1]); ``stats`` holds
    each chunk's (reward_sum, goals, truncs, out_of_range)."""

    def __init__(self, floats, ints, device):
        floats = np.asarray(floats, np.float32)
        ints = np.asarray(ints, np.int64)
        if ints.size and (ints.min() < -2 ** 31 or ints.max() >= 2 ** 31):
            raise OverflowError("a schedule value does not fit int32")
        self.floats = torch.tensor(floats, device=device)
        self.ints = torch.tensor(ints.astype(np.int32), device=device)
        self.k = torch.zeros(1, dtype=torch.int64, device=device)
        self.stats = torch.zeros((floats.shape[0], 4), dtype=torch.int64,
                                 device=device)

    def row(self):
        """(float32 [F], int32 [I]) of the current chunk, new tensors."""
        return (self.floats.index_select(0, self.k)[0],
                self.ints.index_select(0, self.k)[0])

    def record(self, stats) -> None:
        """Store the chunk's four stats in its row and move to the next."""
        self.stats.index_copy_(0, self.k, torch.stack(tuple(stats))[None])
        self.k.add_(1)

    def state(self) -> list:
        """The tensors a body writes: ``run`` restores them after its
        warm-up."""
        return [self.k, self.stats]

    def history(self):
        """(every chunk's (reward_sum, goals, truncs), the run's summed
        out-of-range count): the run's one read of the device."""
        rows = self.stats.tolist()
        return [tuple(r[:3]) for r in rows], sum(r[3] for r in rows)


def check_capture(mesh) -> None:
    """Refuse, with ValueError naming the backend, a mesh whose
    collectives a CUDA graph cannot capture (gloo on CUDA tensors); None
    or a mesh on the CPU passes."""
    if mesh is not None and not mesh.capturable:
        raise ValueError(
            f"a {mesh.backend} mesh's collectives on CUDA tensors cannot be "
            "captured in a CUDA graph: the grouped modes and the learners' "
            "*_train need an NCCL mesh on the card")


def run(body, carry, n_chunks: int, g: int, counters=(),
        timing: dict | None = None, mesh=None) -> None:
    """Run ``body`` ``n_chunks`` times: on a CUDA device as replays of one
    CUDA graph of ``g`` bodies for each full segment, then one body at a
    time for the rest; on the CPU one body at a time.

    ``carry``: every tensor the body writes (on the device), each restored
    after the warm-up body that precedes the capture, which runs on a side
    stream as PyTorch's graph capture asks; ``counters``: the launch-count
    dicts of the kernels the body launches, kept as described in the
    module's docstring.  ``timing``, if a dict, receives ``capture_ms``
    (the warm-up and the capture, host clock), ``segments_ms`` (the
    replays, CUDA events; the chunks and the work between them cannot be
    told apart inside a graph), ``replays``, ``chunks_per_replay``,
    ``remainder_ms`` (the bodies run one at a time) and ``chunks``.
    ``mesh``: the data-parallel mesh the body's collectives run on, or
    None; where a full segment would be captured, a mesh that cannot be
    captured is refused (``check_capture``) before any body runs."""
    device = carry[0].device
    cuda = device.type == "cuda"
    if n_chunks >= g:
        check_capture(mesh)
    n_full = n_chunks // g if cuda else 0
    spans = {"capture_ms": 0.0, "segments_ms": 0.0, "remainder_ms": 0.0}
    if n_full:
        t0 = time.perf_counter()
        graph, added = _capture(body, carry, g, counters, device)
        torch.cuda.synchronize(device)
        spans["capture_ms"] = (time.perf_counter() - t0) * 1e3
        with _Span(spans, "segments_ms", cuda, timing):
            for _ in range(n_full):
                graph.replay()
                for d, extra in zip(counters, added):
                    for name, n in extra.items():
                        d[name] += n
    with _Span(spans, "remainder_ms", cuda, timing):
        for _ in range(n_chunks - n_full * g):
            body()
    if timing is not None:
        timing.update(spans, replays=n_full, chunks_per_replay=g,
                      chunks=n_chunks)


def _capture(body, carry, g: int, counters, device):
    """(a CUDA graph of ``g`` bodies, the launches they add to each of
    ``counters``), after one warm-up body; the carry and the counts are as
    they were before."""
    before = [dict(d) for d in counters]
    saved = [t.clone() for t in carry]
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        body()
    main.wait_stream(side)
    for t, s in zip(carry, saved):
        t.copy_(s)
    _restore(counters, before)
    # torch.cuda.graph's context would also run the garbage collector and
    # empty the allocator's cache first, which the capture does not need
    # and which takes long in a process that holds many objects.
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(g):
                body()
        finally:
            graph.capture_end()
    main.wait_stream(side)
    added = [{k: d[k] - b[k] for k in d} for d, b in zip(counters, before)]
    _restore(counters, before)
    return graph, added


def _restore(counters, before) -> None:
    for d, b in zip(counters, before):
        d.update(b)


class _Span:
    """Adds the time of its block to ``spans[key]``: CUDA events on the
    device's stream, or the host clock on the CPU; nothing when
    ``timing`` is None."""

    def __init__(self, spans, key, cuda: bool, timing):
        self.spans, self.key, self.cuda = spans, key, cuda
        self.on = timing is not None

    def __enter__(self):
        if self.on and self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()
        elif self.on:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on or exc[0] is not None:
            return False
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            self.spans[self.key] += self.ev[0].elapsed_time(self.ev[1])
        else:
            self.spans[self.key] += (time.perf_counter() - self.t0) * 1e3
        return False
