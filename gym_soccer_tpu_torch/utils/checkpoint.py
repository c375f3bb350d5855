"""Checkpoint and resume of learner and environment state: the port of
gym_soccer_tpu/utils/checkpoint.py.

A tree of tensors (NamedTuples, dicts, tuples and lists of tensors, numpy
arrays and Python scalars; ``None`` holds no leaf) is flattened to one
``.npz`` in the JAX package's leaf order (dict keys sorted, NamedTuple
fields in order) and written with an atomic rename.  A NamedTuple field
named ``key`` (the engines' per-instance key words) is stored as uint32
key words with ``"kind": "prng_key"``, as the JAX package stores its typed
keys, so a file the JAX package saved loads here and one saved here loads
there.  The meta also records this module's ``LAYOUT``; a file of another
layout, or with another leaf count than the template, raises ValueError.

``save_orbax`` / ``load_orbax``, the JAX package's orbax pair "for
multi-host / async use cases", write and read a checkpoint directory with
``torch.distributed.checkpoint`` (DCP): the same leaves in the same order,
the key words as uint32 with ``"kind": "prng_key"``, and the meta (layout
and kinds) inside the checkpoint.  Saving is synchronous and replaces an
existing checkpoint whole, as orbax's ``save(..., force=True)`` followed
by ``wait_until_finished()`` does.  A port tensor carries no sharding, so
under a data-parallel ``Mesh`` the caller names the tree's top-level keys
whose leaves are the rank's block of the global batch (``blocks=``, e.g. a
trainer resume dict's ``"fields"``); DCP stores those as one tensor of
the global batch and reads back any rank's block of it, at another world
size, 1 included, as orbax restores into a template of another sharding.
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any

import numpy as np
import torch

# The meta's layout tag; the JAX package's files carry none.
LAYOUT = "gym_soccer_tpu_torch/1"
JAX_LAYOUT = "gym_soccer_tpu"
KEY_IMPL = "threefry2x32"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, is_key: bool = False, out=None) -> list:
    """[(leaf, is_key)] in the JAX package's pytree order."""
    out = [] if out is None else out
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], False, out)
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            _flatten(v, name == "key", out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flatten(v, False, out)
    else:
        out.append((tree, is_key))
    return out


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        got = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: got[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_numpy(leaf, is_key: bool) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr.astype(np.uint32) if is_key else arr


def save_pytree(path: str, tree: Any) -> None:
    """Flatten a tree of tensors (key words included) into one .npz."""
    arrays, meta = {}, []
    for i, (leaf, is_key) in enumerate(_flatten(tree)):
        arrays[f"leaf_{i}"] = _to_numpy(leaf, is_key)
        meta.append({"i": i, "kind": "prng_key", "impl": KEY_IMPL}
                    if is_key else {"i": i, "kind": "array"})
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"leaves": meta, "layout": LAYOUT}).encode(),
        dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic finalize


def _restore(arr: np.ndarray, kind: str, tmpl):
    """A saved leaf in the type of its template leaf: a tensor on the
    template's device (uint32 words as int64), a Python scalar, or the
    array."""
    if kind == "prng_key" or arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    if isinstance(tmpl, torch.Tensor):
        return torch.as_tensor(arr, device=tmpl.device)
    if isinstance(tmpl, (bool, int, float)):
        return type(tmpl)(arr.item())
    return arr


def load_pytree(path: str, template: Any) -> Any:
    """Restore into the structure of ``template`` (its leaves' values are
    ignored; their types and devices are kept)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        layout = meta.get("layout", JAX_LAYOUT)
        leaves_t = [leaf for leaf, _ in _flatten(template)]
        if layout not in (LAYOUT, JAX_LAYOUT):
            raise ValueError(f"checkpoint {path} has layout {layout!r}; "
                             f"this reads {LAYOUT!r} and {JAX_LAYOUT!r}")
        if len(meta["leaves"]) != len(leaves_t):
            raise ValueError(
                f"checkpoint {path} (layout {layout!r}) has "
                f"{len(meta['leaves'])} leaves, the template has "
                f"{len(leaves_t)}")
        out = [_restore(data[f"leaf_{m['i']}"], m["kind"], tmpl)
               for m, tmpl in zip(meta["leaves"], leaves_t)]
    return _unflatten(template, iter(out))


# ----------------------------------------------------------------------
# The orbax pair on torch.distributed.checkpoint
# ----------------------------------------------------------------------

META_KEY = "__meta__"


def _top(tree) -> list:
    """[(top-level key, subtree, is_key)] in ``_flatten``'s order."""
    if isinstance(tree, dict):
        return [(k, tree[k], False) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(n, v, n == "key") for n, v in zip(tree._fields, tree)]
    if isinstance(tree, (tuple, list)):
        return [(i, v, False) for i, v in enumerate(tree)]
    return [(None, tree, False)]


def _leaves(tree, blocks) -> list:
    """[(leaf, is_key, is_block)] in the JAX package's pytree order; a leaf
    is a block leaf under a top-level key that ``blocks`` names."""
    top = _top(tree)
    unknown = set(blocks) - {k for k, _, _ in top}
    if unknown:
        raise ValueError(f"blocks {sorted(map(str, unknown))} name no "
                         f"top-level key of the tree")
    return [(leaf, is_key, k in blocks) for k, sub, key in top
            for leaf, is_key in _flatten(sub, key)]


def _cpu_tensor(leaf, is_key: bool) -> torch.Tensor:
    """A leaf as a new CPU tensor (key words as uint32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
    else:
        t = torch.as_tensor(np.array(leaf))
    return t.to(torch.uint32) if is_key else t


def _dist_mesh(mesh):
    """(DCP's process-group switch, a 1-D device mesh of the ranks for
    the block leaves' DTensors, the block leaves' device): no collective
    without a mesh or at world size 1."""
    if mesh is None or mesh.world == 1:
        return False, None, torch.device("cpu")
    from torch.distributed.device_mesh import init_device_mesh
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    return True, init_device_mesh(dev.type, (mesh.world,)), dev


def _block(t: torch.Tensor, dmesh, dev):
    """This rank's block ``t`` as its shard of the global batch."""
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(t.to(dev), dmesh, [Shard(0)], run_check=False)


def _quiet(fn, *args, **kw):
    """``fn`` without DCP's warning that it saves or loads in one
    process, which ``no_dist=True`` asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        return fn(*args, **kw)


def _barrier(on: bool) -> None:
    if on:
        import torch.distributed as dist
        dist.barrier()


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.remove(path)


def save_orbax(path: str, tree: Any, mesh=None, blocks=()) -> None:
    """Save a tree of tensors (key words included) as a DCP checkpoint
    directory at ``path``, replacing whatever was there.

    ``mesh``: a ``parallel.mesh.Mesh``; at world size 2 or more every
    rank calls this with its own tree, the replicated leaves (equal on
    every rank) are written once and the leaves under the top-level keys
    ``blocks`` names, each rank's block of the global batch on dim 0, are
    written as one tensor of the global batch.  Without a mesh, or at world
    size 1, the save runs no collective.  The checkpoint is written to
    ``path + ".tmp"`` and renamed into place (on rank 0, after a barrier),
    so no file of an earlier checkpoint survives it."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    on, dmesh, dev = _dist_mesh(mesh)
    state, meta = {}, []
    for i, (leaf, is_key, block) in enumerate(_leaves(tree, blocks)):
        t = _cpu_tensor(leaf, is_key)
        state[f"leaf_{i}"] = _block(t, dmesh, dev) if block and on else t
        meta.append({"i": i, "kind": "prng_key", "impl": KEY_IMPL}
                    if is_key else {"i": i, "kind": "array"})
    state[META_KEY] = torch.frombuffer(bytearray(json.dumps(
        {"leaves": meta, "layout": LAYOUT}).encode()), dtype=torch.uint8)
    tmp = path + ".tmp"
    first = not on or mesh.rank == 0
    if first:
        _remove(tmp)
    _barrier(on)
    _quiet(dcp.save, state, checkpoint_id=tmp, no_dist=not on)
    _barrier(on)
    if first:
        old = path + ".old"
        _remove(old)
        if os.path.lexists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        _remove(old)
    _barrier(on)


def load_orbax(path: str, template: Any, mesh=None, blocks=()) -> Any:
    """Restore a ``save_orbax`` checkpoint into ``template``'s structure
    (its leaves' values are ignored and left unchanged; their types and
    devices are kept).

    ``mesh`` and ``blocks`` as for ``save_orbax``: under a mesh of two or
    more ranks every rank calls this with its block's template and gets
    its block of the saved global batch, whatever world size saved it;
    without one, a block leaf's template holds the global batch.  A
    checkpoint of another layout, with another leaf count, without a
    leaf, or whose leaf has another dtype or shape than the template's
    raises ValueError naming both; a path that is no directory raises
    FileNotFoundError."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if META_KEY not in saved:
        raise ValueError(f"checkpoint {path} has no {META_KEY}: not a "
                         f"save_orbax checkpoint")
    raw = {META_KEY: torch.zeros(tuple(saved[META_KEY].size),
                                 dtype=torch.uint8)}
    _quiet(dcp.load, raw, checkpoint_id=path, no_dist=True)
    meta = json.loads(bytes(raw[META_KEY].numpy()).decode())
    if meta.get("layout") != LAYOUT:
        raise ValueError(f"checkpoint {path} has layout "
                         f"{meta.get('layout')!r}; this reads {LAYOUT!r}")
    leaves = _leaves(template, blocks)
    if len(meta["leaves"]) != len(leaves):
        raise ValueError(f"checkpoint {path} has {len(meta['leaves'])} "
                         f"leaves, the template has {len(leaves)}")
    on, dmesh, dev = _dist_mesh(mesh)
    state = {}
    for i, (tmpl, is_key, block) in enumerate(leaves):
        name = f"leaf_{i}"
        if name not in saved:
            raise ValueError(f"checkpoint {path} has no {name}; the "
                             f"template's leaf {i} needs it")
        t = _cpu_tensor(tmpl, is_key)
        shape = tuple(t.shape)
        if block and on:   # the global batch's rows
            shape = (shape[0] * mesh.world, *shape[1:])
        want = (t.dtype, shape)
        got = (saved[name].properties.dtype, tuple(saved[name].size))
        if got != want:
            raise ValueError(f"checkpoint {path} {name} is {got[0]} "
                             f"{list(got[1])}, the template's leaf {i} "
                             f"wants {want[0]} {list(want[1])}")
        state[name] = _block(t, dmesh, dev) if block and on else t
    _quiet(dcp.load, state, checkpoint_id=path, no_dist=not on)
    out = []
    for i, (tmpl, is_key, _) in enumerate(leaves):
        t = state[f"leaf_{i}"]
        t = t.to_local() if hasattr(t, "to_local") else t
        out.append(_restore(t.cpu().numpy(), meta["leaves"][i]["kind"],
                            tmpl))
    return _unflatten(template, iter(out))
