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
The JAX package's orbax variant is not ported.
"""
from __future__ import annotations

import json
import os
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
