"""Solver-state checkpoint/resume.

The port's counterpart of the JAX package's `utils/checkpoint.py`: any
nest of dicts, lists, tuples, namedtuples and dataclasses (the port's
result types) whose leaves are tensors, arrays or numbers round-trips
through one .npz file. The layout is the JAX file's: `leaf_<i>` in leaf
order, `__treedef__` (advisory), and `__paths__`, each leaf's key path as
["k", key] (dict), ["i", index] (list, tuple), ["a", name] (namedtuple
field, dataclass field). Dict keys are visited in sorted order and None is
an empty node, as JAX flattens them, so a checkpoint of dicts, lists and
tuples of arrays written by either package loads in the other.
"""

import dataclasses
import json

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def _children(node):
    """[(path key, child)] of an inner node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(["k", str(k)], node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(["a", f], getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(["i", i], v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(["a", f.name], getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree, prefix=()):
    """[(path, leaf)] in leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(list(prefix), tree)]
    return [pl for key, child in kids for pl in _flatten(child, prefix + (key,))]


def _skeleton(tree):
    """A JSON-able picture of the structure (advisory only)."""
    kids = _children(tree)
    if kids is None:
        return "*"
    return [type(tree).__name__, [[k[1], _skeleton(c)] for k, c in kids]]


def _unflatten(like, leaves):
    """`like` rebuilt with the leaves (an iterator) in leaf order."""
    kids = _children(like)
    if kids is None:
        return _leaf_like(next(leaves), like)
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(c, leaves) for _, c in kids))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(c, leaves) for _, c in kids)
    return dataclasses.replace(like, **{k[1]: _unflatten(c, leaves)
                                        for k, c in kids})


def _leaf_like(arr, like):
    """A stored array as a tensor on the device and dtype of the matching
    leaf of `like` (the array's own dtype, on the CPU, where that leaf is
    not a tensor)."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    return torch.as_tensor(arr)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _json_bytes(obj):
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_checkpoint(path: str, state) -> None:
    """Save a nest of tensors/arrays/scalars to `path` (.npz)."""
    flat = _flatten(state)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, (_, x) in enumerate(flat)}
    arrays["__treedef__"] = _json_bytes(json.dumps(_skeleton(state)))
    arrays["__paths__"] = _json_bytes([p for p, _ in flat])
    np.savez(path, **arrays)


def load_checkpoint(path: str, like):
    """Load a checkpoint into the structure of `like` (a nest of the same
    structure as the saved state); each leaf becomes a tensor on the device
    and dtype of `like`'s leaf.

    Raises ValueError when the stored structure does not match `like`'s:
    the leaf key paths are compared (a checkpoint without them falls back
    to a leaf-count check); the stored `__treedef__` is advisory only.
    """
    with np.load(path, allow_pickle=False) as data:
        n_leaves = sum(1 for f in data.files if f.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
        stored_def = json.loads(bytes(data["__treedef__"]).decode())
        stored_paths = (json.loads(bytes(data["__paths__"]).decode())
                        if "__paths__" in data.files else None)
    like_paths = [p for p, _ in _flatten(like)]
    if stored_paths is not None:
        if like_paths != stored_paths:
            raise ValueError(
                "checkpoint structure mismatch (leaf key paths differ):\n"
                f"  stored: {stored_paths}\n"
                f"  like:   {like_paths}\n"
                f"  stored treedef (advisory): {stored_def}")
    elif len(like_paths) != len(leaves):
        raise ValueError(
            "checkpoint structure mismatch: "
            f"{len(leaves)} stored leaves vs {len(like_paths)} in `like`\n"
            f"  stored treedef (advisory): {stored_def}")
    return _unflatten(like, iter(leaves))
