"""Checkpoint and resume of solver state, in the `.npz` format of
`piccolax.utils.checkpoint`: one array a leaf, keyed by its path as JAX
spells it (".Z" for a dataclass field, "['goal']" for a dict key, "[0]"
for a sequence index, joined by "/"). A checkpoint written by piccolax
therefore resumes in the port and the other way round; an IPMState of
one problem has the leaves of piccolax's, a batched one a leading [B].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["save_solver_state", "load_solver_state", "save_pytree", "load_pytree"]


def _flatten(tree, prefix=()):
    """[(key path, leaf)] in JAX's order (dict keys sorted)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [kv for key, v in items for kv in _flatten(v, prefix + (key,))]


def _as_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Flat .npz of a tree of dataclasses, dicts, lists and tensors."""
    np.savez(path, **{k: _as_numpy(v) for k, v in _flatten(tree)})


def _rebuild(tree, leaves):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def load_pytree(path: str, like):
    """The arrays of `save_pytree` in the structure of `like`, each as a
    tensor of its like-leaf's dtype and device."""
    raw = np.load(path, allow_pickle=False)
    new = []
    for key, leaf in _flatten(like):
        arr = torch.as_tensor(raw[key])
        if isinstance(leaf, torch.Tensor):
            arr = arr.to(leaf.device, leaf.dtype)
        new.append(arr)
    return _rebuild(like, iter(new))


def save_solver_state(path: str, state) -> None:
    """Persist a whole IPMState (primal and dual iterates, barrier,
    counters)."""
    save_pytree(path, state)


def load_solver_state(path: str, like=None, device="cpu"):
    """An IPMState saved by `save_solver_state` (or by piccolax), for
    `solve_nlp(..., resume_from=)`: in the structure, dtypes and device
    of `like`, or without it on `device` in the file's own dtypes."""
    from ..solver.ipm import IPMState
    if like is not None:
        return load_pytree(path, like)
    raw = np.load(path, allow_pickle=False)
    return IPMState(**{f.name: torch.as_tensor(raw[f".{f.name}"]).to(device)
                       for f in dataclasses.fields(IPMState)})
