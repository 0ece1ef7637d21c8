"""Fault-tolerant checkpointing, mirroring ``repro.train.checkpoint``:
atomic, content-hashed, async-capable, in the JAX package's layout.

Layout: <dir>/step_<n>/  { manifest.json, <leaf-id>.npy ... }, a leaf id
being the JAX package's (``_leaf_id``: "params.main.0.wq",
"opt.mu.embed", "opt.step"), so that a checkpoint written by either
package restores into the other.  A tree is nested dicts, tuples, lists
and NamedTuples of tensors or arrays; a ``models.model.Params`` in it is
written as the JAX package's parameter tree (``weights.leaves``' names,
a "main" or "encoder" leaf stacked over its superblocks).  Writes go to
a tmp directory of the writer's own and are renamed into place only
after the manifest is synced, so a crash mid-save never leaves a torn
checkpoint where ``latest_step`` looks; each leaf records a SHA-256 that
``restore`` verifies.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models import model, weights


def _key(prefix: str, k) -> str:
    return f"{prefix}.{k}" if prefix else str(k)


def _items(tree):
    """A node's (key, child) pairs, or ``None`` for a leaf."""
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (tuple, list)):
        return zip(tree._fields, tree) if hasattr(tree, "_fields") else enumerate(tree)
    return None


def _leaves(tree, prefix: str = ""):
    """(leaf id, leaf) of a tree; a Params' leaves are its masters, a
    stacked leaf the list of its superblocks' tensors."""
    if isinstance(tree, model.Params):
        parts = {}
        for name, i, t in weights.leaves(tree):
            if i is None:
                parts[name] = t
            else:
                parts.setdefault(name, []).append(t)
        for name, leaf in parts.items():
            yield _key(prefix, name), leaf
        return
    items = _items(tree)
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, _key(prefix, k))


def _host(leaf) -> np.ndarray:
    """A leaf on the host (a bfloat16 tensor in float32: numpy has none)."""
    if isinstance(leaf, list):
        return np.stack([_host(t) for t in leaf])
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def _shape(leaf) -> list:
    if isinstance(leaf, list):
        return [len(leaf), *leaf[0].shape]
    return list(np.shape(leaf))


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True):
    """Checkpoint a tree.  The leaves are copied to the host first; with
    ``blocking=False`` the files are written on a daemon thread (returned),
    so the train loop never waits on I/O; the rename still keeps every
    checkpoint whole."""
    leaves = [(lid, _host(leaf)) for lid, leaf in _leaves(tree)]

    def work():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        # a tmp dir per writer: an async save and a final blocking save of
        # the same step never share one (the first to land wins)
        tmp = final + f".tmp.{os.getpid()}.{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for lid, arr in leaves:
            np.save(os.path.join(tmp, lid + ".npy"), arr)
            manifest["leaves"][lid] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                                       "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):  # another writer already landed this step
            shutil.rmtree(tmp)
            return
        os.rename(tmp, final)

    if blocking:
        work()
        return None
    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    """The newest whole checkpoint's step (tmp directories are not)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and ".tmp" not in d]
    return max(steps) if steps else None


def _rebuild(like, loaded: dict, prefix: str = ""):
    """``like``'s structure with each leaf from ``loaded`` (id -> array):
    tensors on ``like``'s device in its dtype, a Params rebuilt as
    ``like`` (``weights.from_jax_params``, trainable if it is)."""
    if isinstance(like, model.Params):
        flat = {name: loaded[_key(prefix, name)] for name, i, _ in weights.leaves(like)}
        trainable = any(t.requires_grad for t in like.parameters())
        return weights.from_jax_params(weights.layout(flat, like.cfg), like.cfg, like.device,
                                       trainable=trainable)
    items = _items(like)
    if items is None:
        arr = loaded[prefix]
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
        return arr
    vals = [_rebuild(v, loaded, _key(prefix, k)) for k, v in items]
    if isinstance(like, dict):
        return dict(zip(like, vals))
    return type(like)(*vals) if hasattr(like, "_fields") else type(like)(vals)


def restore(ckpt_dir: str, step: int, like_tree):
    """The checkpoint of ``step`` in the structure of ``like_tree`` (new
    tensors; ``like_tree`` is only read for its structure, shapes, dtypes
    and devices), after checking each leaf's SHA-256 (``IOError``) and
    shape (``ValueError``)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = {}
    for lid, like in _leaves(like_tree):
        meta = manifest["leaves"][lid]
        arr = np.load(os.path.join(d, lid + ".npy"))
        if hashlib.sha256(arr.tobytes()).hexdigest() != meta["sha256"]:
            raise IOError(f"checkpoint integrity failure for leaf {lid}")
        if list(arr.shape) != _shape(like):
            raise ValueError(f"shape mismatch for {lid}: {arr.shape} vs {_shape(like)}")
        loaded[lid] = arr
    return _rebuild(like_tree, loaded)
