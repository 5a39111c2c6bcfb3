"""npz checkpoints with the reference's flattened keys.

The port of ``repro.training.checkpoint``: a tree of dicts, lists and
tuples is flattened to path-keyed arrays (dict keys sorted, list items
``L<i>``, tuple items ``T<i>``, joined by "/"), so either package
restores the other's file.  Tensors go through ``.detach().cpu()
.numpy()``; restore rebuilds the structure of ``like`` and checks
shapes.  Convolution leaves are saved in the port's OIHW layout.  A
sharded tree (DTensor leaves) is saved as whole tensors and restored
placed as ``like``'s leaves.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.params import is_dtensor, shard_like


def _sharded(tree) -> bool:
    if isinstance(tree, dict):
        return any(_sharded(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_sharded(v) for v in tree)
    return is_dtensor(tree)


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        tag = "T" if isinstance(tree, tuple) else "L"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{tag}{i}/"))
    elif isinstance(tree, torch.Tensor):
        if is_dtensor(tree):
            tree = tree.full_tensor()
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def save(path: str, tree) -> None:
    """Write ``tree`` to ``path``.  A sharded tree is gathered on every
    rank (call it on all of them) and written by rank 0, the others
    waiting until the file is there."""
    flat = _flatten(tree)
    sharded = _sharded(tree)
    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            dist.barrier()
            return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    if sharded:
        dist.barrier()


def restore(path: str, like):
    """Restore into the structure of ``like`` (values replaced): where
    ``like`` holds a tensor, a tensor of the file's type on that
    tensor's device (a DTensor: placed as it); elsewhere the file's
    numpy array.  Raises on a missing key or a shape that differs from
    ``like``'s."""
    with np.load(path) as data:
        flat = dict(data)

    def rebuild(sub, prefix=""):
        if isinstance(sub, dict):
            return {k: rebuild(sub[k], f"{prefix}{k}/") for k in sub}
        if isinstance(sub, (list, tuple)):
            tag = "T" if isinstance(sub, tuple) else "L"
            vals = [rebuild(v, f"{prefix}{tag}{i}/")
                    for i, v in enumerate(sub)]
            return tuple(vals) if isinstance(sub, tuple) else vals
        key = prefix.rstrip("/")
        if key not in flat:
            raise KeyError(f"{path}: no entry {key!r}")
        arr = flat[key]
        want = tuple(sub.shape) if isinstance(sub, torch.Tensor) \
            else np.shape(sub)
        if arr.shape != want:
            raise ValueError(f"{key}: {arr.shape} != {want}")
        if isinstance(sub, torch.Tensor):
            t = torch.from_numpy(arr).to(sub.device)
            return shard_like(t, sub) if is_dtensor(sub) else t
        return arr

    return rebuild(like)
