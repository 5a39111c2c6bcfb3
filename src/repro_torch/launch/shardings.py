"""Sharding assignment for step-function inputs (params, optimizer state,
token batches, decode caches) from the logical-axis rules.

The port of ``repro.launch.shardings``: every function returns the
reference's ``PartitionSpec`` trees as the port's ``PS`` (a tuple of
None, a mesh-axis name or a tuple of names per dim).  ``to_shardings``
turns a tree of them into DTensor placements on a
``torch.distributed`` device mesh (the reference's ``NamedSharding``),
and ``distribute`` places a tree of whole tensors there (its
``jax.device_put``).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.config import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.models.params import (PS, _names, axis_part, placements,
                                       shard_as)


def _ax(rules: dict, name: Optional[str]):
    return axis_part(rules, name)


def param_rules(rules: dict, fsdp: bool) -> dict:
    """Parameter sharding rules: FSDP additionally shards the embed axis of
    *weights* over the data axes (activations keep embed replicated)."""
    if not fsdp:
        return rules
    r = dict(rules)
    r["embed"] = ("data",)
    return r


def batch_spec(rules, *trailing):
    return PS(_ax(rules, "batch"), *[_ax(rules, t) for t in trailing])


def kv_spec(rules, lead_axes: int):
    """KV cache buffer (lead..., B, S, KV, D).  Raises ``ValueError``
    where the rules put ``batch`` and ``kv_seq`` on one mesh axis (the
    reference's ``PartitionSpec`` refuses a duplicated axis too; its
    dry run drops ``batch`` at B = 1, ``long_500k``)."""
    batch, seq = _ax(rules, "batch"), _ax(rules, "kv_seq")
    both = set(_names(batch)) & set(_names(seq))
    if both:
        raise ValueError(f"the rules put batch ({batch}) and kv_seq "
                         f"({seq}) on the same mesh axis {sorted(both)}")
    return PS(*([None] * lead_axes), batch, seq, _ax(rules, "kv_heads"),
              None)


def _kv_tree(rules, lead: int, kv_dtype: str, cross: bool = False):
    # cross-attention KV buffers hold the (short, often non-divisible)
    # vision/audio token axis — never sequence-sharded
    r = dict(rules, kv_seq=None) if cross else rules
    if kv_dtype == "int8":
        return {"q": kv_spec(r, lead),
                "s": PS(*([None] * lead), _ax(r, "batch"),
                        _ax(r, "kv_seq"), _ax(r, "kv_heads"))}
    return kv_spec(r, lead)


def cache_pspecs(cfg: ModelConfig, run: RunConfig, rules: dict):
    """PS tree matching ``<model>.init_cache`` structurally."""
    b = _ax(rules, "batch")
    kvd = run.kv_cache_dtype
    if cfg.family in ("dense", "moe"):
        return {"pos": PS(b), "k": _kv_tree(rules, 1, kvd),
                "v": _kv_tree(rules, 1, kvd)}
    if cfg.family == "vlm":
        return {"pos": PS(b),
                "k": _kv_tree(rules, 2, kvd), "v": _kv_tree(rules, 2, kvd),
                "cross_k": _kv_tree(rules, 1, kvd, cross=True),
                "cross_v": _kv_tree(rules, 1, kvd, cross=True)}
    if cfg.family == "audio":
        return {"pos": PS(b),
                "k": _kv_tree(rules, 1, kvd), "v": _kv_tree(rules, 1, kvd),
                "cross_k": _kv_tree(rules, 1, kvd, cross=True),
                "cross_v": _kv_tree(rules, 1, kvd, cross=True)}
    if cfg.family == "hybrid":
        ssm_h = _ax(rules, "ssm_inner")   # heads of the inner dim
        return {"pos": PS(b),
                "k": _kv_tree(rules, 1, kvd), "v": _kv_tree(rules, 1, kvd),
                "ssm": {"conv": PS(None, None, b, None, None),
                        "ssm": PS(None, None, b, ssm_h, None, None)}}
    if cfg.family == "ssm":
        return {"pos": PS(b),
                "mlstm": {"conv": PS(None, b, None, _ax(rules, "ssm_inner")),
                          "mem": PS(None, b, None, None, None)},
                "slstm": {"cell": tuple(PS(None, b, None)
                                        for _ in range(4))}}
    raise ValueError(cfg.family)


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
                 rules: dict):
    """PS tree matching ``api.input_specs``."""
    specs = {}
    if shape.kind == "train":
        specs["tokens"] = batch_spec(rules, None)
        specs["labels"] = batch_spec(rules, None)
    elif shape.kind == "prefill":
        specs["tokens"] = batch_spec(rules, None)
    else:
        specs["token"] = batch_spec(rules, None)
        specs["cache"] = cache_pspecs(cfg, run, rules)
    if cfg.family == "audio":
        specs["extras"] = {"audio_frames": batch_spec(rules, None, None)}
    if cfg.family == "vlm":
        specs["extras"] = {"vision_embeds": batch_spec(rules, None, None)}
    return specs


def model_param_pspecs(cfg: ModelConfig, rules: dict, fsdp: bool):
    return api.model_pspecs(cfg, param_rules(rules, fsdp))


def opt_state_pspecs(cfg: ModelConfig, rules: dict, fsdp: bool):
    pspec = model_param_pspecs(cfg, rules, fsdp)
    return {"step": PS(), "m": pspec, "v": pspec}


def _map_specs(fn, tree, *others):
    """``fn(spec, *leaves)`` over a PS tree and trees of its structure."""
    if isinstance(tree, PS):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_specs(fn, v, *(o[i] for o in others))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    raise TypeError(f"unexpected spec node {type(tree)}")


def to_shardings(mesh, pspec_tree):
    """The DTensor placements of every PS in the tree on ``mesh``: one
    placement per mesh dim, ``Shard(d)`` on each mesh axis that names
    dim d (both, in mesh order, for a dim named by two) and
    ``Replicate()`` elsewhere."""
    return _map_specs(lambda ps: list(placements(mesh, ps)), pspec_tree)


def distribute(tree, mesh, spec_tree):
    """Every whole tensor of ``tree`` (the same on every rank) as a
    DTensor with its spec's placements on ``mesh``, built from this
    rank's block (no collective, and no copy of a leaf nothing splits).
    Leaves that are not tensors pass as they are."""
    import torch

    def put(ps, t):
        return shard_as(t, mesh, ps) if isinstance(t, torch.Tensor) else t
    return _map_specs(put, spec_tree, tree)
