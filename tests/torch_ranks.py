"""One rank of the port's sharded runs on the CPU, for
tests/test_torch_multidevice.py (not a test module: it imports no jax,
and each rank checks that).

    python tests/torch_ranks.py OUT_DIR STORE RANK WORLD

joins a gloo group of WORLD ranks over the file store STORE, builds a
(data 2, model WORLD // 2) mesh and runs, for each case of
``CASES``, a prefill at ``max_len`` S + 4, one greedy decode step and
one train step (loss, every grad leaf, the updated params), unsharded
and sharded on the same params (drawn with numpy from a seed,
``draw_params``), then a prefill and 2 decode steps under the serving knobs of
``SERVE_CASES``, then the launcher with ``--model-parallel 2`` (its
checkpoint restored into the sharded tree: ``OUT_DIR/restore.npz``).  Rank 0
writes the numbers to ``OUT_DIR/<case>.npz``; the launcher writes its
checkpoint to ``OUT_DIR/launcher.npz``.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

B, S = 4, 32
SEED = 5
# (name, arch, fsdp, num_kv_heads or None)
CASES = [("tinyllama", "tinyllama-1.1b", False, None),
         ("tinyllama-fsdp", "tinyllama-1.1b", True, None),
         ("tinyllama-kv1", "tinyllama-1.1b", False, 1),
         ("tinyllama-kv1-fsdp", "tinyllama-1.1b", True, 1),
         ("deepseek", "deepseek-moe-16b", False, None),
         ("deepseek-fsdp", "deepseek-moe-16b", True, None)]
# serving knobs on the mesh: (name, arch, num_kv_heads or None, RunConfig
# fields), a prefill and 2 greedy decode steps each
SERVE_CASES = [("tinyllama-int8", "tinyllama-1.1b", None,
                dict(kv_cache_dtype="int8")),
               ("tinyllama-kv1-inplace", "tinyllama-1.1b", 1,
                dict(kv_cache_dtype="float32", decode_inplace_cache=True)),
               ("deepseek-last", "deepseek-moe-16b", None,
                dict(kv_cache_dtype="float32", prefill_logits="last"))]
LAUNCHER = ["--smoke", "--model-parallel", "2", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq-len", "16"]


def config(arch, kv=None):
    from repro_torch.config import get_config, smoke_variant
    cfg = smoke_variant(get_config(arch))
    return dataclasses.replace(cfg, num_kv_heads=kv) if kv else cfg


def draw_params(cfg, seed: int = SEED):
    """The param tree of ``cfg`` as numpy float32 arrays in the
    reference's layout: ones and zeros where the schema says, normal(0,
    0.02) elsewhere (at the reference's init the smoke configs' softmaxes
    are one-hot and a rounding flips them)."""
    from repro_torch.models import api
    from repro_torch.models.params import map_schema
    rng = np.random.default_rng(seed)

    def leaf(p, _path):
        if p.init == "ones":
            return np.ones(p.shape, np.float32)
        if p.init == "zeros":
            return np.zeros(p.shape, np.float32)
        return rng.normal(0.0, 0.02, p.shape).astype(np.float32)
    return map_schema(leaf, api.get_model(cfg).schema(cfg))


def draw_tokens(cfg, seed: int = SEED):
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return toks[:, :-1], toks[:, 1:]


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def run_case(mesh, arch, fsdp, kv):
    """Both runs of one case: a dict of numpy results (every rank
    computes it; the collectives need them all)."""
    from repro_torch.config import RunConfig, sharding_rules_for
    from repro_torch.launch import mesh as meshes, shardings as shd
    from repro_torch.models import api, moe
    from repro_torch.models.params import params_from_numpy, use_rules
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train import make_train_step

    cfg = config(arch, kv)
    run = RunConfig(fsdp=fsdp, kv_cache_dtype="float32")
    rules = sharding_rules_for(cfg, meshes.mesh_axis_sizes(mesh), run)
    tree = draw_params(cfg)
    schema = api.get_model(cfg).schema(cfg)
    toks, labels = (torch.tensor(a) for a in draw_tokens(cfg))

    # each batch row's routing, recorded from both runs (the sharded
    # run's rows are this rank's: its coordinate on "data")
    routes = {}
    real_dispatch = moe._dispatch

    def recording(c, x, router, cf):
        out = real_dispatch(c, x, router, cf)
        routes.setdefault(key, []).append(out[0].clone())
        return out
    moe._dispatch = recording

    out = {}
    for key in ("plain", "sharded"):
        params = params_from_numpy(schema, tree, "cpu")
        if key == "sharded":
            params = shd.distribute(params, mesh, shd.model_param_pspecs(
                cfg, rules, fsdp))
        with use_rules(rules if key == "sharded" else None):
            with torch.no_grad():
                logits, cache = api.make_prefill_step(cfg, run, S + 4)(
                    params, toks)
                tok = _full(logits)[:, -1:].argmax(-1)
                dec, _ = api.make_decode_step(cfg, run)(params, tok, cache)
            out[f"{key}_prefill"] = _full(logits).numpy()
            out[f"{key}_decode"] = _full(dec).numpy()
            out[f"{key}_tokens"] = np.concatenate(
                [tok.numpy(), _full(dec).argmax(-1).numpy()], axis=1)
            state = opt.init_state(params)
            params, state, m = make_train_step(cfg, run)(
                params, state, toks, labels)
            out[f"{key}_loss"] = float(m["loss"])
            out[f"{key}_gnorm"] = float(_full(m["grad_norm"]))
            out[f"{key}_grads"] = [_full(p.grad).detach().numpy()
                                   for p in opt.leaves(params)]
            out[f"{key}_updated"] = [_full(p).detach().numpy()
                                     for p in opt.leaves(params)]
    moe._dispatch = real_dispatch

    flips = 0
    if routes:
        rows = B // mesh.size(0)
        lo = mesh.get_coordinate()[0] * rows
        for a, b in zip(routes["plain"], routes["sharded"]):
            flips += int((a[lo:lo + rows] != b).sum())
    flips_t = torch.tensor([flips])
    # each data row is held by every rank of its model group
    dist.all_reduce(flips_t)
    out["flips"] = int(flips_t) // mesh.size(1)
    return out


def run_serve_case(mesh, arch, kv, knobs):
    """A prefill and 2 greedy decode steps under ``knobs``, unsharded and
    sharded: each step's logits and the tokens."""
    from repro_torch.config import RunConfig, sharding_rules_for
    from repro_torch.launch import mesh as meshes, shardings as shd
    from repro_torch.models import api
    from repro_torch.models.params import params_from_numpy, use_rules
    cfg = config(arch, kv)
    run = RunConfig(**knobs)
    rules = sharding_rules_for(cfg, meshes.mesh_axis_sizes(mesh), run)
    plain = params_from_numpy(api.get_model(cfg).schema(cfg),
                              draw_params(cfg), "cpu")
    toks = torch.tensor(draw_tokens(cfg)[0])
    out = {}
    for key in ("plain", "sharded"):
        params = plain if key == "plain" else shd.distribute(
            plain, mesh, shd.model_param_pspecs(cfg, rules, False))
        steps, tokens = [], []
        with use_rules(rules if key == "sharded" else None), \
                torch.no_grad():
            logits, cache = api.make_prefill_step(cfg, run, S + 4)(
                params, toks)
            for i in range(3):
                full = _full(logits)[:, -1:]
                steps.append(full.numpy())
                tokens.append(full.argmax(-1).numpy())
                if i < 2:
                    logits, cache = api.make_decode_step(cfg, run)(
                        params, torch.tensor(tokens[-1]), cache)
        out[f"{key}_logits"] = np.stack(steps)
        out[f"{key}_tokens"] = np.concatenate(tokens, axis=1)
    return out


def main():
    out_dir, store, rank, world = sys.argv[1], sys.argv[2], \
        int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch import mesh as meshes, train as launch_train
        mesh = meshes.make_host_mesh(model=2, device_type="cpu")
        for name, arch, fsdp, kv in CASES:
            res = run_case(mesh, arch, fsdp, kv)
            if rank == 0:
                flat = {k: v for k, v in res.items()
                        if not isinstance(v, list)}
                for k, v in res.items():
                    if isinstance(v, list):
                        flat.update({f"{k}_{i}": a for i, a in enumerate(v)})
                np.savez(os.path.join(out_dir, f"{name}.npz"), **flat)
        for name, arch, kv, knobs in SERVE_CASES:
            res = run_serve_case(mesh, arch, kv, knobs)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"), **res)
        ckpt = os.path.join(out_dir, "launcher.npz")
        params, state = launch_train.main(LAUNCHER + ["--ckpt", ckpt])
        # restored placed as the launcher's sharded tree, equal to it
        from repro_torch.training import checkpoint, optimizer as opt
        like = {"params": params, "opt": state}
        back = checkpoint.restore(ckpt, like)
        err, placed = 0.0, True
        for a, b in zip(opt.leaves(like), opt.leaves(back), strict=True):
            if hasattr(a, "placements"):
                placed &= tuple(a.placements) == tuple(b.placements)
            err = max(err, float((_full(a) - _full(b)).abs().max()))
        # a DTensor never reaches a kernel wrapper (its raw pointers are
        # not the local block's): each refuses one
        from repro_torch.kernels.decode_attention import ops as dec
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.rmsnorm import ops as rms
        from repro_torch.models.params import PS, shard_as
        q = shard_as(torch.ones(4, 1, 2, 8), mesh, PS("data"))
        refused = 0
        for call in (lambda: rms.rmsnorm(q, torch.ones(8)),
                     lambda: fa.flash_attention(q, q, q),
                     lambda: dec.decode_attention(q, q, q, 1)):
            try:
                call()
            except TypeError as e:
                refused += "local_map" in str(e)
        if rank == 0:
            np.savez(os.path.join(out_dir, "restore.npz"), err=err,
                     placed=placed, refused=refused)
        assert "jax" not in sys.modules, "a rank imported jax"
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
