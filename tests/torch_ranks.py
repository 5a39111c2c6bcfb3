"""One rank of the port's sharded runs on the CPU, for
tests/test_torch_multidevice.py, tests/test_torch_multidevice_families.py
and tests/test_torch_kv_seq.py (not a test module: it imports no jax, and each rank checks that).

    python tests/torch_ranks.py OUT_DIR STORE RANK WORLD [SUITE]

joins a gloo group of WORLD ranks over the file store STORE, builds a
(data 2, model WORLD // 2) mesh and runs the cases of SUITE (``dense``,
the default, or ``families``; ``SUITES``; or ``kvseq``, the
sequence-split caches of ``KVSEQ_CASES`` alone): for each case of its train
cases a prefill at ``max_len`` S + 4, one greedy decode step and one
train step (loss, every grad leaf, the updated params), unsharded and
sharded on the same params (drawn with numpy from a seed,
``draw_params``, the modality inputs with them, ``draw_extras``), then a
prefill and 2 decode steps under the serving knobs of its serve cases,
then the launcher with ``--model-parallel 2`` (its checkpoint restored
into the sharded tree: ``OUT_DIR/restore.npz``).  Rank 0 writes the
numbers to ``OUT_DIR/<case>.npz``; the launcher writes its checkpoint to
``OUT_DIR/launcher.npz``.
"""

import collections
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
# the hybrid, ssm, audio and VLM families
FAMILY_ARCHS = {"zamba2": "zamba2-2.7b", "xlstm": "xlstm-125m",
                "whisper": "whisper-tiny",
                "vlm": "llama-3.2-vision-90b"}
FAMILY_CASES = [(f"{name}{'-fsdp' if fsdp else ''}", arch, fsdp, None)
                for name, arch in FAMILY_ARCHS.items()
                for fsdp in (False, True)]
FAMILY_SERVE_CASES = [
    ("whisper-int8", "whisper-tiny", None, dict(kv_cache_dtype="int8")),
    ("vlm-inplace", "llama-3.2-vision-90b", None,
     dict(kv_cache_dtype="float32", decode_inplace_cache=True))]
FAMILY_LAUNCHER = ["--arch", "zamba2-2.7b"] + LAUNCHER
# suite -> (train cases, serve cases, launcher arguments)
SUITES = {"dense": (CASES, SERVE_CASES, LAUNCHER),
          "families": (FAMILY_CASES, FAMILY_SERVE_CASES, FAMILY_LAUNCHER)}
# sequence-split caches (suite "kvseq"): (name, arch, num_kv_heads or
# None, rules, RunConfig fields, positions or None), a prefill at
# max_len KV_LEN and 3 greedy decode steps each.  Rules "kv_seq":
# shard_kv_seq=True, the cache's sequence on data, the batch replicated
# (as rules_for gives it at B = 1); "opt": the --opt decode rules, the
# batch on data and, where the KV heads do not split over the model
# axis, the cache's sequence on model; "default": the sequence whole;
# "seq": rules_for's train rules, the activations' sequence on model:
# the prefill and the loss, no decode step (the reference decodes under
# its decode rules, which split no sequence).
# Positions: each row's decode position, set after the prefill, beyond
# the window, data rank 0's own minimum (rows 0-1) not the batch's (rows
# 2-3 hold it), and each row within the window of the batch's minimum:
# a row further ahead keeps no key in the slice, where the plain
# version's softmax over masked scores (the mean of v) and the kernel's
# (0) part (kernels/decode_attention/ref.py).
KV_LEN = S + 4
KV_WINDOW = 8
KV_POS = (24, 26, 20, 23)
F32 = dict(kv_cache_dtype="float32")
SLICE = dict(F32, decode_window=KV_WINDOW, decode_slice_reads=True)
KVSEQ_CASES = [
    ("tinyllama", "tinyllama-1.1b", None, "kv_seq", F32, None),
    ("deepseek", "deepseek-moe-16b", None, "kv_seq", F32, None),
    ("zamba2", "zamba2-2.7b", None, "kv_seq", F32, None),
    ("whisper", "whisper-tiny", None, "kv_seq", F32, None),
    ("vlm", "llama-3.2-vision-90b", None, "kv_seq", F32, None),
    ("tinyllama-kv1-opt", "tinyllama-1.1b", 1, "opt", F32, None),
    ("tinyllama-kv1-opt-inplace", "tinyllama-1.1b", 1, "opt",
     dict(F32, decode_inplace_cache=True, decode_uniform_pos=True), None),
    ("tinyllama-inplace-bf16", "tinyllama-1.1b", None, "kv_seq",
     dict(decode_inplace_cache=True), None),
    ("deepseek-int8", "deepseek-moe-16b", None, "kv_seq",
     dict(kv_cache_dtype="int8"), None),
    ("tinyllama-slice", "tinyllama-1.1b", None, "default", SLICE, KV_POS),
    ("tinyllama-kvseq-slice", "tinyllama-1.1b", None, "kv_seq", SLICE,
     KV_POS),
    ("tinyllama-kv1-opt-slice", "tinyllama-1.1b", 1, "opt", SLICE, KV_POS),
    ("tinyllama-kv1-opt-slice-inplace", "tinyllama-1.1b", 1, "opt",
     dict(SLICE, decode_inplace_cache=True), KV_POS),
    # sequence parallelism, the reference's train rule (seq on model):
    # queries split along the sequence attend over gathered keys
    ("tinyllama-seq", "tinyllama-1.1b", None, "seq", F32, None),
    ("deepseek-seq", "deepseek-moe-16b", None, "seq", F32, None),
    # 3 heads on a model axis of 2: heads whole, the sequence split
    ("tinyllama-h3-seq", "tinyllama-1.1b",
     dict(num_heads=3, num_kv_heads=3, d_model=192), "seq", F32, None),
    ("whisper-seq", "whisper-tiny", None, "seq", F32, None),
    ("vlm-seq", "llama-3.2-vision-90b", None, "seq", F32, None)]
# the kernel wrappers whose calls each run counts: (module, function)
WRAPPERS = {"rmsnorm": ("repro_torch.kernels.rmsnorm.ops", "rmsnorm"),
            "flash_attention": ("repro_torch.kernels.flash_attention.ops",
                                "flash_attention"),
            "decode_attention": ("repro_torch.kernels.decode_attention.ops",
                                 "decode_attention"),
            "ssd_scan": ("repro_torch.kernels.ssd_scan.ops", "ssd_scan")}


def unsharded_launcher(args):
    """The launcher's arguments without ``--model-parallel N``."""
    i = args.index("--model-parallel")
    return args[:i] + args[i + 2:]


def run_group(out, suite: str = "dense", world: int = 4,
              timeout: float = 240.0):
    """Start ``world`` rank processes of this script on ``suite`` over a
    file store in ``out`` and wait for them all, the group under one
    ``timeout`` (a hung rendezvous fails).  Returns each rank's output;
    raises naming the first rank that failed."""
    import subprocess
    import time
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "torch_ranks.py"), str(out),
         str(Path(out) / "store"), str(r), str(world), suite],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root, env=env) for r in range(world)]
    logs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r}:\n{logs[r][-4000:]}")
    return logs


def config(arch, kv=None):
    """``arch``'s smoke variant; ``kv``: its number of KV heads, or a
    dict of fields to replace."""
    from repro_torch.config import get_config, smoke_variant
    cfg = smoke_variant(get_config(arch))
    if isinstance(kv, dict):
        return dataclasses.replace(cfg, **kv)
    return dataclasses.replace(cfg, num_kv_heads=kv) if kv else cfg


def draw_params(cfg, seed: int = SEED):
    """The param tree of ``cfg`` as numpy float32 arrays in the
    reference's layout: ones and zeros where the schema says, normal(0,
    0.02) elsewhere (at the reference's init the smoke configs' softmaxes
    are one-hot and a rounding flips them), and the VLM's tanh gates
    uniform in [0.5, 1] (its zero gates hide cross attention)."""
    from repro_torch.models import api
    from repro_torch.models.params import map_schema
    rng = np.random.default_rng(seed)

    def leaf(p, path):
        if path.endswith(("/gate_attn", "/gate_mlp")):
            return rng.uniform(0.5, 1.0, p.shape).astype(np.float32)
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


def draw_extras(cfg, seed: int = SEED):
    """The modality inputs (numpy float32, standard normal): whisper's
    ``audio_frames``, the VLM's ``vision_embeds``; None elsewhere."""
    rng = np.random.default_rng(seed + 2)
    if cfg.family == "audio":
        return {"audio_frames": rng.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"vision_embeds": rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)}
    return None


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _numpy(t):
    """A cache leaf, whole, as numpy (bfloat16 as float32: exact)."""
    t = _full(t)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _torch_extras(cfg):
    e = draw_extras(cfg)
    return None if e is None else {k: torch.tensor(v) for k, v in e.items()}


class count_calls:
    """Counts each kernel wrapper's calls (``WRAPPERS``) while active and
    ``on``."""

    def __enter__(self):
        import importlib
        self.calls, self._saved, self.on = collections.Counter(), [], True
        for name, (mod, fn) in WRAPPERS.items():
            m = importlib.import_module(mod)
            real = getattr(m, fn)

            def counted(*a, _real=real, _name=name, **k):
                self.calls[_name] += self.on
                return _real(*a, **k)
            self._saved.append((m, fn, real))
            setattr(m, fn, counted)
        return self

    def __exit__(self, *exc):
        for m, fn, real in self._saved:
            setattr(m, fn, real)
        return False


def placed_as_specs(cfg, run, rules, mesh, cache) -> bool:
    """Every DTensor leaf of ``cache`` placed as ``cache_pspecs`` says."""
    from repro_torch.launch import shardings as shd
    want = shd.to_shardings(mesh, shd.cache_pspecs(cfg, run, rules))

    def walk(w, c):
        if isinstance(c, dict):
            return all(walk(w[k], c[k]) for k in c)
        if isinstance(c, tuple):
            return all(walk(a, b) for a, b in zip(w, c, strict=True))
        return list(c.placements) == list(w)
    return walk(want, cache)


def run_case(mesh, arch, fsdp, kv):
    """Both runs of one case: a dict of numpy results (every rank
    computes it; the collectives need them all)."""
    from repro_torch.config import RunConfig, sharding_rules_for
    from repro_torch.launch import mesh as meshes, shardings as shd
    from repro_torch.models import api, moe
    from repro_torch.models.params import params_from_numpy, use_rules
    from repro_torch.models.transformer import place_cache
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train import make_train_step

    cfg = config(arch, kv)
    run = RunConfig(fsdp=fsdp, kv_cache_dtype="float32")
    rules = sharding_rules_for(cfg, meshes.mesh_axis_sizes(mesh), run)
    tree = draw_params(cfg)
    schema = api.get_model(cfg).schema(cfg)
    toks, labels = (torch.tensor(a) for a in draw_tokens(cfg))
    extras = _torch_extras(cfg)

    # each batch row's routing, recorded from both runs (the sharded
    # run's rows are this rank's: its coordinate on "data")
    routes = {}
    real_dispatch = moe._dispatch

    def recording(c, x, router, cf):
        out = real_dispatch(c, x, router, cf)
        if counter.on:
            routes.setdefault(key, []).append(out[0].clone())
        return out
    moe._dispatch = recording

    out = {}
    for key in ("plain", "sharded"):
        params = params_from_numpy(schema, tree, "cpu")
        if key == "sharded":
            params = shd.distribute(params, mesh, shd.model_param_pspecs(
                cfg, rules, fsdp))
        with use_rules(rules if key == "sharded" else None), \
                count_calls() as counter:
            with torch.no_grad():
                logits, cache = api.make_prefill_step(cfg, run, S + 4)(
                    params, toks, extras)
                tok = _full(logits)[:, -1:].argmax(-1)
                out[f"{key}_cache"] = [_numpy(t) for t in opt.leaves(cache)]
                out["cache_dtypes"] = np.array(
                    [str(t.dtype) for t in opt.leaves(cache)])
                if key == "plain":
                    plain_cache, plain_tok = cache, tok
                dec, cache2 = api.make_decode_step(cfg, run)(
                    params, tok, cache, extras)
                if key == "sharded":
                    # the step alone (not counted, its routes not
                    # recorded): from the unsharded
                    # prefill's cache placed on the mesh, at the unsharded
                    # run's token
                    counter.on = False
                    step, _ = api.make_decode_step(cfg, run)(
                        params, plain_tok, place_cache(
                            cfg, run, plain_cache, mesh), extras)
                    counter.on = True
                    out["sharded_step"] = _full(step).numpy()
            if key == "sharded":
                out["placed"] = all(placed_as_specs(cfg, run, rules, mesh, c)
                                    for c in (cache, cache2))
            out[f"{key}_prefill"] = _full(logits).numpy()
            out[f"{key}_decode"] = _full(dec).numpy()
            out[f"{key}_tokens"] = np.concatenate(
                [tok.numpy(), _full(dec).argmax(-1).numpy()], axis=1)
            state = opt.init_state(params)
            params, state, m = make_train_step(cfg, run)(
                params, state, toks, labels, extras)
            out[f"{key}_loss"] = float(m["loss"])
            out[f"{key}_gnorm"] = float(_full(m["grad_norm"]))
            out[f"{key}_grads"] = [_full(p.grad).detach().numpy()
                                   for p in opt.leaves(params)]
            out[f"{key}_updated"] = [_full(p).detach().numpy()
                                     for p in opt.leaves(params)]
        out[f"{key}_calls"] = np.array([counter.calls[n] for n in WRAPPERS])
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
    sharded: each step's logits and the tokens, and each sharded decode
    step alone, from the unsharded run's cache placed on the mesh
    (``sharded_steps``)."""
    from repro_torch.config import RunConfig, sharding_rules_for
    from repro_torch.launch import mesh as meshes, shardings as shd
    from repro_torch.models import api
    from repro_torch.models.params import params_from_numpy, use_rules
    from repro_torch.models.transformer import place_cache
    cfg = config(arch, kv)
    run = RunConfig(**knobs)
    rules = sharding_rules_for(cfg, meshes.mesh_axis_sizes(mesh), run)
    plain = params_from_numpy(api.get_model(cfg).schema(cfg),
                              draw_params(cfg), "cpu")
    toks = torch.tensor(draw_tokens(cfg)[0])
    extras = _torch_extras(cfg)
    decode = api.make_decode_step(cfg, run)
    out, plain_caches = {}, []
    for key in ("plain", "sharded"):
        params = plain if key == "plain" else shd.distribute(
            plain, mesh, shd.model_param_pspecs(cfg, rules, False))
        steps, tokens, alone = [], [], []
        with use_rules(rules if key == "sharded" else None), \
                torch.no_grad():
            logits, cache = api.make_prefill_step(cfg, run, S + 4)(
                params, toks, extras)
            if key == "sharded":
                out["placed"] = placed_as_specs(cfg, run, rules, mesh, cache)
            for i in range(3):
                full = _full(logits)[:, -1:]
                steps.append(full.numpy())
                tokens.append(full.argmax(-1).numpy())
                if i == 2:
                    break
                if key == "plain":
                    # a copy: the in-place decode writes the one it reads
                    plain_caches.append(_clone(cache))
                else:
                    one, _ = decode(params, torch.tensor(
                        out["plain_tokens"][:, i:i + 1]), place_cache(
                        cfg, run, plain_caches[i], mesh), extras)
                    alone.append(_full(one).numpy())
                logits, cache = decode(params, torch.tensor(tokens[-1]),
                                       cache, extras)
        out[f"{key}_logits"] = np.stack(steps)
        out[f"{key}_tokens"] = np.concatenate(tokens, axis=1)
    out["sharded_steps"] = np.array(alone, dtype=np.float32).reshape(
        (len(alone),) + out["plain_logits"].shape[1:])
    return out


def kvseq_rules(cfg, run, mesh, kind: str) -> dict:
    """The rules of a ``KVSEQ_CASES`` entry (see there)."""
    from repro_torch.config import ShapeConfig, sharding_rules_for
    from repro_torch.launch import dryrun, mesh as meshes
    if kind in ("opt", "seq"):
        step = "decode" if kind == "opt" else "train"
        return dryrun.rules_for(cfg, ShapeConfig(step, KV_LEN, B, step),
                                run, mesh, kind == "opt")
    rules = sharding_rules_for(cfg, meshes.mesh_axis_sizes(mesh), run)
    if kind == "kv_seq":
        rules["batch"] = None
    return rules


def run_kvseq_case(mesh, arch, kv, kind, knobs, positions):
    """A prefill and 3 greedy decode steps (none under the train rules),
    unsharded and on the mesh under the case's rules: each step's
    logits, the tokens, every leaf
    of both final caches, whole, the mesh dims that split the sharded
    cache's sequence, and each sharded decode step alone, from the
    unsharded run's cache placed on the mesh (``sharded_steps``)."""
    from repro_torch.config import RunConfig
    from repro_torch.launch import shardings as shd
    from repro_torch.models import api
    from repro_torch.models.params import seq_dims
    from repro_torch.models.params import (params_from_numpy, shard_batch,
                                           use_rules)
    from repro_torch.models.transformer import place_cache
    from repro_torch.training import optimizer as opt
    cfg = config(arch, kv)
    run = RunConfig(shard_kv_seq=kind == "kv_seq", **knobs)
    rules = kvseq_rules(cfg, run, mesh, kind)
    plain = params_from_numpy(api.get_model(cfg).schema(cfg),
                              draw_params(cfg), "cpu")
    toks = torch.tensor(draw_tokens(cfg)[0])
    extras = _torch_extras(cfg)
    decode = api.make_decode_step(cfg, run)
    out, plain_caches = {}, []
    for key in ("plain", "sharded"):
        params = plain if key == "plain" else shd.distribute(
            plain, mesh, shd.model_param_pspecs(cfg, rules, run.fsdp))
        steps, tokens, alone = [], [], []
        with use_rules(rules if key == "sharded" else None), \
                torch.no_grad():
            logits, cache = api.make_prefill_step(cfg, run, KV_LEN)(
                params, toks, extras)
            if positions is not None:
                cache = dict(cache, pos=shard_batch(params, torch.tensor(
                    positions, dtype=torch.int32)))
            if key == "sharded":
                out["placed"] = placed_as_specs(cfg, run, rules, mesh, cache)
                k = cache["k"]["q"] if isinstance(cache["k"], dict) \
                    else cache["k"]
                # one layer's (B, S, KV, D) buffer
                out["seq_dims"] = np.array(
                    seq_dims(k.flatten(0, k.dim() - 5)[0]), dtype=np.int64)
            decodes = 0 if kind == "seq" else 3
            for i in range(decodes + 1):
                full = _full(logits)[:, -1:]
                steps.append(full.numpy())
                tokens.append(full.argmax(-1).numpy())
                if i == decodes:
                    break
                if key == "plain":
                    plain_caches.append(_clone(cache))
                else:
                    one, _ = decode(params, torch.tensor(
                        out["plain_tokens"][:, i:i + 1]), place_cache(
                        cfg, run, _clone(plain_caches[i]), mesh), extras)
                    alone.append(_full(one).numpy())
                logits, cache = decode(params, torch.tensor(tokens[-1]),
                                       cache, extras)
            leaves = [_numpy(t) for t in opt.leaves(cache)]
            if kind == "seq":
                toks_l, labels = (torch.tensor(a) for a in draw_tokens(cfg))
                loss, _ = api.make_train_step(cfg, run)(params, toks_l,
                                                        labels, extras)
                out[f"{key}_loss"] = float(_full(loss))
        out[f"{key}_logits"] = np.stack(steps)
        out[f"{key}_tokens"] = np.concatenate(tokens, axis=1)
        out.update({f"{key}_cache_{i}": a for i, a in enumerate(leaves)})
    out["cache_dtypes"] = np.array([str(t.dtype) for t in opt.leaves(cache)])
    out["sharded_steps"] = np.array(alone, dtype=np.float32).reshape(
        (len(alone),) + out["plain_logits"].shape[1:])
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def main():
    out_dir, store, rank, world = sys.argv[1], sys.argv[2], \
        int(sys.argv[3]), int(sys.argv[4])
    suite = sys.argv[5] if len(sys.argv) > 5 else "dense"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch import mesh as meshes, train as launch_train
        mesh = meshes.make_host_mesh(model=2, device_type="cpu")
        if suite == "kvseq":
            for name, *case in KVSEQ_CASES:
                res = run_kvseq_case(mesh, *case)
                if rank == 0:
                    np.savez(os.path.join(out_dir, f"{name}.npz"), **res)
            assert "jax" not in sys.modules, "a rank imported jax"
            return
        cases, serve_cases, launcher = SUITES[suite]
        for name, arch, fsdp, kv in cases:
            res = run_case(mesh, arch, fsdp, kv)
            if rank == 0:
                flat = {k: v for k, v in res.items()
                        if not isinstance(v, list)}
                for k, v in res.items():
                    if isinstance(v, list):
                        flat.update({f"{k}_{i}": a for i, a in enumerate(v)})
                np.savez(os.path.join(out_dir, f"{name}.npz"), **flat)
        for name, arch, kv, knobs in serve_cases:
            res = run_serve_case(mesh, arch, kv, knobs)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"), **res)
        ckpt = os.path.join(out_dir, "launcher.npz")
        params, state = launch_train.main(launcher + ["--ckpt", ckpt])
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
