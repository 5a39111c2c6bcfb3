"""How far the bucketed engine's images are from the dict engine's on one
card, and why.

    python3 tools/check_bucketed_padding.py [--seeds 2]
        [--parts ops knobs timing images]

The bucketed engine runs a batch of B services at the padded width
shape_bucket(B); the dict engine at B.  Three parts, each printed one
line a row and written to chiprun_out/check_bucketed_padding.json:

  ops      -- which operation of the U-Net gives a row another result
              at the padded width: the full-width U-Net (conv_out
              redrawn) runs one forward at shape_bucket(B) with B real
              rows, for every B of 1..15 that is not its own bucket; at
              every call of a convolution, groupnorm_silu, group norm,
              matmul and softmax, each way of computing that operation
              (its alternatives below) runs on the whole batch and on
              its B real rows alone, and the rows are compared bit for
              bit.  Then the whole forward the same way, under each of
              KNOBS.
  knobs    -- the full-width U-Net (conv_out redrawn) on a plan whose
              batches take every size 16..1, bucketed against dict,
              under each of KNOBS for the whole run: which one closes
              the gap.  "before" is the U-Net as it ran before
              ``unet.product_rows`` and ``unet.conv_rows``: matrix
              products and convolutions at the batch's own row count.  Beside it the dict engine on the same
              rows padded with zero rows to shape_bucket(B) (the padded
              width without graphs), and a DDIM step's time at batch 8.
  timing   -- what the U-Net's batch-invariant layout costs: a DDIM
              step's best of 20 at batch 5, 8, 12 and 16, on the dict engine
              (eager) and as a bucket graph replay, as the port runs
              and "before", in the order port, before, before, port.
  images   -- for the SMOKE and the full-width U-Net, conv_out at the
              reference's init (1e-10, eps ~ 0) and redrawn (eps of
              order 1), a plan whose batches need padding (sizes 5, 4,
              3, 2, 1) and one whose batches fill their bucket (8, 4,
              2), ``--seeds`` sets of latents: bucketed against dict
              (max abs error and the elements over MATCH_TOL), and as
              controls the multi-step graphs against single steps and
              the dict engine against itself.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PADDED = {0: 9, 1: 6, 2: 4, 3: 2, 4: 1}           # sizes 5, 4, 3, 2, 1
EVERY = {k: k + 1 for k in range(16)}             # sizes 16, 15, ..., 1
PARTS = ["ops", "knobs", "timing", "images"]
FILLED = {0: 7, 1: 7, 2: 5, 3: 5, 4: 3, 5: 3, 6: 3, 7: 3}   # 8, 4, 2


def _plan(counts):
    """All services with steps left batched together, each round."""
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.plan import BatchPlan
    rem, done, batches = dict(counts), {k: 0 for k in counts}, []
    while any(rem.values()):
        ks = sorted(k for k, v in rem.items() if v)
        batches.append([(k, done[k]) for k in ks])
        for k in ks:
            rem[k] -= 1
            done[k] += 1
    return BatchPlan(batches=batches, start_times=[0.0] * len(batches),
                     steps_completed=dict(counts), delay=DelayModel())


def _params(cfg, redraw):
    import torch
    from repro_torch.diffusion import unet
    from repro_torch.models.params import init_params
    params = init_params(unet.schema(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    if redraw:
        params["conv_out"] = torch.randn(
            params["conv_out"].shape,
            generator=torch.Generator().manual_seed(1)
        ) / cfg.base_channels ** 0.5
    return params


# -- ways of computing each operation ----------------------------------------

@contextlib.contextmanager
def _cudnn(**flags):
    import torch
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


def _group_norm_rows(x, scale, bias, num_groups, eps=1e-6):
    """group_norm with each (image, group) gathered into one contiguous
    row before its reductions."""
    from repro_torch.kernels.groupnorm_silu.ref import num_groups_for
    B, H, W, C = x.shape
    G = num_groups_for(C, num_groups)
    xg = x.reshape(B, H * W, G, C // G).permute(0, 2, 1, 3) \
        .reshape(B, G, -1).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, correction=0)
    out = ((xg - mu) * (var + eps).rsqrt()).reshape(B, G, H * W, C // G) \
        .permute(0, 2, 1, 3).reshape(B, H, W, C)
    return (out * scale + bias).to(x.dtype)


def _matmul_bmm(orig):
    """``a @ b`` as one batched product per image (a weight broadcast
    over the batch)."""
    import torch

    def mm(a, b):
        if a.dim() == 2 and b.dim() == 2:
            return torch.bmm(a[:, None], b.expand(a.shape[0], *b.shape))[:, 0]
        if a.dim() == 3 and b.dim() == 2:
            return torch.bmm(a, b.expand(a.shape[0], *b.shape))
        return orig(a, b)
    return mm


def _alternatives():
    """{op: {alternative: function of the op's own arguments}}; each
    op's first entry is the U-Net's own (the convolution without
    ``unet.conv_rows``)."""
    import torch
    from repro_torch.diffusion import unet

    def under(fn, **flags):
        def run(*a, **kw):
            with _cudnn(**flags):
                return fn(*a, **kw)
        return run
    def conv(x, w, b=None, stride=1):
        # the convolution alone, at the rows it is given
        out = unet._conv(x, w, stride)
        return out if b is None else out + b
    mm = torch.Tensor.__matmul__
    return {
        "conv2d": {"cudnn": conv,
                   "cudnn deterministic": under(conv, deterministic=True),
                   "no cudnn": under(conv, enabled=False)},
        "gn_silu": {"kernel": unet.gn_silu},
        "group_norm": {"torch reductions": unet.group_norm,
                       "contiguous rows": _group_norm_rows},
        "matmul": {"matmul": mm, "bmm": _matmul_bmm(mm)},
        "softmax": {"softmax": torch.softmax},
        "product_rows": {"bucket": unet.product_rows,
                         "own rows": lambda B: B},
        "conv_rows": {"probed": unet.conv_rows,
                      "own rows": lambda x, w, stride: x.shape[0]},
    }


@contextlib.contextmanager
def _patched(ops):
    """The U-Net's conv2d, gn_silu, group_norm, ``@``, softmax and
    product_rows replaced by ``ops[name]`` where given."""
    import torch
    from repro_torch.diffusion import unet
    old = (unet.conv2d, unet.gn_silu, unet.group_norm,
           torch.Tensor.__matmul__, torch.softmax, unet.product_rows,
           unet.conv_rows)
    unet.conv2d = ops.get("conv2d", old[0])
    unet.gn_silu = ops.get("gn_silu", old[1])
    unet.group_norm = ops.get("group_norm", old[2])
    torch.Tensor.__matmul__ = ops.get("matmul", old[3])
    torch.softmax = ops.get("softmax", old[4])
    unet.product_rows = ops.get("product_rows", old[5])
    unet.conv_rows = ops.get("conv_rows", old[6])
    try:
        yield
    finally:
        (unet.conv2d, unet.gn_silu, unet.group_norm,
         torch.Tensor.__matmul__, torch.softmax, unet.product_rows,
         unet.conv_rows) = old


# each knob: {op: alternative} for the whole run
BEFORE = {"product_rows": "own rows", "conv_rows": "own rows"}
KNOBS = {
    "as the port runs": {},
    "before (products and convolutions at B rows)": BEFORE,
    "products at B rows": {"product_rows": "own rows"},
    "convolutions at B rows": {"conv_rows": "own rows"},
    "before, cudnn deterministic": {**BEFORE,
                                    "conv2d": "cudnn deterministic"},
    "before, no cudnn": {**BEFORE, "conv2d": "no cudnn"},
    "before, bmm": {**BEFORE, "matmul": "bmm"},
}



def op_witness(cfg, params, B, device):
    """One forward at shape_bucket(B): B rows of noise at t = 500, the
    rest zero at t = -1 (the scratch row's lanes).  Per (op,
    alternative): calls, calls whose real rows differ from the same
    alternative run on the real rows alone, the largest difference, and
    the shapes that differ."""
    import torch
    from repro_torch.core.execution import shape_bucket
    from repro_torch.diffusion import unet
    Bp = shape_bucket(B)
    alts = _alternatives()
    found = {}
    busy = [False]

    def wrap(op, own):
        def fn(*args, **kw):
            out = own(*args, **kw)
            a = args[0]
            if busy[0] or not torch.is_tensor(a) or a.dim() < 2 \
                    or a.shape[0] != Bp:
                return out
            busy[0] = True
            try:
                part = [a[:B]] + [t[:B] if op == "matmul" and t.dim() == 3
                                  else t for t in args[1:]]
                for alt, f in alts[op].items():
                    d = float((f(*args, **kw)[:B] - f(*part, **kw))
                              .abs().max())
                    r = found.setdefault((op, alt), dict(
                        calls=0, differ=0, max_abs=0.0, shapes=[]))
                    r["calls"] += 1
                    if d > 0:
                        r["differ"] += 1
                        r["max_abs"] = max(r["max_abs"], d)
                        shape = [list(t.shape) for t in args
                                 if torch.is_tensor(t)]
                        if shape not in r["shapes"]:
                            r["shapes"].append(shape)
            finally:
                busy[0] = False
            return out
        return fn
    g = torch.Generator().manual_seed(B)
    x = torch.zeros((Bp, cfg.image_size, cfg.image_size, cfg.in_channels))
    x[:B] = torch.randn(x[:B].shape, generator=g)
    t = torch.full((Bp,), -1.0)
    t[:B] = 500.0
    p = {k: v for k, v in params.items()}
    from repro_torch.diffusion.executor import _to_device
    p = _to_device(p, device)
    x, t = x.to(device), t.to(device)
    with _patched({op: wrap(op, a[next(iter(a))])
                   for op, a in alts.items()
                   if op not in ("product_rows", "conv_rows")}):
        unet.forward(cfg, p, x, t)
    rows = [dict(op=op, alternative=alt, B=B, Bp=Bp, **r)
            for (op, alt), r in found.items()]
    # the whole forward, each knob on for all of it: what the listed
    # operations do not account for shows here
    for name, pick in KNOBS.items():
        with _patched({op: alts[op][alt] for op, alt in pick.items()}):
            d = float((unet.forward(cfg, p, x, t)[:B]
                       - unet.forward(cfg, p, x[:B], t[:B])).abs().max())
        rows.append(dict(op="forward", alternative=name, B=B, Bp=Bp,
                         calls=1, differ=int(d > 0), max_abs=d, shapes=[]))
    return rows



def _dict_padded(ex, plan, lat):
    """The dict engine's step function on each batch's rows stacked with
    zero rows at t = -1 up to shape_bucket(B): the bucketed engine's
    arithmetic with no pool and no graph."""
    import numpy as np
    import torch
    from repro_torch.core.execution import shape_bucket
    sess = ex.open_session(plan, latents=lat, exec_engine="dict")
    for batch in plan.batches:
        ks = [k for k, _ in batch]
        Bp = shape_bucket(len(ks))
        x = torch.stack([sess.latents[k] for k in ks] + [
            torch.zeros_like(sess.latents[ks[0]])] * (Bp - len(ks)))
        tn = np.full((2, Bp), -1, np.int64)
        for i, k in enumerate(ks):
            rem = sess._remaining[k]
            tn[:, i] = rem[0], rem[1] if len(rem) > 1 else -1
            rem.pop(0)
        t = torch.from_numpy(tn).to(ex.device)
        x = ex.step_fn(x, t[0], t[1])
        for i, k in enumerate(ks):
            sess.latents[k] = x[i]
    return sess.finish()


def _err(a, b):
    import numpy as np
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _over(a, b):
    import numpy as np
    from repro_torch.diffusion.bucketed import MATCH_TOL
    return sum(int((~np.isclose(a[k], b[k], **MATCH_TOL)).sum()) for k in a)


def _curves(ex, reps=20):
    """{engine: {batch: best ms}} at batch 5, 8, 12 and 16."""
    import torch
    return {eng: {X: s * 1e3 for X, s in ex.measure_delay_curve(
        torch.Generator().manual_seed(1), batch_sizes=(5, 8, 12, 16),
        reps=reps,
        exec_engine=eng)} for eng in ("dict", "bucketed")}


def _step_ms(ex, B=8, reps=5):
    import torch
    cfg = ex.cfg
    x = torch.randn((B, cfg.image_size, cfg.image_size, cfg.in_channels),
                    generator=torch.Generator().manual_seed(3)).cuda()
    t = torch.full((B,), 500, dtype=torch.int64, device="cuda")
    ex.step_fn(x, t, t - 1)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.step_fn(x, t, t - 1)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--parts", nargs="+", default=PARTS, choices=PARTS)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("check_bucketed_padding: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.ddim_cifar10 import CONFIG, SMOKE
    from repro_torch.core.execution import shape_bucket
    from repro_torch.diffusion.executor import BatchDenoisingExecutor
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)

    def show(part, row):
        print(part + ": " + " ".join(
            f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)

    ops_rows = []
    full = _params(CONFIG, True)
    for B in [B for B in range(1, 16) if shape_bucket(B) != B
              and "ops" in args.parts]:
        for row in op_witness(CONFIG, full, B, "cuda"):
            ops_rows.append(row)
            show("ops", row)

    knob_rows = []
    alts = _alternatives()
    plan = _plan(EVERY)
    shape = (CONFIG.image_size, CONFIG.image_size, CONFIG.in_channels)
    rng = np.random.default_rng(0)
    lat = {k: rng.standard_normal(shape).astype(np.float32) for k in EVERY}
    for name, pick in KNOBS.items() if "knobs" in args.parts else ():
        with _patched({op: alts[op][alt] for op, alt in pick.items()}):
            ex = BatchDenoisingExecutor(CONFIG, full, device="cuda")
            got, _ = ex.run(plan, latents=lat, exec_engine="bucketed")
            want, _ = ex.run(plan, latents=lat, exec_engine="dict")
            padded = _dict_padded(ex, plan, lat)
            row = dict(knob=name, bucketed_vs_dict=_err(got, want),
                       over_match_tol=_over(got, want),
                       dict_padded_vs_dict=_err(padded, want),
                       dict_padded_vs_bucketed=_err(padded, got),
                       step_ms_b8=_step_ms(ex),
                       step_ms_b16=_step_ms(ex, 16))
            del ex
        knob_rows.append(row)
        show("knobs", row)

    timing_rows = []
    for name in ("as the port runs", "before", "before",
                 "as the port runs") if "timing" in args.parts else ():
        pick = {} if name == "as the port runs" else BEFORE
        with _patched({op: alts[op][alt] for op, alt in pick.items()}):
            ex = BatchDenoisingExecutor(CONFIG, full, device="cuda")
            row = dict(knob=name, **{f"{eng}_ms_b{X}": ms for eng, c in
                                     _curves(ex).items()
                                     for X, ms in c.items()})
            del ex
        timing_rows.append(row)
        show("timing", row)

    rows = []
    for cfg in (SMOKE, CONFIG) if "images" in args.parts else ():
        shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
        for redraw in (False, True):
            ex = BatchDenoisingExecutor(cfg, _params(cfg, redraw),
                                        device="cuda")
            for name, counts in (("padded", PADDED), ("filled", FILLED)):
                plan = _plan(counts)
                for seed in range(args.seeds):
                    rng = np.random.default_rng(seed)
                    lat = {k: rng.standard_normal(shape).astype(np.float32)
                           for k in counts}
                    scan, _ = ex.run(plan, latents=lat,
                                     exec_engine="bucketed")
                    step, _ = ex.run(plan, latents=lat, timed=True,
                                     exec_engine="bucketed")
                    want, _ = ex.run(plan, latents=lat, exec_engine="dict")
                    again, _ = ex.run(plan, latents=lat,
                                      exec_engine="dict")
                    row = dict(
                        config=cfg.name, conv_out="redrawn" if redraw
                        else "reference init", plan=name, seed=seed,
                        bucketed_vs_dict=_err(scan, want),
                        over_match_tol=_over(scan, want),
                        elements=sum(v.size for v in want.values()),
                        scan_vs_step=_err(scan, step),
                        dict_vs_dict=_err(want, again),
                        max_image=max(float(np.abs(v).max())
                                      for v in want.values()))
                    rows.append(row)
                    show("images", row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "check_bucketed_padding.json").write_text(json.dumps(
        dict(card=card, torch=torch.__version__, ops=ops_rows,
             knobs=knob_rows, timing=timing_rows, images=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
