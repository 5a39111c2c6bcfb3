"""Driver of the DDIM configurations: the program's
``DiffusionWorkload`` on its bucketed engine (one CUDA graph a padded
batch bucket), weights from the configuration's reference, the start
latents of every round drawn from the seed, and the comparison of the
images the window produced with the reference's.

``image_err`` is the largest, over a sample of the window's images
drawn from the seed (the one that ran most steps among them), of
max |program - reference| / max |reference|: each image run by the
reference from its start latent through the timesteps the planned
totals and the session's retargets give it.  ``check`` keeps what it
compared (``checked``: the start latents and the timesteps) for the
control's reading (``control``).
"""

from __future__ import annotations

import numpy as np

from harness import frozen
from harness.bench import set_tf32
from harness.traffic import rng


class Driver:
    def __init__(self, cfg: dict, traffic: dict, ref, seed: int, device):
        self.cfg, self.traffic, self.ref = cfg, traffic, ref
        self.seed, self.device = seed, device
        self.execute_kwargs = {"exec_engine": cfg["exec_engine"]}
        self.latents = {}

    def unet_config(self):
        from repro_torch.configs.ddim_cifar10 import UNetConfig
        c = self.cfg
        return UNetConfig(
            name=c["name"], image_size=c["image_size"],
            in_channels=c["in_channels"], base_channels=c["base_channels"],
            channel_mults=tuple(c["channel_mults"]),
            num_res_blocks=c["num_res_blocks"],
            attn_resolutions=tuple(c["attn_resolutions"]),
            num_groups=c["num_groups"],
            num_train_timesteps=c["num_train_timesteps"])

    def setup(self) -> None:
        import torch
        from repro_torch.api import DiffusionWorkload
        from repro_torch.core.delay_model import DelayModel
        from repro_torch.core.quality_model import PowerLawFID
        set_tf32(False)
        params = self.ref.make_weights(self.cfg, self.seed, self.device)
        self.workload = DiffusionWorkload(
            cfg=self.unet_config(), params=params, device=self.device,
            exec_engine=self.cfg["exec_engine"])
        # one step at each warm size captures every bucket's graph
        # before the window; the plans' g is the cell's, fixed
        self.workload.measure_delay_curve(
            torch.Generator().manual_seed(int(self.seed) % 2**63),
            batch_sizes=tuple(self.traffic["warm_batches"]), reps=1)
        self.delay = DelayModel(**self.traffic["delay"])
        self.quality = PowerLawFID()

    def shape(self):
        c = self.cfg
        return (c["image_size"], c["image_size"], c["in_channels"])

    def round_inputs(self, log) -> dict:
        x = rng(self.seed, log.r, 1).standard_normal(
            (len(log.requests),) + self.shape(), dtype=np.float32)
        lat = {q.id: x[i] for i, q in enumerate(log.requests)}
        self.latents[log.r] = lat
        return {"latents": lat}

    def release(self) -> None:
        self.workload = None

    def check(self, logs, gen: np.random.Generator):
        import torch
        pool = [(j, q.id) for j, log in enumerate(logs)
                for q in log.requests]
        n = min(int(self.traffic["check"]["images"]), len(pool))
        pick = [pool[i] for i in gen.choice(len(pool), n, replace=False)]
        steps = {(j, k): sum(k in b[0] for b in logs[j].batches)
                 for j, k in pool}
        longest = max(pool, key=lambda p: steps[p])
        if longest not in pick:
            pick[0] = longest
        scheds = [frozen.schedule_of(logs[j].events,
                                     logs[j].initial_totals, k,
                                     self.cfg["num_train_timesteps"])
                  for j, k in pick]
        x0 = torch.tensor(np.stack([self.latents[logs[j].r][k]
                                    for j, k in pick]), device=self.device)
        got = torch.tensor(np.stack([np.asarray(logs[j].content[k])
                                     for j, k in pick]), device=self.device)
        self.checked = (x0, scheds)
        w = self.ref.make_weights(self.cfg, self.seed, self.device)
        out = {}
        with torch.no_grad():
            set_tf32(False)
            out["image_err"] = rel_err(
                got, self.ref.denoise(self.cfg, w, x0, scheds))
        out["images_checked"] = float(n)
        out["steps_checked"] = float(sum(len(s) for s in scheds))
        return out


def control(driver) -> dict:
    """The control's ``image_err`` over what ``driver.check`` compared:
    the reference under TF32 (the precision below the configuration's
    float32) in the program's place.  Read by ``limits.py`` and the
    card's test, never by a run."""
    import torch
    x0, scheds = driver.checked
    w = driver.ref.make_weights(driver.cfg, driver.seed, driver.device)
    with torch.no_grad():
        set_tf32(False)
        want = driver.ref.denoise(driver.cfg, w, x0, scheds)
        set_tf32(True)
        low = driver.ref.denoise(driver.cfg, w, x0, scheds)
        set_tf32(False)
    return {"image_err": rel_err(low, want)}


def rel_err(got, want) -> float:
    """Largest over images of max |got - want| / max |want|."""
    d = (got - want).flatten(1).abs().amax(1)
    m = want.flatten(1).abs().amax(1).clamp_min(1e-30)
    return float((d / m).max())
