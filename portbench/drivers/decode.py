"""Driver of the LLM decoding configurations: the program's
``DecodeWorkload`` (its ``ServingEngine``: a prefill per request at its
first batch, then one batched decode step a batch over bfloat16 KV
caches), weights from the configuration's reference, prompts from the
seed, and the comparison of the tokens the window served with the
reference's logits.

``mismatch_share`` is the share of the served tokens, over a sample of
the window's requests drawn from the seed (the longest among them),
that are not the reference's greedy choice at the position that served
them (the reference's best logit above the served token's).
``logit_gap``, the widest such margin, is read beside it: it swings
with single near-ties and does not separate the program from the
control (PERF.md).  ``routed_distinct_ratio`` (mixture-of-experts
configurations) is read beside them: the distinct routed experts that
the reference's routing of the sampled requests selects, in groups of
up to K rows at one decode step, over the uniform-routing expectation
``counts/decode_step.py`` charges a step with.
``token_count_mismatch``: requests whose served token count is not the
number of decode steps the session ran for them (exact, limit 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness.bench import set_tf32



class Driver:
    def __init__(self, cfg: dict, traffic: dict, ref, seed: int, device):
        self.cfg, self.traffic, self.ref = cfg, traffic, ref
        self.seed, self.device = seed, device
        self.execute_kwargs = {}
        self.prompt_seed = int(seed) % 2**32

    def model_config(self):
        """The port's ``ModelConfig`` for this configuration: a
        mixture of experts where it has routed experts
        (``n_routed_experts`` > 0), else a dense SwiGLU of width
        ``intermediate_size``."""
        from repro_torch.config import get_config
        c = self.cfg
        E = int(c.get("n_routed_experts", 0))
        moe = dict(num_experts=E,
                   experts_per_token=c["num_experts_per_tok"] if E else 0,
                   num_shared_experts=c["n_shared_experts"] if E else 0,
                   d_ff_expert=c["moe_intermediate_size"] if E else 0)
        return dataclasses.replace(
            get_config(c["arch"]), num_layers=c["num_hidden_layers"],
            d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
            num_kv_heads=c["num_key_value_heads"],
            d_ff=c["moe_intermediate_size"] if E else
            c["intermediate_size"], vocab_size=c["vocab_size"],
            rope_theta=c["rope_theta"], **moe)

    def setup(self) -> None:
        from repro_torch.api import DecodeWorkload
        from repro_torch.config import RunConfig
        from repro_torch.core.delay_model import DelayModel
        from repro_torch.serving.engine import TokenQuality
        set_tf32(False)
        weights = self.ref.make_weights(self.cfg, self.seed, self.device)
        run = RunConfig(kv_cache_dtype=self.cfg["kv_cache_dtype"],
                        moe_capacity_factor=self.cfg["capacity_factor"])
        self.workload = DecodeWorkload(
            cfg=self.model_config(), params=weights, run=run,
            max_len=self.traffic["max_len"],
            prompt_len=self.traffic["prompt_len"],
            init_seed=self.prompt_seed, device=self.device)
        # a prefill and decode steps at each warm size before the
        # window; the plans' g is the cell's, fixed
        self.workload.measure_delay_curve(
            batch_sizes=tuple(self.traffic["warm_batches"]), reps=1)
        self.delay = DelayModel(**self.traffic["delay"])
        self.quality = TokenQuality()

    def round_inputs(self, log) -> dict:
        return {}

    def cur_lens(self, log):
        """Per batch of a round, each row's valid cache length at that
        decode step (prompt, tokens already decoded, the new one)."""
        done, out = {}, []
        P = self.traffic["prompt_len"]
        for ids, _, _, _ in log.batches:
            out.append([P + done.get(k, 0) + 1 for k in ids])
            for k in ids:
                done[k] = done.get(k, 0) + 1
        return out

    def release(self) -> None:
        self.workload = None

    def check(self, logs, gen: np.random.Generator):
        import torch
        steps = {}
        for j, log in enumerate(logs):
            for ids, _, _, _ in log.batches:
                for k in ids:
                    steps[(j, k)] = steps.get((j, k), 0) + 1
        pool = [(j, q.id) for j, log in enumerate(logs)
                for q in log.requests]
        bad = sum(len(logs[j].content.get(k, [])) != steps.get((j, k), 0)
                  for j, k in pool)
        served = [p for p in pool if steps.get(p, 0) > 0]
        n = min(int(self.traffic["check"]["requests"]), len(served))
        pick = [served[i] for i in gen.choice(len(served), n,
                                              replace=False)]
        longest = max(served, key=lambda p: steps[p])
        if longest not in pick:
            pick[0] = longest
        P, V = self.traffic["prompt_len"], self.cfg["vocab_size"]
        seqs, toks = [], []
        for j, k in pick:
            got = [int(t) for t in logs[j].content[k]]
            pr = self.ref.prompt(self.prompt_seed, k, V, P)
            seqs.append(torch.tensor(np.concatenate(
                [pr, pr[-1:], np.asarray(got[:-1], np.int64)]
            ).astype(np.int64)))
            toks.append(torch.tensor(got))
        self.checked = (seqs, toks)
        out = {"token_count_mismatch": float(bad)}
        E = int(self.cfg.get("n_routed_experts", 0))
        routes = [] if E else None
        w = self.ref.make_weights(self.cfg, self.seed, self.device)
        with torch.no_grad():
            set_tf32(False)
            want = self.ref.decode_logits(self.cfg, w, seqs, P, routes)
            gaps = torch.cat([gap(lg, t.to(lg.device))
                              for lg, t in zip(want, toks)])
            out["logit_gap"] = float(gaps.max())
            out["mismatch_share"] = float((gaps > 0).float().mean())
        if routes:
            out["routed_distinct_ratio"] = distinct_ratio(
                routes, [len(s) for s in seqs], P, E,
                self.cfg["num_experts_per_tok"], int(self.traffic["K"]))
        out["tokens_checked"] = float(sum(len(t) for t in toks))
        return out


def control(driver) -> dict:
    """The control's ``mismatch_share`` and ``logit_gap`` over what
    ``driver.check`` compared: at each served position, the token the
    reference under TF32 (the precision below the configuration's
    float32) puts first, judged by the float32 reference's logits.
    Read by ``limits.py`` and the card's test, never by a run."""
    import torch
    seqs, _ = driver.checked
    P = driver.traffic["prompt_len"]
    w = driver.ref.make_weights(driver.cfg, driver.seed, driver.device)
    with torch.no_grad():
        set_tf32(False)
        want = driver.ref.decode_logits(driver.cfg, w, seqs, P)
        set_tf32(True)
        low = driver.ref.decode_logits(driver.cfg, w, seqs, P)
        set_tf32(False)
        gaps = torch.cat([gap(lg, lo.argmax(-1))
                          for lg, lo in zip(want, low)])
    return {"mismatch_share": float((gaps > 0).float().mean()),
            "logit_gap": float(gaps.max())}


def distinct_ratio(routes, lens, P: int, E: int, k: int, K: int) -> float:
    """Distinct experts the routing ``routes`` (per layer, the expert
    ids (T, k) of the concatenated sequences of lengths ``lens``)
    selects over groups of up to K sequences at one decode step, over
    the uniform-routing expectation E (1 - (1 - k/E)^b) of each group
    of b >= 2 rows."""
    starts = np.cumsum([0] + lens[:-1])
    got = want = 0.0
    for s in range(max(lens) - P):
        rows = [int(lo) + P + s for lo, n in zip(starts, lens) if P + s < n]
        for g in range(0, len(rows), K):
            grp = rows[g:g + K]
            if len(grp) < 2:
                continue
            for ids in routes:
                got += len(set(ids[grp].flatten().tolist()))
                want += E * (1.0 - (1.0 - k / E) ** len(grp))
    return got / want if want else 1.0


def gap(logits, tokens):
    """Per position, the best logit minus the logit of ``tokens``."""
    return logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]
