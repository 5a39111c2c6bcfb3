"""Hypothesis properties of the port's device planner engine
(``repro_torch.core.torchplan``, on the CPU), mirroring
tests/test_jaxplan_properties.py on tie-heavy instances: the radix
selection equals the sort, the ``_first_best`` rule holds on exact ties
and on ties at 1e-12, surplus rounds change nothing, the float state is
float64 under the default dtype, and end to end the engine meets its
1e-9 mean-FID contract against the port's vec engine."""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import arrays  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.quality_model import PowerLawFID  # noqa: E402
from repro_torch.core.service import ServiceRequest  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.core.torchplan import (backend, device_scope,  # noqa: E402
                                        kernels, plan_many)

DELAY, QUALITY = DelayModel(), PowerLawFID()
TOL = 1e-9


def _svcs(taus):
    return ([ServiceRequest(id=i, deadline=t, spectral_eff=7.0)
             for i, t in enumerate(taus)], {i: t for i, t in enumerate(taus)})


def _fid(plan, ids):
    return QUALITY.mean_fid([plan.steps_completed[k] for k in ids])


taus_strategy = st.lists(
    st.floats(min_value=0.05, max_value=4.0, allow_nan=False,
              allow_infinity=False), min_size=1, max_size=8)


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_radix_select_matches_sort_on_tie_heavy_keys(data):
    K = data.draw(st.integers(2, 24))
    L = data.draw(st.integers(1, 4))
    tp_vals = data.draw(st.lists(st.integers(0, 6), min_size=1,
                                 max_size=3))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    Tp = rng.choice(tp_vals, size=(L, K)).astype(np.int64)
    tie = rng.permutation(K).astype(np.int64)
    M = np.int64(1) << np.int64(max(K, 1).bit_length())
    key_np = Tp * M + tie[None, :]
    key_bits = int((int(key_np.max()) + 1).bit_length())
    key_all = np.repeat(key_np, K, axis=0)
    x_all = np.tile(np.arange(1, K + 1, dtype=np.int64), L)
    for dtype in (torch.int32, torch.int64):
        key = torch.as_tensor(key_all).to(dtype)
        x_n = torch.as_tensor(x_all)
        sel = kernels._select_kth_key(key, x_n, key_bits)
        ref = kernels._sort_kth_key(key, x_n)
        assert torch.equal(sel, ref)
        assert sel.dtype == dtype
        np.testing.assert_array_equal(np.sort(key_all, axis=1)[
            np.arange(L * K), x_all - 1], ref.numpy())


def _host_rule(qs, ok):
    best_i, best_q = -1, float("inf")
    for i, (q, v) in enumerate(zip(qs.tolist(), ok.tolist())):
        if v and q < best_q - 1e-12:
            best_i, best_q = i, q
    return best_i, best_q


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_first_best_rule_on_exact_and_1e12_ties(data):
    """``kernels._first_best`` against the scalar searches' loop, on
    rows built from a few base values plus multiples of 0.3e-12 and
    0.6e-12, so exact ties and near-ties at the 1e-12 slack both
    occur; some candidates masked out."""
    S = data.draw(st.integers(1, 6))
    L = data.draw(st.integers(1, 40))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    base = rng.choice([1.0, 5.25, 7.5], size=(S, 1))
    steps = rng.choice([0.0, 0.3e-12, 0.6e-12, 1e-12, 1.2e-12, 2.5e-12],
                       size=(S, L))
    qs = base - np.cumsum(steps, axis=1) * rng.choice([1, -1], size=(S, L))
    qs[rng.random((S, L)) < 0.1] = np.inf
    ok = rng.random((S, L)) < 0.85
    bi, bq = kernels._first_best(torch.as_tensor(qs), torch.as_tensor(ok))
    for s in range(S):
        want_i, want_q = _host_rule(qs[s], ok[s])
        assert (int(bi[s]), float(bq[s])) == (want_i, want_q)
        if ok[s].all():
            assert backend._first_best(qs[s]) == want_i
    # the chunked path of wide tables gives the same answers
    cells = kernels._FIRST_BEST_CELLS
    kernels._FIRST_BEST_CELLS = (L + 1) ** 2
    try:
        bi2, bq2 = kernels._first_best(torch.as_tensor(qs),
                                       torch.as_tensor(ok))
    finally:
        kernels._FIRST_BEST_CELLS = cells
    assert torch.equal(bi, bi2) and torch.equal(bq, bq2)


def test_first_best_is_not_argmin():
    """The rule picks the chain's end, not the smallest value."""
    qs = torch.tensor([[1.0, 1.0 - 1.2e-12, 1.0 - 1.5e-12],
                       [1.0, 1.0 - 0.6e-12, 1.0 - 1.2e-12],
                       [2.0, 2.0, 2.0]], dtype=torch.float64)
    bi, _ = kernels._first_best(qs, torch.ones(3, dtype=torch.bool))
    assert bi.tolist() == [1, 2, 0]


@settings(max_examples=20, deadline=None)
@given(taus=taus_strategy, data=st.data())
def test_surplus_rounds_change_nothing(taus, data):
    """Rounds run in blocks between loop checks: whatever the block,
    the counts and makespans are those of checking every round."""
    offs = np.asarray([data.draw(st.integers(0, 6)) for _ in taus])
    tp = np.asarray(taus, dtype=np.float64)
    levels = np.arange(1, 12)
    targets = np.maximum(levels[:, None] - offs[None, :], 0)
    prev = kernels.ROUNDS_PER_CHECK
    out = []
    try:
        for rounds in (1, 3, 16):
            kernels.ROUNDS_PER_CHECK = rounds
            with device_scope("cpu"):
                out.append(kernels.clustered_counts(tp, offs, levels, DELAY)
                           + kernels.lockstep_counts(tp, targets, DELAY))
    finally:
        kernels.ROUNDS_PER_CHECK = prev
    for other in out[1:]:
        for a, b in zip(out[0], other):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("default", [torch.float32, torch.bfloat16])
def test_float_state_is_float64_under_any_default_dtype(default):
    """Every float the sweeps make is float64 by explicit dtype: under a
    float32 or bfloat16 default the counts and makespans equal the vec
    engine's float64 ones exactly.  (A cap left to the default dtype
    changes counts here: with ``te_max`` not cast, 2 of these 20 seeds
    part from vec under bfloat16.)"""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(default)
    try:
        with device_scope("cpu"):
            for seed in range(20):
                rng = np.random.default_rng(seed)
                K = 60
                tp = rng.uniform(0.3, 12.0, size=K)
                off = rng.integers(0, 6, size=K)
                arr = arrays.ServiceArrays.build(
                    list(range(K)), dict(enumerate(tp)), dict(enumerate(off)))
                levels = np.arange(1, 40)
                Tc, t = kernels.clustered_sweep(arr.tau_prime, arr.offsets,
                                                levels, DELAY, ids=arr.ids)
                want = arrays.sweep_clustered(arr, DELAY, levels)
                assert t.dtype == torch.float64
                np.testing.assert_array_equal(Tc.numpy(), want[0])
                np.testing.assert_array_equal(t.numpy(), want[1])
                targets = np.maximum(levels[:, None] - off[None, :], 0)
                got = kernels.lockstep_counts(tp, targets, DELAY)
                want = arrays.sweep_lockstep(arr, DELAY, targets)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                q = kernels.powerlaw_rows(Tc, QUALITY, off)
                assert q.dtype == torch.float64
                np.testing.assert_allclose(
                    q.numpy(), arrays.score_rows(Tc.numpy() + off, QUALITY),
                    rtol=0, atol=TOL)
            res = plan_many(rng.uniform(0.3, 12.0, size=(16, 20)), delay=DELAY,
                            quality=QUALITY)
    finally:
        torch.set_default_dtype(prev)
    assert res.mean_fid.dtype == np.float64
    np.testing.assert_allclose(res.mean_fid,
                               arrays.score_rows(res.steps, QUALITY),
                               rtol=0, atol=TOL)


@settings(max_examples=20, deadline=None)
@given(data=st.data())
def test_tie_heavy_stacking_matches_vec(data):
    vals = data.draw(st.lists(
        st.floats(min_value=0.5, max_value=4.0, allow_nan=False),
        min_size=1, max_size=2))
    taus = [vals[i % len(vals)]
            for i in range(data.draw(st.integers(2, 10)))]
    svcs, tp = _svcs(taus)
    ids = list(range(len(taus)))
    vec = stacking(svcs, tp, DELAY, QUALITY, engine="vec")
    with device_scope("cpu"):
        got = stacking(svcs, tp, DELAY, QUALITY, engine="torch")
    assert abs(_fid(vec, ids) - _fid(got, ids)) < TOL
    got.validate(gen_deadlines=tp)


@settings(max_examples=15, deadline=None)
@given(scenarios=st.lists(taus_strategy, min_size=1, max_size=6))
def test_plan_many_matches_per_scenario_vec(scenarios):
    K = max(len(t) for t in scenarios)
    taus = np.zeros((len(scenarios), K))
    valid = np.zeros(taus.shape, dtype=bool)
    for s, row in enumerate(scenarios):
        taus[s, :len(row)] = row
        valid[s, :len(row)] = True
    with device_scope("cpu"):
        res = plan_many(taus, delay=DELAY, quality=QUALITY, valid=valid)
    for s, row in enumerate(scenarios):
        svcs, tp = _svcs(row)
        pv = arrays.stacking_vec(svcs, tp, DELAY, QUALITY)
        assert abs(_fid(pv, range(len(row))) - res.mean_fid[s]) < TOL
