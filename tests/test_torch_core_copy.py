"""The port's copies of the NumPy planning core give results EQUAL
(``==``) to ``repro.core``'s on several seeds: scenarios, allocations,
STACKING plans, simulated outcomes and mean FID; and the training data
pipeline's batches."""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import bandwidth as jb  # noqa: E402
from repro.core import delay_model as jd  # noqa: E402
from repro.core import quality_model as jq  # noqa: E402
from repro.core import service as js  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import stacking as jst  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro_torch.core import bandwidth as pb  # noqa: E402
from repro_torch.core import delay_model as pd  # noqa: E402
from repro_torch.core import quality_model as pq  # noqa: E402
from repro_torch.core import service as ps  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core import stacking as pst  # noqa: E402
from repro_torch.training import data as pdata  # noqa: E402

SEEDS = [0, 1, 7, 42]
DELAYS = [(0.0240, 0.3543), (0.01, 0.2)]


def _scenarios(seed, **kw):
    return js.make_scenario(seed=seed, **kw), ps.make_scenario(seed=seed,
                                                               **kw)


def _plans_equal(a, b):
    assert a.batches == b.batches
    assert a.start_times == b.start_times
    assert a.steps_completed == b.steps_completed


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bits", [None, (1e4, 5e4)])
def test_make_scenario_equal(seed, bits):
    ref, port = _scenarios(seed, K=12, content_bits_range=bits)
    assert ref.total_bandwidth_hz == port.total_bandwidth_hz
    assert ref.content_bits == port.content_bits
    for r, p in zip(ref.services, port.services, strict=True):
        assert (r.id, r.deadline, r.spectral_eff, r.content_bits) == \
            (p.id, p.deadline, p.spectral_eff, p.content_bits)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("alloc", ["equal_allocate", "inv_se_allocate"])
@pytest.mark.parametrize("ab", DELAYS)
def test_plan_and_simulation_equal(seed, alloc, ab):
    ref, port = _scenarios(seed, K=10)
    ra = getattr(jb, alloc)(ref)
    pa = getattr(pb, alloc)(port)
    np.testing.assert_array_equal(ra, pa)
    rtp, rplan = jb.make_plan(ref, ra, jst.stacking, jd.DelayModel(*ab),
                              jq.PowerLawFID())
    ptp, pplan = pb.make_plan(port, pa, pst.stacking, pd.DelayModel(*ab),
                              pq.PowerLawFID())
    assert rtp == ptp
    _plans_equal(rplan, pplan)
    pplan.validate(gen_deadlines=ptp)
    rsim = jsim.simulate(ref, ra, rplan, jq.PowerLawFID())
    psim_ = psim.simulate(port, pa, pplan, pq.PowerLawFID())
    assert rsim.mean_fid == psim_.mean_fid
    assert rsim.outage_rate == psim_.outage_rate
    assert [dataclasses.astuple(o) for o in rsim.outcomes] == \
        [dataclasses.astuple(o) for o in psim_.outcomes]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_pso_and_coordinate_equal(seed):
    ref, port = _scenarios(seed, K=5)
    kw = dict(num_particles=5, iters=3, seed=seed)
    r = jb.pso_allocate(ref, jst.stacking, jd.DelayModel(), jq.PowerLawFID(),
                        **kw)
    p = pb.pso_allocate(port, pst.stacking, pd.DelayModel(),
                        pq.PowerLawFID(), **kw)
    np.testing.assert_array_equal(r.alloc, p.alloc)
    assert r.history == p.history
    r = jb.coordinate_refine(ref, jb.inv_se_allocate(ref), jst.stacking,
                             jd.DelayModel(), jq.PowerLawFID(), rounds=2)
    p = pb.coordinate_refine(port, pb.inv_se_allocate(port), pst.stacking,
                             pd.DelayModel(), pq.PowerLawFID(), rounds=2)
    np.testing.assert_array_equal(r.alloc, p.alloc)
    assert r.fid == p.fid


def test_delay_fit_and_quality_equal():
    x, y = [1, 2, 4, 8, 16], [0.011, 0.0121, 0.0139, 0.0187, 0.0262]
    assert jd.fit(x, y) == jd.DelayModel(**dataclasses.asdict(pd.fit(x, y)))
    ref, port = jq.PowerLawFID(), pq.PowerLawFID()
    for T in (0, 1, 3, 50, 999):
        assert ref.fid(T) == port.fid(T)
    assert ref.mean_fid([0, 4, 9]) == port.mean_fid([0, 4, 9])
    for m in (jd.DelayModel(), jd.DelayModel(0.002, 0.05)):
        pm = pd.DelayModel(m.a, m.b)
        for budget in (-1.0, 0.0, 0.37, 5.0, 19.9):
            assert m.max_steps(budget) == pm.max_steps(budget)
        assert m.scaled(0.5).g(3) == pm.scaled(0.5).g(3)


def test_validate_rejects_a_broken_plan():
    plan = pst.stacking_pass([0, 1], {0: 3.0, 1: 3.0}, pd.DelayModel(), 4)
    plan.validate()
    plan.batches.append([(0, 0)])                     # task scheduled twice
    plan.start_times.append(plan.makespan())
    with pytest.raises(AssertionError):
        plan.validate()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("vocab,seq,batch", [(512, 16, 2), (32000, 64, 8)])
def test_synthetic_batches_equal(seed, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ref = jdata.batches(jdata.DataConfig(**kw))
    port = pdata.batches(pdata.DataConfig(**kw))
    for _ in range(3):
        (rt, rl), (pt, pl) = next(ref), next(port)
        assert pt.dtype == rt.dtype == np.int32
        np.testing.assert_array_equal(pt, rt)
        np.testing.assert_array_equal(pl, rl)


def test_file_batches_and_shards_equal(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.random.default_rng(5).integers(0, 60000, 4096).astype(
        np.uint16).tofile(path)
    kw = dict(vocab_size=1000, seq_len=32, global_batch=4, source="file",
              path=path, seed=3)
    ref = jdata.batches(jdata.DataConfig(**kw))
    port = pdata.batches(pdata.DataConfig(**kw))
    for _ in range(3):
        for r, p in zip(next(ref), next(port), strict=True):
            np.testing.assert_array_equal(p, r)
            for rank in range(2):
                np.testing.assert_array_equal(pdata.shard_batch(p, rank, 2),
                                              jdata.shard_batch(r, rank, 2))
