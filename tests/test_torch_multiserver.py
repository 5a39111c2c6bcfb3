"""The port's multi-server pipeline (``repro_torch.core.multiserver``,
``api.placements``, ``api.multiserver``, the servers of
``core.service``) against the reference's on the same seeds.

On the vec and scalar engines everything is NumPy arithmetic in the
reference's order, so scenarios, assignments, plans, outcomes and
``to_dict()`` are held equal (``==``).  The torch planner engine, on
the CPU, is held to the port's vec engine: the same assignments and
mean FID within 1e-9, the planner engines' contract.  Mirrors
tests/test_multiserver.py class by class."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import MultiServerProvisioner as JaxMulti  # noqa: E402
from repro.api import get_allocator as jax_allocator  # noqa: E402
from repro.api import get_placement as jax_placement  # noqa: E402
from repro.api import get_scheduler as jax_scheduler  # noqa: E402
from repro.core import multiserver as jm  # noqa: E402
from repro.core import service as js  # noqa: E402
from repro.core.delay_model import DelayModel as JaxDelay  # noqa: E402
from repro.core.quality_model import PowerLawFID as JaxFID  # noqa: E402
from repro.core.stacking import stacking as jax_stacking  # noqa: E402
from repro_torch.api import (ALLOCATORS, PLACEMENTS,  # noqa: E402
                             MultiServerProvisioner, OnlineProvisioner,
                             Provisioner)
from repro_torch.api.provisioner import SCHEDULERS  # noqa: E402
from repro_torch.core import multiserver as pm  # noqa: E402
from repro_torch.core import service as ps  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.quality_model import PowerLawFID  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402

DELAY, QUALITY = DelayModel(), PowerLawFID()
TOL = 1e-9
HETERO = dict(K=9, n_servers=3, server_speed_range=(0.6, 1.4), seed=0)
SCENARIOS = [
    dict(K=10, seed=4),
    dict(K=10, n_servers=3, seed=4),
    dict(K=6, n_servers=3, server_speed_range=(0.5, 2.0), seed=7),
    dict(K=6, n_servers=3, server_capacity=2, seed=2),
    dict(K=8, n_servers=2, arrival_rate=1.0,
         content_bits_range=(1e4, 5e4), seed=3),
]


def _rows(objs):
    return [dataclasses.astuple(o) for o in objs]


def _pair(**kw):
    return js.make_scenario(**kw), ps.make_scenario(**kw)


def _same_report(ref, got):
    assert list(got.assignment) == list(ref.assignment)
    assert got.server_ids == ref.server_ids
    assert _rows(got.sim.outcomes) == _rows(ref.sim.outcomes)
    for r, g in zip(ref.reports, got.reports):
        np.testing.assert_array_equal(g.allocation, r.allocation)
        assert g.tau_prime == r.tau_prime
        assert g.plan.batches == r.plan.batches
        assert g.plan.start_times == r.plan.start_times
        assert dataclasses.astuple(g.delay) == dataclasses.astuple(r.delay)
    assert got.to_dict() == ref.to_dict()
    assert got.summary() == ref.summary()


class TestScenarioSampling:
    @pytest.mark.parametrize("kw", SCENARIOS, ids=range(len(SCENARIOS)))
    def test_scenarios_equal(self, kw):
        ref, got = _pair(**kw)
        assert _rows(got.services) == _rows(ref.services)
        assert got.servers is None if ref.servers is None else \
            _rows(got.servers) == _rows(ref.servers)
        assert _rows(got.server_list) == _rows(ref.server_list)
        assert (got.n_servers, got.is_static, got.total_bandwidth_hz) == \
            (ref.n_servers, ref.is_static, ref.total_bandwidth_hz)

    def test_single_server_draws_unchanged(self):
        """The server draws come after the base draws."""
        base = ps.make_scenario(K=10, seed=4)
        assert base.servers is None and base.n_servers == 1
        for kw in (dict(n_servers=3), dict(server_speed_range=(0.5, 2.0)),
                   dict(server_capacity=2)):
            multi = ps.make_scenario(K=10, seed=4, **kw)
            assert _rows(multi.services) == _rows(base.services)
            assert multi.servers is not None

    def test_server_delay_model_scales_with_speed(self):
        for speed in (1.0, 2.0, 0.7):
            got = ps.EdgeServer(id=0, bandwidth_hz=1e4, speed=speed)
            ref = js.EdgeServer(id=0, bandwidth_hz=1e4, speed=speed)
            d, r = got.delay_model(DELAY), ref.delay_model(JaxDelay())
            assert (d.a, d.b) == (r.a, r.b)
        assert ps.EdgeServer(id=1).delay_model(DELAY) is DELAY
        assert [ps.EdgeServer(0, capacity=2).has_room(n)
                for n in range(3)] == [True, True, False]

    def test_invalid_n_servers_rejected(self):
        with pytest.raises(ValueError, match="n_servers"):
            ps.make_scenario(K=4, n_servers=0)


class TestSplitScenario:
    def test_partition_equal(self):
        ref, got = _pair(K=9, n_servers=3, seed=1)
        assignment = [i % 3 for i in range(9)]
        for r, g in zip(jm.split_scenario(ref, assignment),
                        pm.split_scenario(got, assignment)):
            assert _rows(g.services) == _rows(r.services)
            assert g.total_bandwidth_hz == r.total_bandwidth_hz
            assert g.servers is None

    @pytest.mark.parametrize("kw,assignment,match", [
        (dict(K=4, n_servers=2, server_capacity=2), [0, 0, 0, 1],
         "capacity"),
        (dict(K=2, n_servers=2), [0, 5], "unknown servers"),
        (dict(K=3, n_servers=2), [0, 1], "covers 2 of 3"),
    ])
    def test_bad_assignments_raise(self, kw, assignment, match):
        with pytest.raises(ValueError, match=match):
            pm.split_scenario(ps.make_scenario(seed=0, **kw), assignment)


class TestSingleServerEquivalence:
    @pytest.mark.parametrize("scheduler", ["stacking", "greedy",
                                           "equal_steps"])
    @pytest.mark.parametrize("allocator", ["inv_se", "equal"])
    def test_static_pipeline_matches_provisioner(self, scheduler,
                                                 allocator):
        scn = ps.make_scenario(K=8, seed=3)
        single = Provisioner(scn, scheduler=scheduler,
                             allocator=allocator).run()
        multi = MultiServerProvisioner(scn, placement="round_robin",
                                       scheduler=scheduler,
                                       allocator=allocator).run()
        assert multi.sim.outcomes == single.sim.outcomes
        assert list(multi.assignment) == [0] * scn.K
        np.testing.assert_array_equal(multi.reports[0].allocation,
                                      single.allocation)
        ref = JaxMulti(js.make_scenario(K=8, seed=3),
                       placement="round_robin", scheduler=scheduler,
                       allocator=allocator).run()
        _same_report(ref, multi)

    @pytest.mark.parametrize("placement", ["round_robin", "least_loaded",
                                           "greedy_fid", "alternating"])
    def test_every_placement_degenerates_on_one_server(self, placement):
        scn = ps.make_scenario(K=6, seed=5)
        single = Provisioner(scn, scheduler="stacking",
                             allocator="inv_se").run()
        multi = MultiServerProvisioner(scn, placement=placement,
                                       scheduler="stacking",
                                       allocator="inv_se").run()
        assert multi.sim.outcomes == single.sim.outcomes

    def test_online_matches_simulate_online(self):
        scn = ps.make_scenario(K=8, arrival_rate=0.5, seed=3)
        single = OnlineProvisioner(scn, scheduler="stacking",
                                   allocator="inv_se").run()
        multi = pm.simulate_online_multi(scn, stacking, ALLOCATORS["inv_se"],
                                         DELAY, QUALITY)
        assert multi.result.outcomes == single.result.outcomes
        assert multi.assignment == {o.id: 0
                                    for o in single.result.outcomes}
        static = ps.make_scenario(K=8, seed=6)
        assert pm.simulate_online_multi(
            static, stacking, ALLOCATORS["inv_se"], DELAY,
            QUALITY).result.outcomes == Provisioner(
                static, scheduler="stacking",
                allocator="inv_se").run().sim.outcomes


PLACE_CASES = [(name, kw) for name in ("round_robin", "least_loaded",
                                       "greedy_fid")
               for kw in (HETERO, dict(K=7, n_servers=3, seed=0),
                          dict(K=6, n_servers=3, server_capacity=2,
                               seed=2))]
PLACE_CASES.append(("alternating", dict(K=6, n_servers=2,
                                        server_speed_range=(0.5, 1.5),
                                        seed=1)))


class TestPlacements:
    def test_table_names(self):
        for name in ("round_robin", "least_loaded", "greedy_fid",
                     "alternating", "rr", "coord_desc"):
            assert name in PLACEMENTS
        assert PLACEMENTS["rr"] is PLACEMENTS["round_robin"]
        with pytest.raises(ValueError, match="unknown placement"):
            MultiServerProvisioner(ps.make_scenario(K=2), placement="x")

    @pytest.mark.parametrize("name,kw", PLACE_CASES,
                             ids=[f"{n}-{i}" for i, (n, _) in
                                  enumerate(PLACE_CASES)])
    def test_assignment_equal(self, name, kw):
        ref_scn, scn = _pair(**kw)
        ref = jax_placement(name)(ref_scn, jax_stacking,
                                  jax_allocator("inv_se"), JaxDelay(),
                                  JaxFID())
        got = PLACEMENTS[name](scn, stacking, ALLOCATORS["inv_se"], DELAY,
                               QUALITY)
        assert list(got) == list(ref)
        counts = np.bincount(np.asarray(got), minlength=scn.n_servers)
        for m, sv in enumerate(scn.server_list):
            assert sv.capacity is None or counts[m] <= sv.capacity

    def test_least_loaded_prefers_fast_servers(self):
        scn = ps.Scenario(
            services=[ps.ServiceRequest(id=k, deadline=10.0,
                                        spectral_eff=7.0) for k in range(4)],
            servers=[ps.EdgeServer(id=0, bandwidth_hz=2e4, speed=1.0),
                     ps.EdgeServer(id=1, bandwidth_hz=2e4, speed=3.0)])
        assert list(PLACEMENTS["least_loaded"](scn)).count(1) == 3

    def test_insufficient_capacity_raises(self):
        scn = ps.make_scenario(K=6, n_servers=2, server_capacity=2, seed=0)
        with pytest.raises(ValueError, match="capacities"):
            PLACEMENTS["round_robin"](scn)

    def test_greedy_fid_no_worse_than_round_robin(self):
        scn = ps.make_scenario(**HETERO)
        alloc = ALLOCATORS["inv_se"]
        fids = {p: pm.provision_multi(
            scn, PLACEMENTS[p](scn, stacking, alloc, DELAY, QUALITY),
            stacking, alloc, DELAY, QUALITY).mean_fid
            for p in ("round_robin", "greedy_fid")}
        assert fids["greedy_fid"] <= fids["round_robin"] + TOL


class TestMultiProvisionReport:
    @pytest.mark.parametrize("placement,allocator", [
        ("least_loaded", "inv_se"), ("greedy_fid", "equal"),
        ("round_robin", "coordinate")])
    def test_report_equal(self, placement, allocator):
        ref_scn, scn = _pair(**HETERO)
        ref = JaxMulti(ref_scn, placement=placement, scheduler="stacking",
                       allocator=allocator).run()
        got = MultiServerProvisioner(scn, placement=placement,
                                     scheduler="stacking",
                                     allocator=allocator).run()
        _same_report(ref, got)
        for sid, sub in zip(got.server_ids, got.reports):
            server = scn.server_list[sid]
            assert sub.allocation.sum() == pytest.approx(
                server.bandwidth_hz)
            assert sub.delay == server.delay_model(DELAY)
            assert got.report_for(sid) is sub
        assert got.report_for(99) is None

    def test_explicit_assignment_overrides_placement(self):
        ref_scn, scn = _pair(K=4, n_servers=2, seed=0)
        kw = dict(placement="least_loaded", scheduler="greedy",
                  allocator="equal")
        got = MultiServerProvisioner(scn, **kw).run(assignment=[1, 1, 1, 1])
        assert got.server_ids == [1] and got.reports[0].scenario.K == 4
        _same_report(JaxMulti(ref_scn, **kw).run(assignment=[1, 1, 1, 1]),
                     got)

    def test_cell_objective_equal(self):
        for K in (0, 5):
            ref_scn, scn = _pair(K=K, seed=1)
            assert pm.cell_objective(
                scn, SCHEDULERS["greedy"], ALLOCATORS["equal"], DELAY,
                QUALITY) == jm.cell_objective(
                    ref_scn, jax_scheduler("greedy"),
                    jax_allocator("equal"), JaxDelay(), JaxFID())


def _online_pair(kw, allocator="inv_se", placement=None, handoff=False):
    """The same simulate_online_multi run in both packages;
    ``placement`` names an online router of both modules."""
    ref_scn, scn = _pair(**kw)
    ref = jm.simulate_online_multi(
        ref_scn, jax_stacking, jax_allocator(allocator), JaxDelay(),
        JaxFID(), placement=getattr(jm, placement) if placement else None,
        handoff=handoff)
    got = pm.simulate_online_multi(
        scn, stacking, ALLOCATORS[allocator], DELAY, QUALITY,
        placement=getattr(pm, placement) if placement else None,
        handoff=handoff)
    return ref, got


def _same_online(ref, got):
    assert _rows(got.outcomes) == _rows(ref.outcomes)
    assert [(d.id, d.arrival, d.admitted, dataclasses.astuple(d.projected))
            for d in got.result.decisions] == \
        [(d.id, d.arrival, d.admitted, dataclasses.astuple(d.projected))
         for d in ref.result.decisions]
    assert got.assignment == ref.assignment
    assert (got.handoffs, got.handoff_log) == (ref.handoffs,
                                               ref.handoff_log)
    assert (got.mean_fid, got.outage_rate, got.reject_rate) == \
        (ref.mean_fid, ref.outage_rate, ref.reject_rate)


ONLINE = dict(K=10, n_servers=3, arrival_rate=1.5,
              server_speed_range=(0.5, 1.5), seed=2)


class TestMultiOnline:
    @pytest.mark.parametrize("placement", [None, "earliest_free",
                                           "best_projection"])
    @pytest.mark.parametrize("handoff", [False, True])
    def test_simulate_online_multi_equal(self, placement, handoff):
        ref, got = _online_pair(ONLINE, placement=placement,
                                handoff=handoff)
        _same_online(ref, got)

    def test_capacity_and_force_reject_equal(self):
        kw = dict(K=10, n_servers=2, server_capacity=3, arrival_rate=1.0,
                  seed=0)
        ref, got = _online_pair(kw, allocator="equal")
        _same_online(ref, got)
        assert len(got.assignment) == 6
        assert got.reject_rate == pytest.approx(0.4)
        assert all(d.projected.steps == 0
                   for d in got.result.decisions if not d.admitted)

    def test_custom_placement_cannot_oversubscribe(self):
        scn = ps.make_scenario(K=4, n_servers=2, server_capacity=1,
                               arrival_rate=1.0, seed=2)
        res = pm.MultiOnlineSimulation(
            scn, SCHEDULERS["greedy"], ALLOCATORS["equal"], DELAY, QUALITY,
            admission=lambda *a: True, placement=lambda svc, s: 0).run()
        assert list(res.assignment.values()) == [0]
        assert res.reject_rate == pytest.approx(0.75)

    def test_facade_run_online_equal(self):
        ref_scn, scn = _pair(K=12, n_servers=3, arrival_rate=2.0, seed=0)
        ref = JaxMulti(ref_scn, scheduler="stacking",
                       allocator="inv_se").run_online(
            admission="deadline_feasible")
        got = MultiServerProvisioner(scn, scheduler="stacking",
                                     allocator="inv_se").run_online(
            admission="deadline_feasible")
        _same_online(ref.result, got.result)
        assert got.to_dict() == ref.to_dict()
        assert got.summary() == ref.summary()

    def test_per_cell_transmissions_never_exceed_cell_budget(self):
        scn = ps.make_scenario(K=12, n_servers=2, tau_min=1.0, tau_max=3.0,
                               arrival_rate=4.0, seed=0,
                               content_bits_range=(65536.0, 262144.0))
        sim = pm.MultiOnlineSimulation(scn, stacking, ALLOCATORS["inv_se"],
                                       DELAY, QUALITY,
                                       admission=lambda *a: True)
        res = sim.run()
        for m, server in enumerate(scn.server_list):
            spans = [(st.gen_end, st.tx_end, st.bandwidth)
                     for sid, st in sim.states.items()
                     if st.gen_complete and res.assignment.get(sid) == m]
            for t0, _, _ in spans:
                in_air = sum(bw for s, e, bw in spans if s <= t0 < e)
                assert in_air <= server.bandwidth_hz + 1e-6


class TestEngines:
    """The scalar engine ``==`` vec; the torch engine on the CPU within
    1e-9 mean FID of vec with the same assignments."""

    @pytest.mark.parametrize("placement", ["round_robin", "least_loaded",
                                           "greedy_fid"])
    def test_run_engines(self, placement):
        scn = ps.make_scenario(K=8, n_servers=3,
                               server_speed_range=(0.7, 1.3), seed=0)
        reps = {eng: MultiServerProvisioner(
            scn, placement=placement, allocator="inv_se", engine=eng,
            device="cpu").run() for eng in ("vec", "scalar", "torch")}
        vec = reps["vec"]
        _same_report(vec, reps["scalar"])
        assert list(reps["torch"].assignment) == list(vec.assignment)
        assert abs(reps["torch"].mean_fid - vec.mean_fid) < TOL
        for r in reps["torch"].reports:
            r.plan.validate(gen_deadlines=r.tau_prime)

    def test_run_online_engines(self):
        scn = ps.make_scenario(K=10, n_servers=3, arrival_rate=2.0,
                               server_speed_range=(0.7, 1.3), seed=0)
        reps = {eng: MultiServerProvisioner(
            scn, allocator="inv_se", engine=eng, device="cpu").run_online()
            for eng in ("vec", "scalar", "torch")}
        _same_online(reps["vec"].result, reps["scalar"].result)
        assert reps["torch"].assignment == reps["vec"].assignment
        assert abs(reps["torch"].mean_fid - reps["vec"].mean_fid) < TOL
