"""The port's fleet harness (``repro_torch.core.fleet``, ``api.fleet``)
against ``repro.core.fleet`` and ``repro.api.fleet``.

On the vec and scalar engines every ``FleetResult`` field, every
``to_dict()`` and every summary is the reference's (``==``): the same
NumPy arithmetic in the same order.  The torch engine batches every
concurrent replan into ``torchplan.replan_many`` calls (here on the
CPU) and is held to the port's vec engine within 1e-9 mean FID, the
planner engines' contract, with equal counts and fewer planner calls.
tests/test_torch_fleet_jax.py holds it to the reference's jax engine.
Mirrors tests/test_fleet.py class by class."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FleetProvisioner as JaxFleetProvisioner  # noqa: E402
from repro.api import make_fleet_scenario as jax_make_fleet  # noqa: E402
from repro.core import fleet as jf  # noqa: E402
from repro.core import traffic as jt  # noqa: E402
from repro_torch.api import (ARRIVALS, FleetProvisioner,  # noqa: E402
                             make_fleet_scenario)
from repro_torch.api.provisioner import ALLOCATORS  # noqa: E402
from repro_torch.core import fleet as pf  # noqa: E402
from repro_torch.core import traffic as pt  # noqa: E402
from repro_torch.core.multiserver import simulate_online_multi  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.core.torchplan import device_scope  # noqa: E402

TOL = 1e-9
COUNTS = ("arrivals", "admitted", "rejected", "completed", "replans",
          "peak_live_rows")


def small_fleet(fl, tr, n_cells=3, rate=2.0, horizon=8.0, seed=11, **kw):
    """tests/test_fleet.py's heterogeneous fleet, in module ``fl``."""
    cells = [fl.FleetCell(bandwidth_hz=1.2e6 * (c + 1),
                          speed=1.0 + 0.25 * c,
                          process=tr.PoissonProcess(rate))
             for c in range(n_cells)]
    return fl.FleetScenario(cells=cells, horizon=horizon, seed=seed, **kw)


def epoch_fleet(fl, tr):
    """tests/test_fleet.py's 10-cell epoch fleet (one speed)."""
    cells = [fl.FleetCell(bandwidth_hz=2e6,
                          process=tr.PoissonProcess(5.0))
             for _ in range(10)]
    return fl.FleetScenario(cells=cells, horizon=30.0, seed=1)


def _same(a, b) -> bool:
    """Field-by-field equality of two results, NaN equal to NaN."""
    ta, tb = dataclasses.astuple(a), dataclasses.astuple(b)
    return len(ta) == len(tb) and all(
        x == y or (isinstance(x, float) and math.isnan(x)
                   and math.isnan(y)) for x, y in zip(ta, tb))


def _pair(make, engine="vec", **kw):
    """``simulate_fleet`` of the fleet ``make(fl, tr)`` in both
    packages; the port's under ``device_scope("cpu")``."""
    ref = jf.simulate_fleet(make(jf, jt), engine="vec", **kw)
    with device_scope("cpu"):
        got = pf.simulate_fleet(make(pf, pt), engine=engine, **kw)
    return ref, got


def _close(ref, got):
    """The torch engine's contract against vec."""
    assert abs(got.mean_fid - ref.mean_fid) < TOL
    assert abs(got.outage_rate - ref.outage_rate) < 1e-12
    assert [getattr(got, k) for k in COUNTS] == \
        [getattr(ref, k) for k in COUNTS]


class TestMultiserverEquivalence:
    @pytest.mark.parametrize("alloc", ["equal", "inv_se"])
    @pytest.mark.parametrize("engine", ["vec", "scalar", "torch"])
    def test_event_mode_matches(self, alloc, engine):
        ref, got = _pair(small_fleet, engine, allocator=alloc, mode="event")
        if engine == "torch":
            _close(ref, got)
        else:
            assert _same(ref, dataclasses.replace(got, engine="vec"))
        scn, assignment = pf.fleet_to_scenario(small_fleet(pf, pt))
        assert len(scn.services) > 30
        cell_of = {s.id: assignment[i] for i, s in enumerate(scn.services)}
        multi = simulate_online_multi(
            scn, stacking, ALLOCATORS.get(alloc),
            placement=lambda svc, sim: cell_of[svc.id], engine="vec")
        assert abs(got.mean_fid - multi.mean_fid) < TOL
        assert abs(got.outage_rate - multi.outage_rate) < 1e-12
        assert got.admitted == len(multi.outcomes)

    def test_fleet_to_scenario_equal(self):
        ref, ref_assign = jf.fleet_to_scenario(small_fleet(jf, jt))
        got, assign = pf.fleet_to_scenario(small_fleet(pf, pt))
        assert assign == ref_assign
        assert [dataclasses.astuple(s) for s in got.services] == \
            [dataclasses.astuple(s) for s in ref.services]
        assert [dataclasses.astuple(s) for s in got.servers] == \
            [dataclasses.astuple(s) for s in ref.servers]
        assert (got.content_bits, got.total_bandwidth_hz) == \
            (ref.content_bits, ref.total_bandwidth_hz)
        keys = list(zip([s.arrival for s in got.services], assign))
        assert keys == sorted(keys)


class TestEngineParity:
    def test_epoch_torch_matches_vec(self):
        vec, got = _pair(epoch_fleet, "torch", mode="epoch")
        _close(vec, got)
        assert got.planner_calls < vec.planner_calls
        assert got.planner_calls <= 64          # one call an epoch

    def test_event_torch_batches_rounds(self):
        def fleet(fl, tr):
            return small_fleet(fl, tr, n_cells=4, rate=3.0, horizon=6.0)
        vec, got = _pair(fleet, "torch", mode="event")
        _close(vec, got)
        assert got.planner_calls <= vec.planner_calls

    def test_equal_speeds_share_a_call(self):
        """Cells of one speed batch together: an event round of the
        10-cell fleet is one call, padded to ``kernels._bucket``."""
        vec, got = _pair(epoch_fleet, "torch", mode="event")
        _close(vec, got)
        assert got.planner_calls * 5 < vec.planner_calls

    @pytest.mark.parametrize("S", [3, 9])
    def test_padded_rows_never_reach_best_level(self, S):
        """``replan_many`` pads the scenario axis to ``kernels._bucket``
        (8, 16); each row's winner is the one it gets planned alone."""
        from repro_torch.core.delay_model import DelayModel
        from repro_torch.core.quality_model import PowerLawFID
        from repro_torch.core.torchplan import replan_many
        rng = np.random.default_rng(4)
        taus = rng.uniform(-0.5, 6.0, size=(S, 5))
        offs = rng.integers(0, 4, size=(S, 5))
        kw = dict(delay=DelayModel(), quality=PowerLawFID())
        with device_scope("cpu"):
            res = replan_many(taus, offsets=offs, doomed=(offs > 0)
                              & (taus < 0), **kw)
            alone = [int(replan_many(
                taus[i:i + 1], offsets=offs[i:i + 1],
                doomed=(offs[i:i + 1] > 0) & (taus[i:i + 1] < 0),
                **kw).best_level[0]) for i in range(S)]
        assert res.best_level.shape == (S,)
        assert res.best_level.tolist() == alone

    def test_non_powerlaw_quality_plans_cell_by_cell(self):
        class Linear:
            """Batched scoring is PowerLawFID's only."""
            def fid(self, steps):
                return 100.0 - min(float(steps), 50.0)

            def mean_fid(self, counts):
                return float(np.mean([self.fid(t) for t in counts]))
        with device_scope("cpu"):
            res = pf.simulate_fleet(epoch_fleet(pf, pt), engine="torch",
                                    quality=Linear())
        assert res.planner_calls == res.replans

    @pytest.mark.parametrize("mode", ["event", "epoch"])
    def test_devices_raises(self, mode):
        """``devices=`` no longer raises: the torch engine shards its
        batched replans across devices (here two CPU "devices") with the
        unsharded run's results; vec and scalar have no batched path and
        drop it, as the reference does."""
        for engine in ("torch", "vec", "scalar"):
            with device_scope("cpu"):
                want = pf.simulate_fleet(small_fleet(pf, pt), mode=mode,
                                         engine=engine)
                got = pf.simulate_fleet(small_fleet(pf, pt), mode=mode,
                                        engine=engine,
                                        devices=["cpu", "cpu"])
            assert got.mean_fid == want.mean_fid
            assert got.outage_rate == want.outage_rate
            assert [getattr(got, k) for k in COUNTS] == \
                [getattr(want, k) for k in COUNTS]


class TestCrossMode:
    def _trace_fleet(self, fl, tr):
        times = [0.0, 5.0, 10.0, 15.0]
        cells = [fl.FleetCell(
            bandwidth_hz=2e6,
            process=tr.TraceArrivals([t + 0.3 * c for t in times]))
            for c in range(2)]
        return fl.FleetScenario(cells=cells, horizon=20.0, seed=3,
                                deadline_range=(1.0, 2.0))

    @pytest.mark.parametrize("engine", ["vec", "torch"])
    def test_trace_event_equals_epoch(self, engine):
        ref_ev, ev = _pair(self._trace_fleet, engine, mode="event")
        ref_ep, ep = _pair(self._trace_fleet, engine, mode="epoch",
                           epoch=5.0)
        assert abs(ev.mean_fid - ep.mean_fid) < 1e-12
        assert (ev.arrivals, ev.completed) == (ep.arrivals, ep.completed)
        if engine == "vec":
            assert _same(ref_ev, ev) and _same(ref_ep, ep)

    def test_epoch_chunking_invariant(self):
        def fleet(fl, tr):
            return fl.FleetScenario(
                cells=[fl.FleetCell(bandwidth_hz=3e6, process=tr.
                                    TraceArrivals(np.linspace(0.5, 39.5,
                                                              40)))],
                horizon=40.0, seed=9)
        for width in (10.0, 5.0):
            ref, got = _pair(fleet, mode="epoch", epoch=width)
            assert got.arrivals == 40 and _same(ref, got)


class TestDeterminismAndAccounting:
    def test_seeded_run_is_reproducible(self):
        a = pf.simulate_fleet(small_fleet(pf, pt, seed=5))
        b = pf.simulate_fleet(small_fleet(pf, pt, seed=5))
        assert a == b
        assert a.mean_fid != pf.simulate_fleet(
            small_fleet(pf, pt, seed=6)).mean_fid

    @pytest.mark.parametrize("mode", ["event", "epoch"])
    @pytest.mark.parametrize("engine", ["vec", "torch"])
    def test_every_arrival_accounted(self, mode, engine):
        ref, res = _pair(small_fleet, engine, mode=mode)
        assert res.arrivals > 0
        assert res.admitted + res.rejected == res.arrivals
        assert res.completed == res.admitted
        if engine == "vec":
            assert _same(ref, res)

    @pytest.mark.parametrize("mode", ["event", "epoch"])
    def test_capacity_rejects_equal(self, mode):
        def fleet(fl, tr):
            return fl.FleetScenario(
                cells=[fl.FleetCell(bandwidth_hz=2e6, capacity=3,
                                    process=tr.PoissonProcess(3.0))],
                horizon=10.0, seed=0)
        ref, res = _pair(fleet, mode=mode)
        assert _same(ref, res)
        assert res.admitted <= 3 and res.rejected > 0
        assert res.rejected == res.arrivals - res.admitted

    @pytest.mark.parametrize("mode", ["event", "epoch"])
    @pytest.mark.parametrize("policy", ["deny", "feasible"])
    def test_admission_policy_equal(self, mode, policy):
        adm = (lambda c, p: False) if policy == "deny" else \
            (lambda c, p: p.steps > 0 and p.met_deadline)
        ref, res = _pair(small_fleet, admission=adm, mode=mode)
        assert _same(ref, res)
        if policy == "deny":
            assert res.rejected == res.arrivals
            assert res.completed == res.admitted == 0
        else:
            assert res.rejected > 0
            with device_scope("cpu"):
                tr = pf.simulate_fleet(small_fleet(pf, pt), admission=adm,
                                       mode=mode, engine="torch")
            _close(res, tr)


class TestBoundedMemory:
    def test_peak_rows_track_working_set_not_horizon(self):
        peaks = {}
        for horizon in (25.0, 100.0):
            def fleet(fl, tr):
                return fl.FleetScenario(
                    cells=[fl.FleetCell(bandwidth_hz=1.5e6,
                                        process=tr.PoissonProcess(2.0))
                           for _ in range(8)], horizon=horizon, seed=7)
            ref, res = _pair(fleet, mode="epoch", epoch=5.0)
            assert _same(ref, res)
            peaks[horizon] = res.peak_live_rows
        assert peaks[100.0] <= 2 * peaks[25.0]

    @pytest.mark.parametrize("n", [3, 10_000])
    def test_reservoir_equal(self, n):
        ref = jf.ReservoirQuantiles(capacity=64, seed=0)
        got = pf.ReservoirQuantiles(capacity=64, seed=0)
        for x in np.random.default_rng(0).random(n):
            ref.add(float(x))
            got.add(float(x))
        assert got.count == n and got._buf.size == 64
        np.testing.assert_array_equal(got._buf, ref._buf)
        assert [got.percentile(q) for q in (50, 95, 99)] == \
            [ref.percentile(q) for q in (50, 95, 99)]
        assert np.isnan(pf.ReservoirQuantiles().percentile(50))
        with pytest.raises(ValueError):
            pf.ReservoirQuantiles(capacity=0)


class TestSharedStreamPlacement:
    @pytest.mark.parametrize("placement", ["round_robin", "least_busy",
                                           "rate_aware"])
    @pytest.mark.parametrize("engine", ["vec", "torch"])
    def test_shared_stream_routes(self, placement, engine):
        def fleet(fl, tr):
            cells = [fl.FleetCell(bandwidth_hz=2e6,
                                  process=tr.PoissonProcess(0.5)
                                  if c == 0 else None) for c in range(3)]
            return fl.FleetScenario(cells=cells, horizon=20.0, seed=2,
                                    shared_process=tr.PoissonProcess(4.0))
        ref, res = _pair(fleet, engine, mode="epoch", placement=placement)
        assert res.arrivals > 0
        assert res.admitted + res.rejected == res.arrivals
        if engine == "vec":
            assert _same(ref, res)
        else:
            _close(ref, res)

    def test_event_mode_rejects_shared(self):
        fleet = pf.FleetScenario(
            cells=[pf.FleetCell(bandwidth_hz=1e6)], horizon=5.0,
            shared_process=pt.PoissonProcess(1.0))
        with pytest.raises(ValueError, match="event"):
            pf.simulate_fleet(fleet, mode="event")
        with pytest.raises(ValueError, match="per-cell"):
            pf.fleet_to_scenario(fleet)


class TestValidation:
    @pytest.mark.parametrize("kw,match", [
        (dict(mode="turbo"), "mode"),
        (dict(mode="epoch", epoch=0.0), "epoch"),
        (dict(allocator="pso"), "closed-form"),
        (dict(placement="teleport", mode="epoch"), None),
    ])
    def test_bad_arguments(self, kw, match):
        if match is None:       # a placement only matters with a stream
            fleet = pf.FleetScenario(
                cells=[pf.FleetCell(1e6)], horizon=2.0,
                shared_process=pt.PoissonProcess(2.0))
            with pytest.raises(ValueError, match="placement"):
                pf.simulate_fleet(fleet, **kw)
            return
        with pytest.raises(ValueError, match=match):
            pf.simulate_fleet(small_fleet(pf, pt), **kw)

    def test_allocator_shape_checked(self):
        with pytest.raises(ValueError, match="shape"):
            pf.simulate_fleet(small_fleet(pf, pt), mode="event",
                              allocator=lambda B, se: np.ones(1))

    @pytest.mark.parametrize("kw,match", [
        (dict(cells=[], horizon=1.0), "at least one cell"),
        (dict(cells=[pf.FleetCell(1e6)], horizon=0.0), "horizon"),
        (dict(cells=[pf.FleetCell(1e6)], horizon=1.0,
              deadline_range=(3.0, 1.0)), "deadline_range"),
    ])
    def test_scenario_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            pf.FleetScenario(**kw)


class TestApiFacade:
    def test_make_fleet_scenario_and_run_equal(self):
        kw = dict(rate=1.0, bandwidth_hz=[1e6, 2e6, 3e6, 4e6], speed=1.2,
                  seed=3)
        ref_fleet = jax_make_fleet(4, 20.0, **kw)
        fleet = make_fleet_scenario(4, 20.0, **kw)
        assert fleet.n_cells == 4 and fleet.cells[2].bandwidth_hz == 3e6
        ref = JaxFleetProvisioner(ref_fleet, allocator="inv_se").run()
        got = FleetProvisioner(fleet, allocator="inv_se").run()
        assert _same(ref.result, got.result)
        assert got.summary() == ref.summary()
        assert got.to_dict() == ref.to_dict()
        assert "fleet x4" in got.summary() and "inv_se" in got.summary()

    def test_arrivals_table(self):
        for name in ("poisson", "diurnal", "flash_crowd", "trace"):
            assert name in ARRIVALS
        assert ARRIVALS.get("poisson") is pt.PoissonProcess
        with pytest.raises(KeyError, match="unknown arrival"):
            make_fleet_scenario(2, 5.0, arrival="teleport")

    @pytest.mark.parametrize("kw", [
        dict(rate=2.0, correlation=0.7, seed=4),
        dict(arrival="diurnal", rate=2.0, correlation=0.6, seed=3,
             arrival_kwargs={"amplitude": 0.6, "period": 10.0}),
        dict(arrival="flash_crowd", rate=[0.5, 1.0, 1.5, 2.0, 0.5, 1.0,
                                          1.5, 2.0],
             arrival_kwargs={"peak_rate": 4.0, "start": 2.0,
                             "duration": 3.0}),
        dict(rate=1.0, capacity=[2, None, 3, None, 1, 1, 1, 1],
             shared_arrival="poisson", shared_kwargs={"rate": 2.0}),
    ])
    def test_fleet_specs_equal(self, kw):
        ref = jax_make_fleet(8, 10.0, **kw)
        got = make_fleet_scenario(8, 10.0, **kw)
        for r, g in zip(ref.cells, got.cells):
            assert (g.bandwidth_hz, g.speed, g.capacity) == \
                (r.bandwidth_hz, r.speed, r.capacity)
            assert type(g.process).__name__ == type(r.process).__name__
            assert g.process.mean_rate(0.0, 10.0) == \
                r.process.mean_rate(0.0, 10.0)
        rates = [c.process.mean_rate(0.0, 10.0) for c in got.cells]
        assert min(rates) > 0
        if kw.get("correlation"):
            assert len(set(rates)) > 1
        assert _same(jf.simulate_fleet(ref), pf.simulate_fleet(got))

    def test_trace_spec_loads_file(self, tmp_path):
        p = tmp_path / "t.json"
        p.write_text("[1.0, 2.0]")
        fleet = make_fleet_scenario(
            1, 5.0, arrival="trace", arrival_kwargs={"path": str(p)})
        assert fleet.cells[0].process.times.tolist() == [1.0, 2.0]

    @pytest.mark.parametrize("kw,match", [
        (dict(rate=1.0, bandwidth_hz=[1e6, 2e6]), "bandwidth_hz"),
        (dict(arrival=pt.PoissonProcess(1.0),
              arrival_kwargs={"rate": 2.0}), "already constructed"),
        (dict(correlation=0.5), "rate"),
        (dict(arrival="trace_times", rate=1.0,
              arrival_kwargs={"times": [1.0]}), "neither rate"),
        (dict(rate=1.0, arrival_kwargs={"rate": 2.0}), "conflicts"),
        (dict(rate=[1.0, 2.0], correlation=0.5), "scalar base rate"),
    ])
    def test_bad_specs_raise(self, kw, match):
        n = 3 if "bandwidth_hz" in kw else 2
        with pytest.raises(ValueError, match=match):
            make_fleet_scenario(n, 5.0, **kw)
        with pytest.raises(ValueError, match="n_cells"):
            make_fleet_scenario(0, 5.0)

    def test_torch_facade_on_cpu(self):
        fleet = make_fleet_scenario(6, 20.0, rate=2.0, bandwidth_hz=2e6,
                                    seed=2)
        vec = FleetProvisioner(fleet, allocator="inv_se").run()
        got = FleetProvisioner(fleet, allocator="inv_se", engine="torch",
                               device="cpu").run()
        _close(vec.result, got.result)
        assert got.result.engine == "torch"
        assert got.result.planner_calls < vec.result.planner_calls
        # devices=2: two CPU "devices" (torchplan.resolve_devices), the
        # same results as one
        two = FleetProvisioner(fleet, allocator="inv_se", engine="torch",
                               device="cpu", devices=2).run()
        assert two.result.mean_fid == got.result.mean_fid
        assert [getattr(two.result, k) for k in COUNTS] == \
            [getattr(got.result, k) for k in COUNTS]
