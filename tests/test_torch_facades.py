"""The port's facade surface (``repro_torch.api.base``, ``api.online``,
the shared kwargs, the ``provision()`` front door and the ``to_dict``
report protocol) against ``repro.api`` on the same seeds.

Analytic results are NumPy arithmetic in the reference's order, so they
are held equal (``==``); the torch planner engine, on the CPU, within
1e-9 mean FID of the port's vec engine.  ``OnlineProvisioner(execute=
True)`` replays on the SMOKE U-Net from the reference session's latents,
images within 1e-4 (the U-Net forward's tolerance across frameworks).
Mirrors tests/test_online.py (TestAdmissionRegistry,
TestAdmissionPolicies) and tests/test_facades.py (TestSharedKwargs,
TestProvisionFrontDoor, TestReportProtocol)."""

import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro.api as R  # noqa: E402
from repro.api.execution import replay_plan as jax_replay_plan  # noqa: E402
from repro.core import service as js  # noqa: E402
from repro.core.delay_model import DelayModel as JaxDelay  # noqa: E402
from repro_torch import api as P  # noqa: E402
from repro_torch.configs.ddim_cifar10 import SMOKE  # noqa: E402
from repro_torch.core import service as ps  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from test_torch_unet import redrawn_params  # noqa: E402

TOL = 1e-9
DELAY = dict(a=0.05, b=0.1)
REQUIRED = {"kind", "mean_fid", "outage_rate", "makespan", "components",
            "telemetry"}


def _rows(objs):
    return [dataclasses.astuple(o) for o in objs]


def _decisions(result):
    return [(d.id, d.arrival, d.admitted, dataclasses.astuple(d.projected))
            for d in result.decisions]


def _online(pkg, scn_kw, **kw):
    """``OnlineProvisioner(...).run()`` of package ``pkg`` (R or P)."""
    svc = js if pkg is R else ps
    delay = (JaxDelay if pkg is R else DelayModel)(**DELAY)
    return pkg.OnlineProvisioner(svc.make_scenario(**scn_kw), delay=delay,
                                 **kw).run()


def _reference(fn, *args, **kw):
    """A reference call with its deprecation warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


class TestAdmissionRegistry:
    def test_names_match_reference(self):
        assert sorted(P.ADMISSIONS) == R.list_admissions()
        assert P.ADMISSIONS["feasible"] is P.ADMISSIONS["deadline_feasible"]
        assert P.ADMISSIONS["all"] is P.ADMISSIONS["admit_all"]
        assert sorted(P.PLACEMENTS) == R.list_placements()
        assert sorted(P.ARRIVALS) == R.list_arrivals()
        assert sorted(P.ALLOCATORS) == R.list_allocators()
        assert sorted(P.WORKLOADS) == R.list_workloads()

    def test_unknown_name_raises_with_candidates(self):
        with pytest.raises(ValueError, match="unknown admission"):
            P.OnlineProvisioner(ps.make_scenario(K=2), admission="bouncer")


ADMISSION_CASES = [
    ("admit_all", None, dict(K=8, arrival_rate=2.0, seed=0)),
    ("deadline_feasible", None, dict(K=14, tau_min=1.0, tau_max=3.0,
                                     arrival_rate=4.0, seed=1)),
    ("feasible", None, dict(K=10, arrival_rate=0.3, seed=11)),
    ("fid_threshold", dict(threshold=20.0), dict(
        K=14, tau_min=1.0, tau_max=3.0, arrival_rate=4.0, seed=1)),
    ("fid_threshold", dict(threshold=1e9), dict(
        K=14, tau_min=1.0, tau_max=3.0, arrival_rate=4.0, seed=1)),
]


class TestAdmissionPolicies:
    @pytest.mark.parametrize("admission,akw,scn_kw", ADMISSION_CASES,
                             ids=[f"{a}-{i}" for i, (a, _, _) in
                                  enumerate(ADMISSION_CASES)])
    def test_policy_equal_to_reference(self, admission, akw, scn_kw):
        kw = dict(scheduler="stacking", allocator="inv_se",
                  admission=admission, admission_kwargs=akw)
        ref = _online(R, scn_kw, **kw)
        got = _online(P, scn_kw, **kw)
        assert _rows(got.result.outcomes) == _rows(ref.result.outcomes)
        assert _decisions(got.result) == _decisions(ref.result)
        assert got.result.executed_batches == ref.result.executed_batches
        assert got.to_dict() == ref.to_dict()
        assert got.summary() == ref.summary()
        policy = P.ADMISSIONS[admission]
        for d in got.result.decisions:
            assert d.admitted == policy(None, d.projected, {},
                                        **(akw or {}))
        if admission == "admit_all":
            assert got.reject_rate == 0.0
            assert len(got.result.outcomes) == scn_kw["K"]

    @pytest.mark.parametrize("policy,admitted", [
        (lambda svc, projected, states: False, []),
        (lambda svc, projected, states: svc.id % 2 == 0, [0, 2, 4]),
    ], ids=["deny", "evens"])
    def test_custom_policy_passes_through(self, policy, admitted):
        scn_kw = dict(K=6, arrival_rate=1.0, seed=4)
        kw = dict(scheduler="greedy", allocator="equal", admission=policy)
        ref = _online(R, scn_kw, **kw)
        got = _online(P, scn_kw, **kw)
        assert got.result.admitted_ids == ref.result.admitted_ids == admitted
        assert _rows(got.result.outcomes) == _rows(ref.result.outcomes)
        if not admitted:
            assert got.reject_rate == 1.0 and np.isnan(got.mean_fid)
        assert got.admission_name == "<lambda>"

    @pytest.mark.parametrize("admission", ["admit_all", "deadline_feasible"])
    def test_torch_engine_on_cpu(self, admission):
        scn_kw = dict(K=12, tau_min=1.0, tau_max=4.0, arrival_rate=3.0,
                      seed=2)
        kw = dict(scheduler="stacking", allocator="inv_se",
                  admission=admission)
        vec = _online(P, scn_kw, **kw)
        got = _online(P, scn_kw, engine="torch", device="cpu", **kw)
        assert abs(got.mean_fid - vec.mean_fid) < TOL
        assert got.result.admitted_ids == vec.result.admitted_ids
        assert _online(P, scn_kw, engine="scalar", **kw).to_dict() == \
            vec.to_dict()


FACADES = [
    ("Provisioner", dict(K=6, seed=0)),
    ("OnlineProvisioner", dict(K=6, seed=0, arrival_rate=0.5)),
    ("MultiServerProvisioner", dict(K=6, seed=0, n_servers=2)),
]


class TestSharedKwargs:
    @pytest.mark.parametrize("name,scn_kw", FACADES,
                             ids=[n for n, _ in FACADES])
    def test_seed_reaches_seeded_allocator(self, name, scn_kw):
        cls = getattr(P, name)
        scn = ps.make_scenario(**scn_kw)
        assert cls(scn, allocator="pso", seed=5).allocator_kwargs == \
            _reference(getattr(R, name), js.make_scenario(**scn_kw),
                       allocator="pso", seed=5).allocator_kwargs == \
            {"seed": 5}
        assert cls(scn, allocator="pso", seed=5,
                   allocator_kwargs={"seed": 9}).allocator_kwargs == \
            {"seed": 9}
        assert cls(scn, allocator="inv_se", seed=5).allocator_kwargs == {}

    def test_seed_determinism_pso_equal(self):
        kw = dict(allocator="pso", seed=3,
                  allocator_kwargs={"iters": 5, "num_particles": 6})
        a = P.Provisioner(ps.make_scenario(K=6, seed=0),
                          delay=DelayModel(**DELAY), **kw).allocate()
        b = P.Provisioner(ps.make_scenario(K=6, seed=0),
                          delay=DelayModel(**DELAY), **kw).allocate()
        ref = _reference(R.Provisioner, js.make_scenario(K=6, seed=0),
                         delay=JaxDelay(**DELAY), **kw).allocate()
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, ref)

    def test_fleet_seed_reseeds_arrivals(self):
        fleet = P.make_fleet_scenario(n_cells=3, horizon=4.0, rate=1.0,
                                      seed=0)
        p = P.FleetProvisioner(fleet, seed=42)
        assert p.fleet.seed == 42
        ref = R.FleetProvisioner(R.make_fleet_scenario(
            n_cells=3, horizon=4.0, rate=1.0, seed=0), seed=42).run()
        assert p.run().to_dict() == ref.to_dict()

    @pytest.mark.parametrize("cls", ["Provisioner", "OnlineProvisioner",
                                     "MultiServerProvisioner"])
    def test_execute_validation_at_construction(self, cls):
        with pytest.raises(ValueError, match="execute"):
            getattr(P, cls)(ps.make_scenario(K=2), execute="sideways")
        fleet = P.make_fleet_scenario(n_cells=2, horizon=2.0, rate=1.0)
        with pytest.raises(ValueError, match="execute"):
            P.FleetProvisioner(fleet, execute="sideways")

    @pytest.mark.parametrize("cls", ["Provisioner", "OnlineProvisioner",
                                     "MultiServerProvisioner"])
    def test_engine_checked_at_construction(self, cls):
        with pytest.raises(ValueError, match="unknown planner engine"):
            getattr(P, cls)(ps.make_scenario(K=2), engine="jax")
        fleet = P.make_fleet_scenario(n_cells=2, horizon=2.0, rate=1.0)
        with pytest.raises(ValueError, match="unknown planner engine"):
            P.FleetProvisioner(fleet, engine="warp")

    def test_fleet_and_multiserver_execute_raise(self):
        fleet = P.make_fleet_scenario(n_cells=2, horizon=2.0, rate=1.0)
        with pytest.raises(NotImplementedError):
            P.FleetProvisioner(fleet, execute=True).run()
        ms = P.MultiServerProvisioner(ps.make_scenario(K=6, n_servers=2),
                                      delay=DelayModel(**DELAY))
        with pytest.raises(NotImplementedError, match="per cell"):
            ms.run(execute="closed")
        with pytest.raises(NotImplementedError, match="per cell"):
            ms.run_online(execute=True)

    @pytest.mark.parametrize("cls,kw", [
        ("Provisioner", "devices"), ("OnlineProvisioner", "devices"),
        ("MultiServerProvisioner", "devices"),
        ("MultiServerProvisioner", "execute_kwargs")])
    def test_knobs_a_facade_would_drop_are_refused(self, cls, kw):
        """No facade takes a knob it cannot act on: ``devices=`` only
        where it reaches the batched planner (the fleet), and
        ``execute_kwargs=`` only where a run executes."""
        with pytest.raises(TypeError, match=kw):
            getattr(P, cls)(ps.make_scenario(K=2), **{kw: {}})
        fleet = P.make_fleet_scenario(n_cells=2, horizon=2.0, rate=1.0)
        with pytest.raises(TypeError, match="execute_kwargs"):
            P.FleetProvisioner(fleet, execute_kwargs={})
        with pytest.raises(NotImplementedError, match="devices"):
            P.FleetProvisioner(fleet, devices=["cuda:0"]).run()

    def test_online_execute_modes(self):
        on = P.OnlineProvisioner(ps.make_scenario(K=3, arrival_rate=1.0),
                                 allocator="inv_se")
        with pytest.raises(ValueError, match="replays"):
            on.run(execute="closed")
        with pytest.raises(ValueError, match="workload"):
            on.run(execute=True)

    def test_seed_is_the_default_generator(self):
        """``seed=`` draws the workload's latents as an explicit
        generator seeded alike does."""
        scn = ps.make_scenario(K=2, tau_min=1.5, tau_max=3.0, seed=2)
        wl = P.DiffusionWorkload(device="cpu")
        a = P.Provisioner(scn, workload=wl, allocator="inv_se",
                          device="cpu", seed=7).run()
        b = P.Provisioner(scn, workload=wl, allocator="inv_se",
                          device="cpu").run(torch.Generator().manual_seed(7))
        c = P.Provisioner(scn, workload=wl, allocator="inv_se",
                          device="cpu").run(torch.Generator().manual_seed(8))
        for k in a.content:
            np.testing.assert_array_equal(a.content[k], b.content[k])
        assert any(not np.array_equal(a.content[k], c.content[k])
                   for k in a.content)


def _front_door_cases():
    """(case, scenario of module m, facade, method, ctor kwargs, run
    kwargs); ``provision`` gets both kwarg sets at once."""
    return [
        ("static", lambda m: m.make_scenario(K=6, seed=0),
         "Provisioner", "run",
         dict(scheduler="stacking", allocator="inv_se"),
         dict(execute=False)),
        ("online", lambda m: m.make_scenario(K=6, seed=1,
                                             arrival_rate=0.5),
         "OnlineProvisioner", "run",
         dict(scheduler="stacking", allocator="inv_se"), {}),
        ("admission", lambda m: m.make_scenario(K=6, seed=0),
         "OnlineProvisioner", "run",
         dict(allocator="inv_se", admission="deadline_feasible"), {}),
        ("multi", lambda m: m.make_scenario(
            K=8, seed=2, n_servers=3, server_speed_range=(0.7, 1.3)),
         "MultiServerProvisioner", "run", dict(allocator="inv_se"), {}),
        ("multi_online", lambda m: m.make_scenario(
            K=8, seed=3, n_servers=2, arrival_rate=0.5),
         "MultiServerProvisioner", "run_online", dict(allocator="inv_se"),
         dict(admission="admit_all")),
        ("fleet", lambda m: m.make_fleet_scenario(
            n_cells=3, horizon=4.0, rate=1.0, seed=5),
         "FleetProvisioner", "run", dict(allocator="equal"), {}),
    ]


FRONT_DOOR = _front_door_cases()


class TestProvisionFrontDoor:
    @pytest.mark.parametrize("case,make,facade,method,ctor,run", FRONT_DOOR,
                             ids=[c[0] for c in FRONT_DOOR])
    def test_dispatch_equal(self, case, make, facade, method, ctor, run):
        fleet = case == "fleet"
        ref_scn, scn = (make(R), make(P)) if fleet else (make(js), make(ps))
        delay = {} if fleet else dict(delay=DelayModel(**DELAY))
        jdelay = {} if fleet else dict(delay=JaxDelay(**DELAY))
        got = P.provision(scn, **delay, **ctor, **run)
        want = getattr(getattr(P, facade)(scn, **delay, **ctor),
                       method)(**run)
        ref = _reference(R.provision, ref_scn, **jdelay, **ctor, **run)
        assert type(got) is type(want)
        assert type(got).__name__ == type(ref).__name__
        assert got.to_dict() == want.to_dict() == ref.to_dict()
        assert got.summary() == want.summary() == ref.summary()
        if case == "static":
            assert got.plan.batches == ref.plan.batches
        if case in ("online", "admission"):
            assert got.result.executed_batches == \
                ref.result.executed_batches
        if case == "multi":
            np.testing.assert_array_equal(got.assignment, ref.assignment)

    def test_torch_engine_dispatch(self):
        scn = ps.make_scenario(K=8, seed=2, n_servers=3,
                               server_speed_range=(0.7, 1.3))
        vec = P.provision(scn, allocator="inv_se")
        got = P.provision(scn, allocator="inv_se", engine="torch",
                          device="cpu")
        assert list(got.assignment) == list(vec.assignment)
        assert abs(got.mean_fid - vec.mean_fid) < TOL


class TestReportProtocol:
    def _check(self, d, kind):
        assert REQUIRED <= set(d)
        assert d["kind"] == kind
        json.loads(json.dumps(d))

    def test_every_kind(self):
        static = ps.make_scenario(K=6, seed=0)
        delay = DelayModel(**DELAY)
        d = P.Provisioner(static, allocator="inv_se",
                          delay=delay).run(execute=False).to_dict()
        self._check(d, "provision")
        assert d["components"]["allocator"] == "inv_se"
        on = P.OnlineProvisioner(ps.make_scenario(K=6, seed=1,
                                                  arrival_rate=0.5),
                                 allocator="inv_se", delay=delay).run()
        self._check(on.to_dict(), "online")
        assert 0.0 <= on.to_dict()["reject_rate"] <= 1.0
        assert on.makespan() is None or on.makespan() > 0
        ms = P.MultiServerProvisioner(ps.make_scenario(
            K=8, seed=2, n_servers=3, server_speed_range=(0.7, 1.3)),
            allocator="inv_se", delay=delay)
        self._check(ms.run().to_dict(), "multi")
        self._check(ms.run_online().to_dict(), "multi_online")
        rep = P.FleetProvisioner(P.make_fleet_scenario(
            n_cells=3, horizon=4.0, rate=1.0, seed=5)).run()
        d = rep.to_dict()
        self._check(d, "fleet")
        assert d["telemetry"]["arrivals"] == rep.result.arrivals

    def test_jsonable(self):
        from repro.api.base import jsonable as jax_jsonable
        v = {1: np.arange(3), "x": (np.float32(1.5), np.bool_(True)),
             "y": [np.int64(4), {"z": np.array([[1.0]])}]}
        assert P.base.jsonable(v) == jax_jsonable(v)
        json.dumps(P.base.jsonable(v))


KEY = jax.random.PRNGKey(0)
SCN = dict(K=3, tau_min=1.5, tau_max=3.0, arrival_rate=2.0, seed=2)


def test_online_execute_matches_reference_images():
    """``OnlineProvisioner(execute=True)``: the replayed batches are the
    simulated ones and the images the reference's within 1e-4, from the
    reference session's latents (conv_out redrawn)."""
    params = redrawn_params(SMOKE)
    jwl = R.DiffusionWorkload(params=params)
    ref = R.OnlineProvisioner(js.make_scenario(**SCN), workload=jwl,
                              scheduler="stacking", allocator="inv_se",
                              execute=True).run(key=KEY)
    steps = {o.id: o.steps for o in ref.result.outcomes}
    plan = jax_replay_plan(ref.result.executed_batches, steps, ref.delay)
    latents = {k: np.asarray(v) for k, v in
               jwl._ex().open_session(plan, KEY).latents.items()}
    wl = P.DiffusionWorkload(
        cfg=SMOKE, params=params_from_numpy(unet.schema(SMOKE), params,
                                            "cpu"), device="cpu")
    got = P.OnlineProvisioner(ps.make_scenario(**SCN), workload=wl,
                              scheduler="stacking", allocator="inv_se",
                              execute=True, device="cpu",
                              seed=0).run(latents=latents)
    assert got.result.executed_batches == ref.result.executed_batches
    assert [x for x, _ in got.timings] == \
        [len(ids) for _, ids in got.result.executed_batches]
    assert sorted(got.content) == sorted(ref.content)
    assert len(got.result.executed_batches) > 1
    for k, img in ref.content.items():
        assert np.isfinite(got.content[k]).all()
        np.testing.assert_allclose(got.content[k], img, atol=1e-4,
                                   rtol=1e-4)
    assert got.to_dict()["telemetry"]["batches"] == \
        ref.to_dict()["telemetry"]["batches"]
