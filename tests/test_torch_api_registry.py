"""The port's registries (``repro_torch.api.registry``), protocols and
deprecated positional constructors against the reference's
``repro.api``: the same names (``*_jax`` read as ``*_torch``), the same
errors (tests/test_api.py's), and positional calls that warn and give
what the keyword forms give (tests/test_facades.py's)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as R  # noqa: E402
import repro_torch.api as P  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.service import make_scenario  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402

DELAY = DelayModel()
KINDS = ("schedulers", "allocators", "workloads", "admissions",
         "placements", "arrivals", "executors")


@pytest.mark.parametrize("kind", KINDS)
def test_list_equals_the_reference(kind):
    want = sorted(n.replace("jax", "torch")
                  for n in getattr(R, f"list_{kind}")())
    assert getattr(P, f"list_{kind}")() == want
    reg = getattr(P, kind.upper())
    assert isinstance(reg, registry.Registry) and reg.names() == want


def test_reference_surface_is_the_ports():
    assert set(R.__all__) <= set(P.__all__)
    for name in P.__all__:
        assert hasattr(P, name), name


def test_lookup_and_aliases():
    assert P.get_scheduler("stacking") is stacking
    assert P.get_scheduler("fixed") is P.get_scheduler("fixed_size")
    assert P.get_scheduler("offset_torch") is \
        P.get_scheduler("stacking_offset_torch")
    assert P.get_admission("all") is P.get_admission("admit_all")
    assert P.get_admission("feasible") is \
        P.get_admission("deadline_feasible")
    assert P.get_placement("rr") is P.get_placement("round_robin")
    assert P.get_placement("coord_desc") is P.get_placement("alternating")
    assert P.get_arrival("flash") is P.get_arrival("flash_crowd")
    assert P.get_arrival("csv") is P.get_arrival("trace")
    assert P.get_workload("diffusion") is P.DiffusionWorkload
    assert P.get_workload("llm_decode") is P.DecodeWorkload
    assert P.get_executor("diffusion") is P.get_executor("llm_decode")


def test_unknown_name_raises_with_candidates():
    with pytest.raises(KeyError, match="unknown scheduler 'nope'"):
        P.get_scheduler("nope")
    with pytest.raises(KeyError, match="registered:.*pso"):
        P.get_allocator("psso")
    with pytest.raises(KeyError, match="unknown workload"):
        P.get_workload("video")
    with pytest.raises(KeyError, match="unknown scheduler 'greedy_jax'"):
        P.Provisioner(make_scenario(K=2), scheduler="greedy_jax")


def test_duplicate_registration_rejected():
    with pytest.raises(ValueError, match="already registered"):
        P.register_scheduler("stacking", stacking)
    with pytest.raises(ValueError, match="already registered"):
        P.register_placement("new_name", print, aliases=("rr",))


def test_resolve_passes_callables_through_and_decorators_register():
    def my_sched(services, tau_prime, delay, quality):
        return stacking(services, tau_prime, delay, quality)
    assert P.SCHEDULERS.resolve(my_sched) is my_sched
    reg = registry.Registry("widget")

    @reg.register("w", aliases=("v",))
    def widget():
        return 1
    assert reg.get("v") is widget and reg.names() == ["v", "w"]
    assert "w" in reg and "x" not in reg
    assert registry.display_name(my_sched) == "my_sched"
    assert registry.display_name("stacking") == "stacking"


def test_protocols_hold_the_ports_components():
    assert isinstance(P.get_scheduler("stacking"), P.Scheduler)
    assert isinstance(P.get_scheduler("stacking_offset"), P.OffsetScheduler)
    assert not isinstance(stacking, P.OffsetScheduler)
    assert isinstance(P.get_allocator("pso"), P.Allocator)
    wl = P.DiffusionWorkload(device="cpu")
    assert isinstance(wl, P.Workload)
    assert P.WorkloadOutput(content={}).timings == []


def _static(**kw):
    return make_scenario(**{"K": 5, "seed": 3, **kw})


def test_provisioner_positional_warns_and_matches():
    scn = _static()
    with pytest.warns(DeprecationWarning, match="positional"):
        old = P.Provisioner(scn, None, "stacking", "inv_se", DELAY)
    new = P.Provisioner(scn, workload=None, scheduler="stacking",
                        allocator="inv_se", delay=DELAY)
    a, b = old.run(execute=False), new.run(execute=False)
    assert a.mean_fid == b.mean_fid
    assert a.plan.batches == b.plan.batches


def test_online_positional_warns_and_matches():
    scn = _static(K=6, seed=1, arrival_rate=0.5)
    with pytest.warns(DeprecationWarning, match="positional"):
        old = P.OnlineProvisioner(scn, "stacking", "equal", "admit_all",
                                  DELAY)
    new = P.OnlineProvisioner(scn, scheduler="stacking", allocator="equal",
                              admission="admit_all", delay=DELAY)
    assert old.run().mean_fid == new.run().mean_fid
    assert old.admission_name == "admit_all"


def test_multiserver_positional_warns_and_matches():
    scn = _static(K=8, seed=2, n_servers=3, server_speed_range=(0.7, 1.3))
    with pytest.warns(DeprecationWarning, match="positional"):
        old = P.MultiServerProvisioner(scn, "least_loaded", "stacking",
                                       "inv_se", DELAY)
    new = P.MultiServerProvisioner(scn, placement="least_loaded",
                                   scheduler="stacking", allocator="inv_se",
                                   delay=DELAY)
    a, b = old.run(), new.run()
    assert a.mean_fid == b.mean_fid
    np.testing.assert_array_equal(a.assignment, b.assignment)


@pytest.mark.parametrize("cls,args,kw", [
    ("Provisioner", (None, "stacking"), dict(scheduler="stacking_offset")),
    ("OnlineProvisioner", ("stacking",), dict(scheduler="greedy")),
    ("MultiServerProvisioner", ("least_loaded",), dict(placement="rr")),
])
def test_positional_keyword_conflict_raises(cls, args, kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(TypeError, match="multiple values"):
            getattr(P, cls)(_static(), *args, **kw)


def test_too_many_positionals_raise():
    with pytest.raises(TypeError, match="positional"):
        P.Provisioner(_static(), None, "stacking", "inv_se", DELAY, None,
                      None, None, "extra")
    with pytest.raises(TypeError, match="at most 9"):
        P.OnlineProvisioner(_static(), *(["stacking"] * 9))
