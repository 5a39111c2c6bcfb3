"""Public surface of the port (the reference's ``repro.api``, whole).

Three pipeline protocols (Workload / Scheduler / Allocator) plus online
admission policies and multi-server placements, a string-keyed registry
per component kind (``register_*``, ``get_*``, ``list_*``), the four
provisioning facades (``Provisioner``, ``OnlineProvisioner``,
``MultiServerProvisioner``, ``FleetProvisioner``), the ``provision()``
front door, the workloads (diffusion, llm_decode) and the closed
execution loop (``execute_plan``, ``execute_report``, ``make_session``,
``replay_result``, behind the ``EXECUTORS`` registry).  The names are
the reference's, its ``*_jax`` entries read as ``*_torch``.
"""

from repro_torch.api.base import BaseProvisioner, provision
from repro_torch.api.protocols import (Allocator, OffsetScheduler,
                                       Scheduler, Workload, WorkloadOutput)
from repro_torch.api.registry import (ADMISSIONS, ALLOCATORS, ARRIVALS,
                                      EXECUTORS, PLACEMENTS, SCHEDULERS,
                                      WORKLOADS,
                                      get_admission, get_allocator,
                                      get_arrival, get_executor,
                                      get_placement, get_scheduler,
                                      get_workload,
                                      list_admissions, list_allocators,
                                      list_arrivals, list_executors,
                                      list_placements, list_schedulers,
                                      list_workloads,
                                      register_admission, register_allocator,
                                      register_arrival, register_executor,
                                      register_placement, register_scheduler,
                                      register_workload)
# entry modules populate the registries on import
from repro_torch.api import allocators as _allocators   # noqa: F401
from repro_torch.api import schedulers as _schedulers   # noqa: F401
from repro_torch.api import workloads as _workloads     # noqa: F401
from repro_torch.api import online as _online           # noqa: F401
from repro_torch.api import placements as _placements   # noqa: F401
from repro_torch.api import fleet as _fleet             # noqa: F401
from repro_torch.api import execution as _execution     # noqa: F401
from repro_torch.api.workloads import DecodeWorkload, DiffusionWorkload
from repro_torch.api.provisioner import Provisioner, ProvisionReport
from repro_torch.api.online import OnlineProvisioner, OnlineReport
from repro_torch.api.multiserver import (MultiOnlineReport,
                                         MultiProvisionReport,
                                         MultiServerProvisioner)
from repro_torch.api.fleet import (FleetProvisioner, FleetReport,
                                   make_fleet_scenario)
from repro_torch.api.execution import (execute_plan, execute_report,
                                       make_session, replay_result)
from repro_torch.core.execution import (ExecutionLoop, ExecutionResult,
                                        SimulatedSession)

__all__ = [
    "Allocator", "OffsetScheduler", "Scheduler", "Workload",
    "WorkloadOutput",
    "ADMISSIONS", "ALLOCATORS", "ARRIVALS", "EXECUTORS", "PLACEMENTS",
    "SCHEDULERS", "WORKLOADS",
    "register_admission", "register_allocator", "register_arrival",
    "register_executor", "register_placement", "register_scheduler",
    "register_workload",
    "get_admission", "get_allocator", "get_arrival", "get_executor",
    "get_placement", "get_scheduler", "get_workload",
    "list_admissions", "list_allocators", "list_arrivals",
    "list_executors", "list_placements", "list_schedulers",
    "list_workloads",
    "DecodeWorkload", "DiffusionWorkload",
    "BaseProvisioner", "provision",
    "Provisioner", "ProvisionReport",
    "OnlineProvisioner", "OnlineReport",
    "MultiServerProvisioner", "MultiProvisionReport", "MultiOnlineReport",
    "FleetProvisioner", "FleetReport", "make_fleet_scenario",
    "execute_plan", "execute_report", "make_session", "replay_result",
    "ExecutionLoop", "ExecutionResult", "SimulatedSession",
]
