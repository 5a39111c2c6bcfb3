"""Public surface of the port: the four provisioning facades and the
``provision()`` front door, their component tables (``SCHEDULERS``,
``ALLOCATORS``, ``ADMISSIONS``, ``PLACEMENTS``, ``ARRIVALS``), the
workloads (diffusion, llm_decode) and the closed execution loop
(``execute_plan``, ``execute_report``, ``replay_result``,
``EXECUTORS``).  The tables are plain dicts; their keys are the names
the reference's ``list_*()`` return."""

from repro_torch.api.base import BaseProvisioner, provision
from repro_torch.api.execution import (EXECUTORS, execute_plan,
                                       execute_report, replay_result)
from repro_torch.api.fleet import (ARRIVALS, FleetProvisioner, FleetReport,
                                   make_fleet_scenario)
from repro_torch.api.multiserver import (MultiOnlineReport,
                                         MultiProvisionReport,
                                         MultiServerProvisioner)
from repro_torch.api.online import ADMISSIONS, OnlineProvisioner, OnlineReport
from repro_torch.api.placements import PLACEMENTS
from repro_torch.api.provisioner import (ALLOCATORS, SCHEDULERS, WORKLOADS,
                                         ProvisionReport, Provisioner)
from repro_torch.api.workloads import (DecodeWorkload, DiffusionWorkload,
                                       WorkloadOutput)
from repro_torch.core.execution import ExecutionResult

__all__ = ["ADMISSIONS", "ALLOCATORS", "ARRIVALS", "EXECUTORS",
           "PLACEMENTS", "SCHEDULERS", "WORKLOADS", "BaseProvisioner",
           "DecodeWorkload", "DiffusionWorkload", "ExecutionResult",
           "FleetProvisioner", "FleetReport", "MultiOnlineReport",
           "MultiProvisionReport", "MultiServerProvisioner",
           "OnlineProvisioner", "OnlineReport", "ProvisionReport",
           "Provisioner", "WorkloadOutput", "execute_plan",
           "execute_report", "make_fleet_scenario", "provision",
           "replay_result"]
