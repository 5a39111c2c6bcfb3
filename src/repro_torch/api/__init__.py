"""Public surface of the port: the ``Provisioner`` pipeline, its
workloads (diffusion, llm_decode) and the closed execution loop
(``execute_plan``, ``execute_report``, ``EXECUTORS``)."""

from repro_torch.api.execution import (EXECUTORS, execute_plan,
                                       execute_report)
from repro_torch.api.provisioner import (ALLOCATORS, SCHEDULERS,
                                         ProvisionReport, Provisioner)
from repro_torch.api.workloads import (DecodeWorkload, DiffusionWorkload,
                                       WorkloadOutput)
from repro_torch.core.execution import ExecutionResult

__all__ = ["ALLOCATORS", "EXECUTORS", "SCHEDULERS", "DecodeWorkload",
           "DiffusionWorkload", "ExecutionResult", "ProvisionReport",
           "Provisioner", "WorkloadOutput", "execute_plan", "execute_report"]
