"""Public surface of the port: the ``Provisioner`` pipeline and the
diffusion workload."""

from repro_torch.api.provisioner import (ALLOCATORS, SCHEDULERS,
                                         ProvisionReport, Provisioner)
from repro_torch.api.workloads import DiffusionWorkload, WorkloadOutput

__all__ = ["ALLOCATORS", "SCHEDULERS", "DiffusionWorkload",
           "ProvisionReport", "Provisioner", "WorkloadOutput"]
