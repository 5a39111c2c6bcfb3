"""Public surface of the port: the ``Provisioner`` pipeline and its
workloads (diffusion, llm_decode)."""

from repro_torch.api.provisioner import (ALLOCATORS, SCHEDULERS,
                                         ProvisionReport, Provisioner)
from repro_torch.api.workloads import (DecodeWorkload, DiffusionWorkload,
                                       WorkloadOutput)

__all__ = ["ALLOCATORS", "SCHEDULERS", "DecodeWorkload", "DiffusionWorkload",
           "ProvisionReport", "Provisioner", "WorkloadOutput"]
