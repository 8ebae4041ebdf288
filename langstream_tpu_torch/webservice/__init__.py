"""Control plane (L7): REST API over application store + code storage (the
port's own copy of ``langstream_tpu/webservice/``, on the stdlib).

Parity: reference ``langstream-webservice/`` — ``/api/applications/{tenant}``
CRUD (ApplicationResource.java:79-493), ``/api/tenants`` (TenantResource),
``/api/archetypes`` (ArchetypeResource), code zips into a CodeStorage
(CodeStorageService), apps persisted through an ApplicationStore
(reference KubernetesApplicationStore / langstream-k8s-storage).
"""

from langstream_tpu_torch.webservice.stores import (
    InMemoryApplicationStore,
    LocalDiskApplicationStore,
    LocalDiskCodeStorage,
    LocalDiskGlobalMetadataStore,
)
from langstream_tpu_torch.webservice.service import ApplicationService, TenantService
from langstream_tpu_torch.webservice.server import ControlPlaneServer

__all__ = [
    "ApplicationService",
    "ControlPlaneServer",
    "InMemoryApplicationStore",
    "LocalDiskApplicationStore",
    "LocalDiskCodeStorage",
    "LocalDiskGlobalMetadataStore",
    "TenantService",
]
