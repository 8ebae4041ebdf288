"""Kubernetes deployer/operator (L8) — the port's own copy of
``langstream_tpu/k8s/``.

Parity: reference ``langstream-k8s-deployer`` — CRDs
(``applications`` / ``agents`` of the ``langstream.tpu`` API group,
deployer-api/AgentSpec.java:33), JOSDK reconcilers (AppController.java:54,
AgentController.java:58), resource factories (AgentResourcesFactory.java:91-591,
AppResourcesFactory.java). The group, kinds, labels, annotations, Secret keys
and env names are the JAX package's, so either package's operator reconciles
the other's CRs. Agent pods request NVIDIA H100 cards (``nvidia.com/gpu``,
GKE's ``nvidia-h100-80gb`` node label) from the agent's ``resources.tpu``
spec, and run ``python -m langstream_tpu_torch.entrypoint <role>``
(``k8s/resources.py`` lists every difference from the JAX manifests).

No real cluster is required: controllers run against any object with the
five verbs of ``FakeKubeServer`` (the KubeTestServer analogue), which backs
tests and local mode; ``KubeApiClient`` speaks them to a live API server or
to ``http_fake.HttpFakeKubeServer``.
"""

from langstream_tpu_torch.k8s.crds import AgentCustomResource, ApplicationCustomResource
from langstream_tpu_torch.k8s.fake import FakeKubeServer
from langstream_tpu_torch.k8s.resources import AgentResourcesFactory, AppResourcesFactory
from langstream_tpu_torch.k8s.controllers import AgentController, AppController

__all__ = [
    "AgentController",
    "AgentCustomResource",
    "AgentResourcesFactory",
    "AppController",
    "AppResourcesFactory",
    "ApplicationCustomResource",
    "FakeKubeServer",
]
