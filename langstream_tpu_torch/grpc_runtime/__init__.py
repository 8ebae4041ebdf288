"""Out-of-process (polyglot) agent runtime over gRPC (the port's own copy of
``langstream_tpu/grpc_runtime``).

Parity: reference ``langstream-agent-grpc`` (Java bridge:
AbstractGrpcAgent.java:54, GrpcAgentProcessor.java:31, PythonGrpcServer.java:
40-90) + ``langstream-runtime-impl/src/main/python`` (grpc_service.py:75-415).
User code runs in a child process (crash isolation, its own dependencies,
no CUDA context) and speaks the proto contract to the runtime.

Layout: ``proto/agent.proto`` (IDL: package ``langstream_tpu``, the JAX
package's wire names, so either package's bridge drives the other's child),
``agent_pb2`` (protoc-generated messages, the JAX package's descriptor byte
for byte; service glue is hand-written in ``service.py`` because the image
ships no grpc protoc plugin), ``convert.py`` (record ↔ proto, Avro schema
interning), ``service.py`` (the child's server), ``bridge.py`` (the
runtime-side agents and the process supervisor). Only this package and
``agents/python_agents.py`` import ``grpc`` and ``google.protobuf``.
"""
