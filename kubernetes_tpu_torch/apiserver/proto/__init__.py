"""The gRPC wire's protobuf schema (`ktpu.proto`) and its `protoc
--python_out` module (`ktpu_pb2.py`, a verbatim copy of the JAX package's).

Import it package-qualified, `kubernetes_tpu_torch.apiserver.proto.ktpu_pb2`:
the JAX package loads its copy as the top-level module `ktpu_pb2` from its
own proto directory, so a bare `import ktpu_pb2` could return the other
package's module. Both copies register the same `ktpu.proto` file in
protobuf's default descriptor pool, so their message classes coincide.
"""
