"""The port's proto3 codec: ``corev1`` and ``extender`` hold one class per
message of ``corev1.proto`` and ``extender.proto`` (copied from the JAX
package as they are), written on :mod:`.wire`, so that nothing here
needs the ``protobuf`` runtime. Their bytes equal the runtime's
deterministic serialization of the same messages."""
