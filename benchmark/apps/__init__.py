"""Population builders, one per family of configuration, written against
the port's public API (``Store``, ``Graph``, ``ReplicatedRuntime`` and its
write verbs). Each makes its data from the seed and returns a
``harness.drivers.Population``."""
