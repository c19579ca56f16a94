"""The port's distribution layer for the LM substrate: ``ctx`` (the
activation-sharding context), ``pspec`` (a jax-free ``PartitionSpec``
and a mesh's axes) and ``steps`` (the sharding specs and the one-device
train / prefill / decode step builders).  The solver's distribution lives
in ``repro_torch.core.dist``."""
