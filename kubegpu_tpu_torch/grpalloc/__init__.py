"""Placement scoring: the port's copy of the part of the JAX package's
``grpalloc/`` that the device plugin's ``GetPreferredAllocation`` uses.
The allocator itself stays in the JAX package's extender."""
