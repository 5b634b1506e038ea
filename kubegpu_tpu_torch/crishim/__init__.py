"""The node runtime shim of the port's device layer: the counterparts of
the JAX package's ``crishim/`` (the injection logic, the CRI proxy and
its daemon) over a ``GpuProvider``.  A scheduled container gets exactly
its cards through ``CUDA_VISIBLE_DEVICES``/``NVIDIA_VISIBLE_DEVICES``,
beside the ``JAX_*``/``TPU_WORKER_*``/``MEGASCALE_*`` rendezvous env
that the port's worker reads (``parallel/mesh.py``).  ``grpc`` is
imported only where the proxy starts."""
