"""The GPU device layer's node side: discovery of the host's cards
through NVML (``nvml.py``, ``discovery.py``), a fake for the CPU tests
(``fake.py``), the kubelet device plugin (``deviceplugin.py``) and the
advertiser (``advertiser.py``), over one provider interface
(``provider.py``): the counterparts of the JAX package's TPU
``plugins/``.  Nothing here imports ``grpc`` at import time: the two
gRPC servers (the device plugin here, the CRI proxy in ``crishim/``)
import it where they start."""
