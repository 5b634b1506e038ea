"""The port's copy of the JAX package's ``scheduler/__init__.py``.

L4 scheduling service (SURVEY.md §2 #4): cache, core verbs, gang
registry, HTTP extender server.
"""

from kubegpu_tpu_torch.scheduler.cache import ClusterCache
from kubegpu_tpu_torch.scheduler.core import FilterResult, Scheduler
from kubegpu_tpu_torch.scheduler.plugins import (
    DeviceSchedulerPlugin,
    GroupedResourceScheduler,
    PluginRegistry,
    TpuDeviceScheduler,
    default_registry,
)
from kubegpu_tpu_torch.scheduler.podgroup import GangPlan, PodGroupRegistry
from kubegpu_tpu_torch.scheduler.server import ExtenderServer, build_fake_cluster

__all__ = [
    "ClusterCache",
    "FilterResult",
    "Scheduler",
    "GangPlan",
    "PodGroupRegistry",
    "ExtenderServer",
    "build_fake_cluster",
    "DeviceSchedulerPlugin",
    "GroupedResourceScheduler",
    "PluginRegistry",
    "TpuDeviceScheduler",
    "default_registry",
]
