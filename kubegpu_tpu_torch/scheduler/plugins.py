"""The port's copy of the JAX package's ``scheduler/plugins.py``.

DeviceScheduler plugins: pluggable device types for the extender.

Capability parity with the reference's scheduler-side plugin architecture
(SURVEY.md §2 #5, §3.5): the extender loads DeviceScheduler plugins, each of
which translates a pod's container requests for ONE device type into an
allocator query and delegates fit/score to the allocation core.  The
reference loaded Go ``plugin`` .so files resolved through a
``CreateDeviceSchedulerPlugin`` entry symbol; the Python-native analog is
:func:`PluginRegistry.load` — an importlib module path resolved through a
``create_device_scheduler_plugin()`` factory.

Two built-ins:

- :class:`TpuDeviceScheduler` — the TPU path (the analog of the reference's
  GPU scheduler plugin): scalar ``google.com/tpu`` requests, ICI-mesh
  fit/score via ``grpalloc.pod_fits_group_constraints``.
- :class:`GroupedResourceScheduler` — arbitrary extended resources (e.g. a
  vendor accelerator advertised as a grouped tree): scalar requests expand
  to wildcard tree requests (``grpalloc.treefit``, SURVEY.md §2 #3) and fit
  against the node's allocatable tree; bindings ride the same Assignment
  annotation / cache bookkeeping as chips.

A pod may request ONE device type: the scheduler rejects pods whose
containers mix device types (``Scheduler._owning_plugin``), because a single
Assignment annotation can only commit one plugin's allocation atomically.
``PluginRegistry.plugin_for`` resolves a single-type pod to its owning
plugin by registration order (TPU first).
"""

from __future__ import annotations

import importlib
import logging
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from kubegpu_tpu_torch.grpalloc import pod_fits_group_constraints
from kubegpu_tpu_torch.grpalloc.allocator import FitResult
from kubegpu_tpu_torch.grpalloc.treefit import expand_scalar_request, fit_request_tree
from kubegpu_tpu_torch.grpalloc.view import SliceView
from kubegpu_tpu_torch.types.info import Assignment, NodeInfo, PodInfo, TpuRequest
from kubegpu_tpu_torch.types.resource import ResourcePath, ResourceTree

log = logging.getLogger(__name__)

ENTRY_SYMBOL = "create_device_scheduler_plugin"


class DeviceSchedulerPlugin(ABC):
    """One device type's scheduling logic (SURVEY.md §2 #5)."""

    name: str = "device"

    @abstractmethod
    def owns(self, pod: PodInfo) -> bool:
        """Does this pod request this plugin's device type?"""

    @abstractmethod
    def fit(
        self, node: NodeInfo, pod: PodInfo, view: Optional[SliceView]
    ) -> FitResult:
        """Feasibility + concrete assignment + score on one node."""


class TpuDeviceScheduler(DeviceSchedulerPlugin):
    """The built-in TPU plugin: delegates to the ICI-mesh allocation core."""

    name = "tpu"

    def __init__(self) -> None:
        # one-slot request memo: a filter/prioritize sweep calls fit() once
        # per candidate node for the SAME pod object; don't rebuild the
        # request N times (identity check, strong ref — no aliasing risk)
        self._last: Optional[tuple] = None

    def owns(self, pod: PodInfo) -> bool:
        return pod.total_tpu_chips() > 0

    def _request(self, pod: PodInfo) -> TpuRequest:
        if self._last is not None and self._last[0] is pod:
            return self._last[1]
        req = TpuRequest.from_pod(pod)
        self._last = (pod, req)
        return req

    def fit(
        self, node: NodeInfo, pod: PodInfo, view: Optional[SliceView]
    ) -> FitResult:
        return pod_fits_group_constraints(node, self._request(pod), view)


class GroupedResourceScheduler(DeviceSchedulerPlugin):
    """Generic grouped-resource device type.

    ``resource_name`` is the extended-resource key in container limits
    (e.g. ``example.com/npu``); ``template`` is the wildcard path a scalar
    request expands into (e.g. ``npugrp/*/npu/*/dev`` — SURVEY.md §2 #3).
    Capacity comes from the node's grouped-capacity annotation
    (``annotations.NODE_GROUPED_CAPACITY``), written by the device's own
    advertiser daemon.
    """

    def __init__(self, name: str, resource_name: str, template: str) -> None:
        self.name = name
        self.resource_name = resource_name
        self.template = template

    def owns(self, pod: PodInfo) -> bool:
        return any(c.extended.get(self.resource_name, 0) > 0 for c in pod.containers)

    def fit(
        self, node: NodeInfo, pod: PodInfo, view: Optional[SliceView]
    ) -> FitResult:
        allocatable = node.allocatable()
        leaf = self.template.rsplit("/", 1)[-1]
        free_before = allocatable.total(leaf)
        grouped: Dict[str, List] = {}
        want_total = 0
        for c in pod.containers:
            want = c.extended.get(self.resource_name, 0)
            if want <= 0:
                continue
            want_total += want
            request = expand_scalar_request(self.resource_name, want, self.template)
            r = fit_request_tree(request, allocatable)
            if not r.fits:
                return FitResult(
                    fits=False,
                    reason=f"{self.resource_name} on {node.name}: {r.reason}",
                    capacity_failure=True,
                )
            bindings: List = []
            for pairs in r.bindings.values():
                bindings.extend((path, qty) for path, qty in pairs)
            grouped[c.name] = bindings
            # later containers must not re-bind the same units
            for path_s, qty in bindings:
                single = ResourceTree()
                single.add(ResourcePath.parse(path_s), qty)
                allocatable.add_tree(single, sign=-1)
        if want_total == 0:
            return FitResult(fits=True, reason="no device request", score=0.0)
        # bin-packing score: prefer the node whose matching capacity is
        # tightest after placement (the multi-tenant packing stance the
        # TPU scorer takes, applied to flat quantities)
        free_after = free_before - want_total
        score = 100.0 / (1.0 + max(0, free_after))
        return FitResult(
            fits=True,
            score=score,
            assignment=Assignment(
                node=node.name, slice_id=None, grouped=grouped, score=score
            ),
        )


class PluginRegistry:
    """Ordered plugin set; first ``owns()`` match wins (§3.5 plugin load)."""

    def __init__(self) -> None:
        self._plugins: List[DeviceSchedulerPlugin] = []

    def register(self, plugin: DeviceSchedulerPlugin) -> None:
        if any(p.name == plugin.name for p in self._plugins):
            raise ValueError(f"plugin {plugin.name!r} already registered")
        self._plugins.append(plugin)
        log.info("registered device-scheduler plugin %s", plugin.name)

    def plugin_for(self, pod: PodInfo) -> Optional[DeviceSchedulerPlugin]:
        for p in self._plugins:
            if p.owns(pod):
                return p
        return None

    def plugins_for(self, pod: PodInfo) -> List[DeviceSchedulerPlugin]:
        """Every plugin claiming this pod.  More than one means the pod mixes
        device types — the scheduler must REJECT it rather than silently fit
        only the first type (which would over-commit the others)."""
        return [p for p in self._plugins if p.owns(pod)]

    def names(self) -> List[str]:
        return [p.name for p in self._plugins]

    def load(self, spec: str) -> DeviceSchedulerPlugin:
        """Dynamic loading, the Go-plugin .so analog (SURVEY.md §2 #5):
        ``spec`` is ``module`` or ``module:factory``; the factory (default
        ``create_device_scheduler_plugin``) returns the plugin instance."""
        module_name, _, symbol = spec.partition(":")
        mod = importlib.import_module(module_name)
        factory = getattr(mod, symbol or ENTRY_SYMBOL)
        plugin = factory()
        if not isinstance(plugin, DeviceSchedulerPlugin):
            raise TypeError(
                f"{spec}: factory returned {type(plugin).__name__}, "
                "not a DeviceSchedulerPlugin"
            )
        self.register(plugin)
        return plugin


def default_registry() -> PluginRegistry:
    reg = PluginRegistry()
    reg.register(TpuDeviceScheduler())
    return reg
