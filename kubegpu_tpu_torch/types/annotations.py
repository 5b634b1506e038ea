"""Annotation keys + wire codecs: the port's copy of the JAX package's
``types/annotations.py``.  All of the system's state rides on k8s
objects: the advertiser writes a node's devices into its topology
annotation, the extender writes a pod's assignment at bind, the CRI
shim reads it at container create.  Keys and JSON are the system's own,
byte for byte, so either package's extender places pods on what the
other's advertiser wrote and either shim injects what either extender
binds."""

from __future__ import annotations

import json
from typing import Dict, Optional

from kubegpu_tpu_torch.types.info import Assignment, ContainerInfo, NodeInfo, PodInfo
from kubegpu_tpu_torch.types.resource import RES_TPU
from kubegpu_tpu_torch.types.topology import Chip, TpuGeneration

PREFIX = "kubegpu-tpu"

# Node side (written by the advertiser daemon, read by the scheduler cache).
NODE_TOPOLOGY = f"{PREFIX}/topology"            # JSON: slice fragment owned by host
# Advertisement generation marker, bumped on every advertise cycle.  The
# failure detector counts ABSENT-chip strikes per distinct advertisement —
# re-reading one stale truncated annotation must not accumulate strikes.
NODE_ADVERT_SEQ = f"{PREFIX}/advertised-at"
# Node side (written by a generic device daemon for non-TPU device types
# served by a DeviceSchedulerPlugin, SURVEY.md §2 #5): flat {path: qty}.
NODE_GROUPED_CAPACITY = f"{PREFIX}/grouped-capacity"
# Pod side (written by users / controllers).
POD_GROUP = f"{PREFIX}/pod-group"               # gang name
POD_GROUP_SIZE = f"{PREFIX}/pod-group-size"     # gang cardinality
POD_GROUP_UID = f"{PREFIX}/pod-group-uid"       # gang incarnation id (e.g.
                                                # the owning Job's UID).
                                                # Optional but recommended:
                                                # scopes completed-member
                                                # memory, so a NEW run
                                                # reusing a gang name starts
                                                # its arithmetic clean even
                                                # while the old run's
                                                # Succeeded pods linger
POD_CONTIGUOUS = f"{PREFIX}/contiguous"         # "true"/"false", default true
POD_PRIORITY = f"{PREFIX}/priority"             # int, for preemption
POD_MULTISLICE = f"{PREFIX}/multislice"         # "true" lets a gang span
                                                # DCN-connected slices when no
                                                # single slice fits it
POD_SLICE_SELECTOR = f"{PREFIX}/slice-selector" # comma list of slice ids the
                                                # pod/gang may be placed on
                                                # (tenant pinning); absent =
                                                # any slice
# Pod side (written by users / controllers, read by the serving gateway):
# marks a pod as a decode replica of the named serving group.  The gateway's
# ReplicaRegistry discovers replicas by this key and routes cluster traffic
# to them once their assignment annotation exists and their assigned chips
# are advertised healthy.
POD_SERVING_GROUP = f"{PREFIX}/serving-group"
# Pod side (written by users / the fleet controller's ratio actuator, read
# by the registry): the replica's serving ROLE in a disaggregated fleet —
# "prefill" | "decode" | "flex".  A prefill replica runs chunked prefill
# only and hands sequences off post-seal; a decode replica receives them;
# flex (the default when absent) serves both phases co-located.
POD_ROLE = f"{PREFIX}/role"
# Pod side (written by the fleet controller's checkpoint-and-requeue):
# stamped on a batch pod recreated PENDING after preemption evicted it.
# The value is JSON — {"preempted": true, ...checkpointer metadata...} —
# so the resumed job knows to restore from its checkpoint instead of
# starting cold.
POD_REQUEUE_CHECKPOINT = f"{PREFIX}/requeue-checkpoint"
# Pod side (written by ReplicaRegistry.set_draining): durable DRAINING
# mark — "true" while a drain is in progress.  Persisted on the pod so a
# RESTARTED controller/gateway process (fresh registry over the same API
# server) adopts an in-flight drain instead of silently re-admitting the
# half-drained replica.  A recreated pod starts without it (clean slate).
POD_DRAINING = f"{PREFIX}/draining"
# Pod side (written by the extender at bind, read by the CRI shim).
POD_ASSIGNMENT = f"{PREFIX}/assignment"         # JSON: Assignment
# Pod side (written by the extender for gang coordination/observability).
POD_GROUP_STATUS = f"{PREFIX}/pod-group-status"


# ---------------------------------------------------------------------------
# Node topology annotation
# ---------------------------------------------------------------------------

def encode_node_topology(node: NodeInfo) -> str:
    return json.dumps(
        {
            "slice_id": node.slice_id,
            "generation": node.generation.value if node.generation else None,
            "mesh_shape": list(node.mesh_shape) if node.mesh_shape else None,
            "wrap": list(node.wrap) if node.wrap else None,
            "chips": [c.to_dict() for c in node.chips],
        },
        sort_keys=True,
    )


def decode_node_topology(name: str, payload: str) -> NodeInfo:
    d = json.loads(payload)
    node = NodeInfo(
        name=name,
        slice_id=d.get("slice_id"),
        generation=TpuGeneration(d["generation"]) if d.get("generation") else None,
        mesh_shape=tuple(d["mesh_shape"]) if d.get("mesh_shape") else None,
        wrap=tuple(bool(x) for x in d["wrap"]) if d.get("wrap") else None,
        chips=[Chip.from_dict(c) for c in d.get("chips", [])],
    )
    node.rebuild_capacity()
    return node


# ---------------------------------------------------------------------------
# Generic grouped-capacity annotation (non-TPU device plugins)
# ---------------------------------------------------------------------------

def encode_grouped_capacity(tree) -> str:
    return json.dumps(tree.to_flat(), sort_keys=True)


def decode_grouped_capacity(payload: str):
    from kubegpu_tpu_torch.types.resource import ResourceTree

    flat = json.loads(payload)
    if not isinstance(flat, dict):
        raise ValueError(
            f"grouped-capacity must be a JSON object, got {type(flat).__name__}"
        )
    return ResourceTree.from_flat(flat)


# ---------------------------------------------------------------------------
# Pod assignment annotation
# ---------------------------------------------------------------------------

def encode_assignment(a: Assignment) -> str:
    return json.dumps(a.to_dict(), sort_keys=True)


def decode_assignment(payload: str) -> Assignment:
    return Assignment.from_dict(json.loads(payload))


# ---------------------------------------------------------------------------
# k8s object -> Info converters (used by extender handlers + CRI shim)
# ---------------------------------------------------------------------------

def pod_from_k8s(obj: dict, strict: bool = True) -> PodInfo:
    """Build a PodInfo from a Kubernetes Pod object (dict form, as received
    by the scheduler-extender HTTP endpoints).

    ``strict`` governs malformed device quantities: the scheduling verbs use
    strict=True so a pod with an unparseable request FAILS (it must never
    bypass device accounting), while LIST-path callers (gang member
    gathering, preemption victim collection) use strict=False so one
    malformed quantity cannot make an already-bound pod invisible — an
    invisible sibling wedges its whole gang's injection and hides its chips
    from preemption."""
    meta = obj.get("metadata", {}) or {}
    spec = obj.get("spec", {}) or {}
    ann: Dict[str, str] = dict(meta.get("annotations") or {})
    containers = []
    for c in spec.get("containers", []) or []:
        res = ((c.get("resources") or {}).get("limits") or {})
        req = ((c.get("resources") or {}).get("requests") or {})
        try:
            chips = int(res.get(RES_TPU, req.get(RES_TPU, 0)) or 0)
        except (TypeError, ValueError):
            if strict:
                raise
            chips = 0  # lenient list path: visibility over accounting
        # Other extended resources (domain/name-form) go to the plugin
        # registry (SURVEY.md §2 #5); cpu/memory/etc stay with the default
        # scheduler, exactly as TPU chips do.
        extended: Dict[str, int] = {}
        for source in (req, res):  # limits win over requests
            for key, val in source.items():
                if key == RES_TPU or "/" not in key:
                    continue
                try:
                    extended[key] = int(val)
                except (TypeError, ValueError):
                    # device counts are plain integers; in strict mode fail
                    # the pod exactly like a malformed google.com/tpu
                    # quantity does — dropping the request would let the pod
                    # bypass plugin device accounting and over-commit
                    if strict:
                        raise ValueError(
                            f"pod {meta.get('namespace', 'default')}/"
                            f"{meta.get('name', '')}: unparseable extended "
                            f"resource {key}={val!r} (device counts are "
                            f"plain integers)"
                        )
        containers.append(
            ContainerInfo(name=c.get("name", ""), tpu_chips=chips, extended=extended)
        )
    pod = PodInfo(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", ""),
        containers=containers,
        annotations=ann,
        labels=dict(meta.get("labels") or {}),
        node_name=spec.get("nodeName"),
        subdomain=spec.get("subdomain"),
        phase=str((obj.get("status") or {}).get("phase") or ""),
        deletion_timestamp=meta.get("deletionTimestamp"),
    )
    pod.pod_group = ann.get(POD_GROUP)
    pod.pod_group_uid = ann.get(POD_GROUP_UID, "")
    try:
        pod.pod_group_size = int(ann.get(POD_GROUP_SIZE, "1"))
    except ValueError:
        pod.pod_group_size = 1
    pod.require_contiguous = ann.get(POD_CONTIGUOUS, "true").lower() != "false"
    pod.allow_multislice = ann.get(POD_MULTISLICE, "false").lower() == "true"
    selector = ann.get(POD_SLICE_SELECTOR, "").strip()
    if selector:
        pod.slice_selector = frozenset(
            s.strip() for s in selector.split(",") if s.strip()
        )
    try:
        pod.priority = int(ann.get(POD_PRIORITY, str(spec.get("priority", 0) or 0)))
    except ValueError:
        pod.priority = 0
    return pod


def node_from_k8s(obj: dict) -> NodeInfo:
    meta = obj.get("metadata", {}) or {}
    ann = dict(meta.get("annotations") or {})
    name = meta.get("name", "")
    if NODE_TOPOLOGY in ann:
        node = decode_node_topology(name, ann[NODE_TOPOLOGY])
    else:
        node = NodeInfo(name=name)
    if NODE_GROUPED_CAPACITY in ann:
        # fold generic device capacity in on top of the chip-derived tree;
        # a malformed generic annotation must not take down the node's TPU
        # topology (the fold is isolated, the chip tree survives)
        try:
            node.capacity.add_tree(decode_grouped_capacity(ann[NODE_GROUPED_CAPACITY]))
        except (ValueError, TypeError, KeyError, AttributeError, json.JSONDecodeError):
            import logging

            logging.getLogger(__name__).warning(
                "ignoring malformed %s on node %s", NODE_GROUPED_CAPACITY, name
            )
    return node


def assignment_from_pod(obj_or_annotations) -> Optional[Assignment]:
    """Extract the bind-time assignment from a pod object or its annotation
    map; None if the pod was never device-scheduled.

    Disambiguation: a k8s Pod object has a dict under "metadata"; an
    annotation map's values are all strings (a legal annotation may be
    *named* "metadata", so key presence alone is not enough)."""
    d = obj_or_annotations or {}
    if isinstance(d.get("metadata"), dict):
        ann = d["metadata"].get("annotations") or {}
    else:
        ann = d
    payload = ann.get(POD_ASSIGNMENT)
    return decode_assignment(payload) if payload else None
