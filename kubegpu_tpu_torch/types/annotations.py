"""Annotation keys + wire codecs: the port's copy of the JAX package's
``types/annotations.py``.  All of the system's state rides on k8s
objects: the advertiser writes a node's devices into its topology
annotation, the extender writes a pod's assignment at bind, the CRI
shim reads it at container create.  Keys and JSON are the system's own,
byte for byte, so the JAX package's extender places pods on what the
port advertises and the port injects what that extender binds."""

from __future__ import annotations

import json
from typing import Dict, Optional

from kubegpu_tpu_torch.types.info import Assignment, ContainerInfo, NodeInfo, PodInfo
from kubegpu_tpu_torch.types.resource import RES_TPU

PREFIX = "kubegpu-tpu"

# Node side (written by the advertiser).
NODE_TOPOLOGY = f"{PREFIX}/topology"            # JSON: the host's devices
NODE_ADVERT_SEQ = f"{PREFIX}/advertised-at"     # bumped every advertisement
# Pod side (written by users / controllers).
POD_GROUP = f"{PREFIX}/pod-group"               # gang name
POD_GROUP_SIZE = f"{PREFIX}/pod-group-size"     # gang cardinality
POD_GROUP_UID = f"{PREFIX}/pod-group-uid"       # gang incarnation id
POD_CONTIGUOUS = f"{PREFIX}/contiguous"         # "true"/"false", default true
POD_PRIORITY = f"{PREFIX}/priority"             # int, for preemption
POD_MULTISLICE = f"{PREFIX}/multislice"         # "true": may span slices
POD_SLICE_SELECTOR = f"{PREFIX}/slice-selector" # comma list of slice ids
# Pod side (written by the extender at bind, read by the CRI shim).
POD_ASSIGNMENT = f"{PREFIX}/assignment"         # JSON: Assignment


def encode_node_topology(node: NodeInfo) -> str:
    return json.dumps(
        {
            "slice_id": node.slice_id,
            "generation": node.generation,
            "mesh_shape": list(node.mesh_shape) if node.mesh_shape else None,
            "wrap": list(node.wrap) if node.wrap else None,
            "chips": [c.to_dict() for c in node.chips],
        },
        sort_keys=True,
    )


def encode_assignment(a: Assignment) -> str:
    return json.dumps(a.to_dict(), sort_keys=True)


def decode_assignment(payload: str) -> Assignment:
    return Assignment.from_dict(json.loads(payload))


def pod_from_k8s(obj: dict, strict: bool = True) -> PodInfo:
    """A PodInfo from a Kubernetes Pod object (dict form).  ``strict``
    governs malformed device quantities: strict raises, the lenient form
    (the shim's list paths) counts them as 0 so a bound pod stays
    visible."""
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
            chips = 0
        extended: Dict[str, int] = {}
        for source in (req, res):  # limits win over requests
            for key, val in source.items():
                if key == RES_TPU or "/" not in key:
                    continue
                try:
                    extended[key] = int(val)
                except (TypeError, ValueError):
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


def assignment_from_pod(obj_or_annotations) -> Optional[Assignment]:
    """The bind-time assignment of a pod object or of its annotation map;
    None if the pod was never device-scheduled.  A k8s Pod object has a
    dict under "metadata"; an annotation map's values are strings."""
    d = obj_or_annotations or {}
    if isinstance(d.get("metadata"), dict):
        ann = d["metadata"].get("annotations") or {}
    else:
        ann = d
    payload = ann.get(POD_ASSIGNMENT)
    return decode_assignment(payload) if payload else None
