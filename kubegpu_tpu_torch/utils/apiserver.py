"""API-server client: the port's copy of the part of the JAX package's
``utils/apiserver.py`` that the advertiser and the CRI shim call.

Node and pod annotations are the system's durable state, so every node
daemon is stateless.  ``ApiServer`` is the interface (four verbs),
``InMemoryApiServer`` its fake for the tests (with the verbs a test needs
to set up and read back), ``KubeApiServer`` the in-cluster REST client
(service-account token + CA bundle, JSON merge-patches)."""

from __future__ import annotations

import copy
import json
import os
import ssl
import threading
import urllib.error
import urllib.request
from typing import Dict, List, Optional


class NotFound(Exception):
    pass


class Conflict(Exception):
    pass


class ApiServer:
    """What the advertiser (node patches) and the CRI shim (pod reads)
    call; see InMemoryApiServer for the semantics."""

    def patch_node_annotations(self, name: str, ann: Dict[str, str]) -> None:
        raise NotImplementedError

    def patch_node_capacity(self, name: str, capacity: Dict[str, str]) -> None:
        raise NotImplementedError

    def list_pods(self, namespace: Optional[str] = None) -> List[dict]:
        raise NotImplementedError

    def get_pod(self, namespace: str, name: str) -> dict:
        raise NotImplementedError


class InMemoryApiServer(ApiServer):
    """Thread-safe fake: annotation and capacity patches merge, reads
    return copies."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._nodes: Dict[str, dict] = {}
        self._pods: Dict[str, dict] = {}

    @staticmethod
    def _key(namespace: str, name: str) -> str:
        return f"{namespace}/{name}"

    def list_nodes(self) -> List[dict]:
        with self._lock:
            return [copy.deepcopy(n) for n in self._nodes.values()]

    def get_node(self, name: str) -> dict:
        with self._lock:
            if name not in self._nodes:
                raise NotFound(f"node {name}")
            return copy.deepcopy(self._nodes[name])

    def patch_node_annotations(self, name: str, ann: Dict[str, str]) -> None:
        with self._lock:
            node = self._nodes.setdefault(name, {"metadata": {"name": name}})
            node.setdefault("metadata", {}).setdefault("annotations", {}).update(ann)

    def patch_node_capacity(self, name: str, capacity: Dict[str, str]) -> None:
        with self._lock:
            node = self._nodes.setdefault(name, {"metadata": {"name": name}})
            status = node.setdefault("status", {})
            status.setdefault("capacity", {}).update(capacity)
            status.setdefault("allocatable", {}).update(capacity)

    def list_pods(self, namespace: Optional[str] = None) -> List[dict]:
        with self._lock:
            return [
                copy.deepcopy(p)
                for p in self._pods.values()
                if namespace is None or p["metadata"].get("namespace", "default") == namespace
            ]

    def get_pod(self, namespace: str, name: str) -> dict:
        with self._lock:
            k = self._key(namespace, name)
            if k not in self._pods:
                raise NotFound(f"pod {k}")
            return copy.deepcopy(self._pods[k])

    def create_pod(self, obj: dict) -> dict:
        with self._lock:
            meta = obj.setdefault("metadata", {})
            meta.setdefault("namespace", "default")
            k = self._key(meta["namespace"], meta["name"])
            if k in self._pods:
                raise Conflict(f"pod {k} exists")
            self._pods[k] = copy.deepcopy(obj)
            return copy.deepcopy(self._pods[k])


class KubeApiServer(ApiServer):
    """Thin in-cluster REST client (service-account token + CA bundle)."""

    TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"
    CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

    def __init__(self, base_url: Optional[str] = None) -> None:
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base = base_url or f"https://{host}:{port}"
        self._ctx = ssl.create_default_context(
            cafile=self.CA if os.path.exists(self.CA) else None
        )

    def _token(self) -> str:
        try:
            with open(self.TOKEN) as f:
                return f.read().strip()
        except OSError:
            return ""

    def _req(self, method: str, path: str, body: Optional[dict] = None,
             content_type: str = "application/json") -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base + path, data=data, method=method)
        req.add_header("Authorization", f"Bearer {self._token()}")
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        try:
            with urllib.request.urlopen(req, context=self._ctx, timeout=30) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise NotFound(path)
            if e.code == 409:
                raise Conflict(path)
            raise

    def patch_node_annotations(self, name: str, ann: Dict[str, str]) -> None:
        self._req(
            "PATCH",
            f"/api/v1/nodes/{name}",
            {"metadata": {"annotations": ann}},
            content_type="application/merge-patch+json",
        )

    def patch_node_capacity(self, name: str, capacity: Dict[str, str]) -> None:
        self._req(
            "PATCH",
            f"/api/v1/nodes/{name}/status",
            {"status": {"capacity": capacity, "allocatable": capacity}},
            content_type="application/merge-patch+json",
        )

    def list_pods(self, namespace: Optional[str] = None) -> List[dict]:
        path = f"/api/v1/namespaces/{namespace}/pods" if namespace else "/api/v1/pods"
        return self._req("GET", path).get("items", [])

    def get_pod(self, namespace: str, name: str) -> dict:
        return self._req("GET", f"/api/v1/namespaces/{namespace}/pods/{name}")
