"""The port's copy of the JAX package's ``scheduler/status.py``.

Operator status CLI: one readable screen of what the scheduler knows.

    python -m kubegpu_tpu_torch.scheduler.status --url http://localhost:12345

Renders the extender's /state (slice occupancy maps, in-flight gang plans)
and the headline /metrics counters — the `kubectl get`-style surface for
the device-scheduling layer (SURVEY.md §5.5's observability row, operator
side).  Read-only; works against any live extender.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def fetch(url: str, path: str, timeout: float):
    with urllib.request.urlopen(url + path, timeout=timeout) as resp:
        body = resp.read().decode()
    return json.loads(body) if path != "/metrics" else body


def render_slice(sid: str, s: dict) -> str:
    mesh = s["mesh"]
    used = {tuple(c) for c in s["used"]}
    free = {tuple(c) for c in s["free"]}
    dims = "x".join(str(d) for d in mesh)
    lines = [f"slice {sid}  mesh {dims}  "
             f"free {len(free)}  used {len(used)}  hosts {len(s['hosts'])}"]

    def cell(c):
        return "#" if c in used else "." if c in free else "x"

    if len(mesh) == 2:
        for y in range(mesh[1]):
            lines.append("  " + " ".join(cell((x, y)) for x in range(mesh[0])))
    elif len(mesh) == 3:
        # one 2D map per z-layer (v4/v5p 3D torus topologies)
        for z in range(mesh[2]):
            lines.append(f"  z={z}:")
            for y in range(mesh[1]):
                lines.append(
                    "    " + " ".join(cell((x, y, z)) for x in range(mesh[0]))
                )
    else:  # exotic rank: fall back to a coordinate listing
        lines.append(f"  used: {sorted(used)}")
        lines.append(f"  free: {sorted(free)}")
    lines.append("  (# used, . free, x unhealthy/absent)")
    return "\n".join(lines)


HEADLINE_METRICS = (
    "kubegpu_placements_total",
    "kubegpu_placements_contiguous_total",
    "kubegpu_chips_allocated_total",
    "kubegpu_preemptions_total",
    "kubegpu_preempted_pods_total",
    "kubegpu_health_evictions_total",
    "kubegpu_stranded_gang_rollbacks_total",
    "kubegpu_bind_conflicts_total",
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--url", default="http://127.0.0.1:12345")
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--json", action="store_true",
                    help="raw /state JSON instead of the rendered screen")
    args = ap.parse_args(argv)
    url = args.url.rstrip("/")

    try:
        state = fetch(url, "/state", args.timeout)
    except (OSError, ValueError) as e:
        # ValueError covers JSONDecodeError: a 200 from something that is
        # not an extender (proxy error page, wrong port) exits cleanly too
        print(f"cannot reach extender at {url}: {e}", file=sys.stderr)
        return 1

    if args.json:
        print(json.dumps(state, indent=2))
        return 0

    try:
        metrics_text = fetch(url, "/metrics", args.timeout)
    except (OSError, ValueError):
        metrics_text = ""  # render what we have; counters are optional

    print(f"extender {url}  nodes={len(state.get('nodes', []))}")
    for sid in sorted(state.get("slices", {})):
        print()
        print(render_slice(sid, state["slices"][sid]))

    plans = state.get("gang_plans", {})
    if plans:
        print("\nin-flight gang plans:")
        for gk in sorted(plans):
            p = plans[gk]
            print(f"  {gk}: {len(p['committed'])}/{len(p['members'])} "
                  f"committed, score {p['score']}")
    assumed = state.get("assumed", [])
    if assumed:
        print(f"\nassumed (reserved, bind pending): {', '.join(assumed)}")

    counters = {}
    for line in metrics_text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        if name in HEADLINE_METRICS:
            counters[name] = value
    if counters:
        print("\ncounters:")
        for name in HEADLINE_METRICS:
            if name in counters:
                print(f"  {name.removeprefix('kubegpu_'):38s} {counters[name]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
