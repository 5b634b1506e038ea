"""chip_smoke.py's phase 71 rehearsed on the CPU: the sample's gateway
(``samples/jax-serve-gateway.yaml``) in front of the decode replica that
phase 70 binds again, on a fabricated one-card GPU host, at a tiny width.

The replica's process boots before phase 70's worker runs and serves
only once that worker has exited; the pod bound again runs the sample's
serving command under the shim's env; the port's gateway, wired as its
in-cluster mode wires it, answers ``/readyz`` 503 before the replica's
probe and 200 after, streams each prompt's tokens as the replica streams
them when sent straight to it, serves a burst with no retry, hedge or
429, its entry point's ``--replica-endpoint`` mode serves and drains,
and the pod's delete turns ``/readyz`` 503; the replica's
``KERNEL_LAUNCHES`` line (all 0 on the CPU, which launches no kernel)
is read at its graceful exit."""

import yaml

import chip_smoke
from kubegpu_tpu_torch.plugins.fake import FakeGpuHost

from test_samples import SAMPLES, load_pods

TINY = ["--model=decode", "--serving=paged", "--batch-per-chip=3",
        "--prompt-len=12", "--steps=4", "--vocab=61", "--layers=1",
        "--heads=2", "--hidden=16", "--seq=48", "--device=cpu",
        "--serve-fp32"]


def test_phase_71_serving_command_matches_the_sample():
    (sample,) = [p for p in load_pods("jax-serve-gateway.yaml")
                 if p["metadata"]["name"] == "decode-replica-0"]
    command = sample["spec"]["containers"][0]["command"]
    kept = [a for a in command[3:] if not a.startswith(
        ("--ckpt-dir=", "--steps="))]
    assert "--serve-http=8700" in kept
    assert [a for a in chip_smoke.SERVE_REPLICA_ARGV
            if not a.startswith("--steps=")] == [
        "--serve-http=0" if a == "--serve-http=8700" else a for a in kept]
    deployment = next(
        d for d in yaml.safe_load_all((SAMPLES / "jax-serve-gateway.yaml")
                                      .read_text())
        if d and d.get("kind") == "Deployment")
    flags = deployment["spec"]["template"]["spec"]["containers"][0][
        "command"][3:]
    assert "--queue-capacity=256" in flags and "--group=decode" in flags
    assert "--deadline=30" in flags and "--hedge-after=1.0" in flags
    assert "--dispatchers" not in " ".join(flags)   # the default, 8
    assert chip_smoke.GATEWAY_FLAGS == dict(
        queue_capacity=256, deadline_s=30.0, hedge_after_s=1.0,
        dispatchers=8)


def test_phase_71_rehearses_on_the_cpu(tmp_path):
    host = FakeGpuHost("cpu-rehearsal", cards=1)
    pod_argv = TINY[:]
    serve_argv = TINY + ["--serve-http=0"]
    cp = chip_smoke.control_plane_bind(host.provider(), pod_argv)
    gate, served = tmp_path / "built", tmp_path / "served"
    chip_smoke._EARLY["pod"] = chip_smoke.worker_popen(
        cp["argv"], cp["env"], str(gate))
    chip_smoke._EARLY["replica"] = chip_smoke.worker_popen(
        serve_argv, cp["env"], str(served))
    try:
        gate.touch()
        chip_smoke.phase_control_plane(cp, rebind_argv=serve_argv,
                                       serve_gate=str(served))
        r = chip_smoke.phase_gateway(
            cp, "cpu", argv=serve_argv,
            traffic=dict(singles=2, burst=6, at_once=3, new_tokens=8))
    finally:
        chip_smoke.stop_early()
    assert set(r["launches"].values()) == {0}
    assert {"K1", "K1q", "K2", "K2q"} <= set(r["launches"])
    assert r["figures"]["gateway_ttft_s"][1] == 6
    assert r["gone_s"] < 10.0
    assert "replica" not in chip_smoke._EARLY
