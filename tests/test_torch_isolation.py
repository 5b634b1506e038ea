"""The port stands alone: no module of kubegpu_tpu_torch, not
chip_smoke.py and not the rank bodies of the gangs
(tests/torch_tp_cases.py, tests/torch_resnet_cases.py,
tests/torch_moe_cases.py, tests/torch_pp_cases.py,
tests/torch_cp_cases.py, tests/torch_3d_cases.py,
tests/torch_zero_cases.py, and the pods of tests/torch_gang_cases.py,
whose processes must run without JAX) imports
jax, flax, orbax or the JAX package, nor the Orbax converter
(tools/orbax_to_torch_checkpoint.py); its entry points run on the card
unless the caller asks for the CPU.  The GPU device layer imports grpc
only where its two servers (the device plugin, the CRI proxy) start, and
runs on request bytes without it."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kubegpu_tpu_torch")
TP_CASES = os.path.join(REPO, "tests", "torch_tp_cases.py")
RESNET_CASES = os.path.join(REPO, "tests", "torch_resnet_cases.py")
MOE_CASES = os.path.join(REPO, "tests", "torch_moe_cases.py")
PP_CASES = os.path.join(REPO, "tests", "torch_pp_cases.py")
GANG_CASES = os.path.join(REPO, "tests", "torch_gang_cases.py")
CP_CASES = os.path.join(REPO, "tests", "torch_cp_cases.py")
CASES_3D = os.path.join(REPO, "tests", "torch_3d_cases.py")
ZERO_CASES = os.path.join(REPO, "tests", "torch_zero_cases.py")
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "orbax", "kubegpu_tpu",
                   "orbax_to_torch_checkpoint", "tools")


def port_sources():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield TP_CASES
    yield RESNET_CASES
    yield MOE_CASES
    yield PP_CASES
    yield GANG_CASES
    yield CP_CASES
    yield CASES_3D
    yield ZERO_CASES


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kubegpu_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'kubegpu_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "import torch_tp_cases\n"
        "import torch_resnet_cases\n"
        "import torch_moe_cases\n"
        "import torch_pp_cases\n"
        "import torch_gang_cases\n"
        "import torch_cp_cases\n"
        "import torch_3d_cases\n"
        "import torch_zero_cases\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN_ROOTS!r})\n"
        "print(len(names), bad)\n"
        "print(' '.join(names))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.dirname(TP_CASES)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    first, imported = proc.stdout.splitlines()[:2]
    n_modules = int(first.split()[0])
    assert n_modules >= 25
    # the HTTP replica slice's own copies of the JAX package's
    # stdlib-only modules, the sampling slice's counter-based PRNG, the
    # dense serving slice's batchers, the tensor-parallel slice's
    # modules, the data x tensor-parallel training they carry, the
    # ResNet, the MoE transformer, the pipeline and ZeRO-1
    for name in ("models.resnet", "models.moe", "models.pipeline_lm",
                 "parallel.pipeline", "parallel.zero", "gateway", "gateway.client",
                 "gateway.dataplane", "utils", "utils.metrics",
                 "utils.tracing", "utils.metric_names", "ops.prng", "models.serving", "models.spec_serving",
                 "parallel.mesh", "parallel.sharding",
                 "parallel.collectives", "parallel.launch",
                 "parallel.replay", "models.train", "models.transformer",
                 "models.data", "models.checkpoint",
                 # the GPU device layer
                 "types", "types.topology", "types.resource", "types.info",
                 "types.annotations", "utils.protowire", "utils.apiserver",
                 "grpalloc", "grpalloc.scoring", "plugins",
                 "plugins.provider", "plugins.nvml", "plugins.discovery",
                 "plugins.fake", "plugins.deviceplugin",
                 "plugins.advertiser", "crishim", "crishim.inject",
                 "crishim.proxy", "crishim.daemon",
                 # the control plane's scheduling half
                 "utils.events", "utils.leaderelection", "grpalloc.view",
                 "grpalloc.treefit", "grpalloc.allocator",
                 "grpalloc.multislice", "scheduler", "scheduler.cache",
                 "scheduler.plugins", "scheduler.preemption",
                 "scheduler.podgroup", "scheduler.core", "scheduler.server",
                 "scheduler.status"):
        assert f"kubegpu_tpu_torch.{name}" in imported.split(), name


def test_no_source_imports_jax_or_the_jax_package():
    for path in port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN_ROOTS, (
                    f"{path} imports {name}"
                )


# where the device layer's two gRPC servers may import grpc: where they
# start, and their handlers
GRPC_START_PATHS = {
    "plugins/deviceplugin.py": {"start", "register_with_kubelet",
                                "plugin_handler"},
    "crishim/proxy.py": {"__init__", "passthrough_handler"},
}


def test_grpc_is_imported_only_where_the_servers_start():
    """No module of the port imports grpc at import time; the device
    plugin and the CRI proxy import it in the functions that start them
    (and build their handlers), nowhere else."""
    found = {}
    for path in port_sources():
        tree = ast.parse(open(path).read(), path)
        rel = os.path.relpath(path, PKG)

        def visit(node, func):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit(child, child.name)
                    continue
                if isinstance(child, (ast.Import, ast.ImportFrom)):
                    names = ([a.name for a in child.names]
                             if isinstance(child, ast.Import)
                             else [child.module or ""])
                    if any(n.split(".")[0] == "grpc" for n in names):
                        assert func is not None, f"{rel} imports grpc at import time"
                        found.setdefault(rel, set()).add(func)
                visit(child, func)

        visit(tree, None)
    assert found == GRPC_START_PATHS


def test_the_device_layer_runs_without_grpc():
    """With grpc unimportable, every module of the device layer imports and
    turns request bytes into response bytes: the device plugin's
    inventory, Allocate and GetPreferredAllocation, the shim's decision and
    its CreateContainer surgery; only starting a server needs grpc."""
    code = """
import sys
sys.modules["grpc"] = None
import importlib, pkgutil
import kubegpu_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, "kubegpu_tpu_torch."):
    if m.name.split(".")[1] in ("types", "utils", "grpalloc", "plugins",
                                "crishim"):
        importlib.import_module(m.name)
from kubegpu_tpu_torch.crishim.daemon import ShimDaemon
from kubegpu_tpu_torch.crishim.proxy import CriProxy, mutate_create_request
from kubegpu_tpu_torch.plugins.deviceplugin import DevicePluginServer
from kubegpu_tpu_torch.plugins.fake import FakeGpuHost
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.info import Assignment, ChipRef
from kubegpu_tpu_torch.utils import protowire as pw
from kubegpu_tpu_torch.utils.apiserver import InMemoryApiServer

host = FakeGpuHost("n0", cards=4)
plugin = DevicePluginServer(host.provider())
assert plugin._inventory() == {str(i): True for i in range(4)}
req = pw.encode_len_field(1, pw.encode_string_field(1, "2"))
resp = plugin.allocate(req, None)
env = pw.decode_string_map(pw.get_all(bytes(pw.get_all(resp, 1)[0]), 1))
assert env["CUDA_VISIBLE_DEVICES"] == host.uuids[2], env
pref = pw.encode_len_field(1, b"".join(pw.encode_string_field(1, d)
                                       for d in "0123")
                           + pw.encode_varint(3 << 3) + pw.encode_varint(2))
assert len(pw.get_all(bytes(pw.get_all(plugin.preferred_allocation(pref, None), 1)[0]), 1)) == 2
api = InMemoryApiServer()
a = Assignment("n0", "n0", {"main": [ChipRef("n0", 1, 1, (1,))]})
api.create_pod({"metadata": {"name": "p", "namespace": "default",
                             "annotations": {annotations.POD_ASSIGNMENT:
                                             annotations.encode_assignment(a)}},
                "spec": {"containers": [{"name": "main"}]}})
inj = ShimDaemon(api, host.provider()).decide("default", "p", "main", {}, "n0")
assert inj.env["CUDA_VISIBLE_DEVICES"] == host.uuids[1], inj.env
assert mutate_create_request(pw.encode_len_field(2, b""), inj) != b""
for start in (plugin.start, plugin.register_with_kubelet,
              lambda: CriProxy("127.0.0.1:1", lambda *a: None)):
    try:
        start()
    except ImportError:
        continue
    raise AssertionError("a server started without grpc")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)


def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch):
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.decoding import greedy_generate
    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.params import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(vocab_size=16, num_layers=1, num_heads=2, hidden=16,
               max_seq=16)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedContinuousBatcher(params, **cfg, prompt_pad=8, page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greedy_generate(params, np.zeros((1, 2), np.int32), 2, **cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.run_decode(worker.build_parser().parse_args(
            ["--model", "decode"]))


def test_chip_smoke_exits_nonzero_without_a_card():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_speculative_entry_points_default_to_the_card(monkeypatch):
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.params import init_params
    from kubegpu_tpu_torch.models.speculative import speculative_generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(vocab_size=16, num_layers=1, num_heads=2, hidden=16,
               max_seq=16)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        speculative_generate(params, params, np.zeros((1, 2), np.int32), 2,
                             k=2, draft_num_layers=1, draft_num_heads=2,
                             draft_hidden=16, **cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.run_decode(worker.build_parser().parse_args(
            ["--model", "decode", "--serving", "paged", "--speculate"]))


def test_training_entry_points_default_to_the_card(monkeypatch):
    """``--model lm`` and the training state run on the card unless
    asked for the CPU, and flash attention on a tensor off the CPU
    launches its kernels or raises — never the plain twin."""
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.train import (
        place_lm,
        train_state_from_numpy,
    )
    from kubegpu_tpu_torch.models.transformer import TransformerLM
    from kubegpu_tpu_torch.parallel.mesh import Mesh
    from kubegpu_tpu_torch.ops.attention import (
        flash_attention,
        flash_backward_dkdv,
        flash_backward_dq,
        flash_forward,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--model", "lm"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.run_lm(worker.build_parser().parse_args(["--model", "lm"]))
    cfg = dict(vocab_size=16, num_layers=1, num_heads=2, hidden=16,
               max_seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_from_numpy(TransformerLM(**cfg), {})
    # the data x tensor-parallel path: the mesh is the cards' unless the
    # CPU is asked for, and a mesh on a card places nothing without one
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--model", "lm", "--tp", "2"])
    mesh = Mesh(size=4, rank=0, device=torch.device("cuda"), backend="nccl",
                axis_names=("data", "model"), axis_sizes=(2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place_lm(TransformerLM(mesh=mesh, **cfg), {})
    q = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(q, q, q, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_forward(q, q, q, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_backward_dkdv(q, q, q, q, q, q, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_backward_dq(q, q, q, q, q, q, True)


def test_3d_and_zero1_placement_default_to_the_card(monkeypatch):
    """The 3-D mesh's model and ZeRO-1's placement put nothing on a
    card that is not there: they raise, never fall back to the CPU."""
    from kubegpu_tpu_torch.models.train import place_lm
    from kubegpu_tpu_torch.models.transformer import TransformerLM
    from kubegpu_tpu_torch.parallel.mesh import Mesh
    from kubegpu_tpu_torch.parallel.zero import place_zero1_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(vocab_size=16, num_layers=1, num_heads=2, hidden=16,
               max_seq=16)
    mesh = Mesh(size=8, rank=0, device=torch.device("cuda"), backend="gloo",
                axis_names=("data", "model", "seq"), axis_sizes=(2, 2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place_lm(TransformerLM(mesh=mesh, context_parallel=True,
                               attn_impl="ring", **cfg), {})
    mesh = Mesh(size=2, rank=0, device=torch.device("cuda"), backend="gloo",
                axis_names=("data",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place_zero1_lm(TransformerLM(mesh=mesh, **cfg), {})


def test_resnet_entry_points_default_to_the_card(monkeypatch):
    """The worker's default model, ResNet-50, and the ResNet's fresh
    weights run on the card unless asked for the CPU: without one they
    raise, never fall back."""
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.params import init_resnet_params
    from kubegpu_tpu_torch.models.resnet import ResNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert worker.build_parser().parse_args([]).model == "resnet50"
    for argv in ([], ["--model", "resnet-tiny"],
                 ["--model", "resnet50-unrolled", "--steps", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            worker.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.run_resnet(worker.build_parser().parse_args(
            ["--model", "resnet-tiny"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_resnet_params(ResNet(stage_sizes=(1,), num_filters=4),
                           torch.Generator())


def test_moe_entry_points_default_to_the_card(monkeypatch):
    """``--model moe`` and the MoE weights run on the card unless asked
    for the CPU: without one they raise, never fall back; the worker
    lists the model."""
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.moe import MoeTransformerLM
    from kubegpu_tpu_torch.models.params import init_moe_params
    from kubegpu_tpu_torch.models.train import place_moe
    from kubegpu_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert "moe" in worker.build_parser()._option_string_actions[
        "--model"].choices
    for argv in (["--model", "moe"], ["--model", "moe", "--ep", "2"],
                 ["--model", "moe", "--tp", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            worker.main(argv)
    cfg = dict(vocab_size=16, num_layers=1, hidden=16, max_seq=16,
               num_experts=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_moe_params(cfg, torch.Generator())
    mesh = Mesh(size=4, rank=0, device=torch.device("cuda"), backend="nccl",
                axis_names=("data", "expert"), axis_sizes=(2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place_moe(MoeTransformerLM(num_heads=2, mesh=mesh, **cfg), {})


def test_checkpoint_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """A checkpoint restores onto the card unless the CPU is asked for:
    the serving restore, the draft's and the worker's ``--ckpt-dir``
    raise without one, even where the checkpoint exists."""
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_params,
        save_checkpoint,
    )
    from kubegpu_tpu_torch.models.params import init_params
    from kubegpu_tpu_torch.models.serving import load_draft_checkpoint
    from kubegpu_tpu_torch.models.train import create_train_state
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    cfg = dict(vocab_size=16, num_layers=1, hidden=16, max_seq=16)
    state = create_train_state(
        TransformerLM(num_heads=2, **cfg),
        init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu"))
    mgr = make_manager(str(tmp_path / "lm"))
    save_checkpoint(mgr, state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_params(mgr, dict(cfg, num_heads=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_draft_checkpoint(str(tmp_path), num_heads=2, **cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--model", "decode", "--vocab", "16", "--layers", "1",
                     "--heads", "2", "--hidden", "16", "--seq", "15",
                     "--prompt-len", "4", "--steps", "2",
                     "--ckpt-dir", str(tmp_path)])


def test_the_orbax_converter_stands_outside_the_port():
    """tools/orbax_to_torch_checkpoint.py reads Orbax (JAX) and writes
    the port's format: it imports the port, never the other way round."""
    converter = os.path.join(REPO, "tools", "orbax_to_torch_checkpoint.py")
    assert os.path.exists(converter)
    for path in port_sources():
        assert "orbax_to_torch_checkpoint import" not in open(path).read()
    tree = ast.parse(open(converter).read(), converter)
    imported = {a.name if isinstance(node, ast.Import) else node.module
                for node in ast.walk(tree)
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for a in getattr(node, "names", [])}
    assert "orbax.checkpoint" in imported
    assert "kubegpu_tpu_torch.models.checkpoint" in imported


def test_serve_http_without_a_card_raises_before_binding(monkeypatch):
    """``--serve-http`` checks the device (and builds the batcher) before
    any socket is bound: without a card it raises and listens nowhere."""
    import socket

    from kubegpu_tpu_torch.models import worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bound = []
    real_bind = socket.socket.bind

    def bind(self, addr):
        bound.append(addr)
        return real_bind(self, addr)

    monkeypatch.setattr(socket.socket, "bind", bind)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--model", "decode", "--serving", "paged",
                     "--serve-http", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--model", "decode", "--serving", "paged",
                     "--serve-http", "0", "--speculate"])
    assert bound == []


def test_dense_batchers_default_to_the_card(monkeypatch):
    """The dense serving slice's entry points run on the card unless asked
    for the CPU: both batchers, ``generate(quant=True)`` and the worker's
    ``static``, ``continuous`` and ``speculative`` modes raise without
    one."""
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.decoding import (
        generate,
        quantize_params_int8,
    )
    from kubegpu_tpu_torch.models.params import init_params
    from kubegpu_tpu_torch.models.serving import ContinuousBatcher
    from kubegpu_tpu_torch.models.spec_serving import (
        SpeculativeContinuousBatcher,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(vocab_size=16, num_layers=1, num_heads=2, hidden=16,
               max_seq=16)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(params, **cfg, prompt_pad=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeculativeContinuousBatcher(params, params, **cfg, prompt_pad=8,
                                     draft_num_layers=1, draft_num_heads=2,
                                     draft_hidden=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(quantize_params_int8(params), np.zeros((1, 2), np.int32),
                 2, quant=True, **cfg)
    for serving in ("static", "continuous", "speculative"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            worker.run_decode(worker.build_parser().parse_args(
                ["--model", "decode", "--serving", serving]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--model", "decode", "--serving", "continuous",
                     "--serve-http", "0"])
