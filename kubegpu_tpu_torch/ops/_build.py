"""Build the port's CUDA kernels from the sources in ``ops/csrc`` at first
use, and load them with ``ctypes``.

Each source is a shared library with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kubegpu_tpu_torch/`` at the
root of the checkout.  A library's file name carries a hash of its
source and flags, so an edited kernel is rebuilt and a fresh checkout
builds everything on its first call; the shared headers (``csrc/*.cuh``)
count in every library's hash.  :func:`build` starts one ``nvcc``
per missing library, all at once, and waits for them; each splits its
device code's optimisation over the host's cores (``--split-compile``,
CUDA 12.1 and later), which leaves every kernel's registers as they
were.  A library registered in ``parts`` compiles its source that many
times at once, with ``-DKG_PART=p`` for p = 0 .. parts - 1 (each part
instantiates a share of the kernels), and links the objects into one
library.  A failed build raises with the compiler's output.  Nothing is
built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubegpu_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
]

# name -> (source file under csrc, ctypes declarations)
_KERNELS: Dict[str, tuple] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> the compiler's output of this process's build (ptxas
# registers / shared memory / spills per kernel)
BUILD_LOG: Dict[str, str] = {}
# name -> seconds from this process's start of its nvcc to its end
BUILD_SECONDS: Dict[str, float] = {}


def register(name: str, source: str,
             declare: Callable[[ctypes.CDLL], None], parts: int = 1) -> None:
    _KERNELS[name] = (source, declare, parts)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build from ops/csrc at first "
            "use and need the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header
    under csrc (a source may include any of them) and the flags."""
    digest = hashlib.sha256()
    for path in [CSRC / _KERNELS[name][0], *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(f"parts={_KERNELS[name][2]}".encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _commands(nvcc: str, name: str, out: Path) -> tuple:
    """``(compilations, link, objects)`` of library ``name`` into ``out``:
    the compilations run at once, then the link of their objects (None,
    and no objects, for a one-part library)."""
    source, _, parts = _KERNELS[name]
    if parts == 1:
        return [[nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]], \
            None, []
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [out.with_suffix(f".part{p}.o") for p in range(parts)]
    return ([[nvcc, *compile_flags, f"-DKG_PART={p}", "-c", "-o", str(obj),
              str(CSRC / source)] for p, obj in enumerate(objs)],
            [nvcc, "-shared", "-o", str(out), *map(str, objs)], objs)


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Path]:
    """Compile every named kernel library (default: all registered) that
    is not built yet — every ``nvcc`` of every library started together,
    then each parted library's link."""
    names = list(_KERNELS) if names is None else list(names)
    targets = {n: library_path(n) for n in names}
    missing = [n for n in names if not targets[n].exists()]
    if not missing:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    jobs = {}
    for n in missing:
        tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
        cmds, link, objs = _commands(nvcc, n, tmp)
        jobs[n] = (tmp, link, objs, [subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ) for cmd in cmds])
    failed = []
    for n, (tmp, link, objs, procs) in jobs.items():
        logs, ok = [], True
        for proc in procs:
            logs.append(proc.communicate()[0])
            ok = ok and proc.returncode == 0
        if ok and link is not None:
            done = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs.append(done.stdout)
            ok = done.returncode == 0
        for obj in objs:
            obj.unlink(missing_ok=True)
        BUILD_LOG[n] = "".join(logs)
        BUILD_SECONDS[n] = time.monotonic() - t0
        if not ok:
            failed.append(f"{n}:\n{BUILD_LOG[n]}")
            continue
        os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _KERNELS[name][1](lib)
        _LOADED[name] = lib
    return lib
