#!/usr/bin/env python3
"""Where a checkpoint's seconds go on a machine: 4 GiB of float32 leaves
written raw with and without fsync, read back raw, written as one step
of the port's checkpoint format (``kubegpu_tpu_torch/models/checkpoint.py``:
a zip through ``zipfile``, then fsync), read back through ``np.load``'s
npz path and through the format's own reader (one read at each member's
offset, CRC-32 checked), CRC-32 alone, and host-to-device and
device-to-host copies of pageable memory.  Prints GB/s for each.

    python tools/checkpoint_io_probe.py [--dir DIR]

Needs a CUDA device for the copies; writes into a temporary directory
(under ``--dir`` when given) and removes it."""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kubegpu_tpu_torch.models.checkpoint import make_manager  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    root = tempfile.mkdtemp(prefix="ckpt-io-", dir=args.dir)
    rng = np.random.default_rng(0)
    leaves = [(f"params/l{i}", rng.random((8192, 8192), np.float32))
              for i in range(16)]
    total = sum(a.nbytes for _, a in leaves)
    usage = shutil.disk_usage(root)
    print(f"{total} B in {len(leaves)} leaves; {root}: free "
          f"{usage.free / 1e9:.1f} of {usage.total / 1e9:.1f} GB",
          flush=True)

    def rate(label, fn, nbytes=total):
        t = time.monotonic()
        fn()
        dt = time.monotonic() - t
        print(f"{label}: {dt:.3f} s, {nbytes / dt / 1e9:.3f} GB/s",
              flush=True)

    raw = os.path.join(root, "raw.bin")

    def write_raw(fsync: bool):
        with open(raw, "wb") as f:
            for _, a in leaves:
                f.write(memoryview(a).cast("B"))
            f.flush()
            if fsync:
                os.fsync(f.fileno())

    def read_raw():
        with open(raw, "rb") as f:
            for _, a in leaves:
                f.readinto(memoryview(np.empty_like(a)).cast("B"))

    mgr = make_manager(os.path.join(root, "ck"))
    npz = os.path.join(root, "ck", "1", "state.npz")

    def read_npz():
        with np.load(npz) as z:
            for k, _ in leaves:
                z[k]

    def read_format():
        with mgr.open(1) as r:
            for k, _ in leaves:
                r.leaf(k)

    try:
        rate("raw write", lambda: write_raw(False))
        rate("raw write + fsync", lambda: write_raw(True))
        rate("raw read", read_raw)
        rate("format write (zipfile, fsync)",
             lambda: mgr.write(1, iter(leaves), {}))
        rate("npz read (np.load)", read_npz)
        rate("format read (one read a leaf, CRC-32 checked)", read_format)
        rate("crc32", lambda: [zlib.crc32(memoryview(a).cast("B"))
                               for _, a in leaves])
        if torch.cuda.is_available():
            dev = torch.device("cuda")

            def h2d():
                for _, a in leaves:
                    torch.from_numpy(a).to(dev)
                torch.cuda.synchronize()

            rate("host to device (pageable)", h2d)
            on_card = [torch.from_numpy(a).to(dev) for _, a in leaves[:4]]
            torch.cuda.synchronize()
            rate("device to host (pageable)",
                 lambda: [t.cpu() for t in on_card],
                 sum(t.numel() * 4 for t in on_card))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
