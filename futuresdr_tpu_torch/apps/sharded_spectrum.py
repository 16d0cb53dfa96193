"""Sequence-parallel spectrum over a device mesh: the counterpart of the
reference's ``examples/sharded_spectrum.py``.

One stream is time-sharded over every device of a one-axis mesh: each shard
filters its slice with the ``fir_fft`` kernel (its left halo, the previous
shard's last ``n_taps − 1`` samples, crosses by a peer copy, so the FIR is
exact across shard and frame edges), takes the DFT of each row and ``|x|²``,
and the spectra stay sharded (``parallel/stream_sp.sp_fir_fft_mag2_stream``).

``--devices N`` counts the mesh. Where fewer cards exist, the app lists N
logical devices on card 0 (config ``virtual_devices``, as the reference forces
N virtual devices) and says so: logical shards on one card measure the
sharding's overhead, not its scaling. ``--cpu`` runs the kernels' plain
versions on N logical CPU devices.

Run: ``python -m futuresdr_tpu_torch.apps.sharded_spectrum [--devices 8]
[--frames 32] [--fft 1024] [--frame-size 262144] [--cpu]``
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["main"]


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--fft", type=int, default=1024)
    p.add_argument("--frame-size", type=int, default=1 << 18)
    p.add_argument("--cpu", action="store_true", help="logical CPU devices, plain versions")
    a = p.parse_args(argv)

    from ..config import config
    cfg = config()
    prev = cfg.virtual_devices
    if a.cpu or torch.cuda.device_count() < a.devices:
        cfg.virtual_devices = a.devices        # asked for by --devices, said below
    try:
        return _run(a, "cpu" if a.cpu else None)
    finally:
        cfg.virtual_devices = prev


def _run(a, base) -> int:
    from ..dsp import firdes
    from ..parallel import (describe_devices, make_mesh, place, sp_fir_fft_mag2_stream,
                            to_host)
    mesh = make_mesh(("sp",), shape=(a.devices,), device=base)
    devs = mesh.line("sp")
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    fn, init_carry = sp_fir_fft_mag2_stream(taps, a.fft, mesh)
    n = a.frame_size - (a.frame_size % (a.devices * a.fft))
    rng = np.random.default_rng(0)
    carry = init_carry(np.float32)
    # a small pool of frames made before the timed window, already placed
    pool = [place(torch.from_numpy(rng.standard_normal(n).astype(np.float32)), mesh)
            for _ in range(4)]
    carry, y = fn(carry, pool[0])            # warm: kernel builds, first launches
    _sync(devs)
    t0 = time.perf_counter()
    for k in range(a.frames):
        carry, y = fn(carry, pool[k % len(pool)])
    _sync(devs)
    dt = time.perf_counter() - t0
    spec = to_host(y).reshape(-1, a.fft)
    print(f"mesh: {describe_devices(devs)} ('sp' axis), frame {n} samples, "
          f"{a.frames} frames")
    print(f"throughput: {a.frames * n / dt / 1e6:.1f} Msamples/s "
          f"({a.frames * n / dt / 1e6 / a.devices:.1f} per shard)")
    print(f"spectra: {spec.shape[0]} x {a.fft} bins, peak bin power {spec.max():.1f}")
    return 0


def _sync(devs) -> None:
    for d in {str(d) for d in devs}:
        if d.startswith("cuda"):
            torch.cuda.synchronize(d)


if __name__ == "__main__":
    sys.exit(main())
