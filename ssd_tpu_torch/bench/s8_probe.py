"""Probe: the card's int8 dot rate against its bf16 dot, at the int8 paged
kernel's tile (64 row blocks of 8 query rows, 512 positions, a 128-wide
contraction) and at 4096 positions, where the bytes dominate the launch.
The port of bench/s8_probe.py: its Pallas kernels become csrc/s8_probe.cu's
three paths (ops/probes.py).

Usage: python -m ssd_tpu_torch.bench.s8_probe [--iters N] [--interpret]

Each path is checked against its plain fp64 version (exact: it must match
bit for bit) at both shapes and timed as chip_smoke.py times every kernel
(gmm_routes.time_ms: CUDA events around each of --iters calls, the L2
flushed before each). --interpret runs the plain versions on the CPU
instead (no card, no timing, the first shape only), as the JAX script's
flag runs its kernels in interpret mode.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ssd_tpu_torch.ops import probes

SHAPE = dict(N=64, R=8, L=512, D=128)
LONG_L = 4096                 # the second timed shape: 32 MiB of k
# (N, L, D) at which the card checks hold the kernels to their plain
# version: the probe's shape, LONG_L, one row block, D = 64, and tails past
# the last whole block of 64 positions (517 with L % 4 != 0).
CHECK_SHAPES = ((64, 512, 128), (64, LONG_L, 128), (1, 512, 128), (64, 512, 64),
                (3, 517, 128), (5, 1000, 64))


def inputs(device: str, seed: int = 0, N: int = SHAPE["N"], L: int = SHAPE["L"],
           D: int = SHAPE["D"]):
    """q [N, 8, D] and k [N, L, D] int8 in [-127, 127), as the JAX script
    draws them (its shape by default), and q cast to bf16."""
    rng = np.random.default_rng(seed)
    q8 = torch.from_numpy(rng.integers(-127, 127, (N, SHAPE["R"], D)).astype(np.int8)).to(device)
    k8 = torch.from_numpy(rng.integers(-127, 127, (N, L, D)).astype(np.int8)).to(device)
    return q8, k8, q8.to(torch.bfloat16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--interpret", action="store_true",
                    help="run the plain versions on the CPU (no timing)")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    device = "cpu" if args.interpret else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --interpret to run the plain versions")
    for L in (SHAPE["L"],) if device == "cpu" else (SHAPE["L"], LONG_L):
        q8, k8, qb = inputs(device, L=L)
        want = probes.s8_dot_plain(q8, k8)
        for name, fn, q in (("s8_mma", probes.s8_dot_mma, q8),
                            ("s8_dp4a", probes.s8_dot_dp4a, q8),
                            ("bf16_cast", probes.s8_dot_bf16, qb)):
            out = fn(q, k8)
            if not torch.equal(out.double(), want.double()):
                raise SystemExit(f"{name} differs from its plain version at L={L}")
            line = f"{name} L={L}: exact=True checksum={int(out.double().sum().item())}"
            if device == "cuda":
                from ssd_tpu_torch.bench.gmm_routes import time_ms

                line += f"  {time_ms(lambda: fn(q, k8), args.iters) * 1e3:.2f} us/call"
            print(line, flush=True)


if __name__ == "__main__":
    main()
