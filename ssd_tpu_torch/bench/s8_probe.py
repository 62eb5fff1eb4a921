"""Probe: the card's int8 dot rate against its bf16 dot, at the int8 paged
kernel's tile (64 row blocks of 8 query rows, 512 positions, a 128-wide
contraction). The port of bench/s8_probe.py: its Pallas kernels become
csrc/s8_probe.cu's three paths (ops/probes.py).

Usage: python -m ssd_tpu_torch.bench.s8_probe [--iters N] [--interpret]

Each path is checked against its plain fp64 version (exact: it must match
bit for bit) and timed with CUDA events over --iters launches. --interpret
runs the plain versions on the CPU instead (no card, no timing), as the JAX
script's flag runs its kernels in interpret mode.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ssd_tpu_torch.ops import probes

SHAPE = dict(N=64, R=8, L=512, D=128)


def inputs(device: str, seed: int = 0):
    """q [64, 8, 128] and k [64, 512, 128] int8 in [-127, 127), as the JAX
    script draws them, and q cast to bf16."""
    rng = np.random.default_rng(seed)
    N, R, L, D = SHAPE["N"], SHAPE["R"], SHAPE["L"], SHAPE["D"]
    q8 = torch.from_numpy(rng.integers(-127, 127, (N, R, D)).astype(np.int8)).to(device)
    k8 = torch.from_numpy(rng.integers(-127, 127, (N, L, D)).astype(np.int8)).to(device)
    return q8, k8, q8.to(torch.bfloat16)


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--interpret", action="store_true",
                    help="run the plain versions on the CPU (no timing)")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    device = "cpu" if args.interpret else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --interpret to run the plain versions")
    q8, k8, qb = inputs(device)
    want = probes.s8_dot_plain(q8, k8)
    for name, fn, q in (("s8_mma", probes.s8_dot_mma, q8), ("s8_dp4a", probes.s8_dot_dp4a, q8),
                        ("bf16_cast", probes.s8_dot_bf16, qb)):
        out = fn(q, k8)
        exact = bool(torch.equal(out.double(), want.double()))
        if not exact:
            raise SystemExit(f"{name} differs from its plain version")
        line = f"{name}: exact={exact} checksum={int(out.double().sum().item())}"
        if device == "cuda":
            line += f"  {time_ms(lambda: fn(q, k8), args.iters) * 1e3:.2f} us/call"
        print(line, flush=True)


if __name__ == "__main__":
    main()
