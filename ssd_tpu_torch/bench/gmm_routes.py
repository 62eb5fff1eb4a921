"""Times the grouped GEMM K6's two bf16 routes (csrc/grouped_gemm.cu)
against each other and against torch._grouped_mm at Qwen3-30B-A3B
dispatches of 1 to 5534 tokens, to place the crossover of the route rule
(ops/moe.py::grouped_gemm_route, GMM_DECODE_ROWS).

Usage: python ssd_tpu_torch/bench/gmm_routes.py [--root DIR] [--iters N] [--out FILE]

The dispatches are each token's top-8 of 128 experts from a seeded random
router (the last expert masked out, as chip_smoke.py draws them; 1, 8 and
5534 tokens are its b1 and b8 decode and prefill dispatches, 40 tokens the
b8 verify of K+1 = 5 positions), and from a skewed router on which every
token picks the same 8 experts, so each group holds every token. Each is
timed at the gate (2048 -> 768) and down (768 -> 2048) shapes.

--root imports ssd_tpu_torch from another checkout (a `git archive` of an
earlier commit, which builds its own kernels) and times its grouped_gemm
on the route it picks itself, so that two trees can be timed in one chip
call. On a tree with grouped_gemm_route, each bf16 route is forced in turn
by replacing that function. Every timed call is first checked against
grouped_gemm_plain at the bf16 tolerance, 1e-4 + 2^-7 |ref|. Prints one
JSON object per dispatch and shape, with the plain version's, the
library's and each route's ms and the bytes bound, and appends it to
--out.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

E, TOP_K, D, IM = 128, 8, 2048, 768           # Qwen3-30B-A3B's experts
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
SEEDED = {1: 3, 8: 2, 16: 16, 40: 40, 64: 64, 128: 128, 256: 256, 512: 512,
          1024: 1024, 5534: 1}                  # tokens -> router seed
SKEWED = (8, 40, 64, 128)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one fn() call by CUDA events, with L2 flushed
    before each call and the stream held by a spin kernel while the host
    enqueues, as chip_smoke.py's time_ms does."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def dispatch_offsets(tokens: int, seed: int, skewed: bool, device: str):
    """Group offsets [E+1] int32 of `tokens` tokens' top-8 experts: a seeded
    random router over random hidden states with the last expert masked
    out, or with `skewed` the same 8 experts for every token."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(tokens, D, generator=g, device=device)
    logits = x @ (torch.randn(D, E, generator=g, device=device) * 0.02)
    logits[:, E - 1] = float("-inf")
    if skewed:
        logits[:, :TOP_K] += 1e4
    top = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :TOP_K]
    sizes = torch.bincount(top.reshape(-1), minlength=E)
    return torch.nn.functional.pad(torch.cumsum(sizes, 0), (1, 0)).to(torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose ssd_tpu_torch is timed (default: this one)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="append the JSON lines to this file too")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from ssd_tpu_torch.ops import moe

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the grouped GEMM's routes run only on the card")
    rule = getattr(moe, "grouped_gemm_route", None)
    routes = ("decode", "prefill") if rule else ("own",)
    cases = [(t, s, False) for t, s in SEEDED.items()] + [(t, t, True) for t in SKEWED]
    out = open(args.out, "a") if args.out else None
    for tokens, seed, skewed in cases:
        offs = dispatch_offsets(tokens, seed, skewed, "cuda")
        sizes = (offs[1:] - offs[:-1]).tolist()
        N, active = int(offs[-1]), sum(n > 0 for n in sizes)
        for shape, (K, Nout) in (("gate", (D, IM)), ("down", (IM, D))):
            g = torch.Generator(device="cuda").manual_seed(51)
            x = torch.randn(N, K, generator=g, device="cuda").to(torch.bfloat16)
            w = (torch.randn(E, K, Nout, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
            want = moe.grouped_gemm_plain(x, w, offs).float()
            tol = 1e-4 + 2.0 ** -7 * want.abs()
            bytes_ = (N * K + active * K * Nout + N * Nout) * 2 + offs.numel() * 4
            row = dict(root=args.root, tokens=tokens, router="skewed" if skewed else "seeded",
                       shape=shape, N=N, K=K, Nout=Nout, active_experts=active,
                       max_group=max(sizes), rule=rule(torch.bfloat16, N, E) if rule else None,
                       bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
                       device=torch.cuda.get_device_name(0))
            row["plain_ms"] = time_ms(lambda: moe.grouped_gemm_plain(x, w, offs), 3, warmup=1)
            ends = offs[1:].contiguous()
            row["library_ms"] = time_ms(lambda: torch._grouped_mm(x, w, offs=ends), args.iters) \
                if hasattr(torch, "_grouped_mm") else None
            for route in routes:
                if rule:
                    moe.grouped_gemm_route = lambda *shape_, route=route: route
                got = moe.grouped_gemm(x, w, offs)
                torch.cuda.synchronize()
                if not bool(((got.float() - want).abs() <= tol).all()):
                    raise SystemExit(f"{route} route disagrees with the plain version "
                                     f"at {tokens} tokens, {shape}")
                row[f"{route}_ms"] = time_ms(lambda: moe.grouped_gemm(x, w, offs), args.iters)
            if rule:
                moe.grouped_gemm_route = rule
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
            del x, w, want, tol
    if out:
        out.close()


if __name__ == "__main__":
    main()
