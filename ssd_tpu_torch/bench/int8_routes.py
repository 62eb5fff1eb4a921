"""Times the W8A16 GEMM K9's two bf16 routes (csrc/int8_weight_gemm.cu: 16 x
16 and 64 x 64 tiles) against each other, to place the crossover of the
route rule (ops/linear.py::int8_linear_route, INT8_SMALL_ROWS,
INT8_NARROW_ROWS, INT8_WIDE_N).

Usage: python ssd_tpu_torch/bench/int8_routes.py [--iters N] [--out FILE]

Dense shapes are Llama-3.2-1B's projections (q/o 2048 -> 2048, k/v 2048 ->
512, gate/up 2048 -> 8192, down 8192 -> 2048) and its LM head (2048 ->
128,256, fp32 out) at 8 to 256 rows (8: the AR b8 decode; 40: the SD
verify; 80: the SSD tree step); grouped shapes are Qwen3-30B-A3B's expert
gate (2048 -> 768) and down (768 -> 2048) at dispatches of 1 to 64 tokens'
top-8 of 128 experts, from chip_smoke.py's seeded router. Each route is
forced in turn by replacing int8_linear_route, every call is first checked
against int8_linear_plain at the tolerance of its output dtype (1e-4 +
2^-7 |ref| in bf16, 1e-4 in fp32), and each is timed as gmm_routes.py
times (L2 flushed before each call). Prints one JSON object per shape
and row count, with each route's ms, the rule's pick and the bytes bound,
and appends it to --out.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
DENSE = {"qo": (2048, 2048), "kv": (512, 2048), "gate_up": (8192, 2048),
         "down": (2048, 8192), "lm_head": (128256, 2048)}   # name -> (N, K)
ROWS = (8, 16, 24, 32, 40, 64, 80, 128, 256)
EXPERTS = {"gate": (768, 2048), "down": (2048, 768)}
TOKENS = {1: 3, 2: 5, 4: 7, 8: 2, 16: 16, 40: 40, 64: 64}   # tokens -> router seed
E, TOP_K = 128, 8


def dispatch_offsets(tokens: int, seed: int):
    """Group offsets [E+1] int32 of `tokens` tokens' top-8 experts: a seeded
    random router over random hidden states, the last expert masked out
    (chip_smoke.py::_moe_offsets)."""
    import torch

    from ssd_tpu_torch.ops import moe
    from ssd_tpu_torch.ops.spec_math import stable_topk_indices

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tokens, 2048, generator=g, device="cuda")
    logits = x @ (torch.randn(2048, E, generator=g, device="cuda") * 0.02)
    logits[:, E - 1] = float("-inf")
    return moe.expert_offsets(stable_topk_indices(logits, TOP_K).reshape(-1), E)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="append the JSON lines to this file too")
    args = ap.parse_args(argv)
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from ssd_tpu_torch.bench.gmm_routes import time_ms
    from ssd_tpu_torch.ops import linear

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K9's routes run only on the card")
    rule = linear.int8_linear_route
    cases = [(name, M, N, K, None) for name, (N, K) in DENSE.items() for M in ROWS]
    cases += [(f"experts_{name}", None, N, K, t) for name, (N, K) in EXPERTS.items()
              for t in TOKENS]
    out = open(args.out, "a") if args.out else None
    for name, M, N, K, tokens in cases:
        offs = None if tokens is None else dispatch_offsets(tokens, TOKENS[tokens])
        G = 1 if offs is None else E
        M = M if offs is None else int(offs[-1])
        active = G if offs is None else int((offs[1:] > offs[:-1]).sum())
        odt = torch.float32 if name == "lm_head" else torch.bfloat16
        g = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (G, N, K), generator=g, device="cuda", dtype=torch.int8)
        s = torch.rand(G, N, generator=g, device="cuda") * (0.04 / 127) + 0.01 / 127
        want = linear.int8_linear_plain(x, w, s, odt, offs).float()
        tol = 1e-4 + (2.0 ** -7 if odt == torch.bfloat16 else 0.0) * want.abs()
        bytes_ = M * K * 2 + active * N * (K + 4) + M * N * odt.itemsize
        row = dict(shape=name, M=M, N=N, K=K, tokens=tokens, active_groups=active,
                   rule=rule(torch.bfloat16, M, N, G), bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
                   device=torch.cuda.get_device_name(0))
        for route in ("small", "large"):
            linear.int8_linear_route = lambda *shape_, route=route: route
            got = linear.int8_linear(x, w, s, out_dtype=odt, group_offsets=offs)
            torch.cuda.synchronize()
            if not bool(((got.float() - want).abs() <= tol).all()):
                raise SystemExit(f"{route} route disagrees with the plain version at {name} M={M}")
            row[f"{route}_ms"] = time_ms(
                lambda: linear.int8_linear(x, w, s, out_dtype=odt, group_offsets=offs),
                args.iters)
        linear.int8_linear_route = rule
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
        del x, w, s, want, tol
    if out:
        out.close()


if __name__ == "__main__":
    main()
