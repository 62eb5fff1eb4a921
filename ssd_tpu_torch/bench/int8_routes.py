"""Times the W8A16 GEMM K9's bf16 routes (csrc/int8_weight_gemm.cu: the wgmma
decode and prefill routes) against each other, to place the crossover of
the route rule (ops/linear.py::int8_linear_route and its INT8_* constants),
and the shared-x launch (int8_linear_shared: q/k/v, gate/up, the experts'
gate/up in one launch) against the separate calls it replaces. With
--baseline, also against an earlier K9 in the same run: DIR holds that
version's int8_weight_gemm.cu and the headers it includes (the first
kernel's: routes 0, 16 x 16 tiles, and 1, 64 x 64 tiles, both mma.sync,
picked by base_route's rule), built here with nvcc into csrc/build/.

Usage: python ssd_tpu_torch/bench/int8_routes.py [--iters N] [--out FILE]
           [--baseline DIR]

For example, against the first kernel, from the commit COMMIT that holds it:
  mkdir -p tree_check/k9_first && git archive COMMIT ssd_tpu_torch/csrc \
      | tar -x -C tree_check/k9_first
  python ssd_tpu_torch/bench/int8_routes.py \
      --baseline tree_check/k9_first/ssd_tpu_torch/csrc

Dense shapes are Llama-3.2-1B's projections (q/o 2048 -> 2048, k/v 2048 ->
512, gate/up 2048 -> 8192, down 8192 -> 2048) and its LM head (2048 ->
128,256, fp32 out) at 1 to 512 rows (8: the AR b8 decode; 40: the SD
verify; 80: the SSD tree step); grouped shapes are Qwen3-30B-A3B's expert
gate (2048 -> 768) and down (768 -> 2048) at dispatches of 1 to 64 tokens'
top-8 of 128 experts, from chip_smoke.py's seeded router. Each route is
forced in turn by replacing int8_linear_route, every call is first checked
against int8_linear_plain at the tolerance of its output dtype (1e-4 +
2^-7 |ref| in bf16, 1e-4 in fp32), and each is timed as gmm_routes.py
times (L2 flushed before each call). Prints one JSON object per shape
and row count, with each route's ms (the baseline's as base_small_ms and
base_large_ms, and base_rule_ms on its rule's route), the rule's pick and
the bytes bound, then one per shared-x product (the shared launch's ms,
the separate calls' on its route, and with --baseline the baseline's
separate calls on its rule's routes), and appends them to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
DENSE = {"qo": (2048, 2048), "kv": (512, 2048), "gate_up": (8192, 2048),
         "down": (2048, 8192), "lm_head": (128256, 2048)}   # name -> (N, K)
ROWS = (1, 8, 16, 24, 32, 40, 64, 80, 128, 160, 256, 512)
ROUTES = ("decode", "prefill")
SHARED = {"qkv": ((2048, 512, 512), 2048), "gate_up": ((8192, 8192), 2048)}
SHARED_ROWS = (1, 8, 40, 80, 128, 5534)
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


# The first K9's rule (its ops/linear.py::int8_linear_route): route 0
# (16 x 16 tiles) up to 16 rows a group on average, or up to 128 below N =
# 8192; else route 1 (64 x 64 tiles).
BASE_ROUTES = {"small": 0, "large": 1}


def base_route(M: int, N: int, G: int) -> str:
    rows = M / G
    return "small" if rows <= 16 or (rows <= 128 and N < 8192) else "large"


def load_baseline(src_dir: str):
    """The earlier K9 in src_dir/int8_weight_gemm.cu, compiled alone into a
    shared library under csrc/build/ (named by a hash of the source
    directory's files) and loaded with ctypes; its ssd_int8_linear has the
    current entry's arguments."""
    from ssd_tpu_torch.ops import cuda_lib

    src = Path(src_dir).resolve()
    h = hashlib.sha256(" ".join(cuda_lib.NVCC_FLAGS).encode())
    for f in sorted(src.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = cuda_lib.BUILD_DIR / f"baseline_int8_{h.hexdigest()[:16]}.so"
    if not so.exists():
        cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        str(src / "int8_weight_gemm.cu"), "-o", str(so)],
                       check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_int8_linear.restype = i
    lib.ssd_int8_linear.argtypes = [i, i, i, p, p, p, p, p, i, i, i, i, p]
    return lib


def baseline_linear(lib, route: str, x, w, s, odt, offs):
    """The baseline's product of a bf16 x on its route `route`."""
    import torch

    M, K = x.shape
    G, N, _ = w.shape
    out = torch.empty(M, N, dtype=odt, device=x.device)
    err = lib.ssd_int8_linear(1, int(odt == torch.float32), BASE_ROUTES[route], x.data_ptr(),
                              w.data_ptr(), s.data_ptr(),
                              None if offs is None else offs.data_ptr(), out.data_ptr(),
                              M, N, K, G, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the baseline's {route} route failed: CUDA error {err}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="append the JSON lines to this file too")
    ap.add_argument("--baseline", metavar="DIR",
                    help="time an earlier K9's routes too: DIR holds its int8_weight_gemm.cu")
    args = ap.parse_args(argv)
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from ssd_tpu_torch.bench.gmm_routes import time_ms
    from ssd_tpu_torch.ops import linear

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K9's routes run only on the card")
    rule = linear.int8_linear_route
    base = load_baseline(args.baseline) if args.baseline else None
    cases = [(name, M, N, K, None) for name, (N, K) in DENSE.items() for M in ROWS]
    cases += [(f"experts_{name}", None, N, K, t) for name, (N, K) in EXPERTS.items()
              for t in TOKENS]
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    # The first case runs twice and its first row is dropped: a process's
    # first timings come out slow (NVIDIA H100 80GB HBM3: 0.0325 ms for q/o
    # at one row, against 0.0123 for q/k/v together at one row later in
    # the same run).
    for i, (name, M, N, K, tokens) in enumerate([cases[0]] + cases):
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
        for route in ROUTES:
            linear.int8_linear_route = lambda *shape_, route=route: route
            got = linear.int8_linear(x, w, s, out_dtype=odt, group_offsets=offs)
            torch.cuda.synchronize()
            if not bool(((got.float() - want).abs() <= tol).all()):
                raise SystemExit(f"{route} route disagrees with the plain version at {name} M={M}")
            row[f"{route}_ms"] = time_ms(
                lambda: linear.int8_linear(x, w, s, out_dtype=odt, group_offsets=offs),
                args.iters)
        linear.int8_linear_route = rule
        row["rule_ms"] = row[f"{row['rule']}_ms"]
        if base is not None:
            for route in BASE_ROUTES:
                fn = lambda route=route: baseline_linear(base, route, x, w, s, odt, offs)
                got = fn()
                torch.cuda.synchronize()
                if not bool(((got.float() - want).abs() <= tol).all()):
                    raise SystemExit(f"the baseline's {route} route disagrees with the plain "
                                     f"version at {name} M={M}")
                row[f"base_{route}_ms"] = time_ms(fn, args.iters)
            row["base_rule"] = base_route(M, N, G)
            row["base_rule_ms"] = row[f"base_{row['base_rule']}_ms"]
        if i > 0:
            emit(row)
        del x, w, s, want, tol
    shared = [(name, M, Ns, K, None) for name, (Ns, K) in SHARED.items() for M in SHARED_ROWS]
    shared += [("experts_gate_up", None, (768, 768), 2048, t) for t in TOKENS]
    for name, M, Ns, K, tokens in shared:
        offs = None if tokens is None else dispatch_offsets(tokens, TOKENS[tokens])
        G = 1 if offs is None else E
        M = M if offs is None else int(offs[-1])
        g = torch.Generator(device="cuda").manual_seed(8)
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        ws = [torch.randint(-127, 128, (G, N, K), generator=g, device="cuda", dtype=torch.int8)
              for N in Ns]
        ss = [torch.rand(G, N, generator=g, device="cuda") * (0.04 / 127) + 0.01 / 127
              for N in Ns]
        route = rule(torch.bfloat16, M, Ns[0], G)
        got = linear.int8_linear_shared(x, ws, ss, group_offsets=offs)
        linear.int8_linear_route = lambda *shape_: route   # each product on the launch's route
        separate = lambda: [linear.int8_linear(x, w, s, group_offsets=offs)
                            for w, s in zip(ws, ss)]
        sep = separate()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, sep)):
            raise SystemExit(f"the shared-x launch differs from the separate calls at {name} M={M}")
        separate_ms = time_ms(separate, args.iters)
        linear.int8_linear_route = rule
        row = dict(shared=name, M=M, N=list(Ns), K=K, tokens=tokens, rule=route,
                   shared_ms=time_ms(lambda: linear.int8_linear_shared(
                       x, ws, ss, group_offsets=offs), args.iters),
                   separate_ms=separate_ms, device=torch.cuda.get_device_name(0))
        if base is not None:
            row["base_separate_ms"] = time_ms(
                lambda: [baseline_linear(base, base_route(M, w.shape[1], G), x, w, s,
                                         torch.bfloat16, offs) for w, s in zip(ws, ss)],
                args.iters)
        emit(row)
        del x, ws, ss, got, sep
    if out:
        out.close()


if __name__ == "__main__":
    main()
