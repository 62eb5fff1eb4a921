"""Split the paged decode kernel's time into its stages: the port of
bench/kernel_diag.py. The same kernel (csrc/paged_attention.cu, or
csrc/paged_attention_int8.cu with --kv int8) is built with its page loads or
its math compiled out (ops/probes.py::paged_attention_diag):

  full     the production kernel (page loads + attention math)
  dma      page walk and K/V loads only
  compute  the attention math on resident rows, no page loads
  empty    neither: the grid, the query load and the output write

  python -m ssd_tpu_torch.bench.kernel_diag --ctx 2048 --batch 8 --block 256
  python -m ssd_tpu_torch.bench.kernel_diag --contexts 1500 --chunks 32,64,128,256

--chunks times the production kernel at each chunk length (positions per
block; ops/attention.py::PAGED_CHUNK holds the one the port uses), the way
that value is chosen; the variants run at the port's own chunk. Every time
is taken with the L2 cache flushed before each call.

--tree times the tree kernels instead (csrc/tree_split.cuh: K3, and K5 in
both int8 modes with --kv int8), at the last tree step of the async draft
(K=4, fan-out 2: MQ=10) over the same contexts (each sequence's prefix; its
tree tail is added), at each --chunks length (TREE_CHUNK holds the port's),
or without --chunks at the package's own. Run by its path with another
checkout of the package first on PYTHONPATH, the latter times that
checkout's tree kernels on the same inputs:

  python -m ssd_tpu_torch.bench.kernel_diag --tree --contexts 97,175 --chunks 64,128,256
  cd <other checkout> && PYTHONPATH=. python <this checkout>/ssd_tpu_torch/bench/kernel_diag.py --tree ...

The JAX script's flags are kept except --ppc (pages per TPU grid step): the
GPU kernel walks a sequence's pages in one block and has no such knob. "full"
is checked bit for bit against the production entry before timing.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops import probes


def decode_case(B, Q, Hq, Hkv, hd, bs, ctx_lens, dtype, kv_quant=None, seed=0,
                device="cuda"):
    """A paged decode batch: shuffled disjoint page tables, K/V standard
    normal in `dtype` (or quantized to the int8 pair). Returns (q, layer,
    block_tables, context_lens, qeff)."""
    rng = np.random.default_rng(seed)
    M = max(-(-c // bs) for c in ctx_lens)
    S = B * M * bs + bs
    kv = torch.from_numpy(rng.normal(size=(Hkv, S, 2 * hd)).astype(np.float32)).to(device)
    q = torch.from_numpy(rng.normal(size=(B, Q, Hq, hd)).astype(np.float32)).to(device, dtype)
    bt = torch.from_numpy((rng.permutation(B * M).reshape(B, M) + 1).astype(np.int32)).to(device)
    if kv_quant:
        layer = (torch.zeros(Hkv, S, 2 * hd, dtype=torch.int8, device=device),
                 torch.full((Hkv, 2, S), 1e-10, device=device))
        att.store_kv(layer, kv[:, :, :hd].transpose(0, 1), kv[:, :, hd:].transpose(0, 1),
                     torch.arange(S, dtype=torch.int32, device=device))
    else:
        layer = kv.to(dtype)
    ctx = torch.tensor(ctx_lens, dtype=torch.int32, device=device)
    return q, layer, bt, ctx, torch.full((B,), Q, dtype=torch.int32, device=device)


def tree_case(Hq, Hkv, hd, bs, bases, dtype, kv_quant=None, K=4, fan_out=2, seed=0,
              device="cuda"):
    """The last tree step of the async draft (K, fan-out: MQ = fan_out * (K+1)
    rows a sequence) whose prefixes are `bases`: contexts base + (K+1) +
    K * MQ, the hit fan-out rows. Returns (q, layer, block_tables,
    context_lens, fan_idx_rows, step, K)."""
    MQ = fan_out * (K + 1)
    ctx = [n + (K + 1) + K * MQ for n in bases]
    q, layer, bt, ctx_t, _ = decode_case(len(ctx), MQ, Hq, Hkv, hd, bs, ctx, dtype,
                                         kv_quant=kv_quant, seed=seed, device=device)
    fan = torch.arange(K + 1, device=device).repeat_interleave(fan_out)
    fan = fan[None].expand(len(ctx), MQ).to(torch.int32).contiguous()
    return q, layer, bt, ctx_t, fan, K - 1, K


def time_cold_ms(fn, iters: int) -> float:
    """Mean device time of one fn() call with the L2 cache flushed before
    each (a 256 MiB write), as a layer's attention finds its KV on the
    serving path; a spin kernel holds the stream while the host enqueues,
    so CUDA events around each call time the device's work."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ctx", type=int, default=2048)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--q", type=int, default=1)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--kv-heads", type=int, default=8)
    p.add_argument("--hd", type=int, default=64)
    p.add_argument("--block", type=int, default=256)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--variants", default="full,dma,compute,empty")
    p.add_argument("--kv", choices=("bf16", "int8"), default="bf16")
    p.add_argument("--contexts", default=None,
                   help="comma-separated per-sequence contexts (overrides --ctx, --batch)")
    p.add_argument("--chunks", default=None,
                   help="comma-separated chunk lengths at which to time the production kernel")
    p.add_argument("--tree", action="store_true",
                   help="time the tree kernels (at --chunks, else at the package's own) "
                        "instead of the paged kernel's stages")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_diag times the CUDA kernel and needs a card")
    ctx_lens = ([int(c) for c in args.contexts.split(",")] if args.contexts
                else [args.ctx] * args.batch)
    if args.tree:
        return tree_chunks(args, ctx_lens)
    B, Q, bs = len(ctx_lens), args.q, args.block
    q, layer, bt, ctx, qeff = decode_case(
        B, Q, args.heads, args.kv_heads, args.hd, bs, ctx_lens, torch.bfloat16,
        kv_quant="int8" if args.kv == "int8" else None)
    scale = args.hd ** -0.5
    prod = att.paged_attention(q, layer, bt, ctx, qeff, bs, scale)
    full = probes.paged_attention_diag("full", q, layer, bt, ctx, qeff, bs, scale)
    same = bool(torch.equal(full, prod))
    print(f"device: {torch.cuda.get_device_name(0)}  full == production: {same}", flush=True)
    if not same:
        raise SystemExit("the full stage differs from the production kernel")
    # The attended K|V bytes (and the int8 cache's two scales per position).
    per_pos = 2 * args.hd * (1 if args.kv == "int8" else 2) + (8 if args.kv == "int8" else 0)
    kv_bytes = sum(ctx_lens) * args.kv_heads * per_pos
    key = (args.hd, args.kv == "int8")
    for chunk in [int(c) for c in args.chunks.split(",")] if args.chunks else []:
        own = att.PAGED_CHUNK[key]
        att.PAGED_CHUNK[key] = chunk
        try:
            dt = time_cold_ms(lambda: att.paged_attention(q, layer, bt, ctx, qeff, bs, scale),
                              args.iters)
        finally:
            att.PAGED_CHUNK[key] = own
        print(f"[chunk {chunk:4d}] {dt:.4f} ms/call  {kv_bytes / dt / 1e6:.1f} GB/s-equiv",
              flush=True)
    for name in args.variants.split(","):
        dt = time_cold_ms(lambda: probes.paged_attention_diag(name, q, layer, bt, ctx, qeff,
                                                              bs, scale), args.iters)
        print(f"[{name:7s}] {dt:.4f} ms/call  {kv_bytes / dt / 1e6:.1f} GB/s-equiv",
              flush=True)


def tree_chunks(args, bases):
    """--tree: the tree kernels' time at each chunk length."""
    kvq = "int8" if args.kv == "int8" else None
    q, layer, bt, ctx, fan, step, K = tree_case(args.heads, args.kv_heads, args.hd, args.block,
                                                bases, torch.bfloat16, kv_quant=kvq)
    scale = args.hd ** -0.5
    print(f"device: {torch.cuda.get_device_name(0)}  tree step {step} of K={K}, "
          f"contexts {ctx.tolist()}", flush=True)
    key = (args.hd, kvq is not None)
    run = lambda s8: att.tree_attention(q, layer, bt, ctx, fan, step, K, args.block,  # noqa: E731
                                        scale, s8=s8)
    for s8 in ((False, True) if kvq else (False,)):
        mode = "int8_mxu" if s8 else args.kv
        if not args.chunks:  # the package's own chunk (any version of it)
            print(f"[tree {mode:8s}] {time_cold_ms(lambda: run(s8), args.iters):.4f} ms/call",
                  flush=True)
        for chunk in [int(c) for c in args.chunks.split(",")] if args.chunks else []:
            own = att.TREE_CHUNK[key]
            att.TREE_CHUNK[key] = chunk
            try:
                dt = time_cold_ms(lambda: run(s8), args.iters)
            finally:
                att.TREE_CHUNK[key] = own
            print(f"[tree {mode:8s} chunk {chunk:4d}] {dt:.4f} ms/call", flush=True)


if __name__ == "__main__":
    main()
