"""Prefill cost decomposition: where does a 2k-token TTFT go? The port of
bench/prefill_diag.py.

Times R prefills of one --t-token prompt, each variant as one CUDA graph
(diag_timing.py; the least of --reps replays):

    full       the production flat prefill (engine/model_runner.py::
               flat_prefill_step: embed -> L x (norms, rope, q/k/v/o, the
               flat prefill kernel K1, the KV store, MLP) -> LM head on the
               last row -> sample)
    no_kernel  the same body from the port's public functions
               (models/transformer.py::forward_hidden, compute_logits,
               ops/attention.py::store_kv, ops/sampler.py::sample) with the
               attention replaced by the identity (KV store kept)
    no_attn    the same, the KV store skipped too
    matmul     the stacked-matmul floor: each layer's q/k/v/o and MLP
               products alone (torch.matmul, no norms, rope, embedding or
               head), the activations carried from layer to layer
    head       the LM head on one row and the sample alone

so  kernel = full - no_kernel,  kv_store = no_kernel - no_attn,
    non_matmul = no_attn - the FLOP floor of the projections and the head,
measured rather than guessed, with the achieved TFLOP/s against the card's
bf16 tensor-core peak (--peak-tflops; `mxu_pct_full` keeps the JAX line's
key for that share). The FLOP count is the JAX script's: the projections
and the MLP of every token, the head of one row, causal attention as
2 L Hq T^2 hd.

Prefill i of R takes the prompt's token ids plus i (mod V), so every
prefill does real work. The JAX script's guards against XLA hoisting a
loop-invariant body out of its scan (a perturbed carry, a summed hidden
state) have no CUDA-graph counterpart and are not kept: a graph replays
every launch it captured. Geometry: Llama-3.2-1B (16 layers, untied head,
random weights, seed 0), block 64, bf16, temperature 0; --tiny
the JAX script's CPU geometry (2 layers, at most 128 tokens).

  python -m ssd_tpu_torch.bench.prefill_diag --t 2048 --r 8 --reps 5
  python -m ssd_tpu_torch.bench.prefill_diag --tiny --device cpu

On the card the full variant's graph replay is also held bit for bit to
flat_prefill_step called eagerly on the same inputs
(`full_replay_equals_eager`). Runs on "cuda" unless --device cpu, and
raises without a card.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ssd_tpu_torch.bench import diag_timing as dt
from ssd_tpu_torch.bench.card import PEAK_FLOPS, device_fields
from ssd_tpu_torch.engine.model_runner import (
    flat_prefill_step, layer_of, resolve_device, served_params)
from ssd_tpu_torch.models.transformer import Arch, compute_logits, forward_hidden, init_params
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops.layers import silu_mul
from ssd_tpu_torch.ops.sampler import sample

LAYERS = {False: 16, True: 2}   # tiny -> layers
TINY_MAX_T = 128


@dataclass
class Case:
    """One prompt of T tokens at positions 0..T-1 in pages 0..T/64-1."""

    arch: Arch
    params: dict
    kv: torch.Tensor            # [L, Hkv, (T/64 + 8) * 64, 2 hd]
    ids: torch.Tensor           # [T] seeded in [10, V-1)
    positions: torch.Tensor     # [T]
    pages: torch.Tensor         # [T/64]
    row_lo: torch.Tensor        # [T] 0
    row_hi: torch.Tensor        # [T] position + 1
    gather_idx: torch.Tensor    # [1] T-1
    temps: torch.Tensor         # [1] 0
    x0: torch.Tensor            # [T, D] seeded activations (matmul, head)
    R: int
    gen: torch.Generator

    def reset(self):
        self.kv.zero_()

    def ids_at(self, i: int) -> torch.Tensor:
        return (self.ids + i) % self.arch.vocab_size


def make_case(params, arch, *, T: int, R: int, device) -> Case:
    dtype = params["layers"][0]["wq"].dtype
    n_pages = T // dt.BLOCK
    rng = np.random.default_rng(0)
    ids = rng.integers(10, arch.vocab_size - 1, T)
    x0 = np.random.default_rng(1).standard_normal((T, arch.hidden_size)) * 0.02
    pos = torch.arange(T, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    return Case(
        arch=arch, params=params,
        kv=torch.zeros((arch.num_layers, arch.num_kv_heads, (n_pages + 8) * dt.BLOCK,
                        2 * arch.head_dim), dtype=dtype, device=device),
        ids=torch.from_numpy(ids.astype(np.int32)).to(device), positions=pos,
        pages=torch.arange(n_pages, dtype=torch.int32, device=device),
        row_lo=torch.zeros(T, dtype=torch.int32, device=device),
        row_hi=pos + 1, gather_idx=torch.tensor([T - 1], device=device),
        temps=torch.zeros(1, dtype=torch.float32, device=device),
        x0=torch.from_numpy(x0).to(device, dtype), R=R, gen=gen)


def full_variant(c: Case):
    """R production prefills; returns their tokens [R, 1] and logits
    [R, 1, V]."""
    def run():
        toks, logits = [], []
        for i in range(c.R):
            tok, lg = flat_prefill_step(
                c.params, c.kv, c.ids_at(i), c.positions, c.positions, c.pages, c.row_lo,
                c.row_hi, c.gather_idx, c.temps, c.gen, arch=c.arch, block_size=dt.BLOCK,
                greedy=True)
            toks.append(tok)
            logits.append(lg)
        return torch.stack(toks), torch.stack(logits)

    return run


def _stripped(c: Case, keep_store: bool):
    """The prefill with the identity for attention, storing each layer's
    K/V (keep_store) or not; returns as full_variant."""
    def attn_call(li, q, k, v):
        if keep_store:
            att.store_kv(layer_of(c.kv, li), k, v, c.positions)
        return q

    def run():
        toks, logits = [], []
        for i in range(c.R):
            hidden = forward_hidden(c.params, c.ids_at(i), c.positions, attn_call, c.arch)
            lg = compute_logits(c.params, hidden, c.arch, gather_idx=c.gather_idx)
            toks.append(sample(lg, c.temps, c.gen, greedy=True))
            logits.append(lg)
        return torch.stack(toks), torch.stack(logits)

    return run


def matmul_variant(c: Case):
    """The projections and the MLP of every layer, R times over, on
    activations carried from layer to layer (k and v padded to q's width
    and added to it). Returns the last activations [T, D]."""
    def run():
        x = c.x0
        for _ in range(c.R):
            for lp in c.params["layers"]:
                q = torch.matmul(x, lp["wq"])
                k = torch.matmul(x, lp["wk"])
                v = torch.matmul(x, lp["wv"])
                pad = (0, q.shape[1] - k.shape[1])
                o = q + torch.nn.functional.pad(k, pad) + torch.nn.functional.pad(v, pad)
                h = torch.matmul(o, lp["wo"])
                x = torch.matmul(silu_mul(torch.matmul(h, lp["gate"]),
                                          torch.matmul(h, lp["up"])), lp["down"])
        return x

    return run


def head_variant(c: Case):
    """R heads of the last row of x0 and their samples; returns the tokens
    [R, 1] and logits [R, 1, V]."""
    def run():
        logits = [compute_logits(c.params, c.x0, c.arch, gather_idx=c.gather_idx)
                  for _ in range(c.R)]
        toks = [sample(lg, c.temps, c.gen, greedy=True) for lg in logits]
        return torch.stack(toks), torch.stack(logits)

    return run


VARIANTS = {"full": full_variant, "no_kernel": partial(_stripped, keep_store=True),
            "no_attn": partial(_stripped, keep_store=False), "matmul": matmul_variant,
            "head": head_variant}


def flops(arch: Arch, T: int) -> dict:
    """FLOPs of one prefill of T tokens per variant, as the JAX script
    counts them."""
    D, I, L = arch.hidden_size, arch.intermediate_size, arch.num_layers
    proj = D * (arch.num_heads * arch.head_dim * 2 + arch.num_kv_heads * arch.head_dim * 2)
    layers = 2 * T * L * (proj + 3 * D * I)
    head = 2 * D * arch.vocab_size
    attn = 2 * L * arch.num_heads * T * T * arch.head_dim
    return {"full": layers + head + attn, "no_kernel": layers + head,
            "no_attn": layers + head, "matmul": layers, "head": head}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--t", type=int, default=2048, help="prompt tokens")
    p.add_argument("--r", type=int, default=8, help="prefills a graph")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--tiny", action="store_true", help="the CPU smoke's geometry")
    p.add_argument("--peak-tflops", type=float, default=PEAK_FLOPS["bfloat16"] / 1e12,
                   help="the card's dense bf16 tensor-core rate (H100 SXM: 989)")
    p.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile", action="store_true",
                   help="add one replay of each variant under torch.profiler")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)   # "cuda" raises without a card
    T = min(args.t, TINY_MAX_T) if args.tiny else args.t
    arch = Arch.from_model_config(dt.model_config(args.tiny, LAYERS[args.tiny]))
    params = served_params(init_params(arch, 0, dt.DTYPE, device), None)
    c = make_case(params, arch, T=T, R=args.r, device=device)
    fl = flops(arch, T)
    fields = device_fields(device)
    print(f"{arch.num_layers}L, T={T}, R={c.R} on {fields['device']} "
          f"({fields['power_limit']})", flush=True)
    timer = dt.Timer(device, [c.gen])
    out = {"metric": "prefill_decomposition_ms", "t": T}
    launches, profiles, equal = {}, {}, None
    for name in args.variants:
        m = timer.measure(name, VARIANTS[name](c), args.reps, reset=c.reset)
        if name == "full" and device.type == "cuda":
            c.reset()
            equal = dt.same(m.outputs, full_variant(c)())
        ms = m.ms / c.R
        tf = fl[name] / (ms / 1e3) / 1e12
        out[name] = ms
        launches[name] = m.launches
        if args.profile:
            profiles[name] = timer.profile(name, c.R)
        print(f"[{name:9s}] {ms:8.3f} ms/prefill  {tf:6.1f} TFLOP/s "
              f"({100 * tf / args.peak_tflops:.0f}% of the bf16 peak)  launches {m.launches}",
              flush=True)
    timer.release()
    floor_ms = fl["no_attn"] / (args.peak_tflops * 1e12) * 1e3
    out["matmul_floor_ms"] = floor_ms
    if all(k in out for k in ("full", "no_kernel", "no_attn")):
        out["kernel_ms"] = out["full"] - out["no_kernel"]
        out["kv_store_ms"] = out["no_kernel"] - out["no_attn"]
        out["non_matmul_ms"] = out["no_attn"] - floor_ms
        out["mxu_pct_full"] = 100 * fl["full"] / (out["full"] / 1e3) / 1e12 / args.peak_tflops
    if args.profile:
        out["profile"] = profiles
    out.update(fields, launches=launches, full_replay_equals_eager=equal, r=c.R,
               layers=arch.num_layers, flops=fl)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
