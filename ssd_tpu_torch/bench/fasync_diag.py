"""Fused-async superstep cost decomposition: where does a round's time go?
The port of bench/fasync_diag.py.

Per round engine/async_fused.py::async_ssd_superstep runs the draft's tree
build (draft_runner.py::tree_build_step: the K+1-query glue forward, the
top-F fork per glue depth, then K tree steps over B*MQ rows), the target's
K+1-query verify forward and verify(), and the in-step cache service (the
match and two gathers). The byte budget of a round is

    (K+1) * draft_bytes + target_bytes

the same as sync fused SD (the same forward count; the tree's extra cost
is query width, the fork's top-k and the [B*MQ, K, V] tree logits). The
tool runs, each as R rounds in one CUDA graph (diag_timing.py):

    full     the production async_ssd_superstep, its tree build on the
             graphs' side stream as the engine captures it
             (async_fused.py::_side), so it overlaps the verify
    build    R rounds of tree_build_step alone (fixed glue ids 0..K,
             every row a hit, base += K+1)
    verify   R rounds of the verify forward (decode_forward at q_len K+1)
             and ops/verify.py::verify alone (fixed speculation 0..K, zero
             q logits)
    fork     R x ops/spec_math.py::get_forked_recovery_tokens with its
             FanOut, on fixed glue logits (seeded normal)
    sync     the sync sd_superstep at the same K and R (the floor it is
             compared with)

residual_ms = full - build - verify, the JAX script's definition: the
cache service and the round's glue. On the card the build overlaps the
verify inside full, so the residual can be negative; a negative residual is
that overlap. Geometry: Llama-3.2-1B's width, target 16 layers, draft 4,
block 64, fan-out F on every glue depth (MQ = F (K+1) tree rows), bf16; --tiny the JAX script's CPU geometry. Each row owns its pages
(the JAX script gives every row the same table). Every row samples at
temperature 0.

  python -m ssd_tpu_torch.bench.fasync_diag --k 4 --rounds 32 --reps 3 --batch 8
  python -m ssd_tpu_torch.bench.fasync_diag --tiny --device cpu

On the card the full variant's graph replay is also held bit for bit to
the production function called eagerly (serially, as an eager engine runs
it) on the same inputs (`full_replay_equals_eager`). Runs on "cuda" unless
--device cpu, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass

import numpy as np
import torch

from ssd_tpu_torch.bench import diag_timing as dt
from ssd_tpu_torch.bench import sd_diag
from ssd_tpu_torch.bench.card import HBM_BYTES_PER_S, device_fields
from ssd_tpu_torch.engine.async_fused import async_ssd_superstep
from ssd_tpu_torch.engine.draft_runner import tree_build_step
from ssd_tpu_torch.engine.model_runner import decode_forward, resolve_device, tensor_bytes
from ssd_tpu_torch.ops.spec_math import FanOut, get_forked_recovery_tokens
from ssd_tpu_torch.ops.verify import verify


@dataclass
class Case(sd_diag.Case):
    """sd_diag's case (B rows) with the tree's fan-out and the fork's glue
    logits."""

    fan: FanOut | None = None
    F: int = 2
    glue_logits: torch.Tensor | None = None   # [B, K+1, V] fp32


def make_case(t_params, d_params, t_arch, d_arch, *, K: int, R: int, F: int, ctx_pad: int,
              B: int, device) -> Case:
    base = sd_diag.make_case(t_params, d_params, t_arch, d_arch, K=K, R=R, ctx_pad=ctx_pad,
                             device=device, B=B)
    glue_logits = np.random.default_rng(5).standard_normal(
        (B, K + 1, t_arch.vocab_size), dtype=np.float32)
    return Case(**vars(base), fan=FanOut((F,) * (K + 1), (F,) * (K + 1), device), F=F,
                glue_logits=torch.from_numpy(glue_logits).to(device))


def _glue(c: Case) -> torch.Tensor:
    """[B, K+1] ids 0..K on every row."""
    return torch.arange(c.K + 1, device=c.rec0.device)[None].expand(c.B, c.K + 1)


def _hits(c: Case) -> torch.Tensor:
    return torch.ones(c.B, dtype=torch.int64, device=c.rec0.device)


def full_variant(c: Case, side: torch.cuda.Stream | None = None):
    """The production superstep; returns its rounds [R, B, K+4]."""
    return lambda: async_ssd_superstep(
        c.t_params, c.t_kv, c.d_params, c.d_kv, c.rec0, c.n0, c.bt, c.bt, c.temps, c.temps,
        c.t_gen, c.d_gen, t_arch=c.t_arch, d_arch=c.d_arch, block_size=dt.BLOCK, K=c.K,
        R=c.R, fan=c.fan, sampler_x=None, F=c.F, greedy=True, side=side)


def build_variant(c: Case):
    """R tree builds over fixed glue ids, each at a base K+1 past the last.
    Returns the tree tokens [R, B, MQ, K+1] and the last build's spec
    logits [B*MQ, K, V] (stacking every round's would copy R times their
    bytes inside the timed graph)."""
    glue, hits = _glue(c), _hits(c)

    def run():
        n, trees = c.n0, []
        for _ in range(c.R):
            tree, spec_logits, _ = tree_build_step(
                c.d_params, c.d_kv, glue, n, c.bt, hits, c.temps, c.d_gen, arch=c.d_arch,
                block_size=dt.BLOCK, K=c.K, fan=c.fan, sampler_x=None, F=c.F, greedy=True)
            n = n + c.K + 1
            trees.append(tree)
        return torch.stack(trees), spec_logits

    return run


def verify_variant(c: Case):
    """R rounds of the verify forward and verify() over the fixed
    speculation 0..K with zero q logits, n += accept_until + 1. Returns
    accept_until and recoveries [R, B]."""
    Kp1 = c.K + 1
    spec, hits = _glue(c), _hits(c)
    ar = torch.arange(Kp1, device=c.rec0.device)
    logits_q = torch.zeros((c.B, c.K, c.t_arch.vocab_size), dtype=torch.float32,
                           device=c.rec0.device)

    def run():
        n, accs, recs = c.n0, [], []
        for _ in range(c.R):
            logits_p = decode_forward(
                c.t_params, c.t_kv, spec.reshape(-1), (n[:, None] + ar).reshape(-1), c.bt,
                n + Kp1, arch=c.t_arch, block_size=dt.BLOCK, q_len=Kp1)
            acc, rec = verify(logits_p.reshape(c.B, Kp1, -1), logits_q, spec, c.temps,
                              c.temps, hits, c.t_gen, greedy=True)
            n = n + acc + 1
            accs.append(acc)
            recs.append(rec)
        return torch.stack(accs), torch.stack(recs)

    return run


def fork_variant(c: Case):
    """R fork selections on the fixed glue logits, every row a hit with the
    returned tokens 0..K. Returns the fork tokens [R, B, MQ]."""
    returned, hits = _glue(c), _hits(c)
    return lambda: torch.stack([
        get_forked_recovery_tokens(c.glue_logits, hits, returned, c.fan) for _ in range(c.R)])


VARIANTS = {"full": full_variant, "build": build_variant, "verify": verify_variant,
            "fork": fork_variant, "sync": sd_diag.full_variant}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--f", type=int, default=2)
    p.add_argument("--rounds", type=int, default=32)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--ctx-pad", type=int, default=2048)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--tiny", action="store_true", help="the CPU smoke's geometry")
    p.add_argument("--peak-gbs", type=float, default=HBM_BYTES_PER_S / 1e9,
                   help="the card's memory rate, GB/s (H100 SXM: 3350)")
    p.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile", action="store_true",
                   help="add one replay of each variant under torch.profiler")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)   # "cuda" raises without a card
    t_arch, d_arch, _ = sd_diag.archs(args.tiny, eagle=False)
    t_params, d_params = sd_diag.random_params(
        t_arch, d_arch, dt.DTYPE, device)
    c = make_case(t_params, d_params, t_arch, d_arch, K=args.k, R=args.rounds, F=args.f,
                  ctx_pad=args.ctx_pad, B=args.batch, device=device)
    t_bytes, d_bytes = tensor_bytes(t_params), tensor_bytes(d_params)
    budget = {"full": (c.K + 1) * d_bytes + t_bytes, "sync": (c.K + 1) * d_bytes + t_bytes,
              "build": (c.K + 1) * d_bytes, "verify": t_bytes, "fork": 0}
    fields = device_fields(device)
    print(f"target {t_bytes / 1e9:.2f} GB ({t_arch.num_layers}L), draft {d_bytes / 1e9:.2f} GB "
          f"({d_arch.num_layers}L), fp32 heads included, K={c.K} F={c.F} MQ={c.fan.MQ} "
          f"R={c.R} B={c.B} ctx_pad={args.ctx_pad} on {fields['device']} "
          f"({fields['power_limit']})", flush=True)
    timer = dt.Timer(device, [c.t_gen, c.d_gen])
    out = {"metric": "fasync_round_ms"}
    launches, profiles, equal = {}, {}, None
    for name in args.variants:
        fn = full_variant(c, timer.side) if name == "full" else VARIANTS[name](c)
        m = timer.measure(name, fn, args.reps, reset=c.reset)
        if name == "full" and device.type == "cuda":
            c.reset()
            equal = dt.same(m.outputs, full_variant(c)())
        ms_round = m.ms / c.R
        out[name] = ms_round
        launches[name] = m.launches
        if args.profile:
            profiles[name] = timer.profile(name, c.R)
        line = f"[{name:6s}] {ms_round:7.3f} ms/round"
        if budget[name]:
            gbs = budget[name] / (ms_round / 1e3) / 1e9
            line += (f"  {gbs:6.1f} GB/s vs {budget[name] / 1e9:.2f} GB/round "
                     f"({100 * gbs / args.peak_gbs:.0f}% of peak)")
        print(f"{line}  launches {m.launches}", flush=True)
    timer.release()
    if all(k in out for k in ("full", "build", "verify")):
        out["residual_ms"] = out["full"] - out["build"] - out["verify"]
    if args.profile:
        out["profile"] = profiles
    out.update(fields, launches=launches, full_replay_equals_eager=equal, k=c.K, f=c.F,
               rounds=c.R, batch=c.B, target_bytes=t_bytes, draft_bytes=d_bytes)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
