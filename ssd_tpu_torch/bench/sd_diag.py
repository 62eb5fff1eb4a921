"""Fused-SD superstep cost decomposition: where does a round's time go?
The port of bench/sd_diag.py.

Per round the superstep (engine/fused_sd.py::sd_superstep) runs K+1 draft
forwards (K chain steps and the extra write that keeps the K-th token's
KV) and one K+1-query target verify forward. The byte budget of a round is

    (K+1) * draft_bytes + target_bytes

with each model's tensors counted as the runner holds them
(model_runner.py::tensor_bytes), so its LM head counts as the fp32 copy
that it serves (printed apart: the chain pays it at every step to sample
one token). The tool runs three programs, each R rounds as one CUDA graph
(diag_timing.py):

    full    the production sd_superstep (or with --eagle eagle_sd_superstep)
    draft   R rounds of the draft chain alone (model_runner.py::
            chain_decode_step with the extra write; with --eagle
            eagle_runner.py::eagle_chain_step, K+1 conditioned decodes)
    verify  R rounds of the target verify forward alone (decode_step at
            q_len K+1; with --eagle decode_forward with the taps, then the
            last row's sample, as decode_step samples)

and prints ms a round, the implied bandwidth against the byte budget, and
the residual full - draft - verify (verify() math, sampling, the round's
glue) measured rather than guessed. Geometry: Llama-3.2-1B's width, target
16 layers, draft 4 (--eagle: an EAGLE-3 head at the target's width, taps
at layers 2, 8 and 13), B = 1, block 64, tables of --ctx-pad positions,
bf16; --tiny the JAX script's CPU geometry. Weights are random
(seeds 0 and 1). Every row samples at temperature 0.

  python -m ssd_tpu_torch.bench.sd_diag --k 4 --rounds 32 --reps 3 [--eagle]
  python -m ssd_tpu_torch.bench.sd_diag --tiny --device cpu

On the card the full variant's graph replay is also held bit for bit to
the production function called eagerly on the same inputs
(`full_replay_equals_eager` in the JSON line). Runs on "cuda" unless
--device cpu, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass

import numpy as np
import torch

from ssd_tpu_torch.bench import diag_timing as dt
from ssd_tpu_torch.bench.card import HBM_BYTES_PER_S, device_fields
from ssd_tpu_torch.engine import fused_sd
from ssd_tpu_torch.engine.eagle_runner import eagle_chain_step
from ssd_tpu_torch.engine.model_runner import (
    chain_decode_step, decode_forward, decode_step, resolve_device, served_params, tensor_bytes)
from ssd_tpu_torch.models.eagle3 import EagleArch, init_eagle_params
from ssd_tpu_torch.models.transformer import Arch, init_params
from ssd_tpu_torch.ops.sampler import sample

LAYERS = {False: (16, 4), True: (2, 1)}   # tiny -> (target, draft) layers


@dataclass
class Case:
    """One superstep's weights, caches and inputs (row b's table: pages
    b*M+1 .. b*M+M)."""

    t_arch: Arch
    d_arch: Arch | EagleArch
    t_params: dict
    d_params: dict
    t_kv: torch.Tensor
    d_kv: torch.Tensor
    rec0: torch.Tensor          # [B] 7
    n0: torch.Tensor            # [B] 128
    bt: torch.Tensor            # [B, M] both models' tables
    temps: torch.Tensor         # [B] 0
    K: int
    R: int
    t_gen: torch.Generator
    d_gen: torch.Generator
    eagle_layers: tuple | None = None
    acts0: torch.Tensor | None = None   # [B, n_taps * D] 0 (EAGLE)

    @property
    def B(self) -> int:
        return self.rec0.shape[0]

    def reset(self):
        """Both caches back to zeros."""
        self.t_kv.zero_()
        self.d_kv.zero_()


def archs(tiny: bool, eagle: bool):
    """(target Arch, draft Arch or EagleArch, the taps or None)."""
    Lt, Ld = LAYERS[tiny]
    t_mc = dt.model_config(tiny, Lt)
    t_arch = Arch.from_model_config(t_mc)
    if not eagle:
        return t_arch, Arch.from_model_config(dt.model_config(tiny, Ld)), None
    d_arch = EagleArch.from_model_config(t_mc, d_model_target=t_mc.hidden_size,
                                         num_eagle_layers=3)
    return t_arch, d_arch, (min(2, Lt - 1), Lt // 2, max(0, Lt - 3))


def random_params(t_arch, d_arch, dtype, device):
    """Random weights as the engine serves them (seeds 0 and 1)."""
    t = init_params(t_arch, 0, dtype, device)
    d = (init_eagle_params(d_arch, 1, dtype, device) if isinstance(d_arch, EagleArch)
         else init_params(d_arch, 1, dtype, device))
    return served_params(t, None), served_params(d, None)


def make_case(t_params, d_params, t_arch, d_arch, *, K: int, R: int, ctx_pad: int,
              device, eagle_layers=None, B: int = 1) -> Case:
    """Zero caches of B * ctx_pad / 64 + 2 blocks in the target's dtype,
    recovery token 7 at position 128 on every row."""
    M = ctx_pad // dt.BLOCK
    dtype = t_params["layers"][0]["wq"].dtype

    def kv(arch):
        return torch.zeros((arch.num_layers, arch.num_kv_heads, (M * B + 2) * dt.BLOCK,
                            2 * arch.head_dim), dtype=dtype, device=device)

    def gen(seed):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return g

    acts0 = None
    if eagle_layers is not None:
        acts0 = torch.zeros(B, d_arch.act_dim, dtype=torch.float32, device=device)
    return Case(
        t_arch=t_arch, d_arch=d_arch, t_params=t_params, d_params=d_params,
        t_kv=kv(t_arch), d_kv=kv(d_arch),
        rec0=torch.full((B,), 7, dtype=torch.int64, device=device),
        n0=torch.full((B,), 128, dtype=torch.int64, device=device),
        bt=torch.from_numpy(np.arange(B * M, dtype=np.int32).reshape(B, M) + 1).to(device),
        temps=torch.zeros(B, dtype=torch.float32, device=device), K=K, R=R,
        t_gen=gen(2), d_gen=gen(3), eagle_layers=eagle_layers, acts0=acts0)


def full_variant(c: Case):
    """The production superstep; returns its (speculations [R, B, K+1],
    accept_until [R, B], recoveries [R, B][, final taps])."""
    kw = dict(t_arch=c.t_arch, d_arch=c.d_arch, block_size=dt.BLOCK, K=c.K, R=c.R,
              greedy=True)
    if c.eagle_layers is not None:
        return lambda: fused_sd.eagle_sd_superstep(
            c.t_params, c.t_kv, c.d_params, c.d_kv, c.rec0, c.acts0, c.n0, c.bt, c.bt,
            c.temps, c.temps, c.t_gen, c.d_gen, eagle_layers=c.eagle_layers, **kw)
    return lambda: fused_sd.sd_superstep(
        c.t_params, c.t_kv, c.d_params, c.d_kv, c.rec0, c.n0, c.bt, c.bt, c.temps,
        c.temps, c.t_gen, c.d_gen, **kw)


def draft_variant(c: Case):
    """R rounds of the draft chain: the superstep's K+1 decodes a round at
    full acceptance (n += K+1), each round from the last one's final token.
    Returns the final tokens [R, B]."""
    def run():
        rec, n = c.rec0, c.n0
        last = []
        for _ in range(c.R):
            if c.eagle_layers is not None:
                toks, _, _ = eagle_chain_step(
                    c.d_params, c.d_kv, rec, c.acts0, n - 1, c.bt, c.temps, c.d_gen,
                    arch=c.d_arch, block_size=dt.BLOCK, K=c.K + 1, tree_sampling=False,
                    greedy=True)
            else:
                toks, _ = chain_decode_step(
                    c.d_params, c.d_kv, rec, n, c.bt, n + 1, c.temps, c.d_gen,
                    arch=c.d_arch, block_size=dt.BLOCK, K=c.K, extra_write=True, greedy=True)
            rec, n = toks[:, -1], n + c.K + 1
            last.append(rec)
        return torch.stack(last)

    return run


def verify_variant(c: Case):
    """R rounds of the target's K+1-query verify forward over fixed
    speculations (the recovery token K+1 times), n += K+1 a round. Returns
    each round's sampled last-row tokens [R, B] and the last round's logits
    [B*(K+1), V]."""
    Kp1 = c.K + 1
    ar = torch.arange(Kp1, device=c.rec0.device)
    spec = c.rec0[:, None].expand(c.B, Kp1).reshape(-1)
    kw = dict(arch=c.t_arch, block_size=dt.BLOCK, q_len=Kp1)

    def run():
        n, toks = c.n0, []
        for _ in range(c.R):
            pos = (n[:, None] + ar).reshape(-1)
            if c.eagle_layers is not None:
                lg, _ = decode_forward(c.t_params, c.t_kv, spec, pos, c.bt, n + Kp1,
                                       eagle_layers=c.eagle_layers, **kw)
                tok = sample(lg.reshape(c.B, Kp1, -1)[:, -1], c.temps, c.t_gen, greedy=True)
            else:
                tok, lg = decode_step(c.t_params, c.t_kv, spec, pos, c.bt, n + Kp1, c.temps,
                                      c.t_gen, greedy=True, **kw)
            n = n + Kp1
            toks.append(tok)
        return torch.stack(toks), lg

    return run


VARIANTS = {"full": full_variant, "draft": draft_variant, "verify": verify_variant}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--rounds", type=int, default=32)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--ctx-pad", type=int, default=2048)
    p.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    p.add_argument("--tiny", action="store_true", help="the CPU smoke's geometry")
    p.add_argument("--peak-gbs", type=float, default=HBM_BYTES_PER_S / 1e9,
                   help="the card's memory rate, GB/s (H100 SXM: 3350)")
    p.add_argument("--eagle", action="store_true",
                   help="decompose the fused EAGLE superstep instead: the one-layer "
                        "conditioned draft chain (K+1 steps incl. the extra write) + "
                        "the verify forward with taps")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile", action="store_true",
                   help="add one replay of each variant under torch.profiler")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)   # "cuda" raises without a card
    t_arch, d_arch, taps = archs(args.tiny, args.eagle)
    t_params, d_params = random_params(t_arch, d_arch, dt.DTYPE, device)
    c = make_case(t_params, d_params, t_arch, d_arch, K=args.k, R=args.rounds,
                  ctx_pad=args.ctx_pad, device=device, eagle_layers=taps)
    t_bytes = tensor_bytes(t_params)
    # The EAGLE head streams its layer and head a step; its embedding is a
    # row gather and fc runs once a round on the carried taps.
    d_bytes = tensor_bytes({k: v for k, v in d_params.items()
                            if not (args.eagle and k in ("embed", "fc"))})
    heads = {"target_head_bytes": tensor_bytes(t_params["lm_head"]),
             "draft_head_bytes": tensor_bytes(d_params["lm_head"])}
    budget = {"full": (c.K + 1) * d_bytes + t_bytes, "draft": (c.K + 1) * d_bytes,
              "verify": t_bytes}
    fields = device_fields(device)
    d_desc = "EAGLE 1L streamed (layer + head)" if args.eagle else f"{d_arch.num_layers}L"
    print(f"target {t_bytes / 1e9:.2f} GB ({t_arch.num_layers}L, fp32 head "
          f"{heads['target_head_bytes'] / 1e9:.2f} GB), draft {d_bytes / 1e9:.2f} GB "
          f"({d_desc}, fp32 head {heads['draft_head_bytes'] / 1e9:.2f} GB), K={c.K} R={c.R} "
          f"ctx_pad={args.ctx_pad} on {fields['device']} ({fields['power_limit']})",
          flush=True)
    timer = dt.Timer(device, [c.t_gen, c.d_gen])
    out = {"metric": "sd_round_ms"}
    launches, profiles, equal = {}, {}, None
    for name in args.variants:
        m = timer.measure(name, VARIANTS[name](c), args.reps, reset=c.reset)
        if name == "full" and device.type == "cuda":
            c.reset()
            equal = dt.same(m.outputs, full_variant(c)())
        ms_round = m.ms / c.R
        out[name] = ms_round
        launches[name] = m.launches
        if args.profile:
            profiles[name] = timer.profile(name, c.R)
        gbs = budget[name] / (ms_round / 1e3) / 1e9
        print(f"[{name:6s}] {ms_round:7.3f} ms/round  {gbs:6.1f} GB/s vs "
              f"{budget[name] / 1e9:.2f} GB/round budget ({100 * gbs / args.peak_gbs:.0f}% "
              f"of peak)  launches {m.launches}", flush=True)
    timer.release()
    if all(k in out for k in VARIANTS):
        out["residual_ms"] = out["full"] - out["draft"] - out["verify"]
    if args.profile:
        out["profile"] = profiles
    out.update(fields, launches=launches, full_replay_equals_eager=equal, k=c.K, rounds=c.R,
               eagle=args.eagle, target_bytes=t_bytes, draft_bytes=d_bytes, **heads)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
