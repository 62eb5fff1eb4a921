"""Fused multi-round synchronous speculative decoding, and ngram speculation.

Counterpart of ssd_tpu/engine/fused_sd.py (sd_superstep,
eagle_sd_superstep, ngram_propose, ngram_superstep, _superstep_rows,
_collect_rounds, run_sd_superstep, run_eagle_sd_superstep,
run_ngram_superstep). One round is [draft chain -> target verify forward ->
verify() -> advance]; R rounds run back to back with both KV caches updated
in place, and the token history (ngram) or the EAGLE-3 head's conditioning
taps on the device, and nothing is read back until the last round. The JAX
package scans the rounds inside one program; here each (B_pad, R) is one
CUDA graph on the card (engine/graphs.py) and an eager loop on the CPU. Token-level semantics are the
unfused path's: greedy outputs are token-exact against it, and EOS /
max-token overshoot is truncated on the host and rolled back by the
scheduler, as for AR multi-step.

Not ported: the `*_packed` variants (a TPU upload workaround).
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.engine.eagle_runner import eagle_chain_step
from ssd_tpu_torch.engine.model_runner import (
    chain_decode_step, decode_forward, next_pow2)
from ssd_tpu_torch.models.eagle3 import EagleArch
from ssd_tpu_torch.models.transformer import Arch
from ssd_tpu_torch.ops.verify import verify


def sd_superstep(
    t_params, target_kv,
    d_params, draft_kv,
    rec0: torch.Tensor,        # [B] current recovery token per sequence
    n0: torch.Tensor,          # [B] committed tokens (the chain writes rec at n0)
    bt_target: torch.Tensor,   # [B, M]
    bt_draft: torch.Tensor,    # [B, M]
    temps_t: torch.Tensor,     # [B]
    temps_d: torch.Tensor,     # [B]
    t_generator: torch.Generator | None,
    d_generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    t_arch: Arch,
    d_arch: Arch,
    block_size: int,
    K: int,
    R: int,
    t_s8: bool = False,
    d_s8: bool = False,
    greedy: bool = False,
):
    """R rounds of [draft chain -> verify forward -> verify() -> advance].
    The draft samples with d_generator, verify() draws with t_generator, as
    in the unfused path. Returns (speculations [R, B, K+1], accept_until
    [R, B], recoveries [R, B]): round r of sequence b contributed
    speculations[r, b, :accept_until[r, b] + 1], and its next recovery
    token is recoveries[r, b]."""
    B = rec0.shape[0]
    Kp1 = K + 1
    ar = torch.arange(Kp1, device=rec0.device)
    hits = torch.ones(B, dtype=torch.int64, device=rec0.device)
    rec, n = rec0.long(), n0.long()
    specs, accs, recs = [], [], []
    for _ in range(R):
        d_tokens, logits_q = chain_decode_step(
            d_params, draft_kv, rec, n, bt_draft, n + 1, temps_d, d_generator,
            top_ps, top_ks, arch=d_arch, block_size=block_size, K=K,
            extra_write=True, s8=d_s8, greedy=greedy)
        spec = torch.cat([rec[:, None], d_tokens], dim=1)          # [B, K+1]
        logits_p = decode_forward(
            t_params, target_kv, spec.reshape(-1), (n[:, None] + ar).reshape(-1),
            bt_target, n + Kp1, arch=t_arch, block_size=block_size, q_len=Kp1,
            s8=t_s8)
        # cache_hits = all ones: the chain tokens are real samples of q, so
        # ratio acceptance applies (speculator_sync.py).
        acc, rec = verify(logits_p.reshape(B, Kp1, -1), logits_q, spec, temps_t,
                          temps_d, hits, t_generator, top_p=top_ps, top_k=top_ks,
                          greedy=greedy)
        n = n + acc + 1
        specs.append(spec)
        accs.append(acc)
        recs.append(rec)
    return torch.stack(specs), torch.stack(accs), torch.stack(recs)


def eagle_sd_superstep(
    t_params, target_kv,
    d_params, draft_kv,
    rec0: torch.Tensor,        # [B] current recovery token per sequence
    acts0: torch.Tensor,       # [B, n_taps*D_target] taps at the last committed position
    n0: torch.Tensor,          # [B] committed tokens (rec sits at n0)
    bt_target: torch.Tensor,   # [B, M]
    bt_draft: torch.Tensor,    # [B, M]
    temps_t: torch.Tensor,     # [B]
    temps_d: torch.Tensor,     # [B]
    t_generator: torch.Generator | None,
    d_generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    t_arch: Arch,
    d_arch: EagleArch,
    block_size: int,
    K: int,
    R: int,
    eagle_layers: tuple[int, ...],
    t_s8: bool = False,
    d_s8: bool = False,
    greedy: bool = False,
):
    """R rounds of [EAGLE chain -> verify forward with taps -> verify() ->
    advance]. The chain is K+1 conditioned decodes (the last writes the K-th
    token's KV): the first on fc of the carried taps, then each on the
    previous step's prenorm, from draft position n - 1 (the EAGLE shift).
    The taps at row accept_until of the verify (the last accepted token's)
    condition the next round, in fp32. Returns as sd_superstep, plus the
    final taps [B, n_taps*D_target]."""
    B = rec0.shape[0]
    Kp1 = K + 1
    dev = rec0.device
    ar = torch.arange(Kp1, device=dev)
    b_idx = torch.arange(B, device=dev)
    hits = torch.ones(B, dtype=torch.int64, device=dev)
    rec, acts, n = rec0.long(), acts0.float(), n0.long()
    specs, accs, recs = [], [], []
    for _ in range(R):
        d_tokens, logits_q, _ = eagle_chain_step(
            d_params, draft_kv, rec, acts, n - 1, bt_draft, temps_d, d_generator, top_ps,
            top_ks, arch=d_arch, block_size=block_size, K=K, extra_write=True,
            tree_sampling=False, s8=d_s8, greedy=greedy)
        spec = torch.cat([rec[:, None], d_tokens], dim=1)          # [B, K+1]
        logits_p, taps = decode_forward(
            t_params, target_kv, spec.reshape(-1), (n[:, None] + ar).reshape(-1),
            bt_target, n + Kp1, arch=t_arch, block_size=block_size, q_len=Kp1,
            s8=t_s8, eagle_layers=eagle_layers)
        acc, rec = verify(logits_p.reshape(B, Kp1, -1), logits_q, spec, temps_t,
                          temps_d, hits, t_generator, top_p=top_ps, top_k=top_ks,
                          greedy=greedy)
        acts = taps.reshape(B, Kp1, -1)[b_idx, acc].float()
        n = n + acc + 1
        specs.append(spec)
        accs.append(acc)
        recs.append(rec)
    return torch.stack(specs), torch.stack(accs), torch.stack(recs), acts


def ngram_propose(hist: torch.Tensor, n: torch.Tensor, rec: torch.Tensor, *,
                  N: int, K: int) -> torch.Tensor:
    """Prompt-lookup proposal: for each row, find the most recent earlier
    occurrence of the last N tokens (hist[n-N+1..n], rec already written at
    slot n) inside the committed prefix and return the K tokens that
    followed it, reading no further than slot n; rows with no match repeat
    rec. hist [B, H] int, n [B] (committed, rec at slot n), rec [B]."""
    B, H = hist.shape
    W = H - N   # candidate window starts
    dev = hist.device
    n = n.long()
    gram = hist.gather(1, (n[:, None] - (N - 1) + torch.arange(N, device=dev)).clamp(0, H - 1))
    match = torch.ones(B, W, dtype=torch.bool, device=dev)
    for j in range(N):
        match &= hist[:, j:j + W] == gram[:, j:j + 1]
    s_range = torch.arange(W, device=dev)[None, :]
    # The continuation starts inside the committed prefix (s + N <= n),
    # which also excludes the trivial self-match at s = n - N + 1.
    valid = (s_range <= (n - N)[:, None]) & (n >= N)[:, None]
    s_star = torch.where(match & valid, s_range, -1).amax(dim=1)
    prop_idx = torch.minimum((s_star[:, None] + N + torch.arange(K, device=dev)).clamp(min=0),
                             n.clamp(0, H - 1)[:, None])
    props = hist.gather(1, prop_idx)
    return torch.where((s_star >= 0)[:, None], props, rec[:, None].to(hist.dtype))


def ngram_superstep(
    t_params, target_kv,
    hist0: torch.Tensor,       # [B, H] committed tokens (junk beyond n0)
    rec0: torch.Tensor,        # [B] pending recovery token
    n0: torch.Tensor,          # [B] committed tokens (rec not yet appended)
    bt_target: torch.Tensor,   # [B, M]
    temps_t: torch.Tensor,     # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    t_arch: Arch,
    block_size: int,
    N: int,
    K: int,
    R: int,
    s8: bool = False,
    greedy: bool = False,
):
    """Model-free speculation, R rounds: each round proposes K tokens by
    matching the last N committed tokens against the row's own history,
    then runs sd_superstep's verify forward and verify() with q the
    proposal's one-hot (ratio acceptance is exactly p(token); greedy rows
    take the greedy compare), so outputs are token-exact against AR. The
    history is a copy of hist0 updated on the device. Returns as
    sd_superstep."""
    B, H = hist0.shape
    Kp1 = K + 1
    dev = hist0.device
    b_idx = torch.arange(B, device=dev)
    ar = torch.arange(Kp1, device=dev)
    zeros = torch.zeros(B, dtype=torch.float32, device=dev)
    hits = torch.ones(B, dtype=torch.int64, device=dev)
    hist = hist0.clone()
    rec, n = rec0.long(), n0.long()
    specs, accs, recs = [], [], []
    for _ in range(R):
        hist[b_idx, n.clamp(0, H - 1)] = rec.to(hist.dtype)
        props = ngram_propose(hist, n, rec, N=N, K=K).long()        # [B, K]
        spec = torch.cat([rec[:, None], props], dim=1)              # [B, K+1]
        logits_p = decode_forward(
            t_params, target_kv, spec.reshape(-1), (n[:, None] + ar).reshape(-1),
            bt_target, n + Kp1, arch=t_arch, block_size=block_size, q_len=Kp1, s8=s8)
        logits_q = torch.nn.functional.one_hot(props, t_arch.vocab_size).float()
        acc, rec = verify(logits_p.reshape(B, Kp1, -1), logits_q, spec, temps_t,
                          zeros, hits, generator, top_p=top_ps, top_k=top_ks,
                          greedy=greedy)
        # Proposals past the accepted length are junk in the history, but
        # they sit past the next round's n, where the matcher never reads.
        hist[b_idx[:, None], (n[:, None] + 1 + ar[:K]).clamp(0, H - 1)] = props.to(hist.dtype)
        n = n + acc + 1
        specs.append(spec)
        accs.append(acc)
        recs.append(rec)
    return torch.stack(specs), torch.stack(accs), torch.stack(recs)


def _superstep_rows(seqs, target_runner, draft_runner, B_pad: int) -> dict:
    """Host inputs of a superstep at the batch bucket: recovery tokens,
    committed counts, temperatures and block tables (ghost rows: rec 0, n0 1,
    temperature 0, table -1) and, with the top-p/top-k warp, its columns."""
    for seq in seqs:
        assert seq.recovery_token_id is not None
    t = target_runner
    inputs = t._rows(
        B_pad,
        rec0=(np.asarray([s.recovery_token_id for s in seqs], np.int32), 0),
        n0=(np.asarray([s.num_tokens for s in seqs], np.int32), 1),
        bt_target=(t._block_table_array(seqs), -1),
        temps_t=(np.asarray([s.temperature for s in seqs], np.float32), 0.0))
    if draft_runner is not None:
        inputs.update(t._rows(
            B_pad, bt_draft=(draft_runner._block_table_array(seqs), -1),
            temps_d=(draft_runner._temperatures(seqs), 0.0)))
    if t.use_warp:
        w = t._sampling_inputs(B_pad, np.zeros(len(seqs), np.float32), *t._seq_warp(seqs))
        inputs.update(top_ps=w["top_ps"], top_ks=w["top_ks"])
    return inputs


def _collect_rounds(specs, accs, recs, B, R):
    """Per-sequence committed suffixes (accepted tokens + recovery per
    round, concatenated), final recovery tokens, and per-round lengths for
    the acceptance metrics."""
    suffixes, final_rec, per_round_lens = [], [], []
    for b in range(B):
        out, lens = [], []
        for r in range(R):
            a = int(accs[r, b])
            out.extend(int(x) for x in specs[r, b, :a + 1])
            lens.append(a + 1)
        suffixes.append(out)
        per_round_lens.append(lens)
        final_rec.append(int(recs[R - 1, b]))
    return suffixes, final_rec, per_round_lens


def _greedy(inputs: dict) -> bool:
    """No row samples: every temperature 0 (ghost rows have 0)."""
    return not any((inputs[k] > 0).any() for k in ("temps_t", "temps_d") if k in inputs)


def sd_call(target_runner, draft_runner, seqs, K: int, R: int, B_pad: int):
    """The sync-SD superstep as a step call (model_runner.py: key, fn,
    inputs, ghost) over seqs at bucket B_pad; no seqs: ghost rows only."""
    t, d = target_runner, draft_runner
    inputs = _superstep_rows(seqs, t, d, B_pad)
    greedy = _greedy(inputs)

    def fn(rec0, n0, bt_target, bt_draft, temps_t, temps_d, top_ps=None, top_ks=None):
        return sd_superstep(
            t.params, t.kv_cache, d.params, d.kv_cache, rec0, n0, bt_target, bt_draft,
            temps_t, temps_d, t.generator, d.generator, top_ps, top_ks,
            t_arch=t.arch, d_arch=d.arch, block_size=t.block_size, K=K, R=R,
            t_s8=t.s8, d_s8=d.s8, greedy=greedy)

    return (("sd", B_pad, K, R, greedy), fn, inputs,
            lambda: _superstep_rows([], t, d, B_pad))


def eagle_call(target_runner, draft_runner, seqs, K: int, R: int, B_pad: int):
    """The fused EAGLE superstep as a step call over seqs at bucket B_pad,
    conditioned on each sequence's last_target_hidden_state (ghost rows:
    taps 0); no seqs: ghost rows only."""
    t, d = target_runner, draft_runner
    A = d.arch.act_dim

    def rows(seqs):
        inputs = _superstep_rows(seqs, t, d, B_pad)
        acts = torch.stack([s.last_target_hidden_state for s in seqs]) if seqs else None
        inputs["acts0"] = t._device_rows(B_pad, acts, (A,), torch.float32)
        return inputs

    inputs = rows(seqs)
    greedy = _greedy(inputs)

    def fn(rec0, acts0, n0, bt_target, bt_draft, temps_t, temps_d, top_ps=None, top_ks=None):
        return eagle_sd_superstep(
            t.params, t.kv_cache, d.params, d.kv_cache, rec0, acts0, n0, bt_target, bt_draft,
            temps_t, temps_d, t.generator, d.generator, top_ps, top_ks, t_arch=t.arch,
            d_arch=d.arch, block_size=t.block_size, K=K, R=R, eagle_layers=t.eagle_layers,
            t_s8=t.s8, d_s8=d.s8, greedy=greedy)

    return ("eagle_sd", B_pad, K, R, greedy), fn, inputs, lambda: rows([])


def ngram_width(target_runner, K: int, R: int) -> int:
    """The history's width H: every slot a superstep can write (up to
    max_model_len + R * (K+1)), so the matcher sees the whole committed
    prefix, as the JAX package's context bucket does."""
    return target_runner.max_blocks * target_runner.block_size + R * (K + 1) + 1


def ngram_call(target_runner, seqs, N: int, K: int, R: int, B_pad: int):
    """The ngram superstep as a step call over seqs at bucket B_pad, with
    each sequence's tokens as its history (zeros past them)."""
    t = target_runner
    H = ngram_width(t, K, R)

    def rows(seqs):
        inputs = _superstep_rows(seqs, t, None, B_pad)
        hist = np.zeros((B_pad, H), np.int32)
        for i, seq in enumerate(seqs):
            ids = seq.token_ids[:H]
            hist[i, :len(ids)] = ids
        inputs["hist0"] = hist
        return inputs

    inputs = rows(seqs)
    greedy = _greedy(inputs)

    def fn(hist0, rec0, n0, bt_target, temps_t, top_ps=None, top_ks=None):
        return ngram_superstep(
            t.params, t.kv_cache, hist0, rec0, n0, bt_target, temps_t, t.generator,
            top_ps, top_ks, t_arch=t.arch, block_size=t.block_size, N=N, K=K, R=R,
            s8=t.s8, greedy=greedy)

    return ("ngram", B_pad, N, K, R, greedy), fn, inputs, lambda: rows([])


def _run(target_runner, call, B: int, R: int):
    """The host's side: one replay (or eager loop) and one readback for R
    rounds. Returns (suffixes list[B] of list[int], accepted tokens +
    recovery per round concatenated across rounds; final recovery tokens
    list[B]; per-round lengths list[B] of list[int]). The caller truncates
    for EOS / max_new_tokens and commits via
    scheduler.postprocess_speculate."""
    specs, accs, recs = (x.cpu().numpy() for x in target_runner.run_step(*call))
    return _collect_rounds(specs, accs, recs, B, R)


def run_sd_superstep(target_runner, draft_runner, seqs, K: int, R: int):
    return _run(target_runner, sd_call(target_runner, draft_runner, seqs, K, R,
                                       next_pow2(len(seqs))), len(seqs), R)


def run_eagle_sd_superstep(target_runner, draft_runner, seqs, K: int, R: int):
    """As run_sd_superstep; also sets each sequence's
    last_target_hidden_state to its final taps (the next superstep's
    conditioning), copied out of the step's output. A sequence truncated by
    EOS or max_new_tokens is finished, so its taps are never read."""
    B = len(seqs)
    specs, accs, recs, acts = target_runner.run_step(*eagle_call(
        target_runner, draft_runner, seqs, K, R, next_pow2(B)))
    for seq, a in zip(seqs, acts[:B].clone()):
        seq.last_target_hidden_state = a
    specs, accs, recs = (x.cpu().numpy() for x in (specs, accs, recs))
    return _collect_rounds(specs, accs, recs, B, R)


def run_ngram_superstep(target_runner, seqs, N: int, K: int, R: int):
    return _run(target_runner, ngram_call(target_runner, seqs, N, K, R,
                                          next_pow2(len(seqs))), len(seqs), R)
