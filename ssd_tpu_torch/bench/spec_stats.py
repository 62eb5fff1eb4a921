"""Statistics that hold a speculative mode's sampling to its reference:
BASELINE.md's gate 2 on per-depth acceptance histograms, and a two-sample
chi-square test on emitted tokens. `chip_smoke.py`'s `sampled` phase and
`tests/test_torch_sampled.py` use them."""

from __future__ import annotations

import collections

import numpy as np
import torch

GATE_MEAN_BOUND = 0.25   # tests/test_spec_stats.py's bound on the means


def accept_histogram(lens, K: int):
    """Frequencies of 0..K accepted draft tokens a verify round, from
    METRICS' accepted suffix lengths (the recovery token included), and the
    number of rounds."""
    a = np.clip(np.asarray(lens, dtype=np.int64) - 1, 0, K)
    h = np.bincount(a, minlength=K + 1)
    return h / max(1, int(h.sum())), int(h.sum())


def histogram_gate(ref, n_ref: int, got, n_got: int) -> dict:
    """BASELINE.md's gate 2 as tests/test_spec_stats.py states it: each
    depth's frequency within max(0.04, 4 sigma) of the reference's, sigma
    the two-sample binomial noise of the smaller run, and the means within
    GATE_MEAN_BOUND."""
    ref, got = np.asarray(ref, float), np.asarray(got, float)
    n = max(1, min(n_ref, n_got))
    p = np.maximum(ref, got)
    tol = np.maximum(0.04, 4.0 * np.sqrt(np.maximum(p * (1 - p), 1e-4) / n) * np.sqrt(2))
    diff = np.abs(ref - got)
    k = np.arange(len(ref))
    mean_diff = abs(float((ref * k).sum() - (got * k).sum()))
    return dict(ok=bool((diff < tol).all() and mean_diff < GATE_MEAN_BOUND),
                rounds=[n_ref, n_got], ref=ref.round(4).tolist(), got=got.round(4).tolist(),
                tol=tol.round(4).tolist(), diff=diff.round(4).tolist(), mean_diff=mean_diff,
                mean_bound=GATE_MEAN_BOUND)


def chi2_two_sample(a, b, min_expected: float = 5.0) -> dict:
    """Pearson's chi-square test that two samples of tokens come from one
    law: the 2 x C table of their counts, where the tokens whose expected
    count in either sample is below min_expected are merged into one bin
    (and that bin into the smallest other one if it is still below).
    Returns the statistic, degrees of freedom, p-value and the bins'
    counts."""
    ca, cb = collections.Counter(a), collections.Counter(b)
    na, nb = len(a), len(b)
    n = na + nb
    bins, other = [], [0, 0]
    for tok in sorted(set(ca) | set(cb)):
        x, y = ca[tok], cb[tok]
        if min(na, nb) * (x + y) / n < min_expected:
            other[0] += x
            other[1] += y
        else:
            bins.append([tok, x, y])
    if other[0] + other[1]:
        if min(na, nb) * sum(other) / n < min_expected and bins:
            small = min(bins, key=lambda r: r[1] + r[2])
            small[1] += other[0]
            small[2] += other[1]
            small[0] = f"{small[0]}+other"
        else:
            bins.append(["other", other[0], other[1]])
    stat = 0.0
    for _, x, y in bins:
        t = x + y
        for obs, tot in ((x, na), (y, nb)):
            e = tot * t / n
            stat += (obs - e) ** 2 / e
    df = len(bins) - 1
    p = 1.0 if df == 0 else float(torch.special.gammaincc(
        torch.tensor(df / 2, dtype=torch.float64), torch.tensor(stat / 2, dtype=torch.float64)))
    return dict(stat=stat, df=df, p=p, n=[na, nb],
                counts=sorted(bins, key=lambda r: -(r[1] + r[2])))


def chi2_excess(pa, pb, n: int) -> float:
    """The two-sample chi-square statistic's expected excess over its
    degrees of freedom when samples of n draws each come from the laws pa
    and pb (vectors over one support): n * sum((pa - pb)^2 / (pa + pb))."""
    pa, pb = np.asarray(pa, float), np.asarray(pb, float)
    s = pa + pb
    m = s > 0
    return float(n * ((pa[m] - pb[m]) ** 2 / s[m]).sum())
