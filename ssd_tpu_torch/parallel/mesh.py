"""Sharding rules for tensor and expert parallelism.

Counterpart of ssd_tpu/parallel/mesh.py. The JAX package gives each
parameter a NamedSharding over a "tp" mesh axis and lets GSPMD insert the
collectives; here each rank holds its own slice of every parameter and the
forward calls the collectives itself (parallel/comm.py,
models/transformer.py). The rules are `_PARAM_SPECS`'s:

- wq / wk / wv, gate / up: column-parallel (the output axis);
- wo, down: row-parallel (the input axis), followed by an all-reduce;
- the experts' stacks moe_gate / moe_up / moe_down: the expert axis (expert
  parallelism); the router stays whole, so top-k is global;
- embed, lm_head: vocabulary-parallel (rows), when tp divides the
  vocabulary (a reduced draft head's Vd rows, for lm_head); otherwise
  replicated with no gather, as `_compatible_spec` falls back;
- a reduced head's d2t map and head_ids: replicated (JAX's P(None));
- the norms and the router: replicated;
- int8 scales: with their weight's output channels, so wo's and down's
  (their output is the model width) stay whole, computed over the full
  input axis: a tensor is quantized whole and then sharded.

Attention is split by whole heads. `_compatible_spec` shards any axis that
divides, which at tp > Hkv would cut inside a k/v head; a paged kernel
cannot take that. There each rank holds the k/v heads its query heads read
(replicated across the ranks that share them), and so does its KV cache;
JAX's `kv_sharding` replicates the cache in that case too. tp must divide
the query heads and, for a mixture of experts, the experts (a replicated
expert would be summed tp times by the all-reduce), and a rank's query heads
must be whole groups of one k/v head or lie inside one.

Over several hosts (Config.num_hosts > 1) the ranks are the global ranks of
all hosts, host-major (rank h * n + l is local rank l of host h), and
`tp` is num_devices: this is `_compatible_spec` over a ("dcn", "tp") mesh,
which shards a dimension over both axes where their product divides it, so
a 70B's memory spreads over the hosts. Where only the per-host count
divides, JAX falls back to "tp" alone (sharded within a host, replicated
over the hosts); the port keeps one rank axis and takes the rules above
at the global count: an embedding or head whose rows do not divide is
whole on every rank, heads, the MLP width and the experts must divide (a
ValueError names them), and at a global count above Hkv each rank holds
the k/v heads its query heads read, as `kv_sharding` falls back to
replication. At Llama-70B's geometry over 2 hosts x 4 ranks every axis
divides by 8, and each rank's shapes are JAX's per-device shapes
(tests/test_torch_multihost.py).

An EAGLE-3 head's flat dict (models/eagle3.py; ssd_tpu/parallel/mesh.py::
_EAGLE_PARAM_SPECS) takes the same rules through the same names: its
projections column- and row-parallel, its embedding and its reduced head
(Vd rows) vocabulary-parallel, and fc, the norms and d2t replicated (fc
contracts the taps, which are whole on every rank). Its EagleArch gives
the Sharding what a model's Arch does.

Layouts are the port's: float weights [in, out] (expert stacks [E, in,
out]), int8 weights [out, in] ([E, out, in]) beside fp32 scales [out]
([E, out]), embed and lm_head [V, D] in both.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

# Which slice of its axis each sharded leaf takes: attention heads ("q",
# "kv"), the feed-forward width ("ffn"), the experts, the vocabulary.
_COLUMN = {"wq": "q", "wk": "kv", "wv": "kv", "gate": "ffn", "up": "ffn"}
_ROW = {"wo": "q", "down": "ffn"}
_EXPERTS = ("moe_gate", "moe_up", "moe_down")
_VOCAB = ("embed", "lm_head")


@dataclass(frozen=True)
class Sharding:
    """Rank `rank` of `tp` over a model of the full architecture `arch`
    (models/transformer.py::Arch, or an EAGLE-3 head's
    models/eagle3.py::EagleArch)."""

    arch: object
    rank: int
    tp: int

    def __post_init__(self):
        a, tp = self.arch, self.tp
        if not 0 <= self.rank < tp:
            raise ValueError(f"rank {self.rank} outside {tp} ranks")
        if a.num_heads % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks needs the query heads "
                             f"({a.num_heads}) to divide by {tp}")
        if a.num_experts and a.num_experts % tp:
            raise ValueError(f"expert parallelism over {tp} ranks needs the experts "
                             f"({a.num_experts}) to divide by {tp}")
        if not a.num_experts and a.intermediate_size % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks needs the MLP width "
                             f"({a.intermediate_size}) to divide by {tp}")
        n, G = self.heads, a.num_heads // a.num_kv_heads
        if n % G and G % n:
            raise ValueError(f"at tp {tp} a rank's {n} query heads are neither whole "
                             f"groups of one k/v head nor inside one (group size {G})")

    @property
    def heads(self) -> int:
        """The rank's query heads."""
        return self.arch.num_heads // self.tp

    @property
    def kv_heads(self) -> tuple[int, int]:
        """(first, count) of the k/v heads the rank's query heads read."""
        G = self.arch.num_heads // self.arch.num_kv_heads
        return self.rank * self.heads // G, max(1, self.heads // G)

    @property
    def vocab_sharded(self) -> bool:
        """The embedding is split over the ranks by rows."""
        return self.vocab_rows("embed") is not None

    def vocab_rows(self, base: str) -> int | None:
        """Rows of the rank's slice of the embedding or the LM head (a
        reduced head's Vd / tp), or None when that table is replicated."""
        rows = self.arch.head_rows if base == "lm_head" else self.arch.vocab_size
        return rows // self.tp if self.tp > 1 and rows % self.tp == 0 else None

    def span(self, name: str) -> tuple[int, int] | None:
        """[lo, hi) of the rank's slice of `name`'s sharded axis (a weight's
        name; its scales take the same), or None when `name` is
        replicated."""
        a, r = self.arch, self.rank
        base = name[:-len("_scale")] if name.endswith("_scale") else name
        kind = _COLUMN.get(base) or _ROW.get(base)
        if self.tp == 1:
            return None
        if kind == "q":
            return r * self.heads * a.head_dim, (r + 1) * self.heads * a.head_dim
        if kind == "kv":
            lo, n = self.kv_heads
            return lo * a.head_dim, (lo + n) * a.head_dim
        if kind == "ffn":
            w = a.intermediate_size // self.tp
            return r * w, (r + 1) * w
        if base in _EXPERTS:
            e = a.num_experts // self.tp
            return r * e, (r + 1) * e
        if base in _VOCAB and self.vocab_rows(base):
            v = self.vocab_rows(base)
            return r * v, (r + 1) * v
        return None

    def axis(self, name: str, x: torch.Tensor) -> int | None:
        """The dimension of x (the leaf `name` in the port's layout) that
        the rank slices, or None when the leaf is whole on every rank."""
        if self.span(name) is None:
            return None
        base = name[:-len("_scale")] if name.endswith("_scale") else name
        if name.endswith("_scale"):
            # [out] or [E, out]: the output channels, or the experts.
            return 0 if base in _EXPERTS or base in _COLUMN or base in _VOCAB else None
        if base in _EXPERTS or base in _VOCAB:
            return 0
        int8 = x.dtype == torch.int8   # [out, in], else [in, out]
        if base in _COLUMN:
            return x.dim() - 2 if int8 else x.dim() - 1
        return x.dim() - 1 if int8 else x.dim() - 2

    def leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The rank's slice of the whole leaf x, in memory of its own (the
        whole tensor can be dropped after). A leaf that is the rank's
        slice already (the loader reads only the rank's experts) passes as
        it is: at tp > 1 a slice is shorter than the whole axis."""
        dim = self.axis(name, x)
        if dim is None:
            return x
        lo, hi = self.span(name)
        if x.shape[dim] == hi - lo:
            return x
        return x.narrow(dim, lo, hi - lo).contiguous().clone()

    def rank_arch(self, comm=None):
        """The Arch (or EagleArch) of the rank's forward: its query and k/v
        heads and MLP width; the vocabulary, the experts (the router's
        width) and the model width stay the model's."""
        a = self.arch
        over = dict(num_heads=self.heads, num_kv_heads=self.kv_heads[1],
                    tp_size=self.tp, tp_rank=self.rank, comm=comm)
        if not a.num_experts:
            over["intermediate_size"] = a.intermediate_size // self.tp
        return replace(a, **over)


def shard_params(params: dict, sharding: Sharding) -> dict:
    """The rank's parameter dict from a whole one (models/transformer.py
    layout, or an EAGLE-3 head's flat dict, float or int8); a tied head
    stays the embedding's tensor."""
    if "layers" not in params:
        return {k: sharding.leaf(k, v) for k, v in params.items()}
    tied = params["lm_head"] is params["embed"]
    head = ("lm_head", "lm_head_scale") if tied else ()
    out = {k: sharding.leaf(k, v) for k, v in params.items()
           if k != "layers" and k not in head}
    out["layers"] = [{k: sharding.leaf(k, v) for k, v in lp.items()}
                     for lp in params["layers"]]
    for k in head:
        if k in params:
            out[k] = out[k.replace("lm_head", "embed")]
    return out
