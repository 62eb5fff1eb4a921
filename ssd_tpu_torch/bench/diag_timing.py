"""What the step-decomposition tools (sd_diag, fasync_diag, prefill_diag)
share: their geometries and the timer that runs a variant as the engine runs a step.

A variant is a callable that runs its R rounds (or R prefills) on tensors
it closes over and returns its outputs. On "cuda", `Timer.measure` captures
it once as one CUDA graph through engine/graphs.py::StepGraphs (the
runners' generators registered, as the engine registers them; the eager
run before the capture warms every kernel), replays the graph once
untimed, reads the kernel wrappers' launch counts of that replay
(ops/cuda_lib.py), then times --reps replays with CUDA events and keeps the
least. No L2 flush: one round streams at least 1 GB of weights. On "cpu"
it runs the callable eagerly instead (the tests; host time, no launches).
`Timer.profile` (the tools' --profile) adds one replay under
torch.profiler: the kernel time a round per stream, and the kernels that
take the most of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from time import perf_counter

import torch

from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.ops import attention as att

# Llama-3.2-1B's width (the JAX tools' geometry, 4096 positions; also
# chip_smoke.py's LLAMA_1B, which adds its depth, a tied head and eos), and
# the tiny one of their CPU smokes.
LLAMA_1B_WIDTH = dict(model_type="llama", vocab_size=128256, hidden_size=2048,
                      intermediate_size=8192, num_attention_heads=32, num_key_value_heads=8,
                      head_dim=64, max_position_embeddings=4096, rope_theta=500000.0,
                      rms_norm_eps=1e-5)
TINY_WIDTH = dict(model_type="llama", vocab_size=512, hidden_size=128, intermediate_size=256,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                  max_position_embeddings=4096, rope_theta=500000.0, rms_norm_eps=1e-5)
BLOCK = 64
DTYPE = torch.bfloat16   # the tools' weights and caches, as the JAX tools'

# The attention kernels a decomposition names (ops/attention.py's wrappers).
KERNELS = {"K1": att.flat_prefill_attention, "K2": att.paged_attention,
           "K3": att.tree_attention}


def model_config(tiny: bool, layers: int) -> ModelConfig:
    return ModelConfig(num_hidden_layers=layers, **(TINY_WIDTH if tiny else LLAMA_1B_WIDTH))


def same(a, b) -> bool:
    """a and b (tensors, or tuples or lists of them) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype \
            and torch.equal(a, b)
    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def launch_counts() -> dict:
    return {k: w.launches for k, w in KERNELS.items()}


def stream_busy(prof) -> dict:
    """Kernel time per CUDA stream in a torch.profiler profile, the union
    over streams, and the time two streams ran kernels at once (sum minus
    union), in ms."""
    from torch.autograd import DeviceType

    def merge(xs):
        out = []
        for a, b in sorted(xs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per.setdefault(str(getattr(e, "device_resource_id", 0)), []).append(
                (e.time_range.start, e.time_range.end))
    busy = {k: sum(b - a for a, b in merge(v)) / 1e3 for k, v in per.items()}
    union = sum(b - a for a, b in merge([x for v in per.values() for x in v])) / 1e3
    return dict(per_stream_ms=busy, union_ms=union, concurrent_ms=sum(busy.values()) - union)


@dataclass
class Measured:
    ms: float           # least time of one run (R rounds or prefills)
    outputs: object     # its outputs: on the card the graph's own buffers
    launches: dict      # {"K1": n, "K2": n, "K3": n} of one run (0 on the CPU)


class Timer:
    """One StepGraphs for a tool's variants on the card; none on the CPU."""

    def __init__(self, device: torch.device, generators=()):
        from ssd_tpu_torch.engine.graphs import StepGraphs

        self.device = device
        self.graphs = (StepGraphs(device, list(generators)) if device.type == "cuda"
                       else None)

    @property
    def side(self) -> torch.cuda.Stream | None:
        """The side stream a two-branch step forks onto under graphs."""
        return None if self.graphs is None else self.graphs.side

    def measure(self, name: str, fn, reps: int, reset=None) -> Measured:
        """fn's least time over `reps` runs after one untimed run; `reset()`
        (outside the graph) runs first, so the untimed run starts from the
        state an eager call of fn would be given."""
        g = self.graphs
        if g is None:
            if reset is not None:
                reset()
            out = fn()
            times = []
            for _ in range(reps):
                t0 = perf_counter()
                fn()
                times.append((perf_counter() - t0) * 1e3)
            return Measured(min(times), out, {k: 0 for k in KERNELS})
        key = ("diag", name)
        g.capture(key, fn, {})
        if reset is not None:
            reset()
        before = launch_counts()
        out = g.run(key, fn, {}, dict)
        launches = {k: n - before[k] for k, n in launch_counts().items()}
        pairs = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.run(key, fn, {}, dict)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(self.device)
        return Measured(min(a.elapsed_time(b) for a, b in pairs), out, launches)

    def profile(self, name: str, rounds: int, top: int = 8) -> dict | None:
        """One more replay of `name`'s graph under torch.profiler, in ms a
        round: each stream's kernel time, their union, the time two
        streams ran kernels at once, kernels a round and the `top` kernels
        by device time (None on the CPU)."""
        if self.graphs is None:
            return None
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.graphs.run(("diag", name), None, {}, dict)
            torch.cuda.synchronize(self.device)
        busy = stream_busy(prof)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        best = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]
        return dict(per_stream_ms={k: v / rounds for k, v in busy["per_stream_ms"].items()},
                    union_ms=busy["union_ms"] / rounds,
                    concurrent_ms=busy["concurrent_ms"] / rounds,
                    kernels=sum(e.count for e in kernels) / rounds,
                    top_kernels=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3 / rounds,
                                      calls=e.count / rounds) for e in best])

    def release(self):
        if self.graphs is not None:
            self.graphs.release()
