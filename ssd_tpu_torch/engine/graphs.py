"""One CUDA graph per decode-side step and batch bucket.

Counterpart of the JAX package's one compiled program per step and shape
bucket (ssd_tpu/engine/model_runner.py: jax.jit programs keyed by the batch
bucket B_pad = next_pow2(B); ssd_tpu/engine/llm_engine.py::warmup compiles
them at engine init, the analogue of the reference capturing its CUDA
graphs). A step function of engine/model_runner.py, engine/draft_runner.py,
engine/eagle_runner.py, engine/fused_sd.py or engine/async_fused.py takes
fixed-shape device inputs and reads nothing back to the host, so its whole loop of launches is
captured once per key, (step kind, B_pad[, K or M, R], greedy), and
replayed:

- the inputs are static device buffers, refilled with `copy_` before each
  replay from the host's numpy arrays (B_pad rows) or from device tensors
  (into their leading rows); the outputs are the graph's own buffers, valid
  until the next replay of any graph of the same StepGraphs (a caller that
  keeps one across another replay copies it, or proves the order);
- a StepGraphs is one pool, one capture stream and one side stream, owned
  by one replaying thread: the engine's, and the unfused async draft's own
  (engine/draft_runner.py::DraftServer), so the draft's tree build and the
  target's verify, replayed at the same time on two streams, never share
  memory; its graphs replay on the caller's current stream, one at a time;
- a step with two branches (engine/async_fused.py) forks its tree build
  onto the side stream and joins it back inside the capture, so a replay
  overlaps the branches;
- a capture runs the step once eagerly first, on ghost inputs (tables of
  -1: nothing is written to the KV cache), so that each kernel's first
  launch (cudaFuncSetAttribute, the grouped GEMM's lookup of
  cuTensorMapEncodeTiled) and every workspace allocation happen outside
  the capture; Python's garbage collector is run before and held off
  during the capture (it would destroy an earlier engine's graphs there,
  which invalidates a capture); captures take one process-wide lock and
  the thread-local capture mode, so that a sampled form captured on its
  first use in one thread does not stop another thread's work on the card;
- each step owns its split-KV workspace and counters, one pair per stream
  (ops/attention.py::SplitScratch), sized by that eager run, so no two
  graphs, branches or eager calls on another stream share counters;
- the runners' generators are registered with each graph, so sampled draws
  advance from replay to replay;
- the kernel launches the capture recorded are added to the wrappers'
  counts at every replay (ops/cuda_lib.py::add_launches), and so are the
  collectives of a tensor-parallel step (parallel/comm.py), captured inside
  its graph: a StepGraphs over a Comm runs one collective before its first
  capture (NCCL makes its communicator at the first call), and every rank
  captures the same steps in the same order (the engine's warm-up, and a
  sampled form at the same step of the same replicated schedule).

A failed capture or replay raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import gc
import threading
from time import perf_counter

import numpy as np
import torch

from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops import cuda_lib

_CAPTURE_LOCK = threading.Lock()


def _static(v, device) -> torch.Tensor:
    """A graph's static input buffer holding v (numpy or a device tensor)."""
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


class CapturedStep:
    """One graph with its static inputs, outputs, split-KV scratch and the
    kernel launches of one replay."""

    def __init__(self, graph, inputs: dict, outputs, scratch, launches: dict):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.scratch = scratch
        self.launches = launches


class StepGraphs:
    """One thread's captured steps, keyed by (step kind, B_pad, ...)."""

    def __init__(self, device: torch.device, generators: list[torch.Generator],
                 comm=None):
        if comm is not None:
            comm.warm_up()
        self.device = device
        self.generators = generators
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.side = torch.cuda.Stream(device)   # a two-branch step's second branch
        self.steps: dict[tuple, CapturedStep] = {}
        self.capture_s = 0.0     # seconds spent capturing, eager warm-ups included
        self.pool_bytes = 0      # device memory the captures reserved
        self.replays = 0

    def capture(self, key: tuple, fn, inputs: dict) -> CapturedStep:
        """Capture fn(**inputs) as the graph of `key`; inputs are ghost rows
        (see the module's notes). A key captured before is kept."""
        if key in self.steps:
            return self.steps[key]
        with _CAPTURE_LOCK:
            return self._capture(key, fn, inputs)

    def _capture(self, key: tuple, fn, inputs: dict) -> CapturedStep:
        torch.cuda.synchronize(self.device)
        t0 = perf_counter()
        # Collect now, and not during the capture: a collection there would
        # destroy unreachable graphs of an earlier engine, and destroying a
        # graph while a stream captures invalidates the capture.
        gc.collect()
        torch.cuda.empty_cache()   # as torch.cuda.graph does, so the count sees only growth
        reserved = torch.cuda.memory_reserved(self.device)
        static = {k: _static(v, self.device) for k, v in inputs.items()}
        scratch = att.SplitScratch()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream), att.split_scratch(scratch):
            fn(**static)
        self.stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with att.split_scratch(scratch), cuda_lib.recording_launches() as launches, \
                    torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                     capture_error_mode="thread_local"):
                outputs = fn(**static)
        finally:
            if gc_on:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_s += perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        step = self.steps[key] = CapturedStep(graph, static, outputs, scratch, launches)
        return step

    def run(self, key: tuple, fn, inputs: dict, ghost):
        """Replay the graph of `key` on `inputs` (numpy at the shapes of its
        capture, or device tensors with as many rows or fewer) on the
        current stream, capturing it first from ghost() if this StepGraphs
        has not yet. Returns the graph's outputs."""
        step = self.steps.get(key) or self.capture(key, fn, ghost())
        for k, v in inputs.items():
            if isinstance(v, torch.Tensor):
                step.inputs[k][:v.shape[0]].copy_(v)
            else:
                step.inputs[k].copy_(torch.from_numpy(np.ascontiguousarray(v)),
                                     non_blocking=True)
        step.graph.replay()
        cuda_lib.add_launches(step.launches)
        self.replays += 1
        return step.outputs

    def release(self):
        """Destroy every captured graph (the engine's exit). A graph that
        captured NCCL collectives keeps its communicator in use, and the
        process group's teardown waits for it, so a tensor-parallel
        engine's graphs go before its group."""
        torch.cuda.synchronize(self.device)
        self.steps.clear()

    def summary(self) -> dict:
        """What the captures cost: graphs, seconds, reserved bytes, replays."""
        return dict(graphs=len(self.steps), capture_s=self.capture_s,
                    pool_bytes=self.pool_bytes, replays=self.replays)
