"""The collectives of a tensor-parallel engine, and its ranks.

Counterpart of what GSPMD inserts into the JAX package's programs under a
"tp" mesh (ssd_tpu/parallel/mesh.py): the all-reduce after each row-parallel
product, the vocabulary gather of the LM head, plus what a process-per-card
engine needs besides: the smallest KV pool over the ranks, the relay of the
public calls, and a check that every rank emitted the same tokens.

Process model: replicated controllers, the JAX package's multi-host model
(ssd_tpu/engine/llm_engine.py, tests/test_multihost.py). Every rank builds
the same engine over its own shard and runs the same scheduler on the same
inputs, so the only traffic a step is the model's collectives; the
gathered logits and the seeded generators' draws are the same bits on
every rank, and so are the scheduling decisions, none of which reads the
clock or a per-process quantity.

- `connect` gives an engine its Comm, in one of three ways:
  * a caller that has initialised a torch.distributed group of
    Config.world_size ranks gets that group (its backend, its device: the
    current CUDA device, or the CPU), and every such process calls the
    engine identically; over several hosts, rank r is local rank
    r % (num_devices / num_hosts) of host r // (num_devices / num_hosts);
  * with Config.coordinator_address (num_hosts > 1), each host's calling
    process becomes global rank host_id * n, n = num_devices / num_hosts,
    and spawns its n - 1 local ranks, global ranks host_id * n + r on
    cuda:r; every process of every host joins a TCP rendezvous at the
    coordinator (a TCPStore that global rank 0, host 0's caller, serves).
    Through that store the ranks compare their cards: NCCL when every rank
    has a card of its own, gloo on the CPU and where ranks share a card
    (two "hosts" on one card, eagerly). A host that never joins, or dies,
    raises on the others within TIMEOUT;
  * otherwise, for world_size > 1, the caller's process becomes rank 0 and
    spawns ranks 1..N-1 (the spawn start method, entry `worker_main`), over
    NCCL with one card each (cuda:r) or over gloo on the CPU, rendezvousing
    through a FileStore in a temporary directory (no TCP port). With
    num_hosts > 1 this is one machine standing in for the hosts, the
    counterpart of JAX's one-controller emulation of a hybrid mesh: the
    same ranks, groups and collectives as the multi-host run, so the same
    bits.
  At world_size 1 without a group there is no Comm and no collective.
- The process that spawned ranks relays the public calls (add_request,
  step, generate, abort_request, exit) to its own ranks through a pipe each
  and returns the outputs; the others' results are dropped. Over several
  hosts every host's caller calls the engine identically, and each host's
  first process relays to its own ranks only (Comm.lead: the process whose
  caller gets the outputs, the stream and the printed metrics).
- With the unfused async draft split over the hosts
  (Config.draft_split_over_hosts), every process makes one group per local
  index l, the ranks {h * n + l : h}, in the same order; `union_sum` adds
  the hosts' partial draft replies over the rank's own
  (engine/speculator_async.py::union_parts).
- Every collective of a group this module makes has a timeout
  (TIMEOUT), and a process that spawned ranks polls their liveness while
  it waits for their replies, so a dead rank raises there instead of
  hanging it.
- gloo takes CPU tensors: under gloo a CUDA tensor is staged through host
  memory (two processes sharing one card, eagerly; graphs cannot capture a
  gloo collective, so the engine refuses them). NCCL never stages.
- `all_reduce_sum`, `gather_vocab` and `union_sum` count their calls in
  `.launches` (through ops/cuda_lib.py::count_launch, so a CUDA graph's
  replays count the collectives it captured).
- With the unfused async draft on ranks of its own (Config.draft_ranks),
  the group has Config.world_size ranks: the target's tp_size first, then
  one rank per draft replica, spawned like the others (worker_main runs
  parallel/draft_rank.py::serve there, with its pipe as the message link)
  or taken from a caller's group. Every collective of the target then runs
  over a group of the target's ranks only (Comm.group, made by every
  process in the same order), so that no draft rank takes part in one.
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
import shutil
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ssd_tpu_torch.ops import cuda_lib

TIMEOUT = timedelta(seconds=600)
# Torch threads of a spawned rank (the CPU ranks of a test share cores).
WORKER_THREADS = 2

# The live Comm whose ranks this process spawned. Process state, as the
# default process group it made is: a second spawning engine is refused
# while it lives, and a later engine must not take its group for a caller's.
_spawned = None
# Set in a spawned rank: its engine's caller is the relay, not a user.
_in_worker = False


class Comm:
    """One rank's view of the engine's process group: `size` target ranks
    (the default group, or `group` when draft ranks follow them), and the
    global ranks of the draft replicas."""

    def __init__(self, rank: int, size: int, backend: str, device: torch.device,
                 owned: bool = False, workers=(), store_dir: str | None = None,
                 group=None, draft_ranks=(), draft_procs=(), lead: bool = False,
                 per_host: int | None = None, union_group=None):
        self.rank = rank              # the global rank (the target's rank below size)
        self.size = size              # the target's ranks
        self.lead = lead              # its caller gets the outputs (see the notes)
        self.per_host = per_host or size   # ranks a host (Config.ranks_per_host)
        self.union_group = union_group   # the hosts' ranks of this local index
        self.backend = backend
        self.device = device
        self.owned = owned            # made by this engine: destroyed at close
        self.workers = list(workers)  # rank 0 of a spawned group: [(process, pipe)]
        self.store_dir = store_dir
        self.group = group            # the target's ranks, when draft ranks exist
        self.draft_ranks = list(draft_ranks)
        self.draft_procs = list(draft_procs)   # rank 0 of a spawned group
        self.stage = backend == "gloo" and device.type == "cuda"
        self._hash = hashlib.blake2b(digest_size=8)
        self.closed = False

    @property
    def host(self) -> int:
        return self.rank // self.per_host

    @property
    def is_draft(self) -> bool:
        """This process runs a draft replica, not a shard of the target."""
        return self.rank >= self.size

    # --- collectives (over the target's ranks) ---

    def min_over_ranks(self, n: int) -> int:
        t = torch.tensor([n], dtype=torch.int64,
                         device="cpu" if self.backend == "gloo" else self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t.item())

    def warm_up(self):
        """One collective before the first graph capture: NCCL makes its
        communicator at the first call, which a capture cannot hold."""
        self.min_over_ranks(0)
        if self.union_group is not None:
            union_sum(self, torch.zeros(1, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def record_tokens(self, outputs):
        """Add a step's finished outputs [(seq_id, token ids)] to the running
        hash of the tokens this rank emitted."""
        for _, ids in outputs:
            self._hash.update(b"|" + ",".join(map(str, ids)).encode())

    def check_tokens(self):
        """Raise on every rank unless every rank's token hash equals rank
        0's (min and max over the ranks agree)."""
        h = int.from_bytes(self._hash.digest(), "little") >> 2
        lo, hi = self.min_over_ranks(h), -self.min_over_ranks(-h)
        if lo != hi:
            raise RuntimeError(f"rank {self.rank}: the ranks emitted different tokens "
                               "(token hashes differ)")

    # --- relay (rank 0 of a spawned group) ---

    def relay(self, name: str | None, args: tuple, kwargs: dict, local):
        """Send the public call `name` to the other ranks, run it here
        (local()), then wait for their replies; a rank's failure raises
        here, after the local call's own failure if it had one. name None
        sends nothing and waits for the replies to the engine's
        construction."""
        if name == "generate":
            # The other ranks neither show progress nor stream.
            kwargs = {**kwargs, "use_tqdm": False, "stream_callback": None}
        for _, conn in self.workers if name is not None else ():
            conn.send((name, args, kwargs))
        try:
            out = local()
        except BaseException:
            self._replies(raise_errors=False)
            raise
        self._replies()
        return out

    def _replies(self, raise_errors: bool = True):
        errors = []
        for r, (proc, conn) in enumerate(self.workers, start=1):
            while not conn.poll(1.0):
                if not proc.is_alive():
                    errors.append(f"rank {r} died (exit code {proc.exitcode})")
                    break
            else:
                status, info = conn.recv()
                if status != "ok":
                    errors.append(f"rank {r}:\n{info}")
        if errors and raise_errors:
            raise RuntimeError("tensor-parallel ranks failed: " + "\n".join(errors))

    def close(self):
        """Destroy the group if this engine made it and join the spawned
        ranks (idempotent)."""
        global _spawned
        if self.closed:
            return
        self.closed = True
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        for _, conn in self.draft_procs:
            conn.close()   # a draft rank still waiting for a message ends
        for proc, conn in self.workers + self.draft_procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
            conn.close()
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)
        if _spawned is self:
            _spawned = None


def all_reduce_sum(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, on every rank, in x's memory (under gloo
    a CUDA tensor goes through host memory; bf16 is carried as fp32 there
    and rounded once, as NCCL rounds a two-rank sum)."""
    if comm.stage or (comm.backend == "gloo" and x.dtype == torch.bfloat16):
        t = x.float().cpu()
        dist.all_reduce(t, group=comm.group)
        x.copy_(t)
    else:
        dist.all_reduce(x, group=comm.group)
    cuda_lib.count_launch(all_reduce_sum)
    return x


def gather_vocab(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """The ranks' vocabulary slices x [T, V/tp] (rank order) as [T, V] on
    every rank."""
    T, Vl = x.shape
    if comm.backend == "gloo":
        t = x.cpu().contiguous()
        parts = [torch.empty_like(t) for _ in range(comm.size)]
        dist.all_gather(parts, t, group=comm.group)
        out = torch.cat(parts, dim=1).to(x.device)
    else:
        buf = torch.empty(comm.size * T, Vl, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(buf, x.contiguous(), group=comm.group)
        out = buf.view(comm.size, T, Vl).permute(1, 0, 2).reshape(T, comm.size * Vl)
    cuda_lib.count_launch(gather_vocab)
    return out


def broadcast(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """Target rank 0's x on every target rank, in x's memory (a CUDA
    tensor goes through host memory under gloo)."""
    if comm.stage:
        t = x.cpu()
        dist.broadcast(t, 0, group=comm.group)
        x.copy_(t)
    else:
        dist.broadcast(x, 0, group=comm.group)
    return x


def union_sum(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the hosts' ranks of this rank's local index
    (Comm.union_group), in x's memory (through host memory under gloo)."""
    if comm.stage:
        t = x.cpu()
        dist.all_reduce(t, group=comm.union_group)
        x.copy_(t)
    else:
        dist.all_reduce(x, group=comm.union_group)
    cuda_lib.count_launch(union_sum)
    return x


all_reduce_sum.launches = 0
gather_vocab.launches = 0
union_sum.launches = 0


def _device_of(config) -> torch.device:
    device = torch.device(config.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_graphs(config, backend: str, device: torch.device):
    if backend == "gloo" and device.type == "cuda" and not config.enforce_eager:
        raise ValueError("a gloo group cannot be captured into CUDA graphs; pass "
                         "enforce_eager=True (or use an NCCL group)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group needs device='cuda', got {config.device!r}")


def _make_comm(config, rank: int, backend: str, device: torch.device, **kw) -> Comm:
    """The Comm of global rank `rank`. Every process makes here, in the
    same order, the target's group when draft ranks follow it, and the
    hosts' union groups when the async draft is split over the hosts."""
    tp = config.tp_size
    draft = list(range(tp, config.world_size))
    group = dist.new_group(list(range(tp))) if draft else None
    union = None
    if config.draft_split_over_hosts:
        n = config.ranks_per_host
        for local in range(n):
            g = dist.new_group([h * n + local for h in range(config.num_hosts)])
            if rank % n == local:
                union = g
    return Comm(rank, tp, backend, device, group=group, draft_ranks=draft,
                per_host=config.ranks_per_host, union_group=union, **kw)


def _join(init: str, rank: int, size: int, backend: str | None,
          device: torch.device) -> str:
    """Join the engine's group as `rank` of `size` and return its backend:
    through the FileStore of init "file://path" with `backend`, or through
    the TCP rendezvous of init "tcp://host:port" (global rank 0 serves the
    store), where the ranks compare their cards first: NCCL when each has a
    card of its own, else gloo."""
    if init.startswith("file://"):
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=size,
                                timeout=TIMEOUT)
        return backend
    host, _, port = init[len("tcp://"):].rpartition(":")
    store = dist.TCPStore(host, int(port), size, is_master=rank == 0, timeout=TIMEOUT)
    backend = "gloo"
    if device.type == "cuda":
        store.set(f"card/{rank}", str(torch.cuda.get_device_properties(device).uuid))
        if len({store.get(f"card/{r}") for r in range(size)}) == size:
            backend = "nccl"
    dist.init_process_group(backend, store=dist.PrefixStore("group", store), rank=rank,
                            world_size=size, timeout=TIMEOUT)
    return backend


def connect(config, model: str, init_random: bool, kwargs: dict) -> Comm | None:
    """The engine's Comm (see the module's notes), or None: one process
    (Config.world_size 1) and no group of one rank from the caller."""
    global _spawned
    n = config.world_size
    if dist.is_available() and dist.is_initialized():
        if _spawned is not None:
            if n > 1:
                raise RuntimeError("another engine's spawned ranks are alive in this "
                                   "process; exit() it before building one more")
            return None
        if config.coordinator_address is not None:
            raise ValueError("coordinator_address makes the engine join the hosts "
                             "itself; leave it None over a caller's process group")
        size = dist.get_world_size()
        if size != n:
            if n == 1:
                return None
            raise ValueError(f"the engine runs {n} ranks (num_devices={config.num_devices}), "
                             f"but the caller's process group has {size}")
        backend, device, rank = dist.get_backend(), _device_of(config), dist.get_rank()
        _check_graphs(config, backend, device)
        lead = rank % config.ranks_per_host == 0 and not _in_worker
        return _make_comm(config, rank, backend, device, lead=lead)
    if n == 1:
        return None
    device = torch.device(config.device)
    store_dir = None
    if config.coordinator_address is not None:
        # This host's ranks: global ranks first.. on its cuda:0..local-1.
        local = config.ranks_per_host
        first = config.host_id * local
        init, backend = f"tcp://{config.coordinator_address}", None
    else:
        local, first = n, 0
        store_dir = tempfile.mkdtemp(prefix="ssd_tp_")
        init = "file://" + os.path.join(store_dir, "store")
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < local:
            raise RuntimeError(
                f"num_devices={n} needs {local} visible CUDA devices on this host, found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    ctx = mp.get_context("spawn")
    threads = min(WORKER_THREADS, torch.get_num_threads())
    workers, drafts = [], []
    for r in range(1, local):
        parent, child = ctx.Pipe()
        kind = "tp" if first + r < config.tp_size else "draft"
        proc = ctx.Process(target=worker_main, daemon=True, name=f"ssd-{kind}-rank{first + r}",
                           args=(first + r, n, init, backend,
                                 r if device.type == "cuda" else None,
                                 model, init_random, kwargs, child, threads))
        proc.start()
        child.close()
        (workers if kind == "tp" else drafts).append((proc, parent))
    comm = Comm(first, n, backend, device, owned=True, workers=workers + drafts,
                store_dir=store_dir)
    try:
        backend = _join(init, first, n, backend, device)
        _check_graphs(config, backend, device)
        comm = _make_comm(config, first, backend, device, owned=True, workers=workers,
                          draft_procs=drafts, store_dir=store_dir, lead=True)
    except BaseException:
        comm.close()
        raise
    _spawned = comm
    return comm


def worker_main(rank: int, size: int, init: str, backend: str | None, card: int | None,
                model: str, init_random: bool, kwargs: dict, conn, threads: int):
    """Entry of a spawned rank (global rank `rank` on cuda:card, or the CPU
    when card is None): join the group; a target rank builds the engine
    over it, replies to the engine's construction, then serves the relayed
    calls until exit (or until its caller's pipe closes); a draft rank
    serves its draft replica (parallel/draft_rank.py) through its pipe."""
    global _in_worker
    _in_worker = True
    torch.set_num_threads(threads)
    device = torch.device("cpu")
    if card is not None:
        torch.cuda.set_device(card)
        device = torch.device("cuda", card)
    try:
        backend = _join(init, rank, size, backend, device)
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    # The group exists now: the rank's engine takes it as a caller's.
    kwargs = {k: v for k, v in kwargs.items() if k not in ("coordinator_address", "host_id")}
    try:
        from ssd_tpu_torch.config import Config

        config = Config(model, **kwargs)
        if rank >= config.tp_size:
            from ssd_tpu_torch.parallel import draft_rank

            comm = _make_comm(config, rank, backend, _device_of(config))
            draft_rank.serve(comm, config, init_random, conn)
            return
        from ssd_tpu_torch.engine.llm_engine import LLMEngine

        try:
            engine = LLMEngine(model, init_random=init_random, **kwargs)
        except Exception:
            conn.send(("error", traceback.format_exc()))
            return
        conn.send(("ok", None))
        while True:
            try:
                name, args, kw = conn.recv()
            except EOFError:
                return
            try:
                getattr(engine, name)(*args, **kw)
                conn.send(("ok", None))
            except Exception:
                conn.send(("error", traceback.format_exc()))
            if name == "exit":
                return
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
