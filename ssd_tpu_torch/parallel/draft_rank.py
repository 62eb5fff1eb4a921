"""The unfused async draft on ranks of its own (Config.draft_ranks > 0).

Counterpart of the JAX package's draft replicas on the last draft_dp devices
(ssd_tpu/engine/draft_runner.py::DraftServer, `devices[-dp:]`; the
reference's num_tp = num_gpus - 1 split): the target runs on ranks
0..tp_size-1 (parallel/comm.py), and draft replica r runs a DraftRunner in
a process of its own, rank tp_size + r, on its own card (cuda:tp_size + r
when the engine spawned its ranks), so its host loop never shares the
target's interpreter and its tree build runs while the target verifies.

Exchange, target rank 0 <-> each draft rank:
- messages: (command, numpy payload) pickled through the spawn pipe of a
  rank the engine spawned (no timeout while the engine is idle; rank 0
  polls the rank's liveness while it waits), or by torch.distributed's
  object send/recv in a caller's group;
- a request carries the rows seq_id % draft_dp == r: the cache keys,
  num_tokens, draft block tables, temperatures and the warp's columns, or
  a prefill's prompts and tables;
- the reply carries hits and tokens, then the logits [rows, K, V] fp32 as
  one point-to-point tensor (NCCL between cards, with no host copy; gloo
  through host memory on the CPU and on one card);
- the draft rank replies before it builds its next tree, as the thread of
  engine/draft_runner.py does;
- rank 0 sends every replica its rows before it waits for any reply, and
  broadcasts the assembled reply to the other target ranks over the
  target's group, so the replicated controllers stay identical.

Each draft rank sizes its KV pool from its own card (or takes
num_kvcache_blocks), reports the count before the first request, and the
target's scheduler takes the smallest over the ranks. A draft rank's
failure reaches every target rank as RuntimeError("draft server died"):
the rank answers each later request with its traceback, and a dead
process raises at rank 0 (gloo's closed connection, or the liveness poll
of a spawned rank). Each draft rank counts its kernel launches in its own
process (ops/cuda_lib.py::count_launch) and returns the counts since the
last `drain()` at `drain()` and at exit. On a card that is not eager it
replays its tree build and miss chain from CUDA graphs of its own
(engine/graphs.py), captured before it reports its pool; a tree build has
no collective.
"""

from __future__ import annotations

import traceback
from time import perf_counter

import numpy as np
import torch
import torch.distributed as dist

from ssd_tpu_torch.engine.draft_runner import SpecRequest, SpecResponse, replica_rows


def _launch_wrappers() -> tuple:
    """The kernel wrappers whose launches a draft rank reports."""
    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops import linear, moe

    return att.KERNEL_WRAPPERS + (moe.grouped_gemm, linear.int8_linear)


def _take_launches() -> dict:
    """{wrapper name: launches} since the last call, zeroing the counts."""
    out = {}
    for w in _launch_wrappers():
        out[w.__name__], w.launches = w.launches, 0
    return out


class RemoteError(Exception):
    """A draft rank's exception, with its traceback as the message."""


class _Link:
    """Messages with one peer: through a spawn pipe (conn) or as pickled
    objects over torch.distributed point-to-point."""

    def __init__(self, peer: int, conn=None, proc=None):
        self.peer, self.conn, self.proc = peer, conn, proc

    def send(self, obj):
        if self.conn is not None:
            self.conn.send(obj)
        else:
            dist.send_object_list([obj], dst=self.peer)

    def recv(self):
        if self.conn is None:
            box = [None]
            dist.recv_object_list(box, src=self.peer)
            return box[0]
        while not self.conn.poll(1.0):
            if self.proc is not None and not self.proc.is_alive():
                raise RuntimeError(f"draft rank {self.peer} died "
                                   f"(exit code {self.proc.exitcode})")
        return self.conn.recv()


def _send_tensor(comm, x: torch.Tensor, dst: int):
    x = x.contiguous()
    dist.send(x.cpu() if comm.backend == "gloo" else x, dst=dst)


def _recv_tensor(comm, shape, src: int, device: torch.device) -> torch.Tensor:
    if comm.backend == "gloo":
        buf = torch.empty(shape, dtype=torch.float32)
        dist.recv(buf, src=src)
        return buf.to(device)
    buf = torch.empty(shape, dtype=torch.float32, device=device)
    dist.recv(buf, src=src)
    return buf


def _request_payload(req: SpecRequest, idx: np.ndarray) -> dict:
    """The host fields of a request's rows idx (a draft rank's request)."""
    return {k: None if getattr(req, k) is None else getattr(req, k)[idx]
            for k in ("cache_keys", "num_tokens", "block_tables", "temperatures",
                      "top_ps", "top_ks")}


class DraftRanks:
    """The target's side of the draft ranks (engine/speculator_async.py
    calls it as it calls engine/draft_runner.py::DraftServer): rank 0
    exchanges with them, the other target ranks receive rank 0's replies."""

    def __init__(self, comm, draft_cfg):
        """Waits for every draft rank's pool size; the block count is the
        smallest, on every target rank."""
        self.comm = comm
        self.lead = comm.rank == 0
        # Rank 0's link to each draft rank: the spawn pipes of the ranks it
        # spawned, else point-to-point messages; none on other target ranks.
        self.links = [] if not self.lead else (
            [_Link(g, conn, proc) for g, (proc, conn) in zip(comm.draft_ranks, comm.draft_procs)]
            or [_Link(g) for g in comm.draft_ranks])
        self.dp = len(comm.draft_ranks)
        self.K = draft_cfg.speculate_k
        self.V = draft_cfg.hf_config.vocab_size
        self.max_blocks = draft_cfg.max_blocks
        self.use_warp = draft_cfg.enable_top_sampling
        self.launches: dict = {}             # what the ranks reported at exit
        self.exchange_s: list[float] = []    # a step's request to assembled reply
        self._dead: BaseException | None = None
        self._closed = False
        blocks = 1 << 62
        for link in self.links:
            try:
                status, info = link.recv()
                if status != "ok":
                    raise RemoteError(info)
                blocks = min(blocks, info)
            except Exception as e:
                self._dead = self._dead or e
        blocks = comm.min_over_ranks(-1 if self._dead else blocks)
        if blocks < 0:
            self._dead = self._dead or RemoteError("a draft rank failed to start")
            self._raise_dead()
        self.num_kvcache_blocks = blocks

    def _raise_dead(self):
        raise RuntimeError("draft server died") from self._dead

    def prefill(self, input_id_lists: list[list[int]], block_tables: np.ndarray,
                seq_ids: np.ndarray, acts_list=None):
        """Send each draft rank the prompts of its rows (no reply)."""
        if self._dead is not None:
            self._raise_dead()
        try:
            for link, idx in zip(self.links, replica_rows(seq_ids, self.dp)):
                if len(idx):
                    link.send(("prefill", ([input_id_lists[i] for i in idx],
                                           block_tables[idx])))
        except Exception as e:
            self._dead = e
            self._raise_dead()

    def speculate(self, req: SpecRequest) -> list[tuple[np.ndarray, SpecResponse]]:
        """Every replica's reply to its rows of req, [(rows, SpecResponse)],
        on every target rank, the logits on the rank's device."""
        if self._dead is not None:
            self._raise_dead()
        t0 = perf_counter()
        parts = []
        if self.lead:
            try:
                parts = self._exchange(req)
            except Exception as e:
                self._dead = e
        if self.comm.size > 1:
            parts = self._broadcast(parts)
        if self._dead is not None:
            self._raise_dead()
        self.exchange_s.append(perf_counter() - t0)
        return parts

    def _exchange(self, req: SpecRequest) -> list:
        rows = replica_rows(req.cache_keys[:, 0], self.dp)
        for link, idx in zip(self.links, rows):
            if len(idx):
                link.send(("spec", _request_payload(req, idx)))
        parts = []
        for link, idx in zip(self.links, rows):
            if len(idx):
                status, info = link.recv()
                if status != "ok":
                    raise RemoteError(info)
                logits = _recv_tensor(self.comm, (len(idx), self.K, self.V), link.peer,
                                      self.comm.device)
                parts.append((idx, SpecResponse(*info, logits)))
        return parts

    def _broadcast(self, parts: list) -> list:
        """Rank 0's parts (or its failure) on every target rank."""
        from ssd_tpu_torch.parallel.comm import broadcast

        meta = [None if self._dead else [(idx, r.cache_hits, r.tokens) for idx, r in parts]]
        dist.broadcast_object_list(meta, src=0, group=self.comm.group)
        if meta[0] is None:
            self._dead = self._dead or RemoteError("target rank 0 lost the draft ranks")
            return []
        if not self.lead:
            parts = [(idx, SpecResponse(hits, tokens, torch.empty(
                (len(idx), self.K, self.V), device=self.comm.device)))
                for idx, hits, tokens in meta[0]]
        for _, r in parts:
            broadcast(self.comm, r.logits_q)
        return parts

    def _ask_all(self, cmd: str) -> dict:
        """Send cmd to every draft rank and sum the launch counts they
        return."""
        total: dict = {}
        for link in self.links:
            link.send((cmd, None))
            status, counts = link.recv()
            if status != "ok":
                raise RemoteError(counts)
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
        return total

    def drain(self) -> dict:
        """Wait until every draft rank has built its last tree; returns the
        kernel launches the draft ranks made since the last drain (rank 0;
        {} elsewhere). Raises if a draft rank died or failed."""
        if self._dead is not None:
            self._raise_dead()
        try:
            return self._ask_all("sync")
        except Exception as e:
            self._dead = e
            self._raise_dead()

    def shutdown(self):
        """Stop the draft ranks (their processes end once the engine tears
        its group down); keeps the launches they report in .launches."""
        if self._closed:
            return
        self._closed = True
        for link in self.links:
            try:
                link.send(("exit", None))
                status, counts = link.recv()
            except Exception:
                continue   # a dead rank: nothing to stop
            if status == "ok":
                for k, n in counts.items():
                    self.launches[k] = self.launches.get(k, 0) + n


def serve(comm, config, init_random: bool, conn=None) -> dict:
    """A draft rank: build the draft's runner on this rank's device (its
    pool sized from its card unless num_kvcache_blocks is given, its
    graphs captured on a card that is not eager), report the pool's block
    count to target rank 0, then serve its requests until exit. Messages go
    through conn (the spawn pipe) or, without one, point to point. Returns
    the kernel launches since the last drain, as reported at exit. A
    failure after start-up is answered to every later request; one at
    start-up is reported, then raised here."""
    from ssd_tpu_torch.engine.draft_runner import DraftRunner
    from ssd_tpu_torch.engine.model_runner import next_pow2

    link = _Link(0, conn)
    draft_cfg = config.create_draft_config()
    draft_cfg.device = str(comm.device)
    try:
        runner = DraftRunner(draft_cfg, init_random=init_random)
        if runner.device.type == "cuda" and not config.enforce_eager:
            from ssd_tpu_torch.engine.graphs import StepGraphs

            runner.graphs = StepGraphs(runner.device, [runner.generator])
            runner.capture([1 << i for i in range(next_pow2(config.max_num_seqs).bit_length())])
    except Exception:
        link.send(("error", traceback.format_exc()))
        raise
    link.send(("ok", runner.num_kvcache_blocks))
    _take_launches()   # the captures' warm-up runs serve nothing
    failure = None
    with torch.no_grad():
        while True:
            cmd, payload = link.recv()
            if cmd in ("sync", "exit"):
                counts = _take_launches()
                link.send(("ok", counts))
                if cmd == "exit":
                    return counts
            elif cmd == "prefill":
                if failure is None:
                    try:
                        runner.prefill_from_payload(*payload)
                    except Exception:
                        failure = traceback.format_exc()
            elif failure is not None:
                link.send(("error", failure))
            else:
                req = SpecRequest(**payload)
                try:
                    resp = runner.service(req)
                except Exception:
                    failure = traceback.format_exc()
                    link.send(("error", failure))
                    continue
                # Reply, then build the next tree while the target verifies.
                link.send(("ok", (resp.cache_hits, resp.tokens)))
                _send_tensor(comm, resp.logits_q, 0)
                try:
                    runner.reset_tree_cache()
                    runner.build_tree(req, resp)
                except Exception:
                    failure = traceback.format_exc()
