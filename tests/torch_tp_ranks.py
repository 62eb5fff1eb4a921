"""Ranks of a tensor-parallel group that a test starts itself, free of JAX so
that a spawned process imports only torch and the port.

`verify_rank` is one rank of a caller-launched gloo group on the CPU: it
loads its shard of a checkpoint (parallel/mesh.py), slices a whole KV cache
to the k/v heads its query heads read, runs one verify forward
(engine/model_runner.py::decode_forward at q_len = K+1) over the group and,
at rank 0, saves the gathered logits.

`eagle_step_rank` does the same for an EAGLE-3 head: the rank's runner of
the fused superstep's head (engine/eagle_runner.py::EagleModelRunner over
the group) runs one chain step and one tree build over its slice of a
whole draft cache, and rank 0 saves their tokens and logits.
"""

import numpy as np
import torch
import torch.distributed as dist


def verify_rank(rank: int, size: int, store: str, ckpt: str, inputs: str, out: str,
                block_size: int, q_len: int):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=size)
    try:
        from ssd_tpu_torch.config import ModelConfig
        from ssd_tpu_torch.engine import model_runner as mr
        from ssd_tpu_torch.models.transformer import Arch
        from ssd_tpu_torch.parallel.comm import Comm
        from ssd_tpu_torch.parallel.mesh import Sharding
        from ssd_tpu_torch.utils.loader import load_params

        mc = ModelConfig.from_pretrained(ckpt)
        sh = Sharding(Arch.from_model_config(mc), rank, size)
        params = load_params(ckpt, mc, torch.float32, torch.device("cpu"),
                             place=lambda name, x: {name: sh.leaf(name, x)})
        arch = sh.rank_arch(Comm(rank, size, "gloo", torch.device("cpu")))
        z = np.load(inputs)
        lo, n = sh.kv_heads
        cache = torch.from_numpy(np.ascontiguousarray(z["cache"][:, lo:lo + n]))
        t = torch.from_numpy
        with torch.no_grad():
            logits = mr.decode_forward(params, cache, t(z["ids"]), t(z["pos"]), t(z["bt"]),
                                       t(z["ctx"]), arch=arch, block_size=block_size,
                                       q_len=q_len)
        if rank == 0:
            np.save(out, logits.numpy())
    finally:
        dist.destroy_process_group()


def eagle_step_rank(rank: int, size: int, store: str, target: str, head: str, taps: list,
                    inputs: str, out: str, block_size: int, K: int, fan: tuple, F: int):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=size)
    try:
        from ssd_tpu_torch.config import Config
        from ssd_tpu_torch.engine import eagle_runner as er
        from ssd_tpu_torch.ops.spec_math import FanOut
        from ssd_tpu_torch.parallel.comm import Comm

        cfg = Config(target, device="cpu", draft=head, speculate=True, use_eagle=True,
                     speculate_k=K, spec_rounds=2, eagle_layers=taps,
                     kvcache_block_size=block_size, num_kvcache_blocks=32, max_model_len=256,
                     dtype="float32")
        runner = er.EagleModelRunner(cfg.create_draft_config(),
                                     comm=Comm(rank, size, "gloo", torch.device("cpu")))
        z = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
        lo, n = runner.sharding.kv_heads
        common = dict(arch=runner.arch, block_size=block_size, K=K)
        with torch.no_grad():
            cache = z["cache"][:, lo:lo + n].contiguous()
            toks, logits, _ = er.eagle_chain_step(
                runner.params, cache, z["first"], z["acts"], z["base"], z["bt"],
                torch.zeros(2), None, sampler_x=None, fan_out=F, **common)
            cache = z["cache"][:, lo:lo + n].contiguous()
            tree, spec_logits, _ = er.eagle_tree_build_step(
                runner.params, cache, z["glue"], z["rec_acts"], z["ext_acts"], z["prev"],
                z["n_ext"], z["base"], z["bt"], z["hits"], torch.zeros(2), None,
                fan=FanOut(list(fan[0]), list(fan[1]), "cpu"), sampler_x=None, F=F, **common)
        if rank == 0:
            np.savez(out, chain_tokens=toks.numpy(), chain_logits=logits.numpy(),
                     tree=tree.numpy(), spec_logits=spec_logits.numpy())
    finally:
        dist.destroy_process_group()
