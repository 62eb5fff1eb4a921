"""Ranks of a tensor-parallel group that a test starts itself, free of JAX so
that a spawned process imports only torch and the port.

`verify_rank` is one rank of a caller-launched gloo group on the CPU: it
loads its shard of a checkpoint (parallel/mesh.py), slices a whole KV cache
to the k/v heads its query heads read, runs one verify forward
(engine/model_runner.py::decode_forward at q_len = K+1) over the group and,
at rank 0, saves the gathered logits.
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
