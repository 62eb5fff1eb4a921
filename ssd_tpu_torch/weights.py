"""Carry the JAX package's parameters into the port.

`params_from_jax` takes the stacked JAX parameter pytree of
ssd_tpu/models/transformer.py, already brought to the host as numpy arrays
(the caller runs `jax.device_get`; this module imports no JAX), and returns
the port's per-layer parameter dict, so both packages compute the same
function from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

_LAYER_KEYS = ("input_ln", "wq", "wk", "wv", "wo", "post_ln", "gate", "up",
               "down", "q_norm", "k_norm",
               # Qwen3-MoE: router [L, D, E], expert stacks [L, E, in, out]
               "router", "moe_gate", "moe_up", "moe_down")


def params_from_jax(np_params: dict) -> dict:
    """{embed, layers: {name: [L, ...]}, final_ln, lm_head} as numpy arrays ->
    {embed, layers: [{name: tensor}] * L, final_ln, lm_head} (an MoE layer
    keeps its experts stacked, [E, ...]), CPU tensors of
    the arrays' dtype (float32, float16 or ml_dtypes' bfloat16); a tied head
    (the same array as embed) stays one tensor."""
    def conv(a) -> torch.Tensor:
        a = np.array(a)  # a copy: device_get arrays are read-only
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    stacked = np_params["layers"]
    unknown = set(stacked) - set(_LAYER_KEYS)
    if unknown:
        raise NotImplementedError(f"layer parameters not ported yet: {sorted(unknown)}")
    L = next(iter(stacked.values())).shape[0]
    layers = [{k: conv(v[i]) for k, v in stacked.items()} for i in range(L)]
    params = {"embed": conv(np_params["embed"]), "layers": layers,
              "final_ln": conv(np_params["final_ln"])}
    head = np_params["lm_head"]
    params["lm_head"] = (params["embed"] if head is np_params["embed"]
                         else conv(head))
    return params
