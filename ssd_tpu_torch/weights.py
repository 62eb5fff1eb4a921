"""Carry the JAX package's parameters into the port.

`params_from_jax` takes the stacked JAX parameter pytree of
ssd_tpu/models/transformer.py, already brought to the host as numpy arrays
(the caller runs `jax.device_get`; this module imports no JAX), and returns
the port's per-layer parameter dict, so both packages compute the same
function from the same weights. An EAGLE-3 head's flat dict
(ssd_tpu/models/eagle3.py) converts key for key.
"""

from __future__ import annotations

import numpy as np
import torch

_LAYER_KEYS = ("input_ln", "wq", "wk", "wv", "wo", "post_ln", "gate", "up",
               "down", "q_norm", "k_norm",
               # Qwen3-MoE: router [L, D, E], expert stacks [L, E, in, out]
               "router", "moe_gate", "moe_up", "moe_down")


_EAGLE_KEYS = ("embed", "fc", "input_ln", "cond_ln", "post_ln", "wq", "wk",
               "wv", "wo", "gate", "up", "down", "final_ln", "lm_head", "d2t")


def params_from_jax(np_params: dict) -> dict:
    """{embed, layers: {name: [L, ...]}, final_ln, lm_head} as numpy arrays ->
    {embed, layers: [{name: tensor}] * L, final_ln, lm_head} (an MoE layer
    keeps its experts stacked, [E, ...]), CPU tensors of
    the arrays' dtype (float32, float16 or ml_dtypes' bfloat16); a tied head
    (the same array as embed) stays one tensor. An EAGLE head's dict (it has
    `fc`) keeps its keys, with d2t as int64."""
    def conv(a) -> torch.Tensor:
        a = np.array(a)  # a copy: device_get arrays are read-only
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    if "fc" in np_params:
        # An EAGLE-3 head (ssd_tpu/models/eagle3.py): one flat dict, the same
        # keys on both sides.
        unknown = set(np_params) - set(_EAGLE_KEYS)
        if unknown:
            raise NotImplementedError(f"EAGLE parameters not ported yet: {sorted(unknown)}")
        params = {k: conv(v) for k, v in np_params.items()}
        params["d2t"] = params["d2t"].long()
        return params
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
