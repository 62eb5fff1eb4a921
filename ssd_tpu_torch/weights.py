"""Carry the JAX package's parameters into the port.

`params_from_jax` takes the stacked JAX parameter pytree of
ssd_tpu/models/transformer.py, already brought to the host as numpy arrays
(the caller runs `jax.device_get`; this module imports no JAX), and returns
the port's per-layer parameter dict, so both packages compute the same
function from the same weights. An EAGLE-3 head's flat dict
(ssd_tpu/models/eagle3.py) converts key for key, and shards as a model's
tree does. A tree quantized by
ssd_tpu/utils/quant.py carries its int8 weights and `_scale` keys across,
each int8 matrix transposed to the port's [out, in] (utils/quant.py).
Given a parallel/mesh.py::Sharding, it returns that rank's shard of the
whole tree (quantized whole on the JAX side, then sliced, as ssd_tpu
quantizes before it shards).
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.models.transformer import set_reduced_head
from ssd_tpu_torch.parallel.mesh import shard_params
from ssd_tpu_torch.utils.quant import EAGLE_WEIGHTS, LAYER_WEIGHTS

_LAYER_KEYS = ("input_ln", "wq", "wk", "wv", "wo", "post_ln", "gate", "up",
               "down", "q_norm", "k_norm",
               # Qwen3-MoE: router [L, D, E], expert stacks [L, E, in, out]
               "router", "moe_gate", "moe_up", "moe_down",
               # int8 weights' per-output-channel scales
               *(name + "_scale" for name in LAYER_WEIGHTS))


_EAGLE_KEYS = ("embed", "fc", "input_ln", "cond_ln", "post_ln", "wq", "wk",
               "wv", "wo", "gate", "up", "down", "final_ln", "lm_head", "d2t",
               *(name + "_scale" for name in EAGLE_WEIGHTS + ("embed", "lm_head")))
_TOP_KEYS = ("embed", "layers", "final_ln", "lm_head", "embed_scale", "lm_head_scale", "d2t")


def params_from_jax(np_params: dict, sharding=None) -> dict:
    """{embed, layers: {name: [L, ...]}, final_ln, lm_head} as numpy arrays ->
    {embed, layers: [{name: tensor}] * L, final_ln, lm_head} (an MoE layer
    keeps its experts stacked, [E, ...]), CPU tensors of
    the arrays' dtype (float32, float16 or ml_dtypes' bfloat16); a tied head
    (the same array as embed) stays one tensor. An EAGLE head's dict (it has
    `fc`) keeps its keys, with d2t as int64. Int8 matrices (not the
    embedding or the head, already [V, D]) become [.., out, in]. A reduced-
    vocabulary draft's d2t (int32) becomes the port's int64 map and its
    head_ids (models/transformer.py::set_reduced_head). With a Sharding,
    the rank's slices of a model's tree or of an EAGLE head's dict
    (parallel/mesh.py; the Sharding's Arch or EagleArch carries the reduced
    head's rows)."""
    def conv(a, transpose=False) -> torch.Tensor:
        a = np.array(a)  # a copy: device_get arrays are read-only
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        if transpose and a.dtype == np.int8:
            return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, -1, -2)))
        return torch.from_numpy(a)

    if "fc" in np_params:
        # An EAGLE-3 head (ssd_tpu/models/eagle3.py): one flat dict, the same
        # keys on both sides.
        unknown = set(np_params) - set(_EAGLE_KEYS)
        if unknown:
            raise NotImplementedError(f"EAGLE parameters not ported yet: {sorted(unknown)}")
        params = {k: conv(v, k in EAGLE_WEIGHTS) for k, v in np_params.items()}
        params["d2t"] = params["d2t"].long()
        return params if sharding is None else shard_params(params, sharding)
    unknown = (set(np_params) - set(_TOP_KEYS)) | (set(np_params["layers"]) - set(_LAYER_KEYS))
    if unknown:
        raise NotImplementedError(f"parameters not ported yet: {sorted(unknown)}")
    stacked = np_params["layers"]
    L = next(iter(stacked.values())).shape[0]
    layers = [{k: conv(v[i], k in LAYER_WEIGHTS) for k, v in stacked.items()}
              for i in range(L)]
    params = {"layers": layers, **{k: conv(np_params[k]) for k in
                                   ("embed", "final_ln", "embed_scale") if k in np_params}}
    tied = np_params["lm_head"] is np_params["embed"]
    for k in ("lm_head", "lm_head_scale"):
        if k in np_params:
            params[k] = params[k.replace("lm_head", "embed")] if tied else conv(np_params[k])
    if "d2t" in np_params:
        set_reduced_head(params, conv(np_params["d2t"]))
    return params if sharding is None else shard_params(params, sharding)
