"""Checkpoint loading: HF safetensors -> the port's parameter dict.

Counterpart of ssd_tpu/utils/loader.py::load_params and load_eagle_params. The safetensors format
is read directly (an 8-byte little-endian header length, a JSON header, then
raw little-endian bytes), so the port does not need the `safetensors`
package. Tensors are staged one at a time: read into host memory, converted
to the target dtype, copied to the device and dropped, so the device never
holds the source-dtype checkpoint beside the converted weights.
"""

from __future__ import annotations

import json
import os
import struct
from glob import glob

import torch

from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.models.transformer import Arch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


class SafetensorsIndex:
    """Names, dtypes and byte ranges of every tensor in a checkpoint dir."""

    def __init__(self, model_path: str):
        files = sorted(glob(os.path.join(model_path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no safetensors files found in {model_path}")
        self.entries: dict[str, tuple[str, int, dict]] = {}
        for fn in files:
            with open(fn, "rb") as f:
                (n,) = struct.unpack("<Q", f.read(8))
                header = json.loads(f.read(n))
            for name, meta in header.items():
                if name != "__metadata__":
                    self.entries[name] = (fn, 8 + n, meta)

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def names(self) -> list[str]:
        return list(self.entries)

    def get(self, name: str) -> torch.Tensor:
        """One tensor, read into host memory in its stored dtype."""
        fn, base, meta = self.entries[name]
        begin, end = meta["data_offsets"]
        with open(fn, "rb") as f:
            f.seek(base + begin)
            buf = bytearray(f.read(end - begin))
        dtype = _DTYPES[meta["dtype"]]
        if not buf:
            return torch.empty(meta["shape"], dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype).reshape(meta["shape"])


def load_params(model_path: str, mc: ModelConfig, dtype: torch.dtype,
                device: torch.device) -> dict:
    """Load a Llama-3 / Qwen-3 / Qwen3-MoE checkpoint into the parameter dict
    of models/transformer.py. HF stores linear weights as [out, in]; the
    forward computes x @ W, so they are transposed to [in, out]. A Qwen3-MoE
    layer's router mlp.gate [E, D] becomes router [D, E], and its experts'
    projections mlp.experts.{e}.{gate,up,down}_proj are transposed into one
    [E, in, out] stack per projection, filled on the device expert by
    expert."""
    arch = Arch.from_model_config(mc)
    t = SafetensorsIndex(model_path)

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        w = t.get(name).to(dtype)
        if transpose:
            w = w.T
        return w.contiguous().to(device)

    def experts(prefix: str, proj: str) -> torch.Tensor:
        first = t.get(f"{prefix}0.{proj}.weight")
        out_f, in_f = first.shape
        stack = torch.empty(arch.num_experts, in_f, out_f, dtype=dtype, device=device)
        for e in range(arch.num_experts):
            w = first if e == 0 else t.get(f"{prefix}{e}.{proj}.weight")
            stack[e].copy_(w.to(dtype).T)
        return stack

    layers = []
    for i in range(arch.num_layers):
        p = f"model.layers.{i}."
        lp = {
            "input_ln": get(p + "input_layernorm.weight"),
            "wq": get(p + "self_attn.q_proj.weight", True),
            "wk": get(p + "self_attn.k_proj.weight", True),
            "wv": get(p + "self_attn.v_proj.weight", True),
            "wo": get(p + "self_attn.o_proj.weight", True),
            "post_ln": get(p + "post_attention_layernorm.weight"),
        }
        if arch.num_experts:
            lp["router"] = get(p + "mlp.gate.weight", True)
            for proj in ("gate", "up", "down"):
                lp["moe_" + proj] = experts(p + "mlp.experts.", proj + "_proj")
        else:
            lp.update(gate=get(p + "mlp.gate_proj.weight", True),
                      up=get(p + "mlp.up_proj.weight", True),
                      down=get(p + "mlp.down_proj.weight", True))
        if arch.use_qk_norm:
            lp["q_norm"] = get(p + "self_attn.q_norm.weight")
            lp["k_norm"] = get(p + "self_attn.k_norm.weight")
        layers.append(lp)

    params = {
        "embed": get("model.embed_tokens.weight"),
        "layers": layers,
        "final_ln": get("model.norm.weight"),
    }
    if arch.tie_embeddings or "lm_head.weight" not in t:
        params["lm_head"] = params["embed"]
    else:
        params["lm_head"] = get("lm_head.weight")
    return params


def load_eagle_params(model_path: str, mc: ModelConfig, d_model_target: int,
                      num_eagle_layers: int, dtype: torch.dtype,
                      device: torch.device, target_path: str | None = None) -> dict:
    """Load an EAGLE-3 draft checkpoint into the dict of models/eagle3.py
    (ssd_tpu/utils/loader.py::load_eagle_params): bare `midlayer.*` or
    `model.midlayer.*` keys, `hidden_norm` as the conditioning norm, `fc`,
    the `d2t` offsets (`t2d` is not needed), and the target's embeddings
    when the draft ships none. A full-vocabulary head must carry an all-zero
    d2t (or none)."""
    from ssd_tpu_torch.models.eagle3 import EagleArch

    arch = EagleArch.from_model_config(mc, d_model_target, num_eagle_layers)
    t = SafetensorsIndex(model_path)

    def key(*cands: str) -> str:
        for c in cands:
            if c in t:
                return c
        raise KeyError(f"none of {cands} in EAGLE checkpoint {model_path}")

    def get(name: str, transpose: bool = False, index: SafetensorsIndex = t):
        w = index.get(name).to(dtype)
        return (w.T if transpose else w).contiguous().to(device)

    mid = "midlayer." if any(k.startswith("midlayer.") for k in t.names()) \
        else "model.midlayer."
    params = {
        "fc": get(key("fc.weight", "model.fc.weight"), True),
        "input_ln": get(key(mid + "input_layernorm.weight")),
        "cond_ln": get(key(mid + "hidden_norm.weight")),
        "post_ln": get(key(mid + "post_attention_layernorm.weight")),
        "final_ln": get(key("norm.weight", "model.norm.weight")),
        "lm_head": get(key("lm_head.weight", "model.lm_head.weight")),
    }
    for name, hf in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                     ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                     ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                     ("down", "mlp.down_proj")):
        params[name] = get(key(mid + hf + ".weight"), True)
    if "d2t" in t:
        d2t = t.get("d2t").long()
        if arch.draft_vocab_size == arch.vocab_size and bool(d2t.any()):
            raise ValueError("an EAGLE checkpoint with draft_vocab == vocab must "
                             "carry an all-zero d2t (the identity map)")
    elif arch.draft_vocab_size != arch.vocab_size:
        raise ValueError("an EAGLE checkpoint without d2t needs draft_vocab == "
                         "target vocab")
    else:
        d2t = torch.zeros(arch.draft_vocab_size, dtype=torch.int64)
    params["d2t"] = d2t.to(device)

    embed_key = next((k for k in t.names() if "embed_tokens" in k), None)
    if embed_key is not None:
        params["embed"] = get(embed_key)
    else:
        if target_path is None:
            raise ValueError("the EAGLE checkpoint has no embed_tokens; the "
                             "target's path is needed to borrow them")
        tt = SafetensorsIndex(target_path)
        ek = next(k for k in tt.names() if "embed_tokens" in k)
        params["embed"] = get(ek, index=tt)
        if params["embed"].shape[1] != arch.hidden_size:
            raise ValueError(f"target embedding width {params['embed'].shape[1]} "
                             f"!= draft hidden {arch.hidden_size}")
    return params


def save_safetensors(path: str, tensors: dict[str, torch.Tensor]):
    """Write CPU tensors as one safetensors file (for random-weight
    checkpoints made at run time)."""
    names = {v: k for k, v in _DTYPES.items()}
    header, offset, blobs = {}, 0, []
    for name, x in tensors.items():
        x = x.detach().contiguous().cpu()
        blob = x.reshape(-1).view(torch.uint8).numpy().tobytes() if x.numel() else b""
        header[name] = {"dtype": names[x.dtype], "shape": list(x.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)
