"""Checkpoint loading: HF safetensors -> the port's parameter dict.

Counterpart of ssd_tpu/utils/loader.py::load_params and load_eagle_params.
The safetensors format is read directly (an 8-byte little-endian header
length, a JSON header, then raw little-endian bytes), so the port does not
need the `safetensors` package. Tensors are staged one at a time, in
their stored dtype, onto the device (for a card, streamed from the file
through one small page-locked buffer), then converted and transposed there
and dropped, so the device never holds the source-dtype checkpoint beside
the converted weights (only the one tensor in flight).
"""

from __future__ import annotations

import json
import os
import struct
import threading
from glob import glob

import torch

from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.models.transformer import Arch, set_reduced_head, tie_head

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

    def get(self, name: str, device: torch.device | str = "cpu") -> torch.Tensor:
        """One tensor in its stored dtype on `device`: read straight into
        its own buffer on the host, or for a card streamed through the
        page-locked staging buffer (one copy out of the file either way)."""
        fn, base, meta = self.entries[name]
        begin, end = meta["data_offsets"]
        dtype = _DTYPES[meta["dtype"]]
        device = torch.device(device)
        buf = torch.empty(end - begin, dtype=torch.uint8, device=device)
        if end > begin:
            with open(fn, "rb") as f:
                f.seek(base + begin)
                got = (f.readinto(buf.numpy()) if device.type == "cpu"
                       else _read_to_device(f, buf))
            if got != end - begin:
                raise ValueError(f"{fn}: tensor {name} is cut short")
        return buf.view(dtype).reshape(meta["shape"])


_STAGING_BYTES = 64 << 20   # the page-locked buffer a card's loads stream through
_staging: list[torch.Tensor] = []
_staging_lock = threading.Lock()


def _read_to_device(f, buf: torch.Tensor) -> int:
    """Fill the device tensor `buf` (uint8) from the file's position, through
    one page-locked buffer made at the first load and kept (allocating
    page-locked memory a tensor at a time costs more than the copies).
    Returns the bytes read."""
    with _staging_lock:
        if not _staging:
            _staging.append(torch.empty(_STAGING_BYTES, dtype=torch.uint8, pin_memory=True))
        stage = _staging[0]
        done, n = 0, buf.numel()
        while done < n:
            k = f.readinto(stage[:min(_STAGING_BYTES, n - done)].numpy())
            if not k:
                break
            buf[done:done + k].copy_(stage[:k])   # waits for the copy: stage is reused
            done += k
        return done


def _stage(w: torch.Tensor, dtype: torch.dtype, transpose: bool) -> torch.Tensor:
    """A tensor on its device as a contiguous weight of `dtype`: converted
    (and transposed) where it lies, so a card does that work, not the
    host."""
    w = w.to(dtype)
    return (w.T if transpose else w).contiguous()


def reduced_head_rows(model_path: str) -> int | None:
    """Rows of a reduced-vocabulary draft's LM head (the length of its
    checkpoint's d2t), or None when it has none (read from the headers)."""
    t = SafetensorsIndex(model_path)
    return t.entries["d2t"][2]["shape"][0] if "d2t" in t else None


def load_params(model_path: str, mc: ModelConfig, dtype: torch.dtype,
                device: torch.device, place=None,
                expert_span: tuple[int, int] | None = None) -> dict:
    """Load a Llama-3 / Qwen-3 / Qwen3-MoE checkpoint into the parameter dict
    of models/transformer.py. HF stores linear weights as [out, in]; the
    forward computes x @ W, so they are transposed to [in, out]. A Qwen3-MoE
    layer's router mlp.gate [E, D] becomes router [D, E], and its experts'
    projections mlp.experts.{e}.{gate,up,down}_proj are transposed into one
    [E, in, out] stack per projection, filled on the device expert by
    expert. One tensor at a time goes whole to the device and through
    `place(name, x)` (the runner's: quantize it, keep the rank's slice;
    default: keep it), so host memory holds one tensor and the device one
    whole tensor beyond the rank's weights. expert_span [lo, hi): the
    experts a rank keeps, the only ones read (default all). A checkpoint
    with `d2t` is a reduced-vocabulary draft (FR-Spec style, as
    ssd_tpu/utils/loader.py::load_params reads it): its explicit lm_head
    has len(d2t) rows, and the map is kept whole on every rank
    (models/transformer.py::set_reduced_head)."""
    arch = Arch.from_model_config(mc)
    t = SafetensorsIndex(model_path)
    place = place or (lambda name, x: {name: x})

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        return _stage(t.get(name, device), dtype, transpose)

    def experts(prefix: str, proj: str) -> torch.Tensor:
        lo, hi = expert_span or (0, arch.num_experts)
        first = t.get(f"{prefix}{lo}.{proj}.weight", device)
        out_f, in_f = first.shape
        stack = torch.empty(hi - lo, in_f, out_f, dtype=dtype, device=device)
        for e in range(lo, hi):
            w = first if e == lo else t.get(f"{prefix}{e}.{proj}.weight", device)
            stack[e - lo].copy_(w.to(dtype).T)
        return stack

    layers = []
    for i in range(arch.num_layers):
        p = f"model.layers.{i}."
        lp = {}
        for name, key, tr in (("input_ln", "input_layernorm", False),
                              ("wq", "self_attn.q_proj", True),
                              ("wk", "self_attn.k_proj", True),
                              ("wv", "self_attn.v_proj", True),
                              ("wo", "self_attn.o_proj", True),
                              ("post_ln", "post_attention_layernorm", False)):
            lp.update(place(name, get(p + key + ".weight", tr)))
        if arch.num_experts:
            lp["router"] = get(p + "mlp.gate.weight", True)
            for proj in ("gate", "up", "down"):
                lp.update(place("moe_" + proj, experts(p + "mlp.experts.", proj + "_proj")))
        else:
            for proj in ("gate", "up", "down"):
                lp.update(place(proj, get(p + f"mlp.{proj}_proj.weight", True)))
        if arch.use_qk_norm:
            lp["q_norm"] = get(p + "self_attn.q_norm.weight")
            lp["k_norm"] = get(p + "self_attn.k_norm.weight")
        layers.append(lp)

    params = {**place("embed", get("model.embed_tokens.weight")), "layers": layers,
              "final_ln": get("model.norm.weight")}
    if "d2t" in t:
        if "lm_head.weight" not in t:
            raise ValueError("d2t requires an untied explicit lm_head")
        d2t = t.get("d2t")
        if t.entries["lm_head.weight"][2]["shape"][0] != d2t.shape[0]:
            raise ValueError("lm_head rows must match d2t length")
        params.update(place("lm_head", get("lm_head.weight")))
        set_reduced_head(params, d2t.to(device))
    elif arch.tie_embeddings or "lm_head.weight" not in t:
        tie_head(params)
    else:
        params.update(place("lm_head", get("lm_head.weight")))
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
        return _stage(index.get(name, device), dtype, transpose)

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
    header, offset, flat = {}, 0, []
    for name, x in tensors.items():
        x = x.detach().contiguous().cpu()
        n = x.numel() * x.element_size()
        header[name] = {"dtype": names[x.dtype], "shape": list(x.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
        flat.append(x.reshape(-1).view(torch.uint8))
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for x in flat:
            if x.numel():
                f.write(x.numpy().data)   # the tensor's own bytes, not a copy
