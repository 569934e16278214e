"""HuggingFace checkpoint interop (import + export): the port of
`lmrl_gym_tpu/models/hf.py`, loading and saving the port's own modules.

The maps from HF names go through the flax parameter tree the JAX package
builds (`models/convert.py` carries it to and from the port's state dicts),
so the two packages read an HF checkpoint into the same weights.

- GPT-2 `Conv1D` stores weights [in, out], a flax Dense kernel's layout;
  the fused qkv matches c_attn's (q|k|v) output concatenation.
- GPT-J and LLaMA use separate q/k/v torch Linears (weight [out, in]);
  GPT-J takes the interleaved rotary convention.
- Vocab rows above `vocab_size` (the padding) are zero-filled on import
  and stripped on export.

`load_hf_pretrained` and `export_hf_pretrained` need neither `transformers`
nor `safetensors`: `config.json` is read and written with `json`, and the
weights with this module's own safetensors reader and writer (an 8-byte
little-endian header length, a JSON header, then the raw tensors), or read
from `pytorch_model.bin` with `torch.load(weights_only=True)`. The
directory `export_hf_pretrained` writes is one that
`transformers.AutoModelForCausalLM.from_pretrained` loads.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Union

import torch
from torch import nn

from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.models.config import TransformerConfig
from lmrl_gym_torch.models.convert import (
    encdec_params_from_jax,
    encdec_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from lmrl_gym_torch.models.transformer import Transformer

StateDict = Dict[str, torch.Tensor]


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _getter(hf_config):
    """Attribute access on a transformers config, or key access on its
    config.json dict (with the transformers class defaults for keys a
    saved config may leave out)."""
    if isinstance(hf_config, Mapping):
        return lambda k, default=None: hf_config.get(k, default)
    return lambda k, default=None: getattr(hf_config, k, default)


def config_from_hf(hf_config) -> TransformerConfig:
    """Map a GPT-2 / GPT-J / LLaMA config (a transformers config or its
    config.json dict) to TransformerConfig."""
    get = _getter(hf_config)
    t = get("model_type")
    if t == "gpt2":
        return TransformerConfig(
            vocab_size=get("vocab_size", 50257),
            max_position_embeddings=get("n_positions", 1024),
            hidden_size=get("n_embd", 768),
            num_layers=get("n_layer", 12),
            num_heads=get("n_head", 12),
            intermediate_size=get("n_inner"),
            activation=get("activation_function", "gelu_new"),
            position_embedding="learned",
            layer_norm_epsilon=get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=True,
            embd_pdrop=get("embd_pdrop", 0.1),
            resid_pdrop=get("resid_pdrop", 0.1),
            attn_pdrop=get("attn_pdrop", 0.1),
            initializer_range=get("initializer_range", 0.02),
        )
    if t == "gptj":
        return TransformerConfig(
            vocab_size=get("vocab_size", 50400),
            max_position_embeddings=get("n_positions", 2048),
            hidden_size=get("n_embd", 4096),
            num_layers=get("n_layer", 28),
            num_heads=get("n_head", 16),
            intermediate_size=get("n_inner"),
            activation=get("activation_function", "gelu_new"),
            position_embedding="rotary",
            rotary_dim=get("rotary_dim", 64),
            rotary_interleaved=True,
            parallel_ffn=True,
            layer_norm_epsilon=get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=False,
            embd_pdrop=get("embd_pdrop", 0.0),
            resid_pdrop=get("resid_pdrop", 0.0),
            attn_pdrop=get("attn_pdrop", 0.0),
            initializer_range=get("initializer_range", 0.02),
        )
    if t == "llama":
        heads = get("num_attention_heads", 32)
        if (get("num_key_value_heads") or heads) != heads:
            raise ValueError("GQA (num_key_value_heads < num_heads) not supported yet")
        return TransformerConfig(
            vocab_size=get("vocab_size", 32000),
            max_position_embeddings=get("max_position_embeddings", 2048),
            hidden_size=get("hidden_size", 4096),
            num_layers=get("num_hidden_layers", 32),
            num_heads=heads,
            intermediate_size=get("intermediate_size", 11008),
            activation="silu",
            position_embedding="rotary",
            rotary_base=get("rope_theta", 10000.0),
            norm="rmsnorm",
            gated_mlp=True,
            attn_bias=False,
            mlp_bias=False,
            lm_head_bias=False,
            tie_word_embeddings=bool(get("tie_word_embeddings", False)),
            layer_norm_epsilon=get("rms_norm_eps", 1e-6),
            embd_pdrop=0.0,
            resid_pdrop=0.0,
            attn_pdrop=0.0,
            initializer_range=get("initializer_range", 0.02),
        )
    raise ValueError(f"unsupported HF model_type: {t}")


def params_from_hf_state_dict(state: Mapping[str, Any], config: TransformerConfig) -> StateDict:
    """HF torch state dict → the port's `Transformer` state dict (float32)."""
    V = config.padded_vocab_size
    sd = {k: _f32(v) for k, v in state.items()}
    if any(k.startswith("model.embed_tokens") for k in sd):
        return params_from_jax(_params_from_llama(sd, config), config)
    # strip the "transformer." prefix HF *ForCausalLM wrappers add
    sd = {k.removeprefix("transformer."): v for k, v in sd.items()}

    is_gptj = config.position_embedding == "rotary"
    params: Dict[str, Any] = {
        "wte": {"embedding": _pad_rows(sd["wte.weight"], V)},
        "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
    }
    if config.position_embedding == "learned":
        params["wpe"] = {"embedding": sd["wpe.weight"]}

    D = config.hidden_size
    for i in range(config.num_layers):
        p = f"h.{i}."
        blk: Dict[str, Any] = {"ln_1": {"scale": sd[p + "ln_1.weight"], "bias": sd[p + "ln_1.bias"]}}
        if is_gptj:
            qkv_w = torch.cat(
                [sd[p + "attn.q_proj.weight"].T, sd[p + "attn.k_proj.weight"].T, sd[p + "attn.v_proj.weight"].T],
                dim=1,
            )
            blk["attn"] = {
                "qkv": {"kernel": qkv_w, "bias": torch.zeros(3 * D)},
                "out": {"kernel": sd[p + "attn.out_proj.weight"].T, "bias": torch.zeros(D)},
            }
            blk["mlp"] = {
                "fc": {"kernel": sd[p + "mlp.fc_in.weight"].T, "bias": sd[p + "mlp.fc_in.bias"]},
                "proj": {"kernel": sd[p + "mlp.fc_out.weight"].T, "bias": sd[p + "mlp.fc_out.bias"]},
            }
        else:
            blk["attn"] = {
                "qkv": {"kernel": sd[p + "attn.c_attn.weight"], "bias": sd[p + "attn.c_attn.bias"]},
                "out": {"kernel": sd[p + "attn.c_proj.weight"], "bias": sd[p + "attn.c_proj.bias"]},
            }
            blk["ln_2"] = {"scale": sd[p + "ln_2.weight"], "bias": sd[p + "ln_2.bias"]}
            blk["mlp"] = {
                "fc": {"kernel": sd[p + "mlp.c_fc.weight"], "bias": sd[p + "mlp.c_fc.bias"]},
                "proj": {"kernel": sd[p + "mlp.c_proj.weight"], "bias": sd[p + "mlp.c_proj.bias"]},
            }
        params[f"h_{i}"] = blk

    if not config.tie_word_embeddings:
        params["lm_head"] = {
            "kernel": _pad_rows(sd["lm_head.weight"], V).T if "lm_head.weight" in sd else torch.zeros(D, V),
        }
        if "lm_head.bias" in sd:
            params["lm_head"]["bias"] = _pad_rows(sd["lm_head.bias"][:, None], V)[:, 0]
        else:
            params["lm_head"]["bias"] = torch.zeros(V)
    return params_from_jax(params, config)


def _params_from_llama(sd: StateDict, config: TransformerConfig) -> Dict[str, Any]:
    """HF LlamaForCausalLM layout → flax tree. RMSNorm has scale only;
    all projections bias-free; MLP is SwiGLU (gate_proj→fc, up_proj→gate,
    down_proj→proj per models/transformer.py naming)."""
    V = config.padded_vocab_size
    params: Dict[str, Any] = {
        "wte": {"embedding": _pad_rows(sd["model.embed_tokens.weight"], V)},
        "ln_f": {"scale": sd["model.norm.weight"]},
    }
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        qkv_w = torch.cat(
            [sd[p + "self_attn.q_proj.weight"].T, sd[p + "self_attn.k_proj.weight"].T,
             sd[p + "self_attn.v_proj.weight"].T],
            dim=1,
        )
        params[f"h_{i}"] = {
            "ln_1": {"scale": sd[p + "input_layernorm.weight"]},
            "ln_2": {"scale": sd[p + "post_attention_layernorm.weight"]},
            "attn": {"qkv": {"kernel": qkv_w}, "out": {"kernel": sd[p + "self_attn.o_proj.weight"].T}},
            "mlp": {
                "fc": {"kernel": sd[p + "mlp.gate_proj.weight"].T},
                "gate": {"kernel": sd[p + "mlp.up_proj.weight"].T},
                "proj": {"kernel": sd[p + "mlp.down_proj.weight"].T},
            },
        }
    if not config.tie_word_embeddings:
        lm_w = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
        params["lm_head"] = {"kernel": _pad_rows(lm_w, V).T}
    return params


def _state_dict(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Mapping[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, nn.Module) else params


def params_to_hf_state_dict(params, config: TransformerConfig) -> StateDict:
    """The port's `Transformer` (or its state dict) → HF torch-layout state
    dict (float32 CPU tensors). Inverse of params_from_hf_state_dict;
    padded vocab rows are stripped."""
    p = _tree_f32(params_to_jax(_state_dict(params), config))
    Vt = config.vocab_size
    if config.norm == "rmsnorm":
        return _params_to_llama(p, config)
    is_gptj = config.position_embedding == "rotary"
    out: StateDict = {
        "transformer.wte.weight": p["wte"]["embedding"][:Vt],
        "transformer.ln_f.weight": p["ln_f"]["scale"],
        "transformer.ln_f.bias": p["ln_f"]["bias"],
    }
    if config.position_embedding == "learned":
        out["transformer.wpe.weight"] = p["wpe"]["embedding"]
    D = config.hidden_size
    for i in range(config.num_layers):
        blk = p[f"h_{i}"]
        t = f"transformer.h.{i}."
        out[t + "ln_1.weight"] = blk["ln_1"]["scale"]
        out[t + "ln_1.bias"] = blk["ln_1"]["bias"]
        if is_gptj:
            qkv = blk["attn"]["qkv"]["kernel"]
            out[t + "attn.q_proj.weight"] = qkv[:, :D].T
            out[t + "attn.k_proj.weight"] = qkv[:, D: 2 * D].T
            out[t + "attn.v_proj.weight"] = qkv[:, 2 * D:].T
            out[t + "attn.out_proj.weight"] = blk["attn"]["out"]["kernel"].T
            out[t + "mlp.fc_in.weight"] = blk["mlp"]["fc"]["kernel"].T
            out[t + "mlp.fc_in.bias"] = blk["mlp"]["fc"]["bias"]
            out[t + "mlp.fc_out.weight"] = blk["mlp"]["proj"]["kernel"].T
            out[t + "mlp.fc_out.bias"] = blk["mlp"]["proj"]["bias"]
        else:
            out[t + "attn.c_attn.weight"] = blk["attn"]["qkv"]["kernel"]
            out[t + "attn.c_attn.bias"] = blk["attn"]["qkv"]["bias"]
            out[t + "attn.c_proj.weight"] = blk["attn"]["out"]["kernel"]
            out[t + "attn.c_proj.bias"] = blk["attn"]["out"]["bias"]
            out[t + "ln_2.weight"] = blk["ln_2"]["scale"]
            out[t + "ln_2.bias"] = blk["ln_2"]["bias"]
            out[t + "mlp.c_fc.weight"] = blk["mlp"]["fc"]["kernel"]
            out[t + "mlp.c_fc.bias"] = blk["mlp"]["fc"]["bias"]
            out[t + "mlp.c_proj.weight"] = blk["mlp"]["proj"]["kernel"]
            out[t + "mlp.c_proj.bias"] = blk["mlp"]["proj"]["bias"]
    if config.tie_word_embeddings:
        out["lm_head.weight"] = out["transformer.wte.weight"]
    else:
        out["lm_head.weight"] = p["lm_head"]["kernel"][:, :Vt].T
        if "bias" in p["lm_head"]:
            out["lm_head.bias"] = p["lm_head"]["bias"][:Vt]
    return {k: v.contiguous() for k, v in out.items()}


def _params_to_llama(p: Dict[str, Any], config: TransformerConfig) -> StateDict:
    Vt = config.vocab_size
    D = config.hidden_size
    out: StateDict = {
        "model.embed_tokens.weight": p["wte"]["embedding"][:Vt],
        "model.norm.weight": p["ln_f"]["scale"],
    }
    for i in range(config.num_layers):
        blk = p[f"h_{i}"]
        t = f"model.layers.{i}."
        qkv = blk["attn"]["qkv"]["kernel"]
        out[t + "input_layernorm.weight"] = blk["ln_1"]["scale"]
        out[t + "post_attention_layernorm.weight"] = blk["ln_2"]["scale"]
        out[t + "self_attn.q_proj.weight"] = qkv[:, :D].T
        out[t + "self_attn.k_proj.weight"] = qkv[:, D: 2 * D].T
        out[t + "self_attn.v_proj.weight"] = qkv[:, 2 * D:].T
        out[t + "self_attn.o_proj.weight"] = blk["attn"]["out"]["kernel"].T
        out[t + "mlp.gate_proj.weight"] = blk["mlp"]["fc"]["kernel"].T
        out[t + "mlp.up_proj.weight"] = blk["mlp"]["gate"]["kernel"].T
        out[t + "mlp.down_proj.weight"] = blk["mlp"]["proj"]["kernel"].T
    if config.tie_word_embeddings:
        out["lm_head.weight"] = out["model.embed_tokens.weight"]
    else:
        out["lm_head.weight"] = p["lm_head"]["kernel"][:, :Vt].T
    return {k: v.contiguous() for k, v in out.items()}


def _tree_f32(tree: Mapping) -> Dict[str, Any]:
    return {k: _tree_f32(v) if isinstance(v, Mapping) else _f32(v) for k, v in tree.items()}


# ---------------- T5 (encoder-decoder) ----------------


def encdec_config_from_hf(hf_config) -> "EncDecConfig":
    """A T5Config (or its config.json dict) → EncDecConfig."""
    from lmrl_gym_torch.models.encdec import EncDecConfig

    get = _getter(hf_config)
    assert get("model_type") == "t5", get("model_type")
    proj = get("feed_forward_proj", "relu")
    proj = "gated-gelu" if "gated" in proj else "relu"
    return EncDecConfig(
        vocab_size=get("vocab_size", 32128),
        d_model=get("d_model", 512),
        d_kv=get("d_kv", 64),
        d_ff=get("d_ff", 2048),
        num_layers=get("num_layers", 6),
        num_decoder_layers=get("num_decoder_layers"),
        num_heads=get("num_heads", 8),
        relative_attention_num_buckets=get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=get("relative_attention_max_distance", 128),
        feed_forward_proj=proj,
        layer_norm_epsilon=get("layer_norm_epsilon", 1e-6),
        dropout_rate=get("dropout_rate", 0.1),
        tie_word_embeddings=bool(get("tie_word_embeddings", True)),
        decoder_start_token_id=get("decoder_start_token_id", 0),
        pad_token_id=get("pad_token_id", 0),
    )


def _t5_attn(sd: StateDict, prefix: str) -> Dict[str, Any]:
    return {n: {"kernel": sd[prefix + f"{n}.weight"].T} for n in ("q", "k", "v", "o")}


def _t5_mlp(sd: StateDict, prefix: str, gated: bool) -> Dict[str, Any]:
    names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
    return {n: {"kernel": sd[prefix + f"{n}.weight"].T} for n in names}


def encdec_params_from_hf_state_dict(state: Mapping[str, Any], config) -> StateDict:
    """HF T5ForConditionalGeneration state dict → the port's
    `EncoderDecoder` state dict (float32)."""
    sd = {k: _f32(v) for k, v in state.items()}
    V = config.padded_vocab_size
    gated = config.feed_forward_proj == "gated-gelu"
    params: Dict[str, Any] = {
        "shared": {"embedding": _pad_rows(sd["shared.weight"], V)},
        "enc_rel_bias": {"embedding": sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]},
        "dec_rel_bias": {"embedding": sd["decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]},
        "enc_ln_f": {"scale": sd["encoder.final_layer_norm.weight"]},
        "dec_ln_f": {"scale": sd["decoder.final_layer_norm.weight"]},
    }
    for i in range(config.num_layers):
        p = f"encoder.block.{i}."
        params[f"enc_blocks_{i}"] = {
            "ln_self": {"scale": sd[p + "layer.0.layer_norm.weight"]},
            "self_attn": _t5_attn(sd, p + "layer.0.SelfAttention."),
            "ln_mlp": {"scale": sd[p + "layer.1.layer_norm.weight"]},
            "mlp": _t5_mlp(sd, p + "layer.1.DenseReluDense.", gated),
        }
    for i in range(config.n_dec_layers):
        p = f"decoder.block.{i}."
        params[f"dec_blocks_{i}"] = {
            "ln_self": {"scale": sd[p + "layer.0.layer_norm.weight"]},
            "self_attn": _t5_attn(sd, p + "layer.0.SelfAttention."),
            "ln_cross": {"scale": sd[p + "layer.1.layer_norm.weight"]},
            "cross_attn": _t5_attn(sd, p + "layer.1.EncDecAttention."),
            "ln_mlp": {"scale": sd[p + "layer.2.layer_norm.weight"]},
            "mlp": _t5_mlp(sd, p + "layer.2.DenseReluDense.", gated),
        }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": _pad_rows(sd["lm_head.weight"], V).T}
    return encdec_params_from_jax(params)


def encdec_params_to_hf_state_dict(params, config) -> StateDict:
    """Inverse of encdec_params_from_hf_state_dict (padding stripped);
    `params` is the port's `EncoderDecoder` or its state dict."""
    p = _tree_f32(encdec_params_to_jax(_state_dict(params)))
    Vt = config.vocab_size
    gated = config.feed_forward_proj == "gated-gelu"
    out: StateDict = {
        "shared.weight": p["shared"]["embedding"][:Vt],
        "encoder.embed_tokens.weight": p["shared"]["embedding"][:Vt],
        "decoder.embed_tokens.weight": p["shared"]["embedding"][:Vt],
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": p["enc_rel_bias"]["embedding"],
        "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": p["dec_rel_bias"]["embedding"],
        "encoder.final_layer_norm.weight": p["enc_ln_f"]["scale"],
        "decoder.final_layer_norm.weight": p["dec_ln_f"]["scale"],
    }

    def put_attn(dst: str, attn: Dict[str, Any]):
        for n in ("q", "k", "v", "o"):
            out[dst + f"{n}.weight"] = attn[n]["kernel"].T

    def put_mlp(dst: str, mlp: Dict[str, Any]):
        for n in ("wi_0", "wi_1", "wo") if gated else ("wi", "wo"):
            out[dst + f"{n}.weight"] = mlp[n]["kernel"].T

    for i in range(config.num_layers):
        blk = p[f"enc_blocks_{i}"]
        t = f"encoder.block.{i}."
        out[t + "layer.0.layer_norm.weight"] = blk["ln_self"]["scale"]
        put_attn(t + "layer.0.SelfAttention.", blk["self_attn"])
        out[t + "layer.1.layer_norm.weight"] = blk["ln_mlp"]["scale"]
        put_mlp(t + "layer.1.DenseReluDense.", blk["mlp"])
    for i in range(config.n_dec_layers):
        blk = p[f"dec_blocks_{i}"]
        t = f"decoder.block.{i}."
        out[t + "layer.0.layer_norm.weight"] = blk["ln_self"]["scale"]
        put_attn(t + "layer.0.SelfAttention.", blk["self_attn"])
        out[t + "layer.1.layer_norm.weight"] = blk["ln_cross"]["scale"]
        put_attn(t + "layer.1.EncDecAttention.", blk["cross_attn"])
        out[t + "layer.2.layer_norm.weight"] = blk["ln_mlp"]["scale"]
        put_mlp(t + "layer.2.DenseReluDense.", blk["mlp"])
    if config.tie_word_embeddings:
        out["lm_head.weight"] = out["shared.weight"]
    else:
        out["lm_head.weight"] = p["lm_head"]["kernel"][:, :Vt].T
    return {k: v.contiguous() for k, v in out.items()}


# ---------------- safetensors, without the safetensors package ----------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> StateDict:
    """A .safetensors file → {name: CPU tensor}: an 8-byte little-endian
    header length, a JSON header ({name: {dtype, shape, data_offsets}},
    offsets relative to the end of the header), then the raw bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        out[name] = torch.frombuffer(bytearray(data[start:end]), dtype=dtype).reshape(info["shape"])
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """{name: tensor} → a .safetensors file in the layout `read_safetensors`
    (and the safetensors package) reads; the header is space-padded to a
    multiple of 8 bytes."""
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    blobs = []
    offset = 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def read_hf_state_dict(path: str) -> StateDict:
    """The weights of an HF checkpoint directory: `model.safetensors`, a
    sharded `model.safetensors.index.json`, or `pytorch_model.bin`."""
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return read_safetensors(single)
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out: StateDict = {}
        for shard in shards:
            out.update(read_safetensors(os.path.join(path, shard)))
        return out
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {path}")


def load_hf_pretrained(path: str, device: DeviceLike = None, param_dtype: torch.dtype = torch.float32,
                       **overrides):
    """(config, `Transformer` on `device` with parameters in `param_dtype`) from a
    local HF checkpoint directory (GPT-2, GPT-J or LLaMA), read without
    `transformers`; `overrides` replace config fields (e.g. the activation
    `dtype`, `pad_vocab_to_multiple`) before the model is built."""
    with open(os.path.join(path, "config.json")) as f:
        config = config_from_hf(json.load(f)).replace(**overrides)
    model = Transformer(config, device=resolve_device(device), dtype=param_dtype)
    model.load_state_dict(params_from_hf_state_dict(read_hf_state_dict(path), config))
    return config, model


def hf_config_dict(config: TransformerConfig) -> Dict[str, Any]:
    """The config.json transformers writes for this config's family."""
    if config.norm == "rmsnorm":
        return dict(
            architectures=["LlamaForCausalLM"], model_type="llama",
            vocab_size=config.vocab_size, max_position_embeddings=config.max_position_embeddings,
            hidden_size=config.hidden_size, num_hidden_layers=config.num_layers,
            num_attention_heads=config.num_heads, num_key_value_heads=config.num_heads,
            intermediate_size=config.intermediate_size, rope_theta=config.rotary_base,
            rms_norm_eps=config.layer_norm_epsilon, hidden_act="silu",
            tie_word_embeddings=config.tie_word_embeddings, torch_dtype="float32",
        )
    if config.position_embedding == "learned":
        return dict(
            architectures=["GPT2LMHeadModel"], model_type="gpt2",
            vocab_size=config.vocab_size, n_positions=config.max_position_embeddings,
            n_embd=config.hidden_size, n_layer=config.num_layers, n_head=config.num_heads,
            n_inner=config.intermediate_size, activation_function=config.activation,
            layer_norm_epsilon=config.layer_norm_epsilon, tie_word_embeddings=True, torch_dtype="float32",
        )
    return dict(
        architectures=["GPTJForCausalLM"], model_type="gptj",
        vocab_size=config.vocab_size, n_positions=config.max_position_embeddings,
        n_embd=config.hidden_size, n_layer=config.num_layers, n_head=config.num_heads,
        n_inner=config.intermediate_size, rotary_dim=config.rotary_dim,
        activation_function=config.activation, layer_norm_epsilon=config.layer_norm_epsilon,
        tie_word_embeddings=False, torch_dtype="float32",
    )


def export_hf_pretrained(params, config: TransformerConfig, path: str, tokenizer=None) -> None:
    """Write a transformers-loadable checkpoint dir (config.json and
    model.safetensors, float32) from the port's `Transformer` or its state
    dict, without `transformers`; an HF tokenizer is saved beside it."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(config), f, indent=2)
    write_safetensors(params_to_hf_state_dict(params, config), os.path.join(path, "model.safetensors"))
    if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(path)
