"""Encoder-decoder (T5 family) in PyTorch: the port of
`lmrl_gym_tpu/models/encdec.py`.

T5 semantics as the JAX package has them: RMSNorm without mean-centring,
a relative-position bucket bias (one table per stack, shared across its
layers), attention with NO 1/sqrt(d) scale, relu or gated-gelu MLPs, and a
tied head that scales its input by d_model^-0.5 (or an untied f32
`lm_head`, flan-t5). Module and parameter names follow the flax tree
(`shared`, `enc_blocks.<i>.self_attn.q`, ...), so `models/convert.py`
maps one onto the other.

Attention here is plain PyTorch matmuls on CUDA and CPU alike: the JAX
package computes T5 attention as an einsum with an additive bias, outside
any Pallas kernel, so no kernel of the port is on this path. Scores are
f32 products of the dtype-rounded q and k (`preferred_element_type=f32`);
masking is `where`-masking with finfo(f32).min, never an added mask.

Decoding: the encoder runs once, each decoder layer's cross-attention K/V
are projected once (`precompute_cross`), and the decoder steps through
`models/generation.py` with a self-attention `KVCache` (host-int index,
in-place writes) of `1 + max_new_tokens` slots.

Relative-position buckets are read from a table computed once on the CPU
in the JAX package's f32 arithmetic (log, divide, multiply, truncate) for
every offset in [−max_distance, max_distance] and gathered on the device:
at n = 16, 32 and 64 the real value is an exact integer, so one ulp of a
device `log` would move the bucket.

Dropout (training) draws its masks from the caller's `torch.Generator`:
embedding, residual, MLP-hidden and attention-probability dropout, as the
flax module applies them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lmrl_gym_torch.core.device import DeviceLike, resolve_device, torch_dtype
from lmrl_gym_torch.models.transformer import KVCache, RMSNorm, dense, dropout, mask_pad_logits
from lmrl_gym_torch.parallel.mesh import Spec

_NEG = torch.finfo(torch.float32).min


@dataclass(frozen=True)
class EncDecConfig:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6  # encoder layers
    num_decoder_layers: Optional[int] = None  # default = num_layers
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    feed_forward_proj: str = "relu"  # 'relu' | 'gated-gelu' (v1.1/flan)
    layer_norm_epsilon: float = 1e-6
    dropout_rate: float = 0.1
    initializer_factor: float = 1.0
    tie_word_embeddings: bool = True  # v1.1/flan: False
    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    pad_vocab_to_multiple: int = 128
    dtype: str = "bfloat16"

    @property
    def n_dec_layers(self) -> int:
        return self.num_decoder_layers or self.num_layers

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_to_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def replace(self, **kw) -> "EncDecConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EncDecConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def partition_rules(self) -> Tuple[Tuple[str, Spec], ...]:
        """The JAX package's table over flax key paths."""
        return (
            ("shared/embedding", Spec("mp", "fsdp")),
            ("rel_bias/embedding", Spec()),
            ("/(q|k|v)/kernel", Spec("fsdp", "mp")),
            ("/o/kernel", Spec("mp", "fsdp")),
            ("wi(_0|_1)?/kernel", Spec("fsdp", "mp")),
            ("wo/kernel", Spec("mp", "fsdp")),
            ("lm_head/kernel", Spec("fsdp", "mp")),
            (".*scale", Spec()),
            (".*", Spec()),
        )


def t5_small() -> EncDecConfig:
    return EncDecConfig()


def t5_base() -> EncDecConfig:
    return EncDecConfig(d_model=768, d_ff=3072, num_heads=12, num_layers=12)


def flan_t5_xl() -> EncDecConfig:
    """flan-t5-xl — the reference oracle architecture
    (twenty_questions/env/oracle.py:20)."""
    return EncDecConfig(
        d_model=2048,
        d_kv=64,
        d_ff=5120,
        num_layers=24,
        num_heads=32,
        feed_forward_proj="gated-gelu",
        tie_word_embeddings=False,
    )


def tiny_encdec_config(**kw) -> EncDecConfig:
    base = dict(
        vocab_size=259,
        d_model=64,
        d_kv=16,
        d_ff=128,
        num_layers=2,
        num_heads=4,
        dropout_rate=0.0,
        pad_vocab_to_multiple=64,
        dtype="float32",
    )
    base.update(kw)
    return EncDecConfig(**base)


@functools.lru_cache(maxsize=None)
def bucket_table(bidirectional: bool, num_buckets: int = 32, max_distance: int = 128) -> torch.Tensor:
    """[2·max_distance + 1] int64 (CPU): the bucket of every relative
    position rp = key_pos − query_pos in [−max_distance, max_distance], at
    index rp + max_distance, in the JAX package's f32 arithmetic. Offsets
    past ±max_distance fall in the same bucket as ±max_distance (the large
    branch is clamped to num_buckets − 1 from there on)."""
    rp = torch.arange(-max_distance, max_distance + 1, dtype=torch.int64)
    ret = torch.zeros_like(rp)
    n = -rp
    if bidirectional:
        num_buckets //= 2
        ret += (n < 0).to(torch.int64) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    ratio = n.clamp(min=1).to(torch.float32) / max_exact
    # the Python constant rounds to f32, as a weakly typed scalar does in JAX
    scaled = torch.log(ratio) / torch.tensor(math.log(max_distance / max_exact), dtype=torch.float32)
    val_if_large = max_exact + (scaled * float(num_buckets - max_exact)).to(torch.int64)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def relative_position_bucket(
    relative_position: torch.Tensor,  # key_pos − query_pos, any shape
    bidirectional: bool,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """T5's log-spaced relative-position bucketing: a gather from
    `bucket_table` on the positions' device."""
    table = bucket_table(bidirectional, num_buckets, max_distance).to(relative_position.device)
    return table[relative_position.clamp(-max_distance, max_distance) + max_distance]


def compute_position_bias(
    rel_bias_embed: torch.Tensor,  # [num_buckets, H]
    query_pos: torch.Tensor,  # [T_q]
    key_pos: torch.Tensor,  # [T_kv]
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """→ [1, H, T_q, T_kv] additive f32 attention bias."""
    rp = key_pos[None, :] - query_pos[:, None]
    buckets = relative_position_bucket(rp, bidirectional, num_buckets, max_distance)
    return rel_bias_embed[buckets].permute(2, 0, 1)[None].float()


def _linear(d_in: int, d_out: int, device, dtype) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=dtype)


class T5Attention(nn.Module):
    """T5 attention: d_kv-wide heads, no bias terms, no 1/sqrt(d) scale."""

    def __init__(self, config: EncDecConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        D, I = config.d_model, config.inner_dim
        self.q, self.k, self.v = (_linear(D, I, device, dtype) for _ in range(3))
        self.o = _linear(I, D, device, dtype)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        B, L, _ = t.shape
        cfg = self.config
        return t.view(B, L, cfg.num_heads, cfg.d_kv).transpose(1, 2)

    def project_kv(self, kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V (run once per encoder pass)."""
        dtype = torch_dtype(self.config.dtype)
        return self._heads(dense(self.k, kv, dtype)), self._heads(dense(self.v, kv, dtype))

    def forward(
        self,
        x: torch.Tensor,  # [B, T_q, D] (already normed)
        mask: torch.Tensor,  # [B|1, 1, T_q|1, T_kv] bool
        position_bias: Optional[torch.Tensor],  # [1, H, T_q, T_kv] f32
        layer_cache: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,  # (k, v, index), written in place
        static_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross K/V
        generator: Optional[torch.Generator] = None,  # attention-probability dropout when set
    ) -> torch.Tensor:
        cfg = self.config
        B, T, _ = x.shape
        dtype = torch_dtype(cfg.dtype)
        q = self._heads(dense(self.q, x, dtype))
        if static_kv is not None:
            k, v = static_kv  # [B, H, T_enc, Dh]
        else:
            k, v = self._heads(dense(self.k, x, dtype)), self._heads(dense(self.v, x, dtype))
            if layer_cache is not None:
                ck, cv, index = layer_cache
                ck[:, :, index:index + T].copy_(k)
                cv[:, :, index:index + T].copy_(v)
                k, v = ck, cv
        out = self._attend(q, k, v, mask, position_bias, generator)
        return dense(self.o, out.transpose(1, 2).reshape(B, T, cfg.inner_dim), dtype)

    def _attend(self, q, k, v, mask, position_bias, generator) -> torch.Tensor:
        """The attention core on [B, H, T, d_kv] heads: f32 scores from the
        dtype-rounded operands (preferred_element_type=f32), the bias added,
        `where`-masked, softmax, probabilities in the activation dtype."""
        cfg = self.config
        dtype = torch_dtype(cfg.dtype)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if position_bias is not None:
            scores = scores + position_bias
        scores = torch.where(mask, scores, _NEG)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        if generator is not None and cfg.dropout_rate > 0:
            probs = dropout(probs, cfg.dropout_rate, generator)
        return torch.matmul(probs, v.to(dtype))


class T5MLP(nn.Module):
    def __init__(self, config: EncDecConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        D, M = config.d_model, config.d_ff
        if config.feed_forward_proj == "gated-gelu":
            self.wi_0, self.wi_1 = _linear(D, M, device, dtype), _linear(D, M, device, dtype)
        elif config.feed_forward_proj == "relu":
            self.wi = _linear(D, M, device, dtype)
        else:
            raise ValueError(config.feed_forward_proj)
        self.wo = _linear(M, D, device, dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        dtype = torch_dtype(cfg.dtype)
        if cfg.feed_forward_proj == "gated-gelu":
            h = F.gelu(dense(self.wi_0, x, dtype), approximate="tanh") * dense(self.wi_1, x, dtype)
        else:
            h = F.relu(dense(self.wi, x, dtype))
        if generator is not None and cfg.dropout_rate > 0:
            h = dropout(h, cfg.dropout_rate, generator)
        return dense(self.wo, h, dtype)


def _rms(cfg: EncDecConfig, device, dtype) -> RMSNorm:
    # T5LayerNorm == flax RMSNorm(dtype=cfg.dtype): f32 statistics, cfg.dtype output
    return RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, torch_dtype(cfg.dtype), device=device, dtype=dtype)


class T5Block(nn.Module):
    def __init__(self, config: EncDecConfig, is_decoder: bool, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.is_decoder = is_decoder
        self.ln_self = _rms(config, device, dtype)
        self.self_attn = T5Attention(config, device, dtype)
        if is_decoder:
            self.ln_cross = _rms(config, device, dtype)
            self.cross_attn = T5Attention(config, device, dtype)
        self.ln_mlp = _rms(config, device, dtype)
        self.mlp = T5MLP(config, device, dtype)

    def _res_drop(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is not None and self.config.dropout_rate > 0:
            return dropout(h, self.config.dropout_rate, generator)
        return h

    def forward(
        self,
        x: torch.Tensor,
        self_mask: torch.Tensor,
        position_bias: Optional[torch.Tensor],
        cross_mask: Optional[torch.Tensor] = None,
        cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        layer_cache: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        h = self.self_attn(self.ln_self(x), self_mask, position_bias, layer_cache, None, generator)
        x = x + self._res_drop(h, generator)
        if self.is_decoder:
            h = self.cross_attn(self.ln_cross(x), cross_mask, None, None, cross_kv, generator)
            x = x + self._res_drop(h, generator)
        h = self.mlp(self.ln_mlp(x), generator)
        return x + self._res_drop(h, generator)


class EncoderDecoder(nn.Module):
    """T5. Methods: `forward` (full encoder + decoder pass for training and
    scoring), `encode`, `precompute_cross`, `decode_step` (a cached decoder
    step). A `generator` turns on dropout (training); None is inference.

    Built on `device` (default `cuda`; raises without one) with parameters
    in `dtype`, initialized as the flax module is (normal weights with
    T5's per-layer scales, unit norm scales) from `seed`."""

    def __init__(self, config: EncDecConfig, device: DeviceLike = None, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        cfg = config
        self.shared = nn.Embedding(cfg.padded_vocab_size, cfg.d_model, device=device, dtype=dtype)
        nb = cfg.relative_attention_num_buckets
        self.enc_rel_bias = nn.Embedding(nb, cfg.num_heads, device=device, dtype=dtype)
        self.dec_rel_bias = nn.Embedding(nb, cfg.num_heads, device=device, dtype=dtype)
        self.enc_blocks = nn.ModuleList(T5Block(cfg, False, device, dtype) for _ in range(cfg.num_layers))
        self.dec_blocks = nn.ModuleList(T5Block(cfg, True, device, dtype) for _ in range(cfg.n_dec_layers))
        self.enc_ln_f = _rms(cfg, device, dtype)
        self.dec_ln_f = _rms(cfg, device, dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = _linear(cfg.d_model, cfg.padded_vocab_size, device, dtype)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.config
        f = cfg.initializer_factor
        for name, module in self.named_modules():
            if isinstance(module, nn.Linear):
                leaf = name.rsplit(".", 1)[-1]
                fan = {"o": cfg.inner_dim, "wo": cfg.d_ff, "lm_head": 1}.get(leaf, cfg.d_model)
                nn.init.normal_(module.weight, 0.0, f * fan**-0.5, generator=generator)
            elif isinstance(module, nn.Embedding):
                std = f * (1.0 if name == "shared" else cfg.d_model**-0.5)
                nn.init.normal_(module.weight, 0.0, std, generator=generator)

    def _res_drop(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is not None and self.config.dropout_rate > 0:
            return dropout(h, self.config.dropout_rate, generator)
        return h

    def _bias(self, which: str, query_pos: torch.Tensor, key_pos: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        embed = (self.enc_rel_bias if which == "enc" else self.dec_rel_bias).weight
        return compute_position_bias(embed, query_pos, key_pos, which == "enc",
                                     cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.shared.weight).to(torch_dtype(self.config.dtype))

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        T = input_ids.shape[1]
        x = self._res_drop(self._embed(input_ids), generator)
        pos = torch.arange(T, device=input_ids.device)
        bias = self._bias("enc", pos, pos)
        mask = attention_mask[:, None, None, :] > 0  # [B,1,1,T] broadcasts over T_q
        for blk in self.enc_blocks:
            x = blk(x, mask, bias, generator=generator)
        return self._res_drop(self.enc_ln_f(x), generator)

    def precompute_cross(self, enc_hidden: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (cross_k, cross_v) each [L_dec, B, H, T_enc, Dh]."""
        kv = [blk.cross_attn.project_kv(enc_hidden) for blk in self.dec_blocks]
        return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])

    def _decode(
        self,
        decoder_input_ids: torch.Tensor,  # [B, T]
        decoder_attention_mask: torch.Tensor,  # [B, T_kv] (the cache length if cached)
        enc_mask: torch.Tensor,  # [B, T_enc]
        cross_k: torch.Tensor,
        cross_v: torch.Tensor,
        cache: Optional[KVCache],
        generator: Optional[torch.Generator],
    ):
        T = decoder_input_ids.shape[1]
        device = decoder_input_ids.device
        x = self._res_drop(self._embed(decoder_input_ids), generator)
        if cache is not None:
            q_pos = cache.index + torch.arange(T, device=device)
            kv_pos = torch.arange(cache.max_len, device=device)
            causal = kv_pos[None, None, None, :] <= q_pos[None, None, :, None]
        else:
            q_pos = kv_pos = torch.arange(T, device=device)
            causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))[None, None]
        self_mask = causal & (decoder_attention_mask[:, None, None, :] > 0)
        bias = self._bias("dec", q_pos, kv_pos)
        cross_mask = enc_mask[:, None, None, :] > 0  # broadcasts over T_q
        for i, blk in enumerate(self.dec_blocks):
            layer_cache = (cache.k[i], cache.v[i], cache.index) if cache is not None else None
            x = blk(x, self_mask, bias, cross_mask=cross_mask, cross_kv=(cross_k[i], cross_v[i]),
                    layer_cache=layer_cache, generator=generator)
        x = self._res_drop(self.dec_ln_f(x), generator)
        new_cache = cache.advanced(T) if cache is not None else None
        return self._logits(x), x, new_cache

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits: the tied head scales its input by d_model^-0.5 and,
        as flax's Embed.attend, multiplies in the activation dtype; the
        untied `lm_head` is Dense(dtype=float32) on f32 input."""
        cfg = self.config
        if cfg.tie_word_embeddings:
            dtype = torch_dtype(cfg.dtype)
            return F.linear((x * cfg.d_model**-0.5).to(dtype), self.shared.weight.to(dtype)).float()
        return dense(self.lm_head, x, torch.float32)

    def decode_step(
        self,
        decoder_input_ids: torch.Tensor,
        decoder_attention_mask: torch.Tensor,
        enc_mask: torch.Tensor,
        cross_k: torch.Tensor,
        cross_v: torch.Tensor,
        cache: KVCache,
    ):
        logits, _, new_cache = self._decode(decoder_input_ids, decoder_attention_mask, enc_mask, cross_k, cross_v,
                                            cache, None)
        return logits, new_cache

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        decoder_input_ids: torch.Tensor,
        decoder_attention_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ):
        """Full forward → (logits [B,T_dec,V_padded] f32, decoder hidden)."""
        enc_hidden = self.encode(input_ids, attention_mask, generator)
        cross_k, cross_v = self.precompute_cross(enc_hidden)
        logits, hidden, _ = self._decode(decoder_input_ids, decoder_attention_mask, attention_mask, cross_k, cross_v,
                                         None, generator)
        return logits, hidden


def init_encdec_params(config: EncDecConfig, seed: int = 0, device: DeviceLike = None,
                       dtype: torch.dtype = torch.float32) -> EncoderDecoder:
    """A freshly initialized EncoderDecoder (its parameters live in the module)."""
    return EncoderDecoder(config, device=device, dtype=dtype, seed=seed)


class EncDecCore:
    """The (config, device) a T5 runs with, mirroring `interface.LMCore`;
    parameters are an `EncoderDecoder` passed to each call."""

    def __init__(self, config: EncDecConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)

    def forward(
        self,
        params: EncoderDecoder,
        input_ids: torch.Tensor,
        decoder_input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`train=True` runs with dropout (masks from `generator`) under the
        caller's grad mode; `train=False` is an inference forward."""
        if attention_mask is None:
            attention_mask = (input_ids != self.config.pad_token_id).to(torch.int32)
        if decoder_attention_mask is None:
            decoder_attention_mask = torch.ones_like(decoder_input_ids, dtype=torch.int32)
        if train and self.config.dropout_rate > 0 and generator is None:
            raise ValueError("dropout in training draws its masks from `generator`; pass one")
        with torch.enable_grad() if train else torch.no_grad():
            return params(input_ids, attention_mask, decoder_input_ids, decoder_attention_mask,
                          generator if train else None)

    def make_seq2seq_logits_fn(
        self,
        params: EncoderDecoder,
        enc_ids: torch.Tensor,  # [B, T_enc]
        enc_mask: torch.Tensor,  # [B, T_enc]
        total_dec_len: int,
    ):
        """(logits_fn, init_carry) for models.generation.generate: runs the
        encoder and the cross-K/V projections once; the loop steps only the
        decoder, over a self-attention cache of total_dec_len slots."""
        cfg = self.config
        B = enc_ids.shape[0]
        with torch.no_grad():
            enc_hidden = params.encode(enc_ids, enc_mask)
            cross_k, cross_v = params.precompute_cross(enc_hidden)
        shape = (B, cfg.num_heads, total_dec_len, cfg.d_kv)
        dtype = torch_dtype(cfg.dtype)
        cache = KVCache(
            k=tuple(torch.zeros(shape, dtype=dtype, device=enc_ids.device) for _ in range(cfg.n_dec_layers)),
            v=tuple(torch.zeros(shape, dtype=dtype, device=enc_ids.device) for _ in range(cfg.n_dec_layers)),
            index=0,
        )

        def logits_fn(tokens: torch.Tensor, attn_mask: torch.Tensor, cache: KVCache):
            if attn_mask.shape[1] < cache.max_len:
                attn_mask = F.pad(attn_mask, (0, cache.max_len - attn_mask.shape[1]))
            logits, cache = params.decode_step(tokens, attn_mask, enc_mask, cross_k, cross_v, cache)
            return mask_pad_logits(logits, cfg.vocab_size), cache

        return logits_fn, cache

