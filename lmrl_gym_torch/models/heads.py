"""Value heads on top of the transformer trunk: the port of
`lmrl_gym_tpu/models/heads.py`.

- LinearHead: one dense layer with a configurable bias init;
- MLPHead: dense1 → gelu (flax's default tanh approximation, whatever the
  config string says) or relu → dropout (training only) → dense2, with the
  zero-init last layer
  (`layer2_initializer_range=0.0`) and `layer2_bias_init` of the ILQL Q/V
  heads.

Each head computes in its config's dtype (float32 by default), casting its
input and parameters as flax's `Dense(dtype=...)` does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lmrl_gym_torch.core.device import DeviceLike, resolve_device, torch_dtype
from lmrl_gym_torch.models.transformer import dense, dropout


@dataclass(frozen=True)
class LinearHeadConfig:
    input_dim: int
    output_dim: int
    use_bias: bool = True
    initializer_range: float = 0.02
    bias_init: float = 0.0
    dtype: str = "float32"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class LinearHead(nn.Module):
    def __init__(
        self,
        config: LinearHeadConfig,
        device: DeviceLike = None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dense = nn.Linear(config.input_dim, config.output_dim, bias=config.use_bias, device=device, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            nn.init.normal_(self.dense.weight, 0.0, config.initializer_range, generator=gen)
            if self.dense.bias is not None:
                nn.init.constant_(self.dense.bias, config.bias_init)

    def forward(self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`deterministic` and `generator` have no effect: a linear head has
        no dropout. They give it MLPHead's signature, so a caller (such as
        `ilql_forward`) can call either head the same way, as the flax
        LinearHead's ignored `deterministic` does."""
        return dense(self.dense, x, torch_dtype(self.config.dtype))


@dataclass(frozen=True)
class MLPHeadConfig:
    input_dim: int
    hidden_dim: int
    output_dim: int
    use_bias: bool = True
    initializer_range: float = 0.02
    layer2_initializer_range: Optional[float] = None  # 0.0 → zero-init
    layer2_bias_init: Optional[float] = None
    activation: str = "gelu"
    dropout: float = 0.0
    dtype: str = "float32"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class MLPHead(nn.Module):
    def __init__(
        self,
        config: MLPHeadConfig,
        device: DeviceLike = None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        cfg = config
        self.dense1 = nn.Linear(cfg.input_dim, cfg.hidden_dim, bias=cfg.use_bias, device=device, dtype=dtype)
        self.dense2 = nn.Linear(cfg.hidden_dim, cfg.output_dim, bias=cfg.use_bias, device=device, dtype=dtype)
        l2_range = cfg.layer2_initializer_range if cfg.layer2_initializer_range is not None else cfg.initializer_range
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            nn.init.normal_(self.dense1.weight, 0.0, cfg.initializer_range, generator=gen)
            if l2_range == 0.0:
                nn.init.zeros_(self.dense2.weight)
            else:
                nn.init.normal_(self.dense2.weight, 0.0, l2_range, generator=gen)
            if cfg.use_bias:
                nn.init.zeros_(self.dense1.bias)
                nn.init.constant_(self.dense2.bias, cfg.layer2_bias_init or 0.0)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """Dropout after the activation applies only in training
        (`deterministic=False`), with masks from `generator`."""
        cfg = self.config
        dtype = torch_dtype(cfg.dtype)
        h = dense(self.dense1, x, dtype)
        # flax nn.gelu defaults to approximate=True: the tanh form
        h = F.gelu(h, approximate="tanh") if cfg.activation == "gelu" else F.relu(h)
        if cfg.dropout > 0 and not deterministic:
            if generator is None:
                raise ValueError("MLPHead dropout in training draws its mask from `generator`; pass one")
            h = dropout(h, cfg.dropout, generator)
        return dense(self.dense2, h, dtype)
