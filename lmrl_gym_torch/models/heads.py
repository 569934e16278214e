"""Value heads on top of the transformer trunk: the port of
`lmrl_gym_tpu/models/heads.py`.

- LinearHead: one dense layer with a configurable bias init;
- MLPHead: dense1 → gelu (flax's default tanh approximation, whatever the
  config string says) or relu → dropout (training only) → dense2, with the
  zero-init last layer
  (`layer2_initializer_range=0.0`) and `layer2_bias_init` of the ILQL Q/V
  heads.

Each head computes in its config's dtype (float32 by default), casting its
input and parameters as flax's `Dense(dtype=...)` does. `matmul_precision`
mirrors `jax_default_matmul_precision`: "float32" (the default, what the JAX
package computes on the CPU) or "bfloat16", which rounds both operands of
every head product to bf16 and accumulates in f32, forward and backward, as
XLA's default precision does to an f32 dot on a TPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lmrl_gym_torch.core.device import DeviceLike, resolve_device, torch_dtype
from lmrl_gym_torch.models.transformer import dense, dropout
from lmrl_gym_torch.parallel.mesh import Spec

MATMUL_PRECISIONS = ("float32", "bfloat16")


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16, the products summed in f32:
    bf16 × bf16 is exact in f32, so an f32 matmul of the rounded operands
    (TF32 off) is the one-pass bf16 product with f32 accumulation."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


class _Bf16Linear(torch.autograd.Function):
    """y = bf16(x)·bf16(W)ᵀ in f32; the backward's two products round their
    operands too (dX = bf16(dY)·bf16(W), dW = bf16(dY)ᵀ·bf16(X)), as XLA
    does for the transposed dots of a DEFAULT-precision dot."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return _bf16_mm(x, w.t())

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dx = _bf16_mm(dy, w) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = _bf16_mm(dy.reshape(-1, dy.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        return dx, dw


def head_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, matmul_precision: str) -> torch.Tensor:
    """`dense` under the head's `matmul_precision`; the bias add stays in
    `dtype`."""
    if matmul_precision == "float32":
        return dense(layer, x, dtype)
    if matmul_precision != "bfloat16":
        raise ValueError(f"matmul_precision must be one of {MATMUL_PRECISIONS}, got {matmul_precision!r}")
    y = _Bf16Linear.apply(x.to(dtype), layer.weight.to(dtype)).to(dtype)
    return y if layer.bias is None else y + layer.bias.to(dtype)


@dataclass(frozen=True)
class LinearHeadConfig:
    input_dim: int
    output_dim: int
    use_bias: bool = True
    initializer_range: float = 0.02
    bias_init: float = 0.0
    dtype: str = "float32"
    matmul_precision: str = "float32"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def partition_rules(self) -> Tuple[Tuple[str, Spec], ...]:
        return ((".*", Spec()),)  # replicated, as in the JAX package


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
        return head_dense(self.dense, x, torch_dtype(self.config.dtype), self.config.matmul_precision)


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
    matmul_precision: str = "float32"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def partition_rules(self) -> Tuple[Tuple[str, Spec], ...]:
        """The JAX package's table over flax key paths."""
        return (
            ("dense1/kernel", Spec("fsdp", "mp")),
            ("dense2/kernel", Spec("mp", "fsdp")),
            ("dense1/bias", Spec("mp")),
            (".*", Spec()),
        )


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
        h = head_dense(self.dense1, x, dtype, cfg.matmul_precision)
        # flax nn.gelu defaults to approximate=True: the tanh form
        h = F.gelu(h, approximate="tanh") if cfg.activation == "gelu" else F.relu(h)
        if cfg.dropout > 0 and not deterministic:
            if generator is None:
                raise ValueError("MLPHead dropout in training draws its mask from `generator`; pass one")
            h = dropout(h, cfg.dropout, generator)
        return head_dense(self.dense2, h, dtype, cfg.matmul_precision)


def head_from_key(head: nn.Module, key: torch.Tensor) -> nn.Module:
    """`head` (a `LinearHead` or `MLPHead`) with the weights the JAX
    package's `init_head_params(flax head, input_dim, key)` draws
    (`lmrl_gym_tpu/models/heads.py:124`): each normal-initialized Dense
    kernel under its module's flax key (`core/threefry.py`; within 1e-6 of
    JAX's), constant kernels and biases as built. Loaded in place; returns
    `head`. `key` is a JAX key as an int64 [2] tensor."""
    from lmrl_gym_torch.core.threefry import flax_normal_init
    from lmrl_gym_torch.models.convert import head_params_from_jax, head_params_to_jax

    cfg = head.config
    if isinstance(head, MLPHead):
        l2 = cfg.layer2_initializer_range if cfg.layer2_initializer_range is not None else cfg.initializer_range
        std = {"dense1": cfg.initializer_range, "dense2": None if l2 == 0.0 else l2}
    else:
        std = {"dense": cfg.initializer_range}
    device = next(head.parameters()).device
    drawn = flax_normal_init(head_params_to_jax(head.state_dict()), key.to(device),
                             lambda path: std[path[0]] if path[-1] == "kernel" else None)
    head.load_state_dict(head_params_from_jax(drawn))
    return head
