"""Optimizers: the optax pieces the JAX package uses, written for PyTorch.

The port of `lmrl_gym_tpu/core/optimizer.py` and of the optax
transformations behind it. A transformation is an (init, update) pair, as
in optax, over a dict {parameter name: tensor}:

- `init(params)` → state;
- `update(updates, state, params)` → (updates, state). Updates are the
  caller's gradients, consumed: a transformation may scale them in place.
  State tensors (Adam's moments, the accumulated gradients) are updated in
  place; step counts are host ints, so nothing here waits for the card.

`TrainState` (flax's `TrainState`) holds a module, its transformation and
the optimizer state, and applies gradients in place under `torch.no_grad()`
(the PyTorch idiom for the JAX step's donated state). Every parameter gets
an update on every step, zero gradients included: Adam's moments decay and
weight decay applies to parameters that received a zero gradient, as in
optax (`torch.optim` would skip a parameter whose `.grad` is None).

Defaults are optax's, not torch.optim's: `adamw` has weight_decay=1e-4;
`clip_by_global_norm` scales by c/‖g‖ only when ‖g‖ ≥ c and adds no epsilon.
Schedules are host functions of the update count: the learning rate of
update i (counting from 0) is `schedule(i)`.

Sharded modules (FSDP2, `parallel/mesh.py`) hold `DTensor` parameters,
gradients and optimizer state; every transformation works on each rank's
local block, elementwise as before, and `clip_by_global_norm` sums the
squared norm over the ranks that hold the blocks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Optional[Params]], Tuple[Params, Any]]


class EmptyState(NamedTuple):
    pass


def named_params(module: Union[nn.Module, Params]) -> Params:
    return module if isinstance(module, dict) else dict(module.named_parameters())


def _local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local block (a view: in-place ops reach the
    `DTensor`); a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _values(d: Params, keys: List[str]) -> List[torch.Tensor]:
    return [_local(d[k]) for k in keys]


def _shard_groups(params: Optional[Params]) -> List[Any]:
    """The process groups over which sharded parameters' blocks are split
    (FSDP2's shard dim); empty for plain parameters and one-rank groups."""
    for p in (params or {}).values():
        if isinstance(p, DTensor):
            groups = [p.device_mesh.get_group(d) for d, pl in enumerate(p.placements) if pl.is_shard()]
            return [g for g in groups if dist.get_world_size(g) > 1]  # a one-rank group holds whole tensors
        return []
    return []


# ---- schedules (optax.schedules) ----


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int, transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        c = min(max(count - transition_begin, 0), transition_steps)
        return (init_value - end_value) * (1 - c / transition_steps) + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
    exponent: float = 1.0,
) -> Schedule:
    """Linear warmup to `peak_value` over `warmup_steps`, then cosine decay
    to `end_value` at `decay_steps` (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)


# ---- transformations ----


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def set_to_zero() -> GradientTransformation:
    """Every update is zero (a frozen parameter group)."""

    def update(updates, state, params=None):
        return {k: torch.zeros_like(u) for k, u in updates.items()}, state

    return GradientTransformation(lambda params: EmptyState(), update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's rule: g·c/‖g‖ when ‖g‖ ≥ c, else g unchanged; the norm is
    taken over every tensor together, on the device (for sharded
    parameters, over every rank's blocks: one all-reduce of the sum of
    squares)."""

    def update(updates, state, params=None):
        keys = list(updates)
        g = _values(updates, keys)
        if not g:
            return updates, state
        groups = _shard_groups(params)
        if groups:
            sq = torch.stack(torch._foreach_norm(g)).square().sum()
            for group in groups:
                dist.all_reduce(sq, group=group)
            g_norm = sq.sqrt()
        else:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        keep = g_norm < max_norm
        clipped = torch._foreach_div(g, g_norm)  # (g / ‖g‖)·c, in optax's order
        torch._foreach_mul_(clipped, max_norm)
        return {k: torch.where(keep, t, c) for k, t, c in zip(keys, g, clipped)}, state

    return GradientTransformation(lambda params: EmptyState(), update)


class ScaleByAdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay**count as optax's jitted float32 code gives it: the power
    of the float32 decay, rounded once to float32, then the float32
    subtraction. In float64 throughout, the cancellation at decay = 0.999
    would move Adam's first updates by ~1e-5 relative."""
    decay32 = float(torch.tensor(decay, dtype=torch.float32))
    return float(1 - torch.tensor(decay32**count, dtype=torch.float32))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(
            0, {k: torch.zeros_like(p) for k, p in params.items()}, {k: torch.zeros_like(p) for k, p in params.items()}
        )

    def update(updates, state, params=None):
        keys = list(updates)
        g, mu, nu = _values(updates, keys), _values(state.mu, keys), _values(state.nu, keys)
        # (1 − b)·x + b·m with each product rounded on its own, in optax's order
        new = torch._foreach_mul(g, 1 - b1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, new)
        new = torch._foreach_mul(g, g)
        torch._foreach_mul_(new, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, new)
        del new
        count = state.count + 1
        denom = torch._foreach_div(nu, _bias_correction(b2, count))
        if eps_root:
            torch._foreach_add_(denom, eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        out = torch._foreach_div(mu, _bias_correction(b1, count))
        torch._foreach_div_(out, denom)
        return dict(zip(keys, out)), ScaleByAdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


def add_decayed_weights(
    weight_decay: float = 0.0, mask: Optional[Union[Dict[str, bool], Callable[[Params], Dict[str, bool]]]] = None
) -> GradientTransformation:
    """u + weight_decay·p on the parameters the mask selects (all if None)."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        m = mask(params) if callable(mask) else mask
        keys = [k for k in updates if m is None or m[k]]
        if keys and weight_decay:
            torch._foreach_add_(_values(updates, keys), torch._foreach_mul(_values(params, keys), weight_decay))
        return updates, state

    return GradientTransformation(lambda params: EmptyState(), update)


class ScaleByScheduleState(NamedTuple):
    count: int


def scale_by_learning_rate(learning_rate: ScalarOrSchedule) -> GradientTransformation:
    """u·(−lr), with lr = schedule(count) for a schedule, count from 0."""
    if not callable(learning_rate):

        def update_const(updates, state, params=None):
            torch._foreach_mul_(_values(updates, list(updates)), -learning_rate)
            return updates, state

        return GradientTransformation(lambda params: EmptyState(), update_const)

    def update(updates, state, params=None):
        torch._foreach_mul_(_values(updates, list(updates)), -learning_rate(state.count))
        return updates, ScaleByScheduleState(state.count + 1)

    return GradientTransformation(lambda params: ScaleByScheduleState(0), update)


def adam(
    learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0
) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root), scale_by_learning_rate(learning_rate))


def adamw(
    learning_rate: ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    eps_root: float = 0.0,
    weight_decay: float = 1e-4,
    mask: Optional[Union[Dict[str, bool], Callable[[Params], Dict[str, bool]]]] = None,
) -> GradientTransformation:
    return chain(
        scale_by_adam(b1, b2, eps, eps_root),
        add_decayed_weights(weight_decay, mask),
        scale_by_learning_rate(learning_rate),
    )


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: Any
    acc_grads: Params


def multi_steps(opt: GradientTransformation, every_k_schedule: int) -> GradientTransformation:
    """optax.MultiSteps: gradient accumulation. Each call folds the
    gradients into their running mean (acc + (g − acc)/(mini_step + 1));
    the k-th call hands the mean to `opt` and returns its updates, the
    others return zero updates and leave `opt`'s state as it was."""
    k = every_k_schedule

    def init(params):
        return MultiStepsState(0, 0, opt.init(params), {n: torch.zeros_like(p) for n, p in params.items()})

    def update(updates, state, params=None):
        keys = list(updates)
        acc = _values(state.acc_grads, keys)
        diff = torch._foreach_sub(_values(updates, keys), acc)
        torch._foreach_div_(diff, state.mini_step + 1)
        torch._foreach_add_(acc, diff)
        if state.mini_step < k - 1:
            zeros = {n: torch.zeros_like(u) for n, u in updates.items()}
            return zeros, MultiStepsState(state.mini_step + 1, state.gradient_step, state.inner_opt_state, state.acc_grads)
        final, inner = opt.update(dict(zip(keys, acc)), state.inner_opt_state, params)
        # fresh zeros: the inner updates may alias the accumulators
        fresh = {n: torch.zeros_like(a) for n, a in state.acc_grads.items()}
        return final, MultiStepsState(0, state.gradient_step + 1, inner, fresh)

    return GradientTransformation(init, update)


def apply_updates(params: Params, updates: Params) -> None:
    """p += u in place for every parameter."""
    keys = list(updates)
    with torch.no_grad():
        torch._foreach_add_(_values(params, keys), _values(updates, keys))


class TrainState:
    """flax's TrainState for a module: `params` is the module itself,
    `step` counts every `apply_gradients` call (grad-accumulation mini steps
    included)."""

    def __init__(self, params: nn.Module, tx: GradientTransformation):
        self.params = params
        self.tx = tx
        self.opt_state = tx.init(named_params(params))
        self.step = 0

    def apply_gradients(self, grads: Params) -> "TrainState":
        named = named_params(self.params)
        updates, self.opt_state = self.tx.update(grads, self.opt_state, named)
        apply_updates(named, updates)
        self.step += 1
        return self


def value_and_grads(loss: torch.Tensor, modules: Tuple[nn.Module, ...]) -> Tuple[Params, ...]:
    """Gradients of `loss` for every parameter of each module, one dict per
    module, zeros where the loss does not reach a parameter (as `jax.grad`
    gives them), so `apply_gradients` updates every parameter.

    Sharded modules take `loss.backward()`, whose FSDP2 hooks reduce each
    rank's part into the parameters' sharded `.grad`, rescaled from FSDP2's
    average to the sum (`grad_scale`, `parallel/mesh.py::shard_pytree`)."""
    sharded = [getattr(m, "grad_scale", None) is not None for m in modules]
    if any(sharded):
        if not all(sharded):
            raise ValueError("a step over sharded modules needs every trained module sharded")
        return _sharded_grads(loss, modules)
    named = [named_params(m) for m in modules]
    flat = [p for d in named for p in d.values()]
    if loss.requires_grad:
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    else:
        grads = [torch.zeros_like(p) for p in flat]
    out, i = [], 0
    for d in named:
        out.append(dict(zip(d, grads[i:i + len(d)])))
        i += len(d)
    return tuple(out)


def _sharded_grads(loss: torch.Tensor, modules: Tuple[nn.Module, ...]) -> Tuple[Params, ...]:
    if loss.requires_grad:
        loss.backward()
    out = []
    for m in modules:
        grads = {}
        for n, p in m.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            if m.grad_scale != 1.0:
                _local(g).mul_(m.grad_scale)
            grads[n] = g
        out.append(grads)
    return tuple(out)


def incremental_update(new: nn.Module, target: nn.Module, step_size: float) -> None:
    """target ← step_size·new + (1 − step_size)·target, in place (Polyak)."""
    t, p = _values(named_params(target), list(named_params(target))), _values(named_params(new), list(named_params(new)))
    with torch.no_grad():
        torch._foreach_mul_(t, 1.0 - step_size)
        torch._foreach_add_(t, p, alpha=step_size)


def periodic_update(new: nn.Module, target: nn.Module, steps: int, update_period: int) -> None:
    """target ← new, in place, when steps % update_period == 0."""
    if steps % update_period == 0:
        with torch.no_grad():
            torch._foreach_copy_(_values(named_params(target), list(named_params(target))),
                                 _values(named_params(new), list(named_params(new))))


# ---- the JAX package's optimizer surface ----


def weight_decay_mask(params: Union[nn.Module, Params]) -> Dict[str, bool]:
    """True (decayed) for ≥ 2-D weights; False for biases, norm scales and
    1-D tensors. The JAX package's rule on flax paths ('bias', 'scale' or
    'ln' in the path → False) picks the same leaves on the port's names."""

    def is_decayed(name: str, p: torch.Tensor) -> bool:
        if "bias" in name or "scale" in name or "ln" in name.lower():
            return False
        return p.ndim >= 2

    return {n: is_decayed(n, p) for n, p in named_params(params).items()}


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    end_lr_ratio: float = 0.1
    warmup_steps: int = 0
    total_steps: Optional[int] = None  # None → constant after warmup
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    grad_accum_steps: int = 1

    def to_dict(self) -> dict:
        import dataclasses

        return dataclasses.asdict(self)


def make_optimizer(config: OptimizerConfig, params: Union[nn.Module, Params]) -> GradientTransformation:
    if config.total_steps is not None:
        schedule: ScalarOrSchedule = warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=config.lr,
            warmup_steps=max(config.warmup_steps, 1),
            decay_steps=max(config.total_steps, config.warmup_steps + 1),
            end_value=config.lr * config.end_lr_ratio,
        )
    elif config.warmup_steps > 0:
        schedule = linear_schedule(0.0, config.lr, config.warmup_steps)
    else:
        schedule = config.lr

    txs = []
    if config.grad_clip is not None:
        txs.append(clip_by_global_norm(config.grad_clip))
    txs.append(
        adamw(
            learning_rate=schedule,
            b1=config.b1,
            b2=config.b2,
            eps=config.eps,
            weight_decay=config.weight_decay,
            mask=weight_decay_mask(params) if config.weight_decay > 0 else None,
        )
    )
    tx = chain(*txs)
    if config.grad_accum_steps > 1:
        tx = multi_steps(tx, every_k_schedule=config.grad_accum_steps)
    return tx


def map_param_state(opt_state: Any, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> Any:
    """The optimizer state with every per-parameter tensor (the dicts keyed
    by parameter name: Adam's moments, accumulated gradients) replaced by
    `fn(name, tensor)`; counts stay."""
    if isinstance(opt_state, dict):
        return {k: fn(k, v) for k, v in opt_state.items()}
    if isinstance(opt_state, tuple) and hasattr(opt_state, "_fields"):
        return type(opt_state)(*(map_param_state(x, fn) for x in opt_state))
    if isinstance(opt_state, (list, tuple)):
        return type(opt_state)(map_param_state(x, fn) for x in opt_state)
    return opt_state


def mini_step_of(opt_state: Any) -> Optional[int]:
    """MultiSteps microstep counter, or None for plain optimizers."""
    return getattr(opt_state, "mini_step", None)
