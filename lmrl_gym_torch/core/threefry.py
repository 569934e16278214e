"""JAX's default PRNG (threefry2x32, the partitionable layout) in plain
PyTorch, on any device, so the port can draw the JAX package's own random
stream from its integer keys: the bits, uniforms, integers, Gumbel noise
and categorical picks `jax.random` gives on the same key and shape, and
the initial weights flax's `Module.init` draws.

A key is an int64 tensor of shape [..., 2] holding the two uint32 words of
a raw JAX key (`jax.random.key_data`); every function takes a batch of
keys (one draw per leading key index), so a rollout's draws over all its
turns and slots are one pass. The 32-bit unsigned arithmetic runs in
int64 with every value brought back into [0, 2^32) by `& 0xFFFFFFFF`
before a right shift reads it; a rotation's left shift stays below 2^62.
That is exact on the CPU and on CUDA alike (torch has no wrapping uint32
add, shift or xor on CUDA).

The Gumbel noise −log(−log(U)) uses XLA's CPU logarithm (`_xla_log`: the
Cephes polynomial with the fused multiply-adds XLA's CPU code makes),
written in f32 operations and f64 products that are exact IEEE arithmetic
on both devices, so the card's Gumbels equal the CPU's and the JAX
package's on the CPU to the bit. U takes only 2^23 values, so the noise is
read from a table of all of them, made once per device.

Sources, in the installed jax (`jax/_src/`): `prng.py` (`threefry_seed`,
`_threefry2x32_lowering`, `_threefry_split_foldlike`, `threefry_fold_in`,
`_threefry_random_bits_partitionable`, `iota_2x32_shape`) and `random.py`
(`_uniform`, `_randint`, `_gumbel` in its default "low" mode,
`categorical`, `_normal_real`, `_truncated_normal`); flax's
`core/scope.py::_fold_in_static` for the per-parameter keys of
`Module.init`. `normal` and `truncated_normal` use XLA's single-precision
erf⁻¹ polynomial over an f64 `log1p`: within 1e-6 of `jax.random` on the
CPU, not bit-exact, and the same on the CPU and the card.
"""
from __future__ import annotations

import functools
import hashlib
import math
from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000  # 1.0f
_F32_TINY = torch.finfo(torch.float32).tiny


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with x64 off: the seed is an int32 and the
    key is (seed >> 32, seed & 0xFFFFFFFF) = (0, seed mod 2^32)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"a PRNG seed must fit in int32 (jax_enable_x64 off), got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counter words (x1, x2) under key words
    (k1, k2), all int64 in [0, 2^32), broadcast together: 20 rounds of
    add / rotate / xor with a key injection after every 4, as
    `prng.py::_threefry2x32_lowering`. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    # x1 is never shifted, so it may carry bits above 32 until the end;
    # x2 is right-shifted every round, so it is masked after each xor. The
    # rotation is x2·2^r + (x2 >> (32 − r)) (the two parts share no bit),
    # one add with alpha, masked with the xor's result. In place, so a big
    # draw allocates three buffers, not one per step.
    x1 = (x1 + ks[0]).expand(shape).contiguous()
    x2 = ((x2 + ks[1]) & _MASK).expand(shape).contiguous()
    t = torch.empty_like(x2)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2)
            torch.bitwise_right_shift(x2, 32 - r, out=t)
            t.add_(x2, alpha=1 << r).bitwise_xor_(x1).bitwise_and_(_MASK)
            x2, t = t, x2
        x1.add_(ks[(i + 1) % 3])
        x2.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x1.bitwise_and_(_MASK), x2


def _threefry2x32_ints(k1: int, k2: int, x1: int, x2: int) -> Tuple[int, int]:
    """`threefry2x32` on one counter in Python ints: the host's path for
    deriving a few keys, where a tensor op's dispatch would cost more than
    the arithmetic."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = (x1 + k1) & _MASK, (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = (((x2 << r) & _MASK) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


_HOST_KEYS = 64  # a CPU key batch up to this size splits in Python ints


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`prng.py::iota_2x32_shape`: the row-major index of every element of
    `shape` as (high, low) 32-bit words."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device).view(tuple(shape))
    return idx >> 32, idx & _MASK


def _words(key: torch.Tensor, ndim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A key batch [..., 2]'s words, shaped [..., 1 (ndim times)] to
    broadcast against a draw of `ndim` dimensions."""
    k = key.reshape(key.shape[:-1] + (1,) * ndim + (2,))
    return k[..., 0], k[..., 1]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` for each key of a batch [..., 2]:
    returns [..., num, 2] (`_threefry_split_foldlike`)."""
    if key.device.type == "cpu" and key.numel() <= 2 * _HOST_KEYS:
        out = [[_threefry2x32_ints(k1, k2, 0, j) for j in range(num)] for k1, k2 in key.reshape(-1, 2).tolist()]
        return torch.tensor(out, dtype=torch.int64).reshape(key.shape[:-1] + (num, 2))
    k1, k2 = _words(key, 1)
    b1, b2 = threefry2x32(k1, k2, *_counters((num,), key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: threefry2x32 of the counter
    (0, data mod 2^32), which is also the `data`-th key of a split."""
    k1, k2 = _words(key, 0)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(k1), torch.full_like(k2, data & _MASK))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32) for each key of a batch
    [..., 2]: [..., *shape] int64 in [0, 2^32)."""
    k1, k2 = _words(key, len(shape))
    b1, b2 = threefry2x32(k1, k2, *_counters(shape, key.device))
    return b1.bitwise_xor_(b2)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) floats from 32 random bits: the top 23 as the mantissa of a
    float in [1, 2), less 1 (`_uniform`)."""
    return ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32) - 1.0


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """floats · (maxval − minval) + minval in f32, at least minval."""
    lo = torch.tensor(minval, dtype=torch.float32)
    span = (torch.tensor(maxval, dtype=torch.float32) - lo).item()
    return (_unit_floats(bits) * span + lo.item()).clamp_min(lo.item())


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """`_randint`'s modular reduction of two 32-bit draws into
    [minval, maxval), in its uint32 arithmetic (each product below 2^62,
    wrapped by the mask as uint32 wraps)."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise OverflowError("randint's bounds must fit in int32")
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + (lower % span)
    out = ((offset & _MASK) % span + minval) & _MASK  # the int32 sum, wrapping
    return out - ((out >> 31) << 32)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32 values, as
    int64): the reduction of two bit draws from split(key)."""
    higher, lower = random_bits(split(key, 2), shape).unbind(dim=-len(shape) - 1)
    return randint_from_bits(higher, lower, minval, maxval)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add a·b + c: the product of two f32 values is
    exact in f64, so one f64 add and one rounding to f32 give it."""
    return (a.double() * b + c).float()


_LOG_P = tuple(torch.tensor(v, dtype=torch.float32).item() for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1 = torch.tensor(-2.12194440e-4, dtype=torch.float32).item()
_LOG_Q2 = 0.693359375
_SQRT_HALF = torch.tensor(0.707106781186547524, dtype=torch.float32).item()


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """The natural log of positive normal f32 values as XLA's CPU code
    computes it: the mantissa in [√½, √2) less 1, Cephes' degree-8
    polynomial in three interleaved parts, and the exponent's ln 2 in two
    pieces, with the multiply-adds fused where XLA's compiled code fuses
    them (`_fma`); every other step is one f32 operation."""
    x = torch.clamp_min(x, _F32_TINY)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # mantissa bits, exponent of 0.5
    small = m < _SQRT_HALF
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, 0.0)
    z = m * m
    m3 = z * m
    p = [_fma(m, _LOG_P[3 * j], _LOG_P[3 * j + 1]) for j in range(3)]
    p = [_fma(p[j], m, _LOG_P[3 * j + 2]) for j in range(3)]
    y = _fma(_fma(p[0], m3, p[1]), m3, p[2])
    y = _fma(y, m3, (e * _LOG_Q1).double())
    return _fma(e, _LOG_Q2, ((_fma(z, -0.5, m) + y)).double())


@functools.cache
def _table_on(device: torch.device) -> torch.Tensor:
    k = torch.arange(1 << 23, dtype=torch.int64, device=device)
    return -_xla_log(-_xla_log(uniform_from_bits(k << 9, _F32_TINY, 1.0)))


def _gumbel_table(device) -> torch.Tensor:
    """−log(−log(U)) for each of the 2^23 values U = uniform(tiny, 1) takes,
    indexed by the top 23 of its 32 bits (32 MB); made once per device."""
    return _table_on(torch.device(device))


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    return _gumbel_table(bits.device)[bits >> 9]


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` (float32, mode "low"):
    −log(−log(U)), U uniform on [tiny, 1)."""
    return gumbel_from_bits(random_bits(key, shape))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)`: the argmax of
    gumbel(key, logits.shape) + logits, the first maximum on ties."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erf⁻¹ (Giles' polynomial in w = −log1p(−x²),
    one branch below w = 5 and one above), ±inf at ±1. log1p runs in f64
    and is rounded to f32 once, so its result does not hang on which code
    path (vectorized or not, CPU or CUDA) computed it."""
    w = -torch.log1p((-x * x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT[0], _ERFINV_GT[0])
    for a, b in zip(_ERFINV_LT[1:], _ERFINV_GT[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


_SQRT2 = torch.tensor(math.sqrt(2), dtype=torch.float32).item()


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.normal(key, shape)` (float32): √2·erf⁻¹(U), U uniform on
    [nextafter(−1, 0), 1) (`_normal_real`)."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    return _erfinv(uniform(key, shape, lo, 1.0)) * _SQRT2


def truncated_normal(key: torch.Tensor, lower: float, upper: float, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.truncated_normal(key, lower, upper, shape)` (float32):
    √2·erf⁻¹(U) for U uniform between erf(lower/√2) and erf(upper/√2),
    clipped into the open interval (`_truncated_normal`)."""
    lower_t, upper_t = torch.tensor(lower, dtype=torch.float32), torch.tensor(upper, dtype=torch.float32)
    a, b = torch.erf(lower_t / _SQRT2).item(), torch.erf(upper_t / _SQRT2).item()
    out = _erfinv(uniform(key, shape, a, b)) * _SQRT2
    lo = torch.nextafter(lower_t, torch.tensor(math.inf)).item()
    hi = torch.nextafter(upper_t, torch.tensor(-math.inf)).item()
    return torch.clamp(out, lo, hi)


def flax_param_key(key: torch.Tensor, path: Sequence[str], count: int = 1) -> torch.Tensor:
    """The key flax's `Module.init(key, ...)` hands the `count`-th parameter
    drawn in the module at `path` (names from the root module down): the
    root key folded with the first 4 bytes of the SHA-1 of the path's names
    and the count (`LazyRng.as_jax_rng`, `_fold_in_static`, with flax's
    default `flax_fix_rng_separator` off: no separators)."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(count.to_bytes((count.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def flax_normal_init(tree: Mapping, key: torch.Tensor, stddev: Callable[[Tuple[str, ...]], Optional[float]],
                     path: Tuple[str, ...] = ()) -> dict:
    """A flax param tree (nested mappings of tensors) with each leaf that
    `stddev(path)` gives a deviation for redrawn as its normal initializer
    draws it under `Module.init(key)`: normal(key of its module, shape) ·
    stddev, the parameter being its module's first draw (a Dense kernel, an
    Embed table). Other leaves (constant initializers) are kept."""
    out = {}
    for name, node in tree.items():
        sub = path + (name,)
        if isinstance(node, Mapping):
            out[name] = flax_normal_init(node, key, stddev, sub)
            continue
        std = stddev(sub)
        if std is None:
            out[name] = node
        else:
            out[name] = normal(flax_param_key(key, path), tuple(node.shape)) * torch.tensor(std, dtype=torch.float32)
    return out
