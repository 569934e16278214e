"""Streaming pytree checkpoints in the JAX package's file format: the port
of `save_pytree`, `load_pytree`, `save_config`, `load_config` and
`create_path` from `lmrl_gym_tpu/core/checkpointing.py`.

A file is a stream of msgpack pairs `(key, payload)`, one per leaf in the
flattened tree's order, `key` the leaf's path joined by '/'. `payload` is
what `flax.serialization.to_bytes(array)` gives: msgpack ext type 1 around
the msgpack triple `(shape, dtype name, raw C-order bytes)`. The port
carries its own small msgpack codec for exactly that subset (no `msgpack`
or `flax` package), so a file either package writes is read by the other
with bit-identical arrays, and the same tree gives the same bytes.

Leaves are CPU tensors on load (`bfloat16` travels by name and has no
numpy dtype). flax chunks arrays over 2**30 bytes into a map; the port
raises on one rather than misreading it (no supported model has such a
leaf: GPT-2-small's largest is 154 MB). `stream_sharding_fn` cuts each
leaf to this rank's block as it is read, for a sharded module.
"""
from __future__ import annotations

import json
import struct
from typing import Any, BinaryIO, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lmrl_gym_torch.core.io import makedirs_with_bucket, open_with_bucket

_NP_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16", "int8", "uint64", "uint32", "uint16",
              "uint8", "bool")
# torch dtype → the numpy dtype name flax writes (bfloat16 by name only)
_NAME = {getattr(torch, n): n for n in _NP_DTYPES if hasattr(torch, n)}
_NAME[torch.bfloat16] = "bfloat16"


# ---- flattening (jax.tree_util.tree_flatten_with_path's order and names)

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) pairs of a node in jax's order, None for a leaf:
    dict keys sorted, sequences by index, NamedTuple fields as '.name'."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    if tree is None:
        return []
    return None


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def walk(node, parts):
        kids = _children(node)
        if kids is None:
            out.append(("/".join(parts), node))
            return
        for part, child in kids:
            walk(child, parts + [part])

    walk(tree, [])
    return out


def _rebuild(target: Any, leaves: Dict[str, torch.Tensor], parts: List[str]) -> Any:
    kids = _children(target)
    if kids is None:
        key = "/".join(parts)
        if key not in leaves:
            raise KeyError(f"checkpoint missing key: {key}")
        value = leaves[key]
        if isinstance(target, (bool, int, float)):
            return type(target)(value.item())
        return value
    if isinstance(target, dict):
        return {k: _rebuild(target[k], leaves, parts + [str(k)]) for k in target}
    if target is None:
        return None
    new = [_rebuild(c, leaves, parts + [p]) for p, c in kids]
    return type(target)(*new) if _is_namedtuple(target) else type(target)(new)


def _unflatten_paths(leaves: Dict[str, Any]) -> dict:
    root: dict = {}
    for key, value in leaves.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


# ---- msgpack encoding of the subset the files use

def _uint(n: int) -> bytes:
    if n < 0x80:
        return bytes((n,))
    if n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _array_header(n: int) -> bytes:
    if n <= 15:
        return bytes((0x90 | n,))
    return (b"\xdc" + struct.pack(">H", n)) if n <= 0xFFFF else (b"\xdd" + struct.pack(">I", n))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n <= 31:
        head = bytes((0xA0 | n,))
    elif n <= 0xFF:
        head = b"\xd9" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        head = b"\xda" + struct.pack(">H", n)
    else:
        head = b"\xdb" + struct.pack(">I", n)
    return head + b


def _bin_header(n: int) -> bytes:
    if n <= 0xFF:
        return b"\xc4" + struct.pack(">B", n)
    return (b"\xc5" + struct.pack(">H", n)) if n <= 0xFFFF else (b"\xc6" + struct.pack(">I", n))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes((fixed[n], code))
    if n <= 0xFF:
        return b"\xc7" + struct.pack(">Bb", n, code)
    if n <= 0xFFFF:
        return b"\xc8" + struct.pack(">Hb", n, code)
    return b"\xc9" + struct.pack(">Ib", n, code)


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.array(leaf))  # a writable C-order copy; 0-d stays 0-d


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """The tensor's C-order bytes, without a copy where it is a contiguous
    CPU tensor."""
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy().reshape(-1).view(np.uint8))


def array_to_bytes(t: torch.Tensor) -> List[bytes]:
    """`flax.serialization.to_bytes` of one array, as pieces to write in
    order: ext type 1 around (shape, dtype name, raw bytes)."""
    if t.dtype not in _NAME:
        raise TypeError(f"no checkpoint dtype for {t.dtype}")
    raw = _raw_bytes(t)
    inner = _array_header(3) + _array_header(t.dim()) + b"".join(_uint(d) for d in t.shape) + _str(_NAME[t.dtype])
    inner += _bin_header(len(raw))
    n = len(inner) + len(raw)
    return [_ext_header(1, n), inner, raw]


# ---- msgpack decoding

class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def take(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise EOFError("truncated checkpoint")
        return b

    def take_buffer(self, n: int):
        """n bytes as a writable buffer: a view into the payload being
        parsed, or one copy out of the file."""
        if isinstance(self.f, _BytesIO):
            return self.f.view(n)
        buf = bytearray(n)
        if self.f.readinto(buf) != n:
            raise EOFError("truncated checkpoint")
        return buf

    def _n(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, at_top: bool = False):
        """The next object, of the types flax's array payloads use: unsigned
        ints, str, bin, arrays, maps (flax's chunked-array marker), bools
        (that marker's value) and ext types."""
        head = self.f.read(1)
        if not head:
            if at_top:
                raise StopIteration
            raise EOFError("truncated checkpoint")
        c = head[0]
        if c < 0x80:
            return c
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        if c in (0xC2, 0xC3):
            return c == 0xC3
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in sizes:
            return self.take_buffer(self._n(sizes[c]))
        uints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if c in uints:
            return self._n(uints[c])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return self.take(self._n(strs[c])).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.obj() for _ in range(self._n(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self._map(self._n(">H" if c == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            code = self._n(">b")
            return _Ext(code, self.take_buffer(fixext[c]))
        if c in (0xC7, 0xC8, 0xC9):
            n = self._n({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
            code = self._n(">b")
            return _Ext(code, self.take_buffer(n))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x} in a checkpoint")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


class _Ext:
    def __init__(self, code: int, data: bytearray):
        self.code, self.data = code, data


class _BytesIO:
    """A minimal reader over a buffer: `view` hands out slices of it."""

    def __init__(self, data):
        self.data, self.pos = memoryview(data), 0

    def read(self, n: int) -> bytes:
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += len(out)
        return out

    def view(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise EOFError("truncated checkpoint")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    if name not in _NP_DTYPES or not hasattr(torch, name):
        raise TypeError(f"unsupported checkpoint dtype {name!r}")
    return getattr(torch, name)


def array_from_bytes(payload) -> torch.Tensor:
    """The inverse of `array_to_bytes` on a payload (`flax.serialization.
    from_bytes(None, payload)`): a CPU tensor."""
    obj = _Reader(_BytesIO(payload)).obj()
    if isinstance(obj, dict):
        if "__msgpack_chunked_array__" in obj:
            raise ValueError("chunked array (over 2**30 bytes) in a checkpoint: not supported by the port")
        raise ValueError("checkpoint payload is a map, not an array")
    if not isinstance(obj, _Ext) or obj.code != 1:
        raise ValueError("checkpoint payload is not an ndarray (msgpack ext type 1)")
    shape, name, raw = _Reader(_BytesIO(obj.data)).obj()
    if memoryview(raw).readonly:  # a `bytes` payload: tensors need a writable buffer
        raw = bytearray(raw)
    dtype = _torch_dtype(name if isinstance(name, str) else bytes(name).decode())
    if dtype == torch.bfloat16:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(_NAME[dtype])))
    return t.reshape(tuple(shape))


# ---- the JAX package's API

def save_pytree(tree: Any, path: str, dtype: Optional[torch.dtype] = None) -> None:
    """Stream a pytree to `path` as msgpack (key, tensor) pairs. `dtype`:
    optional cast applied to floating leaves on save (bf16 on save)."""
    with open_with_bucket(path, "wb") as f:
        for key, leaf in flatten_with_paths(tree):
            t = _as_tensor(leaf)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            pieces = array_to_bytes(t)
            f.write(_array_header(2) + _str(key) + _bin_header(sum(len(p) for p in pieces)))
            for p in pieces:
                f.write(p)


def load_pytree(path: str, target: Any = None,
                sharding_fn: Optional[Callable[[str, torch.Tensor], Any]] = None) -> Any:
    """Load a msgpack-streamed pytree: with `target`, a tree of target's
    structure (keys matched by path), else nested dicts. `sharding_fn(key,
    tensor)` is applied leaf by leaf as they are read."""
    leaves = {}
    with open_with_bucket(path, "rb") as f:
        reader = _Reader(f)
        while True:
            try:
                pair = reader.obj(at_top=True)
            except StopIteration:
                break
            key, raw = pair
            if isinstance(key, (bytes, bytearray)):
                key = bytes(key).decode("utf-8")
            arr = array_from_bytes(raw)
            leaves[key] = sharding_fn(key, arr) if sharding_fn is not None else arr
    if target is None:
        return _unflatten_paths(leaves)
    return _rebuild(target, leaves, [])


def stream_sharding_fn(mesh, spec_by_key: Callable[[str], Any]):
    """A `sharding_fn` for `load_pytree` that keeps this rank's block of
    each leaf, laid out as `parallel/mesh.py::shard_pytree` lays out a
    parameter of that spec (`spec_by_key(key)`, over the flax key path; a
    `DTensor` on the mesh's FSDP2 mesh). Leaves pass whole on a one-rank
    mesh."""
    from lmrl_gym_torch.parallel.mesh import place_by_spec

    def fn(key: str, arr: torch.Tensor):
        return place_by_spec(arr, mesh, spec_by_key(key))

    return fn


def save_config(config: dict, path: str) -> None:
    with open_with_bucket(path, "w") as f:
        json.dump(config, f, indent=2)


def load_config(path: str) -> dict:
    with open_with_bucket(path) as f:
        return json.load(f)


def create_path(path: str) -> str:
    return makedirs_with_bucket(path)
