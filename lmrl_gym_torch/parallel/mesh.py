"""Device mesh and sharding on `torch.distributed`: the port of
`lmrl_gym_tpu/parallel/mesh.py`.

One process drives one device, so the mesh is laid over the ranks of the
process group. What the JAX package leaves to GSPMD, the port does by hand:

- **Parameters.** A rule table (regex → `Spec` over the flax key paths;
  `match_partition_rules`) picks each parameter's spec, a flax kernel's
  spec transposed onto the port's [out, in] `nn.Linear` weight.
  `shard_pytree` lowers the specs onto FSDP2 (`fully_shard`): each
  parameter's storage, and so its optimizer state, is sharded over the
  fsdp×mp ranks along the tensor dim its spec shards (the fsdp axis's dim
  first, then mp's; dim 0 where the spec shards nothing or no dim divides)
  and replicated over dp and sp. FSDP2 gathers a block's full parameters
  just before its forward and frees them after, so every kernel sees plain
  local tensors and the fused qkv matrix is split whole.
- **Compute.** The batch is sharded over (dp, fsdp) (`batch_spec`), and the
  trunk's sequence over sp when it runs ring attention
  (`parallel/ring_attention.py`). The mp ranks hold the same rows and
  compute the same activations: the port shards parameter and optimizer
  memory over mp but does not split the matmuls by head.
- **Losses.** A step runs on its rank's rows (`sharded_step`) and gathers
  the loss inputs over the batch ranks (`gather_batch`), so every masked
  mean, cumsum and whitening is the global one, as in the unsharded
  program. The gather's backward keeps the rank's own rows, and FSDP2's
  reduction sums the ranks' parts (`shard_pytree` rescales its average).
- **Draws.** Inside `sharded_step` every random draw is made over the
  global batch from the step's generator and sliced (`core/random.py::
  sharded_draws`), so the ranks together draw what the unsharded program
  draws.

With no process group (one process; `core/io.py::distributed_init`
started nothing) a mesh is one rank without a `DeviceMesh`: nothing is
wrapped, sliced or gathered, and no collective runs.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.core.io import group_timeout
from lmrl_gym_torch.core.random import sharded_draws

# Canonical mesh axes. dp = data parallel (parameters replicated), fsdp =
# fully-sharded data parallel (parameters and batch sharded), mp = model
# parallel (parameters sharded), sp = sequence parallel.
MESH_AXES = ("dp", "fsdp", "mp")
MESH_AXES_SP = ("dp", "fsdp", "mp", "sp")
_BATCH = ("dp", "fsdp")


class Spec(tuple):
    """A `PartitionSpec`: one entry per tensor dim, each a mesh-axis name, a
    tuple of names (sharded over their product, the first outermost) or
    None (not sharded). Missing trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Mesh:
    """Named mesh axes over the process group's ranks, row-major: rank r sits
    at `np.unravel_index(r, shape)`. `device_mesh` is the `DeviceMesh` over
    the same ranks, None with no process group (one rank)."""

    def __init__(self, shape: Dict[str, int], device: torch.device):
        self.shape = dict(shape)
        self.device = device
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], Tuple[Any, int, int]] = {}
        self._param_mesh = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import DeviceMesh

            self.rank = dist.get_rank()
            ranks = torch.arange(self.size).reshape(tuple(shape.values()))
            self.device_mesh = DeviceMesh(device.type, ranks, mesh_dim_names=self.axis_names)
        else:
            self.rank = 0

    @property
    def is_distributed(self) -> bool:
        return self.device_mesh is not None

    def axis_size(self, axes) -> int:
        """Product of the named axes' sizes; axes absent from the mesh count 1."""
        return int(np.prod([self.shape.get(a, 1) for a in _axes(axes)]))

    def coord(self, axes) -> int:
        """This rank's row-major index over the named axes."""
        names = [a for a in _axes(axes) if a in self.shape]
        pos = dict(zip(self.axis_names, np.unravel_index(self.rank, tuple(self.shape.values()))))
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + int(pos[a])
        return idx

    def _arranged(self, outer: Sequence[str], inner: Sequence[str]) -> torch.Tensor:
        """Ranks as a [prod(outer), prod(inner)] table: each row one group
        over `inner` (row-major), the rows over `outer`."""
        full = list(self.axis_names)
        ranks = torch.arange(self.size).reshape(tuple(self.shape.values()))
        order = [full.index(a) for a in list(outer) + list(inner)]
        n_in = self.axis_size(inner)
        return ranks.permute(*order).reshape(-1, n_in)

    def group(self, axes) -> Tuple[Any, int, int]:
        """(process group, this rank's index, size) over the named axes,
        built on first use: every rank calls `new_group` for every group of
        the partition, in the same order."""
        key = tuple(a for a in _axes(axes) if a in self.shape)
        if key not in self._groups:
            rest = [a for a in self.axis_names if a not in key]
            mine = None
            for row in self._arranged(rest, key).tolist():
                g = dist.new_group(row, timeout=group_timeout())
                if self.rank in row:
                    mine = g
            self._groups[key] = (mine, self.coord(key), self.axis_size(key))
        return self._groups[key]

    @property
    def param_mesh(self):
        """FSDP2's mesh: replicate over dp×sp, shard over fsdp×mp (1-D when
        nothing is replicated)."""
        if self._param_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            rep = [a for a in ("dp", "sp") if a in self.shape]
            shard = [a for a in ("fsdp", "mp") if a in self.shape]
            table = self._arranged(rep, shard)
            if table.shape[0] == 1:
                self._param_mesh = DeviceMesh(self.device.type, table[0], mesh_dim_names=("shard",))
            else:
                self._param_mesh = DeviceMesh(self.device.type, table, mesh_dim_names=("replicate", "shard"))
        return self._param_mesh

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, distributed={self.is_distributed})"


def load_mesh(shape: Sequence[int], axis_names: Sequence[str] = MESH_AXES, device: DeviceLike = None) -> Mesh:
    """A mesh over every rank of the process group (one rank without one).

    One axis may be -1, meaning "the remainder", like the JAX package's
    `load_mesh((dp, fsdp, mp))`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = list(shape)
    if len(shape) != len(axis_names):
        raise ValueError("shape and axis_names must align")
    neg = [i for i, s in enumerate(shape) if s == -1]
    if len(neg) > 1:
        raise ValueError("at most one -1 axis")
    known = int(np.prod([s for s in shape if s != -1]))
    if neg:
        if world % known:
            raise ValueError(f"{world} ranks not divisible by {known}")
        shape[neg[0]] = world // known
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
    return Mesh(dict(zip(axis_names, shape)), resolve_device(device))


# ---- partition rules over the port's parameters

def flax_path(module: nn.Module, name: str) -> Tuple[str, bool]:
    """(the flax key path of the port parameter `name`, whether the port
    stores it transposed): `h.0.attn.qkv.weight` → (`h_0/attn/qkv/kernel`,
    True); embeddings are `embedding`, norm weights `scale`."""
    prefix, _, leaf = name.rpartition(".")
    owner = module.get_submodule(prefix) if prefix else module
    transposed = False
    if leaf == "weight":
        if isinstance(owner, nn.Linear):
            leaf, transposed = "kernel", True
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        else:
            leaf = "scale"
    path = re.sub(r"\.(\d+)(?=\.|$)", r"_\1", prefix).replace(".", "/")
    return (f"{path}/{leaf}" if path else leaf), transposed


def match_partition_rules(rules: Sequence[Tuple[str, Spec]], params: nn.Module) -> Dict[str, Spec]:
    """{parameter name: Spec} for a module: each parameter's flax key path
    takes the first rule whose regex it matches; a transposed parameter
    takes the rule's spec reversed."""
    out = {}
    for name, p in params.named_parameters():
        path, transposed = flax_path(params, name)
        for pattern, spec in rules:
            if re.search(pattern, path) is not None:
                if transposed:
                    spec = Spec(*reversed(tuple(spec) + (None,) * (p.ndim - len(spec))))
                out[name] = Spec(*spec)
                break
        else:
            raise ValueError(f"no partition rule matched: {path}")
    return out


def _refine(spec: Spec, shape: Sequence[int], mesh: Mesh) -> Spec:
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    return Spec(*(a if dim % mesh.axis_size(a) == 0 else None for a, dim in zip(parts, shape)))


def refine_specs_for_shapes(specs: Dict[str, Spec], params: nn.Module, mesh: Mesh) -> Dict[str, Spec]:
    """Drop sharding on any dim not divisible by its mesh axes' size (small
    heads, odd vocabularies), as the JAX package does."""
    return {name: _refine(specs[name], p.shape, mesh) for name, p in params.named_parameters()}


def _shard_dim(spec: Spec, shape: Sequence[int], mesh: Mesh) -> int:
    """The tensor dim FSDP2 shards a parameter of this spec along (over the
    fsdp×mp ranks): the dim of its fsdp axis, else of its mp axis, where that
    dim divides evenly; else dim 0 (FSDP2 pads dim 0)."""
    n = mesh.axis_size(("fsdp", "mp"))
    for axis in ("fsdp", "mp"):
        for d, entry in enumerate(spec):
            if axis in _axes(entry) and mesh.axis_size(axis) > 1 and shape[d] % n == 0:
                return d
    return 0


def _grad_scale(mesh: Mesh, sequence_sharded: bool) -> float:
    """FSDP2 averages gradients over every rank; the step needs the sum of
    the rank parts: over the batch ranks, and over sp for a module whose
    forward ran on the rank's sequence slice. The mp ranks (and, for a
    module that runs after the sequence gather, the sp ranks) computed the
    same part, which is counted once."""
    dup = mesh.axis_size("mp") * (1 if sequence_sharded else mesh.axis_size("sp"))
    return mesh.size / dup


def _param_placements(mesh: Mesh, dim: int):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate()] * (mesh.param_mesh.ndim - 1) + [Shard(dim)]


def place_by_spec(t: torch.Tensor, mesh: Mesh, spec: Spec) -> torch.Tensor:
    """A whole tensor cut to this rank's block as `shard_pytree` would hold
    a parameter of this spec (a `DTensor` on the FSDP2 mesh); the tensor
    itself on a one-rank mesh."""
    if not mesh.is_distributed or t.ndim == 0:
        return t
    dim = _shard_dim(_refine(spec, t.shape, mesh), t.shape, mesh)
    return _cut(t.to(mesh.device), mesh.param_mesh, _param_placements(mesh, dim))


def _cut(t: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """This rank's block of a whole tensor as a `DTensor` laid out by
    `placements`, cut as DTensor's `Shard` cuts (torch.chunk: the trailing
    ranks of an uneven cut may hold nothing); no communication."""
    from torch.distributed.tensor import DTensor

    local = t
    for mesh_dim, pl in enumerate(placements):
        if pl.is_shard():
            n, i = device_mesh.size(mesh_dim), device_mesh.get_local_rank(mesh_dim)
            chunks = torch.chunk(local, n, dim=pl.dim)
            local = chunks[i] if i < len(chunks) else local.narrow(pl.dim, 0, 0)
    return DTensor.from_local(local.contiguous(), device_mesh, placements, shape=t.shape, stride=t.stride(),
                              run_check=False)


def shard_pytree(module: nn.Module, specs: Dict[str, Spec], mesh: Mesh) -> nn.Module:
    """Shard a module's parameters per its specs with FSDP2, in place: each
    block of a `ModuleList` (the trunk's layers, the T5's blocks) is a unit
    of its own, then the rest of the module. Returns the module, unchanged
    on a one-rank mesh without a process group."""
    if not mesh.is_distributed:
        return module
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    placement = {id(p): Shard(_shard_dim(specs[n], p.shape, mesh)) for n, p in module.named_parameters()}

    def fn(p):
        return placement[id(p)]

    for child in module.modules():
        if isinstance(child, nn.ModuleList):
            for block in child:
                fully_shard(block, mesh=mesh.param_mesh, shard_placement_fn=fn, reshard_after_forward=True)
    # the root too: a forward without a backward (a target, a bootstrap) must
    # leave every parameter sharded for the optimizer and the target updates
    fully_shard(module, mesh=mesh.param_mesh, shard_placement_fn=fn, reshard_after_forward=True)
    module.grad_scale = _grad_scale(mesh, getattr(module, "sequence_sharded", False))
    module.shard_mesh = mesh
    return module


def shard_module(module: nn.Module, mesh: Mesh) -> nn.Module:
    """`shard_pytree` with the module config's own rule table."""
    rules = module.config.partition_rules()
    return shard_pytree(module, refine_specs_for_shapes(match_partition_rules(rules, module), module, mesh), mesh)


def is_sharded(module: Any) -> bool:
    return getattr(module, "grad_scale", None) is not None


# ---- batches: constraints, shards and gathers

def _placements(spec: Spec, mesh: Mesh):
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a in mesh.shape:
                out[mesh.axis_names.index(a)] = Shard(d)
    return out


def with_sharding_constraint(x: Any, mesh: Optional[Mesh], spec: Spec) -> Any:
    """Redistribute a `DTensor` to `spec`; a no-op without a mesh or on a
    plain (rank-local) tensor."""
    if mesh is None or not mesh.is_distributed:
        return x
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh.device_mesh, _placements(spec, mesh))
    return x


def batch_spec(extra_dims: int = 1) -> Spec:
    """Canonical batch sharding: the leading axis over ('dp', 'fsdp')."""
    return Spec(_BATCH, *([None] * extra_dims))


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "__dataclass_fields__"):
        import dataclasses

        return dataclasses.replace(tree, **{f: _map(fn, getattr(tree, f)) for f in tree.__dataclass_fields__})
    return tree


def host_local_device_put(x: Any, mesh: Mesh, spec: Spec) -> Any:
    """Each rank's own block of the data (a tree of tensors) → `DTensor`s
    laid out by `spec` over the mesh; unchanged on a one-rank mesh."""
    if not mesh.is_distributed:
        return x
    from torch.distributed.tensor import DTensor

    placements = _placements(spec, mesh)
    return _map(lambda a: DTensor.from_local(a.to(mesh.device), mesh.device_mesh, placements, run_check=False), x)


def fully_replicated(mesh: Mesh):
    """The placements of a tensor replicated on every rank."""
    return _placements(Spec(), mesh)


def tree_size_bytes(tree: Any) -> int:
    """Bytes of every tensor in a module or tree (global sizes)."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    leaves = []
    _map(leaves.append, tree)
    return sum(t.numel() * t.element_size() for t in leaves)


def local_shard(x: Any, mesh: Optional[Mesh], spec: Spec) -> Any:
    """This rank's block of `x` under `spec` (a tree of tensors): a
    `DTensor`'s local tensor after redistributing it to `spec`, a plain
    tensor's slice (it holds the whole array). Unchanged on a one-rank mesh."""
    if mesh is None or not mesh.is_distributed:
        return x
    from torch.distributed.tensor import DTensor

    def one(t):
        if isinstance(t, DTensor):
            return t.redistribute(mesh.device_mesh, _placements(spec, mesh)).to_local()
        for d, entry in enumerate(spec):
            if mesh.axis_size(entry) > 1:
                start, size = block(t.shape[d], mesh, entry)
                t = t.narrow(d, start, size)
        return t

    return _map(one, x)


def block(n: int, mesh: Mesh, axes) -> Tuple[int, int]:
    """(start, size) of this rank's block of n along the named axes, cut as
    DTensor's `Shard` cuts (torch.chunk: blocks of ceil(n/k); on an uneven
    cut the trailing ranks hold less, or nothing)."""
    k = mesh.axis_size(axes)
    size = -(-n // k)
    start = min(mesh.coord(axes) * size, n)
    return start, min(size, n - start)


def local_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows of every tensor of a batch (leading dim over dp×fsdp)."""
    return local_shard(batch, mesh, Spec(_BATCH))


class _Gather(torch.autograd.Function):
    """All-gather along `dim` over a group. Every rank computes the same
    function of the gathered tensor, so the gradient reaching it is the same
    on every rank, and the backward keeps the rank's own block of it."""

    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        # the blocks' lengths (an uneven cut: DTensor's chunk sizes)
        n = torch.tensor([x.shape[dim]], device=x.device)
        lens = [torch.empty_like(n) for _ in range(size)]
        dist.all_gather(lens, n, group=group)
        lens = [int(v) for v in lens]
        ctx.dim, ctx.start, ctx.n = dim, sum(lens[:index]), x.shape[dim]
        src = x.contiguous()
        as_bytes = src.dtype == torch.bool
        if as_bytes:
            src = src.to(torch.uint8)
        longest = max(lens)
        if src.shape[dim] < longest:  # all_gather takes equal shapes
            pad = list(src.shape)
            pad[dim] = longest - src.shape[dim]
            src = torch.cat([src, src.new_zeros(pad)], dim)
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, lens)], dim)
        return out.bool() if as_bytes else out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None, None


def gather_shards(x: Optional[torch.Tensor], mesh: Optional[Mesh], spec: Spec) -> Optional[torch.Tensor]:
    """The inverse of `local_shard` on a plain local block: the whole array
    on every rank, differentiable (`_Gather`)."""
    if x is None or mesh is None or not mesh.is_distributed:
        return x
    for d, entry in enumerate(spec):
        group, index, size = mesh.group(entry)
        if size > 1:
            x = _Gather.apply(x, d, group, index, size)
    return x


def gather_batch(mesh: Optional[Mesh], *xs: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor], ...]:
    """Each tensor's rows from every batch rank (leading dim), in order."""
    return tuple(gather_shards(x, mesh, Spec(_BATCH)) for x in xs)


def sharded_step(step, mesh: Optional[Mesh]):
    """step(state, batch, generator=None, ...) run on this rank's rows of
    `batch` (a tree of global tensors or batch-sharded `DTensor`s), with
    every random draw made over the global batch and sliced. The step itself
    gathers its loss inputs (`gather_batch`). Unchanged without a
    distributed mesh."""
    if mesh is None or not mesh.is_distributed:
        return step

    def wrapped(state, batch, generator=None, *args, **kw):
        leaves = []
        _map(leaves.append, batch)
        n = leaves[0].shape[0]
        start, _ = block(n, mesh, _BATCH)
        with sharded_draws(((start, n),)):
            return step(state, local_batch(batch, mesh), generator, *args, **kw)

    return wrapped


def run_batch_sharded(fn, mesh: Optional[Mesh], rows: int, *args, **kw):
    """fn(*args, **kw) on this rank's `rows` rows (the caller hands it the
    rank's rows: env states, caches; every rank the same count), every
    random draw made over the global batch and sliced, and each tensor of
    the result put on the mesh as a batch-sharded `DTensor`. A plain call
    without a distributed mesh."""
    if mesh is None or not mesh.is_distributed:
        return fn(*args, **kw)
    with sharded_draws(((mesh.coord(_BATCH) * rows, rows * mesh.axis_size(_BATCH)),)):
        out = fn(*args, **kw)
    return host_local_device_put(out, mesh, Spec(_BATCH))


def batch_rows(mesh: Optional[Mesh], n: int) -> int:
    """This rank's share of n rows."""
    if mesh is None or not mesh.is_distributed:
        return n
    if n % mesh.axis_size(_BATCH):
        raise ValueError(f"{n} rows do not divide over {mesh.axis_size(_BATCH)} batch ranks")
    return n // mesh.axis_size(_BATCH)


# ---- whole tensors and sharded state

def full_tensor(t: Any) -> Any:
    """A `DTensor`'s whole value on every rank (a collective); other values
    as they are."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict with every sharded tensor gathered whole."""
    return {k: full_tensor(v) for k, v in module.state_dict().items()}


def gather_tree(tree: Any) -> Any:
    """Every `DTensor` of a tree (an optimizer state) gathered whole."""
    return _map(full_tensor, tree)


def shard_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A whole tensor cut to the layout of the `DTensor` `like` (this rank's
    block, no communication); `t` itself where `like` is a plain tensor."""
    from torch.distributed.tensor import DTensor

    local = t.to(like.device, like.dtype)
    return _cut(local, like.device_mesh, like.placements) if isinstance(like, DTensor) else local


def load_state(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load a state dict into a (sharded or plain) module, in place: from
    whole tensors each rank keeps its own block; a `DTensor` already in the
    parameter's layout (`stream_sharding_fn`) is copied block to block."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        for name, p in list(module.named_parameters()) + list(module.named_buffers()):
            src = sd[name]
            if isinstance(src, DTensor) and not (isinstance(p, DTensor) and src.placements == p.placements):
                src = src.full_tensor()
            if not isinstance(src, DTensor):
                src = shard_like(src, p)
            _local(p).copy_(_local(src))


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def shard_train_state(state: Any, mesh: Mesh) -> Any:
    """Shard every module of an algorithm's state (its `TrainState`s and
    target modules, built unsharded) by the modules' rule tables, in place;
    each optimizer state tensor takes its parameter's layout."""
    from lmrl_gym_torch.core.optimizer import TrainState, map_param_state

    if not mesh.is_distributed:
        return state
    for f in state.__dataclass_fields__:
        value = getattr(state, f)
        if isinstance(value, TrainState):
            whole = value.opt_state
            shard_module(value.params, mesh)
            params = dict(value.params.named_parameters())
            value.opt_state = map_param_state(whole, lambda name, t: shard_like(t, params[name]))
        elif isinstance(value, nn.Module):
            shard_module(value, mesh)
    return state


def all_modules(state: Any) -> Iterable[nn.Module]:
    from lmrl_gym_torch.core.optimizer import TrainState

    for f in state.__dataclass_fields__:
        value = getattr(state, f)
        if isinstance(value, TrainState):
            yield value.params
        elif isinstance(value, nn.Module):
            yield value

