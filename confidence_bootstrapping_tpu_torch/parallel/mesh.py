"""Ranks, process groups and sharding for data-parallel training and sampling.

Port of ``confidence_bootstrapping_tpu/parallel/mesh.py``. There one process
drives every device, and GSPMD makes a step on a sharded batch compute what
the one-device step computes. PyTorch runs one process per rank under
``torch.distributed``, so the port rebuilds that equality by hand:

* ``Mesh``: the ranks laid out along named axes ("data", or "data" x
  "model"), this rank's place on each axis, one process group per axis and
  this rank's ``torch.device``;
* ``shard_batch`` / ``gather_batch``: this rank's contiguous slice of the
  leading (pose or complex) axis of every field, and the inverse;
* ``data_parallel(mesh)``: a context, scoped like ``torch.autocast``, inside
  which the models, losses and sampler take over the data axis's ranks what
  the JAX package takes over the global batch: batch statistics
  (``all_sum``, differentiable), loss denominators (``psum``, ``dp_mean``),
  random draws at the global batch's rows (``rows``) and the receptor
  compaction's shared minimum (``all_min``);
* ``reduce_gradients``: the gradients' sum over the data axis (each rank's
  loss is its share of the global loss);
* the 2-D split (``make_mesh_2d``, ``model_parallel_specs``,
  ``shard_model_tree``): the JAX package's shape rule, applied in the Flax
  layout that ``models/from_flax`` maps, picks the leaves whose last Flax
  dimension is cut over the "model" axis; each rank then keeps and updates
  only its slice of those leaves' parameters, EMA and Adam moments
  (``train_loop.apply_gradients`` gathers the slices after each update;
  ``agree`` keeps the axis's ranks on one gradient and one set of batch
  statistics).

Collectives: NCCL on CUDA, gloo on the CPU, and gloo with CUDA tensors where
several ranks share one card (NCCL refuses two ranks on one GPU; gloo takes
CUDA tensors in all_reduce, broadcast and all_gather).

Known differences from the JAX module: ``maybe_init_distributed`` raises when
the start fails (the JAX one prints and carries on alone, which hides the
fault); ``coordinator_barrier`` is a collective barrier of the process group
(the JAX one waits in the coordination service).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..runtime import resolve_device


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> Tuple[int, int]:
    """(world size, rank); (1, 0) outside a process group."""
    return (dist.get_world_size(), dist.get_rank()) if _initialized() else (1, 0)


def coordinator_barrier(name: str, timeout_ms: int = 600_000) -> bool:
    """Line every rank up, e.g. while rank 0 writes files the others read
    next. gloo: ``monitored_barrier`` with the timeout, which names the
    ranks that did not arrive; nccl: ``barrier``. Returns False outside a
    process group (no-op)."""
    if not _initialized():
        return False
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(timeout=datetime.timedelta(milliseconds=timeout_ms), wait_all_ranks=True)
        else:
            dist.barrier(device_ids=[torch.cuda.current_device()])
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e
    return True


def _local_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda:LOCAL_RANK`` (raises without a card)."""
    if device is not None:
        return resolve_device(device)
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


def maybe_init_distributed(device=None) -> bool:
    """Start ``torch.distributed`` when the environment asks for it; True
    when the world has more than one rank.

    The environment: torchrun's ``WORLD_SIZE`` / ``RANK`` (with
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``env://``), or the JAX package's
    contract ``JAX_COORDINATOR_ADDRESS`` (host:port of rank 0's store) /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``. Neither: a no-op (False). A
    process group started before (a test's ``file://`` store) is kept.
    The backend: nccl when ``device`` (default ``cuda:LOCAL_RANK``) is a
    GPU, gloo on the CPU. A failed start raises."""
    if _initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    if "WORLD_SIZE" in env:
        world, rank, init_method = int(env["WORLD_SIZE"]), int(env.get("RANK", "0")), "env://"
    elif coordinator:
        world, rank = int(env.get("JAX_NUM_PROCESSES", "1")), int(env.get("JAX_PROCESS_ID", "0"))
        init_method = f"tcp://{coordinator}"
    else:
        return False
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method, world_size=world,
                            rank=rank)
    return world > 1


def _new_groups(layout: np.ndarray, axis: int, rank: int):
    """The process group along ``axis`` of the rank layout that holds
    ``rank`` (None where that axis has one rank) and its ranks. Every rank
    of the world creates every group, in the same order, as
    ``dist.new_group`` asks."""
    mine = (None, [rank])
    if layout.shape[axis] == 1:
        return mine
    world = _world()[0]
    for line in np.moveaxis(layout, axis, -1).reshape(-1, layout.shape[axis]):
        ranks = [int(r) for r in line]
        group = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
        if rank in ranks:
            mine = (group, ranks)
    return mine


@dataclasses.dataclass(eq=False)
class Mesh:
    """Ranks laid out along named axes. ``devices``: the global ranks in
    that layout (``devices.size`` is JAX's ``mesh.devices.size``);
    ``groups``: this rank's process group along each axis (None: one rank)
    and ``group_ranks`` its ranks; ``group``: the whole mesh's; ``device``:
    this rank's device."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    device: torch.device
    rank: int
    groups: Dict[str, object]
    group: object
    group_ranks: Dict[str, list] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def index(self, axis_name: str) -> int:
        """This rank's coordinate along ``axis_name``."""
        return int(np.argwhere(self.devices == self.rank)[0][self.axis_names.index(axis_name)])


def _make(shape: Sequence[int], axis_names: Tuple[str, ...], device) -> Mesh:
    world, rank = _world()
    n = int(np.prod(shape))
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    layout = np.arange(n).reshape(tuple(shape))
    groups = {a: _new_groups(layout, i, rank) for i, a in enumerate(axis_names)}
    whole = _new_groups(layout.reshape(1, -1), 1, rank)[0]
    if rank >= n:
        raise ValueError(f"rank {rank} is outside a mesh of {n} ranks")
    return Mesh(layout, tuple(axis_names), _local_device(device), rank, {a: g for a, (g, _) in groups.items()}, whole,
                {a: r for a, (_, r) in groups.items()})


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks (default: all; one
    rank, with no process group, outside ``torch.distributed``). ``device``:
    this rank's device (default ``cuda:LOCAL_RANK``)."""
    return _make((_world()[0] if n_devices is None else n_devices,), (axis_name,), device)


class NamedSharding(NamedTuple):
    """Where a tensor lives on a mesh: ``spec`` names, per dimension, the
    axis it is cut over (None: whole); ``()`` is replicated."""

    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    """Shard the leading (pose/complex) axis across the mesh."""
    return NamedSharding(mesh, (axis_name,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _map(fn, tree):
    """``fn`` on every tensor of a ComplexBatch, (named) tuple, list or dict."""
    if torch.is_tensor(tree):
        return fn(tree)
    if hasattr(tree, "map") and dataclasses.is_dataclass(tree):
        return tree.map(fn)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(mesh: Mesh, batch, axis_name: str = "data"):
    """This rank's contiguous slice of the leading axis of every tensor in
    ``batch`` (a ComplexBatch, noise draws, targets), as ``batch_sharding``
    places it. Every rank passes the same global batch. Raises when the
    leading axis does not split evenly."""
    (axis,) = batch_sharding(mesh, axis_name).spec
    n, i = mesh.shape[axis], mesh.index(axis)

    def cut(x):
        if x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a leading axis of {x.shape[0]} does not split over {n} ranks")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return _map(cut, batch)


def _bcast(x: torch.Tensor, mesh: Mesh) -> None:
    if mesh.group is not None:
        dist.broadcast(x, src=int(mesh.devices.flat[0]), group=mesh.group)


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank of the mesh: a module's parameters and
    buffers in place (returns the module), or a copy of a tensor tree."""
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            _bcast(t.data, mesh)
        return tree

    def put(x):
        x = x.detach().clone().contiguous()
        _bcast(x, mesh)
        return x

    return _map(put, tree)


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's picklable ``obj`` (metrics, a history with wall times) on
    every rank of the mesh."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=int(mesh.devices.flat[0]), group=mesh.group)
    return box[0]


# every process holds the same global batch, so the multi-controller forms are the same functions
shard_batch_multiprocess = shard_batch
replicate_multiprocess = replicate


def _gather(x: torch.Tensor, group, n: int) -> list:
    """``all_gather`` of ``x`` over ``group`` (n ranks): the n tensors."""
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


def _cat(x: torch.Tensor, group, n: int) -> torch.Tensor:
    return x if x.ndim == 0 else torch.cat(_gather(x, group, n))


def gather_batch(mesh: Mesh, tree, axis_name: str = "data"):
    """The inverse of ``shard_batch``: every tensor's slices from the
    axis's ranks, concatenated along the leading axis, on every rank."""
    group, n = mesh.groups[axis_name], mesh.shape[axis_name]
    if group is None:
        return tree
    return _map(lambda x: _cat(x, group, n), tree)


def data_mesh(mesh: Optional[Mesh], n: int, axis_name: str = "data") -> Optional[Mesh]:
    """``mesh`` when a batch of ``n`` splits over its data axis of several
    ranks, else None: every rank then runs the whole batch, as the JAX
    package's ``n % size`` guard does."""
    return mesh if mesh is not None and mesh.groups[axis_name] is not None and n % mesh.shape[axis_name] == 0 else None


# --------------------------------------------------------------------------- #
# inside a data-parallel step or sample
# --------------------------------------------------------------------------- #


class _Shard(NamedTuple):
    group: object  # the data axis's process group
    index: int  # this rank's place on it
    size: int  # its ranks


_active = threading.local()


def _shard() -> Optional[_Shard]:
    """The data axis of the enclosing ``data_parallel`` context, or None."""
    return getattr(_active, "shard", None)


@contextlib.contextmanager
def data_parallel(mesh: Mesh, axis_name: str = "data"):
    """Within the block, batch statistics, loss counts, random draws and the
    receptor compaction span the axis's ranks (a no-op at one rank)."""
    prev = _shard()
    group = mesh.groups[axis_name]
    _active.shard = None if group is None else _Shard(group, mesh.index(axis_name), mesh.shape[axis_name])
    try:
        yield
    finally:
        _active.shard = prev


class _AllSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradients over it
    (each rank's loss reads the sum), as SyncBatchNorm's statistics do."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active data axis, differentiable; ``x`` outside."""
    s = _shard()
    return x if s is None else _AllSum.apply(x, s.group)


@torch.no_grad()
def psum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active data axis, without gradient (counts and
    metrics); ``x`` outside."""
    s = _shard()
    if s is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=s.group)
    return y


@torch.no_grad()
def all_min(x: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum over the active data axis; ``x`` outside."""
    s = _shard()
    if s is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MIN, group=s.group)
    return y


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch as this rank's share: the local sum
    over the global count (the shards are equal); ``torch.mean`` outside."""
    s = _shard()
    return torch.mean(x) if s is None else torch.sum(x) / (x.numel() * s.size)


def rows(draw, shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """``draw(shape, generator=, device=)`` (``torch.rand``, ``torch.randn``)
    with ``shape[0]`` this rank's batch rows: drawn at the global batch's
    rows and sliced, so every rank's generator advances as the one-process
    run's does and its numbers are that run's."""
    s = _shard()
    if s is None:
        return draw(tuple(shape), generator=generator, device=device)
    b = shape[0]
    full = draw((b * s.size,) + tuple(shape[1:]), generator=generator, device=device)
    return full[s.index * b:(s.index + 1) * b]


def gathered(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` (leading axis) on every rank of the active
    data axis; ``x`` outside."""
    s = _shard()
    return x if s is None else _cat(x, s.group, s.size)


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor; ``x`` outside."""
    s = _shard()
    if s is None:
        return x
    b = x.shape[0] // s.size
    return x[s.index * b:(s.index + 1) * b]


@torch.no_grad()
def reduce_gradients(mesh: Mesh, grads, params, axis_name: str = "data") -> list:
    """Each parameter's gradient (None: zero) summed over the axis's ranks,
    in one collective."""
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    group = mesh.groups[axis_name]
    if group is None or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    return [f.view_as(g) for f, g in zip(torch.split(flat, [g.numel() for g in grads]), grads)]


# --------------------------------------------------------------------------- #
# 2-D data x model split
#
# The reference has no model parallelism; the JAX package cuts the channel
# dimension of large weights over a "model" axis with a shape rule that needs
# no knowledge of the tree: a leaf whose last dimension divides by the axis
# size (and is at least ``min_size``) is cut on it, 1-D leaves and small
# tables stay whole. The port applies the rule to each parameter's Flax shape
# (a torch Linear weight is the transpose of a Flax kernel), so the same
# leaves are cut. Each rank of a model group runs the whole model on the same
# data shard and keeps only its slice of the cut leaves' parameters, EMA and
# Adam moments; Adam is elementwise, so the update of a slice is exact.
# --------------------------------------------------------------------------- #


def make_mesh_2d(n_data: int, n_model: int, axis_names=("data", "model"), device=None) -> Mesh:
    """A (data, model) mesh over the first n_data * n_model ranks: rank
    d * n_model + m sits at (d, m). Raises ValueError with too few ranks."""
    return _make((n_data, n_model), tuple(axis_names), device)


def _leaf_spec(x, n_model: int, model_axis: str, min_size: int) -> tuple:
    shape = getattr(x, "shape", ())
    if len(shape) >= 2 and shape[-1] >= min_size and shape[-1] % n_model == 0:
        return tuple([None] * (len(shape) - 1) + [model_axis])
    return ()


def model_parallel_specs(tree: torch.nn.Module, mesh: Mesh, model_axis: str = "model", min_size: int = 8) -> dict:
    """{parameter name: spec in the torch layout} of a module: the axis
    each dimension is cut over (None: whole), ``()`` for a whole leaf,
    decided by ``_leaf_spec`` on the parameter's Flax shape."""
    from ..models.from_flax import flax_path

    n_model = mesh.shape[model_axis]
    specs = {}
    for name, p in tree.named_parameters():
        transposed = flax_path(tree, name)[1]
        spec = _leaf_spec(p.t() if transposed else p, n_model, model_axis, min_size)
        specs[name] = tuple(reversed(spec)) if transposed and spec else spec
    return specs


def shard_model_tree(mesh: Mesh, state, model_axis: str = "model", min_size: int = 8):
    """A ``train_loop.TrainState`` whose optimizer and EMA hold this rank's
    slice of every cut leaf (``model_parallel_specs``) and the whole of the
    rest. The model keeps whole parameters for the forward; Adam moments the
    state already had are sliced alike."""
    specs = model_parallel_specs(state.model, mesh, model_axis, min_size)
    n, i = mesh.shape[model_axis], mesh.index(model_axis)
    shards, leaves = {}, []
    for name, p in state.model.named_parameters():
        if model_axis not in specs[name]:
            leaves.append(p)
            continue
        d = specs[name].index(model_axis)
        c = p.shape[d] // n
        leaf = torch.nn.Parameter(p.detach().narrow(d, i * c, c).clone())
        shards[name] = (d, i * c, c, leaf)
        leaves.append(leaf)
    opt = type(state.optimizer)(leaves, **state.optimizer.defaults)
    for (name, p), leaf in zip(state.model.named_parameters(), leaves):
        old = state.optimizer.state.get(p)
        if old and name in shards:
            d, s, c, _ = shards[name]
            opt.state[leaf] = {k: v.narrow(d, s, c).clone() if torch.is_tensor(v) and v.shape == p.shape else v
                               for k, v in old.items()}
        elif old:
            opt.state[leaf] = old
    ema = {k: v.narrow(*shards[k][:3]).clone() if k in shards else v for k, v in state.ema.items()}
    return dataclasses.replace(state, optimizer=opt, ema=ema, shards=shards, mesh=mesh, model_axis=model_axis)


@torch.no_grad()
def agree(mesh: Mesh, tensors: Sequence[torch.Tensor], axis_name: str = "model") -> None:
    """Overwrite ``tensors`` in place with those of the axis's first rank
    (one broadcast of them flattened). The ranks of a model axis run the
    same data shard, but a card's atomic adds (PyTorch's scatters) may leave
    their gradients and batch statistics a rounding apart; they keep one."""
    group = mesh.groups[axis_name]
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=mesh.group_ranks[axis_name][0], group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def gather_model_tree(state) -> None:
    """Write every rank's updated slices of the cut leaves into the whole
    parameters of ``state.model`` on every rank of the model axis (one
    all_gather of the flattened slices)."""
    mesh, axis = state.mesh, state.model_axis
    group, n = mesh.groups[axis], mesh.shape[axis]
    params = dict(state.model.named_parameters())
    names = list(state.shards)
    if group is None or not names:
        return
    flat = torch.cat([state.shards[k][3].reshape(-1) for k in names])
    parts = _gather(flat, group, n)
    off = 0
    for k in names:
        d, _, c, leaf = state.shards[k]
        pieces = [part[off:off + leaf.numel()].view_as(leaf) for part in parts]
        params[k].copy_(torch.cat(pieces, dim=d))
        off += leaf.numel()
