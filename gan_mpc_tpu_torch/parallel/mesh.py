"""The device mesh over ``torch.distributed``, and the sharding and
collective helpers of the data-parallel steps.

Counterpart of ``gan_mpc_tpu/parallel/mesh.py``. JAX runs one program
over every device of a ``jax.sharding.Mesh``; here one process per
device (a rank, spawned by ``parallel/launch.py``) runs the same code
(SPMD), and a ``Mesh`` is this rank's view of the group: the axis names
and sizes, this rank's coordinates, and the process group of each axis.
A mesh of one device needs no process group: its collectives are the
identity, as JAX's over a one-device axis.

The collectives the steps and the fused epochs use are the counterparts
of the JAX closures (``training/fused_epoch.py:172-188``): ``pmean``
(``jax.lax.pmean``: a sum over the axis divided by its size, so that it
needs no ``ReduceOp.AVG``), ``gather`` (``all_gather(..., tiled=True)``
on axis 0) and ``rows`` (this rank's equal block of a replicated
leading axis). Gloo takes CUDA tensors for no collective but a few, so
under gloo (ranks on the CPU, or ranks sharing one card) each collective
goes through a host copy.

Sharding helpers: ``batch_sharding`` / ``shard_batch`` give this rank its
block of leading rows (the size must divide, as JAX's callers keep it);
``mlp_tensor_parallel_sharding`` / ``apply_tensor_parallel`` its column
block of each kernel's and bias's last axis where that axis divides, the
rest replicated (JAX's rule); ``replicate`` broadcasts rank 0's tensors.
"""

from __future__ import annotations

import math
import socket
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[None, str, Sequence[str]]


def default_devices(n: int) -> List[str]:
    """cuda:0..n-1, one card per rank; raises where fewer cards are
    attached (the JAX ``maybe_mesh`` check): a run never doubles ranks up
    on a card or drops to the CPU unless the caller's ``devices`` say so."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise ValueError(f"a mesh of {n} devices asked for, but only {count} CUDA devices "
                         "are attached")
    return [f"cuda:{i}" for i in range(n)]


def backend_for(devices: Sequence) -> str:
    """NCCL where every rank has a card of its own, else gloo (ranks on the
    CPU, or ranks sharing a card, which only tests and the smoke script
    ask for)."""
    devs = [torch.device(d) for d in devices]
    own_cards = all(d.type == "cuda" for d in devs) and \
        len({d.index for d in devs}) == len(devs)
    return "nccl" if own_cards else "gloo"


class Mesh:
    """This rank's view of a mesh of ``prod(shape)`` ranks with axis
    ``axis_names``: ranks in row-major order over the axes. ``shape`` maps
    each axis name to its size, as JAX's ``Mesh.shape`` does."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.backend = dist.get_backend() if self.distributed else None
        self.device_mesh = device_mesh
        coords, rest = [], self.rank
        for name in reversed(self.axis_names):
            coords.append(rest % self.shape[name])
            rest //= self.shape[name]
        self.coords = dict(zip(reversed(self.axis_names), coords))

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        if axes is None:
            return self.axis_names
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh axes {self.axis_names} have no {unknown}")
        return names

    def axis_size(self, axes: Axes = None) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes: Axes = None) -> int:
        """This rank's index along ``axes`` (row-major over them), as
        ``jax.lax.axis_index`` of a tuple of axes."""
        index = 0
        for a in self._axes(axes):
            index = index * self.shape[a] + self.coords[a]
        return index

    def group(self, axes: Axes = None):
        """The process group that spans ``axes`` through this rank (None:
        the default group, or no communication for a one-rank axis)."""
        names = self._axes(axes)
        if set(names) == set(self.axis_names):
            return None
        if len(names) != 1:
            raise ValueError(f"a group over {names} of a mesh {self.axis_names}: "
                             "take one axis or all of them")
        return self.device_mesh.get_group(names[0])

    def _collective(self, x: torch.Tensor, axes: Axes, op) -> torch.Tensor:
        """``op(tensor, group)`` on a copy of ``x`` fit for the backend (on
        the host under gloo), returned on ``x``'s device."""
        staged = x.detach().cpu() if self.backend == "gloo" else x.detach()
        out = op(staged.contiguous().clone(), self.group(axes))
        return out.to(x.device)

    def psum(self, x: torch.Tensor, axes: Axes = None) -> torch.Tensor:
        if self.axis_size(axes) == 1:
            return x

        def op(t, group):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            return t

        return self._collective(x, axes, op)

    def pmean(self, x: torch.Tensor, axes: Axes = None) -> torch.Tensor:
        """The mean over ``axes`` (``jax.lax.pmean``): the sum divided by the
        axes' size."""
        n = self.axis_size(axes)
        return x if n == 1 else self.psum(x, axes) / n

    def gather(self, x: torch.Tensor, axes: Axes = None) -> torch.Tensor:
        """Every rank's ``x`` along ``axes``, concatenated on axis 0 in the
        axis order (``jax.lax.all_gather(..., tiled=True)``)."""
        n = self.axis_size(axes)
        if n == 1:
            return x

        def op(t, group):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            return torch.cat(parts)

        return self._collective(x, axes, op)

    def rows(self, x: torch.Tensor, axes: Axes = None) -> torch.Tensor:
        """This rank's equal block of ``x``'s leading axis along ``axes``."""
        n = self.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not divide the mesh axes "
                             f"{self._axes(axes)} of size {n}")
        step = x.shape[0] // n
        return x[self.axis_index(axes) * step:(self.axis_index(axes) + 1) * step]

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` overwritten in place by rank ``src``'s."""
        if self.size == 1:
            return x

        def op(t, group):
            dist.broadcast(t, src, group=group)
            return t

        with torch.no_grad():
            x.copy_(self._collective(x, None, op))
        return x

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank (tensors in it on
        the host)."""
        if self.size == 1:
            return obj
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src)
        return box[0]

    def reduce_gradients(self, params: Iterable[torch.Tensor], axes: Axes = None,
                         divide_by: Optional[int] = None) -> None:
        """Every ``.grad`` of ``params`` summed over ``axes`` in one
        collective and divided by ``divide_by`` (default: the axes' size, so
        the mean), in place."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads or self.axis_size(axes) == 1 and divide_by in (None, 1):
            return
        flat = self.psum(torch.cat([g.reshape(-1) for g in grads]), axes)
        flat = flat / (self.axis_size(axes) if divide_by is None else divide_by)
        for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def optimizer_params(optimizer) -> List[torch.Tensor]:
    """The parameters ``optimizer`` steps (``masking.ClippedAdam`` or a
    ``torch.optim`` optimizer)."""
    if hasattr(optimizer, "params"):
        return list(optimizer.params)
    return [p for group in optimizer.param_groups for p in group["params"]]


def data_parallel_step(optimizer, compute_loss, mesh: Optional[Mesh] = None,
                       axes: Axes = None) -> torch.Tensor:
    """One optimizer step on the scalar ``compute_loss()`` of this rank's
    rows: backward, then (with a mesh) every gradient averaged over
    ``axes``, so that the optimizer's clipping sees the averaged gradient
    (JAX's ``opt.update(pmean(grads))``), then the step. Returns the loss,
    detached, averaged over ``axes``."""
    optimizer.zero_grad()
    loss = compute_loss()
    loss.backward()
    if mesh is not None:
        mesh.reduce_gradients(optimizer_params(optimizer), axes)
        loss = mesh.pmean(loss.detach(), axes)
    optimizer.step()
    return loss.detach()


def make_mesh(num_devices: Optional[int] = None, axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of the ranks of this process group (``parallel/launch.py``
    spawns them), ``shape`` over ``axis_names`` (default one axis of all
    of them). Outside a process group only a one-device mesh exists; a
    mesh of more devices than cards raises. ``devices`` (one entry per
    rank) is checked against the group's size."""
    in_group = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if in_group else 1
    n = num_devices or (len(devices) if devices is not None else world)
    if shape is None:
        shape = (n,)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(axis_names)} axis names for a {len(shape)}-axis shape")
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n}")
    if n != world:
        if not in_group and devices is None:
            default_devices(n)  # raises where fewer cards are attached
        raise ValueError(f"a mesh of {n} devices in a group of {world} ranks: run one rank "
                         "per device (parallel.launch.spawn)")
    device_mesh = None
    if in_group and len(shape) > 1:
        from torch.distributed.device_mesh import init_device_mesh

        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        current = torch.cuda.current_device() if kind == "cuda" else None
        device_mesh = init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axis_names))
        if current is not None:
            torch.cuda.set_device(current)  # the mesh may pick a card by rank
    return Mesh(axis_names, shape, device_mesh)


def make_hybrid_mesh(axis_names: Sequence[str] = ("dcn", "ici"),
                     dcn_size: Optional[int] = None) -> Mesh:
    """The 2-D multi-host mesh: the slow axis ("dcn") crosses hosts, the
    fast one ("ici") stays within a host, so that a reduction over both
    takes the host-local traffic first. Rows are the hosts (their ranks
    contiguous, as one launcher per host numbers them); ``dcn_size``
    splits the ranks into that many rows instead, as JAX's tests split
    virtual devices into fake slices."""
    in_group = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if in_group else 1
    if dcn_size is None:
        hosts = [socket.gethostname()]
        if in_group and world > 1:
            hosts = [None] * world
            dist.all_gather_object(hosts, socket.gethostname())
        rows = [h for i, h in enumerate(hosts) if i == 0 or hosts[i - 1] != h]
        if len(set(rows)) != len(rows):
            raise ValueError("the ranks of a host are not contiguous: pass dcn_size")
        dcn_size = len(rows)
    if world % dcn_size:
        raise ValueError(f"{world} devices not divisible into {dcn_size} slices")
    return make_mesh(world, tuple(axis_names), (dcn_size, world // dcn_size))


def data_axes(mesh: Mesh):
    """The mesh axes a data batch shards over: all of ("dcn", "ici") that
    exist, else the 1-D "dp" axis; usable as the ``axis`` of every
    sharded step."""
    names = tuple(a for a in ("dcn", "ici") if a in mesh.axis_names)
    return names if names else "dp"


class Sharding(NamedTuple):
    """How a tensor lies on the mesh (JAX's ``NamedSharding``): ``spec``
    names, per leading dimension, the mesh axes it is split over (None:
    whole); an empty spec is replicated."""

    mesh: Mesh
    spec: tuple = ()

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        for dim, axes in enumerate(self.spec):
            if axes is not None:
                x = self.mesh.rows(x.movedim(dim, 0), axes).movedim(0, dim)
        return x


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        mapped = [_tree_map(fn, v) for v in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree)


def replicate(tree, mesh: Mesh, src: int = 0):
    """Every tensor of ``tree`` overwritten in place by rank ``src``'s (the
    counterpart of placing it with ``NamedSharding(mesh, P())``)."""
    return _tree_map(lambda t: mesh.broadcast_(t, src) if torch.is_tensor(t) else t, tree)


def batch_sharding(mesh: Mesh, axis: Axes = "dp") -> Sharding:
    """The leading (batch) dimension split over ``axis``."""
    return Sharding(mesh, (axis,))


def shard_batch(tree, mesh: Mesh, axis: Axes = "dp"):
    """This rank's block of every tensor's leading dimension (raises where
    it does not divide the axis: callers keep batch % devices == 0)."""
    sharding = batch_sharding(mesh, axis)
    return _tree_map(lambda t: sharding.shard(t) if torch.is_tensor(t) else t, tree)


def mlp_tensor_parallel_sharding(params, mesh: Mesh, axis: str = "tp"):
    """Per tensor of ``params``: the last axis split over ``axis`` where it
    divides the axis size (the hidden columns of kernels and biases), else
    replicated (JAX's rule)."""
    size = mesh.shape[axis]

    def spec(t):
        if torch.is_tensor(t) and t.dim() >= 1 and t.shape[-1] % size == 0:
            return Sharding(mesh, (None,) * (t.dim() - 1) + (axis,))
        return Sharding(mesh, ())

    return _tree_map(spec, params)


def apply_tensor_parallel(params, mesh: Mesh, axis: str = "tp"):
    """This rank's blocks of ``params`` by ``mlp_tensor_parallel_sharding``."""
    return _tree_map(lambda t: mlp_tensor_parallel_sharding(t, mesh, axis).shard(t)
                     if torch.is_tensor(t) else t, params)
