"""Process meshes for sharded ensemble sweeps, on ``torch.distributed``.

Counterpart of ``kinetica_tpu/parallel/sharding.py``. The reference runs
one process over a ``jax.sharding.Mesh`` of devices, and ``shard_map``
splits the program. PyTorch has no single-controller SPMD, so here a mesh
position is a *process* (SPMD over ``torch.distributed``): every rank of
the default process group runs the same code on its own block of the
inputs.

* ``("batch",)`` meshes split the ensemble members; the hot path has no
  collective, and the ranks exchange their results once per solve.
* ``("batch", "model")`` meshes also split the reaction axis over
  ``model``: each model rank evaluates its reactions' share of du/dt and
  of the Jacobian, an ``all_reduce`` over the model axis sums the shares,
  and every model rank then runs the identical BDF loop on the sums
  (:meth:`~kinetica_tpu_torch.parallel.batching.EnsembleProblem.solve`).

A mesh holds one process subgroup per axis and a gloo group over all its
ranks, which carries the results as CPU tensors. Its axis groups use NCCL
where every rank has a card of its own, and gloo otherwise (several ranks
on one card: NCCL refuses two ranks on one device). The NCCL route has not
run yet: the one-card machine of the port's checks and the CPU tests use
gloo.

Launch: one process per rank, each calling
``torch.distributed.init_process_group`` with the same rendezvous, then
:func:`make_mesh`. :mod:`kinetica_tpu_torch.testing.sharded_ranks` does
so for the tests and the chip smoke run.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)

# model-axis all_reduce calls and their host wall seconds since the last
# reset (the sharded RHS and Jacobian count them; a run reports them)
all_reduces = 0
all_reduce_seconds = 0.0


class Mesh:
    """The ranks of the default process group laid out row-major over
    ``shape``, as ``np.asarray(devices).reshape(shape)`` lays devices out
    in the reference.

    ``devices`` is that (shape) array of ranks, ``shape`` maps each axis
    name to its size, ``coords`` this rank's index along each axis and
    ``device`` the torch device this rank computes on.
    """

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 device: torch.device, backend: str,
                 timeout: datetime.timedelta):
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = dist.get_rank()
        here = np.argwhere(self.devices == self.rank)[0]
        self.coords = dict(zip(self.axis_names, (int(i) for i in here)))
        self.device = device
        self.backend = backend
        self._groups = {}
        # every rank creates every group, in one order (new_group is a
        # collective over the default group)
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, ax, -1).reshape(-1, shape[ax])
            for line in lines:
                g = dist.new_group([int(r) for r in line], timeout=timeout,
                                   backend=backend)
                if self.rank in line:
                    self._groups[name] = g
        self.host_group = dist.new_group(
            [int(r) for r in self.devices.ravel()], timeout=timeout,
            backend="gloo")

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._groups[axis]

    def ranks_at(self, axis: str, index: int) -> list[int]:
        """The ranks whose coordinate along ``axis`` is ``index``."""
        ax = self.axis_names.index(axis)
        return [int(r) for r in np.take(self.devices, index, axis=ax).ravel()]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and np.array_equal(self.devices, other.devices))

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def make_mesh(n_devices: int | None = None, axis_names=("batch",),
              shape: tuple[int, ...] | None = None, device=None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Create a process mesh. 1-D ``(batch,)`` by default.

    ``shape`` allows multi-axis meshes, e.g. ``shape=(4, 2)`` with
    ``axis_names=("batch", "model")``. Needs an initialised default
    process group whose ranks all join the call; the mesh uses exactly
    those ranks. ``device``: None for this rank's card (``cuda:{local
    rank}`` where every rank has one, else the local rank's card modulo
    the count: ``cuda:0`` for every rank on a one-card machine), or an
    explicit device such as ``"cpu"``. ``timeout`` bounds every collective
    of the mesh's groups: a rank that stops taking part (its ranks have
    diverged) makes the others raise instead of hang.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) in every rank first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if shape is None:
        shape = (n_devices,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} does not use {n_devices} devices")
    if n_devices != world:
        raise ValueError(f"a mesh uses every rank of the process group: "
                         f"{n_devices} devices asked for, {world} ranks")
    if len(axis_names) != len(shape):
        raise ValueError(f"axis names {tuple(axis_names)} do not match the "
                         f"mesh shape {shape}")
    rank = dist.get_rank()
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    own_card = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no card for this rank (pass "
                               "device='cpu' to run the ranks on the CPU)")
        n_cards = torch.cuda.device_count()
        own_card = n_cards >= local_world
        device = torch.device("cuda", local_rank % n_cards)
    else:
        device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if own_card and dist.is_nccl_available() else "gloo"
    return Mesh(shape, tuple(axis_names), device, backend, timeout)


class Placement(NamedTuple):
    """Where an array's axes go on a mesh, the counterpart of
    ``NamedSharding(mesh, PartitionSpec(*spec))``: entry i of ``spec``
    names the mesh axis that splits array axis i (None: not split)."""
    mesh: Mesh
    spec: tuple

    def local(self, x):
        """This rank's block of ``x`` (a numpy array or a tensor)."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n, i = self.mesh.shape[axis], self.mesh.coords[axis]
            if x.shape[dim] % n:
                raise ValueError(f"axis {dim} of length {x.shape[dim]} does "
                                 f"not split over {n} ranks of {axis!r}")
            step = x.shape[dim] // n
            sl = [slice(None)] * x.ndim
            sl[dim] = slice(i * step, (i + 1) * step)
            x = x[tuple(sl)]
        return x


def batch_sharding(mesh: Mesh, axis: str = "batch") -> Placement:
    """Shard the leading (ensemble) axis over the mesh; replicate the rest."""
    return Placement(mesh, (axis,))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def shard_ensemble(mesh: Mesh, arrays, axis: str = "batch"):
    """This rank's blocks of member-major arrays, on the mesh's device.

    ``arrays`` is an array or a dict, list or tuple of them (nested).
    Where the reference returns global arrays laid over its devices, a
    rank here holds only its own block."""
    sh = batch_sharding(mesh, axis)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return torch.as_tensor(sh.local(x), device=mesh.device)

    return put(arrays)


def ensemble_shardings(mesh: Mesh):
    """Input placements for an :class:`EnsembleProblem` solve over ``mesh``.

    Returns ``(u0_sharding, ktable_sharding)``:

    * 1-D ``("batch",)`` mesh — both shard the leading (member) axis.
    * 2-D ``("batch", "model")`` mesh — members shard over ``batch``
      while the REACTION axis of the discrete k-table (B, n_t, nr) shards
      over ``model``.

    State (u0, solution) is replicated over ``model``: every model rank
    holds the full species vector, only per-reaction work is split.
    """
    if "model" in mesh.axis_names:
        return (Placement(mesh, ("batch",)),
                Placement(mesh, ("batch", None, "model")))
    return Placement(mesh, ("batch",)), Placement(mesh, ("batch",))


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, on every one of them.

    Every rank receives the same bits. The ranks of the axis must make the
    same calls with the same shapes; an empty tensor needs no exchange, so
    every rank skips it alike."""
    global all_reduces, all_reduce_seconds
    if x.numel() == 0:
        return x
    x = x.contiguous()
    t0 = time.perf_counter()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    all_reduce_seconds += time.perf_counter() - t0
    all_reduces += 1
    return x


def gather_members(mesh: Mesh, axis: str | None, arrays: dict,
                   agree: tuple[str, ...] = ()):
    """Every rank's member block of each array, joined in ``axis`` order.

    Each value of ``arrays`` is this rank's (B_local, ...) numpy array. The
    blocks travel as CPU tensors over the mesh's gloo group, and every rank
    returns the same joined arrays. Ranks that share a coordinate along
    ``axis`` (the model ranks of one batch block, or every rank where
    ``axis`` is None) hold the same members: the arrays named in ``agree``
    must be equal among them, else their runs diverged and this raises.
    Returns ``(joined, spread)``: ``spread`` is the largest difference of
    any other array between such ranks (0.0 when they agree bit for bit).
    """
    world = mesh.devices.size
    parts = {}
    for name, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t, group=mesh.host_group)
        parts[name] = [o.numpy() for o in out]
    n = mesh.shape[axis] if axis is not None else 1
    joined = {k: [] for k in arrays}
    spread = 0.0
    for i in range(n):
        ranks = (mesh.ranks_at(axis, i) if axis is not None
                 else [int(r) for r in mesh.devices.ravel()])
        lead = ranks[0]
        for name in arrays:
            ref = parts[name][lead]
            for r in ranks[1:]:
                other = parts[name][r]
                if name in agree:
                    if not np.array_equal(other, ref):
                        raise RuntimeError(
                            f"ranks {lead} and {r} hold the same members but "
                            f"their {name!r} differ: the ranks diverged")
                elif other.size:
                    spread = max(spread, float(np.max(np.abs(
                        other.astype(np.float64) - ref.astype(np.float64)))))
            joined[name].append(ref)
    return {k: np.concatenate(v) for k, v in joined.items()}, spread
