"""The mesh: the multi-process launch, the rank layout over nodes, and the
collectives of data- and tensor-parallel training.

Counterpart of ``m3f/pytorch_tpu/parallel/mesh.py``. The JAX package builds
one ``Mesh(('data', 'model'))`` and GSPMD inserts the collectives: with the
batch sharded over ``data``, every reduction over the batch is global, so a
data-parallel step equals the one-device step on the whole batch; with
``num_model > 1`` the BiGRU's gate matrices are column-parallel and the
fusion head row-parallel over ``model``. The port runs one process a card,
joined by a ``torch.distributed`` group, and inserts the same collectives
itself:

- ``distributed_init_plan(env)`` decides from the environment whether this
  process joins a group (a pure function); ``maybe_initialize_distributed``
  applies it (idempotent, loud on any mismatch; NCCL on the card, gloo on
  the CPU, or the backend the caller names). The device of a rank is
  ``cuda:LOCAL_RANK``.
- ``order_ranks_for_mesh(node_ids, num_data, num_model)`` lays the ranks
  out as ``num_data`` rows of ``num_model`` (a pure function): one node,
  the plain reshape; several, every row within one node (the per-layer
  tensor-parallel collectives stay on the node's links) and the data axis
  node-major.
- ``create_mesh(num_data, num_model)`` → ``Mesh``: the data axis (this
  process's row and the rows, as a ``DataAxis``: the mesh is one) and the
  model axis (``Mesh.model``: its place in the row); ``num_data=-1``
  takes world / ``num_model`` rows. Every rank creates every row group
  and every column group, in one order.
- Inside ``data_parallel(axis)`` (a train step's forward, loss and
  backward) the reductions over the batch are summed over the data axis:

  - ``all_sum``: BatchNorm's channel sums. Its backward sums over the ranks
    too, because the gradient that reaches a sum on one rank covers that
    rank's activations only.
  - ``replicated_sum``: the loss's statistics. Every rank computes the same
    loss from them, so the backward passes the gradient through and does
    not sum again (which would scale the loss by the world size).
  - ``spread``: a replicated value used on a rank's own rows (the two-pass
    CCC's means): the identity forward, a sum over the ranks backward.

  ``sum_grads`` then sums the parameter gradients over the data axis, so
  every rank applies the update of the one-device step.
- Tensor parallelism: ``tp_spec(name, shape, n_model)`` says which leaves
  are sharded (the reference's ``_tp_spec`` on the port's names), and
  ``TensorParallel`` holds a rank's layout: a sharded leaf, its optimizer
  moments and its EMA shadow are held as the rank's block only.
  ``gather_blocks`` (the blocks of the model axis into the full tensor;
  the backward takes the rank's own block and does not sum, as every model
  rank computes the same full gradient), ``take_block`` (its dual: the
  backward gathers the blocks' gradients) and ``model_sum`` (the partial
  products of a row-parallel product; the backward passes through) are the
  model's collectives; ``axis_sum`` adds the gradient norm's sharded
  squares.
- ``DataAxis.rows`` / ``local_rows``: data rank r holds rows r·b … (r+1)·b
  − 1 of a global batch of b rows a rank; the ranks of a row hold the same
  rows.

Without a process group every helper is the identity, and one process runs
as it did before this module existed.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the signals of the JAX package's launchers, which the port does not read
_JAX_LAUNCHERS = ("MEGASCALE_COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_TORCH_SIGNALS = ("--coordinator host:port,num_processes,process_id (or "
                  "M3F_COORDINATOR), or torchrun's RANK, WORLD_SIZE, "
                  "MASTER_ADDR and MASTER_PORT")


@dataclass(frozen=True)
class DistInitPlan:
    """The decision of ``distributed_init_plan``: pure data.

    ``initialize``: call ``torch.distributed.init_process_group(**kwargs)``.
    ``expect_processes``: the world size the group must have after init.
    ``local_rank``: ``LOCAL_RANK`` when the launcher set it (the rank's
    card), else None. ``reason``: which signal decided."""
    initialize: bool
    reason: str
    kwargs: Dict = field(default_factory=dict)
    expect_processes: Optional[int] = None
    local_rank: Optional[int] = None


def _int(env: Mapping[str, str], key: str) -> int:
    try:
        return int(env[key])
    except ValueError:
        raise ValueError(f"{key}={env[key]!r} is not an integer") from None


def _check_rank(world: int, rank: int, source: str) -> None:
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"{source}: rank {rank} of {world} processes is not "
                         "a rank of the job — refusing to guess its shape")


def distributed_init_plan(env: Mapping[str, str]) -> DistInitPlan:
    """Should this process join a ``torch.distributed`` group? Signals, in
    order:

    1. ``M3F_COORDINATOR=host:port,num_processes,process_id`` (set by the
       ``--coordinator`` flag): a TCP rendezvous at host:port. The
       address-only form takes the rank and world size from torchrun's
       ``RANK`` / ``WORLD_SIZE``.
    2. torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
       ``MASTER_PORT``, all four or none: a TCP rendezvous at
       MASTER_ADDR:MASTER_PORT.
    3. The JAX launchers' signals (``MEGASCALE_COORDINATOR_ADDRESS``,
       ``JAX_COORDINATOR_ADDRESS``, ``TPU_WORKER_HOSTNAMES`` with more than
       one host) are refused with ``NotImplementedError``: they name a
       launcher of the JAX package.

    Inconsistent signals (a rank outside the world, a partial torchrun
    environment) raise ``ValueError`` here, before any network call."""
    local = _int(env, "LOCAL_RANK") if env.get("LOCAL_RANK") else None
    coord = env.get("M3F_COORDINATOR", "")
    if coord:
        parts = [p.strip() for p in coord.split(",")]
        if len(parts) == 3:
            try:
                world, rank = int(parts[1]), int(parts[2])
            except ValueError:
                raise ValueError(f"M3F_COORDINATOR={coord!r}: num_processes "
                                 "and process_id must be integers") from None
            reason = "M3F_COORDINATOR (explicit)"
        elif len(parts) == 1 and env.get("RANK") and env.get("WORLD_SIZE"):
            world, rank = _int(env, "WORLD_SIZE"), _int(env, "RANK")
            reason = "M3F_COORDINATOR (explicit) with RANK / WORLD_SIZE"
        elif len(parts) == 1:
            raise ValueError(
                f"M3F_COORDINATOR={coord!r} gives no process count and rank: "
                "pass host:port,num_processes,process_id, or set RANK and "
                "WORLD_SIZE")
        else:
            raise ValueError(f"M3F_COORDINATOR={coord!r}: expected host:port "
                             "or host:port,num_processes,process_id")
        _check_rank(world, rank, "M3F_COORDINATOR")
        return DistInitPlan(True, reason,
                            {"init_method": f"tcp://{parts[0]}",
                             "world_size": world, "rank": rank}, world, local)
    have = [k for k in _TORCHRUN if env.get(k)]
    if have:
        missing = [k for k in _TORCHRUN if not env.get(k)]
        if missing:
            raise ValueError(
                f"torchrun's environment is partial: {', '.join(have)} set "
                f"but {', '.join(missing)} not — refusing to guess the job "
                "shape")
        world, rank = _int(env, "WORLD_SIZE"), _int(env, "RANK")
        _check_rank(world, rank, "RANK / WORLD_SIZE")
        return DistInitPlan(True, "torchrun env (RANK, WORLD_SIZE, "
                            "MASTER_ADDR, MASTER_PORT)",
                            {"init_method": f"tcp://{env['MASTER_ADDR']}:"
                                            f"{env['MASTER_PORT']}",
                             "world_size": world, "rank": rank}, world, local)
    jax_signals = [k for k in _JAX_LAUNCHERS if env.get(k)]
    hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",")
             if h.strip()]
    if len(hosts) > 1:
        jax_signals.append("TPU_WORKER_HOSTNAMES")
    if jax_signals:
        raise NotImplementedError(
            f"{', '.join(jax_signals)} name a launcher of the JAX package, "
            f"which the port does not read: launch it with {_TORCH_SIGNALS}")
    return DistInitPlan(False, "single-process (no multi-process signal)")


def maybe_initialize_distributed(env: Optional[Mapping[str, str]] = None, *,
                                 device="cuda",
                                 backend: Optional[str] = None
                                 ) -> DistInitPlan:
    """Apply ``distributed_init_plan``; idempotent (a process already in a
    group keeps it); loud when anything is wrong.

    ``device`` "cuda": the rank's card becomes the current device
    (``LOCAL_RANK``, else the rank modulo the cards) and the group uses
    NCCL; "cpu": gloo. ``backend`` names another one explicitly (gloo for
    several ranks on one card, which NCCL refuses). A failing init raises
    ``RuntimeError`` — it never carries on as one process, which would
    train one private copy of the run a process — and so does a group whose
    world size is not the one the signals promised."""
    plan = distributed_init_plan(os.environ if env is None else env)
    if not plan.initialize or dist.is_initialized():
        return plan
    dev = torch.device(device)
    kwargs = dict(plan.kwargs)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run on the CPU")
        local = plan.local_rank if plan.local_rank is not None \
            else kwargs["rank"] % torch.cuda.device_count()
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local)
    try:
        dist.init_process_group(backend, **kwargs)
    except Exception as e:  # noqa: BLE001 — re-raised with the decision trail
        raise RuntimeError(
            f"multi-process launch detected via {plan.reason} but "
            f"init_process_group({backend!r}, {plan.kwargs}) failed. Refusing "
            "to continue as one process: that would train one private copy "
            "of the run a process. Fix the launch environment or unset the "
            "multi-process variables to really run one process.") from e
    if dist.get_world_size() != plan.expect_processes:
        raise RuntimeError(
            f"the group has {dist.get_world_size()} processes but "
            f"{plan.reason} promised {plan.expect_processes} — the processes "
            "disagree about the job shape; aborting before any of them "
            "trains a private copy of the run")
    return plan


@dataclass(frozen=True)
class DataAxis:
    """One axis of the mesh as this process sees it: its ``rank`` among the
    ``size`` processes of ``group`` (None: no process group, one process,
    nothing reduced), and ``ranks``, the global ranks of the axis in its
    order (a group's own rank order is that of the sorted global ranks)."""
    size: int = 1
    rank: int = 0
    group: Any = None
    ranks: Tuple[int, ...] = (0,)

    def rows(self, local: int) -> slice:
        """This rank's rows of a global batch of ``local`` rows a rank."""
        return slice(self.rank * local, (self.rank + 1) * local)


@dataclass(frozen=True)
class Mesh(DataAxis):
    """The two axes of one process: as a ``DataAxis`` the data axis (its
    row among ``size`` rows: the column of ranks holding the same place in
    their rows), and ``model``, its place in its row (the ranks that share
    its rows, over which the model is tensor-parallel). ``layout`` holds
    the global ranks, ``num_data`` rows of ``num_model``."""
    model: DataAxis = field(default_factory=DataAxis)
    layout: Tuple[Tuple[int, ...], ...] = ((0,),)

    @property
    def data(self) -> DataAxis:
        return DataAxis(self.size, self.rank, self.group, self.ranks)


def order_ranks_for_mesh(node_ids: Sequence[Hashable], num_data: int,
                         num_model: int) -> np.ndarray:
    """The global ranks of a ``num_data`` x ``num_model`` mesh, [num_data,
    num_model] int: the counterpart of the reference's
    ``order_devices_for_mesh`` with rank r on node ``node_ids[r]``.

    One node: the plain reshape of ranks 0 … n-1. Several: every row lies
    within one node, its ranks in rank order, so the tensor-parallel
    collectives (per layer, many a step) stay on the node's links; the rows
    go node by node in the order of the sorted node ids (the data axis is
    node-major), so only the once-a-step gradient sum crosses nodes. A node
    whose rank count ``num_model`` does not divide is refused (a row would
    cross nodes), as are fewer rows than ``num_data``."""
    groups: Dict[Hashable, List[int]] = {}
    for r, s in enumerate(node_ids):
        groups.setdefault(s, []).append(r)
    use = num_data * num_model
    if len(groups) <= 1:
        if use > len(node_ids):
            raise ValueError(f"mesh {num_data}x{num_model} needs {use} "
                             f"devices, have {len(node_ids)}")
        return np.arange(use, dtype=np.int64).reshape(num_data, num_model)
    rows = []
    for s in sorted(groups):
        g = groups[s]
        if len(g) % num_model:
            raise ValueError(
                f"node {s} has {len(g)} ranks, not a multiple of "
                f"num_model={num_model} — a tensor-parallel group would "
                "cross nodes (inter-node links); choose num_model to divide "
                "every node's rank count")
        rows.extend(g[i:i + num_model] for i in range(0, len(g), num_model))
    if num_data > len(rows):
        raise ValueError(f"mesh {num_data}x{num_model} needs {num_data} "
                         f"rows, nodes provide {len(rows)}")
    return np.asarray(rows[:num_data], dtype=np.int64)


def _node_ids() -> List[int]:
    """Every rank's node, numbered in order of first appearance: torchrun's
    ``GROUP_RANK`` where it is set, else the host name, gathered over the
    world group."""
    mine = os.environ.get("GROUP_RANK") or socket.gethostname()
    every: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    first: Dict[Any, int] = {}
    return [first.setdefault(v, len(first)) for v in every]


def create_mesh(num_data: int = -1, num_model: int = 1,
                node_ids: Optional[Sequence[Hashable]] = None) -> Mesh:
    """The mesh over the processes of the ``torch.distributed`` group (one
    process without a group), each holding one device: ``num_data`` rows
    of ``num_model`` ranks (``num_data`` -1: world / ``num_model``), laid
    out by ``order_ranks_for_mesh`` over ``node_ids`` (default: each
    rank's node, ``_node_ids``). Every process must take part in the mesh:
    a world of another size than ``num_data`` x ``num_model`` is refused
    with the reference's words, as is ``num_model < 1``."""
    if num_model < 1:
        raise ValueError(f"train.mesh.num_model must be at least 1, got "
                         f"{num_model}")
    world = world_axis()
    n = world.size
    if num_data == -1:
        if n % num_model:
            raise ValueError(
                f"mesh -1x{num_model} needs a multiple of {num_model} "
                f"devices, have {n}")
        num_data = n // num_model
    if num_data < 1:
        raise ValueError(f"train.mesh.num_data must be -1 or at least 1, got "
                         f"{num_data}")
    use = num_data * num_model
    if use > n:
        raise ValueError(f"mesh {num_data}x{num_model} needs {use} "
                         f"devices, have {n}")
    if use < n:
        raise ValueError(
            f"mesh {num_data}x{num_model} leaves {n - use} of the {n} "
            "processes out: each process holds one device of the mesh, so "
            f"train.mesh.num_data must be -1 or {n // num_model}")
    if world.group is None:
        return Mesh()
    nodes = _node_ids() if node_ids is None else list(node_ids)
    layout = order_ranks_for_mesh(nodes, num_data, num_model).tolist()
    me = world.rank
    # every rank creates every group, rows then columns, in one order
    data = model = None
    for i, row in enumerate(layout):
        g = dist.new_group(row) if num_model > 1 else None
        if me in row:
            model = DataAxis(num_model, row.index(me), g, tuple(row))
    for k in range(num_model):
        col = [row[k] for row in layout]
        g = dist.group.WORLD if col == list(range(n)) else dist.new_group(col)
        if me in col:
            data = DataAxis(num_data, col.index(me), g, tuple(col))
    if num_model == 1:
        model = DataAxis(1, 0, None, (me,))
    return Mesh(data.size, data.rank, data.group, data.ranks, model,
                tuple(tuple(r) for r in layout))


def world_axis() -> DataAxis:
    """The axis over every process of the initialised ``torch.distributed``
    group; one process (no group) without one."""
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        return DataAxis(n, dist.get_rank(), dist.group.WORLD,
                        tuple(range(n)))
    return DataAxis()


# -- the active axis ---------------------------------------------------------

_active = threading.local()


@contextlib.contextmanager
def data_parallel(axis: DataAxis):
    """Within: the batch reductions of this thread's forward and loss are
    global over ``axis`` (nothing changes for an axis without a group)."""
    prev = getattr(_active, "axis", None)
    _active.axis = axis if axis.group is not None else None
    try:
        yield
    finally:
        _active.axis = prev


def active_axis() -> Optional[DataAxis]:
    """The axis of the enclosing ``data_parallel`` with a group, else
    None."""
    return getattr(_active, "axis", None)


def data_size() -> int:
    """The number of ranks the active axis spans (1 outside one)."""
    axis = active_axis()
    return 1 if axis is None else axis.size


def global_rows(local: int) -> Tuple[int, slice]:
    """(global row count, this rank's rows) of a batch of ``local`` rows
    under the active axis; (local, all rows) outside one."""
    axis = active_axis()
    if axis is None:
        return local, slice(0, local)
    return local * axis.size, axis.rows(local)


# -- differentiable collectives ------------------------------------------------

def _flat_all_reduce(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum ``tensors`` (one dtype) over ``group`` in one collective → new
    tensors of their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    parts = flat.split([t.numel() for t in tensors])
    return [p.reshape(t.shape).clone() for p, t in zip(parts, tensors)]


class _Sum(torch.autograd.Function):
    """All-reduce (sum) of several tensors in one collective; the backward
    sums over the ranks (``backward_sums``) or passes through."""

    @staticmethod
    def forward(ctx, group, backward_sums, *xs):
        ctx.group, ctx.backward_sums = group, backward_sums
        ctx.likes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(_flat_all_reduce(xs, group))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=d, device=v) if g is None else g
              for g, (s, d, v) in zip(gs, ctx.likes)]
        if ctx.backward_sums:
            gs = _flat_all_reduce(gs, ctx.group)
        return (None, None, *gs)


class _Spread(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return None, _flat_all_reduce([g], ctx.group)[0]


def all_sum(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Sums over the active axis' ranks whose backward sums too (BatchNorm's
    channel sums); the inputs themselves outside an axis."""
    axis = active_axis()
    if axis is None:
        return xs
    return _Sum.apply(axis.group, True, *xs)


def replicated_sum(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Sums over the active axis' ranks feeding a value every rank computes
    alike (the loss's statistics): the backward passes through."""
    axis = active_axis()
    if axis is None:
        return xs
    return _Sum.apply(axis.group, False, *xs)


def spread(x: torch.Tensor, axis: Optional[DataAxis] = None) -> torch.Tensor:
    """A replicated value about to be used on this rank's rows (of the
    active axis, or of ``axis``): the identity forward; backward, the sum of
    the ranks' gradients."""
    axis = active_axis() if axis is None else axis
    if axis is None or axis.group is None:
        return x
    return _Spread.apply(axis.group, x)


def _group_order(axis: DataAxis) -> Optional[List[int]]:
    """Where each rank of ``axis``, in axis order, sits among the group's
    ranks (the sorted global ranks); None where the two orders agree."""
    srt = sorted(axis.ranks)
    order = [srt.index(r) for r in axis.ranks]
    return None if order == list(range(len(order))) else order


def _all_gather(x: torch.Tensor, axis: DataAxis) -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes) over ``axis``, in axis order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    order = _group_order(axis)
    return parts if order is None else [parts[i] for i in order]


def own_block(g: torch.Tensor, axis: DataAxis, dim: int) -> torch.Tensor:
    """This rank's block of ``g`` along ``dim``: the backward of
    ``gather_blocks``, which does not sum (every rank of ``axis`` computes
    the same full gradient)."""
    k = g.shape[dim] // axis.size
    return g.narrow(dim, axis.rank * k, k).contiguous()


class _GatherBlocks(torch.autograd.Function):
    """The ranks' blocks of ``axis`` along ``dim`` → the full tensor;
    backward: ``own_block``."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return torch.cat(_all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return own_block(g, ctx.axis, ctx.dim), None, None


class _TakeBlock(torch.autograd.Function):
    """A replicated tensor → this rank's block along ``dim``; backward: the
    blocks' gradients gathered into the full one."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        k = x.shape[dim] // axis.size
        return x.narrow(dim, axis.rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.axis), dim=ctx.dim), None, None


def gather_blocks(x: torch.Tensor, axis: Optional[DataAxis],
                  dim: int = -1) -> torch.Tensor:
    """The full tensor from the blocks of the model axis ``axis`` along
    ``dim`` (rank order), differentiable (module doc); ``x`` itself without
    a group."""
    if axis is None or axis.group is None:
        return x
    return _GatherBlocks.apply(x, axis, dim % x.dim())


def take_block(x: torch.Tensor, axis: Optional[DataAxis],
               dim: int = -1) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``,
    differentiable (module doc); ``x`` itself without a group."""
    if axis is None or axis.group is None:
        return x
    return _TakeBlock.apply(x, axis, dim % x.dim())


def model_sum(x: torch.Tensor, axis: Optional[DataAxis]) -> torch.Tensor:
    """The sum over ``axis`` of the partial products of a row-parallel
    product: every rank then holds the same output, so the backward passes
    the gradient through; ``x`` itself without a group."""
    if axis is None or axis.group is None:
        return x
    return _Sum.apply(axis.group, False, x)[0]


def axis_sum(x: torch.Tensor, axis: Optional[DataAxis]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (not differentiated: the
    gradient norm's squares); ``x`` itself without a group."""
    if axis is None or axis.group is None:
        return x
    return _flat_all_reduce([x], axis.group)[0]


# -- whole-state collectives ---------------------------------------------------

def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def sum_grads(grads: Sequence[torch.Tensor], axis: DataAxis) -> None:
    """Sum the gradients over the ranks of ``axis``, in place: one
    collective a dtype."""
    if axis.group is None or not grads:
        return
    for idx in _by_dtype(grads).values():
        summed = _flat_all_reduce([grads[i] for i in idx], axis.group)
        for i, s in zip(idx, summed):
            grads[i].copy_(s)


def broadcast_(tensors: Sequence[torch.Tensor], axis: DataAxis,
               src: Optional[int] = None) -> None:
    """Overwrite ``tensors`` on every rank of ``axis`` with global rank
    ``src``'s (default: the axis' first rank), in place: one collective a
    dtype."""
    if axis.group is None or not tensors:
        return
    src = axis.ranks[0] if src is None else src
    with torch.no_grad():
        for idx in _by_dtype(tensors).values():
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            dist.broadcast(flat, src=src, group=axis.group)
            for i, p in zip(idx, flat.split([tensors[i].numel() for i in idx])):
                tensors[i].copy_(p.reshape(tensors[i].shape))


def gather_rows(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along dim 0 in rank order,
    on every rank."""
    if axis.group is None:
        return x
    if _group_order(axis) is not None:
        return torch.cat(_all_gather(x, axis))
    x = x.contiguous()
    out = torch.empty((axis.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=axis.group)
    return out


def agree(value: int, axis: DataAxis, what: str) -> None:
    """Raise unless every rank of ``axis`` holds the same integer
    ``value``."""
    if axis.group is None:
        return
    mine = torch.tensor([value], dtype=torch.int64)
    if dist.get_backend(axis.group) == "nccl":
        mine = mine.cuda()
    every = gather_rows(mine, axis).tolist()
    if len(set(every)) != 1:
        raise RuntimeError(f"the ranks disagree on {what}: {every} (rank "
                           "order) — is the checkpoint directory shared?")


def barrier(axis: DataAxis) -> None:
    if axis.group is not None:
        dist.barrier(group=axis.group)


def local_rows(batch: Mapping[str, Any], axis: DataAxis) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors, leading
    axis divisible by the world size)."""
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % axis.size:
            raise ValueError(f"batch entry {k!r} has {n} rows, not a multiple "
                             f"of the {axis.size} ranks of the data axis")
        out[k] = v[axis.rows(n // axis.size)]
    return out



# -- tensor parallelism ---------------------------------------------------------

# the reference's rules, matched on a leaf's name: the BiGRU's gate matrices
# [D, 3H] column-parallel, their biases [3H] split like the matmul's output,
# the fusion head's kernel [2H, out] row-parallel
_TP_GRU_MATS = ("w_ih", "w_hh")
_TP_GRU_VECS = ("b_ih", "b_hh")


def tp_spec(name: str, shape: Sequence[int], n_model: int
            ) -> Tuple[Optional[str], ...]:
    """The partition of a state leaf over the model axis, as the entries of
    the reference's ``PartitionSpec`` (``_tp_spec``): ``(None, "model")``
    for the gate matrices of every ``gru`` layer and direction, ``("model",)``
    for their biases, ``("model", None)`` for the fusion head's ``kernel``
    (not the branches' ``audio.head`` / ``visual.head``), ``()``
    (replicated) for every other leaf, for a shape the axis does not
    divide and for ``n_model`` 1. ``name`` is the port's parameter name
    (``gru.layers.0.fwd.w_ih``); Adam's moments, the gradient accumulator
    and the EMA shadow of a parameter share its name and layout."""
    if n_model <= 1:
        return ()
    keys = name.split(".")
    last = keys[-1]
    shape = tuple(shape)
    if "gru" in keys and last in _TP_GRU_MATS and len(shape) == 2 \
            and shape[1] % n_model == 0:
        return (None, "model")
    if "gru" in keys and last in _TP_GRU_VECS and len(shape) == 1 \
            and shape[0] % n_model == 0:
        return ("model",)
    if len(keys) >= 2 and keys[-2] == "head" and last == "kernel" \
            and "audio" not in keys and "visual" not in keys \
            and len(shape) == 2 and shape[0] % n_model == 0:
        return ("model", None)
    return ()


@dataclass(frozen=True)
class TensorParallel:
    """A rank's tensor-parallel layout: ``dims`` maps each sharded leaf's
    name to the dim split over the model axis ``axis``; a rank holds the
    contiguous block ``rank`` of ``axis.size`` along it."""
    axis: DataAxis
    dims: Dict[str, int]

    def sharded(self, name: str) -> bool:
        return name in self.dims

    def block(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full leaf ``name`` (a copy of its own;
        ``full`` itself when the leaf is replicated)."""
        if name not in self.dims:
            return full
        return own_block(full, self.axis, self.dims[name]).clone()

    def blocks(self, tensors: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        return {n: self.block(n, t) for n, t in tensors.items()}

    def full(self, name: str, block: torch.Tensor) -> torch.Tensor:
        """The full leaf ``name`` from the blocks of the model axis (a
        collective: every rank of the axis calls it); ``block`` itself when
        the leaf is replicated."""
        if name not in self.dims:
            return block
        return torch.cat(_all_gather(block, self.axis), dim=self.dims[name])


def tensor_parallel(shapes: Mapping[str, Sequence[int]],
                    axis: DataAxis) -> Optional[TensorParallel]:
    """The layout of leaves of ``shapes`` (name → full shape) over the model
    axis ``axis`` by ``tp_spec``; None when no leaf is sharded (one rank on
    the axis, or no shape it divides)."""
    dims = {}
    for n, shape in shapes.items():
        spec = tp_spec(n, shape, axis.size)
        if "model" in spec:
            dims[n] = spec.index("model")
    return TensorParallel(axis, dims) if dims and axis.group is not None \
        else None
