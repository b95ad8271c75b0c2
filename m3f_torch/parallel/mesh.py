"""The data axis: the multi-process launch, the rank layout and the
collectives of data-parallel training.

Counterpart of the data axis of ``m3f/pytorch_tpu/parallel/mesh.py``. The
JAX package builds one ``Mesh(('data', 'model'))`` and GSPMD inserts the
collectives: with the batch sharded over ``data``, every reduction over the
batch is global, so a data-parallel step equals the one-device step on the
whole batch. The port runs one process a card, joined by a
``torch.distributed`` group, and makes the same reductions global itself:

- ``distributed_init_plan(env)`` decides from the environment whether this
  process joins a group (a pure function); ``maybe_initialize_distributed``
  applies it (idempotent, loud on any mismatch; NCCL on the card, gloo on
  the CPU, or the backend the caller names). The device of a rank is
  ``cuda:LOCAL_RANK``.
- ``create_mesh(num_data, num_model)`` → ``DataAxis``: this process's rank
  and the world size along ``data`` (``num_data=-1``: every process; each
  process holds one device). Tensor parallelism (``num_model > 1``) is
  refused by name.
- Inside ``data_parallel(axis)`` (a train step's forward, loss and
  backward) the reductions over the batch are summed over the ranks:

  - ``all_sum``: BatchNorm's channel sums. Its backward sums over the ranks
    too, because the gradient that reaches a sum on one rank covers that
    rank's activations only.
  - ``replicated_sum``: the loss's statistics. Every rank computes the same
    loss from them, so the backward passes the gradient through and does
    not sum again (which would scale the loss by the world size).
  - ``spread``: a replicated value used on a rank's own rows (the two-pass
    CCC's means): the identity forward, a sum over the ranks backward.

  ``sum_grads`` then sums the parameter gradients, so every rank applies
  the update of the one-device step and the state stays replicated.
- ``DataAxis.rows`` / ``local_rows``: rank r holds rows r·b … (r+1)·b − 1
  of a global batch of b rows a rank.

Without a process group every helper is the identity, and one process runs
as it did before this module existed.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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
    """The data axis of one process: its ``rank`` among ``size`` processes
    of ``group`` (None: no process group, one process, nothing reduced)."""
    size: int = 1
    rank: int = 0
    group: Any = None

    def rows(self, local: int) -> slice:
        """This rank's rows of a global batch of ``local`` rows a rank."""
        return slice(self.rank * local, (self.rank + 1) * local)


def create_mesh(num_data: int = -1, num_model: int = 1) -> DataAxis:
    """The data axis over the processes of the ``torch.distributed`` group
    (one process without a group), each holding one device: ``num_data``
    -1 takes them all; fewer or more rows than processes are refused, as is
    tensor parallelism (``num_model > 1``, not ported)."""
    if num_model > 1:
        raise NotImplementedError(
            f"train.mesh.num_model={num_model}: tensor parallelism is not "
            "ported (ROADMAP §1, parallel/); use num_model=1")
    if num_model < 1:
        raise ValueError(f"train.mesh.num_model must be 1, got {num_model}")
    axis = world_axis()
    world = axis.size
    if num_data == -1:
        num_data = world
    if num_data < 1:
        raise ValueError(f"train.mesh.num_data must be -1 or at least 1, got "
                         f"{num_data}")
    if num_data > world:
        raise ValueError(f"mesh {num_data}x{num_model} needs {num_data} "
                         f"devices, have {world}")
    if num_data < world:
        raise ValueError(
            f"mesh {num_data}x{num_model} leaves {world - num_data} of the "
            f"{world} processes out: each process holds one device of the "
            f"data axis, so train.mesh.num_data must be -1 or {world}")
    return axis


def world_axis() -> DataAxis:
    """The axis over every process of the initialised ``torch.distributed``
    group; one process (no group) without one."""
    if dist.is_available() and dist.is_initialized():
        return DataAxis(dist.get_world_size(), dist.get_rank(),
                        dist.group.WORLD)
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


def spread(x: torch.Tensor) -> torch.Tensor:
    """A replicated value about to be used on this rank's rows: the
    identity forward; backward, the sum of the ranks' gradients."""
    axis = active_axis()
    if axis is None:
        return x
    return _Spread.apply(axis.group, x)


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
               src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, in place:
    one collective a dtype."""
    if axis.group is None or not tensors:
        return
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

