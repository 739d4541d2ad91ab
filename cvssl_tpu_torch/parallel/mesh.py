"""Data parallelism across processes (port of ``cvssl_tpu/parallel/mesh.py``).

JAX runs one program over a mesh of devices, and GSPMD makes every
reduction in it global. Here each card has its own process, joined by
``torch.distributed``, and the same numbers come from this rule:

* every rank holds the global batch (the same index stream from the same
  seed, gathered and augmented from its own copy of the data, from its own
  generator in lockstep), so the methods' loss code runs on global tensors
  and gives the same loss on every rank;
* each model call of a step is split (:func:`split_call`): the model runs
  on the rank's rows of that call's batch, and the outputs are gathered
  back along dim 0 (:func:`all_gather_rows`, differentiable). A call whose
  batch the world size does not divide runs whole on every rank;
* inside a split call the port's BatchNorm normalises with statistics
  all-reduced over the ranks (:func:`all_reduce_sum`, differentiable), and
  every random draw over the batch axis is drawn at the global batch size
  and cut to the rank's rows (:func:`draw_rows`), so the running buffers
  and the dropout bytes are those of one process on the global batch;
* every rank computes the same loss L, and the backward of the gather sums
  the W identical cotangents, so each rank's parameter gradient is W times
  its rows' share of dL/dtheta, and a whole call's is dL/dtheta itself; a
  MEAN all-reduce of the gradients (:func:`all_reduce_grads`) gives
  dL/dtheta in both cases.

The collectives are all-gather, reduce-scatter, all-reduce and broadcast,
which gloo runs on the CPU and on CUDA tensors (two ranks on one card,
where NCCL refuses; gloo's send/recv does not take CUDA tensors), and NCCL
on the cards of a node. No tensor is copied to the host to communicate.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a data-parallel run: this process's ``rank`` of
    ``world``, its ``device``, and the process ``group`` (None: one process
    and no group, where every collective is skipped)."""

    rank: int
    world: int
    device: torch.device
    group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n``, which the world size must
        divide (JAX ``batch_sharding``)."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)


def _torchrun_env(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> Mesh:
    """Join the process group and return the mesh. With no arguments the
    group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); ``init_method`` (a
    ``tcp://`` or ``file://`` address), ``world_size`` and ``rank`` name it
    otherwise. The device is ``cuda:LOCAL_RANK`` for ``device="cuda"``, the
    given one for ``cuda:i`` or ``cpu``; the backend ``nccl`` on CUDA and
    ``gloo`` on the CPU unless ``backend`` names another (two ranks on one
    card need gloo: NCCL refuses them)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", _torchrun_env("LOCAL_RANK") or 0)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if init_method is None:
        init_method = "env://"
        world_size = _torchrun_env("WORLD_SIZE") if world_size is None \
            else world_size
        rank = _torchrun_env("RANK") if rank is None else rank
        if world_size is None or rank is None:
            raise RuntimeError("distributed_init: no process group given and "
                               "no torchrun environment (RANK, WORLD_SIZE); "
                               "launch with torchrun --nproc_per_node N")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    return make_mesh(device=device)


def world_size() -> int:
    """The process group's size, or 1 where there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(num_devices: Optional[int] = None, device="cuda",
              dcn: Optional[int] = None) -> Mesh:
    """The mesh of this process: every rank of the process group, or one
    process without a group. ``num_devices`` must be None or the world
    size: the port runs one process per card, and torchrun starts them.
    A bare ``cuda`` device in a group is the card ``distributed_init`` set
    current."""
    if dcn is not None:
        raise NotImplementedError(
            "dcn folds a TPU mesh across hosts; the port's mesh is the "
            "process group, one process per card")
    world = world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"num_devices={num_devices}, but this run has {world} "
            f"process(es): the port runs one process per card; launch "
            f"torchrun --nproc_per_node {num_devices} -m "
            "cvssl_tpu_torch.train.cli --distributed ...")
    device = torch.device(device)
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh(0, 1, device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.get_rank(), world, device, dist.group.WORLD)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """The rank's rows of every array of ``batch`` (JAX ``shard_batch``:
    each batch size must divide by the world size)."""
    return {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.new_empty((x.shape[0] * mesh.world,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        out = grad.new_empty((grad.shape[0] // mesh.world,)
                             + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad.contiguous(), group=mesh.group)
        return out, None


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order, on every rank.
    Differentiable: the backward sums the ranks' cotangents of the global
    tensor and returns this rank's rows of the sum (a reduce-scatter)."""
    return _AllGatherRows.apply(x, mesh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        return grad, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``, on every rank; differentiable (each
    rank's output depends on every rank's input, so the backward is the
    sum of the ranks' cotangents)."""
    return _AllReduceSum.apply(x, mesh)


def _by_dtype(tensors: Iterable[torch.Tensor]):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def all_reduce_grads(mesh: Mesh, params: Iterable[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over the ranks (one
    flat all-reduce per dtype). Parameters without a gradient are skipped:
    the same ones on every rank, since every rank runs the same step."""
    if not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for group in _by_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def replicate_state(mesh: Mesh, modules: Iterable[torch.nn.Module]) -> None:
    """Rank 0's parameters and buffers in every rank's ``modules``, in place
    (JAX ``replicate_state``; one flat broadcast per dtype): the ranks then
    start from one state."""
    if not mesh.distributed:
        return
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    with torch.no_grad():
        for group in _by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, 0, group=mesh.group)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------------------
# the split model call
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """The model call in progress on this rank: its global batch ``total``
    and the rank's rows ``lo:hi`` of it."""

    mesh: Mesh
    total: int
    lo: int
    hi: int


_SPLIT: contextvars.ContextVar[Optional[Split]] = contextvars.ContextVar(
    "cvssl_tpu_torch_split", default=None)


def current_split() -> Optional[Split]:
    """The split model call this code runs in, or None."""
    return _SPLIT.get()


@contextlib.contextmanager
def _set_split(split: Optional[Split]):
    token = _SPLIT.set(split)
    try:
        yield
    finally:
        _SPLIT.reset(token)


def shared_draws():
    """A context in which random draws are not cut to the rank's rows: for
    a draw shared across the batch (``unet.feature_noise``'s over
    ``x.shape[1:]``)."""
    return _set_split(None)


def draw_rows(shape, draw):
    """``draw(shape)`` for a draw over the batch axis (``shape[0]`` the
    batch). Inside a split call the draw is made at the call's global batch
    and cut to the rank's rows, so every rank's generator moves as one
    process's would and the rank gets that process's values."""
    split = _SPLIT.get()
    shape = tuple(shape)
    if split is None:
        return draw(shape)
    if shape[0] != split.hi - split.lo:
        raise ValueError(f"a draw of shape {shape} inside a split call of "
                         f"{split.hi - split.lo} rows: its first axis is "
                         "not the batch (wrap a shared draw in "
                         "shared_draws())")
    return draw((split.total,) + shape[1:])[split.lo:split.hi]


def _gather_tree(mesh: Mesh, out):
    if torch.is_tensor(out):
        return all_gather_rows(mesh, out)
    if isinstance(out, (tuple, list)):
        return type(out)(_gather_tree(mesh, o) for o in out)
    raise TypeError(f"a split model call returned {type(out).__name__}; "
                    "tensors, tuples and lists of them are gathered")


def split_call(mesh: Mesh, fn, x: torch.Tensor, *args, **kwargs):
    """``fn(x, *args, **kwargs)`` with the batch split over the ranks: the
    rank runs ``fn`` on its rows of ``x`` (and of every tensor argument
    with ``x``'s batch), inside a :class:`Split` that BatchNorm and the
    random draws read, and the outputs are gathered along dim 0. A batch
    the world size does not divide, or a mesh of one, runs whole."""
    n = x.shape[0]
    if mesh.world == 1 or n % mesh.world:
        return fn(x, *args, **kwargs)
    rows = mesh.rows(n)
    args = tuple(a[rows] if torch.is_tensor(a) and a.ndim
                 and a.shape[0] == n else a for a in args)
    with _set_split(Split(mesh, n, rows.start, rows.stop)):
        out = fn(x[rows], *args, **kwargs)
    return _gather_tree(mesh, out)
