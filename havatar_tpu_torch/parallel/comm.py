"""The process group and its collectives, on ``torch.distributed``.

Port of ``havatar_tpu/parallel/comm.py``. The JAX package is one process
driving N devices, and its collectives are ``psum`` / ``all_gather`` over a
named mesh axis inside ``shard_map``, with the gradient all-reduce inserted
by the compiler. Here each GPU has a process of its own (``torchrun
--nproc_per_node N``), so the same semantics are spelt out:

* ``initialize`` joins the process group that torchrun's environment
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``); ``nccl`` on CUDA, ``gloo`` on the CPU;
* ``all_gather`` is ``jax.lax.all_gather(tiled=True)`` with its transpose as
  the backward (a reduce-scatter sum of the gradient);
* ``all_reduce_grads`` is the gradient all-reduce that JAX's compiler
  inserts, over one flat buffer.

Without a process group every function here is the identity of one rank:
world size 1, rank 0. A ``WORLD_SIZE`` above 1 in the environment with no
process group is an error, never one rank's shard taken as the whole.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# torch 2.13 renamed the tensor forms of the two collectives
_all_gather_tensor = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def initialize(device=None, backend: Optional[str] = None, *,
               init_method: str = "env://", rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group; returns whether one is active.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; without ``WORLD_SIZE`` (and without ``world_size``) this
    is a no-op that returns False. ``device`` (None: CUDA) picks the backend
    unless ``backend`` names one: ``nccl`` on CUDA, ``gloo`` on the CPU. On
    CUDA the process takes ``device``'s index, or ``LOCAL_RANK`` when it
    names none, as its current device. A spawned process (a test, a smoke
    run) passes ``init_method`` (``file://...`` or ``tcp://localhost:P``),
    ``rank`` and ``world_size`` itself."""
    if dist.is_initialized():
        return True
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(
            os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(index)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device=None, backend: Optional[str] = None):
    """``initialize`` for the block (an entry point's body), and leave the
    group at its end if the block joined it."""
    joined = not dist.is_initialized() and initialize(device, backend)
    try:
        yield
    finally:
        if joined:
            shutdown()


def get_world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    env = int(os.environ.get("WORLD_SIZE", "1"))
    if env > 1:
        raise RuntimeError(
            f"WORLD_SIZE={env} but this process has joined no process "
            "group: call havatar_tpu_torch.parallel.comm.initialize() first")
    return 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier over the process group (host-side phases: checkpoints,
    the end of a run)."""
    if get_world_size() > 1:
        dist.barrier()


# ---- collectives on tensors ------------------------------------------------

def reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks (a new tensor; no gradient)."""
    if get_world_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks (a sum and a division: gloo has no
    average)."""
    n = get_world_size()
    return x if n == 1 else reduce_sum(x, group) / n


def reduce_loss_dict(losses: Dict[str, torch.Tensor],
                     group=None) -> Dict[str, torch.Tensor]:
    """Every scalar of ``losses`` averaged over the ranks, in one
    collective."""
    if get_world_size() == 1 or not losses:
        return losses
    keys = list(losses)
    flat = reduce_mean(torch.stack([losses[k].detach().float()
                                    for k in keys]), group)
    return dict(zip(keys, flat.unbind()))


def process_allgather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis [world, ...]."""
    n = get_world_size()
    if n == 1:
        return x[None]
    x = x.detach()[None].contiguous()
    out = x.new_empty((n,) + tuple(x.shape[1:]))
    _all_gather_tensor(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Tiled all-gather on ``axis``; the backward sums the gradient over the
    ranks and keeps this rank's block (a reduce-scatter), the transpose of
    the gather."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        n = dist.get_world_size(group)
        xs = x.movedim(axis, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
        _all_gather_tensor(out, xs, group=group)
        return out.movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        gs = g.movedim(ctx.axis, 0).contiguous()
        out = gs.new_empty((gs.shape[0] // n,) + tuple(gs.shape[1:]))
        _reduce_scatter_tensor(out, gs, group=ctx.group)
        return out.movedim(0, ctx.axis), None, None


def all_gather(x: torch.Tensor, axis: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``axis`` in rank order, like
    ``jax.lax.all_gather(..., tiled=True)``; differentiable (the backward
    is a reduce-scatter sum, so a loss computed on the gathered tensor by
    every rank gives each rank N times its block's gradient, which
    ``all_reduce_grads``' average turns into the global loss's)."""
    if get_world_size() == 1:
        return x
    return _AllGather.apply(x, axis, group)


def all_reduce_grads(params: Iterable[torch.Tensor],
                     op=dist.ReduceOp.AVG, group=None) -> None:
    """All-reduce the ``.grad`` of ``params`` in place, one flat buffer a
    dtype: ``ReduceOp.AVG`` (a sum divided by the world size, which gloo
    lacks as an op) or ``ReduceOp.SUM``. Parameters without a gradient are
    skipped; every rank runs the same graph, so the set is the same on
    each."""
    n = get_world_size()
    if n == 1:
        return
    if op not in (dist.ReduceOp.AVG, dist.ReduceOp.SUM):
        raise ValueError(f"op must be ReduceOp.AVG or ReduceOp.SUM, got {op}")
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        if op == dist.ReduceOp.AVG:
            flat /= n
        _unflatten_into(flat, grads)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values, one flat
    buffer a dtype (a run's state after its initialization or resume)."""
    if get_world_size() == 1:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src, group=group)
            _unflatten_into(flat, ts)


def _unflatten_into(flat: torch.Tensor, tensors: list) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def fold_in(rng: torch.Generator, rank: Optional[int] = None
            ) -> torch.Generator:
    """A generator of this rank's own, seeded from one draw of ``rng`` (the
    same draw on every rank) with the rank folded in: the counterpart of
    ``jax.random.fold_in(key, axis_index("data"))``. ``rng`` advances by
    the same draw on every rank."""
    rank = get_rank() if rank is None else rank
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng,
                             device=rng.device))
    return torch.Generator(device=rng.device).manual_seed(
        (seed + 0x9E3779B97F4A7C15 * (rank + 1)) % 2 ** 63)
