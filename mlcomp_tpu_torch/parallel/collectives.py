"""The port's collective seam: every collective the parallel paths issue,
and the differentiable ones that give the ring, Ulysses, tensor and
pipeline parallelism their backward from autograd.

``torch.distributed``'s point-to-point ops and collectives carry no
autograd, where the JAX package's ``ppermute`` and ``all_to_all`` have
transposes.  So:

- :func:`rotate` is ``ppermute`` over a ring (rank r receives rank
  r - shift's tensor); its backward is the rotation the other way.
- :func:`all_to_all` is the tiled ``all_to_all`` (split one dimension
  over the group, concatenate another); its backward is the inverse
  exchange.
- :func:`all_gather` concatenates the group's shards; its backward is the
  adjoint, a reduce-scatter, or with ``grad="split"`` the rank's own
  chunk of the cotangent (for a gathered tensor that every rank of the
  group consumes identically: the tensor-parallel vocabulary, the
  sequence-parallel logits).
- :func:`copy_to` (identity, backward all-reduce) and :func:`reduce_from`
  (all-reduce, backward identity) are the tensor-parallel region edges;
  their sums add in f32 and round once.
- :func:`broadcast_from` broadcasts the source rank's tensor; only the
  source keeps the cotangent.

Transport.  Ranks that share one card run on gloo (NCCL refuses two
ranks on one device).  Gloo takes the card's tensors in its collectives
(all-reduce, broadcast, all-gather, reduce-scatter, all-to-all: probed on
an H100 with torch 2.11) but not in point-to-point send/recv, which read
the card's memory as host memory.  So :func:`ring_shift` on gloo copies
the card's tensor into pinned host memory, exchanges it there and copies
the result back: explicitly, counted in :data:`transport_counts` under
``"gloo-host-staged"`` (the rest count under ``"nccl"`` and ``"gloo"``).
Nothing falls back silently.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

# collectives issued, by transport: "nccl", "gloo" (host tensors) and
# "gloo-host-staged" (a card's tensors through pinned host memory)
transport_counts = {"nccl": 0, "gloo": 0, "gloo-host-staged": 0}


def reset_counts() -> None:
    for k in transport_counts:
        transport_counts[k] = 0


def transport(group, t: torch.Tensor, p2p: bool = False) -> str:
    """How a collective (``p2p``: a send/recv pair) on ``t`` over
    ``group`` travels."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return "nccl"
    return "gloo-host-staged" if (p2p and t.is_cuda) else "gloo"


def _run(group, tensors, fn, p2p: bool = False):
    """Run ``fn(*tensors)`` for ``tensors`` (outputs included) on the
    group's transport, copying back into the originals where the tensors
    were staged through host memory."""
    kind = transport(group, tensors[0], p2p)
    transport_counts[kind] += 1
    if kind != "gloo-host-staged":
        fn(*tensors)
        return
    staged = [t.detach().to("cpu").pin_memory() for t in tensors]
    fn(*staged)
    for t, s in zip(tensors, staged):
        t.copy_(s, non_blocking=True)


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``."""
    if size(group) > 1:
        _run(group, [t], lambda x: dist.all_reduce(x, op=op, group=group))
    return t


def broadcast_(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """In-place broadcast from group rank ``src``."""
    if size(group) > 1:
        gsrc = dist.get_global_rank(group, src)
        _run(group, [t], lambda x: dist.broadcast(x, gsrc, group=group))
    return t


def gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate the group's shards along ``dim`` (rank order)."""
    n = size(group)
    if n == 1:
        return t
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:])) if dim == 0 else None
    if dim == 0:
        _run(group, [out, t], lambda o, x: dist.all_gather_into_tensor(o, x, group=group))
        return out
    moved = t.movedim(dim, 0).contiguous()
    return gather_dim(moved, group, 0).movedim(0, dim)


def reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum over the group, keeping this rank's chunk of ``dim``."""
    n = size(group)
    if n == 1:
        return t
    moved = t.movedim(dim, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"dimension {t.shape[dim]} not divisible by the group's {n}")
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    _run(group, [out, moved], lambda o, x: dist.reduce_scatter_tensor(o, x, group=group))
    return out.movedim(0, dim)


def chunk_of(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` (no communication)."""
    n = size(group)
    if n == 1:
        return t
    return t.chunk(n, dim)[rank(group)].contiguous()


def exchange(t: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: ``t``'s ``split_dim`` cut into group-size chunks,
    chunk j sent to rank j, the received chunks concatenated along
    ``concat_dim`` in rank order."""
    n = size(group)
    if n == 1:
        return t
    if t.shape[split_dim] % n:
        raise ValueError(f"dimension {t.shape[split_dim]} not divisible by the group's {n}")
    send = t.movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    _run(group, [recv, send], lambda r, s: dist.all_to_all_single(r, s, group=group))
    # recv's leading dim holds the n source ranks' chunks in rank order
    parts = recv.movedim(0, split_dim).chunk(n, split_dim)
    return torch.cat(parts, dim=concat_dim)


def ring_shift(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank r receives rank (r - shift)'s tensor (``ppermute`` over the
    ring ``i -> i + shift``)."""
    n = size(group)
    if n == 1 or shift % n == 0:
        return t
    me = rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    t = t.contiguous()
    out = torch.empty_like(t)

    def p2p(o, x):
        ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, o, src, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _run(group, [out, t], p2p, p2p=True)
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -ctx.shift), None, None


def rotate(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Differentiable ``ppermute`` over the ring ``i -> i + shift``."""
    return _Rotate.apply(x, group, shift)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return exchange(g, ctx.group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Differentiable tiled all-to-all; the backward is the inverse exchange."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, split):
        ctx.group, ctx.dim, ctx.split = group, dim, split
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            return chunk_of(g, ctx.group, ctx.dim), None, None, None
        return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, group, dim: int, grad: str = "sum") -> torch.Tensor:
    """Differentiable all-gather along ``dim``.  ``grad="sum"``: the
    backward reduce-scatters (each rank consumed the gathered tensor in
    its own way); ``grad="split"``: it keeps the rank's own chunk (every
    rank of the group consumed it identically)."""
    if grad not in ("sum", "split"):
        raise ValueError(f"grad must be 'sum' or 'split', got {grad!r}")
    return _AllGather.apply(x, group, dim, grad == "split")


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x``, added in f32 and rounded once to x's dtype
    (a bf16 partial is not rounded again on every addition)."""
    return all_reduce_(x.float().contiguous().clone(), group).to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a tensor-parallel region: identity forward, the cotangent
    summed over the group backward."""
    return _CopyTo.apply(x, group) if size(group) > 1 else x


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a tensor-parallel region: partial sums summed over the group
    forward, identity backward."""
    return _ReduceFrom.apply(x, group) if size(group) > 1 else x


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.keep = rank(group) == src
        return broadcast_(x.contiguous().clone(), group, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None


def broadcast_from(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Every rank gets group rank ``src``'s tensor; the cotangent stays
    with the source (every rank consumes the result identically)."""
    return _BroadcastFrom.apply(x, group, src) if size(group) > 1 else x


def group_of(mesh, axis: str) -> Optional[object]:
    """The mesh's group along ``axis``, None where the axis has size 1."""
    from mlcomp_tpu_torch.parallel.mesh import axis_size

    if mesh is None or axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def data_groups(mesh) -> list:
    """The groups of the mesh's data axes wider than one (fsdp, then dp):
    the ranks that hold other rows of the global batch ([] without a
    mesh)."""
    return [g for g in (group_of(mesh, "fsdp"), group_of(mesh, "dp")) if g is not None]
