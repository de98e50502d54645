"""Pipeline parallelism over the ``pp`` mesh axis (GPipe schedule, SPMD).

The counterpart of mlcomp_tpu/parallel/pipeline.py, with its tick
schedule.  Every rank of the pp group runs the same program, holds its
stages' slices of the stacked layer parameters, and activations hop to
the next stage with :func:`~mlcomp_tpu_torch.parallel.collectives.rotate`
each tick.  A microbatch enters at stage 0 every tick; after the
``n_stages - 1``-tick fill bubble, all stages compute every tick.

Differentiable end to end (the rotation's backward is the rotation the
other way), so autograd runs the mirrored drain schedule.  ``remat=True``
recomputes each stage body in the backward (``checkpoint``), storing only
stage inputs.

**Interleaved (circular) schedule**: with ``V = v * n_stages`` stacked
slices each rank holds ``v`` virtual stages assigned round-robin (rank
``d`` owns virtual stages ``d, S+d, 2S+d, ...``) and every microbatch
laps the ring ``v`` times, for a ``v`` x smaller fill bubble.  A tick
where this rank holds no live microbatch (the bubble) computes nothing:
the tensor it passes on reaches only other bubble ticks, so the result is
the JAX schedule's, tick for tick.

Each rank's activations form one chain through its rotations (stage 0
selects a fresh microbatch over the received tensor, as the JAX
``where`` does, keeping the link), and the result depends on the chain's
last link with a zero weight: every rank then runs every backward
rotation, in the chain's order, so the ranks' exchanges always pair up.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from mlcomp_tpu_torch.parallel import collectives as col


def schedule_ticks(n_micro: int, n_stages: int, n_virtual: int) -> int:
    """Ticks of one pipeline pass: the last microbatch M-1 sits in group
    (M-1)//S at position (M-1)%S and is banked by the last rank at the
    tick before this count."""
    return (((n_micro - 1) // n_stages) * n_virtual * n_stages
            + (n_virtual - 1) * n_stages + ((n_micro - 1) % n_stages) + n_stages)


def tick_slot(t: int, stage: int, n_stages: int, n_virtual: int):
    """``(m, k)``: the microbatch rank ``stage`` holds at tick ``t`` and
    its lap (virtual stage ``k*S + stage``).  Microbatch ``m`` (group
    ``g = m // S``, position ``p = m % S``) occupies rank ``d`` on lap
    ``k`` at tick ``g*v*S + k*S + p + d``."""
    lap_len = n_virtual * n_stages
    rel = t - stage
    g = rel // lap_len
    k = (rel % lap_len) // n_stages
    return g * n_stages + rel % n_stages, k


def _pipeline_local(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                    microbatches: torch.Tensor, group, remat: bool, n_virtual: int
                    ) -> torch.Tensor:
    """One rank's part of the schedule.  ``stage_params``: this rank's
    slices, leading axis ``n_virtual`` in lap order (virtual stages
    ``d, S+d, ...``).  ``microbatches``: (M, mbs, ...); only stage 0
    reads it.  Returns this rank's bank (M, mbs, ...): the outputs of the
    last stage on the last rank, zeros elsewhere."""
    n_stages = col.size(group) if group is not None else 1
    stage = col.rank(group) if group is not None else 0
    n_micro = microbatches.shape[0]
    fn = (lambda p, h: checkpoint(stage_fn, p, h, use_reentrant=False)) if remat else stage_fn
    banked = [None] * n_micro
    # zeros inside the autograd graph (where the microbatches are): a rank
    # whose first ticks are bubble still passes tensors that take part in
    # the backward, so its rotations run there as its peers' do
    cur = microbatches[0] * 0.0
    if (torch.is_grad_enabled() and not cur.requires_grad
            and any(p.requires_grad for p in stage_params.values())):
        cur.requires_grad_(True)
    take = torch.ones((), dtype=torch.bool, device=microbatches.device)
    for t in range(schedule_ticks(n_micro, n_stages, n_virtual)):
        m, k = tick_slot(t, stage, n_stages, n_virtual)
        live = 0 <= m < n_micro
        if live:
            if stage == 0 and k == 0:
                # ingest; the select keeps the received tensor in the chain
                cur = torch.where(take, microbatches[m], cur)
            out = fn({name: x[k] for name, x in stage_params.items()}, cur)
            if k == n_virtual - 1 and stage == n_stages - 1:
                banked[m] = out
        else:
            out = cur
        cur = col.rotate(out, group, 1) if n_stages > 1 else out
    zero = torch.zeros_like(microbatches[0])
    bank = torch.stack([b if b is not None else zero for b in banked])
    if n_stages > 1:
        # the chain's last link, with weight 0 (see the module docstring)
        bank = bank + cur.sum(dtype=torch.float32).to(bank.dtype) * 0.0
    return bank


def _check_stack(stacked_params, n_stages: int) -> int:
    leading = {leaf.shape[0] for leaf in stacked_params.values()}
    if len(leading) != 1:
        raise ValueError(f"stacked_params leading axes disagree: {sorted(leading)}")
    (n_total,) = leading
    if n_total % n_stages:
        raise ValueError(
            f"{n_total} virtual stages not a multiple of {n_stages} pipeline devices")
    return n_total // n_stages


def pipeline_local(stage_fn: Callable, local_params: Dict[str, torch.Tensor], x: torch.Tensor,
                   n_microbatches: int, group, remat: bool = True,
                   network_order: bool = True) -> torch.Tensor:
    """The pipeline on this rank's pp shard of the stacks (the P("pp")
    placement of ``parallel/sharding``): (V/S, ...) a leaf, the rank's
    contiguous slice of a NETWORK-ordered stack, or with ``network_order``
    False already in device order.  Returns this rank's bank reshaped to
    (B, ...): the pipeline's output on the last rank (see
    :func:`_pipeline_local`).  A network-ordered stack with ``v > 1``
    is permuted across the ranks each call (all-gather, whose backward
    reduce-scatters the stages' gradients back to their owners)."""
    n_stages = col.size(group) if group is not None else 1
    n_virtual = _check_stack(local_params, 1)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
    if n_virtual > 1 and network_order and n_stages > 1:
        full = {k: col.all_gather(v, group, 0) for k, v in local_params.items()}
        d = col.rank(group)
        perm = [k * n_stages + d for k in range(n_virtual)]
        local_params = {k: v[perm] for k, v in full.items()}
    mb = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    out = _pipeline_local(stage_fn, local_params, mb, group, remat, n_virtual)
    return out.reshape(b, *out.shape[2:])


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, n_microbatches: int,
                   mesh, axis_name: str = "pp", remat: bool = True,
                   pre_interleaved: bool = False, data_axes: tuple = ()) -> torch.Tensor:
    """Run ``x`` through ``V`` pipelined virtual stages on the pp group.

    - ``stage_fn(params_slice, h) -> h``: one stage; activations keep one
      shape/dtype across stages.
    - ``stacked_params``: dict whose leaves have a leading axis ``V``, a
      multiple of the pp axis size, network order (or device order with
      ``pre_interleaved``); every rank passes the whole stack and keeps
      its own slices.
    - ``x``: this rank's (B, ...) batch (its rows over ``data_axes``, which
      the port's loader already cut); B must divide into
      ``n_microbatches``.
    Returns (B, ...) outputs after the last stage, on every rank.
    """
    group = col.group_of(mesh, axis_name)
    n_stages = col.size(group) if group is not None else 1
    n_virtual = _check_stack(stacked_params, n_stages)
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n_microbatches} microbatches")
    if n_virtual > 1 and not pre_interleaved:
        stacked_params = interleave_stage_params(stacked_params, n_stages)
    d = col.rank(group) if group is not None else 0
    local = {k: v[d * n_virtual:(d + 1) * n_virtual] for k, v in stacked_params.items()}
    out = pipeline_local(stage_fn, local, x, n_microbatches, group, remat, network_order=False)
    return col.broadcast_from(out, group, n_stages - 1) if group is not None else out


def stack_stage_params(param_list):
    """Stack per-stage param dicts along a new leading axis for P(pp)."""
    return {k: torch.stack([p[k] for p in param_list]) for k in param_list[0]}


def deinterleave_stage_params(stacked_params, n_stages: int):
    """Inverse of :func:`interleave_stage_params`: device order back to
    network order."""
    (n_total,) = {leaf.shape[0] for leaf in stacked_params.values()}
    n_virtual = n_total // n_stages
    if n_virtual == 1:
        return stacked_params
    # network index k*S + d lives at device-order position d*v + k
    perm = [d * n_virtual + k for k in range(n_virtual) for d in range(n_stages)]
    return {k: v[perm] for k, v in stacked_params.items()}


def interleave_stage_params(stacked_params, n_stages: int):
    """Permute a network-ordered (V, ...) stack into device order.

    Rank ``d`` owns virtual stages ``d, S+d, 2S+d, ...`` (lap order), so
    device order is ``[d*v + k] = k*S + d``.  ``n_virtual == 1`` is the
    identity."""
    (n_total,) = {leaf.shape[0] for leaf in stacked_params.values()}
    if n_total % n_stages:
        raise ValueError(
            f"{n_total} virtual stages not a multiple of {n_stages} pipeline devices")
    n_virtual = n_total // n_stages
    if n_virtual == 1:
        return stacked_params
    perm = [k * n_stages + d for d in range(n_stages) for k in range(n_virtual)]
    return {k: v[perm] for k, v in stacked_params.items()}
