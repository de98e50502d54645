"""A gloo gang for the port's parallel tests (imports torch and the port,
never JAX): :func:`run_gang` starts ``world`` processes once, each joins a
``torch.distributed`` group on the CPU, runs every case of the calling
test file in order and sends back numpy results.  One spawn a file, so no
test case pays its own.

Every case is a function of this module, ``case_<kind>(**kwargs)``,
called on every rank; a failing case records its error on that rank and
the rank stops (its peers then fail on the group's timeout).
"""

from __future__ import annotations

import os
import socket
import traceback

import numpy as np

GANG_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, cases, q):
    import torch

    torch.set_num_threads(1)
    os.environ.update(MLCOMP_TPU_COORDINATOR=f"127.0.0.1:{port}",
                      MLCOMP_TPU_NUM_PROCESSES=str(world), MLCOMP_TPU_PROCESS_ID=str(rank))
    os.environ.pop("MLCOMP_TPU_DIST_BACKEND", None)
    out = {}
    try:
        from mlcomp_tpu_torch.parallel.distributed import init_distributed

        init_distributed(device="cpu", timeout_s=120)
        for name, kind, kwargs in cases:
            try:
                out[name] = globals()[f"case_{kind}"](**kwargs)
            except Exception as e:  # the test reports it
                tb = traceback.StackSummary.extract(traceback.walk_tb(e.__traceback__),
                                                    limit=-12, lookup_lines=False)
                out[name] = {"error": repr(e)[:2000] + " @ " + " <- ".join(
                    f"{f.filename.split('/')[-1]}:{f.lineno}:{f.name}" for f in tb)}
                break
    finally:
        q.put((rank, out))
        try:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:
            pass


def run_gang(world: int, cases, timeout_s: float = GANG_TIMEOUT_S):
    """Run ``cases`` ([(name, kind, kwargs)]) on a gang of ``world`` gloo
    processes; returns ``{rank: {name: result}}``."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, cases, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            try:
                rank, out = q.get(timeout=timeout_s)
            except queue.Empty:
                break
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return results


def result(results, rank: int, name: str):
    """One case's result on one rank; fails the test on the case's error."""
    got = results.get(rank, {}).get(name)
    if got is None:
        errors = {k: v["error"] for k, v in results.get(rank, {}).items()
                  if isinstance(v, dict) and "error" in v}
        raise AssertionError(f"rank {rank} returned nothing for {name} (ranks "
                             f"{sorted(results)}; an earlier case failed: {errors})")
    assert not (isinstance(got, dict) and "error" in got), f"rank {rank} {name}: {got['error']}"
    return got


# ---------------------------------------------------------------- cases

def _mesh(**axes):
    from mlcomp_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(**axes), device_type="cpu")


def _t(a, grad=False):
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(True) if grad else t


def case_attention(mode, q, k, v, ct, sp, causal, use_flash=False, kv_chunk=None):
    """Ring (einsum or flash blocks) or Ulysses attention on this rank's
    sequence shard of q/k/v over an sp group of ``sp`` ranks: the local
    output and the gradients of sum(out * ct), with the rank's sp index.
    ``kv_chunk`` sets the ring's KV chunk for this case."""
    from mlcomp_tpu_torch.parallel import ring
    from mlcomp_tpu_torch.parallel.mesh import axis_rank
    from mlcomp_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    mesh = _mesh(sp=sp)
    r = axis_rank(mesh, "sp")
    s = q.shape[1] // sp
    cut = slice(r * s, (r + 1) * s)
    ql, kl, vl = (_t(a[:, cut], grad=True) for a in (q, k, v))
    saved = ring.KV_CHUNK
    ring.KV_CHUNK = kv_chunk or saved
    try:
        if mode == "ulysses":
            out = ulysses_attention_sharded(ql, kl, vl, mesh, causal=causal)
        else:
            out = ring.ring_attention_sharded(ql, kl, vl, mesh, causal=causal,
                                              use_flash=use_flash)
        (out * _t(ct[:, cut])).sum().backward()
    finally:
        ring.KV_CHUNK = saved
    return {"sp_rank": r, "out": out.detach().numpy(), "dq": ql.grad.numpy(),
            "dk": kl.grad.numpy(), "dv": vl.grad.numpy()}


def case_refusal(mode, heads, kv_heads, s_local, sp):
    """The exception a sharded attention raises on these shapes (None if
    it runs)."""
    import torch

    from mlcomp_tpu_torch.parallel.ring import ring_attention_sharded
    from mlcomp_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    mesh = _mesh(sp=sp)
    q = torch.zeros(1, s_local, heads, 16)
    k = torch.zeros(1, s_local, kv_heads, 16)
    try:
        if mode == "ulysses":
            ulysses_attention_sharded(q, k, k, mesh, causal=True)
        else:
            ring_attention_sharded(q, k, k, mesh, causal=True, use_flash=True)
    except (ValueError, NotImplementedError) as e:
        return {"type": type(e).__name__, "msg": str(e)}
    return {"type": None}


def case_pipeline(stacked, x, n_micro, pp, ct, pre_interleaved=False, remat=True):
    """``pipeline_apply`` of a tanh stage on a pp group of ``pp`` ranks:
    the output (every rank's) and the gradients of sum(out * ct) with
    respect to the whole stacks (summed over the ranks' shares)."""
    import torch

    from mlcomp_tpu_torch.parallel import collectives as col
    from mlcomp_tpu_torch.parallel.pipeline import pipeline_apply

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = _mesh(pp=pp)
    params = {k: _t(v, grad=True) for k, v in stacked.items()}
    out = pipeline_apply(stage, params, _t(x), n_micro, mesh, remat=remat,
                         pre_interleaved=pre_interleaved)
    (out * _t(ct)).sum().backward()
    grads = {}
    for k, p in params.items():
        g = p.grad.clone()
        col.all_reduce_(g, col.group_of(mesh, "pp"))
        grads[k] = g.numpy()
    return {"out": out.detach().numpy(), "grads": grads}


def case_pipeline_error(stacked, x, n_micro, pp):
    import torch

    from mlcomp_tpu_torch.parallel.pipeline import pipeline_apply

    try:
        pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {k: _t(v) for k, v in
                                                              stacked.items()},
                       _t(x), n_micro, _mesh(pp=pp))
    except ValueError as e:
        return {"msg": str(e)}
    return {"msg": None}


def _trainer(cfg, init):
    """The port's Trainer from ``cfg`` starting from the flat flax-path
    weights ``init`` (numpy, each rank keeps its shards)."""
    import torch

    from mlcomp_tpu_torch.parallel.sharding import load_into
    from mlcomp_tpu_torch.train.loop import Trainer

    t = Trainer(cfg, device="cpu")
    if init is not None:
        with torch.no_grad():
            for k, p in t.state.params.items():
                load_into(p, torch.from_numpy(np.ascontiguousarray(init[k])))
    return t


def case_trainer(cfg, init, batches, forward_ids=None):
    """Steps of the port's Trainer under ``cfg["mesh"]`` on the global
    ``batches`` (each rank feeds its rows): the losses, the final weights
    (gathered), the step, and with ``forward_ids`` the logits of one
    forward before training."""
    import torch

    from mlcomp_tpu_torch.parallel.distributed import global_batch_from_host

    t = _trainer(cfg, init)
    res = {}
    if forward_ids is not None:
        with torch.no_grad():
            t.state.binding.bind(t.state.params, requires_grad=False)
            res["logits"] = t.model(_t(forward_ids)).numpy()
    losses = []
    for b in batches:
        stats = t._train_step(t.state, global_batch_from_host(b, t.mesh))
        losses.append(float(stats["loss"]))
    sd = t.state.state_dict()
    res.update(losses=losses, step=t.state.step,
               params={k: v.numpy() for k, v in sd["params"].items()},
               local={k: tuple(p.to_local().shape) for k, p in t.state.params.items()})
    return res


def case_checkpoint(cfg, init, batches, directory):
    """Train under the mesh, save (the primary writes), then resume the
    saved checkpoint into a fresh sharded Trainer: the saved step and
    whether the restored shards equal the trained ones."""
    import torch
    import torch.distributed as dist

    from mlcomp_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
    from mlcomp_tpu_torch.parallel.distributed import global_batch_from_host

    t = _trainer(cfg, init)
    for b in batches:
        t._train_step(t.state, global_batch_from_host(b, t.mesh))
    save_checkpoint(directory, t.state, step=t.state.step, primary=dist.get_rank() == 0)
    dist.barrier()
    fresh = _trainer(cfg, None)
    restore_checkpoint(directory, fresh.state)
    same = all(torch.equal(fresh.state.params[k].to_local(), p.to_local())
               for k, p in t.state.params.items())
    return {"step": fresh.state.step, "same": same}


def case_hybrid(spec, dcn, ranks_per_slice):
    """``make_hybrid_mesh``: its shape by axis, or the refusal's message."""
    from mlcomp_tpu_torch.parallel.distributed import make_hybrid_mesh
    from mlcomp_tpu_torch.parallel.mesh import MeshSpec, mesh_shape

    try:
        m = make_hybrid_mesh(MeshSpec(**spec), dcn, ranks_per_slice=ranks_per_slice,
                             device_type="cpu")
    except ValueError as e:
        return {"error_msg": str(e)}
    return {"shape": mesh_shape(m), "names": list(m.mesh_dim_names),
            "ranks": np.asarray(m.mesh).tolist()}


def case_batch_rows(spec, batch):
    """``global_batch_from_host``: this rank's rows and its batch shard."""
    from mlcomp_tpu_torch.parallel.distributed import global_batch_from_host, sync_hosts
    from mlcomp_tpu_torch.parallel.mesh import MeshSpec, batch_sharding, make_mesh

    mesh = make_mesh(MeshSpec(**spec), device_type="cpu")
    rows = global_batch_from_host(batch, mesh)
    sync_hosts("rows")
    return {"rows": {k: v.numpy() for k, v in rows.items()}, "shard": batch_sharding(mesh)}


def case_pipeline_lm(model_cfg, flat, ids, pp):
    """The port's ``transformer_lm_pp`` forward under a pp group of ``pp``
    ranks, each holding its P("pp") slices of the stacks: the logits."""
    import torch

    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.parallel.mesh import axis_rank, set_current_mesh

    mesh = _mesh(pp=pp)
    d = axis_rank(mesh, "pp")
    state = {}
    for k, v in flat.items():
        if k.startswith("stages_"):
            n = v.shape[0] // pp
            v = v[d * n:(d + 1) * n]
        state[k] = _t(v)
    model = create_model(dict(model_cfg), device="cpu")
    model.load_state(state)
    set_current_mesh(mesh)
    try:
        with torch.no_grad():
            return {"logits": model(_t(ids)).numpy()}
    finally:
        set_current_mesh(None)


def case_restore(cfg, directory):
    """A fresh sharded Trainer restored from ``directory`` (any
    checkpoint, unsharded included): its step and gathered weights."""
    from mlcomp_tpu_torch.io.checkpoint import restore_checkpoint

    t = _trainer(cfg, None)
    restore_checkpoint(directory, t.state)
    sd = t.state.state_dict()
    return {"step": t.state.step, "params": {k: v.numpy() for k, v in sd["params"].items()}}


