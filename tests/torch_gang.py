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

import atexit
import os
import socket
import traceback

import numpy as np

GANG_TIMEOUT_S = 240


# every port free_port handed out, still bound in this process
_HELD = []


def free_port() -> int:
    """A port held for this process's lifetime: bound here to port 0 with
    SO_REUSEADDR and never listened on.  The process that serves it (a
    rank's gloo store, the boundary channel, a daemon's HTTP server: each
    sets SO_REUSEADDR) binds it over the held socket, while the kernel
    gives a held port to no other port-0 bind or outgoing connection, so
    another xdist worker's gang cannot take it in between."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    _HELD.append(s)
    return s.getsockname()[1]


@atexit.register
def _release_ports() -> None:
    for s in _HELD:
        s.close()


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
        _register_test_models()
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


def _register_test_models() -> None:
    """``resnet``: the zoo's ResNet at any ``stage_sizes`` (the tests'
    two-stage net), under the name the JAX side registers it by."""
    from mlcomp_tpu_torch.models import MODELS, load_all
    from mlcomp_tpu_torch.models.resnet import ResNet
    from mlcomp_tpu_torch.utils.registry import RegistryError

    load_all()
    try:
        MODELS.get("resnet")
    except RegistryError:
        MODELS.register("resnet", obj=ResNet)


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
    (gathered) and model state (BatchNorm statistics), the step, each
    step's summed sown losses (``aux``) and, for ``moe_lm``, the
    assignments its capacity dropped (``dropped``), and with
    ``forward_ids`` the logits of one forward before training."""
    import torch

    from mlcomp_tpu_torch.parallel.distributed import global_batch_from_host
    from mlcomp_tpu_torch.train.loop import sown_losses

    t = _trainer(cfg, init)
    res = {}
    if forward_ids is not None:
        with torch.no_grad():
            t.state.binding.bind(t.state.params, requires_grad=False)
            res["logits"] = t.model(_t(forward_ids)).numpy()
    losses, aux, dropped = [], [], []
    blocks = t.model.moe_blocks() if hasattr(t.model, "moe_blocks") else []
    for b in batches:
        stats = t._train_step(t.state, global_batch_from_host(b, t.mesh))
        losses.append(float(stats["loss"]))
        aux.append(float(sum(a.detach() for a in sown_losses(t.model))))
        if blocks:
            dropped.append(float(sum(blk.dropped for _, blk in blocks)))
    sd = t.state.state_dict()
    res.update(losses=losses, step=t.state.step, aux=aux, dropped=dropped,
               model_state={k: v.numpy() for k, v in sd["model_state"].items()},
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




# ------------------------------------------------------ sharded serving

def case_serving_linears(cfg, params, x):
    """The int8 projections of a model served on this rank's tp 2 shards
    (``load_decode_weights(quantize="kernel", mesh=)``: ``serving_shards``,
    then ``set_serving_tp``): layer 0's q, v, out, gate and down and the
    head, each on x (rows, width) as the serving forward feeds it (a
    column-parallel projection the whole x's first ``m`` columns, a
    row-parallel one the rank's slice of them), and q and gate again with
    their RMSNorm folded into the kernel (B2)."""
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.models.generation import load_decode_weights
    from mlcomp_tpu_torch.ops.quant import Int8Linear
    from mlcomp_tpu_torch.parallel.mesh import axis_rank

    mesh = _mesh(dp=1, tp=2)
    model = create_model(cfg, device="cpu")
    load_decode_weights(model, params, quantize="kernel", mesh=mesh)
    r = axis_rank(mesh, "tp")
    layer, xb = model.layers[0], _t(x).bfloat16()
    rows, dh = x.shape[0], cfg["hidden"] // cfg["heads"]
    mods = {"q": layer.attn.q, "v": layer.attn.v, "out": layer.attn.out, "gate": layer.gate,
            "down": layer.down, "lm_head": model.lm_head}
    out = {"tp": r}
    for name, mod in mods.items():
        assert isinstance(mod, Int8Linear) and mod.tp_group is not None, name
        m = mod.q8.shape[0]
        xl = xb[:, r * m:(r + 1) * m] if mod.row_parallel else xb[:, :m]
        if mod.n_contract == 2:
            xl = xl.reshape(rows, -1, dh)
        out[name] = {"y": mod(xl).float().reshape(rows, -1).numpy(),
                     "row_parallel": mod.row_parallel, "m": m}
    for name, mod, norm in (("q", layer.attn.q, layer.attn.norm),
                            ("gate", layer.gate, layer.norm)):
        y = mod(xb[:, :cfg["hidden"]], norm=norm)
        out[f"{name}+norm"] = {"y": y.float().reshape(rows, -1).numpy(),
                               "norm_scale": norm.scale.float().numpy()}
    return out


def case_local_decode(cfg, q, k8, ks, v8, vs, start, stop):
    """Decode attention on this rank's heads, as a tp 2 serving model holds
    them: the model's own cache (``init_cache`` after ``set_serving_tp``:
    ``kv_heads / tp`` heads) takes the rank's heads of the whole int8
    cache, and ``decode_attention`` runs the rank's query heads on it."""
    import torch

    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.models import transformer as tm
    from mlcomp_tpu_torch.parallel.mesh import axis_rank

    mesh = _mesh(dp=1, tp=2)
    model = create_model(cfg, device="cpu")
    model.set_serving_tp(mesh)
    r = axis_rank(mesh, "tp")
    b, h, _ = q.shape
    h_kv, l_buf = k8.shape[1], k8.shape[2]
    cache = model.init_cache(b, l_buf).layers[0]
    hk = slice(r * h_kv // 2, (r + 1) * h_kv // 2)
    for field, whole, cast in (("kq", k8, None), ("ks", ks, torch.bfloat16), ("vq", v8, None),
                               ("vs", vs, torch.bfloat16)):
        local = _t(whole[:, hk])
        getattr(cache, field).copy_(local if cast is None else local.to(cast))
    hq = slice(r * h // 2, (r + 1) * h // 2)
    got = tm.decode_attention(_t(q[:, hq]).bfloat16().contiguous(), cache.kq, cache.ks,
                              cache.vq, cache.vs, kv_start=_t(start), kv_stop=_t(stop),
                              scale=0.1)
    return {"out": got.float().numpy(), "tp": r, "cache_heads": cache.kq.shape[1]}


def case_serving_errors(tile_cfg, tile_params, heads_cfg, heads_params):
    """The JAX package's kernel-level refusals on the serving path under
    tp 2: an int8 shard that is not lane-tileable (``serving_shards``) and
    head counts that tp does not divide with the int8 KV kernels
    (``set_serving_tp``)."""
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.models.generation import load_decode_weights

    mesh = _mesh(dp=1, tp=2)
    out = {}
    for key, cfg, params, quantize in (("qmm", tile_cfg, tile_params, "kernel"),
                                       ("decode", heads_cfg, heads_params, False)):
        try:
            load_decode_weights(create_model(cfg, device="cpu"), params, quantize=quantize,
                                mesh=mesh)
        except ValueError as e:
            out[key] = str(e)
    return out


def case_serving_shards(cfg, params, axes, quantize):
    """This rank's serving shards of ``params`` (quantized whole first when
    ``quantize``), flattened by path."""
    from mlcomp_tpu_torch.io.weights import flatten
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.ops.quant import as_tensor, quantize_params
    from mlcomp_tpu_torch.parallel.mesh import axis_rank
    from mlcomp_tpu_torch.parallel.sharding import serving_shards

    mesh = _mesh(**axes)
    model = create_model(cfg, device="cpu")
    tree = quantize_params(params) if quantize else params
    flat = flatten(serving_shards(tree, model, mesh))
    return {"tp": axis_rank(mesh, "tp"),
            "leaves": {k: as_tensor(v).numpy() for k, v in flat.items()}}


def _serve_model(cfg, params, mesh):
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.models.generation import load_decode_weights

    model = create_model(cfg, device="cpu")
    load_decode_weights(model, params, mesh=mesh)
    return model


def _channel(port):
    from mlcomp_tpu_torch.parallel.distributed import BoundaryChannel

    return BoundaryChannel(address="127.0.0.1:0", port=port, timeout_s=120)


def _kv_heads(eng):
    """The KV heads of every cache (or page) tensor this rank holds: the
    dense bf16 layout keeps heads at dim 2 of (B, L, Hkv, dh), pages at
    dim 2 of (P, T, Hkv, dh); the int8 family at dim 1."""
    if eng._layout is None:
        return sorted({t.shape[2] if n in ("k", "v") else t.shape[1]
                       for layer in eng._d["cache"].layers for n, t in vars(layer).items()})
    return sorted({p.shape[2] if spec.field in ("k", "v") else p.shape[1]
                   for spec, p in zip(eng._layout.kv_specs, eng._d["pages"])})


def _finish_rank(eng, out):
    """Coordinator: close (its loop sends the stop record).  Follower: wait
    for the stop record to end the loop, then close."""
    if eng.is_coordinator:
        eng.close()
        return out
    eng._thread.join(timeout=120)
    out["loop_ended"] = not eng._thread.is_alive()
    eng.close()
    return out


def _engine_state(eng):
    st = eng.stats()
    out = {"emitted_tokens": st["emitted_tokens"], "prefills": st["prefills"],
           "cancelled": st["cancelled"], "dispatches": st["dispatches"],
           "mesh": st.get("mesh"), "kv_heads": _kv_heads(eng),
           "depth": st["pipeline"]["depth"], "peak_inflight": st["pipeline"]["peak_inflight"]}
    if eng._layout is not None:
        out["table"] = eng._d["table"].numpy().copy()
        out["live_slots"] = len(eng._host)
    return out


def case_engine_workload(cfg, params, axes, depth, kv_layout, eos_c, ids, sync_port):
    """The mixed workload of tests/test_engine_sharded.py on a gang engine:
    A streams while B joins, C queues behind full slots and joins
    mid-stream, stopping at an EOS inside a K = 2 dispatch.  Rank 0 returns
    the results and its state, a follower its state once the coordinator's
    stop record ended its loop."""
    import queue

    from mlcomp_tpu_torch.engine import DecodeEngine

    mesh = _mesh(**axes)
    model = _serve_model(cfg, params, mesh)
    eng = DecodeEngine(model, slots=2, prompt_buckets=(16,), max_new_cap=10,
                       steps_per_dispatch=2, pipeline_depth=depth, kv_layout=kv_layout,
                       mesh=mesh, dist=_channel(sync_port))
    out = {"kv_heads_born": _kv_heads(eng)}
    if eng.is_coordinator:
        try:
            qa = queue.Queue()
            fa = eng.submit(ids["a"], 9, logprobs=True, stream=qa)
            qa.get(timeout=120)
            fb = eng.submit(ids["b"], 7)
            fc = eng.submit(ids["c"], 6, eos_id=eos_c)
            ra, rb, rc = (f.result(timeout=120) for f in (fa, fb, fc))
            out.update(a=(ra["ids"], ra["logprobs"]), b=rb["ids"], c=rc["ids"])
        finally:
            _finish_rank(eng, out)
        out.update(_engine_state(eng))
        return out
    _finish_rank(eng, out)
    out.update(_engine_state(eng))
    return out


def case_dp_slots(cfg, params, axes):
    """Slot counts that dp does not split are refused at construction (a
    rank's copy of the other dp ranks' rows goes stale once they decode)."""
    from mlcomp_tpu_torch.engine import DecodeEngine

    mesh = _mesh(**axes)
    out = {}
    for name, kw in (("slots", dict(slots=3)),
                     ("max_slots", dict(slots=2, max_slots=5, kv_layout="paged"))):
        try:
            DecodeEngine(_serve_model(cfg, params, mesh), prompt_buckets=(16,), max_new_cap=8,
                         mesh=mesh, dist=object(), **kw)
        except ValueError as e:
            out[name] = str(e)
    return out


def case_follower_replay(cfg, params, axes, prompt1, prompt2, sync_port):
    """A coordinator/follower pair: the follower refuses submits
    (NotCoordinator) and replays the coordinator's boundaries, a cancel
    retirement included; the coordinator's stop record ends its loop."""
    import queue

    from mlcomp_tpu_torch.engine import DecodeEngine, NotCoordinator

    mesh = _mesh(**axes)
    model = _serve_model(cfg, params, mesh)
    eng = DecodeEngine(model, slots=2, prompt_buckets=(16,), max_new_cap=10,
                       steps_per_dispatch=2, pipeline_depth=2, mesh=mesh,
                       dist=_channel(sync_port))
    out = {"is_coordinator": eng.is_coordinator}
    if not eng.is_coordinator:
        try:
            eng.submit([1, 2, 3], 4)
        except NotCoordinator as e:
            out["not_coordinator"] = e.status
        _finish_rank(eng, out)
        out.update(_engine_state(eng))
        return out
    try:
        out["r1"] = eng.submit(prompt1, 6).result(timeout=120)["ids"]
        qs = queue.Queue()
        f2 = eng.submit(prompt2, 10, stream=qs)
        qs.get(timeout=120)
        out["cancel_matched"] = eng.cancel(f2.rid)
        try:
            f2.result(timeout=120)
            out["f2"] = "finished"
        except Exception as e:
            out["f2"] = type(e).__name__
    finally:
        _finish_rank(eng, out)
    out.update(_engine_state(eng))
    return out


def case_service(cfg, params, mesh_cfg, kw, prompt, sync_port):
    """``load_service(mesh_cfg=, dist=)`` on this rank: the coordinator
    answers ``generate``, renders /metrics and reports its readiness; a
    follower its readiness and its state once its loop ended."""
    from mlcomp_tpu_torch.serve import load_service

    svc = load_service(cfg, params=params, device="cpu", mesh_cfg=mesh_cfg,
                       dist=_channel(sync_port), metrics_history_interval=0, **kw)
    out = {"mesh_block": svc.stats().get("mesh")}
    if hasattr(svc.model, "moe_blocks"):
        # the experts this rank holds, and the first of them
        out["experts"] = [(blk.w1.shape[0], blk.expert0) for _, blk in svc.model.moe_blocks()]
    eng = svc.engine
    if eng.is_coordinator:
        try:
            out["warm"] = svc.warmup()
            out["ids"] = svc.generate(prompt, kw["max_new_buckets"][-1])["ids"]
            out["ready"] = svc.stats()["ready"]
            out["metrics"] = [line for line in svc.metrics.render().splitlines()
                              if line.startswith(("mlcomp_engine_mesh_devices",
                                                  "mlcomp_engine_is_coordinator"))]
        finally:
            svc.close()
        return out
    out["ready"] = svc.stats()["ready"]
    out["metrics"] = [line for line in svc.metrics.render().splitlines()
                      if line.startswith(("mlcomp_engine_mesh_devices",
                                          "mlcomp_engine_is_coordinator"))]
    eng._thread.join(timeout=120)
    out["loop_ended"] = not eng._thread.is_alive()
    svc.close()
    return out
